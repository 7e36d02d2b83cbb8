"""Mutable (consuming) segment: an in-memory columnar store built a row at
a time.

The port of pinot_tpu/segment/mutable.py. Reference: MutableSegmentImpl
(pinot-segment-local/.../indexsegment/mutable/MutableSegmentImpl.java:126,
index():515) and the realtime mutable dictionary and forward index impls
(.../realtime/impl/).

- Columns are append-only Python lists on the host. A query pins a
  `MutableSegmentView` (row count, dictionary cardinalities, upsert
  validity) and runs it on the device through the append-only planes of
  realtime/device_plane.py, which upload only the rows appended since the
  last query.
- Mutable dictionaries are insertion-ordered (no sorted invariant), so the
  immutable planner refuses mutable segments (`is_mutable`) and the
  realtime planner lowers RANGE predicates in value space. On commit,
  realtime/converter.py re-encodes the rows with sorted dictionaries.
- Readers see a consistent prefix: `index()` appends, then publishes the
  new row count last (single writer, many readers: the guarantee
  MutableSegmentImpl gives with its volatile numDocsIndexed).
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import Any, Optional

import numpy as np

from ..spi.data_types import DataType, FieldSpec, Schema, coerce_value
from .format import ColumnMetadata

_NUMERIC_NP = {
    DataType.INT: np.int32,
    DataType.LONG: np.int64,
    DataType.FLOAT: np.float32,
    DataType.DOUBLE: np.float64,
    DataType.BOOLEAN: np.int8,
    DataType.TIMESTAMP: np.int64,
}


class MutableDictionary:
    """Insertion-ordered value↔id map (reference realtime mutable
    dictionaries). ``values`` materializes for host predicate evaluation."""

    def __init__(self):
        self._index: dict = {}
        self._values: list = []

    def index_of(self, value) -> int:
        return self._index.get(value, -1)

    def upsert(self, value) -> int:
        did = self._index.get(value)
        if did is None:
            did = len(self._values)
            self._index[value] = did
            self._values.append(value)
        return did

    def get(self, dict_id: int):
        return self._values[dict_id]

    @property
    def values(self) -> np.ndarray:
        return np.asarray(self._values)

    def __len__(self) -> int:
        return len(self._values)


class SnapshotDictionary:
    """Read-only view of a MutableDictionary pinned at a cardinality.

    The live dictionary is insertion-ordered and append-only, so its first
    ``card`` entries never change — pinning the cardinality makes every
    lookup deterministic for one snapshot even while ingestion keeps
    inserting new values. Values indexed after the pin report -1 (absent),
    which is consistent: no row inside the snapshot prefix can reference
    them."""

    def __init__(self, live: MutableDictionary, card: int):
        self._live = live
        self._card = card

    def index_of(self, value) -> int:
        did = self._live.index_of(value)
        return did if 0 <= did < self._card else -1

    def get(self, dict_id: int):
        return self._live.get(dict_id)

    @property
    def values(self) -> np.ndarray:
        return np.asarray(self._live._values[: self._card])

    def __len__(self) -> int:
        return self._card


class _MutableColumn:
    def __init__(self, spec: FieldSpec):
        self.spec = spec
        self.single_value = spec.single_value
        dt = DataType(spec.data_type)
        self.data_type = dt
        # dimensions dict-encode (strings MUST); metrics store raw
        self.dict_encoded = spec.field_type.value != "METRIC" or not dt.is_numeric
        self.dictionary = MutableDictionary() if self.dict_encoded else None
        self.dict_ids: list = []      # SV dict ids | raw values
        self.mv_ids: list = []        # MV rows: list[list]
        self.null_docs: list[int] = []
        self.min_value = None
        self.max_value = None
        self.total_values = 0
        self.max_mv = 0

    def _observe(self, v):
        if self.min_value is None or v < self.min_value:
            self.min_value = v
        if self.max_value is None or v > self.max_value:
            self.max_value = v

    def add(self, value, doc_id: int):
        if value is None:
            self.null_docs.append(doc_id)
            value = (list(self.spec.default_null_value)
                     if not self.single_value and isinstance(
                         self.spec.default_null_value, (list, tuple))
                     else self.spec.default_null_value)
            if not self.single_value and not isinstance(value, (list, tuple)):
                value = [value]
        if self.single_value:
            value = self._coerce(value)
            self._observe(value)
            self.total_values += 1
            if self.dict_encoded:
                self.dict_ids.append(self.dictionary.upsert(value))
            else:
                self.dict_ids.append(value)
        else:
            vals = [self._coerce(v) for v in (value if isinstance(value, (list, tuple, np.ndarray)) else [value])]
            for v in vals:
                self._observe(v)
            self.total_values += len(vals)
            self.max_mv = max(self.max_mv, len(vals))
            if self.dict_encoded:
                self.mv_ids.append([self.dictionary.upsert(v) for v in vals])
            else:
                self.mv_ids.append(vals)

    def _coerce(self, v):
        return coerce_value(v, self.data_type)

    def metadata(self, num_docs: int) -> ColumnMetadata:
        card = len(self.dictionary) if self.dict_encoded else 0
        return ColumnMetadata(
            name=self.spec.name,
            data_type=self.data_type.value,
            field_type=self.spec.field_type.value,
            encoding="DICT" if self.dict_encoded else "RAW",
            single_value=self.single_value,
            cardinality=card,
            min_value=self.min_value,
            max_value=self.max_value,
            is_sorted=False,
            has_nulls=bool(self.null_docs),
            total_number_of_entries=self.total_values,
            max_number_of_multi_values=self.max_mv,
        )

    def values_snapshot(self, n: int) -> np.ndarray:
        if not self.single_value:
            raise ValueError(f"{self.spec.name} is MV")
        if self.dict_encoded:
            vals = self.dictionary.values
            ids = np.asarray(self.dict_ids[:n], dtype=np.int64)
            if len(vals) == 0:
                return np.empty(0, dtype=object)
            return vals[ids]
        dtype = _NUMERIC_NP.get(self.data_type, object)
        return np.asarray(self.dict_ids[:n], dtype=dtype)

    def mv_snapshot(self, n: int) -> list[np.ndarray]:
        if self.dict_encoded:
            vals = self.dictionary.values
            return [np.asarray([vals[i] for i in row]) for row in self.mv_ids[:n]]
        return [np.asarray(row) for row in self.mv_ids[:n]]

    # -- device-plane delta reads (realtime/device_plane.py) ---------------
    # Rows below any published num_docs are immutable, so slicing [a, b)
    # with b <= num_docs is race-free against the consumer thread.

    def ids_slice(self, a: int, b: int) -> np.ndarray:
        """SV dict-id rows [a, b) as int32 (unpacked device ids plane)."""
        return np.asarray(self.dict_ids[a:b], dtype=np.int32)

    def raw_slice(self, a: int, b: int) -> np.ndarray:
        """Raw (non-dict) SV metric rows [a, b) at the column's np dtype."""
        dtype = _NUMERIC_NP.get(self.data_type)
        if dtype is None:
            raise ValueError(f"{self.spec.name}: non-numeric raw plane")
        return np.asarray(self.dict_ids[a:b], dtype=dtype)

    def null_slice(self, a: int, b: int) -> np.ndarray:
        """Null bitmap for rows [a, b). null_docs is monotonic (appended in
        doc order) so a bisected window is exact."""
        out = np.zeros(b - a, dtype=bool)
        nd = self.null_docs
        lo = bisect.bisect_left(nd, a)
        hi = bisect.bisect_left(nd, b)
        for d in nd[lo:hi]:
            out[d - a] = True
        return out

    def dict_values_numeric(self, a: int, b: int) -> np.ndarray:
        """Dictionary values [a, b) at the column's np dtype — delta feed
        for the device dict-values plane (append-only, stable prefix)."""
        dtype = _NUMERIC_NP.get(self.data_type)
        if dtype is None:
            raise ValueError(f"{self.spec.name}: non-numeric dict plane")
        return np.asarray(self.dictionary._values[a:b], dtype=dtype)


class _NoIndexes:
    """A consuming segment carries no persisted indexes and no star-trees
    (the JAX package's mutable segments answer the same): a TEXT_MATCH,
    VECTOR_SIMILARITY or JSON_MATCH on one raises (engine/host_masks.py),
    a `mapvalue` predicate takes the row-wise transform, and the host
    engine (engine/host_executor.py) scans where it would read an
    inverted, sorted, range or geo index."""

    def get_inverted_index(self, column: str):
        return None

    def get_sorted_index(self, column: str):
        return None

    def get_range_index(self, column: str):
        return None

    def get_geo_index(self, lat_col: str, lng_col: str,
                      or_build: bool = False):
        return None

    def get_bloom_filter(self, column: str):
        return None

    def get_json_index(self, column: str, or_build: bool = False):
        return None

    def get_text_index(self, column: str, or_build: bool = False):
        return None

    def get_vector_index(self, column: str, or_build: bool = False):
        return None

    def get_map_index(self, column: str):
        return None

    @property
    def star_trees(self):
        return []


class MutableSegment(_NoIndexes):
    """Duck-types the ImmutableSegment read API (segment/loader.py) over
    append-only buffers; queried through `snapshot_view()`."""

    is_mutable = True
    valid_doc_ids = None  # upsert validity plane (upsert/manager.py)

    def __init__(self, schema: Schema, segment_name: str):
        self.schema = schema
        self.segment_name = segment_name
        self._columns: dict[str, _MutableColumn] = {
            name: _MutableColumn(spec) for name, spec in schema.fields.items()}
        self._num_docs = 0

    # -- write path --------------------------------------------------------
    def index(self, row: dict) -> int:
        """Add one transformed row; returns its doc id (reference
        MutableSegmentImpl.index:515 — single consumer thread)."""
        doc_id = self._num_docs
        for name, col in self._columns.items():
            col.add(row.get(name), doc_id)
        # publish AFTER the row is fully written (reader snapshot isolation)
        self._num_docs = doc_id + 1
        return doc_id

    # -- read API (ImmutableSegment duck type) -----------------------------
    @property
    def name(self) -> str:
        return self.segment_name

    @property
    def num_docs(self) -> int:
        return self._num_docs

    def columns(self) -> list[str]:
        return list(self._columns)

    def column(self, name: str) -> _MutableColumn:
        """Raw column buffer access for the realtime device-plane reader."""
        return self._columns[name]

    def get_values(self, column: str) -> np.ndarray:
        return self._columns[column].values_snapshot(self._num_docs)

    def get_values_at(self, column: str, doc_ids: np.ndarray) -> np.ndarray:
        """Values of a single-value column at `doc_ids` (selection rows)."""
        return self.get_values(column)[doc_ids]

    def get_mv_values(self, column: str) -> list[np.ndarray]:
        return self._columns[column].mv_snapshot(self._num_docs)

    def get_null_bitmap(self, column: str) -> Optional[np.ndarray]:
        return _null_bitmap(self._columns[column], self._num_docs)

    def read_cell(self, column: str, doc_id: int):
        """Single-cell point read without materializing the column (partial
        upsert reads the previous row version at ingestion rate)."""
        col = self._columns[column]
        if not col.single_value:
            row = col.mv_ids[doc_id]
            if col.dict_encoded:
                return [col.dictionary.get(i) for i in row]
            return list(row)
        v = col.dict_ids[doc_id]
        return col.dictionary.get(v) if col.dict_encoded else v

    # -- conversion support ------------------------------------------------
    def to_columns(self) -> dict[str, list]:
        """Column-major snapshot for RealtimeSegmentConverter → SegmentBuilder."""
        n = self._num_docs
        out: dict[str, Any] = {}
        for name, col in self._columns.items():
            if col.single_value:
                vals: list = list(col.values_snapshot(n))
            else:
                vals = [list(r) for r in col.mv_snapshot(n)]
            # restore None so the builder re-derives the null vector
            for d in col.null_docs:
                if d < n:
                    vals[d] = None
            out[name] = vals
        return out

    def snapshot_view(self) -> "MutableSegmentView":
        """Pin the row count for one query: every column reads the same
        prefix even while the consumer thread keeps appending (reference:
        MutableSegmentImpl readers bound by numDocsIndexed at acquire)."""
        return MutableSegmentView(self)


class _PinnedValidity:
    """Immutable upsert-validity snapshot with ValidDocIds' `mask` read, so
    every plan of one query sees the same bits."""

    def __init__(self, mask: np.ndarray):
        self._mask = mask

    def mask(self, n: int) -> np.ndarray:
        out = np.zeros(n, dtype=bool)
        m = min(n, len(self._mask))
        out[:m] = self._mask[:m]
        return out


class MutableSegmentView(_NoIndexes):
    """Read-only consistent-prefix view over a MutableSegment.

    Beyond the row count, the view pins everything a query plan can
    observe: per-column dictionary cardinality (SnapshotDictionary), the
    upsert validity plane, and column metadata — so the host path, the
    device plane path, and every cache key derived from this view agree on
    one immutable snapshot identified by ``snapshot_generation``."""

    is_mutable = True

    def __init__(self, segment: MutableSegment):
        self._seg = segment
        self._n = segment._num_docs
        vd = segment.valid_doc_ids
        if vd is not None and hasattr(vd, "snapshot"):
            mask, ugen = vd.snapshot(self._n)
            self._valid: Optional[_PinnedValidity] = _PinnedValidity(mask)
            self._upsert_gen = ugen
        else:
            self._valid = None
            self._upsert_gen = 0
        # card read AFTER _num_docs: every dict id in the prefix is < card
        self._cards = {
            name: (len(col.dictionary) if col.dict_encoded else 0)
            for name, col in segment._columns.items()}
        self._dicts: dict[str, Optional[SnapshotDictionary]] = {}
        self._meta: dict[str, ColumnMetadata] = {}

    @property
    def valid_doc_ids(self):
        return self._valid

    @property
    def snapshot_generation(self) -> tuple:
        """Stable identity of this snapshot's contents: the row prefix plus
        the upsert validity generation. Two views with equal generations
        answer every query identically."""
        return (self._n, self._upsert_gen)

    def pinned_cardinality(self, column: str) -> int:
        return self._cards[column]

    @property
    def name(self) -> str:
        return self._seg.segment_name

    @property
    def num_docs(self) -> int:
        return self._n

    def columns(self) -> list[str]:
        return self._seg.columns()

    def has_column(self, column: str) -> bool:
        return column in self._seg._columns

    def column_metadata(self, column: str) -> ColumnMetadata:
        md = self._meta.get(column)
        if md is None:
            col = self._seg._columns[column]
            md = col.metadata(self._n)
            if col.dict_encoded:
                md = dataclasses.replace(md, cardinality=self._cards[column])
            self._meta[column] = md
        return md

    def get_dictionary(self, column: str):
        if column not in self._dicts:
            live = self._seg._columns[column].dictionary
            self._dicts[column] = (
                SnapshotDictionary(live, self._cards[column])
                if live is not None else None)
        return self._dicts[column]

    def get_values(self, column: str) -> np.ndarray:
        return self._seg._columns[column].values_snapshot(self._n)

    def get_values_at(self, column: str, doc_ids: np.ndarray) -> np.ndarray:
        """Values of a single-value column at `doc_ids` (selection rows)."""
        return self.get_values(column)[doc_ids]

    def get_mv_values(self, column: str) -> list[np.ndarray]:
        return self._seg._columns[column].mv_snapshot(self._n)

    def get_null_bitmap(self, column: str) -> Optional[np.ndarray]:
        """The pinned prefix's null vector, or None when it has no null."""
        return _null_bitmap(self._seg._columns[column], self._n)


def _null_bitmap(col: _MutableColumn, n: int) -> Optional[np.ndarray]:
    if not col.null_docs or col.null_docs[0] >= n:
        return None
    return col.null_slice(0, n)
