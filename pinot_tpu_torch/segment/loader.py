"""Immutable segment loader.

Reference: pinot-segment-local/.../indexsegment/immutable/
ImmutableSegmentLoader.java:67 — loads a segment directory, mmaps buffers, and
exposes per-column data sources. Here `data.bin` is np.memmap'd (the analogue
of PinotDataBuffer.mapFile, pinot-segment-spi/.../memory/PinotDataBuffer.java:272)
and columns decode lazily into host int32/value planes, cached, ready for one
copy to the device via device_cache.DeviceSegmentCache.

Dictionary-encoded columns, single- and multi-value; raw single-value
columns, fixed-width or var-byte (STRING, BYTES, JSON: a value stream and
u64 offsets); CLP log columns (segment/clp.py); any buffer in a PTCC
container (segment/compression.py: LZ4, SNAPPY, GZIP, ZSTANDARD),
decompressed once on its first read and cached; bloom filters for pruning;
the inverted, sorted, raw range and geo indexes the host engine reads; the
JSON, text, vector and custom (map) indexes; each read lazily and cached;
the star-trees' pre-aggregated views. The on-disk format is shared with
the JAX package, so either package's builder output loads here.

Var-width and CLP values live on the host only (the planner refuses them
in a filter, key or value), so a selection decodes just the rows it
returns (`get_values_at`); a whole-column read decodes once and caches.
`apply_schema` gives a column the segment predates a virtual default
column; `backfill_indexes` builds the indexes a table config asks for
and the segment was written without.
"""

from __future__ import annotations

import zlib
from pathlib import Path
from typing import Optional

import numpy as np

from ..spi.data_types import DataType
from . import bitpack
from .clp import deserialize_clp
from .compression import decompress_buffer
from .dictionary import Dictionary, deserialize_dictionary
from .format import DATA_FILE, ColumnMetadata, SegmentMetadata, read_metadata
from .index_spi import load_custom_index
from .indexes import (BloomFilter, GeoGridIndex, InvertedIndex, JsonIndex,
                      RawRangeIndex, SortedIndex, TextIndex, VectorIndex,
                      deserialize_bloom, deserialize_geo_index,
                      deserialize_inverted, deserialize_json_index,
                      deserialize_text_index, deserialize_vector_index)
from .startree import StarTreeView


# full-segment verifications so far (a perf guard: a warm query path,
# tiered storage's resident path included, must not move it)
VERIFY_CALLS = 0


class SegmentIntegrityError(RuntimeError):
    """A loaded segment's bytes do not match its build-time checksums
    (bit rot, truncation, torn copy); names the damaged columns."""

    def __init__(self, segment_name: str, directory, reason: str,
                 columns: Optional[list] = None):
        detail = f" (columns: {', '.join(columns)})" if columns else ""
        super().__init__(
            f"segment {segment_name} failed integrity check: "
            f"{reason}{detail} [{directory}]")
        self.segment_name = segment_name
        self.directory = str(directory)
        self.reason = reason
        self.columns = columns or []


class ImmutableSegment:
    """A loaded immutable segment: metadata + lazily decoded column planes."""

    # upsert validity plane, set by upsert/manager.py on an upsert table's
    # committed segments; the planner ANDs it into the filter
    valid_doc_ids = None

    def __init__(self, directory: str | Path):
        self.directory = Path(directory)
        self.metadata: SegmentMetadata = read_metadata(self.directory)
        self._data = np.memmap(self.directory / DATA_FILE, dtype=np.uint8, mode="r")
        self._dictionaries: dict[str, Dictionary] = {}
        self._decompressed: dict[str, np.ndarray] = {}
        self._dict_ids: dict[str, np.ndarray] = {}
        self._raw: dict[str, np.ndarray] = {}
        self._nulls: dict[str, Optional[np.ndarray]] = {}
        self._mv_offsets: dict[str, np.ndarray] = {}
        self._indexes: dict[tuple, object] = {}

    # -- integrity ----------------------------------------------------------
    def verify_integrity(self) -> None:
        """Recompute checksums over data.bin and compare with the ones the
        builder stamped into metadata.json; raise SegmentIntegrityError on
        any mismatch, naming the damaged column(s) when the per-buffer
        crcs localize it. One full sequential pass at load time."""
        global VERIFY_CALLS
        VERIFY_CALLS += 1
        meta = self.metadata
        expected_end = max(
            (off + size for off, size, *_ in meta.buffers.values()),
            default=0)
        if len(self._data) < expected_end:
            self._integrity_failure(
                f"data.bin truncated: {len(self._data)} bytes, "
                f"buffers extend to {expected_end}",
                self._damaged_columns())
        if meta.crc is not None:
            crc = zlib.crc32(self._data[:expected_end])
            if format(crc, "08x") != meta.crc:
                self._integrity_failure(
                    f"segment crc mismatch: computed {format(crc, '08x')}, "
                    f"metadata {meta.crc}", self._damaged_columns())
        elif meta.buffer_crcs:
            bad = self._damaged_columns()
            if bad:
                self._integrity_failure("buffer crc mismatch", bad)

    def _damaged_columns(self) -> list:
        """Per-buffer re-check to localize damage: returns the owning
        column names (or raw buffer names) whose stored crc disagrees."""
        meta = self.metadata
        columns = sorted(meta.columns, key=len, reverse=True)
        bad = []
        for name, want in meta.buffer_crcs.items():
            entry = meta.buffers.get(name)
            if entry is None:
                continue
            off, size = entry[0], entry[1]
            chunk = self._data[off:off + size]
            if len(chunk) != size or format(zlib.crc32(chunk), "08x") != want:
                owner = next((c for c in columns
                              if name == c or name.startswith(c + ".")),
                             name)
                if owner not in bad:
                    bad.append(owner)
        return bad

    def _integrity_failure(self, reason: str, columns: list):
        raise SegmentIntegrityError(self.metadata.segment_name,
                                    self.directory, reason, columns)

    # -- schema evolution and index backfill ----------------------------------
    def apply_schema(self, schema) -> None:
        """Give every single-value column of `schema` that this segment
        predates a virtual dictionary column of cardinality 1 holding the
        field's default value, so predicates, group keys and projections
        read it as any dictionary column (the JAX package's
        ImmutableSegment.apply_schema; reference: SegmentPreProcessor's
        default-column update on load). Multi-value columns get none, as
        there."""
        for name in schema.column_names():
            if name in self.metadata.columns:
                continue
            spec = schema.field_spec(name)
            if not spec.single_value:
                continue
            default = spec.default_null_value
            dt = spec.data_type
            n = self.num_docs
            self.metadata.columns[name] = ColumnMetadata(
                name=name, data_type=dt.value,
                field_type=spec.field_type.value, encoding="DICT",
                cardinality=1, bits_per_value=1, min_value=default,
                max_value=default, is_sorted=True,
                total_number_of_entries=n)
            values = (np.asarray([default], dtype=object)
                      if dt.value in ("STRING", "JSON", "BYTES")
                      else np.asarray([default], dtype=dt.numpy_dtype))
            self._dictionaries[name] = Dictionary(dt, values)
            self._dict_ids[name] = np.zeros(n, dtype=np.int32)
            self._nulls[name] = None

    def backfill_indexes(self, indexing) -> list[str]:
        """Build the indexes `indexing` (spi/table_config.py
        IndexingConfig) asks for and this segment was written without, in
        memory, as the JAX package's backfill_indexes does (reference:
        SegmentPreProcessor's index backfill on load): the inverted index
        of a dictionary SV column (also for a range index over one), the
        range index of a raw fixed-width column, the bloom filter (over the
        dictionary's or the raw column's values), and the JSON, text,
        vector and geo indexes. Returns what it built ("bloom:<column>",
        ...)."""
        built = []

        def have(key):
            return self._indexes.get(key) is not None

        def build_inverted(col, m, label):
            self._indexes[("inv", col)] = InvertedIndex.build(
                self.get_dict_ids(col), m.cardinality)
            built.append(f"{label}:{col}")

        for col in indexing.inverted_index_columns:
            if not self.has_column(col) or have(("inv", col)) \
                    or self.get_inverted_index(col) is not None:
                continue
            m = self.column_metadata(col)
            if m.encoding == "DICT" and m.single_value:
                build_inverted(col, m, "inverted")
        for col in indexing.range_index_columns:
            if not self.has_column(col):
                continue
            m = self.column_metadata(col)
            if m.encoding == "DICT":
                # a dictionary range rides the inverted index, as the
                # builder decides for rangeIndexColumns
                if m.single_value and not have(("inv", col)) \
                        and self.get_inverted_index(col) is None:
                    build_inverted(col, m, "range(inv)")
            elif not have(("rng", col)) \
                    and self.get_range_index(col) is None \
                    and m.encoding == "RAW" \
                    and DataType(m.data_type).is_fixed_width:
                self._indexes[("rng", col)] = RawRangeIndex.build(
                    self.get_raw(col))
                built.append(f"range:{col}")
        for col in indexing.bloom_filter_columns:
            if not self.has_column(col) \
                    or self.get_bloom_filter(col) is not None:
                continue
            m = self.column_metadata(col)
            values = (self.get_dictionary(col).values
                      if m.encoding == "DICT" else self.get_raw(col))
            self._indexes[("bloom", col)] = BloomFilter.build(values)
            built.append(f"bloom:{col}")
        for kind, cols, get in (
                ("json", indexing.json_index_columns, self.get_json_index),
                ("text", indexing.text_index_columns, self.get_text_index),
                ("vector", indexing.vector_index_columns,
                 self.get_vector_index)):
            for col in cols:
                if self.has_column(col) and get(col) is None:
                    get(col, or_build=True)
                    built.append(f"{kind}:{col}")
        for cfg in indexing.geo_index_configs:
            lat, lng = cfg.get("latColumn"), cfg.get("lngColumn")
            if lat and lng and self.has_column(lat) and self.has_column(lng) \
                    and self.get_geo_index(lat, lng) is None:
                self.get_geo_index(lat, lng, or_build=True)
                built.append(f"geo:{lat},{lng}")
        return built

    # -- identity ----------------------------------------------------------
    @property
    def name(self) -> str:
        return self.metadata.segment_name

    @property
    def num_docs(self) -> int:
        return self.metadata.num_docs

    def column_metadata(self, column: str) -> ColumnMetadata:
        return self.metadata.columns[column]

    def has_column(self, column: str) -> bool:
        return column in self.metadata.columns

    def columns(self) -> list[str]:
        return list(self.metadata.columns)

    # -- buffers -----------------------------------------------------------
    def _buffer(self, name: str) -> np.ndarray:
        entry = self.metadata.buffers[name]
        if len(entry) == 3:  # [offset, size, codec]: a PTCC container
            if name not in self._decompressed:
                off, size, _codec = entry
                self._decompressed[name] = np.frombuffer(
                    decompress_buffer(self._data[off:off + size]),
                    dtype=np.uint8)
            return self._decompressed[name]
        off, size = entry
        return self._data[off : off + size]

    def _sv(self, column: str, encoding: str) -> ColumnMetadata:
        m = self.column_metadata(column)
        if m.encoding != encoding or not m.single_value:
            raise ValueError(
                f"{column}: {m.encoding} "
                f"{'SV' if m.single_value else 'MV'} column, expected "
                f"{encoding} SV")
        return m

    def get_dictionary(self, column: str) -> Dictionary:
        if column not in self._dictionaries:
            m = self.column_metadata(column)
            if m.encoding != "DICT":
                raise ValueError(f"{column} has no dictionary")
            raw = bytes(self._buffer(f"{column}.dict"))
            self._dictionaries[column] = deserialize_dictionary(raw, DataType(m.data_type), m.cardinality)
        return self._dictionaries[column]

    def get_dict_ids(self, column: str) -> np.ndarray:
        """Decoded int32 dict-id plane (SV) or flat MV dict-id stream."""
        if column not in self._dict_ids:
            m = self.column_metadata(column)
            if m.encoding != "DICT":
                raise ValueError(f"{column} has no dictionary")
            self._dict_ids[column] = bitpack.unpack(
                self._buffer(f"{column}.fwd"), m.bits_per_value,
                m.total_number_of_entries)
        return self._dict_ids[column]

    def get_mv_offsets(self, column: str) -> np.ndarray:
        """int64 row offsets (num_docs + 1) into an MV column's id stream."""
        if column not in self._mv_offsets:
            self._mv_offsets[column] = np.frombuffer(
                self._buffer(f"{column}.mvoff"), dtype=np.uint32,
                count=self.num_docs + 1).astype(np.int64)
        return self._mv_offsets[column]

    def get_mv_dict_id_matrix(self, column: str) -> np.ndarray:
        """(num_docs, max_mv) int32 matrix of an MV column's dict ids,
        padded with the sentinel `cardinality`: out of dictionary range, so
        every predicate is false on a pad slot and MV predicates reduce
        with any() across the row."""
        m = self.column_metadata(column)
        ids = self.get_dict_ids(column)
        lens = np.diff(self.get_mv_offsets(column))
        max_mv = max(1, m.max_number_of_multi_values)
        out = np.full((self.num_docs, max_mv), m.cardinality, dtype=np.int32)
        out[np.arange(max_mv)[None, :] < lens[:, None]] = ids
        return out

    def get_raw(self, column: str) -> np.ndarray:
        """Every value of a single-value raw column: the fixed-width value
        plane, or an object array of a var-byte or CLP column's values
        (str, or bytes for BYTES), decoded once and cached."""
        if column not in self._raw:
            m = self.column_metadata(column)
            if m.encoding == "CLP":
                self._raw[column] = self._clp(column).decode_all()
                return self._raw[column]
            m = self._sv(column, "RAW")
            dtype = DataType(m.data_type)
            if dtype.is_fixed_width:
                self._raw[column] = np.frombuffer(
                    self._buffer(f"{column}.fwd"),
                    dtype=dtype.numpy_dtype, count=self.num_docs)
            else:
                self._raw[column] = self._var_values(column, None)
        return self._raw[column]

    def _var_values(self, column: str, doc_ids) -> np.ndarray:
        """A var-byte raw column's values at `doc_ids` (all with None):
        the value stream sliced at its u64 offsets (reference
        VarByteChunkForwardIndexReaderV4). STRING and JSON values are
        str, BYTES values bytes, as the JAX package's loop per row gives
        them; an ASCII stream decodes once and is sliced as text."""
        buf = self._buffer(f"{column}.fwd")
        offs = np.frombuffer(self._buffer(f"{column}.voff"), dtype=np.uint64,
                             count=self.num_docs + 1)
        is_bytes = self.column_metadata(column).data_type == "BYTES"
        if doc_ids is None:
            blob = buf.tobytes()
            starts, ends = offs[:-1].tolist(), offs[1:].tolist()
            if is_bytes:
                vals = [blob[a:b] for a, b in zip(starts, ends)]
            elif blob.isascii():
                text = blob.decode("ascii")
                vals = [text[a:b] for a, b in zip(starts, ends)]
            else:
                vals = [blob[a:b].decode("utf-8")
                        for a, b in zip(starts, ends)]
        else:
            idx = np.asarray(doc_ids, dtype=np.int64).ravel()
            pieces = [buf[a:b].tobytes() for a, b in
                      zip(offs[idx].tolist(), offs[idx + 1].tolist())]
            vals = pieces if is_bytes else [p.decode("utf-8")
                                            for p in pieces]
        out = np.empty(len(vals), dtype=object)
        out[:] = vals
        return out

    def _clp(self, column: str):
        """A CLP column's encoded form (segment/clp.py), parsed once."""
        return self._index(("clp", column), lambda: deserialize_clp(
            bytes(self._buffer(f"{column}.fwd"))))

    def get_null_bitmap(self, column: str) -> Optional[np.ndarray]:
        """Boolean null vector, or None when the column has no nulls
        (reference NullValueVectorReaderImpl)."""
        if column not in self._nulls:
            m = self.column_metadata(column)
            if not m.has_nulls:
                self._nulls[column] = None
            else:
                self._nulls[column] = bitpack.unpack_bitmap(self._buffer(f"{column}.nulls"), self.num_docs)
        return self._nulls[column]

    def buffer_array(self, name: str) -> np.ndarray:
        """Raw uint8 view of a stored buffer (custom index SPI surface)."""
        return self._buffer(name)

    def _has_buffer(self, name: str) -> bool:
        return name in self.metadata.buffers

    def _index(self, key: tuple, load, build=None):
        """The cached index `key`: load() (None when the segment stores
        none), else, when asked for, build() from the column's values,
        cached so repeated queries parse the column once."""
        if key not in self._indexes:
            self._indexes[key] = load()
        if self._indexes[key] is None and build:
            self._indexes[key] = build()
        return self._indexes[key]

    def _bufs(self, column: str, suffixes) -> dict:
        return {s: np.frombuffer(self._buffer(f"{column}.{s}"), dtype=np.uint8)
                for s in suffixes if self._has_buffer(f"{column}.{s}")}

    def get_inverted_index(self, column: str):
        """The CSR inverted index (segment/indexes.py; reference
        BitmapInvertedIndexReader; a dictId range is one slice, so it is
        the dictionary range index too), or None."""
        def load():
            if not self._has_buffer(f"{column}.inv.off"):
                return None
            return deserialize_inverted(
                np.frombuffer(self._buffer(f"{column}.inv.off"),
                              dtype=np.uint32),
                np.frombuffer(self._buffer(f"{column}.inv.docs"),
                              dtype=np.uint32))
        return self._index(("inv", column), load)

    def get_sorted_index(self, column: str):
        """A sorted dictionary SV column's dictId -> doc range index,
        derived from the forward index (nothing is stored; reference
        SortedIndexReader), or None for any other column."""
        def load():
            m = self.column_metadata(column)
            if not (m.encoding == "DICT" and m.single_value and m.is_sorted):
                return None
            return SortedIndex.build(self.get_dict_ids(column),
                                     m.cardinality)
        return self._index(("sorted", column), load)

    def get_range_index(self, column: str):
        """A raw column's range index (sorted values and their
        permutation), or None."""
        def load():
            if not self._has_buffer(f"{column}.rng.perm"):
                return None
            dt = DataType(self.column_metadata(column).data_type).numpy_dtype
            return RawRangeIndex(
                np.frombuffer(self._buffer(f"{column}.rng.sorted"), dtype=dt),
                np.frombuffer(self._buffer(f"{column}.rng.perm"),
                              dtype=np.uint32))
        return self._index(("rng", column), load)

    def get_geo_index(self, lat_col: str, lng_col: str,
                      or_build: bool = False):
        """The geo grid index over (lat_col, lng_col), or (or_build=True)
        a transient one at the default resolution, built from the columns'
        values and cached."""
        pair = f"{lat_col}__{lng_col}"

        def load():
            if not self._has_buffer(f"{pair}.geo.hdr"):
                return None
            return deserialize_geo_index(self._bufs(pair, (
                "geo.hdr", "geo.cells", "geo.off", "geo.docs")))
        return self._index(("geo", lat_col, lng_col), load, or_build and (
            lambda: GeoGridIndex.build(
                np.asarray(self.get_values(lat_col), dtype=np.float64),
                np.asarray(self.get_values(lng_col), dtype=np.float64))))

    def get_bloom_filter(self, column: str):
        """The column's bloom filter (segment/indexes.py), or None."""
        def load():
            if not self._has_buffer(f"{column}.bloom.hdr"):
                return None
            return deserialize_bloom(
                np.frombuffer(self._buffer(f"{column}.bloom.hdr"),
                              dtype=np.int64),
                np.frombuffer(self._buffer(f"{column}.bloom.bits"),
                              dtype=np.uint8))
        return self._index(("bloom", column), load)

    def get_json_index(self, column: str, or_build: bool = False):
        """Persisted JSON index, or (or_build=True) a transient one built
        from the column's values and cached."""
        def load():
            if not self._has_buffer(f"{column}.json.keys.names"):
                return None
            return deserialize_json_index(self._bufs(column, (
                "json.keys.names", "json.keys.off", "json.keys.docs",
                "json.paths.names", "json.paths.off", "json.paths.docs")))
        return self._index(("json", column), load, or_build and (
            lambda: JsonIndex.build(self.get_values(column))))

    def get_text_index(self, column: str, or_build: bool = False):
        def load():
            if not self._has_buffer(f"{column}.text.terms"):
                return None
            return deserialize_text_index(self._bufs(column, (
                "text.terms", "text.off", "text.docs", "text.pos")))
        return self._index(("text", column), load, or_build and (
            lambda: TextIndex.build(self.get_values(column))))

    def get_vector_index(self, column: str, or_build: bool = False):
        def load():
            if not self._has_buffer(f"{column}.vec.hdr"):
                return None
            return deserialize_vector_index(self._bufs(column, (
                "vec.hdr", "vec.data", "vec.centroids", "vec.assign")))
        return self._index(("vector", column), load, or_build and (
            lambda: VectorIndex.build(np.stack([
                np.asarray(v, dtype=np.float32)
                for v in self.get_mv_values(column)]))))

    def get_custom_index(self, column: str, type_name: str):
        """A custom index built through the index SPI
        (segment/index_spi.py), deserialized once; None if this segment
        carries none."""
        return self._index(("custom", column, type_name),
                           lambda: load_custom_index(self, column, type_name))

    def get_map_index(self, column: str):
        """Dense per-key planes of a MAP column (segment/map_index.py);
        None when this segment has no map index for the column."""
        return self.get_custom_index(column, "map")

    def star_trees(self):
        """The segment's star-trees as pre-aggregated pseudo-segments
        (segment/startree.py StarTreeView), cached: a view keeps its device
        planes under one identity."""
        return self._index(("startree", "*"), lambda: [
            StarTreeView(self, m) for m in self.metadata.star_trees])

    # -- materialized values (selection rows, transient indexes) -------------
    def get_values(self, column: str) -> np.ndarray:
        """Every value of a single-value column."""
        return self.get_values_at(column, slice(None))

    def get_values_at(self, column: str, doc_ids: np.ndarray) -> np.ndarray:
        """The values of a single-value column at `doc_ids` (the JAX
        package's `get_values(column)[doc_ids]`), decoding only those
        docs' values."""
        m = self.column_metadata(column)
        if m.encoding in ("RAW", "CLP") and column not in self._raw \
                and not isinstance(doc_ids, slice):
            # a var-width column's selected rows only
            if m.encoding == "CLP":
                return self._clp(column).decode_docs(doc_ids)
            if not DataType(m.data_type).is_fixed_width:
                return self._var_values(column, doc_ids)
        if m.encoding in ("RAW", "CLP"):
            return self.get_raw(column)[doc_ids]
        if not m.single_value:
            raise ValueError(f"{column} is MV; use get_mv_values")
        return self.get_dictionary(column).take(
            self.get_dict_ids(column)[doc_ids])

    def read_cell(self, column: str, doc_id: int):
        """Single-cell point read: a partial upsert reads the previous
        version of a row (decoded planes are cached, so O(1) after the
        first read of a column)."""
        m = self.column_metadata(column)
        if m.encoding in ("RAW", "CLP"):
            return _py(self.get_values_at(column, np.asarray([doc_id]))[0])
        d = self.get_dictionary(column)
        ids = self.get_dict_ids(column)
        if m.single_value:
            return _py(d.get(int(ids[doc_id])))
        offsets = self.get_mv_offsets(column)
        return [_py(d.get(int(i)))
                for i in ids[offsets[doc_id]:offsets[doc_id + 1]]]

    def get_mv_values(self, column: str) -> list[np.ndarray]:
        """Per-document value arrays of an MV column."""
        d = self.get_dictionary(column)
        ids = self.get_dict_ids(column)
        offsets = self.get_mv_offsets(column)
        return [d.take(ids[offsets[i]:offsets[i + 1]])
                for i in range(self.num_docs)]


def _py(v):
    return v.item() if isinstance(v, np.generic) else v


def load_segment(directory: str | Path, verify: bool = True) -> ImmutableSegment:
    """Load (and by default verify) a segment directory. Verification
    happens ONCE here — load time — never per query."""
    seg = ImmutableSegment(directory)
    if verify:
        seg.verify_integrity()
    return seg
