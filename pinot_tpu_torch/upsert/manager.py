"""Upsert metadata manager: pk → latest doc, valid-doc bitmaps, partial merge.

The port of pinot_tpu/upsert/manager.py. Reference analogue:
- ConcurrentMapPartitionUpsertMetadataManager (pinot-segment-local/.../
  upsert/ConcurrentMapPartitionUpsertMetadataManager.java:48): concurrent
  pk→RecordLocation map, per-segment validDocIds bitmaps, comparison-column
  conflict resolution (newer wins, ties go to the later arrival).
- PartialUpsertHandler (.../upsert/PartialUpsertHandler.java): per-column
  merge strategies applied against the previous version of the row.
- ConcurrentMapPartitionDedupMetadataManager (.../dedup/): pk-presence map
  that drops duplicate ingested rows.

Validity is a dense numpy bool plane per segment: the planner ANDs it into
the filter as an `ir.MaskParam` plane (engine/plan.py `_and_valid_docs`,
evaluated in ops/kernels.py), so upsert tables query on the device at
kernel speed; there is no RoaringBitmap in the hot path.
"""

from __future__ import annotations

import itertools
import threading
from typing import Optional

import numpy as np

from ..spi.data_types import Schema
from ..spi.table_config import TableConfig


class ValidDocIds:
    """Growable per-segment validity plane (reference: per-segment
    ThreadSafeMutableRoaringBitmap validDocIds)."""

    def __init__(self, n: int = 0):
        self._mask = np.zeros(max(n, 64), dtype=bool)
        self._n = n
        self._generation = 0
        self._lock = threading.Lock()

    def ensure(self, n: int) -> None:
        with self._lock:
            self._ensure_nolock(n)

    def _ensure_nolock(self, n: int) -> None:
        if n > len(self._mask):
            grown = np.zeros(max(n, 2 * len(self._mask)), dtype=bool)
            grown[: len(self._mask)] = self._mask
            self._mask = grown
        self._n = max(self._n, n)

    def set(self, doc_id: int, valid: bool) -> None:
        # grow-and-write under one lock so a concurrent ensure() can't swap
        # the array out between the two steps and drop this write
        with self._lock:
            self._ensure_nolock(doc_id + 1)
            self._mask[doc_id] = valid
            self._generation += 1

    def mask(self, n: int) -> np.ndarray:
        """Validity for the first n docs (query snapshot)."""
        with self._lock:
            out = np.zeros(n, dtype=bool)
            m = min(n, len(self._mask))
            out[:m] = self._mask[:m]
            return out

    def snapshot(self, n: int) -> tuple:
        """Atomic (mask, generation) pair for the first n docs.

        A snapshot view pins this pair so the host and device paths read
        identical validity even while upserts continue to mutate the live
        plane."""
        with self._lock:
            out = np.zeros(n, dtype=bool)
            m = min(n, len(self._mask))
            out[:m] = self._mask[:m]
            return out, self._generation

    def num_valid(self, n: Optional[int] = None) -> int:
        with self._lock:
            m = self._mask if n is None else self._mask[:n]
            return int(m.sum())


class PartialUpsertHandler:
    """Column-merge strategies for PARTIAL mode. Unspecified columns
    default to OVERWRITE (reference default); pk + comparison columns are
    never merged."""

    def __init__(self, strategies: dict[str, str], exclude: set):
        self.strategies = {k: v.upper() for k, v in strategies.items()}
        self.exclude = exclude

    def merge(self, prev: dict, new: dict) -> dict:
        out = dict(new)
        for col, pv in prev.items():
            if col in self.exclude:
                continue
            nv = out.get(col)
            strat = self.strategies.get(col, "OVERWRITE")
            if nv is None and strat != "FORCE_OVERWRITE":
                out[col] = pv  # null new value keeps previous (reference)
                continue
            if strat in ("OVERWRITE", "FORCE_OVERWRITE"):
                continue
            if strat == "IGNORE":
                out[col] = pv
            elif strat == "INCREMENT":
                out[col] = (pv or 0) + (nv or 0)
            elif strat == "APPEND":
                out[col] = _as_list(pv) + _as_list(nv)
            elif strat == "UNION":
                merged = _as_list(pv)
                for v in _as_list(nv):
                    if v not in merged:
                        merged.append(v)
                out[col] = merged
            elif strat == "MAX":
                out[col] = max(pv, nv)
            elif strat == "MIN":
                out[col] = min(pv, nv)
            else:
                raise ValueError(f"unknown partial-upsert strategy {strat}")
        return out


def _as_list(v) -> list:
    if v is None:
        return []
    if isinstance(v, (list, tuple, np.ndarray)):
        return list(v)
    return [v]


class TableUpsertMetadataManager:
    """Tracks the latest doc per primary key across a table's segments and
    maintains each segment's validity plane."""

    def __init__(self, schema: Schema, table_config: TableConfig):
        cfg = table_config.upsert
        self.mode = cfg.mode.upper()
        self.pk_columns = list(schema.primary_key_columns)
        if not self.pk_columns:
            raise ValueError("upsert requires schema.primary_key_columns")
        self.cmp_column = cfg.comparison_columns[0] if cfg.comparison_columns \
            else table_config.validation.time_column_name
        self._seq = itertools.count()  # arrival order, also the tie-breaker
        self._lock = threading.RLock()
        # pk tuple → (segment, doc_id, cmp_value, arrival_seq)
        self._map: dict[tuple, tuple] = {}
        # TTL + deletes (reference: UpsertConfig.metadataTTL /
        # deleteRecordColumn / deletedKeysTTL)
        self.metadata_ttl = float(cfg.metadata_ttl or 0.0)
        self.delete_column = cfg.delete_record_column or None
        self.deleted_keys_ttl = float(cfg.deleted_keys_ttl or 0.0)
        self.consistency_mode = (cfg.consistency_mode or "NONE").upper()
        # SYNC: every validity plane is CREATED with the manager's lock so
        # mask() snapshots serialize against invalidate+validate pairs — no
        # after-the-fact lock swap (which would race in-flight readers)
        self._shared_lock = self._lock if self.consistency_mode == "SYNC" \
            else None
        self._watermark = None  # max comparison value observed
        # pk → (cmp_value at delete time); tombstones suppress older rows
        self._deleted: dict[tuple, object] = {}
        self.partial_handler = None
        if self.mode == "PARTIAL":
            self.partial_handler = PartialUpsertHandler(
                cfg.partial_upsert_strategies,
                exclude=set(self.pk_columns) | ({self.cmp_column}
                                                if self.cmp_column else set()))

    # -- ingestion hooks ----------------------------------------------------
    def process_row(self, segment, row: dict) -> Optional[dict]:
        """Pre-index hook: PARTIAL mode merges with the previous version."""
        if self.partial_handler is None:
            return row
        pk = self._pk(row)
        with self._lock:
            loc = self._map.get(pk)
        if loc is None:
            return row
        prev = self._read_row(loc[0], loc[1])
        return self.partial_handler.merge(prev, row)

    def add_record(self, segment, doc_id: int, row: dict) -> None:
        """Post-index hook: resolve the pk conflict (newer comparison value
        wins; ties go to the later arrival — reference
        ConcurrentMapPartitionUpsertMetadataManager.addOrReplaceRecord).
        A truthy delete column tombstones the key instead."""
        pk = self._pk(row)
        cmp_val = row.get(self.cmp_column) if self.cmp_column else None
        seq = next(self._seq)
        valid = _validity_of(segment, self._shared_lock)
        with self._lock:
            if cmp_val is not None and (
                    self._watermark is None or cmp_val > self._watermark):
                self._watermark = cmp_val
            if self.delete_column and row.get(self.delete_column):
                # delete record: resolved through the SAME comparison order
                # as upserts — a late out-of-order delete must not clobber a
                # newer live row or a newer tombstone
                valid.set(doc_id, False)  # the delete row itself never serves
                loc = self._map.get(pk)
                if loc is not None and not _newer(cmp_val, seq, loc):
                    return  # older than the live row: delete loses
                tomb = self._deleted.get(pk, _MISSING)
                if tomb is not _MISSING and not _cmp_newer(cmp_val, tomb):
                    return  # older than the existing tombstone
                if loc is not None:
                    del self._map[pk]
                    _validity_of(loc[0], self._shared_lock).set(loc[1], False)
                self._deleted[pk] = cmp_val
                return
            tomb = self._deleted.get(pk, _MISSING)
            if tomb is not _MISSING and not _cmp_newer(cmp_val, tomb):
                valid.set(doc_id, False)  # older than its delete
                return
            if tomb is not _MISSING:
                del self._deleted[pk]  # resurrected by a newer row
            loc = self._map.get(pk)
            if loc is None or _newer(cmp_val, seq, loc):
                if loc is not None:
                    _validity_of(loc[0], self._shared_lock).set(loc[1], False)
                valid.set(doc_id, True)
                self._map[pk] = (segment, doc_id, cmp_val, seq)
            else:
                valid.set(doc_id, False)

    def remove_expired_metadata(self) -> int:
        """Drop pk entries (and delete tombstones) whose comparison value
        trails the high-watermark by more than the TTL — the reference's
        removeExpiredPrimaryKeys periodic task. Validity planes keep their
        current state; the keys simply stop being tracked (and so stop
        costing memory). Returns the number of entries dropped."""
        dropped = 0
        with self._lock:
            if self._watermark is None:
                return 0
            if self.metadata_ttl > 0:
                floor = self._watermark - self.metadata_ttl
                for pk, loc in list(self._map.items()):
                    if loc[2] is not None and loc[2] < floor:
                        del self._map[pk]
                        dropped += 1
            if self.deleted_keys_ttl > 0:
                floor = self._watermark - self.deleted_keys_ttl
                for pk, cmp_val in list(self._deleted.items()):
                    if cmp_val is not None and cmp_val < floor:
                        del self._deleted[pk]
                        dropped += 1
        return dropped

    # -- segment lifecycle --------------------------------------------------
    def replace_segment(self, old, new) -> None:
        """Consuming segment committed → immutable with IDENTICAL doc order
        (the converter must not re-sort upsert tables). Moves the validity
        plane and remaps record locations (reference:
        replaceSegment in the metadata manager)."""
        with self._lock:
            # mask copy + remap must be one atomic step: a concurrent
            # add_record invalidating a doc in `old` between them would be
            # lost, leaving a superseded row valid forever
            old_valid = _validity_of(old, self._shared_lock)
            new_valid = _validity_of(new, self._shared_lock)
            n = new.num_docs
            m = old_valid.mask(n)
            for d in np.nonzero(m)[0]:
                new_valid.set(int(d), True)
            new_valid.ensure(n)
            for pk, (seg, doc, cmp_val, seq) in list(self._map.items()):
                if seg is old:
                    self._map[pk] = (new, doc, cmp_val, seq)

    def remove_segment(self, segment) -> None:
        with self._lock:
            for pk, loc in list(self._map.items()):
                if loc[0] is segment:
                    del self._map[pk]

    def add_segment(self, segment) -> None:
        """Bootstrap metadata from a committed segment (restart recovery —
        reference: addSegment replays validDocIds from pk + comparison
        columns). Call in commit order."""
        n = segment.num_docs
        cols = {c: _column_values(segment, c) for c in self.pk_columns}
        cmp_vals = (_column_values(segment, self.cmp_column)
                    if self.cmp_column else None)
        for d in range(n):
            row = {c: _item(cols[c][d]) for c in self.pk_columns}
            if cmp_vals is not None:
                row[self.cmp_column] = _item(cmp_vals[d])
            self.add_record(segment, d, row)

    # -- introspection ------------------------------------------------------
    def num_primary_keys(self) -> int:
        with self._lock:
            return len(self._map)

    # -- internals ----------------------------------------------------------
    def _pk(self, row: dict) -> tuple:
        return tuple(row.get(c) for c in self.pk_columns)

    @staticmethod
    def _read_row(segment, doc_id: int) -> dict:
        return {c: segment.read_cell(c, doc_id) for c in segment.columns()}


_MISSING = object()


def _newer(cmp_val, seq: int, loc: tuple) -> bool:
    old_cmp, old_seq = loc[2], loc[3]
    if cmp_val is None or old_cmp is None:
        return seq >= old_seq
    if cmp_val != old_cmp:
        return cmp_val > old_cmp
    return seq >= old_seq


def _cmp_newer(cmp_val, tomb_cmp) -> bool:
    """Is a row at cmp_val newer than (or concurrent with) its tombstone?"""
    if cmp_val is None or tomb_cmp is None:
        return True  # no comparison values: arrival order → row is later
    return cmp_val >= tomb_cmp


def _validity_of(segment, shared_lock=None) -> ValidDocIds:
    """The segment's validity plane, created on first touch. ``shared_lock``
    (SYNC consistency) becomes the plane's lock AT CREATION — the reference
    ConsistencyMode SYNC's read-write lock; swapping a live plane's lock
    would race in-flight readers, so planes created elsewhere keep theirs."""
    v = getattr(segment, "valid_doc_ids", None)
    if v is None:
        v = ValidDocIds(segment.num_docs)
        if shared_lock is not None:
            v._lock = shared_lock
        segment.valid_doc_ids = v
    return v


def _item(v):
    return v.item() if isinstance(v, np.generic) else v


def _column_values(segment, column: str) -> np.ndarray:
    """Every value of a single-value column, immutable or mutable."""
    return segment.get_values_at(column, np.arange(segment.num_docs))


class TableDedupManager:
    """Drops rows whose primary key was already ingested (reference:
    ConcurrentMapPartitionDedupMetadataManager — presence map, optional
    TTL on the metadata)."""

    def __init__(self, schema: Schema, table_config: TableConfig):
        if not schema.primary_key_columns:
            raise ValueError("dedup requires schema.primary_key_columns")
        self.pk_columns = list(schema.primary_key_columns)
        self._seen: set[tuple] = set()
        self._lock = threading.Lock()

    def process_row(self, segment, row: dict) -> Optional[dict]:
        pk = tuple(row.get(c) for c in self.pk_columns)
        with self._lock:
            if pk in self._seen:
                return None
            self._seen.add(pk)
        return row

    def add_record(self, segment, doc_id: int, row: dict) -> None:
        pass

    def replace_segment(self, old, new) -> None:
        pass

    def remove_segment(self, segment) -> None:
        pass

    def add_segment(self, segment) -> None:
        n = segment.num_docs
        cols = {c: _column_values(segment, c) for c in self.pk_columns}
        with self._lock:
            for d in range(n):
                self._seen.add(tuple(_item(cols[c][d]) for c in self.pk_columns))

    def num_primary_keys(self) -> int:
        with self._lock:
            return len(self._seen)
