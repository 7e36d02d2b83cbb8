"""Device residency manager: host column planes -> padded device tensors.

The port of pinot_tpu/segment/device_cache.py. Each referenced column plane
is copied to the device ONCE per segment and cached. Planes are padded to a
shape bucket (next power of two), so every plane of a segment has the same
length; `num_docs` rides along as a runtime scalar and masks the pad rows.

A multi-value column lives on the device as a (padded, max_mv) int32
dict-id matrix padded with its cardinality. Narrow uint8/uint16 dict-id
planes stay narrow in device memory (1/4 or 1/2 of the int32 bytes) and
widen on use (ops/kernels.py `_apply_packed`, or in
registers inside the fused kernel). They default to on for a CUDA device and
off for the CPU.

A batch FAMILY of segments (engine/executor.py) reads `[S, ...]` stacks of
its members' planes from a StackedSegmentView: derived copies, cached under
the same byte budget and evicted wholesale before any member plane.

Cached partials (`put_partial`: the sparse device combine's per-segment
value-space tables, cache tier 2) stay on the device under the same
budget. They are derived data too and evict first, before any stack or
view. Under device-memory pressure `evict_all_except` sheds every partial,
every stack and every view but the executing segment's (engine/oom.py).

Concurrent queries share the views and stacks: each plane and each stack
is built exactly once, under its view's lock, so two threads asking for a
missing plane upload it once and the budget counts only what is kept.

While a trace is active, the dispatching thread arms per-thread transfer
counters (`reset_transfer_stats`): host->device bytes and stack hits and
misses, read back into the dispatch's `family_dispatch` span. Disarmed,
an upload pays one thread-local read.
"""

from __future__ import annotations

import threading
import weakref
from collections import OrderedDict
from typing import Optional

import numpy as np
import torch

from ..spi.data_types import DataType
from .loader import ImmutableSegment

_MIN_PAD = 1 << 13

# Per-thread transfer attribution for tracing (engine/executor.py arms it
# at a traced dispatch's start and folds it into the span at its end).
_TRANSFER_TL = threading.local()


def reset_transfer_stats() -> None:
    """Arm this thread's transfer counters (tracing on)."""
    _TRANSFER_TL.stats = {"transferBytes": 0, "transfers": {},
                          "stackHits": 0, "stackMisses": 0}


def clear_transfer_stats() -> None:
    _TRANSFER_TL.stats = None


def transfer_stats() -> Optional[dict]:
    """This thread's counters since the last reset, or None when disarmed:
    host->device bytes in all and per (column, plane kind), and stack
    hits and misses."""
    return getattr(_TRANSFER_TL, "stats", None)


def note_upload(key: tuple, nbytes: int) -> None:
    """Count an upload of `nbytes` for plane `key` into the armed counters
    (also called by realtime/device_plane.py for its delta uploads)."""
    stats = getattr(_TRANSFER_TL, "stats", None)
    if stats is not None:
        stats["transferBytes"] += nbytes
        slot = f"{key[0]}:{key[1]}"
        stats["transfers"][slot] = stats["transfers"].get(slot, 0) + nbytes


def _note_stack(hit: bool) -> None:
    stats = getattr(_TRANSFER_TL, "stats", None)
    if stats is not None:
        stats["stackHits" if hit else "stackMisses"] += 1


def pad_bucket(n: int) -> int:
    """Next power of two >= n (min 8192) — the plane shape bucket."""
    b = _MIN_PAD
    while b < n:
        b <<= 1
    return b


class SegmentDeviceView:
    """Device-resident planes for one segment, uploaded on first use and
    reused across queries."""

    def __init__(self, segment: ImmutableSegment, device: torch.device,
                 packed: Optional[bool] = None):
        self.segment = segment
        self.device = torch.device(device)
        # narrow id planes: on for CUDA, off for the CPU, unless asked
        self.packed = (self.device.type == "cuda") if packed is None \
            else bool(packed)
        self.padded = pad_bucket(max(1, segment.num_docs))
        self._planes: dict[tuple[str, str], torch.Tensor] = {}
        # get-or-create of a plane is atomic: a missing plane is built and
        # uploaded under this lock, once, however many threads ask
        self._lock = threading.Lock()

    def _plane(self, key: tuple[str, str], host) -> torch.Tensor:
        """The cached plane `key`, or `host()` uploaded and cached by the
        first caller while the others wait for it. Returned through a local
        reference, so a concurrent evict() never turns a read into a
        KeyError."""
        t = self._planes.get(key)
        if t is not None:
            return t
        with self._lock:
            t = self._planes.get(key)
            if t is None:
                t = self._put(key, host())
        return t

    def _put(self, key: tuple[str, str], host: np.ndarray) -> torch.Tensor:
        """Upload `host` as plane `key` and keep it: once per plane, under
        the view's lock."""
        t = torch.from_numpy(host).to(self.device)
        self._planes[key] = t
        note_upload(key, _tensor_bytes(t))
        return t

    def _padded_plane(self, values: np.ndarray, dtype) -> np.ndarray:
        out = np.zeros(self.padded, dtype=dtype)
        out[: values.shape[0]] = values
        return out

    def dict_ids(self, column: str) -> torch.Tensor:
        """Padded int32 dict-id plane (pad value 0; rows masked by num_docs)."""
        return self._plane((column, "ids"), lambda: self._padded_plane(
            self.segment.get_dict_ids(column), np.int32))

    def dict_ids_packed(self, column: str):
        """(plane, width): the id plane stored as uint8 for <= 8-bit ids and
        uint16 for <= 16-bit ids, width 8 or 16; (int32 plane, 0) for wider
        ids or when narrow planes are off."""
        bits = self.segment.column_metadata(column).bits_per_value or 32
        if not self.packed or bits > 16:
            return self.dict_ids(column), 0
        width = 8 if bits <= 8 else 16
        dtype = np.uint8 if width == 8 else np.uint16
        return self._plane((column, "ids_packed"), lambda: self._padded_plane(
            self.segment.get_dict_ids(column), dtype)), width

    def mv_dict_ids(self, column: str) -> torch.Tensor:
        """A multi-value column's (padded, max_mv) int32 dict-id matrix,
        every pad slot (and every pad row) holding the sentinel
        `cardinality`, which no predicate matches."""
        def host():
            mat = self.segment.get_mv_dict_id_matrix(column)
            card = self.segment.column_metadata(column).cardinality
            out = np.full((self.padded, mat.shape[1]), card, dtype=np.int32)
            out[: mat.shape[0]] = mat
            return out

        return self._plane((column, "mvids"), host)

    def raw(self, column: str) -> torch.Tensor:
        def host():
            vals = self.segment.get_raw(column)
            return self._padded_plane(vals, vals.dtype)

        return self._plane((column, "raw"), host)

    def raw_f32_rebased(self, column: str) -> torch.Tensor:
        """(v - column min) as a float32 plane: the histogram-binning view
        of a raw FLOAT/DOUBLE column (engine/plan.py slot kind rawf32r).
        The rebase runs on the host in float64 before the cast, as the
        JAX package's does, so both packages bin from the same bits; a
        narrow-range column of large values keeps its full precision."""
        def host():
            vals = self.segment.get_raw(column)
            base = float(self.segment.column_metadata(column).min_value)
            out = np.zeros(self.padded, dtype=np.float32)
            out[: vals.shape[0]] = (vals - base).astype(np.float32)
            return out

        return self._plane((column, "rawf32r"), host)

    def dict_values(self, column: str) -> torch.Tensor:
        """Numeric dictionary on the device, for on-device decode."""
        m = self.segment.column_metadata(column)
        if not DataType(m.data_type).is_fixed_width:
            raise ValueError(f"{column}: var-width dictionaries stay on the host")
        # a writable copy
        return self._plane((column, "dict"), lambda: np.array(
            self.segment.get_dictionary(column).values))

    def null_plane(self, column: str) -> torch.Tensor:
        def host():
            nulls = self.segment.get_null_bitmap(column)
            out = np.zeros(self.padded, dtype=bool)
            if nulls is not None:
                out[: nulls.shape[0]] = nulls
            return out

        return self._plane((column, "null"), host)

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in list(self._planes.values()))

    def evict(self) -> None:
        self._planes.clear()


class StackedSegmentView:
    """Device-resident [S, ...] planes stacked from the member views of a
    batch family. Each plane is a `torch.stack` of the members' cached
    planes, cached here so repeated queries over the same family skip the
    stack copies. Narrow uint8/uint16 id planes stay narrow in the stack."""

    def __init__(self, key: tuple, names: tuple = ()):
        # the members' id(segment)s in order; a consuming snapshot's member
        # is ("rt", name, snapshot_generation)
        self.key = key
        # the members' names: a dropped segment finds its stacks by name
        self.names = frozenset(str(n) for n in names)
        self._planes: dict[tuple, torch.Tensor] = {}
        # a missing stack is built under this lock, once (as
        # SegmentDeviceView._plane)
        self._lock = threading.Lock()

    def plane(self, plane_key: tuple, build) -> torch.Tensor:
        """The cached stack `plane_key`, built by `build()` by the first
        caller while the others wait; returned through a local reference,
        as SegmentDeviceView._plane."""
        t = self._planes.get(plane_key)
        if t is None:
            with self._lock:
                t = self._planes.get(plane_key)
                if t is None:
                    t = self._planes[plane_key] = build()
                    _note_stack(hit=False)
                    return t
        _note_stack(hit=True)
        return t

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in list(self._planes.values()))

    def evict(self) -> None:
        self._planes.clear()


def _tensor_bytes(t) -> int:
    return t.numel() * t.element_size()


# every DeviceSegmentCache alive in the process (one per executor), weakly
# held: a committed realtime segment is dropped by name from each of them
# (realtime/manager.py), so a replica's or a second executor's cache over
# the same table is reached too
_LIVE_CACHES: "weakref.WeakSet" = weakref.WeakSet()


def live_caches() -> list:
    """The DeviceSegmentCaches alive now."""
    return list(_LIVE_CACHES)


class DeviceSegmentCache:
    """Segment -> device-view cache with byte-budget LRU eviction: while
    the resident bytes exceed `budget_bytes`, cached partials go first
    (any of them, the newest too: a miss costs one dispatch), then the
    least recently used family stacks (derived data: a stack rebuilds from
    its members' planes without an upload), then the least recently used
    views; never the stack or view just touched."""

    def __init__(self, device, budget_bytes: Optional[int] = None):
        self.device = torch.device(device)
        self.budget_bytes = budget_bytes
        self._views: dict[int, SegmentDeviceView] = {}
        self._order: list[int] = []  # LRU, most recent last
        self._stacks: dict[tuple, StackedSegmentView] = {}
        self._stack_order: list[tuple] = []  # LRU, most recent last
        # key -> (tensors, nbytes, segment name); LRU, most recent last
        self._partials: OrderedDict[tuple, tuple] = OrderedDict()
        self.partial_hits = 0
        self.partial_misses = 0
        self.evictions = 0
        # the most bytes held at once, sampled before every release and at
        # each read of `high_water_bytes` (the hbmBytesHighWater gauge)
        self._high_water = 0
        self._lock = threading.Lock()
        _LIVE_CACHES.add(self)

    def view(self, segment: ImmutableSegment) -> SegmentDeviceView:
        key = id(segment)
        with self._lock:
            v = self._views.get(key)
            if v is None:
                v = self._views[key] = SegmentDeviceView(segment, self.device)
            if key in self._order:
                self._order.remove(key)
            self._order.append(key)
            self._maybe_evict()
            return v

    def stacked_view(self, segments: list) -> StackedSegmentView:
        """Get-or-create the stacked view of a batch family, identified by
        its ordered member segments. Consuming-segment snapshots are keyed
        by (name, snapshot_generation), not id(): a snapshot object is new
        on every query (and its id may be reused once it is collected), but
        an unchanged generation has the same plane contents, so a warm
        repeat reuses the stack. A newer generation supersedes the old
        stack, which is evicted at once (it can never be asked for again).
        A mutable object WITHOUT a pinned generation gets an uncached view
        (it could never be hit again and would only hold dead device
        bytes)."""
        members = []
        rt_names = set()
        names = tuple(getattr(s, "name", "") for s in segments)
        for s in segments:
            if not getattr(s, "is_mutable", False):
                members.append(id(s))
                continue
            gen = getattr(s, "snapshot_generation", None)
            if gen is None:
                return StackedSegmentView(tuple(id(m) for m in segments),
                                          names)
            rt_names.add(str(s.name))
            members.append(("rt", str(s.name), gen))
        key = tuple(members)
        with self._lock:
            if rt_names and key not in self._stacks:
                for skey in [k for k in self._stacks if any(
                        isinstance(m, tuple) and m[0] == "rt"
                        and m[1] in rt_names for m in k)]:
                    self._stacks.pop(skey).evict()
                    self._stack_order.remove(skey)
                    self.evictions += 1
            sv = self._stacks.get(key)
            if sv is None:
                sv = self._stacks[key] = StackedSegmentView(key, names)
            if key in self._stack_order:
                self._stack_order.remove(key)
            self._stack_order.append(key)
            self._maybe_evict()
            return sv

    def warm(self, segment: ImmutableSegment,
             columns: Optional[list] = None) -> int:
        """Upload a segment's column planes before the first query needs
        them; returns the planes uploaded. Dict-encoded columns warm their
        (narrow) id planes and, for numeric dictionaries, their values; raw
        columns their value plane and, for FLOAT/DOUBLE, the rebased f32
        plane the percentile histograms bin from; multi-value columns their
        id matrix. Var-width and CLP columns have no device plane."""
        v = self.view(segment)
        n = 0
        for col in (columns or segment.columns()):
            m = segment.column_metadata(col)
            if not m.single_value:
                v.mv_dict_ids(col)
                n += 1
            elif m.encoding == "DICT":
                v.dict_ids_packed(col)
                n += 1
                if np.asarray(segment.get_dictionary(col).values).dtype.kind \
                        in "iuf":
                    v.dict_values(col)
                    n += 1
            elif m.encoding == "RAW" and DataType(m.data_type).is_fixed_width:
                v.raw(col)
                n += 1
                if m.data_type in ("FLOAT", "DOUBLE") \
                        and m.min_value is not None:
                    v.raw_f32_rebased(col)
                    n += 1
        return n

    # -- device-resident cached partials (cache tier 2) ---------------------
    def put_partial(self, key: tuple, tensors: tuple,
                    segment_name: str) -> None:
        """Keep a cached partial (a tuple of device tensors: a sparse group
        table's keys, counts and state columns) against the byte budget.
        A partial larger than the whole budget is not kept."""
        nbytes = sum(_tensor_bytes(t) for t in tensors)
        with self._lock:
            if self.budget_bytes is not None and nbytes > self.budget_bytes:
                return
            old = self._partials.pop(key, None)
            self._partials[key] = (tuple(tensors), nbytes, str(segment_name))
            if old is None:
                self._maybe_evict()

    def get_partial(self, key: tuple) -> Optional[tuple]:
        with self._lock:
            ent = self._partials.get(key)
            if ent is None:
                self.partial_misses += 1
                return None
            self._partials.move_to_end(key)
            self.partial_hits += 1
            return ent[0]

    def drop_partials(self, segment_name: Optional[str] = None) -> int:
        """Evict cached partials: all of them, or those derived from
        `segment_name` (a segment replaced or deleted). Returns how many."""
        with self._lock:
            stale = [k for k, ent in self._partials.items()
                     if segment_name is None or ent[2] == str(segment_name)]
            for k in stale:
                del self._partials[k]
            self.evictions += len(stale)
            return len(stale)

    def drop(self, segment) -> None:
        """Release a retired segment's device planes, every stack holding
        it (by member id, or by name for a stack of an earlier incarnation
        of it) and its cached partials."""
        key = id(segment)
        name = getattr(segment, "name", None)
        with self._lock:
            self._note_high_water()
            victims = 0
            v = self._views.pop(key, None)
            if v is not None:
                v.evict()
                victims += 1
            if key in self._order:
                self._order.remove(key)
            for skey in [k for k, sv in self._stacks.items()
                         if key in k
                         or (name is not None and str(name) in sv.names)]:
                self._stacks.pop(skey).evict()
                self._stack_order.remove(skey)
                victims += 1
            if name is not None:
                for pkey in [k for k, ent in self._partials.items()
                             if ent[2] == str(name)]:
                    del self._partials[pkey]
                    victims += 1
            self.evictions += victims

    def drop_named(self, segment_name: str) -> int:
        """Release every view, stack and partial derived from a segment of
        this name, when the segment object is no longer in hand (views and
        stacks are keyed by id(segment)). Returns the bytes freed."""
        name = str(segment_name)
        freed = victims = 0
        with self._lock:
            self._note_high_water()
            dead = [k for k, v in self._views.items()
                    if str(getattr(v.segment, "name", "")) == name]
            for key in dead:
                v = self._views.pop(key)
                freed += v.nbytes()
                v.evict()
                if key in self._order:
                    self._order.remove(key)
                victims += 1
            dead_ids = set(dead)
            for skey in [k for k, sv in self._stacks.items()
                         if name in sv.names or dead_ids.intersection(k)]:
                sv = self._stacks.pop(skey)
                freed += sv.nbytes()
                sv.evict()
                self._stack_order.remove(skey)
                victims += 1
            for pkey in [k for k, ent in self._partials.items()
                         if ent[2] == name]:
                freed += self._partials.pop(pkey)[1]
                victims += 1
            self.evictions += victims
        return freed

    def release(self, segment) -> int:
        """Release the device view of this segment OBJECT and every family
        stack it is a member of, by id (a tiered server's evicted copy,
        once its last reader has drained). The caller keeps the object
        alive until this returns, so its id names no other segment; a
        newer incarnation of the same name keeps its own view and stacks.
        Returns the bytes freed."""
        key = id(segment)
        freed = victims = 0
        with self._lock:
            self._note_high_water()
            v = self._views.get(key)
            if v is not None and v.segment is segment:
                del self._views[key]
                freed += v.nbytes()
                v.evict()
                if key in self._order:
                    self._order.remove(key)
                victims += 1
            for skey in [k for k in self._stacks if key in k]:
                sv = self._stacks.pop(skey)
                freed += sv.nbytes()
                sv.evict()
                self._stack_order.remove(skey)
                victims += 1
            self.evictions += victims
        return freed

    def evict_all_except(self, keep_segment=None) -> tuple[int, int]:
        """Device-memory pressure relief (engine/oom.py): evict every
        cached partial, then every stack, then every view but
        `keep_segment`'s. Returns (bytes freed, victims)."""
        keep_key = id(keep_segment) if keep_segment is not None else None
        freed = victims = 0
        with self._lock:
            self._note_high_water()
            for _, nbytes, _ in self._partials.values():
                freed += nbytes
                victims += 1
            self._partials.clear()
            for sv in self._stacks.values():
                freed += sv.nbytes()
                sv.evict()
                victims += 1
            self._stacks.clear()
            self._stack_order.clear()
            for key in [k for k in self._views if k != keep_key]:
                v = self._views.pop(key)
                freed += v.nbytes()
                v.evict()
                self._order.remove(key)
                victims += 1
            self.evictions += victims
        return freed, victims

    def segment_names(self) -> set:
        """The names of the segments this cache holds a view, a stack
        member or a partial of."""
        with self._lock:
            out = {str(getattr(v.segment, "name", ""))
                   for v in self._views.values()}
            for sv in self._stacks.values():
                out |= sv.names
            out |= {ent[2] for ent in self._partials.values()}
        return out

    def stats(self) -> dict:
        """Resident bytes by kind, and the partial tier's counters."""
        with self._lock:
            return {"viewBytes": sum(v.nbytes() for v in self._views.values()),
                    "stackBytes": sum(s.nbytes()
                                      for s in self._stacks.values()),
                    "partialEntries": len(self._partials),
                    "partialBytes": sum(e[1] for e in self._partials.values()),
                    "partialHits": self.partial_hits,
                    "partialMisses": self.partial_misses,
                    "evictions": self.evictions}

    def bytes_used(self) -> int:
        with self._lock:
            return self._bytes_locked()

    def hbm_stats(self) -> dict:
        """The card bytes this cache holds against its budget (None: no
        budget), under the JAX device cache's `hbm_stats` keys: the
        server's `status` beacon and the health scrape's hbm-pressure
        rule read it."""
        with self._lock:
            partial_bytes = sum(e[1] for e in self._partials.values())
            return {"hbmBytesUsed": self._bytes_locked(),
                    "hbmBudgetBytes": self.budget_bytes,
                    "hbmEvictions": self.evictions,
                    "hbmPartialEntries": len(self._partials),
                    "hbmPartialBytes": partial_bytes}

    def _bytes_locked(self) -> int:
        return (sum(v.nbytes() for v in self._views.values())
                + sum(s.nbytes() for s in self._stacks.values())
                + sum(e[1] for e in self._partials.values()))

    def _note_high_water(self) -> None:
        # caller holds self._lock
        self._high_water = max(self._high_water, self._bytes_locked())

    def high_water_bytes(self) -> int:
        """The most bytes this cache held at once, as far as it sampled:
        before each release and at each call."""
        with self._lock:
            self._note_high_water()
            return self._high_water

    def _maybe_evict(self) -> None:
        # caller holds self._lock. Planes upload (and stacks build) lazily
        # after view() / stacked_view(), so the budget is enforced on the
        # next call of either (or of put_partial).
        if self.budget_bytes is None:
            return
        total = (sum(v.nbytes() for v in self._views.values())
                 + sum(s.nbytes() for s in self._stacks.values())
                 + sum(e[1] for e in self._partials.values()))
        while total > self.budget_bytes and self._partials:
            _, (_, freed, _) = self._partials.popitem(last=False)
            total -= freed
            self.evictions += 1
        while total > self.budget_bytes and len(self._stack_order) > 1:
            victim = self._stack_order.pop(0)
            total -= self._stacks[victim].nbytes()
            self._stacks.pop(victim).evict()
            self.evictions += 1
        while total > self.budget_bytes and len(self._order) > 1:
            victim = self._order.pop(0)
            total -= self._views[victim].nbytes()
            self._views.pop(victim).evict()
            self.evictions += 1
