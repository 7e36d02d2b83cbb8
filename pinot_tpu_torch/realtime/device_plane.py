"""Realtime device planes: consuming segments on the device path.

The port of pinot_tpu/realtime/device_plane.py. A consuming (mutable)
segment is append-only below every published row count: once
`MutableSegment.index()` publishes `num_docs = n`, rows `< n` (forward ids,
raw values, null docs, the dictionary entries they reference) never change
again. This module keeps per-column device-resident planes for each
consuming segment on that invariant:

- Planes live in power-of-two row buckets (`pad_bucket`, the shape bucket
  of every segment plane). Capacity grows on the device when a snapshot
  outgrows its bucket: a larger zero tensor, the old prefix copied in, no
  host->device traffic.
- On a query, only the rows appended since the last uploaded watermark go
  host->device, written in place (`plane[rows:rows + chunk].copy_(...)`,
  the counterpart of the reference's `dynamic_update_slice` with a runtime
  start). Delta bytes are counted (`realtime_stats`) and are proportional
  to new rows, never to the snapshot's size; an unchanged generation
  uploads nothing.
- Kernels read the plane cut to the snapshot's pad bucket and mask rows
  `>= num_docs` (the pad-row rule of every plane), so a consuming segment
  gives the rows an immutable segment of the same data would.
- Upsert tables ride the same planes: the snapshot view pins the validity
  mask with its upsert generation (`ValidDocIds.snapshot`), and the planner
  ships it as an `ir.MaskParam` plane, as for an immutable upsert segment.

The `realtime.upload` fault seam (spi/faults.py) fires before a delta
touches device state. An error fault, or a delay past the upload budget
(`PINOT_TPU_RT_UPLOAD_BUDGET_MS`, default 100), raises RealtimeUploadError
and leaves every plane and watermark as it was; an injected corruption
drops the segment's whole plane set, so the next query uploads it again
from row 0. The JAX package answers the failed query on its host engine;
the port does not hide the device, so the query fails with that error,
under every QueryExecutor backend.

`RealtimeSegmentPlanner` lowers plans against a pinned `MutableSegmentView`:
the insertion-ordered mutable dictionary breaks the sorted-id-interval
RANGE lowering, so ranges lower to value-space boolean LUTs; MV and
rebased-float planes are refused, as is every shape under `SET
realtimeDevicePlanes = false`: UnsupportedQueryError, which QueryExecutor's
backend "auto" answers on the host engine for that snapshot alone (as the
JAX package does) and the default "device" raises.
"""

from __future__ import annotations

import os
import threading
import time
import weakref
from typing import Optional

import numpy as np
import torch

from ..engine import ir
from ..engine.aggregation import UnsupportedQueryError
from ..engine.executor import _dict_pad
from ..engine.plan import SegmentPlanner, _coerce_like
from ..query.filter import PredicateType
from ..segment.device_cache import note_upload, pad_bucket
from ..spi import faults
from ..spi.data_types import DataType
from ..spi.metrics import SERVER_METRICS, ServerMeter

# smallest delta chunk written in one upload: power-of-two chunks bound the
# distinct write shapes to log2(bucket) while keeping upload bytes
# proportional to new rows (the JAX package's chunking, byte for byte)
_MIN_CHUNK = 256


class RealtimeUploadError(Exception):
    """A delta upload failed (an injected fault, a delay past the upload
    budget; planes and watermarks keep their state from before it, or the
    whole set was dropped on a corruption), or a plane this port keeps on
    the host for consuming segments was asked for (an MV id matrix, a
    rebased float plane; the planner refuses those slots first)."""


def realtime_device_enabled(query=None) -> bool:
    """The per-query `SET realtimeDevicePlanes = true|false` option (default
    on). Off asks for the JAX package's host scan, which the port does not
    have: realtime_plan refuses such a query."""
    for k, v in getattr(query, "query_options", {}).items():
        if str(k).lower() == "realtimedeviceplanes":
            return str(v).strip().lower() not in ("0", "false", "off")
    return True


def _upload_budget_ms() -> float:
    try:
        return float(os.environ.get("PINOT_TPU_RT_UPLOAD_BUDGET_MS", "100"))
    except ValueError:
        return 100.0


# -- per-query upload attribution --------------------------------------------

_TLS = threading.local()


def reset_realtime_stats() -> None:
    """Arm this thread's delta-upload counters."""
    _TLS.stats = {"deltaBytes": 0, "uploads": 0, "deviceQueries": 0}


def realtime_stats() -> Optional[dict]:
    return getattr(_TLS, "stats", None)


def _note_delta(nbytes: int) -> None:
    st = getattr(_TLS, "stats", None)
    if st is not None:
        st["deltaBytes"] += nbytes
        st["uploads"] += 1


def note_realtime_device_query() -> None:
    """One query answered over a consuming segment on the device path."""
    SERVER_METRICS.add_meter(ServerMeter.REALTIME_DEVICE_QUERIES, 1)
    st = getattr(_TLS, "stats", None)
    if st is not None:
        st["deviceQueries"] += 1


# -- device plane store -------------------------------------------------------


class _Plane:
    """One device tensor and its uploaded-row watermark. For dictionary
    planes `rows` counts uploaded dictionary entries instead."""

    __slots__ = ("arr", "rows")

    def __init__(self):
        self.arr: Optional[torch.Tensor] = None
        self.rows = 0


def _chunk_len(delta: int, room: int) -> int:
    """Power-of-two write chunk >= delta, clipped to the rows left before
    the plane's capacity. Zeros beyond the delta land strictly above the
    new watermark (not yet uploaded), so they never clobber uploaded
    data."""
    c = _MIN_CHUNK
    while c < delta:
        c <<= 1
    return min(c, room)


def _torch_dtype(dtype: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.zeros(0, dtype=dtype)).dtype


class RealtimePlaneSet:
    """Append-only device planes of ONE consuming segment on one device,
    shared by every query and snapshot over it. Holds the segment's NAME
    only: the registry's weak key owns the lifetime, and a strong segment
    reference here would keep the entry alive forever."""

    def __init__(self, name: str, device: torch.device,
                 registry: "RealtimePlaneRegistry"):
        self.name = name
        self.device = device
        self.registry = registry
        self._planes: dict[tuple[str, str], _Plane] = {}
        self._lock = threading.Lock()
        self._gen_rows = 0  # highest row watermark any plane reached

    def _fire_fault(self, column: str, kind: str, nbytes: int) -> None:
        """The `realtime.upload` seam, called with self._lock held before
        the delta touches device state."""
        if not faults.ACTIVE:
            return
        t0 = time.perf_counter()
        try:
            faults.FAULTS.fire("realtime.upload", segment=self.name,
                               column=column, plane=kind, nbytes=nbytes)
        except faults.InjectedCorruption as c:
            # a damaged delta on the device would poison every later query:
            # drop the whole set, the next query uploads it from row 0
            self._planes.clear()
            raise RealtimeUploadError(
                f"injected corruption uploading {self.name}.{column}: "
                f"plane set dropped, full re-upload next query") from c
        except faults.InjectedFault as e:
            raise RealtimeUploadError(
                f"injected fault uploading {self.name}.{column}") from e
        # a delay fault sleeps inside fire(): hold the upload budget
        waited_ms = (time.perf_counter() - t0) * 1000.0
        budget = _upload_budget_ms()
        if waited_ms > budget:
            raise RealtimeUploadError(
                f"delta upload for {self.name}.{column} stalled "
                f"{waited_ms:.0f}ms > budget {budget:.0f}ms")

    def _account(self, nbytes: int) -> None:
        note_upload((f"rt:{self.name}", "delta"), nbytes)
        SERVER_METRICS.add_meter(
            ServerMeter.REALTIME_DELTA_UPLOAD_BYTES, nbytes)
        _note_delta(nbytes)
        self.registry._note(nbytes)

    def _ensure_capacity(self, st: _Plane, padded: int, dtype) -> None:
        if st.arr is None:
            st.arr = torch.zeros(padded, dtype=_torch_dtype(dtype),
                                 device=self.device)
        elif st.arr.shape[0] < padded:
            # grow on the device: the old plane copied into a larger zero
            # bucket, no host->device traffic
            grown = torch.zeros(padded, dtype=st.arr.dtype,
                                device=self.device)
            grown[:st.arr.shape[0]].copy_(st.arr)
            st.arr = grown

    def _upload(self, st: _Plane, delta: np.ndarray, dtype, column: str,
                kind: str) -> None:
        """Write `delta` at the watermark as one power-of-two chunk, after
        the fault seam."""
        self._fire_fault(column, kind, int(delta.nbytes))
        chunk = _chunk_len(len(delta), st.arr.shape[0] - st.rows)
        upd = np.zeros(chunk, dtype=dtype)
        upd[:len(delta)] = delta
        st.arr[st.rows:st.rows + chunk].copy_(torch.from_numpy(upd))
        self._account(int(upd.nbytes))

    # -- plane builders -----------------------------------------------------
    def row_plane(self, view, column: str, kind: str) -> torch.Tensor:
        """Device plane for (column, kind in ids|raw|null), delta-uploaded
        up to the view's pinned row count and cut to its pad bucket."""
        col = view._seg.column(column)
        n = view.num_docs
        padded = pad_bucket(max(1, n))
        if kind == "ids":
            slicer, dtype = col.ids_slice, np.dtype(np.int32)
        elif kind == "raw":
            if not col.data_type.is_numeric:
                raise RealtimeUploadError(f"{column}: non-numeric raw plane")
            # the SPI storage dtype, not the mutable buffer's, so the plane
            # matches what the immutable path uploads (family keys and
            # kernel dtypes line up across hybrid members)
            slicer, dtype = col.raw_slice, col.data_type.numpy_dtype
        elif kind == "null":
            slicer, dtype = col.null_slice, np.dtype(bool)
        else:  # pragma: no cover - the planner asks only for the above
            raise ValueError(kind)
        with self._lock:
            st = self._planes.setdefault((column, kind), _Plane())
            self._ensure_capacity(st, padded, dtype)
            if st.rows < n:
                self._upload(st, slicer(st.rows, n), dtype, column, kind)
                st.rows = n
                if n > self._gen_rows:
                    self._gen_rows = n
                    SERVER_METRICS.add_meter(
                        ServerMeter.REALTIME_PLANE_GENERATIONS, 1)
                    self.registry.generations += 1
            arr = st.arr
        return arr if arr.shape[0] == padded else arr[:padded]

    def dict_plane(self, view, column: str) -> torch.Tensor:
        """Device dictionary-values plane, delta-uploaded up to the view's
        pinned cardinality and padded to its _dict_pad bucket (pad entries
        are never gathered: the prefix's ids stay below the pinned card)."""
        col = view._seg.column(column)
        card = view.pinned_cardinality(column)
        if not col.data_type.is_numeric:
            raise RealtimeUploadError(f"{column}: non-numeric dict plane")
        dtype = col.data_type.numpy_dtype
        target = _dict_pad(card)
        with self._lock:
            st = self._planes.setdefault((column, "dict"), _Plane())
            self._ensure_capacity(st, max(target, 1), dtype)
            if st.rows < card:
                self._upload(st, col.dict_values_numeric(st.rows, card),
                             dtype, column, "dict")
                st.rows = card
            arr = st.arr
        return arr if arr.shape[0] == target else arr[:target]

    # -- bookkeeping --------------------------------------------------------
    def nbytes(self) -> int:
        with self._lock:
            return sum(p.arr.numel() * p.arr.element_size()
                       for p in self._planes.values() if p.arr is not None)

    def evict(self) -> None:
        with self._lock:
            self._planes.clear()

    def watermark(self, column: str, kind: str) -> int:
        """Uploaded-row watermark of one plane."""
        with self._lock:
            st = self._planes.get((column, kind))
            return st.rows if st is not None else 0

    def capacity(self, column: str, kind: str) -> int:
        """Rows the plane holds on the device (its pow2 bucket)."""
        with self._lock:
            st = self._planes.get((column, kind))
            return 0 if st is None or st.arr is None else st.arr.shape[0]


class RealtimeDeviceView:
    """Per-query adapter: the SegmentDeviceView read API over one snapshot
    view and the segment's shared plane set. `padded` is the SNAPSHOT's pad
    bucket: a plane whose capacity outgrew it is cut on the device, so
    every kernel shape matches an immutable segment of this bucket."""

    def __init__(self, planes: RealtimePlaneSet, snapshot):
        self.planes = planes
        self.snapshot = snapshot
        self.device = planes.device
        self.padded = pad_bucket(max(1, snapshot.num_docs))

    def dict_ids(self, column: str) -> torch.Tensor:
        return self.planes.row_plane(self.snapshot, column, "ids")

    def dict_ids_packed(self, column: str):
        # realtime id planes are always unpacked int32 (mutable metadata
        # carries no bits_per_value): width 0, as the family key predicts
        return self.dict_ids(column), 0

    def mv_dict_ids(self, column: str):
        raise RealtimeUploadError(
            f"{column}: no MV planes for consuming segments")

    def raw(self, column: str) -> torch.Tensor:
        return self.planes.row_plane(self.snapshot, column, "raw")

    def raw_f32_rebased(self, column: str):
        # the rebase base (the column min) moves while consuming; the
        # planner refuses the slot
        raise RealtimeUploadError(
            f"{column}: no rebased f32 planes for consuming segments")

    def dict_values(self, column: str) -> torch.Tensor:
        return self.planes.dict_plane(self.snapshot, column)

    def null_plane(self, column: str) -> torch.Tensor:
        return self.planes.row_plane(self.snapshot, column, "null")


class RealtimePlaneRegistry:
    """Process-wide plane sets, weakly keyed by the live MutableSegment and
    then by device: a set goes when its segment does; `drop_named` releases
    a committed or discarded segment's planes at once, `clear` all."""

    def __init__(self):
        self._lock = threading.Lock()
        self._stat_lock = threading.Lock()
        self._sets: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
        self.delta_bytes = 0
        self.uploads = 0
        self.generations = 0

    def _note(self, nbytes: int) -> None:
        with self._stat_lock:
            self.delta_bytes += nbytes
            self.uploads += 1

    def plane_set(self, segment, device) -> RealtimePlaneSet:
        device = torch.device(device)
        with self._lock:
            per_device = self._sets.setdefault(segment, {})
            ps = per_device.get(str(device))
            if ps is None:
                ps = per_device[str(device)] = RealtimePlaneSet(
                    str(getattr(segment, "name", segment)), device, self)
            return ps

    def view(self, snapshot, device) -> RealtimeDeviceView:
        """Device view of one pinned MutableSegmentView. Plane state is
        keyed by the UNDERLYING segment, so consecutive snapshots share
        (and advance) the same planes."""
        seg = getattr(snapshot, "_seg", snapshot)
        return RealtimeDeviceView(self.plane_set(seg, device), snapshot)

    def _drop(self, victim) -> int:
        """Remove the sets of every segment `victim(segment, set)` selects;
        bytes freed."""
        with self._lock:
            gone = [(seg, ps) for seg, per_device in self._sets.items()
                    for ps in per_device.values() if victim(seg, ps)]
            for seg, _ in gone:
                self._sets.pop(seg, None)
        freed = 0
        for _, ps in gone:
            freed += ps.nbytes()
            ps.evict()
        return freed

    def drop_named(self, name: str) -> int:
        """Release the planes of every set of this segment name (commit,
        discard). Returns bytes freed."""
        name = str(name)
        return self._drop(lambda seg, ps: ps.name == name)

    def clear(self, keep=None) -> int:
        """Drop every plane set, optionally sparing one segment's. Returns
        bytes freed."""
        return self._drop(lambda seg, ps: seg is not keep)

    def names(self) -> set:
        """The names of the segments that hold plane sets."""
        with self._lock:
            return {ps.name for per_device in self._sets.values()
                    for ps in per_device.values()}

    def nbytes(self) -> int:
        with self._lock:
            sets = [ps for per_device in self._sets.values()
                    for ps in per_device.values()]
        return sum(ps.nbytes() for ps in sets)

    def stats(self) -> dict:
        with self._stat_lock:
            return {"deltaBytes": self.delta_bytes,
                    "uploads": self.uploads,
                    "generations": self.generations,
                    "planeBytes": self.nbytes()}


REALTIME_PLANES = RealtimePlaneRegistry()


# -- planner ------------------------------------------------------------------


class RealtimeSegmentPlanner(SegmentPlanner):
    """Per-segment planner over a pinned MutableSegmentView. Differences
    from the immutable planner:

    - mutable segments are allowed (the view pins row count, dictionary
      cardinalities and upsert validity, so lowering is deterministic);
    - RANGE over a dict column lowers in VALUE space (a boolean LUT over
      the snapshot dictionary's values): the insertion-ordered mutable
      dictionary has no sorted id intervals;
    - MV id planes, rebased-f32 planes and non-numeric dictionary planes
      are refused: ragged MV matrices and a min-value rebase base are not
      stable while the segment is consuming.
    """

    allow_mutable = True

    def slot(self, column: str, kind: str) -> int:
        if kind in ("rawf32r", "mvids"):
            raise UnsupportedQueryError(
                f"realtime device planes: no {kind} plane for "
                f"consuming segments")
        if kind == "dict":
            m = self._meta(column)
            if not DataType(m.data_type).is_numeric:
                raise UnsupportedQueryError(
                    f"realtime device planes: non-numeric dictionary "
                    f"for {column}")
        return super().slot(column, kind)

    def _lower_dict_predicate(self, p, lhs, info):
        if p.type != PredicateType.RANGE:
            return super()._lower_dict_predicate(p, lhs, info)
        ids_slot, card, d = info
        mv = not self._meta(lhs.identifier).single_value
        vals = d.values
        m = np.ones(card, dtype=bool)
        if card:
            if p.lower is not None:
                lo = _coerce_like(vals, p.lower)
                m &= (vals >= lo) if p.lower_inclusive else (vals > lo)
            if p.upper is not None:
                hi = _coerce_like(vals, p.upper)
                m &= (vals <= hi) if p.upper_inclusive else (vals < hi)
        lut = np.zeros(card + 1, dtype=bool)
        lut[:card] = m
        return ir.Lut(ids_slot, self.param(lut), mv=mv)


def realtime_plan(query, segment):
    """The device plan of a pinned consuming-segment snapshot; raises
    UnsupportedQueryError for a shape the realtime planes do not take."""
    if getattr(segment, "snapshot_generation", None) is None:
        raise UnsupportedQueryError(
            "mutable segment without a pinned snapshot view")
    if not realtime_device_enabled(query):
        raise UnsupportedQueryError("realtime device planes disabled")
    return RealtimeSegmentPlanner(query, segment).plan()
