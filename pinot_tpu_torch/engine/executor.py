"""Segment executor: one device dispatch per segment, or per batch family.

The port of pinot_tpu/engine/executor.py (`TpuSegmentExecutor`): one
segment = ONE device dispatch of the kernel-program interpreter
(ops/kernels.run_program). Segments whose plans agree on everything that
shapes the kernel's inputs (`batch_family_key`) form a batch FAMILY: their
planes stack into [S, ...] tensors and run as ONE dispatch
(ops/kernels.run_program_batch, kernel A with its family axis), whose
outputs come back in one buffer. Host work is limited to planning
(dictionary lookups), launching, and decoding occupied group keys back to
values, or, for a selection, gathering the rows its filter bitmap marks.

PyTorch launches CUDA work asynchronously, so a caller can dispatch every
segment and family first and fetch afterwards: the device queue stays full.

While a trace is active (spi/trace.py), each dispatch runs under a
`family_dispatch` span with the reference's attributes (segment or
numSegments, mode, padded, fused, compileMs, deviceExecMs, transferBytes)
and `device`. deviceExecMs is the device's time: CUDA events around the
launches, waited for only while traced (on the CPU, where the plain
versions run synchronously, the host clock). Eager PyTorch compiles no
program, so compileMs is 0. Tracing off, a dispatch pays one thread-local
read: no span, no event, no synchronize.

Every dispatch names its executable family: (program, padded bucket,
fused variant, LUT runs) for a segment, ("batch", program, padded bucket,
packing, the stacked planes' dtypes and shapes, members) for a family.
A family's first dispatch in the process registers it with the compile
registry (engine/compile_registry.py), its host wall time as the family's
cold cost, and, with the AOT cache on (engine/aot_cache.py), persists
the family's record; every later one is a dict lookup and counter bumps.
A family the AOT prewarm installed counts `aotCacheHits`.

With a mesh shape (`mesh=(ndev,)`, engine/query_executor.py `_mesh_sig`)
a family of at least ndev members splits over the executor's first ndev
mesh devices (parallel/mesh.py): its stacks are cached per shard, a
ragged family padded by its last member with num_docs 0, each device runs
its members, and the outputs gather to the executor's device before the
pack, so the host still crosses once. A traced sharded dispatch adds
`meshDevices`, a `mesh_device:<k>` span per device and
`crossChipCombineMs`. A failed sharded dispatch fails the query: there is
no fallback to the solo family. A coalesced group (`repeat` > 1) runs on
the executor's device alone.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

import numpy as np
import torch

from ..cache.keys import family_fingerprint
from ..ops import fused_groupby
from ..ops.kernels import (PackedOuts, pack_outputs, run_program,
                           run_program_batch, unpack_outputs)
from ..parallel import mesh as pmesh
from ..query.context import QueryContext
from ..segment.bitpack import unpack_bitmap
from ..segment.device_cache import (DeviceSegmentCache, clear_transfer_stats,
                                    pad_bucket, reset_transfer_stats,
                                    transfer_stats)
from ..segment.loader import ImmutableSegment
from ..spi import faults
from ..spi.data_types import DataType
from ..spi.metrics import SERVER_METRICS, ServerMeter, ServerTimer
from ..spi.trace import TRACING
from . import aot_cache
from .compile_registry import COMPILE_REGISTRY, describe_family
from .plan import SegmentPlan, SegmentPlanner
from .results import (AggIntermediate, GroupArrays, GroupByIntermediate,
                      SelectionIntermediate)
from .selection import selection_from_mask

# Per-QUERY dispatch counter, thread-local because concurrent queries share
# this module: a reset at query start and a read at its end on the query's
# own thread see exactly that query's dispatches.
_TLS = threading.local()


def reset_dispatch_counters() -> None:
    _TLS.dispatches = 0


def dispatch_counters() -> int:
    """Device dispatches since the last reset on this thread."""
    return getattr(_TLS, "dispatches", 0)


def _count_dispatch() -> None:
    if hasattr(_TLS, "dispatches"):
        _TLS.dispatches += 1


class _FamilyGuard:
    """The executable families this process has dispatched, by family key:
    `note` says whether a key is new. Bounded like the registry: past its
    size the set starts over, and the families dispatch as first ones
    again."""

    def __init__(self, limit: int = COMPILE_REGISTRY.max_entries):
        self.limit = limit
        self._lock = threading.Lock()
        self._seen: set = set()

    def note(self, key) -> bool:
        with self._lock:
            if key in self._seen:
                return False
            if len(self._seen) >= self.limit:
                self._seen.clear()
            self._seen.add(key)
            return True

    def forget(self, key) -> None:
        with self._lock:
            self._seen.discard(key)

    def clear(self) -> None:
        with self._lock:
            self._seen.clear()


_FAMILIES = _FamilyGuard()


def _run_family(gkey, family: tuple, device: torch.device, launch,
                mesh: tuple = ()):
    """`launch()` as a dispatch of the family `gkey`; `family` is its
    (program, padded, fused, lut_meta, batch_size) for describe_family.
    A warm dispatch bumps the registry's counters; the first one
    fingerprints and registers the family, times `launch` on the host
    clock (no sync) as its cold cost, and hands the kernel calls it
    recorded to the AOT cache when that is on. A mesh-sharded family
    (`mesh` its shape) fingerprints with its mesh axis and never
    persists: its record is valid only on that device layout."""
    if aot_cache.AOT_READY and gkey in aot_cache.AOT_READY:
        SERVER_METRICS.add_meter(ServerMeter.AOT_CACHE_HITS)
    if not _FAMILIES.note(gkey):
        out = launch()
        COMPILE_REGISTRY.note_dispatch(gkey)
        return out
    program, padded, fused, lut_meta, batch_size = family
    fp = family_fingerprint(program, padded, fused, lut_meta, batch_size,
                            mesh=mesh)
    described = describe_family(program, padded, fused, lut_meta, batch_size)
    COMPILE_REGISTRY.note_first_dispatch(gkey, fp, described)
    calls = None if mesh else aot_cache.start_recording()
    t0 = time.perf_counter()
    try:
        out = launch()
    except BaseException:
        _FAMILIES.forget(gkey)
        raise
    finally:
        aot_cache.stop_recording(calls)
    cold_ms = round((time.perf_counter() - t0) * 1000, 3)
    COMPILE_REGISTRY.note_cold_cost(gkey, cold_ms)
    if calls is not None and fp is not None:
        aot_cache.on_first_dispatch(gkey, fp, cold_ms, described, calls,
                                    device)
    return out


def _fused_label(device: torch.device, fused) -> str:
    """The fused kernel's form in a family key and a span: its CUDA build,
    or its plain version on the CPU; "" off the fused path."""
    if not fused:
        return ""
    return "cuda" if device.type == "cuda" else "plain"


class _DeviceTimer:
    """A traced dispatch's deviceExecMs: CUDA events recorded around its
    launches on the current stream and waited for at `stop`, or the host
    clock on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        if self.cuda:
            self.start = torch.cuda.Event(enable_timing=True)
            self.end = torch.cuda.Event(enable_timing=True)
            self.start.record()
        else:
            self.t0 = time.perf_counter()

    def stop(self, span) -> None:
        if self.cuda:
            self.end.record()
            self.end.synchronize()
            ms = self.start.elapsed_time(self.end)
        else:
            ms = (time.perf_counter() - self.t0) * 1000
        span.set_attribute("compileMs", 0.0)
        span.set_attribute("deviceExecMs", round(ms, 3))


def _traced(dispatch):
    """Run `dispatch(span)` under a family_dispatch span when a trace is
    active (transfer counters armed for its uploads), else `dispatch(None)`
    with nothing added."""
    if TRACING.active_trace() is None:
        return dispatch(None)
    with TRACING.scope("family_dispatch") as span:
        reset_transfer_stats()
        try:
            return dispatch(span)
        finally:
            stats = transfer_stats()
            span.set_attribute("transferBytes", stats["transferBytes"])
            if stats["transfers"]:
                span.set_attribute("transfers", dict(stats["transfers"]))
            span.set_attribute("stackHits", stats["stackHits"])
            span.set_attribute("stackMisses", stats["stackMisses"])
            clear_transfer_stats()


def _span_plan(span, plan, view, device: torch.device, fused=False) -> None:
    span.set_attribute("mode", plan.program.mode)
    span.set_attribute("padded", view.padded)
    span.set_attribute("device", device.type)
    if fused:
        span.set_attribute("fused", _fused_label(device, fused))


class BatchFamilyMismatch(Exception):
    """A family grouped by the host-side key gathered planes of unequal
    dtype or shape: a planning decision made before anything runs (the key
    over-grouped), so the caller dispatches the members one by one."""


def _dict_pad(card: int) -> int:
    """Shape bucket for dictionary-values planes: next power of two >= card.
    Dict planes are only ever gathered by ids below the segment's OWN
    cardinality, so zero-padding to a shared bucket lets segments with
    different dictionary sizes join one family without changing any
    gathered value."""
    b = 1
    while b < card:
        b <<= 1
    return b


def batch_family_key(segment: ImmutableSegment, plan: SegmentPlan,
                     packed_on: bool, mesh: tuple = ()):
    """Host-computable batch family key: segments with equal keys gather
    identically shaped device planes and params, so their kernel inputs
    stack into [S, ...] tensors and run as ONE dispatch.

    The key is (program, padded bucket, per-slot dtype/packing signature,
    per-param dtype/shape signature), derived from column METADATA alone
    (no upload); `packed_on` says whether the device keeps narrow id planes
    (SegmentDeviceView.packed). It mirrors what gather_arrays_packed will
    produce; the family dispatch re-checks the gathered shapes and raises
    BatchFamilyMismatch if the mirror ever drifts. None when a slot's
    shape cannot be predicted. A mesh shape joins the key, so sharded and
    solo families keep apart."""
    sig = []
    for column, kind in plan.slots:
        m = segment.column_metadata(column)
        if kind == "mvids":
            sig.append(("mvids", max(1, m.max_number_of_multi_values)))
        elif kind == "ids":
            # a consuming snapshot's metadata has no bits_per_value: its id
            # planes are unpacked int32 (realtime/device_plane.py)
            bits = m.bits_per_value or 32
            width = 32
            if bits <= 16 and packed_on:
                width = 8 if bits <= 8 else 16
            sig.append(("ids", width))
        elif kind == "raw":
            sig.append(("raw", str(DataType(m.data_type).numpy_dtype)))
        elif kind == "rawf32r":
            sig.append(("rawf32r",))
        elif kind == "dict":
            sig.append(("dict", str(DataType(m.data_type).numpy_dtype),
                        _dict_pad(int(m.cardinality))))
        elif kind == "null":
            sig.append(("null",))
        else:
            return None
    psig = tuple((str(np.asarray(p).dtype), np.asarray(p).shape)
                 for p in plan.params)
    key = (plan.program, pad_bucket(max(1, segment.num_docs)), tuple(sig),
           psig)
    if mesh:
        key = key + (("mesh",) + tuple(mesh),)
    return key


def _stack(planes: list) -> torch.Tensor:
    """torch.stack of equal planes; uint16 stacks through its int16 view
    (the unsigned type has only view-level support in torch)."""
    if planes[0].dtype == torch.uint16:
        return torch.stack([p.view(torch.int16) for p in planes]) \
            .view(torch.uint16)
    return torch.stack(planes)


def _repeat(stack: torch.Tensor, q: int) -> torch.Tensor:
    """An [S, ...] stack repeated q times along its first dim (a new
    tensor); uint16 through its int16 view, as _stack."""
    reps = (q,) + (1,) * (stack.dim() - 1)
    if stack.dtype == torch.uint16:
        return stack.view(torch.int16).repeat(reps).view(torch.uint16)
    return stack.repeat(reps)


class SegmentExecutor:
    """Executes one QueryContext against one segment, or one batch family
    of segments, on the device."""

    def __init__(self, cache: DeviceSegmentCache,
                 mesh_devices: Optional[list] = None):
        self.cache = cache
        # the devices a family may split over, the cache's device first:
        # the process's cards by default (parallel/mesh.py local_devices);
        # a list naming one device several times stands in for a host with
        # more cards than this one
        self.mesh_devices = [torch.device(d) for d in (
            pmesh.local_devices(cache.device) if mesh_devices is None
            else mesh_devices)]
        # the [S*Q, ...] planes built for coalesced groups (never cached):
        # builds, bytes and host ms, summed over the executor's life
        self._repeats = {"builds": 0, "bytes": 0, "ms": 0.0}
        self._repeats_lock = threading.Lock()

    def repeat_stats(self) -> dict:
        """What the coalesced groups' `[S*Q, ...]` planes cost so far:
        builds, bytes and the host ms spent launching the repeats."""
        with self._repeats_lock:
            return dict(self._repeats)

    @property
    def device(self) -> torch.device:
        return self.cache.device

    @property
    def packed_on(self) -> bool:
        """Whether the cache keeps narrow id planes (SegmentDeviceView)."""
        return self.device.type == "cuda"

    def plan(self, query: QueryContext, segment: ImmutableSegment) -> SegmentPlan:
        if getattr(segment, "is_mutable", False):
            # consuming-segment snapshots lower through the realtime
            # planner (value-space ranges, no MV or rebased planes)
            from ..realtime.device_plane import realtime_plan

            return realtime_plan(query, segment)
        return SegmentPlanner(query, segment).plan()

    def _view_for(self, segment):
        """Device view: the segment cache for immutable segments, the
        realtime plane registry (delta-uploaded append-only planes) for
        consuming-segment snapshots."""
        if getattr(segment, "is_mutable", False):
            from ..realtime.device_plane import REALTIME_PLANES

            return REALTIME_PLANES.view(segment, self.device)
        return self.cache.view(segment)

    def dispatch_plan(self, segment: ImmutableSegment,
                      plan: SegmentPlan) -> PackedOuts:
        """Launch the segment's program and return its outputs packed into
        one device buffer, not yet copied to the host."""
        if faults.ACTIVE:
            # kind="hbm_oom" raises RESOURCE_EXHAUSTED here, which the
            # caller's with_oom_retry absorbs as a device OOM
            faults.FAULTS.fire("device.dispatch", segment=segment.name)
        return _traced(lambda span: self._dispatch_plan(segment, plan, span))

    def solo_inputs(self, segment, plan: SegmentPlan) -> tuple:
        """A lone segment's kernel inputs: (view, arrays, params, packed,
        fused, lut_meta), the planes from the device cache (or the
        realtime registry) and the params as tensors on the device, with
        the fused kernel's dict-id run params appended where its plan
        applies."""
        view = self._view_for(segment)
        arrays, packed = plan.gather_arrays_packed(view)
        host_params = tuple(np.asarray(p) for p in plan.params)
        # the fused kernel applies when the program is in its scope; dict
        # LUT predicates join it when their LUT compresses to a few dict-id
        # runs, a property of the concrete params (decided as the JAX
        # package decides it, executor.py:351-361)
        fused = plan.fused_ok
        lut_meta: tuple = ()
        if fused:
            extra, lut_meta = fused_groupby.lut_run_params(
                plan.program, host_params)
            if plan.program.mode == "group_by" and fused_groupby.plan(
                    plan.program, arrays, lut_meta) is not None:
                host_params = host_params + extra
            else:
                fused, lut_meta = False, ()
        params = tuple(torch.from_numpy(np.array(p)).to(view.device)
                       for p in host_params)
        return view, arrays, params, packed, fused, lut_meta

    def _dispatch_plan(self, segment, plan: SegmentPlan, span) -> PackedOuts:
        if span is not None:
            span.set_attribute("segment", segment.name)
            span.set_attribute("numSegments", 1)
        view, arrays, params, packed, fused, lut_meta = self.solo_inputs(
            segment, plan)
        _count_dispatch()
        timer = None
        if span is not None:
            _span_plan(span, plan, view, self.device, fused)
            timer = _DeviceTimer(self.device)
        label = _fused_label(self.device, fused)
        outs = _run_family(
            (plan.program, view.padded, label, lut_meta),
            (plan.program, view.padded, label, lut_meta, 0), self.device,
            lambda: run_program(plan.program, arrays, params,
                                segment.num_docs, view.padded, packed=packed,
                                fused=fused, fused_lut_meta=lut_meta,
                                device=view.device))
        if timer is not None:
            timer.stop(span)
        return pack_outputs(outs)

    def dispatch_plan_raw(self, segment: ImmutableSegment, plan: SegmentPlan):
        """dispatch_plan without the fused kernel and the packing: (device
        outputs, view), for callers that keep computing on the device (the
        sparse device combine)."""
        if faults.ACTIVE:
            faults.FAULTS.fire("device.dispatch", segment=segment.name)
        return _traced(lambda span: self._dispatch_plan_raw(segment, plan,
                                                            span))

    def _dispatch_plan_raw(self, segment, plan: SegmentPlan, span):
        if span is not None:
            span.set_attribute("segment", segment.name)
            span.set_attribute("numSegments", 1)
        view = self._view_for(segment)
        arrays, packed = plan.gather_arrays_packed(view)
        params = tuple(torch.from_numpy(np.array(p)).to(view.device)
                       for p in plan.params)
        _count_dispatch()
        timer = None
        if span is not None:
            _span_plan(span, plan, view, self.device)
            timer = _DeviceTimer(self.device)
        outs = _run_family(
            (plan.program, view.padded, "", ()),
            (plan.program, view.padded, "", (), 0), self.device,
            lambda: run_program(plan.program, arrays, params,
                                segment.num_docs, view.padded, packed=packed,
                                device=view.device))
        if timer is not None:
            timer.stop(span)
        return outs, view

    def _gather_batch(self, segments: list, plans: list, repeat: int = 1,
                      ndev: int = 1):
        """Gather and stack a family's kernel inputs: member planes from
        the per-segment cache (each uploaded once), the [S, ...] stacks
        from the cache's stacked view. Dictionary planes zero-pad to the
        family's power-of-two bucket. Raises BatchFamilyMismatch when the
        members' planes or params disagree in dtype, shape or packing.

        With `ndev` > 1 the stacks split over the first ndev mesh devices:
        each slot is a parallel/mesh.py Sharded whose part k (members
        k * S_pad / ndev on) is cached on its device, and a ragged family
        pads to a multiple of ndev by repeating its last member with
        num_docs 0 (its params too).

        `repeat` = Q > 1 is a coalesced group (engine/coalesce.py): Q
        queries over the same S segments, `plans` their S*Q plans in query
        order. Each plane is the family's cached [S, ...] stack repeated
        Q times for this launch only: caching [S*Q, ...] stacks would keep
        a new copy of the family for every group size."""
        views = [self._view_for(s) for s in segments]
        gathered = [pl.gather_arrays_packed(v)
                    for pl, v in zip(plans[:len(segments)], views)]
        packed = gathered[0][1]
        nslots = len(gathered[0][0])
        for arrs, pk in gathered[1:]:
            if pk != packed or len(arrs) != nslots:
                raise BatchFamilyMismatch("packing/slot-count mismatch")
        sview = self.cache.stacked_view(segments)
        stacked = []
        for i in range(nslots):
            col = [g[0][i] for g in gathered]
            if plans[0].slots[i][1] == "dict":
                target = _dict_pad(max(a.shape[0] for a in col))
                col = [torch.cat([a, a.new_zeros(target - a.shape[0])])
                       if a.shape[0] != target else a for a in col]
            a0 = col[0]
            if any(a.shape != a0.shape or a.dtype != a0.dtype
                   for a in col[1:]):
                raise BatchFamilyMismatch(
                    f"slot {i} ({plans[0].slots[i]}): unequal plane "
                    "shapes/dtypes across family members")
            pkey = (plans[0].slots[i], str(a0.dtype), tuple(a0.shape))
            if ndev > 1:
                stacked.append(self._sharded_stack(sview, pkey, col, ndev))
                continue
            stacked.append(sview.plane(pkey, lambda c=tuple(col): _stack(c)))
        if repeat > 1:
            t0 = time.perf_counter()
            stacked = [_repeat(t, repeat) for t in stacked]
            with self._repeats_lock:
                self._repeats["builds"] += 1
                self._repeats["bytes"] += sum(
                    t.numel() * t.element_size() for t in stacked)
                self._repeats["ms"] += (time.perf_counter() - t0) * 1000
        nparams = len(plans[0].params)
        if any(len(pl.params) != nparams for pl in plans):
            raise BatchFamilyMismatch("param-count mismatch")
        pad = (-len(plans)) % ndev
        params_b = []
        for j in range(nparams):
            ps = [np.asarray(pl.params[j]) for pl in plans]
            if any(p.shape != ps[0].shape or p.dtype != ps[0].dtype
                   for p in ps[1:]):
                raise BatchFamilyMismatch(f"param {j}: shape/dtype mismatch")
            params_b.append(torch.from_numpy(np.stack(ps + ps[-1:] * pad))
                            .to(self.device))
        num_docs = np.asarray([s.num_docs for s in segments] * repeat
                              + [0] * pad, dtype=np.int64)
        return views, tuple(stacked), tuple(params_b), packed, num_docs

    def _sharded_stack(self, sview, pkey: tuple, col: list,
                       ndev: int) -> pmesh.Sharded:
        """One slot's family stack split over the first ndev mesh devices,
        the last member repeated up to a multiple of ndev; part k is
        cached in the stacked view under its shard."""
        devices = self.mesh_devices[:ndev]
        col = col + col[-1:] * ((-len(col)) % ndev)
        step = len(col) // ndev
        parts = [sview.plane(
            pkey + (("mesh", ndev, k),),
            lambda c=tuple(col[k * step:(k + 1) * step]), d=d:
            _stack(list(c)).to(d)) for k, d in enumerate(devices)]
        return pmesh.Sharded(parts, devices)

    def dispatch_plan_batch_raw(self, segments: list, plans: list,
                                repeat: int = 1, mesh: tuple = ()):
        """ONE dispatch for a whole batch family (equal batch_family_key):
        (device outputs, views), every output carrying a leading [S] dim
        whose row s is what dispatch_plan_raw returns for member s. Raises
        BatchFamilyMismatch, before anything runs, to ask for the
        per-segment dispatch. With `repeat` = Q, a coalesced group of Q
        queries over `segments` (see _gather_batch): the outputs' leading
        dim is S*Q, query q's rows q*S to (q+1)*S. With `mesh` = (ndev,)
        and at least ndev members, the family splits over the mesh devices
        and its outputs come back gathered on the executor's device."""
        return self._batch(segments, plans, repeat, mesh, pack=False)

    def _batch(self, segments: list, plans: list, repeat: int, mesh: tuple,
               pack: bool):
        if faults.ACTIVE:
            faults.FAULTS.fire("device.dispatch", segment=segments[0].name,
                               batch_size=len(segments))
        ndev = int(mesh[0]) if mesh else 1
        if ndev > 1 and repeat == 1 and len(segments) >= ndev:
            return _traced(lambda span: self._dispatch_batch_sharded(
                segments, plans, ndev, pack, span))
        outs, views = _traced(lambda span: self._dispatch_batch(
            segments, plans, repeat, span))
        return (pack_outputs(outs) if pack else outs), views

    def _dispatch_batch(self, segments: list, plans: list, repeat: int,
                        span):
        if span is not None:
            span.set_attribute("numSegments", len(plans))
        views, arrays, params_b, packed, num_docs = self._gather_batch(
            segments, plans, repeat)
        _count_dispatch()
        timer = None
        if span is not None:
            _span_plan(span, plans[0], views[0], self.device)
            timer = _DeviceTimer(self.device)
        program, padded = plans[0].program, views[0].padded
        asig = tuple((str(a.dtype), tuple(a.shape)) for a in arrays)
        outs = _run_family(
            ("batch", program, padded, packed, asig, len(plans)),
            (program, padded, "", (), len(plans)), self.device,
            lambda: run_program_batch(program, arrays, params_b, num_docs,
                                      padded, packed=packed,
                                      device=self.device))
        if timer is not None:
            timer.stop(span)
        return outs, views

    def _dispatch_batch_sharded(self, segments: list, plans: list,
                                ndev: int, pack: bool, span):
        """ONE dispatch of the whole family over the first ndev mesh
        devices: each runs its members, then the outputs gather to the
        executor's device (packed, or raw for the sparse device combine)
        before the query's single host crossing. Per-member math is the
        solo family's, so the bytes are too."""
        if span is not None:
            span.set_attribute("numSegments", len(plans))
        views, arrays, params_b, packed, num_docs = self._gather_batch(
            segments, plans, ndev=ndev)
        _count_dispatch()
        program, padded = plans[0].program, views[0].padded
        if span is not None:
            _span_plan(span, plans[0], views[0], self.device)
            span.set_attribute("meshDevices", ndev)
        smesh = pmesh.segment_mesh(self.mesh_devices, ndev)
        asig = tuple((str(a.parts[0].dtype), (len(num_docs),)
                      + tuple(a.parts[0].shape[1:])) for a in arrays)
        t1 = time.perf_counter()
        outs = _run_family(
            ("batchmesh", ndev, program, padded, packed, asig, len(plans)),
            (program, padded, "", (), len(plans)), self.device,
            lambda: pmesh.run_program_batch_sharded(
                program, arrays, params_b, num_docs, padded, smesh,
                packed=packed), mesh=(ndev,))
        if span is not None:
            stamps = pmesh.block_per_device(outs, ndev, t1)
            span.set_attribute("compileMs", 0.0)
            span.set_attribute("deviceExecMs",
                               stamps[-1][1] if stamps else 0.0)
            for k, ms in stamps:
                with TRACING.scope(f"mesh_device:{k}") as dspan:
                    dspan.set_attribute("device", k)
                    dspan.set_attribute("deviceExecMs", ms)
        t2 = time.perf_counter()
        if pack:
            result = pmesh.pack_outputs_collective(outs, len(segments), ndev)
            sync_target = result.flat
        else:
            result = pmesh.gather_outputs(outs, len(segments))
            sync_target = result[0] if result else None
        if span is not None:
            if sync_target is not None and sync_target.is_cuda:
                torch.cuda.synchronize(sync_target.device)
            combine_ms = round((time.perf_counter() - t2) * 1000, 3)
            span.set_attribute("crossChipCombineMs", combine_ms)
            SERVER_METRICS.update_timer(ServerTimer.CROSS_CHIP_COMBINE_MS,
                                        combine_ms)
        return result, views

    def dispatch_plan_batch(self, segments: list, plans: list,
                            repeat: int = 1, mesh: tuple = ()) -> PackedOuts:
        """dispatch_plan_batch_raw packed into one device buffer: one
        launch and one host copy for the whole family (or group); a
        mesh-sharded family packs on the executor's device after the
        gather."""
        return self._batch(segments, plans, repeat, mesh, pack=True)[0]

    def collect(self, query: QueryContext, segment: ImmutableSegment,
                plan: SegmentPlan, outs):
        """Decode the segment's intermediate result from its outputs: a
        PackedOuts (copied to the host here, one fetch) or the host arrays
        of an earlier fetch (a member's row of a family's outputs)."""
        if isinstance(outs, PackedOuts):
            outs = unpack_outputs(outs)
        if plan.program.mode == "selection":
            return self._selection_result(query, segment, plan, outs[0])
        if plan.program.mode == "aggregation":
            states = [la.extract(outs, 0) for la in plan.lowered_aggs]
            return AggIntermediate(states, num_docs_scanned=int(outs[0][0]))
        return self._group_by_result(plan, outs)

    def _group_by_result(self, plan: SegmentPlan,
                         outs) -> GroupByIntermediate:
        num_groups = plan.program.num_groups
        mv_docs = None
        if plan.program.mv_group_slot is not None:
            # an MV GROUP BY counts (doc, value) pairs; the kernel appends
            # the matched DOC count as the last output
            mv_docs = int(outs[-1][0])
            outs = outs[:-1]
        counts = outs[0][:num_groups]
        gids = np.nonzero(counts)[0]
        sparse = plan.program.mode == "group_by_sparse"
        # sparse kernels emit each slot's composite key as the last output;
        # dense slots ARE the composite key
        composite = outs[-1][gids].astype(np.int64) if sparse else gids
        # decompose the composite key -> per-dim dict ids -> values
        # (inverse of DictionaryBasedGroupKeyGenerator's cartesian key)
        key_cols = []
        for dim, stride in zip(plan.group_dims, plan.program.group_strides):
            ids = (composite // stride) % dim.cardinality
            key_cols.append(np.asarray(dim.dictionary.values[ids]))
        scanned = int(counts.sum())
        trimmed = False
        if sparse:
            # the sparse trash slot counts valid rows whose group was
            # trimmed: they were scanned all the same
            trash = int(outs[0][num_groups])
            scanned += trash
            # an ORDER BY pushdown trim is exact, not a groups-limit event
            trimmed = trash > 0 and not plan.program.exact_trim
        if mv_docs is not None:
            scanned = mv_docs  # docs matched, not (doc x value) pairs
        if all(la.vec is not None for la in plan.lowered_aggs):
            return GroupArrays(
                key_cols,
                [la.vec.extract(outs, gids) for la in plan.lowered_aggs],
                [la.vec.spec for la in plan.lowered_aggs],
                [la.vec.fin_tag for la in plan.lowered_aggs],
                num_docs_scanned=scanned, groups_trimmed=trimmed)
        # object states (sets, sketches, tuples of sums): one per group and
        # aggregation, keyed by the group's values
        groups = {}
        for row, g in enumerate(gids):
            key = tuple(_to_python(col[row]) for col in key_cols)
            groups[key] = [la.extract(outs, g) for la in plan.lowered_aggs]
        return GroupByIntermediate(groups, num_docs_scanned=scanned,
                                   groups_trimmed=trimmed)


    @staticmethod
    def _selection_result(query, segment, plan: SegmentPlan,
                          bitmap) -> SelectionIntermediate:
        """The selected rows of the segment's packed filter bitmap."""
        mask = unpack_bitmap(np.asarray(bitmap), segment.num_docs)
        return selection_from_mask(query, segment, plan.selection_columns,
                                   mask, extra_exprs=plan.selection_exprs
                                   or None)


def _to_python(v):
    return v.item() if isinstance(v, np.generic) else v
