"""Single-pass fused dense group-by: filter + gid + limbs + per-group sums.

The port of pinot_tpu/ops/fused_groupby.py. The two-step dense path
(ops/kernels.py `_dense_group_by_entry` -> mxu_groupby.limb_sums)
materializes the widened id planes, the filter mask, the int32 gid vector
and one int8 limb plane per 7 bits of every summed column. The fused
kernel (csrc/fused_limb_sums.cu) reads each RAW column plane
(uint8/uint16/int32, exactly as resident on the device) once and keeps every
intermediate out of device memory.

Scope (the common hot shape; everything else stays on the two-step path):
  * filter: None / TRUE / a CONJUNCTION of closed dict-id or raw-int32
    intervals, or dict-LUT predicates that compress to <= 4 id runs
  * group key: plain id-plane slots with static strides
  * aggregations: COUNT and int32-exact SUMs (the limb recipe)

Runtime bounds ride an int32 scalar vector, so one compiled kernel serves
every literal value and every plan shape. On a CUDA tensor the kernel runs
or raises; on a CPU tensor `fused_limb_sums_plain` computes the same sums.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from functools import lru_cache
from typing import Optional

import numpy as np
import torch

from . import _cuda, geometry, mxu_groupby
from ..engine import aot_cache, ir

_I32_MIN = -(1 << 31)
_I32_MAX = (1 << 31) - 1
_MAX_TERMS = 8
MAX_LUT_RUNS = 4


@dataclass(frozen=True)
class FusedPlan:
    # ("iv", slot, lo_param|None, hi_param|None, lo_inc, hi_inc)
    # | ("runs", slot, runs_param, n_runs) — a dict-LUT predicate (IN,
    #   LIKE, NOT...) whose boolean LUT compresses to n_runs contiguous
    #   dict-id ranges; the [lo0,hi0,lo1,hi1,...] i64 array rides in
    #   params[runs_param] (appended at dispatch — lut_run_params)
    terms: tuple
    groups: tuple  # (slot, stride)
    # ("count",) | ("limb", slot, shift) | ("neg", slot)
    planes: tuple
    # per agg: ("count",) | ("sum", ((plane_idx, shift), ...), neg_idx|None)
    recipes: tuple
    slots: tuple  # unique slots the kernel loads, in ref order


def lut_run_params(program: ir.Program, params):
    """Dispatch-time (host, concrete numpy params) analysis: for each Lut
    filter leaf whose boolean LUT is a union of <= MAX_LUT_RUNS contiguous
    dict-id ranges, build the [lo,hi,...] run array. Returns
    (extra_params, meta) — meta is ((lut_param, appended_param index,
    n_runs), ...); ((), ()) when any Lut doesn't compress (the program then
    stays on the two-step path)."""
    if program.mode != "group_by" or program.filter is None:
        return (), ()
    extra: list = []
    meta: list = []
    base = len(params)
    for leaf in _filter_leaves(program.filter):
        if not isinstance(leaf, ir.Lut):
            continue
        lut = np.asarray(params[leaf.lut_param])
        if lut.dtype != np.bool_ or lut.ndim != 1:
            return (), ()
        idx = np.flatnonzero(lut)
        if idx.size == 0:
            runs = np.asarray([1, 0], dtype=np.int64)  # empty interval
        else:
            breaks = np.flatnonzero(np.diff(idx) > 1)
            starts = np.concatenate([[idx[0]], idx[breaks + 1]])
            ends = np.concatenate([idx[breaks], [idx[-1]]])
            if len(starts) > MAX_LUT_RUNS:
                return (), ()
            runs = np.empty(2 * len(starts), dtype=np.int64)
            runs[0::2] = starts
            runs[1::2] = ends
        meta.append((leaf.lut_param, base + len(extra), len(runs) // 2))
        extra.append(runs)
    return tuple(extra), tuple(meta)


def _filter_leaves(node):
    if isinstance(node, ir.FAnd):
        for c in node.children:
            yield from _filter_leaves(c)
    else:
        yield node


_ID_DTYPES = (torch.uint8, torch.uint16, torch.int32)


def plan(program: ir.Program, arrays,
         lut_meta: tuple = ()) -> Optional[FusedPlan]:
    """Static shape analysis; `arrays` contributes only dtypes/ndims.
    Returns None when the program leaves the fused scope. ``arrays=None``
    checks the program's structure only (EXPLAIN's eligibility: a Lut leaf
    counts as eligible, its run compression being a property of the
    dispatch's params). ``lut_meta`` is lut_run_params' description of the
    appended run arrays."""
    if program.mode != "group_by" or program.mv_group_slot is not None:
        return None
    if program.group_vexprs or not program.group_slots:
        return None

    def plane_ok(slot, payload=False):
        if arrays is None:
            return True
        a = arrays[slot]
        if a.dim() != 1:
            return False
        if payload:
            return a.dtype == torch.int32
        return a.dtype in _ID_DTYPES

    runs_of = {m[0]: m for m in lut_meta}
    terms = []
    if program.filter is not None:
        for leaf in _filter_leaves(program.filter):
            if isinstance(leaf, ir.FConst):
                if leaf.value:
                    continue
                return None
            if isinstance(leaf, ir.Lut):
                if leaf.mv or not plane_ok(leaf.ids_slot):
                    return None
                m = runs_of.get(leaf.lut_param)
                if m is None:
                    if arrays is None:
                        terms.append(("runs", leaf.ids_slot, -1, 1))
                        continue
                    return None
                terms.append(("runs", leaf.ids_slot, m[1], m[2]))
                continue
            if not isinstance(leaf, ir.Interval):
                return None
            ve = leaf.vexpr
            if not isinstance(ve, (ir.IdsCol, ir.Col)) or \
                    not plane_ok(ve.slot):
                return None
            terms.append(("iv", ve.slot, leaf.lo_param, leaf.hi_param,
                          leaf.lo_inclusive, leaf.hi_inclusive))
    if len(terms) > _MAX_TERMS:
        return None

    for slot in program.group_slots:
        if not plane_ok(slot):
            return None
    groups = tuple(zip(program.group_slots, program.group_strides))

    # limb policy comes from the ONE shared helper so fused and two-step
    # sums can never drift (kernels._limb_shifts)
    from .kernels import _limb_shifts

    planes: list = [("count",)]
    recipes: list = []
    b = mxu_groupby.LIMB_BITS
    for agg in program.aggs:
        if agg.kind == "count":
            recipes.append(("count",))
            continue
        if agg.kind != "sum" or not isinstance(agg.vexpr, ir.Col) or \
                not plane_ok(agg.vexpr.slot, payload=True):
            return None
        slot = agg.vexpr.slot
        shifts, nonneg = _limb_shifts(agg.vmin, agg.vmax, b)
        refs = tuple((len(planes) + k, s) for k, s in enumerate(shifts))
        planes.extend(("limb", slot, s) for s in shifts)
        neg_idx = None
        if not nonneg:
            neg_idx = len(planes)
            planes.append(("neg", slot))
        recipes.append(("sum", refs, neg_idx))

    num_segments = program.num_groups + 1
    if not mxu_groupby.supports(num_segments, len(planes)):
        return None

    slots = []
    for term in terms:
        if term[1] not in slots:
            slots.append(term[1])
    for s, _ in groups:
        if s not in slots:
            slots.append(s)
    for p in planes:
        if p[0] in ("limb", "neg") and p[1] not in slots:
            slots.append(p[1])
    return FusedPlan(tuple(terms), groups, tuple(planes), tuple(recipes),
                     tuple(slots))


def _scalar(v, device) -> torch.Tensor:
    return torch.as_tensor(v, device=device)


def execute(fp: FusedPlan, program: ir.Program, arrays, params, num_docs,
            n: int, row_offset=0):
    """Run the fused sums; returns the `_run_dense_group_by` output
    contract: (counts_i64, per-agg columns...)."""
    num_segments = program.num_groups + 1
    device = arrays[fp.slots[0]].device if fp.slots else arrays[0].device
    i64 = torch.int64
    # runtime scalar vector: [num_docs, row_offset, lo0, hi0, lo1, hi1, ..].
    # Bounds normalize to CLOSED i32 intervals over integer planes:
    #   * float bounds round INWARD (v >= 5.5 ≡ v >= 6; v <= 5.5 ≡ v <= 5;
    #     open bounds v > 5.0 ≡ v >= 6) — matching the two-step path's
    #     float-space compare on integer values
    #   * bounds outside int32 collapse to an EMPTY interval when they
    #     exclude the whole plane (lo > I32_MAX / hi < I32_MIN), never to
    #     a spurious point-match at the clipped extreme
    svals = [_scalar(num_docs, device).to(i64),
             _scalar(row_offset, device).to(i64)]
    # float bounds clamp to +-2^40 before the int64 cast: every such bound
    # is already outside int32, and the cast stays defined
    big = float(1 << 40)
    for term in fp.terms:
        if term[0] == "runs":
            # dict-id run bounds: already closed i32-safe intervals
            _, _slot, runs_param, n_runs = term
            arr = params[runs_param]
            for k in range(2 * n_runs):
                svals.append(arr[k].to(i64))
            continue
        _, _slot, lo_p, hi_p, lo_inc, hi_inc = term
        if lo_p is None:
            lo = _scalar(_I32_MIN, device).to(i64)
        else:
            p = params[lo_p]
            if p.is_floating_point():
                lo = (torch.ceil(p) if lo_inc
                      else torch.floor(p) + 1).clamp(-big, big).to(i64)
            else:
                lo = p.to(i64) + (0 if lo_inc else 1)
        if hi_p is None:
            hi = _scalar(_I32_MAX, device).to(i64)
        else:
            p = params[hi_p]
            if p.is_floating_point():
                hi = (torch.floor(p) if hi_inc
                      else torch.ceil(p) - 1).clamp(-big, big).to(i64)
            else:
                hi = p.to(i64) - (0 if hi_inc else 1)
        empty = (lo > _I32_MAX) | (hi < _I32_MIN) | (lo > hi)
        svals.append(torch.where(empty, _scalar(1, device).to(i64),
                                 lo.clamp(_I32_MIN, _I32_MAX)))
        svals.append(torch.where(empty, _scalar(0, device).to(i64),
                                 hi.clamp(_I32_MIN, _I32_MAX)))
    scalars = torch.stack([v.reshape(()) for v in svals]).to(torch.int32)

    planes_in = tuple(arrays[s] for s in fp.slots)
    sums = fused_limb_sums(fp, planes_in, scalars, num_segments, n)

    counts = sums[0]
    outputs = [counts]
    for r in fp.recipes:
        if r[0] == "count":
            outputs.append(counts)
            continue
        _, refs, neg_idx = r
        total = torch.zeros(counts.shape[0], dtype=i64, device=counts.device)
        for idx, shift in refs:
            total = total + (sums[idx] << shift)
        if neg_idx is not None:
            total = total - (sums[neg_idx] << 32)
        outputs.append(total.to(torch.float64))
    return tuple(outputs)


# -- the CUDA kernel's plan descriptor (csrc/fused_limb_sums.cu FusedDesc) --

_MAX_SLOTS = geometry.MAX_SLOTS
_MAX_GROUP_DIMS = 16
_SLOT_TYPES = {torch.uint8: 0, torch.uint16: 1, torch.int32: 2}
# a load code is a slot type, plus _VEC when the slot's rows in a stage
# start on a multiple of 4 rows (the kernel reads 4 of them at once)
_VEC = 4
_PLANE_KINDS = {"count": 0, "limb": 1, "neg": 2}
_P = mxu_groupby.MAX_PLANES


class _Desc(ctypes.Structure):
    _fields_ = [
        ("slot_ptr", ctypes.c_void_p * _MAX_SLOTS),
        ("slot_type", ctypes.c_int * _MAX_SLOTS),
        ("n_terms", ctypes.c_int),
        *[(f, ctypes.c_int * _MAX_TERMS) for f in (
            "term_slot", "term_code", "term_at", "term_runs", "term_bound")],
        ("n_groups", ctypes.c_int),
        *[(f, ctypes.c_int * _MAX_GROUP_DIMS) for f in (
            "group_slot", "group_code", "group_at", "group_stride")],
        ("n_planes", ctypes.c_int),
        *[(f, ctypes.c_int * _P) for f in (
            "plane_kind", "plane_slot", "plane_code", "plane_at",
            "plane_shift")],
    ]


@lru_cache(maxsize=64)
def _plan_descriptor(fp: FusedPlan, slot_types: tuple,
                     geo: geometry.Geometry) -> _Desc:
    """FusedPlan -> the kernel's descriptor without the slot pointers:
    slots are indexed by their position in fp.slots (== planes_in order).
    Each term, group dimension and plane carries its slot's load code and
    the place of the slot's row 0 in a stage of `geo`'s ring."""
    if len(fp.slots) > _MAX_SLOTS or len(fp.groups) > _MAX_GROUP_DIMS:
        raise ValueError(f"fused plan too wide for the kernel: {fp}")
    pos = {s: i for i, s in enumerate(fp.slots)}
    code = [t | (_VEC if geo.vec_mask >> i & 1 else 0)
            for i, t in enumerate(slot_types)]
    d = _Desc()
    for i, t in enumerate(slot_types):
        d.slot_type[i] = t
    d.n_terms = len(fp.terms)
    bound = 2
    for i, term in enumerate(fp.terms):
        slot = pos[term[1]]
        d.term_slot[i], d.term_code[i] = slot, code[slot]
        d.term_at[i] = geo.row_off[slot]
        d.term_runs[i] = term[3] if term[0] == "runs" else 1
        d.term_bound[i] = bound
        bound += 2 * d.term_runs[i]
    d.n_groups = len(fp.groups)
    for i, (slot, stride) in enumerate(fp.groups):
        slot = pos[slot]
        d.group_slot[i], d.group_code[i] = slot, code[slot]
        d.group_at[i], d.group_stride[i] = geo.row_off[slot], stride
    d.n_planes = len(fp.planes)
    for i, pd in enumerate(fp.planes):
        slot = pos[pd[1]] if len(pd) > 1 else 0
        d.plane_kind[i] = _PLANE_KINDS[pd[0]]
        d.plane_slot[i], d.plane_code[i] = slot, code[slot]
        d.plane_at[i] = geo.row_off[slot]
        d.plane_shift[i] = pd[2] if pd[0] == "limb" else 0
    return d


def _descriptor(fp: FusedPlan, planes_in, geo: geometry.Geometry) -> _Desc:
    d = _Desc.from_buffer_copy(_plan_descriptor(
        fp, tuple(_SLOT_TYPES[t.dtype] for t in planes_in), geo))
    for i, t in enumerate(planes_in):
        d.slot_ptr[i] = t.data_ptr()
    return d


def slot_layout(planes_in):
    """(widths, addresses modulo 16) of the kernel's slot planes."""
    return (tuple(t.element_size() for t in planes_in),
            tuple(t.data_ptr() % 16 for t in planes_in))


def fused_limb_sums(fp: FusedPlan, planes_in, scalars: torch.Tensor,
                    num_segments: int, n: int) -> torch.Tensor:
    """(P, num_segments) int64 sums of fp.planes over the rows that pass
    fp's filter; planes_in are the raw (n,) planes of fp.slots, scalars the
    int32 vector [num_docs, row_offset, lo0, hi0, ...]."""
    device = scalars.device
    for t in planes_in:
        if t.device != device or t.dim() != 1 or t.shape[0] != n \
                or t.dtype not in _SLOT_TYPES:
            raise ValueError(
                f"fused_limb_sums: plane {t.dtype} {tuple(t.shape)} on "
                f"{t.device}; want (n={n},) uint8/uint16/int32 on {device}")
    if scalars.dtype != torch.int32 or scalars.dim() != 1:
        raise TypeError("fused_limb_sums: scalars must be a 1-D int32 tensor")
    if aot_cache.RECORDING[0]:
        aot_cache.note_kernel_call({
            "kernel": "fused_limb_sums", "plan": fp,
            "slotTypes": [str(t.dtype).removeprefix("torch.")
                          for t in planes_in],
            "planes": len(fp.planes), "groups": num_segments, "rows": n})
    if device.type == "cpu":
        return fused_limb_sums_plain(fp, planes_in, scalars, num_segments, n)
    if device.type != "cuda":
        raise ValueError(f"fused_limb_sums: unsupported device {device}")
    planes_in = tuple(t.contiguous() for t in planes_in)
    scalars = scalars.contiguous()
    if not n:
        return torch.zeros((len(fp.planes), num_segments), dtype=torch.int64,
                           device=device)
    geo = _cuda.geometry_for("fused_limb_sums", n, len(fp.planes),
                             num_segments, *slot_layout(planes_in),
                             device.index)
    return launch(fp, planes_in, scalars, num_segments, geo)


def launch(fp: FusedPlan, planes_in, scalars: torch.Tensor, num_segments: int,
           geo: geometry.Geometry) -> torch.Tensor:
    """Launch kernel B with geometry `geo` over contiguous CUDA inputs
    (fused_limb_sums has checked them); returns the (P, num_segments) sums."""
    out = _cuda.new_output(len(fp.planes), num_segments, scalars.device)
    desc = _descriptor(fp, planes_in, geo)
    _cuda.launch("fused_limb_sums", ctypes.addressof(desc),
                 ctypes.addressof(_cuda.geom_struct(geo)), scalars.data_ptr(),
                 scalars.shape[0], num_segments, out.data_ptr(),
                 _cuda.stream_handle(scalars.device))
    return out


def fused_limb_sums_plain(fp: FusedPlan, planes_in, scalars: torch.Tensor,
                          num_segments: int, n: int) -> torch.Tensor:
    """The same function in plain PyTorch: the arithmetic of the TPU
    kernel body (pinot_tpu/ops/fused_groupby.py `_kernel`) over the whole
    plane, then one int64 index_add_ per plane."""
    gid, vals = fused_planes(fp, planes_in, scalars, num_segments, n)
    out = torch.zeros((len(fp.planes), num_segments), dtype=torch.int64,
                      device=scalars.device)
    for i in range(len(fp.planes)):
        out[i].index_add_(0, gid, vals[i])
    return out


def fused_planes(fp: FusedPlan, planes_in, scalars: torch.Tensor,
                 num_segments: int, n: int):
    """(gid (n,) int64, values (P, n) int64): the group id and the
    count/limb/neg plane values the fused kernel accumulates, materialized
    (masked rows carry gid num_segments - 1 and zero values)."""
    device = scalars.device
    loaded = {slot: t.to(torch.int32) for slot, t in zip(fp.slots, planes_in)}
    rows = torch.arange(n, dtype=torch.int32, device=device)
    m = (rows + scalars[1]) < scalars[0]
    si = 2
    for term in fp.terms:
        p = loaded[term[1]]
        n_runs = term[3] if term[0] == "runs" else 1
        tm = torch.zeros_like(m)
        for _ in range(n_runs):
            tm = tm | ((p >= scalars[si]) & (p <= scalars[si + 1]))
            si += 2
        m = m & tm

    gid = torch.zeros(n, dtype=torch.int32, device=device)
    for slot, stride in fp.groups:
        gid = gid + loaded[slot] * stride
    gid = torch.where(m, gid, num_segments - 1).to(torch.int64)

    vals = []
    for pd in fp.planes:
        if pd[0] == "count":
            vals.append(m.to(torch.int64))
        elif pd[0] == "limb":
            u = torch.where(m, loaded[pd[1]], 0).to(torch.int64) & 0xFFFFFFFF
            vals.append((u >> pd[2]) & ((1 << mxu_groupby.LIMB_BITS) - 1))
        else:  # neg
            vals.append((m & (loaded[pd[1]] < 0)).to(torch.int64))
    return gid, torch.stack(vals)
