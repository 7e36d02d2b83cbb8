"""The kernel-program interpreter, in PyTorch.

The port of pinot_tpu/ops/kernels.py for the `selection`, `aggregation`,
dense `group_by` and sparse `group_by_sparse` modes. One call runs a whole
ir.Program over the padded column planes of one segment (`run_program`)
or of a batch FAMILY of segments at once (`run_program_batch`):

    mask  = filter tree as boolean vector algebra
    gid   = sum of dict_ids[d] * stride[d]  (masked rows -> trash slot)
    out_k = per-group count / sum / sumsq / min / max, or a matrix per
            group: dict-id occupancy or counts, an adaptive or fixed
            histogram

A selection returns only its mask, as a little-endian packed bitmap (n / 8
bytes a segment). A multi-value column is a (docs, max_mv) id matrix
padded with its cardinality: its predicates match a doc when any value
does, the *MV aggregations reduce each row through a LUT (ir.MvLutReduce),
and an MV GROUP BY dimension expands the rows into (doc x value slot)
pairs, every per-doc plane broadcast across max_mv and the pad slots
masked, before the dense or sparse group-by runs as usual.

The JAX package runs a family as `jax.vmap` of the per-segment body. Here
the body itself works over a leading segment axis: planes are [S, N],
scalar params [S, 1], LUT and gather tables [S, L] (gathered along dim 1:
dictionaries are per segment), num_docs an (S,) tensor, and every output
gains a leading S dim. A solo segment is the same code at S = 1, so row s
of a family's outputs is what the member's own unfused run returns.

COUNT and int32-exact SUMs of a dense group-by ride 7-bit limb planes
through `mxu_groupby.limb_sums` (CUDA kernel A, one launch per family) or,
for a solo segment whose program is in its scope, the single-pass
`fused_groupby` kernel (CUDA kernel B); MIN/MAX and float sums use torch
scatters over the flattened [S * N] rows (slot gid + s * (G + 1)). The
matrix-shaped aggregations count rows per (group, dict id) or per (group,
bin) slot with kernel A at one plane (`_mxu_or_scatter_counts`). The
sparse mode sorts composite keys (torch.sort, stable), finds group edges
with torch.searchsorted and reduces with prefix sums and scatters, as the
JAX package does with XLA ops; a DISTINCT column rides the sort as a
secondary key and comes out as per-slot uint32 bitmap words. All outputs
pack into one device buffer per segment or family; `fetch_packed_batch`
brings every buffer of a query to the host in one copy.

Type promotion follows JAX with 64-bit types enabled, not PyTorch, so
both interpreters compute in the same dtypes:
  * every param arrives as a tensor of its numpy dtype (0-dim for
    scalars), and binary ops promote both operands with
    torch.promote_types first — a 0-dim int64 param widens an int32 plane
    to int64, as a JAX int64 array argument does (torch would keep int32);
  * `div` of two integer operands and float-valued unary math on integers
    compute in float64 (torch would give float32);
  * `mod` is floor-mod (torch.remainder, as jnp.mod; torch.fmod truncates).
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from ..engine import ir
from . import fused_groupby, mxu_groupby

_I32_MAX = (1 << 31) - 1
_I32_MIN = -(1 << 31)


def planes_from_numpy(arrays, params, device) -> tuple[tuple, tuple]:
    """(arrays, params) as tensors on `device`: the numpy planes and the
    params a SegmentPlan gathers (in either package) become the
    interpreter's inputs, each keeping its numpy dtype."""
    device = torch.device(device)
    ta = tuple(torch.from_numpy(np.array(a)).to(device) for a in arrays)
    tp = tuple(torch.from_numpy(np.array(p)).to(device) for p in params)
    return ta, tp


# -- value expressions --------------------------------------------------------


def _promote(a: torch.Tensor, b: torch.Tensor):
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt), b.to(dt)


def _div(a, b):
    a, b = _promote(a, b)
    if not a.is_floating_point():
        a, b = a.to(torch.float64), b.to(torch.float64)
    return torch.true_divide(a, b)


def _float_op(fn):
    """Unary float math: integer/bool inputs compute in float64."""
    def op(a):
        if not a.is_floating_point():
            a = a.to(torch.float64)
        return fn(a)
    return op


def _promoted(fn):
    def op(a, b):
        return fn(*_promote(a, b))
    return op


_BIN_OPS = {
    "add": _promoted(torch.add),
    "sub": _promoted(torch.sub),
    "mul": _promoted(torch.mul),
    "div": _div,
    "fdiv": _promoted(torch.floor_divide),
    "mod": _promoted(torch.remainder),
    "pow": _promoted(torch.pow),
    "eq": _promoted(torch.eq),
    "ne": _promoted(torch.ne),
    "lt": _promoted(torch.lt),
    "le": _promoted(torch.le),
    "gt": _promoted(torch.gt),
    "ge": _promoted(torch.ge),
    "and": torch.logical_and,
    "or": torch.logical_or,
    "min": _promoted(torch.minimum),
    "max": _promoted(torch.maximum),
}

_UN_OPS = {
    "neg": torch.neg,
    "abs": torch.abs,
    "not": torch.logical_not,
    "exp": _float_op(torch.exp),
    "ln": _float_op(torch.log),
    "log10": _float_op(torch.log10),
    "log2": _float_op(torch.log2),
    "sqrt": _float_op(torch.sqrt),
    # integer inputs pass through unchanged, as jnp.ceil/jnp.floor do
    "ceil": lambda a: torch.ceil(a) if a.is_floating_point() else a,
    "floor": lambda a: torch.floor(a) if a.is_floating_point() else a,
    "sign": torch.sign,
}

_CAST_DTYPES = {
    "INT": torch.int32,
    "LONG": torch.int64,
    "FLOAT": torch.float32,
    "DOUBLE": torch.float64,
    "BOOLEAN": torch.bool,
    "STRING": torch.float64,  # numeric-context cast
    "TIMESTAMP": torch.int64,
}


def _gather(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """table[s, ids[s, ...]]: a per-segment table [S, L] read at [S, N]
    ids, or at an [S, N, W] MV id matrix."""
    flat = ids.to(torch.int64).reshape(ids.shape[0], -1)
    return torch.gather(table, 1, flat).view(ids.shape)


def _mv_reduce(node: ir.MvLutReduce, arrays, params) -> torch.Tensor:
    """Per-doc reduce of an MV id matrix [S, N, W]: the non-pad count, or
    the sum / min / max of LUT values (the pad slot holds the identity).
    Sums add the W slots left to right, the order of the JAX package's
    reduce over its MV axis."""
    ids = arrays[node.ids_slot]
    if node.op == "count":
        return (ids != node.card).sum(-1, dtype=torch.int32)
    vals = _gather(params[node.lut_param], ids)
    if node.op == "min":
        return vals.amin(-1)
    if node.op == "max":
        return vals.amax(-1)
    out = vals[..., 0]
    for w in range(1, vals.shape[-1]):
        out = out + vals[..., w]
    return out


def _eval_value(node: ir.ValueExpr, arrays, params):
    """Evaluate a value expression. The planner's IRBuilder shares
    subexpressions as one Python object (a civil-date chain reads `doe` or
    `yoe` many times: DATETRUNC('MONTH', ts) is 55 distinct nodes but 9368
    as a tree), so each distinct node evaluates once, as XLA's CSE does for
    the reference, and its result is dropped after its last use."""
    uses: dict = {}
    _count_uses(node, uses)
    return _eval_shared(node, arrays, params, {}, uses)


def _children(node):
    if isinstance(node, ir.Bin):
        return (node.a, node.b)
    if isinstance(node, (ir.Un, ir.Cast)):
        return (node.a,)
    if isinstance(node, ir.Where):
        return (node.cond, node.a, node.b)
    if isinstance(node, ir.ParamGather):
        return (node.ids,)
    return ()


def _count_uses(node, uses: dict) -> None:
    k = id(node)
    uses[k] = uses.get(k, 0) + 1
    if uses[k] == 1:
        for c in _children(node):
            _count_uses(c, uses)


def _eval_shared(node, arrays, params, memo: dict, uses: dict):
    k = id(node)
    if k in memo:
        out = memo[k]
    else:
        out = _eval_node(node, arrays, params, lambda c: _eval_shared(
            c, arrays, params, memo, uses))
        if uses[k] > 1:
            memo[k] = out
    uses[k] -= 1
    if uses[k] == 0:
        memo.pop(k, None)
    return out


def _eval_node(node: ir.ValueExpr, arrays, params, ev):
    """One node, its children evaluated through `ev`."""
    if isinstance(node, (ir.Col, ir.IdsCol)):
        return arrays[node.slot]
    if isinstance(node, ir.DictGather):
        return _gather(arrays[node.dict_slot], arrays[node.ids_slot])
    if isinstance(node, ir.ConstParam):
        return params[node.idx]
    if isinstance(node, ir.ParamGather):
        return _gather(params[node.param_idx], ev(node.ids))
    if isinstance(node, ir.Bin):
        return _BIN_OPS[node.op](ev(node.a), ev(node.b))
    if isinstance(node, ir.Un):
        return _UN_OPS[node.op](ev(node.a))
    if isinstance(node, ir.Cast):
        return ev(node.a).to(_CAST_DTYPES[node.to])
    if isinstance(node, ir.Where):
        a, b = _promote(ev(node.a), ev(node.b))
        return torch.where(ev(node.cond).to(torch.bool), a, b)
    if isinstance(node, ir.NullCol):
        return arrays[node.null_slot]
    if isinstance(node, ir.FilterVal):
        return _eval_filter(node.filter, arrays, params)
    if isinstance(node, ir.MvLutReduce):
        return _mv_reduce(node, arrays, params)
    raise TypeError(f"value node {node} is not lowered by this port")


def _eval_filter(node: ir.FilterNode, arrays, params):
    if isinstance(node, ir.FConst):
        # a 0-dim CPU tensor broadcasts against planes on any device
        return torch.tensor(bool(node.value))
    if isinstance(node, ir.Interval):
        v = _eval_value(node.vexpr, arrays, params)
        mask = torch.ones(v.shape, dtype=torch.bool, device=v.device)
        if node.lo_param is not None:
            lo = params[node.lo_param]
            mask &= (_BIN_OPS["ge"] if node.lo_inclusive
                     else _BIN_OPS["gt"])(v, lo)
        if node.hi_param is not None:
            hi = params[node.hi_param]
            mask &= (_BIN_OPS["le"] if node.hi_inclusive
                     else _BIN_OPS["lt"])(v, hi)
        if mask.dim() == 3:  # MV matrix: a doc matches if any value does
            mask = mask.any(-1)
        return mask
    if isinstance(node, ir.Lut):
        m = _gather(params[node.lut_param], arrays[node.ids_slot])
        return m.any(-1) if m.dim() == 3 else m
    if isinstance(node, ir.Isin):
        v, vals = _promote(_eval_value(node.vexpr, arrays, params),
                           params[node.values_param])
        # each segment against its own value list
        return torch.stack([torch.isin(v[s], vals[s])
                            for s in range(v.shape[0])])
    if isinstance(node, ir.Null):
        return arrays[node.null_slot]
    if isinstance(node, ir.MaskParam):
        # a host-computed [S, padded] doc mask (upsert validity), its pad
        # rows False
        return params[node.idx]
    if isinstance(node, ir.FAnd):
        m = _eval_filter(node.children[0], arrays, params)
        for c in node.children[1:]:
            m = m & _eval_filter(c, arrays, params)
        return m
    if isinstance(node, ir.FOr):
        m = _eval_filter(node.children[0], arrays, params)
        for c in node.children[1:]:
            m = m | _eval_filter(c, arrays, params)
        return m
    if isinstance(node, ir.FNot):
        return ~_eval_filter(node.child, arrays, params)
    raise TypeError(f"filter node {node} is not lowered by this port")


def _apply_packed(arrays: tuple, packed: tuple) -> tuple:
    """Widen narrow (uint8/uint16) id planes to int32. `packed` entries are
    (slot, width) with width in {8, 16} (SegmentDeviceView
    .dict_ids_packed). Widening comes first: torch has no compares or
    arithmetic on uint16."""
    if not packed:
        return arrays
    out = list(arrays)
    for slot, _width in packed:
        out[slot] = out[slot].to(torch.int32)
    return tuple(out)


# -- output packing -----------------------------------------------------------


class PackedOuts:
    """Kernel outputs flattened into ONE device byte buffer + host-side
    (dtype, shape) metas, so a segment's (or a family's) results cross to
    the host in one copy. float64 travels as its raw bytes."""

    __slots__ = ("flat", "metas")

    def __init__(self, flat, metas):
        self.flat = flat
        self.metas = metas  # [(np.dtype, shape), ...]


_NP_DTYPES = {torch.bool: np.bool_, torch.uint8: np.uint8,
              torch.int32: np.int32,
              torch.uint32: np.uint32, torch.int64: np.int64,
              torch.float32: np.float32, torch.float64: np.float64}


def pack_outputs(outs: tuple) -> PackedOuts:
    metas = [(np.dtype(_NP_DTYPES[o.dtype]), tuple(o.shape)) for o in outs]
    chunks = []
    for o in outs:
        if o.dtype == torch.bool:
            o = o.to(torch.uint8)
        chunks.append(o.contiguous().reshape(-1).view(torch.uint8))
    flat = torch.cat(chunks) if len(chunks) > 1 else chunks[0]
    return PackedOuts(flat, metas)


# lifetime count of device->host copies of packed outputs: a query makes
# exactly one, whatever its number of segments and families (a fused
# multi-stage join stage one more). Multi-stage statements on several
# threads count through the lock; each thread also keeps its own count,
# which a stage reads around its own device work.
_HOST_FETCHES = [0]
_FETCH_LOCK = threading.Lock()
_FETCH_TLS = threading.local()


def host_fetches() -> int:
    return _HOST_FETCHES[0]


def thread_host_fetches() -> int:
    """Host fetches made so far by the calling thread."""
    return getattr(_FETCH_TLS, "n", 0)


def count_host_fetch() -> None:
    """Record one deliberate device->host crossing."""
    with _FETCH_LOCK:
        _HOST_FETCHES[0] += 1
    _FETCH_TLS.n = thread_host_fetches() + 1


def _split_flat(flat: np.ndarray, metas) -> list:
    out, off = [], 0
    for dt, shape in metas:
        nbytes = int(np.prod(shape, dtype=np.int64)) * dt.itemsize
        out.append(flat[off:off + nbytes].view(dt).reshape(shape))
        off += nbytes
    return out


def fetch_packed_batch(packs: list) -> list:
    """Bring many packed outputs (segments' and families') to the host in
    ONE device->host copy: the flat buffers concatenate on the device and
    the host splits the copy back into each pack's arrays (zero-copy
    views). Returns one list of numpy arrays per pack."""
    if not packs:
        return []
    count_host_fetch()
    flats = [p.flat for p in packs]
    flat = (torch.cat(flats) if len(flats) > 1 else flats[0]).cpu().numpy()
    out, off = [], 0
    for p, f in zip(packs, flats):
        out.append(_split_flat(flat[off:off + f.shape[0]], p.metas))
        off += f.shape[0]
    return out


def unpack_outputs(p: PackedOuts) -> list:
    return fetch_packed_batch([p])[0]


# -- the JAX package's wire pack (PTDP) ---------------------------------------
#
# cluster/datatable.py's PTDP blocks carry the byte layout of the JAX
# package's `_pack_u8` (pinot_tpu/ops/kernels.py:260), so a mixed fleet
# decodes either package's blocks: bool as uint8, float64 as four 32-bit
# words from `_encode_f64` (an exact float32 triplet of the value scaled
# by a power-of-two bucket, then the bucket and the nan/inf/sign flags),
# every other dtype as its raw little-endian bytes. The port's own fetch
# (pack_outputs above) copies float64 raw instead.

_F64_HALF_SCALES = tuple(2.0 ** (-90 * k) for k in range(-6, 7))


def _encode_f64(x: torch.Tensor) -> torch.Tensor:
    """float64 -> int32 words [..., 4], bit for bit the JAX package's
    `_encode_f64` (same arithmetic in the same order)."""
    finite = torch.isfinite(x)
    xs = torch.where(finite, x, torch.zeros_like(x))
    ax = xs.abs()
    # bucket k: exponent(x) in [180k-60, 180k+120)
    k = sum((ax >= 2.0 ** (180 * kk - 60)).to(torch.int32)
            for kk in range(-5, 7)) - 6
    half = torch.tensor(_F64_HALF_SCALES, dtype=torch.float64,
                        device=x.device)[(k + 6).long()]
    y = xs * half * half  # two exact multiplies (2^(180*6) overflows alone)
    a = y.to(torch.float32)
    r1 = y - a.to(torch.float64)
    b = r1.to(torch.float32)
    c = (r1 - b.to(torch.float64)).to(torch.float32)
    nan = torch.isnan(x)
    # the JAX package's zero sign test: 1/-0.0 = -inf (a NaN is never neg)
    neg = (x < 0) | ((x == 0) & (1.0 / x < 0))
    meta = ((k + 6) | (nan.to(torch.int32) << 8)
            | ((~finite & ~nan).to(torch.int32) << 9)
            | (neg.to(torch.int32) << 10))
    return torch.stack([a.view(torch.int32), b.view(torch.int32),
                        c.view(torch.int32), meta.to(torch.int32)], dim=-1)


def _decode_f64(raw: np.ndarray, shape) -> np.ndarray:
    """The inverse of `_encode_f64` on the host (pinot_tpu/ops/kernels.py
    `_decode_f64`)."""
    w = raw.view(np.uint32).reshape(-1, 4)
    a = np.ascontiguousarray(w[:, 0]).view(np.float32).astype(np.float64)
    b = np.ascontiguousarray(w[:, 1]).view(np.float32).astype(np.float64)
    c = np.ascontiguousarray(w[:, 2]).view(np.float32).astype(np.float64)
    k = (w[:, 3] & 0xFF).astype(np.int32) - 6
    neg = (w[:, 3] >> 10) & 1
    x = np.ldexp(a + b + c, 180 * k)
    zneg = (x == 0) & (neg == 1)  # -0.0 + 0.0 = +0.0 loses the zero sign
    if zneg.any():
        x = np.where(zneg, -0.0, x)
    isinf = (w[:, 3] >> 9) & 1
    if isinf.any():
        x = np.where(isinf == 1, np.where(neg == 1, -np.inf, np.inf), x)
    isnan = (w[:, 3] >> 8) & 1
    if isnan.any():
        x = np.where(isnan == 1, np.nan, x)
    return x.reshape(shape)


def pack_u8_wire(outs: tuple) -> torch.Tensor:
    """The tensors as ONE uint8 buffer on their device, in the JAX
    package's `_pack_u8` layout."""
    chunks = []
    for o in outs:
        if o.dtype == torch.bool:
            o = o.to(torch.uint8)
        elif o.dtype == torch.float64:
            o = _encode_f64(o)
        chunks.append(o.contiguous().reshape(-1).view(torch.uint8))
    return torch.cat(chunks) if len(chunks) > 1 else chunks[0]


def split_flat_wire(flat: np.ndarray, metas) -> list:
    """`pack_u8_wire`'s buffer -> numpy arrays of (dtype, shape) metas."""
    out, off = [], 0
    for dt, shape in metas:
        count = int(np.prod(shape, dtype=np.int64))
        if dt == np.float64:  # 4 x 32-bit words per value
            nbytes = count * 16
            out.append(_decode_f64(flat[off:off + nbytes], shape))
        else:
            nbytes = count * dt.itemsize
            out.append(flat[off:off + nbytes].view(dt).reshape(shape))
        off += nbytes
    return out


# -- programs -----------------------------------------------------------------


def run_program(program: ir.Program, arrays: tuple, params: tuple,
                num_docs: int, padded: int, row_offset: int = 0,
                packed: tuple = (), fused: bool = False,
                fused_lut_meta: tuple = (), device=None):
    """Execute a Program over one segment's padded column planes. Returns a
    tuple:

    selection       -> (bitmap[padded / 8] uint8,): the filter mask packed
                       little-endian (bit j of byte i is row 8 i + j)
    aggregation     -> (count, agg_0, agg_1, ...) each shape (2,) (value, trash)
    group_by        -> (counts[G+1], agg_0[G+1], ...), slot G = trash
    group_by_sparse -> (counts[K+1], agg_0[K+1], ..., keys[K]), slot K =
                       trash, keys the composite key of each slot (-1 empty)

    With an MV GROUP BY dimension the group-by outputs gain a last one,
    the matched DOC count (shape (1,)): the counts are of (doc, value)
    pairs.

    `arrays` are tensors of length `padded` (dictionary planes: their own
    length) on one device; `params` are tensors (0-dim for scalars) on the
    same device. `packed` marks narrow id slots. `fused` runs the
    single-pass fused group-by (ops/fused_groupby) for programs in its
    scope on the RAW narrow planes; `fused_lut_meta` describes the dict-id
    run arrays appended to `params` (fused_groupby.lut_run_params).
    `device` is where the outputs live; it defaults to the device of the
    first plane or param. Without `fused`, this is `run_program_batch` of
    a family of one.
    """
    if device is None:
        device = (arrays or params)[0].device if (arrays or params) \
            else torch.device("cpu")
    if fused and program.mode == "group_by":
        fp = fused_groupby.plan(program, arrays, fused_lut_meta)
        if fp is not None:
            return fused_groupby.execute(fp, program, arrays, params,
                                         num_docs, padded, row_offset)
    arrays = _apply_packed(arrays, packed)
    outs = _run_program_impl(
        program, tuple(a.unsqueeze(0) for a in arrays),
        tuple(p.reshape(1, -1) for p in params),
        torch.tensor([int(num_docs)], dtype=torch.int64, device=device),
        padded, row_offset, device)
    return tuple(o[0] for o in outs)


def run_program_batch(program: ir.Program, arrays: tuple, params: tuple,
                      num_docs, padded: int, packed: tuple = (),
                      device=None):
    """Execute one Program over a stacked FAMILY of segments in one
    dispatch: every plane in `arrays` and every param in `params` carries
    a leading [S] dim (one row per member), `num_docs` holds the S
    members' row counts. Each output gains a leading S dim, and row s is
    element for element what `run_program(..., fused=False)` returns for
    member s. Narrow packed planes widen before the body, as in the JAX
    package; the fused kernel is per segment only."""
    if device is None:
        device = arrays[0].device if arrays else params[0].device
    arrays = _apply_packed(arrays, packed)
    params = tuple(p.reshape(p.shape[0], -1) for p in params)
    num_docs = torch.as_tensor(np.asarray(num_docs, dtype=np.int64),
                               device=device)
    return _run_program_impl(program, arrays, params, num_docs, padded, 0,
                             device)


def _run_program_impl(program: ir.Program, arrays: tuple, params: tuple,
                      num_docs: torch.Tensor, padded: int, row_offset: int,
                      device):
    n = padded
    rows = torch.arange(n, dtype=torch.int64, device=device) + row_offset
    valid = rows.unsqueeze(0) < num_docs.unsqueeze(1)  # [S, N]
    mask = valid
    if program.filter is not None:
        mask = valid & _eval_filter(program.filter, arrays, params)
    if program.mode == "selection":
        return (_packbits(mask),)
    if program.mv_group_slot is not None and program.mode in (
            "group_by", "group_by_sparse"):
        return _run_mv_group_by(program, arrays, params, mask, n)
    if program.mode == "group_by":
        return _dense_group_by_entry(program, arrays, params, mask, n)
    if program.mode == "group_by_sparse":
        return _run_sparse_group_by(program, arrays, params, mask, n)
    if program.mode == "aggregation":
        return _run_ungrouped(program, arrays, params, mask, n)
    raise ValueError(f"program mode {program.mode} is not lowered by this port")


def _packbits(mask: torch.Tensor) -> torch.Tensor:
    """[S, n] bool -> [S, n / 8] uint8, little-endian within each byte
    (numpy's packbits(bitorder="little"), segment/bitpack.unpack_bitmap's
    order). n is a padded bucket, a multiple of 8."""
    weights = torch.tensor([1, 2, 4, 8, 16, 32, 64, 128], dtype=torch.uint8,
                           device=mask.device)
    bits = mask.view(mask.shape[0], -1, 8).to(torch.uint8) * weights
    return bits.sum(-1, dtype=torch.uint8)


def _run_mv_group_by(program: ir.Program, arrays, params, mask, n):
    """MV GROUP BY: expand the rows into (doc x value slot) pairs (the MV
    id matrix [S, n, W] flattens to [S, n W]; every per-doc plane of
    `mv_doc_slots` repeats W times; pad slots are masked) and run the
    dense or sparse group-by over the n W pairs unchanged, kernel A
    included. The matched DOC count, taken before the expansion, is
    appended as [S, 1] int64. Matrices read only by the filter, and
    dictionary planes, pass through."""
    s_count = mask.shape[0]
    scanned = mask.sum(-1, dtype=torch.int64).unsqueeze(1)
    mv = arrays[program.mv_group_slot]
    width = mv.shape[2]
    doc_slots = set(program.mv_doc_slots)
    arrays = tuple(
        mv.reshape(s_count, n * width) if i == program.mv_group_slot
        else a.unsqueeze(2).expand(s_count, n, width).reshape(
            s_count, n * width) if i in doc_slots
        else a
        for i, a in enumerate(arrays))
    mask = (mask.unsqueeze(2) & (mv != program.mv_group_card)).reshape(
        s_count, n * width)
    if program.mode == "group_by_sparse":
        outs = _run_sparse_group_by(program, arrays, params, mask, n * width)
    else:
        outs = _dense_group_by_entry(program, arrays, params, mask, n * width)
    return outs + (scanned,)


def _segment_reduce(values: torch.Tensor, index: torch.Tensor, slots: int,
                    kind: str, init=0) -> torch.Tensor:
    """Per-slot reduction of `values` ([S, N], or broadcastable to it) by
    `index` ([S, N] in [0, slots)): out [S, slots], kind "sum" | "amin" |
    "amax". One scatter over the flattened rows, segment s's slots at
    s * slots: the batched form of jax.ops.segment_sum/min/max."""
    s = index.shape[0]
    flat = (index.to(torch.int64) + torch.arange(
        s, dtype=torch.int64, device=index.device).unsqueeze(1) * slots)
    vals = values.expand(index.shape).reshape(-1)
    if kind == "sum":
        out = torch.zeros(s * slots, dtype=values.dtype, device=index.device)
        out.index_add_(0, flat.reshape(-1), vals)
    else:
        out = torch.full((s * slots,), init, dtype=values.dtype,
                         device=index.device)
        out.scatter_reduce_(0, flat.reshape(-1), vals, kind, include_self=True)
    return out.view(s, slots)


def _dense_group_by_entry(program: ir.Program, arrays, params, mask, n):
    """Dense group-by gid assembly: gid = sum of id * stride over the group
    dims; masked rows route to the trash slot num_groups."""
    gid = torch.zeros(mask.shape, dtype=torch.int32, device=mask.device)
    if program.group_vexprs:
        for vexpr, stride in zip(program.group_vexprs, program.group_strides):
            v = _eval_value(vexpr, arrays, params)
            gid = gid + v.to(torch.int32) * stride
    else:
        for slot, stride in zip(program.group_slots, program.group_strides):
            gid = gid + arrays[slot].to(torch.int32) * stride
    gid = torch.where(mask, gid, program.num_groups)
    return _run_dense_group_by(program, arrays, params, mask, gid,
                               program.num_groups + 1, n)


def _run_dense_group_by(program: ir.Program, arrays, params, mask, gid,
                        num_segments, n):
    """COUNT and every int32-exact SUM ride ONE limb_sums pass (7-bit limb
    planes (S, P, N), one launch for the whole family); scatters remain for
    what the limbs cannot carry (min/max, float sums)."""
    planes = [mask.to(mxu_groupby.PLANE_DTYPE)]  # count plane
    recipes: list = []  # per agg: callable(sums, counts) | None -> _run_agg
    for agg in program.aggs:
        recipes.append(_mxu_agg(agg, arrays, params, mask, planes))
    if not mxu_groupby.supports(num_segments, len(planes)):
        # too many groups/planes for the limb pass: sums take their own
        # scatters; COUNTs still answer from the shared counts column
        planes = []
        recipes = [r if agg.kind == "count" else None
                   for agg, r in zip(program.aggs, recipes)]
    if planes:
        sums = mxu_groupby.limb_sums(torch.stack(planes, dim=1), gid,
                                     num_segments)
        counts = sums[:, 0]
    else:
        sums = None
        counts = _segment_reduce(mask.to(torch.int64), gid, num_segments,
                                 "sum")
    outputs = [counts]
    for agg, recipe in zip(program.aggs, recipes):
        if recipe is None:
            outputs.append(_run_agg(agg, arrays, params, mask, gid,
                                    num_segments, counts=counts))
        else:
            outputs.append(recipe(sums, counts))
    return tuple(outputs)


def _mxu_agg(agg: ir.AggOp, arrays, params, mask, planes):
    """Register an aggregation's limb planes for the limb_sums pass;
    returns a recipe (sums, counts) -> output column, or None if this agg
    kind runs through its own scatter (_run_agg)."""
    if agg.kind == "count":
        return lambda sums, counts: counts
    if agg.kind != "sum":
        return None
    v = _eval_value(agg.vexpr, arrays, params)
    if not _is_fast32(v, agg):
        return None
    b = mxu_groupby.LIMB_BITS
    shifts, nonneg = _limb_shifts(agg.vmin, agg.vmax, b)
    if len(planes) + len(shifts) + (0 if nonneg else 1) > mxu_groupby.MAX_PLANES:
        return None
    vm = torch.where(mask, v, 0).to(torch.int32)
    u = vm.to(torch.int64) & 0xFFFFFFFF  # the two's-complement u32 bits
    refs = []
    for s in shifts:
        refs.append((len(planes), s))
        planes.append(((u >> s) & ((1 << b) - 1)).to(mxu_groupby.PLANE_DTYPE))
    neg_ref = None
    if not nonneg:
        neg_ref = len(planes)
        planes.append((vm < 0).to(mxu_groupby.PLANE_DTYPE))

    def recipe(sums, counts, _refs=refs, _neg=neg_ref):
        total = torch.zeros_like(counts)
        for idx, shift in _refs:
            total = total + (sums[:, idx] << shift)
        if _neg is not None:
            total = total - (sums[:, _neg] << 32)
        return total.to(torch.float64)

    return recipe


def _run_ungrouped(program: ir.Program, arrays, params, mask, n):
    """Un-grouped aggregation: masked row reductions shaped (value, trash)
    per segment to keep the output contract. The card has a 64-bit integer
    ALU, so integer sums are one int64 sum (the JAX package splits them
    into 16-bit limbs summed in int32 blocks; the value is the same)."""
    i64, f64 = torch.int64, torch.float64
    count = mask.sum(-1, dtype=i64)  # [S]
    zero_i = torch.zeros_like(count)
    zero_f = torch.zeros(count.shape, dtype=f64, device=mask.device)
    inf = torch.full(count.shape, float("inf"), dtype=f64, device=mask.device)

    def pair(a, b):
        return torch.stack([a, b], dim=-1)

    outputs = [pair(count, zero_i)]
    for agg in program.aggs:
        if agg.kind == "count":
            outputs.append(pair(count, zero_i))
            continue
        if agg.kind in _MATRIX_KINDS:
            # matrix shapes keep the (1 group + trash) layout: [S, 1, width]
            gid = torch.where(mask, 0, 1).to(torch.int32)
            outputs.append(_run_agg(agg, arrays, params, mask, gid, 2))
            continue
        v = _eval_value(agg.vexpr, arrays, params)
        fast32 = _is_fast32(v, agg)
        if agg.kind == "sum":
            if not v.is_floating_point():
                s = torch.where(mask, v, 0).to(i64).sum(-1).to(f64)
            else:
                s = torch.where(mask, v, 0).to(f64).sum(-1)
            outputs.append(pair(s, zero_f))
        elif agg.kind == "sumsq":
            vf = torch.where(mask, v, 0).to(f64)
            outputs.append(pair((vf * vf).sum(-1), zero_f))
        elif agg.kind in ("min", "max"):
            sign = 1.0 if agg.kind == "min" else -1.0
            if fast32:
                ident = _I32_MAX if agg.kind == "min" else _I32_MIN
                vm = torch.where(mask, v.to(torch.int32), ident)
                s = vm.amin(-1) if agg.kind == "min" else vm.amax(-1)
                out = torch.where(count > 0, s.to(f64), sign * inf)
            else:
                # float32 -> float64 is exact, so the order of the cast
                # and the reduction does not change the result
                vm = torch.where(mask, v.to(f64), sign * float("inf"))
                out = vm.amin(-1) if agg.kind == "min" else vm.amax(-1)
            outputs.append(pair(out, sign * inf))
        else:
            raise ValueError(f"agg kind {agg.kind} is not lowered by this port")
    return tuple(outputs)


def _limb_shifts(vmin, vmax, b):
    """Limb starting bits for an exact two's-complement int32 sum split
    into b-bit limbs, and whether the negative-count correction pass can be
    skipped (planner-proved non-negative columns)."""
    nonneg = vmin is not None and vmin >= 0
    nbits = 32
    if nonneg and vmax is not None:
        nbits = max(1, int(vmax).bit_length())
    return list(range(0, nbits, b)), nonneg


def _fits_i32(v: torch.Tensor, agg: ir.AggOp) -> bool:
    """The 32-bit paths are only sound when every value fits int32: either
    the plane is int32 already, or the planner proved bounds."""
    if v.dtype == torch.int32:
        return True
    return (agg.vmin is not None and agg.vmax is not None
            and agg.vmin >= _I32_MIN and agg.vmax <= _I32_MAX)


def _is_fast32(v: torch.Tensor, agg: ir.AggOp) -> bool:
    return (not v.is_floating_point() and v.dtype != torch.bool
            and _fits_i32(v, agg))


_MATRIX_KINDS = ("distinct_bitmap", "value_hist", "hist_adaptive",
                 "hist_fixed")


def _mxu_or_scatter_counts(mask, sid, num_slots):
    """Per-slot row counts [S, num_slots] int64 of the rows where `mask`
    holds, `sid` [S, N] int32 routing every other row to a slot nothing
    reads: kernel A with one plane when the table is in its domain, an
    exact int64 scatter otherwise."""
    if mxu_groupby.supports(num_slots, 1):
        return mxu_groupby.limb_sums(
            mask.to(mxu_groupby.PLANE_DTYPE).unsqueeze(1), sid, num_slots)[:, 0]
    return _segment_reduce(mask.to(torch.int64), sid, num_slots, "sum")


def _gather_rows(table: torch.Tensor, gid: torch.Tensor) -> torch.Tensor:
    """table[s, min(gid, G)] for a per-group table [S, G] with a zero row
    appended for the trash slot G."""
    g = table.shape[1]
    padded = torch.cat([table, table.new_zeros((table.shape[0], 1))], 1)
    return torch.gather(padded, 1, gid.clamp(max=g).to(torch.int64))


def _run_matrix_agg(agg: ir.AggOp, arrays, params, mask, gid, num_segments):
    """The matrix-shaped aggregations, [S, G, width] per family (G =
    num_segments - 1 groups, no trash row): per-(group, dict id)
    occupancy (bool) or counts (int64), and the two histograms. Count
    passes over G x width + 1 slots go through kernel A at one plane."""
    num_groups = num_segments - 1
    s_count = mask.shape[0]
    if agg.kind in ("distinct_bitmap", "value_hist"):
        card = agg.card
        ids = arrays[agg.ids_slot].to(torch.int32)
        sid = torch.where(mask, gid * card + ids, num_groups * card)
        occ = _mxu_or_scatter_counts(mask, sid, num_groups * card + 1)
        occ = occ[:, :num_groups * card].reshape(s_count, num_groups, card)
        return occ > 0 if agg.kind == "distinct_bitmap" else occ
    if agg.kind == "hist_adaptive":
        return _hist_adaptive(agg, arrays, params, mask, gid, num_groups)
    # hist_fixed: equal-width bins over [lo, hi]; rows outside are dropped
    # (reference HistogramAggregationFunction)
    bins = agg.bins
    v = _eval_value(agg.vexpr, arrays, params).to(torch.float64)
    lo, hi = params[agg.lo_param], params[agg.hi_param]
    # XLA compiles the JAX package's `(hi - lo) / bins` to a multiply by
    # the reciprocal rounded once to float64; bins on an edge depend on it
    width = (hi - lo) * (1.0 / bins)
    b = ((v - lo) / width).to(torch.int32).clamp(0, bins - 1)
    inside = mask & (v >= lo) & (v <= hi)
    sid = torch.where(inside, gid * bins + b, num_groups * bins)
    counts = _segment_reduce(inside.to(torch.int64), sid,
                             num_groups * bins + 1, "sum")
    return counts[:, :num_groups * bins].reshape(s_count, num_groups, bins)


def _f32_scalar(x: float, device) -> torch.Tensor:
    """A 0-dim float32 tensor of x rounded once: multiplying by it keeps
    float32, where a Python float would be rounded by the op itself."""
    return torch.tensor(np.float32(x), device=device)


def _hist_adaptive(agg: ir.AggOp, arrays, params, mask, gid, num_groups):
    """Two count passes of a percentile sketch: pass 1 bins each group's
    values coarsely into `bins` buckets over [lo, hi]; the bucket holding
    the asked quantile (bstar) is found from the pass-1 table; pass 2
    re-bins the rows of exactly that bucket `bins` times finer. Returns
    [S, G, 2 * bins + 1] int64: h1, h2, bstar.

    The binning runs in float32 on (v - lo) offsets (the f64 rebase first,
    or the pre-rebased rawf32r plane), each op in the precision and order
    of the JAX package's COMPILED program, so a row's buckets are
    bit-identical to its, and pass 2 keeps exactly the rows whose pass-1
    bucket is bstar. XLA folds `span / bins` into `span * f32(1 / bins)`
    and `width1 / bins` into `span * f32(1 / bins^2)`; the constants are
    rounded to float32 once, as XLA rounds them. Every op is its own
    kernel, so no multiply and add contract into one FMA on the card."""
    bins = agg.bins
    f32 = torch.float32
    lo64 = params[agg.lo_param]  # [S, 1] float64
    if agg.prebased:
        v = _eval_value(agg.vexpr, arrays, params)
    else:
        v64 = _eval_value(agg.vexpr, arrays, params).to(torch.float64)
        v = (v64 - lo64).to(f32)
    span = (params[agg.hi_param] - lo64).to(f32)
    width1 = span * _f32_scalar(1.0 / bins, span.device)
    b1 = (v / width1).to(torch.int32).clamp(0, bins - 1)
    inside = mask & (v >= 0) & (v <= span)
    trash = num_groups * bins
    s_count = mask.shape[0]
    sid1 = torch.where(inside, gid * bins + b1, trash)
    h1 = _mxu_or_scatter_counts(inside, sid1, trash + 1)[:, :trash] \
        .reshape(s_count, num_groups, bins)
    cum = torch.cumsum(h1, dim=2)
    rank = cum[:, :, -1].to(torch.float64) * (agg.pct / 100.0)
    # the first bucket whose running count reaches the rank (bucket 0
    # when none does); cum is nondecreasing, so that is the count of
    # buckets below the rank
    below = (cum.to(torch.float64) < rank.unsqueeze(2)).sum(2)
    bstar = torch.where(below == bins, 0, below).to(torch.int32)
    bstar_r = _gather_rows(bstar, gid)
    lo_r = _gather_rows(bstar.to(f32) * width1, gid)
    width2 = span * _f32_scalar(1.0 / (bins * bins), span.device)
    inside2 = inside & (b1 == bstar_r)
    b2 = ((v - lo_r) / width2).to(torch.int32).clamp(0, bins - 1)
    sid2 = torch.where(inside2, gid * bins + b2, trash)
    h2 = _mxu_or_scatter_counts(inside2, sid2, trash + 1)[:, :trash] \
        .reshape(s_count, num_groups, bins)
    return torch.cat([h1, h2, bstar.to(torch.int64).unsqueeze(2)], dim=2)


def _run_agg(agg: ir.AggOp, arrays, params, mask, gid, num_segments,
             counts=None):
    """Per-group reductions for what the limb pass does not carry: count,
    sum (int64-exact for integers), sumsq, min, max and the matrix
    kinds."""
    i64, f64 = torch.int64, torch.float64
    if agg.kind == "count":
        return _segment_reduce(mask.to(i64), gid, num_segments, "sum")
    if agg.kind in _MATRIX_KINDS:
        return _run_matrix_agg(agg, arrays, params, mask, gid, num_segments)
    v = _eval_value(agg.vexpr, arrays, params)
    fast32 = _is_fast32(v, agg)
    if agg.kind == "sum":
        if fast32:
            return _segment_reduce(torch.where(mask, v, 0).to(i64), gid,
                                   num_segments, "sum").to(f64)
        return _segment_reduce(torch.where(mask, v, 0).to(f64), gid,
                               num_segments, "sum")
    if agg.kind == "sumsq":
        vf = torch.where(mask, v, 0).to(f64)
        return _segment_reduce(vf * vf, gid, num_segments, "sum")
    if agg.kind in ("min", "max"):
        reduce = "amin" if agg.kind == "min" else "amax"
        inf = float("inf") if agg.kind == "min" else float("-inf")
        if fast32 and counts is not None:
            # masked rows route to the trash slot; EMPTY groups are found
            # by the count column, never by a sentinel a value could hit
            ident = _I32_MAX if agg.kind == "min" else _I32_MIN
            out = _segment_reduce(torch.where(mask, v.to(torch.int32), ident),
                                  gid, num_segments, reduce, ident)
            return torch.where(counts == 0, inf, out.to(f64))
        if v.dtype == torch.float32:
            return _segment_reduce(torch.where(mask, v, inf), gid,
                                   num_segments, reduce, inf).to(f64)
        return _segment_reduce(torch.where(mask, v.to(f64), inf), gid,
                               num_segments, reduce, inf)
    raise ValueError(f"agg kind {agg.kind} is not lowered by this port")


# -- sparse (sort-based) group-by --------------------------------------------


def _cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive int64 prefix sums of an integer [S, N] along N. torch
    scans a batch of rows with one thread block per row, so the S rows
    scan as one flat sequence and each row then drops the rows before
    it (exact in int64)."""
    flat = x.to(torch.int64).reshape(-1).cumsum(0).view(x.shape)
    if x.shape[0] == 1:
        return flat
    before = torch.cat([flat.new_zeros(1), flat[:-1, -1]]).unsqueeze(1)
    return flat - before


def _edges_of(gidx: torch.Tensor, k: int, n: int):
    """Slot edges of a nondecreasing group index [S, N]: edges[s, j] = the
    first row of slot j; fi / li the first and last row of each of the k
    slots (li clamped to fi for empty slots), and both clamped into
    [0, n - 1] for gathers (the JAX gathers clamp the same way)."""
    targets = torch.arange(k + 1, dtype=torch.int64, device=gidx.device)
    edges = torch.searchsorted(
        gidx, targets.expand(gidx.shape[0], k + 1).contiguous())
    fi = edges[:, :k]
    li = torch.maximum(edges[:, 1:] - 1, fi)
    return edges, fi.clamp(0, n - 1), li.clamp(0, n - 1)


def _transitions(key: torch.Tensor) -> torch.Tensor:
    """True at row 0 and wherever the key differs from the row before."""
    first = torch.ones(key.shape, dtype=torch.bool, device=key.device)
    first[:, 1:] = key[:, 1:] != key[:, :-1]
    return first


def _run_sparse_group_by(program: ir.Program, arrays, params, mask, n):
    """High-cardinality group-by: sort-based aggregation on the device
    (the port of the JAX `_run_sparse_group_by`).

        key   = sum of dict_ids[d] * stride[d]   (masked -> sentinel)
        sort  key, stable, carrying a row permutation
        first = key[i] != key[i-1]               (group boundaries)
        gidx  = cumsum(first) - 1                (dense 0-based group index)
        out_k = per-slot reductions              (K+1 slots, K = groups limit)

    Groups past numGroupsLimit (in key order) route to the trash slot, and
    the composite key of each surviving slot is the LAST output. Keys sort
    as int32 when the key space fits, as in the JAX package, so the slot
    order and the keys match. With `keys_presorted` the key plane is
    already nondecreasing in doc order and no sort runs
    (`_presorted_sparse_tail`). The stable sort makes the permutation the
    one the JAX package's sort of (key, iota) gives.
    """
    s_count = mask.shape[0]
    key32 = 0 < program.key_space < _I32_MAX
    kdtype = torch.int32 if key32 else torch.int64
    key = torch.zeros((s_count, n), dtype=kdtype, device=mask.device)
    if program.group_vexprs:
        for vexpr, stride in zip(program.group_vexprs, program.group_strides):
            key = key + _eval_value(vexpr, arrays, params).to(kdtype) * stride
    else:
        for slot, stride in zip(program.group_slots, program.group_strides):
            key = key + arrays[slot].to(kdtype) * stride
    sentinel = _I32_MAX if key32 else ir.SPARSE_KEY_SPACE
    if not program.keys_presorted:
        # masked rows sort to a sentinel tail; the presorted path keeps
        # the raw keys and skips masked rows by identities and mask sums
        key = torch.where(mask, key, sentinel)

    # COUNT DISTINCT rides the same sort as a secondary key: with dict ids
    # sorted within each group, the distinct (group, id) pairs are the
    # first-occurrence rows. The ids pack into the key's low digits when
    # the combined space fits int32 (key' = key * card + id), else they
    # sort as a second key
    distinct = [a for a in program.aggs if a.kind == "distinct_bitmap"]
    if len(distinct) > 1:
        raise ValueError("the sparse group-by takes one DISTINCT column")
    pack_card = None
    if distinct and key32 and not program.keys_presorted and \
            0 < program.key_space * distinct[0].card < _I32_MAX:
        pack_card = int(distinct[0].card)
        ids = arrays[distinct[0].ids_slot].to(torch.int32)
        key = torch.where(mask, key * pack_card + ids, sentinel)

    # agg inputs with mask-neutral elements, computed before the sort
    f64 = torch.float64
    operands = [key]
    if distinct and pack_card is None:
        operands.append(arrays[distinct[0].ids_slot].to(torch.int32))
    specs = []  # per agg: (reduce kind, operand index, agg)
    for agg in program.aggs:
        if agg.kind == "count":
            specs.append(("count", None, agg))
            continue
        if agg.kind == "distinct_bitmap":
            specs.append(("distinct", None if pack_card else 1, agg))
            continue
        v = _eval_value(agg.vexpr, arrays, params)
        fast32 = _is_fast32(v, agg)
        if agg.kind == "sumsq":
            v = torch.where(mask, v, 0).to(f64)
            v, kind = v * v, "sum_f"
        elif agg.kind == "sum":
            if fast32:
                v, kind = torch.where(mask, v, 0).to(torch.int32), "sum_i"
            else:
                v, kind = torch.where(mask, v, 0).to(f64), "sum_f"
        elif agg.kind in ("min", "max"):
            lo = agg.kind == "min"
            if fast32:
                v = torch.where(mask, v.to(torch.int32),
                                _I32_MAX if lo else _I32_MIN)
                kind = "min_i" if lo else "max_i"
            else:
                v = torch.where(mask, v.to(f64),
                                float("inf") if lo else float("-inf"))
                kind = "min_f" if lo else "max_f"
        else:
            raise ValueError(
                f"agg kind {agg.kind} is not lowered by this port's sparse "
                "group-by")
        specs.append((kind, len(operands), agg))
        operands.append(v.expand(mask.shape))

    if program.keys_presorted:
        return _presorted_sparse_tail(program, operands, specs, mask, n)

    if distinct and pack_card is None:
        # (key, id) lexicographic: two stable sorts, the secondary key
        # first, give the permutation of the JAX package's two-key sort
        _, perm = torch.sort(operands[1], dim=-1, stable=True)
        _, p2 = torch.sort(torch.gather(key, 1, perm), dim=-1, stable=True)
        perm = torch.gather(perm, 1, p2)
        skey = torch.gather(key, 1, perm)
    else:
        skey, perm = torch.sort(key, dim=-1, stable=True)
    sorted_ops = [skey] + [torch.gather(op, 1, perm) for op in operands[1:]]
    valid = skey < sentinel
    packed_ids = first_pairs = None
    if pack_card is not None:
        # unpack: the group key is the high digits, the id the low digit.
        # Sentinel rows' quotient stays above every real key
        skey_raw = skey
        skey = torch.div(skey_raw, pack_card, rounding_mode="floor")
        packed_ids = skey_raw - skey * pack_card
        first_pairs = _transitions(skey_raw) & valid
    first = _transitions(skey) & valid
    if distinct and pack_card is None:
        first_pairs = (first | _transitions(sorted_ops[1])) & valid
    gidx = _cumsum(first) - 1
    k = program.num_groups
    n_valid = valid.sum(-1)
    # invalid rows sit in the sentinel tail; pin their gidx above every
    # slot so the edges never include them
    edges, fic, lic = _edges_of(torch.where(valid, gidx, 1 << 30), k, n)
    counts_k = edges[:, 1:] - edges[:, :-1]
    counts = torch.cat([counts_k, (n_valid - edges[:, k]).unsqueeze(1)], 1)
    occupied = counts_k > 0
    # rows of slots [0, k) -> their slot; trimmed and invalid rows -> k
    slot = torch.where(valid & (gidx < k), gidx, k)
    outputs = [counts] + _sparse_aggs(specs, sorted_ops, slot, occupied,
                                      fic, lic, counts, k, packed_ids,
                                      first_pairs)
    outputs.append(torch.where(occupied, torch.gather(skey, 1, fic)
                               .to(torch.int64), -1))
    return tuple(outputs)


def _presorted_sparse_tail(program: ir.Program, operands, specs, mask, n):
    """Sorted-key fast path: no sort (reference SortedGroupByOperator).

    The single key plane (operands[0], raw: no sentinel) is nondecreasing
    over the segment's masked-in rows (the planner checked is_sorted), so
    group runs are already contiguous in doc order. Masked rows sit inside
    and after runs, so a group exists only where a key run has a masked-in
    row, and the run's FIRST masked-in row opens it: fully masked runs
    consume no numGroupsLimit slot. Reductions skip masked rows through
    their identities (the operands carry them) and counts come from a mask
    prefix sum. The padded tail (id 0 past num_docs) is always masked."""
    key = operands[0]
    k = program.num_groups
    n_rows = key.shape[1]
    first_key = _transitions(key)
    mi = mask.to(torch.int64)
    pm = _cumsum(mi)
    # masked-in rows so far within the key run (inclusive): the row where
    # it first reaches 1 opens the run's group. Each run's count before
    # its start lands on the run's index (one add per run start) and is
    # read back at every row of the run (the JAX package scans instead)
    run_id = _cumsum(first_key) - 1
    run_base = torch.gather(_segment_reduce(
        torch.where(first_key, pm - mi, 0), run_id, n_rows, "sum"), 1, run_id)
    first = mask & (pm - run_base == 1)
    gidx = _cumsum(first) - 1  # -1 before group 0
    _, fic, lic = _edges_of(gidx, k, n)
    occupied = torch.arange(k, device=key.device).unsqueeze(0) \
        < gidx[:, -1:] + 1
    counts_k = torch.where(
        occupied, torch.gather(pm, 1, lic) - torch.gather(pm, 1, fic)
        + torch.gather(mi, 1, fic), 0)
    counts = torch.cat(
        [counts_k, (pm[:, -1] - counts_k.sum(-1)).unsqueeze(1)], 1)
    # a masked-in row belongs to the group its run opened
    slot = torch.where(mask & (gidx >= 0) & (gidx < k), gidx, k)
    outputs = [counts] + _sparse_aggs(specs, operands, slot, occupied, fic,
                                      lic, counts, k)
    outputs.append(torch.where(occupied, torch.gather(key, 1, fic)
                               .to(torch.int64), -1))
    return tuple(outputs)


def _sparse_aggs(specs, ops, slot, occupied, fic, lic, counts, k,
                 packed_ids=None, first_pairs=None) -> list:
    """Per-slot outputs of the sparse aggregations over rows `ops` whose
    slot (0..k-1, or the trash k) is `slot`; every slot's rows lie within
    [fic, lic]. The JAX package reads a segmented tree scan at each slot's
    last row for DOUBLE sums and MIN/MAX; here a scatter by slot reduces
    the same rows (MIN/MAX exactly; DOUBLE sums in another order, the
    rounding still local to each group). The DISTINCT bitmap reads its
    ids from `ops` or, packed into the sort key, from `packed_ids`;
    `first_pairs` marks the first row of each (group, id) pair on the
    sort path."""
    f64 = torch.float64
    inf = float("inf")
    out = []
    for kind, oi, agg in specs:
        if kind == "count":
            out.append(counts)
            continue
        if kind == "distinct":
            ids = packed_ids if oi is None else ops[oi]
            out.append(_bitmap_words(ids, first_pairs, slot, occupied, k,
                                     agg.card))
            continue
        v = ops[oi]
        if kind == "sum_i" and not _prefix_exact_gate(v, agg):
            # the planner proved no small bound: exact int64 sums by slot,
            # the trash slot holding the trimmed rows' sum as in the JAX
            # package's _segment_sum_exact_i64
            out.append(_segment_sum_exact_i64(v, slot, k + 1).to(f64))
        elif kind == "sum_i":
            # prefix sums over the slot's row span [fi, li]: rows of the
            # span outside the slot are masked and hold 0. int64 prefixes
            # are exact on the card (the JAX package builds exact f64
            # prefixes from int32 blocks, `_sorted_prefix_f64`)
            p = _cumsum(v)
            s = (torch.gather(p, 1, lic) - torch.gather(p, 1, fic)
                 + torch.gather(v, 1, fic))
            out.append(_with_trash(torch.where(occupied, s.to(f64), 0.0), 0.0))
        elif kind == "sum_f":
            s = _segment_reduce(v, slot, k + 1, "sum")[:, :k]
            out.append(_with_trash(torch.where(occupied, s, 0.0), 0.0))
        else:
            lo = kind.startswith("min")
            ident = (_I32_MAX if lo else _I32_MIN) if kind.endswith("_i") \
                else (inf if lo else -inf)
            s = _segment_reduce(v, slot, k + 1, "amin" if lo else "amax",
                                ident)[:, :k]
            fill = inf if lo else -inf
            out.append(_with_trash(torch.where(occupied, s.to(f64), fill),
                                   fill))
    return out


def _bitmap_words(ids, first_pairs, slot, occupied, k, card) -> torch.Tensor:
    """Per-slot dict-id bitmaps [S, k + 1, W] uint32 (W = ceil(card / 32);
    bit j of word w stands for id 32 w + j; the trash row is zero) of the
    ids of every row by its `slot`.

    On the sort path `first_pairs` marks the first row of each (group, id)
    pair, so a word is the SUM of its bits: one int64 scatter, exact (a
    group's word sum is below 2^32; the JAX package takes it by a
    wrapping uint32 prefix sum). On the presorted path (`first_pairs` None)
    ids repeat within a group unsorted (the JAX package ORs them by a
    segmented scan): each row marks its (slot, id) cell of a (k + 1) x 32 W
    occupancy table, and the words pack from the cells."""
    s_count = ids.shape[0]
    words = -(-card // 32)
    ids = ids.to(torch.int64)
    base = (torch.arange(s_count, dtype=torch.int64, device=ids.device)
            .unsqueeze(1) * (k + 1) + slot)
    if first_pairs is not None:
        bits = torch.where(first_pairs, torch.ones_like(ids) << (ids & 31), 0)
        table = torch.zeros(s_count * (k + 1) * words, dtype=torch.int64,
                            device=ids.device)
        table.index_add_(0, (base * words + (ids >> 5)).reshape(-1),
                         bits.reshape(-1))
        table = table.view(s_count, k + 1, words)
    else:
        cells = torch.zeros(s_count * (k + 1) * words * 32, dtype=torch.uint8,
                            device=ids.device)
        cells[(base * (words * 32) + ids).reshape(-1)] = 1
        shifts = torch.arange(32, dtype=torch.int64, device=ids.device)
        table = (cells.view(s_count, k + 1, words, 32).to(torch.int64)
                 << shifts).sum(-1)
    table = torch.where(occupied.unsqueeze(2), table[:, :k], 0)
    table = torch.cat([table, table.new_zeros((s_count, 1, words))], 1)
    # int64 in [0, 2^32) -> the low 32 bits, read as uint32 (the host
    # decode tells the sparse form by that dtype)
    return table.to(torch.int32).view(torch.uint32)


def _with_trash(col: torch.Tensor, value: float) -> torch.Tensor:
    return torch.cat([col, torch.full((col.shape[0], 1), value,
                                      dtype=col.dtype, device=col.device)], 1)


def _int_prefix_bound(agg):
    bound = max(abs(int(agg.vmin)), abs(int(agg.vmax))) \
        if agg is not None and agg.vmin is not None and agg.vmax is not None \
        else (1 << 31)
    block = 1 << max(0, min(11, 30 - bound.bit_length()))
    return bound, block


def _prefix_exact_gate(v, agg) -> bool:
    """The JAX package's gate for its exact f64 prefix sums (`_sorted_
    prefix_f64`): every partial sum an integer below 2^53, built from int32
    blocks. Kept as is, since it decides what the trash slot of an integer
    SUM holds (0 here; the trimmed rows' sum without it)."""
    if v.is_floating_point():
        return True
    n = v.shape[-1]
    bound, block = _int_prefix_bound(agg)
    return block >= 8 and n % block == 0 and n * bound < (1 << 53)


def _segment_sum_exact_i64(v, gid, num_segments):
    """Exact int64 per-slot sums. The JAX package builds them from int32
    limb scatters because 64-bit scatters are emulated on the TPU; the card
    adds int64 natively."""
    return _segment_reduce(v.to(torch.int64), gid, num_segments, "sum")


# -- device-side sparse combine (server-level merge of segment tables) -------

# empty merged-table slots carry this key; above any real dictionary VALUE
COMBINE_KEY_SENTINEL = 1 << 62


def ids_to_values_i64(keys: torch.Tensor, dict_plane: torch.Tensor):
    """One segment's sparse key output (dict IDS; -1 = empty slot) in
    dictionary VALUE space: dictionaries are segment-local, so keys merged
    across segments must be values. Empty slots take the sort sentinel so
    they tail the merge."""
    card = dict_plane.shape[0]
    ids = keys.clamp(0, max(0, card - 1))
    return torch.where(keys >= 0, dict_plane[ids].to(torch.int64),
                       COMBINE_KEY_SENTINEL)


def combine_sparse_group_tables(seg_keys, seg_counts, seg_states, kinds):
    """Merge S per-segment sparse group tables ON THE DEVICE: the S * K
    rows sort by value-space key (stable) and equal keys reduce into one
    slot, so only the merged table crosses to the host.

    seg_keys:   S x (K,) int64 value-space keys (ids_to_values_i64)
    seg_counts: S x (K+1,) int64 count columns (slot K = trash)
    seg_states: S x tuple of (K+1,) state columns, one per Program agg op
    kinds:      per state column: "add" | "min" | "max"

    Returns (counts(M+1), *states(M+1), keys(M)) with M = S * K: the
    per-segment output layout, so LoweredAgg.vec.extract decodes it. Every
    merged group is kept; the ordered server-level trim runs downstream.
    """
    key = torch.cat(list(seg_keys))
    cnt = torch.cat([c[:-1] for c in seg_counts])
    trash = torch.stack([c[-1] for c in seg_counts]).sum()
    states = [torch.cat([s[i][:-1] for s in seg_states])
              for i in range(len(kinds))]
    m = key.shape[0]
    skey, perm = torch.sort(key, stable=True)
    valid = skey < COMBINE_KEY_SENTINEL
    first = _transitions(skey.unsqueeze(0))[0] & valid
    gidx = _cumsum(first.unsqueeze(0))[0] - 1
    slot = torch.where(valid, gidx, m).unsqueeze(0)
    occupied = torch.arange(m, device=key.device) < first.sum()

    def merge(v, kind, init):
        s = _segment_reduce(v[perm].unsqueeze(0), slot, m + 1, kind, init)
        return s[0, :m]

    outs = [torch.cat([torch.where(occupied, merge(cnt, "sum", 0), 0),
                       trash.reshape(1)])]
    inf = float("inf")
    for v, kind in zip(states, kinds):
        if kind == "add":
            merged = torch.where(occupied, merge(v, "sum", 0), 0)
            tail = 0
        elif kind == "min":
            merged = torch.where(occupied, merge(v, "amin", inf), inf)
            tail = inf
        else:
            merged = torch.where(occupied, merge(v, "amax", -inf), -inf)
            tail = -inf
        outs.append(torch.cat([merged, torch.full((1,), tail, dtype=v.dtype,
                                                  device=v.device)]))
    keys = _segment_reduce(skey.unsqueeze(0), slot, m + 1, "amin",
                           COMBINE_KEY_SENTINEL)[0, :m]
    outs.append(torch.where(occupied, keys, -1))
    return tuple(outs)
