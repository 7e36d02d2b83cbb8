"""Device sort-merge equi-join for large MSE intermediates.

The port of pinot_tpu/mse/device_join.py: the reference's jitted XLA
programs become torch ops on the executor's device. Reference analogue:
HashJoinOperator (pinot-query-runtime/.../runtime/operator/
HashJoinOperator.java) builds a host hash table per worker; the device
shape is sort + vectorized binary search:

    rs            = sort(right_keys)                one stable sort
    starts, ends  = searchsorted(rs, left_keys)     vectorized
    expansion     = searchsorted(cumsum(counts), j) one output row per match

Only the join keys travel to the device (already dict-coded to int64 by
the host join's joint-code pass); the result is (left_idx, right_idx)
pairs, and payload columns gather on the device (``gather_payload``).
Output is capped at a pow2 bucket; overflow reports back for the
THROW/BREAK join guards.

Gating: ``PINOT_TPU_DEVICE_JOIN`` = auto (default: on when the executor's
device is ``cuda`` and the sides are large) | 1 (force, on the executor's
device, the CPU included) | 0 (off). The gates are deterministic (sizes,
dtypes, overflow); an error in a device stage fails the query — there is
no fallback to the host join after a device failure.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

# below this many total key rows the host numpy argsort wins (device
# dispatch + transfer overhead dominates)
AUTO_MIN_ROWS = 4_000_000

# the pad sentinel of the pair join: above every gated key code
_SENT = 1 << 62


def _bucket(n: int) -> int:
    b = 1
    while b < n:
        b <<= 1
    return max(b, 1024)


def _join_indices(lk: torch.Tensor, rk: torch.Tensor, ln: int, rn: int,
                  max_out: int):
    """The reference's ``_join_kernel`` on torch tensors: (left index,
    right index, total) over padded key planes, -1 past the output."""
    dev = lk.device
    lvalid = torch.arange(lk.shape[0], device=dev) < ln
    lkm = torch.where(lvalid, lk, _SENT)
    rkm = torch.where(torch.arange(rk.shape[0], device=dev) < rn, rk, _SENT)
    rs_keys, rs_idx = torch.sort(rkm, stable=True)
    starts = torch.searchsorted(rs_keys, lkm)
    ends = torch.searchsorted(rs_keys, lkm, right=True)
    counts = torch.where(lvalid, ends - starts, 0)
    incl = torch.cumsum(counts, 0)
    total = incl[-1]
    excl = incl - counts
    j = torch.arange(max_out, device=dev)
    li = torch.searchsorted(incl, j, right=True).clamp(max=lk.shape[0] - 1)
    ri = rs_idx[(starts[li] + (j - excl[li])).clamp(max=rk.shape[0] - 1)]
    valid_out = j < total.clamp(max=max_out)
    return (torch.where(valid_out, li, -1), torch.where(valid_out, ri, -1),
            total)


def device_join_indices(lcodes: np.ndarray, rcodes: np.ndarray,
                        max_out: int, device):
    """(lidx, ridx, total) for the INNER equi-join of two int64 key
    arrays, on ``device``. ``total`` is the TRUE match count; at most
    ``max_out`` pairs are returned (ascending left order, right order
    within a left row following the right side's stable sort)."""
    ln, rn = len(lcodes), len(rcodes)
    lk = np.zeros(_bucket(ln), dtype=np.int64)
    rk = np.zeros(_bucket(rn), dtype=np.int64)
    lk[:ln] = lcodes
    rk[:rn] = rcodes
    li, ri, total = _join_indices(torch.as_tensor(lk, device=device),
                                  torch.as_tensor(rk, device=device),
                                  ln, rn, _bucket(max_out))
    total = int(total)
    n = min(total, max_out)
    return li[:n].cpu().numpy(), ri[:n].cpu().numpy(), total


def gather_payload(cols: dict, idx: np.ndarray, device):
    """Payload gather of a device-joined side: every pruned output column
    gathered on ``device`` through the pair indices, padded to pow2
    buckets (a take clipped to each column's length). Returns None for no
    columns."""
    if not cols:
        return None
    n = len(idx)
    pidx = np.zeros(_bucket(max(n, 1)), dtype=np.int64)
    pidx[:n] = idx
    tidx = torch.as_tensor(pidx, device=device)
    out = {}
    for name, v in cols.items():
        pv = np.zeros(_bucket(max(len(v), 1)), dtype=v.dtype)
        pv[:len(v)] = v
        col = torch.as_tensor(pv, device=device)
        out[name] = col.index_select(
            0, tidx.clamp(0, col.shape[0] - 1))[:n].cpu().numpy()
    return out


def env_mode() -> str:
    return os.environ.get("PINOT_TPU_DEVICE_JOIN", "auto").lower()


def enabled(ln: int, rn: int, device) -> bool:
    """Whether a pair join of ``ln`` x ``rn`` key rows runs on ``device``
    (the executor's; None for a caller without one)."""
    if device is None:
        return False
    mode = env_mode()
    if mode in ("0", "off", "false"):
        return False
    if mode in ("1", "on", "force", "true"):
        return True
    return ln + rn >= AUTO_MIN_ROWS and torch.device(device).type == "cuda"


# -- fused partition→join→aggregate stage ------------------------------------
#
# The pair-producing join above still materializes (lidx, ridx) and hands
# aggregation back to the host. The fused path below never materializes
# pairs: the whole ``Aggregate ← INNER Join ← 2×hash-receive`` stage runs
# as three device dispatches (partition left, partition right, join+agg)
# and only a [n_aggs, G] group table crosses back — see
# ops/join_pipeline.py for the kernels.

# auto threshold for the fused stage: unlike the pair join it pays off on
# the CPU too (it skips materializing `total_pairs` index/payload arrays
# entirely), so the gate is on input size alone
FUSED_AUTO_MIN_ROWS = 500_000


# P of the device hash partition. Pure routing width: every P yields the
# same result (partition combine is exact), so it only trades plane height
# against batch width.
FUSED_PARTITIONS = 8


@dataclass
class FusedStagePlan:
    """Shape proof that a stage is ``Aggregate ← equi-Join ← two hash
    receives`` (INNER/LEFT/SEMI/ANTI, optional side-separable residual)
    with aggregates the device kernel can produce. Built once per query by
    plan_fused_stage; None means the stage keeps the generic host operator
    tree."""
    agg_node: object
    join_node: object
    receives: tuple            # (left recv, right recv) MailboxReceiveNodes
    probe_side: str            # "left" | "right": the side the groups live on
    group_cols: list = field(default_factory=list)   # (schema name, probe col)
    # (kind, "probe"|"build"|None, value col name|None, out_name) per agg
    aggs: list = field(default_factory=list)
    join_type: str = "INNER"
    # residual conjuncts: (rel "probe"|"build", expr, [(blk key, side col)])
    residual: list = field(default_factory=list)
    # absorbed upstream join chain: which join input it replaces + source
    chain_side: Optional[str] = None    # "left" | "right" | None
    chain: object = None                # ChainSource | None


@dataclass
class ChainSource:
    """An upstream join stage absorbed into a fused stage: its output
    table never materializes — the fused stage expands the join on row
    INDICES and its leaf blocks hand off raw through the mailbox, so
    intermediates stay on the device (values) or never exist (pairs)."""
    stage_id: int
    join_node: object
    left: object     # MailboxReceiveNode | ChainSource
    right: object    # MailboxReceiveNode | ChainSource

    def leaf_receives(self):
        for side in (self.left, self.right):
            if isinstance(side, ChainSource):
                yield from side.leaf_receives()
            else:
                yield side

    def stage_ids(self):
        yield self.stage_id
        for side in (self.left, self.right):
            if isinstance(side, ChainSource):
                yield from side.stage_ids()


def _match_col(name: str, schema: list) -> Optional[str]:
    if name in schema:
        return name
    suffix = [c for c in schema if c.endswith("." + name)]
    return suffix[0] if len(suffix) == 1 else None


def _conjuncts(e) -> list:
    """Flatten an AND-tree into its conjunct expressions."""
    if e.is_function and e.function.name == "and":
        out = []
        for a in e.function.arguments:
            out.extend(_conjuncts(a))
        return out
    return [e]


def _plan_residual(residual, lschema, rschema) -> Optional[list]:
    """Decompose a residual filter into per-side conjuncts the device can
    apply as row masks. Each conjunct must reference exactly ONE side
    (then pair-filtering factorizes into a probe mask × a build mask) and
    resolve unambiguously under the same naming rule the host's
    _residual_block applies (right-side duplicate names carry a "0"
    suffix). Returns [(side, expr, [(eval-block key, side column)])] or
    None — ambiguous/cross-side conjuncts keep the host path, which also
    owns the host's error behavior for unresolvable names."""
    from . import operators

    out = []
    for conj in _conjuncts(residual):
        ids: set = set()
        operators._expr_ids(conj, ids)
        if not ids:
            return None       # literal-only conjunct: host path
        side, cols = None, []
        for i in ids:
            lc, rc = _match_col(i, lschema), _match_col(i, rschema)
            if lc is not None and rc is not None:
                return None   # ambiguous across sides (host raises)
            if lc is not None:
                got, key, col = "left", lc, lc
            elif rc is not None:
                got, key, col = "right", rc, rc
            elif (i.endswith("0") and i[:-1] in rschema
                    and i[:-1] in lschema):
                # the host's dup rename: right column shadowed by a
                # same-named left column surfaces as <name>0
                got, key, col = "right", i, i[:-1]
            else:
                return None
            if side is None:
                side = got
            elif side != got:
                return None   # conjunct spans both sides
            cols.append((key, col))
        out.append((side, conj, cols))
    return out


def plan_fused_stage(stage) -> Optional[FusedStagePlan]:
    from .fragmenter import MailboxReceiveNode
    from .logical import AggregateNode, JoinNode

    agg = stage.root
    if not isinstance(agg, AggregateNode) or not agg.group_exprs:
        return None
    join = agg.inputs[0]
    if (not isinstance(join, JoinNode)
            or join.join_type not in ("INNER", "LEFT", "SEMI", "ANTI")
            or not join.left_keys or len(join.inputs) != 2):
        return None
    recv_l, recv_r = join.inputs
    if not all(isinstance(r, MailboxReceiveNode) and r.dist == "hash"
               for r in (recv_l, recv_r)):
        return None
    lschema, rschema = list(recv_l.schema), list(recv_r.schema)

    def resolve(name):
        lc, rc = _match_col(name, lschema), _match_col(name, rschema)
        if (lc is None) == (rc is None):   # missing or ambiguous
            return None
        return ("left", lc) if lc is not None else ("right", rc)

    group_cols, sides = [], set()
    for out_name, g in zip(agg.schema, agg.group_exprs):
        if not g.is_identifier:
            return None
        got = resolve(g.identifier)
        if got is None:
            return None
        sides.add(got[0])
        group_cols.append((out_name, got[1]))
    if len(sides) != 1:
        # groups split across sides: every probe row would need two group
        # codes — host path handles it
        return None
    probe_side = sides.pop()
    if join.join_type in ("LEFT", "SEMI", "ANTI") and probe_side != "left":
        # LEFT preserves the left side (probe must be the preserved side);
        # SEMI/ANTI project the left side only
        return None

    aggs = []
    for call in agg.agg_calls:
        if call.condition is not None or call.extra:
            return None
        if call.name == "count" and not call.args:
            aggs.append(("count", None, None, call.out_name))
            continue
        if call.name not in ("sum", "min", "max") or len(call.args) != 1 \
                or not call.args[0].is_identifier:
            return None
        got = resolve(call.args[0].identifier)
        if got is None:
            return None
        rel = "probe" if got[0] == probe_side else "build"
        if rel == "build" and join.join_type in ("SEMI", "ANTI"):
            return None    # output schema is probe-side only
        aggs.append((call.name, rel, got[1], call.out_name))

    residual = []
    if join.residual is not None:
        planned = _plan_residual(join.residual, lschema, rschema)
        if planned is None:
            return None
        residual = [("probe" if side == probe_side else "build", expr, cols)
                    for side, expr, cols in planned]
    return FusedStagePlan(agg, join, (recv_l, recv_r), probe_side,
                          group_cols, aggs, join.join_type, residual)


def plan_chain_source(stage) -> Optional[ChainSource]:
    """One absorbable chain level: a stage whose whole output is a plain
    INNER equi-join of two hash receives (no residual, no other
    operators). The runtime nests these and rewires the leaves' mailboxes
    straight to the consuming fused stage."""
    from .fragmenter import MailboxReceiveNode
    from .logical import JoinNode

    join = stage.root
    if (not isinstance(join, JoinNode) or join.join_type != "INNER"
            or join.residual is not None or not join.left_keys
            or len(join.inputs) != 2):
        return None
    if not all(isinstance(r, MailboxReceiveNode) and r.dist == "hash"
               for r in join.inputs):
        return None
    return ChainSource(stage.stage_id, join, join.inputs[0], join.inputs[1])


def _src_schema(side) -> list:
    return list(side.join_node.schema if isinstance(side, ChainSource)
                else side.schema)


def chain_resolve(src: ChainSource, name: str):
    """Resolve an output column of an absorbed join to its leaf receive
    node + leaf column, through the host joiner's naming rule (left wins
    name collisions; the shadowed right column carries a "0" suffix).
    None when the fused consumer could not reconstruct the column."""
    lsch, rsch = _src_schema(src.left), _src_schema(src.right)
    if name in lsch:
        side, col = src.left, name
    elif name in rsch:
        side, col = src.right, name
    elif name.endswith("0") and name[:-1] in rsch:
        side, col = src.right, name[:-1]
    else:
        return None
    if isinstance(side, ChainSource):
        return chain_resolve(side, col)
    return (side, col)


# -- chain expansion: joins as composed row indices --------------------------


class _SideView:
    """A join input as (leaf array, composed row index) pairs: column
    VALUES stay in their leaf blocks; only int indices materialize."""
    n: int

    def raw(self, name):
        raise NotImplementedError

    def host_col(self, name) -> np.ndarray:
        arr, idx = self.raw(name)
        return arr if idx is None else arr[idx]


class _LeafView(_SideView):
    def __init__(self, block: dict, n: int):
        self.block, self.n = block, n

    def raw(self, name):
        return np.asarray(self.block[name]), None


class _JoinView(_SideView):
    """An expanded chain level: left/right views + the (lidx, ridx) pair
    indices of the equi-join between them (exactly the host joiner's
    argsort/searchsorted expansion, so pair sets match bit-for-bit)."""

    def __init__(self, src: ChainSource, left, right, lidx, ridx, n):
        self.src, self.left, self.right = src, left, right
        self.lidx, self.ridx, self.n = lidx, ridx, n
        self._memo: dict = {}

    def raw(self, name):
        lsch, rsch = _src_schema(self.src.left), _src_schema(self.src.right)
        if name in lsch:
            side, col, idx = self.left, name, self.lidx
        elif name in rsch:
            side, col, idx = self.right, name, self.ridx
        elif name.endswith("0") and name[:-1] in rsch:
            side, col, idx = self.right, name[:-1], self.ridx
        else:
            raise KeyError(name)
        arr, sub = side.raw(col)
        key = (id(side), sub is None)
        if sub is not None:
            key = (id(side), id(sub))
        if key not in self._memo:
            self._memo[key] = idx if sub is None else sub[idx]
        return arr, self._memo[key]


def expand_chain(src: ChainSource, get_leaf, ctx=None):
    """Expand an absorbed chain into a _JoinView bottom-up on the host's
    OWN join machinery (joint codes + stable argsort + searchsorted +
    repeat — the exact expansion op_join performs), but producing only
    index vectors. Returns None when a level's pair count exceeds
    MAX_ROWS_IN_JOIN — the host fallback owns THROW/BREAK semantics."""
    from . import operators

    def build(node):
        if not isinstance(node, ChainSource):
            block, n = get_leaf(node)
            return _LeafView(block, n)
        lv, rv = build(node.left), build(node.right)
        if lv is None or rv is None:
            return None
        join = node.join_node
        lcodes, rcodes = operators._joint_codes(
            [lv.host_col(k) for k in join.left_keys],
            [rv.host_col(k) for k in join.right_keys], lv.n, rv.n, ctx)
        rs = np.argsort(rcodes, kind="stable")
        rsorted = rcodes[rs]
        starts = np.searchsorted(rsorted, lcodes, side="left")
        ends = np.searchsorted(rsorted, lcodes, side="right")
        counts = ends - starts
        total = int(counts.sum())
        if total > operators.MAX_ROWS_IN_JOIN:
            return None
        lidx = np.repeat(np.arange(lv.n), counts)
        offs = np.arange(total) - np.repeat(
            np.cumsum(counts) - counts, counts)
        ridx = rs[np.repeat(starts, counts) + offs]
        return _JoinView(node, lv, rv, lidx, ridx, total)

    return build(src)


def host_expand_chain(src: ChainSource, get_leaf, ctx=None) -> dict:
    """Materialize an absorbed chain as the block its stage would have
    sent, via the host joiner itself — the fused fallback path for
    absorbed plans (exact semantics including the join-row guards)."""
    from . import operators

    def build(node):
        if not isinstance(node, ChainSource):
            return get_leaf(node)[0]
        lb, rb = build(node.left), build(node.right)
        j = node.join_node
        return operators.op_join(lb, rb, j.join_type, j.left_keys,
                                 j.right_keys, j.residual, list(j.schema),
                                 ctx)

    return build(src)


def _as_view(side) -> _SideView:
    if isinstance(side, _SideView):
        return side
    from .mailbox import block_len

    return _LeafView(side, block_len(side))


def run_fused(left, right, plan: FusedStagePlan, device, ctx=None):
    """Execute a fused stage on ``device``. ``left``/``right`` are blocks
    or chain _SideViews (absorbed upstream joins). Returns (block, info) or
    None when a deterministic gate fails (dtype, empty side, keys at the
    pad sentinels, non-bool residual, plane overflow, the join row limit)
    — the caller's host path owns exact semantics for those. Between the
    uploads and the one fetch, every shape is host-known, so the stage
    waits for the device once."""
    from . import operators
    from ..ops import join_pipeline as jp

    lview, rview = _as_view(left), _as_view(right)
    ln, rn = lview.n, rview.n
    if ln == 0 or rn == 0:
        return None
    join = plan.join_node
    lcodes, rcodes = operators._joint_codes(
        [lview.host_col(k) for k in join.left_keys],
        [rview.host_col(k) for k in join.right_keys], ln, rn, ctx)

    probe, build = ((lview, rview) if plan.probe_side == "left"
                    else (rview, lview))
    pcodes, bcodes = ((lcodes, rcodes) if plan.probe_side == "left"
                      else (rcodes, lcodes))
    pn, bn = len(pcodes), len(bcodes)
    # raw int keys ARE their own codes (the int fast path): values at or
    # above the pad sentinels would alias padding
    for c in (pcodes, bcodes):
        if len(c) and (int(c.max()) >= (1 << 62)
                       or int(c.min()) <= -(1 << 62)):
            return None
    # the build side's code range picks the partition stage's sort
    bmin, bmax = int(bcodes.min()), int(bcodes.max())

    # bit-identity gate: integer-valued f64 accumulation is exact, hence
    # reduction-order-free; float args would make partition order visible
    pv_names = [c for k, s, c, _ in plan.aggs if s == "probe"]
    bv_names = [c for k, s, c, _ in plan.aggs if s == "build"]
    for side_view, names in ((probe, pv_names), (build, bv_names)):
        for nm in dict.fromkeys(names):
            arr, _ = side_view.raw(nm)
            if not operators._int_like(np.asarray(arr)):
                return None

    # residual conjuncts factorize into per-side row masks; each must
    # evaluate to a real boolean vector (then the host's AND/_truthy and
    # the device's mask multiply agree exactly — NaN truthiness never
    # enters), else the host path owns the semantics
    pmask = bmask = None
    for rel, expr, cols in plan.residual:
        view = probe if rel == "probe" else build
        blk = {key: view.host_col(col) for key, col in cols}
        m = np.asarray(operators.eval_expr(
            expr, blk, probe.n if rel == "probe" else build.n))
        if m.ndim != 1 or m.dtype != np.bool_:
            return None
        if rel == "probe":
            pmask = m if pmask is None else (pmask & m)
        else:
            bmask = m if bmask is None else (bmask & m)

    gcols = [probe.host_col(c) for _, c in plan.group_cols]
    gcodes, num, first = operators.group_codes(gcols)
    if num == 0:
        return None

    P = FUSED_PARTITIONS
    Np, Nb = jp.bucket(pn), jp.bucket(bn)
    # plane caps: the partition mix is pure, so the EXACT per-partition
    # counts are a host bincount — size each plane to the real max
    # (pow2-bucketed). Skewed keys (NULL buckets, heavy hitters) stay on
    # the device as long as their partition fits a plane at all.
    cap_l = min(Np, jp.bucket(max(
        64, int(jp.host_partition_counts(pcodes, P).max()))))
    cap_r = min(Nb, jp.bucket(max(
        64, int(jp.host_partition_counts(bcodes, P).max()))))
    Gp = jp.bucket(num)

    def upload(a, n_to, dtype):
        out = np.zeros(n_to, dtype=dtype)
        out[:len(a)] = a
        return jp.upload(out, device)

    dispatches = [3]

    def side_vals(view, order, n_to):
        """Value plane of one side: plain blocks pad on the host and
        upload; chained sides gather on the device through the composed
        chain indices (one gather_stack per distinct leaf index), so chain
        values never materialize on the host."""
        if not order:
            return torch.zeros((1, n_to), dtype=torch.float64, device=device)
        if isinstance(view, _LeafView):
            return torch.stack([upload(np.asarray(view.block[c], np.float64),
                                       n_to, np.float64) for c in order])
        groups: dict = {}
        for pos, c in enumerate(order):
            arr, idx = view.raw(c)
            groups.setdefault(id(idx), (idx, []))[1].append((pos, arr))
        parts = [None] * len(order)
        for idx, cols in groups.values():
            plane = jp.gather_stack([a for _, a in cols], idx, view.n, n_to,
                                    device)
            dispatches[0] += 1
            for row, (pos, _) in enumerate(cols):
                parts[pos] = plane[row]
        return torch.stack(parts)

    pv_order = list(dict.fromkeys(pv_names))
    bv_order = list(dict.fromkeys(bv_names))
    spec = tuple(
        ("count", "probe", 0) if k == "count"
        else (k, s, (pv_order if s == "probe" else bv_order).index(c))
        for k, s, c, _ in plan.aggs)

    pvals = side_vals(probe, pv_order, Np)
    bvals = side_vals(build, bv_order, Nb)
    pk = upload(pcodes, Np, np.int64)
    bk = upload(bcodes, Nb, np.int64)
    pg = upload(gcodes, Np, np.int64)
    # the probe plane only needs partition grouping; the build plane must
    # come out ascending-key for the binary search
    pplane, pcounts = jp.partition_planes(pk, pn, P, cap_l)
    bplane, bcounts = jp.partition_planes(bk, bn, P, cap_r, key_sorted=True,
                                          cmin=bmin, cmax=bmax)
    packed = jp.fused_join_agg(
        pk, pg, pvals, pplane, pcounts, bk, bvals, bplane, bcounts,
        pn, bn, spec, P, Gp, join_type=plan.join_type,
        pmask=None if pmask is None else upload(pmask, Np, bool),
        bmask=None if bmask is None else upload(bmask, Nb, bool))
    out = jp.fetch_packed(packed)

    n_aggs = len(plan.aggs)
    meta = out[n_aggs + 2]
    total_pairs = int(meta[0])
    if meta[1] != 0.0 or total_pairs > operators.MAX_ROWS_IN_JOIN:
        # plane overflow (key skew beyond the cap) or the join row guard:
        # the host path owns THROW/BREAK semantics
        return None
    w_row = out[n_aggs][:num]         # output rows per group
    match_row = out[n_aggs + 1][:num]  # matched pairs per group
    present = w_row > 0

    block = {}
    for (out_name, col), kv in zip(plan.group_cols, gcols):
        block[out_name] = kv[first][present]
    no_match = match_row[present] == 0
    for i, (kind, s, _c, out_name) in enumerate(plan.aggs):
        vals = out[i][:num][present]
        if kind == "count":
            block[out_name] = vals.astype(np.int64)
            continue
        if s == "build" and no_match.any():
            # a group whose every output row is LEFT-padded aggregates
            # NULL build payload — the host emits NaN there
            vals = vals.copy()
            vals[no_match] = np.nan
        block[out_name] = vals
    return block, {"total_pairs": total_pairs,
                   "dispatches": dispatches[0]}
