"""Device-resident join pipeline: hash partition + fused join+aggregate.

The port of pinot_tpu/ops/join_pipeline.py. The reference's jitted XLA
programs become plain torch ops on the tensors' device. The MSE
shuffle-join path (mse/device_join.py orchestrates, this module holds the
device stages) replaces the host loop of
``hash_partition → per-partition argsort join → pair gather → bincount``
with three device stages per join stage:

1. **Partition** (twice, one per side) — ``partition_id = mix(key_code) %
   P``, then the ragged per-partition row sets packed into a padded
   ``[P, cap]`` index plane (pow2 ``cap``, pad slots masked by the
   per-partition counts). The probe side only needs partition grouping; the
   build side must come out ascending-key per plane slice — one stable
   sort on the packed ``partition * B + key`` composite when the key span
   fits ``pack_base(P)``, two stable sorts (key, then partition) otherwise
   — so the join stage never sorts again.
2. **Fused join+aggregate** — one batched pass over the ``[P, cap]``
   planes (the reference vmaps over P): binary-search every probe row
   against its pre-sorted build plane and aggregate match contributions
   straight into a ``[P, Gp]`` group table (count / sum via run prefix
   sums, min/max via key-run segment scatters), then reduce over P. Join
   pairs are never materialized; only the packed group table crosses back
   to the host, one copy per stage (``fetch_packed``).

Every shape here is a function of host-known sizes (caps, buckets, P,
Gp), so nothing between the uploads and ``fetch_packed`` waits for the
device.

Bit-identity: callers gate the fused path to integer-typed aggregate
arguments. Integer-valued f64 sums are exact (and therefore
reduction-order-free) below 2^53, so the device's probe-order and
partition-order accumulation equals the host's ``np.bincount`` row-order
accumulation bit for bit; min/max and count are order-independent.
"""

from __future__ import annotations

import numpy as np
import torch

from . import kernels

# output plane layout: one row per aggregate, then these three bookkeeping
# rows (output-row weight per group; matched-pair count per group;
# [total_pairs, overflow, ...] metadata)
META_ROWS = 3

# pad-slot sentinels: distinct per side so a padded probe row can never
# binary-search onto a padded build row
_SENT_PROBE = 1 << 62
_SENT_BUILD = (1 << 62) + 1

# the Fibonacci multiplier 0x9E3779B97F4A7C15 as an int64 (two's
# complement): int64 multiplication wraps exactly as uint64's does
_MIX = 0x9E3779B97F4A7C15 - (1 << 64)
_LOW31 = (1 << 31) - 1


def bucket(n: int) -> int:
    """Power-of-2 padding bucket (at least 8)."""
    b = 1
    while b < n:
        b <<= 1
    return max(b, 8)


def _mix_mod(codes: torch.Tensor, P: int) -> torch.Tensor:
    """Partition id of each int64 key code: ``((codes as u64) *
    0x9E3779B97F4A7C15 >> 33) % P``, a multiplicative (Fibonacci) hash so
    dense code spaces spread across partitions. torch has no uint64
    multiply or shift on CUDA: the product is taken in int64 (it wraps the
    same way) and the shift is made logical by masking off the sign
    extension."""
    h = codes * _MIX
    return ((h >> 33) & _LOW31) % P


def host_partition_counts(codes: np.ndarray, P: int) -> np.ndarray:
    """Exact per-partition row counts of ``_mix_mod`` on the host (uint64
    wraparound matches the device bit for bit). Callers size the plane cap
    off ``counts.max()`` so planes fit the real distribution."""
    h = codes.astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15)
    return np.bincount(((h >> np.uint64(33)) % np.uint64(P)).astype(np.int64),
                       minlength=P)


def pack_base(P: int) -> int:
    """Largest pow2 ``B`` such that packed keys ``part * B + rel`` stay in
    int64 for part ≤ P (the pad partition) and 0 ≤ rel < B."""
    B = 1
    while B * 2 * (P + 1) <= (1 << 63) - 1:
        B <<= 1
    return B


def sort_mode(key_sorted: bool, n: int, cmin: int, cmax: int, P: int) -> str:
    """The partition stage's sort: "rows" (partition grouping only),
    "packed" (one sort on partition * B + key; the key span fits B) or
    "keyed" (two sorts). ``cmin``/``cmax`` bound the side's codes, known on
    the host before the upload."""
    if not key_sorted:
        return "rows"
    if n == 0 or cmax - cmin < pack_base(P):
        return "packed"
    return "keyed"


def _partition(codes: torch.Tensor, n: int, cmin: int, P: int, cap: int,
               mode: str):
    """``[P, cap]`` row-index plane (int64) + per-partition counts of the
    first ``n`` of the padded ``codes`` — element-equal to the reference's
    ``_partition_kernel``."""
    dev = codes.device
    N = codes.shape[0]
    iota = torch.arange(N, device=dev)
    valid = iota < n
    # invalid (pad) rows route past the last real partition so they fall
    # off the end of every plane slice
    part = torch.where(valid, _mix_mod(codes, P), P)
    if mode == "rows":
        # a counting sort: rank of each row within its partition, in row
        # order, then one max-scatter (the reference's .at[].max): pad rows
        # dump 0 onto the clipped last slot, so any real occupant wins;
        # rows past a full partition (count > cap) pile onto its last slot
        # too, and the join stage reports the overflow
        counts = torch.zeros(P + 1, dtype=torch.int64, device=dev)
        counts.index_add_(0, part, torch.ones_like(part))
        counts = counts[:P]
        order = torch.sort(part, stable=True).indices
        starts = torch.cumsum(counts, 0) - counts
        rank = torch.empty_like(order)
        rank[order] = iota - torch.cat(
            [starts, starts.new_full((1,), n)])[part[order]]
        pp = torch.where(valid, part, P - 1)
        slot = torch.where(valid, rank.clamp(0, cap - 1), cap - 1)
        plane = torch.zeros(P * cap, dtype=torch.int64, device=dev)
        plane.scatter_reduce_(0, pp * cap + slot, torch.where(valid, iota, 0),
                              "amax", include_self=True)
        return plane.view(P, cap), counts
    if mode == "packed":
        # ascending part * B + (code - cmin) == ascending (partition, key),
        # stable on row id; callers gate on a key span below B
        B = pack_base(P)
        packed = torch.where(valid, part * B + (codes - cmin), P * B)
        ksorted, order = torch.sort(packed, stable=True)
        bounds = torch.searchsorted(
            ksorted, torch.arange(P + 1, device=dev) * B)
    else:  # "keyed": wide-span keys, by key then (stably) by partition
        by_key = torch.sort(codes, stable=True).indices
        psorted, pos = torch.sort(part[by_key], stable=True)
        order = by_key[pos]
        bounds = torch.searchsorted(psorted, torch.arange(P + 1, device=dev))
    counts = bounds[1:] - bounds[:-1]
    idx = (bounds[:-1, None] + torch.arange(cap, device=dev)[None, :]) \
        .clamp(0, N - 1)
    return order[idx], counts


def partition_planes(codes: torch.Tensor, n: int, P: int, cap: int,
                     key_sorted: bool = False, cmin: int = 0, cmax: int = 0):
    """Device hash partition: pack ``codes[:n]`` (padded to ``codes``'s
    pow2 length) into a ``[P, cap]`` row-index plane + per-partition
    counts, on ``codes``'s device. ``key_sorted=True`` additionally orders
    each plane slice by ascending key code (stable on row id) so the join
    stage can binary-search it without re-sorting; pass the side's min and
    max codes as ``cmin``/``cmax``. Overflowed partitions (count > cap)
    are detected by the join stage and reported in the packed output."""
    return _partition(codes, n, cmin, P, cap,
                      sort_mode(key_sorted, n, cmin, cmax, P))


def fused_join_agg(pcodes, pg, pvals, pplane, pcounts,
                   bcodes, bvals, bplane, bcounts,
                   pn: int, bn: int, spec: tuple, P: int, Gp: int,
                   join_type: str = "INNER", pmask=None, bmask=None):
    """Probe every partition plane against its sorted build plane and
    return the packed f64 ``[len(spec) + META_ROWS, Gp]`` group table: one
    row per aggregate, then the per-group output-row weight (count(*)
    semantics for the join type), then the per-group matched-pair count
    (the LEFT-join all-unmatched → NULL rule rides it), then [total_pairs,
    overflow] (total_pairs is pre-residual, as the host guard counts).

    spec: ("count"|"sum"|"min"|"max", "probe"|"build", value-row index) per
    aggregate. ``join_type`` picks the per-probe-row output weight ``w``
    from the (residual-masked) match count ``cnt``: INNER ``cnt``, LEFT
    ``max(cnt, 1)``, SEMI ``cnt > 0``, ANTI ``cnt == 0``. ``pmask`` /
    ``bmask`` are optional per-row residual masks (padded bool tensors
    aligned with pcodes / bcodes), applied as a probe multiplier and a
    masked build prefix sum. Element-equal (bit-equal f64) to the
    reference's ``_fused_join_agg`` under the integer gate."""
    dev = pcodes.device
    f64 = torch.float64
    capL, capR = pplane.shape[1], bplane.shape[1]
    use_masks = pmask is not None or bmask is not None
    if use_masks:
        if pmask is None:
            pmask = torch.ones(pcodes.shape[0], dtype=torch.bool, device=dev)
        if bmask is None:
            bmask = torch.ones(bcodes.shape[0], dtype=torch.bool, device=dev)

    lrows, rrows = pplane, bplane
    lvalid = torch.arange(capL, device=dev)[None, :] < pcounts[:, None]
    rvalid = torch.arange(capR, device=dev)[None, :] < bcounts[:, None]
    lk = torch.where(lvalid, pcodes[lrows], _SENT_PROBE)
    lg = torch.where(lvalid, pg[lrows], 0)
    # the build plane is ascending-key (stable on row id within equal
    # keys), and every gated key code is below the pad sentinel, so
    # masking pads keeps each lane sorted: no sort here
    rs_k = torch.where(rvalid, bcodes[rrows], _SENT_BUILD)
    s = torch.searchsorted(rs_k, lk)
    e = torch.searchsorted(rs_k, lk, right=True)
    cnt_raw = torch.where(lvalid, e - s, 0)
    bsorted_valid = rs_k < _SENT_BUILD
    zcol = torch.zeros((P, 1), dtype=torch.int64, device=dev)
    if use_masks:
        pm = lvalid & pmask[lrows]
        bm = bsorted_valid & bmask[rrows]
        # matched pairs surviving the residual: prefix sum of the build
        # mask over each probe row's [s, e) key run, zeroed where the probe
        # row itself fails its side's conjuncts
        prefm = torch.cat([zcol, torch.cumsum(bm.to(torch.int64), 1)], 1)
        cnt = torch.where(pm, prefm.gather(1, e) - prefm.gather(1, s), 0)
    else:
        bm = bsorted_valid
        cnt = cnt_raw
    has = cnt > 0
    if join_type == "LEFT":
        w = torch.where(lvalid, cnt.clamp(min=1), 0)
    elif join_type == "SEMI":
        w = has.to(torch.int64)
    elif join_type == "ANTI":
        w = torch.where(lvalid, 1 - has.to(torch.int64), 0)
    else:  # INNER: one output row per surviving pair
        w = cnt

    def group_sum(contrib):
        return torch.zeros((P, Gp), dtype=f64, device=dev).scatter_add_(
            1, lg, contrib)

    def group_ext(kind, contrib, pad):
        return torch.full((P, Gp), pad, dtype=f64, device=dev).scatter_reduce_(
            1, lg, contrib, "amin" if kind == "min" else "amax",
            include_self=True)

    if any(k in ("min", "max") and sd == "build" for k, sd, _ in spec):
        # key-run segmentation of the sorted build plane (for min/max):
        # the run id increments where the sorted key changes
        change = torch.cat([zcol, (rs_k[:, 1:] != rs_k[:, :-1])
                            .to(torch.int64)], 1)
        run_id = torch.cumsum(change, 1)
        s_run = run_id.gather(1, s.clamp(0, capR - 1))

    w_row = group_sum(torch.where(lvalid, w.to(f64), 0.0))
    match_row = group_sum(torch.where(lvalid, cnt.to(f64), 0.0))
    rows = []
    for kind, side, vrow in spec:
        if kind == "count":
            rows.append(w_row)
            continue
        pad = float("inf") if kind == "min" else float("-inf")
        if side == "probe":
            val = pvals[vrow][lrows]
            if kind == "sum":
                rows.append(group_sum(torch.where(lvalid, val * w.to(f64),
                                                  0.0)))
            else:  # min/max: the probe row's own value, where emitted
                rows.append(group_ext(kind, torch.where(lvalid & (w > 0), val,
                                                        pad), pad))
            continue
        # build-side value column, gathered through the sorted plane; only
        # matched pairs contribute (a LEFT join's padded rows carry NULL
        # build payload, which the host aggregate drops)
        if kind == "sum":
            bv = torch.where(bm, bvals[vrow][rrows], 0.0)
            pref = torch.cat([zcol.to(f64), torch.cumsum(bv, 1)], 1)
            contrib = torch.where(has, pref.gather(1, e) - pref.gather(1, s),
                                  0.0)
            rows.append(group_sum(torch.where(lvalid, contrib, 0.0)))
        else:
            bvm = torch.where(bm, bvals[vrow][rrows], pad)
            seg = torch.full((P, capR), pad, dtype=f64,
                             device=dev).scatter_reduce_(
                1, run_id, bvm, "amin" if kind == "min" else "amax",
                include_self=True)
            contrib = torch.where(lvalid & has, seg.gather(1, s_run), pad)
            rows.append(group_ext(kind, contrib, pad))

    # combine across partitions: adds are f64 sums of integer-valued terms
    # (exact, order-free under the int gate); min/max are order-free
    combined = []
    for (kind, _side, _vrow), row in zip(spec, rows):
        if kind == "min":
            combined.append(row.amin(0))
        elif kind == "max":
            combined.append(row.amax(0))
        else:
            combined.append(row.sum(0))
    combined.append(w_row.sum(0))
    combined.append(match_row.sum(0))
    overflow = ((pcounts.max() > capL) | (bcounts.max() > capR)
                | (pn > P * capL) | (bn > P * capR))
    combined.append(torch.cat([cnt_raw.sum().to(f64).view(1),
                               overflow.to(f64).view(1),
                               torch.zeros(Gp - 2, dtype=f64, device=dev)]))
    return torch.stack(combined)


def upload(arr: np.ndarray, device) -> torch.Tensor:
    """A host array on ``device`` without waiting for the device: a CUDA
    copy goes from pinned memory and does not block, so the uploads of a
    stage queue up and its one wait is ``fetch_packed``."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if torch.device(device).type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def fetch_packed(packed: torch.Tensor) -> np.ndarray:
    """The stage's single device→host crossing, counted where the
    single-stage path counts its own (ops/kernels.py)."""
    kernels.count_host_fetch()
    return packed.cpu().numpy()


def gather_stack(cols, idx: np.ndarray, n: int, n_to: int,
                 device) -> torch.Tensor:
    """Gather each f64 column in ``cols`` (host arrays, uploaded here)
    through the host-composed chain index ``idx[:n]`` and stack them into a
    padded ``[len(cols), n_to]`` plane on ``device`` (pad slots zero): the
    expanded chain's value columns, built on the device without ever
    materializing on the host. A take clipped to ``[0, len - 1]``, as the
    reference's ``jnp.take(mode="clip")``."""
    idx_pad = np.zeros(n_to, dtype=np.int64)
    idx_pad[:n] = idx[:n]
    safe = upload(idx_pad, device)
    valid = torch.arange(n_to, device=device) < n
    out = []
    for c in cols:
        col = upload(np.asarray(c, dtype=np.float64), device)
        got = col.index_select(0, safe.clamp(0, max(col.shape[0] - 1, 0)))
        out.append(torch.where(valid, got, 0.0))
    return torch.stack(out)
