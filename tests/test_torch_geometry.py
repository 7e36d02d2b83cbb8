"""The launch geometry of the two group-by kernels (pinot_tpu_torch/ops/
geometry.py), checked on the CPU over the domain of `supports()`.

The CUDA kernels run only on the card, but where they read and where they
add is fixed by this geometry: every tile of rows goes to exactly one CTA,
every output counter has exactly one owning CTA, each CTA's table and ring
fit its shared memory, and a table is flushed before its int32 counters of
7-bit values could overflow. A shape whose table fits the cluster is read
in one pass. A family of S segments (kernel A's batch axis) is one
launch: the clusters split the family's units into contiguous ranges, so
every (segment, row) still falls in exactly one tile, and a table holds
one segment's sums between two flushes.
"""

from __future__ import annotations

import numpy as np
import pytest

from pinot_tpu_torch.ops import geometry, mxu_groupby

N_MAIN = 1 << 23
Q2_WIDTHS = (1, 1, 2, 4)            # s_region, d_year, p_brand, lo_revenue
Q9_WIDTHS = Q2_WIDTHS + (4, 4)      # + lo_extendedprice, lo_quantity


def limb_widths(p):
    return (4,) + (1,) * p


def stacked_mis(n, p):
    """limb_sums's slot offsets: gid at 0, plane k at k * n bytes."""
    return (0,) + tuple((k * n) % 16 for k in range(p))


def _one_tile(widths):
    return geometry.tile_rows_for(widths)


# name -> (n, planes, groups, widths, mis)
SHAPES = {
    "q2_plan": (N_MAIN, 4, 7001, Q2_WIDTHS, None),
    "q9_plan": (N_MAIN, 8, 7001, Q9_WIDTHS, None),
    "q2_unfused": (N_MAIN, 4, 7001, limb_widths(4), None),
    "flagship": (N_MAIN, 4, 1001, limb_widths(4), None),
    "q9_shape": (N_MAIN, 8, 7001, limb_widths(8), None),
    "G32768_P1": (N_MAIN, 1, 32768, limb_widths(1), None),
    "P24_G128": (N_MAIN, 24, 128, limb_widths(24), None),
    "P24_G1001": (N_MAIN, 24, 1001, limb_widths(24), None),
    "P24_G21760": (1 << 20, 24, 21760, limb_widths(24), None),
    "P8_G32768": (1 << 20, 8, 32768, limb_widths(8), None),
    "P12_G32768": (1 << 20, 12, 32768, limb_widths(12), None),
    "P16_G32768": (1 << 20, 16, 32768, limb_widths(16), None),
    "ragged_n": (N_MAIN - 12345, 5, 1001, limb_widths(5),
                 stacked_mis(N_MAIN - 12345, 5)),
    "ragged_100003": (100_003, 3, 1, limb_widths(3), stacked_mis(100_003, 3)),
    "ragged_2p20_7": ((1 << 20) + 7, 1, 32768, limb_widths(1),
                      stacked_mis((1 << 20) + 7, 1)),
    "fused_ragged": ((1 << 22) + 3, 6, 2001, (2, 4), (0, 4)),
    "below_one_tile": (1000, 4, 7001, Q2_WIDTHS, None),
    "one_tile": (_one_tile(Q2_WIDTHS), 4, 7001, Q2_WIDTHS, None),
    "one_tile_ragged": (_one_tile(limb_widths(2)), 2, 10, limb_widths(2),
                        stacked_mis(_one_tile(limb_widths(2)) + 1, 2)),
    "n1": (1, 2, 10, limb_widths(2), None),
    "saturation": ((1 << 25) + 5, 1, 1, limb_widths(1), stacked_mis((1 << 25) + 5, 1)),
}

# the supports() domain on a grid of plane and group counts
DOMAIN = [(p, g) for p in (1, 2, 3, 4, 7, 8, 12, 16, 24)
          for g in (1, 2, 127, 128, 129, 1001, 7001, 16384, 21760, 32768)
          if mxu_groupby.supports(g, p)]

# family shapes: (n, P, G, widths, mis, segments)
FAMILY_SHAPES = {
    "family_S1": (N_MAIN, 4, 7001, limb_widths(4), None, 1),
    "family_q2_S4": (N_MAIN, 4, 7001, limb_widths(4), None, 4),
    "family_flagship_S4": (N_MAIN, 4, 1001, limb_widths(4), None, 4),
    "family_q4_S16": (1 << 21, 4, 7001, limb_widths(4), None, 16),
    "family_S16_small": (20_000, 3, 700, limb_widths(3), None, 16),
    "family_S16_ragged": (100_016 + 5 * 16, 2, 1001, limb_widths(2),
                          stacked_mis(100_096, 2), 16),
    "family_split_S4": (1 << 20, 24, 1001, limb_widths(24), None, 4),
    "family_shared_S3": (1 << 20, 16, 32768, limb_widths(16), None, 3),
    "family_S16_below_one_tile": (1000, 2, 10, limb_widths(2), None, 16),
}

ONE_CLUSTER = {
    # every cluster size may run, but only one cluster at a time: the
    # rows of the whole input feed one cluster's tables
    "one_cluster": lambda c, smem: 1,
    # one lone CTA
    "one_cta": lambda c, smem: 1 if c == 1 else 0,
}


def _plan(n, p, g, widths, mis, active=None, segments=1):
    return geometry.plan(n, p, g, widths, mis, segments=segments,
                         active_clusters=active)


def _unpack(shape):
    """(n, P, G, widths, mis, segments) of a SHAPES or FAMILY_SHAPES entry."""
    return tuple(shape[:5]) + ((shape[5],) if len(shape) > 5 else (1,))


def _cases():
    for name, shape in SHAPES.items():
        yield pytest.param(shape, None, id=name)
    for name, shape in FAMILY_SHAPES.items():
        yield pytest.param(shape, None, id=name)
    yield pytest.param(FAMILY_SHAPES["family_q2_S4"],
                       ONE_CLUSTER["one_cluster"], id="family_q2_S4_one_cluster")
    for p, g in DOMAIN:
        yield pytest.param((1 << 20, p, g, limb_widths(p), None), None,
                           id=f"domain_P{p}_G{g}")
    for shape in ("saturation", "q9_plan", "ragged_n"):
        yield pytest.param(SHAPES[shape], ONE_CLUSTER["one_cluster"],
                           id=f"{shape}_one_cluster")
    for shape in ("saturation", "ragged_n", "G32768_P1"):
        yield pytest.param(SHAPES[shape], ONE_CLUSTER["one_cta"],
                           id=f"{shape}_one_cta")


CASES = list(_cases())


@pytest.mark.parametrize("shape,active", CASES)
def test_every_counter_has_exactly_one_owner(shape, active):
    n, p, g, widths, mis, segments = _unpack(shape)
    geo = _plan(n, p, g, widths, mis, active, segments)
    if geo.mode == "global":
        assert geo.table_counters == 0
        return
    pp, gg = np.meshgrid(np.arange(p), np.arange(g), indexing="ij")
    pp, gg = pp.ravel(), gg.ravel()
    if geo.mode == "shared":
        rank = gg // geo.table_groups
        index = pp * geo.table_groups + gg % geo.table_groups
        # the kernels' owner: a multiply-high by tg_inv
        assert np.array_equal((gg.astype(np.uint64) * np.uint64(geo.tg_inv))
                              >> np.uint64(32), rank.astype(np.uint64))
    elif geo.mode == "split":
        tp = geo.table_planes
        rank = pp // tp
        index = (pp % tp) * geo.groups + gg
        # the kernels' range of planes [rank * tp, min(P, (rank + 1) * tp))
        assert -(-p // tp) == geo.cluster
    else:
        per = -(-(-(-geo.table_counters // 4)) // geo.cluster)
        index = pp * geo.groups + gg
        rank = (index // 4) // per
    # the vectorised ownership is the one geometry.owner states
    for k in (0, len(pp) // 2, len(pp) - 1):
        assert geo.owner(int(pp[k]), int(gg[k])) == (rank[k], index[k])
    assert rank.min() >= 0 and rank.max() < geo.cluster
    assert index.min() >= 0 and index.max() < geo.table_counters
    key = rank.astype(np.int64) * geo.table_counters + index
    assert np.unique(key).size == p * g


@pytest.mark.parametrize("shape,active", CASES)
def test_table_and_ring_fit_shared_memory(shape, active):
    n, p, g, widths, mis, segments = _unpack(shape)
    geo = _plan(n, p, g, widths, mis, active, segments)
    assert geo.smem_bytes <= geometry.SMEM_MAX < 232_448
    assert geo.table_off >= 8 * 2 * geometry.MAX_STAGES >= 8 * 2 * geo.stages
    assert geo.table_off + 4 * geo.table_counters <= geo.ring_off
    assert geo.ring_off + geo.stages * geo.stage_bytes == geo.smem_bytes
    assert geo.stages >= 2
    for c, o in zip(geo.copy_bytes, geo.smem_off):
        assert c % 16 == 0 and o % 16 == 0 and o + c <= geo.stage_bytes
    assert geo.tx_bytes < 1 << 20  # an mbarrier's transaction count


@pytest.mark.parametrize("shape,active", CASES)
def test_flush_keeps_int32_counters_exact(shape, active):
    n, p, g, widths, mis, segments = _unpack(shape)
    geo = _plan(n, p, g, widths, mis, active, segments)
    assert geo.rows_per_flush() * 127 < 1 << 31
    if geo.mode != "global":
        # the loop steps between flushes cover the rows they claim
        fed = geo.epoch_iters * geo.feeders() * geo.tile_rows + geo.tail_rows
        assert fed * 127 < 1 << 31


def _walk(geo):
    """The kernels' walk by their own formula (geometry.tile_of, checked
    at both ends of every range, vectorised in between): for every unit,
    its cluster, its step in that cluster's range and its segment; and
    every (segment, tile) read."""
    bounds = np.array([geo.unit_range(q) for q in range(geo.clusters)])
    u = np.arange(geo.units)
    cl = np.searchsorted(bounds[:, 1], u, side="right")
    step = u - bounds[cl, 0]
    seg = u // max(1, geo.seg_units)
    ranks = np.arange(1 if geo.mode == "split" else geo.cluster)
    tile = ((u % max(1, geo.seg_units)) * geo.unit_tiles)[:, None] + ranks
    for k in {0, geo.units - 1} if geo.units else ():
        for r in ranks:
            want = (int(seg[k]), int(tile[k, r]))
            got = geo.tile_of(int(step[k]), int(cl[k]), int(r))
            assert got == (want if want[1] < geo.tiles else None)
    keep = tile < geo.tiles
    read = np.broadcast_to(seg[:, None], tile.shape)[keep] * geo.tiles \
        + tile[keep]
    return cl, step, seg, read


@pytest.mark.parametrize("shape,active", CASES)
def test_every_row_falls_in_exactly_one_tile(shape, active):
    n, p, g, widths, mis, segments = _unpack(shape)
    geo = _plan(n, p, g, widths, mis, active, segments)
    mis = mis or (0,) * len(widths)
    assert 0 <= geo.full_rows <= n and geo.full_rows % geo.tile_rows == 0
    assert geo.full_rows + geo.tail_rows == n
    assert geo.tail_rows < geo.tile_rows + 16
    # the clusters' ranges cover the family's units once, in order
    bounds = [geo.unit_range(q) for q in range(geo.clusters)]
    assert bounds[0][0] == 0 and bounds[-1][1] == geo.units
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    assert max(e - s for s, e in bounds) == geo.iters
    # every whole tile of every segment is read once; the rest of each
    # segment is its tail
    _, _, _, read = _walk(geo)
    assert np.array_equal(np.sort(read), np.arange(segments * geo.tiles))
    for k, (w, m) in enumerate(zip(widths, mis)):
        # the last tile's copy ends inside the plane: never past row n - 1
        end = m + geo.full_rows * w
        assert -(-end // 16) * 16 <= m + n * w or geo.full_rows == 0
        assert geo.copy_bytes[k] == geo.tile_rows * w + (16 if m else 0)


@pytest.mark.parametrize("shape,active", CASES)
def test_a_table_holds_one_segment_between_flushes(shape, active):
    n, p, g, widths, mis, segments = _unpack(shape)
    geo = _plan(n, p, g, widths, mis, active, segments)
    cl, step, seg, _ = _walk(geo)
    # the kernels flush at a step whose segment differs from the step
    # before, and every epoch_iters steps: between two flushes a table
    # sees one segment, and at most epoch_iters steps
    new_seg = np.r_[False, (seg[1:] != seg[:-1]) & (cl[1:] == cl[:-1])]
    flush = (step > 0) & (new_seg | (step % geo.epoch_iters == 0))
    epoch = np.cumsum(flush | (step == 0))
    for e in np.unique(epoch)[:2000]:
        at = epoch == e
        assert np.unique(seg[at]).size == 1 and at.sum() <= geo.epoch_iters
    # a contiguous range touches at most one segment more than it spans
    for q in range(geo.clusters):
        at = cl == q
        if at.any():
            touched = np.unique(seg[at]).size
            assert touched <= 1 + -(-at.sum() // max(1, geo.seg_units))


@pytest.mark.parametrize("shape,active", CASES)
def test_one_pass_whenever_the_table_fits_the_cluster(shape, active):
    n, p, g, widths, mis, segments = _unpack(shape)
    geo = _plan(n, p, g, widths, mis, active, segments)
    least = (geometry.BARRIER_BYTES
             + geometry._align(4 * p * -(-g // geometry.MAX_CLUSTER))
             + min(geometry.STAGES) * geo.stage_bytes)
    if least <= geometry.SMEM_MAX:
        assert geo.mode in ("private", "split", "shared")
    # no plane chunks: every CTA adds every plane of the rows it reads
    assert geo.planes == p
    if geo.mode == "private":
        assert geo.table_planes == p and geo.table_groups == g
    elif geo.mode == "split":
        assert geo.table_groups == g and geo.table_planes * geo.cluster >= p
    elif geo.mode == "shared":
        assert geo.table_planes == p and geo.table_groups * geo.cluster >= g


def test_main_path_plans():
    q2 = _plan(*SHAPES["q2_plan"])
    q9 = _plan(*SHAPES["q9_plan"])
    flagship = _plan(*SHAPES["flagship"])
    # the q9 plan's 224 KB table is split over a pair of CTAs by plane,
    # each with 4 planes of every group: each tile is read once and
    # multicast to both
    assert q9.mode == "split" and q9.cluster == 2 and q9.table_planes == 4
    assert q9.table_groups == 7001 and q9.stages == 3
    assert q2.mode == flagship.mode == "private"
    for geo in (q2, q9, flagship):
        assert geo.full_rows == N_MAIN and geo.stages >= 2
        assert geo.ctas <= geometry.H100_SMS
        # every thread has rows in every tile of q2 and the flagship; half
        # of them in q9's smaller tiles
        assert geo.tile_rows * (2 if geo is q9 else 1) >= (
            geometry.ROWS_PER_STEP * geometry.THREADS)
        # 32 KB or more of loads in flight per cluster of CTAs reading them
        assert (geo.stages - 1) * geo.stage_bytes >= 32 * 1024
    assert q2.tile_rows == 4096 and q9.tile_rows == 2048


def test_unaligned_planes_copy_from_the_aligned_address_below():
    n = (1 << 20) + 7
    geo = _plan(n, 2, 100, limb_widths(2), stacked_mis(n, 2))
    assert geo.mis == (0, 0, 7)
    assert geo.copy_bytes == (4 * geo.tile_rows, geo.tile_rows,
                              geo.tile_rows + 16)


def test_small_groups_sum_within_the_warp():
    assert _plan(N_MAIN, 24, 128, limb_widths(24), None).warp_agg
    assert not _plan(N_MAIN, 4, 1001, limb_widths(4), None).warp_agg


def test_unschedulable_cluster_raises():
    with pytest.raises(RuntimeError, match="scheduled"):
        geometry.plan(N_MAIN, 8, 7001, Q9_WIDTHS,
                      active_clusters=lambda c, smem: 0)
    # the q9 plan's table needs a cluster: lone CTAs cannot hold it
    with pytest.raises(RuntimeError, match="scheduled"):
        geometry.plan(N_MAIN, 8, 7001, Q9_WIDTHS,
                      active_clusters=ONE_CLUSTER["one_cta"])


def test_a_cluster_that_cannot_run_gives_way_to_a_larger_one():
    geo = geometry.plan(N_MAIN, 8, 7001, Q9_WIDTHS,
                        active_clusters=lambda c, smem: 4 if c == 4 else 0)
    assert geo.mode == "split" and geo.cluster == 4 and geo.clusters == 4
    assert geo.table_planes == 2


def test_one_cta_flushes_its_table_before_int32_overflow():
    n = SHAPES["saturation"][0]
    geo = _plan(*SHAPES["saturation"], ONE_CLUSTER["one_cta"])
    assert geo.mode == "private" and geo.ctas == 1
    # 2^25 rows of one CTA: the table is flushed at least once mid-run
    assert geo.iters > geo.epoch_iters
    assert n * 127 >= 1 << 31 > geo.rows_per_flush() * 127


@pytest.mark.parametrize("widths,mis", [((3,), None), ((4,), (2,)),
                                        ((1,) * 49, None)])
def test_bad_slot_planes_raise(widths, mis):
    with pytest.raises(ValueError):
        geometry.plan(1000, 1, 10, widths, mis)
