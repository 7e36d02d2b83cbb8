"""The port's CUDA kernels on the card, each against its plain PyTorch version.

Every test here carries the `gpu` marker and needs an NVIDIA H100 (compute
capability 9.0): the kernels (pinot_tpu_torch/csrc/*.cu) are built by nvcc
at first use and have no CPU mode. Whether a card is present is decided
inside the `cuda` fixture, so every test collects alike everywhere; on a
machine without one they skip. Run them on the card with

    python -m pytest -m gpu tests/test_torch_*.py

Sums are int64 and must be element-equal to the plain versions. Kernel A
with its family axis is one launch per family, equal to the plain version
of the flattened family; a 16-segment query batched on the card equals the
same query with SET segmentBatch = false, and sparse GROUP BYs (torch ops
on the card, the device combine) equal the CPU's, as do selections, pruned
queries, multi-value filters, GROUP BYs and aggregations (kernel A over
the expanded (doc, value) pairs), the histogram bins of edge values, and
star-tree queries (kernel A over the pre-aggregated views) and
index-backed predicates (JSON_MATCH, TEXT_MATCH, mapValue over a map
index, VECTOR_SIMILARITY: mask planes on the card). The multi-stage join
pipeline's device stages (partition planes, the fused join+aggregate, the
chain gather, the pair join) on the card equal the same torch ops on the
CPU element for element at about 2^20 skewed keys, and a q8-shaped
statement on the card equals the CPU executor's rows. A coalesced group
of eight queries is one launch of kernel A with rows equal to the CPU's,
kernel A at a group's S*Q = 32 and 64 members equals its plain version, a
traced family times the card (deviceExecMs > 0), and eight threads on a
fresh executor upload each plane once. A cluster of two servers on the
card (cluster/) answers q2 and q2_family with a CPU cluster's rows,
launching kernel B on each segment and kernel A on each server's family;
PTDP blocks packed on the card equal the CPU's bytes; the cluster
multi-stage engine on two servers on the card runs its join workers' pair
join on the card, packs its exchange blocks from card tensors and launches
kernels A and B through its leaves, with the CPU cluster's rows; a
realtime manager consuming a 2-partition stream feeds the card (kernel A
over its committed family, kernel B over each consuming snapshot, rows
equal to the CPU's) and a commit leaves no plane of the sealed segments on
the card; the doctor (tools/doctor.py) classifies the card `ok`; and a
family of compressed segments under an evolved schema runs kernels A and
B on its decompressed planes and virtual columns with the CPU's rows. With
head sampling on, a 2-server card cluster retains q2_family with both
servers' spans and the compile registry counts one dispatch per launch of
kernel A; the AOT prewarm of a card executor's persisted families launches
kernels A and B once each, element-equal to their plain versions. A
tiered card server (storage/tier.py) warms a cold segment and launches
kernel A once over the family with the CPU's rows; a demoted segment's
planes leave the card and upload fresh when it is fetched again; and
queries racing a thread that keeps demoting and fetching the segments
again launch kernel A exactly. Operations on the card: a rebalance moves
a segment onto a third card server, whose launch of kernel A over it is
element-equal to its plain version, with a CPU cluster's rows, and the
source's device cache lets the moved planes go; a lineage swap to a
renamed copy of a segment counts its rows once, before and after the
swap, and the replaced segment's planes leave its server's cache. The
offline data path: a batch job's segments (gzipped CSV, JSON, Avro and
Thrift inputs), tar-pushed through file:// and through an in-memory s3://
store, load on two card servers, which launch kernel B a segment and
kernel A over each server's family of 2, every launch equal to its plain
version, with a CPU cluster's rows. The soak's sql suite
(tools/soak.py) passes with its device parity on the card, every launch
it made equal to its plain version. The mesh on one card (`cuda:0` four
times): q2's plan row-sharded over 4 shards launches kernel B at each
nonzero row offset, every launch equal to its plain version and the
merged table equal to the solo run; a family split over dp = 4 launches
kernel A once a shard, each equal to its plain version, and its packed
buffer equals the solo family's byte for byte.
"""

from __future__ import annotations

import gc
import importlib.util
import os
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from pinot_tpu_torch.engine.query_executor import QueryExecutor
from pinot_tpu_torch.ops import _cuda, fused_groupby, geometry, mxu_groupby
from pinot_tpu_torch.segment.builder import SegmentBuilder
from pinot_tpu_torch.segment.loader import load_segment
from pinot_tpu_torch.spi.data_types import Schema
from pinot_tpu_torch.spi.table_config import IndexingConfig, TableConfig

pytestmark = pytest.mark.gpu


@pytest.fixture(autouse=True)
def _caches_off(monkeypatch):
    # the segment partial cache is process-wide: a CUDA and a CPU executor
    # over one segment would share partials, and a repeat would dispatch
    # nothing; these tests compare devices and count dispatches
    # (the cache tests below turn both caches on for themselves)
    monkeypatch.setenv("PINOT_TPU_SEGMENT_CACHE", "0")
    monkeypatch.setenv("PINOT_TPU_RESULT_CACHE", "0")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA H100: torch.cuda.is_available() is false")
    if torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs compute capability 9.0 (the kernels target sm_90a)")
    return torch.device("cuda")


def _limb_inputs(n, p, g, seed, device):
    rng = np.random.default_rng(seed)
    gid = rng.integers(0, max(1, g - 1), n).astype(np.int32)
    planes = rng.integers(0, 128, (p, n)).astype(np.int8)
    masked = rng.random(n) < 0.8
    gid[masked] = g - 1
    planes[:, masked] = 0
    return (torch.from_numpy(planes).to(device),
            torch.from_numpy(gid).to(device))


# the main path's shapes; a table private to each CTA (q2, G = 1001 with
# 24 planes, G = 32768 with one plane), one split across a cluster (8 planes
# of 7001 groups) and none (16 planes of 32768 groups: global atomics);
# few groups summed within the warp; lengths that are no multiple of 16 (the
# stacked planes then start off 16 bytes), below one tile, exactly one
# tile, and empty
ONE_TILE = geometry.tile_rows_for((4, 1, 1))


@pytest.mark.parametrize("n,p,g", [
    (1 << 20, 4, 7001), (1 << 20, 8, 7001), ((1 << 20) + 7, 1, 32768),
    (1 << 20, 24, 1001), (1 << 18, 16, 32768),
    (300_001, 24, 128), (100_003, 3, 1), (5, 2, 10), (ONE_TILE, 2, 10),
    (ONE_TILE + 3, 2, 10), (0, 2, 10)])
def test_limb_sums_kernel_matches_plain(cuda, n, p, g):
    planes, gid = _limb_inputs(n, p, g, n + p + g, cuda)
    before = _cuda.LAUNCHES["limb_sums"]
    got = mxu_groupby.limb_sums(planes, gid, g)
    torch.cuda.synchronize()
    assert got.device.type == "cuda"
    assert _cuda.LAUNCHES["limb_sums"] == before + (1 if n else 0)
    assert torch.equal(got, mxu_groupby.limb_sums_plain(planes, gid, g))


def _only(cluster=None, count=1, name="limb_sums"):
    """An occupancy that lets `count` clusters run, of size `cluster` only
    when one is named."""
    def active(c, smem):
        if cluster is not None and c != cluster:
            return 0
        return min(count, _cuda.max_active_clusters(name, c, smem))
    return active


# a table split across the cluster, by plane (each tile multicast to every
# CTA of the cluster) at every cluster size and by group, and one lone
# cluster taking every row
@pytest.mark.parametrize("p,g,cluster,count,mode", [
    (8, 7001, 2, 66, "split"), (8, 16384, 4, 33, "split"),
    (8, 32768, 8, 16, "split"), (3, 32768, 4, 33, "shared"),
    (5, 32768, 8, 16, "shared"), (8, 7001, None, 1, "split")])
def test_limb_sums_shared_table_at_every_cluster_size(cuda, p, g, cluster,
                                                      count, mode):
    n = (1 << 20) + 7
    planes, gid = _limb_inputs(n, p, g, 5, cuda)
    geo = geometry.plan(n, p, g, *mxu_groupby.slot_layout(planes, gid),
                        active_clusters=_only(cluster, count))
    assert geo.mode == mode
    got = mxu_groupby.launch(planes, gid, g, geo)
    assert torch.equal(got, mxu_groupby.limb_sums_plain(planes, gid, g))


# 2^25 + 5 rows of 127 on one group: the sum exceeds 2^31, so a table that
# is not flushed in time wraps. The default geometry, one lone CTA (its
# private table takes every row) and one cluster sharing one table.
@pytest.mark.parametrize("p,g,active", [
    (1, 1, None), (1, 1, "one_cta"), (8, 7001, "one_cluster")])
def test_limb_sums_int32_saturation(cuda, p, g, active):
    n = (1 << 25) + 5
    planes = torch.full((p, n), 127, dtype=torch.int8, device=cuda)
    gid = torch.zeros(n, dtype=torch.int32, device=cuda)
    if active is None:
        got = mxu_groupby.limb_sums(planes, gid, g)
    else:
        occupancy = _only(1) if active == "one_cta" else _only()
        geo = geometry.plan(n, p, g, *mxu_groupby.slot_layout(planes, gid),
                            active_clusters=occupancy)
        assert geo.iters > geo.epoch_iters  # the table is flushed mid-run
        got = mxu_groupby.launch(planes, gid, g, geo)
    want = torch.zeros((p, g), dtype=torch.int64, device=cuda)
    want[:, 0] = 127 * n
    assert torch.equal(got, want)


def _family_inputs(segments, n, p, g, seed, device, live=None):
    """S members' inputs; member s keeps live[s] rows (the rest carry the
    trash gid and zero payloads, as a member's pad rows do)."""
    planes, gid = _limb_inputs(segments * n, p, g, seed, device)
    planes = planes.view(p, segments, n).transpose(0, 1).contiguous()
    gid = gid.view(segments, n).contiguous()
    for s, rows in enumerate(live or ()):
        gid[s, rows:] = g - 1
        planes[s, :, rows:] = 0
    return planes, gid


# S = 1; the q2 and q4 shapes; 16 members of a ragged n (padded to 16
# bytes) with ragged live rows; a member with no live row; a table split
# by plane, by group and none (global atomics); tiles of one segment
# spread over many CTAs, and clusters whose ranges cross segments
@pytest.mark.parametrize("segments,n,p,g,live", [
    (1, 1 << 20, 4, 7001, None),
    (4, 1 << 20, 4, 7001, None),
    (16, 1 << 18, 4, 7001, None),
    (16, (1 << 18) + 5, 2, 1001, [(1 << 18) + 5 - 4099 * s for s in range(16)]),
    (3, 100_000, 3, 700, [100_000, 0, 5]),
    (4, 1 << 19, 8, 7001, None),
    (3, 1 << 18, 16, 32768, None),
    (5, 3000, 24, 128, None),
])
def test_family_limb_sums_kernel_matches_plain(cuda, segments, n, p, g, live):
    planes, gid = _family_inputs(segments, n, p, g, segments + n, cuda, live)
    before = _cuda.LAUNCHES["limb_sums"]
    got = mxu_groupby.limb_sums(planes, gid, g)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["limb_sums"] == before + 1  # one per family
    assert got.shape == (segments, p, g)
    assert torch.equal(got, mxu_groupby.limb_sums_plain(planes, gid, g))


# the count passes of the matrix-shaped aggregations: one plane over
# groups x width + 1 slots (aggmix's value histogram, q5's occupancy, aggmix's
# occupancy, q5's adaptive histogram), solo and with the family axis
@pytest.mark.parametrize("segments", [1, 4])
@pytest.mark.parametrize("g", [78, 5841, 7001, 32121])
def test_limb_sums_one_plane_matches_plain(cuda, segments, g):
    n = 1 << 20
    planes, gid = _family_inputs(segments, n, 1, g, g + segments, cuda)
    if segments == 1:
        planes, gid = planes[0], gid[0]
    before = _cuda.LAUNCHES["limb_sums"]
    got = mxu_groupby.limb_sums(planes, gid, g)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["limb_sums"] == before + 1
    assert torch.equal(got, mxu_groupby.limb_sums_plain(planes, gid, g))


@pytest.mark.parametrize("p,g,cluster,count,mode", [
    (8, 7001, 2, 66, "split"), (3, 32768, 4, 33, "shared"),
    (4, 7001, None, 1, "private"), (4, 1001, 1, 132, "private")])
def test_family_limb_sums_at_forced_geometry(cuda, p, g, cluster, count,
                                             mode):
    segments, n = 6, (1 << 18) + 16 * 7
    planes, gid = _family_inputs(segments, n, p, g, 9, cuda)
    geo = geometry.plan(n, p, g, *mxu_groupby.slot_layout(planes, gid),
                        segments=segments,
                        active_clusters=_only(cluster, count))
    assert geo.mode == mode
    got = mxu_groupby.launch(planes, gid, g, geo)
    assert torch.equal(got, mxu_groupby.limb_sums_plain(planes, gid, g))


def test_limb_sums_kernel_rejects_bad_inputs(cuda):
    planes, gid = _limb_inputs(100, 2, 10, 1, cuda)
    with pytest.raises(TypeError):
        mxu_groupby.limb_sums(planes.to(torch.int32), gid, 10)
    with pytest.raises(ValueError):
        mxu_groupby.limb_sums(planes, gid.cpu(), 10)


def _fused_cases(device):
    n = (1 << 20) + 3
    rng = np.random.default_rng(9)

    def plane(lo, hi, dtype):
        return torch.from_numpy(rng.integers(lo, hi, n).astype(dtype)).to(device)

    u16, u8 = plane(0, 2000, np.uint16), plane(0, 100, np.uint8)
    pos = plane(0, 1 << 20, np.int32)
    signed = plane(-(1 << 30), 1 << 30, np.int32)
    region, year = plane(0, 5, np.uint8), plane(0, 7, np.uint8)
    brand = plane(0, 1000, np.uint16)
    price, qty = plane(1, 55_001, np.int32), plane(1, 51, np.int32)

    def sc(*v):
        return torch.tensor(v, dtype=torch.int32, device=device)

    def limbs(slot, bits):
        return tuple(("limb", slot, s) for s in range(0, bits, 7))

    FP = fused_groupby.FusedPlan
    return {
        "interval": (FP((("iv", 0, 0, 1, True, True),), ((1, 1),),
                        (("count",),) + limbs(2, 20), (), (0, 1, 2)),
                     (u16, u8, pos), sc(n - 5, 0, 500, 1500), 101, n),
        "runs": (FP((("runs", 1, 0, 3),), ((0, 1),),
                    (("count",),) + limbs(2, 20), (), (1, 0, 2)),
                 (u8, u16, pos), sc(n, 0, 2, 5, 9, 9, 20, 40), 2001, n),
        "signed_sum": (FP((), ((0, 1),),
                          (("count",),) + limbs(1, 32) + (("neg", 1),),
                          (), (0, 1)),
                       (u16, signed), sc(n, 0), 2001, n),
        # 32768 groups of one plane: a 128 KB table private to each CTA
        "two_dims_32768": (FP((("iv", 1, 0, 1, True, True),),
                              ((0, 16), (1, 1)), (("count",),), (), (0, 1)),
                           (u16, u8), sc(n, 0, 0, 15), 32768, n),
        # the q9 plan's shape: 8 planes of 7001 groups, a table split across
        # the cluster by plane
        "shared_table": (FP((("iv", 0, 0, 1, True, True),),
                            ((1, 1000), (2, 1)),
                            (("count",),) + limbs(3, 20) + limbs(4, 16)
                            + limbs(5, 7), (), (0, 1, 2, 3, 4, 5)),
                         (region, year, brand, pos, price, qty),
                         sc(n - 9, 0, 1, 1), 7001, n),
    }


@pytest.mark.parametrize("case", ["interval", "runs", "signed_sum",
                                  "two_dims_32768", "shared_table"])
def test_fused_kernel_matches_plain(cuda, case):
    fp, planes_in, scalars, g, n = _fused_cases(cuda)[case]
    assert mxu_groupby.supports(g, len(fp.planes))
    before = _cuda.LAUNCHES["fused_limb_sums"]
    got = fused_groupby.fused_limb_sums(fp, planes_in, scalars, g, n)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["fused_limb_sums"] == before + 1
    assert torch.equal(
        got, fused_groupby.fused_limb_sums_plain(fp, planes_in, scalars, g, n))


@pytest.mark.parametrize("n", [0, 1000, ONE_TILE, (1 << 20) + 3])
def test_fused_kernel_small_and_ragged_lengths(cuda, n):
    rng = np.random.default_rng(n)
    u8 = torch.from_numpy(rng.integers(0, 100, n).astype(np.uint8)).to(cuda)
    pos = torch.from_numpy(rng.integers(0, 1 << 20, n).astype(np.int32)).to(cuda)
    fp = fused_groupby.FusedPlan((("iv", 0, 0, 1, True, True),), ((0, 1),),
                                 (("count",), ("limb", 1, 0), ("limb", 1, 7)),
                                 (), (0, 1))
    scalars = torch.tensor([max(0, n - 2), 0, 10, 80], dtype=torch.int32,
                           device=cuda)
    got = fused_groupby.fused_limb_sums(fp, (u8, pos), scalars, 101, n)
    assert torch.equal(got, fused_groupby.fused_limb_sums_plain(
        fp, (u8, pos), scalars, 101, n))


# 2^25 + 5 rows that pass, all on group 0, with a limb of 127: the default
# geometry and one lone CTA, whose table must be flushed mid-run
@pytest.mark.parametrize("one_cta", [False, True])
def test_fused_kernel_int32_saturation(cuda, one_cta):
    n = (1 << 25) + 5
    u8 = torch.zeros(n, dtype=torch.uint8, device=cuda)
    val = torch.full((n,), 127, dtype=torch.int32, device=cuda)
    fp = fused_groupby.FusedPlan((), ((0, 1),), (("count",), ("limb", 1, 0)),
                                 (), (0, 1))
    scalars = torch.tensor([n, 0], dtype=torch.int32, device=cuda)
    if one_cta:
        geo = geometry.plan(n, 2, 1, *fused_groupby.slot_layout((u8, val)),
                            active_clusters=_only(1, name="fused_limb_sums"))
        assert geo.iters > geo.epoch_iters
        got = fused_groupby.launch(fp, (u8, val), scalars, 1, geo)
    else:
        got = fused_groupby.fused_limb_sums(fp, (u8, val), scalars, 1, n)
    assert got.tolist() == [[n], [127 * n]]


@pytest.fixture(scope="module")
def small_table(tmp_path_factory):
    rng = np.random.default_rng(23)
    n = 50_000
    cols = {
        "d_year": rng.integers(1992, 1999, n).astype(np.int32),
        "p_brand": rng.integers(0, 1000, n).astype(np.int32),
        "s_region": np.asarray(["AMERICA", "ASIA", "EUROPE", "AFRICA",
                                "MIDDLE EAST"], dtype=object)[
            rng.integers(0, 5, n)],
        "lo_revenue": rng.integers(1, 600_000, n).astype(np.int32),
    }
    schema = Schema.build("ssb", dimensions=[
        ("d_year", "INT"), ("p_brand", "INT"), ("s_region", "STRING")],
        metrics=[("lo_revenue", "INT")])
    cfg = TableConfig(table_name="ssb", indexing=IndexingConfig(
        no_dictionary_columns=["lo_revenue"]))
    segs = []
    for i in range(2):
        path = tmp_path_factory.mktemp("torch_cuda") / f"s{i}"
        SegmentBuilder(schema, cfg, f"s{i}").build(
            {k: v[i * n // 2:(i + 1) * n // 2] for k, v in cols.items()}, path)
        segs.append(load_segment(path))
    return schema, segs


# (sql, kernel, launches): a family (the default) is one launch of kernel
# A; a lone segment, one of kernel B where its plan is in scope
@pytest.mark.parametrize("sql,kernel,launches", [
    ("SET segmentBatch = false; SELECT d_year, p_brand, SUM(lo_revenue) "
     "FROM ssb WHERE s_region = 'ASIA' GROUP BY d_year, p_brand LIMIT 10000",
     "fused_limb_sums", 2),
    ("SET useFusedKernel = false; SELECT d_year, p_brand, SUM(lo_revenue) "
     "FROM ssb WHERE s_region = 'ASIA' GROUP BY d_year, p_brand LIMIT 10000",
     "limb_sums", 1),
    ("SELECT p_brand, SUM(lo_revenue), COUNT(*), MIN(lo_revenue), "
     "MAX(lo_revenue) FROM ssb WHERE d_year >= 1995 GROUP BY p_brand "
     "LIMIT 1000", "limb_sums", 1),
    ("SELECT d_year, p_brand, SUM(lo_revenue) FROM ssb WHERE "
     "s_region = 'ASIA' GROUP BY d_year, p_brand LIMIT 10000",
     "limb_sums", 1),
])
def test_query_on_the_card_matches_cpu(cuda, small_table, sql, kernel,
                                       launches):
    schema, segs = small_table
    gpu, cpu = QueryExecutor(device="cuda"), QueryExecutor(device="cpu")
    for qe in (gpu, cpu):
        qe.add_table(schema, segs)
    before = _cuda.LAUNCHES[kernel]
    got = gpu.execute_sql(sql)
    assert _cuda.LAUNCHES[kernel] == before + launches
    want = cpu.execute_sql(sql)
    assert sorted(map(tuple, got.result_table.rows)) == \
        sorted(map(tuple, want.result_table.rows))


@pytest.fixture(scope="module")
def table16(tmp_path_factory):
    """16 segments of 20,000 rows, lo_orderkey sorted in ingestion order."""
    rng = np.random.default_rng(29)
    n, segments = 20_000, 16
    cols = {
        "d_year": rng.integers(1992, 1999, n * segments).astype(np.int32),
        "p_brand": rng.integers(0, 1000, n * segments).astype(np.int32),
        "lo_orderkey": np.sort(rng.integers(0, 1 << 20, n * segments))
        .astype(np.int32),
        "lo_revenue": rng.integers(1, 600_000, n * segments).astype(np.int32),
    }
    schema = Schema.build("ssb16", dimensions=[
        ("d_year", "INT"), ("p_brand", "INT"), ("lo_orderkey", "INT")],
        metrics=[("lo_revenue", "INT")])
    cfg = TableConfig(table_name="ssb16", indexing=IndexingConfig(
        no_dictionary_columns=["lo_revenue"]))
    segs = []
    for i in range(segments):
        path = tmp_path_factory.mktemp("torch_cuda16") / f"s{i}"
        SegmentBuilder(schema, cfg, f"s{i}").build(
            {k: v[i * n:(i + 1) * n] for k, v in cols.items()}, path)
        segs.append(load_segment(path))
    return schema, segs


@pytest.mark.parametrize("sql", [
    "SELECT d_year, p_brand, SUM(lo_revenue), COUNT(*) FROM ssb16 "
    "WHERE d_year > 1993 GROUP BY d_year, p_brand LIMIT 10000",
    "SELECT p_brand, MIN(lo_revenue), MAX(lo_revenue), SUM(lo_revenue) "
    "FROM ssb16 GROUP BY p_brand LIMIT 1000",
    "SELECT COUNT(*), SUM(lo_revenue), MAX(lo_revenue) FROM ssb16 "
    "WHERE p_brand < 500",
])
def test_16_segment_family_equals_unbatched(cuda, table16, sql):
    schema, segs = table16
    qe = QueryExecutor(device="cuda")
    qe.add_table(schema, segs)
    before = dict(_cuda.LAUNCHES)
    batched = qe.execute_sql(sql)
    grouped = "GROUP BY" in sql
    assert batched.num_device_dispatches == 1
    assert _cuda.LAUNCHES["limb_sums"] - before["limb_sums"] == int(grouped)
    solo = qe.execute_sql("SET segmentBatch = false; " + sql)
    assert solo.num_device_dispatches == len(segs)
    assert batched.result_table.rows == solo.result_table.rows


@pytest.mark.parametrize("sql", [
    # presorted keys, the exact trim, the device combine
    "SET sparseGroupBy = true; SELECT lo_orderkey, SUM(lo_revenue), "
    "COUNT(*) FROM ssb16 GROUP BY lo_orderkey ORDER BY lo_orderkey "
    "LIMIT 5000",
    # the sort path with two keys (the host merge)
    "SELECT d_year, lo_orderkey, SUM(lo_revenue), COUNT(*), "
    "MIN(lo_revenue), MAX(lo_revenue) FROM ssb16 GROUP BY d_year, "
    "lo_orderkey ORDER BY d_year, lo_orderkey LIMIT 3000",
    # one family of 16 through the sort path and the device combine
    "SET sparseGroupBy = true; SELECT p_brand, SUM(lo_revenue), COUNT(*), "
    "MIN(lo_revenue), MAX(lo_revenue) FROM ssb16 GROUP BY p_brand "
    "ORDER BY p_brand LIMIT 1000",
    "SET sparseGroupBy = true; SET numGroupsLimit = 300; SELECT p_brand, "
    "COUNT(*), SUM(lo_revenue) FROM ssb16 GROUP BY p_brand",
])
def test_sparse_query_on_the_card_matches_cpu(cuda, table16, sql):
    schema, segs = table16
    gpu, cpu = QueryExecutor(device="cuda"), QueryExecutor(device="cpu")
    for qe in (gpu, cpu):
        qe.add_table(schema, segs)
    got, want = gpu.execute_sql(sql), cpu.execute_sql(sql)
    assert got.result_table.rows == want.result_table.rows
    assert got.num_docs_scanned == want.num_docs_scanned
    assert got.num_device_dispatches == want.num_device_dispatches
    assert got.num_groups_limit_reached == want.num_groups_limit_reached


@pytest.fixture(scope="module")
def agg_table(tmp_path_factory):
    """Two segments of 40,000 rows for the matrix-shaped aggregations:
    lo_orderkey sorted in ingestion order, fare a raw DOUBLE."""
    rng = np.random.default_rng(31)
    n, segments = 40_000, 2
    cols = {
        "d_year": rng.integers(1992, 1999, n * segments).astype(np.int32),
        "p_brand": rng.integers(0, 1000, n * segments).astype(np.int32),
        "lo_discount": rng.integers(0, 11, n * segments).astype(np.int32),
        "lo_orderkey": np.sort(rng.integers(0, 1 << 16, n * segments))
        .astype(np.int32),
        "lo_revenue": rng.integers(1, 600_000, n * segments).astype(np.int32),
        "fare": np.round(rng.gamma(3.0, 9.0, n * segments), 2),
    }
    schema = Schema.build("aggs", dimensions=[
        ("d_year", "INT"), ("p_brand", "INT"), ("lo_discount", "INT"),
        ("lo_orderkey", "INT")], metrics=[("lo_revenue", "INT"),
                                          ("fare", "DOUBLE")])
    cfg = TableConfig(table_name="aggs", indexing=IndexingConfig(
        no_dictionary_columns=["lo_revenue", "fare"]))
    segs = []
    for i in range(segments):
        path = tmp_path_factory.mktemp("torch_cuda_aggs") / f"s{i}"
        SegmentBuilder(schema, cfg, f"s{i}").build(
            {k: v[i * n:(i + 1) * n] for k, v in cols.items()}, path)
        segs.append(load_segment(path))
    return schema, segs


# one plan of each matrix kind, and the sparse DISTINCT on the presorted
# and the sort path: (sql, mode)
MATRIX_PLANS = [
    ("SELECT d_year, DISTINCTCOUNT(p_brand), PERCENTILE(lo_discount, 90) "
     "FROM aggs WHERE lo_revenue > 1000 GROUP BY d_year", "group_by"),
    ("SELECT d_year, PERCENTILETDIGEST(fare, 95), PERCENTILEEST(lo_revenue, 5), "
     "HISTOGRAM(fare, 0, 100, 20) FROM aggs GROUP BY d_year", "group_by"),
    ("SELECT DISTINCTCOUNT(lo_discount), PERCENTILETDIGEST(fare, 50), "
     "HISTOGRAM(lo_revenue, 0, 600000, 9) FROM aggs", "aggregation"),
    ("SET sparseGroupBy = true; SET numGroupsLimit = 5000; SELECT "
     "lo_orderkey, DISTINCTCOUNT(lo_discount), SUM(lo_revenue) FROM aggs "
     "GROUP BY lo_orderkey ORDER BY lo_orderkey LIMIT 5000", "presorted"),
    ("SET sparseGroupBy = true; SELECT d_year, lo_orderkey, "
     "DISTINCTCOUNT(lo_discount) FROM aggs GROUP BY d_year, lo_orderkey",
     "sort"),
]


@pytest.mark.parametrize("sql,mode", MATRIX_PLANS)
def test_matrix_run_program_on_the_card_matches_cpu(cuda, agg_table, sql,
                                                    mode):
    from pinot_tpu_torch.engine.plan import SegmentPlanner
    from pinot_tpu_torch.ops.kernels import run_program
    from pinot_tpu_torch.query.parser.sql import parse_sql
    from pinot_tpu_torch.segment.device_cache import SegmentDeviceView

    _, segs = agg_table
    plan = SegmentPlanner(parse_sql(sql), segs[0]).plan()
    program = plan.program
    assert program.mode == ("group_by_sparse" if mode in ("presorted", "sort")
                            else mode)
    assert program.keys_presorted == (mode == "presorted")
    outs = {}
    for dev in ("cpu", "cuda"):
        view = SegmentDeviceView(segs[0], dev)
        arrays, packed = plan.gather_arrays_packed(view)
        params = tuple(torch.from_numpy(np.array(p)).to(dev)
                       for p in plan.params)
        outs[dev] = run_program(program, arrays, params, segs[0].num_docs,
                                view.padded, packed=packed, device=dev)
    torch.cuda.synchronize()
    for got, want in zip(outs["cuda"], outs["cpu"]):
        got = got.cpu()
        assert got.dtype == want.dtype and got.shape == want.shape
        if got.is_floating_point():  # float64 sums: another order of adds
            torch.testing.assert_close(got, want, rtol=1e-12, atol=0)
        else:
            assert torch.equal(got, want)


def test_aggmix_on_the_card_matches_cpu(cuda, agg_table):
    """The slice's device kinds in one family query: kernel A launches
    for the sums and for every count pass."""
    schema, segs = agg_table
    sql = ("SELECT d_year, DISTINCTCOUNT(p_brand), DISTINCTCOUNTHLL(p_brand), "
           "PERCENTILE(lo_discount, 90), MODE(lo_discount), "
           "HISTOGRAM(lo_revenue, 0, 600000, 10), "
           "PERCENTILETDIGEST(fare, 95), STDDEVPOP(lo_revenue), "
           "CORR(lo_discount, fare) FROM aggs GROUP BY d_year LIMIT 100")
    gpu, cpu = QueryExecutor(device="cuda"), QueryExecutor(device="cpu")
    for qe in (gpu, cpu):
        qe.add_table(schema, segs)
    before = _cuda.LAUNCHES["limb_sums"]
    got = gpu.execute_sql(sql)
    # the sum planes, the occupancy, the value histogram, two adaptive
    # passes: one launch each for the family
    assert _cuda.LAUNCHES["limb_sums"] - before == 5
    assert got.num_device_dispatches == 1
    want = cpu.execute_sql(sql)
    rows_g = sorted(map(tuple, got.result_table.rows))
    rows_w = sorted(map(tuple, want.result_table.rows))
    assert len(rows_g) == len(rows_w) == 7
    for rg, rw in zip(rows_g, rows_w):
        assert rg[:-2] == rw[:-2]
        # the moment sums of floats add in another order on the card:
        # STDDEVPOP to rtol 1e-12; CORR, near 0 here, finalizes by a
        # difference of nearly equal terms, so its rounding is held
        # absolutely, to 1e-12 of its [-1, 1] range
        np.testing.assert_allclose(rg[-2], rw[-2], rtol=1e-12)
        assert abs(rg[-1] - rw[-1]) <= 1e-12


# -- selection, pruning and multi-value columns on the card ---------------------

@pytest.fixture(scope="module")
def mv_table(tmp_path_factory):
    """Three segments of 30,000 rows with a tags-like INT multi-value
    column (1 to 4 values a row of 1000)."""
    from pinot_tpu_torch.segment.builder import MultiValues

    rng = np.random.default_rng(37)
    n, segments = 30_000, 3
    schema = Schema.build("mvt", dimensions=[
        ("d_year", "INT"), ("s_region", "STRING"), ("lo_orderkey", "INT"),
        ("lo_tags", "INT", False)], metrics=[("lo_revenue", "INT")])
    cfg = TableConfig(table_name="mvt", indexing=IndexingConfig(
        no_dictionary_columns=["lo_revenue"]))
    segs = []
    for i in range(segments):
        lens = rng.integers(1, 5, n)
        cols = {
            "d_year": rng.integers(1992, 1999, n).astype(np.int32),
            "s_region": np.asarray(["AMERICA", "ASIA", "EUROPE"],
                                   dtype=object)[rng.integers(0, 3, n)],
            "lo_orderkey": (100_000 * i + np.arange(n)).astype(np.int32),
            "lo_tags": MultiValues(
                rng.integers(0, 1000, int(lens.sum())).astype(np.int32), lens),
            "lo_revenue": rng.integers(1, 600_000, n).astype(np.int32),
        }
        path = tmp_path_factory.mktemp("torch_cuda_mv") / f"s{i}"
        SegmentBuilder(schema, cfg, f"s{i}").build(cols, path)
        segs.append(load_segment(path))
    return schema, segs


# (sql, launches of kernel A): the MV GROUP BY runs kernel A once over the
# family's (doc x value slot) pairs; the *MV aggregations' sums pass once
@pytest.mark.parametrize("sql,launches", [
    ("SELECT d_year, COUNT(*), SUM(lo_revenue) FROM mvt "
     "WHERE lo_tags IN (3, 17, 42) GROUP BY d_year", 1),
    ("SELECT lo_tags, COUNT(*), SUM(lo_revenue) FROM mvt "
     "WHERE s_region = 'ASIA' GROUP BY lo_tags LIMIT 2000", 1),
    ("SET segmentBatch = false; SELECT lo_tags, COUNT(*), SUM(lo_revenue) "
     "FROM mvt GROUP BY lo_tags LIMIT 2000", 3),
    ("SELECT d_year, COUNTMV(lo_tags), SUMMV(lo_tags), MINMV(lo_tags), "
     "MAXMV(lo_tags), AVGMV(lo_tags), MINMAXRANGEMV(lo_tags) FROM mvt "
     "GROUP BY d_year", 1),
    ("SET sparseGroupBy = true; SELECT lo_tags, COUNT(*), MAX(lo_revenue) "
     "FROM mvt GROUP BY lo_tags ORDER BY lo_tags LIMIT 100", 0),
    ("SELECT lo_orderkey, lo_revenue FROM mvt WHERE lo_tags = 7 "
     "ORDER BY lo_revenue DESC, lo_orderkey LIMIT 50", 0),
    ("SELECT lo_orderkey, d_year FROM mvt WHERE s_region = 'ASIA' "
     "LIMIT 100", 0),
    ("SELECT COUNT(*), HISTOGRAM(lo_revenue, 0, 1000000, 4) FROM mvt "
     "WHERE lo_orderkey < 0", 0),
    ("SELECT lo_orderkey FROM mvt WHERE lo_orderkey BETWEEN 100100 AND "
     "100200 LIMIT 500", 0),
])
def test_mv_and_selection_on_the_card_match_cpu(cuda, mv_table, sql,
                                                launches):
    schema, segs = mv_table
    gpu, cpu = QueryExecutor(device="cuda"), QueryExecutor(device="cpu")
    for qe in (gpu, cpu):
        qe.add_table(schema, segs)
    before = _cuda.LAUNCHES["limb_sums"]
    got = gpu.execute_sql(sql)
    assert _cuda.LAUNCHES["limb_sums"] - before == launches
    want = cpu.execute_sql(sql)
    if "ORDER BY" in sql or "GROUP BY" not in sql:
        assert got.result_table.rows == want.result_table.rows
    else:
        assert sorted(map(tuple, got.result_table.rows)) == \
            sorted(map(tuple, want.result_table.rows))
    assert got.num_docs_scanned == want.num_docs_scanned
    assert got.num_segments_pruned == want.num_segments_pruned
    assert got.num_device_dispatches == want.num_device_dispatches


def test_mv_group_expanded_rows_kernel_matches_plain(cuda, mv_table):
    """Kernel A on the MV GROUP BY's recorded family inputs ((S, P, n W)
    planes, G = card + 1) equals its plain version."""
    schema, segs = mv_table
    gpu = QueryExecutor(device="cuda")
    gpu.add_table(schema, segs)
    calls = []
    orig = mxu_groupby.limb_sums

    def record(*args):
        calls.append(args)
        return orig(*args)

    mxu_groupby.limb_sums = record
    try:
        gpu.execute_sql("SELECT lo_tags, COUNT(*), SUM(lo_revenue) FROM mvt "
                        "GROUP BY lo_tags LIMIT 2000")
    finally:
        mxu_groupby.limb_sums = orig
    ((planes, gid, g),) = calls
    assert planes.shape[0] == 3 and planes.shape[2] == 4 * 32768
    assert g == 1001
    assert torch.equal(mxu_groupby.limb_sums(planes, gid, g),
                       mxu_groupby.limb_sums_plain(planes, gid, g))


def test_selection_bitmap_on_the_card_matches_cpu(cuda, mv_table):
    from pinot_tpu_torch.engine.plan import SegmentPlanner
    from pinot_tpu_torch.ops.kernels import run_program
    from pinot_tpu_torch.query.parser.sql import parse_sql
    from pinot_tpu_torch.segment.device_cache import SegmentDeviceView

    _, segs = mv_table
    plan = SegmentPlanner(parse_sql(
        "SELECT lo_orderkey FROM mvt WHERE lo_tags IN (1, 2, 3) "
        "AND d_year > 1994 LIMIT 10"), segs[0]).plan()
    outs = {}
    for dev in ("cpu", "cuda"):
        view = SegmentDeviceView(segs[0], dev)
        arrays, packed = plan.gather_arrays_packed(view)
        params = tuple(torch.from_numpy(np.array(p)).to(dev)
                       for p in plan.params)
        (outs[dev],) = run_program(plan.program, arrays, params,
                                   segs[0].num_docs, view.padded,
                                   packed=packed, device=dev)
    assert outs["cuda"].dtype == torch.uint8
    assert torch.equal(outs["cuda"].cpu(), outs["cpu"])


@pytest.mark.parametrize("bins", [10, 7, 17])
def test_histogram_bins_on_the_card_match_cpu(cuda, bins):
    """HISTOGRAM and the adaptive percentile histogram bin every value,
    edges included, as the CPU run does (each op its own kernel: no FMA
    contraction of the width arithmetic)."""
    from pinot_tpu_torch.engine import ir
    from pinot_tpu_torch.ops.kernels import planes_from_numpy, run_program

    rng = np.random.default_rng(bins)
    n = 1 << 20
    x = rng.integers(0, 31, n) * 0.1
    gid = rng.integers(0, 500, n).astype(np.int32)
    span = 29.63817787 + 30.9284687
    v = (rng.integers(0, bins * bins * 4, n)
         * (span / (bins * bins * 4))).astype(np.float32)
    program = ir.Program(
        mode="group_by", filter=None, aggs=(
            ir.AggOp("hist_fixed", vexpr=ir.Col(0), bins=bins, lo_param=0,
                     hi_param=1),
            ir.AggOp("hist_adaptive", vexpr=ir.Col(2), bins=bins, lo_param=2,
                     hi_param=3, pct=95.0, prebased=True)),
        group_slots=(1,), group_strides=(1,), num_groups=500)
    params = (np.float64(0.0), np.float64(3.0), np.float64(-30.9284687),
              np.float64(29.63817787))
    outs = {}
    for dev in ("cpu", "cuda"):
        arrays, tparams = planes_from_numpy((x, gid, v), params, dev)
        outs[dev] = run_program(program, arrays, tparams, n, n, device=dev)
    for got, want in zip(outs["cuda"], outs["cpu"]):
        assert torch.equal(got.cpu(), want)


# -- the transform registry's int64 date chains on the card ---------------------

_MS_1900, _MS_2101 = -2_208_988_800_000, 4_133_980_800_000
# leap days and the turns of 1900, 2000 and 2100, in epoch millis
_MS_EDGES = [-2_208_988_800_000, -2_203_977_600_000, -2_203_891_200_000,
             951_782_400_000, 951_868_800_000, 946_684_799_999,
             946_684_800_000, 4_107_456_000_000, 4_107_542_400_000,
             4_102_444_799_999, 4_102_444_800_000, -1, 0, 1]
_DATE_CHAINS = ["year(tsr)", "month(tsr)", "quarter(tsr)", "day(tsr)",
                "dayofyear(tsr)", "dayofweek(tsr)", "hour(tsr)",
                "minute(tsr)", "second(tsr)", "millisecond(tsr)",
                "datetrunc('WEEK', tsr)", "datetrunc('MONTH', tsr)",
                "datetrunc('QUARTER', tsr)", "datetrunc('YEAR', tsr)",
                "datetrunc('MONTH', ts)", "toepochdays(tsr) - toepochdays(ts)",
                "timestampdiff('WEEK', ts, tsr)", "toepochminutesbucket(tsr, 15)",
                "datetimeconvert(tsr, '1:MILLISECONDS:EPOCH', '1:HOURS:EPOCH', "
                "'15:MINUTES')"]


@pytest.fixture(scope="module")
def time_table(tmp_path_factory):
    """2^20 rows: tsr raw millis from 1900 to 2100 (edges first), ts a
    day of the same span (dictionary-encoded), d_year, lo_revenue."""
    rng = np.random.default_rng(1900)
    n = 1 << 20
    tsr = rng.integers(_MS_1900, _MS_2101, n).astype(np.int64)
    tsr[:len(_MS_EDGES)] = _MS_EDGES
    cols = {"tsr": tsr,
            "ts": rng.integers(-25567, 47482, n).astype(np.int64) * 86_400_000,
            "d_year": rng.integers(1992, 1999, n).astype(np.int32),
            "lo_revenue": rng.integers(1, 600_000, n).astype(np.int32)}
    schema = Schema.build("tt", dimensions=[("tsr", "TIMESTAMP"),
                                            ("ts", "TIMESTAMP"),
                                            ("d_year", "INT")],
                          metrics=[("lo_revenue", "INT")])
    cfg = TableConfig(table_name="tt", indexing=IndexingConfig(
        no_dictionary_columns=["tsr", "lo_revenue"]))
    path = tmp_path_factory.mktemp("torch_cuda_time") / "tt"
    SegmentBuilder(schema, cfg, "tt").build(cols, path)
    return schema, load_segment(path)


@pytest.mark.parametrize("expr", _DATE_CHAINS)
def test_int64_date_chain_on_the_card_matches_cpu(cuda, time_table, expr):
    """Each lowered chain (int64 floor division and modulo over negative
    millis), element-equal on the card to the port's CPU run, which equals
    the registry's numpy form."""
    from pinot_tpu_torch.engine.plan import SegmentPlan, SegmentPlanner
    from pinot_tpu_torch.engine import ir
    from pinot_tpu_torch.ops import kernels
    from pinot_tpu_torch.query.parser.sql import parse_sql
    from pinot_tpu_torch.query.transforms import eval_expr_np
    from pinot_tpu_torch.segment.device_cache import SegmentDeviceView

    _, seg = time_table
    q = parse_sql(f"SELECT {expr} FROM tt")
    planner = SegmentPlanner(q, seg)
    ve = planner.value_expr(q.select_expressions[0])
    assert not isinstance(ve, ir.ParamGather)
    plan = SegmentPlan(ir.Program(mode="selection", filter=None),
                       planner._slots, planner._params)
    outs = {}
    for dev in ("cpu", "cuda"):
        arrays, packed = plan.gather_arrays_packed(SegmentDeviceView(seg, dev))
        arrays = kernels._apply_packed(arrays, packed)
        params = tuple(torch.from_numpy(np.array(p)).to(dev).reshape(1, -1)
                       for p in plan.params)
        outs[dev] = kernels._eval_value(
            ve, tuple(a.unsqueeze(0) for a in arrays), params)[0]
    assert outs["cuda"].dtype == torch.int64
    assert torch.equal(outs["cuda"].cpu(), outs["cpu"])
    want = eval_expr_np(q.select_expressions[0], lambda c: seg.get_values_at(
        c, np.arange(seg.num_docs)))
    np.testing.assert_array_equal(outs["cpu"][:seg.num_docs].numpy(), want)


def test_time_raw_on_the_card_matches_cpu(cuda, time_table):
    """chip_smoke.py's time_raw shape: the chain in a filter and an int64
    expression operand, through kernel A, rows equal to the CPU run's."""
    schema, seg = time_table
    sql = ("SELECT d_year, COUNT(*), SUM(toEpochDays(tsr) - toEpochDays(ts)) "
           "FROM tt WHERE MONTH(tsr) = 12 GROUP BY d_year")
    rows = {}
    for dev in ("cpu", "cuda"):
        qe = QueryExecutor(device=dev)
        qe.add_table(schema, [seg])
        before = _cuda.LAUNCHES["limb_sums"]
        rows[dev] = sorted(qe.execute_sql(sql).result_table.rows)
        if dev == "cuda":
            assert _cuda.LAUNCHES["limb_sums"] == before + 1
    assert rows["cuda"] == rows["cpu"] and len(rows["cpu"]) == 7


def _live_rows(n, seed, t0=0):
    rng = np.random.default_rng(seed)
    regions = ["AMERICA", "ASIA", "EUROPE", "AFRICA", "MIDDLE EAST"]
    return [{"d_year": int(rng.integers(1992, 1999)),
             "p_brand": int(rng.integers(0, 100)),
             "s_region": regions[int(rng.integers(5))],
             "lo_revenue": int(rng.integers(1, 600_000)),
             "pk": int(rng.integers(0, 4096)), "ts": t0 + i}
            for i in range(n)]


_LIVE_SCHEMA = dict(dimensions=[("d_year", "INT"), ("p_brand", "INT"),
                                ("s_region", "STRING"), ("pk", "LONG")],
                    metrics=[("lo_revenue", "INT")],
                    date_times=[("ts", "LONG")])


def test_realtime_delta_upload_on_the_card_matches_cpu(cuda):
    """A consuming segment's planes on the card: per generation (cold, a
    warm repeat, a tail, a tail across the 8192-row bucket, grown on the
    device) the same delta bytes and uploads as the CPU run, the same plane
    contents and the same rows, kernel A launched for the GROUP BY."""
    from pinot_tpu_torch.realtime.device_plane import (
        REALTIME_PLANES, realtime_stats, reset_realtime_stats)
    from pinot_tpu_torch.segment.mutable import MutableSegment

    schema = Schema.build("live", **_LIVE_SCHEMA)
    seg = MutableSegment(schema, "card_live_0")
    qes = {dev: QueryExecutor(device=dev) for dev in ("cpu", "cuda")}
    for qe in qes.values():
        qe.add_table(schema, [seg])
    sql = ("SET useFusedKernel = false; SELECT d_year, SUM(lo_revenue), "
           "COUNT(*) FROM live WHERE d_year BETWEEN 1993 AND 1995 "
           "GROUP BY d_year")
    for n, seed in ((6000, 1), (0, None), (300, 2), (4000, 3)):
        for r in _live_rows(n, seed) if n else ():
            seg.index(r)
        rows, stats = {}, {}
        for dev, qe in qes.items():
            before = _cuda.LAUNCHES["limb_sums"]
            reset_realtime_stats()
            rows[dev] = sorted(qe.execute_sql(sql).result_table.rows)
            stats[dev] = dict(realtime_stats())
            if dev == "cuda":
                assert _cuda.LAUNCHES["limb_sums"] == before + 1
        assert rows["cuda"] == rows["cpu"]
        assert stats["cuda"] == stats["cpu"]
        if not n:
            assert stats["cuda"]["deltaBytes"] == 0
    view = seg.snapshot_view()
    for column, kind in (("d_year", "ids"), ("lo_revenue", "raw")):
        planes = {dev: REALTIME_PLANES.plane_set(seg, dev)
                  for dev in ("cpu", "cuda")}
        assert planes["cuda"].capacity(column, kind) == 16384
        got = planes["cuda"].row_plane(view, column, kind)
        assert got.is_cuda
        assert torch.equal(got.cpu(),
                           planes["cpu"].row_plane(view, column, kind))


def test_hybrid_and_upsert_queries_on_the_card_match_cpu(cuda, tmp_path):
    """chip_smoke.py's `ssb_rt` and `ups` shapes at a small size: 2
    immutable segments and a consuming one (2 dispatches), and an upsert
    table (FULL, `ts` the comparison column) of a committed and a
    consuming segment, each carrying a validity MaskParam, before and
    after an overwrite; rows on the card equal the CPU's."""
    from pinot_tpu_torch.segment.mutable import MutableSegment
    from pinot_tpu_torch.spi.table_config import UpsertConfig
    from pinot_tpu_torch.upsert import TableUpsertMetadataManager

    schema = Schema.build("rt", primary_key_columns=["pk"], **_LIVE_SCHEMA)
    rows = _live_rows(12_000, 4)
    segs = []
    for i in range(2):
        part = rows[i * 4000:(i + 1) * 4000]
        path = tmp_path / f"rt{i}"
        SegmentBuilder(schema, TableConfig(table_name="rt"), f"rt{i}").build(
            {c: [r[c] for r in part] for c in schema.column_names()}, path)
        segs.append(load_segment(path))
    live = MutableSegment(schema, "card_hybrid")
    for r in rows[8000:]:
        live.index(r)
    qes = {dev: QueryExecutor(device=dev) for dev in ("cpu", "cuda")}
    for qe in qes.values():
        qe.add_table(schema, segs + [live])
    hybrid = ("SELECT d_year, p_brand, SUM(lo_revenue) FROM rt "
              "WHERE s_region = 'ASIA' GROUP BY d_year, p_brand LIMIT 10000")
    got = {dev: qe.execute_sql(hybrid) for dev, qe in qes.items()}
    assert got["cuda"].num_device_dispatches == 2
    assert sorted(got["cuda"].result_table.rows) == \
        sorted(got["cpu"].result_table.rows)

    cfg = TableConfig(table_name="ups", upsert=UpsertConfig(
        mode="FULL", comparison_columns=["ts"]))
    mgr = TableUpsertMetadataManager(schema, cfg)
    committed = load_segment(tmp_path / "rt0")
    mgr.add_segment(committed)
    consuming = MutableSegment(schema, "card_ups")
    for qe in qes.values():
        qe.add_table(schema, [committed, consuming], "ups")

    def put(batch):
        for r in batch:
            mgr.add_record(consuming, consuming.index(r), r)

    put(_live_rows(4000, 5, t0=10_000))
    ups = ("SELECT d_year, SUM(lo_revenue), COUNT(*) FROM ups "
           "WHERE s_region = 'ASIA' GROUP BY d_year")
    for _ in range(2):
        got = {dev: sorted(qe.execute_sql(ups).result_table.rows)
               for dev, qe in qes.items()}
        assert got["cuda"] == got["cpu"]
        put(_live_rows(500, 6, t0=20_000))


def _fed_manager(tmp_path, monkeypatch, flush=10_000):
    """A RealtimeTableDataManager over a fresh 2-partition in-memory topic
    (the port's registry replaced), with the topic: partition 0 gets 11,000
    rows and partition 1 19,000, so each commits one segment of `flush`
    rows (a family of 2 on the card) and keeps a consuming segment of
    1,000 and 9,000 rows (two pad buckets: each snapshot dispatches
    alone)."""
    from pinot_tpu_torch.realtime.manager import RealtimeTableDataManager
    from pinot_tpu_torch.spi import stream
    from pinot_tpu_torch.spi.table_config import IngestionConfig, TableType

    reg = stream.InMemoryStreamRegistry()
    monkeypatch.setattr(stream, "GLOBAL_STREAM_REGISTRY", reg)
    reg.create_topic("card_rt", num_partitions=2)
    topic = reg.topic("card_rt")
    rows = _live_rows(30_000, 7)
    for i, r in enumerate(rows):
        topic.publish(0 if i < 11_000 else 1, r)
    schema = Schema.build("live", **_LIVE_SCHEMA)
    cfg = TableConfig(
        table_name="live", table_type=TableType.REALTIME,
        indexing=IndexingConfig(no_dictionary_columns=["lo_revenue"]),
        ingestion=IngestionConfig(stream_configs={
            "streamType": "inmemory", "stream.inmemory.topic.name": "card_rt",
            "realtime.segment.flush.threshold.rows": flush}))
    mgr = RealtimeTableDataManager(schema, cfg, tmp_path / "rt")
    qes = {dev: QueryExecutor(device=dev) for dev in ("cpu", "cuda")}
    for qe in qes.values():
        qe.add_table(schema, mgr.segments)
    return mgr, qes, rows


_RT_Q2 = ("SELECT d_year, p_brand, SUM(lo_revenue) FROM live WHERE s_region "
          "= 'ASIA' GROUP BY d_year, p_brand LIMIT 10000")


def _settle(mgr, total, committed, timeout=60.0):
    import time

    t0 = time.time()
    while not (mgr.total_docs() == total
               and len(mgr._committed) == committed):
        assert time.time() - t0 < timeout, (mgr.total_docs(),
                                            len(mgr._committed))
        time.sleep(0.01)


def test_realtime_manager_feeds_the_card(cuda, tmp_path, monkeypatch):
    """A manager consuming a 2-partition stream feeds a QueryExecutor on
    the card: at the settle point the Q2 shape's rows equal a CPU
    executor's over the same live list, kernel A runs over the committed
    family of 2 and kernel B over each consuming snapshot."""
    mgr, qes, rows = _fed_manager(tmp_path, monkeypatch)
    mgr.start()
    try:
        _settle(mgr, len(rows), 2)
        assert sorted(s.num_docs for s in mgr._committed) == [10_000, 10_000]
        _cuda.reset_launches()
        got = qes["cuda"].execute_sql(_RT_Q2)
        torch.cuda.synchronize()
        launches = dict(_cuda.LAUNCHES)
        assert got.num_device_dispatches == 3
        assert launches == {"limb_sums": 1, "fused_limb_sums": 2}
        want = qes["cpu"].execute_sql(_RT_Q2)
        assert sorted(got.result_table.rows) == sorted(want.result_table.rows)
        assert len(got.result_table.rows) > 0
    finally:
        mgr.stop()


def test_commit_retires_the_sealed_planes_on_the_card(cuda, tmp_path,
                                                       monkeypatch):
    """After a force_commit, neither REALTIME_PLANES nor the card's or the
    CPU executor's cache holds a plane of the sealed segments; their bytes
    were freed, nothing raised, and the next query (the immutable
    replacements, cold) still equals the CPU's."""
    from pinot_tpu_torch.realtime.device_plane import REALTIME_PLANES

    mgr, qes, rows = _fed_manager(tmp_path, monkeypatch)
    mgr.start()
    try:
        _settle(mgr, len(rows), 2)
        for qe in qes.values():
            qe.execute_sql(_RT_Q2)  # the snapshots' planes, both devices
        sealed = [m.segment.name for m in mgr._consuming.values()]
        assert set(sealed) <= REALTIME_PLANES.names()
        before = mgr.retirement_stats()
        assert sorted(mgr.force_commit()) == sorted(sealed)
        _settle(mgr, len(rows), 4)
        after = mgr.retirement_stats()
        assert after["segments"] == before["segments"] + 2
        assert after["errors"] == before["errors"]
        assert after["bytesFreed"] > before["bytesFreed"]
        assert not set(sealed) & REALTIME_PLANES.names()
        for qe in qes.values():
            assert not set(sealed) & qe.executor.cache.segment_names()
        got = {dev: sorted(qe.execute_sql(_RT_Q2).result_table.rows)
               for dev, qe in qes.items()}
        assert got["cuda"] == got["cpu"]
    finally:
        mgr.stop()


@pytest.fixture(scope="module")
def index_table(tmp_path_factory):
    """Three segments with a star-tree (split d_year, s_region, p_brand)
    and JSON, text, map and vector index columns; integer metrics, so
    every sum is exact in any order."""
    import json

    rng = np.random.default_rng(29)
    n = 20_000
    words = np.asarray(["connection", "reset", "time", "timeout"]
                       + [f"w{i}" for i in range(40)], dtype=object)
    schema = Schema.build("ix", dimensions=[
        ("d_year", "INT"), ("s_region", "STRING"), ("p_brand", "INT"),
        ("attrs", "JSON"), ("msg", "STRING"), ("props", "STRING"),
        ("emb", "FLOAT", False)],
        metrics=[("lo_revenue", "INT"), ("lo_quantity", "INT")])
    cfg = TableConfig(table_name="ix", indexing=IndexingConfig(
        no_dictionary_columns=["lo_revenue", "lo_quantity"],
        star_tree_index_configs=[{
            "dimensionsSplitOrder": ["d_year", "s_region", "p_brand"],
            "functionColumnPairs": ["COUNT__*", "SUM__lo_revenue",
                                    "SUM__lo_quantity", "MIN__lo_quantity",
                                    "MAX__lo_quantity"]}],
        json_index_columns=["attrs"], text_index_columns=["msg"],
        vector_index_columns=["emb"],
        custom_index_configs={"props": {"type": "map", "maxKeys": 8}}))
    segs = []
    for i in range(3):
        cols = {
            "d_year": rng.integers(1992, 1999, n).astype(np.int32),
            "s_region": np.asarray(["AMERICA", "ASIA", "EUROPE"],
                                   dtype=object)[rng.integers(0, 3, n)],
            "p_brand": rng.integers(0, 200, n).astype(np.int32),
            "attrs": [json.dumps({"os": ["ios", "android"][k % 2],
                                  "tags": [f"t{k % 9}", f"t{k % 7}"]})
                      for k in rng.integers(0, 1000, n)],
            "msg": [" ".join(words[rng.integers(0, len(words), 6)])
                    for _ in range(n)],
            "props": [json.dumps({"clicks": int(c)} if c % 11 else {})
                      for c in rng.integers(0, 51, n)],
            "emb": [list(v) for v in rng.normal(size=(n, 16)).astype(
                np.float32)],
            "lo_revenue": rng.integers(1, 600_000, n).astype(np.int32),
            "lo_quantity": rng.integers(1, 51, n).astype(np.int32),
        }
        path = tmp_path_factory.mktemp("torch_cuda_index") / f"ix{i}"
        SegmentBuilder(schema, cfg, f"ix{i}").build(cols, path)
        segs.append(load_segment(path))
    return schema, segs


_QVEC = "ARRAY[" + ", ".join(f"{x:.5f}" for x in np.random.default_rng(
    31).normal(size=16)) + "]"


# star-tree rewrites (one family of the views: one launch of kernel A; its
# SET segmentBatch = false twin, three) and index-backed mask planes (one
# family)
@pytest.mark.parametrize("sql,launches", [
    ("SELECT d_year, p_brand, SUM(lo_revenue) FROM ix WHERE s_region = "
     "'ASIA' GROUP BY d_year, p_brand LIMIT 10000", 1),
    ("SELECT s_region, COUNT(*), AVG(lo_revenue), MINMAXRANGE(lo_quantity) "
     "FROM ix WHERE d_year BETWEEN 1993 AND 1995 GROUP BY s_region", 1),
    ("SET segmentBatch = false; SELECT d_year, SUM(lo_quantity), COUNT(*) "
     "FROM ix GROUP BY d_year", 3),
    ("SELECT SUM(lo_revenue) FROM ix WHERE d_year = 1993 AND "
     "lo_quantity < 25", 0),
    ("SELECT d_year, COUNT(*), SUM(lo_revenue) FROM ix WHERE "
     "JSON_MATCH(attrs, '\"$.os\" = ''ios'' AND \"$.tags[*]\" = ''t7''') "
     "GROUP BY d_year", 1),
    ("SELECT d_year, COUNT(*), SUM(lo_revenue) FROM ix WHERE "
     "TEXT_MATCH(msg, '\"connection reset\" OR time*') AND s_region = "
     "'ASIA' GROUP BY d_year", 1),
    ("SELECT s_region, COUNT(*), SUM(lo_revenue) FROM ix WHERE "
     "mapValue(props, 'clicks') > 40 GROUP BY s_region", 1),
    (f"SELECT d_year, COUNT(*) FROM ix WHERE VECTOR_SIMILARITY(emb, {_QVEC}, "
     "100) GROUP BY d_year", 1),
])
def test_index_queries_on_the_card_match_cpu(cuda, index_table, sql,
                                             launches):
    schema, segs = index_table
    gpu, cpu = QueryExecutor(device="cuda"), QueryExecutor(device="cpu")
    for qe in (gpu, cpu):
        qe.add_table(schema, segs)
    before = _cuda.LAUNCHES["limb_sums"]
    got = gpu.execute_sql(sql)
    assert _cuda.LAUNCHES["limb_sums"] - before == launches
    want = cpu.execute_sql(sql)
    assert sorted(map(tuple, got.result_table.rows)) == \
        sorted(map(tuple, want.result_table.rows))
    assert got.num_docs_scanned == want.num_docs_scanned
    assert got.num_device_dispatches == want.num_device_dispatches


# -- the multi-stage join pipeline --------------------------------------------


def _skewed_keys(rng, n):
    """About 2^20 keys: a tenth on one heavy hitter, a Zipf tail and a
    uniform body over 2^18 values."""
    keys = rng.integers(0, 1 << 18, n)
    heavy = rng.random(n) < 0.1
    keys[heavy] = 777
    tail = rng.random(n) < 0.2
    keys[tail] = np.minimum(rng.zipf(1.4, int(tail.sum())), 1 << 20)
    return keys.astype(np.int64)


def _join_inputs(seed):
    from pinot_tpu_torch.ops import join_pipeline as jp

    rng = np.random.default_rng(seed)
    pn, bn = (1 << 20) - 3, (1 << 19) + 11
    Np, Nb = jp.bucket(pn), jp.bucket(bn)
    pk, bk, pg = (np.zeros(Np, np.int64), np.zeros(Nb, np.int64),
                  np.zeros(Np, np.int64))
    pk[:pn] = _skewed_keys(rng, pn)
    bk[:bn] = _skewed_keys(rng, bn)
    pg[:pn] = rng.integers(0, 7, pn)
    pvals = np.zeros((1, Np))
    pvals[0, :pn] = rng.integers(-1000, 1000, pn)
    bvals = np.zeros((1, Nb))
    bvals[0, :bn] = rng.integers(0, 10_000, bn)
    pmask = np.zeros(Np, bool)
    pmask[:pn] = rng.random(pn) < 0.5
    bmask = np.zeros(Nb, bool)
    bmask[:bn] = rng.random(bn) < 0.1
    P = 8
    cap_l = jp.bucket(int(jp.host_partition_counts(pk[:pn], P).max()))
    cap_r = jp.bucket(int(jp.host_partition_counts(bk[:bn], P).max()))
    return dict(pk=pk, bk=bk, pg=pg, pvals=pvals, bvals=bvals, pmask=pmask,
                bmask=bmask, pn=pn, bn=bn, P=P, cap_l=cap_l, cap_r=cap_r,
                bmin=int(bk[:bn].min()), bmax=int(bk[:bn].max()))


def _run_join(x, device, join_type, masks):
    from pinot_tpu_torch.ops import join_pipeline as jp

    t = {k: torch.as_tensor(x[k], device=device)
         for k in ("pk", "bk", "pg", "pvals", "bvals", "pmask", "bmask")}
    pplane, pcounts = jp.partition_planes(t["pk"], x["pn"], x["P"],
                                          x["cap_l"])
    bplane, bcounts = jp.partition_planes(
        t["bk"], x["bn"], x["P"], x["cap_r"], key_sorted=True,
        cmin=x["bmin"], cmax=x["bmax"])
    spec = (("count", "probe", 0), ("sum", "probe", 0), ("min", "probe", 0),
            ("sum", "build", 0), ("max", "build", 0), ("min", "build", 0))
    packed = jp.fused_join_agg(
        t["pk"], t["pg"], t["pvals"], pplane, pcounts, t["bk"], t["bvals"],
        bplane, bcounts, x["pn"], x["bn"], spec, x["P"], 8,
        join_type=join_type,
        pmask=t["pmask"] if masks else None,
        bmask=t["bmask"] if masks else None)
    return [a.cpu().numpy() for a in (pplane, pcounts, bplane, bcounts,
                                      packed)]


@pytest.mark.parametrize("join_type", ["INNER", "LEFT", "SEMI", "ANTI"])
@pytest.mark.parametrize("masks", [False, True])
def test_join_pipeline_on_the_card_matches_cpu(cuda, join_type, masks):
    x = _join_inputs(41)
    got = _run_join(x, cuda, join_type, masks)
    want = _run_join(x, "cpu", join_type, masks)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g.view(np.int64),
                                                     w.view(np.int64))


@pytest.mark.parametrize("mode", ["rows", "packed", "keyed"])
def test_partition_modes_on_the_card_match_cpu(cuda, mode):
    from pinot_tpu_torch.ops import join_pipeline as jp

    rng = np.random.default_rng(5)
    n = (1 << 20) - 5
    codes = np.zeros(1 << 20, np.int64)
    codes[:n] = _skewed_keys(rng, n) * (1 << 40 if mode == "keyed" else 1)
    cmin = int(codes[:n].min())
    for cap in (1 << 17, 1 << 15):  # fits; overflows the heavy partition
        got = jp._partition(torch.as_tensor(codes, device=cuda), n, cmin, 8,
                            cap, mode)
        want = jp._partition(torch.as_tensor(codes), n, cmin, 8, cap, mode)
        for g, w in zip(got, want):
            assert np.array_equal(g.cpu().numpy(), w.numpy())


def test_chain_gather_and_pair_join_on_the_card_match_cpu(cuda):
    from pinot_tpu_torch.mse import device_join
    from pinot_tpu_torch.ops import join_pipeline as jp

    rng = np.random.default_rng(8)
    cols = [rng.integers(-1 << 30, 1 << 30, 1 << 20).astype(np.int32),
            rng.integers(0, 1 << 40, 1 << 20).astype(np.int64)]
    idx = rng.integers(0, 1 << 20, 3 << 18)
    got = jp.gather_stack(cols, idx, len(idx), 1 << 20, cuda).cpu().numpy()
    want = jp.gather_stack(cols, idx, len(idx), 1 << 20, "cpu").numpy()
    assert np.array_equal(got, want)
    lk = _skewed_keys(rng, (1 << 20) - 1)[::3]
    rk = _skewed_keys(rng, 1 << 18)[::7]
    for max_out in (5_000_000, 100_000):
        g = device_join.device_join_indices(lk, rk, max_out, cuda)
        w = device_join.device_join_indices(lk, rk, max_out, "cpu")
        assert g[2] == w[2]
        assert np.array_equal(g[0], w[0]) and np.array_equal(g[1], w[1])
    payload = {"a": cols[0], "b": cols[1]}
    g = device_join.gather_payload(payload, idx, cuda)
    for name, v in payload.items():
        assert np.array_equal(g[name], v[idx])


def test_q8_shape_on_the_card_matches_cpu(cuda, tmp_path):
    """The bench's q8 statement end to end: leaves on the selection bitmap,
    the fused join stage on the card, one host crossing."""
    rng = np.random.default_rng(12)
    n = 1 << 20
    cols = {"lo_orderkey": rng.integers(0, n // 8, n).astype(np.int32),
            "lo_quantity": rng.integers(1, 51, n).astype(np.int32),
            "lo_discount": rng.integers(0, 11, n).astype(np.int32),
            "d_year": rng.integers(1992, 1999, n).astype(np.int32),
            "lo_revenue": rng.integers(1, 600_000, n).astype(np.int32)}
    schema = Schema.build("ssb", dimensions=[
        ("lo_orderkey", "INT"), ("lo_quantity", "INT"),
        ("lo_discount", "INT"), ("d_year", "INT")],
        metrics=[("lo_revenue", "INT")])
    cfg = TableConfig(table_name="ssb", indexing=IndexingConfig(
        no_dictionary_columns=["lo_orderkey", "lo_revenue"]))
    segs = []
    for i in range(2):
        sl = slice(i * n // 2, (i + 1) * n // 2)
        SegmentBuilder(schema, cfg, f"q8_{i}").build(
            {k: v[sl] for k, v in cols.items()}, tmp_path / f"q8_{i}")
        segs.append(load_segment(tmp_path / f"q8_{i}"))
    sql = ("SET useMultistageEngine = true; SET deviceJoin = true; "
           "SELECT a.d_year, COUNT(*), SUM(b.lo_revenue) FROM ssb a "
           "JOIN ssb b ON a.lo_orderkey = b.lo_orderkey "
           "WHERE a.lo_quantity < 3 AND b.lo_discount = 0 "
           "GROUP BY a.d_year ORDER BY a.d_year LIMIT 100")
    got, want = [], []
    for device, out in ((cuda, got), ("cpu", want)):
        qe = QueryExecutor(device=device)
        qe.add_table(schema, segs)
        resp = qe.execute_sql(sql)
        assert not resp.exceptions, resp.exceptions
        fused = [st for st in resp.mse_stage_stats.values()
                 if st["join_impl"]]
        assert [st["join_impl"] for st in fused] == ["device-fused"]
        assert [st["host_crossings"] for st in fused] == [1]
        out.extend(resp.result_table.rows)
    assert got == want and len(got) == 7


# -- the caches and device-memory relief on the card ---------------------------


@pytest.fixture
def caches_on(monkeypatch):
    from pinot_tpu_torch.cache.partial import GLOBAL_PARTIAL_CACHE

    monkeypatch.setenv("PINOT_TPU_SEGMENT_CACHE", "1")
    monkeypatch.setenv("PINOT_TPU_RESULT_CACHE", "1")
    GLOBAL_PARTIAL_CACHE.clear()
    yield
    GLOBAL_PARTIAL_CACHE.clear()


SPARSE16 = ("SET sparseGroupBy = true; SELECT lo_orderkey, SUM(lo_revenue), "
            "COUNT(*) FROM ssb16 GROUP BY lo_orderkey ORDER BY lo_orderkey "
            "LIMIT 5000")


@pytest.mark.parametrize("sql", [
    "SELECT d_year, p_brand, SUM(lo_revenue), COUNT(*) FROM ssb16 "
    "WHERE d_year > 1993 GROUP BY d_year, p_brand LIMIT 10000",
    "SELECT p_brand, MIN(lo_revenue), MAX(lo_revenue), AVG(lo_revenue) "
    "FROM ssb16 GROUP BY p_brand LIMIT 1000",
    "SELECT COUNT(*), SUM(lo_revenue), MAX(lo_revenue) FROM ssb16",
    SPARSE16,
], ids=["dense", "minmax-avg", "agg", "sparse"])
def test_cache_hit_equals_recompute_on_the_card(cuda, caches_on, table16,
                                                sql):
    """A hit's rows are the recompute's, bit for bit (floats compared with
    ==), with no dispatch."""
    schema, segs = table16
    qe = QueryExecutor(device="cuda")
    qe.add_table(schema, segs)
    cold = qe.execute_sql(sql)
    warm = qe.execute_sql(sql)
    again = qe.execute_sql("SET segmentCache = false; " + sql)
    assert (warm.num_segments_cache_hit, warm.num_device_dispatches) == \
        (len(segs), 0)
    assert again.num_device_dispatches > 0
    assert warm.result_table.rows == cold.result_table.rows == \
        again.result_table.rows


def test_sparse_table_tier_stays_on_the_card(cuda, caches_on, table16):
    """The device combine's per-segment tables are kept as CUDA tensors,
    counted in the device cache's bytes, evicted first under its budget."""
    from pinot_tpu_torch.cache.partial import GLOBAL_PARTIAL_CACHE

    schema, segs = table16
    qe = QueryExecutor(device="cuda")
    qe.add_table(schema, segs)
    cache = qe.executor.cache
    cold = qe.execute_sql(SPARSE16)
    st = cache.stats()
    assert st["partialEntries"] == len(segs)
    tensors = [t for ent in cache._partials.values() for t in ent[0]]
    assert all(t.device.type == "cuda" for t in tensors)
    assert st["partialBytes"] == sum(t.numel() * t.element_size()
                                     for t in tensors)
    assert cache.bytes_used() == st["viewBytes"] + st["stackBytes"] + \
        st["partialBytes"]
    GLOBAL_PARTIAL_CACHE.clear()
    warm = qe.execute_sql(SPARSE16)
    assert warm.num_device_dispatches == 0
    assert warm.result_table.rows == cold.result_table.rows
    # a budget the partials overflow: they go before any view or stack
    cache.budget_bytes = st["viewBytes"] + st["stackBytes"] + \
        st["partialBytes"] // 2
    cache.view(segs[0])
    after = cache.stats()
    assert after["partialBytes"] <= st["partialBytes"] // 2
    assert after["viewBytes"] == st["viewBytes"]


def _raw_table(tmp_path, name, segments, rows, seed):
    rng = np.random.default_rng(seed)
    schema = Schema.build(name, dimensions=[("d_year", "INT")],
                          metrics=[("m1", "INT"), ("m2", "INT")])
    cfg = TableConfig(table_name=name, indexing=IndexingConfig(
        no_dictionary_columns=["m1", "m2"]))
    segs = []
    for i in range(segments):
        cols = {"d_year": rng.integers(1992, 1999, rows).astype(np.int32),
                "m1": rng.integers(0, 1000, rows).astype(np.int32),
                "m2": rng.integers(0, 1000, rows).astype(np.int32)}
        SegmentBuilder(schema, cfg, f"{name}{i}").build(
            cols, tmp_path / f"{name}{i}")
        segs.append(load_segment(tmp_path / f"{name}{i}"))
    return schema, segs


def _fill_free_blocks():
    """Tensors that take the caching allocator's free blocks under the
    current cap (blocks inside segments that still hold live tensors,
    which empty_cache cannot release): then the cap binds."""
    ballast = []
    for size in (64 << 20, 2 << 20, 512 << 10):
        while True:
            try:
                ballast.append(torch.empty(size, dtype=torch.uint8,
                                           device="cuda"))
            except torch.cuda.OutOfMemoryError:
                break
    return ballast


def test_capped_allocation_relieves_once_and_answers(cuda, tmp_path):
    """Under a per-process cap a cold table cannot upload beside a resident
    one: one relief evicts the resident planes and the query answers as on
    the CPU. Under a cap below the query's own need it fails alone with
    HbmExhaustedError, and answers again once the cap is lifted."""
    from pinot_tpu_torch.engine.oom import (HbmExhaustedError, oom_stats,
                                            reset_oom_stats)

    # the resident planes (144 MB) free far more than one cold segment
    # needs (9 MB of planes and the kernel's temporaries), and its planes
    # need new blocks of the caching allocator past the cap; each segment
    # dispatches alone (a family's stacks and temporaries can outgrow what
    # relief frees: it then falls back to this path, phase `oom` of
    # chip_smoke.py covers that seam)
    resident = _raw_table(tmp_path, "res", 4, 1 << 22, 3)
    cold = _raw_table(tmp_path, "cold", 4, 1 << 20, 4)
    sql = ("SET segmentBatch = false; SELECT d_year, SUM(m1), SUM(m2), "
           "COUNT(*) FROM cold GROUP BY d_year ORDER BY d_year")
    cpu = QueryExecutor(device="cpu")
    cpu.add_table(*cold)
    want = cpu.execute_sql(sql).result_table.rows
    qe = QueryExecutor(device="cuda")
    qe.add_table(*resident)
    qe.add_table(*cold)
    for s in resident[1]:
        qe.executor.cache.warm(s)
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    total = torch.cuda.get_device_properties(0).total_memory
    try:
        cap = torch.cuda.memory_reserved() + (4 << 20)
        torch.cuda.set_per_process_memory_fraction(cap / total)
        ballast = _fill_free_blocks()
        reset_oom_stats()
        got = qe.execute_sql(sql)
        ballast = None
        assert got.result_table.rows == want
        assert (oom_stats()["reliefs"], oom_stats()["failures"]) == (1, 0)
        assert oom_stats()["freedBytes"] >= 4 * 2 * (1 << 22) * 4
        torch.cuda.empty_cache()
        qe.executor.cache.evict_all_except(None)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.set_per_process_memory_fraction(
            (torch.cuda.memory_allocated() + (1 << 20)) / total)
        ballast = _fill_free_blocks()
        with pytest.raises(HbmExhaustedError):
            qe.execute_sql(sql)
        assert oom_stats()["failures"] >= 1
    finally:
        ballast = None
        torch.cuda.set_per_process_memory_fraction(1.0)
    assert qe.execute_sql(sql).result_table.rows == want


# -- coalescing, tracing and the device caches under concurrency -------------


def _concurrent(qe, sqls):
    """Run the SQLs on one thread each, released together."""
    import threading

    barrier = threading.Barrier(len(sqls))
    out: list = [None] * len(sqls)

    def work(i, sql):
        barrier.wait(timeout=60)
        out[i] = qe.execute_sql(sql)

    threads = [threading.Thread(target=work, args=(i, s))
               for i, s in enumerate(sqls)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert all(r is not None for r in out), "a worker thread failed or hung"
    return out


_CO_SQL = ("SELECT d_year, p_brand, SUM(lo_revenue), COUNT(*) FROM ssb "
           "WHERE lo_revenue > {lit} GROUP BY d_year, p_brand LIMIT 10000")


def test_coalesced_group_on_the_card_matches_cpu(cuda, small_table,
                                                 monkeypatch):
    """Eight concurrent queries of one family, four literals, coalesce
    into one launch of kernel A over [S*Q] members; each query's rows equal
    the CPU executor's."""
    from pinot_tpu_torch.engine.coalesce import FamilyTraffic, QueryCoalescer

    schema, segs = small_table
    gpu, cpu = QueryExecutor(device="cuda"), QueryExecutor(device="cpu")
    for qe in (gpu, cpu):
        qe.add_table(schema, segs)
    gpu.coalescer = QueryCoalescer(FamilyTraffic(min_traffic=1.0))
    sqls = [_CO_SQL.format(lit=lit) for lit in (0, 1000, 250_000, 500_000)] * 2
    want = [sorted(map(tuple, cpu.execute_sql(s).result_table.rows))
            for s in sqls]
    monkeypatch.setenv("PINOT_TPU_COALESCE_WINDOW_MS", "5000")
    monkeypatch.setenv("PINOT_TPU_COALESCE_MAX_QUERIES", str(len(sqls)))
    before = _cuda.LAUNCHES["limb_sums"]
    got = _concurrent(gpu, sqls)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["limb_sums"] == before + 1
    assert sum(r.num_device_dispatches for r in got) == 1
    for r, w in zip(got, want):
        assert r.num_coalesced_queries == len(sqls) - 1
        assert sorted(map(tuple, r.result_table.rows)) == w


@pytest.mark.parametrize("q", [8, 16])
def test_family_limb_sums_at_the_coalesced_shape(cuda, q):
    """Kernel A over S*Q = 32 and 64 members (4 segments, Q queries), as
    a coalesced group of q2_family's shape launches it: element-equal to
    its plain version."""
    planes, gid = _family_inputs(4, 1 << 18, 4, 7001, q, cuda)
    planes = planes.repeat(q, 1, 1)
    gid = gid.repeat(q, 1)
    got = mxu_groupby.limb_sums(planes, gid, 7001)
    assert got.shape == (4 * q, 4, 7001)
    assert torch.equal(got, mxu_groupby.limb_sums_plain(planes, gid, 7001))


def test_traced_family_times_the_device(cuda, small_table):
    schema, segs = small_table
    qe = QueryExecutor(device="cuda")
    qe.add_table(schema, segs)
    sql = _CO_SQL.format(lit=0)
    qe.execute_sql(sql)
    resp = qe.execute_sql("SET trace = true; " + sql)
    spans = [s for s in resp.trace_info if s["operator"] == "family_dispatch"]
    assert len(spans) == 1
    assert spans[0]["attributes"]["device"] == "cuda"
    assert spans[0]["attributes"]["deviceExecMs"] > 0
    rows = qe.execute_sql("EXPLAIN ANALYZE " + sql).result_table.rows
    assert any("family_dispatch(numSegments:2, device:cuda" in r[0]
               for r in rows)


def test_concurrent_uploads_each_plane_once_on_the_card(cuda, small_table,
                                                        monkeypatch):
    """F7 on the card: 8 threads run one family query on a fresh executor;
    each plane is uploaded once and each stack built once."""
    from collections import Counter

    from pinot_tpu_torch.engine import executor as port_executor
    from pinot_tpu_torch.segment import device_cache

    puts: Counter = Counter()
    stacks: list = []
    real_put = device_cache.SegmentDeviceView._put
    real_stack = port_executor._stack

    def counting_put(view, key, host):
        puts[(view.segment.name, key)] += 1
        return real_put(view, key, host)

    def counting_stack(planes):
        stacks.append(planes[0].shape)
        return real_stack(planes)

    monkeypatch.setattr(device_cache.SegmentDeviceView, "_put", counting_put)
    monkeypatch.setattr(port_executor, "_stack", counting_stack)
    schema, segs = small_table
    qe = QueryExecutor(device="cuda")
    qe.add_table(schema, segs)
    got = _concurrent(qe, [_CO_SQL.format(lit=0)] * 8)
    assert all(r.result_table.rows == got[0].result_table.rows for r in got)
    assert puts and max(puts.values()) == 1, puts
    # at most one stack per family plane (every thread built its own
    # before the repair)
    assert 0 < len(stacks) <= len(puts) // len(segs)


# -- the cluster serving path, PTDP and the doctor on the card ---------------


@pytest.fixture(scope="module")
def cluster_segments(tmp_path_factory):
    """Four segment directories of q2's columns for the cluster tests."""
    rng = np.random.default_rng(31)
    n = 40_000
    schema = Schema.build("ssb", dimensions=[
        ("d_year", "INT"), ("p_brand", "INT"), ("s_region", "STRING")],
        metrics=[("lo_revenue", "INT")])
    cfg = TableConfig(table_name="ssb", indexing=IndexingConfig(
        no_dictionary_columns=["lo_revenue"]))
    root = tmp_path_factory.mktemp("torch_cuda_cluster")
    paths = []
    for i in range(4):
        cols = {"d_year": rng.integers(1992, 1999, n).astype(np.int32),
                "p_brand": rng.integers(0, 1000, n).astype(np.int32),
                "s_region": np.asarray(["AMERICA", "ASIA", "EUROPE"],
                                       dtype=object)[rng.integers(0, 3, n)],
                "lo_revenue": rng.integers(1, 600_000, n).astype(np.int32)}
        SegmentBuilder(schema, cfg, f"ssb_{i}").build(cols, root / f"ssb_{i}")
        paths.append(str(root / f"ssb_{i}"))
    return schema, paths


def _cluster(schema, paths, device):
    from pinot_tpu_torch.cluster import (Broker, ClusterController,
                                         PropertyStore, ServerInstance)

    store = PropertyStore()
    ctl = ClusterController(store)
    servers = [ServerInstance(store, f"Server_{i}", device=device)
               for i in range(2)]
    for s in servers:
        s.start()
    ctl.add_schema(schema.to_json())
    table = ctl.create_table({"tableName": "ssb", "replication": 1})
    for i, path in enumerate(paths):
        ctl.add_segment(table, f"ssb_{i}", {"location": path,
                                            "numDocs": 40_000})
    return servers, Broker(store)


@pytest.mark.parametrize("sql,kernel", [
    ("SET segmentBatch = false; SELECT d_year, p_brand, SUM(lo_revenue) "
     "FROM ssb WHERE s_region = 'ASIA' GROUP BY d_year, p_brand LIMIT 10000",
     "fused_limb_sums"),
    ("SELECT d_year, p_brand, SUM(lo_revenue) FROM ssb "
     "WHERE s_region = 'ASIA' GROUP BY d_year, p_brand LIMIT 10000",
     "limb_sums"),
])
def test_card_cluster_equals_cpu_cluster(cuda, cluster_segments, sql, kernel):
    """Two servers on the card answer q2 (kernel B on each segment) and
    q2_family (kernel A on each server's family of 2) with the rows,
    scanned docs and dispatches of two servers on the CPU."""
    schema, paths = cluster_segments
    out = {}
    for device in ("cpu", "cuda"):
        servers, broker = _cluster(schema, paths, device)
        try:
            _cuda.reset_launches()
            resp = broker.execute_sql(sql)
            torch.cuda.synchronize()
            out[device] = (sorted(map(tuple, resp.result_table.rows)),
                           resp.num_docs_scanned, resp.num_device_dispatches,
                           resp.num_servers_responded, dict(_cuda.LAUNCHES))
        finally:
            for s in servers:
                s.stop()
            broker.close()
    assert out["cuda"][:4] == out["cpu"][:4]
    assert out["cuda"][3] == 2
    assert out["cuda"][4][kernel] == (4 if kernel == "fused_limb_sums" else 2)


def test_packed_block_on_the_card_equals_the_cpu_bytes(cuda):
    from pinot_tpu_torch.cluster import datatable

    rng = np.random.default_rng(5)
    n = 100_003
    specials = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 5e-324,
                         -5e-324, 1e-310, 2.2250738585072014e-308, 1e308])
    block = {"i": rng.integers(-2 ** 31, 2 ** 31 - 1, n).astype(np.int32),
             "l": rng.integers(-2 ** 62, 2 ** 62, n),
             "b": rng.integers(0, 2, n).astype(bool),
             "f": np.concatenate([specials, rng.normal(0, 1e6, n),
                                  rng.normal(size=n) * 1e-300])}
    on_card = datatable.encode_packed_block(block, device="cuda")
    assert on_card == datatable.encode_packed_block(block, device="cpu")
    back = datatable.decode_packed_block(on_card)
    for k, v in block.items():
        assert back[k].tobytes() == v.tobytes(), k


MSE_CLUSTER_JOIN = (
    "SELECT a.d_year, COUNT(*), SUM(b.lo_revenue) FROM ssb a JOIN ssb b "
    "ON a.p_brand = b.p_brand WHERE a.lo_revenue < 3000 AND b.d_year = 1995 "
    "GROUP BY a.d_year ORDER BY a.d_year")


def test_cluster_mse_join_on_the_card_equals_cpu_cluster(
        cuda, cluster_segments, monkeypatch):
    """The cluster multi-stage engine on two servers on the card: the join
    workers' pair join (forced) runs on the card, exchange blocks above
    the (lowered) threshold are packed from card tensors, and rows and
    PTDP bytes equal two servers on the CPU."""
    from pinot_tpu_torch.mse import device_join
    from pinot_tpu_torch.mse import distributed
    from pinot_tpu_torch.ops import kernels

    monkeypatch.setattr(distributed, "DEVICE_PACK_MIN_BYTES", 4096)
    monkeypatch.setenv("PINOT_TPU_DEVICE_JOIN", "1")
    joins, packs = [], []
    real_join, real_pack = device_join.device_join_indices, kernels.pack_u8_wire

    def join_spy(lcodes, rcodes, limit, device):
        joins.append(torch.device(device).type)
        return real_join(lcodes, rcodes, limit, device)

    def pack_spy(outs):
        packs.append({t.device.type for t in outs})
        return real_pack(outs)

    monkeypatch.setattr(device_join, "device_join_indices", join_spy)
    monkeypatch.setattr(kernels, "pack_u8_wire", pack_spy)
    schema, paths = cluster_segments
    out = {}
    for device in ("cpu", "cuda"):
        servers, broker = _cluster(schema, paths, device)
        joins.clear()
        packs.clear()
        try:
            resp = broker.execute_sql(MSE_CLUSTER_JOIN)
            torch.cuda.synchronize()
            assert not resp.exceptions, resp.exceptions
            out[device] = ([tuple(r) for r in resp.result_table.rows],
                           resp.mse_exchange["packed_bytes"],
                           sorted(set(joins)), [sorted(p) for p in packs])
        finally:
            for s in servers:
                s.stop()
            broker.close()
    assert out["cuda"][:2] == out["cpu"][:2]
    assert out["cuda"][1] > 0
    assert out["cuda"][2] == ["cuda"]
    assert out["cuda"][3] and all(p == ["cuda"] for p in out["cuda"][3])


@pytest.mark.parametrize("batch,kernel,launches", [
    ("", "limb_sums", 2), ("SET segmentBatch = false; ", "fused_limb_sums", 4)])
def test_cluster_mse_leaf_launches_the_kernels(cuda, cluster_segments, batch,
                                               kernel, launches):
    """q2 under SET useMultistageEngine = true through the broker: the
    leaf's partial aggregate is each server's family dispatch (kernel A
    once a server), or one kernel B launch a segment, with the CPU
    cluster's rows."""
    sql = (batch + "SET useMultistageEngine = true; SELECT d_year, p_brand, "
           "SUM(lo_revenue) FROM ssb WHERE s_region = 'ASIA' "
           "GROUP BY d_year, p_brand LIMIT 10000")
    schema, paths = cluster_segments
    out = {}
    for device in ("cpu", "cuda"):
        servers, broker = _cluster(schema, paths, device)
        try:
            _cuda.reset_launches()
            resp = broker.execute_sql(sql)
            torch.cuda.synchronize()
            assert not resp.exceptions, resp.exceptions
            out[device] = (sorted(map(tuple, resp.result_table.rows)),
                           dict(_cuda.LAUNCHES))
        finally:
            for s in servers:
                s.stop()
            broker.close()
    assert out["cuda"][0] == out["cpu"][0]
    assert out["cuda"][1][kernel] == launches


def test_doctor_classifies_the_card_ok(cuda):
    from pinot_tpu_torch.tools import doctor

    report = doctor.run_probe(timeout_s=600)
    assert report["classification"] == "ok", report["stderrTail"]
    assert report["device"]["capability"] == [9, 0]
    assert report["device"]["maxAbsErr"] == 0


@pytest.mark.parametrize("batch,launches", [
    (True, [{"limb_sums": 1, "fused_limb_sums": 0}] * 2),
    (False, [{"limb_sums": 3, "fused_limb_sums": 0},
             {"limb_sums": 0, "fused_limb_sums": 3}])])
def test_compressed_schema_evolved_family_on_the_card(cuda, tmp_path, batch,
                                                      launches):
    """Three segments with LZ4 / SNAPPY raw planes and a GZIP dictionary
    key, registered under a schema that adds a column: kernel A over the
    family on their decompressed planes and virtual columns; with SET
    segmentBatch = false kernel A a segment where a virtual column is
    summed, kernel B a segment where only raw planes are; rows equal to
    the CPU's."""
    rng = np.random.default_rng(16)
    schema = Schema.build("cz", dimensions=[("d_year", "INT"),
                                            ("p_brand", "INT"),
                                            ("s_region", "STRING")],
                          metrics=[("lo_revenue", "INT"), ("lo_tax", "INT")])
    built = Schema.build("cz", dimensions=[("d_year", "INT"),
                                           ("p_brand", "INT"),
                                           ("s_region", "STRING")],
                         metrics=[("lo_revenue", "INT")])
    cfg = TableConfig(table_name="cz", indexing=IndexingConfig(
        no_dictionary_columns=["lo_revenue"], compression_configs={
            "lo_revenue": "LZ4", "p_brand": "GZIP", "d_year": "SNAPPY"}))
    regions = np.asarray(["AMERICA", "ASIA", "EUROPE"], dtype=object)
    paths = []
    for i in range(3):
        n = 1 << 16
        SegmentBuilder(built, cfg, f"cz{i}").build({
            "d_year": rng.integers(1992, 1999, n).astype(np.int32),
            "p_brand": rng.integers(0, 300, n).astype(np.int32),
            "s_region": regions[rng.integers(0, 3, n)],
            "lo_revenue": rng.integers(1, 600_000, n).astype(np.int32)},
            tmp_path / f"cz{i}")
        paths.append(tmp_path / f"cz{i}")
    prefix = "" if batch else "SET segmentBatch = false; "
    sqls = [prefix + "SELECT d_year, p_brand, SUM(lo_revenue), SUM(lo_tax) "
            "FROM cz WHERE s_region = 'ASIA' GROUP BY d_year, p_brand "
            "LIMIT 10000",
            prefix + "SELECT d_year, SUM(lo_revenue), COUNT(*) FROM cz "
            "GROUP BY d_year"]
    rows = {}
    for device in ("cpu", cuda):
        qe = QueryExecutor(device=device)
        qe.add_table(schema, [load_segment(p) for p in paths])
        for sql, want in zip(sqls, launches):
            before = dict(_cuda.LAUNCHES)
            resp = qe.execute_sql(sql)
            if device != "cpu":
                torch.cuda.synchronize()
                assert {k: _cuda.LAUNCHES[k] - before[k] for k in want} \
                    == want
            rows.setdefault(sql, []).append(sorted(map(tuple,
                                                       resp.result_table.rows)))
    for sql, (cpu_rows, card_rows) in rows.items():
        assert cpu_rows == card_rows and cpu_rows, sql


# -- the flight recorder and the AOT family cache on the card -----------------

_FR_FAMILY = ("SELECT d_year, p_brand, SUM(lo_revenue) FROM ssb "
              "WHERE s_region = 'ASIA' GROUP BY d_year, p_brand LIMIT 10000")
_FR_SOLO = "SET segmentBatch = false; " + _FR_FAMILY


def _fresh_families():
    from pinot_tpu_torch.engine import aot_cache, executor
    from pinot_tpu_torch.engine.compile_registry import COMPILE_REGISTRY

    aot_cache.reset()
    executor._FAMILIES.clear()
    COMPILE_REGISTRY.reset()


def test_sampled_family_query_on_the_card_retains_both_servers(
        cuda, cluster_segments, monkeypatch):
    """Head sampling on a 2-server card cluster: q2_family (kernel A on
    each server's family) is retained with the broker's and both servers'
    spans, and the registry counts one dispatch per launch of kernel A."""
    from pinot_tpu_torch.engine.compile_registry import COMPILE_REGISTRY
    from pinot_tpu_torch.spi.traceexport import to_chrome_trace

    monkeypatch.setenv("PINOT_TPU_TRACE_SAMPLE", "1.0")
    schema, paths = cluster_segments
    servers, broker = _cluster(schema, paths, cuda)
    broker.query_logger.slow_threshold_ms = 60_000.0
    try:
        _fresh_families()
        _cuda.reset_launches()
        resp = broker.execute_sql(_FR_FAMILY)
        torch.cuda.synchronize()
        assert not resp.exceptions and resp.trace_info is None
        ent = broker.trace_store.get(resp.query_id)
        assert ent["reason"] == "sampled"
        assert {s.get("server") for s in ent["spans"]} >= {"Server_0",
                                                           "Server_1"}
        assert to_chrome_trace(ent["spans"], resp.query_id)["traceEvents"]
        snap = COMPILE_REGISTRY.snapshot()
        assert snap["totalDispatches"] == resp.num_device_dispatches \
            == _cuda.LAUNCHES["limb_sums"] == 2
        assert snap["totalCompiles"] == 0
        assert all(e["compileMsLast"] > 0 for e in snap["compiles"])
    finally:
        for s in servers:
            s.stop()
        broker.close()


def test_prewarm_on_the_card_launches_both_kernels_once(
        cuda, cluster_segments, tmp_path, monkeypatch):
    """A card executor persists q2_family's family (kernel A) and q2's
    (kernel B, one family for the four equal segments); after a restart
    the prewarm launches each kernel once on the card, each launch
    element-equal to its plain version on the same inputs, and the next
    queries count aotCacheHits."""
    import pickle

    from pinot_tpu_torch.engine import aot_cache
    from pinot_tpu_torch.spi.metrics import SERVER_METRICS

    monkeypatch.setenv("PINOT_TPU_AOT_CACHE_DIR", str(tmp_path / "aot"))
    schema, paths = cluster_segments
    _fresh_families()
    qe = QueryExecutor(device=cuda)
    qe.add_table(schema, [load_segment(p) for p in paths])
    rows = {sql: qe.execute_sql(sql).result_table.rows
            for sql in (_FR_FAMILY, _FR_SOLO)}
    torch.cuda.synchronize()
    _fresh_families()
    _cuda.reset_launches()
    got = aot_cache.prewarm_table("ssb", device=cuda)
    assert got["loaded"] == 2 and got["refused"] == 0
    assert dict(_cuda.LAUNCHES) == {"limb_sums": 1, "fused_limb_sums": 1}
    plain = {"limb_sums": mxu_groupby.limb_sums_plain,
             "fused_limb_sums": fused_groupby.fused_limb_sums_plain}
    for name in sorted(os.listdir(tmp_path / "aot")):
        if not name.endswith(".aot"):
            continue
        blob = pickle.loads((tmp_path / "aot" / name).read_bytes())
        assert blob["envTag"] == aot_cache.env_tag(cuda)
        launches = pickle.loads(blob["payload"])["launches"]
        for fn, args, out in aot_cache.replay(launches, cuda):
            assert torch.equal(out, plain[fn](*args)), fn
    hits = SERVER_METRICS.snapshot()["meters"].get("aotCacheHits", 0)
    for sql, want in rows.items():
        assert qe.execute_sql(sql).result_table.rows == want
    assert SERVER_METRICS.snapshot()["meters"]["aotCacheHits"] == hits + 5
    _fresh_families()


# -- tiered storage on the card ------------------------------------------------

_TIER_FAMILY = ("SELECT d_year, p_brand, SUM(lo_revenue) FROM ssb "
                "WHERE s_region = 'ASIA' GROUP BY d_year, p_brand LIMIT 10000")


def _tarred(paths, root) -> tuple:
    """Each segment directory as a tarball: (tars, the largest directory's
    bytes, the tier's measure of a segment)."""
    import tarfile
    from pathlib import Path

    tars, biggest = [], 0
    for p in paths:
        tar = Path(root) / f"{Path(p).name}.tar.gz"
        with tarfile.open(tar, "w:gz", compresslevel=1) as tf:
            tf.add(p, arcname=Path(p).name)
        tars.append(str(tar))
        biggest = max(biggest, sum(
            os.path.getsize(os.path.join(r, f))
            for r, _, fs in os.walk(p) for f in fs))
    return tars, biggest


def _tiered_server(schema, tars, biggest, device, per_server=2):
    """One server over `tars` whose tier holds `per_server - 1` segments:
    the first loads, the rest register cold (metadata only)."""
    from pinot_tpu_torch.cluster import (Broker, ClusterController,
                                         PropertyStore, ServerInstance)

    store = PropertyStore()
    ctl = ClusterController(store)
    server = ServerInstance(store, "Server_0", device=device,
                            local_storage_mb=biggest * (per_server - 1)
                            / (1 << 20))
    server.start()
    ctl.add_schema(schema.to_json())
    table = ctl.create_table({"tableName": "ssb", "replication": 1})
    for i, tar in enumerate(tars[:per_server]):
        ctl.add_segment(table, f"ssb_{i}", {"location": tar,
                                            "numDocs": 40_000})
    return server, Broker(store)


def test_warmed_cold_segment_family_on_the_card_equals_plain(
        cuda, cluster_segments, tmp_path):
    """A card server holds one of its two segments and registers the
    other cold: q2_family warms the cold one and launches kernel A once
    over the family of both, element-equal to the plain version on the
    same planes, with the rows of the same query on the CPU."""
    schema, paths = cluster_segments
    tars, biggest = _tarred(paths, tmp_path)
    want = None
    for device in ("cpu", "cuda"):
        server, broker = _tiered_server(schema, tars, biggest, device)
        try:
            cold = server.debug_storage()["tables"]["ssb_OFFLINE"]["cold"]
            assert len(cold) == 1
            calls = []
            orig = mxu_groupby.limb_sums

            def rec(*args, **kw):
                calls.append(args)
                return orig(*args, **kw)

            mxu_groupby.limb_sums = rec
            _cuda.reset_launches()
            try:
                resp = broker.execute_sql(_TIER_FAMILY)
            finally:
                mxu_groupby.limb_sums = orig
            assert not resp.exceptions and not resp.partial_result
            rows = sorted(map(tuple, resp.result_table.rows))
            if device == "cpu":
                want = rows
                continue
            torch.cuda.synchronize()
            assert rows == want
            assert _cuda.LAUNCHES["limb_sums"] == 1 and len(calls) == 1
            planes, gid, g = calls[0]
            assert planes.device.type == "cuda" and planes.shape[0] == 2
            assert torch.equal(mxu_groupby.limb_sums(planes, gid, g),
                               mxu_groupby.limb_sums_plain(planes, gid, g))
        finally:
            server.stop()
            broker.close()


def test_evicted_planes_leave_the_card_and_upload_fresh(
        cuda, cluster_segments, tmp_path):
    """Demoting a segment to cold frees its planes and family stacks on
    the card (allocated bytes fall by at least its plane bytes); fetched
    again, it uploads fresh planes (a new view) and kernel A over them
    equals the plain version, with the same rows."""
    schema, paths = cluster_segments
    tars, biggest = _tarred(paths, tmp_path)
    server, broker = _tiered_server(schema, tars, biggest, "cuda",
                                    per_server=3)
    try:
        cache = server.executor.executor.cache
        first = broker.execute_sql(_TIER_FAMILY)
        assert not first.exceptions
        torch.cuda.synchronize()
        names = {v.segment.name: v for v in cache._views.values()}
        victim = sorted(names)[0]
        old_view = names[victim]
        plane_bytes = old_view.nbytes()
        assert plane_bytes > 0
        before = torch.cuda.memory_allocated()
        server._tier.budget_bytes = 0  # every unpinned copy must go
        server._tier._make_room()
        server._tier.budget_bytes = int(biggest * 3)
        gc.collect()
        torch.cuda.synchronize()
        assert victim not in cache.segment_names()
        assert before - torch.cuda.memory_allocated() >= plane_bytes
        calls = []
        orig = mxu_groupby.limb_sums

        def rec(*args, **kw):
            calls.append(args)
            return orig(*args, **kw)

        mxu_groupby.limb_sums = rec
        try:
            again = broker.execute_sql(_TIER_FAMILY)
        finally:
            mxu_groupby.limb_sums = orig
        torch.cuda.synchronize()
        assert not again.exceptions
        assert sorted(map(tuple, again.result_table.rows)) == \
            sorted(map(tuple, first.result_table.rows))
        fresh = [v for v in cache._views.values()
                 if v.segment.name == victim]
        assert fresh and fresh[0] is not old_view
        for planes, gid, g in calls:
            assert torch.equal(mxu_groupby.limb_sums(planes, gid, g),
                               mxu_groupby.limb_sums_plain(planes, gid, g))
    finally:
        server.stop()
        broker.close()


def test_eviction_racing_dispatches_leaves_every_launch_exact(
        cuda, cluster_segments, tmp_path):
    """Queries on the card while another thread keeps demoting and
    fetching the same segments again: every answer is the first one's
    rows, and every recorded launch of kernel A equals its plain version
    on the planes it was given."""
    import threading

    schema, paths = cluster_segments
    tars, biggest = _tarred(paths, tmp_path)
    server, broker = _tiered_server(schema, tars, biggest, "cuda",
                                    per_server=3)
    try:
        want = sorted(map(tuple, broker.execute_sql(
            _TIER_FAMILY).result_table.rows))
        stop = threading.Event()
        errors = []

        def churn():
            tier = server._tier
            while not stop.is_set():
                budget = tier.budget_bytes
                tier.budget_bytes = 0
                tier._make_room()
                tier.budget_bytes = budget

        calls = []
        orig = mxu_groupby.limb_sums

        def rec(*args, **kw):
            out = orig(*args, **kw)
            calls.append((args, out.clone()))
            return out

        mxu_groupby.limb_sums = rec
        t = threading.Thread(target=churn)
        t.start()
        try:
            for _ in range(6):
                resp = broker.execute_sql(
                    "SET allowPartialResults = true; " + _TIER_FAMILY)
                if resp.partial_result:
                    continue  # a segment caught cold: flagged, not wrong
                if sorted(map(tuple, resp.result_table.rows)) != want:
                    errors.append(resp.exceptions)
        finally:
            stop.set()
            t.join(60.0)
            mxu_groupby.limb_sums = orig
        torch.cuda.synchronize()
        assert not errors
        assert calls
        for (planes, gid, g), out in calls:
            assert torch.equal(out, mxu_groupby.limb_sums_plain(
                planes, gid, g))
    finally:
        server.stop()
        broker.close()


def _renamed_copy(path, root, name) -> str:
    """A copy of a segment directory under another segment name: the same
    rows and data bytes (the crc covers the data alone)."""
    import json
    import shutil
    from pathlib import Path

    dst = Path(root) / name
    shutil.copytree(path, dst)
    meta = json.loads((dst / "metadata.json").read_text())
    meta["segmentName"] = name
    (dst / "metadata.json").write_text(json.dumps(meta))
    return str(dst)


def _ops_cluster(schema, paths, device, n_servers=2):
    from pinot_tpu_torch.cluster import (Broker, ClusterController,
                                         PropertyStore, ServerInstance)

    store = PropertyStore()
    ctl = ClusterController(store)
    servers = [ServerInstance(store, f"Server_{i}", device=device)
               for i in range(n_servers)]
    for s in servers:
        s.start()
    ctl.add_schema(schema.to_json())
    table = ctl.create_table({"tableName": "ssb", "replication": 1})
    for i, path in enumerate(paths):
        ctl.add_segment(table, f"ssb_{i}", {"location": path,
                                            "numDocs": 40_000})
    return store, ctl, servers, Broker(store)


OPS_SQL = ("SELECT d_year, p_brand, SUM(lo_revenue) FROM ssb WHERE "
           "s_region = 'ASIA' GROUP BY d_year, p_brand LIMIT 10000")


def _cpu_rows(schema, paths):
    store, ctl, servers, broker = _ops_cluster(schema, paths, "cpu")
    try:
        return sorted(map(tuple, broker.execute_sql(OPS_SQL)
                          .result_table.rows))
    finally:
        for s in servers:
            s.stop()
        broker.close()


def _launches_equal_plain(calls) -> None:
    for planes, gid, G in calls:
        assert torch.equal(mxu_groupby.limb_sums(planes, gid, G),
                           mxu_groupby.limb_sums_plain(planes, gid, G))


class _recording:
    """Record a kernel wrapper's inputs while active (the calls go
    through)."""

    def __init__(self, owner, name):
        self.owner, self.name = owner, name

    def __enter__(self):
        self.orig = getattr(self.owner, self.name)
        self.calls = []

        def wrapper(*args, **kwargs):
            self.calls.append(args)
            return self.orig(*args, **kwargs)

        setattr(self.owner, self.name, wrapper)
        return self.calls

    def __exit__(self, *exc):
        setattr(self.owner, self.name, self.orig)


def test_rebalance_move_on_the_card_frees_the_source(cuda, cluster_segments):
    """A third card server joins; a rebalance moves a segment onto it,
    then a drain of Server_0 moves Server_0's segments onto the other two.
    The next q2_family launches kernel A once over each remaining
    server's family of 2 (the destination's included), each launch
    element-equal to its plain version, with the CPU cluster's rows; the
    drained server's device cache lets every moved segment go."""
    from pinot_tpu_torch.cluster import ServerInstance
    from pinot_tpu_torch.cluster.rebalance import SegmentRebalancer

    schema, paths = cluster_segments
    want = _cpu_rows(schema, paths)
    store, ctl, servers, broker = _ops_cluster(schema, paths, "cuda")
    try:
        assert sorted(map(tuple, broker.execute_sql(OPS_SQL)
                          .result_table.rows)) == want
        torch.cuda.synchronize()
        src = servers[0].executor.executor.cache
        held = src.bytes_used()
        dst = ServerInstance(store, "Server_2", device="cuda")
        dst.start()
        servers.append(dst)
        rb = SegmentRebalancer(ctl, move_timeout_s=30.0)
        assert rb.run("ssb_OFFLINE", timeout_s=60.0)["status"] == "DONE"
        rb.plan("ssb_OFFLINE", trigger="health",
                exclude=frozenset({"Server_0"}))
        job = rb.drive("ssb_OFFLINE", timeout_s=60.0)
        assert job["status"] == "DONE"
        _cuda.reset_launches()
        with _recording(mxu_groupby, "limb_sums") as calls:
            resp = broker.execute_sql(OPS_SQL)
            torch.cuda.synchronize()
        assert sorted(map(tuple, resp.result_table.rows)) == want
        assert _cuda.LAUNCHES["limb_sums"] == 2 == len(calls)
        assert all(planes.shape[0] == 2 for planes, _, _ in calls)
        _launches_equal_plain(calls)
        assert len(dst.executor.executor.cache.segment_names()) == 2
        gc.collect()
        assert not src.segment_names() and src.bytes_used() < held
    finally:
        for s in servers:
            s.stop()
        broker.close()


def test_lineage_swap_on_the_card_counts_rows_once(cuda, cluster_segments,
                                                   tmp_path):
    """A renamed copy of ssb_0 replaces it through the lineage protocol:
    in progress and after the swap q2_family answers the CPU cluster's
    rows (the replaced rows counted once), each launch of kernel A equal
    to its plain version; the old segment's planes leave its server."""
    from pinot_tpu_torch.cluster.periodic import SegmentLineageManager

    schema, paths = cluster_segments
    want = _cpu_rows(schema, paths)
    copy = _renamed_copy(paths[0], tmp_path, "ssb_0r")
    store, ctl, servers, broker = _ops_cluster(schema, paths, "cuda")
    try:
        broker.execute_sql(OPS_SQL)
        owner = next(s for s in servers
                     if "ssb_0" in s.executor.executor.cache.segment_names())
        lineage = SegmentLineageManager(store, ctl)
        lid = lineage.start_replace("ssb_OFFLINE", ["ssb_0"], ["ssb_0r"])
        ctl.add_segment("ssb_OFFLINE", "ssb_0r", {"location": copy,
                                                  "numDocs": 40_000})
        for step in ("in progress", "completed"):
            if step == "completed":
                lineage.end_replace("ssb_OFFLINE", lid)
            _cuda.reset_launches()
            with _recording(mxu_groupby, "limb_sums") as calls:
                resp = broker.execute_sql(OPS_SQL)
                torch.cuda.synchronize()
            assert sorted(map(tuple, resp.result_table.rows)) == want, step
            assert resp.total_docs == 4 * 40_000, step
            assert _cuda.LAUNCHES["limb_sums"] == len(calls) >= 2, step
            _launches_equal_plain(calls)
        gc.collect()
        assert "ssb_0" not in owner.executor.executor.cache.segment_names()
        assert store.get("/LINEAGE/ssb_OFFLINE") == {}
    finally:
        for s in servers:
            s.stop()
        broker.close()


# -- the offline data path on the card -----------------------------------------

_BATCH_DIMS = [("d_year", "INT"), ("p_brand", "INT"), ("s_region", "STRING")]
_BATCH_METRICS = [("lo_revenue", "INT")]
_BATCH_FAMILY = ("SELECT d_year, p_brand, SUM(lo_revenue) FROM batch "
                 "WHERE s_region = 'ASIA' GROUP BY d_year, p_brand "
                 "LIMIT 10000")


def _mem_s3():
    """chip_smoke.py's in-memory object store with the boto3 client surface
    S3PinotFS uses."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_s3", Path(__file__).resolve().parent.parent
        / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.MemS3Client()


@pytest.fixture(scope="module")
def batch_tarballs(tmp_path_factory):
    """A batch job's tarred segments, one a file: gzipped CSV, JSON lines,
    Avro (deflate) and Thrift of the same columns, 20,000 rows each."""
    import csv
    import gzip
    import json

    from pinot_tpu_torch.ingestion.batch import (IngestionJobLauncher,
                                                 SegmentGenerationJobSpec)
    from pinot_tpu_torch.plugins.inputformat import avro, thrift

    root = tmp_path_factory.mktemp("torch_cuda_batch")
    ind = root / "in"
    ind.mkdir()
    rng = np.random.default_rng(20)
    names = [c for c, _ in _BATCH_DIMS + _BATCH_METRICS]
    regions = ["AMERICA", "ASIA", "EUROPE"]
    parts = []
    for _ in range(4):
        n = 20_000
        parts.append([{"d_year": int(y), "p_brand": int(b),
                       "s_region": regions[int(r)], "lo_revenue": int(v)}
                      for y, b, r, v in zip(
                          rng.integers(1992, 1999, n),
                          rng.integers(0, 1000, n), rng.integers(0, 3, n),
                          rng.integers(1, 600_000, n))])
    with gzip.open(ind / "part_0.csv.gz", "wt", newline="") as f:
        w = csv.DictWriter(f, fieldnames=names)
        w.writeheader()
        w.writerows(parts[0])
    (ind / "part_1.json").write_text("\n".join(map(json.dumps, parts[1])))
    with open(ind / "part_2.avro", "wb") as f:
        avro.write_avro_file(f, {"type": "record", "name": "lineorder",
                                 "fields": [{"name": c, "type": "string"
                                             if c == "s_region" else "int"}
                                            for c in names]},
                             parts[2], codec="deflate")
    buf = bytearray()
    for row in parts[3]:
        thrift.write_struct(buf, {i + 1: row[c] for i, c in enumerate(names)})
    (ind / "part_3.thrift").write_bytes(bytes(buf))
    schema = Schema.build("batch", dimensions=_BATCH_DIMS,
                          metrics=_BATCH_METRICS)
    cfg = TableConfig(table_name="batch", indexing=IndexingConfig(
        no_dictionary_columns=["lo_revenue"]))
    spec = SegmentGenerationJobSpec(
        input_dir_uri=f"file://{ind}", output_dir_uri=f"file://{root}/deep",
        schema=schema, table_config=cfg, create_tar=True,
        record_reader_config={"fieldIdToName": {
            str(i + 1): c for i, c in enumerate(names)}})
    results = IngestionJobLauncher(spec).run()
    assert [r.num_docs for r in results] == [20_000] * 4
    return schema, results


def _batch_cluster(schema, results, device, client):
    """Two servers on `device` loading the job's tarballs: three through
    their file:// URIs, the last through the s3:// store over `client`."""
    import dataclasses

    from pinot_tpu_torch.cluster import (Broker, ClusterController,
                                         PropertyStore, ServerInstance)
    from pinot_tpu_torch.ingestion.batch import push_segments_to_cluster
    from pinot_tpu_torch.plugins.filesystem.s3 import S3PinotFS

    last = results[-1]
    uri = f"s3://deep/batch/{last.segment_name}.tar.gz"
    S3PinotFS(client=client).copy_from_local(
        last.output_uri[len("file://"):], uri)
    store = PropertyStore()
    ctl = ClusterController(store)
    servers = [ServerInstance(store, f"Server_{i}", device=device)
               for i in range(2)]
    for s in servers:
        s.start()
    ctl.add_schema(schema.to_json())
    table = ctl.create_table({"tableName": "batch", "replication": 1})
    push_segments_to_cluster(
        results[:-1] + [dataclasses.replace(last, output_uri=uri)], ctl,
        table)
    return servers, Broker(store)


@pytest.mark.parametrize("sql,kernel,launches", [
    ("SET segmentBatch = false; " + _BATCH_FAMILY, "fused_limb_sums", 4),
    (_BATCH_FAMILY, "limb_sums", 2),
])
def test_batch_pushed_segments_on_the_card_equal_plain(
        cuda, batch_tarballs, monkeypatch, sql, kernel, launches):
    """The batch job's segments, tar-pushed through file:// and through an
    in-memory s3:// store, load on two card servers: q2 launches kernel B
    a segment, q2_family kernel A once over each server's family of 2,
    every launch element-equal to its plain version, with the rows of two
    CPU servers over the same tarballs."""
    from pinot_tpu_torch.plugins.filesystem.s3 import S3PinotFS
    from pinot_tpu_torch.spi import filesystem

    schema, results = batch_tarballs
    owner = fused_groupby if kernel == "fused_limb_sums" else mxu_groupby
    plain = getattr(owner, kernel + "_plain")
    client = _mem_s3()
    monkeypatch.setitem(filesystem._FS_REGISTRY, "s3",
                        lambda: S3PinotFS(client=client))
    rows = {}
    for device in ("cpu", "cuda"):
        servers, broker = _batch_cluster(schema, results, device, client)
        try:
            t0 = time.monotonic()
            while len(broker.routing_table("batch_OFFLINE")) < 4:
                assert time.monotonic() - t0 < 60.0, "segments not ONLINE"
                time.sleep(0.05)
            _cuda.reset_launches()
            with _recording(owner, kernel) as calls:
                resp = broker.execute_sql(sql)
                if device == "cuda":
                    torch.cuda.synchronize()
            assert not resp.exceptions, resp.exceptions
            rows[device] = sorted(map(tuple, resp.result_table.rows))
            if device == "cuda":
                assert _cuda.LAUNCHES[kernel] == launches == len(calls)
                for args in calls:
                    assert torch.equal(getattr(owner, kernel)(*args),
                                       plain(*args))
        finally:
            for s in servers:
                s.stop()
            broker.close()
    assert rows["cuda"] == rows["cpu"] and rows["cpu"]


# -- timeseries, minion ---------------------------------------------------------


@pytest.fixture(scope="module")
def time_segments(tmp_path_factory):
    """Four segments of a day-resolution dictionary-encoded TIMESTAMP over
    1992-1998 beside q2's columns."""
    rng = np.random.default_rng(41)
    n = 40_000
    schema = Schema.build("tst", dimensions=[
        ("s_region", "STRING"), ("lo_orderdate", "TIMESTAMP")],
        metrics=[("lo_revenue", "INT"), ("lo_quantity", "INT")])
    cfg = TableConfig(table_name="tst", indexing=IndexingConfig(
        no_dictionary_columns=["lo_revenue", "lo_quantity"]))
    root = tmp_path_factory.mktemp("torch_cuda_ts")
    paths = []
    for i in range(4):
        cols = {"s_region": np.asarray(["AMERICA", "ASIA", "EUROPE", "AFRICA",
                                        "MIDDLE EAST"], dtype=object)[
                    rng.integers(0, 5, n)],
                "lo_orderdate": rng.integers(8035, 10592, n).astype(np.int64)
                * 86_400_000,
                "lo_revenue": rng.integers(1, 600_000, n).astype(np.int32),
                "lo_quantity": rng.integers(1, 51, n).astype(np.int32)}
        SegmentBuilder(schema, cfg, f"tst_{i}").build(cols, root / f"tst_{i}")
        paths.append(str(root / f"tst_{i}"))
    return schema, paths


def test_timeseries_fetch_on_the_card_equals_cpu(cuda, time_segments):
    """A weekly fetch by region (a GROUP BY of the bucket transform over
    the dictionary and the tag, G >= 281) launches kernel A once over the
    family of 4 on the card, every pipe stage after it on the host; the
    block equals the CPU executor's."""
    from pinot_tpu_torch.timeseries import TimeSeriesEngine

    schema, paths = time_segments
    week = 604_800_000
    start = 694_224_000_000 // week * week
    query = ("fetch table=tst value=lo_revenue time_col=lo_orderdate "
             "filter=\"lo_quantity < 25\" | sum s_region | moving_avg 4 "
             "| topk 3")
    blocks = {}
    for device in ("cpu", "cuda"):
        qe = QueryExecutor(device=device)
        qe.add_table(schema, [load_segment(p) for p in paths])
        _cuda.reset_launches()
        with _recording(mxu_groupby, "limb_sums") as calls:
            blocks[device] = TimeSeriesEngine(qe).execute(
                query, start, 915_148_800_000, week)
        if device == "cuda":
            torch.cuda.synchronize()
            assert _cuda.LAUNCHES["limb_sums"] == 1 == len(calls)
            assert calls[0][2] >= 281
            _launches_equal_plain(calls)
    assert blocks["cuda"].to_json() == blocks["cpu"].to_json()
    assert len(blocks["cuda"].series) == 3


def test_merged_segment_on_the_card(cuda, cluster_segments, tmp_path):
    """A MergeRollupTask (concat) replaces the four segments with one
    through lineage; the card server loads it and answers q2_family with
    the rows of a CPU cluster over the inputs, in one launch of a kernel
    element-equal to its plain version."""
    from pinot_tpu_torch.minion import MinionInstance, PinotTaskManager

    schema, paths = cluster_segments
    want = _cpu_rows(schema, paths)
    store, ctl, servers, broker = _ops_cluster(schema, paths, "cuda")
    try:
        table = "ssb_OFFLINE"
        cfg = ctl.table_config(table)
        cfg["taskConfigs"] = {"MergeRollupTask": {"mergeType": "concat"}}
        store.set(f"/CONFIGS/TABLE/{table}", cfg)
        ids = PinotTaskManager(store, ctl).schedule_tasks(table=table)
        minion = MinionInstance(store, "Minion_0", ctl, str(tmp_path / "m"),
                                device="cuda")
        assert minion.run_pending_once() == 1
        state = store.get(f"/TASKS/MergeRollupTask/{ids[0]}")
        assert state["state"] == "COMPLETED", state
        assert store.children(f"/SEGMENTS/{table}") == \
            [state["output"]["outputSegment"]]
        _cuda.reset_launches()
        with _recording(mxu_groupby, "limb_sums") as a_calls, \
                _recording(fused_groupby, "fused_limb_sums") as b_calls:
            resp = broker.execute_sql(OPS_SQL)
            torch.cuda.synchronize()
        assert sorted(map(tuple, resp.result_table.rows)) == want
        assert sum(_cuda.LAUNCHES.values()) == 1
        _launches_equal_plain(a_calls)
        for args in b_calls:
            assert torch.equal(fused_groupby.fused_limb_sums(*args),
                               fused_groupby.fused_limb_sums_plain(*args))
    finally:
        for s in servers:
            s.stop()
        broker.close()


@pytest.mark.parametrize("flt", [
    "s_region = 'ASIA' AND d_year > 1995",
    "p_brand BETWEEN 10 AND 20 OR lo_revenue < 5000",
    "NOT (d_year < 1998)"])
def test_purge_mask_on_the_card_equals_cpu(cuda, cluster_segments, flt):
    from pinot_tpu_torch.minion.tasks import purge_mask
    from pinot_tpu_torch.query.parser.sql import parse_filter_expression

    _, paths = cluster_segments
    seg = load_segment(paths[0])
    got = purge_mask(seg, parse_filter_expression(flt), "cuda")
    want = purge_mask(seg, parse_filter_expression(flt), "cpu")
    assert np.array_equal(got, want) and 0 < want.sum() < len(want)


# -- the host engine beside the card (backend "auto") -------------------------

AUTO_SQL = [
    # the consuming snapshot's raw DOUBLE has no rebased plane: the
    # snapshot answers on the host engine, the committed family on the card
    "SELECT s_region, PERCENTILETDIGEST(fare, 90), COUNT(*) FROM rt "
    "GROUP BY s_region ORDER BY s_region",
    "SELECT s_region, SUM(lo_revenue), COUNT(*) FROM rt "
    "WHERE ST_DISTANCE(lat, lng, 40.0, -100.0) < 900000 "
    "GROUP BY s_region ORDER BY s_region",
    "SELECT s_region, SUM(lo_revenue), MAX(fare) FROM rt "
    "WHERE s_region IN ('ASIA', 'EUROPE') GROUP BY s_region "
    "ORDER BY s_region",
]


@pytest.fixture(scope="module")
def auto_table(tmp_path_factory):
    dims = [("s_region", "STRING")]
    mets = [("lo_revenue", "INT"), ("fare", "DOUBLE"), ("lat", "DOUBLE"),
            ("lng", "DOUBLE")]
    schema = Schema.build("rt", dimensions=dims, metrics=mets)
    rng = np.random.default_rng(4242)
    root = tmp_path_factory.mktemp("torch_cuda_auto")
    cfg = TableConfig(table_name="rt", indexing=IndexingConfig(
        no_dictionary_columns=["lo_revenue", "fare", "lat", "lng"],
        inverted_index_columns=["s_region"],
        geo_index_configs=[{"latColumn": "lat", "lngColumn": "lng"}]))
    regions = np.asarray(["AFRICA", "AMERICA", "ASIA", "EUROPE"],
                         dtype=object)

    def cols(n):
        return {"s_region": regions[rng.integers(0, 4, n)],
                "lo_revenue": rng.integers(0, 9000, n).astype(np.int32),
                "fare": np.round(rng.gamma(3.0, 9.0, n), 2),
                "lat": rng.uniform(25.0, 49.0, n),
                "lng": rng.uniform(-124.0, -67.0, n)}
    paths = []
    for i in range(2):
        SegmentBuilder(schema, cfg, f"c{i}").build(cols(1 << 18),
                                                   root / f"c{i}")
        paths.append(root / f"c{i}")
    live_cols = cols(5000)
    rows = [{k: (v[j].item() if hasattr(v[j], "item") else v[j])
             for k, v in live_cols.items()} for j in range(5000)]
    return schema, paths, rows


@pytest.mark.parametrize("sql", AUTO_SQL)
def test_auto_mixed_query_on_the_card_equals_the_cpu(cuda, auto_table, sql):
    """Under backend "auto" the committed family dispatches on the card,
    the segments the planner refuses answer on the host engine in the
    same query; rows, docs scanned and dispatches equal the CPU run's, and
    every launch of kernel A equals its plain version."""
    from pinot_tpu_torch.segment.mutable import MutableSegment

    schema, paths, rows = auto_table
    out = {}
    for device in ("cpu", "cuda"):
        live = MutableSegment(schema, "live")
        for r in rows:
            live.index(r)
        qe = QueryExecutor(device=device, backend="auto")
        qe.add_table(schema, [load_segment(p) for p in paths] + [live])
        _cuda.reset_launches()
        with _recording(mxu_groupby, "limb_sums") as a_calls:
            resp = qe.execute_sql(sql)
            if device == "cuda":
                torch.cuda.synchronize()
        out[device] = (resp, dict(_cuda.LAUNCHES), list(a_calls))
    (cpu, _, _), (card, launches, a_calls) = out["cpu"], out["cuda"]
    assert card.result_table.rows == cpu.result_table.rows
    assert card.num_docs_scanned == cpu.num_docs_scanned
    assert card.num_device_dispatches == cpu.num_device_dispatches
    assert launches["limb_sums"] == len(a_calls)
    if "ST_DISTANCE" in sql:  # every segment on the host engine
        assert card.num_device_dispatches == 0 and not a_calls
    else:
        assert card.num_device_dispatches >= 1 and a_calls
    _launches_equal_plain(a_calls)


def test_soak_sql_with_device_parity_on_the_card(cuda):
    """The soak's sql suite on the card: the host engine against sqlite,
    backend "auto" on the card against the host engine (soak_sql raises
    on any mismatch); every launch of kernels A and B that the parity
    side made equals its plain version."""
    from pinot_tpu_torch.tools import soak

    _cuda.reset_launches()
    with _recording(mxu_groupby, "limb_sums") as a_calls, \
            _recording(fused_groupby, "fused_limb_sums") as b_calls:
        out = soak.soak_sql(seconds=120.0, seed=23, rows=1 << 13,
                            device_parity=True, max_checks=40)
        torch.cuda.synchronize()
    assert out["checks"] >= 40 and out["device_dispatches"] > 0, out
    assert _cuda.LAUNCHES == {"limb_sums": len(a_calls),
                              "fused_limb_sums": len(b_calls)}
    _launches_equal_plain(a_calls)
    for fp, planes_in, scalars, G, n in b_calls:
        assert torch.equal(
            fused_groupby.fused_limb_sums(fp, planes_in, scalars, G, n),
            fused_groupby.fused_limb_sums_plain(fp, planes_in, scalars, G, n))


MESH_CUDA = ["cuda:0"] * 4


@pytest.fixture(scope="module")
def mesh_table(tmp_path_factory):
    """Six segments of the small table's shape (ragged over 4 devices)."""
    rng = np.random.default_rng(31)
    schema = Schema.build("ssb", dimensions=[
        ("d_year", "INT"), ("p_brand", "INT"), ("s_region", "STRING")],
        metrics=[("lo_revenue", "INT")])
    cfg = TableConfig(table_name="ssb", indexing=IndexingConfig(
        no_dictionary_columns=["lo_revenue"]))
    paths = []
    for i in range(6):
        n = 1 << 16
        cols = {"d_year": rng.integers(1992, 1999, n).astype(np.int32),
                "p_brand": rng.integers(0, 1000, n).astype(np.int32),
                "s_region": np.asarray(["AMERICA", "ASIA", "EUROPE"],
                                       dtype=object)[rng.integers(0, 3, n)],
                "lo_revenue": rng.integers(1, 600_000, n).astype(np.int32)}
        path = tmp_path_factory.mktemp("torch_cuda_mesh") / f"m{i}"
        SegmentBuilder(schema, cfg, f"m{i}").build(cols, path)
        paths.append(path)
    return schema, paths


MESH_Q2 = ("SELECT d_year, p_brand, SUM(lo_revenue) FROM ssb WHERE "
           "s_region = 'ASIA' GROUP BY d_year, p_brand LIMIT 10000")


def test_row_sharded_kernel_b_at_nonzero_offsets(cuda, mesh_table):
    """q2's plan over one segment row-sharded on cuda:0 four times: kernel
    B once a shard at row offsets 0, n/4, n/2, 3n/4, each launch equal to
    its plain version, the merged table equal to the solo fused run."""
    from pinot_tpu_torch.ops.kernels import run_program
    from pinot_tpu_torch.parallel import mesh as pmesh
    from pinot_tpu_torch.query.parser.sql import parse_sql

    schema, paths = mesh_table
    qe = QueryExecutor(device="cuda")
    seg = load_segment(paths[0])
    plan = qe.executor.plan(parse_sql(MESH_Q2), seg)
    view, arrays, params, packed, fused, lut_meta = \
        qe.executor.solo_inputs(seg, plan)
    assert fused
    solo = run_program(plan.program, arrays, params, seg.num_docs,
                       view.padded, packed=packed, fused=True,
                       fused_lut_meta=lut_meta)
    mesh = pmesh.make_mesh(devices=MESH_CUDA)
    _cuda.reset_launches()
    with _recording(fused_groupby, "fused_limb_sums") as b_calls:
        outs = pmesh.run_program_row_sharded(
            plan.program, pmesh.shard_segment_arrays(
                arrays, mesh, view.padded, plan.slots),
            params, seg.num_docs, view.padded, mesh, slots=plan.slots,
            fused=True, lut_meta=lut_meta, packed=packed)
        torch.cuda.synchronize()
    local = view.padded // 4
    assert _cuda.LAUNCHES["fused_limb_sums"] == 4 == len(b_calls)
    assert [int(c[2][1]) for c in b_calls] == [k * local for k in range(4)]
    for fp, planes_in, scalars, G, n in b_calls:
        assert n == local
        assert torch.equal(
            fused_groupby.fused_limb_sums(fp, planes_in, scalars, G, n),
            fused_groupby.fused_limb_sums_plain(fp, planes_in, scalars, G, n))
    for got, want in zip(outs, solo):
        assert torch.equal(got, want)


def test_dp4_family_on_the_card_equals_the_solo_pack(cuda, mesh_table):
    """Six segments split over dp = 4 on cuda:0: kernel A once a shard
    (each launch equal to its plain version), the packed buffer byte for
    byte the solo family's, and the query's rows the CPU's with one host
    fetch."""
    from pinot_tpu_torch.ops import kernels
    from pinot_tpu_torch.query.parser.sql import parse_sql

    schema, paths = mesh_table
    sql = "SET useFusedKernel = false; " + MESH_Q2
    gpu = QueryExecutor(device="cuda", mesh_devices=MESH_CUDA)
    cpu = QueryExecutor(device="cpu")
    for qe in (gpu, cpu):
        qe.add_table(schema, [load_segment(p) for p in paths])
    segs = gpu.tables["ssb"].segments
    plans = [gpu.executor.plan(parse_sql(sql), s) for s in segs]
    _cuda.reset_launches()
    with _recording(mxu_groupby, "limb_sums") as a_calls:
        sharded = gpu.executor.dispatch_plan_batch(segs, plans, mesh=(4,))
        torch.cuda.synchronize()
    assert _cuda.LAUNCHES["limb_sums"] == 4 == len(a_calls)
    assert [c[0].shape[0] for c in a_calls] == [2, 2, 2, 2]  # 6 + 2 pads
    _launches_equal_plain(a_calls)
    solo = gpu.executor.dispatch_plan_batch(segs, plans)
    assert sharded.metas == solo.metas
    assert torch.equal(sharded.flat, solo.flat)
    before = kernels.host_fetches()
    got = gpu.execute_sql(sql)
    assert kernels.host_fetches() - before == 1
    assert got.num_device_dispatches == 1
    assert got.result_table.rows == cpu.execute_sql(sql).result_table.rows
