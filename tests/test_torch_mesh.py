"""The port's mesh (pinot_tpu_torch/parallel/mesh.py) against the JAX
package's, on the CPU.

The JAX package runs its mesh over the 8 virtual XLA devices that
tests/conftest.py forces; the port's mesh here is the CPU device named 8
times (`["cpu"] * 8`), each shard its own run of the interpreter. The
same seeded segments (built once by the port's builder, which writes the
JAX builder's bytes) are loaded by both packages.

Row sharding (mirroring tests/test_parallel.py): `run_program_row_sharded`
on the JAX planner's planes, against the JAX `run_program_row_sharded` and
the port's solo `run_program`: dense group-by and ungrouped aggregations
with and without a filter, the distinct bitmap, the value histograms, the
selection mask, kernel B's plan at each shard's row offset, and the three
refusals (sparse group-by, adaptive histograms, MV group-by). Integer
outputs are element-equal; float64 SUMs of DOUBLE columns are within
rtol 1e-12 of the JAX row-sharded sums (the shards add in another
order); MIN and MAX are exact.

Segment sharding (mirroring tests/test_mesh_parity.py): batch families
through `QueryExecutor.execute_sql`, mesh-sharded against `SET
meshExecution = false`, the JAX package's mesh-sharded rows and sqlite:
dense and sparse (presorted and shuffled), ragged stacks (10 segments on
8 devices), the PINOT_TPU_MESH_DEVICES cap, a family below the shard
threshold, a 4-device mesh (the JAX test's fresh 4-device interpreter, in
process), one dispatch and one host fetch a sharded family, and a failed
sharded dispatch failing the query (no fallback to the solo family). The
batch-sharded pack is byte-equal to the port's solo pack.
"""

from __future__ import annotations

import sqlite3

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pinot_tpu.engine import ir as jir
from pinot_tpu.engine.plan import SegmentPlanner as JaxPlanner
from pinot_tpu.engine.query_executor import QueryExecutor as JaxQueryExecutor
from pinot_tpu.parallel import mesh as jmesh
from pinot_tpu.query.parser.sql import parse_sql as jax_parse
from pinot_tpu.segment.device_cache import SegmentDeviceView as JaxView
from pinot_tpu.segment.loader import load_segment as jax_load
from pinot_tpu_torch.engine import ir
from pinot_tpu_torch.engine.compile_registry import COMPILE_REGISTRY
from pinot_tpu_torch.engine.plan import SegmentPlanner
from pinot_tpu_torch.engine.query_executor import QueryExecutor
from pinot_tpu_torch.ops import fused_groupby, kernels
from pinot_tpu_torch.ops.kernels import planes_from_numpy, run_program
from pinot_tpu_torch.parallel import mesh as pmesh
from pinot_tpu_torch.query.parser.sql import parse_sql
from pinot_tpu_torch.segment.builder import SegmentBuilder
from pinot_tpu_torch.segment.loader import load_segment
from pinot_tpu_torch.spi.data_types import Schema
from pinot_tpu_torch.spi.table_config import IndexingConfig, TableConfig

MESH8 = ["cpu"] * 8
MESH4 = ["cpu"] * 4
N_SEGMENTS = 10  # ragged on 8 devices: 8 + 2
ROWS_PER_SEG = 600
N_KEYS = 40
SCHEMA = Schema.build("meshkv", dimensions=[("k", "INT"), ("d", "INT")],
                      metrics=[("v", "LONG")])

NOCACHE = "SET resultCache = false; SET segmentCache = false; "
SOLO = "SET meshExecution = false; "
TRACE = "SET trace = true; "
DENSE_SQL = ("SELECT k, COUNT(*), SUM(v), MIN(v), MAX(v) "
             "FROM meshkv {where}GROUP BY k ORDER BY k LIMIT 100000")
SPARSE_SQL = ("SET sparseGroupBy = true; "
              "SELECT k, COUNT(*), SUM(v), MIN(v), MAX(v), DISTINCTCOUNT(d) "
              "FROM meshkv {where}GROUP BY k ORDER BY k LIMIT 100000")
COMBINE_SQL = ("SET sparseGroupBy = true; "
               "SELECT k, COUNT(*), SUM(v), MIN(v), MAX(v) "
               "FROM meshkv GROUP BY k ORDER BY k LIMIT 100000")
ORACLE_DENSE = ("SELECT k, COUNT(*), SUM(v), MIN(v), MAX(v) "
                "FROM meshkv {where}GROUP BY k ORDER BY k")
ORACLE_SPARSE = ("SELECT k, COUNT(*), SUM(v), MIN(v), MAX(v), "
                 "COUNT(DISTINCT d) FROM meshkv {where}GROUP BY k ORDER BY k")
FILTER = "WHERE v > 100 AND d < 12 "

pytestmark = pytest.mark.mesh


@pytest.fixture(autouse=True)
def _knobs(monkeypatch):
    monkeypatch.setenv("PINOT_TPU_SEGMENT_CACHE", "0")
    monkeypatch.setenv("PINOT_TPU_RESULT_CACHE", "0")
    monkeypatch.setenv("PINOT_TPU_FUSED", "interpret")
    monkeypatch.delenv("PINOT_TPU_MESH_DEVICES", raising=False)
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _build_env(root, presorted: bool, n_segments: int = N_SEGMENTS,
               devices=MESH8):
    rng = np.random.default_rng(7)
    psegs, jsegs = [], []
    flat = {"k": [], "d": [], "v": []}
    for i in range(n_segments):
        part = {
            "k": rng.integers(0, N_KEYS, ROWS_PER_SEG).astype(np.int32),
            "d": rng.integers(0, 16, ROWS_PER_SEG).astype(np.int32),
            "v": rng.integers(-500, 5000, ROWS_PER_SEG).astype(np.int64),
        }
        if presorted:
            order = np.argsort(part["k"], kind="stable")
            part = {c: a[order] for c, a in part.items()}
        for c in flat:
            flat[c].append(part[c])
        SegmentBuilder(SCHEMA, None, f"s{i}").build(part, root / f"s{i}")
        psegs.append(load_segment(root / f"s{i}"))
        jsegs.append(jax_load(root / f"s{i}"))
    port = QueryExecutor(device="cpu", mesh_devices=devices)
    port.add_table(SCHEMA, psegs)
    jqe = JaxQueryExecutor(backend="tpu")
    jqe.add_table(SCHEMA, jsegs)
    conn = sqlite3.connect(":memory:")
    conn.execute("CREATE TABLE meshkv (k INT, d INT, v INT)")
    flat = {c: np.concatenate(a) for c, a in flat.items()}
    conn.executemany("INSERT INTO meshkv VALUES (?,?,?)", zip(
        map(int, flat["k"]), map(int, flat["d"]), map(int, flat["v"])))
    return port, jqe, conn, psegs


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    return _build_env(tmp_path_factory.mktemp("mesh_shuf"), presorted=False)


@pytest.fixture(scope="module")
def env_presorted(tmp_path_factory):
    return _build_env(tmp_path_factory.mktemp("mesh_sorted"), presorted=True)


def _int_rows(resp):
    assert not resp.exceptions, resp.exceptions
    return [tuple(int(v) for v in row) for row in resp.result_table.rows]


def _mesh_spans(resp) -> list:
    return [s for s in resp.trace_info
            if str(s.get("operator", "")).startswith("mesh_device")]


def _assert_parity(env, sql, oracle_sql):
    port, jqe, conn, _ = env
    mesh = _int_rows(port.execute_sql(NOCACHE + sql))
    solo = _int_rows(port.execute_sql(NOCACHE + SOLO + sql))
    jax_rows = _int_rows(jqe.execute_sql(NOCACHE + sql))
    want = [tuple(int(v) for v in row) for row in conn.execute(oracle_sql)]
    assert mesh == solo, "mesh-sharded rows differ from solo rows"
    assert mesh == jax_rows, "mesh-sharded rows differ from the JAX mesh's"
    assert mesh == want, "mesh-sharded rows differ from the sqlite oracle"


# -- segment sharding through the query executor ------------------------------


def test_mesh_is_on_by_default_here():
    # the JAX side runs on conftest's 8 virtual devices; the port's mesh
    # counts the cards of the process, so on a host without one (or with
    # one) its default path is solo, and an explicit list turns it on
    assert len(jax.devices()) == 8
    assert jmesh.mesh_device_count() == 8
    assert pmesh.mesh_device_count(MESH8) == 8
    assert pmesh.mesh_device_count() == max(1, torch.cuda.device_count())
    assert QueryExecutor(device="cpu").executor.mesh_devices == \
        [torch.device("cpu")]


@pytest.mark.parametrize("where", ["", FILTER], ids=["all", "filter"])
def test_dense_parity_vs_solo_jax_and_sqlite(env, where):
    _assert_parity(env, DENSE_SQL.format(where=where),
                   ORACLE_DENSE.format(where=where))


@pytest.mark.parametrize("layout", ["sort", "presorted"])
def test_sparse_parity_vs_solo_jax_and_sqlite(request, layout):
    env = request.getfixturevalue("env" if layout == "sort"
                                  else "env_presorted")
    _assert_parity(env, SPARSE_SQL.format(where=""),
                   ORACLE_SPARSE.format(where=""))


def test_sparse_device_combine_over_the_mesh(env):
    # the raw path: the family's outputs gather to the executor's device,
    # where the members' tables merge on the device
    port, jqe, conn, _ = env
    resp = port.execute_sql(TRACE + NOCACHE + COMBINE_SQL)
    assert len(_mesh_spans(resp)) == 8
    assert resp.num_device_dispatches == 1
    assert _int_rows(resp) == _int_rows(port.execute_sql(
        NOCACHE + SOLO + COMBINE_SQL)) == _int_rows(jqe.execute_sql(
            NOCACHE + COMBINE_SQL))


def test_ragged_stack_is_sharded(env):
    # 10 segments on 8 devices: 6 pad members ride along (16 = 2 a device);
    # ONE sharded dispatch with one span per device, as in the JAX package
    port, jqe, _, _ = env
    sql = TRACE + NOCACHE + DENSE_SQL.format(where="")
    resp = port.execute_sql(sql)
    assert resp.num_device_dispatches == 1
    spans = _mesh_spans(resp)
    assert len(spans) == 8 == len(_mesh_spans(jqe.execute_sql(sql)))
    assert [s["attributes"]["device"] for s in spans] == list(range(8))
    fam = [s for s in resp.trace_info
           if s.get("attributes", {}).get("meshDevices")]
    assert fam and fam[0]["attributes"]["meshDevices"] == 8
    assert fam[0]["attributes"]["numSegments"] == N_SEGMENTS
    assert fam[0]["attributes"]["crossChipCombineMs"] >= 0


@pytest.mark.parametrize("cap,spans", [("4", 4), ("1", 0)])
def test_mesh_devices_env_cap(env, monkeypatch, cap, spans):
    # PINOT_TPU_MESH_DEVICES shrinks the segment axis (1 turns the mesh
    # off) without any change to the rows
    port, jqe, _, _ = env
    monkeypatch.setenv("PINOT_TPU_MESH_DEVICES", cap)
    _assert_parity(env, DENSE_SQL.format(where=""),
                   ORACLE_DENSE.format(where=""))
    resp = port.execute_sql(TRACE + NOCACHE + DENSE_SQL.format(where=""))
    assert len(_mesh_spans(resp)) == spans
    assert len(_mesh_spans(jqe.execute_sql(
        TRACE + NOCACHE + DENSE_SQL.format(where="")))) == spans


def test_single_segment_family_takes_solo_path(tmp_path):
    # one segment, fewer than 8 devices: below the shard threshold the
    # family runs solo, and still matches the JAX package and sqlite
    env = _build_env(tmp_path, presorted=False, n_segments=1)
    resp = env[0].execute_sql(TRACE + NOCACHE + DENSE_SQL.format(where=""))
    assert not _mesh_spans(resp)
    _assert_parity(env, DENSE_SQL.format(where=""),
                   ORACLE_DENSE.format(where=""))


def test_mesh_off_option_kills_sharding(env):
    port, jqe, _, _ = env
    sql = TRACE + NOCACHE + SOLO + DENSE_SQL.format(where="")
    resp = port.execute_sql(sql)
    assert not _mesh_spans(resp) and not _mesh_spans(jqe.execute_sql(sql))
    assert resp.num_device_dispatches == 1


def test_sharded_family_costs_one_host_crossing(env):
    port, _, _, _ = env
    sql = NOCACHE + DENSE_SQL.format(where="")
    port.execute_sql(sql)
    before = kernels.host_fetches()
    resp = port.execute_sql(sql)
    assert not resp.exceptions
    assert resp.num_device_dispatches == 1
    assert kernels.host_fetches() - before == 1, \
        "sharded family crossed to the host more than once"


def test_sharded_family_reuses_its_family(env):
    # the second run is a warm dispatch of the registered mesh family: no
    # new family, one more dispatch of it
    port, _, _, _ = env
    sql = NOCACHE + DENSE_SQL.format(where="")
    port.execute_sql(sql)
    families = COMPILE_REGISTRY.totals()["families"]
    dispatches = COMPILE_REGISTRY.snapshot()["totalDispatches"]
    resp = port.execute_sql(sql)
    assert resp.num_device_dispatches == 1
    assert COMPILE_REGISTRY.totals()["families"] == families
    assert COMPILE_REGISTRY.snapshot()["totalDispatches"] == dispatches + 1


def test_mesh_parity_on_a_4_device_mesh(tmp_path, monkeypatch):
    # the JAX test runs this shape in a fresh interpreter forced to 4
    # devices; the port's mesh is a list, so it runs in process: 6
    # segments on 4 devices (ragged), against solo, the JAX mesh capped at
    # 4 and sqlite
    monkeypatch.setenv("PINOT_TPU_MESH_DEVICES", "4")
    env = _build_env(tmp_path, presorted=False, n_segments=6, devices=MESH4)
    monkeypatch.delenv("PINOT_TPU_MESH_DEVICES")
    _assert_parity(env, DENSE_SQL.format(where=""),
                   ORACLE_DENSE.format(where=""))
    resp = env[0].execute_sql(TRACE + NOCACHE + DENSE_SQL.format(where=""))
    assert len(_mesh_spans(resp)) == 4


@pytest.mark.parametrize("sql", [DENSE_SQL.format(where=""), COMBINE_SQL],
                         ids=["packed", "raw"])
def test_failed_mesh_dispatch_fails_the_query(env, monkeypatch, sql):
    # the JAX executor warns and falls back to the solo family; the port
    # fails the query, and nothing is dispatched again on the solo path
    port, _, _, _ = env

    def boom(*args, **kwargs):
        raise RuntimeError("sharded dispatch failed")

    solo = []
    real = port.executor.dispatch_plan
    monkeypatch.setattr(pmesh, "run_program_batch_sharded", boom)
    monkeypatch.setattr(port.executor, "dispatch_plan",
                        lambda *a, **k: solo.append(a) or real(*a, **k))
    with pytest.raises(RuntimeError, match="sharded dispatch failed"):
        port.execute_sql(NOCACHE + sql)
    assert not solo
    monkeypatch.undo()
    assert _int_rows(port.execute_sql(NOCACHE + sql)) == _int_rows(
        port.execute_sql(NOCACHE + SOLO + sql))


@pytest.mark.parametrize("members,devices", [(10, MESH8), (8, MESH8),
                                             (6, MESH4)],
                         ids=["ragged8", "even8", "ragged4"])
@pytest.mark.parametrize("sql", [
    DENSE_SQL.format(where=FILTER),
    "SELECT COUNT(*), SUM(v), MIN(v) FROM meshkv WHERE d < 5",
    "SELECT k, v FROM meshkv WHERE d = 3 LIMIT 100000",
    SPARSE_SQL.format(where=""),
], ids=["dense", "aggregation", "selection", "sparse"])
def test_sharded_pack_is_the_solo_pack(env, members, devices, sql):
    """The executor's batch-sharded pack, byte for byte the solo family's
    pack of the same members, metas included."""
    port, _, _, segs = env
    ex = QueryExecutor(device="cpu", mesh_devices=devices).executor
    query = parse_sql(sql)
    segs = segs[:members]
    plans = [ex.plan(query, s) for s in segs]
    sharded = ex.dispatch_plan_batch(segs, plans, mesh=(len(devices),))
    solo = ex.dispatch_plan_batch(segs, plans)
    assert sharded.metas == solo.metas
    assert torch.equal(sharded.flat, solo.flat)


# -- row sharding over the interpreter ----------------------------------------

ROW_N = 20_000
ROW_SCHEMA = Schema.build(
    "t", dimensions=[("d1", "STRING"), ("d2", "INT")],
    metrics=[("m", "INT"), ("x", "DOUBLE")])


def _row_cols(rng):
    return {"d1": np.asarray([f"k{i}" for i in rng.integers(0, 10, ROW_N)],
                             dtype=object),
            "d2": rng.integers(0, 5, ROW_N).astype(np.int32),
            "m": rng.integers(0, 1000, ROW_N).astype(np.int32),
            "x": rng.normal(0.0, 1e3, ROW_N)}


@pytest.fixture(scope="module")
def row_segments(tmp_path_factory):
    """(jax, port) loads of one segment, and of one with `m` and `x` raw
    (a program kernel B's plan takes)."""
    root = tmp_path_factory.mktemp("row_sharded")
    out = {}
    for name, cfg in (("dict", None), ("raw", TableConfig(
            table_name="t", indexing=IndexingConfig(
                no_dictionary_columns=["m", "x"])))):
        SegmentBuilder(ROW_SCHEMA, cfg, name).build(
            _row_cols(np.random.default_rng(7)), root / name)
        out[name] = (jax_load(root / name), load_segment(root / name))
    return out


def _row_both(segs, sql, ndev, fused=False):
    """(port row-sharded outs, JAX row-sharded outs, port solo outs) of
    `sql` on the JAX planner's planes, over `ndev` shards."""
    jseg, pseg = segs
    jplan = JaxPlanner(jax_parse(sql), jseg).plan()
    pplan = SegmentPlanner(parse_sql(sql), pseg).plan()
    assert repr(pplan.program) == repr(jplan.program)
    view = JaxView(jseg)
    arrays = tuple(np.asarray(a) for a in jplan.gather_arrays(view))
    params = tuple(np.asarray(p) for p in jplan.params)
    jm = jmesh.make_mesh(ndev)
    jouts = jmesh.run_program_row_sharded(
        jplan.program, jmesh.shard_segment_arrays(
            tuple(jnp.asarray(a) for a in arrays), jm, view.padded,
            slots=jplan.slots),
        tuple(jnp.asarray(p) for p in params), jseg.num_docs, view.padded,
        jm, slots=jplan.slots, fused="interpret" if fused else "")
    targs, tparams = planes_from_numpy(arrays, params, "cpu")
    pm = pmesh.make_mesh(devices=["cpu"] * ndev)
    pouts = pmesh.run_program_row_sharded(
        pplan.program, pmesh.shard_segment_arrays(
            targs, pm, view.padded, slots=pplan.slots),
        tparams, pseg.num_docs, view.padded, pm, slots=pplan.slots,
        fused=fused)
    solo = run_program(pplan.program, targs, tparams, pseg.num_docs,
                       view.padded, device="cpu")
    return pouts, [np.asarray(o) for o in jouts], solo


def _assert_close(got, want, exact: bool):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape
    if exact or got.dtype.kind != "f":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)


# (sql, shards, exact): exact=False only for float64 SUMs of DOUBLE values
ROW_QUERIES = [
    ("SELECT d1, d2, SUM(m), COUNT(*), MIN(m), MAX(m) FROM t "
     "WHERE d2 >= 1 GROUP BY d1, d2 LIMIT 1000", 8, True),
    ("SELECT d1, SUM(x), MIN(x), MAX(x), COUNT(*) FROM t GROUP BY d1 "
     "LIMIT 100", 8, False),
    ("SELECT d2, DISTINCTCOUNT(d1) FROM t GROUP BY d2 LIMIT 100", 4, True),
    ("SELECT d1, PERCENTILE(m, 90), MODE(d2) FROM t GROUP BY d1", 8, True),
    ("SELECT SUM(m), SUM(x), MIN(x), MAX(m), COUNT(*) FROM t", 8, False),
    ("SELECT SUM(m), MIN(m), MAX(x), COUNT(*) FROM t "
     "WHERE d2 = 3 AND x > 0", 2, True),
    ("SELECT SUM(x), COUNT(*) FROM t WHERE d1 IN ('k1', 'k4')", 4, False),
]


@pytest.mark.parametrize("sql,ndev,exact", ROW_QUERIES)
def test_row_sharded_matches_jax_and_solo(row_segments, sql, ndev, exact):
    pouts, jouts, solo = _row_both(row_segments["dict"], sql, ndev)
    assert len(pouts) == len(jouts) == len(solo)
    for p, j, s in zip(pouts, jouts, solo):
        assert p.dtype == s.dtype
        _assert_close(p, j, exact)
        _assert_close(p, s.numpy(), exact)


def test_selection_mask_stays_split_by_rows(row_segments):
    sql = "SELECT d1 FROM t WHERE d2 = 2 LIMIT 100000"
    pouts, jouts, solo = _row_both(row_segments["dict"], sql, 8)
    (bitmap,) = pouts
    assert isinstance(bitmap, pmesh.Sharded) and len(bitmap.parts) == 8
    np.testing.assert_array_equal(bitmap.gather().numpy(), jouts[0])
    np.testing.assert_array_equal(bitmap.gather().numpy(), solo[0].numpy())


@pytest.mark.parametrize("ndev", [8, 4])
def test_row_sharded_fused_kernel_parity(row_segments, monkeypatch, ndev):
    """Kernel B's plan runs per shard at its row offset (the scalar
    vector's second entry), the shards' tables add: the JAX package's
    fused row-sharded run and the port's solo run, element for element."""
    sql = ("SELECT d1, SUM(m), COUNT(*) FROM t WHERE d2 = 2 GROUP BY d1 "
           "LIMIT 100")
    offsets = []
    real = fused_groupby.fused_limb_sums

    def spy(fp, planes_in, scalars, num_segments, n):
        offsets.append((int(scalars[1]), n))
        return real(fp, planes_in, scalars, num_segments, n)

    monkeypatch.setattr(fused_groupby, "fused_limb_sums", spy)
    pouts, jouts, solo = _row_both(row_segments["raw"], sql, ndev,
                                   fused=True)
    padded = JaxView(row_segments["raw"][0]).padded
    local = padded // ndev
    assert offsets == [(k * local, local) for k in range(ndev)]
    for p, j, s in zip(pouts, jouts, solo):
        _assert_close(p, j, True)
        _assert_close(p, s.numpy(), True)


def test_row_sharded_refusals():
    """Adaptive histograms, sparse group-by and MV group-by refuse to row
    shard, as in the JAX package: their outputs do not add."""
    agg = dict(vexpr=None, bins=8, lo_param=0, hi_param=1, pct=95.0)
    adaptive = ir.Program(
        mode="group_by", filter=None, group_slots=(0,), group_strides=(1,),
        num_groups=10, aggs=(ir.AggOp("hist_adaptive", **dict(
            agg, vexpr=ir.Col(1))),))
    jadaptive = jir.Program(
        mode="group_by", filter=None, group_slots=(0,), group_strides=(1,),
        num_groups=10, aggs=(jir.AggOp("hist_adaptive", **dict(
            agg, vexpr=jir.Col(1))),))
    pm, jm = pmesh.make_mesh(devices=MESH8), jmesh.make_mesh(8)
    cases = [
        ("adaptive", adaptive, jadaptive),
        ("sparse", ir.Program(mode="group_by_sparse", filter=None,
                              group_slots=(0,), group_strides=(1,),
                              num_groups=10, aggs=()),
         jir.Program(mode="group_by_sparse", filter=None, group_slots=(0,),
                     group_strides=(1,), num_groups=10, aggs=())),
        ("MV", ir.Program(mode="group_by", filter=None, group_slots=(0,),
                          group_strides=(1,), num_groups=10, aggs=(),
                          mv_group_slot=0),
         jir.Program(mode="group_by", filter=None, group_slots=(0,),
                     group_strides=(1,), num_groups=10, aggs=(),
                     mv_group_slot=0)),
    ]
    for match, program, jprogram in cases:
        with pytest.raises(ValueError, match=match):
            pmesh.run_program_row_sharded(program, (), (), 0, 8, pm)
        with pytest.raises(ValueError, match=match):
            jmesh.run_program_row_sharded(jprogram, (), (), 0, 8, jm)


def test_mesh_shapes_and_slot_specs():
    """make_mesh over two axes favours row shards, as the JAX package's;
    slot specs follow the slot kind, never the shape."""
    pm = pmesh.make_mesh(axes=(pmesh.SEGMENT_AXIS, pmesh.ROW_AXIS),
                         devices=MESH8)
    jm = jmesh.make_mesh(8, axes=(jmesh.SEGMENT_AXIS, jmesh.ROW_AXIS))
    assert pm.shape == dict(jm.shape)
    assert len(pm.axis_devices(pmesh.ROW_AXIS)) == 4
    slots = [("a", "ids"), ("b", "dict"), ("c", "raw"), ("d", "null")]
    assert pmesh.slot_specs(slots) == (pmesh.ROW_AXIS, None, pmesh.ROW_AXIS,
                                       pmesh.ROW_AXIS)
    assert [None if s == jax.sharding.PartitionSpec() else pmesh.ROW_AXIS
            for s in jmesh.slot_specs(slots)] == list(pmesh.slot_specs(slots))
    with pytest.raises(ValueError):
        pmesh.Mesh(MESH8, (pmesh.ROW_AXIS,), (3,))
