"""The sparse (sort-based) GROUP BY of the port, against the JAX package.

With seeded numpy segments on the CPU:

  * `run_program` of a `group_by_sparse` Program equals the JAX package's
    `run_program(fused="")`: the sort path with int32 and int64 keys, the
    presorted path (one sorted key, and a composite prefix of the
    segment's sort chain), the numGroupsLimit trim (the trash slot counts
    the trimmed rows), the exact ORDER BY trim, COUNT / SUM / MIN / MAX /
    AVG / SUMSQ, a filter, and an integer SUM without small bounds (the
    exact int64 branch, whose trash slot holds the trimmed rows' sum).
    Integers element-equal; float64 sums of DOUBLE values within rtol
    1e-12 (the JAX package adds in a tree scan's order);
  * `run_program_batch` of sparse Programs equals the JAX package's;
  * `ids_to_values_i64` and `combine_sparse_group_tables` equal the JAX
    package's on the same per-segment tables;
  * `execute_sql` over a 16-segment table equals the JAX package's
    `QueryExecutor(backend="tpu")` rows, scanned docs, groups-limit flag
    and device dispatches for bench.py's Q3 and Q4 shapes and a sparse
    query whose 16 members form one family, device combine on and off.
"""

from __future__ import annotations

import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pinot_tpu.engine import ir as jax_ir
from pinot_tpu.engine.executor import TpuSegmentExecutor as JaxExecutor
from pinot_tpu.engine.plan import SegmentPlanner as JaxPlanner
from pinot_tpu.engine.query_executor import QueryExecutor as JaxQueryExecutor
from pinot_tpu.ops import kernels as jax_kernels
from pinot_tpu.query.parser.sql import parse_sql as jax_parse
from pinot_tpu.segment.device_cache import SegmentDeviceView as JaxView
from pinot_tpu.segment.loader import load_segment as jax_load
from pinot_tpu.spi.data_types import Schema as JaxSchema
from pinot_tpu_torch.engine import ir
from pinot_tpu_torch.engine.plan import SegmentPlanner
from pinot_tpu_torch.engine.query_executor import QueryExecutor
from pinot_tpu_torch.ops import kernels
from pinot_tpu_torch.ops.kernels import (planes_from_numpy, run_program,
                                         run_program_batch)
from pinot_tpu_torch.query.parser.sql import parse_sql
from pinot_tpu_torch.segment.builder import SegmentBuilder
from pinot_tpu_torch.segment.loader import load_segment
from pinot_tpu_torch.spi.data_types import Schema
from pinot_tpu_torch.spi.table_config import IndexingConfig, TableConfig

ROWS = 6000
ORDERS = 2000  # distinct lo_orderkey values of every segment
DIMS = [("d_year", "INT"), ("p_brand", "INT"), ("s_region", "STRING"),
        ("lo_discount", "INT"), ("lo_orderkey", "INT"),
        ("lo_linenumber", "INT"), ("a", "INT"), ("b", "INT")]
METRICS = [("lo_revenue", "INT"), ("lo_tax", "DOUBLE"), ("lo_delta", "INT"),
           ("lo_big", "INT")]
RAW = ["lo_revenue", "lo_tax", "lo_delta", "lo_big"]
REGIONS = ["AMERICA", "ASIA", "EUROPE", "AFRICA", "MIDDLE EAST"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _jax_dispatches_every_query(monkeypatch):
    # the JAX package's segment partial cache would answer a repeated
    # program with zero dispatches; its segment-axis mesh is a multi-device
    # path outside this slice
    monkeypatch.setenv("PINOT_TPU_SEGMENT_CACHE", "0")
    monkeypatch.setenv("PINOT_TPU_MESH_DEVICES", "1")


def _cols(rng, rows, orders, base):
    """Lineorder-shaped rows in ingestion order: lo_orderkey sorted (each
    of `orders` keys from `base` on), lo_linenumber sorted within each
    order, so the segment's sort chain starts (lo_orderkey,
    lo_linenumber)."""
    per = rows // orders
    return {
        "d_year": rng.integers(1992, 1999, rows).astype(np.int32),
        "p_brand": rng.integers(0, 300, rows).astype(np.int32),
        "s_region": np.asarray(REGIONS, dtype=object)[
            rng.integers(0, 5, rows)],
        "lo_discount": rng.integers(0, 11, rows).astype(np.int32),
        "lo_orderkey": np.repeat(base + 7 * np.arange(orders, dtype=np.int32),
                                 per),
        "lo_linenumber": np.tile(np.arange(1, per + 1, dtype=np.int32),
                                 orders),
        "a": rng.integers(0, 100_000, rows).astype(np.int32),
        "b": rng.integers(0, 100_000, rows).astype(np.int32),
        "lo_revenue": rng.integers(1, 600_000, rows).astype(np.int32),
        "lo_tax": rng.normal(0.0, 1e3, rows),
        "lo_delta": rng.integers(-70_000, 70_000, rows).astype(np.int32),
        # bounds of 30 bits: its sums skip the exact-prefix gate
        "lo_big": rng.integers(-(1 << 29), 1 << 29, rows).astype(np.int32),
    }


def _build(root, cols_list, table):
    schema = Schema.build(table, dimensions=DIMS, metrics=METRICS)
    cfg = TableConfig(table_name=table,
                      indexing=IndexingConfig(no_dictionary_columns=RAW))
    paths = []
    for i, cols in enumerate(cols_list):
        SegmentBuilder(schema, cfg, f"{table}_{i}").build(cols, root / f"s{i}")
        paths.append(root / f"s{i}")
    return paths


@pytest.fixture(scope="module")
def segments(tmp_path_factory):
    """Four segments of one family shape: equal cardinalities (the
    orderkeys are distinct per segment), different dictionaries."""
    rng = np.random.default_rng(5)
    paths = _build(tmp_path_factory.mktemp("torch_sparse"),
                   [_cols(rng, ROWS, ORDERS, 100_000 * i) for i in range(4)],
                   "t")
    return [jax_load(p) for p in paths], [load_segment(p) for p in paths]


# (sql, exact, path): exact=False for float64 sums of DOUBLE values
SPARSE_QUERIES = [
    ("SET sparseGroupBy = true; SELECT d_year, p_brand, SUM(lo_revenue), "
     "COUNT(*), MIN(lo_revenue), MAX(lo_revenue), AVG(lo_delta) FROM t "
     "WHERE s_region = 'ASIA' GROUP BY d_year, p_brand", True, "sort32"),
    # 100000 * 100000 * 300 keys: above 2^31, the keys sort as int64
    ("SELECT a, b, p_brand, COUNT(*), SUM(lo_revenue), MAX(lo_delta) FROM t "
     "WHERE lo_discount > 2 GROUP BY a, b, p_brand", True, "sort64"),
    ("SET sparseGroupBy = true; SELECT lo_orderkey, SUM(lo_revenue), "
     "COUNT(*) FROM t WHERE lo_discount < 7 GROUP BY lo_orderkey "
     "ORDER BY lo_orderkey LIMIT 500", True, "presorted"),
    ("SET sparseGroupBy = true; SELECT lo_orderkey, lo_linenumber, "
     "MIN(lo_delta), MAX(lo_delta), SUM(lo_delta), COUNT(*) FROM t "
     "WHERE d_year <> 1995 GROUP BY lo_orderkey, lo_linenumber",
     True, "presorted"),
    # numGroupsLimit trims: the trash slot counts (and, without a small
    # bound, sums) the trimmed rows
    ("SET sparseGroupBy = true; SET numGroupsLimit = 50; SELECT p_brand, "
     "COUNT(*), SUM(lo_revenue), SUM(lo_big), SUM(-lo_delta) FROM t "
     "GROUP BY p_brand", True, "sort32"),
    ("SET sparseGroupBy = true; SET numGroupsLimit = 40; SELECT "
     "lo_orderkey, SUM(-lo_delta), SUM(lo_big), MIN(lo_revenue), COUNT(*) "
     "FROM t WHERE d_year > 1993 GROUP BY lo_orderkey", True, "presorted"),
    ("SET sparseGroupBy = true; SELECT d_year, SUM(lo_tax), AVG(lo_tax), "
     "MIN(lo_tax), MAX(lo_tax) FROM t GROUP BY d_year", False, "sort32"),
    ("SET sparseGroupBy = true; SELECT lo_orderkey, SUM(lo_tax), "
     "MAX(lo_tax) FROM t WHERE s_region IN ('ASIA', 'AFRICA') "
     "GROUP BY lo_orderkey ORDER BY lo_orderkey LIMIT 100", False,
     "presorted"),
]


def _sumsq(program):
    """The program with one more agg: SUMSQ of its first valued op (the
    port lowers no SQL function to it; the interpreters both run it).
    Squares of integers stay exact in float64 at these sizes."""
    op = next(a for a in program.aggs if a.vexpr is not None)
    cls = ir.AggOp if isinstance(program, ir.Program) else jax_ir.AggOp
    return dataclasses.replace(
        program, aggs=program.aggs + (cls("sumsq", vexpr=op.vexpr),))


def _path(program):
    if program.keys_presorted:
        return "presorted"
    return "sort32" if program.key_space < (1 << 31) - 1 else "sort64"


def _compare(got, want, exact):
    assert len(got) == len(want)
    for o, w in zip(got, want):
        o, w = np.asarray(o), np.asarray(w)
        assert o.dtype == w.dtype and o.shape == w.shape
        if exact or o.dtype.kind != "f":
            np.testing.assert_array_equal(o, w)
        else:
            np.testing.assert_allclose(o, w, rtol=1e-12, atol=0)


@pytest.mark.parametrize("sumsq", [False, True], ids=["", "sumsq"])
@pytest.mark.parametrize("sql,exact,path", SPARSE_QUERIES)
def test_sparse_run_program_matches_jax(segments, sql, exact, path, sumsq):
    jseg, pseg = segments[0][0], segments[1][0]
    jplan = JaxPlanner(jax_parse(sql), jseg).plan()
    pplan = SegmentPlanner(parse_sql(sql), pseg).plan()
    assert repr(pplan.program) == repr(jplan.program)
    assert pplan.program.mode == "group_by_sparse"
    assert _path(pplan.program) == path
    jprog, pprog = jplan.program, pplan.program
    if sumsq:
        jprog, pprog = _sumsq(jprog), _sumsq(pprog)
    view = JaxView(jseg)
    arrays, packed = jplan.gather_arrays_packed(view)
    arrays = tuple(np.asarray(a) for a in arrays)
    params = tuple(np.asarray(p) for p in jplan.params)
    want = jax_kernels.run_program(jprog, arrays, params,
                                   np.int32(jseg.num_docs), view.padded,
                                   packed=packed, fused="")
    targs, tparams = planes_from_numpy(arrays, params, "cpu")
    got = run_program(pprog, targs, tparams, pseg.num_docs, view.padded,
                      packed=packed, device="cpu")
    _compare([o.numpy() for o in got], want, exact)
    counts = np.asarray(want[0])
    if "numGroupsLimit" in sql:
        assert counts[-1] > 0  # rows were trimmed and counted in the trash


@pytest.mark.parametrize("sql,exact,path", [
    q for q in SPARSE_QUERIES if q[2] != "sort64"])
def test_sparse_run_program_batch_matches_jax(segments, sql, exact, path):
    jsegs, psegs = segments
    jplans = [JaxPlanner(jax_parse(sql), s).plan() for s in jsegs]
    pplans = [SegmentPlanner(parse_sql(sql), s).plan() for s in psegs]
    views, arrays, params_b, packed, num_docs = JaxExecutor()._gather_batch(
        jsegs, jplans)
    arrays = tuple(np.asarray(a) for a in arrays)
    want = jax_kernels.run_program_batch(
        jplans[0].program, arrays, params_b, num_docs, views[0].padded,
        packed=packed)
    got = run_program_batch(
        pplans[0].program, tuple(torch.from_numpy(np.array(a)) for a in arrays),
        tuple(torch.from_numpy(np.array(p)) for p in params_b),
        np.asarray(num_docs), views[0].padded, packed=packed, device="cpu")
    _compare([o.numpy() for o in got], want, exact)


COMBINE_SQL = ("SET sparseGroupBy = true; SELECT lo_orderkey, COUNT(*), "
               "SUM(lo_revenue), MIN(lo_delta), MAX(lo_delta), SUM(lo_tax) "
               "FROM t WHERE lo_discount <> 4 GROUP BY lo_orderkey "
               "ORDER BY lo_orderkey LIMIT 1500")


def test_device_combine_matches_jax(segments):
    jsegs, _ = segments
    jplans = [JaxPlanner(jax_parse(COMBINE_SQL), s).plan() for s in jsegs]
    kinds = tuple({"count": "add", "sum": "add", "min": "min",
                   "max": "max"}[a.kind] for a in jplans[0].program.aggs)
    jkeys, jcounts, jstates, pkeys, pcounts, pstates = ([] for _ in range(6))
    for seg, plan in zip(jsegs, jplans):
        view = JaxView(seg)
        arrays, packed = plan.gather_arrays_packed(view)
        outs = jax_kernels.run_program(plan.program, arrays, plan.params,
                                       np.int32(seg.num_docs), view.padded,
                                       packed=packed, fused="")
        dict_plane = np.asarray(view.dict_values("lo_orderkey"))
        jk = jax_kernels.ids_to_values_i64(outs[-1], jnp.asarray(dict_plane))
        pk = kernels.ids_to_values_i64(torch.from_numpy(np.array(outs[-1])),
                                       torch.from_numpy(np.array(dict_plane)))
        np.testing.assert_array_equal(pk.numpy(), np.asarray(jk))
        jkeys.append(jk)
        jcounts.append(outs[0])
        jstates.append(tuple(outs[1:-1]))
        pkeys.append(pk)
        pcounts.append(torch.from_numpy(np.array(outs[0])))
        pstates.append(tuple(torch.from_numpy(np.array(o))
                             for o in outs[1:-1]))
    want = jax_kernels.combine_sparse_group_tables(
        tuple(jkeys), tuple(jcounts), tuple(jstates), kinds)
    got = kernels.combine_sparse_group_tables(pkeys, pcounts, pstates, kinds)
    # integer states element-equal; the DOUBLE sum (last) within rtol
    _compare([o.numpy() for o in got[:-2]], want[:-2], True)
    _compare([got[-2].numpy()], [want[-2]], False)
    _compare([got[-1].numpy()], [want[-1]], True)


# -- SQL end to end over 16 segments -------------------------------------------

SEGMENTS16 = 16
ROWS16 = 3000
ORDERS16 = 1000


@pytest.fixture(scope="module")
def ssb16(tmp_path_factory):
    rng = np.random.default_rng(2024)
    paths = _build(tmp_path_factory.mktemp("torch_sparse16"),
                   [_cols(rng, ROWS16, ORDERS16, 10_000 * i)
                    for i in range(SEGMENTS16)], "ssb16")
    schema = Schema.build("ssb16", dimensions=DIMS, metrics=METRICS)
    port = QueryExecutor(device="cpu")
    port.add_table(schema, [load_segment(p) for p in paths])
    jax = JaxQueryExecutor(backend="tpu")
    jax.add_table(JaxSchema.build("ssb16", dimensions=DIMS, metrics=METRICS),
                  [jax_load(p) for p in paths])
    return port, jax


Q4 = ("SELECT d_year, p_brand, SUM(lo_revenue) FROM ssb16 "
      "WHERE s_region = 'ASIA' GROUP BY d_year, p_brand LIMIT 10000")
Q3 = ("SET numGroupsLimit = 20000000; SELECT lo_orderkey, SUM(lo_revenue), "
      "COUNT(*) FROM ssb16 GROUP BY lo_orderkey ORDER BY lo_orderkey "
      "LIMIT 100000")
SPARSE_FAMILY = ("SET sparseGroupBy = true; SELECT p_brand, SUM(lo_revenue), "
                 "COUNT(*), MIN(lo_revenue), MAX(lo_revenue) FROM ssb16 "
                 "GROUP BY p_brand ORDER BY p_brand LIMIT 1000")


# (sql, ordered)
SQL16 = [
    (Q4, False),
    (Q3, True),
    ("SET sparseGroupBy = true; " + Q3, True),
    ("SET sparseGroupBy = true; SET deviceCombine = false; " + Q3, True),
    (SPARSE_FAMILY, True),
    ("SET deviceCombine = false; " + SPARSE_FAMILY, True),
    ("SET sparseGroupBy = true; SELECT d_year, lo_orderkey, SUM(lo_revenue), "
     "COUNT(*), MIN(lo_revenue), MAX(lo_revenue) FROM ssb16 "
     "GROUP BY d_year, lo_orderkey ORDER BY d_year, lo_orderkey LIMIT 100",
     True),
    ("SET sparseGroupBy = true; SET numGroupsLimit = 100; SELECT p_brand, "
     "COUNT(*), SUM(lo_delta) FROM ssb16 GROUP BY p_brand", False),
]


def _rows_equal(got, want, ordered):
    if not ordered:
        got, want = sorted(map(tuple, got)), sorted(map(tuple, want))
    assert len(got) == len(want)
    for rg, rw in zip(got, want):
        for a, b in zip(rg, rw):
            if isinstance(a, float) or isinstance(b, float):
                assert math.isclose(float(a), float(b), rel_tol=1e-12)
            else:
                assert a == b


@pytest.mark.parametrize("sql,ordered", SQL16)
def test_execute_sql_16_segments_matches_jax(ssb16, sql, ordered):
    port, jax = ssb16
    before = kernels.host_fetches()
    got = port.execute_sql(sql)
    assert kernels.host_fetches() - before == 1
    want = jax.execute_sql(sql)
    assert not want.exceptions, want.exceptions
    _rows_equal(got.result_table.rows, want.result_table.rows, ordered)
    assert got.num_docs_scanned == want.num_docs_scanned
    assert got.num_groups_limit_reached == want.num_groups_limit_reached
    assert got.num_device_dispatches == want.num_device_dispatches
    if sql in (Q4, SPARSE_FAMILY):
        assert got.num_device_dispatches == 1  # one family of 16


@pytest.mark.parametrize("sql", [
    "SET sparseGroupBy = true; SELECT d_year, VAR_SAMP(p_brand) FROM ssb16 "
    "GROUP BY d_year",
    "SET sparseGroupBy = true; SELECT p_brand, COUNT(*), STDDEVPOP(lo_revenue), "
    "BOOL_OR(lo_delta) FROM ssb16 GROUP BY p_brand",
])
def test_device_combine_declines_aggs_without_columnar_form(ssb16, sql):
    """The moment functions and BOOL_AND/BOOL_OR lower to sum / sumsq /
    min / max ops (kinds the device merge takes) but have no columnar
    form: the device combine declines them, as the reference's eligibility
    check does, and the segments merge on the host (it used to decode the
    merged table by a columnar form that is None)."""
    port, jax = ssb16
    got = port.execute_sql(sql)
    want = jax.execute_sql(sql)
    assert not want.exceptions, want.exceptions
    _rows_equal(got.result_table.rows, want.result_table.rows, False)
    assert got.num_docs_scanned == want.num_docs_scanned
    assert got.num_device_dispatches == want.num_device_dispatches
    off = port.execute_sql(sql.replace("SET sparseGroupBy = true; ",
                                       "SET sparseGroupBy = true; "
                                       "SET deviceCombine = false; "))
    assert off.result_table.rows == got.result_table.rows
