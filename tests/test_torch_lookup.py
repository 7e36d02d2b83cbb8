"""LOOKUP joins over dimension tables, the port against the JAX package.

The cases of tests/test_lookup_join.py with the dimension table
registered in both packages (each its own per-process registry, through
`QueryExecutor.add_dimension_table`): LOOKUP as a GROUP BY key (a derived
dimension over the fact column's dictionary), in a filter (a LUT over its
ids) and as an aggregation input (a gathered table), missing keys reading
0, and an unknown table failing loudly; then bench.py's Q7 star join at a
small size, and the registry's own refusals. Rows are compared exactly
(integers) with the JAX `QueryExecutor(backend="tpu")` and a numpy oracle,
with the same dispatches.
"""

from __future__ import annotations

import numpy as np
import pytest

from pinot_tpu.engine import dim_tables as jax_dim_tables
from pinot_tpu.engine.plan import SegmentPlanner as JaxPlanner
from pinot_tpu.engine.query_executor import QueryExecutor as JaxQueryExecutor
from pinot_tpu.query.parser.sql import parse_sql as jax_parse
from pinot_tpu.segment.loader import load_segment as jax_load
from pinot_tpu.spi.data_types import Schema as JaxSchema
from pinot_tpu_torch.engine import dim_tables
from pinot_tpu_torch.engine.aggregation import UnsupportedQueryError
from pinot_tpu_torch.engine.plan import SegmentPlanner
from pinot_tpu_torch.engine.query_executor import QueryExecutor
from pinot_tpu_torch.query.parser.sql import parse_sql
from pinot_tpu_torch.segment.builder import SegmentBuilder
from pinot_tpu_torch.segment.loader import load_segment
from pinot_tpu_torch.spi.data_types import Schema

N = 6000
CUSTS = 500
REGIONS = ["AMERICA", "ASIA", "EUROPE", "AFRICA"]
FACT = dict(dimensions=[("cust_id", "INT")], metrics=[("amount", "INT")])
DIM = dict(dimensions=[("cid", "INT"), ("region", "STRING")],
           metrics=[("credit", "INT")], primary_key_columns=["cid"])
# bench.py's Q7 over its brands dimension table (bench.py:86-90, :160-179)
N_BRANDS, BRAND_CATEGORIES = 1000, 40
BRAND_REGIONS = ["AMERICA", "ASIA", "EUROPE", "AFRICA", "MIDDLE EAST"]
BRANDS = dict(dimensions=[("b_id", "INT"), ("b_category", "STRING"),
                          ("b_region", "STRING")],
              primary_key_columns=["b_id"])
SSB = dict(dimensions=[("d_year", "INT"), ("p_brand", "INT")],
           metrics=[("lo_revenue", "INT")])
Q7 = ("SELECT d_year, LOOKUP('brands', 'b_category', 'b_id', p_brand), "
      "SUM(lo_revenue) FROM {t} "
      "WHERE LOOKUP('brands', 'b_region', 'b_id', p_brand) = 'ASIA' "
      "GROUP BY d_year, LOOKUP('brands', 'b_category', 'b_id', p_brand) "
      "LIMIT 1000")


@pytest.fixture(autouse=True)
def _jax_dispatches_every_query(monkeypatch):
    monkeypatch.setenv("PINOT_TPU_SEGMENT_CACHE", "0")
    monkeypatch.setenv("PINOT_TPU_MESH_DEVICES", "1")
    monkeypatch.setenv("PINOT_TPU_FUSED", "interpret")


def _build(schema_kw, name, cols, path):
    SegmentBuilder(Schema.build(name, **schema_kw), segment_name=path.name) \
        .build(cols, path)
    return path


def _both(schema_kw, name):
    return Schema.build(name, **schema_kw), JaxSchema.build(name, **schema_kw)


@pytest.fixture
def engines(tmp_path):
    """(port, jax, fact, dim): the orders fact table of two segments and
    the customers dimension table, registered in both packages."""
    rng = np.random.default_rng(9)
    fact = {"cust_id": rng.integers(0, CUSTS, N).astype(np.int32),
            "amount": rng.integers(1, 100, N).astype(np.int32)}
    dim = {"cid": np.arange(CUSTS, dtype=np.int32),
           "region": np.asarray([REGIONS[i % 4] for i in range(CUSTS)], object),
           "credit": (np.arange(CUSTS, dtype=np.int32) * 3) % 1000}
    half = N // 2
    fpaths = [_build(FACT, "orders", {k: v[sl] for k, v in fact.items()},
                     tmp_path / f"f{i}")
              for i, sl in enumerate((slice(0, half), slice(half, N)))]
    dpath = _build(DIM, "customers", dim, tmp_path / "d0")
    port, jax = QueryExecutor(device="cpu"), JaxQueryExecutor(backend="tpu")
    (pf, jf), (pd, jd) = _both(FACT, "orders"), _both(DIM, "customers")
    port.add_table(pf, [load_segment(p) for p in fpaths])
    port.add_dimension_table(pd, [load_segment(dpath)])
    jax.add_table(jf, [jax_load(p) for p in fpaths])
    jax.add_dimension_table(jd, [jax_load(dpath)])
    yield port, jax, fact, dim
    dim_tables.unregister_dimension_table("customers")
    jax_dim_tables.unregister_dimension_table("customers")


def _rows(port, jax, sql):
    """The port's rows, after holding them (sorted) and the dispatches
    equal to the JAX package's."""
    want = jax.execute_sql(sql)
    assert not want.exceptions, want.exceptions
    got = port.execute_sql(sql)
    assert sorted(got.result_table.rows, key=repr) == \
        sorted(want.result_table.rows, key=repr)
    assert got.num_device_dispatches == want.num_device_dispatches
    assert got.num_docs_scanned == want.num_docs_scanned
    return got.result_table.rows


def test_lookup_group_by(engines):
    port, jax, fact, dim = engines
    sql = ("SELECT LOOKUP('customers', 'region', 'cid', cust_id), SUM(amount) "
           "FROM orders GROUP BY LOOKUP('customers', 'region', 'cid', cust_id)")
    seg = port.tables["orders"].segments[0]
    pplan = SegmentPlanner(parse_sql(sql), seg).plan()
    jplan = JaxPlanner(jax_parse(sql), jax.tables["orders"].segments[0]).plan()
    assert pplan.program.mode == "group_by"
    assert repr(pplan.program) == repr(jplan.program)
    for a, b in zip(pplan.params, jplan.params):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    want = {}
    for c, a in zip(fact["cust_id"], fact["amount"]):
        want[dim["region"][c]] = want.get(dim["region"][c], 0) + int(a)
    assert {r[0]: r[1] for r in _rows(port, jax, sql)} == want


def test_lookup_filter_and_agg_input(engines):
    port, jax, fact, dim = engines
    sql = ("SELECT SUM(amount), SUM(LOOKUP('customers', 'credit', 'cid', "
           "cust_id)) FROM orders "
           "WHERE LOOKUP('customers', 'region', 'cid', cust_id) = 'ASIA'")
    m = np.isin(fact["cust_id"], [i for i in range(CUSTS)
                                  if dim["region"][i] == "ASIA"])
    (row,) = _rows(port, jax, sql)
    assert row[0] == int(fact["amount"][m].sum())
    assert row[1] == float(dim["credit"][fact["cust_id"][m]].sum())


def test_lookup_in_like_and_range_filters(engines):
    port, jax, fact, dim = engines
    for where in ("LOOKUP('customers', 'region', 'cid', cust_id) "
                  "IN ('ASIA', 'AFRICA')",
                  "LOOKUP('customers', 'region', 'cid', cust_id) LIKE 'A%'",
                  "LOOKUP('customers', 'credit', 'cid', cust_id) "
                  "BETWEEN 100 AND 400"):
        _rows(port, jax, f"SELECT COUNT(*), SUM(amount) FROM orders "
                         f"WHERE {where}")


def test_lookup_missing_keys_read_zero(engines, tmp_path):
    port, jax, _, dim = engines
    fact2 = {"cust_id": np.asarray([0, 1, CUSTS + 7], np.int32),
             "amount": np.asarray([5, 6, 7], np.int32)}
    path = _build(FACT, "orders2", fact2, tmp_path / "f2")
    pf, jf = _both(FACT, "orders2")
    port.add_table(pf, [load_segment(path)])
    jax.add_table(jf, [jax_load(path)])
    sql = ("SELECT SUM(LOOKUP('customers', 'credit', 'cid', cust_id)), "
           "MIN(LOOKUP('customers', 'credit', 'cid', cust_id)) FROM orders2")
    (row,) = _rows(port, jax, sql)
    assert row == [float(dim["credit"][0] + dim["credit"][1]), 0.0]
    rows = _rows(port, jax, "SELECT LOOKUP('customers', 'region', 'cid', "
                            "cust_id), COUNT(*) FROM orders2 GROUP BY "
                            "LOOKUP('customers', 'region', 'cid', cust_id)")
    assert sorted(rows) == [["", 1], ["AMERICA", 1], ["ASIA", 1]]


@pytest.mark.parametrize("sql", [
    "SELECT SUM(LOOKUP('nope', 'x', 'y', cust_id)) FROM orders",
    "SELECT COUNT(*) FROM orders WHERE LOOKUP('nope', 'x', 'y', cust_id) = 'A'",
    # the table joins on cid, not on another column
    "SELECT SUM(LOOKUP('customers', 'credit', 'region', cust_id)) FROM orders",
])
def test_lookup_unknown_table_fails_loudly(engines, sql):
    port, jax, _, _ = engines
    assert jax.execute_sql(sql).exceptions
    with pytest.raises(UnsupportedQueryError):
        port.execute_sql(sql)


def test_registry_is_the_ports_own(engines):
    """A table registered only in the JAX package's registry is unknown to
    the port, and unregistering one side leaves the other."""
    jax_dim_tables.register_dimension_table(
        "jax_only", "k", {"k": np.arange(3), "v": np.arange(3)})
    try:
        assert dim_tables.get_dimension_table("jax_only") is None
        port = engines[0]
        with pytest.raises(UnsupportedQueryError):
            port.execute_sql("SELECT SUM(LOOKUP('jax_only', 'v', 'k', "
                             "cust_id)) FROM orders")
    finally:
        jax_dim_tables.unregister_dimension_table("jax_only")
    assert dim_tables.get_dimension_table("customers") is not None


def test_registry_refusals(tmp_path):
    with pytest.raises(ValueError, match="duplicate"):
        dim_tables.register_dimension_table(
            "dup", "k", {"k": np.asarray([1, 2, 2]), "v": np.arange(3)})
    with pytest.raises(ValueError, match="pk column"):
        dim_tables.register_dimension_table("nopk", "k", {"v": np.arange(3)})
    assert dim_tables.get_dimension_table("dup") is None
    t = dim_tables.register_dimension_table(
        "t1", "k", {"k": np.asarray([5, 1, 3]),
                    "v": np.asarray(["e", "a", "c"], object)})
    try:
        vals, found = t.lookup("v", np.asarray([3, 4, 5]))
        assert list(vals) == ["c", "", "e"] and list(found) == [True, False, True]
        dim_tables.alias_dimension_table("t1_OFFLINE", "t1")
        assert dim_tables.get_dimension_table("t1_OFFLINE") is t
    finally:
        dim_tables.unregister_dimension_table("t1")
        dim_tables.unregister_dimension_table("t1_OFFLINE")
    assert dim_tables.get_dimension_table("t1") is None
    empty = dim_tables.DimensionTable("e", "k", {"k": np.asarray([], np.int64),
                                                 "v": np.asarray([], np.int64)})
    vals, found = empty.lookup("v", np.asarray([1, 2]))
    assert list(vals) == [0.0, 0.0] and not found.any()

    # QueryExecutor.add_dimension_table: exactly one primary key
    port = QueryExecutor(device="cpu")
    for pks in ([], ["cid", "credit"]):
        kw = dict(DIM, primary_key_columns=pks)
        path = _build(kw, "c2", {"cid": np.arange(3, dtype=np.int32),
                                 "region": np.asarray(["a", "b", "c"], object),
                                 "credit": np.arange(3, dtype=np.int32)},
                      tmp_path / f"c{len(pks)}")
        with pytest.raises(ValueError, match="exactly one primary key"):
            port.add_dimension_table(Schema.build("c2", **kw),
                                     [load_segment(path)])
    path = _build(DIM, "c3", {"cid": np.asarray([1, 1], np.int32),
                              "region": np.asarray(["a", "b"], object),
                              "credit": np.arange(2, dtype=np.int32)},
                  tmp_path / "c3")
    with pytest.raises(ValueError, match="duplicate"):
        port.add_dimension_table(Schema.build("c3", **DIM),
                                 [load_segment(path)])
    assert dim_tables.get_dimension_table("c3") is None


def test_bench_q7_equals_jax_and_oracle(tmp_path):
    """bench.py Q7 verbatim over the brands table (1000 rows) and an
    ssb-shaped fact table of two segments with equal dictionaries: one
    batch family, one
    dispatch, rows equal to the JAX package's and to numpy."""
    rng = np.random.default_rng(2024)
    rows = 40_000  # every brand in both halves: equal dictionaries
    fact = {"d_year": rng.integers(1992, 1999, rows).astype(np.int32),
            "p_brand": rng.integers(0, N_BRANDS, rows).astype(np.int32),
            "lo_revenue": rng.integers(1, 600_000, rows).astype(np.int32)}
    brands = {"b_id": np.arange(N_BRANDS, dtype=np.int32),
              "b_category": np.asarray([f"MFGR#{i % BRAND_CATEGORIES}"
                                        for i in range(N_BRANDS)], object),
              "b_region": np.asarray([BRAND_REGIONS[i % 5]
                                      for i in range(N_BRANDS)], object)}
    half = rows // 2
    fpaths = [_build(SSB, "ssb", {k: v[sl] for k, v in fact.items()},
                     tmp_path / f"s{i}")
              for i, sl in enumerate((slice(0, half), slice(half, rows)))]
    bpath = _build(BRANDS, "brands", brands, tmp_path / "b0")
    port, jax = QueryExecutor(device="cpu"), JaxQueryExecutor(backend="tpu")
    (ps, js), (pb, jb) = _both(SSB, "ssb"), _both(BRANDS, "brands")
    port.add_table(ps, [load_segment(p) for p in fpaths])
    port.add_dimension_table(pb, [load_segment(bpath)])
    jax.add_table(js, [jax_load(p) for p in fpaths])
    jax.add_dimension_table(jb, [jax_load(bpath)])
    try:
        got = port.execute_sql(Q7.format(t="ssb"))
        assert got.num_device_dispatches == 1
        assert sorted(got.result_table.rows) == sorted(
            _rows(port, jax, Q7.format(t="ssb")))
    finally:
        dim_tables.unregister_dimension_table("brands")
        jax_dim_tables.unregister_dimension_table("brands")
    asia = np.asarray([BRAND_REGIONS[b % 5] == "ASIA" for b in fact["p_brand"]])
    want: dict = {}
    for y, b, r in zip(fact["d_year"][asia], fact["p_brand"][asia],
                       fact["lo_revenue"][asia]):
        key = (int(y), f"MFGR#{b % BRAND_CATEGORIES}")
        want[key] = want.get(key, 0) + int(r)
    assert {(r[0], r[1]): r[2] for r in got.result_table.rows} == want
    assert len(want) == 7 * 8  # ASIA brands are b % 5 == 1: 8 categories
