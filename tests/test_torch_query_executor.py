"""SQL end to end: the port's QueryExecutor against the JAX package's.

A 3-segment SSB-shaped table of a few thousand rows is built from seeded
numpy columns and loaded by both packages. Every query's rows from the
port's `QueryExecutor(device="cpu")` (the kernels' plain PyTorch versions)
must equal the JAX `QueryExecutor(backend="tpu")` rows, with the fused
Pallas kernel in interpret mode, and the `backend="host"` rows. Integer
results are element-equal; float64 sums of DOUBLE columns agree to rtol
1e-12, because the engines add in a different order. The three segments
share a pad bucket and a plan, so both device engines run them as one
batch family: one dispatch (the JAX package's count, its segment cache
off so every query dispatches) and one host fetch.
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from pinot_tpu.engine.query_executor import QueryExecutor as JaxQueryExecutor
from pinot_tpu.segment.loader import load_segment as jax_load
from pinot_tpu.spi.data_types import Schema as JaxSchema
from pinot_tpu_torch.engine.aggregation import UnsupportedQueryError
from pinot_tpu_torch.engine.query_executor import QueryExecutor
from pinot_tpu_torch.ops import _cuda
from pinot_tpu_torch.query.parser.sql import parse_sql
from pinot_tpu_torch.segment.builder import SegmentBuilder
from pinot_tpu_torch.segment.loader import load_segment
from pinot_tpu_torch.spi.data_types import Schema
from pinot_tpu_torch.spi.table_config import IndexingConfig, TableConfig

ROWS_PER_SEGMENT = 2500
SEGMENTS = 3
TABLE = "torch_qe_ssb"
DIMS = [("d_year", "INT"), ("p_brand", "INT"), ("s_region", "STRING"),
        ("lo_discount", "INT"), ("lo_quantity", "INT")]
METRICS = [("lo_extendedprice", "INT"), ("lo_revenue", "INT"),
           ("lo_tax", "DOUBLE"), ("lo_delta", "INT")]
RAW = ["lo_extendedprice", "lo_revenue", "lo_quantity", "lo_tax", "lo_delta"]
REGIONS = ["AMERICA", "ASIA", "EUROPE", "AFRICA", "MIDDLE EAST"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    rng = np.random.default_rng(17)
    n = ROWS_PER_SEGMENT * SEGMENTS
    cols = {
        "d_year": rng.integers(1992, 1999, n).astype(np.int32),
        "p_brand": rng.integers(0, 300, n).astype(np.int32),
        "s_region": np.asarray(REGIONS, dtype=object)[rng.integers(0, 5, n)],
        "lo_discount": rng.integers(0, 11, n).astype(np.int32),
        "lo_quantity": rng.integers(1, 51, n).astype(np.int32),
        "lo_extendedprice": rng.integers(1, 55_001, n).astype(np.int32),
        "lo_revenue": rng.integers(1, 600_000, n).astype(np.int32),
        "lo_tax": rng.normal(0.0, 1e3, n),
        "lo_delta": rng.integers(-70_000, 70_000, n).astype(np.int32),
    }
    schema = Schema.build(TABLE, dimensions=DIMS, metrics=METRICS)
    cfg = TableConfig(table_name=TABLE,
                      indexing=IndexingConfig(no_dictionary_columns=RAW))
    root = tmp_path_factory.mktemp("torch_qe")
    paths = []
    for i in range(SEGMENTS):
        sl = slice(i * ROWS_PER_SEGMENT, (i + 1) * ROWS_PER_SEGMENT)
        path = root / f"seg_{i}"
        SegmentBuilder(schema, cfg, f"seg_{i}").build(
            {k: v[sl] for k, v in cols.items()}, path)
        paths.append(path)
    port = QueryExecutor(device="cpu")
    port.add_table(schema, [load_segment(p) for p in paths])
    jschema = JaxSchema.build(TABLE, dimensions=DIMS, metrics=METRICS)
    jax_tpu = JaxQueryExecutor(backend="tpu")
    jax_host = JaxQueryExecutor(backend="host")
    for qe in (jax_tpu, jax_host):
        qe.add_table(jschema, [jax_load(p) for p in paths])
    return port, jax_tpu, jax_host


# (sql, exact, ordered)
QUERIES = [
    # q1: ungrouped, three-term filter
    (f"SELECT SUM(lo_extendedprice) FROM {TABLE} WHERE d_year = 1993 "
     "AND lo_discount BETWEEN 1 AND 3 AND lo_quantity < 25", True, False),
    # q2: the fused shape
    (f"SELECT d_year, p_brand, SUM(lo_revenue) FROM {TABLE} "
     "WHERE s_region = 'ASIA' GROUP BY d_year, p_brand LIMIT 10000",
     True, False),
    # q9: three limb-planed sums
    (f"SELECT d_year, p_brand, SUM(lo_revenue), SUM(lo_extendedprice), "
     f"SUM(lo_quantity) FROM {TABLE} WHERE s_region = 'ASIA' "
     "GROUP BY d_year, p_brand LIMIT 10000", True, False),
    # q2 on the two-step path
    (f"SET useFusedKernel = false; SELECT d_year, p_brand, SUM(lo_revenue) "
     f"FROM {TABLE} WHERE s_region = 'ASIA' GROUP BY d_year, p_brand "
     "LIMIT 10000", True, False),
    # the flagship shape: COUNT/SUM on limbs, MIN/MAX by scatter
    (f"SELECT p_brand, SUM(lo_revenue), COUNT(*), MIN(lo_revenue), "
     f"MAX(lo_revenue) FROM {TABLE} WHERE d_year >= 1995 GROUP BY p_brand "
     "LIMIT 1000", True, False),
    # dict-LUT runs on the fused path, signed sums
    (f"SELECT d_year, SUM(lo_delta), COUNT(*) FROM {TABLE} "
     "WHERE s_region IN ('ASIA', 'EUROPE') GROUP BY d_year LIMIT 10",
     True, False),
    # AVG and ORDER BY ... LIMIT through the broker reduce
    (f"SELECT s_region, AVG(lo_quantity), COUNT(*) FROM {TABLE} "
     "GROUP BY s_region ORDER BY COUNT(*) DESC, s_region LIMIT 3",
     True, True),
    (f"SELECT d_year, SUM(lo_revenue) FROM {TABLE} GROUP BY d_year "
     "ORDER BY SUM(lo_revenue) DESC LIMIT 4", True, True),
    # DOUBLE column: min/max exact, sums to rtol
    (f"SELECT d_year, MIN(lo_tax), MAX(lo_tax), SUM(lo_tax), AVG(lo_tax) "
     f"FROM {TABLE} WHERE lo_discount < 6 GROUP BY d_year LIMIT 10",
     False, False),
    (f"SELECT COUNT(*), MIN(lo_delta), MAX(lo_delta), AVG(lo_revenue) "
     f"FROM {TABLE} WHERE p_brand NOT IN (3, 5, 7)", True, False),
    # HAVING on an aggregate
    (f"SELECT p_brand, COUNT(*) FROM {TABLE} WHERE d_year = 1996 "
     "GROUP BY p_brand HAVING COUNT(*) > 4 LIMIT 1000", True, False),
    # PERCENTILE over a dictionary column (a value histogram per group)
    (f"SELECT d_year, PERCENTILE(lo_discount, 50) FROM {TABLE} "
     "GROUP BY d_year", True, False),
    # selection: the first matching rows, in segment order
    (f"SELECT d_year, lo_revenue FROM {TABLE} WHERE s_region = 'ASIA' "
     "LIMIT 10", True, True),
]


def _cells_equal(a, b, exact):
    if isinstance(a, float) or isinstance(b, float):
        a, b = float(a), float(b)
        if math.isnan(a) or math.isnan(b):
            return math.isnan(a) and math.isnan(b)
        return a == b if exact else math.isclose(a, b, rel_tol=1e-12)
    return a == b


def _assert_rows_equal(got, want, exact, ordered, label):
    if not ordered:
        got, want = sorted(map(tuple, got)), sorted(map(tuple, want))
    assert len(got) == len(want), label
    for rg, rw in zip(got, want):
        assert len(rg) == len(rw), label
        assert all(_cells_equal(a, b, exact) for a, b in zip(rg, rw)), \
            (label, rg, rw)


@pytest.fixture(autouse=True)
def _caches_off(monkeypatch):
    # the port's segment partial cache (on by default, as the JAX
    # package's) would answer a repeated statement with no dispatch and no
    # fetch: these tests count both
    monkeypatch.setenv("PINOT_TPU_SEGMENT_CACHE", "0")
    monkeypatch.setenv("PINOT_TPU_RESULT_CACHE", "0")


@pytest.mark.parametrize("sql,exact,ordered", QUERIES)
def test_execute_sql_matches_jax(tables, sql, exact, ordered, monkeypatch):
    port, jax_tpu, jax_host = tables
    monkeypatch.setenv("PINOT_TPU_FUSED", "interpret")
    monkeypatch.setenv("PINOT_TPU_SEGMENT_CACHE", "0")
    got = port.execute_sql(sql)
    assert got.total_docs == ROWS_PER_SEGMENT * SEGMENTS
    for label, qe in (("tpu", jax_tpu), ("host", jax_host)):
        want = qe.execute_sql(sql)
        assert not want.exceptions, want.exceptions
        if label == "tpu":
            assert got.num_device_dispatches == want.num_device_dispatches == 1
        assert got.result_table.schema.to_json() == \
            want.result_table.schema.to_json()
        _assert_rows_equal(got.result_table.rows, want.result_table.rows,
                           exact, ordered, label)
        assert got.num_docs_scanned == want.num_docs_scanned, label


def test_segments_fetch_once_each(tables):
    from pinot_tpu_torch.ops import kernels

    port = tables[0]
    before = kernels.host_fetches()
    port.execute_sql(QUERIES[1][0])
    assert kernels.host_fetches() - before == 1
    # without batching every segment dispatches alone, and the query
    # still fetches their outputs in one copy
    before = kernels.host_fetches()
    solo = port.execute_sql("SET segmentBatch = false; " + QUERIES[1][0])
    assert solo.num_device_dispatches == SEGMENTS
    assert kernels.host_fetches() - before == 1


def test_cpu_run_launches_no_kernel(tables):
    port = tables[0]
    before = dict(_cuda.LAUNCHES)
    port.execute_sql(QUERIES[1][0])
    port.execute_sql(QUERIES[3][0])
    assert _cuda.LAUNCHES == before


@pytest.mark.parametrize("sql", [
    # a selection transform numpy does not evaluate here (null planes):
    # the JAX package's host engine
    f"SELECT coalesce(lo_tax, 0) FROM {TABLE} LIMIT 10",
    # PERCENTILE over a raw column: the JAX package's host engine
    f"SELECT d_year, PERCENTILE(lo_revenue, 50) FROM {TABLE} GROUP BY d_year",
    f"SELECT lo_revenue, COUNT(*) FROM {TABLE} GROUP BY lo_revenue",
    f"SELECT d_year, SUMMV(lo_revenue) FROM {TABLE} GROUP BY d_year",
    f"SELECT d_year, EXPRMIN(lo_revenue, lo_tax) FROM {TABLE} GROUP BY d_year",
])
def test_unported_shapes_raise(tables, sql, monkeypatch):
    """The port's single-stage engine refuses these. execute_sql retries
    them on the multi-stage engine, as the JAX package does under
    backend="tpu": the rows are the JAX package's, and the docs scanned
    and dispatches are its multi-stage engine's (its single-stage engine
    plans the COALESCE selection itself). Where the JAX package's
    multi-stage engine fails too, the port raises."""
    port, jax_tpu, _ = tables
    monkeypatch.setenv("PINOT_TPU_FUSED", "interpret")
    with pytest.raises(UnsupportedQueryError):
        port.execute(parse_sql(sql))
    want = jax_tpu.execute_sql(sql)
    if want.exceptions:
        with pytest.raises(UnsupportedQueryError):
            port.execute_sql(sql)
        return
    got = port.execute_sql(sql)
    ordered = "GROUP BY" not in sql
    _assert_rows_equal(got.result_table.rows, want.result_table.rows,
                       True, ordered, sql)
    mse = jax_tpu.execute_sql("SET useMultistageEngine = true; " + sql)
    assert got.num_docs_scanned == mse.num_docs_scanned
    assert got.num_device_dispatches == mse.num_device_dispatches


def test_join_is_answered_by_the_multistage_engine(tables):
    """A JOIN goes to the multi-stage engine (mse/), as in the JAX package:
    the same rows."""
    sql = (f"SELECT a.s_region, COUNT(*), SUM(b.lo_revenue) FROM {TABLE} a "
           f"JOIN {TABLE} b ON a.p_brand = b.p_brand WHERE a.d_year = 1993 "
           "AND a.lo_quantity < 5 AND b.lo_discount = 0 GROUP BY a.s_region")
    got = tables[0].execute_sql(sql)
    want = tables[1].execute_sql(sql)
    assert not want.exceptions and got.mse_stage_stats
    assert sorted(got.result_table.rows) == sorted(want.result_table.rows)
