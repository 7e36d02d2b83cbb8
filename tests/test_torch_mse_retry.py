"""Fault F13: a query the single-stage engine refuses is retried on the
multi-stage engine, as the JAX package's `execute_sql` retries it under
backend="tpu".

One table of four segments (12,100 rows, built once by the port's builder
from a numpy seed; `lo_revenue`, `lo_tax` and `tsr` raw, `note` a raw
STRING) and a realtime table (a consuming segment beside an immutable
one), the port's `QueryExecutor(device="cpu")` against the JAX package's
`QueryExecutor(backend="tpu")` with its Pallas kernels interpreted and
both caches off. Every shape of the F13 record answers with the JAX
package's rows, docs scanned and device dispatches, and both count the
server meter `queryExecutionExceptions` alike; shapes that both
multi-stage engines refuse still raise. Tolerance: exact (float cells to
rel 1e-12, where the two multi-stage engines sum in another order).
"""

from __future__ import annotations

import math

import numpy as np
import pytest

from pinot_tpu.engine.query_executor import QueryExecutor as JaxQueryExecutor
from pinot_tpu.segment.loader import load_segment as jax_load
from pinot_tpu.segment.mutable import MutableSegment as JaxMutable
from pinot_tpu.spi.data_types import Schema as JaxSchema
from pinot_tpu.spi.metrics import SERVER_METRICS as JAX_METRICS
from pinot_tpu_torch.engine.aggregation import UnsupportedQueryError
from pinot_tpu_torch.engine.query_executor import QueryExecutor
from pinot_tpu_torch.query.parser.sql import parse_sql
from pinot_tpu_torch.segment.builder import SegmentBuilder
from pinot_tpu_torch.segment.loader import load_segment
from pinot_tpu_torch.segment.mutable import MutableSegment
from pinot_tpu_torch.spi.data_types import Schema
from pinot_tpu_torch.spi.metrics import SERVER_METRICS, ServerMeter
from pinot_tpu_torch.spi.table_config import IndexingConfig, TableConfig

SIZES = [1200, 1200, 700, 9000]
DIMS = [("d_year", "INT"), ("s_region", "STRING"), ("p_brand", "INT"),
        ("note", "STRING"), ("ts", "TIMESTAMP"), ("tsr", "TIMESTAMP")]
METRICS = [("lo_revenue", "INT"), ("lo_tax", "DOUBLE")]
RAW = ["lo_revenue", "lo_tax", "tsr", "note"]
REGIONS = ["AMERICA", "ASIA", "EUROPE", "AFRICA", "MIDDLE EAST"]
DAY = 86_400_000
EXC = ServerMeter.QUERY_EXECUTION_EXCEPTIONS

# the F13 record (ROADMAP.md Queue 3): the JAX planner refuses each, and
# its multi-stage engine answers it
F13_SHAPES = [
    "SELECT s_region, PERCENTILE(lo_revenue, 90) FROM d GROUP BY s_region "
    "ORDER BY s_region",
    "SELECT s_region, SUMPRECISION(lo_revenue) FROM d GROUP BY s_region "
    "ORDER BY s_region",
    "SELECT s_region, EXPRMIN(lo_revenue, lo_tax) FROM d GROUP BY s_region "
    "ORDER BY s_region",
    "SELECT s_region, LASTWITHTIME(lo_revenue, ts, 'INT') FROM d "
    "GROUP BY s_region ORDER BY s_region",
    "SELECT d_year, ARRAYAGG(p_brand, 'INT') FROM d WHERE lo_revenue < 0 "
    "GROUP BY d_year ORDER BY d_year",
    "SELECT CASE WHEN lo_revenue > 1000 THEN 'hi' ELSE 'lo' END, COUNT(*) "
    "FROM d GROUP BY CASE WHEN lo_revenue > 1000 THEN 'hi' ELSE 'lo' END",
    "SELECT ABS(lo_revenue), COUNT(*) FROM d GROUP BY ABS(lo_revenue) "
    "ORDER BY ABS(lo_revenue) LIMIT 20",
    "SELECT tsr - MOD(tsr, 86400000), COUNT(*) FROM d "
    "GROUP BY tsr - MOD(tsr, 86400000) ORDER BY tsr - MOD(tsr, 86400000) "
    "LIMIT 20",
    "SELECT COUNT(*) FROM d WHERE note = 'n3'",
    "SELECT note, COUNT(*) FROM d GROUP BY note",
]
# both packages refuse these on both engines
REFUSED_BY_BOTH = [
    "SELECT 1, COUNT(*) FROM d GROUP BY 1",
    "SELECT nope, COUNT(*) FROM d GROUP BY nope",
]


@pytest.fixture(autouse=True)
def _jax_dispatches_every_query(monkeypatch):
    monkeypatch.setenv("PINOT_TPU_SEGMENT_CACHE", "0")
    monkeypatch.setenv("PINOT_TPU_RESULT_CACHE", "0")
    monkeypatch.setenv("PINOT_TPU_MESH_DEVICES", "1")
    monkeypatch.setenv("PINOT_TPU_FUSED", "interpret")


def _cols(rng, rows):
    return {
        "d_year": rng.integers(1992, 1999, rows).astype(np.int32),
        "s_region": np.asarray(REGIONS, dtype=object)[
            rng.integers(0, 5, rows)],
        "p_brand": rng.integers(0, 40, rows).astype(np.int32),
        "note": np.asarray([f"n{k}" for k in rng.integers(0, 7, rows)],
                           dtype=object),
        "ts": rng.integers(8035, 10592, rows).astype(np.int64) * DAY,
        "tsr": rng.integers(0, 1000 * DAY, rows).astype(np.int64),
        "lo_revenue": rng.integers(-500, 5000, rows).astype(np.int32),
        "lo_tax": np.round(rng.gamma(3.0, 9.0, rows), 2),
    }


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    rng = np.random.default_rng(1313)
    schema = Schema.build("d", dimensions=DIMS, metrics=METRICS)
    cfg = TableConfig(table_name="d",
                      indexing=IndexingConfig(no_dictionary_columns=RAW))
    root = tmp_path_factory.mktemp("torch_f13")
    paths = []
    for i, rows in enumerate(SIZES):
        SegmentBuilder(schema, cfg, f"s{i}").build(_cols(rng, rows),
                                                   root / f"s{i}")
        paths.append(root / f"s{i}")
    port = QueryExecutor(device="cpu")
    port.add_table(schema, [load_segment(p) for p in paths])
    jax = JaxQueryExecutor(backend="tpu")
    jax.add_table(JaxSchema.build("d", dimensions=DIMS, metrics=METRICS),
                  [jax_load(p) for p in paths])
    return port, jax


def _cell_equal(a, b):
    if isinstance(a, float) or isinstance(b, float):
        return math.isclose(float(a), float(b), rel_tol=1e-12)
    return a == b


def _assert_same_answer(got, want, ordered):
    g, w = got.result_table.rows, want.result_table.rows
    if not ordered:
        g, w = sorted(g, key=repr), sorted(w, key=repr)
    assert len(g) == len(w)
    for rg, rw in zip(g, w):
        assert len(rg) == len(rw)
        assert all(_cell_equal(a, b) for a, b in zip(rg, rw)), (rg, rw)
    assert got.num_docs_scanned == want.num_docs_scanned
    assert got.num_device_dispatches == want.num_device_dispatches


@pytest.mark.parametrize("sql", F13_SHAPES)
def test_refused_shape_answers_on_the_multistage_engine(tables, sql):
    port, jax = tables
    with pytest.raises(UnsupportedQueryError):
        port.execute(parse_sql(sql))
    p0, j0 = SERVER_METRICS.meter_count(EXC), JAX_METRICS.meter_count(EXC)
    want = jax.execute_sql(sql)
    assert not want.exceptions, want.exceptions
    got = port.execute_sql(sql)
    assert got.mse_stage_stats
    _assert_same_answer(got, want, "ORDER BY" in sql)
    assert SERVER_METRICS.meter_count(EXC) - p0 == \
        JAX_METRICS.meter_count(EXC) - j0 > 0


@pytest.mark.parametrize("sql", REFUSED_BY_BOTH)
def test_shape_refused_by_both_engines_still_raises(tables, sql):
    port, jax = tables
    p0, j0 = SERVER_METRICS.meter_count(EXC), JAX_METRICS.meter_count(EXC)
    assert jax.execute_sql(sql).exceptions
    with pytest.raises(UnsupportedQueryError):
        port.execute_sql(sql)
    assert SERVER_METRICS.meter_count(EXC) - p0 == \
        JAX_METRICS.meter_count(EXC) - j0


@pytest.mark.parametrize("sql", [
    # a selection ORDER BY on an unselected column (MultistageRefusal)
    "SELECT d_year, lo_revenue FROM d ORDER BY lo_tax, lo_revenue LIMIT 5",
    # the broker reduce's refusal: no engine answers it
    "SELECT s_region, SUM(lo_revenue) FROM d GROUP BY s_region "
    "ORDER BY d_year",
])
def test_query_level_refusal_counts_the_meter_as_jax(tables, sql):
    """The meter counts the single-stage refusal before the retry, as the
    reference's single-stage engine counts its failure."""
    port, jax = tables
    p0, j0 = SERVER_METRICS.meter_count(EXC), JAX_METRICS.meter_count(EXC)
    want = jax.execute_sql(sql)
    if want.exceptions:
        with pytest.raises(UnsupportedQueryError):
            port.execute_sql(sql)
    else:
        _assert_same_answer(port.execute_sql(sql), want, True)
    assert SERVER_METRICS.meter_count(EXC) - p0 == \
        JAX_METRICS.meter_count(EXC) - j0 == 1


# -- a realtime table -----------------------------------------------------------

LIVE_DIMS = [("site", "STRING"), ("day", "INT")]
LIVE_METRICS = [("clicks", "INT"), ("fare", "DOUBLE")]


@pytest.fixture(scope="module")
def live(tmp_path_factory):
    """An immutable segment and a consuming one of the same rows' schema,
    in both packages."""
    rng = np.random.default_rng(77)
    schema = Schema.build("live", dimensions=LIVE_DIMS, metrics=LIVE_METRICS)
    jschema = JaxSchema.build("live", dimensions=LIVE_DIMS,
                              metrics=LIVE_METRICS)
    cfg = TableConfig(table_name="live",
                      indexing=IndexingConfig(no_dictionary_columns=["fare"]))
    n = 600
    cols = {"site": np.asarray([f"s{k}" for k in rng.integers(0, 4, n)],
                               dtype=object),
            "day": rng.integers(0, 3, n).astype(np.int32),
            "clicks": rng.integers(0, 9, n).astype(np.int32),
            "fare": np.round(rng.gamma(2.0, 5.0, n), 2)}
    path = tmp_path_factory.mktemp("torch_f13_live") / "imm0"
    SegmentBuilder(schema, cfg, "imm0").build(
        {k: v[:400] for k, v in cols.items()}, path)
    pseg, jseg = MutableSegment(schema, "c0"), JaxMutable(jschema, "c0")
    for i in range(400, n):
        row = {k: (v[i].item() if hasattr(v[i], "item") else v[i])
               for k, v in cols.items()}
        pseg.index(dict(row))
        jseg.index(dict(row))
    port = QueryExecutor(device="cpu")
    port.add_table(schema, [load_segment(path), pseg])
    jax = JaxQueryExecutor(backend="tpu")
    jax.add_table(jschema, [jax_load(path), jseg])
    return port, jax


def test_realtime_shape_refused_on_the_immutable_segment(live):
    """The immutable segment's refusal sends both packages to their
    multi-stage engine, which reads the consuming snapshot too."""
    port, jax = live
    sql = ("SELECT site, PERCENTILE(fare, 50) FROM live GROUP BY site "
           "ORDER BY site")
    want = jax.execute_sql(sql)
    assert not want.exceptions
    _assert_same_answer(port.execute_sql(sql), want, True)


def test_realtime_shape_refused_only_on_the_consuming_snapshot(live):
    """A deliberate difference: the realtime planner refuses an adaptive
    histogram over the consuming segment's raw DOUBLE (its min moves while
    it consumes). The JAX package answers that snapshot on its host
    engine and its immutable segment on the device, in the single-stage
    engine (1 dispatch); the port has no host engine and answers the whole
    query on its multi-stage engine. The rows agree to the digest's
    accuracy; the docs scanned are the same; the dispatches differ."""
    port, jax = live
    sql = ("SELECT day, PERCENTILETDIGEST(fare, 50) FROM live GROUP BY day "
           "ORDER BY day")
    want = jax.execute_sql(sql)
    assert not want.exceptions and not want.mse_stage_stats
    got = port.execute_sql(sql)
    assert got.mse_stage_stats
    g, w = got.result_table.rows, want.result_table.rows
    assert [r[0] for r in g] == [r[0] for r in w]
    assert all(math.isclose(a[1], b[1], rel_tol=0.01) for a, b in zip(g, w))
    mse = jax.execute_sql("SET useMultistageEngine = true; " + sql)
    assert g == mse.result_table.rows
    assert got.num_docs_scanned == want.num_docs_scanned
    assert got.num_device_dispatches == mse.num_device_dispatches
    assert want.num_device_dispatches == 1
