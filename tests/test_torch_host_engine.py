"""The host engine and the backend selector of the port's QueryExecutor
against the JAX package's.

One table of four segments (the port's builder, from a numpy seed; 7,400
rows): `d_year` sorted in every segment (its sorted index), `s_region`
with an inverted index, `p_brand` with an inverted and a range index
(the dictionary range rides the inverted index), `ts` raw with a range
index, `lat` / `lng` raw with a geo index, `note` a raw STRING, `tags` a
multi-value STRING, `lo_disc` with nulls. About 60 query shapes run on
the port's `QueryExecutor(device="cpu", backend=...)` and the JAX
package's `QueryExecutor(backend=...)`: "host" against "host" and "auto"
against "auto", with the JAX Pallas kernels interpreted and both caches
off. Compared: rows, docs scanned and device dispatches. Tolerance: exact
for every cell, floats included (the host states are built alike and the
combine merges them in the same segment order in both packages), except
the float cells of MOMENT_SHAPES under "auto", held to rel 1e-12: those
plan on the device, where the port's f64 sums of squares and products
reduce in another order than XLA's.

Then: a realtime table whose consuming snapshot the planner refuses
while the committed segment plans (one device family, the snapshot on
the host engine), star-tree views' host intermediates, `num_threads=4`
against 1 with the spans nested under the query's, EXPLAIN under
"host", and the faults "auto" must not reroute: an injected
`RealtimeUploadError` and a failing kernel call both raise.
"""

from __future__ import annotations

import numpy as np
import pytest

from pinot_tpu.engine.query_executor import QueryExecutor as JaxQueryExecutor
from pinot_tpu.segment.loader import load_segment as jax_load
from pinot_tpu.segment.mutable import MutableSegment as JaxMutable
from pinot_tpu.spi.data_types import Schema as JaxSchema
from pinot_tpu_torch.engine import query_executor as qe_mod
from pinot_tpu_torch.engine.aggregation import UnsupportedQueryError
from pinot_tpu_torch.engine.query_executor import QueryExecutor
from pinot_tpu_torch.ops import mxu_groupby
from pinot_tpu_torch.query.parser.sql import parse_sql
from pinot_tpu_torch.realtime import device_plane
from pinot_tpu_torch.segment.builder import MultiValues, SegmentBuilder
from pinot_tpu_torch.segment.loader import load_segment
from pinot_tpu_torch.segment.mutable import MutableSegment
from pinot_tpu_torch.spi import faults
from pinot_tpu_torch.spi.data_types import Schema
from pinot_tpu_torch.spi.table_config import IndexingConfig, TableConfig
from pinot_tpu_torch.spi.trace import TRACING

SIZES = [2400, 1800, 1200, 2000]
DIMS = [("d_year", "INT"), ("s_region", "STRING"), ("p_brand", "INT"),
        ("note", "STRING"), ("tags", "STRING", False), ("user_id", "INT"),
        ("url", "STRING"), ("codes", "INT", False)]
METRICS = [("lo_revenue", "INT"), ("lo_tax", "DOUBLE"), ("ts", "LONG"),
           ("lat", "DOUBLE"), ("lng", "DOUBLE"), ("lo_disc", "INT")]
REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]
TAGS = ["red", "green", "blue", "gold"]
URLS = ["/home", "/cart", "/pay", "/done"]
INDEXING = dict(
    inverted_index_columns=["s_region", "p_brand", "tags"],
    range_index_columns=["p_brand", "ts"],
    no_dictionary_columns=["ts", "lat", "lng", "note", "lo_tax"],
    geo_index_configs=[{"latColumn": "lat", "lngColumn": "lng",
                        "resolutionDeg": 0.5}])
STEPS = "url = '/cart', url = '/pay', url = '/done'"

SHAPES = [
    # filters over each index, and scans
    "SELECT COUNT(*) FROM d WHERE s_region = 'ASIA'",
    "SELECT COUNT(*) FROM d WHERE s_region <> 'ASIA'",
    "SELECT COUNT(*), SUM(lo_revenue) FROM d "
    "WHERE s_region IN ('ASIA', 'EUROPE', 'NOWHERE')",
    "SELECT COUNT(*) FROM d WHERE s_region NOT IN ('ASIA', 'AFRICA')",
    "SELECT COUNT(*) FROM d WHERE p_brand BETWEEN 10 AND 20",
    "SELECT COUNT(*) FROM d WHERE p_brand > 35",
    "SELECT COUNT(*) FROM d WHERE d_year = 1995",
    "SELECT COUNT(*) FROM d WHERE d_year >= 1994 AND d_year < 1997",
    "SELECT COUNT(*), MAX(ts) FROM d WHERE ts BETWEEN 20000 AND 40000",
    "SELECT COUNT(*) FROM d WHERE ts > 90000",
    "SELECT COUNT(*) FROM d WHERE lo_tax < 20.5",
    "SELECT COUNT(*) FROM d WHERE note = 'n3'",
    "SELECT COUNT(*) FROM d WHERE note LIKE 'n%4'",
    "SELECT COUNT(*) FROM d WHERE REGEXP_LIKE(s_region, '^A')",
    "SELECT COUNT(*) FROM d WHERE s_region = 'ASIA' OR p_brand < 5",
    "SELECT COUNT(*) FROM d WHERE NOT (s_region = 'ASIA') AND p_brand < 20",
    "SELECT COUNT(*) FROM d WHERE lo_disc IS NULL",
    "SELECT COUNT(*) FROM d WHERE lo_disc IS NOT NULL",
    "SELECT COUNT(*) FROM d WHERE tags = 'gold'",
    "SELECT COUNT(*) FROM d WHERE tags IN ('red', 'blue')",
    "SELECT COUNT(*), SUM(lo_revenue) FROM d "
    "WHERE ST_DISTANCE(lat, lng, 40.0, -100.0) < 300000",
    "SELECT COUNT(*) FROM d "
    "WHERE ST_DISTANCE(lat, lng, 35.0, -90.0) BETWEEN 100000 AND 500000",
    "SELECT COUNT(*) FROM d WHERE lo_revenue + 10 > 3000",
    # ungrouped aggregations
    "SELECT SUM(lo_revenue), MIN(lo_tax), MAX(lo_tax), AVG(lo_tax) FROM d",
    "SELECT MINMAXRANGE(lo_revenue), COUNT(lo_revenue) FROM d",
    "SELECT DISTINCTCOUNT(p_brand), DISTINCTCOUNTHLL(user_id) FROM d",
    "SELECT PERCENTILE(lo_revenue, 90), PERCENTILETDIGEST(lo_tax, 50) "
    "FROM d",
    "SELECT MODE(p_brand), HISTOGRAM(lo_revenue, 0, 5000, 10) FROM d",
    "SELECT STDDEVPOP(lo_tax), VARSAMP(lo_revenue), SKEWNESS(lo_tax) FROM d",
    "SELECT CORR(lo_revenue, lo_tax), COVARPOP(lo_revenue, lo_tax) FROM d",
    "SELECT SUMPRECISION(lo_revenue), EXPRMIN(p_brand, lo_tax) FROM d",
    "SELECT LASTWITHTIME(lo_revenue, ts, 'INT') FROM d",
    "SELECT SUM(lo_revenue) FILTER (WHERE s_region = 'ASIA'), COUNT(*) "
    "FROM d",
    "SELECT SUMMV(codes), COUNTMV(codes), MAXMV(codes) FROM d",
    "SELECT DISTINCTCOUNTMV(tags) FROM d",
    "SELECT SUM(lo_revenue * 2), MAX(ABS(lo_revenue - 2500)) FROM d",
    # group-by
    "SELECT s_region, COUNT(*), SUM(lo_revenue) FROM d GROUP BY s_region "
    "ORDER BY s_region",
    "SELECT d_year, s_region, SUM(lo_revenue), AVG(lo_tax) FROM d "
    "GROUP BY d_year, s_region ORDER BY d_year, s_region LIMIT 100",
    "SELECT p_brand, MIN(lo_revenue), MAX(lo_revenue) FROM d "
    "WHERE s_region = 'EUROPE' GROUP BY p_brand ORDER BY p_brand LIMIT 50",
    "SELECT s_region, DISTINCTCOUNT(p_brand), PERCENTILE(lo_revenue, 50) "
    "FROM d GROUP BY s_region ORDER BY s_region",
    "SELECT s_region, EXPRMAX(p_brand, lo_tax) FROM d GROUP BY s_region "
    "ORDER BY s_region",
    "SELECT note, COUNT(*) FROM d GROUP BY note ORDER BY note",
    "SELECT ABS(lo_revenue - 2500) / 1000, COUNT(*) FROM d "
    "GROUP BY ABS(lo_revenue - 2500) / 1000 "
    "ORDER BY ABS(lo_revenue - 2500) / 1000",
    "SELECT tags, COUNT(*), SUM(lo_revenue) FROM d GROUP BY tags "
    "ORDER BY tags",
    "SELECT s_region, tags, COUNT(*) FROM d GROUP BY s_region, tags "
    "ORDER BY s_region, tags LIMIT 100",
    "SELECT s_region, SUM(lo_revenue) FROM d GROUP BY s_region "
    "HAVING SUM(lo_revenue) > 1000000 ORDER BY s_region",
    "SELECT s_region, COUNT(*) FILTER (WHERE lo_tax > 30) FROM d "
    "GROUP BY s_region ORDER BY s_region",
    "SELECT d_year, SUM(lo_revenue) FROM d "
    "WHERE ST_DISTANCE(lat, lng, 40.0, -100.0) < 800000 GROUP BY d_year "
    "ORDER BY d_year",
    "SELECT DISTINCT s_region FROM d ORDER BY s_region",
    "SELECT DISTINCT d_year, s_region FROM d ORDER BY d_year, s_region "
    "LIMIT 50",
    # funnels
    f"SELECT FUNNELCOUNT(STEPS({STEPS}), CORRELATE_BY(user_id)) FROM d",
    f"SELECT s_region, FUNNELCOUNT(STEPS({STEPS}), CORRELATE_BY(user_id)) "
    "FROM d GROUP BY s_region ORDER BY s_region",
    f"SELECT FUNNELMAXSTEP(ts, 5000, 3, {STEPS}) FROM d",
    f"SELECT d_year, FUNNELCOMPLETECOUNT(ts, 20000, 3, {STEPS}) FROM d "
    "GROUP BY d_year ORDER BY d_year",
    # selections
    "SELECT user_id, s_region, lo_revenue FROM d WHERE s_region = 'ASIA' "
    "ORDER BY lo_revenue DESC, user_id LIMIT 7",
    "SELECT note, ts FROM d WHERE ts BETWEEN 1000 AND 9000 ORDER BY ts "
    "LIMIT 5",
    "SELECT p_brand, lo_revenue * 2 FROM d ORDER BY lo_revenue * 2 DESC, "
    "p_brand LIMIT 4",
    "SELECT d_year, p_brand FROM d WHERE p_brand = 7 LIMIT 3 OFFSET 2",
    "SELECT lat, lng FROM d WHERE ST_DISTANCE(lat, lng, 40.0, -100.0) "
    "< 100000 ORDER BY lat LIMIT 5",
    # null handling
    "SET enableNullHandling = true; SELECT COUNT(lo_disc), SUM(lo_disc) "
    "FROM d WHERE lo_disc > 10 OR s_region = 'ASIA'",
    "SET enableNullHandling = true; SELECT s_region, AVG(lo_disc) FROM d "
    "GROUP BY s_region ORDER BY s_region",
]


MOMENT_SHAPES = {s for s in SHAPES if "STDDEVPOP" in s or "CORR(" in s}


@pytest.fixture(autouse=True)
def _jax_dispatches_every_query(monkeypatch):
    monkeypatch.setenv("PINOT_TPU_SEGMENT_CACHE", "0")
    monkeypatch.setenv("PINOT_TPU_RESULT_CACHE", "0")
    monkeypatch.setenv("PINOT_TPU_MESH_DEVICES", "1")
    monkeypatch.setenv("PINOT_TPU_FUSED", "interpret")


def _schemas():
    return (Schema.build("d", dimensions=DIMS, metrics=METRICS),
            JaxSchema.build("d", dimensions=DIMS, metrics=METRICS))


def _cols(rng, n, year0):
    lens = rng.integers(1, 4, n)
    disc = rng.integers(0, 50, n).astype(object)
    disc[rng.random(n) < 0.1] = None
    return {
        "d_year": np.sort(rng.integers(year0, year0 + 5, n)).astype(np.int32),
        "s_region": np.asarray(REGIONS, dtype=object)[rng.integers(0, 5, n)],
        "p_brand": rng.integers(0, 40, n).astype(np.int32),
        "note": np.asarray([f"n{k}" for k in rng.integers(0, 15, n)],
                           dtype=object),
        "tags": MultiValues(np.asarray(TAGS, dtype=object)[
            rng.integers(0, 4, int(lens.sum()))], lens),
        "user_id": rng.integers(0, 90, n).astype(np.int32),
        "codes": MultiValues(rng.integers(0, 30, int(lens.sum()))
                             .astype(np.int32), lens),
        "url": np.asarray(URLS, dtype=object)[rng.integers(0, 4, n)],
        "lo_revenue": rng.integers(0, 5000, n).astype(np.int32),
        "lo_tax": np.round(rng.gamma(3.0, 9.0, n), 2),
        "ts": rng.integers(0, 100_000, n).astype(np.int64),
        "lat": rng.uniform(25.0, 50.0, n),
        "lng": rng.uniform(-125.0, -70.0, n),
        "lo_disc": list(disc),
    }


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    rng = np.random.default_rng(2222)
    schema, _ = _schemas()
    cfg = TableConfig(table_name="d", indexing=IndexingConfig(**INDEXING))
    root = tmp_path_factory.mktemp("torch_host_engine")
    out = []
    for i, n in enumerate(SIZES):
        SegmentBuilder(schema, cfg, f"s{i}").build(
            _cols(rng, n, 1992 + i), root / f"s{i}")
        out.append(root / f"s{i}")
    return out


def _pair(paths, backend, num_threads=1):
    schema, jschema = _schemas()
    port = QueryExecutor(device="cpu", backend=backend,
                         num_threads=num_threads)
    port.add_table(schema, [load_segment(p) for p in paths])
    jax = JaxQueryExecutor(backend=backend, num_threads=num_threads)
    jax.add_table(jschema, [jax_load(p) for p in paths])
    return port, jax


@pytest.fixture(scope="module")
def engines(paths):
    return {b: _pair(paths, b) for b in ("host", "auto")}


def _assert_same(got, want, sql, rel=0.0):
    assert not want.exceptions, (sql, want.exceptions)
    if rel:
        assert got.result_table.rows == [
            [pytest.approx(c, rel=rel) if isinstance(c, float) else c
             for c in row] for row in want.result_table.rows], sql
    else:
        assert got.result_table.rows == want.result_table.rows, sql
    assert got.num_docs_scanned == want.num_docs_scanned, sql
    assert got.num_device_dispatches == want.num_device_dispatches, sql


@pytest.mark.parametrize("backend", ["host", "auto"])
@pytest.mark.parametrize("sql", SHAPES)
def test_shape_answers_as_jax(engines, backend, sql):
    port, jax = engines[backend]
    got = port.execute_sql(sql)
    _assert_same(got, jax.execute_sql(sql), sql,
                 1e-12 if backend == "auto" and sql in MOMENT_SHAPES else 0.0)
    if backend == "host":
        assert got.num_device_dispatches == 0


def test_the_index_backed_filters_read_their_indexes(paths):
    """Each index answers its predicate alone: with the column's values
    unreadable, an inverted, sorted, raw range and geo index still give
    the scan's count."""
    port, _ = _pair(paths, "host")
    scan = {sql: port.execute_sql(sql).result_table.rows for sql in (
        "SELECT COUNT(*) FROM d WHERE s_region = 'ASIA'",
        "SELECT COUNT(*) FROM d WHERE d_year BETWEEN 1993 AND 1995",
        "SELECT COUNT(*) FROM d WHERE ts BETWEEN 20000 AND 40000")}
    segs = port.tables["d"].segments
    for seg in segs:
        assert seg.get_inverted_index("s_region") is not None
        assert seg.get_sorted_index("d_year") is not None
        assert seg.get_range_index("ts") is not None
        assert seg.get_geo_index("lat", "lng") is not None

        def refuse(column, _orig=seg.get_values):
            if column in ("s_region", "d_year", "ts"):
                raise AssertionError(f"{column} scanned")
            return _orig(column)
        seg.get_values = refuse
    try:
        for sql, rows in scan.items():
            assert port.execute_sql(sql).result_table.rows == rows
    finally:
        for seg in segs:
            del seg.get_values


def test_default_backend_still_refuses(paths):
    """Under the default "device" a funnel is refused as before (and the
    multi-stage engine does not answer it either)."""
    schema, _ = _schemas()
    port = QueryExecutor(device="cpu")
    assert port.backend == "device"
    port.add_table(schema, [load_segment(p) for p in paths])
    sql = f"SELECT FUNNELCOUNT(STEPS({STEPS}), CORRELATE_BY(user_id)) FROM d"
    with pytest.raises(UnsupportedQueryError):
        port.execute(parse_sql(sql))
    with pytest.raises(ValueError):
        QueryExecutor(device="cpu", backend="tpu")


@pytest.mark.parametrize("sql", [SHAPES[2], SHAPES[37], SHAPES[52],
                                 SHAPES[56]])
def test_four_host_threads_answer_as_one(paths, sql):
    one, _ = _pair(paths, "host")
    four, _ = _pair(paths, "host", num_threads=4)
    a, b = one.execute_sql(sql), four.execute_sql(sql)
    assert a.result_table.rows == b.result_table.rows
    assert a.num_docs_scanned == b.num_docs_scanned


def test_worker_spans_nest_under_the_query(paths):
    port, _ = _pair(paths, "host", num_threads=4)
    resp = port.execute_sql("SET trace = true; " + SHAPES[37])
    spans = {s["spanId"]: s for s in resp.trace_info}
    segs = [s for s in resp.trace_info
            if s["operator"].startswith("segment:")]
    assert sorted(s["operator"] for s in segs) == \
        [f"segment:s{i}" for i in range(4)]
    for s in segs:
        assert spans[s["parentId"]]["operator"] == "QUERY_PLAN_EXECUTION"


@pytest.mark.parametrize("backend", ["host", "auto"])
@pytest.mark.parametrize("sql", [SHAPES[37], SHAPES[0], SHAPES[51],
                                 SHAPES[20], SHAPES[56]])
def test_explain_under_host_as_jax(engines, backend, sql):
    port, jax = engines[backend]
    q = f"EXPLAIN PLAN FOR {sql}"
    assert port.execute_sql(q).result_table.rows == \
        jax.execute_sql(q).result_table.rows, (backend, q)


# -- star-tree views' host intermediates ---------------------------------------

ST_SQL = [
    "SELECT s_region, SUM(lo_revenue), COUNT(*) FROM d GROUP BY s_region "
    "ORDER BY s_region",
    "SELECT SUM(lo_revenue), MAX(lo_revenue) FROM d WHERE s_region = 'ASIA'",
    "SELECT d_year, s_region, AVG(lo_revenue) FROM d "
    "GROUP BY d_year, s_region ORDER BY d_year, s_region LIMIT 40",
]


@pytest.fixture(scope="module")
def star_paths(tmp_path_factory):
    rng = np.random.default_rng(77)
    schema, _ = _schemas()
    cfg = TableConfig(table_name="d", indexing=IndexingConfig(
        star_tree_index_configs=[{
            "dimensionsSplitOrder": ["d_year", "s_region"],
            "functionColumnPairs": ["COUNT__*", "SUM__lo_revenue",
                                    "MAX__lo_revenue"]}], **INDEXING))
    root = tmp_path_factory.mktemp("torch_host_star")
    out = []
    for i, n in enumerate([1500, 900]):
        SegmentBuilder(schema, cfg, f"t{i}").build(
            _cols(rng, n, 1992), root / f"t{i}")
        out.append(root / f"t{i}")
    return out


@pytest.mark.parametrize("backend", ["host", "auto"])
@pytest.mark.parametrize("sql", ST_SQL)
def test_star_tree_host_intermediates_as_jax(star_paths, backend, sql):
    port, jax = _pair(star_paths, backend)
    got = port.execute_sql(sql)
    _assert_same(got, jax.execute_sql(sql), sql)
    # the views answered: fewer docs read than the table holds
    assert got.num_docs_scanned < 2400 or "WHERE" in sql
    port.use_star_tree = jax.use_star_tree = False
    _assert_same(port.execute_sql(sql), jax.execute_sql(sql), sql)


# -- realtime: the consuming snapshot on the host engine ------------------------

RT_SQL = [
    "SELECT s_region, PERCENTILETDIGEST(lo_tax, 90) FROM rt "
    "GROUP BY s_region ORDER BY s_region",
    "SELECT s_region, COUNT(*), SUM(lo_revenue) FROM rt "
    "WHERE s_region <> 'ASIA' GROUP BY s_region ORDER BY s_region",
]


def _rt_rows(rng, n):
    return [{"s_region": REGIONS[int(rng.integers(0, 5))],
             "lo_revenue": int(rng.integers(0, 5000)),
             "lo_tax": float(np.round(rng.gamma(3.0, 9.0), 2))}
            for _ in range(n)]


@pytest.fixture(scope="module")
def realtime(tmp_path_factory):
    rng = np.random.default_rng(31)
    dims, mets = [("s_region", "STRING")], [("lo_revenue", "INT"),
                                            ("lo_tax", "DOUBLE")]
    schema = Schema.build("rt", dimensions=dims, metrics=mets)
    jschema = JaxSchema.build("rt", dimensions=dims, metrics=mets)
    committed = _rt_rows(rng, 1500)
    root = tmp_path_factory.mktemp("torch_host_rt")
    SegmentBuilder(schema, TableConfig(table_name="rt", indexing=IndexingConfig(
        no_dictionary_columns=["lo_tax"])), "c0").build_from_rows(
        committed, root / "c0")
    live, jlive = MutableSegment(schema, "live"), JaxMutable(jschema, "live")
    for r in _rt_rows(rng, 700):
        live.index(r)
        jlive.index(r)
    return (schema, jschema, root / "c0", live, jlive)


@pytest.mark.parametrize("sql", RT_SQL)
def test_realtime_mixed_query_as_jax(realtime, sql):
    """An adaptive histogram over the consuming raw DOUBLE: the realtime
    planner refuses the snapshot, the committed segment plans; under
    "auto" both packages answer the snapshot on the host engine in the
    same query, with the committed segment's one dispatch."""
    schema, jschema, path, live, jlive = realtime
    port = QueryExecutor(device="cpu", backend="auto")
    port.add_table(schema, [load_segment(path), live])
    jax = JaxQueryExecutor(backend="auto")
    jax.add_table(jschema, [jax_load(path), jlive])
    got = port.execute_sql(sql)
    _assert_same(got, jax.execute_sql(sql), sql)
    # the committed segment's one dispatch; the snapshot's too where it
    # plans
    assert got.num_device_dispatches == (1 if "PERCENTILE" in sql else 2)


# -- faults "auto" does not reroute ---------------------------------------------


def test_realtime_upload_fault_is_not_rerouted(realtime):
    """The reference answers an upload fault on its host engine; the port
    fails the query under every backend."""
    schema, _, path, live, _ = realtime
    port = QueryExecutor(device="cpu", backend="auto")
    port.add_table(schema, [load_segment(path), live])
    live.index({"s_region": "ASIA", "lo_revenue": 1, "lo_tax": 1.0})
    faults.FAULTS.arm("realtime.upload", kind="error", times=1)
    try:
        with pytest.raises(device_plane.RealtimeUploadError):
            port.execute_sql(RT_SQL[1])
    finally:
        faults.FAULTS.reset()


def test_kernel_failure_is_not_rerouted(paths, monkeypatch):
    port, _ = _pair(paths, "auto")

    def broken(*a, **k):
        raise RuntimeError("CUDA error: an illegal memory access")
    monkeypatch.setattr(mxu_groupby, "limb_sums", broken)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        port.execute_sql(SHAPES[37])
    monkeypatch.setattr(qe_mod.QueryExecutor, "dispatch_segments",
                        lambda *a, **k: (_ for _ in ()).throw(
                            qe_mod.HbmExhaustedError("injected")))
    with pytest.raises(qe_mod.HbmExhaustedError):
        port.execute_sql(SHAPES[37])
    assert TRACING.active_trace() is None
