"""The port's EXPLAIN, tracing and EXPLAIN ANALYZE against the JAX package.

Seeded numpy segments, built by the port's builder and loaded by both
packages: a table `ex` of 3 segments (dense keys, a sorted high-cardinality
key, an unsorted one, an MV column, a text index), a star-tree table `st`,
and a hybrid table `rt` (an immutable segment and a consuming one, each
package fed the same rows). The port's `QueryExecutor(device="cpu")` runs
against the JAX package's `QueryExecutor(backend="tpu")` (its Pallas
kernels interpreted), both with the segment partial cache off.

  * EXPLAIN PLAN FOR and EXPLAIN IMPLEMENTATION FOR: the rows equal the
    JAX package's for a dense GROUP BY, sparse presorted and sparse sort
    GROUP BYs, a star-tree query, a selection, an MV GROUP BY, an index
    mask, all segments pruned, a consuming table and a planner refusal.
    One row differs by design: a refusal renders UNSUPPORTED(no host
    engine: ...) in the port, HOST_ENGINE(numpy fallback: ...) in the JAX
    package, with the same message (the port has no host engine, so the
    query raises);
  * EXPLAIN ANALYZE: the operator labels and the Parent_Id tree equal the
    JAX package's, timings masked (`_masked`), over a family, solo
    dispatches, the fused kernel, the sparse device combine, a selection
    and a star-tree query; rows equal a plain run's;
  * `SET trace = true`: trace_info carries the spans, and tracing off
    allocates no span, makes no device timing and no extra fetch;
  * a traced run bypasses the segment partial cache; EXPLAIN ANALYZE does
    not, and shows the sparse path's merged hit.

Tolerance: exact (integer counts and sums).
"""

from __future__ import annotations

import re

import numpy as np
import pytest
import torch

from pinot_tpu.engine.query_executor import QueryExecutor as JaxQueryExecutor
from pinot_tpu.segment.loader import load_segment as jax_load
from pinot_tpu.segment.mutable import MutableSegment as JaxMutableSegment
from pinot_tpu.spi.data_types import Schema as JaxSchema
from pinot_tpu_torch.cache.partial import GLOBAL_PARTIAL_CACHE
from pinot_tpu_torch.engine import executor as port_executor
from pinot_tpu_torch.engine.query_executor import QueryExecutor
from pinot_tpu_torch.ops import kernels
from pinot_tpu_torch.segment.builder import SegmentBuilder
from pinot_tpu_torch.segment.loader import load_segment
from pinot_tpu_torch.segment.mutable import MutableSegment
from pinot_tpu_torch.spi.data_types import Schema
from pinot_tpu_torch.spi.table_config import IndexingConfig, TableConfig
from pinot_tpu_torch.spi.trace import TRACING, span_allocations

ROWS = 3000
SEGMENTS = 3
DIMS = [("k", "INT"), ("d", "INT"), ("b", "STRING"), ("sk", "INT"),
        ("hk", "INT"), ("tags", "INT", False), ("msg", "STRING")]
METRICS = [("v", "INT"), ("w", "LONG")]
ST_DIMS = [("country", "STRING"), ("browser", "STRING")]
ST_METRICS = [("clicks", "INT")]
ST_TREE = {"dimensionsSplitOrder": ["country", "browser"],
           "functionColumnPairs": ["COUNT__*", "SUM__clicks"],
           "maxLeafRecords": 10}
RT_DIMS = [("site", "STRING"), ("code", "INT")]
RT_METRICS = [("revenue", "LONG")]
WORDS = ["connection", "reset", "time", "error", "disk", "w1", "w2", "w3"]

SPARSE = "SET sparseGroupBy = true; "
NO_BATCH = "SET segmentBatch = false; "

# shape -> single-stage query; each runs as EXPLAIN PLAN FOR and EXPLAIN
# IMPLEMENTATION FOR
SHAPES = {
    "dense": ("SELECT k, SUM(v), COUNT(*) FROM ex WHERE b = 'x3' AND "
              "NOT (k < 10) GROUP BY k ORDER BY k LIMIT 5"),
    "dense_two_keys": ("SELECT k, d, SUM(v) FROM ex WHERE d < 7 "
                       "GROUP BY k, d LIMIT 50"),
    "sparse_presorted": (SPARSE + "SELECT sk, SUM(v), COUNT(*) FROM ex "
                         "GROUP BY sk ORDER BY sk LIMIT 100"),
    "sparse_sort": (SPARSE + "SELECT hk, SUM(v), MIN(w) FROM ex "
                    "WHERE d < 6 GROUP BY hk LIMIT 100"),
    "star_tree": ("SELECT country, SUM(clicks), COUNT(*) FROM st "
                  "GROUP BY country"),
    "selection": "SELECT k, b, v FROM ex WHERE d < 4 LIMIT 10",
    "mv_group": "SELECT tags, COUNT(*) FROM ex WHERE d < 8 GROUP BY tags",
    "index_mask": ("SELECT d, COUNT(*) FROM ex WHERE TEXT_MATCH(msg, "
                   "'\"connection reset\" OR time') GROUP BY d"),
    "all_pruned": "SELECT COUNT(*), SUM(v) FROM ex WHERE k > 1000",
    "consuming": "SELECT site, SUM(revenue) FROM rt GROUP BY site",
    "no_batch": NO_BATCH + "SELECT k, SUM(v) FROM ex GROUP BY k",
    "refusal": "SELECT EXPRMIN(b, v) FROM ex",
}

# single-stage queries under EXPLAIN ANALYZE
ANALYZE = {
    "family": "SELECT k, SUM(v), COUNT(*) FROM ex WHERE d < 9 GROUP BY k",
    "solo_fused": (NO_BATCH + "SELECT k, SUM(v), COUNT(*) FROM ex "
                   "WHERE d < 9 GROUP BY k"),
    "aggregation": "SELECT COUNT(*), SUM(w), MAX(v) FROM ex WHERE d = 3",
    "sparse_combine": (SPARSE + "SELECT hk, SUM(v), COUNT(*) FROM ex "
                       "GROUP BY hk ORDER BY hk LIMIT 200"),
    "selection": "SELECT k, v FROM ex WHERE d = 2 AND k < 4 LIMIT 20",
    "star_tree": "SELECT country, SUM(clicks) FROM st GROUP BY country",
    "mv_group": "SELECT tags, COUNT(*) FROM ex GROUP BY tags",
    "all_pruned": "SELECT COUNT(*) FROM ex WHERE k > 1000",
    "consuming": "SELECT site, SUM(revenue) FROM rt GROUP BY site",
}

# the timings an EXPLAIN ANALYZE label carries: masked before comparing
TIMINGS = ("ms", "timeMs", "deviceExecMs", "compileMs", "coalesceWaitMs",
           "device_partition_ms")
# Attributes that differ by design, normalized before comparing:
#   device:<type>  the port's family_dispatch spans name the device they
#                  ran on; the JAX package's name none (it has one device
#                  kind per process)
#   fused:<form>   the fused kernel's form: the port runs its plain
#                  version on the CPU ("plain"), the JAX package its
#                  Pallas kernel interpreted ("interpret")
#   compiles:<n>   the JAX package counts the jit compiles of the run;
#                  eager PyTorch compiles nothing, so the port's is 0
_TIMING_RE = re.compile(r"\b(" + "|".join(TIMINGS) + r"):[^,)]*")
_DEVICE_RE = re.compile(r"device:(cpu|cuda), ")
_FUSED_RE = re.compile(r"fused:(plain|interpret)")
_COMPILES_RE = re.compile(r"compiles:\d+")


def _masked(rows: list) -> list:
    out = []
    for op, oid, parent in rows:
        op = _TIMING_RE.sub(lambda m: m.group(1) + ":*", op)
        op = _DEVICE_RE.sub("", op)
        op = _FUSED_RE.sub("fused:*", op)
        op = _COMPILES_RE.sub("compiles:*", op)
        out.append([op, oid, parent])
    return out


@pytest.fixture(autouse=True)
def _uncached(monkeypatch):
    monkeypatch.setenv("PINOT_TPU_SEGMENT_CACHE", "0")
    monkeypatch.setenv("PINOT_TPU_RESULT_CACHE", "0")
    monkeypatch.setenv("PINOT_TPU_MESH_DEVICES", "1")
    monkeypatch.setenv("PINOT_TPU_FUSED", "interpret")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _ex_cols(rng, i: int) -> dict:
    """Equal cardinalities in every segment (one batch family); `sk`
    sorted, `hk` of about 3000 distinct values a segment."""
    tags = [list(rng.integers(0, 30, n)) for n in rng.integers(1, 4, ROWS)]
    tags[:10] = [[3 * j, 3 * j + 1, 3 * j + 2] for j in range(10)]
    k = rng.integers(0, 50, ROWS).astype(np.int32)
    k[:50] = np.arange(50)
    return {
        "k": k,
        "d": rng.integers(0, 12, ROWS).astype(np.int32),
        "b": np.asarray([f"x{j % 7}" for j in range(ROWS)], dtype=object),
        "sk": np.sort(rng.integers(0, 40_000, ROWS)).astype(np.int32),
        "hk": rng.integers(0, 50_000, ROWS).astype(np.int32),
        "tags": tags,
        "msg": np.asarray([" ".join(rng.choice(WORDS, 3))
                           for _ in range(ROWS)], dtype=object),
        "v": rng.integers(0, 100, ROWS).astype(np.int32),
        "w": rng.integers(-1000, 1000, ROWS).astype(np.int64),
    }


def _st_cols(rng) -> dict:
    n = 800
    return {"country": np.asarray(["US", "DE", "JP", "IN"], dtype=object)[
                rng.integers(0, 4, n)],
            "browser": np.asarray(["ff", "cr", "sa"], dtype=object)[
                rng.integers(0, 3, n)],
            "clicks": rng.integers(0, 50, n).astype(np.int32)}


def _rt_rows(rng, n: int) -> list:
    return [{"site": f"s{int(rng.integers(0, 5))}",
             "code": int(rng.integers(0, 20)),
             "revenue": int(rng.integers(0, 1000))} for _ in range(n)]


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    """(port, jax) over tables ex, st and rt."""
    root = tmp_path_factory.mktemp("torch_explain")
    rng = np.random.default_rng(4242)
    port = QueryExecutor(device="cpu")
    jax = JaxQueryExecutor(backend="tpu")

    ex_cfg = TableConfig(table_name="ex", indexing=IndexingConfig(
        no_dictionary_columns=["v", "w"], text_index_columns=["msg"]))
    paths = []
    for i in range(SEGMENTS):
        SegmentBuilder(Schema.build("ex", dimensions=DIMS, metrics=METRICS),
                       ex_cfg, f"ex_{i}").build(_ex_cols(rng, i),
                                                root / f"ex_{i}")
        paths.append(root / f"ex_{i}")
    port.add_table(Schema.build("ex", dimensions=DIMS, metrics=METRICS),
                   [load_segment(p) for p in paths])
    jax.add_table(JaxSchema.build("ex", dimensions=DIMS, metrics=METRICS),
                  [jax_load(p) for p in paths])

    st_cfg = TableConfig(table_name="st", indexing=IndexingConfig(
        star_tree_index_configs=[ST_TREE]))
    st_paths = []
    for i in range(2):
        SegmentBuilder(Schema.build("st", dimensions=ST_DIMS,
                                    metrics=ST_METRICS),
                       st_cfg, f"st_{i}").build(_st_cols(rng), root / f"st_{i}")
        st_paths.append(root / f"st_{i}")
    port.add_table(Schema.build("st", dimensions=ST_DIMS, metrics=ST_METRICS),
                   [load_segment(p) for p in st_paths])
    jax.add_table(JaxSchema.build("st", dimensions=ST_DIMS,
                                  metrics=ST_METRICS),
                  [jax_load(p) for p in st_paths])

    rt_schema = Schema.build("rt", dimensions=RT_DIMS, metrics=RT_METRICS)
    jrt_schema = JaxSchema.build("rt", dimensions=RT_DIMS, metrics=RT_METRICS)
    rows = _rt_rows(rng, 600)
    cols = {c: np.asarray([r[c] for r in rows[:400]],
                          dtype=object if c == "site" else np.int64)
            for c in ("site", "code", "revenue")}
    cols["code"] = cols["code"].astype(np.int32)
    SegmentBuilder(rt_schema, segment_name="rt_0").build(cols, root / "rt_0")
    live, jlive = MutableSegment(rt_schema, "rt_1"), \
        JaxMutableSegment(jrt_schema, "rt_1")
    for r in rows[400:]:
        live.index(dict(r))
        jlive.index(dict(r))
    port.add_table(rt_schema, [load_segment(root / "rt_0"), live])
    jax.add_table(jrt_schema, [jax_load(root / "rt_0"), jlive])
    return port, jax


def _rows(resp) -> list:
    assert not resp.exceptions, resp.exceptions
    return resp.result_table.rows


# -- EXPLAIN PLAN FOR / EXPLAIN IMPLEMENTATION FOR -----------------------------


def _refused(rows: list) -> list:
    """`rows` with a planner refusal's row reduced to REFUSED: its label
    differs by design (UNSUPPORTED(no host engine: ...) in the port,
    HOST_ENGINE(numpy fallback: ...) in the JAX package) and so does the
    planner's message, which is each package's own wording."""
    return [["REFUSED" if op.startswith(("UNSUPPORTED(no host engine: ",
                                        "HOST_ENGINE(numpy fallback: "))
             else op, oid, parent] for op, oid, parent in rows]


def _explain(sql: str, prefix: str) -> str:
    """`sql` with the EXPLAIN prefix after its SET options."""
    sets = ""
    while sql.startswith("SET "):
        cut = sql.index("; ") + 2
        sets, sql = sets + sql[:cut], sql[cut:]
    return sets + prefix + sql


@pytest.mark.parametrize("prefix", ["EXPLAIN PLAN FOR ",
                                    "EXPLAIN IMPLEMENTATION FOR "])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_explain_rows_equal_jax(engines, shape, prefix):
    port, jax = engines
    sql = _explain(SHAPES[shape], prefix)
    got, want = port.execute_sql(sql), jax.execute_sql(sql)
    assert got.result_table.schema.column_names == [
        "Operator", "Operator_Id", "Parent_Id"]
    assert _refused(_rows(got)) == _refused(_rows(want))
    assert got.num_device_dispatches == 0 and got.num_docs_scanned == 0


def test_explain_names_the_shapes(engines):
    """The labels the shapes are chosen for are there (the equality above
    would also hold if both packages lost them)."""
    port = engines[0]

    def ops(shape, prefix="EXPLAIN IMPLEMENTATION FOR "):
        return "\n".join(r[0] for r in _rows(port.execute_sql(
            _explain(SHAPES[shape], prefix))))

    assert "path:sparse-presorted" in ops("sparse_presorted")
    assert "path:sparse-sort+gather" in ops("sparse_sort")
    assert "FILTER_STARTREE_INDEX" in ops("star_tree")
    assert "mvExpansion:true" in ops("mv_group")
    assert "HOST_INDEX_MASK" in ops("index_mask")
    assert "EMPTY(no immutable segments matched)" in ops("all_pruned")
    assert "consuming(host):1" in ops("consuming")
    assert "UNSUPPORTED(no host engine: aggregation exprmin" \
        in ops("refusal")
    assert "SEGMENT_BATCH(disabled)" in ops("no_batch")
    dense = ops("dense_two_keys")
    assert "path:mxu" in dense and "fusedMxu:eligible" in dense
    assert "SEGMENT_BATCH(families:1, segments:3)" in dense
    assert "SERVER_COMBINE(impl:host-columnar-scatter, segments:3)" in dense


# -- EXPLAIN ANALYZE -------------------------------------------------------------


@pytest.mark.parametrize("shape", sorted(ANALYZE))
def test_analyze_tree_equals_jax(engines, shape):
    port, jax = engines
    sql = ANALYZE[shape]
    plain = port.execute_sql(sql)
    jax.execute_sql(sql)  # the JAX package's compiles out of the way
    got = port.execute_sql(_explain(sql, "EXPLAIN ANALYZE "))
    want = jax.execute_sql(_explain(sql, "EXPLAIN ANALYZE "))
    assert _masked(_rows(got)) == _masked(_rows(want))
    root = _rows(got)[0][0]
    assert f"rows:{len(_rows(plain))}," in root
    assert f"dispatches:{plain.num_device_dispatches}," in root
    spans = [s for s in got.trace_info if s["operator"] == "family_dispatch"]
    assert len(spans) == plain.num_device_dispatches
    for s in spans:
        assert s["attributes"]["device"] == "cpu"
        assert s["attributes"]["deviceExecMs"] > 0


def test_analyze_fused_dispatch_names_the_kernel(engines):
    rows = _rows(engines[0].execute_sql(_explain(
        ANALYZE["solo_fused"], "EXPLAIN ANALYZE ")))
    fused = [op for op, _, _ in rows if "fused:" in op]
    assert len(fused) == SEGMENTS and all("fused:plain" in op for op in fused)


# -- SET trace = true ----------------------------------------------------------


def test_trace_info_and_json(engines):
    port = engines[0]
    resp = port.execute_sql("SET trace = true; " + ANALYZE["family"])
    ops = [s["operator"] for s in resp.trace_info]
    assert ops[:2] == ["QUERY_PLAN_EXECUTION", "family_dispatch"]
    assert ops.count("family_dispatch") == 1
    assert ops[-2:] == ["SERVER_COMBINE", "BROKER_REDUCE"]
    assert "traceInfo" in resp.to_json()
    assert resp.to_json()["numCompiles"] == 0
    assert port.execute_sql(ANALYZE["family"]).trace_info is None
    assert TRACING.active_trace() is None


def test_trace_helpers_equal_jax(engines):
    """phase_breakdown over a traced run's spans equals the JAX package's
    over the same list; to_tree nests every span under its parent."""
    from pinot_tpu.spi.trace import phase_breakdown as jax_breakdown
    from pinot_tpu_torch.spi.trace import Trace, phase_breakdown

    resp = engines[0].execute_sql("SET trace = true; " + ANALYZE["family"])
    got = phase_breakdown(resp.trace_info)
    assert got == jax_breakdown(resp.trace_info)
    assert got["deviceExecMs"] > 0 and got["compileMs"] == 0.0
    trace = Trace("t")
    root = trace.record("root", 1.0, 1.5)
    trace.record("child", 1.1, 1.2, parent=root)
    assert [n["operator"] for n in trace.to_tree()] == ["root"]
    assert trace.to_tree()[0]["children"][0]["operator"] == "child"
    assert trace.phase_ms("child") == pytest.approx(100.0)


def _count_timers(monkeypatch) -> list:
    made = []
    real = port_executor._DeviceTimer

    class Counting(real):
        def __init__(self, device):
            made.append(device)
            super().__init__(device)

    monkeypatch.setattr(port_executor, "_DeviceTimer", Counting)
    return made


@pytest.mark.parametrize("shape", ["family", "solo_fused", "sparse_combine",
                                   "selection"])
def test_tracing_off_allocates_no_span(engines, monkeypatch, shape):
    """The port's tests/test_tracing_perf_guard.py: untraced, a query makes
    no span, no device timing (on a card: no event, no synchronize) and
    its one fetch; traced, one timing per dispatch and the same fetch."""
    port = engines[0]
    timers = _count_timers(monkeypatch)
    sql = ANALYZE[shape]
    port.execute_sql(sql)  # planes uploaded
    spans0, fetches0 = span_allocations(), kernels.host_fetches()
    resp = port.execute_sql(sql)
    assert span_allocations() == spans0
    assert kernels.host_fetches() - fetches0 == 1
    assert timers == []
    fetches0 = kernels.host_fetches()
    traced = port.execute_sql("SET trace = true; " + sql)
    assert span_allocations() > spans0
    assert kernels.host_fetches() - fetches0 == 1
    assert len(timers) == resp.num_device_dispatches > 0
    assert _rows(traced) == _rows(resp)


# -- the caches under a trace --------------------------------------------------


def test_trace_bypasses_the_partial_cache_analyze_does_not(engines,
                                                           monkeypatch):
    monkeypatch.setenv("PINOT_TPU_SEGMENT_CACHE", "1")
    GLOBAL_PARTIAL_CACHE.clear()
    port = engines[0]
    sql = ANALYZE["family"]
    try:
        port.execute_sql(sql)  # fills the cache
        traced = port.execute_sql("SET trace = true; " + sql)
        ops = [s["operator"] for s in traced.trace_info]
        assert "SEGMENT_CACHE(bypass:trace)" in ops
        assert traced.num_device_dispatches == 1
        root = _rows(port.execute_sql("EXPLAIN ANALYZE " + sql))[0][0]
        assert "dispatches:0," in root and "cache:hit" in root
    finally:
        GLOBAL_PARTIAL_CACHE.clear()


def test_analyze_shows_the_merged_sparse_hit(engines, monkeypatch):
    monkeypatch.setenv("PINOT_TPU_SEGMENT_CACHE", "1")
    GLOBAL_PARTIAL_CACHE.clear()
    port = engines[0]
    sql = ANALYZE["sparse_combine"]
    try:
        cold = port.execute_sql(sql)
        got = port.execute_sql(_explain(sql, "EXPLAIN ANALYZE "))
        ops = [r[0] for r in _rows(got)]
        assert any(op.startswith("SEGMENT_CACHE(hit:merged)(segments:3, "
                                 "cache:hit") for op in ops), ops
        assert f"rows:{len(_rows(cold))}," in ops[0]
        assert got.num_device_dispatches == 0
    finally:
        GLOBAL_PARTIAL_CACHE.clear()
