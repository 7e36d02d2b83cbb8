"""The port's cluster serving path against the JAX package's.

A port cluster (PropertyStore, ClusterController, three
`ServerInstance(device="cpu")` and a `Broker`, over loopback TCP) and a
JAX cluster (`ServerInstance(backend="tpu")`, its Pallas kernels
interpreted) serve the same segment directories, built once by the port's
builder from a numpy seed:

  * `cl_ssb`: 4 segments of 2,000 rows, replication 1 (the controller
    assigns 2 + 1 + 1 segments in both packages, so summed dispatches are
    comparable), each segment its own `d_year` range (so a filter prunes);
  * `cl_brands`: a dimension table on every server (replication 3), the
    LOOKUP target;
  * `cl_hyb`: an OFFLINE and a REALTIME table of immutable segments with a
    time column, so the broker splits at the time boundary;
  * `cl_rep`: `cl_ssb`'s segments at replication 2, for the failure
    paths, each run on a cluster of its own.

For aggregation, dense and sparse GROUP BY, DISTINCTCOUNT and
PERCENTILETDIGEST, selection with ORDER BY / LIMIT, a pruned filter,
LOOKUP, the hybrid split and EXPLAIN, the rows and numDocsScanned,
totalDocs, numSegmentsQueried / Processed / Pruned, numServersQueried /
Responded and the summed dispatches equal the JAX cluster's. Where a
server's segments are all pruned the JAX broker fails (IndexError in its
merge), so those queries are held against the JAX package's in-process
executor over the same segment directories. The failure paths (failover after stop(), a `transport.call` drop retried on the
replica, a `server.query` error that fails the query or answers partial
as the JAX broker does, a corrupt DataTable retried, partial results, a
timeout whose cancel reaches the server's `kill_prefix`), the broker result cache with its
lineage epochs and `SET trace = true` span trees are held against the JAX
broker's outcomes too. A join answers through the cluster multi-stage
engine with the JAX cluster's rows. Request frames pickle only the port's
classes (the multi-stage stage and mailbox frames: plain data and numpy
columns), and `ServerInstance()` raises without a card. An `hbm_oom` fault at
`device.dispatch` is relieved on the server. The control plane: the
store's CAS, ephemerals, watches and journal recovery (a torn tail cut),
leader failover, replica-group assignment, retention and its lineage bump,
the transport's memory budget and per-call timeout, a failed warmOnLoad
logged, and the meters rendered for Prometheus.

Both packages run with the segment partial cache off and the broker
result cache off except where the cache is the subject. Tolerance:
exact (integer sums and counts; TDigest merges in the same order).
"""

from __future__ import annotations

import io
import pickle
import re
import threading
import time

import numpy as np
import pytest
import torch

import pinot_tpu.cluster as jcl
from pinot_tpu.engine import dim_tables as jdim
from pinot_tpu.engine import perf_ledger as _jax_perf_ledger
from pinot_tpu.engine.query_executor import QueryExecutor as JaxQueryExecutor
from pinot_tpu.segment.loader import load_segment as jax_load
from pinot_tpu.spi.data_types import Schema as JaxSchema
from pinot_tpu.spi import faults as jfaults
from pinot_tpu_torch import cluster as pcl
from pinot_tpu_torch.cluster import transport as ptransport
from pinot_tpu_torch.engine import dim_tables as pdim
from pinot_tpu_torch.engine import perf_ledger as _port_perf_ledger
from pinot_tpu_torch.engine.scheduler import GLOBAL_ACCOUNTANT
from pinot_tpu_torch.query.parser.sql import parse_sql
from pinot_tpu_torch.segment.builder import SegmentBuilder
from pinot_tpu_torch.segment.loader import load_segment
from pinot_tpu_torch.spi import faults
from pinot_tpu_torch.spi.data_types import Schema
from pinot_tpu_torch.spi.metrics import SERVER_METRICS, ServerMeter
from pinot_tpu_torch.spi.table_config import IndexingConfig, TableConfig

ROWS = 2000
SEGMENTS = 4
REGIONS = ["AMERICA", "ASIA", "EUROPE"]
SSB = Schema.build(
    "cl_ssb",
    dimensions=[("d_year", "INT"), ("p_brand", "INT"), ("s_region", "STRING"),
                ("lo_orderkey", "INT")],
    metrics=[("lo_revenue", "INT"), ("lo_quantity", "INT")])
BRANDS = Schema.build("cl_brands",
                      dimensions=[("b_id", "INT"), ("b_category", "STRING")],
                      primary_key_columns=["b_id"])
HYB = Schema.build("cl_hyb", dimensions=[("site", "STRING"), ("ts", "LONG")],
                   metrics=[("clicks", "INT")])

SPARSE = "SET sparseGroupBy = true; "
QUERIES = {
    "aggregation": "SELECT COUNT(*), SUM(lo_revenue), MAX(lo_quantity) "
                   "FROM cl_ssb WHERE s_region = 'ASIA'",
    "dense_group": "SELECT d_year, p_brand, SUM(lo_revenue), COUNT(*) "
                   "FROM cl_ssb WHERE lo_quantity < 30 GROUP BY d_year, "
                   "p_brand ORDER BY d_year, p_brand LIMIT 40",
    "no_batch": "SET segmentBatch = false; SELECT s_region, SUM(lo_revenue) "
                "FROM cl_ssb WHERE d_year < 1998 GROUP BY s_region "
                "ORDER BY s_region",
    "sparse_group": SPARSE + "SELECT lo_orderkey, SUM(lo_revenue), COUNT(*) "
                             "FROM cl_ssb GROUP BY lo_orderkey "
                             "ORDER BY lo_orderkey LIMIT 50",
    "distinct_tdigest": "SELECT s_region, DISTINCTCOUNT(p_brand), "
                        "PERCENTILETDIGEST(lo_quantity, 50) FROM cl_ssb "
                        "GROUP BY s_region ORDER BY s_region",
    "selection": "SELECT d_year, p_brand, lo_revenue FROM cl_ssb "
                 "WHERE lo_quantity > 45 ORDER BY lo_revenue DESC, "
                 "p_brand LIMIT 12",
    "pruned": "SELECT COUNT(*), SUM(lo_quantity) FROM cl_ssb "
              "WHERE d_year = 1994",
    "all_pruned": "SELECT COUNT(*) FROM cl_ssb WHERE d_year > 3000",
    "lookup": "SELECT LOOKUP('cl_brands', 'b_category', 'b_id', p_brand), "
              "SUM(lo_revenue) FROM cl_ssb GROUP BY "
              "LOOKUP('cl_brands', 'b_category', 'b_id', p_brand) "
              "ORDER BY 1",
    "hybrid": "SELECT site, COUNT(*), SUM(clicks) FROM cl_hyb "
              "GROUP BY site ORDER BY site",
}
EXPLAIN = "EXPLAIN PLAN FOR " + QUERIES["dense_group"]
FAILOVER_SQL = ("SELECT d_year, SUM(lo_revenue), COUNT(*) FROM cl_rep "
                "GROUP BY d_year ORDER BY d_year")


@pytest.fixture(scope="module", autouse=True)
def _no_ledger_left_behind():
    """Both packages' brokers record every query, failures included, in
    their process-wide perf ledgers: leave the ledgers and alert books
    empty, so a later module's sentinel does not judge this module's
    queries (an SLO burn it fires arms exemplars that outlive it)."""
    yield
    for mod in (_jax_perf_ledger, _port_perf_ledger):
        mod.PERF_LEDGER.clear()
        mod.ALERTS.clear()


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("PINOT_TPU_SEGMENT_CACHE", "0")
    monkeypatch.setenv("PINOT_TPU_RESULT_CACHE", "0")
    monkeypatch.setenv("PINOT_TPU_FUSED", "interpret")
    monkeypatch.setenv("PINOT_TPU_MESH_DEVICES", "1")
    # keep failure tests inside seconds (the JAX broker's backoff; the
    # port's is an argument, see _start)
    monkeypatch.setenv("PINOT_TPU_SCATTER_BACKOFF_MS", "5")
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)
    faults.FAULTS.reset()


@pytest.fixture(scope="module")
def segments(tmp_path_factory):
    """Segment directories: (name, path, metadata) per table."""
    rng = np.random.default_rng(20261017)
    root = tmp_path_factory.mktemp("cluster_segs")
    raw = TableConfig(table_name="cl_ssb", indexing=IndexingConfig(
        no_dictionary_columns=["lo_revenue"]))
    out = {"ssb": [], "brands": [], "hyb_off": [], "hyb_rt": []}
    for i in range(SEGMENTS):
        cols = {
            "d_year": rng.integers(1992 + 2 * i, 1994 + 2 * i,
                                   ROWS).astype(np.int32),
            "p_brand": rng.integers(0, 40, ROWS).astype(np.int32),
            "s_region": np.asarray(REGIONS, dtype=object)[
                rng.integers(0, 3, ROWS)],
            "lo_orderkey": rng.integers(0, 5000, ROWS).astype(np.int32),
            "lo_revenue": rng.integers(1, 600_000, ROWS).astype(np.int32),
            "lo_quantity": rng.integers(1, 51, ROWS).astype(np.int32)}
        name = f"cl_ssb_{i}"
        SegmentBuilder(SSB, raw, name).build(cols, root / name)
        out["ssb"].append((name, str(root / name), {"numDocs": ROWS}))
    cats = np.asarray(["MFGR#1", "MFGR#2", "MFGR#3", "MFGR#4"], dtype=object)
    SegmentBuilder(BRANDS, None, "cl_brands_0").build(
        {"b_id": np.arange(40, dtype=np.int32),
         "b_category": cats[np.arange(40) % 4]}, root / "cl_brands_0")
    out["brands"].append(("cl_brands_0", str(root / "cl_brands_0"),
                          {"numDocs": 40}))
    for half, lo in (("hyb_off", 0), ("hyb_rt", 500)):
        for j in range(2):
            n = 700
            ts = rng.integers(lo, lo + 1000, n).astype(np.int64)
            name = f"cl_{half}_{j}"
            SegmentBuilder(HYB, None, name).build(
                {"site": np.asarray(["a", "b", "c"], dtype=object)[
                    rng.integers(0, 3, n)], "ts": ts,
                 "clicks": rng.integers(0, 10, n).astype(np.int32)},
                root / name)
            out[half].append((name, str(root / name),
                              {"numDocs": n, "startTimeMs": int(ts.min()),
                               "endTimeMs": int(ts.max())}))
    return out


def _start(pkg, segs, replication: int = 1, servers: int = 3,
           tables=("ssb", "brands", "hyb"), ssb_name="cl_ssb"):
    """A started cluster of `pkg` (the port's or the JAX package's) with
    the given tables loaded: (store, controller, servers, broker)."""
    store = pkg.PropertyStore()
    ctl = pkg.ClusterController(store)
    if pkg is pcl:
        srv = [pkg.ServerInstance(store, f"Server_{i}", device="cpu")
               for i in range(servers)]
    else:
        srv = [pkg.ServerInstance(store, f"Server_{i}", backend="tpu")
               for i in range(servers)]
    for s in srv:
        s.start()
    if "ssb" in tables:
        ctl.add_schema(dict(SSB.to_json(), schemaName=ssb_name))
        t = ctl.create_table({"tableName": ssb_name,
                              "replication": replication})
        for name, path, meta in segs["ssb"]:
            ctl.add_segment(t, name, dict(meta, location=path))
    if "brands" in tables:
        ctl.add_schema(BRANDS.to_json())
        t = ctl.create_table({"tableName": "cl_brands", "isDimTable": True,
                              "replication": servers})
        for name, path, meta in segs["brands"]:
            ctl.add_segment(t, name, dict(meta, location=path))
    if "hyb" in tables:
        ctl.add_schema(HYB.to_json())
        for half, ttype in (("hyb_off", "OFFLINE"), ("hyb_rt", "REALTIME")):
            t = ctl.create_table({"tableName": "cl_hyb", "tableType": ttype,
                                  "timeColumn": "ts", "replication": 1})
            for name, path, meta in segs[half]:
                ctl.add_segment(t, name, dict(meta, location=path))
    # the port's broker takes its backoff as an argument, the JAX
    # package's from PINOT_TPU_SCATTER_BACKOFF_MS
    broker = pkg.Broker(store, scatter_backoff_ms=5) if pkg is pcl \
        else pkg.Broker(store)
    return store, ctl, srv, broker


def _stop(cluster) -> None:
    for s in cluster[2]:
        try:
            s.stop()
        except Exception:
            pass


@pytest.fixture(scope="module")
def clusters(segments):
    port = _start(pcl, segments)
    ref = _start(jcl, segments)
    yield port, ref
    _stop(port)
    _stop(ref)
    port[3].close()
    for reg in (pdim, jdim):
        for name in ("cl_brands", "cl_brands_OFFLINE"):
            reg.unregister_dimension_table(name)


def _counts(resp) -> tuple:
    return (resp.num_docs_scanned, resp.total_docs,
            resp.num_segments_queried, resp.num_segments_processed,
            resp.num_segments_pruned, resp.num_servers_queried,
            resp.num_servers_responded, resp.num_device_dispatches)


def _rows(resp) -> list:
    assert not resp.exceptions, resp.exceptions
    return [list(r) for r in resp.result_table.rows]


# a server whose every segment the filter prunes answers an empty
# aggregation; the JAX broker's merge fails on it (IndexError), so these
# hold the port's cluster against the JAX package's in-process
# QueryExecutor over the same segment directories, which does not go
# through that merge
PRUNED = ("pruned", "all_pruned")


@pytest.mark.parametrize("name", sorted(set(QUERIES) - set(PRUNED)))
def test_cluster_equals_jax_cluster(clusters, name):
    (_, _, _, port), (_, _, _, ref) = clusters
    got, want = port.execute_sql(QUERIES[name]), ref.execute_sql(QUERIES[name])
    assert _rows(got) == _rows(want)
    assert _counts(got) == _counts(want)
    assert got.num_servers_responded == got.num_servers_queried > 0


@pytest.mark.parametrize("name", PRUNED)
def test_pruned_servers_merge_like_one_executor(clusters, segments, name):
    (_, _, _, port), _ = clusters
    qe = JaxQueryExecutor(backend="tpu")
    qe.add_table(JaxSchema.from_json(SSB.to_json()),
                 [jax_load(p) for _, p, _ in segments["ssb"]])
    got, want = port.execute_sql(QUERIES[name]), qe.execute_sql(QUERIES[name])
    assert _rows(got) == _rows(want)
    assert _counts(got)[:5] == _counts(want)[:5]
    assert got.num_segments_pruned >= 3
    assert got.num_servers_responded == got.num_servers_queried == 3


def test_cluster_equals_in_process_executor(clusters):
    # the same rows, scanned docs and dispatches as one QueryExecutor over
    # all four segments would give minus the per-server family split
    (_, _, servers, port), _ = clusters
    resp = port.execute_sql(QUERIES["dense_group"])
    hosted = sum(len(s.segments.get("cl_ssb_OFFLINE", {})) for s in servers)
    assert hosted == SEGMENTS and resp.num_segments_processed == SEGMENTS
    assert resp.num_servers_queried == 3
    # Server_0 holds a family of 2 (one dispatch), the others one each
    assert resp.num_device_dispatches == 3


def test_hybrid_split_counts_each_row_once(clusters, segments):
    (_, _, _, port), _ = clusters
    resp = port.execute_sql("SELECT COUNT(*) FROM cl_hyb")
    boundary = max(m["endTimeMs"] for _, _, m in segments["hyb_off"]) - 1
    want = 0
    for half, keep in (("hyb_off", lambda ts: ts <= boundary),
                       ("hyb_rt", lambda ts: ts > boundary)):
        for _, path, _ in segments[half]:
            want += int(keep(load_segment(path).get_values("ts")).sum())
    assert _rows(resp) == [[want]]


def test_explain_rows_equal_jax(clusters):
    (_, _, _, port), (_, _, _, ref) = clusters
    assert _rows(port.execute_sql(EXPLAIN)) == _rows(ref.execute_sql(EXPLAIN))


MSE_JOIN = ("SELECT a.d_year, COUNT(*) FROM cl_ssb a JOIN cl_ssb b "
            "ON a.lo_orderkey = b.lo_orderkey GROUP BY a.d_year")


def test_multistage_statement_answers_through_the_cluster_mse(clusters):
    # a join goes to the cluster multi-stage engine: stage workers on the
    # servers, the rows the JAX cluster's MSE gives (tests/
    # test_torch_mse_distributed.py holds the engine itself)
    (_, _, _, port), (_, _, _, ref) = clusters
    got, want = port.execute_sql(MSE_JOIN), ref.execute_sql(MSE_JOIN)
    assert sorted(_rows(got)) == sorted(_rows(want))
    assert len(got.mse_exchange["workers"]) == 3
    bad = port.execute_sql("SELEC nonsense")
    assert bad.result_table is None
    assert bad.exceptions[0].startswith("SqlParseError")


# timings, and the attributes that differ by design: the port's
# family_dispatch spans name their device (`device`) and its fused kernel's
# form (`fused`: "plain" on the CPU, the JAX package's "interpret"); the
# JAX package's carry a device-memory snapshot (`hbm*`) the port's do not
# (tests/test_torch_explain.py `_masked`)
TIMINGS = ("ms", "timeMs", "deviceExecMs", "compileMs", "coalesceWaitMs")


def _span_tree(trace: list) -> list:
    """(name, parent name, attributes but timings) of every span, ordered:
    the tree without ids, clocks or the by-design differences."""
    by_id = {s["spanId"]: s for s in trace}
    out = []
    for s in trace:
        parent = by_id.get(s.get("parentId"), {}).get("operator")
        attrs = {k: v for k, v in (s.get("attributes") or {}).items()
                 if k not in TIMINGS and k not in ("device", "fused")
                 and not k.startswith("hbm")}
        out.append((s["operator"], parent, s.get("server"),
                    tuple(sorted((k, str(v)) for k, v in attrs.items()))))
    return sorted(out)


def _warm(port, ref, sql: str) -> None:
    """Run `sql` untraced on both clusters, so every plane and stack it
    needs is resident on both: the traced run that follows transfers the
    same bytes whatever queries the clusters (or, for the JAX package's
    process-wide device cache, this process) ran before."""
    assert _rows(port.execute_sql(sql)) == _rows(ref.execute_sql(sql))


@pytest.mark.parametrize("name", ["dense_group", "no_batch", "aggregation"])
def test_trace_span_trees_equal_jax(clusters, name):
    (_, _, _, port), (_, _, _, ref) = clusters
    _warm(port, ref, QUERIES[name])
    sql = "SET trace = true; " + QUERIES[name]
    got, want = port.execute_sql(sql), ref.execute_sql(sql)
    assert _rows(got) == _rows(want)
    assert got.trace_info and want.trace_info
    assert _span_tree(got.trace_info) == _span_tree(want.trace_info)
    servers = {s.get("server") for s in got.trace_info if s.get("server")}
    assert servers == {"Server_0", "Server_1", "Server_2"}


_TIMING_RE = re.compile(r"\b(" + "|".join(TIMINGS) + r"):[^,)]*")


def _masked(rows: list) -> list:
    """EXPLAIN ANALYZE rows with timings masked and the by-design
    differences dropped (the port's `device:`, the root's `compiles:`,
    `fused:plain` for the JAX package's `fused:interpret`)."""
    out = []
    for op, oid, parent in rows:
        op = _TIMING_RE.sub(lambda m: m.group(1) + ":*", op)
        op = re.sub(r"device:(cpu|cuda), ", "", op)
        op = re.sub(r"fused:(plain|interpret)", "fused:*", op)
        op = re.sub(r"compiles:\d+", "compiles:*", op)
        out.append([op, oid, parent])
    return out


def test_explain_analyze_runs_through_the_broker(clusters):
    (_, _, _, port), (_, _, _, ref) = clusters
    _warm(port, ref, QUERIES["dense_group"])
    sql = "EXPLAIN ANALYZE " + QUERIES["dense_group"]
    got, want = port.execute_sql(sql), ref.execute_sql(sql)
    assert _masked(_rows(got)) == _masked(_rows(want))
    assert any(r[0].startswith("Server_0/family_dispatch(")
               for r in _rows(got))


def test_result_cache_hit_then_lineage_bump_then_miss(segments, monkeypatch,
                                                      tmp_path):
    monkeypatch.setenv("PINOT_TPU_RESULT_CACHE", "1")
    sql = "SELECT COUNT(*), SUM(lo_revenue) FROM cl_ssb"
    outcomes = {}
    for pkg in (pcl, jcl):
        cluster = _start(pkg, segments, tables=("ssb",))
        store, ctl, _, broker = cluster
        try:
            seen = []
            for _ in range(2):
                r = broker.execute_sql(sql)
                seen.append((r.cache_outcome, _rows(r),
                             r.num_device_dispatches))
            # a new segment bumps the table's lineage epoch: the next run
            # misses and counts the new rows
            name, path, meta = segments["ssb"][0]
            ctl.add_segment("cl_ssb_OFFLINE", "cl_ssb_extra",
                            dict(meta, location=path))
            epoch = store.get("/CACHEEPOCH/cl_ssb_OFFLINE")
            r = broker.execute_sql(sql)
            seen.append((r.cache_outcome, _rows(r), r.num_device_dispatches))
            seen.append(epoch)
            outcomes[pkg.__name__] = seen
        finally:
            _stop(cluster)
    port, ref = outcomes["pinot_tpu_torch.cluster"], outcomes["pinot_tpu.cluster"]
    assert port == ref
    assert [o[0] for o in port[:3]] == ["miss", "hit", "miss"]
    assert port[2][1][0][0] == port[0][1][0][0] + ROWS
    assert port[3] == SEGMENTS + 1  # one bump per add_segment


@pytest.fixture()
def replicated(segments):
    """A port cluster whose `cl_rep` segments each sit on 2 of 3 servers,
    and the JAX cluster's rows for FAILOVER_SQL."""
    cluster = _start(pcl, segments, replication=2, tables=("ssb",),
                     ssb_name="cl_rep")
    ref = _start(jcl, segments, replication=2, tables=("ssb",),
                 ssb_name="cl_rep")
    try:
        want = _rows(ref[3].execute_sql(FAILOVER_SQL))
    finally:
        _stop(ref)
    yield cluster, want
    _stop(cluster)
    cluster[3].close()


def test_replica_failover_after_stop(replicated):
    (store, _, servers, broker), want = replicated
    servers[0].stop()
    resp = broker.execute_sql(FAILOVER_SQL)
    assert _rows(resp) == want
    assert resp.num_servers_responded == resp.num_servers_queried == 2


def test_dropped_connection_is_retried_on_the_replica(replicated):
    (_, _, _, broker), want = replicated
    # the query's first RPC drops: that shard fails over to a replica
    faults.FAULTS.arm("transport.call", kind="drop", times=1)
    resp = broker.execute_sql(FAILOVER_SQL)
    assert faults.FAULTS.fired("transport.call") == 1
    assert _rows(resp) == want
    assert resp.num_scatter_retries >= 1


def test_server_error_fails_the_query_like_the_jax_broker(segments):
    # a handler's error is a RemoteError: the server is alive, a replica
    # would fail the same way, so the JAX broker neither retries nor fails
    # over; it fails the query, or answers partial when allowed
    outcomes = []
    for pkg, fl in ((pcl, faults), (jcl, jfaults)):
        cluster = _start(pkg, segments, replication=2, tables=("ssb",),
                         ssb_name="cl_rep")
        try:
            fl.FAULTS.arm("server.query", kind="error", times=1)
            r = cluster[3].execute_sql(FAILOVER_SQL)
            fl.FAULTS.arm("server.query", kind="error", times=1)
            p = cluster[3].execute_sql(
                "SET allowPartialResults = true; " + FAILOVER_SQL)
            outcomes.append((r.result_table is None,
                             r.exceptions[0].split(":")[0],
                             r.num_scatter_retries, p.partial_result,
                             p.exceptions[0].split(":")[0],
                             p.num_servers_responded
                             == p.num_servers_queried - 1))
        finally:
            fl.FAULTS.reset()
            _stop(cluster)
    assert outcomes[0] == outcomes[1] == (True, "RemoteError", 0, True,
                                          "RemoteError", True)


def test_corrupt_datatable_is_retried(replicated):
    (_, _, _, broker), want = replicated
    faults.FAULTS.arm("datatable.encode", kind="corrupt", times=1)
    resp = broker.execute_sql(FAILOVER_SQL)
    assert _rows(resp) == want
    assert resp.num_corrupt_shards_retried == 1
    assert resp.num_scatter_retries >= 1


def test_partial_result_when_a_segment_has_no_replica(segments):
    cluster = _start(pcl, segments, replication=1, tables=("ssb",),
                     ssb_name="cl_rep")
    try:
        store, ctl, servers, broker = cluster
        lost = sorted(servers[2].segments["cl_rep_OFFLINE"])
        servers[2].stop()
        sql = "SET allowPartialResults = true; SELECT COUNT(*) FROM cl_rep"
        resp = broker.execute_sql(sql)
        assert resp.partial_result and resp.exceptions
        assert resp.result_table.rows == [[ROWS * (SEGMENTS - len(lost))]]
        strict = broker.execute_sql("SELECT COUNT(*) FROM cl_rep")
        assert strict.result_table is None and strict.exceptions
    finally:
        _stop(cluster)
        cluster[3].close()


def test_timeout_cancel_reaches_kill_prefix(segments, monkeypatch):
    cluster = _start(pcl, segments, replication=1, tables=("ssb",),
                     servers=1, ssb_name="cl_rep")
    killed = []
    real = GLOBAL_ACCOUNTANT.kill_prefix

    def spy(prefix, reason="killed by admin"):
        killed.append((prefix, reason))
        return real(prefix, reason)

    monkeypatch.setattr(GLOBAL_ACCOUNTANT, "kill_prefix", spy)
    try:
        broker = cluster[3]
        killed0 = SERVER_METRICS.meter_count(ServerMeter.QUERIES_KILLED)
        # the handler stalls past the broker's socket timeout (the budget
        # + 2 s, and one client resend): the broker gives up, sends the
        # prefix cancel, and the shards die on arrival at their tombstone
        faults.FAULTS.arm("server.query", kind="delay", delay_s=2.5,
                          times=2)
        t0 = time.monotonic()
        resp = broker.execute_sql(
            "SET timeoutMs = 200; SELECT COUNT(*) FROM cl_rep")
        assert time.monotonic() - t0 < 8
        assert resp.result_table is None
        assert resp.exceptions[0].startswith("TimeoutError")
        assert killed and killed[0][0] == resp.query_id
        assert killed[0][1] == "broker deadline exceeded"
        deadline = time.monotonic() + 5
        while SERVER_METRICS.meter_count(ServerMeter.QUERIES_KILLED) \
                <= killed0 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert SERVER_METRICS.meter_count(ServerMeter.QUERIES_KILLED) \
            > killed0
    finally:
        _stop(cluster)
        cluster[3].close()


class _ClassRecorder(pickle.Unpickler):
    """Unpickles a frame, recording the module of every class it loads."""

    def __init__(self, frame: bytes):
        super().__init__(io.BytesIO(frame))
        self.modules: set = set()

    def find_class(self, module, name):
        self.modules.add(module)
        return super().find_class(module, name)


def _globals_in(frame: bytes) -> set:
    """Module names of every class a pickle frame references."""
    rec = _ClassRecorder(frame)
    rec.load()
    return rec.modules


def test_request_frames_pickle_only_port_classes(clusters, monkeypatch):
    (_, _, _, port), _ = clusters
    frames = []
    real = ptransport._send_frame

    mse_frames = {"mse_stage": [], "mse_mailbox": []}

    def spy(sock, obj):
        kind = obj.get("type") if isinstance(obj, dict) else None
        if kind == "query":
            frames.append(pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL))
        elif kind in mse_frames:
            mse_frames[kind].append(
                pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL))
        return real(sock, obj)

    monkeypatch.setattr(ptransport, "_send_frame", spy)
    for name in ("lookup", "hybrid", "distinct_tdigest", "pruned"):
        assert not port.execute_sql(QUERIES[name]).exceptions
    assert frames
    mods = set().union(*(_globals_in(f) for f in frames))
    assert mods and all(m.split(".")[0] in ("pinot_tpu_torch", "builtins")
                        for m in mods), mods
    assert not any(re.match(r"pinot_tpu(\.|$)", m) for m in mods)
    # the cluster MSE's frames: a stage is plain JSON data, a mailbox
    # chunk numpy columns; neither names a class of the JAX package
    assert not port.execute_sql(MSE_JOIN).exceptions
    assert all(mse_frames.values()), {k: len(v) for k, v in mse_frames.items()}
    stage_mods = set().union(*(_globals_in(f)
                               for f in mse_frames["mse_stage"]))
    assert stage_mods <= {"builtins"}, stage_mods
    box_mods = set().union(*(_globals_in(f)
                             for f in mse_frames["mse_mailbox"]))
    assert all(m.split(".")[0] in ("numpy", "builtins")
               for m in box_mods), box_mods
    # and a port QueryContext carries no JAX package class either way
    assert "pinot_tpu." not in str(_globals_in(pickle.dumps(
        parse_sql(QUERIES["lookup"]))))


def test_server_instance_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    store = pcl.PropertyStore()
    with pytest.raises(RuntimeError):
        pcl.ServerInstance(store, "Server_x")
    with pytest.raises(RuntimeError):
        pcl.ServerInstance(store, "Server_x", device="cuda")
    # nothing registered: a refused server never joined the cluster
    assert store.children("/LIVEINSTANCES") == []


def test_server_status_and_concurrent_queries(clusters):
    (_, _, servers, port), _ = clusters
    status = servers[0]._handle({"type": "status"})
    assert status["device"] == {"type": "cpu"} and status["numSegments"] >= 2
    results, errors = [], []

    def run():
        try:
            results.append(_rows(port.execute_sql(QUERIES["aggregation"])))
        except Exception as e:  # noqa: BLE001 - collected and asserted
            errors.append(e)

    threads = [threading.Thread(target=run) for _ in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert not errors and not any(t.is_alive() for t in threads)
    assert len(results) == 6 and all(r == results[0] for r in results)


def test_injected_device_oom_is_relieved_on_the_server(clusters):
    # an `hbm_oom` fault at device.dispatch raises the RESOURCE_EXHAUSTED
    # error engine/oom.py classifies as a device OOM: one relief, one
    # retry, and the query answers
    from pinot_tpu_torch.engine.oom import oom_stats

    (_, _, _, port), (_, _, _, ref) = clusters
    want = _rows(ref.execute_sql(QUERIES["dense_group"]))
    before = oom_stats()["reliefs"]
    faults.FAULTS.arm("device.dispatch", kind="hbm_oom", times=1)
    resp = port.execute_sql(QUERIES["dense_group"])
    assert faults.FAULTS.fired("device.dispatch") == 1
    assert _rows(resp) == want
    assert oom_stats()["reliefs"] == before + 1


# -- the control plane and the transport --------------------------------------


def test_store_cas_ephemerals_watches_and_journal(tmp_path):
    from pinot_tpu_torch.cluster.store import BadVersionError, PropertyStore

    store = PropertyStore(data_dir=tmp_path, fsync="off")
    seen = []
    store.watch("/T/", lambda path, value: seen.append((path, value)))
    v = store.set("/T/a", {"x": 1})
    with pytest.raises(BadVersionError):
        store.set("/T/a", {"x": 2}, expected_version=v + 1)
    store.update("/T/a", lambda cur: dict(cur, x=cur["x"] + 1))
    store.set("/T/e", {"live": True}, ephemeral_owner="Server_9")
    store.expire_session("Server_9")
    assert store.get("/T/a") == {"x": 2} and store.get("/T/e") is None
    assert seen[-1] == ("/T/e", None)
    store.close()
    # a torn tail after the last good frame is cut on recovery; ephemerals
    # are never journaled
    with open(tmp_path / "store.journal", "ab") as f:
        f.write(b"\x05\x00\x00\x00garbage")
    again = PropertyStore(data_dir=tmp_path, fsync="off")
    assert again.get("/T/a") == {"x": 2} and again.get("/T/e") is None
    assert again.truncations == 1 and again.get_with_version("/T/a")[1] == 1
    again.close()


def test_leader_election_fails_over():
    from pinot_tpu_torch.cluster.leader import LEADER_PATH

    store = pcl.PropertyStore()
    a = pcl.ClusterController(store, instance_id="Controller_a")
    b = pcl.ClusterController(store, instance_id="Controller_b")
    assert a.is_leader() and not b.is_leader()
    a.leader.disconnect()
    store.expire_session("Controller_a")
    assert b.is_leader() and store.get(LEADER_PATH) == {
        "instance": "Controller_b"}
    b.stop()
    assert store.get(LEADER_PATH) is None


def test_replica_groups_retention_and_lineage(segments):
    store = pcl.PropertyStore()
    ctl = pcl.ClusterController(store)
    servers = [pcl.ServerInstance(store, f"Server_{i}", device="cpu")
               for i in range(4)]
    try:
        for s in servers:
            s.start()
        ctl.add_schema(dict(SSB.to_json(), schemaName="cl_rg"))
        table = ctl.create_table({"tableName": "cl_rg", "replication": 2,
                                  "retentionDays": 1})
        groups = ctl.configure_instance_partitions(table, 2)["replicaGroups"]
        assert sorted(sum(groups, [])) == [f"Server_{i}" for i in range(4)]
        now = 10 * 86_400_000
        for k, (name, path, meta) in enumerate(segments["ssb"]):
            end = now - (3 if k == 0 else 0) * 86_400_000
            assigned = ctl.add_segment(table, name, dict(
                meta, location=path, endTimeMs=end))
            # one replica in each group
            assert [any(i in g for i in assigned) for g in groups] == \
                [True, True]
        epoch = store.get(f"/CACHEEPOCH/{table}")
        assert epoch == SEGMENTS
        assert ctl.run_retention(now_ms=now) == [f"{table}/cl_ssb_0"]
        assert store.get(f"/CACHEEPOCH/{table}") == epoch + 1
        hosted = {n for s in servers for n in s.segments.get(table, {})}
        assert hosted == {f"cl_ssb_{k}" for k in range(1, SEGMENTS)}
        broker = pcl.Broker(store)
        resp = broker.execute_sql("SELECT COUNT(*) FROM cl_rg")
        broker.close()
        assert _rows(resp) == [[ROWS * (SEGMENTS - 1)]]
        ctl.drop_table(table)
        assert ctl.table_config(table) is None
    finally:
        for s in servers:
            s.stop()


def test_transport_memory_budget_and_per_call_timeout():
    from pinot_tpu_torch.cluster.transport import (RemoteError, RpcClient,
                                                   RpcServer, TransportError)

    server = RpcServer(lambda req: (time.sleep(req.get("sleep", 0)), req)[1],
                       max_inflight_bytes=4096)
    client = RpcClient(server.host, server.port, timeout=5.0)
    try:
        assert client.call({"x": 1}) == {"x": 1}
        # a frame over the budget is drained and refused, the stream stays
        # in sync for the next call
        with pytest.raises(RemoteError, match="ServerOutOfMemory"):
            client.call({"blob": b"\0" * 10_000})
        assert client.call({"x": 2}) == {"x": 2}
        with pytest.raises(TransportError):
            client.call({"sleep": 1.0}, retry=False, timeout=0.2)
    finally:
        client.close()
        server.close()


def test_failed_warm_on_load_is_logged(segments, monkeypatch, caplog):
    from pinot_tpu_torch.segment.device_cache import DeviceSegmentCache

    def broken(self, segment, columns=None):
        raise RuntimeError("no room on the card")

    monkeypatch.setattr(DeviceSegmentCache, "warm", broken)
    store = pcl.PropertyStore()
    ctl = pcl.ClusterController(store)
    server = pcl.ServerInstance(store, "Server_w", device="cpu")
    try:
        server.start()
        ctl.add_schema(dict(SSB.to_json(), schemaName="cl_warm"))
        table = ctl.create_table({"tableName": "cl_warm", "warmOnLoad": True})
        with caplog.at_level("ERROR", logger="pinot_tpu_torch.cluster.server"):
            name, path, meta = segments["ssb"][0]
            ctl.add_segment(table, name, dict(meta, location=path))
            deadline = time.monotonic() + 10
            while "warmOnLoad" not in caplog.text and \
                    time.monotonic() < deadline:
                time.sleep(0.02)
        assert "warmOnLoad of cl_warm_OFFLINE/cl_ssb_0 failed" in caplog.text
        assert "no room on the card" in caplog.text
    finally:
        server.stop()


def test_server_meters_render_for_prometheus(clusters):
    from pinot_tpu_torch.spi.metrics import (BROKER_METRICS, SERVER_METRICS,
                                             render_prometheus)

    (_, _, _, port), _ = clusters
    before = SERVER_METRICS.meter_count("numSegmentsProcessed")
    port.execute_sql(QUERIES["aggregation"])
    assert SERVER_METRICS.meter_count("numSegmentsProcessed") == \
        before + SEGMENTS
    text = render_prometheus(SERVER_METRICS, "server")
    assert 'pinot_queries_total{role="server"}' in text
    assert "pinot_queryProcessingTimeMs_count" in text
    assert BROKER_METRICS.table_meter_count("cl_ssb", "queries") >= 1
