"""The port's flight recorder against the JAX package's.

Head sampling (spi/trace.py `sample_decision`, `trace_sample_rate`), the
broker's trace store (cluster/tracestore.py), the Chrome Trace Event
export (spi/traceexport.py) and the query log (cluster/querylog.py) take
the same inputs, made from a numpy seed, in both packages and must give
the same decisions, entries, eviction order, JSON and slow ring (the wall
clock's `timestamp` fields masked). Then a port cluster on the CPU (2
`ServerInstance(device="cpu")` and a `Broker`) with sampling at 1.0
retains a plain production query with the broker's and both servers'
spans, whose export has matched begin/end pairs and connected flows, and
whose span tree equals the JAX cluster's retained trace; the response
ships without a trace and the result cache keeps a plain copy.

Every test that checks a retention reason sets the query log's slow
threshold itself, so the host's speed cannot turn `sampled` into `slow`.
Tolerance: exact.
"""

from __future__ import annotations

import json
import time
from collections import defaultdict
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import pinot_tpu.cluster as jcl
from pinot_tpu.cluster import querylog as jquerylog
from pinot_tpu.cluster.tracestore import TraceStore as JaxTraceStore
from pinot_tpu.engine import perf_ledger as _jax_perf_ledger
from pinot_tpu.spi import trace as jtrace
from pinot_tpu.spi.traceexport import to_chrome_trace as jax_chrome
from pinot_tpu_torch import cluster as pcl
from pinot_tpu_torch.cluster import querylog as pquerylog
from pinot_tpu_torch.cluster.tracestore import TraceStore
from pinot_tpu_torch.engine import perf_ledger as _port_perf_ledger
from pinot_tpu_torch.segment.builder import SegmentBuilder
from pinot_tpu_torch.spi import trace as ptrace
from pinot_tpu_torch.spi.data_types import Schema
from pinot_tpu_torch.spi.traceexport import to_chrome_trace

SAMPLE_ENV = "PINOT_TPU_TRACE_SAMPLE"
RATES = (0.0, 0.0001, 0.01, 0.25, 0.37, 0.5, 0.999, 1.0)


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


def _query_ids(seed: int, n: int = 10_000) -> list:
    """Broker-style query ids (12 hex digits) from a numpy seed."""
    rng = np.random.default_rng(seed)
    return [f"{int(x):012x}" for x in rng.integers(0, 1 << 48, n)]


# -- head sampling ------------------------------------------------------------


@pytest.mark.parametrize("rate", RATES)
def test_sample_decision_equals_jax(rate):
    ids = _query_ids(20261018)
    got = [ptrace.sample_decision(q, rate) for q in ids]
    assert got == [jtrace.sample_decision(q, rate) for q in ids]
    # every shard of a query strips to the broker's decision
    shards = [f"{q}:{k % 5}".split(":", 1)[0] for k, q in enumerate(ids)]
    assert [ptrace.sample_decision(q, rate) for q in shards] == got
    if 0.0 < rate < 1.0:
        assert abs(sum(got) / len(ids) - rate) < 0.02


@pytest.mark.parametrize("raw", [None, "", "0.25", "7", "-1", "nan-ish"])
def test_trace_sample_rate_equals_jax(monkeypatch, raw):
    if raw is None:
        monkeypatch.delenv(SAMPLE_ENV, raising=False)
    else:
        monkeypatch.setenv(SAMPLE_ENV, raw)
    assert ptrace.trace_sample_rate() == jtrace.trace_sample_rate()
    assert ptrace.TRACE_SAMPLE_ENV == jtrace.TRACE_SAMPLE_ENV


# -- trace store --------------------------------------------------------------


def _span_list(rng, n: int, pad: int) -> list:
    out = [{"operator": f"OP_{i}", "startMs": float(i), "durationMs": 1.0,
            "spanId": i} for i in range(n)]
    if pad:
        out[0]["attributes"] = {"pad": "x" * pad}
    return out


def _offers(seed: int, count: int = 40) -> list:
    """(query id, spans, kwargs) of a sequence of offers, some of them
    re-offers of an earlier id."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(count):
        qid = f"q{int(rng.integers(0, count * 3 // 4)):03d}"
        spans = _span_list(rng, int(rng.integers(1, 6)),
                           int(rng.integers(0, 1500)))
        pinned = bool(rng.random() < 0.3)
        kw = {"reason": "slow" if pinned else "sampled", "pinned": pinned,
              "table": f"t{k % 3}", "time_ms": float(rng.random() * 900),
              "exceptions": int(rng.random() < 0.1),
              "partial": bool(rng.random() < 0.1),
              "alert_id": "latency-drift-0001" if k % 11 == 0 else ""}
        out.append((qid, spans, kw))
    return out


def _masked_entry(ent):
    if ent is None:
        return None
    return {k: v for k, v in ent.items() if k != "timestamp"}


@pytest.mark.parametrize("budget,max_traces", [(1 << 20, 8), (6000, 100),
                                               (3000, 4), (1 << 20, 100)])
def test_trace_store_equals_jax(budget, max_traces):
    port = TraceStore(budget_bytes=budget, max_traces=max_traces)
    ref = JaxTraceStore(budget_bytes=budget, max_traces=max_traces)
    for qid, spans, kw in _offers(budget + max_traces):
        assert port.offer(qid, spans, **kw) == ref.offer(qid, spans, **kw)
        # the same entries survive, in the same order, after every offer
        assert [_masked_entry(e) for e in port.summaries()] == \
            [_masked_entry(e) for e in ref.summaries()]
        assert port.stats() == ref.stats()
    for qid, _, _ in _offers(budget + max_traces):
        assert _masked_entry(port.get(qid)) == _masked_entry(ref.get(qid))
    assert port.get("no-such-query") is None
    port.clear()
    assert port.stats()["traces"] == 0 and port.stats()["bytes"] == 0


def test_trace_store_evicts_unpinned_before_pinned():
    ts = TraceStore(budget_bytes=4000, max_traces=100)
    ts.offer("pinned1", _span_list(None, 3, 1000), reason="slow",
             pinned=True)
    for k in range(1, 4):
        ts.offer(f"sample{k}", _span_list(None, 3, 1000))
    assert ts.get("pinned1") is not None
    assert ts.get("sample1") is None and ts.get("sample3") is not None
    assert ts.stats()["evictions"] >= 1


# -- Chrome Trace Event export ------------------------------------------------


def _validate_chrome(ct):
    """Required keys, monotonic ts per lane, matched B/E pairs, flow s/f
    pairs. Returns (duration events, flows by id, processes)."""
    assert set(ct) >= {"traceEvents", "displayTimeUnit"}
    json.dumps(ct)
    procs, stacks, flows, dur = {}, defaultdict(list), defaultdict(list), []
    last_ts = defaultdict(lambda: -1.0)
    for e in ct["traceEvents"]:
        assert {"name", "ph", "pid"} <= set(e), e
        if e["ph"] == "M":
            if e["name"] == "process_name":
                procs[e["pid"]] = e["args"]["name"]
            continue
        key = (e["pid"], e.get("tid", 0))
        if e["ph"] in ("B", "E"):
            dur.append(e)
            assert e["ts"] >= last_ts[key] - 1e-9, e
            last_ts[key] = e["ts"]
            if e["ph"] == "B":
                stacks[key].append(e["name"])
            else:
                assert stacks[key] and stacks[key].pop() == e["name"], e
        elif e["ph"] in ("s", "f"):
            flows[e["id"]].append(e)
    assert all(not s for s in stacks.values()), dict(stacks)
    for fid, pair in flows.items():
        assert sorted(p["ph"] for p in pair) == ["f", "s"], (fid, pair)
    return dur, flows, procs


def _random_trace(seed: int) -> list:
    """A merged broker trace: broker scatter and reduce, then per shard a
    root, overlapping segment spans and an occasional parentless MSE
    stage span; a second shard on one instance is namespaced `#1`."""
    rng = np.random.default_rng(seed)
    spans = [{"operator": "BROKER_SCATTER", "startMs": 0.5,
              "durationMs": 20.0, "spanId": 1},
             {"operator": "BROKER_REDUCE", "startMs": 21.0,
              "durationMs": 3.0, "spanId": 2}]
    for k, prefix in enumerate(("Server_0", "Server_1", "Server_0#1")):
        root = f"{prefix}:1"
        spans.append({"operator": "SERVER_QUERY", "startMs": 0.0,
                      "durationMs": 15.0, "spanId": root,
                      "server": prefix.split("#")[0]})
        for j in range(int(rng.integers(1, 5))):
            t0 = float(rng.random() * 10)
            spans.append({"operator": f"segment:seg_{k}_{j}",
                          "startMs": t0,
                          "durationMs": float(rng.random() * 4),
                          "spanId": f"{prefix}:{j + 2}", "parentId": root,
                          "attributes": {"rows": int(rng.integers(0, 99)),
                                         "shape": (1, 2)}})
        if rng.random() < 0.5:
            spans.append({"operator": "mse_stage:2", "startMs": 3.0,
                          "durationMs": 2.0, "spanId": f"{prefix}:99"})
    return spans


@pytest.mark.parametrize("seed", range(6))
def test_chrome_export_equals_jax(seed):
    spans = _random_trace(seed)
    got = to_chrome_trace(spans, query_id=f"q{seed}")
    assert json.dumps(got, sort_keys=True) == json.dumps(
        jax_chrome(spans, query_id=f"q{seed}"), sort_keys=True)
    dur, flows, procs = _validate_chrome(got)
    assert len(dur) == 2 * len(spans)
    assert set(procs.values()) == {"broker", "Server_0", "Server_1",
                                   "Server_0#1"}
    names = {p[0]["name"] for p in flows.values()}
    assert {"scatter", "gather"} <= names


def test_chrome_export_two_process_and_empty_equal_jax():
    spans = [
        {"operator": "BROKER_SCATTER", "startMs": 1.0, "durationMs": 10.0,
         "spanId": 1},
        {"operator": "BROKER_REDUCE", "startMs": 11.0, "durationMs": 2.0,
         "spanId": 2},
        {"operator": "SERVER_QUERY", "startMs": 0.0, "durationMs": 8.0,
         "spanId": "Server_0:1", "server": "Server_0"},
        {"operator": "segment:seg_0", "startMs": 1.0, "durationMs": 3.0,
         "spanId": "Server_0:2", "parentId": "Server_0:1"},
        {"operator": "segment:seg_1", "startMs": 2.0, "durationMs": 3.0,
         "spanId": "Server_0:3", "parentId": "Server_0:1"},
    ]
    assert to_chrome_trace(spans, "qtest") == jax_chrome(spans, "qtest")
    assert to_chrome_trace([]) == jax_chrome([])
    assert to_chrome_trace([])["traceEvents"] == []


# -- query log ----------------------------------------------------------------


class _Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def _responses(seed: int, n: int = 60) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        out.append(SimpleNamespace(
            time_used_ms=float(rng.random() * 1000),
            num_docs_scanned=int(rng.integers(0, 10_000)),
            num_segments_queried=int(rng.integers(1, 5)),
            num_device_dispatches=int(rng.integers(0, 3)),
            num_compiles=0, total_docs=10_000,
            exceptions=["X: boom"] if k % 13 == 0 else [],
            partial_result=k % 17 == 0,
            num_servers_queried=2, num_servers_responded=2 - (k % 17 == 0),
            num_scatter_retries=k % 7 == 0,
            num_corrupt_shards_retried=0,
            cache_outcome="miss" if k % 2 else "",
            trace_info=None))
    return out


@pytest.mark.parametrize("rate", [0.5, 2.0, 10.0])
def test_query_log_slow_ring_and_throttle_equal_jax(monkeypatch, caplog,
                                                    rate):
    clock = _Clock()
    for mod in (pquerylog, jquerylog):
        monkeypatch.setattr(mod, "time", SimpleNamespace(
            monotonic=clock, time=time.time))
    # a slow entry names the active alerts of its plan or table
    _port_perf_ledger.ALERTS.clear()
    _jax_perf_ledger.ALERTS.clear()
    port = pquerylog.QueryLogger(max_lines_per_s=rate,
                                 slow_threshold_ms=400.0, slow_buffer_size=8)
    ref = jquerylog.QueryLogger(max_lines_per_s=rate,
                                slow_threshold_ms=400.0, slow_buffer_size=8)
    logged = {}
    for name, ql in (("port", port), ("ref", ref)):
        clock.t = 1000.0
        caplog.clear()
        with caplog.at_level("INFO"):
            for k, resp in enumerate(_responses(7)):
                clock.t += 0.05 * (k % 4)
                ql.log(f"SELECT {k} FROM t", resp, table="t")
        logged[name] = [r.getMessage() for r in caplog.records]
    assert logged["port"] == logged["ref"]
    assert 0 < len(logged["port"]) < 60
    assert any("droppedSinceLast=" in m for m in logged["port"])
    mask = lambda es: [{k: v for k, v in e.items() if k != "timestamp"}  # noqa: E731
                       for e in es]
    assert mask(port.slow_queries()) == mask(ref.slow_queries())
    slow = port.slow_queries()
    assert len(slow) == 8 and all(e["timeMs"] >= 400.0 for e in slow)
    assert [e["timeMs"] for e in slow] == sorted(
        (e["timeMs"] for e in slow), reverse=True)


# -- the cluster: sampled retention end to end --------------------------------


FR = Schema.build("frtab", dimensions=[("frk", "INT")],
                  metrics=[("frv", "INT")])
SQL = "SELECT frk, SUM(frv) FROM frtab GROUP BY frk LIMIT 20"
NO_CACHE = "SET resultCache = false; "


@pytest.fixture(scope="module")
def segments(tmp_path_factory):
    root = tmp_path_factory.mktemp("fr_segs")
    rng = np.random.default_rng(11)
    out = []
    for i in range(3):
        cols = {"frk": rng.integers(0, 16, 400).astype(np.int32),
                "frv": rng.integers(0, 100, 400).astype(np.int32)}
        name = f"frtab_{i}"
        SegmentBuilder(FR, None, name).build(cols, root / name)
        out.append((name, str(root / name)))
    return out


def _start(pkg, segs):
    store = pkg.PropertyStore()
    ctl = pkg.ClusterController(store)
    if pkg is pcl:
        servers = [pkg.ServerInstance(store, f"Server_{i}", device="cpu")
                   for i in range(2)]
    else:
        servers = [pkg.ServerInstance(store, f"Server_{i}", backend="tpu")
                   for i in range(2)]
    for s in servers:
        s.start()
    ctl.add_schema(FR.to_json())
    t = ctl.create_table({"tableName": "frtab", "replication": 1})
    for name, path in segs:
        ctl.add_segment(t, name, {"location": path, "numDocs": 400})
    broker = pkg.Broker(store, scatter_backoff_ms=5) if pkg is pcl \
        else pkg.Broker(store)
    # a retention reason must not depend on this host's speed
    broker.query_logger.slow_threshold_ms = 60_000.0
    return servers, broker


@pytest.fixture(scope="module")
def clusters(segments):
    mp = pytest.MonkeyPatch()
    mp.setenv("PINOT_TPU_SEGMENT_CACHE", "0")
    mp.setenv("PINOT_TPU_FUSED", "interpret")
    mp.setenv("PINOT_TPU_MESH_DEVICES", "1")
    port, ref = _start(pcl, segments), _start(jcl, segments)
    yield port, ref
    for servers, _ in (port, ref):
        for s in servers:
            s.stop()
    port[1].close()
    mp.undo()


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


TIMINGS = ("ms", "timeMs", "deviceExecMs", "compileMs", "coalesceWaitMs")


def _span_tree(trace: list) -> list:
    """(name, parent name, server, attributes but timings) of each span:
    the tree without ids or clocks, and without the attributes that
    differ by design (the port's `device` and `fused`, the JAX package's
    `hbm*`; tests/test_torch_cluster.py)."""
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


def test_sampled_production_query_retained(clusters, monkeypatch):
    (_, port), (_, ref) = clusters
    # resident planes on both, so the traced run's transfers agree
    assert port.execute_sql(NO_CACHE + SQL).result_table.rows == \
        ref.execute_sql(NO_CACHE + SQL).result_table.rows
    monkeypatch.setenv(SAMPLE_ENV, "1.0")
    got, want = port.execute_sql(NO_CACHE + SQL), ref.execute_sql(
        NO_CACHE + SQL)
    assert not got.exceptions, got.exceptions
    assert got.result_table.rows == want.result_table.rows
    qid = got.query_id
    assert qid and got.trace_id == qid
    # the client never asked for a trace: the response ships plain
    assert got.trace_info is None and want.trace_info is None
    ent = port.trace_store.get(qid)
    ref_ent = ref.trace_store.get(want.query_id)
    assert ent["reason"] == ref_ent["reason"] == "sampled"
    assert not ent["pinned"]
    assert _span_tree(ent["spans"]) == _span_tree(ref_ent["spans"])
    ops = [s["operator"] for s in ent["spans"]]
    assert "BROKER_SCATTER" in ops and "BROKER_REDUCE" in ops
    assert {s.get("server") for s in ent["spans"]} >= {"Server_0",
                                                       "Server_1"}
    dur, flows, procs = _validate_chrome(to_chrome_trace(ent["spans"], qid))
    assert set(procs.values()) == {"broker", "Server_0", "Server_1"}
    assert len(dur) == 2 * len(ent["spans"])
    reached = {p[1]["pid"] for p in flows.values()
               if p[0]["name"] == "scatter"}
    assert reached == {pid for pid, n in procs.items() if n != "broker"}
    assert any(p[0]["name"] == "gather" for p in flows.values())


def test_sampling_off_retains_nothing(clusters, monkeypatch):
    (_, port), _ = clusters
    monkeypatch.setenv(SAMPLE_ENV, "0.0")
    before = port.trace_store.stats()["traces"]
    resp = port.execute_sql(NO_CACHE + SQL)
    assert not resp.exceptions
    assert getattr(resp, "trace_id", None) is None
    assert port.trace_store.stats()["traces"] == before


def test_slow_sampled_query_is_pinned_and_linked(clusters, monkeypatch):
    (_, port), _ = clusters
    monkeypatch.setenv(SAMPLE_ENV, "1.0")
    monkeypatch.setattr(port.query_logger, "slow_threshold_ms", 0.0)
    resp = port.execute_sql(NO_CACHE + SQL)
    ent = port.trace_store.get(resp.query_id)
    assert ent["pinned"] and ent["reason"] == "slow"
    linked = [e for e in port.query_logger.slow_queries()
              if e.get("traceId") == resp.query_id]
    assert linked and "trace" not in linked[0]
    assert linked[0]["phases"]["deviceExecMs"] >= 0


def test_explicit_trace_still_ships_to_client(clusters, monkeypatch):
    (_, port), _ = clusters
    monkeypatch.delenv(SAMPLE_ENV, raising=False)
    resp = port.execute_sql("SET trace = true; " + NO_CACHE + SQL)
    assert resp.trace_info, "SET trace keeps the client's copy"
    ent = port.trace_store.get(resp.query_id)
    assert ent["reason"] == "traced"


def test_sampled_result_cache_entry_is_plain(clusters, monkeypatch):
    (_, port), _ = clusters
    monkeypatch.setenv(SAMPLE_ENV, "1.0")
    monkeypatch.setenv("PINOT_TPU_RESULT_CACHE", "1")
    sql = "SELECT frk, SUM(frv) FROM frtab GROUP BY frk LIMIT 19"
    r1 = port.execute_sql(sql)
    assert r1.cache_outcome == "miss" and r1.trace_info is None
    assert port.trace_store.get(r1.query_id)["reason"] == "sampled"
    r2 = port.execute_sql(sql)
    assert r2.cache_outcome == "hit"
    assert r2.trace_info is None, "a hit must never replay a sampled trace"
    assert r2.result_table.rows == r1.result_table.rows


def test_broker_gauges_read_the_flight_recorder(clusters, monkeypatch):
    from pinot_tpu_torch.spi.metrics import BROKER_METRICS

    (_, port), _ = clusters
    monkeypatch.setenv(SAMPLE_ENV, "1.0")
    port.execute_sql(NO_CACHE + SQL)
    gauges = BROKER_METRICS.snapshot()["gauges"]
    stats = port.trace_store.stats()
    assert gauges["traceStoreTraces"] == stats["traces"] >= 1
    assert gauges["traceStoreBytes"] == stats["bytes"]
    assert gauges["traceStoreEvictions"] == stats["evictions"]
    assert gauges["ledgerFingerprints"] >= 1
