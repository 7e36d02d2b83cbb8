"""The port's broker admission layer against the JAX package's.

Unit cases feed the same inputs to both packages' classes: the
AdmissionController (a full queue rejects at once, the wait is bounded by
the deadline, a disabled gate is a no-op, a heavy query is shed at
saturation), the QueryQuotaManager's window, the ResponseStore's pages,
TTL and entry cap, and the WorkloadTracker over the same responses on one
fake clock (cost reports, rollups, expected_cost_ms, table_costs,
recommender_input and the snapshot equal). The JAX package reads its
clocks from its modules' `time`, which the tests replace; the port takes
them as arguments.

Cluster cases run a port cluster (2 `ServerInstance(device="cpu")`,
replication 2, 4 segments of 2,000 rows) beside a JAX cluster
(`ServerInstance(backend="host")`, as its own tests run it) over the same
segment directories, built once by the port's builder from a numpy seed:
a QPS quota on the single-stage and the multi-stage path, a synthetic
overload of the admission gate (the same rejections, meters and query-log
fields), the gate in front of the multi-stage dispatch, cursor pages, the
workload rollup of a burst, and the broker's beacon. Every wait is
bounded. Tolerance: exact.
"""

from __future__ import annotations

import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

import pinot_tpu.cluster as jcl
from pinot_tpu.cluster import quota as jquota
from pinot_tpu.cluster import workload as jworkload
from pinot_tpu.engine import perf_ledger as _jax_perf_ledger
from pinot_tpu.engine.results import BrokerResponse as JaxResponse
from pinot_tpu.spi import faults as jfaults
from pinot_tpu.spi.metrics import BROKER_METRICS as JBM
from pinot_tpu.spi.metrics import BrokerMeter as JBMeter
from pinot_tpu_torch import cluster as pcl
from pinot_tpu_torch.cluster import quota as pquota
from pinot_tpu_torch.cluster import workload as pworkload
from pinot_tpu_torch.engine import perf_ledger as _port_perf_ledger
from pinot_tpu_torch.engine.results import BrokerResponse
from pinot_tpu_torch.segment.builder import SegmentBuilder
from pinot_tpu_torch.spi import faults as pfaults
from pinot_tpu_torch.spi.data_types import Schema
from pinot_tpu_torch.spi.metrics import BROKER_METRICS as PBM
from pinot_tpu_torch.spi.metrics import BrokerMeter as PBMeter

ROWS = 2000
SEGMENTS = 4
TEAMS = ["BOS", "NYA", "SFN", "LAN"]
SCHEMA = Schema.build("adm", dimensions=[("team", "STRING"), ("year", "INT")],
                      metrics=[("runs", "INT")])
NOCACHE = "SET resultCache = false; SET segmentCache = false; "
SQL = NOCACHE + "SELECT team, SUM(runs) FROM adm GROUP BY team ORDER BY team"
MSE_SQL = ("SET useMultistageEngine = true; SELECT team, SUM(runs) FROM adm "
           "GROUP BY team ORDER BY team")
SEL_SQL = NOCACHE + ("SELECT team, year, runs FROM adm WHERE runs > 40 "
                     "ORDER BY runs DESC, year, team LIMIT 300")

PORT = SimpleNamespace(name="port", cl=pcl, faults=pfaults, bm=PBM,
                       meter=PBMeter, quota=pquota)
JAX = SimpleNamespace(name="jax", cl=jcl, faults=jfaults, bm=JBM,
                      meter=JBMeter, quota=jquota)
BOTH = (PORT, JAX)


class FakeClock:
    """One clock for both packages: `monotonic`/`time` for the JAX
    modules' `time`, the instance itself for the port's arguments."""

    def __init__(self, t: float = 1000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def monotonic(self) -> float:
        return self.t

    def time(self) -> float:
        return 1_700_000_000.0 + self.t

    def perf_counter(self) -> float:
        return time.perf_counter()


@pytest.fixture(scope="module", autouse=True)
def _no_ledger_left_behind():
    yield
    for mod in (_jax_perf_ledger, _port_perf_ledger):
        mod.PERF_LEDGER.clear()
        mod.ALERTS.clear()


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("PINOT_TPU_SEGMENT_CACHE", "0")
    monkeypatch.setenv("PINOT_TPU_RESULT_CACHE", "0")
    monkeypatch.setenv("PINOT_TPU_FUSED", "interpret")
    yield
    pfaults.FAULTS.reset()
    jfaults.FAULTS.reset()


def _wait(cond, timeout=10.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.01)
    raise AssertionError(f"timed out waiting for {msg}")


# -- unit: the admission gate --------------------------------------------------


@pytest.mark.parametrize("pkg", BOTH, ids=lambda p: p.name)
def test_admission_queue_full_rejects_at_once(pkg):
    a = pkg.quota.AdmissionController(max_inflight=1, max_queued=0)
    with a.admit(timeout_s=5.0):
        t0 = time.perf_counter()
        with pytest.raises(pkg.quota.AdmissionRejectedError,
                           match="queue full"):
            with a.admit(timeout_s=5.0):
                pass
        assert time.perf_counter() - t0 < 1.0
        assert (a.inflight(), a.queued()) == (1, 0)
    assert a.inflight() == 0


@pytest.mark.parametrize("pkg", BOTH, ids=lambda p: p.name)
def test_admission_wait_is_bounded_by_the_deadline(pkg):
    a = pkg.quota.AdmissionController(max_inflight=1, max_queued=4)
    waits0 = pkg.bm.timer_stats("admissionWaitMs")[0]
    with a.admit(timeout_s=5.0):
        t0 = time.perf_counter()
        with pytest.raises(pkg.quota.AdmissionRejectedError,
                           match="deadline"):
            with a.admit(timeout_s=0.1):
                pass
        assert 0.08 <= time.perf_counter() - t0 < 1.0
    assert pkg.bm.timer_stats("admissionWaitMs")[0] == waits0 + 1
    with a.admit(timeout_s=0.1):
        assert a.inflight() == 1
    assert a.inflight() == 0


def test_queued_query_takes_the_freed_slot():
    """A waiter inside its deadline gets the slot the holder frees; the
    queue gauge counts it while it waits."""
    a = pquota.AdmissionController(max_inflight=1, max_queued=1)
    got = threading.Event()
    held = a.admit(timeout_s=5.0)
    held.__enter__()

    def waiter():
        with a.admit(timeout_s=5.0):
            got.set()

    t = threading.Thread(target=waiter)
    t.start()
    _wait(lambda: a.queued() == 1, msg="waiter queued")
    assert not got.is_set()
    held.__exit__(None, None, None)
    assert got.wait(5.0)
    t.join(5.0)
    assert (a.inflight(), a.queued()) == (0, 0)


@pytest.mark.parametrize("pkg", BOTH, ids=lambda p: p.name)
def test_disabled_gate_is_a_noop(pkg):
    a = pkg.quota.AdmissionController(max_inflight=None)
    with a.admit(timeout_s=0.0):
        with a.admit(timeout_s=0.0):
            assert a.inflight() == 0


@pytest.mark.parametrize("pkg", BOTH, ids=lambda p: p.name)
def test_saturated_gate_sheds_a_heavy_query(pkg):
    a = pkg.quota.AdmissionController(max_inflight=1, max_queued=4,
                                      heavy_query_ms=100.0)
    with a.admit(timeout_s=5.0):
        with pytest.raises(pkg.quota.AdmissionRejectedError,
                           match="cost-aware"):
            with a.admit(timeout_s=5.0, cost_hint_ms=250.0):
                pass
        with pytest.raises(pkg.quota.AdmissionRejectedError,
                           match="deadline"):
            with a.admit(timeout_s=0.05, cost_hint_ms=5.0):
                pass


# -- unit: quota window and the response store ---------------------------------


def _quota_trace(pkg, monkeypatch) -> list:
    clock = FakeClock()
    if pkg is JAX:
        monkeypatch.setattr(jquota, "time", clock)
        q = jquota.QueryQuotaManager(window_s=1.0)
    else:
        q = pquota.QueryQuotaManager(window_s=1.0, clock=clock)
    q.set_qps_limit("t", 3)
    out = []
    for dt in (0.0, 0.1, 0.1, 0.1, 0.5, 0.3, 0.2, 0.0, 1.5, 0.0):
        clock.t += dt
        try:
            q.acquire("t")
            q.acquire("other")  # no limit: never counted
            out.append("ok")
        except pkg.quota.QueryQuotaExceededError as e:
            out.append(str(e))
    q.set_qps_limit("t", None)
    q.acquire("t")
    return out


def test_quota_window_equals_the_jax_manager(monkeypatch):
    port = _quota_trace(PORT, monkeypatch)
    assert port == _quota_trace(JAX, monkeypatch)
    assert port.count("ok") == 8 and port.count("table t exceeded 3.0 qps") == 2


def _store_trace(pkg, monkeypatch) -> list:
    clock = FakeClock()
    if pkg is JAX:
        monkeypatch.setattr(jquota, "time", clock)
        rs = jquota.ResponseStore(ttl_s=10.0, max_entries=3)
    else:
        rs = pquota.ResponseStore(ttl_s=10.0, max_entries=3, clock=clock)
    rows = [[i, f"r{i}"] for i in range(11)]
    out, ids = [], []
    for k in range(4):
        clock.t += 2.0
        ids.append(rs.create_cursor(["a", "b"], ["INT", "STRING"], rows))
    pages = []
    for off in range(0, 12, 4):
        p = dict(rs.fetch(ids[-1], off, 4))
        p.pop("cursorId")
        pages.append(p)
    out.append(pages)
    # the cap evicted the oldest cursor
    out.append([_exists(rs, i) for i in ids])
    clock.t += 9.0  # the 2nd and 3rd cursors pass their TTL, the 4th not
    ids.append(rs.create_cursor(["a"], ["INT"], [[1]]))
    out.append([_exists(rs, i) for i in ids])
    out.append([rs.delete(ids[-1]), rs.delete(ids[-1])])
    return out


def _exists(rs, cid) -> bool:
    try:
        rs.fetch(cid, 0, 1)
        return True
    except KeyError:
        return False


def test_response_store_equals_the_jax_store(monkeypatch):
    port = _store_trace(PORT, monkeypatch)
    assert port == _store_trace(JAX, monkeypatch)
    assert port[1] == [False, True, True, True]
    assert port[2] == [False, False, False, True, True]


# -- unit: the workload tracker -------------------------------------------------


def _responses(cls):
    spans = [{"operator": "BROKER_REDUCE", "durationMs": 1.5,
              "attributes": {"deviceExecMs": 2.25, "compileMs": 0.0,
                             "transferBytes": 4096}}]
    return [
        ("SET clientId = 'dash'; SELECT COUNT(*) FROM t", "t",
         cls(time_used_ms=12.5, num_docs_scanned=1000,
             num_device_dispatches=2, num_segments_cache_hit=1,
             num_segments_cache_miss=3, num_scatter_retries=1)),
        ("SELECT SUM(x) FROM t", "t",
         cls(time_used_ms=40.0, num_docs_scanned=4000, trace_info=spans,
             num_hedged_requests=2, num_hedge_wins=1)),
        ("SELECT x FROM u LIMIT 5", "u",
         cls(time_used_ms=3.0, exceptions=["boom"], query_rejected=True)),
        ("SET clientId = 'dash'; SELECT COUNT(*) FROM t", "t",
         _with(cls(time_used_ms=8.0,
                   mse_stage_stats={1: {"shuffled_bytes": 512}}),
               cache_outcome="hit")),
        ("SELECT 1", "", cls(time_used_ms=1.0)),
    ]


def _with(resp, **attrs):
    # the JAX response has no cache_outcome field: its broker sets it
    for k, v in attrs.items():
        setattr(resp, k, v)
    return resp


def _workload_trace(pkg, monkeypatch) -> list:
    clock = FakeClock()
    if pkg is JAX:
        monkeypatch.setattr(jworkload, "time", clock)
        w = jworkload.WorkloadTracker(half_life_s=60.0)
        cls = JaxResponse
    else:
        w = pworkload.WorkloadTracker(half_life_s=60.0, clock=clock,
                                      wall_clock=clock.time)
        cls = BrokerResponse
    out = []
    for sql, table, resp in _responses(cls):
        clock.t += 7.0
        out.append(w.note_response(sql, resp, table=table))
        out.append(round(w.expected_cost_ms(table), 6))
    clock.t += 30.0
    out.append(w.table_costs())
    out.append(w.recommender_input("t"))
    out.append(w.recommender_input("missing"))
    out.append(w.snapshot())
    return out


def test_workload_tracker_equals_the_jax_tracker(monkeypatch):
    port = _workload_trace(PORT, monkeypatch)
    want = _workload_trace(JAX, monkeypatch)
    assert port == want
    assert port[0]["clientId"] == "dash" and port[4]["rejected"] == 1
    assert port[2]["deviceMs"] == 2.25 and port[2]["hedgedRequests"] == 2


def test_client_id_of_equals_the_jax_parser():
    for sql in ("SET clientId = 'dash-1'; SELECT 1", "set CLIENTID=ops.x "
                "select 1", "SELECT 1", "SET clientId = a@b; SELECT 2"):
        assert pworkload.client_id_of(sql) == jworkload.client_id_of(sql)


# -- the cluster ---------------------------------------------------------------


@pytest.fixture(scope="module")
def segment_dirs(tmp_path_factory):
    rng = np.random.default_rng(20261018)
    root = tmp_path_factory.mktemp("admission_segs")
    out, rows = [], []
    for i in range(SEGMENTS):
        cols = {
            "team": np.asarray(TEAMS, dtype=object)[rng.integers(0, 4, ROWS)],
            "year": rng.integers(2000, 2010, ROWS).astype(np.int32),
            "runs": rng.integers(0, 100, ROWS).astype(np.int32),
        }
        name = f"adm_{i}"
        SegmentBuilder(SCHEMA, None, name).build(cols, root / name)
        out.append((name, str(root / name)))
        rows.append(cols)
    return out


def _cluster(pkg, segment_dirs, **broker_kw):
    store = pkg.cl.PropertyStore()
    ctl = pkg.cl.ClusterController(store)
    kw = {"device": "cpu"} if pkg is PORT else {"backend": "host"}
    servers = [pkg.cl.ServerInstance(store, f"Server_{i}", **kw)
               for i in range(2)]
    for s in servers:
        s.start()
    ctl.add_schema(SCHEMA.to_json())
    table = ctl.create_table({"tableName": "adm", "replication": 2})
    for name, path in segment_dirs:
        ctl.add_segment(table, name, {"location": path, "numDocs": ROWS})
    broker = pkg.cl.Broker(store, **broker_kw)
    return SimpleNamespace(store=store, servers=servers, broker=broker)


def _stop(c) -> None:
    for s in c.servers:
        s.stop()
    if hasattr(c.broker, "close"):
        c.broker.close()


@pytest.fixture(scope="module")
def clusters(segment_dirs):
    port, ref = _cluster(PORT, segment_dirs), _cluster(JAX, segment_dirs)
    yield {"port": port, "jax": ref}
    _stop(port)
    _stop(ref)


def _rows(resp) -> list:
    assert not resp.exceptions, resp.exceptions
    return [[r[0], int(r[1])] for r in resp.result_table.rows]


def test_cluster_answers_equal_before_admission(clusters):
    got = clusters["port"].broker.execute_sql(SQL)
    want = clusters["jax"].broker.execute_sql(SQL)
    assert _rows(got) == _rows(want)
    j = got.to_json()
    for key in ("queryRejected", "numHedgedRequests", "coldSegmentsWarming"):
        assert key not in j


def _burst(pkg, c, sql, monkeypatch, limit=2, n=5) -> list:
    """n queries of `sql` at one instant under a `limit` qps quota on
    table adm, then one more after the window passed."""
    clock = FakeClock()
    if pkg is JAX:
        monkeypatch.setattr(jquota, "time", clock)
        c.broker.quota = jquota.QueryQuotaManager()
    else:
        c.broker.quota = pquota.QueryQuotaManager(clock=clock)
    c.broker.quota.set_qps_limit("adm", limit)
    out = []
    for _ in range(n):
        resp = c.broker.execute_sql(sql)
        out.append(resp.exceptions[0] if resp.exceptions else _rows(resp))
    clock.t += 1.5
    resp = c.broker.execute_sql(sql)
    out.append(resp.exceptions[0] if resp.exceptions else _rows(resp))
    c.broker.quota.set_qps_limit("adm", None)
    return out


@pytest.mark.parametrize("sql", [SQL, MSE_SQL], ids=["single", "multistage"])
def test_qps_quota_rejects_the_excess_like_the_jax_broker(
        clusters, sql, monkeypatch):
    got = _burst(PORT, clusters["port"], sql, monkeypatch)
    want = _burst(JAX, clusters["jax"], sql, monkeypatch)
    assert got == want
    rejected = [x for x in got if isinstance(x, str)]
    assert len(rejected) == 3
    assert all(x.startswith("QueryQuotaExceededError") for x in rejected)


def _overload(pkg, c) -> dict:
    """Hold the broker's only slot with a query stalled inside the cluster
    and send another: it is rejected at once, the held one is exact."""
    saved = c.broker.admission
    c.broker.admission = pkg.quota.AdmissionController(max_inflight=1,
                                                       max_queued=0)
    c.broker.query_logger.slow_threshold_ms = 0.0
    m0 = pkg.bm.meter_count(pkg.meter.QUERIES_REJECTED)
    pkg.faults.FAULTS.arm("server.query", kind="delay", delay_s=0.6, times=1)
    results = {}
    t = threading.Thread(
        target=lambda: results.setdefault("slow", c.broker.execute_sql(SQL)))
    try:
        t.start()
        _wait(lambda: c.broker.admission.inflight() == 1,
              msg="slow query holding the slot")
        inflight_gauge = pkg.bm.gauge_value("brokerQueriesInflight")
        t0 = time.perf_counter()
        rejected = c.broker.execute_sql(SQL)
        fast = time.perf_counter() - t0 < 0.5
        mse_rejected = c.broker.execute_sql(MSE_SQL)
        t.join(10.0)
        flags = [e.get("queryRejected", False)
                 for e in c.broker.query_logger.slow_queries()]
    finally:
        pkg.faults.FAULTS.reset()
        c.broker.admission = saved
        c.broker.query_logger.slow_threshold_ms = 500.0
    return {
        "rejected": (rejected.query_rejected, rejected.result_table is None,
                     rejected.exceptions[0].split(":")[0],
                     rejected.to_json().get("queryRejected"), fast),
        "mse_rejected": (mse_rejected.query_rejected,
                         mse_rejected.exceptions[0].split(":")[0]),
        "meter": pkg.bm.meter_count(pkg.meter.QUERIES_REJECTED) - m0,
        "inflight_gauge": inflight_gauge,
        "slow_rows": _rows(results["slow"]),
        "log": flags.count(True),
    }


def test_synthetic_overload_rejects_like_the_jax_broker(clusters):
    got = _overload(PORT, clusters["port"])
    want = _overload(JAX, clusters["jax"])
    # the JAX broker's gauge stays bound to the controller it built, so it
    # misses the one the test swaps in; the port's reads the current one
    assert got.pop("inflight_gauge") == 1
    want.pop("inflight_gauge")
    assert got == want
    assert got["rejected"] == (True, True, "QueryRejectedError", True, True)
    assert got["meter"] == 2
    assert got["log"] == 2


def _pages(c, sql, size) -> list:
    first = c.broker.execute_sql_cursor(sql, num_rows=size)
    pages = [first]
    while pages[-1]["offset"] + pages[-1]["numRows"] < first["totalRows"]:
        pages.append(c.broker.fetch_cursor(
            first["cursorId"], pages[-1]["offset"] + size, size))
    return [{k: v for k, v in p.items() if k != "cursorId"} for p in pages]


def test_cursor_pages_equal_the_jax_broker_and_the_full_rows(clusters):
    got = _pages(clusters["port"], SEL_SQL, 64)
    assert got == _pages(clusters["jax"], SEL_SQL, 64)
    full = clusters["port"].broker.execute_sql(SEL_SQL).result_table.rows
    assert [r for p in got for r in p["resultTable"]["rows"]] == \
        [list(r) for r in full]
    assert len(got) == -(-len(full) // 64) > 1
    bad = clusters["port"].broker.execute_sql_cursor(
        NOCACHE + "SELECT nope FROM adm LIMIT 3")
    assert bad["exceptions"]
    with pytest.raises(KeyError):
        clusters["port"].broker.fetch_cursor("no-such-cursor", 0, 10)


def test_workload_rollup_of_a_burst_feeds_the_beacon(clusters):
    """Every response, a rejected one included, folds into the tracker;
    the beacon carries the table's decayed mean cost and the gate load."""
    b = clusters["port"].broker
    b.workload = pworkload.WorkloadTracker()
    for _ in range(3):
        b.execute_sql(SQL)
    b.execute_sql(NOCACHE + "SELECT nope FROM adm")
    snap = b.workload.snapshot()["tables"]["adm"]
    assert snap["queries"] == 4.0 and snap["failures"] == 1.0
    assert b.workload.expected_cost_ms("adm") > 0
    state = b.publish_state()
    assert state["tableCostsMs"]["adm"] == round(
        b.workload.expected_cost_ms("adm"), 3)
    assert (state["inflight"], state["queued"]) == (0, 0)
    assert clusters["port"].store.get(f"/BROKERSTATE/{b.broker_id}") == state
    inp = b.workload.recommender_input("adm")
    assert inp["queries"][0]["sql"] == SQL


def test_beacon_publishes_from_the_query_path_when_asked(segment_dirs):
    c = _cluster(PORT, segment_dirs, state_publish_s=0.001,
                 broker_id="Broker_beacon")
    try:
        c.broker.execute_sql(SQL)
        state = c.store.get("/BROKERSTATE/Broker_beacon")
        assert state is not None and "adm" in state["tableCostsMs"]
    finally:
        _stop(c)


def test_server_health_lists_breakers_and_selection(clusters):
    b = clusters["port"].broker
    b.execute_sql(SQL)
    b.breakers.record_failure("Server_0")
    try:
        health = b.server_health()
        assert health["Server_0"]["consecutiveFailures"] == 1
        assert health["Server_0"]["state"] == "closed"
        assert "ewmaLatencyMs" in health["Server_0"]
    finally:
        b.breakers.record_success("Server_0")
