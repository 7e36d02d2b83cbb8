"""Hedged requests in the port's broker against the JAX broker's.

Ported from `tests/test_self_healing.py:355-413`. A port cluster (2
`ServerInstance(device="cpu")`, replication 2, 4 segments of 2,000 rows)
and a JAX cluster (`ServerInstance(backend="host")`, as its own tests run
it) serve the same segment directories, built once by the port's builder
from a numpy seed; both brokers select replicas round-robin, so a query
is one shard on one server in both, and each case arms the same
`server.query` fault schedule on both packages:

  * a straggler (the first RPC stalls 2 s) is beaten by the hedge fired at
    40 ms on the other replica: full exact rows, one hedge and one win on
    the response, the meters and its JSON, well inside the stall;
  * hedging every shard (a 1 us delay) merges exactly one answer per
    shard in submission order: bit-identical to the unhedged rows;
  * hedging is off by default (and a fixed 0 turns it off);
  * the loser's server receives the cancel of the losing shard id, also
    when another query reaches a server between arming and the measured
    query;
  * the query log records the hedge fields of a slow hedged query.

Every wait is bounded. Tolerance: exact.
"""

from __future__ import annotations

import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

import pinot_tpu.cluster as jcl
from pinot_tpu.engine import perf_ledger as _jax_perf_ledger
from pinot_tpu.spi import faults as jfaults
from pinot_tpu.spi.metrics import BROKER_METRICS as JBM
from pinot_tpu.spi.metrics import BrokerMeter as JBMeter
from pinot_tpu_torch import cluster as pcl
from pinot_tpu_torch.engine import perf_ledger as _port_perf_ledger
from pinot_tpu_torch.segment.builder import SegmentBuilder
from pinot_tpu_torch.spi import faults as pfaults
from pinot_tpu_torch.spi.data_types import Schema
from pinot_tpu_torch.spi.metrics import BROKER_METRICS as PBM
from pinot_tpu_torch.spi.metrics import BrokerMeter as PBMeter

ROWS = 2000
SEGMENTS = 4
TEAMS = ["BOS", "NYA", "SFN", "LAN"]
SCHEMA = Schema.build("hdg", dimensions=[("team", "STRING"), ("year", "INT")],
                      metrics=[("runs", "INT")])
SCHEMA_X = Schema.build("hdgx", dimensions=[("team", "STRING"),
                                           ("year", "INT")],
                        metrics=[("runs", "INT")])
NOCACHE = "SET resultCache = false; SET segmentCache = false; "
SQL = NOCACHE + "SELECT team, year, SUM(runs), COUNT(*) FROM hdg " \
    "GROUP BY team, year ORDER BY team, year LIMIT 100"
SQL_X = NOCACHE + "SELECT team, SUM(runs) FROM hdgx GROUP BY team " \
    "ORDER BY team LIMIT 10"
STALL_S = 2.0

PORT = SimpleNamespace(name="port", cl=pcl, faults=pfaults, bm=PBM,
                       meter=PBMeter, server_kw={"device": "cpu"})
JAX = SimpleNamespace(name="jax", cl=jcl, faults=jfaults, bm=JBM,
                      meter=JBMeter, server_kw={"backend": "host"})
BOTH = (PORT, JAX)


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


@pytest.fixture(scope="module")
def clusters(tmp_path_factory):
    rng = np.random.default_rng(20261019)
    root = tmp_path_factory.mktemp("hedging_segs")
    paths = []
    for i in range(SEGMENTS):
        cols = {
            "team": np.asarray(TEAMS, dtype=object)[rng.integers(0, 4, ROWS)],
            "year": rng.integers(2000, 2010, ROWS).astype(np.int32),
            "runs": rng.integers(0, 100, ROWS).astype(np.int32),
        }
        SegmentBuilder(SCHEMA, None, f"hdg_{i}").build(cols, root / f"hdg_{i}")
        paths.append((f"hdg_{i}", str(root / f"hdg_{i}")))
    # a second table, whose queries stand for another request's RPCs
    SegmentBuilder(SCHEMA_X, None, "hdgx_0").build(cols, root / "hdgx_0")
    out = {}
    for pkg in BOTH:
        store = pkg.cl.PropertyStore()
        ctl = pkg.cl.ClusterController(store)
        servers = [pkg.cl.ServerInstance(store, f"Server_{i}",
                                         **pkg.server_kw) for i in range(2)]
        for s in servers:
            s.start()
        ctl.add_schema(SCHEMA.to_json())
        table = ctl.create_table({"tableName": "hdg", "replication": 2})
        for name, path in paths:
            ctl.add_segment(table, name, {"location": path, "numDocs": ROWS})
        ctl.add_schema(SCHEMA_X.to_json())
        ctl.add_segment(ctl.create_table({"tableName": "hdgx",
                                          "replication": 2}),
                        "hdgx_0", {"location": str(root / "hdgx_0"),
                                   "numDocs": ROWS})
        out[pkg.name] = SimpleNamespace(store=store, servers=servers)
    yield out
    for c in out.values():
        for s in c.servers:
            s.stop()


def _arm_straggler(pkg) -> None:
    """Stall the next `server.query` RPC of table hdg for STALL_S. The
    registry counts one call index per point across the whole process, so
    a schedule of index 0 would stall whichever RPC came first, of any
    table; a match on the table with `times=1` stalls this file's next
    query alone."""
    pkg.faults.FAULTS.arm("server.query", kind="delay", delay_s=STALL_S,
                          times=1,
                          match=lambda ctx: ctx.get("table") == "hdg_OFFLINE")


def _broker(pkg, c, **kw):
    # round-robin selection: every segment of a query on one replica, in
    # both packages alike
    return pkg.cl.Broker(c.store, adaptive_selection=False, **kw)


def _close(broker) -> None:
    if hasattr(broker, "close"):
        broker.close()


def _rows(resp) -> list:
    assert not resp.exceptions, resp.exceptions
    return [[r[0], int(r[1]), int(r[2]), int(r[3])]
            for r in resp.result_table.rows]


def _straggler(pkg, c) -> dict:
    broker = _broker(pkg, c, hedge_ms=40.0)
    try:
        oracle = _rows(broker.execute_sql(SQL))
        m_hedged = pkg.bm.meter_count(pkg.meter.HEDGED_REQUESTS)
        m_wins = pkg.bm.meter_count(pkg.meter.HEDGE_WINS)
        _arm_straggler(pkg)
        t0 = time.perf_counter()
        resp = broker.execute_sql(SQL)
        elapsed = time.perf_counter() - t0
        j = resp.to_json()
        return {"rows": _rows(resp) == oracle, "partial": resp.partial_result,
                "hedged": resp.num_hedged_requests,
                "wins": resp.num_hedge_wins,
                "json": (j["numHedgedRequests"], j["numHedgeWins"]),
                "meters": (pkg.bm.meter_count(pkg.meter.HEDGED_REQUESTS)
                           - m_hedged,
                           pkg.bm.meter_count(pkg.meter.HEDGE_WINS) - m_wins),
                "rescued": elapsed < STALL_S * 0.8,
                "servers": (resp.num_servers_queried,
                            resp.num_servers_responded)}
    finally:
        _close(broker)


def test_hedge_beats_a_straggler_like_the_jax_broker(clusters):
    got = _straggler(PORT, clusters["port"])
    assert got == _straggler(JAX, clusters["jax"])
    assert got == {"rows": True, "partial": False, "hedged": 1, "wins": 1,
                   "json": (1, 1), "meters": (1, 1), "rescued": True,
                   "servers": (2, 1)}


def test_hedged_answer_is_bit_identical_to_unhedged(clusters):
    out = {}
    for pkg in BOTH:
        c = clusters[pkg.name]
        plain, hedgy = _broker(pkg, c), _broker(pkg, c, hedge_ms=0.001)
        try:
            oracle = plain.execute_sql(SQL)
            assert not oracle.exceptions
            runs = []
            for _ in range(3):
                resp = hedgy.execute_sql(SQL)
                assert not resp.exceptions and not resp.partial_result
                runs.append([list(r) for r in resp.result_table.rows])
            out[pkg.name] = (
                [list(r) for r in oracle.result_table.rows], runs,
                resp.num_hedged_requests >= 1)
        finally:
            _close(plain)
            _close(hedgy)
    oracle, runs, hedged = out["port"]
    assert all(r == oracle for r in runs) and hedged
    assert [[x[0], int(x[1]), int(x[2]), int(x[3])] for x in oracle] == \
        [[x[0], int(x[1]), int(x[2]), int(x[3])] for x in out["jax"][0]]


def test_hedging_is_off_by_default(clusters):
    out = {}
    for pkg in BOTH:
        broker = _broker(pkg, clusters[pkg.name])
        try:
            steps = [broker._hedge_delay_s(), broker.hedge_fixed_ms]
            resp = broker.execute_sql(SQL)
            steps.append((resp.num_hedged_requests, resp.num_hedge_wins,
                          "numHedgedRequests" in resp.to_json()))
            broker.hedge_fixed_ms = 0.0
            steps.append(broker._hedge_delay_s())
            broker.hedge_fixed_ms = 25.0
            steps.append(broker._hedge_delay_s())
        finally:
            _close(broker)
        out[pkg.name] = steps
    assert out["port"] == out["jax"]
    assert out["port"] == [None, None, (0, 0, False), None, 0.025]


def test_quantile_hedge_waits_for_enough_samples():
    broker = pcl.Broker(pcl.PropertyStore(), hedge_quantile=0.95)
    try:
        count = PBM.timer_stats("scatterRpcMs")[0]
        delay = broker._hedge_delay_s()
        if count < broker.hedge_min_samples:
            assert delay is None
        for _ in range(broker.hedge_min_samples):
            PBM.update_timer("scatterRpcMs", 30.0)
        delay = broker._hedge_delay_s()
        assert delay is not None and delay >= 0.001
    finally:
        broker.close()


def _loser_cancelled(pkg, c, stray=None) -> dict:
    """The loser's server receives a cancel RPC naming the losing shard of
    the faulted query, and its accountant tombstones the shard. The
    warm-up runs unhedged, one query per replica (round-robin), so no
    duplicate of it is still on its way to a server when the straggler is
    armed. ``stray``, when given, sends another request's `server.query`
    after arming and before the measured query."""
    cancels = {s.instance_id: [] for s in c.servers}
    originals = {}
    for s in c.servers:
        originals[s.instance_id] = s._rpc.handler

        def record(request, _inst=s.instance_id, _orig=s._rpc.handler):
            if request.get("type") == "cancel":
                cancels[_inst].append((request["queryId"],
                                       request.get("reason")))
            return _orig(request)

        s._rpc.handler = record
    broker = _broker(pkg, c)
    try:
        for _ in c.servers:
            broker.execute_sql(SQL)
        broker.hedge_fixed_ms = 40.0
        _arm_straggler(pkg)
        if stray is not None:
            stray(pkg, c)
        resp = broker.execute_sql(SQL)

        def ours():
            return {i: [(q, r) for q, r in v
                        if q.startswith(f"{resp.query_id}:")]
                    for i, v in cancels.items()}

        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline and not any(ours().values()):
            time.sleep(0.01)
        got = ours()
        losers = {i for i, v in got.items() if v}
        shard = next(q for v in got.values() for q, _ in v)
        loser = next(s for s in c.servers if s.instance_id in losers)
        return {"rows_ok": not resp.exceptions,
                "cancels": sum(map(len, got.values())),
                "reason": sorted({r for v in got.values() for _, r in v}),
                "shard": shard == f"{resp.query_id}:0",
                "tombstoned": loser.scheduler.accountant
                ._tombstone_match_locked(shard) is not None,
                "winner_not_cancelled": not losers & _responders(resp)}
    finally:
        _close(broker)
        for s in c.servers:
            s._rpc.handler = originals[s.instance_id]


def _other_table_query(pkg, c) -> None:
    # another request's RPC lands between arming and the measured query
    broker = _broker(pkg, c)
    try:
        assert not broker.execute_sql(SQL_X).exceptions
    finally:
        _close(broker)


def _responders(resp) -> set:
    # the port's wire stats name the answering servers; the JAX response
    # carries none, so the check is vacuous there
    return {w["server"] for w in (getattr(resp, "wire_stats", None) or [])}


def test_the_loser_is_cancelled_by_its_shard_id(clusters):
    got = _loser_cancelled(PORT, clusters["port"])
    want = _loser_cancelled(JAX, clusters["jax"])
    assert got == want
    assert got == {"rows_ok": True, "cancels": 1,
                   "reason": ["hedged duplicate superseded"], "shard": True,
                   "tombstoned": True, "winner_not_cancelled": True}


def test_a_stray_query_after_arming_leaves_the_stall_to_the_measured_query(
        clusters):
    got = _loser_cancelled(PORT, clusters["port"], _other_table_query)
    assert got == _loser_cancelled(JAX, clusters["jax"], _other_table_query)
    assert got == {"rows_ok": True, "cancels": 1,
                   "reason": ["hedged duplicate superseded"], "shard": True,
                   "tombstoned": True, "winner_not_cancelled": True}


def _logged(pkg, c) -> dict:
    broker = _broker(pkg, c, hedge_ms=40.0)
    broker.query_logger.slow_threshold_ms = 0.0
    try:
        broker.execute_sql(SQL)
        _arm_straggler(pkg)
        broker.execute_sql(SQL)
        entry = max(broker.query_logger.slow_queries(),
                    key=lambda e: e["requestId"])
        return {k: entry.get(k) for k in ("hedgedRequests", "hedgeWins",
                                          "partialResult", "exceptions")}
    finally:
        _close(broker)


def test_the_query_log_records_the_hedge(clusters):
    got = _logged(PORT, clusters["port"])
    assert got == _logged(JAX, clusters["jax"])
    assert got == {"hedgedRequests": 1, "hedgeWins": 1, "partialResult": None,
                   "exceptions": 0}


def test_concurrent_hedged_queries_stay_exact(clusters):
    """Eight clients with every shard hedged: each answer is the oracle's,
    and no shard is merged twice."""
    c = clusters["port"]
    plain, hedgy = _broker(PORT, c), _broker(PORT, c, hedge_ms=0.001)
    try:
        oracle = _rows(plain.execute_sql(SQL))
        results, errors = [], []

        def client():
            try:
                for _ in range(3):
                    results.append(_rows(hedgy.execute_sql(SQL)))
            except AssertionError as e:
                errors.append(e)

        threads = [threading.Thread(target=client) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60.0)
        assert not errors and len(results) == 24
        assert all(r == oracle for r in results)
    finally:
        _close(plain)
        _close(hedgy)
