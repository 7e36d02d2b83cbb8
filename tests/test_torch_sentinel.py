"""The port's regression sentinel against the JAX package's, and end to
end on a port cluster.

  * Rule parity: both packages' `PerfRegressionSentinel`, each over its
    own `PerfLedger` and `AlertBook` on one frozen clock, evaluate the
    same synthetic ledger histories, one per rule (latency-drift,
    compile-storm, fallback-surge, cache-collapse, crossing-regression,
    slo-burn, and an SLO override from a table config), and must give the
    same anomalies, burn rates, alert states and armed exemplars after
    every evaluation (wall-clock stamps masked). Differences by design,
    pinned here: the port's report carries `benchBaseline: None` (the
    JAX package attaches its newest TPU benchmark round), and on the
    port's own traffic `compile-storm` never fires, because its responses
    count no compile (eager PyTorch compiles nothing).
  * End to end, as tests/test_sentinel_rest.py does it for the JAX
    package: a port cluster on the CPU takes a baseline, a 50 ms
    `device.dispatch` delay raises `latency-drift` within 12 rounds, the
    alert pins exemplar traces that export to Chrome and link the alert
    id, it clears after clean rounds, and `sentinel()` lands
    `/PERF/LEDGER` and `/PERF/SENTINEL` in the store; the ledger survives
    a store restart.
"""

from __future__ import annotations

import itertools
from types import SimpleNamespace

import numpy as np
import pytest

from pinot_tpu.cluster import PropertyStore as JaxStore
from pinot_tpu.cluster import sentinel as jsentinel
from pinot_tpu.engine import perf_ledger as jpl
from pinot_tpu_torch import cluster as pcl
from pinot_tpu_torch.cluster import sentinel as psentinel
from pinot_tpu_torch.cluster.sentinel import (SENTINEL_REPORT_PATH,
                                              PerfRegressionSentinel)
from pinot_tpu_torch.engine import perf_ledger as ppl
from pinot_tpu_torch.engine.perf_ledger import (ALERTS, LEDGER_PATH,
                                                PERF_LEDGER, PerfLedger)
from pinot_tpu_torch.segment.builder import SegmentBuilder
from pinot_tpu_torch.spi import faults
from pinot_tpu_torch.spi.data_types import Schema
from pinot_tpu_torch.spi.traceexport import to_chrome_trace

WALL = ("firstSeen", "savedAtMs", "firstFiredMs", "lastUpdateMs",
        "clearedMs", "checkedAtMs")


class _Clock:
    def __init__(self):
        self.t = 50_000.0

    def __call__(self):
        return self.t


def _masked(obj):
    if isinstance(obj, dict):
        return {k: ("*" if k in WALL else _masked(v)) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_masked(v) for v in obj)
    return obj


def _frozen(monkeypatch) -> _Clock:
    """One frozen clock for both packages' ledgers, window math and wall
    stamps alike (the alert book orders by its wall stamps)."""
    clock = _Clock()
    for mod in (ppl, jpl):
        monkeypatch.setattr(mod, "_mono", clock)
        monkeypatch.setattr(mod, "time", SimpleNamespace(time=clock))
    return clock


def _rec(key="fp:plan", table="tab", **kw):
    return ("record", key, dict({"table": table, "time_ms": 5.0}, **kw))


def _history(rule: str, seed: int) -> list:
    """A baseline, a regression of `rule` evaluated round by round, then
    a recovery: a list of steps."""
    rng = np.random.default_rng(seed)
    jitter = lambda: float(rng.uniform(0.9, 1.1))  # noqa: E731
    base = {"latency-drift": {}, "compile-storm": {"compiles": 0},
            "cache-collapse": {"cache_outcome": "hit"},
            "crossing-regression": {"host_crossings": 1},
            "fallback-surge": {}, "slo-burn": {},
            "slo-override": {}}[rule]
    bad = {"latency-drift": {"time_ms": 60.0},
           "compile-storm": {"compiles": 1},
           "cache-collapse": {"cache_outcome": "miss"},
           "crossing-regression": {"host_crossings": 4},
           "fallback-surge": {}, "slo-burn": {"error": True},
           "slo-override": {"time_ms": 30.0}}[rule]
    steps = []
    for _ in range(10):
        steps.append(_rec(**dict({"time_ms": 5.0 * jitter()}, **base)))
        if rule == "fallback-surge" and rng.random() < 0.2:
            steps.append(("event", "device-join-host"))
    steps += [("rotate",), ("advance", 5.0), ("evaluate",)]
    for _ in range(6):  # the regression, evaluated each round
        for _ in range(6):
            kw = dict(base, **bad)
            kw.setdefault("time_ms", 5.0 * jitter())
            steps.append(_rec(**kw))
            if rule == "fallback-surge":
                steps.append(("event", "device-join-host"))
        steps += [("advance", 11.0), ("evaluate",)]
    for _ in range(10):  # recovery: clean rounds
        for _ in range(6):
            steps.append(_rec(**dict({"time_ms": 5.0 * jitter()}, **base)))
        steps += [("rotate",), ("advance", 130.0), ("evaluate",)]
    return steps


class _Side:
    """One package's sentinel over its own ledger, alert book and store."""

    def __init__(self, pl, sentinel_mod, store):
        self.ledger = pl.PerfLedger(window_s=60.0, max_plans=64,
                                    ref_decay=0.8)
        self.alerts = pl.AlertBook()
        self.store = store
        self.sentinel = sentinel_mod.PerfRegressionSentinel(
            store, None, min_queries=5, breaches=2, clears=2, exemplars=3,
            ledger=self.ledger, alerts=self.alerts)

    def step(self, clock, step):
        kind = step[0]
        if kind == "record":
            self.ledger.record(step[1], **step[2])
        elif kind == "event":
            self.ledger.note_event(step[1])
        elif kind == "rotate":
            self.ledger.rotate_now()
        elif kind == "advance":
            clock.t += step[1]
        elif kind == "evaluate":
            report = self.sentinel.evaluate()
            return {"report": {k: v for k, v in report.items()
                               if k != "benchBaseline"},
                    "alerts": self.alerts.snapshot(),
                    "armed": self.ledger.exemplar_armed,
                    "claims": [self.ledger.claim_exemplar("fp:plan", "tab")
                               for _ in range(2)]}
        return None


RULES = ("latency-drift", "compile-storm", "fallback-surge",
         "cache-collapse", "crossing-regression", "slo-burn",
         "slo-override")


@pytest.mark.parametrize("rule", RULES)
def test_rules_equal_jax(monkeypatch, rule):
    clock = _frozen(monkeypatch)
    # the SLO windows shrink so the burn buckets see the history
    monkeypatch.setenv("PINOT_TPU_SLO_FAST_WINDOW_S", "120")
    monkeypatch.setenv("PINOT_TPU_SLO_SLOW_WINDOW_S", "600")
    pstore, jstore = pcl.PropertyStore(), JaxStore()
    if rule == "slo-override":
        for store in (pstore, jstore):
            store.set("/CONFIGS/TABLE/tab_OFFLINE", {"tableName": "tab",
                                                     "sloLatencyMs": 10.0,
                                                     "sloLatencyPct": 0.5})
    port = _Side(ppl, psentinel, pstore)
    ref = _Side(jpl, jsentinel, jstore)
    if rule == "slo-override":
        for side in (port, ref):
            side.sentinel._load_slo_overrides()
    fired = set()
    for step in _history(rule, RULES.index(rule)):
        t0 = clock.t
        got = port.step(clock, step)
        clock.t = t0
        want = ref.step(clock, step)
        assert _masked(got) == _masked(want), step
        if got:
            fired |= {a["type"] for a in got["alerts"]["alerts"]}
    want_type = "slo-burn" if rule.startswith("slo") else rule
    assert want_type in fired, fired
    # recovered: every alert cleared, as in the JAX package
    assert port.alerts.active_count == ref.alerts.active_count == 0


def test_report_and_persistence_equal_jax_but_bench_baseline(monkeypatch):
    clock = _frozen(monkeypatch)
    port = _Side(ppl, psentinel, pcl.PropertyStore())
    ref = _Side(jpl, jsentinel, JaxStore())
    for step in _history("latency-drift", 9)[:40]:
        t0 = clock.t
        port.step(clock, step)
        clock.t = t0
        ref.step(clock, step)
    got, want = port.sentinel(), ref.sentinel()
    assert got["benchBaseline"] is None
    got = {k: v for k, v in got.items() if k != "benchBaseline"}
    want = {k: v for k, v in want.items() if k != "benchBaseline"}
    assert _masked(got) == _masked(want)
    assert _masked(port.store.get(LEDGER_PATH)) == \
        _masked(ref.store.get(jpl.LEDGER_PATH))
    assert _masked(port.store.get(SENTINEL_REPORT_PATH))["plansJudged"] \
        == want["plansJudged"]
    assert SENTINEL_REPORT_PATH == jsentinel.SENTINEL_REPORT_PATH


def test_standby_controller_does_not_evaluate():
    leader = type("L", (), {"is_leader": False})()
    controller = type("C", (), {"leader": leader})()
    s = PerfRegressionSentinel(pcl.PropertyStore(), controller,
                               ledger=PerfLedger(), alerts=ppl.AlertBook())
    assert s() == {"skipped": "standby controller does not evaluate"}


# -- end to end on a port cluster ---------------------------------------------

SCHEMA = Schema.build("sentab", dimensions=[("sk", "STRING")],
                      metrics=[("sv", "INT")])
# both caches off: a cached repeat makes no device dispatch, so neither
# the delay fault nor the drift it should cause would exist
SQL = ("SET resultCache = false; SET segmentCache = false; "
       "SELECT sk, SUM(sv) FROM sentab GROUP BY sk")


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    d = tmp_path_factory.mktemp("sentinel")
    PERF_LEDGER.clear()
    ALERTS.clear()
    store = pcl.PropertyStore(data_dir=str(d / "store"), fsync="off")
    controller = pcl.ClusterController(store)
    server = pcl.ServerInstance(store, "Server_0", device="cpu")
    server.start()
    controller.add_schema(SCHEMA.to_json())
    controller.create_table({"tableName": "sentab", "replication": 1})
    rng = np.random.default_rng(19)
    for i in range(2):
        n = 200
        cols = {"sk": np.asarray(["a", "b", "c", "d"], dtype=object)[
                    rng.integers(0, 4, n)],
                "sv": rng.integers(0, 100, n).astype(np.int32)}
        name = f"sentab_{i}"
        SegmentBuilder(SCHEMA, None, name).build(cols, d / name)
        controller.add_segment("sentab_OFFLINE", name,
                               {"location": str(d / name), "numDocs": n})
    broker = pcl.Broker(store, scatter_backoff_ms=5)
    yield store, controller, broker
    faults.FAULTS.reset()
    PERF_LEDGER.clear()
    ALERTS.clear()
    server.stop()
    broker.close()
    store.close()


def _burst(broker, n):
    for _ in range(n):
        resp = broker.execute_sql(SQL)
        assert not resp.exceptions, resp.exceptions


def _detect_pin_and_clear(store, controller, broker):
    """The reference burst, the fault until `latency-drift` fires, the
    exemplar burst under the fault, then the recovery rounds until the
    alert clears. The reference is persisted before the fault; after it,
    the ledger restarts from what was persisted (as a controller taking
    over restores /PERF/LEDGER), so the recovery is judged in a short
    window of recovery queries only, against the pre-fault reference. A
    short window that still held the fault's 16 queries would put its p50
    at the 0.61 to 0.94 quantile of the recovered latencies, which on a
    loaded host lies past the 25% / 2 ms rule though the latency is back
    (test_sentinel_clears_on_a_loaded_host)."""
    PERF_LEDGER.clear()
    ALERTS.clear()
    _burst(broker, 8)
    PERF_LEDGER.rotate_now()
    PERF_LEDGER.persist(store)
    sentinel = PerfRegressionSentinel(store, controller, min_queries=3,
                                      breaches=2, clears=2)
    report = sentinel.evaluate()
    assert report["anomalies"] == [] and report["benchBaseline"] is None
    snap = PERF_LEDGER.snapshot()
    assert snap["numPlans"] >= 1 and snap["plans"][0]["totals"][
        "queries"] >= 8

    alert, rounds = None, 0
    with faults.injected("device.dispatch", kind="delay", delay_s=0.05,
                         times=None):
        for rounds in range(1, 13):
            _burst(broker, 6)
            sentinel.evaluate()
            if ALERTS.active_count:
                alert = ALERTS.active()[0]
                break
        assert alert is not None, "the dispatch delay raised no alert"
        assert alert["type"] == "latency-drift"
        # exemplar arming: the next matching queries are force-sampled
        _burst(broker, 4)
    rec = ALERTS.get(alert["id"])
    exemplars = rec["exemplarTraceIds"]
    assert exemplars, "the alert fired but pinned no exemplar"
    ent = broker.trace_store.get(exemplars[0])
    assert ent is not None and alert["id"] in ent["alertIds"]
    assert ent["pinned"]
    chrome = to_chrome_trace(ent["spans"], exemplars[0])
    assert chrome["traceEvents"]
    assert broker.trace_store.stats()["alertExemplars"] >= 1

    PERF_LEDGER.clear()
    assert PERF_LEDGER.restore(store) == 1
    for _ in range(12):  # recovery
        _burst(broker, 6)
        sentinel.evaluate()
        if not ALERTS.active_count:
            break
    assert ALERTS.active_count == 0, "the alert never cleared"
    rec = ALERTS.get(alert["id"])
    assert rec["state"] == "cleared" and rec["clearReason"] == "recovered"
    # by design: the port's traffic counts no compile, so no compile-storm
    assert all(p["totals"]["compiles"] == 0
               for p in PERF_LEDGER.snapshot()["plans"])
    assert not any(a["type"] == "compile-storm"
                   for a in ALERTS.snapshot()["alerts"])
    # a full pass lands the ledger and the report in the store
    sentinel()
    assert store.get(LEDGER_PATH)["plans"]
    assert store.get(SENTINEL_REPORT_PATH)["benchBaseline"] is None


def test_sentinel_detects_pins_and_clears(cluster):
    _detect_pin_and_clear(*cluster)


# a loaded host's spread of the clean query's latency (ms), in the order
# the queries take them: half near 3.5 ms, half stalled to 7.5-12 ms; its
# median falls in the 4.0 ms bucket, any higher quantile in the 8.0 ms one
LOADED_HOST_MS = (3.3, 7.9, 3.4, 9.0, 3.5, 12.0, 3.8, 7.5)
FAULT_FLOOR_MS = 40.0  # the 50 ms dispatch delay keeps its own latency


def test_sentinel_clears_on_a_loaded_host(cluster, monkeypatch):
    """T2: every clean query (reference and recovery alike) takes its
    latency from one loaded-host spread, so the latency has recovered
    exactly; the alert must clear. With the fault's queries left in the
    recovery's short window it never did (its p50 stayed in the 8.0 ms
    bucket against a 4.0 ms reference)."""
    spread = itertools.cycle(LOADED_HOST_MS)
    record = PERF_LEDGER.record

    def loaded(key, **kw):
        if kw.get("time_ms", 0.0) < FAULT_FLOOR_MS:
            kw["time_ms"] = next(spread)
        return record(key, **kw)

    monkeypatch.setattr(PERF_LEDGER, "record", loaded)
    _detect_pin_and_clear(*cluster)


def test_ledger_survives_store_restart(cluster, tmp_path):
    assert len(PERF_LEDGER) >= 1, "the cluster test populated the ledger"
    wal = pcl.PropertyStore(data_dir=str(tmp_path / "wal"), fsync="off")
    PERF_LEDGER.persist(wal)
    payload = wal.get(LEDGER_PATH)
    assert payload and payload["plans"]
    wal.close()
    reopened = pcl.PropertyStore(data_dir=str(tmp_path / "wal"),
                                 fsync="off")
    try:
        fresh = PerfLedger()
        assert fresh.restore(reopened) >= 1
        key = next(iter(payload["plans"]))
        _cur, _ref, weight, table = fresh.plan_windows(key)
        assert weight > 0 and table == "sentab"
    finally:
        reopened.close()
