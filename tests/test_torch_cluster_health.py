"""The port's fleet health scrape (ClusterHealthChecker) and the health
routes of its REST servers against the JAX package's.

Cases from `tests/test_cluster_health.py`. A port cluster and a JAX
cluster (2 servers, replication 2) serve the same 4 segments of 2,000
rows, built once by the port's builder from a numpy seed. Each case
compares the anomalies (type and instance), the fleet rollup's counts and
the REST status codes, with ids, timestamps and ms fields taken out.
The port's `hbm-pressure` rule reads each server's device cache (bytes
held on its device against the cache's budget); the JAX rule reads its
process-wide device cache, so each case sets the same numbers on both.
Tolerance: exact.
"""

from __future__ import annotations

import pytest

from _torch_ops import (BOTH, GROUP_SQL, PORT, Cluster, build_segments, http,
                        reset_process_state, strip)


@pytest.fixture(scope="module", autouse=True)
def _module_hygiene():
    reset_process_state()
    yield
    reset_process_state()


@pytest.fixture(scope="module")
def clusters(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    mp.setenv("PINOT_TPU_SEGMENT_CACHE", "0")
    mp.setenv("PINOT_TPU_RESULT_CACHE", "0")
    segs = build_segments(tmp_path_factory.mktemp("health_segs"))
    out = {}
    for pkg in BOTH:
        c = Cluster(pkg)
        c.table(segs, replication=2)
        # latency samples on both servers (round-robin selection)
        for _ in range(6):
            c.rows()
        out[pkg.name] = c
    yield out
    for c in out.values():
        c.close()
    mp.undo()


@pytest.fixture(autouse=True)
def _reset_faults():
    yield
    for pkg in BOTH:
        pkg.faults.FAULTS.reset()


def _anomalies(snap) -> list:
    return sorted((a["type"], a["instance"]) for a in snap["anomalies"])


def test_health_routes_of_every_role(clusters):
    out = {}
    for pkg in BOTH:
        c = clusters[pkg.name]
        rests = [pkg.rest.ServerRestServer(c.servers[0]),
                 pkg.rest.BrokerRestServer(c.broker),
                 pkg.rest.ControllerRestServer(c.controller)]
        try:
            got = []
            for rest in rests:
                for route in ("/health/liveness", "/health",
                              "/health/readiness"):
                    got.append((route, http(rest.url + route)))
            code, status = http(rests[0].url + "/debug/status")
            got.append((code, status["instanceId"],
                        status["queryLatencyMs"]["count"] > 0,
                        "hbm" in status, "segmentCache" in status))
        finally:
            for rest in rests:
                rest.close()
        out[pkg.name] = got
    assert out["port"] == out["jax"]
    assert out["port"][-1] == (200, "S0", True, True, True)
    assert out["port"][-2][1] == (200, {"status": "OK", "role": "leader"})


def test_a_delayed_server_is_flagged_straggler(clusters):
    out = {}
    for pkg in BOTH:
        c = clusters[pkg.name]
        checker = pkg.periodic.ClusterHealthChecker(c.store, c.controller)
        pkg.faults.FAULTS.arm("server.query", kind="delay", delay_s=0.25,
                              times=None,
                              match=lambda ctx: ctx.get("instance") == "S0")
        try:
            for i in range(10):
                c.rows(GROUP_SQL.replace("LIMIT 10", f"LIMIT {10 + i}"))
        finally:
            pkg.faults.FAULTS.reset()
        snap = checker()
        rest = pkg.rest.ControllerRestServer(c.controller)
        try:
            code, body = http(rest.url + "/debug/cluster")
        finally:
            rest.close()
        out[pkg.name] = {
            "anomalies": [a for a in _anomalies(snap)
                          if a[0] == "straggler"],
            "fleet": (snap["fleet"]["serversTotal"],
                      snap["fleet"]["serversReachable"]),
            "rest": (code, _anomalies(body) == _anomalies(snap)),
            "thresholds": snap["thresholds"]}
    assert out["port"] == out["jax"]
    assert out["port"]["anomalies"] == [("straggler", "S0")]
    assert out["port"]["rest"] == (200, True)


def _hbm_pressure(pkg, c):
    """95% of a 1,000-byte budget on S0's device memory."""
    stats = {"hbmBytesUsed": 950, "hbmBudgetBytes": 1000, "hbmEvictions": 0,
             "hbmPartialEntries": 0, "hbmPartialBytes": 0}
    if pkg is PORT:
        cache = c.servers[0].executor.executor.cache
        orig = cache.hbm_stats
        cache.hbm_stats = lambda: stats
        return lambda: setattr(cache, "hbm_stats", orig)
    from pinot_tpu.segment.device_cache import GLOBAL_DEVICE_CACHE

    GLOBAL_DEVICE_CACHE.hbm_stats = lambda: stats
    return lambda: delattr(GLOBAL_DEVICE_CACHE, "hbm_stats")


def test_hbm_pressure_is_named(clusters):
    out = {}
    for pkg in BOTH:
        c = clusters[pkg.name]
        checker = pkg.periodic.ClusterHealthChecker(c.store, c.controller)
        undo = _hbm_pressure(pkg, c)
        try:
            snap = checker()
        finally:
            undo()
        out[pkg.name] = [a for a in _anomalies(snap)
                         if a[0] == "hbm-pressure"]
    # the JAX servers share one process-wide device cache, so both are
    # flagged there; each port server owns its cache, so S0 alone is
    assert out["port"] == [a for a in out["jax"] if a[1] == "S0"]
    assert out["port"] == [("hbm-pressure", "S0")]


def test_each_server_reports_its_own_device_bytes(clusters):
    """Port only: the scrape's device bytes are each server's device
    cache's, and the two servers' caches are distinct."""
    c = clusters["port"]
    snap = PORT.periodic.ClusterHealthChecker(c.store, c.controller)()
    for s in c.servers:
        hbm = snap["servers"][s.instance_id]["hbm"]
        assert hbm["hbmBytesUsed"] == s.executor.executor.cache.bytes_used()
        assert hbm["hbmBytesUsed"] > 0
    assert c.servers[0].executor.executor.cache is not \
        c.servers[1].executor.executor.cache


def test_unreachable_instance_breaker_flap_and_perf_alerts(clusters):
    out = {}
    for pkg in BOTH:
        c = clusters[pkg.name]
        checker = pkg.periodic.ClusterHealthChecker(
            c.store, c.controller, breaker_flap_count=2,
            scrape_timeout_s=0.5)
        c.store.set("/LIVEINSTANCES/Ghost", {"host": "127.0.0.1", "port": 1},
                    ephemeral_owner="Ghost")
        beacon = {"brokerId": "B", "breakers": {"S0": {"timesOpened": 0}}}
        c.store.set("/BROKERSTATE/B", beacon)
        try:
            first = _anomalies(checker())
            beacon["breakers"]["S0"]["timesOpened"] = 3
            c.store.set("/BROKERSTATE/B", beacon)
            pkg.perf.ALERTS.fire("latency-drift", "fp", "ops", "p50 up")
            second = checker()
        finally:
            c.store.delete("/LIVEINSTANCES/Ghost")
            c.store.delete("/BROKERSTATE/B")
            pkg.perf.ALERTS.clear()
        out[pkg.name] = (first, _anomalies(second),
                         second["fleet"]["serversTotal"],
                         second["fleet"]["serversReachable"],
                         sorted(second["brokers"]))
    assert out["port"] == out["jax"]
    first, second, total, reachable, brokers = out["port"]
    assert ("instance-unreachable", "Ghost") in first
    assert ("breaker-flap", "B") in second
    assert ("latency-drift", "ops") in second
    assert (total, reachable, brokers) == (3, 2, ["B"])


def test_cache_collapse_after_a_healthy_window(clusters):
    out = {}
    for pkg in BOTH:
        c = clusters[pkg.name]
        checker = pkg.periodic.ClusterHealthChecker(c.store, c.controller)
        windows = iter([(0, 0), (90, 10), (95, 95)])
        state = {}
        origs = [s.health_status for s in c.servers]

        def patched(orig):
            def status():
                st = orig()
                st["segmentCache"] = {"hits": state["hits"],
                                      "misses": state["misses"]}
                return st
            return status

        for s, orig in zip(c.servers, origs):
            s.health_status = patched(orig)
        got = []
        try:
            for hits, misses in windows:
                state.update(hits=hits, misses=misses)
                snap = checker()
                got.append(([a for a in _anomalies(snap)
                             if a[0] == "cache-collapse"],
                            snap["fleet"]["windowCacheHitRate"]))
        finally:
            for s, orig in zip(c.servers, origs):
                s.health_status = orig
        out[pkg.name] = got
    assert out["port"] == out["jax"]
    assert out["port"][2][0] == [("cache-collapse", "")]


def test_standby_does_not_scrape_and_serves_the_leader_snapshot(clusters):
    out = {}
    for pkg in BOTH:
        c = clusters[pkg.name]
        c1 = pkg.cl.ClusterController(c.store, instance_id="hc1")
        c2 = pkg.cl.ClusterController(c.store, instance_id="hc2")
        rest = pkg.rest.ControllerRestServer(c2)
        try:
            snap = pkg.periodic.ClusterHealthChecker(c.store, c1)()
            skipped = pkg.periodic.ClusterHealthChecker(c.store, c2)()
            code, body = http(rest.url + "/debug/cluster")
            _, health = http(rest.url + "/health/readiness")
            out[pkg.name] = (c1.is_leader(), c2.is_leader(), skipped, code,
                             body["checkedAtMs"] == snap["checkedAtMs"],
                             health, strip(body["thresholds"]))
        finally:
            rest.close()
            c1.stop()
            c2.stop()
    assert out["port"] == out["jax"]
    assert out["port"][:5] == (True, False, {
        "skipped": "standby controller does not scrape"}, 200, True)
    assert out["port"][5] == {"status": "OK", "role": "standby"}


def test_the_broker_beacon_reaches_the_rollup(clusters):
    out = {}
    for pkg in BOTH:
        c = clusters[pkg.name]
        c.broker.publish_state()
        snap = pkg.periodic.ClusterHealthChecker(c.store, c.controller)()
        beacon = snap["brokers"][c.broker.broker_id]
        out[pkg.name] = sorted(beacon)
        c.store.delete(f"/BROKERSTATE/{c.broker.broker_id}")
    assert out["port"] == out["jax"]
    assert {"breakers", "queryP99Ms", "tableCostsMs"} <= set(out["port"])
