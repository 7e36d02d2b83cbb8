"""The port's rebalance (the controller's two-phase rebalance and tier
relocation, the durable SegmentRebalancer, the RebalanceActuator and the
server's `rebalance.move` seam) against the JAX package's.

Cases from `tests/test_rebalance.py` and `tests/test_rebalance_actuator.py`.
Each runs on a port cluster and on a JAX cluster over the same segment
directories (4 segments of 2,000 rows, built once by the port's builder
from a numpy seed) and compares the `/REBALANCE/` journals, the ideal
states after each move and the query rows, with ids, timestamps and ms
fields taken out. Jobs are driven with `tick()` / `drive()`; every wait
is bounded. Tolerance: exact.
"""

from __future__ import annotations

import threading

import pytest

from _torch_ops import (BOTH, PORT, ROWS, Cluster, build_segments,
                        ideal_sets, reset_process_state, strip, wait_for)


@pytest.fixture(scope="module", autouse=True)
def _module_hygiene():
    reset_process_state()
    yield
    reset_process_state()


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("PINOT_TPU_SEGMENT_CACHE", "0")
    monkeypatch.setenv("PINOT_TPU_RESULT_CACHE", "0")
    yield
    for pkg in BOTH:
        pkg.faults.FAULTS.reset()


@pytest.fixture(scope="module")
def segs(tmp_path_factory):
    return build_segments(tmp_path_factory.mktemp("rebalance_segs"))


def _both(fn, n_servers=1, **kw):
    out = {}
    for pkg in BOTH:
        c = Cluster(pkg, n_servers=n_servers, **kw)
        try:
            out[pkg.name] = fn(c)
        finally:
            c.close()
    return out


def _zombie(store, name):
    """A registered, live-looking server that never converges anything."""
    store.set(f"/INSTANCECONFIGS/{name}", {"host": "nowhere", "port": 1,
                                           "tags": ["DefaultTenant"]})
    store.set(f"/LIVEINSTANCES/{name}", {"host": "nowhere", "port": 1},
              ephemeral_owner=name)


def _journal(store, table) -> dict:
    return strip(store.get(f"/REBALANCE/{table}"))


def test_controller_rebalance_spreads_onto_a_new_server(segs):
    """The two-phase rebalance: add, wait for the external view, drop.
    A client queries throughout; every answer is the oracle's and no
    segment's routable replicas fall below one."""
    def run(c):
        table = c.table(segs)
        truth = c.rows()
        c.add_server("S1")
        dry = c.controller.rebalance(table, dry_run=True)
        answers, floor, stop = [], [], threading.Event()

        def client():
            while not stop.is_set():
                answers.append(c.rows() == truth)
                floor.append(min(len(v) for v in
                                 c.broker.routing_table(table).values()))

        t = threading.Thread(target=client)
        t.start()
        try:
            res = c.controller.rebalance(table, min_available_replicas=1)
        finally:
            stop.set()
            t.join(30)
        return {"dry": strip(dry), "res": strip(res),
                "journal": _journal(c.store, table),
                "ideal": ideal_sets(c.store, table),
                "status": strip(c.controller.rebalance_status(table)),
                "answers_ok": all(answers) and len(answers) > 0,
                "min_replicas": min(floor), "rows": c.rows() == truth}

    got = _both(run)
    assert got["port"] == got["jax"]
    port = got["port"]
    assert port["res"]["status"] == "DONE" and port["res"]["moves"] == 2
    assert sorted(set(sum(port["ideal"].values(), []))) == ["S0", "S1"]
    assert port["answers_ok"] and port["min_replicas"] >= 1 and port["rows"]


def test_rebalance_leaves_consuming_segments_in_place(segs):
    def run(c):
        table = c.table(segs[:2])
        c.add_server("S1")

        def consuming(ideal):
            ideal["s1"] = {"S0": "CONSUMING"}
            return ideal

        c.store.update(f"/IDEALSTATES/{table}", consuming)
        return strip(c.controller.rebalance(table, dry_run=True))

    got = _both(run)
    assert got["port"] == got["jax"]
    assert got["port"]["target"]["s1"] == {"S0": "CONSUMING"}


def test_upsert_table_refuses_without_instance_partitions(segs):
    def run(c):
        table = c.table(segs[:1], upsertConfig={"mode": "FULL"})
        out = []
        for call in (lambda: c.controller.rebalance(table),
                     lambda: c.controller.relocate_tiers(table)):
            try:
                call()
                out.append(None)
            except RuntimeError as e:
                out.append(str(e))
        return out

    got = _both(run)
    assert got["port"] == got["jax"]
    assert "upsert" in got["port"][0]


def test_relocate_tiers_moves_by_age_and_by_list(segs):
    def run(c):
        c.add_server("Cold_0", tags=["cold"])
        c.add_server("Warm_0", tags=["warm"])
        now = 1_800_000_000_000
        table = c.controller.create_table({
            "tableName": "ops", "replication": 1,
            "serverTag": "DefaultTenant",
            "tierConfigs": [
                {"name": "warmTier", "segmentAge": "1d", "serverTag": "warm"},
                {"name": "coldTier", "segmentAge": "30d",
                 "serverTag": "cold"},
                {"name": "pinned", "segmentSelectorType": "fixed",
                 "segmentList": ["s3"], "serverTag": "cold"}]})
        ages = {"s0": 60, "s1": 5, "s2": 0, "s3": 0}
        for name, path in segs:
            c.controller.add_segment(table, name, {
                "location": path, "numDocs": ROWS,
                "endTimeMs": now - ages[name] * 86_400_000})
        truth = c.rows()
        dry = strip(c.controller.relocate_tiers(table, dry_run=True,
                                                now_ms=now))
        res = strip(c.controller.relocate_tiers(table, now_ms=now))
        return dry, res, ideal_sets(c.store, table), c.rows() == truth

    got = _both(run)
    assert got["port"] == got["jax"]
    _dry, res, ideal, ok = got["port"]
    assert res["tiers"] == {"s0": "coldTier", "s1": "warmTier", "s2": None,
                            "s3": "pinned"}
    assert ideal["s0"] == ["Cold_0"] and ideal["s1"] == ["Warm_0"] and ok


def test_replica_group_rebalance_and_sticky_partitions(segs):
    def run(c):
        table = c.table(segs, replication=2)
        c.add_server("S2")
        c.add_server("S3")
        ip = c.controller.configure_instance_partitions(table, 2)
        res = strip(c.controller.rebalance(table))
        c.add_server("S4")
        again = c.controller.configure_instance_partitions(table, 2)
        return ip, res, ideal_sets(c.store, table), again, c.rows()

    got = _both(run, n_servers=2)
    assert got["port"] == got["jax"]
    ip, _res, ideal, again, _ = got["port"]
    groups = [set(g) for g in ip["replicaGroups"]]
    assert all(len(set(m) & g) == 1 for m in ideal.values() for g in groups)
    assert again == ip


def _engine_run(c, segs) -> dict:
    table = c.table(segs)
    truth = c.rows()
    c.add_server("S1")
    rb = c.pkg.rebalance.SegmentRebalancer(c.controller, move_timeout_s=10.0)
    dry = rb.plan(table, dry_run=True)
    untouched = c.store.get(f"/REBALANCE/{table}")
    planned = rb.plan(table)
    refused = None
    try:
        rb.plan(table)
    except c.pkg.rebalance.RebalanceInProgress as e:
        refused = type(e).__name__
    steps = []
    while (rb.job(table) or {}).get("status") == "IN_PROGRESS" \
            and len(steps) < 500:
        rb.tick()
        steps.append(sorted(m["state"] for m in rb.job(table)["movePlan"]))
        wait_for(lambda: False, timeout_s=0.01)
    return {"dry": strip(dry), "untouched": untouched,
            "planned": strip(planned), "refused": refused,
            "final": _journal(c.store, table),
            "ideal": ideal_sets(c.store, table),
            "debug": sorted(rb.debug()["finished"]),
            "rows_ok": c.rows() == truth}


def test_durable_rebalance_journals_like_the_jax_engine(segs):
    got = _both(lambda c: _engine_run(c, segs))
    assert got["port"] == got["jax"]
    port = got["port"]
    assert port["untouched"] is None and port["refused"] == \
        "RebalanceInProgress"
    assert port["final"]["status"] == "DONE"
    assert {m["state"] for m in port["final"]["movePlan"]} == {"COMPLETED"}
    assert port["final"]["segmentsDone"] == port["final"]["segmentsTotal"] == 2
    assert port["rows_ok"]


def test_departed_server_releases_the_moved_segments_device_state(segs):
    """Port only (the JAX server keeps one process-wide cache): after a
    move, the source server's device cache holds nothing of the moved
    segments and fewer bytes than before."""
    c = Cluster(PORT, n_servers=1)
    try:
        table = c.table(segs)
        c.rows()
        src = c.server("S0").executor.executor.cache
        before = src.bytes_used()
        assert src.segment_names() >= {"s0", "s1", "s2", "s3"}
        c.add_server("S1")
        rb = PORT.rebalance.SegmentRebalancer(c.controller,
                                              move_timeout_s=10.0)
        job = rb.run(table, timeout_s=20.0)
        moved = {m["segment"] for m in job["movePlan"]}
        assert job["status"] == "DONE" and len(moved) == 2
        assert wait_for(lambda: not (src.segment_names() & moved))
        assert src.bytes_used() < before
        c.rows()
        dst = c.server("S1").executor.executor.cache
        assert dst.segment_names() & moved == moved
    finally:
        c.close()


def test_abort_rolls_back_in_flight_additions(segs):
    def run(c):
        table = c.table(segs)
        truth = c.rows()
        _zombie(c.store, "Z0")
        rb = c.pkg.rebalance.SegmentRebalancer(
            c.controller, move_timeout_s=60.0, max_moves=2)
        rb.plan(table)
        rb.tick()
        mid = ideal_sets(c.store, table)
        job = rb.abort(table)
        return {"mid": mid, "job": strip(job),
                "ideal": ideal_sets(c.store, table),
                "again": rb.plan(table, dry_run=True) is not None,
                "rows_ok": c.rows() == truth}

    got = _both(run)
    assert got["port"] == got["jax"]
    assert got["port"]["job"]["status"] == "ABORTED"
    assert all(v == ["S0"] for v in got["port"]["ideal"].values())


def test_dead_destination_is_blacklisted_then_repicked(segs):
    def run(c):
        table = c.table(segs[:2])
        _zombie(c.store, "Z0")
        rb = c.pkg.rebalance.SegmentRebalancer(
            c.controller, move_timeout_s=0.0, max_attempts=1, backoff_ms=0.0,
            max_moves=1)
        rb.plan(table)
        for _ in range(6):
            rb.tick()
        return _journal(c.store, table)

    got = _both(run)
    assert got["port"] == got["jax"]
    assert got["port"]["status"] == "PARTIAL"
    assert got["port"]["movePlan"][0]["blacklist"] == ["Z0"]


def test_corrupt_move_fetch_is_repaired_and_the_move_completes(
        segs, monkeypatch):
    """`rebalance.move` corrupts the destination's fetched copy: the
    verifying loader quarantines it (ERROR in the external view), the
    integrity checker's nudge repairs it, and the job ends DONE."""
    monkeypatch.setenv("PINOT_TPU_AUTO_REPAIR", "false")

    def run(c):
        table = c.table(segs[:2])
        truth = c.rows()
        dst = c.add_server("S1")
        dst.auto_repair = False
        c.pkg.faults.FAULTS.arm("rebalance.move", kind="corrupt", times=1)
        rb = c.pkg.rebalance.SegmentRebalancer(c.controller,
                                               move_timeout_s=20.0)
        checker = c.pkg.periodic.SegmentIntegrityChecker(c.store,
                                                         c.controller)
        rb.plan(table)
        quarantined, nudges = [], []
        for _ in range(400):
            rb.tick()
            view = c.store.get(f"/EXTERNALVIEW/{table}") or {}
            errored = sorted(s for s, m in view.items()
                             if "ERROR" in m.values())
            if errored:
                quarantined.append(errored)
                nudges.append(strip(checker())[table]["erroredReplicas"])
            if rb.job(table)["status"] != "IN_PROGRESS":
                break
            wait_for(lambda: False, timeout_s=0.01)
        return {"fired": c.pkg.faults.FAULTS.fired("rebalance.move"),
                "quarantined": quarantined[:1], "nudged": nudges[:1],
                "job": _journal(c.store, table),
                "ideal": ideal_sets(c.store, table),
                "rows_ok": c.rows() == truth}

    got = _both(run)
    assert got["port"] == got["jax"]
    port = got["port"]
    assert port["fired"] == 1 and len(port["quarantined"]) == 1
    assert port["nudged"][0] == {port["quarantined"][0][0]: ["S1"]}
    assert port["job"]["status"] == "DONE" and port["rows_ok"]


def test_new_leader_resumes_a_journaled_rebalance(segs):
    def run(c):
        c2 = c.pkg.cl.ClusterController(c.store, instance_id="ctl2")
        c.extra.append(c2)
        table = c.table(segs)
        truth = c.rows()
        c.add_server("S1")
        rb1 = c.pkg.rebalance.SegmentRebalancer(c.controller, max_moves=1,
                                                move_timeout_s=10.0)
        job = rb1.plan(table)

        def one_done():
            rb1.tick()
            plan = rb1.job(table)["movePlan"]
            return any(m["state"] == "COMPLETED" for m in plan)

        assert wait_for(one_done, timeout_s=10.0)
        mid = rb1.job(table)["status"]
        c.controller.leader.disconnect()
        c.store.expire_session("ctl1")
        c.controller.leader.stop()
        leader2 = c2.is_leader()
        during = c.rows() == truth
        actuator = c.pkg.rebalance.RebalanceActuator(
            c.pkg.rebalance.SegmentRebalancer(c2, max_moves=1,
                                              move_timeout_s=10.0))
        wait_for(lambda: actuator() and c.store.get(
            f"/REBALANCE/{table}")["status"] != "IN_PROGRESS",
            timeout_s=15.0)
        final = c.store.get(f"/REBALANCE/{table}")
        return {"mid": mid, "leader2": leader2, "during": during,
                "same_job": final["jobId"] == job["jobId"],
                "final": strip(final), "ideal": ideal_sets(c.store, table),
                "rows_ok": c.rows() == truth}

    got = _both(run, controller_id="ctl1")
    assert got["port"] == got["jax"]
    port = got["port"]
    assert port["mid"] == "IN_PROGRESS" and port["leader2"]
    assert port["same_job"] and port["final"]["status"] == "DONE"
    assert port["during"] and port["rows_ok"]


def test_standby_never_actuates(segs):
    def run(c):
        c2 = c.pkg.cl.ClusterController(c.store, instance_id="ctl2")
        c.extra.append(c2)
        table = c.table(segs)
        c.add_server("S1")
        rb2 = c.pkg.rebalance.SegmentRebalancer(c2)
        out = [c2.is_leader(), rb2.tick()]
        try:
            rb2.drive(table)
        except RuntimeError as e:
            out.append(type(e).__name__)
        out.append(c.pkg.rebalance.RebalanceActuator(rb2)())
        return out

    got = _both(run, controller_id="ctl1")
    assert got["port"] == got["jax"]
    assert got["port"][0] is False and got["port"][2] == "RuntimeError"


def test_actuator_rebuilds_after_death_and_spreads_onto_new_servers(segs):
    def run(c):
        table = c.table(segs, replication=2)
        truth = c.rows()
        actuator = c.pkg.rebalance.RebalanceActuator(
            c.pkg.rebalance.SegmentRebalancer(c.controller,
                                              move_timeout_s=10.0,
                                              max_moves=8))
        first = actuator()["auto"]
        c.add_server("S2")
        spread = actuator()["auto"]
        wait_for(lambda: actuator() and c.store.get(
            f"/REBALANCE/{table}")["status"] != "IN_PROGRESS",
            timeout_s=15.0)
        after_add = _journal(c.store, table)
        c.kill("S0")
        rebuild = actuator()["auto"]
        wait_for(lambda: actuator() and c.store.get(
            f"/REBALANCE/{table}")["status"] != "IN_PROGRESS",
            timeout_s=15.0)
        return {"first": first, "spread": sorted(spread),
                "spread_trigger": [v.split(":")[0] for v in spread.values()],
                "after_add": after_add["status"],
                "rebuild": [v.split(":")[0] for v in rebuild.values()],
                "final": _journal(c.store, table)["status"],
                "ideal": ideal_sets(c.store, table),
                "rows_ok": c.rows() == truth}

    got = _both(run, n_servers=2)
    assert got["port"] == got["jax"]
    port = got["port"]
    assert port["spread_trigger"] == ["server-add"]
    assert port["rebuild"] == ["dead-server"] and port["final"] == "DONE"
    assert "S0" not in sum(port["ideal"].values(), []) and port["rows_ok"]


def test_health_drain_respects_hysteresis_and_cooldown(segs, monkeypatch):
    """The JAX actuator reads its health knobs from the environment; the
    port's takes them as arguments with the same values."""
    monkeypatch.setenv("PINOT_TPU_HEALTH_REBALANCE", "1")
    monkeypatch.setenv("PINOT_TPU_REBALANCE_HYSTERESIS", "2")
    monkeypatch.setenv("PINOT_TPU_REBALANCE_COOLDOWN_S", "300")

    def run(c):
        table = c.table(segs)
        kw = {"health_rebalance": True, "hysteresis": 2,
              "cooldown_s": 300.0} if c.pkg is PORT else {}
        rb = c.pkg.rebalance.SegmentRebalancer(c.controller,
                                               move_timeout_s=10.0,
                                               max_moves=8)
        actuator = c.pkg.rebalance.RebalanceActuator(rb, **kw)
        path = c.pkg.periodic.HEALTH_REPORT_PATH

        def scrape(instance, at_ms):
            c.store.set(path, {"checkedAtMs": at_ms, "anomalies": [
                {"type": "straggler", "instance": instance}]})

        out = []
        scrape("S0", 1000)
        out.append(strip(actuator()["health"]))
        out.append(strip(actuator()["health"]))
        scrape("S0", 2000)
        out.append(sorted(actuator()["health"]["triggered"]))
        job = strip(rb.drive(table, timeout_s=20.0))
        scrape("S1", 3000)
        actuator()
        scrape("S1", 4000)
        out.append(strip(actuator()["health"]))
        return out, job, ideal_sets(c.store, table)

    got = _both(run, n_servers=3)
    assert got["port"] == got["jax"]
    out, job, ideal = got["port"]
    assert out[2] == ["ops_OFFLINE"] and out[3]["cooldown"] is True
    assert job["trigger"] == "health" and job["excluded"] == ["S0"]
    assert "S0" not in sum(ideal.values(), [])


def test_legacy_rebalance_refuses_while_an_engine_job_is_active(segs):
    def run(c):
        table = c.table(segs)
        _zombie(c.store, "Z0")
        rb = c.pkg.rebalance.SegmentRebalancer(c.controller,
                                               move_timeout_s=60.0)
        rb.plan(table)
        rb.tick()
        try:
            c.controller.rebalance(table)
            refused = None
        except RuntimeError as e:
            refused = type(e).__name__
        checker = c.pkg.periodic.RebalanceChecker(c.controller)()
        return refused, checker, rb.abort(table)["status"]

    got = _both(run)
    assert got["port"] == got["jax"] == ("RuntimeError", {}, "ABORTED")
