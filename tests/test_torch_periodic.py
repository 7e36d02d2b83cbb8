"""The port's controller periodic tasks and segment lineage against the JAX
package's.

Cases from `tests/test_periodic_lineage.py` and the integrity checker of
`tests/test_data_integrity.py`. Each runs on a port cluster and on a JAX
cluster over the same segment directories (4 segments of 2,000 rows,
built once by the port's builder from a numpy seed) and compares the
records the tasks write (`/STATS/`, `/LINEAGE/`, `/REPAIRS/`,
`/INTEGRITY/`), the ideal states, the brokers' routing and the query
rows, with ids, timestamps and ms fields taken out. Tolerance: exact.

The lineage routing case writes an in-progress and a completed replace
straight into `/LINEAGE/` and holds the port's broker to the JAX
broker's routing: the replaced rows are counted once.
"""

from __future__ import annotations

import pytest

from _torch_ops import (BOTH, PORT, ROWS, Cluster,
                        build_segment, build_segments, ideal_sets,
                        reset_process_state, strip, wait_for)
from pinot_tpu_torch.spi.env import PinotConfiguration


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
    root = tmp_path_factory.mktemp("periodic_segs")
    return SimpleSegs(root)


class SimpleSegs:
    def __init__(self, root):
        self.root = root
        self.base = build_segments(root)
        # a rebuilt copy of s0: the same rows under another name
        self.merged = build_segment(root, "m01", seed=0, rows=ROWS)

    def path(self, name):
        return dict(self.base)[name]


def _both(fn):
    """Run ``fn(cluster)`` on a fresh 2-server cluster of each package."""
    out = {}
    for pkg in BOTH:
        c = Cluster(pkg)
        try:
            out[pkg.name] = fn(c)
        finally:
            c.close()
    return out


def test_status_checker_reports_drift(segs):
    def run(c):
        table = c.table(segs.base[:2])

        def ghost(ideal):
            ideal["ghost"] = {"S0": "ONLINE"}
            return ideal

        c.store.update(f"/IDEALSTATES/{table}", ghost)
        report = c.pkg.periodic.SegmentStatusChecker(c.store, c.controller)()
        return strip(report), strip(c.store.get(f"/STATS/{table}"))

    got = _both(run)
    assert got["port"] == got["jax"]
    report, stats = got["port"]
    assert report["ops_OFFLINE"]["nonServingSegments"] == ["ghost"]
    assert stats["numSegments"] == 3


def test_rebalance_checker_heals_a_dead_replica(segs):
    def run(c):
        table = c.table(segs.base)
        truth = c.rows()
        owner = sorted(c.store.get(f"/IDEALSTATES/{table}")["s0"])[0]
        c.kill(owner)
        fixed = c.pkg.periodic.RebalanceChecker(c.controller)()
        return {"fixed": fixed, "ideal": ideal_sets(c.store, table),
                "rows_ok": c.rows() == truth, "rows": truth}

    got = _both(run)
    assert got["port"] == got["jax"]
    assert got["port"]["fixed"] and got["port"]["rows_ok"]


def _lineage_routing(c, segs) -> dict:
    """Write an in-progress replace, then a completed one, straight into
    /LINEAGE/; record the broker's routing and rows at each step."""
    table = c.table(segs.base[:2])
    c.controller.add_segment(table, "m01", {"location": segs.merged,
                                            "numDocs": ROWS})
    out = {"before": sorted(c.broker.routing_table(table))}
    entry = {"state": "IN_PROGRESS", "from": ["s0"], "to": ["m01"]}
    c.store.set(f"/LINEAGE/{table}", {"l1": entry})
    out["in_progress"] = (sorted(c.broker.routing_table(table)), c.rows())
    c.store.set(f"/LINEAGE/{table}", {"l1": dict(entry, state="COMPLETED")})
    out["completed"] = (sorted(c.broker.routing_table(table)), c.rows())
    return out


def test_broker_routes_around_lineage_like_the_jax_broker(segs):
    """m01 is a rebuilt copy of s0: in progress the broker hides m01,
    completed it hides s0, so s0's rows are counted once at every step."""
    got = _both(lambda c: _lineage_routing(c, segs))
    assert got["port"] == got["jax"]
    assert got["port"]["before"] == ["m01", "s0", "s1"]
    assert got["port"]["in_progress"][0] == ["s0", "s1"]
    assert got["port"]["completed"][0] == ["m01", "s1"]
    assert got["port"]["in_progress"][1] == got["port"]["completed"][1]
    assert sum(r[2] for r in got["port"]["completed"][1]) == 2 * ROWS


def test_lineage_manager_swaps_atomically(segs):
    def run(c):
        table = c.table(segs.base[:2])
        truth = c.rows()
        mgr = c.pkg.periodic.SegmentLineageManager(c.store, c.controller)
        lid = mgr.start_replace(table, ["s0"], ["m01"])
        c.controller.add_segment(table, "m01", {"location": segs.merged,
                                                "numDocs": ROWS})
        mid = (sorted(c.broker.routing_table(table)), c.rows() == truth,
               strip(list(c.store.get(f"/LINEAGE/{table}").values())))
        mgr.end_replace(table, lid)
        return {"mid": mid, "after": sorted(c.broker.routing_table(table)),
                "rows_ok": c.rows() == truth,
                "lineage": c.store.get(f"/LINEAGE/{table}"),
                "ideal": ideal_sets(c.store, table),
                "routable": sorted(mgr.routable_segments(
                    table, {"s0", "s1", "m01"}))}

    got = _both(run)
    assert got["port"] == got["jax"]
    assert got["port"]["mid"][0] == ["s0", "s1"]
    assert got["port"]["after"] == ["m01", "s1"] and got["port"]["rows_ok"]


def test_lineage_name_reuse_after_gc(segs):
    def run(c):
        table = c.table(segs.base[:1])
        mgr = c.pkg.periodic.SegmentLineageManager(c.store, c.controller)
        lid = mgr.start_replace(table, ["s0"], ["m01"])
        c.controller.add_segment(table, "m01", {"location": segs.merged,
                                                "numDocs": ROWS})
        mgr.end_replace(table, lid)
        gone = c.store.get(f"/LINEAGE/{table}")
        c.controller.add_segment(table, "s0", {"location": segs.path("s1"),
                                               "numDocs": ROWS})
        return gone, sorted(c.broker.routing_table(table)), c.rows()

    got = _both(run)
    assert got["port"] == got["jax"]
    assert got["port"][0] == {} and got["port"][1] == ["m01", "s0"]


def test_lineage_cleanup_finishes_reverts_and_drops(segs):
    def run(c):
        table = c.table(segs.base[:2])
        mgr = c.pkg.periodic.SegmentLineageManager(c.store, c.controller)
        # a crash between the COMPLETED flip and the ideal-state sweep
        lid = mgr.start_replace(table, ["s0"], ["m01"])
        c.controller.add_segment(table, "m01", {"location": segs.merged,
                                                "numDocs": ROWS})
        entry = c.store.get(f"/LINEAGE/{table}")[lid]
        c.store.update(f"/LINEAGE/{table}", lambda cur: {
            **cur, lid: {**entry, "state": "COMPLETED"}})
        stranded = c.rows()
        finished = mgr.cleanup(table)
        # a stale in-progress replace is reverted, then its tombstone goes
        lid2 = mgr.start_replace(table, ["s1"], ["zombie"])
        fresh = mgr.cleanup(table)
        entry2 = c.store.get(f"/LINEAGE/{table}")[lid2]
        c.store.update(f"/LINEAGE/{table}", lambda cur: {
            **cur, lid2: {**entry2, "tsMs": entry2["tsMs"] - 10_000}})
        reverted = mgr.cleanup(table, stale_in_progress_s=5.0)
        dropped = mgr.cleanup(table)
        return {"stranded": stranded, "rows": c.rows(),
                "reports": [{k: len(v) for k, v in r.items()}
                            for r in (finished, fresh, reverted, dropped)],
                "lineage": c.store.get(f"/LINEAGE/{table}"),
                "ideal": ideal_sets(c.store, table),
                "routing": sorted(c.broker.routing_table(table))}

    got = _both(run)
    assert got["port"] == got["jax"]
    assert got["port"]["stranded"] == got["port"]["rows"]
    assert got["port"]["reports"] == [
        {"finished": 1, "dropped": 0, "reverted": 0},
        {"finished": 0, "dropped": 0, "reverted": 0},
        {"finished": 0, "dropped": 0, "reverted": 1},
        {"finished": 0, "dropped": 1, "reverted": 0}]


def test_lineage_revert_keeps_the_old_segment(segs):
    def run(c):
        table = c.table(segs.base[:1])
        mgr = c.pkg.periodic.SegmentLineageManager(c.store, c.controller)
        lid = mgr.start_replace(table, ["s0"], ["bad"])
        c.controller.add_segment(table, "bad", {"location": segs.path("s1"),
                                                "numDocs": ROWS})
        mgr.revert_replace(table, lid)
        return (sorted(c.broker.routing_table(table)), c.rows(),
                strip(list(c.store.get(f"/LINEAGE/{table}").values())))

    got = _both(run)
    assert got["port"] == got["jax"]
    assert got["port"][0] == ["s0"]
    assert got["port"][2][0]["state"] == "REVERTED"


def test_relocator_moves_aged_segments_to_their_tier(segs):
    def run(c):
        c.add_server("Cold_0", tags=["cold"])
        table = c.controller.create_table({
            "tableName": "ops", "replication": 1,
            "serverTag": "DefaultTenant",
            "tierConfigs": [{"name": "coldTier", "segmentAge": "7d",
                             "serverTag": "cold"}]})
        now = 1_800_000_000_000
        c.controller.add_segment(table, "s0", {
            "location": segs.path("s0"), "numDocs": ROWS,
            "endTimeMs": now - 30 * 86_400_000})
        c.controller.add_segment(table, "s1", {
            "location": segs.path("s1"), "numDocs": ROWS,
            "endTimeMs": now})
        truth = c.rows()
        orig = c.controller.relocate_tiers
        c.controller.relocate_tiers = \
            lambda t, **kw: orig(t, now_ms=now, **kw)
        moves = c.pkg.periodic.SegmentRelocator(c.controller)()
        return moves, ideal_sets(c.store, table), c.rows() == truth

    got = _both(run)
    assert got["port"] == got["jax"]
    moves, ideal, ok = got["port"]
    assert moves == {"ops_OFFLINE": [("s0", "coldTier")]}
    assert ideal["s0"] == ["Cold_0"] and ok


def _integrity(c, segs) -> dict:
    """A corrupt load quarantines s0 on its one replica; the checker's
    nudge repairs it. Automatic repair is off so the nudge does it."""
    for s in c.servers:
        s.auto_repair = False
    c.pkg.faults.FAULTS.arm("segment.load", kind="corrupt", times=1,
                            match=lambda ctx: ctx.get("segment") == "s0")
    table = c.table(segs.base[:2])
    checker = c.pkg.periodic.SegmentIntegrityChecker(c.store, c.controller)
    quarantined = strip(c.store.get(f"/EXTERNALVIEW/{table}"))
    first = strip(checker())
    repairs = strip({s: c.store.get(f"/REPAIRS/{table}/{s}")
                     for s in c.store.children(f"/REPAIRS/{table}")})
    healed = wait_for(lambda: (c.store.get(f"/EXTERNALVIEW/{table}") or {})
                      .get("s0", {}).get("S0") == "ONLINE")
    second = strip(checker())
    return {"quarantined": quarantined, "first": first, "repairs": repairs,
            "healed": healed,
            "integrity": c.store.get(f"/INTEGRITY/{table}"),
            "second": second,
            "repairs_after": c.store.children(f"/REPAIRS/{table}"),
            "rows": c.rows()}


def test_integrity_checker_nudges_a_repair(segs, monkeypatch):
    # the JAX server reads its auto-repair switch from the environment
    monkeypatch.setenv("PINOT_TPU_AUTO_REPAIR", "false")
    got = _both(lambda c: _integrity(c, segs))
    assert got["port"] == got["jax"]
    port = got["port"]
    assert port["quarantined"]["s0"] == {"S0": "ERROR"}
    assert port["first"]["ops_OFFLINE"]["erroredReplicas"] == {"s0": ["S0"]}
    assert list(port["repairs"]) == ["s0"] and port["healed"]
    assert port["integrity"] is None and port["repairs_after"] == []


def test_unrepairable_replica_is_flagged_after_its_budget(segs):
    def run(c):
        table = c.table(segs.base[:1])

        def errored(view):
            # a replica on an instance no server answers for: only the
            # checker's budget decides what happens to it
            view = view or {}
            view["s0"] = dict(view.get("s0") or {}, Z9="ERROR")
            return view

        c.store.update(f"/EXTERNALVIEW/{table}", errored)
        checker = c.pkg.periodic.SegmentIntegrityChecker(
            c.store, c.controller, max_repair_triggers=2)
        return [strip(checker()) for _ in range(3)]

    got = _both(run)
    assert got["port"] == got["jax"]
    assert got["port"][2]["ops_OFFLINE"]["unrepairable"] == [
        {"segment": "s0", "instance": "Z9", "triggers": 2}]


def test_default_scheduler_runs_every_task_once(segs):
    def run(c):
        c.table(segs.base[:2])
        sched = c.pkg.periodic.build_default_scheduler(
            c.store, c.controller, interval_s=10.0)
        out = sched.run_once()
        return sorted(sched.tasks), {
            name: t.last_error for name, t in sched.tasks.items()}, \
            {name: t.runs for name, t in sched.tasks.items()}, out

    got = _both(run)
    names, errors, runs, _ = got["port"]
    assert (names, errors, runs) == got["jax"][:3]
    assert names == sorted([
        "RetentionManager", "SegmentStatusChecker",
        "SegmentIntegrityChecker", "RebalanceChecker", "SegmentRelocator",
        "LineageCleanupTask", "RebalanceActuator", "ClusterHealthChecker",
        "StoragePrefetcher", "PerfRegressionSentinel"])
    assert set(errors.values()) == {None} and set(runs.values()) == {1}
    assert got["port"][3]["ClusterHealthChecker"]["fleet"][
        "serversReachable"] == 2


def test_scheduler_loop_runs_tasks_and_stops(segs):
    def run(c):
        c.table(segs.base[:1])
        sched = c.pkg.periodic.build_default_scheduler(
            c.store, c.controller, interval_s=0.01)
        sched.start()
        try:
            ran = wait_for(lambda: all(t.runs >= 2
                                       for t in sched.tasks.values()),
                           timeout_s=10.0)
        finally:
            sched.stop()
        alive = sched._thread.is_alive()
        return ran, alive, sorted(n for n, t in sched.tasks.items()
                                  if t.last_error)

    got = _both(run)
    assert got["port"] == got["jax"] == (True, False, [])


def test_scheduler_isolates_task_errors():
    out = {}
    for pkg in BOTH:
        sched = pkg.periodic.ControllerPeriodicTaskScheduler()
        sched.register("boom", 0.01, lambda: 1 / 0)
        sched.register("ok", 0.01, lambda: "fine")
        out[pkg.name] = sched.run_once()
    assert out["port"] == out["jax"]
    assert out["port"]["ok"] == "fine"
    assert "ZeroDivisionError" in out["port"]["boom"]


def test_standby_scheduler_loop_runs_nothing(segs):
    def run(c):
        other = c.pkg.cl.ClusterController(c.store, instance_id="ctl_b")
        c.extra.append(other)
        sched = c.pkg.periodic.ControllerPeriodicTaskScheduler(
            tick_s=0.01, leader=other.leader)
        sched.register("count", 0.0, lambda: "ran")
        sched.start()
        try:
            wait_for(lambda: False, timeout_s=0.2)
        finally:
            sched.stop()
        return other.is_leader(), sched.tasks["count"].runs

    got = _both(lambda c: run(_led(c)))
    assert got["port"] == got["jax"] == (False, 0)


def _led(c):
    """Seat a leader first, so the controller built in the case stands by."""
    leader = c.pkg.cl.ClusterController(c.store, instance_id="ctl_a")
    c.extra.append(leader)
    assert leader.is_leader()
    return c


def test_scheduler_takes_its_knobs_from_a_configuration(segs, monkeypatch):
    """The JAX scheduler reads PINOT_TPU_* intervals from the environment;
    the port's reads the same knobs from the PinotConfiguration it is
    given (PINOT_TPU_REBALANCE_TICK_S is `rebalance.tick.s`)."""
    knobs = {"REBALANCE_TICK_S": "0.5", "HEALTH_SCRAPE_S": "3",
             "PREFETCH_TICK_S": "4", "SENTINEL_SCRAPE_S": "5"}
    for k, v in knobs.items():
        monkeypatch.setenv(f"PINOT_TPU_{k}", v)
    out = {}
    for pkg in BOTH:
        c = Cluster(pkg, n_servers=0)
        try:
            kw = {"config": PinotConfiguration()} if pkg is PORT else {}
            sched = pkg.periodic.build_default_scheduler(
                c.store, c.controller, interval_s=2.0, **kw)
            out[pkg.name] = {n: t.interval_s for n, t in sched.tasks.items()}
        finally:
            c.close()
    assert out["port"] == out["jax"]
    assert out["port"]["RebalanceActuator"] == 0.5
    assert out["port"]["PerfRegressionSentinel"] == 5.0
    assert out["port"]["RetentionManager"] == 2.0
