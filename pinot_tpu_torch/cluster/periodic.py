"""Controller periodic tasks + segment lineage + tier relocation.

The port's copy of pinot_tpu/cluster/periodic.py. Its thresholds and tick
intervals are keyword arguments with the JAX package's defaults (the JAX
module reads PINOT_TPU_STRAGGLER_*, _HBM_PRESSURE_RATIO,
_CACHE_COLLAPSE_RATE, _BREAKER_FLAP_COUNT and the *_TICK_S / *_SCRAPE_S
intervals from the environment); `build_default_scheduler` also takes
them from a PinotConfiguration the caller passes in. The health scrape's
`hbm-pressure` rule reads each server's card bytes held by its device
cache against that cache's budget.

Reference analogues (SURVEY.md §2.6):
- ControllerPeriodicTask framework + the scheduled jobs wired in
  BaseControllerStarter.java:865-896 (RetentionManager,
  SegmentStatusChecker, RebalanceChecker, SegmentRelocator).
- Segment lineage for atomic replacement
  (pinot-controller/.../helix/core/lineage/ — startReplaceSegments/
  endReplaceSegments; brokers exclude in-flight segments from routing).
- Tier configs moving aged segments onto differently-tagged servers
  (SegmentRelocator + TierConfig).
"""

from __future__ import annotations

import threading
import time
import uuid
from dataclasses import dataclass
from typing import Callable, Optional

from ..cache.results import bump_lineage_epoch
from ..engine.perf_ledger import ALERTS
from ..spi.env import PinotConfiguration
from ..spi.metrics import (CONTROLLER_METRICS, ControllerGauge,
                           ControllerMeter)
from ..storage.prefetch import StoragePrefetcher
from .controller import ERROR, ONLINE, ClusterController
from .rebalance import RebalanceActuator, SegmentRebalancer
from .sentinel import PerfRegressionSentinel
from .store import PropertyStore
from .transport import RemoteError, RpcClient, TransportError


# -- periodic task framework -------------------------------------------------


@dataclass
class PeriodicTask:
    name: str
    interval_s: float
    fn: Callable[[], object]
    last_run: float = 0.0
    runs: int = 0
    last_result: object = None
    last_error: Optional[str] = None


class ControllerPeriodicTaskScheduler:
    """Fixed-interval controller jobs on one background thread (reference:
    ControllerPeriodicTask + PeriodicTaskScheduler)."""

    def __init__(self, tick_s: float = 0.05, leader=None):
        self.tick_s = tick_s
        self.tasks: dict[str, PeriodicTask] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # cluster/leader.py LeadControllerManager: with multiple controllers
        # only the elected leader runs periodic jobs (reference: controller
        # periodic tasks run on the lead controller only)
        self.leader = leader

    def register(self, name: str, interval_s: float, fn: Callable) -> None:
        self.tasks[name] = PeriodicTask(name, interval_s, fn)

    def start(self) -> None:
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="controller-periodic")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(10)

    def run_once(self, name: Optional[str] = None) -> dict:
        """Synchronous trigger (tests + admin endpoint; reference:
        /periodictask/run)."""
        out = {}
        for t in self.tasks.values():
            if name is not None and t.name != name:
                continue
            self._run(t)
            out[t.name] = t.last_result if t.last_error is None else t.last_error
        return out

    def _loop(self) -> None:
        while not self._stop.wait(self.tick_s):
            if self.leader is not None and not self.leader.is_leader:
                continue  # standby controller: the leader runs the jobs
            now = time.monotonic()
            for t in self.tasks.values():
                if now - t.last_run >= t.interval_s:
                    self._run(t)

    def _run(self, t: PeriodicTask) -> None:
        t.last_run = time.monotonic()
        t.runs += 1
        try:
            t.last_result = t.fn()
            t.last_error = None
        except Exception as e:  # periodic tasks must not kill the loop
            t.last_error = f"{type(e).__name__}: {e}"


# -- built-in controller jobs ------------------------------------------------


class SegmentStatusChecker:
    """Counts segments/replicas per table, flags ideal-vs-external drift;
    writes /STATS/{table} (reference: SegmentStatusChecker metrics:
    nonServingSegments, replicationFromConfig...)."""

    def __init__(self, store: PropertyStore, controller: ClusterController):
        self.store = store
        self.controller = controller

    def __call__(self) -> dict:
        report = {}
        for table in self.store.children("/IDEALSTATES"):
            ideal = self.store.get(f"/IDEALSTATES/{table}") or {}
            view = self.store.get(f"/EXTERNALVIEW/{table}") or {}
            missing = []
            under_replicated = []
            for seg, want in ideal.items():
                have = {i for i, st in (view.get(seg) or {}).items()
                        if st == ONLINE}
                if not have:
                    missing.append(seg)
                elif len(have) < len(want):
                    under_replicated.append(seg)
            stats = {
                "numSegments": len(ideal),
                "nonServingSegments": missing,
                "underReplicatedSegments": under_replicated,
                "checkedAtMs": int(time.time() * 1000),
            }
            self.store.set(f"/STATS/{table}", stats)
            report[table] = stats
        return report


class RebalanceChecker:
    """Re-runs rebalance for tables whose replication is not satisfiable
    from the ideal state (reference: RebalanceChecker retrying stuck
    rebalances)."""

    def __init__(self, controller: ClusterController):
        self.controller = controller

    def __call__(self) -> dict:
        fixed = {}
        live = set(self.controller.live_instances())
        for table in self.controller.store.children("/CONFIGS/TABLE"):
            # a durable rebalance job (movePlan journal) owns this table's
            # ideal state: the RebalanceActuator converges it move-by-move,
            # and a concurrent blocking rebalance here would fight the
            # journaled plan. Legacy movePlan-less records are NOT skipped:
            # an IN_PROGRESS one is a crash leftover of the synchronous
            # path, and skipping it would wedge healing forever.
            job = self.controller.store.get(f"/REBALANCE/{table}") or {}
            if job.get("status") in ("IN_PROGRESS", "ABORTING") \
                    and "movePlan" in job:
                continue
            cfg = self.controller.table_config(table) or {}
            replication = int(cfg.get("replication", 1))
            ideal = self.controller.store.get(f"/IDEALSTATES/{table}") or {}
            broken = any(
                len([i for i in m if i in live]) < replication
                for m in ideal.values())
            if broken and len(live) >= replication:
                fixed[table] = self.controller.rebalance(table)["moves"]
        return fixed


# -- segment lineage (atomic replacement) ------------------------------------


class SegmentLineageManager:
    """start/end/revert replace-segments protocol. While IN_PROGRESS the
    broker must route the FROM set and ignore the TO set; on end the swap
    commits atomically in the ideal state (reference:
    SegmentLineageAccessHelper + PinotHelixResourceManager
    startReplaceSegments/endReplaceSegments)."""

    def __init__(self, store: PropertyStore, controller: ClusterController):
        self.store = store
        self.controller = controller

    def start_replace(self, table: str, from_segments: list[str],
                      to_segments: list[str]) -> str:
        lineage_id = uuid.uuid4().hex[:12]
        # snapshot the FROM generation (push time) so trailing cleanup can
        # tell a replaced segment from one RE-pushed under the same name
        # after the swap — the latter must not be deleted
        from_push = {
            seg: (self.store.get(f"/SEGMENTS/{table}/{seg}") or {}).get(
                "pushTimeMs")
            for seg in from_segments}
        self.store.update(f"/LINEAGE/{table}", lambda cur: {
            **(cur or {}),
            lineage_id: {"state": "IN_PROGRESS", "from": from_segments,
                         "to": to_segments, "fromPushMs": from_push,
                         "tsMs": int(time.time() * 1000)}})
        return lineage_id

    def end_replace(self, table: str, lineage_id: str) -> None:
        entry = (self.store.get(f"/LINEAGE/{table}") or {}).get(lineage_id)
        if entry is None or entry["state"] != "IN_PROGRESS":
            raise KeyError(f"lineage {lineage_id} not in progress")
        # the state flip IS the atomic routing switch: brokers route the TO
        # set and hide the FROM set the instant this single key updates.
        # Ideal-state removal is trailing cleanup (servers unload); a crash
        # between flip and cleanup leaves a COMPLETED entry that cleanup()
        # (periodic LineageCleanupTask) finishes idempotently.
        self.store.update(f"/LINEAGE/{table}", lambda cur: {
            **(cur or {}), lineage_id: {**entry, "state": "COMPLETED"}})
        # the routing switch just happened — cached broker results built on
        # the FROM set are stale from this instant (cache/results.py)
        bump_lineage_epoch(self.store, table)
        self._finish_completed(table, lineage_id, entry)

    def _finish_completed(self, table: str, lineage_id: str,
                          entry: dict) -> None:
        """Idempotent trailing cleanup for a COMPLETED entry: drop the FROM
        set from the ideal state and metadata, then delete the entry itself
        so the FROM names become reusable (brokers hide FROM of COMPLETED
        entries only while this cleanup is pending). A FROM name whose
        current metadata no longer matches the generation snapshotted at
        start_replace was re-pushed after the swap and is left alone."""
        from_push = entry.get("fromPushMs", {})
        victims = []
        for seg in entry["from"]:
            meta = self.store.get(f"/SEGMENTS/{table}/{seg}")
            if meta is not None and seg in from_push and \
                    meta.get("pushTimeMs") != from_push[seg]:
                continue  # re-created under the same name — not ours
            victims.append(seg)

        def upd(ideal):
            ideal = ideal or {}
            for seg in victims:
                ideal.pop(seg, None)
            return ideal

        self.store.update(f"/IDEALSTATES/{table}", upd)
        for seg in victims:
            self.store.delete(f"/SEGMENTS/{table}/{seg}")
        self.store.update(f"/LINEAGE/{table}", lambda cur: {
            k: v for k, v in (cur or {}).items() if k != lineage_id})

    def revert_replace(self, table: str, lineage_id: str) -> None:
        entry = (self.store.get(f"/LINEAGE/{table}") or {}).get(lineage_id)
        if entry is None or entry["state"] != "IN_PROGRESS":
            raise KeyError(f"lineage {lineage_id} not in progress")
        def upd(ideal):
            ideal = ideal or {}
            for seg in entry["to"]:
                ideal.pop(seg, None)
            return ideal

        self.store.update(f"/IDEALSTATES/{table}", upd)
        for seg in entry["to"]:
            self.store.delete(f"/SEGMENTS/{table}/{seg}")
        self.store.update(f"/LINEAGE/{table}", lambda cur: {
            **(cur or {}), lineage_id: {**entry, "state": "REVERTED"}})
        bump_lineage_epoch(self.store, table)

    def routable_segments(self, table: str, all_segments: set) -> set:
        """Filter by lineage (reference: the broker's lineage-based segment
        selection)."""
        return set(all_segments) - hidden_segments(self.store, table)

    def cleanup(self, table: str, stale_in_progress_s: float = 86400.0) -> dict:
        """Crash recovery + GC, idempotent (reference: lineage cleanup in
        RetentionManager): finish trailing cleanup of COMPLETED entries
        (process died between the routing flip and the ideal-state sweep),
        drop REVERTED tombstones, and revert IN_PROGRESS entries stale
        enough that their task is certainly dead."""
        now_ms = time.time() * 1000
        report = {"finished": [], "dropped": [], "reverted": []}
        for lid, entry in dict(self.store.get(f"/LINEAGE/{table}") or {}).items():
            if entry["state"] == "COMPLETED":
                self._finish_completed(table, lid, entry)
                report["finished"].append(lid)
            elif entry["state"] == "REVERTED":
                self.store.update(f"/LINEAGE/{table}", lambda cur, lid=lid: {
                    k: v for k, v in (cur or {}).items() if k != lid})
                report["dropped"].append(lid)
            elif (entry["state"] == "IN_PROGRESS"
                  and now_ms - entry.get("tsMs", now_ms)
                  > stale_in_progress_s * 1000):
                self.revert_replace(table, lid)
                report["reverted"].append(lid)
        return report


def hidden_segments(store: PropertyStore, table: str) -> set:
    """Segments brokers must NOT route for this table, per lineage (reads a
    fresh snapshot; pass an already-read snapshot to
    hidden_from_lineage when bracketing reads for consistency)."""
    return hidden_from_lineage(store.get(f"/LINEAGE/{table}"))


def hidden_from_lineage(entries: Optional[dict]) -> set:
    """The TO set of IN_PROGRESS replacements (not yet committed) and the
    FROM set of COMPLETED ones (swap committed, ideal-state cleanup still
    trailing). The single lineage-entry state flip is the atomic routing
    switch; this is the one place that encodes it (used by the broker and
    by SegmentLineageManager.routable_segments)."""
    hidden = set()
    for entry in (entries or {}).values():
        if entry.get("state") == "IN_PROGRESS":
            hidden |= set(entry.get("to", []))
        elif entry.get("state") == "COMPLETED":
            hidden |= set(entry.get("from", []))
    return hidden


# -- data integrity ----------------------------------------------------------


class SegmentIntegrityChecker:
    """Notices replicas quarantined by load-verify failures (ERROR state in
    the external view) and drives self-repair: writes a
    /REPAIRS/{table}/{seg} nudge that the owning servers watch and answer
    with a fresh deep-store fetch + re-verify. Nudges are bounded
    (max_repair_triggers per replica); a replica still ERROR after that is
    flagged unrepairable in the /INTEGRITY/{table} report — the operator's
    signal that the deep-store copy itself may be bad. Healthy-again
    replicas get their nudge + trigger counters cleaned up.

    Reference analogue: SegmentStatusChecker's ERROR-replica accounting +
    RealtimeSegmentValidationManager-style repair kicks."""

    def __init__(self, store: PropertyStore, controller: ClusterController,
                 max_repair_triggers: int = 3):
        self.store = store
        self.controller = controller
        self.max_repair_triggers = max_repair_triggers
        # (table, seg, instance) → nudges issued so far
        self._triggers: dict[tuple, int] = {}

    def __call__(self) -> dict:
        report = {}
        for table in self.store.children("/IDEALSTATES"):
            view = self.store.get(f"/EXTERNALVIEW/{table}") or {}
            errored = {seg: sorted(i for i, st in m.items() if st == ERROR)
                       for seg, m in view.items()
                       if any(st == ERROR for st in m.values())}
            # forget healthy replicas so a future quarantine gets a fresh
            # trigger budget
            for key in [k for k in self._triggers if k[0] == table
                        and k[2] not in errored.get(k[1], ())]:
                self._triggers.pop(key)
            if not errored and self.store.get(f"/INTEGRITY/{table}") is None:
                continue
            nudged, unrepairable = [], []
            for seg, instances in sorted(errored.items()):
                for inst in instances:
                    key = (table, seg, inst)
                    n = self._triggers.get(key, 0)
                    if n >= self.max_repair_triggers:
                        unrepairable.append({"segment": seg,
                                             "instance": inst,
                                             "triggers": n})
                        continue
                    self._triggers[key] = n + 1
                    nudged.append({"segment": seg, "instance": inst})
            for seg in {e["segment"] for e in nudged}:
                # the nonce makes every nudge a distinct write so the
                # store's watch fires even for a repeat nudge
                self.store.set(f"/REPAIRS/{table}/{seg}",
                               {"requestedAtMs": int(time.time() * 1000),
                                "nonce": self._triggers.get(
                                    (table, seg, errored[seg][0]), 0)})
            for seg in self.store.children(f"/REPAIRS/{table}"):
                if seg not in errored:  # repaired (or dropped): clear nudge
                    self.store.delete(f"/REPAIRS/{table}/{seg}")
            integrity = {
                "erroredReplicas": {s: i for s, i in sorted(errored.items())},
                "unrepairable": unrepairable,
                "checkedAtMs": int(time.time() * 1000),
            }
            if errored:
                self.store.set(f"/INTEGRITY/{table}", integrity)
            else:
                self.store.delete(f"/INTEGRITY/{table}")
            report[table] = integrity
        return report


# -- tier relocation ---------------------------------------------------------


class SegmentRelocator:
    """Moves aged segments onto their tier's servers (reference:
    SegmentRelocator + TierConfig). Delegates to the controller's
    tier-aware safe relocation (controller.relocate_tiers: two-phase
    ideal-state convergence, availability never dips — "allow at most one
    replica unavailable during rebalance"). Tier configs accept the
    reference shape ({"name", "segmentSelectorType", "segmentAge",
    "serverTag", "segmentList"}) and the legacy segmentAgeMs key."""

    def __init__(self, controller: ClusterController):
        self.controller = controller

    def __call__(self) -> dict:
        moves = {}
        for table in self.controller.store.children("/CONFIGS/TABLE"):
            cfg = self.controller.table_config(table) or {}
            if not cfg.get("tierConfigs"):
                continue
            try:
                res = self.controller.relocate_tiers(table)
            except (RuntimeError, TimeoutError):
                continue  # tier servers down: retry on the next cycle
            if res.get("segments_changed"):
                moved = [(seg, res["tiers"].get(seg))
                         for seg in sorted(res["target"])
                         if res["tiers"].get(seg) is not None]
                moves[table] = [(s, t) for s, t in moved]
        return moves


# -- cluster health rollup ---------------------------------------------------


# where the leader materializes the fleet snapshot; GET /debug/cluster on
# any controller serves this key (standbys serve the leader's last scrape)
HEALTH_REPORT_PATH = "/HEALTH/cluster"

# fewest latency samples before an instance participates in straggler math
# (the absolute stragglerMinMs floor already filters small-sample noise)
_MIN_LATENCY_SAMPLES = 3
# fewest segment-cache lookups in a scrape window before the fleet hit
# rate is judged at all (a near-idle window says nothing about the cache)
_MIN_CACHE_LOOKUPS = 32


class ClusterHealthChecker:
    """Leader-side fleet scrape + anomaly detection (the tentpole of the
    observability PR). Each run RPCs every live server's ``status``
    endpoint (per-instance latency quantiles, HBM residency, cache
    counters, quarantine inventory), folds in any broker state published
    at ``/BROKERSTATE/*`` (cluster/broker.py publish_state), and
    materializes one fleet snapshot at ``HEALTH_REPORT_PATH`` — the body
    of ``GET /debug/cluster``.

    Anomaly rules (each flagged entry ticks the clusterHealthAnomalies
    meter; thresholds are constructor arguments):

    - ``straggler``            a server's p99 is ≥ straggler_ratio × the
                               rest-of-fleet median p99 AND at least
                               straggler_min_ms above it
    - ``hbm-pressure``         the card bytes a server's device cache holds
                               over its budget ≥ hbm_pressure_ratio, or new
                               hbmOomEvents since the last scrape
    - ``cache-collapse``       fleet segment-cache hit rate over the scrape
                               window fell below cache_collapse_rate after a
                               previously healthy (≥50%) window
    - ``breaker-flap``         a broker's breakers re-opened ≥
                               breaker_flap_count times in one window
    - ``instance-unreachable`` a live-instance entry did not answer the scrape

    All scrape work runs on the controller's periodic thread — never on a
    query thread — and only on the elected leader (double-gated: the
    scheduler loop skips standbys, and __call__ re-checks so a stray
    run_once on a standby stays a no-op)."""

    def __init__(self, store: PropertyStore, controller: ClusterController,
                 straggler_ratio: float = 3.0,
                 straggler_min_ms: float = 50.0,
                 hbm_pressure_ratio: float = 0.9,
                 cache_collapse_rate: float = 0.2,
                 breaker_flap_count: int = 3,
                 scrape_timeout_s: float = 2.0):
        self.store = store
        self.controller = controller
        self.straggler_ratio = float(straggler_ratio)
        self.straggler_min_ms = float(straggler_min_ms)
        self.hbm_pressure_ratio = float(hbm_pressure_ratio)
        self.cache_collapse_rate = float(cache_collapse_rate)
        self.breaker_flap_count = int(breaker_flap_count)
        self.scrape_timeout_s = scrape_timeout_s
        # previous-scrape counters for windowed (delta) rules
        self._prev_counters: dict[str, dict] = {}
        self._prev_breaker_opens: dict[str, int] = {}
        self._prev_window_hit_rate: Optional[float] = None
        self._last_reachable = 0
        CONTROLLER_METRICS.set_gauge(
            ControllerGauge.CLUSTER_SERVERS_REACHABLE,
            lambda: self._last_reachable)

    def __call__(self) -> dict:
        leader = getattr(self.controller, "leader", None)
        if leader is not None and not leader.is_leader:
            return {"skipped": "standby controller does not scrape"}
        t0 = time.perf_counter()
        servers, anomalies = self._scrape_servers()
        brokers = self._collect_brokers(anomalies)
        self._collect_perf_alerts(anomalies)
        fleet = self._fleet_rollup(servers, anomalies)
        self._last_reachable = fleet["serversReachable"]
        snapshot = {
            "checkedAtMs": int(time.time() * 1000),
            "scrapeMs": round((time.perf_counter() - t0) * 1000, 3),
            "fleet": fleet,
            "servers": servers,
            "brokers": brokers,
            "anomalies": anomalies,
            "thresholds": {
                "stragglerRatio": self.straggler_ratio,
                "stragglerMinMs": self.straggler_min_ms,
                "hbmPressureRatio": self.hbm_pressure_ratio,
                "cacheCollapseRate": self.cache_collapse_rate,
                "breakerFlapCount": self.breaker_flap_count,
            },
        }
        if anomalies:
            CONTROLLER_METRICS.add_meter(
                ControllerMeter.CLUSTER_HEALTH_ANOMALIES, len(anomalies))
        self.store.set(HEALTH_REPORT_PATH, snapshot)
        return snapshot

    # -- scrape side ---------------------------------------------------------
    def _scrape_servers(self) -> tuple[dict, list]:
        servers: dict[str, dict] = {}
        anomalies: list[dict] = []
        for inst in sorted(self.store.children("/LIVEINSTANCES")):
            cfg = self.store.get(f"/LIVEINSTANCES/{inst}") or {}
            if "port" not in cfg:
                continue  # minions and other non-query instances
            client = RpcClient(cfg.get("host", "127.0.0.1"), cfg["port"],
                               timeout=self.scrape_timeout_s)
            try:
                status = client.call({"type": "status"}, retry=False)
                servers[inst] = dict(status, reachable=True)
            except (TransportError, RemoteError, OSError) as e:
                servers[inst] = {"instanceId": inst, "reachable": False,
                                 "error": str(e)}
                anomalies.append({
                    "type": "instance-unreachable", "instance": inst,
                    "detail": f"health scrape failed: {e}"})
            finally:
                client.close()
        return servers, anomalies

    def _collect_brokers(self, anomalies: list) -> dict:
        brokers: dict[str, dict] = {}
        for bid in sorted(self.store.children("/BROKERSTATE")):
            state = self.store.get(f"/BROKERSTATE/{bid}") or {}
            brokers[bid] = state
            opens = sum(int((b or {}).get("timesOpened", 0))
                        for b in (state.get("breakers") or {}).values())
            prev = self._prev_breaker_opens.get(bid)
            if prev is not None and opens - prev >= self.breaker_flap_count:
                anomalies.append({
                    "type": "breaker-flap", "instance": bid,
                    "detail": f"circuit breakers opened {opens - prev} "
                              f"times since the last scrape "
                              f"(threshold {self.breaker_flap_count})"})
            self._prev_breaker_opens[bid] = opens
        return brokers

    def _collect_perf_alerts(self, anomalies: list) -> None:
        """Fold the regression sentinel's active alerts into the fleet
        snapshot so GET /debug/cluster shows perf drift next to infra
        anomalies."""
        if not ALERTS.active_count:
            return
        for rec in ALERTS.active():
            anomalies.append({
                "type": rec["type"], "instance": rec.get("table", ""),
                "alertId": rec["id"],
                "detail": rec.get("summary", "")})

    # -- anomaly math --------------------------------------------------------
    def _fleet_rollup(self, servers: dict, anomalies: list) -> dict:
        reachable = {i: s for i, s in servers.items() if s.get("reachable")}
        # straggler: per-server p99 vs the fleet median p99
        p99s = {i: s["queryLatencyMs"]["p99"] for i, s in reachable.items()
                if s.get("queryLatencyMs", {}).get("count", 0)
                >= _MIN_LATENCY_SAMPLES}
        median_p99 = _median(list(p99s.values()))
        if len(p99s) >= 2:
            for inst, p99 in sorted(p99s.items()):
                # leave-one-out median: with small fleets the overall
                # median is dragged toward the straggler itself, hiding it
                rest = _median([v for i, v in p99s.items() if i != inst])
                if rest > 0 and p99 >= self.straggler_ratio * rest \
                        and p99 - rest >= self.straggler_min_ms:
                    anomalies.append({
                        "type": "straggler", "instance": inst,
                        "detail": f"p99 {p99:.1f}ms vs rest-of-fleet "
                                  f"median {rest:.1f}ms (ratio "
                                  f"{p99 / rest:.1f}x >= "
                                  f"{self.straggler_ratio}x)"})
        # hbm pressure: residency vs budget, plus fresh OOM events
        window_hits = window_misses = 0
        for inst, s in sorted(reachable.items()):
            hbm = s.get("hbm") or {}
            used = int(hbm.get("hbmBytesUsed", 0) or 0)
            budget = hbm.get("hbmBudgetBytes")
            if budget and used / budget >= self.hbm_pressure_ratio:
                anomalies.append({
                    "type": "hbm-pressure", "instance": inst,
                    "detail": f"HBM {used}/{budget} bytes "
                              f"({used / budget:.0%} >= "
                              f"{self.hbm_pressure_ratio:.0%} of budget)"})
            prev = self._prev_counters.get(inst, {})
            oom_delta = s.get("hbmOomEvents", 0) - prev.get("oom", 0)
            if prev and oom_delta > 0:
                anomalies.append({
                    "type": "hbm-pressure", "instance": inst,
                    "detail": f"{oom_delta} hbmOomEvents since the last "
                              f"scrape"})
            cache = s.get("segmentCache") or {}
            window_hits += cache.get("hits", 0) - prev.get("hits", 0) \
                if prev else 0
            window_misses += cache.get("misses", 0) - prev.get("misses", 0) \
                if prev else 0
            self._prev_counters[inst] = {
                "hits": cache.get("hits", 0),
                "misses": cache.get("misses", 0),
                "oom": s.get("hbmOomEvents", 0),
            }
        # cache collapse: fleet hit rate over THIS window, judged only
        # against a previously healthy window with real traffic
        lookups = window_hits + window_misses
        window_rate = window_hits / lookups if lookups else None
        if lookups >= _MIN_CACHE_LOOKUPS and window_rate is not None:
            prev_rate = self._prev_window_hit_rate
            if prev_rate is not None and prev_rate >= 0.5 \
                    and window_rate < self.cache_collapse_rate:
                anomalies.append({
                    "type": "cache-collapse", "instance": "",
                    "detail": f"fleet segment-cache hit rate fell to "
                              f"{window_rate:.0%} (was {prev_rate:.0%}) "
                              f"over {lookups} lookups"})
            self._prev_window_hit_rate = window_rate
        quarantined = sum(len(segs)
                          for s in reachable.values()
                          for segs in (s.get("quarantined") or {}).values())
        return {
            "serversTotal": len(servers),
            "serversReachable": len(reachable),
            "medianP50Ms": _median([s["queryLatencyMs"]["p50"]
                                    for s in reachable.values()
                                    if s.get("queryLatencyMs", {}).get(
                                        "count", 0)]),
            "medianP99Ms": median_p99,
            "maxP99Ms": max(p99s.values()) if p99s else 0.0,
            "windowCacheHitRate": round(window_rate, 4)
            if window_rate is not None else None,
            "quarantinedSegments": quarantined,
        }


def _median(values: list) -> float:
    if not values:
        return 0.0
    values = sorted(values)
    mid = len(values) // 2
    if len(values) % 2:
        return float(values[mid])
    return (values[mid - 1] + values[mid]) / 2.0


def build_default_scheduler(store: PropertyStore, controller: ClusterController,
                            interval_s: float = 10.0, leader=None,
                            config: Optional[PinotConfiguration] = None,
                            ) -> ControllerPeriodicTaskScheduler:
    """The standard job set (reference BaseControllerStarter wiring). Pass
    a LeadControllerManager so only the elected controller runs the jobs
    when several controllers share a cluster; defaults to the controller's
    own elector when it was built with an instance_id.

    ``config`` carries the knobs the JAX package reads from its
    environment, under the names PinotConfiguration gives them
    (PINOT_TPU_REBALANCE_TICK_S is ``rebalance.tick.s``): the tick
    intervals, the rebalancer's, the actuator's, the prefetcher's and the
    sentinel's knobs and the health thresholds. Each absent key takes the
    JAX default."""
    cfg = config if config is not None else PinotConfiguration(use_env=False)
    if leader is None:
        leader = getattr(controller, "leader", None)
    sched = ControllerPeriodicTaskScheduler(leader=leader)
    sched.register("RetentionManager", interval_s,
                   lambda: controller.run_retention())
    sched.register("SegmentStatusChecker", interval_s,
                   SegmentStatusChecker(store, controller))
    sched.register("SegmentIntegrityChecker", interval_s,
                   SegmentIntegrityChecker(store, controller))
    sched.register("RebalanceChecker", interval_s, RebalanceChecker(controller))
    sched.register("SegmentRelocator", interval_s, SegmentRelocator(controller))

    def _lineage_cleanup():
        mgr = SegmentLineageManager(store, controller)
        return {t: mgr.cleanup(t) for t in store.children("/LINEAGE")}

    sched.register("LineageCleanupTask", interval_s, _lineage_cleanup)
    actuator = RebalanceActuator(
        SegmentRebalancer(
            controller,
            max_moves=cfg.get_int("rebalance.max.moves", 2),
            move_timeout_s=cfg.get_float("rebalance.move.timeout.s", 30.0),
            max_attempts=cfg.get_int("rebalance.retries", 3),
            backoff_ms=cfg.get_float("rebalance.backoff.ms", 100.0)),
        health_rebalance=cfg.get_bool("health.rebalance", False),
        hysteresis=cfg.get_int("rebalance.hysteresis", 2),
        cooldown_s=cfg.get_float("rebalance.cooldown.s", 300.0))
    # actuation wants a tighter cadence than housekeeping: a move's EV wait
    # advances at most one step per tick
    sched.register("RebalanceActuator",
                   cfg.get_float("rebalance.tick.s", min(1.0, interval_s)),
                   actuator)
    # fleet scrape can run on its own cadence (operators tune how fresh
    # GET /debug/cluster is, independent of segment housekeeping)
    sched.register("ClusterHealthChecker",
                   cfg.get_float("health.scrape.s", interval_s),
                   ClusterHealthChecker(
                       store, controller,
                       straggler_ratio=cfg.get_float("straggler.ratio", 3.0),
                       straggler_min_ms=cfg.get_float("straggler.min.ms",
                                                      50.0),
                       hbm_pressure_ratio=cfg.get_float("hbm.pressure.ratio",
                                                        0.9),
                       cache_collapse_rate=cfg.get_float(
                           "cache.collapse.rate", 0.2),
                       breaker_flap_count=cfg.get_int("breaker.flap.count",
                                                      3)))
    # walks broker /BROKERSTATE cost beacons and writes /PREFETCH/{table}
    # nudges for tables entering the hot set
    sched.register("StoragePrefetcher",
                   cfg.get_float("prefetch.tick.s", interval_s),
                   StoragePrefetcher(
                       store, top_k=cfg.get_int("prefetch.top.k", 3),
                       min_cost_ms=cfg.get_float("prefetch.min.cost.ms",
                                                 0.5)))
    sched.register("PerfRegressionSentinel",
                   cfg.get_float("sentinel.scrape.s", interval_s),
                   PerfRegressionSentinel(
                       store, controller,
                       threshold=cfg.get_float("sentinel.threshold", 0.25),
                       min_abs_ms=cfg.get_float("sentinel.min.abs.ms", 2.0),
                       min_queries=cfg.get_int("sentinel.min.queries", 5),
                       breaches=cfg.get_int("sentinel.breaches", 2),
                       clears=cfg.get_int("sentinel.clears", 2),
                       exemplars=cfg.get_int("sentinel.exemplars", 3)))
    return sched
