"""Self-healing capacity: durable, leader-gated, no-downtime segment moves.

The port's copy of pinot_tpu/cluster/rebalance.py. Its knobs are keyword
arguments with the JAX package's defaults (the JAX module reads them from
PINOT_TPU_REBALANCE_* and PINOT_TPU_HEALTH_REBALANCE); the port's cluster
reads no environment variable. A move's destination loads on its card like
any other segment, and the departing server releases the moved segment's
planes and stacks from its card when it converges.

Reference analogue: TableRebalancer (pinot-controller/.../helix/core/
rebalance/TableRebalancer.java) driving Helix ideal-state transitions with
ZK-persisted job context, plus RebalanceChecker resuming stuck jobs. The
controller's synchronous ``ClusterController.rebalance`` converges a whole
table in one blocking call; this module is the production actuation loop
layered on the same two-phase discipline:

- The PLAN is durable: ``/REBALANCE/{table}`` holds the target assignment
  plus one state-machine record per moved segment, journaled in the
  crash-consistent property store (cluster/store.py WAL). A controller
  failover resumes mid-rebalance from the journal instead of orphaning
  half-moved segments — the new leader's actuator just keeps ticking.
- Moves are strictly MAKE-BEFORE-BREAK: the destination deep-store-fetches,
  loads and integrity-verifies (ServerInstance._load_segment_verified, the
  PR-8 repair path) and shows ONLINE in the external view before the
  source replica leaves the ideal state. A segment's routable replica
  count never dips below its pre-move count.
- Per-move lifecycle::

      PENDING ──start──▶ ADDING ──dest ONLINE──▶ DROPPING ──▶ COMPLETED
         ▲                  │ timeout                 (resumed idempotently
         └───retry/backoff──┘                          after a crash)
               │ attempts exhausted: blacklist dest, repick or
               ▼
             FAILED                PENDING/ADDING ──abort──▶ CANCELLED

- Bounded concurrency (``max_moves`` in-flight moves), per-move retry with
  exponential backoff, destination blacklisted after ``max_attempts``
  failed attempts and a replacement chosen.
- Target assignment is minimal-movement and replica-count-preserving, and
  weighs hosts by the PR-10 per-table cost rollups that brokers publish at
  ``/BROKERSTATE/*`` — hot segments are placed and spread FIRST so new
  capacity absorbs the expensive traffic before the cold tail moves.
- Each completed move bumps the table's ``/CACHEEPOCH`` lineage epoch
  (broker result-cache invalidation) and the departing server's converge
  drops its partials AND name-matched stacked batch-family views
  (DeviceSegmentCache.drop_named), so no cache tier serves from a
  moved-away segment.

Triggers (RebalanceActuator, registered as a leader-gated periodic task):
operator REST (``POST /tables/{t}/rebalance``, ``GET /debug/rebalance``,
abort via ``POST /tables/{t}/rebalance/abort``), automatic dead-server
rebuild and server-add spreading, and an opt-in health loop
(``health_rebalance=True``) draining ``straggler``/``hbm-pressure``
instances under cooldown + hysteresis so it can never flap.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Optional

from ..cache.results import bump_lineage_epoch
from ..spi.metrics import (CONTROLLER_METRICS, ControllerGauge,
                           ControllerMeter, ControllerTimer)
from .controller import CONSUMING, ERROR, ONLINE, ClusterController, \
    raw_table_name
from .store import BadVersionError, PropertyStore

log = logging.getLogger("pinot_tpu_torch.rebalance")

REBALANCE_PREFIX = "/REBALANCE"
# durable last-seen live-server set for the server-add trigger, so a
# controller failover/restart still fires for servers added during the
# outage (deliberately OUTSIDE the job prefix: children(REBALANCE_PREFIX)
# must only ever yield table names)
SEEN_SERVERS_PATH = "/REBALANCEMETA/seenServers"

# process-wide per-(store, table) actuation locks, shared by every
# SegmentRebalancer wrapping the same store (the REST handler and the
# periodic actuator each build their own engine instance): only one
# thread may advance a table's move state machine at a time, so inline
# drive() and the actuator's tick() can't both act on one stale
# view/journal read
_LOCKS_GUARD = threading.Lock()

# job statuses
IN_PROGRESS = "IN_PROGRESS"
DONE = "DONE"
PARTIAL = "PARTIAL"          # finished, but some moves FAILED
ABORTING = "ABORTING"
ABORTED = "ABORTED"
ACTIVE_STATUSES = (IN_PROGRESS, ABORTING)

# per-move states
MOVE_PENDING = "PENDING"
MOVE_ADDING = "ADDING"
MOVE_DROPPING = "DROPPING"
MOVE_COMPLETED = "COMPLETED"
MOVE_FAILED = "FAILED"
MOVE_CANCELLED = "CANCELLED"
MOVE_TERMINAL = (MOVE_COMPLETED, MOVE_FAILED, MOVE_CANCELLED)


class RebalanceInProgress(RuntimeError):
    """A durable rebalance job for the table is already active."""


def _is_engine_job(job: Optional[dict]) -> bool:
    """True for journal records this engine owns. The legacy blocking
    rebalance (ClusterController._apply_target_safely) shares the
    /REBALANCE/{table} path but never writes a movePlan — the engine must
    neither tick nor finalize those records, and the legacy path must not
    overwrite an active engine journal (it checks the same predicate)."""
    return job is not None and "movePlan" in job


class SegmentRebalancer:
    """Leader-gated, crash-resumable rebalance engine. Stateless between
    ticks by design: every decision re-reads the journaled job from the
    property store, so ANY controller holding the leader seat can advance
    any job — that is what makes failover resume free."""

    def __init__(self, controller: ClusterController,
                 max_moves: int = 2, move_timeout_s: float = 30.0,
                 max_attempts: int = 3, backoff_ms: float = 100.0):
        self.controller = controller
        self.store: PropertyStore = controller.store
        self.max_moves = max(1, int(max_moves))
        self.move_timeout_s = float(move_timeout_s)
        self.max_attempts = max(1, int(max_attempts))
        self.backoff_ms = float(backoff_ms)
        CONTROLLER_METRICS.set_gauge(ControllerGauge.REBALANCE_ACTIVE,
                                     self.active_jobs)

    def _table_lock(self, nwt: str) -> threading.Lock:
        """Per-(store, table) actuation lock shared across every engine
        instance in this process (REST builds one, the actuator another)."""
        with _LOCKS_GUARD:
            locks = getattr(self.store, "_rebalance_table_locks", None)
            if locks is None:
                locks = {}
                self.store._rebalance_table_locks = locks
            return locks.setdefault(nwt, threading.Lock())

    # -- observation ---------------------------------------------------------
    def job_path(self, nwt: str) -> str:
        return f"{REBALANCE_PREFIX}/{nwt}"

    def job(self, nwt: str) -> Optional[dict]:
        return self.store.get(self.job_path(nwt))

    def active_jobs(self) -> int:
        n = 0
        for table in self.store.children(REBALANCE_PREFIX):
            if (self.store.get(f"{REBALANCE_PREFIX}/{table}") or {}).get(
                    "status") in ACTIVE_STATUSES:
                n += 1
        return n

    def debug(self) -> dict:
        """GET /debug/rebalance: every journaled job, active first."""
        jobs = {t: self.store.get(f"{REBALANCE_PREFIX}/{t}")
                for t in self.store.children(REBALANCE_PREFIX)}
        return {
            "active": {t: j for t, j in jobs.items()
                       if (j or {}).get("status") in ACTIVE_STATUSES},
            "finished": {t: j for t, j in jobs.items()
                         if (j or {}).get("status") not in ACTIVE_STATUSES},
            "knobs": {
                "maxMoves": self.max_moves,
                "moveTimeoutS": self.move_timeout_s,
                "maxAttempts": self.max_attempts,
                "backoffMs": self.backoff_ms,
            },
        }

    # -- cost-aware target computation ---------------------------------------
    def table_heat(self) -> dict:
        """raw table → decayed expected query cost (ms), folded across
        every broker beacon at /BROKERSTATE/* (the PR-10 workload rollups).
        Empty when no broker publishes costs — weights then degrade to
        doc counts."""
        heat: dict[str, float] = {}
        for bid in self.store.children("/BROKERSTATE"):
            state = self.store.get(f"/BROKERSTATE/{bid}") or {}
            for table, cost in (state.get("tableCostsMs") or {}).items():
                try:
                    heat[table] = max(heat.get(table, 0.0), float(cost))
                except (TypeError, ValueError):
                    continue
        return heat

    def _segment_weights(self, nwt: str, ideal: dict,
                         heat: dict) -> dict[str, float]:
        """Move-ordering weight: docs scaled by table heat, so the hot
        table's big segments spread onto new capacity first."""
        factor = 1.0 + heat.get(raw_table_name(nwt), 0.0)
        weights = {}
        for seg in ideal:
            meta = self.store.get(f"/SEGMENTS/{nwt}/{seg}") or {}
            weights[seg] = max(1.0, float(meta.get("numDocs", 1))) * factor
        return weights

    def compute_target(self, nwt: str, exclude: frozenset = frozenset()
                       ) -> tuple[dict, dict, int]:
        """Minimal-movement, replica-count-preserving target.

        Returns (target, weights, moves). CONSUMING segments are frozen
        (moving an active consumer restarts consumption); replica-group
        tables delegate to the controller's group-aware math. ``exclude``
        drains instances (health loop) — refused when it would leave
        fewer candidates than the replication factor."""
        cfg = self.controller.table_config(nwt)
        if cfg is None:
            raise KeyError(nwt)
        self.controller._check_upsert_movable(nwt, cfg)
        ideal = self.store.get(f"/IDEALSTATES/{nwt}") or {}
        heat = self.table_heat()
        weights = self._segment_weights(nwt, ideal, heat)
        frozen = {s: dict(m) for s, m in ideal.items()
                  if CONSUMING in m.values()}
        movable = {s: m for s, m in ideal.items() if s not in frozen}

        if self.controller.instance_partitions(nwt):
            if exclude:
                raise RuntimeError(
                    f"{nwt}: cannot drain instances {sorted(exclude)} from "
                    "a replica-group table — group membership pins placement"
                )
            target, moves = self.controller._rebalance_target(
                nwt, cfg, movable)
            target.update(frozen)
            return target, weights, moves

        replication = int(cfg.get("replication", 1))
        candidates = sorted(
            (set(self.controller.server_instances(cfg.get("serverTag")))
             & set(self.controller.live_instances())) - set(exclude))
        if len(candidates) < replication:
            raise RuntimeError(
                f"{nwt}: {len(candidates)} usable servers "
                f"{candidates} < replication {replication}")
        # weighted load per host (hot tables dominate); count load keeps
        # the final spread levelled like the synchronous rebalancer
        wload = {i: 0.0 for i in candidates}
        cload = {i: 0 for i in candidates}
        target: dict[str, dict] = {}
        moves = 0
        hot_first = sorted(movable, key=lambda s: (-weights[s], s))
        for seg in hot_first:
            keep = [i for i in movable[seg] if i in candidates][:replication]
            target[seg] = {i: movable[seg][i] for i in keep}
            for i in keep:
                wload[i] += weights[seg]
                cload[i] += 1
        for seg in hot_first:
            state = ONLINE
            while len(target[seg]) < replication:
                pick = min((i for i in candidates if i not in target[seg]),
                           key=lambda i: (cload[i], wload[i], i))
                target[seg][pick] = state
                wload[pick] += weights[seg]
                cload[pick] += 1
                moves += 1
        # level counts (spread <= 1), shedding the HOTTEST movable replica
        # from the most-loaded host each step
        for _ in range(len(movable) * max(1, replication)):
            hi = max(candidates, key=lambda i: (cload[i], wload[i], i))
            lo = min(candidates, key=lambda i: (cload[i], wload[i], i))
            if cload[hi] - cload[lo] <= 1:
                break
            movable_here = [s for s in hot_first
                            if hi in target[s] and lo not in target[s]]
            if not movable_here:
                break
            seg = movable_here[0]
            target[seg][lo] = target[seg].pop(hi)
            wload[hi] -= weights[seg]
            wload[lo] += weights[seg]
            cload[hi] -= 1
            cload[lo] += 1
            moves += 1
        target.update(frozen)
        return target, weights, moves

    # -- planning ------------------------------------------------------------
    def plan(self, nwt: str, trigger: str = "rest",
             exclude: frozenset = frozenset(),
             dry_run: bool = False) -> Optional[dict]:
        """Compute and journal a durable rebalance job. Returns None when
        the table is already balanced; raises RebalanceInProgress when an
        active job exists (abort it first)."""
        existing, existing_version = self.store.get_with_version(
            self.job_path(nwt))
        if existing and existing.get("status") in ACTIVE_STATUSES:
            raise RebalanceInProgress(
                f"{nwt}: job {existing.get('jobId')} is "
                f"{existing.get('status')}")
        ideal = self.store.get(f"/IDEALSTATES/{nwt}") or {}
        target, weights, moves = self.compute_target(nwt, exclude=exclude)
        changed = [s for s in ideal
                   if set(target.get(s, {})) != set(ideal[s])]
        changed.sort(key=lambda s: (-weights.get(s, 1.0), s))
        now_ms = int(time.time() * 1000)
        move_plan = []
        for seg in changed:
            adds = {i: st for i, st in target[seg].items()
                    if i not in ideal[seg]}
            drops = sorted(i for i in ideal[seg] if i not in target[seg])
            move_plan.append({
                "segment": seg,
                "adds": adds,
                "drops": drops,
                "state": MOVE_PENDING,
                "attempts": 0,
                "blacklist": [],
                "weight": round(weights.get(seg, 1.0), 3),
            })
        job = {
            "jobId": f"rb_{now_ms}_{len(changed)}",
            "status": IN_PROGRESS if changed else DONE,
            "trigger": trigger,
            "startedMs": now_ms,
            "segmentsTotal": len(changed),
            "segmentsDone": 0,
            "moves": moves,
            "target": target,
            "movePlan": move_plan,
        }
        if not changed:
            job["finishedMs"] = now_ms
        if exclude:
            job["excluded"] = sorted(exclude)
        if dry_run:
            return job
        # CAS on the version read above: two planners racing past the
        # active check (e.g. REST on two controllers) cannot both journal —
        # the loser would silently overwrite a plan already being actuated
        try:
            if existing_version < 0:
                if not self.store.create_if_absent(self.job_path(nwt), job):
                    raise BadVersionError(self.job_path(nwt))
            else:
                self.store.set(self.job_path(nwt), job,
                               expected_version=existing_version)
        except BadVersionError:
            raise RebalanceInProgress(
                f"{nwt}: a concurrent plan journaled first") from None
        log.info("%s: journaled rebalance %s (%d segments, trigger=%s)",
                 nwt, job["jobId"], len(changed), trigger)
        return job

    # -- actuation -----------------------------------------------------------
    def tick(self) -> dict:
        """Advance every active job by at most one state transition per
        move. Safe to call from any controller; standbys no-op. Each tick
        re-reads the journal, so the loop is resumable at every point."""
        if not self.controller.is_leader():
            return {"skipped": "standby controller does not actuate"}
        report = {}
        for table in self.store.children(REBALANCE_PREFIX):
            job = self.store.get(f"{REBALANCE_PREFIX}/{table}")
            if not job or job.get("status") not in ACTIVE_STATUSES:
                continue
            if not _is_engine_job(job):
                # legacy blocking-rebalance record: its owner drives it
                # synchronously; finalizing or ticking it here would let
                # both engines mutate the table's ideal state at once
                continue
            try:
                with self._table_lock(table):
                    report[table] = self._tick_table(
                        table, self.job(table) or job)
            except Exception as e:  # one stuck table must not wedge others
                log.exception("%s: rebalance tick failed", table)
                report[table] = f"{type(e).__name__}: {e}"
        return report

    def drive(self, nwt: str, timeout_s: float = 30.0,
              tick_interval_s: float = 0.02) -> dict:
        """Synchronously tick one table's job to a terminal status (REST
        default mode + tests). The job stays durable throughout — killing
        the caller mid-way leaves a journal any leader resumes. Leader-only
        like tick(): a standby driving inline would actuate concurrently
        with the real leader's periodic actuator."""
        if not self.controller.is_leader():
            raise RuntimeError(
                f"{nwt}: standby controller does not actuate; the leader's "
                "RebalanceActuator drives the journaled job")
        deadline = time.time() + timeout_s
        while time.time() < deadline:
            job = self.job(nwt)
            if not job or job.get("status") not in ACTIVE_STATUSES:
                return job or {"status": DONE, "segmentsTotal": 0}
            if not _is_engine_job(job):
                raise RebalanceInProgress(
                    f"{nwt}: journal holds a legacy blocking-rebalance job "
                    f"{job.get('jobId')} ({job.get('status')}); the engine "
                    "cannot drive it")
            with self._table_lock(nwt):
                job = self.job(nwt)
                if job and job.get("status") in ACTIVE_STATUSES:
                    self._tick_table(nwt, job)
            job = self.job(nwt)
            if job and job.get("status") in ACTIVE_STATUSES:
                time.sleep(tick_interval_s)
        raise TimeoutError(
            f"rebalance for {nwt} still {self.job(nwt).get('status')} "
            f"after {timeout_s}s")

    def run(self, nwt: str, trigger: str = "rest",
            timeout_s: float = 30.0) -> dict:
        """plan + drive: the synchronous operator entry point."""
        job = self.plan(nwt, trigger=trigger)
        if job is None or job.get("status") != IN_PROGRESS:
            return job
        return self.drive(nwt, timeout_s=timeout_s)

    def abort(self, nwt: str) -> dict:
        """Roll an active job back: in-flight destinations leave the ideal
        state (their replicas were additive, so availability only shrinks
        back to the pre-move set), pending moves cancel, completed moves
        stay (the segment already lives at its new home)."""
        def to_aborting(job):
            if job and job.get("status") == IN_PROGRESS:
                job["status"] = ABORTING
            return job

        self.store.update(self.job_path(nwt), to_aborting)
        job = self.job(nwt)
        # marking ABORTING is a durable request any controller may journal;
        # the rollback itself is actuation and stays leader-only (a standby
        # returns the ABORTING job and the leader's next tick rolls back)
        if job and job.get("status") == ABORTING \
                and self.controller.is_leader():
            with self._table_lock(nwt):
                job = self.job(nwt)
                if job and job.get("status") == ABORTING:
                    self._tick_table(nwt, job)
            job = self.job(nwt)
        return job

    # -- per-table state machine ---------------------------------------------
    def _tick_table(self, nwt: str, job: dict) -> dict:
        if job.get("status") == ABORTING:
            return self._abort_table(nwt, job)
        now_ms = int(time.time() * 1000)
        summary = {"advanced": 0, "started": 0, "retried": 0}
        plan = job.get("movePlan") or []
        view = self.store.get(f"/EXTERNALVIEW/{nwt}") or {}
        for idx, move in enumerate(plan):
            if move["state"] == MOVE_DROPPING:
                self._finish_move(nwt, idx, move)
                summary["advanced"] += 1
            elif move["state"] == MOVE_ADDING:
                summary["advanced"] += self._check_adding(
                    nwt, idx, move, view, now_ms)
        job = self.job(nwt) or job
        plan = job.get("movePlan") or []
        active = sum(1 for m in plan
                     if m["state"] in (MOVE_ADDING, MOVE_DROPPING))
        for idx, move in enumerate(plan):
            if active >= self.max_moves:
                break
            if move["state"] != MOVE_PENDING:
                continue
            if move.get("backoffUntilMs", 0) > now_ms:
                continue
            self._start_move(nwt, idx, move, now_ms)
            active += 1
            summary["started"] += 1
        self._maybe_finish_job(nwt)
        return summary

    def _start_move(self, nwt: str, idx: int, move: dict,
                    now_ms: int) -> None:
        """Phase 1: additive union — the destination joins the ideal state
        while every current replica stays. Availability can only grow."""
        seg = move["segment"]
        adds = dict(move["adds"])

        def add_union(ideal):
            ideal = ideal or {}
            if seg in ideal:  # deleted concurrently → nothing to move
                merged = dict(ideal[seg])
                merged.update(adds)
                ideal[seg] = merged
            return ideal

        self.store.update(f"/IDEALSTATES/{nwt}", add_union)
        if seg not in (self.store.get(f"/IDEALSTATES/{nwt}") or {}):
            self._update_move(nwt, idx, state=MOVE_CANCELLED,
                              error="segment deleted during rebalance")
            return
        first_attempt = move["attempts"] == 0
        self._update_move(nwt, idx, state=MOVE_ADDING,
                          attempts=move["attempts"] + 1,
                          attemptStartedMs=now_ms,
                          startedMs=move.get("startedMs", now_ms))
        if first_attempt:
            CONTROLLER_METRICS.add_meter(
                ControllerMeter.SEGMENT_MOVES_STARTED)

    def _check_adding(self, nwt: str, idx: int, move: dict, view: dict,
                      now_ms: int) -> int:
        """Destination ONLINE in the external view → break the source;
        timeout → retry with backoff, blacklisting after exhaustion."""
        seg = move["segment"]
        ev = view.get(seg) or {}
        wanted = [i for i, st in move["adds"].items() if st == ONLINE]
        if wanted and all(ev.get(i) == ONLINE for i in wanted):
            self._update_move(nwt, idx, state=MOVE_DROPPING)
            move = dict(move, state=MOVE_DROPPING)
            self._finish_move(nwt, idx, move)
            return 1
        if not wanted:
            # pure-drop move (e.g. shrinking onto fewer replicas): nothing
            # to wait for, the remaining replicas are already serving
            self._update_move(nwt, idx, state=MOVE_DROPPING)
            self._finish_move(nwt, idx, dict(move, state=MOVE_DROPPING))
            return 1
        elapsed_ms = now_ms - move.get("attemptStartedMs", now_ms)
        errored = [i for i in wanted if ev.get(i) == ERROR]
        if elapsed_ms < self.move_timeout_s * 1000:
            return 0
        self._retry_move(nwt, idx, move, now_ms,
                         reason=f"destination not ONLINE after "
                                f"{elapsed_ms}ms"
                                + (f" (ERROR on {errored})" if errored
                                   else ""))
        return 0

    def _retry_move(self, nwt: str, idx: int, move: dict, now_ms: int,
                    reason: str) -> None:
        seg = move["segment"]
        adds = dict(move["adds"])

        def remove_adds(ideal):
            ideal = ideal or {}
            if seg in ideal:
                for inst in adds:
                    # make-before-break: the destination never served, so
                    # retracting it cannot dip availability
                    ideal[seg].pop(inst, None)
            return ideal

        self.store.update(f"/IDEALSTATES/{nwt}", remove_adds)
        attempts = move["attempts"]
        if attempts < self.max_attempts:
            backoff = self.backoff_ms * (2 ** max(0, attempts - 1))
            self._update_move(nwt, idx, state=MOVE_PENDING,
                              backoffUntilMs=now_ms + int(backoff),
                              error=reason)
            return
        # attempts exhausted: blacklist the destination and repick —
        # honouring the job's drained instances (a health-drain job must
        # never repick the straggler it exists to empty)
        blacklist = sorted(set(move.get("blacklist", [])) | set(adds))
        excluded = set((self.job(nwt) or {}).get("excluded", ()))
        ideal_now = (self.store.get(f"/IDEALSTATES/{nwt}") or {}).get(seg, {})
        cfg = self.controller.table_config(nwt) or {}
        candidates = sorted(
            set(self.controller.server_instances(cfg.get("serverTag")))
            & set(self.controller.live_instances()))
        fresh = [i for i in candidates
                 if i not in blacklist and i not in ideal_now
                 and i not in excluded]
        if not fresh:
            self._update_move(nwt, idx, state=MOVE_FAILED,
                              blacklist=blacklist,
                              error=f"{reason}; no replacement destination "
                                    f"outside blacklist {blacklist}",
                              finishedMs=now_ms)
            CONTROLLER_METRICS.add_meter(
                ControllerMeter.SEGMENT_MOVES_FAILED)
            log.error("%s: move of %s FAILED (%s)", nwt, seg, reason)
            return
        state = next(iter(adds.values()), ONLINE)
        replacement = {fresh[0]: state}
        self._update_move(nwt, idx, state=MOVE_PENDING, attempts=0,
                          adds=replacement, blacklist=blacklist,
                          backoffUntilMs=now_ms + int(self.backoff_ms),
                          error=f"{reason}; destination blacklisted, "
                                f"retrying via {fresh[0]}")
        log.warning("%s: move of %s blacklisted %s, repicked %s",
                    nwt, seg, sorted(adds), fresh[0])

    def _finish_move(self, nwt: str, idx: int, move: dict) -> None:
        """Phase 2 (journaled as DROPPING first, so a crash between the
        journal write and the ideal-state update replays this idempotent
        step): retract the departing replicas, bump the table's cache
        lineage epoch, and mark the move COMPLETED."""
        seg = move["segment"]
        drops = list(move.get("drops", []))

        def break_source(ideal):
            ideal = ideal or {}
            if seg in ideal:
                for inst in drops:
                    ideal[seg].pop(inst, None)
            return ideal

        self.store.update(f"/IDEALSTATES/{nwt}", break_source)
        bump_lineage_epoch(self.store, nwt)
        now_ms = int(time.time() * 1000)
        self._update_move(nwt, idx, state=MOVE_COMPLETED,
                          finishedMs=now_ms, error=None)
        CONTROLLER_METRICS.add_meter(ControllerMeter.SEGMENT_MOVES_COMPLETED)
        CONTROLLER_METRICS.update_timer(
            ControllerTimer.SEGMENT_MOVE_MS,
            max(0.0, now_ms - move.get("startedMs", now_ms)))

    def _abort_table(self, nwt: str, job: dict) -> dict:
        cancelled = 0
        for idx, move in enumerate(job.get("movePlan") or []):
            if move["state"] in MOVE_TERMINAL:
                continue
            if move["state"] == MOVE_DROPPING:
                # past the point of no return: the destination is serving,
                # finishing is the rollback-safe direction
                self._finish_move(nwt, idx, move)
                continue
            if move["state"] == MOVE_ADDING:
                seg, adds = move["segment"], dict(move["adds"])

                def remove_adds(ideal):
                    ideal = ideal or {}
                    if seg in ideal:
                        for inst in adds:
                            ideal[seg].pop(inst, None)
                    return ideal

                self.store.update(f"/IDEALSTATES/{nwt}", remove_adds)
            self._update_move(nwt, idx, state=MOVE_CANCELLED,
                              finishedMs=int(time.time() * 1000))
            cancelled += 1
        bump_lineage_epoch(self.store, nwt)

        def finish(j):
            if j and j.get("status") == ABORTING:
                j["status"] = ABORTED
                j["finishedMs"] = int(time.time() * 1000)
            return j

        self.store.update(self.job_path(nwt), finish)
        log.info("%s: rebalance aborted (%d moves rolled back)", nwt,
                 cancelled)
        return {"aborted": cancelled}

    def _maybe_finish_job(self, nwt: str) -> None:
        def finalize(job):
            if not job or job.get("status") != IN_PROGRESS:
                return job
            if not _is_engine_job(job):
                # legacy blocking-rebalance record mid-flight: finalizing
                # it to DONE here would defeat the RebalanceInProgress
                # guard and let both engines mutate the ideal state
                return job
            plan = job.get("movePlan") or []
            if any(m["state"] not in MOVE_TERMINAL for m in plan):
                job["segmentsDone"] = sum(
                    1 for m in plan if m["state"] == MOVE_COMPLETED)
                return job
            failed = [m["segment"] for m in plan
                      if m["state"] == MOVE_FAILED]
            job["segmentsDone"] = sum(
                1 for m in plan if m["state"] == MOVE_COMPLETED)
            job["status"] = PARTIAL if failed else DONE
            if failed:
                job["failedSegments"] = failed
            job["finishedMs"] = int(time.time() * 1000)
            return job

        self.store.update(self.job_path(nwt), finalize)

    def _update_move(self, nwt: str, idx: int, **fields) -> None:
        def upd(job):
            if not job:
                return job
            plan = job.get("movePlan") or []
            if idx < len(plan):
                for k, v in fields.items():
                    if v is None:
                        plan[idx].pop(k, None)
                    else:
                        plan[idx][k] = v
            return job

        self.store.update(self.job_path(nwt), upd)


class RebalanceActuator:
    """The leader-gated periodic task wrapping the engine: ticks active
    jobs forward and fires the automatic triggers.

    - dead-server: a table whose ideal state references non-live instances
      gets a durable rebuild job (replicas re-fetch from deep store).
    - server-add: when NEW servers join the live set, tables whose dry-run
      plan has moves spread onto them.
    - health loop (opt-in, ``health_rebalance``): drains the instance
      named by ``straggler``/``hbm-pressure`` anomalies in the leader's
      /HEALTH/cluster snapshot — only after the anomaly persists
      ``hysteresis`` consecutive scrapes, and never within ``cooldown_s``
      of the last health-driven job, so a borderline server can't make the
      cluster flap."""

    def __init__(self, rebalancer: SegmentRebalancer,
                 health_rebalance: bool = False, hysteresis: int = 2,
                 cooldown_s: float = 300.0):
        self.rebalancer = rebalancer
        self.health_rebalance = bool(health_rebalance)
        self.hysteresis = max(1, int(hysteresis))
        self.cooldown_s = float(cooldown_s)
        self.controller = rebalancer.controller
        self.store = rebalancer.store
        self._seen_servers: Optional[set] = None
        # instance → consecutive health scrapes naming it
        self._anomaly_streak: dict[str, int] = {}
        self._last_health_checked_ms = 0
        self._last_health_trigger = 0.0

    def __call__(self) -> dict:
        if not self.controller.is_leader():
            return {"skipped": "standby controller does not actuate"}
        report = {"ticked": self.rebalancer.tick()}
        try:
            report["auto"] = self._auto_triggers()
        except Exception as e:
            report["auto"] = f"{type(e).__name__}: {e}"
        try:
            report["health"] = self._health_loop()
        except Exception as e:
            report["health"] = f"{type(e).__name__}: {e}"
        return report

    # -- membership-driven triggers ------------------------------------------
    def _auto_triggers(self) -> dict:
        live = set(self.controller.live_instances())
        if self._seen_servers is None:
            # fresh actuator (controller restart/failover): baseline from
            # the durable last-seen set, so servers added DURING the outage
            # still fire a server-add spread on the first leader tick —
            # only the very first actuator in a cluster's life has nothing
            # to compare against
            stored = self.store.get(SEEN_SERVERS_PATH)
            self._seen_servers = set(stored) if stored is not None else None
        added = set() if self._seen_servers is None \
            else live - self._seen_servers
        self._seen_servers = live
        if self.store.get(SEEN_SERVERS_PATH) != sorted(live):
            self.store.set(SEEN_SERVERS_PATH, sorted(live))
        out: dict[str, str] = {}
        for nwt in self.store.children("/CONFIGS/TABLE"):
            job = self.rebalancer.job(nwt)
            if job and job.get("status") in ACTIVE_STATUSES:
                continue
            ideal = self.store.get(f"/IDEALSTATES/{nwt}") or {}
            if not ideal:
                continue
            cfg = self.controller.table_config(nwt) or {}
            replication = int(cfg.get("replication", 1))
            dead_refs = any(
                sum(1 for i in m if i in live) < min(replication, len(m))
                for m in ideal.values())
            trigger = None
            if dead_refs and len(live) >= replication:
                trigger = "dead-server"
            elif added:
                try:
                    dry = self.rebalancer.plan(nwt, dry_run=True,
                                               trigger="server-add")
                except (RebalanceInProgress, RuntimeError, KeyError):
                    dry = None
                if dry and dry.get("segmentsTotal", 0) > 0:
                    trigger = "server-add"
            if trigger is None:
                continue
            try:
                job = self.rebalancer.plan(nwt, trigger=trigger)
            except (RebalanceInProgress, RuntimeError) as e:
                out[nwt] = f"skipped: {e}"
                continue
            if job and job.get("status") == IN_PROGRESS:
                out[nwt] = f"{trigger}:{job['jobId']}"
        return out

    # -- health-driven drain -------------------------------------------------
    def _health_loop(self) -> dict:
        if not self.health_rebalance:
            return {"enabled": False}
        from .periodic import HEALTH_REPORT_PATH

        snap = self.store.get(HEALTH_REPORT_PATH) or {}
        checked = int(snap.get("checkedAtMs", 0))
        out: dict = {"enabled": True, "triggered": {}}
        if checked <= self._last_health_checked_ms:
            return out  # same scrape as last tick: no new evidence
        self._last_health_checked_ms = checked
        hysteresis, cooldown_s = self.hysteresis, self.cooldown_s
        flagged = {a.get("instance") for a in snap.get("anomalies", ())
                   if a.get("type") in ("straggler", "hbm-pressure")
                   and a.get("instance")}
        for inst in list(self._anomaly_streak):
            if inst not in flagged:
                del self._anomaly_streak[inst]
        for inst in flagged:
            self._anomaly_streak[inst] = self._anomaly_streak.get(inst, 0) + 1
        out["streaks"] = dict(self._anomaly_streak)
        if time.monotonic() - self._last_health_trigger < cooldown_s \
                and self._last_health_trigger > 0:
            out["cooldown"] = True
            return out
        ripe = sorted(i for i, n in self._anomaly_streak.items()
                      if n >= hysteresis)
        if not ripe:
            return out
        victim = ripe[0]  # one drain at a time — the opposite of flapping
        live = set(self.controller.live_instances())
        for nwt in self.store.children("/CONFIGS/TABLE"):
            ideal = self.store.get(f"/IDEALSTATES/{nwt}") or {}
            if not any(victim in m for m in ideal.values()):
                continue
            cfg = self.controller.table_config(nwt) or {}
            if len(live - {victim}) < int(cfg.get("replication", 1)):
                continue  # draining would break replication: refuse
            job = self.rebalancer.job(nwt)
            if job and job.get("status") in ACTIVE_STATUSES:
                continue
            try:
                planned = self.rebalancer.plan(
                    nwt, trigger="health", exclude=frozenset({victim}))
            except (RebalanceInProgress, RuntimeError):
                continue
            if planned and planned.get("status") == IN_PROGRESS:
                out["triggered"][nwt] = planned["jobId"]
        if out["triggered"]:
            self._last_health_trigger = time.monotonic()
            self._anomaly_streak.pop(victim, None)
        return out
