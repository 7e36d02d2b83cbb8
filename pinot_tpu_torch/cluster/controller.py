"""Cluster controller: table/segment lifecycle + assignment + rebalance.

The port of pinot_tpu/cluster/controller.py: table names with type,
schemas, tables, segment add/drop with replica-group and instance-partition
assignment, the two-phase rebalance and tier relocation (the durable
engine over them is rebalance.py), retention, and the leader-hosted
realtime segment completion manager (realtime/completion.py). Segment add,
drop and replace bump the table's lineage epoch (cache/results.py), which
keys the broker's result cache.

Reference analogue: PinotHelixResourceManager (pinot-controller/.../helix/
core/PinotHelixResourceManager.java, 4.6K LoC — create/delete tables, add
segments, ideal-state updates, instance management), segment assignment
strategies (.../helix/core/assignment/segment/BaseSegmentAssignment.java),
TableRebalancer (.../helix/core/rebalance/TableRebalancer.java) and
RetentionManager (.../helix/core/retention/).

State layout in the property store (ZK-analogue paths):
  /CONFIGS/TABLE/{tableNameWithType}   table config JSON
  /SCHEMAS/{rawName}                   schema JSON
  /IDEALSTATES/{tableNameWithType}     {segment: {instance: state}}
  /EXTERNALVIEW/{tableNameWithType}    same shape, written by servers
  /LIVEINSTANCES/{instanceId}          ephemeral {host, port}
  /INSTANCECONFIGS/{instanceId}        {host, port, tags}
  /SEGMENTS/{tableNameWithType}/{seg}  segment metadata (location, docs, time range)
"""

from __future__ import annotations

import threading
import time
from typing import Optional

from ..cache.results import bump_lineage_epoch
from ..spi.metrics import CONTROLLER_METRICS, ControllerMeter
from .leader import LeadControllerManager
from .store import PropertyStore

ONLINE = "ONLINE"
OFFLINE = "OFFLINE"
CONSUMING = "CONSUMING"
# external-view-only state: the replica failed integrity verification and
# is quarantined — never advertised ONLINE, excluded from broker routing
# (reference: Helix ERROR state on a failed state transition)
ERROR = "ERROR"


def table_name_with_type(name: str, table_type: str = "OFFLINE") -> str:
    if name.endswith("_OFFLINE") or name.endswith("_REALTIME"):
        return name
    return f"{name}_{table_type}"


def raw_table_name(name_with_type: str) -> str:
    for suffix in ("_OFFLINE", "_REALTIME"):
        if name_with_type.endswith(suffix):
            return name_with_type[: -len(suffix)]
    return name_with_type


class ClusterController:
    """``instance_id=None`` (the default) keeps the single-controller mode:
    no election, every helper available. With an ``instance_id`` the
    controller joins the leader election (cluster/leader.py) and hosts the
    realtime SegmentCompletionManager only while it leads: the Helix
    arrangement where exactly one controller owns segment completion.
    ``completion_config`` holds the manager's keyword arguments
    (num_replicas, commit_lease_s, decision_wait_s)."""

    def __init__(self, store: PropertyStore,
                 instance_id: Optional[str] = None,
                 completion_config: Optional[dict] = None):
        self.store = store
        self.instance_id = instance_id
        self.completion_config = completion_config or {}
        self._completion = None
        self._completion_lock = threading.Lock()
        self.leader: Optional[LeadControllerManager] = None
        if instance_id is not None:
            self.leader = LeadControllerManager(
                store, instance_id, on_change=self._on_leadership)
            self.leader.start()

    # -- leadership / completion hosting ------------------------------------
    def _on_leadership(self, is_leader: bool) -> None:
        CONTROLLER_METRICS.add_meter(ControllerMeter.LEADER_CHANGES)
        if not is_leader:
            # drop the hosted completion manager: its in-memory FSMs belong
            # to the seat, not the process. The next leader starts clean:
            # replicas re-poll, the lease model re-elects, and the durable
            # DONE record keeps already-committed segments idempotent.
            with self._completion_lock:
                self._completion = None

    def is_leader(self) -> bool:
        return self.leader is None or self.leader.is_leader

    def completion_manager(self):
        """The leader-hosted SegmentCompletionManager; None while this
        controller is not the leader (callers hold and retry)."""
        if not self.is_leader():
            return None
        with self._completion_lock:
            if self._completion is None:
                # the realtime package imports the engine, which imports
                # this package: the completion manager is imported on use
                from ..realtime.completion import SegmentCompletionManager

                self._completion = SegmentCompletionManager(
                    self.store, **self.completion_config)
            return self._completion

    def stop(self) -> None:
        """Graceful shutdown: resign leadership (atomic delete_if) and drop
        hosted state. Crash-death is modeled by ``leader.disconnect()`` +
        ``store.expire_session`` instead."""
        if self.leader is not None:
            self.leader.stop()
        with self._completion_lock:
            self._completion = None

    # -- instances ---------------------------------------------------------
    def list_instances(self, tag: Optional[str] = None) -> list[str]:
        out = []
        for inst in self.store.children("/INSTANCECONFIGS"):
            cfg = self.store.get(f"/INSTANCECONFIGS/{inst}") or {}
            if tag is None or tag in cfg.get("tags", []):
                out.append(inst)
        return out

    def live_instances(self) -> list[str]:
        return self.store.children("/LIVEINSTANCES")

    def server_instances(self, tag: Optional[str] = None) -> list[str]:
        """Segment-hosting candidates: registered instances that are
        servers. Minions/brokers register with an explicit non-SERVER type
        and must never be assigned segments (reference: Helix instance
        tags — segments go to server-tenant-tagged instances only)."""
        out = []
        for inst in self.list_instances(tag):
            cfg = self.store.get(f"/INSTANCECONFIGS/{inst}") or {}
            if cfg.get("type", "SERVER") == "SERVER":
                out.append(inst)
        return out

    # -- schemas / tables ---------------------------------------------------
    def add_schema(self, schema_json: dict) -> None:
        self.store.set(f"/SCHEMAS/{schema_json['schemaName']}", schema_json)

    def create_table(self, table_config: dict) -> str:
        """table_config needs at least tableName; optional tableType
        (OFFLINE default), replication (1), serverTag, timeColumn,
        retentionDays."""
        name = table_name_with_type(table_config["tableName"],
                                    table_config.get("tableType", "OFFLINE"))
        table_config = dict(table_config, tableNameWithType=name)
        self.store.set(f"/CONFIGS/TABLE/{name}", table_config)
        if self.store.get(f"/IDEALSTATES/{name}") is None:
            self.store.set(f"/IDEALSTATES/{name}", {})
        return name

    def drop_table(self, name_with_type: str) -> None:
        for seg in self.store.children(f"/SEGMENTS/{name_with_type}"):
            self.store.delete(f"/SEGMENTS/{name_with_type}/{seg}")
        self.store.delete(f"/IDEALSTATES/{name_with_type}")
        self.store.delete(f"/CONFIGS/TABLE/{name_with_type}")

    def table_config(self, name_with_type: str) -> Optional[dict]:
        return self.store.get(f"/CONFIGS/TABLE/{name_with_type}")

    # -- segments -----------------------------------------------------------
    def add_segment(self, name_with_type: str, segment_name: str,
                    metadata: dict) -> list[str]:
        """metadata: {location: dir path (deep-store address), numDocs,
        startTimeMs?, endTimeMs?, crc?}. Assigns replicas and updates the
        ideal state; servers converge and load. Returns assigned instances."""
        cfg = self.table_config(name_with_type)
        if cfg is None:
            raise KeyError(f"table {name_with_type} not found")
        metadata = dict(metadata, segmentName=segment_name,
                        pushTimeMs=int(time.time() * 1000))
        self.store.set(f"/SEGMENTS/{name_with_type}/{segment_name}", metadata)
        assigned = self._assign_segment(cfg, metadata)
        state = CONSUMING if metadata.get("consuming") else ONLINE

        def upd(ideal):
            ideal = ideal or {}
            ideal[segment_name] = {inst: state for inst in assigned}
            return ideal

        self.store.update(f"/IDEALSTATES/{name_with_type}", upd)
        # lineage epoch bump (cache/results.py): every upload/refresh makes
        # broker result-cache entries for this table unreachable
        bump_lineage_epoch(self.store, name_with_type)
        return assigned

    def drop_segment(self, name_with_type: str, segment_name: str) -> None:
        def upd(ideal):
            ideal = ideal or {}
            ideal.pop(segment_name, None)
            return ideal

        self.store.update(f"/IDEALSTATES/{name_with_type}", upd)
        self.store.delete(f"/SEGMENTS/{name_with_type}/{segment_name}")
        bump_lineage_epoch(self.store, name_with_type)

    def segment_metadata(self, name_with_type: str, segment_name: str) -> Optional[dict]:
        return self.store.get(f"/SEGMENTS/{name_with_type}/{segment_name}")

    # -- instance partitions (replica groups) --------------------------------
    def configure_instance_partitions(self, name_with_type: str,
                                      num_replica_groups: int,
                                      instances_per_group: Optional[int] = None,
                                      num_partitions: Optional[int] = None) -> dict:
        """Partition the table's eligible instances into replica groups
        (reference: InstanceAssignmentDriver +
        InstanceReplicaGroupPartitionSelector — each replica of a segment
        lands in a DISTINCT group, so one group can serve a full copy of
        the table and queries fan out within a single group). Selection is
        deterministic (sorted instances, round-robin into groups) so
        re-running after membership changes moves as little as possible."""
        cfg = self.table_config(name_with_type)
        if cfg is None:
            raise KeyError(name_with_type)
        candidates = sorted(set(self.server_instances(cfg.get("serverTag")))
                            & set(self.live_instances()))
        per_group = instances_per_group or len(candidates) // num_replica_groups
        need = num_replica_groups * per_group
        if per_group < 1 or len(candidates) < need:
            raise RuntimeError(
                f"need {num_replica_groups}x{per_group} instances, "
                f"have {candidates}")
        # sticky re-run: instances keep their previous group when still
        # eligible, so new capacity fills gaps instead of reshuffling
        # whole groups (and the follow-up rebalance moves the minimum)
        prev = (self.instance_partitions(name_with_type)
                or {}).get("replicaGroups", [])
        eligible = set(candidates)
        groups: list[list] = []
        taken: set = set()
        for g in range(num_replica_groups):
            kept = [i for i in (prev[g] if g < len(prev) else [])
                    if i in eligible and i not in taken][:per_group]
            groups.append(kept)
            taken.update(kept)
        pool = [i for i in candidates if i not in taken]
        for g in range(num_replica_groups):
            while len(groups[g]) < per_group:
                groups[g].append(pool.pop(0))
        record = {"replicaGroups": groups}
        if num_partitions:
            record["numPartitions"] = int(num_partitions)
        self.store.set(f"/INSTANCEPARTITIONS/{name_with_type}", record)
        return record

    def instance_partitions(self, name_with_type: str) -> Optional[dict]:
        return self.store.get(f"/INSTANCEPARTITIONS/{name_with_type}")

    @staticmethod
    def _segment_partition_id(metadata: Optional[dict]) -> Optional[int]:
        """First stamped partition id on the segment's push metadata."""
        for info in ((metadata or {}).get("partitions") or {}).values():
            parts = info.get("partitions") if isinstance(info, dict) else None
            if parts:
                return int(parts[0])
        return None

    # -- assignment ---------------------------------------------------------
    def _assign_segment(self, cfg: dict,
                        metadata: Optional[dict] = None) -> list[str]:
        """Replica-group assignment when instance partitions are configured
        (one instance from EACH group — partition-stamped segments pin to
        group member p % group_size, reference
        BaseSegmentAssignment.assignSegment replica-group path); otherwise
        balanced least-loaded assignment
        (BalancedNumSegmentAssignmentStrategy)."""
        name = cfg["tableNameWithType"]
        ideal = self.store.get(f"/IDEALSTATES/{name}") or {}
        ip = self.instance_partitions(name)
        if ip:
            live = set(self.live_instances())
            load = {}
            for seg_map in ideal.values():
                for inst in seg_map:
                    load[inst] = load.get(inst, 0) + 1
            pid = self._segment_partition_id(metadata)
            out = []
            for group in ip["replicaGroups"]:
                members = [i for i in group if i in live]
                if not members:
                    raise RuntimeError(f"replica group {group} has no live "
                                       f"members for {name}")
                if pid is not None:
                    out.append(members[pid % len(members)])
                else:
                    out.append(min(members,
                                   key=lambda i: (load.get(i, 0), i)))
            return out
        replication = int(cfg.get("replication", 1))
        tag = cfg.get("serverTag")
        candidates = [i for i in self.server_instances(tag)
                      if i in set(self.live_instances())]
        if len(candidates) < replication:
            raise RuntimeError(
                f"not enough live servers: need {replication}, have {candidates}")
        load = {i: 0 for i in candidates}
        for seg_map in ideal.values():
            for inst in seg_map:
                if inst in load:
                    load[inst] += 1
        return sorted(candidates, key=lambda i: (load[i], i))[:replication]

    # -- rebalance ----------------------------------------------------------
    def _rebalance_target(self, name_with_type: str, cfg: dict,
                          ideal: dict) -> tuple[dict, int]:
        """Minimal-movement balanced target (replica-group aware when
        instance partitions are configured)."""
        ip = self.instance_partitions(name_with_type)
        if ip:
            live = set(self.live_instances())
            target: dict[str, dict] = {}
            moves = 0
            load: dict[str, int] = {}
            for seg in sorted(ideal):
                pid = self._segment_partition_id(
                    self.segment_metadata(name_with_type, seg))
                current = set(ideal[seg])
                chosen = []
                for group in ip["replicaGroups"]:
                    members = [i for i in group if i in live]
                    if not members:
                        raise RuntimeError(
                            f"replica group {group} has no live members")
                    if pid is not None:
                        pick = members[pid % len(members)]
                    else:
                        # keep the current in-group replica when possible
                        keep = [i for i in members if i in current]
                        pick = keep[0] if keep else min(
                            members, key=lambda i: (load.get(i, 0), i))
                    chosen.append(pick)
                    load[pick] = load.get(pick, 0) + 1
                moves += len(set(chosen) - current)
                # preserve the segment's state (a moved CONSUMING replica
                # must re-enter as CONSUMING, not as a deep-store load)
                state = CONSUMING if CONSUMING in ideal[seg].values() else ONLINE
                target[seg] = {i: state for i in chosen}
            return target, moves

        replication = int(cfg.get("replication", 1))
        candidates = sorted(set(self.server_instances(cfg.get("serverTag")))
                            & set(self.live_instances()))
        if len(candidates) < replication:
            raise RuntimeError("not enough live servers to rebalance")
        load = {i: 0 for i in candidates}
        target = {}
        moves = 0
        for seg in sorted(ideal):
            keep = [i for i in ideal[seg] if i in candidates][:replication]
            target[seg] = {i: ideal[seg][i] for i in keep}
            for i in keep:
                load[i] += 1
        for seg in sorted(ideal):
            state = CONSUMING if CONSUMING in ideal[seg].values() else ONLINE
            while len(target[seg]) < replication:
                pick = min((i for i in candidates if i not in target[seg]),
                           key=lambda i: (load[i], i))
                target[seg][pick] = state
                load[pick] += 1
                moves += 1
        # level loads: move replicas from the most- to the least-loaded host
        # until spread ≤ 1 (balanced target, minimal movement)
        for _ in range(len(ideal) * replication):
            hi = max(candidates, key=lambda i: (load[i], i))
            lo = min(candidates, key=lambda i: (load[i], i))
            if load[hi] - load[lo] <= 1:
                break
            movable = next((s for s in sorted(ideal)
                            if hi in target[s] and lo not in target[s]), None)
            if movable is None:
                break
            target[movable][lo] = target[movable].pop(hi)
            load[hi] -= 1
            load[lo] += 1
            moves += 1
        return target, moves

    def rebalance(self, name_with_type: str, dry_run: bool = False,
                  min_available_replicas: int = 1,
                  ev_timeout_s: float = 30.0,
                  include_consuming: bool = False) -> dict:
        """Safe rebalance (reference: TableRebalancer.rebalance —
        .../helix/core/rebalance/TableRebalancer.java): compute a
        minimal-movement target, then converge the ideal state in TWO
        phases per changed segment — first ADD the target replicas
        (ideal = current ∪ target) and wait for the external view to show
        every target replica ONLINE, only then REMOVE the departing ones.
        A segment's routable replica count therefore never drops below
        min(current availability, min_available_replicas) at any point:
        queries keep succeeding throughout the move. Progress is tracked
        in the store (/REBALANCE/{table}) like the reference's
        ZK-persisted rebalance job context."""
        cfg = self.table_config(name_with_type)
        if cfg is None:
            raise KeyError(name_with_type)
        self._check_upsert_movable(name_with_type, cfg)
        ideal = self.store.get(f"/IDEALSTATES/{name_with_type}") or {}
        # CONSUMING segments sit out by default (reference: rebalance
        # includeConsuming=false) — moving an active consumer means
        # restarting consumption on the new host
        frozen = {} if include_consuming else {
            s: m for s, m in ideal.items() if CONSUMING in m.values()}
        movable = {s: m for s, m in ideal.items() if s not in frozen}
        target, moves = self._rebalance_target(name_with_type, cfg, movable)
        target.update({s: dict(m) for s, m in frozen.items()})
        changed = [s for s in sorted(ideal)
                   if set(target.get(s, {})) != set(ideal[s])]
        result = {"table": name_with_type, "moves": moves, "target": target,
                  "segments_changed": len(changed)}
        if dry_run:
            return result
        return dict(result, **self._apply_target_safely(
            name_with_type, target, changed, min_available_replicas,
            ev_timeout_s, moves))

    def _apply_target_safely(self, name_with_type: str, target: dict,
                             changed: list, min_available_replicas: int,
                             ev_timeout_s: float, moves: int) -> dict:
        """Two-phase ideal-state convergence shared by rebalance and the
        tier relocator: ADD target replicas, wait for the external view,
        then REMOVE departing ones — availability never dips."""
        for seg in target:
            if len(target[seg]) < min_available_replicas:
                raise RuntimeError(
                    f"target for {seg} has {len(target[seg])} replicas "
                    f"< minAvailableReplicas={min_available_replicas}")

        job_id = f"rb_{int(time.time() * 1000)}"
        job_path = f"/REBALANCE/{name_with_type}"
        # the durable rebalance engine (cluster/rebalance.py) journals its
        # move plan at this same path: overwriting an active engine job
        # would orphan its in-flight moves (leaked ADDING replicas, lost
        # crash-resume state) while both engines mutate the ideal state
        existing = self.store.get(job_path)
        if existing and existing.get("status") in ("IN_PROGRESS",
                                                   "ABORTING") \
                and "movePlan" in existing:
            raise RuntimeError(
                f"{name_with_type}: durable rebalance job "
                f"{existing.get('jobId')} is {existing.get('status')}; "
                "wait for the actuator to finish it or abort it first")
        job = {"jobId": job_id, "status": "IN_PROGRESS",
               "segmentsTotal": len(changed), "segmentsDone": 0,
               "moves": moves, "startedMs": int(time.time() * 1000)}
        self.store.set(job_path, job)
        if not changed:
            job["status"] = "DONE"
            self.store.set(job_path, job)
            return {"jobId": job_id, "status": "DONE"}

        # phase 1: additive union — nothing is ever removed here, so
        # availability only grows. Segments deleted concurrently (retention,
        # drop) are SKIPPED, not resurrected: the closures re-read current
        # membership under the store's atomic update.
        def add_union(cur):
            cur = cur or {}
            for seg in changed:
                if seg not in cur:
                    continue
                merged = dict(cur[seg])
                merged.update(target[seg])
                cur[seg] = merged
            return cur

        self.store.update(f"/IDEALSTATES/{name_with_type}", add_union)

        # wait: every ONLINE-target replica of every changed segment shows
        # ONLINE in the external view (CONSUMING replicas never report
        # ONLINE — their handoff is the realtime manager's job, not ours)
        def ev_wait_insts(seg):
            return [i for i, st in target[seg].items() if st == ONLINE]

        deadline = time.time() + ev_timeout_s
        pending = set(changed)
        while pending and time.time() < deadline:
            view = self.store.get(f"/EXTERNALVIEW/{name_with_type}") or {}
            ideal_now = self.store.get(f"/IDEALSTATES/{name_with_type}") or {}
            pending = {s for s in pending if s in ideal_now
                       and any((view.get(s) or {}).get(i) != ONLINE
                               for i in ev_wait_insts(s))}
            if pending:
                time.sleep(0.05)
        if pending:
            job["status"] = "STUCK"
            job["pending"] = sorted(pending)
            self.store.set(job_path, job)
            raise TimeoutError(
                f"rebalance {job_id}: replicas not ONLINE after "
                f"{ev_timeout_s}s: {sorted(pending)}")

        # phase 2: drop the departing replicas (targets are serving)
        def to_target(cur):
            cur = cur or {}
            for seg in changed:
                if seg in cur:
                    cur[seg] = dict(target[seg])
            return cur

        self.store.update(f"/IDEALSTATES/{name_with_type}", to_target)
        job.update(status="DONE", segmentsDone=len(changed),
                   finishedMs=int(time.time() * 1000))
        self.store.set(job_path, job)
        return {"jobId": job_id, "status": "DONE"}

    def rebalance_status(self, name_with_type: str) -> Optional[dict]:
        return self.store.get(f"/REBALANCE/{name_with_type}")

    def _check_upsert_movable(self, name_with_type: str, cfg: dict) -> None:
        """Upsert tables keep a per-server primary-key map: every segment
        of a pk partition must live on the same server or validity planes
        diverge. Moves are only safe under partition-pinned placement, so
        rebalance/relocation REFUSES without instance partitions
        (reference: TableRebalancer requires strict replica groups for
        upsert tables)."""
        mode = ((cfg.get("upsertConfig") or {}).get("mode") or "NONE").upper()
        if mode != "NONE" and not self.instance_partitions(name_with_type):
            raise RuntimeError(
                f"{name_with_type} is an upsert table: configure instance "
                "partitions (partition-pinned placement) before rebalancing "
                "so pk partitions stay colocated")

    # -- tiered storage ------------------------------------------------------
    @staticmethod
    def _parse_age_ms(age: str) -> int:
        """'7d' / '12h' / '30m' / bare ms (reference TierConfig segmentAge
        TimeUtils period format)."""
        age = str(age).strip().lower()
        mult = {"d": 86_400_000, "h": 3_600_000, "m": 60_000, "s": 1000}
        if age and age[-1] in mult:
            return int(float(age[:-1]) * mult[age[-1]])
        return int(age)

    def _tier_for_segment(self, cfg: dict, seg: str, meta: dict,
                          now_ms: int) -> Optional[dict]:
        """First matching tier config wins (reference TierConfigUtils
        ordering). Selectors: 'time' (segment end time older than
        segmentAge) and 'fixed' (explicit segment list)."""
        tiers = cfg.get("tierConfigs") or []
        # oldest-threshold tier first, so a segment past several thresholds
        # lands on the coldest matching tier (reference TierConfigUtils
        # comparator)
        def age_of(t):
            return self._parse_age_ms(t.get("segmentAge",
                                            t.get("segmentAgeMs", "0d")))

        for tier in sorted(tiers, key=lambda t: -age_of(t)):
            sel = str(tier.get("segmentSelectorType", "time")).lower()
            if sel == "fixed":
                if seg in (tier.get("segmentList") or []):
                    return tier
            else:
                end = meta.get("endTimeMs") or meta.get("pushTimeMs")
                if end is not None and now_ms - int(end) >= age_of(tier):
                    return tier
        return None

    def relocate_tiers(self, name_with_type: str, dry_run: bool = False,
                       now_ms: Optional[int] = None,
                       min_available_replicas: int = 1,
                       ev_timeout_s: float = 30.0) -> dict:
        """Move segments whose tier selector matches onto the tier's
        tagged servers (reference: SegmentRelocator — relocate ONLINE
        segments to tiers via a tier-aware rebalance, at most one replica
        unavailable). Uses the same safe two-phase apply as rebalance."""
        cfg = self.table_config(name_with_type)
        if cfg is None:
            raise KeyError(name_with_type)
        if not cfg.get("tierConfigs"):
            return {"table": name_with_type, "moves": 0, "status": "DONE"}
        self._check_upsert_movable(name_with_type, cfg)
        now_ms = now_ms or int(time.time() * 1000)
        replication = int(cfg.get("replication", 1))
        ideal = self.store.get(f"/IDEALSTATES/{name_with_type}") or {}
        live = set(self.live_instances())
        load: dict[str, int] = {}
        for seg_map in ideal.values():
            for inst in seg_map:
                load[inst] = load.get(inst, 0) + 1
        target: dict[str, dict] = {}
        tiers_of: dict[str, Optional[str]] = {}
        moves = 0
        for seg in sorted(ideal):
            if CONSUMING in ideal[seg].values():
                target[seg] = dict(ideal[seg])
                continue
            meta = self.segment_metadata(name_with_type, seg) or {}
            tier = self._tier_for_segment(cfg, seg, meta, now_ms)
            tag = (tier or {}).get("serverTag") or cfg.get("serverTag")
            tiers_of[seg] = (tier or {}).get("name")
            candidates = [i for i in self.server_instances(tag) if i in live]
            if len(candidates) < replication:
                raise RuntimeError(
                    f"tier {tag!r} has {len(candidates)} live servers, "
                    f"need {replication} for {seg}")
            keep = [i for i in ideal[seg] if i in candidates][:replication]
            chosen = list(keep)
            while len(chosen) < replication:
                pick = min((i for i in candidates if i not in chosen),
                           key=lambda i: (load.get(i, 0), i))
                chosen.append(pick)
                load[pick] = load.get(pick, 0) + 1
                moves += 1
            target[seg] = {i: ONLINE for i in chosen}
        changed = [s for s in sorted(ideal)
                   if set(target.get(s, {})) != set(ideal[s])]
        result = {"table": name_with_type, "moves": moves,
                  "segments_changed": len(changed), "tiers": tiers_of,
                  "target": target}
        if dry_run:
            return result
        return dict(result, **self._apply_target_safely(
            name_with_type, target, changed, min_available_replicas,
            ev_timeout_s, moves))

    # -- retention ----------------------------------------------------------
    def run_retention(self, now_ms: Optional[int] = None) -> list[str]:
        """Drop segments past the table's retentionDays (reference:
        RetentionManager periodic task)."""
        now_ms = now_ms or int(time.time() * 1000)
        dropped = []
        for table in self.store.children("/CONFIGS/TABLE"):
            cfg = self.table_config(table) or {}
            days = cfg.get("retentionDays")
            if not days:
                continue
            cutoff = now_ms - int(days) * 86_400_000
            for seg in self.store.children(f"/SEGMENTS/{table}"):
                meta = self.segment_metadata(table, seg) or {}
                end = meta.get("endTimeMs")
                if end is not None and end < cutoff:
                    self.drop_segment(table, seg)
                    dropped.append(f"{table}/{seg}")
        return dropped
