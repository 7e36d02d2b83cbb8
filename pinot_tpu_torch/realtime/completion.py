"""Controller-side segment completion FSM with committer election (the
port of pinot_tpu/realtime/completion.py).

Reference: SegmentCompletionManager (pinot-controller/.../helix/core/
realtime/SegmentCompletionManager.java:53) + SegmentCompletionFSM: replica
consumers that reach their end criteria call ``segmentConsumed``; the
controller collects offsets, elects ONE committer (the replica at the
largest reported offset - others are told to CATCHUP to it), and walks the
segment through HOLDING -> COMMITTER_DECIDED -> COMMITTER_UPLOADING ->
COMMITTED. The committer builds + uploads and calls ``segmentCommitEnd``;
the controller then writes the segment metadata (the DONE record) as one
store transaction. Losing replicas are told to DISCARD and download the
committed build instead of their own.

Failure handling mirrors the reference's lease model: the elected committer
holds a commit lease; if it dies between election and ``segmentCommitEnd``,
the lease expires and the next replica to poll ``segmentConsumed`` is
re-elected (reference: COMMITTER_NOTIFIED timeout -> pick a new committer).

The FSM state lives in this manager; the *commit record* lives in the
property store under ``/SEGMENTS/{table}/{segment}`` so every replica (and
the broker/controller) observes the same committed metadata - the ZK write
in the reference.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Optional

from ..cache.results import bump_lineage_epoch

# FSM states (reference SegmentCompletionFSM.State)
HOLDING = "HOLDING"
COMMITTER_DECIDED = "COMMITTER_DECIDED"
COMMITTER_UPLOADING = "COMMITTER_UPLOADING"
COMMITTED = "COMMITTED"

# protocol responses (reference SegmentCompletionProtocol.ControllerResponseStatus)
HOLD = "HOLD"
CATCHUP = "CATCHUP"
COMMIT = "COMMIT"
DISCARD = "DISCARD"
CONTINUE = "COMMIT_CONTINUE"
COMMIT_SUCCESS = "COMMIT_SUCCESS"
FAILED = "FAILED"


@dataclass
class CompletionResponse:
    status: str
    offset: Optional[int] = None  # target end offset for CATCHUP/COMMIT
    location: Optional[str] = None  # committed build for DISCARD downloads


@dataclass
class _Fsm:
    state: str = HOLDING
    votes: dict = field(default_factory=dict)  # instance -> max reported offset
    committer: Optional[str] = None
    target_offset: Optional[int] = None
    lease_deadline: float = 0.0
    first_vote_at: float = 0.0


class SegmentCompletionManager:
    """One controller-side manager for all in-flight consuming segments."""

    def __init__(self, store, num_replicas: int = 1,
                 commit_lease_s: float = 10.0, decision_wait_s: float = 2.0):
        self.store = store
        self.num_replicas = num_replicas
        self.commit_lease_s = commit_lease_s
        self.decision_wait_s = decision_wait_s
        self._fsms: dict[tuple[str, str], _Fsm] = {}
        self._lock = threading.Lock()

    # -- server -> controller protocol --------------------------------------
    def segment_consumed(self, table: str, segment: str, instance: str,
                         offset: int) -> CompletionResponse:
        """A replica reached its end criteria at ``offset``. Returns HOLD,
        CATCHUP(target), COMMIT(target), or DISCARD(location)."""
        with self._lock:
            fsm = self._fsms.get((table, segment))
            if fsm is None:
                # completed FSMs are pruned from memory (commit_end); the
                # store record is the durable answer for late replicas
                rec = self.store.get(f"/SEGMENTS/{table}/{segment}")
                if rec is not None and rec.get("status") == "DONE":
                    return CompletionResponse(
                        DISCARD, offset=int(rec["endOffset"]),
                        location=rec.get("location"))
                fsm = self._fsms.setdefault((table, segment), _Fsm())
            now = time.monotonic()
            if not fsm.votes:
                fsm.first_vote_at = now
            fsm.votes[instance] = max(offset, fsm.votes.get(instance, offset))

            if fsm.state == HOLDING:
                quorum = len(fsm.votes) >= self.num_replicas
                waited = now - fsm.first_vote_at >= self.decision_wait_s
                if not (quorum or waited):
                    return CompletionResponse(HOLD)
                # elect: the replica at the largest offset commits; ties
                # break on report order (dict preserves insertion)
                fsm.target_offset = max(fsm.votes.values())
                fsm.committer = next(i for i, o in fsm.votes.items()
                                     if o == fsm.target_offset)
                fsm.state = COMMITTER_DECIDED
                fsm.lease_deadline = now + self.commit_lease_s

            # COMMITTER_DECIDED / COMMITTER_UPLOADING
            if now > fsm.lease_deadline:
                # committer died mid-commit: re-elect the polling replica
                # (reference: FSM timeout -> new committer). The target moves
                # up if the new committer consumed past the old target (a
                # late voter that was HOLDing above it) - committing its
                # superset is correct, spinning on an unreachable target is
                # not.
                fsm.committer = instance
                fsm.target_offset = max(fsm.target_offset, offset)
                fsm.state = COMMITTER_DECIDED
                fsm.lease_deadline = now + self.commit_lease_s
            if instance == fsm.committer:
                if offset < fsm.target_offset:
                    return CompletionResponse(CATCHUP, offset=fsm.target_offset)
                return CompletionResponse(COMMIT, offset=fsm.target_offset)
            if offset < fsm.target_offset:
                return CompletionResponse(CATCHUP, offset=fsm.target_offset)
            return CompletionResponse(HOLD)

    def segment_commit_start(self, table: str, segment: str, instance: str,
                             offset: int) -> CompletionResponse:
        """Committer announces the build is starting (renews the lease)."""
        with self._lock:
            fsm = self._fsms.get((table, segment))
            if fsm is None or fsm.state == COMMITTED:
                return CompletionResponse(FAILED)
            if instance != fsm.committer or offset != fsm.target_offset:
                return CompletionResponse(FAILED)
            fsm.state = COMMITTER_UPLOADING
            fsm.lease_deadline = time.monotonic() + self.commit_lease_s
            return CompletionResponse(CONTINUE, offset=fsm.target_offset)

    def extend_build_time(self, table: str, segment: str, instance: str,
                          extra_s: float) -> bool:
        """Reference: extendBuildTime - a slow build renews its lease."""
        with self._lock:
            fsm = self._fsms.get((table, segment))
            if fsm is None or fsm.committer != instance:
                return False
            fsm.lease_deadline = time.monotonic() + extra_s
            return True

    def segment_commit_end(self, table: str, segment: str, instance: str,
                           offset: int, location: str,
                           metadata: Optional[dict] = None) -> CompletionResponse:
        """Committer uploaded the build; write the DONE record. Exactly one
        caller can succeed - a re-elected committer racing the 'dead' one is
        resolved here by the committer check under the lock."""
        with self._lock:
            fsm = self._fsms.get((table, segment))
            if fsm is None or fsm.state == COMMITTED:
                # idempotent across controller failover: if the previous
                # leader durably wrote THIS committer's DONE record but died
                # before acking, the retried commit_end on the new leader
                # (which has no FSM) must succeed, not fail - the outcome is
                # decided by the store record, not by in-memory state
                rec = self.store.get(f"/SEGMENTS/{table}/{segment}")
                if (rec is not None and rec.get("status") == "DONE"
                        and rec.get("committer") == instance
                        and int(rec.get("endOffset", -1)) == offset):
                    return CompletionResponse(COMMIT_SUCCESS, offset=offset,
                                              location=rec.get("location"))
                return CompletionResponse(FAILED)
            if instance != fsm.committer or offset != fsm.target_offset:
                return CompletionResponse(FAILED)
            record = dict(metadata or {}, segmentName=segment,
                          location=location, endOffset=str(offset),
                          status="DONE", committer=instance,
                          commitTimeMs=int(time.time() * 1000))
            self.store.set(f"/SEGMENTS/{table}/{segment}", record)
            # a realtime commit changes the table's served content: bump
            # the lineage epoch so broker result-cache entries keyed on the
            # old epoch become unreachable (cache/results.py)
            bump_lineage_epoch(self.store, table)
            # prune: the store DONE record (checked first in
            # segment_consumed/fsm_state) answers late polls; keeping every
            # finished FSM would leak for the life of the controller
            self._fsms.pop((table, segment), None)
            return CompletionResponse(COMMIT_SUCCESS, offset=fsm.target_offset,
                                      location=location)

    # -- introspection ------------------------------------------------------
    def fsm_state(self, table: str, segment: str) -> Optional[str]:
        with self._lock:
            fsm = self._fsms.get((table, segment))
            if fsm is not None:
                return fsm.state
        rec = self.store.get(f"/SEGMENTS/{table}/{segment}")
        if rec is not None and rec.get("status") == "DONE":
            return COMMITTED
        return None

    def committed_record(self, table: str, segment: str) -> Optional[dict]:
        return self.store.get(f"/SEGMENTS/{table}/{segment}")


class NoControllerLeaderError(Exception):
    """No controller currently holds the leader seat (or the leader is not
    resolvable to a live controller). Completion clients retry with capped
    backoff - consumers HOLD through a controller outage, never ERROR."""


class LeaderCompletionClient:
    """Server-side completion stub that routes every protocol call to
    whichever controller currently leads.

    Reference: ServerSegmentCompletionProtocolHandler resolves the lead
    controller per request (LeadControllerManager on the server side) and
    raises/retries when no leader is up. ``resolver`` maps a leader
    instance id to its live ``ClusterController`` (None when that
    controller is dead - e.g. killed before its ephemeral leader entry
    expired), standing in for the HTTP hop to the leader's REST port."""

    def __init__(self, store, resolver):
        self.store = store
        self.resolver = resolver

    def _manager(self):
        # the cluster package imports the engine, which imports the
        # realtime package: the leader path is imported on use
        from ..cluster.leader import LEADER_PATH

        cur = self.store.get(LEADER_PATH)
        if not isinstance(cur, dict) or not cur.get("instance"):
            raise NoControllerLeaderError("no controller leader claimed")
        inst = cur["instance"]
        controller = self.resolver(inst)
        if controller is None:
            raise NoControllerLeaderError(f"leader {inst} not reachable")
        mgr = controller.completion_manager()
        if mgr is None:
            raise NoControllerLeaderError(f"{inst} lost leadership")
        return mgr

    def segment_consumed(self, *args, **kw) -> CompletionResponse:
        return self._manager().segment_consumed(*args, **kw)

    def segment_commit_start(self, *args, **kw) -> CompletionResponse:
        return self._manager().segment_commit_start(*args, **kw)

    def extend_build_time(self, *args, **kw) -> bool:
        return self._manager().extend_build_time(*args, **kw)

    def segment_commit_end(self, *args, **kw) -> CompletionResponse:
        return self._manager().segment_commit_end(*args, **kw)
