"""Query scheduler + resource accounting + query killing.

The port's copy of pinot_tpu/engine/scheduler.py, whole.

Reference analogues:
- QueryScheduler.submit (pinot-core/.../query/scheduler/QueryScheduler.java
  :93) with FCFS and token-bucket priority policies
  (MultiLevelPriorityQueue), picked by QuerySchedulerFactory.
- PerQueryCPUMemResourceUsageAccountant (pinot-core/.../accounting/
  PerQueryCPUMemAccountantFactory.java:70): samples per-query resource
  usage and interrupts the most expensive query under pressure (:832-937).

Cooperative cancellation: Python threads can't be interrupted, so queries
check their kill flag between segments (`check_cancel` from
QueryExecutor's segment loop) — the same effective granularity as the
reference, which also only interrupts between operator blocks.
"""

from __future__ import annotations

import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Callable, Optional

from ..spi.metrics import SERVER_METRICS, ServerMeter, ServerTimer


class QueryKilledError(Exception):
    """Reference: QueryCancelledException from the accountant interrupt."""


class QueryRejectedError(Exception):
    """Admission control rejection (scheduler queue full)."""


@dataclass
class QueryResourceTracker:
    query_id: str
    scheduler_group: str = "default"
    start_time: float = field(default_factory=time.perf_counter)
    cpu_ns: int = 0
    allocated_bytes: int = 0
    _kill_reason: Optional[str] = None

    def add_cpu_ns(self, ns: int) -> None:
        self.cpu_ns += ns

    def add_allocated_bytes(self, n: int) -> None:
        self.allocated_bytes += n

    def kill(self, reason: str) -> None:
        self._kill_reason = reason

    def check_cancel(self) -> None:
        if self._kill_reason is not None:
            SERVER_METRICS.add_meter(ServerMeter.QUERIES_KILLED)
            raise QueryKilledError(self._kill_reason)

    @property
    def cost(self) -> int:
        """Ranking for the kill heuristic (reference ranks by allocated
        bytes, falling back to CPU time)."""
        return self.allocated_bytes or self.cpu_ns


class ResourceAccountant:
    """Tracks in-flight queries; kills the most expensive one when the
    memory budget is exceeded (reference: the watcher task heap-pressure
    path). Budget is an explicit byte budget for query intermediates —
    there is no JVM heap to watch."""

    def __init__(self, memory_budget_bytes: Optional[int] = None,
                 tombstone_ttl_s: float = 10.0):
        self.memory_budget_bytes = memory_budget_bytes
        self.tombstone_ttl_s = tombstone_ttl_s
        self._lock = threading.Lock()
        self._inflight: dict[str, QueryResourceTracker] = {}
        # cancel-before-register race: a cancel that arrives before the
        # query registers leaves a short-TTL tombstone — id (or shard-id
        # prefix) → (reason, expiry, is_prefix) — so the late-registering
        # query is killed on arrival instead of running to completion
        self._tombstones: dict[str, tuple[str, float, bool]] = {}

    def start_query(self, query_id: Optional[str] = None,
                    group: str = "default") -> QueryResourceTracker:
        t = QueryResourceTracker(query_id or uuid.uuid4().hex[:12], group)
        reason = None
        with self._lock:
            if self._tombstones:
                reason = self._tombstone_match_locked(t.query_id)
            self._inflight[t.query_id] = t
        if reason is not None:
            t.kill(reason)
        return t

    def _tombstone_match_locked(self, query_id: str) -> Optional[str]:
        now = time.monotonic()
        expired = [k for k, (_r, exp, _p) in self._tombstones.items()
                   if exp <= now]
        for k in expired:
            del self._tombstones[k]
        for key, (reason, _exp, is_prefix) in self._tombstones.items():
            if query_id == key or (
                    is_prefix and query_id.startswith(key + ":")):
                return reason
        return None

    def _tombstone_locked(self, key: str, reason: str,
                          is_prefix: bool) -> None:
        self._tombstones[key] = (
            reason, time.monotonic() + self.tombstone_ttl_s, is_prefix)

    def end_query(self, tracker: QueryResourceTracker) -> None:
        with self._lock:
            self._inflight.pop(tracker.query_id, None)

    def on_allocation(self, tracker: QueryResourceTracker, n_bytes: int) -> None:
        tracker.add_allocated_bytes(n_bytes)
        self.maybe_kill()

    def total_allocated(self) -> int:
        with self._lock:
            return sum(t.allocated_bytes for t in self._inflight.values())

    def maybe_kill(self) -> Optional[str]:
        """If over budget, flag the most expensive in-flight query
        (reference :832-937 interrupts the runner thread of the costliest
        query)."""
        if self.memory_budget_bytes is None:
            return None
        with self._lock:
            total = sum(t.allocated_bytes for t in self._inflight.values())
            if total <= self.memory_budget_bytes:
                return None
            victim = max(self._inflight.values(), key=lambda t: t.cost,
                         default=None)
        if victim is not None:
            victim.kill(
                f"query {victim.query_id} killed: intermediates "
                f"{total} bytes exceed budget {self.memory_budget_bytes}")
            return victim.query_id
        return None

    def kill_query(self, query_id: str, reason: str = "killed by admin") -> bool:
        with self._lock:
            t = self._inflight.get(query_id)
            if t is None:
                # not registered (yet): tombstone the id so a query that
                # lost the race to the cancel RPC still dies on arrival
                self._tombstone_locked(query_id, reason, is_prefix=False)
        if t is None:
            return False
        t.kill(reason)
        return True

    def kill_prefix(self, prefix: str,
                    reason: str = "killed by admin") -> int:
        """Kill every in-flight query whose id is ``prefix`` or a shard of
        it (``prefix:<n>`` — the broker stamps one shard id per scatter
        RPC), and tombstone the prefix so late-registering shards die on
        arrival. Returns the number of live trackers killed."""
        with self._lock:
            victims = [t for qid, t in self._inflight.items()
                       if qid == prefix or qid.startswith(prefix + ":")]
            self._tombstone_locked(prefix, reason, is_prefix=True)
        for t in victims:
            t.kill(reason)
        return len(victims)

    def inflight(self) -> list[str]:
        with self._lock:
            return sorted(self._inflight)


GLOBAL_ACCOUNTANT = ResourceAccountant()


class QueryScheduler:
    """Bounded-concurrency admission control (reference FCFS policy:
    fcfs QuerySchedulerFactory default)."""

    def __init__(self, max_concurrent: int = 8, max_pending: int = 64,
                 accountant: Optional[ResourceAccountant] = None):
        self.max_concurrent = max_concurrent
        self.max_pending = max_pending
        self.accountant = accountant or GLOBAL_ACCOUNTANT
        self._sem = threading.Semaphore(max_concurrent)
        self._pending = 0
        self._lock = threading.Lock()
        self.wait_ms_total = 0.0

    def submit(self, fn: Callable, *args, group: str = "default",
               timeout_s: float = 60.0, query_id: Optional[str] = None,
               **kwargs):
        """Run fn(tracker, *args) under admission control. ``timeout_s``
        bounds queue wait (deadline propagation: the server passes the
        query's remaining budget); ``query_id`` names the tracker so a
        broker-sent cancel can find it via ``kill_query``."""
        with self._lock:
            if self._pending >= self.max_pending:
                SERVER_METRICS.add_meter(ServerMeter.QUERIES_REJECTED)
                raise QueryRejectedError(
                    f"scheduler queue full ({self.max_pending} pending)")
            self._pending += 1
        t0 = time.perf_counter()
        try:
            if not self._sem.acquire(timeout=timeout_s):
                SERVER_METRICS.add_meter(ServerMeter.QUERIES_REJECTED)
                raise QueryRejectedError("scheduler wait timeout")
        finally:
            with self._lock:
                self._pending -= 1
        wait_ms = (time.perf_counter() - t0) * 1000
        self.wait_ms_total += wait_ms
        # reference ServerQueryPhase.SCHEDULER_WAIT: admission-control
        # latency into the server timer histogram
        SERVER_METRICS.update_timer(ServerTimer.SCHEDULER_WAIT_MS, wait_ms)
        tracker = self.accountant.start_query(query_id=query_id, group=group)
        try:
            return fn(tracker, *args, **kwargs)
        finally:
            self.accountant.end_query(tracker)
            self._sem.release()


class PriorityQueryScheduler(QueryScheduler):
    """Token-bucket fairness across scheduler groups (reference:
    MultiLevelPriorityQueue / TokenPriorityScheduler): a group that has
    consumed more CPU-milliseconds waits behind lighter groups when the
    cluster is saturated."""

    def __init__(self, max_concurrent: int = 8, max_pending: int = 64,
                 accountant: Optional[ResourceAccountant] = None):
        super().__init__(max_concurrent, max_pending, accountant)
        self._tokens_used: dict[str, float] = {}
        self._waiting: dict[str, int] = {}
        self._cv = threading.Condition()
        self._running = 0

    def submit(self, fn: Callable, *args, group: str = "default",
               timeout_s: float = 60.0, query_id: Optional[str] = None,
               **kwargs):
        deadline = time.monotonic() + timeout_s
        t_wait = time.perf_counter()
        with self._cv:
            if self._pending >= self.max_pending:
                SERVER_METRICS.add_meter(ServerMeter.QUERIES_REJECTED)
                raise QueryRejectedError("scheduler queue full")
            self._pending += 1
            self._waiting[group] = self._waiting.get(group, 0) + 1
            try:
                while self._running >= self.max_concurrent or not \
                        self._my_turn(group):
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        SERVER_METRICS.add_meter(ServerMeter.QUERIES_REJECTED)
                        raise QueryRejectedError("scheduler wait timeout")
                    self._cv.wait(min(remaining, 0.05))
                self._running += 1
            finally:
                self._pending -= 1
                self._waiting[group] -= 1
                if not self._waiting[group]:
                    del self._waiting[group]
        wait_ms = (time.perf_counter() - t_wait) * 1000
        self.wait_ms_total += wait_ms
        SERVER_METRICS.update_timer(ServerTimer.SCHEDULER_WAIT_MS, wait_ms)
        tracker = self.accountant.start_query(query_id=query_id, group=group)
        t0 = time.perf_counter()
        try:
            return fn(tracker, *args, **kwargs)
        finally:
            used = (time.perf_counter() - t0) * 1000
            with self._cv:
                self._tokens_used[group] = self._tokens_used.get(group, 0.0) + used
                self._running -= 1
                self._cv.notify_all()
            self.accountant.end_query(tracker)

    def _my_turn(self, group: str) -> bool:
        """Contention resolves toward the group with the fewest consumed
        tokens — but only among groups WAITING right now; a lone waiter
        always proceeds (otherwise historical heavy groups would starve)."""
        mine = self._tokens_used.get(group, 0.0)
        return all(mine <= self._tokens_used.get(g, 0.0)
                   for g in self._waiting if g != group)
