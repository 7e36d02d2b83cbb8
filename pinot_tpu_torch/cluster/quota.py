"""Query quota, broker admission control and cursors (paginated results).

The port of pinot_tpu/cluster/quota.py. Reference analogues:
- HelixExternalViewBasedQueryQuotaManager (pinot-broker/.../queryquota/):
  per-table QPS quotas, enforced with a hit counter over a sliding window.
- The broker's maxConcurrentQueries admission gate: a semaphore over
  query execution that sheds load with a well-formed 429-style rejection
  instead of letting an overloaded broker collapse.
- Cursors / response store (pinot-broker/.../cursors/FsResponseStore.java
  + pinot-spi/.../cursors/): a query's full result spools once, pages are
  served by cursor id.

All of it is host code. The JAX package reads its defaults from
PINOT_TPU_MAX_INFLIGHT_QUERIES, PINOT_TPU_MAX_QUEUED_QUERIES and
PINOT_TPU_HEAVY_QUERY_MS; here the constructor arguments are the
interface, with the same defaults those variables have when unset (the
gate disabled). `clock` is injectable so windows and TTLs test
deterministically.
"""

from __future__ import annotations

import threading
import time
import uuid
from collections import deque
from contextlib import contextmanager
from typing import Callable, Optional

from ..spi.metrics import BROKER_METRICS, BrokerTimer


class QueryQuotaExceededError(Exception):
    pass


class AdmissionRejectedError(Exception):
    """Broker admission control shed this query (queue full, or the queue
    wait would outlive the query's deadline)."""


class AdmissionController:
    """Broker-wide in-flight query gate (load shedding under overload).

    `max_inflight` bounds concurrent query executions; None or 0 disables
    the gate entirely, and the warm path then pays one attribute check.
    Waiters queue on the semaphore, but only for as long as the query's own
    deadline allows, and the queue depth itself is capped (`max_queued`,
    default 2 x max_inflight) so a burst fails fast instead of piling up.
    """

    def __init__(self, max_inflight: Optional[int] = None,
                 max_queued: Optional[int] = None,
                 heavy_query_ms: float = 0.0):
        max_inflight = max_inflight or None
        if max_queued is None:
            max_queued = 2 * max_inflight if max_inflight else 0
        self.max_inflight = max_inflight
        self.max_queued = max_queued
        # cost-aware shedding (fed by cluster/workload.py): once the broker
        # is saturated, a query whose expected cost (the decayed mean wall
        # time of its table's recent traffic) crosses this threshold is
        # rejected at once instead of queueing, so cheap queries keep
        # their queue slots. 0 disables (count-only admission).
        self.heavy_query_ms = float(heavy_query_ms or 0.0)
        self._sem = (threading.Semaphore(max_inflight)
                     if max_inflight else None)
        self._lock = threading.Lock()
        self._inflight = 0
        self._queued = 0

    def inflight(self) -> int:
        with self._lock:
            return self._inflight

    def queued(self) -> int:
        with self._lock:
            return self._queued

    @contextmanager
    def admit(self, timeout_s: float = 0.0, cost_hint_ms: float = 0.0):
        """Hold one in-flight slot for the duration of the block; raises
        AdmissionRejectedError when the queue is full or no slot frees up
        within `timeout_s` (the query's remaining deadline).
        `cost_hint_ms`, the caller's expected cost for this query, lets a
        saturated broker shed expensive queries without queueing them."""
        if self._sem is None:
            yield
            return
        # fast path: a free slot means no queueing at all; the queue-depth
        # cap only applies to queries that would have to wait
        ok = self._sem.acquire(blocking=False)
        if not ok:
            if self.heavy_query_ms and cost_hint_ms \
                    and cost_hint_ms >= self.heavy_query_ms:
                raise AdmissionRejectedError(
                    f"broker saturated and query's expected cost "
                    f"{cost_hint_ms:.0f}ms >= heavy threshold "
                    f"{self.heavy_query_ms:.0f}ms (cost-aware shedding)")
            with self._lock:
                if self._queued >= self.max_queued:
                    raise AdmissionRejectedError(
                        f"broker admission queue full "
                        f"({self._queued} queued, "
                        f"{self.max_inflight} in flight)")
                self._queued += 1
            t0 = time.perf_counter()
            try:
                ok = self._sem.acquire(timeout=max(0.0, timeout_s))
            finally:
                with self._lock:
                    self._queued -= 1
            wait_ms = (time.perf_counter() - t0) * 1000
            BROKER_METRICS.update_timer(BrokerTimer.ADMISSION_WAIT_MS,
                                        wait_ms)
            if not ok:
                raise AdmissionRejectedError(
                    f"no broker capacity within deadline "
                    f"(waited {wait_ms:.0f}ms for one of "
                    f"{self.max_inflight} slots)")
        with self._lock:
            self._inflight += 1
        try:
            yield
        finally:
            with self._lock:
                self._inflight -= 1
            self._sem.release()


class QueryQuotaManager:
    """Sliding-window QPS enforcement per table (reference: HitCounter with
    per-second buckets)."""

    def __init__(self, window_s: float = 1.0,
                 clock: Callable[[], float] = time.monotonic):
        self.window_s = window_s
        self._clock = clock
        self._lock = threading.Lock()
        self._limits: dict[str, float] = {}
        self._hits: dict[str, deque] = {}

    def set_qps_limit(self, table: str, qps: Optional[float]) -> None:
        with self._lock:
            if qps is None:
                self._limits.pop(table, None)
            else:
                self._limits[table] = float(qps)

    def acquire(self, table: str) -> None:
        """Record a hit; raises when the table is over its QPS quota."""
        with self._lock:
            limit = self._limits.get(table)
            if limit is None:
                return
            now = self._clock()
            dq = self._hits.setdefault(table, deque())
            while dq and now - dq[0] > self.window_s:
                dq.popleft()
            if len(dq) >= limit * self.window_s:
                raise QueryQuotaExceededError(
                    f"table {table} exceeded {limit} qps")
            dq.append(now)


class ResponseStore:
    """Spooled query results served page by page (reference:
    FsResponseStore + the broker's /resultStore cursor endpoints)."""

    def __init__(self, ttl_s: float = 300.0, max_entries: int = 256,
                 clock: Callable[[], float] = time.monotonic):
        self.ttl_s = ttl_s
        self.max_entries = max_entries
        self._clock = clock
        self._lock = threading.Lock()
        self._store: dict[str, tuple[float, list, list, list]] = {}

    def create_cursor(self, column_names: list, column_types: list,
                      rows: list) -> str:
        cursor_id = uuid.uuid4().hex
        with self._lock:
            self._evict_locked()
            self._store[cursor_id] = (self._clock(), column_names,
                                      column_types, rows)
        return cursor_id

    def fetch(self, cursor_id: str, offset: int, num_rows: int) -> dict:
        with self._lock:
            entry = self._store.get(cursor_id)
        if entry is None:
            raise KeyError(f"cursor {cursor_id} not found or expired")
        _, names, types, rows = entry
        page = rows[offset:offset + num_rows]
        return {
            "resultTable": {
                "dataSchema": {"columnNames": names, "columnDataTypes": types},
                "rows": page},
            "offset": offset,
            "numRows": len(page),
            "totalRows": len(rows),
            "cursorId": cursor_id,
        }

    def delete(self, cursor_id: str) -> bool:
        with self._lock:
            return self._store.pop(cursor_id, None) is not None

    def _evict_locked(self) -> None:
        now = self._clock()
        dead = [k for k, (t, *_rest) in self._store.items()
                if now - t > self.ttl_s]
        for k in dead:
            del self._store[k]
        while len(self._store) >= self.max_entries:
            oldest = min(self._store, key=lambda k: self._store[k][0])
            del self._store[oldest]
