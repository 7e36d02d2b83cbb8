"""The broker's query log, with rate throttling and a slow-query ring.

The port of pinot_tpu/cluster/querylog.py. Reference analogue:
pinot-broker/.../querylog/QueryLogger.java: one structured log line per
completed query (requestId, table, latency, docs scanned, exceptions),
throttled by a token bucket so a hot broker cannot flood the log; the
dropped lines are counted and reported with the next line that passes.
A slow entry names the hedges, the cold segments still warming and an
admission rejection where the query met them.
"""

from __future__ import annotations

import itertools
import logging
import os
import threading
import time
from collections import deque

logger = logging.getLogger("pinot_tpu_torch.querylog")


class QueryLogger:
    """Token-bucket-throttled per-query log (default 10 lines/s), plus a
    slow-query ring buffer: every completed query over
    ``slow_threshold_ms`` (PINOT_TPU_SLOW_QUERY_MS, default 500) is kept —
    with its full phase breakdown when it ran traced — in a bounded deque
    the JAX broker serves at GET /debug/queries. The slow capture is NOT
    throttled: the worst queries are exactly the ones a drop would hide."""

    def __init__(self, max_lines_per_s: float = 10.0, max_sql_len: int = 200,
                 slow_threshold_ms: float = None, slow_buffer_size: int = 50,
                 trace_store=None):
        self.rate = float(max_lines_per_s)
        self.max_sql_len = max_sql_len
        # flight-recorder linkage: when the broker wires its TraceStore in,
        # slow entries reference the retained trace by id instead of
        # embedding the span list (one copy of the bytes, in the store)
        self.trace_store = trace_store
        self.slow_threshold_ms = float(
            os.environ.get("PINOT_TPU_SLOW_QUERY_MS", 500.0)
            if slow_threshold_ms is None else slow_threshold_ms)
        self._slow: deque = deque(maxlen=slow_buffer_size)
        # cap ≥ 1.0: with a sub-1 rate a rate-sized cap could never reach
        # one token and the logger would be permanently, silently mute
        self._cap = max(self.rate, 1.0)
        self._tokens = self._cap
        self._last = time.monotonic()
        self._dropped = 0
        self._lock = threading.Lock()
        self._ids = itertools.count(1)

    def _note_slow(self, rid: int, sql: str, response, table: str) -> None:
        time_ms = getattr(response, "time_used_ms", 0) or 0
        if time_ms < self.slow_threshold_ms:
            return
        sql_part = sql if len(sql) <= self.max_sql_len else \
            sql[: self.max_sql_len] + "..."
        entry = {
            "requestId": rid,
            "table": table,
            "timeMs": round(time_ms, 3),
            "docsScanned": getattr(response, "num_docs_scanned", 0),
            "segmentsQueried": getattr(response, "num_segments_queried", 0),
            "numDeviceDispatches": getattr(response,
                                           "num_device_dispatches", 0),
            "numCompiles": getattr(response, "num_compiles", 0),
            "exceptions": len(getattr(response, "exceptions", []) or []),
            "timestamp": time.time(),
            "sql": sql_part,
        }
        if getattr(response, "partial_result", False):
            entry["partialResult"] = True
        if getattr(response, "num_servers_queried", 0):
            entry["numServersQueried"] = response.num_servers_queried
            entry["numServersResponded"] = response.num_servers_responded
        # self-healing scatter/gather: a slow query that healed (retried or
        # hedged its way to a full answer) says so in the log
        if getattr(response, "num_scatter_retries", 0):
            entry["scatterRetries"] = response.num_scatter_retries
        if getattr(response, "num_hedged_requests", 0):
            entry["hedgedRequests"] = response.num_hedged_requests
            entry["hedgeWins"] = response.num_hedge_wins
        # wire-integrity healing: shards whose DataTable failed its
        # checksum and were re-dispatched to another replica
        if getattr(response, "num_corrupt_shards_retried", 0):
            entry["corruptShardsRetried"] = response.num_corrupt_shards_retried
        # tiered storage: the query raced a cold segment's warm, slow (or
        # partial) because the bytes were still on their way up the tiers
        if getattr(response, "cold_segments_warming", 0):
            entry["coldSegmentsWarming"] = response.cold_segments_warming
        if getattr(response, "query_rejected", False):
            entry["queryRejected"] = True
        from ..spi import faults

        if faults.ACTIVE:
            # chaos runs: stamp the cumulative injected-fault count so a
            # slow entry can be correlated with the fault schedule
            entry["injectedFaults"] = faults.FAULTS.total_fired()
        # regression-sentinel cross-link: a slow query whose plan or table
        # has an active alert names the alert ids, so /debug/queries and
        # /debug/alerts triangulate without a third lookup. active_count
        # is a plain attribute read — the no-alerts path pays nothing.
        from ..engine.perf_ledger import ALERTS

        if ALERTS.active_count:
            alert_ids = ALERTS.active_ids_for(
                getattr(response, "_ledger_key", "") or "", table)
            if alert_ids:
                entry["alertIds"] = alert_ids
        outcome = getattr(response, "cache_outcome", None)
        if outcome:
            # a "slow but cached" query is an anomaly worth seeing: the
            # result cache answered yet the request still crossed the
            # slow threshold (serialization? lock contention?)
            entry["cacheOutcome"] = outcome
        trace_info = getattr(response, "trace_info", None)
        if trace_info:
            from ..spi.trace import phase_breakdown

            entry["phases"] = phase_breakdown(trace_info)
            trace_id = getattr(response, "trace_id", None)
            if trace_id and self.trace_store is not None \
                    and self.trace_store.get(trace_id) is not None:
                # the broker retained this trace already (sampled or
                # tail-captured): link it — GET /debug/traces/{traceId}
                entry["traceId"] = trace_id
            else:
                entry["trace"] = trace_info
        with self._lock:
            self._slow.append(entry)

    def slow_queries(self) -> list:
        """Ring contents, worst (slowest) first."""
        with self._lock:
            entries = list(self._slow)
        return sorted(entries, key=lambda e: -e["timeMs"])

    def log(self, sql: str, response, table: str = "") -> None:
        rid = next(self._ids)
        self._note_slow(rid, sql, response, table)
        with self._lock:
            now = time.monotonic()
            self._tokens = min(self._cap, self._tokens
                               + (now - self._last) * self.rate)
            self._last = now
            if self._tokens < 1.0:
                self._dropped += 1
                return
            self._tokens -= 1.0
            dropped, self._dropped = self._dropped, 0
        sql_part = sql if len(sql) <= self.max_sql_len else \
            sql[: self.max_sql_len] + "..."
        parts = [
            f"requestId={rid}",
            f"table={table}" if table else None,
            f"timeMs={getattr(response, 'time_used_ms', 0):.1f}",
            f"docsScanned={getattr(response, 'num_docs_scanned', 0)}",
            f"totalDocs={getattr(response, 'total_docs', 0)}",
            f"segmentsQueried={getattr(response, 'num_segments_queried', 0)}",
            f"exceptions={len(getattr(response, 'exceptions', []) or [])}",
            f"droppedSinceLast={dropped}" if dropped else None,
            f"query={sql_part!r}",
        ]
        logger.info("%s", " ".join(p for p in parts if p))
