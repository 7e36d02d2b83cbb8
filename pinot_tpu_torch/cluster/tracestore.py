"""The broker's ring of retained traces (the flight recorder's store).

The port of pinot_tpu/cluster/tracestore.py. Reference analogue: none in
Pinot; the nearest are the broker's query log ring and the OpenTelemetry
collector's tail-sampling buffer. Every trace the broker finishes with
(head-sampled, `SET trace = true`, or EXPLAIN ANALYZE) is offered here.
Slow, partial and failed queries are kept PINNED (tail capture: the
queries worth debugging are the ones a random drop would lose); healthy
samples are best-effort and go first when the byte budget evicts.

Entries are keyed by the broker's query id: `summaries()` lists them and
`get(queryId)` returns the span list (spi/traceexport.py renders it for
Perfetto), the payloads of GET /debug/traces and /debug/traces/{id}
(cluster/rest.py). The store is per process and bounded
two ways: PINOT_TPU_TRACE_STORE_BYTES (16 MiB of span JSON by default)
and PINOT_TPU_TRACE_STORE_MAX entries. Eviction drops the oldest unpinned
trace first, then the oldest pinned one, and counts what it dropped.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import OrderedDict
from typing import Optional

DEFAULT_BUDGET_BYTES = int(os.environ.get(
    "PINOT_TPU_TRACE_STORE_BYTES", 16 << 20))
DEFAULT_MAX_TRACES = int(os.environ.get(
    "PINOT_TPU_TRACE_STORE_MAX", 256))


class TraceStore:
    """Byte-budgeted, pin-aware ring of retained traces."""

    def __init__(self, budget_bytes: Optional[int] = None,
                 max_traces: Optional[int] = None):
        self.budget_bytes = DEFAULT_BUDGET_BYTES if budget_bytes is None \
            else int(budget_bytes)
        self.max_traces = DEFAULT_MAX_TRACES if max_traces is None \
            else int(max_traces)
        # queryId → entry dict; insertion order is arrival order (the
        # eviction scan walks oldest-first within each pin class)
        self._traces: "OrderedDict[str, dict]" = OrderedDict()
        self._bytes = 0
        self.evictions = 0  # lifetime drops (budget/count pressure)
        self._lock = threading.Lock()

    def offer(self, query_id: str, spans: list, *, reason: str = "sampled",
              pinned: bool = False, table: str = "", time_ms: float = 0.0,
              exceptions: int = 0, partial: bool = False,
              alert_id: str = "") -> str:
        """Retain one finished trace. ``pinned`` marks tail-captured
        traces (slow/partial/failed) that outlive budget pressure from
        healthy samples. ``alert_id`` tags sentinel-pinned exemplars
        (engine/perf_ledger.py) so the alert record and the trace link
        both ways. Returns the retained trace id (the queryId).
        A re-offer under the same id replaces the old entry (hedged
        EXPLAIN reruns of one id keep the latest)."""
        # sizing by serialized span JSON: that is exactly what the debug
        # endpoint ships, and it is only computed on RETAINED traces —
        # untraced queries never reach this method
        try:
            nbytes = len(json.dumps(spans))
        except (TypeError, ValueError):
            spans = [{"operator": "unserializable-trace"}]
            nbytes = 64
        entry = {
            "queryId": query_id,
            "reason": reason,
            "pinned": bool(pinned),
            "table": table,
            "timeMs": round(float(time_ms), 3),
            "exceptions": int(exceptions),
            "partialResult": bool(partial),
            "numSpans": len(spans),
            "bytes": nbytes,
            "timestamp": round(time.time(), 3),
            "spans": spans,
        }
        if alert_id:
            entry["alertIds"] = [alert_id]
        with self._lock:
            old = self._traces.pop(query_id, None)
            if old is not None:
                self._bytes -= old["bytes"]
            self._traces[query_id] = entry
            self._bytes += nbytes
            self._evict_locked()
        return query_id

    def _evict_locked(self) -> None:
        def over() -> bool:
            return self._bytes > self.budget_bytes \
                or len(self._traces) > self.max_traces
        if not over():
            return
        # unpinned (healthy samples) go first, oldest-first; pinned
        # (slow/partial/failed) only when samples alone can't fit the
        # budget — but the just-offered newest entry always survives
        for pin_class in (False, True):
            for qid in list(self._traces):
                if not over():
                    return
                ent = self._traces[qid]
                if ent["pinned"] is not pin_class:
                    continue
                if qid == next(reversed(self._traces)):
                    continue  # never evict the entry being offered
                self._bytes -= ent["bytes"]
                del self._traces[qid]
                self.evictions += 1

    def get(self, query_id: str) -> Optional[dict]:
        with self._lock:
            ent = self._traces.get(query_id)
            return dict(ent) if ent is not None else None

    def summaries(self) -> list:
        """Newest-first listing without the span payloads."""
        with self._lock:
            out = [{k: v for k, v in ent.items() if k != "spans"}
                   for ent in self._traces.values()]
        out.reverse()
        return out

    def stats(self) -> dict:
        with self._lock:
            pinned = sum(1 for e in self._traces.values() if e["pinned"])
            exemplars = sum(1 for e in self._traces.values()
                            if e.get("alertIds"))
            return {"traces": len(self._traces),
                    "pinnedTraces": pinned,
                    "alertExemplars": exemplars,
                    "bytes": self._bytes,
                    "budgetBytes": self.budget_bytes,
                    "maxTraces": self.max_traces,
                    "evictions": self.evictions}

    def clear(self) -> None:
        with self._lock:
            self._traces.clear()
            self._bytes = 0
