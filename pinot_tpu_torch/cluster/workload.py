"""Per-query cost accounting and decaying workload rollups.

The port of pinot_tpu/cluster/workload.py. Reference analogue: the
broker's query-cost attribution in QueryLogger/BrokerQueryEventListener
plus the controller recommender's queryStats input, folded into one
place: every completed query is reduced to a cost report (device, host,
transfer and shuffle cost, cache behaviour, healing effort) attributed to
its table and client id, and accumulated into exponentially decaying
per-table rollups.

Two consumers read the rollups instead of raw query counts:

- the admission controller (cluster/quota.py): a saturated broker can
  shed *expensive* queries first; `expected_cost_ms` supplies the decayed
  mean cost of the query's table as the admission cost hint;
- the broker's /BROKERSTATE beacon (`table_costs`), which the servers'
  storage tier reads as eviction heat and the StoragePrefetcher
  (storage/prefetch.py) ranks hot tables by; `recommender_input` emits
  the `{queries: [{sql, freq}], qps}` body the JAX package's recommender
  accepts.

Cost extraction never arms tracing: untraced queries contribute the
response-level counters; phase-level device and combine times and
transfer bytes ride along only when the query ran traced. The fold is
plain dict arithmetic on the broker's return path: no device sync, no
span allocation. All of it is host code; `clock` (monotonic seconds) and
`wall_clock` (epoch seconds) are injectable so the rollups test
deterministically. The half life is the JAX package's default (its
PINOT_TPU_WORKLOAD_HALF_LIFE_S unset); the constructor sets another.
"""

from __future__ import annotations

import math
import re
import threading
import time
from collections import deque
from typing import Callable, Optional

from ..spi.trace import phase_breakdown

# decayed-sum half life for the per-table rollups: ~5 minutes means a
# burst stops dominating the admission cost hint within a few half-lives
DEFAULT_HALF_LIFE_S = 300.0

# distinct SQL patterns sampled per table for the recommender feed
MAX_PATTERNS_PER_TABLE = 64

# accumulated (decaying) numeric fields of a rollup; every one is also a
# QueryCostReport key
_SUM_FIELDS = (
    "queries", "failures", "rejected", "tracedQueries",
    "timeMs", "deviceMs", "compileMs", "hostCombineMs",
    "transferBytes", "hbmBytesTouched", "shuffledBytes", "cacheHitBytes",
    "docsScanned", "deviceDispatches", "compiles",
    "segmentCacheHits", "segmentCacheMisses",
    "resultCacheHits", "scatterRetries", "hedgedRequests",
)

_CLIENT_ID_RE = re.compile(r"(?i)\bset\s+clientid\s*=\s*'?([\w.@-]+)'?")


def client_id_of(sql: str) -> str:
    """Client attribution from the query's own ``SET clientId = x`` option
    (the parsers treat unknown SET options as passthrough query options;
    this extracts it without re-parsing on the hot path)."""
    m = _CLIENT_ID_RE.search(sql)
    return m.group(1) if m else ""


def build_cost_report(resp, table: str = "", client_id: str = "",
                      sql: str = "") -> dict:
    """Fold one completed query's response (and its trace, when present)
    into a flat cost report. Every numeric key is decayed-summable."""
    trace_info = getattr(resp, "trace_info", None)
    device_ms = compile_ms = combine_ms = 0.0
    transfer = shuffled = hbm_touched = cache_hit_bytes = 0
    if trace_info:
        phases = phase_breakdown(trace_info)
        device_ms = phases["deviceExecMs"]
        compile_ms = phases["compileMs"]
        combine_ms = phases["hostCombineMs"]
        transfer = phases["transferBytes"]
        shuffled = phases.get("shuffledBytes", 0)
        for span in trace_info:
            attrs = span.get("attributes") or {}
            hbm_touched = max(hbm_touched,
                              int(attrs.get("hbmBytesUsed", 0) or 0))
            cache_hit_bytes += int(attrs.get("cacheHitBytes", 0) or 0)
    mss = getattr(resp, "mse_stage_stats", None)
    if mss:
        # MSE stage stats carry shuffle volume even untraced
        shuffled = max(shuffled, sum(
            int((s or {}).get("shuffled_bytes", 0) or 0)
            for s in mss.values()))
    return {
        "table": table,
        "clientId": client_id,
        "queries": 1,
        "failures": 1 if getattr(resp, "exceptions", None) else 0,
        "rejected": 1 if getattr(resp, "query_rejected", False) else 0,
        "tracedQueries": 1 if trace_info else 0,
        "timeMs": round(float(getattr(resp, "time_used_ms", 0.0) or 0.0), 3),
        "deviceMs": device_ms,
        "compileMs": compile_ms,
        "hostCombineMs": combine_ms,
        "transferBytes": transfer,
        "hbmBytesTouched": hbm_touched,
        "shuffledBytes": shuffled,
        "cacheHitBytes": cache_hit_bytes,
        "docsScanned": int(getattr(resp, "num_docs_scanned", 0) or 0),
        "deviceDispatches": int(
            getattr(resp, "num_device_dispatches", 0) or 0),
        "compiles": int(getattr(resp, "num_compiles", 0) or 0),
        "segmentCacheHits": int(
            getattr(resp, "num_segments_cache_hit", 0) or 0),
        "segmentCacheMisses": int(
            getattr(resp, "num_segments_cache_miss", 0) or 0),
        "resultCacheHits":
            1 if getattr(resp, "cache_outcome", None) == "hit" else 0,
        "scatterRetries": int(getattr(resp, "num_scatter_retries", 0) or 0),
        "hedgedRequests": int(getattr(resp, "num_hedged_requests", 0) or 0),
        "sql": sql,
    }


class _Rollup:
    """Exponentially-decaying sums: every fold first decays the stored
    values by 2^(-dt/half_life), so 'recent' traffic dominates and an idle
    table's cost signal fades to zero instead of pinning forever."""

    __slots__ = ("sums", "patterns", "last_ts", "half_life_s")

    def __init__(self, half_life_s: float, now: float):
        self.sums = {k: 0.0 for k in _SUM_FIELDS}
        # canonical sql → decayed frequency weight (recommender feed)
        self.patterns: dict[str, float] = {}
        self.last_ts = now
        self.half_life_s = half_life_s

    def _decay(self, now: float) -> None:
        dt = now - self.last_ts
        if dt <= 0:
            return
        f = math.pow(2.0, -dt / self.half_life_s)
        for k in self.sums:
            self.sums[k] *= f
        for k in list(self.patterns):
            w = self.patterns[k] * f
            if w < 1e-3:
                del self.patterns[k]
            else:
                self.patterns[k] = w
        self.last_ts = now

    def fold(self, report: dict, now: float) -> None:
        self._decay(now)
        for k in _SUM_FIELDS:
            self.sums[k] += float(report.get(k, 0) or 0)
        sql = report.get("sql") or ""
        if sql:
            if sql not in self.patterns \
                    and len(self.patterns) >= MAX_PATTERNS_PER_TABLE:
                # evict the faintest pattern; the sample stays bounded
                del self.patterns[min(self.patterns,
                                      key=self.patterns.get)]
            self.patterns[sql] = self.patterns.get(sql, 0.0) + 1.0

    def snapshot(self, now: float) -> dict:
        self._decay(now)
        out = {k: (round(v, 3) if isinstance(v, float) else v)
               for k, v in self.sums.items()}
        q = self.sums["queries"]
        out["meanTimeMs"] = round(self.sums["timeMs"] / q, 3) if q else 0.0
        out["cacheHitRate"] = round(
            self.sums["segmentCacheHits"]
            / (self.sums["segmentCacheHits"]
               + self.sums["segmentCacheMisses"]), 4) \
            if (self.sums["segmentCacheHits"]
                + self.sums["segmentCacheMisses"]) else None
        # decayed count / half-life ≈ recent arrival rate
        out["decayedQps"] = round(q * math.log(2) / self.half_life_s, 4)
        return out


class WorkloadTracker:
    """Broker-side cost accountant: per-table and per-client decaying
    rollups plus a bounded ring of the most recent raw cost reports."""

    def __init__(self, half_life_s: Optional[float] = None,
                 recent_reports: int = 64,
                 clock: Callable[[], float] = time.monotonic,
                 wall_clock: Callable[[], float] = time.time):
        self.half_life_s = DEFAULT_HALF_LIFE_S if half_life_s is None \
            else float(half_life_s)
        self._clock = clock
        self._wall = wall_clock
        self._lock = threading.Lock()
        self._tables: dict[str, _Rollup] = {}
        self._clients: dict[str, _Rollup] = {}
        self._recent: deque = deque(maxlen=recent_reports)

    def note_response(self, sql: str, resp, table: str = "") -> dict:
        """Fold one completed query; returns its cost report."""
        report = build_cost_report(resp, table=table,
                                   client_id=client_id_of(sql), sql=sql)
        now = self._clock()
        with self._lock:
            key = table or "(none)"
            roll = self._tables.get(key)
            if roll is None:
                roll = self._tables[key] = _Rollup(self.half_life_s, now)
            roll.fold(report, now)
            cid = report["clientId"]
            if cid:
                croll = self._clients.get(cid)
                if croll is None:
                    croll = self._clients[cid] = _Rollup(
                        self.half_life_s, now)
                croll.fold(dict(report, sql=""), now)
            self._recent.append(
                dict(report, sql=report["sql"][:200],
                     timestamp=round(self._wall(), 3)))
        return report

    def expected_cost_ms(self, table: str) -> float:
        """Decayed mean wall-time of the table's recent queries — the
        admission controller's heavy-query cost hint."""
        with self._lock:
            roll = self._tables.get(table or "(none)")
            if roll is None:
                return 0.0
            roll._decay(self._clock())
            q = roll.sums["queries"]
            return roll.sums["timeMs"] / q if q else 0.0

    def table_costs(self) -> dict[str, float]:
        """Every tracked table's decayed mean wall-time (ms). Published in
        the broker's /BROKERSTATE beacon so the controller's rebalancer can
        weight hot tables when ordering segment moves."""
        with self._lock:
            now = self._clock()
            out = {}
            for table, roll in self._tables.items():
                if table == "(none)":
                    continue
                roll._decay(now)
                q = roll.sums["queries"]
                if q:
                    out[table] = round(roll.sums["timeMs"] / q, 3)
            return out

    def recommender_input(self, table: str) -> Optional[dict]:
        """Observed traffic in the body shape the JAX package's
        ``POST /recommender`` accepts: {queries: [{sql, freq}], qps}."""
        with self._lock:
            roll = self._tables.get(table)
            if roll is None:
                return None
            now = self._clock()
            roll._decay(now)
            total = sum(roll.patterns.values()) or 1.0
            return {
                "queries": [{"sql": s, "freq": round(w / total, 4)}
                            for s, w in sorted(roll.patterns.items(),
                                               key=lambda kv: -kv[1])],
                "qps": round(roll.sums["queries"] * math.log(2)
                             / self.half_life_s, 4),
            }

    def snapshot(self) -> dict:
        """The payload of the broker's GET /debug/workload
        (cluster/rest.py)."""
        now = self._clock()
        with self._lock:
            return {
                "halfLifeS": self.half_life_s,
                "tables": {t: r.snapshot(now)
                           for t, r in self._tables.items()},
                "clients": {c: r.snapshot(now)
                            for c, r in self._clients.items()},
                "recentQueries": list(self._recent),
                "recommenderInput": {
                    t: inp for t in list(self._tables)
                    if (inp := self._recommender_input_locked(t, now))},
            }

    def _recommender_input_locked(self, table: str, now: float):
        roll = self._tables.get(table)
        if roll is None or not roll.patterns:
            return None
        total = sum(roll.patterns.values()) or 1.0
        return {"queries": [{"sql": s, "freq": round(w / total, 4)}
                            for s, w in sorted(roll.patterns.items(),
                                               key=lambda kv: -kv[1])],
                "qps": round(roll.sums["queries"] * math.log(2)
                             / self.half_life_s, 4)}
