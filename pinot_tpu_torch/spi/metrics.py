"""Metrics SPI: meters / gauges / histogram timers with a pluggable factory.

The port's copy of pinot_tpu/spi/metrics.py, whole. The meters of the
modules the port has not taken yet (realtime consumption, the cluster
MSE, tiered storage, AOT) are declared for name parity and stay at 0.

Reference analogue: pinot-spi/.../spi/metrics/ + AbstractMetrics
(pinot-common/.../common/metrics/AbstractMetrics.java) with the typed
per-role enums (ServerMeter/ServerGauge/ServerTimer, Broker*, Controller*)
and swappable yammer/dropwizard backends
(pinot-plugins/pinot-metrics/). The in-memory registry here is the default
backend; `register_metrics_factory` swaps it (e.g. a Prometheus exporter).

Timers are log-bucketed histograms (4 buckets per octave, so quantile
estimates carry at most ~19% relative error) rather than plain
count/total pairs — `snapshot()` reports p50/p95/p99 per timer, and
`render_prometheus` exposes the whole registry in Prometheus text format
for the REST `/metrics` route.
"""

from __future__ import annotations

import math
import re
import threading
import time
from collections import defaultdict
from typing import Callable, Optional


class ServerMeter:
    QUERIES = "queries"
    NUM_DOCS_SCANNED = "numDocsScanned"
    NUM_SEGMENTS_PROCESSED = "numSegmentsProcessed"
    NUM_SEGMENTS_PRUNED = "numSegmentsPruned"
    NUM_DEVICE_DISPATCHES = "numDeviceDispatches"
    NUM_COMPILES = "numCompiles"
    QUERY_EXECUTION_EXCEPTIONS = "queryExecutionExceptions"
    DELETED_SEGMENT_COUNT = "deletedSegmentCount"
    REALTIME_ROWS_CONSUMED = "realtimeRowsConsumed"
    # realtime device planes (realtime/device_plane.py): bytes of newly
    # appended rows delta-uploaded to device (∝ new rows, NOT snapshot
    # size), watermark advances across all plane sets, and queries that
    # answered over a consuming segment on the device path
    REALTIME_DELTA_UPLOAD_BYTES = "realtimeDeltaUploadBytes"
    REALTIME_PLANE_GENERATIONS = "realtimePlaneGenerations"
    REALTIME_DEVICE_QUERIES = "realtimeDeviceQueries"
    QUERIES_KILLED = "queriesKilled"
    QUERIES_REJECTED = "queriesRejected"
    HBM_OOM_EVENTS = "hbmOomEvents"
    HBM_OOM_EVICTIONS = "hbmOomEvictions"
    HBM_OOM_QUERY_FAILURES = "hbmOomQueryFailures"
    SEGMENT_CACHE_HITS = "segmentCacheHits"
    SEGMENT_CACHE_MISSES = "segmentCacheMisses"
    SEGMENT_CACHE_EVICTIONS = "segmentCacheEvictions"
    # data-integrity pipeline (segment verify → quarantine → repair)
    SEGMENT_CRC_MISMATCH = "segmentCrcMismatch"
    SEGMENTS_QUARANTINED = "segmentsQuarantined"
    SEGMENT_REPAIRS = "segmentRepairs"
    # realtime completion protocol stalled on a vacant controller seat:
    # each retry-while-no-leader backoff sleep bumps this (consumers HOLD)
    COMPLETION_HOLDS_NO_LEADER = "completionHoldsNoLeader"
    # device-resident MSE join stages: fused kernel runs vs gate failures
    # (dtype/overflow/empty side) that fell back to the host operators
    MSE_DEVICE_JOINS = "mseDeviceJoins"
    MSE_DEVICE_JOIN_FALLBACKS = "mseDeviceJoinFallbacks"
    # whole-query device residency: stages executed inside a fused device
    # plan (the fused stage itself + absorbed chain stages), device→host
    # crossings taken by fused plans (one per plan per server), and bytes
    # shipped cross-server as device-packed PTDP DataTable blocks
    MSE_FUSED_STAGES = "mseFusedStages"
    MSE_HOST_CROSSINGS = "mseHostCrossings"
    DEVICE_PACKED_EXCHANGE_BYTES = "devicePackedExchangeBytes"
    # tiered storage (storage/tier.py via cluster/server.py): cold
    # metadata-only segments fetched on demand, budget-pressure evictions
    # back to metadata-only, and prefetch-nudge warms that completed
    SEGMENT_COLD_LOADS = "segmentColdLoads"
    SEGMENT_EVICTIONS = "segmentEvictions"
    PREFETCH_HITS = "prefetchHits"
    # continuous batching (engine/coalesce.py): queries that rode another
    # query's family dispatch instead of paying their own
    COALESCED_QUERIES = "coalescedQueries"
    # AOT executable cache (engine/aot_cache.py): dispatches served by a
    # deserialized persisted executable vs fresh-compile fallbacks
    AOT_CACHE_HITS = "aotCacheHits"
    AOT_CACHE_MISSES = "aotCacheMisses"


class BrokerMeter:
    QUERIES = "queries"
    BROKER_RESPONSES_WITH_EXCEPTIONS = "brokerResponsesWithExceptions"
    REQUEST_FAILURES = "requestFailures"
    NO_SERVING_HOST_FOR_SEGMENT = "noServingHostForSegment"
    RESULT_CACHE_HITS = "resultCacheHits"
    RESULT_CACHE_MISSES = "resultCacheMisses"
    RESULT_CACHE_EVICTIONS = "resultCacheEvictions"
    PARTIAL_RESULTS = "partialResults"
    DEADLINE_EXCEEDED = "deadlineExceededCancellations"
    # self-healing scatter/gather (cluster/broker.py retry/hedge layer)
    SCATTER_RETRIES = "scatterRetries"
    HEDGED_REQUESTS = "hedgedRequests"
    HEDGE_WINS = "hedgeWins"
    CIRCUIT_OPEN = "circuitOpenCount"
    QUERIES_REJECTED = "queriesRejected"
    # wire-integrity: scatter responses whose DataTable checksum failed
    # (each one is reclassified as a connection failure and retried)
    DATATABLE_CORRUPTIONS = "datatableCorruptions"
    # routing read failed; the query was served from the last good
    # external-view snapshot (control-plane outage tolerance)
    ROUTING_FROM_LAST_VIEW = "routingServedFromLastView"


class ServerTimer:
    QUERY_PROCESSING_TIME_MS = "queryProcessingTimeMs"
    SCHEDULER_WAIT_MS = "schedulerWaitMs"
    # on-device cross-chip result merge for mesh-sharded family dispatches
    # (engine/executor.py _dispatch_batch_sharded; traced runs only)
    CROSS_CHIP_COMBINE_MS = "crossChipCombineMs"
    # tiered storage: wall time to fetch+verify+load one cold segment
    COLD_LOAD_MS = "coldLoadMs"
    # continuous batching: how long a coalesced query waited in the hold
    # window before its group dispatched
    COALESCE_WAIT_MS = "coalesceWaitMs"
    # AOT cache: wall time spent deserializing + warming a table's top
    # family executables at segment-load / prefetch time
    AOT_PREWARM_MS = "aotPrewarmMs"


class BrokerTimer:
    QUERY_PROCESSING_TIME_MS = "queryProcessingTimeMs"
    # per scatter-RPC latency — the p95 source for the hedge delay
    SCATTER_RPC_MS = "scatterRpcMs"
    # broker admission-control queue wait (cluster/quota.py)
    ADMISSION_WAIT_MS = "admissionWaitMs"


class ServerGauge:
    DOCUMENT_COUNT = "documentCount"
    SEGMENT_COUNT = "segmentCount"
    UPSERT_PRIMARY_KEYS_COUNT = "upsertPrimaryKeysCount"
    # compile telemetry registry (engine/compile_registry.py): supplier
    # gauges polled only at scrape time — the query path never pays
    COMPILE_FAMILIES = "compileFamilies"
    COMPILE_MS_TOTAL = "compileMsTotal"
    # HBM residency telemetry (segment/device_cache.py hbm_telemetry)
    HBM_BYTES_USED = "hbmBytesUsed"
    HBM_BYTES_HIGH_WATER = "hbmBytesHighWater"
    HBM_EVICTIONS = "hbmEvictions"
    # mesh execution: local devices the segment-axis mesh spans
    # (parallel/mesh.py mesh_device_count; per-device HBM residency is
    # the dynamic hbmBytesUsedDevice.{device} gauge family)
    MESH_DEVICES = "meshDevices"


class ControllerMeter:
    # control-plane durability + failover (cluster/store.py, leader.py)
    LEADER_CHANGES = "controllerLeaderChanges"
    STORE_RECOVERIES = "storeRecoveries"
    STORE_JOURNAL_TRUNCATIONS = "storeJournalTruncations"
    STORE_SNAPSHOTS = "storeSnapshots"
    # cluster-health rollup (cluster/periodic.py ClusterHealthChecker):
    # one tick per anomaly flagged in a scrape (straggler, hbm-pressure,
    # cache-collapse, breaker-flap, instance-unreachable)
    CLUSTER_HEALTH_ANOMALIES = "clusterHealthAnomalies"
    # elastic rebalance (cluster/rebalance.py): per-segment move lifecycle
    SEGMENT_MOVES_STARTED = "segmentMovesStarted"
    SEGMENT_MOVES_COMPLETED = "segmentMovesCompleted"
    SEGMENT_MOVES_FAILED = "segmentMovesFailed"


class ControllerGauge:
    STORE_JOURNAL_BYTES = "storeJournalBytes"
    # servers that answered the last health scrape (leader only)
    CLUSTER_SERVERS_REACHABLE = "clusterServersReachable"
    # rebalance jobs currently IN_PROGRESS/ABORTING across all tables
    REBALANCE_ACTIVE = "rebalanceActive"
    # regression-sentinel alerts currently firing (cluster/sentinel.py)
    PERF_ANOMALIES_ACTIVE = "perfAnomaliesActive"


class ControllerTimer:
    # wall time of one completed segment move, ADDING start → source drop
    SEGMENT_MOVE_MS = "segmentMoveMs"


# log-bucketed histogram resolution: 4 buckets per power of two keeps the
# worst-case quantile error at 2**0.25 - 1 ~= 19% with O(40*4) buckets
# across the practical 1us..1000s range
_BUCKETS_PER_OCTAVE = 4
_MIN_MS = 2.0 ** -10  # ~1us floor; everything below lands in one bucket


def _bucket_index(ms: float) -> int:
    if ms <= _MIN_MS:
        return -10 * _BUCKETS_PER_OCTAVE
    return math.ceil(math.log2(ms) * _BUCKETS_PER_OCTAVE)


def _bucket_upper_ms(idx: int) -> float:
    return 2.0 ** (idx / _BUCKETS_PER_OCTAVE)


class TimerHistogram:
    """Log-bucketed latency histogram (lock handled by the registry)."""

    __slots__ = ("count", "total_ms", "min_ms", "max_ms", "buckets")

    def __init__(self):
        self.count = 0
        self.total_ms = 0.0
        self.min_ms = math.inf
        self.max_ms = 0.0
        self.buckets: dict[int, int] = {}

    def add(self, ms: float) -> None:
        self.count += 1
        self.total_ms += ms
        if ms < self.min_ms:
            self.min_ms = ms
        if ms > self.max_ms:
            self.max_ms = ms
        idx = _bucket_index(ms)
        self.buckets[idx] = self.buckets.get(idx, 0) + 1

    def quantile(self, q: float) -> float:
        if self.count == 0:
            return 0.0
        target = max(1, math.ceil(q * self.count))
        cum = 0
        for idx in sorted(self.buckets):
            cum += self.buckets[idx]
            if cum >= target:
                # clamp the bucket bound to the observed range so small
                # samples don't report an estimate outside [min, max]
                est = _bucket_upper_ms(idx)
                return min(max(est, self.min_ms), self.max_ms)
        return self.max_ms


class MetricsRegistry:
    """In-memory backend: thread-safe counters, gauges, timer histograms."""

    def __init__(self):
        self._lock = threading.Lock()
        self._meters: dict[str, int] = defaultdict(int)
        # per-table labeled meters, keyed (name, table)
        # (reference: AbstractMetrics.addMeteredTableValue)
        self._table_meters: dict[tuple[str, str], int] = defaultdict(int)
        self._gauges: dict[str, Callable[[], float]] = {}
        self._timers: dict[str, TimerHistogram] = defaultdict(TimerHistogram)

    def add_meter(self, name: str, value: int = 1) -> None:
        with self._lock:
            self._meters[name] += value

    def meter_count(self, name: str) -> int:
        with self._lock:
            return self._meters.get(name, 0)

    def add_table_meter(self, table: str, name: str, value: int = 1) -> None:
        with self._lock:
            self._table_meters[(name, table)] += value

    def table_meter_count(self, table: str, name: str) -> int:
        with self._lock:
            return self._table_meters.get((name, table), 0)

    def set_gauge(self, name: str, supplier: Callable[[], float]) -> None:
        with self._lock:
            self._gauges[name] = supplier

    def remove_gauge(self, name: str, supplier=None) -> None:
        """Unregister a gauge (reference: removeTableGauge on table
        shutdown) so stopped components are released and snapshot() stops
        polling their suppliers. With ``supplier``, removes only if that
        exact supplier is still registered — an old component's shutdown
        must not delete its replacement's gauge."""
        with self._lock:
            if supplier is None or self._gauges.get(name) is supplier:
                self._gauges.pop(name, None)

    def gauge_value(self, name: str) -> Optional[float]:
        with self._lock:
            g = self._gauges.get(name)
        return None if g is None else float(g())

    def update_timer(self, name: str, ms: float) -> None:
        with self._lock:
            self._timers[name].add(ms)

    def timer_stats(self, name: str) -> tuple[int, float]:
        with self._lock:
            t = self._timers.get(name)
            return (0, 0.0) if t is None else (t.count, t.total_ms)

    def timer_quantile(self, name: str, q: float) -> float:
        with self._lock:
            t = self._timers.get(name)
            return 0.0 if t is None else t.quantile(q)

    def timed(self, name: str):
        registry = self

        class _Ctx:
            def __enter__(self):
                self.t0 = time.perf_counter()
                return self

            def __exit__(self, *exc):
                registry.update_timer(name, (time.perf_counter() - self.t0) * 1000)

        return _Ctx()

    def snapshot(self) -> dict:
        # gauge suppliers may block or raise (e.g. stream-metadata RPCs
        # behind the ingestion-lag gauge) — evaluate them OUTSIDE the
        # registry lock so a slow supplier cannot stall query-path
        # add_meter/update_timer, and skip any that raise so one broken
        # supplier cannot take down the whole snapshot
        with self._lock:
            out = {
                "meters": dict(self._meters),
                "tableMeters": {f"{name}.{table}": v
                                for (name, table), v in
                                self._table_meters.items()},
                "timers": {k: {"count": t.count,
                               "totalMs": round(t.total_ms, 3),
                               "minMs": round(t.min_ms, 3) if t.count else 0.0,
                               "maxMs": round(t.max_ms, 3),
                               "p50Ms": round(t.quantile(0.50), 3),
                               "p95Ms": round(t.quantile(0.95), 3),
                               "p99Ms": round(t.quantile(0.99), 3)}
                           for k, t in self._timers.items()},
            }
            gauges = dict(self._gauges)
        vals = {}
        for k, v in gauges.items():
            try:
                vals[k] = float(v())
            except Exception:
                pass
        out["gauges"] = vals
        return out


def _prom_name(name: str) -> str:
    return re.sub(r"[^a-zA-Z0-9_:]", "_", name)


PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def render_prometheus(registry: MetricsRegistry, role: str) -> str:
    """Render a registry in Prometheus text exposition format 0.0.4:
    meters as counters, gauges as gauges, timer histograms as summaries
    with p50/p95/p99 quantile labels."""
    snap = registry.snapshot()
    base = f'role="{role}"'
    lines = []
    for name in sorted(snap["meters"]):
        pn = f"pinot_{_prom_name(name)}_total"
        lines.append(f"# TYPE {pn} counter")
        lines.append(f"{pn}{{{base}}} {snap['meters'][name]}")
    by_name: dict[str, list] = defaultdict(list)
    for key, v in snap["tableMeters"].items():
        name, table = key.split(".", 1)
        by_name[name].append((table, v))
    for name in sorted(by_name):
        pn = f"pinot_{_prom_name(name)}_total"
        for table, v in sorted(by_name[name]):
            lines.append(f'{pn}{{{base},table="{table}"}} {v}')
    for name in sorted(snap["gauges"]):
        pn = f"pinot_{_prom_name(name)}"
        lines.append(f"# TYPE {pn} gauge")
        lines.append(f"{pn}{{{base}}} {snap['gauges'][name]}")
    for name in sorted(snap["timers"]):
        t = snap["timers"][name]
        pn = f"pinot_{_prom_name(name)}"
        lines.append(f"# TYPE {pn} summary")
        for q, key in ((0.5, "p50Ms"), (0.95, "p95Ms"), (0.99, "p99Ms")):
            lines.append(f'{pn}{{{base},quantile="{q}"}} {t[key]}')
        lines.append(f"{pn}_count{{{base}}} {t['count']}")
        lines.append(f"{pn}_sum{{{base}}} {t['totalMs']}")
    return "\n".join(lines) + "\n"


_FACTORY: Callable[[], MetricsRegistry] = MetricsRegistry


def register_metrics_factory(factory: Callable[[], MetricsRegistry]) -> None:
    global _FACTORY
    _FACTORY = factory


def make_registry() -> MetricsRegistry:
    return _FACTORY()


# process-wide defaults per role (reference: ServerMetrics.get() singletons)
SERVER_METRICS = MetricsRegistry()
BROKER_METRICS = MetricsRegistry()
CONTROLLER_METRICS = MetricsRegistry()
