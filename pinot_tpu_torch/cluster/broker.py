"""Broker role: route, scatter, gather, reduce.

The port of pinot_tpu/cluster/broker.py. Reference analogue:
pinot-broker — BaseSingleStageBrokerRequestHandler.handleRequest:279
(parse → optimize → route → scatter → gather → reduce),
BrokerRoutingManager (routing tables from external view), replica
selection (BalancedInstanceSelector / adaptive), circuit breakers
(cluster/breaker.py), TimeBoundaryManager:56 (hybrid OFFLINE+REALTIME
split), and BrokerReduceService.reduceOnDataTable:61.

One RPC per server carries the server's routed segments; each server
answers one DataTable (cluster/datatable.py), which the broker decodes at
the scatter edge (a corrupt blob fails over like a dropped connection),
merges and reduces with the port's BrokerReducer. A failed shard retries
on the segment's other replicas under capped backoff, inside the query's
deadline; with `allowPartialResults` the broker answers with what the
responding servers held. A statement the single-stage grammar rejects
(joins, subqueries, set operations) and `SET useMultistageEngine = true`
go to the cluster multi-stage engine (mse/distributed.py
`DistributedMseDispatcher`): plan fragments to stage workers on the
servers, the exchange between them, the final receive here.

The flight recorder: every response passes one funnel in `execute_sql`.
A traced response (head-sampled under PINOT_TPU_TRACE_SAMPLE, `SET trace
= true`, EXPLAIN ANALYZE) is offered to the broker's TraceStore
(cluster/tracestore.py), pinned when slow, partial or failed; the query
log (cluster/querylog.py) takes a line and, past its slow threshold, a
slow entry linking the retained trace; the perf ledger
(engine/perf_ledger.py) records the plan's counters. A head-sampled
response ships without its trace, and the result cache keeps a plain
copy. When the sentinel (cluster/sentinel.py) armed exemplars for a plan
or table, the broker claims one per query, forces its sampling and pins
its trace under the alert. None of these hooks can fail a query.

Admission (cluster/quota.py): a per-table QPS quota is checked before the
result cache, on either engine (`Broker.quota.set_qps_limit`); past it a
query comes back with a QueryQuotaExceededError. A broker-wide gate
(`max_inflight`, `max_queued`, `heavy_query_ms`; off by default) admits a
query whose budget is already running, so the time it waits for a slot
comes out of its own deadline; a full queue, a wait past the deadline or a
heavy query at saturation answers at once with `query_rejected` and a
QueryRejectedError (the queriesRejected meter). Every response is folded
into the workload tracker (cluster/workload.py), whose decayed per-table
cost is the heavy-query hint and, in the /BROKERSTATE/{id} beacon
(`publish_state`), the servers' eviction heat and the prefetcher's input.
Cursors spool a full result and serve it page by page
(`execute_sql_cursor`, `fetch_cursor`); `execute_sql_stream` yields a
selection's pages a server segment at a time and stops at its LIMIT.

Hedging is opt-in (`hedge_ms`, or `hedge_quantile` over the scatterRpcMs
histogram): a shard still in flight past the delay gets a duplicate RPC on
another replica that holds all its segments; the first complete answer
wins, the loser is cancelled by its shard id, and the gather keeps the
shards' submission order, so a hedged answer is bit-identical to an
unhedged one. Cold-aware routing: a server that reports a routed segment
still warming (tiered storage) is avoided for that segment for a short
TTL, and the response counts `cold_segments_warming`. Routing hides the
segments that `/LINEAGE/{table}` hides (the TO set of a replacement in
progress, the FROM set of a committed one), bracketing the ideal-state
read between two lineage reads so a swap never counts rows twice.

The JAX broker reads its defaults from environment variables
(PINOT_TPU_HEDGE_MS, PINOT_TPU_MAX_INFLIGHT_QUERIES, ...); the port's
constructor arguments are the interface, with the defaults those
variables have when unset. cluster/rest.py serves the broker over HTTP
(`/query/sql` answers a rejection with 429, `/debug/workload`,
`/debug/servers`, `/health/readiness` over `is_ready`).
"""

from __future__ import annotations

import copy
import itertools
import threading
import time
import uuid
import zlib
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait
from typing import Optional

from ..cache.keys import query_fingerprint
from ..cache.results import (BrokerResultCache, lineage_epoch,
                             result_cache_enabled)
from ..engine.aggregation import semantics_for
from ..engine.combine import (combine_aggregation, combine_group_arrays,
                              combine_group_by, combine_selection)
from ..engine.explain import analyze_table
from ..engine.perf_ledger import ALERTS, PERF_LEDGER
from ..engine.reduce import BrokerReducer
from ..engine.results import (AggIntermediate, BrokerResponse, DataSchema,
                              GroupArrays, GroupByIntermediate, ResultTable,
                              SelectionIntermediate)
from ..query.context import QueryContext
from ..query.expressions import ExpressionContext
from ..query.filter import FilterContext, Predicate, PredicateType
from ..query.parser.sql import SqlParseError, parse_sql
from ..spi import faults
from ..spi.data_types import Schema
from ..spi.metrics import BROKER_METRICS, BrokerMeter, BrokerTimer
from ..spi.trace import TRACING, sample_decision, trace_sample_rate
from .breaker import CircuitBreakerTable
from .controller import ONLINE, raw_table_name, table_name_with_type
from .datatable import DataTableError
from .datatable import decode as decode_datatable
from .periodic import hidden_from_lineage
from .querylog import QueryLogger
from .quota import (AdmissionController, AdmissionRejectedError,
                    QueryQuotaExceededError, QueryQuotaManager, ResponseStore)
from .store import PropertyStore
from .tracestore import TraceStore
from .transport import RemoteError, RpcClient, TransportError
from .workload import WorkloadTracker

# a query that sets no allowPartialResults fails on a lost segment
ALLOW_PARTIAL_DEFAULT = False
# the end-to-end budget of a query that carries no timeoutMs
BROKER_TIMEOUT_MS = 60000.0
# re-scatter rounds a failed segment gets before the broker degrades
# (partial) or fails the query
SCATTER_RETRIES = 2
# the ceiling of the exponential backoff between those rounds
SCATTER_BACKOFF_CAP_MS = 1000.0
# scatterRpcMs samples the quantile hedge delay needs before it applies
HEDGE_MIN_SAMPLES = 20
# how long a replica that reported a segment still warming is avoided for
# that segment
COLD_HINT_TTL_S = 15.0


def _sql_key(sql: str) -> str:
    """The perf-ledger key of a query without a plan fingerprint."""
    return "sql:%08x" % (zlib.crc32(sql.encode()) & 0xFFFFFFFF)


class _StaleRoutingError(Exception):
    """A routed segment vanished mid-query; the scatter must restart on a
    fresh routing snapshot."""


class _ServerStats:
    """Per-server latency EWMA + in-flight count for adaptive selection
    (reference: pinot-broker/.../routing/adaptiveserverselector/ —
    NumInFlightReqSelector / LatencySelector hybrid)."""

    __slots__ = ("ewma_ms", "inflight")

    def __init__(self):
        self.ewma_ms = 0.0
        self.inflight = 0

    def score(self) -> float:
        return self.ewma_ms * (1.0 + self.inflight)

    def record(self, latency_ms: float, alpha: float = 0.3) -> None:
        self.ewma_ms = (alpha * latency_ms + (1 - alpha) * self.ewma_ms
                        if self.ewma_ms else latency_ms)


class _QueryBudget:
    """Per-query deadline + failure-degradation context, threaded through
    scatter/gather so every RPC is stamped with the REMAINING time budget
    and every degradation decision can consult allowPartialResults."""

    __slots__ = ("deadline", "query_id", "partial_ok", "_shard_seq")

    def __init__(self, timeout_ms: float, partial_ok: bool):
        self.deadline = time.monotonic() + timeout_ms / 1000.0
        self.query_id = uuid.uuid4().hex[:12]
        self.partial_ok = partial_ok
        self._shard_seq = itertools.count()

    def remaining_s(self) -> float:
        return self.deadline - time.monotonic()

    def next_shard_id(self) -> str:
        """One id per scatter RPC (``<query_id>:<n>``): a hedged duplicate
        can be cancelled alone without killing its sibling shards, while a
        broadcast cancel kills the whole ``<query_id>`` prefix."""
        return f"{self.query_id}:{next(self._shard_seq)}"


def _stats_template() -> dict:
    return {"total_docs": 0, "num_segments_processed": 0,
            "num_segments_pruned": 0, "num_segments_queried": 0,
            "num_device_dispatches": 0, "num_compiles": 0,
            "num_segments_cache_hit": 0, "num_segments_cache_miss": 0,
            "scatter_retries": 0, "hedged_requests": 0, "hedge_wins": 0,
            "corrupt_shards_retried": 0, "cold_segments_warming": 0,
            "num_coalesced_queries": 0, "coalesce_wait_ms": 0.0,
            "server_traces": [], "wire": [],
            "servers_queried": [], "servers_responded": [],
            "partial_exceptions": []}


class Broker:
    def __init__(self, store: PropertyStore, num_scatter_threads: int = 8,
                 adaptive_selection: bool = True,
                 scatter_backoff_ms: float = 50.0,
                 hedge_ms: Optional[float] = None,
                 hedge_quantile: float = 0.0,
                 max_inflight: Optional[int] = None,
                 max_queued: Optional[int] = None,
                 heavy_query_ms: float = 0.0,
                 broker_id: Optional[str] = None,
                 state_publish_s: float = 0.0):
        self.store = store
        self.broker_id = broker_id or f"Broker_{uuid.uuid4().hex[:8]}"
        # brokers are store CLIENTS (never in /LIVEINSTANCES), so their
        # load and workload state reaches the controller, the servers'
        # tiers and the prefetcher through /BROKERSTATE beacons. Publishing
        # from the query path is opt-in (`state_publish_s` > 0) and at most
        # once an interval: the common case is one clock comparison.
        self._state_publish_s = float(state_publish_s or 0.0)
        self._state_published_at = 0.0
        # per-server circuit breakers drive replica selection and the
        # serversUnhealthy gauge
        self.breakers = CircuitBreakerTable()
        # the first replica retry's backoff, doubling up to the cap
        self.backoff_base_s = scatter_backoff_ms / 1000.0
        BROKER_METRICS.set_gauge("serversUnhealthy",
                                 self.breakers.down_count)
        # hedging is OPT-IN (a fixed `hedge_ms`, or `hedge_quantile` over
        # the scatterRpcMs histogram): a duplicate RPC changes the
        # cluster's call pattern, which must never happen behind the back
        # of a deterministic fault schedule
        self.hedge_fixed_ms = hedge_ms
        self.hedge_quantile = float(hedge_quantile or 0.0)
        self.hedge_min_samples = HEDGE_MIN_SAMPLES
        # broker-wide admission gate; disabled by default (then admit() is
        # a plain yield)
        self.admission = AdmissionController(max_inflight, max_queued,
                                             heavy_query_ms)
        BROKER_METRICS.set_gauge("brokerQueriesInflight",
                                 lambda: self.admission.inflight())
        BROKER_METRICS.set_gauge("brokerQueriesQueued",
                                 lambda: self.admission.queued())
        self.quota = QueryQuotaManager()
        self.response_store = ResponseStore()
        # per-query cost accounting into decaying per-table and per-client
        # rollups: the admission cost hint and the beacon's table costs
        self.workload = WorkloadTracker()
        self.adaptive_selection = adaptive_selection
        # full-response cache (cache/results.py): keyed on the query
        # fingerprint + the table's lineage epoch, so a segment add, drop
        # or replace makes old entries unreachable
        self.result_cache = BrokerResultCache()
        # flight recorder: retained traces (head-sampled + tail-captured
        # slow/partial/failed); the query logger links its slow entries
        # to retained trace ids
        self.trace_store = TraceStore()
        # supplier gauges: polled only when the metrics are snapshotted,
        # the query path never pays for them
        BROKER_METRICS.set_gauge("traceStoreTraces",
                                 lambda: self.trace_store.stats()["traces"])
        BROKER_METRICS.set_gauge("traceStoreBytes",
                                 lambda: self.trace_store.stats()["bytes"])
        BROKER_METRICS.set_gauge("ledgerFingerprints",
                                 lambda: len(PERF_LEDGER))
        BROKER_METRICS.set_gauge(
            "exemplarsPinned",
            lambda: self.trace_store.stats()["alertExemplars"])
        BROKER_METRICS.set_gauge(
            "traceStoreEvictions",
            lambda: self.trace_store.stats()["evictions"])
        self.query_logger = QueryLogger(trace_store=self.trace_store)
        self._server_stats: dict[str, _ServerStats] = {}
        # last successfully computed routing per table: a control-plane
        # outage degrades to serving the last external view
        self._last_routing: dict[str, dict[str, list[str]]] = {}
        self._clients: dict[str, RpcClient] = {}
        # cold-aware routing hints (tiered storage): (instance, segment) →
        # hint expiry, learned from cold_segments warming reports; while a
        # hint is live, selection prefers replicas holding the segment
        # resident, and when none does the pick triggers the warm
        self._cold_hints: dict[tuple, float] = {}
        self._cold_hint_ttl = COLD_HINT_TTL_S
        self._rr = 0  # round-robin cursor for replica selection
        self._pool = ThreadPoolExecutor(max_workers=num_scatter_threads,
                                        thread_name_prefix="broker-scatter")
        self._lock = threading.Lock()

    def close(self) -> None:
        """Release the scatter threads, pooled connections and the
        multi-stage dispatcher."""
        dispatcher = getattr(self, "_mse_dispatcher", None)
        if dispatcher is not None:
            dispatcher.close()
        self._pool.shutdown(wait=True)
        with self._lock:
            clients, self._clients = list(self._clients.values()), {}
        for c in clients:
            c.close()

    # -- health -------------------------------------------------------------
    def is_ready(self) -> bool:
        """Readiness = at least one materialized routing snapshot: before
        the first successful routing read every query would fail routing,
        so orchestrators should not send traffic yet. Serves the REST
        GET /health[/readiness] (liveness is unconditional)."""
        with self._lock:
            if self._last_routing:
                return True
        # no query has warmed routing yet: try to materialize one now so a
        # freshly-started broker over a healthy store turns ready without
        # needing traffic first
        tables = self.store.children("/CONFIGS/TABLE")
        if not tables:
            return True  # nothing to route — vacuously ready
        for nwt in tables:
            try:
                self.routing_table(nwt)
                return True
            except Exception:
                continue
        return False

    def publish_state(self) -> dict:
        """Write this broker's beacon to /BROKERSTATE/{id}: breaker
        states, admission load, latency quantiles, result-cache counters
        and the per-table decayed query cost the servers' tiers weigh
        eviction by and the StoragePrefetcher ranks hot tables by. Called
        from the query path when `state_publish_s` is set, or directly."""
        state = {
            "brokerId": self.broker_id,
            "publishedAtMs": int(time.time() * 1000),
            "breakers": self.breakers.snapshot(),
            "inflight": self.admission.inflight(),
            "queued": self.admission.queued(),
            "queryP50Ms": round(BROKER_METRICS.timer_quantile(
                BrokerTimer.QUERY_PROCESSING_TIME_MS, 0.5), 3),
            "queryP99Ms": round(BROKER_METRICS.timer_quantile(
                BrokerTimer.QUERY_PROCESSING_TIME_MS, 0.99), 3),
            "resultCacheHits": BROKER_METRICS.meter_count(
                BrokerMeter.RESULT_CACHE_HITS),
            "resultCacheMisses": BROKER_METRICS.meter_count(
                BrokerMeter.RESULT_CACHE_MISSES),
            "tableCostsMs": self.workload.table_costs(),
        }
        self.store.set(f"/BROKERSTATE/{self.broker_id}", state)
        return state

    def server_health(self) -> dict:
        """Breaker and adaptive-selection state per server (the JAX
        broker's GET /debug/servers)."""
        breakers = self.breakers.snapshot()
        with self._lock:
            stats = {i: {"ewmaLatencyMs": round(s.ewma_ms, 3),
                         "inflight": s.inflight}
                     for i, s in self._server_stats.items()}
        out = {}
        for inst in sorted(set(breakers) | set(stats)):
            entry = dict(breakers.get(inst) or {
                "state": "closed", "consecutiveFailures": 0,
                "cooldownS": self.breakers.base_cooldown_s,
                "timesOpened": 0})
            entry.update(stats.get(inst, {}))
            out[inst] = entry
        return out

    # -- routing ------------------------------------------------------------
    def routing_table(self, name_with_type: str) -> dict[str, list[str]]:
        """segment → online instances, from the external view (reference:
        BrokerRoutingManager watching ExternalView). A failed routing read
        falls back to the last successful snapshot for the table; with no
        snapshot yet the failure propagates."""
        try:
            out = self._routing_table_uncached(name_with_type)
        except Exception:
            with self._lock:
                last = self._last_routing.get(name_with_type)
            if last is None:
                raise
            BROKER_METRICS.add_meter(BrokerMeter.ROUTING_FROM_LAST_VIEW)
            return {seg: list(insts) for seg, insts in last.items()}
        with self._lock:
            self._last_routing[name_with_type] = out
        return out

    def _routing_table_uncached(self, name_with_type: str) -> dict[str, list[str]]:
        if faults.ACTIVE:
            faults.FAULTS.fire("broker.route", table=name_with_type)
        # lineage is read BEFORE and AFTER the ideal-state read: if a
        # replacement committed in between (entry state changed/vanished),
        # the ideal snapshot may contain FROM ∪ TO with nothing hidden —
        # re-snapshot instead of double counting. A stable pair of lineage
        # reads brackets the ideal read into one routing generation.
        for _ in range(5):
            lineage_before = self.store.get(f"/LINEAGE/{name_with_type}")
            view = self.store.get(f"/EXTERNALVIEW/{name_with_type}") or {}
            ideal = self.store.get(f"/IDEALSTATES/{name_with_type}") or {}
            live = set(self.store.children("/LIVEINSTANCES"))
            if self.store.get(f"/LINEAGE/{name_with_type}") == lineage_before:
                break
        hidden = hidden_from_lineage(lineage_before)
        return {seg: sorted(i for i, st in (view.get(seg) or {}).items()
                            if st == ONLINE and i in live)
                for seg in ideal if seg not in hidden}

    def _client(self, instance: str) -> RpcClient:
        cfg = self.store.get(f"/LIVEINSTANCES/{instance}") or \
            self.store.get(f"/INSTANCECONFIGS/{instance}")
        with self._lock:
            c = self._clients.get(instance)
            # a restarted server re-registers under a new address; a cached
            # client pointing at the old one must not linger
            if c is not None and cfg is not None and \
                    (c.host, c.port) != (cfg["host"], cfg["port"]):
                self._clients.pop(instance, None)
                c = None
            if c is None:
                if cfg is None:
                    raise TransportError(f"no address for {instance}")
                c = RpcClient(cfg["host"], cfg["port"])
                self._clients[instance] = c
            return c

    def _select_instances(self, routing: dict[str, list[str]],
                          unavailable_sink: Optional[list] = None
                          ) -> dict[str, list[str]]:
        """instance → segments over healthy replicas: the least loaded by
        latency EWMA and in-flight count (adaptive), else round-robin
        (reference: BalancedInstanceSelector). With ``unavailable_sink``
        (partial-results mode), segments with no online replica are
        appended to the sink instead of failing the query."""
        plan: dict[str, list[str]] = {}
        unavailable = []
        with self._lock:
            self._rr += 1
            rr = self._rr
            hints = dict(self._cold_hints) if self._cold_hints else None
        now = time.monotonic() if hints else 0.0
        for seg, replicas in routing.items():
            # breaker-gated: open breakers are skipped; if EVERY replica is
            # tripped the query still goes out (last-resort traffic beats a
            # guaranteed failure, and doubles as probing)
            healthy = [i for i in replicas if self.breakers.allow(i)]
            candidates = healthy or replicas
            if hints:
                # cold-aware routing: prefer a replica NOT recently seen
                # warming this segment; when every replica is cold, fall
                # through and let the pick trigger the warm
                resident = [i for i in candidates
                            if hints.get((i, seg), 0.0) <= now]
                candidates = resident or candidates
            if not candidates:
                unavailable.append(seg)
                continue
            if self.adaptive_selection:
                # ties break on a per-process hash: which replica serves a
                # segment is not stable across processes, the answer is
                with self._lock:
                    pick = min(candidates, key=lambda i: (
                        self._server_stats.setdefault(i, _ServerStats()).score(),
                        (hash(i) + rr) % 97))
            else:
                pick = candidates[rr % len(candidates)]
            plan.setdefault(pick, []).append(seg)
        if unavailable:
            if unavailable_sink is not None:
                unavailable_sink.extend(unavailable)
            else:
                raise TransportError(
                    f"no online replica for segments {unavailable}")
        return plan

    def _note_cold(self, inst: str, seg: str) -> None:
        """A server reported `seg` cold (still warming): route the next
        queries to other replicas for the hint TTL, then forget: the warm
        completes in the background, so the hint must expire."""
        now = time.monotonic()
        with self._lock:
            if len(self._cold_hints) > 4096:
                self._cold_hints = {
                    k: t for k, t in self._cold_hints.items() if t > now}
            self._cold_hints[(inst, seg)] = now + self._cold_hint_ttl

    # -- query --------------------------------------------------------------
    def execute_sql(self, sql: str,
                    segments: Optional[dict] = None) -> BrokerResponse:
        """``segments``: optional {tableNameWithType: [segment, ...]}
        restriction (an explicit searchSegments list). Every response,
        the multi-stage ones and the failures included, passes the
        flight recorder's funnel: trace retention, the query log, the
        perf ledger."""
        t0 = time.perf_counter()
        try:
            query = parse_sql(sql)
        except SqlParseError as e:
            # shapes the single-stage grammar rejects (joins, subqueries,
            # set operations) go to the multi-stage dispatcher, the
            # reference's cross-engine fallback at the broker
            resp = self._admitted_mse(sql)
            if resp.exceptions and any(
                    x.startswith(("SqlParseError", "PlanError", "ParseError"))
                    for x in resp.exceptions):
                # neither grammar accepts it: the V1 error names the
                # query's syntax problem; an MSE execution failure passes
                resp = BrokerResponse(exceptions=[f"SqlParseError: {e}"])
            query = None
        if query is not None:
            if query.query_options.get("useMultistageEngine") in (
                    True, "true", 1):
                resp = self._admitted_mse(sql)
            else:
                resp = self._execute_sql_impl(query, segments, sql)
        if not resp.time_used_ms:
            resp.time_used_ms = (time.perf_counter() - t0) * 1000
        # the broker-side end-to-end latency histogram
        BROKER_METRICS.update_timer(BrokerTimer.QUERY_PROCESSING_TIME_MS,
                                    resp.time_used_ms)
        table = ""
        if query is not None:
            table = query.table_name
            BROKER_METRICS.add_table_meter(table, BrokerMeter.QUERIES)
        # retention BEFORE the query log, so a slow entry links the
        # retained trace id
        self._retain_trace(resp, table)
        try:
            self.query_logger.log(sql, resp, table=table)
        except Exception:
            pass  # the query log must never fail a query
        try:
            self.workload.note_response(sql, resp, table=table)
        except Exception:
            pass  # nor may the workload accounting
        self._record_ledger(sql, resp, table)
        if getattr(resp, "trace_sampled", False):
            # the client never asked for this trace: the store and the
            # query log took their copies, the response ships plain
            resp.trace_info = None
        if self._state_publish_s and time.monotonic() \
                - self._state_published_at >= self._state_publish_s:
            self._state_published_at = time.monotonic()
            try:
                self.publish_state()
            except Exception:
                pass  # a glitching store must not fail the query
        return resp

    def _retain_trace(self, resp: BrokerResponse, table: str) -> None:
        """Offer every traced completion, head-sampled or asked for, to
        the TraceStore under its query id. Tail capture PINS the traces
        that matter most (slow, partial, failed, alert exemplars): they
        outlive healthy samples when the byte budget evicts."""
        if not resp.trace_info or not resp.query_id:
            return
        time_ms = resp.time_used_ms or 0
        n_exc = len(resp.exceptions or [])
        partial = resp.partial_result
        slow = time_ms >= self.query_logger.slow_threshold_ms
        if n_exc:
            reason = "failed"
        elif partial:
            reason = "partial"
        elif slow:
            reason = "slow"
        elif getattr(resp, "trace_sampled", False):
            reason = "sampled"
        else:
            reason = "traced"
        alert_id = getattr(resp, "_alert_id", "") or ""
        try:
            resp.trace_id = self.trace_store.offer(
                resp.query_id, resp.trace_info, reason=reason,
                pinned=bool(n_exc or partial or slow or alert_id),
                table=table, time_ms=time_ms, exceptions=n_exc,
                partial=partial, alert_id=alert_id)
            if alert_id:
                # the alert record links back to its pinned exemplars
                ALERTS.note_exemplar(alert_id, resp.trace_id)
        except Exception:
            pass  # retention is best-effort; never fail the query for it

    def _record_ledger(self, sql: str, resp: BrokerResponse,
                       table: str) -> None:
        """The plan's perf-ledger bump: counter arithmetic over fields the
        response carries. The key is the plan fingerprint when the
        result-cache path computed one, a crc of the SQL text otherwise:
        never a fresh canonicalization walk."""
        try:
            key = getattr(resp, "_ledger_key", None)
            if key is None:
                key = _sql_key(sql)
            crossings = bytes_shuffled = 0
            for st in (resp.mse_stage_stats or {}).values():
                crossings += int(st.get("host_crossings", 0) or 0)
                bytes_shuffled += int(st.get("shuffled_bytes", 0) or 0)
            PERF_LEDGER.record(
                key, table=table, time_ms=resp.time_used_ms or 0.0,
                error=bool(resp.exceptions), partial=resp.partial_result,
                dispatches=resp.num_device_dispatches,
                compiles=resp.num_compiles,
                cache_outcome=resp.cache_outcome or "",
                seg_cache_hits=resp.num_segments_cache_hit,
                seg_cache_misses=resp.num_segments_cache_miss,
                coalesced=resp.num_coalesced_queries,
                host_crossings=crossings, bytes_shuffled=bytes_shuffled,
                sql=sql)
        except Exception:
            pass  # the ledger must never fail a query

    def execute_sql_mse(self, sql: str) -> BrokerResponse:
        """Multi-stage execution across the servers: plan fragments travel
        to stage workers, shuffle blocks cross the TCP transport, the final
        receive is here (reference: MultiStageBrokerRequestHandler →
        QueryDispatcher.submitAndReduce)."""
        return self.mse_dispatcher.execute_sql(sql)

    def _admitted_mse(self, sql: str) -> BrokerResponse:
        """The multi-stage dispatch behind the same admission gate as the
        single-stage path (its quota check runs in the dispatcher, over
        every table a leaf stage scans)."""
        try:
            with self.admission.admit(timeout_s=BROKER_TIMEOUT_MS / 1000.0):
                return self.execute_sql_mse(sql)
        except AdmissionRejectedError as e:
            return self._rejected_response(e)

    def _rejected_response(self, e: Exception) -> BrokerResponse:
        BROKER_METRICS.add_meter(BrokerMeter.QUERIES_REJECTED)
        return BrokerResponse(exceptions=[f"QueryRejectedError: {e}"],
                              query_rejected=True)

    def execute_sql_cursor(self, sql: str, num_rows: int = 1000) -> dict:
        """Spool the full result and return the first page with its cursor
        id (reference: the getCursor=true query option and the
        /resultStore endpoints); later pages come from fetch_cursor()."""
        resp = self.execute_sql(sql)
        if resp.exceptions or resp.result_table is None:
            return {"exceptions": resp.exceptions}
        rt = resp.result_table
        cursor_id = self.response_store.create_cursor(
            rt.schema.column_names, rt.schema.column_types, rt.rows)
        return self.response_store.fetch(cursor_id, 0, num_rows)

    def fetch_cursor(self, cursor_id: str, offset: int,
                     num_rows: int = 1000) -> dict:
        return self.response_store.fetch(cursor_id, offset, num_rows)

    def execute_sql_stream(self, sql: str):
        """Streaming query: a generator of ResultTable pages (reference:
        the gRPC streaming broker path). A selection WITHOUT order-by or
        offset streams one page per server segment as it completes and
        stops early once LIMIT rows have been emitted; other shapes
        (aggregation, group-by, order-by, offset) run whole and yield one
        page."""
        try:
            query = parse_sql(sql)
        except SqlParseError as e:
            raise ValueError(f"SqlParseError: {e}") from None
        streamable = (not query.is_aggregation_query and not query.is_group_by
                      and not query.distinct
                      and not query.order_by_expressions
                      and not query.offset)
        if not streamable:
            resp = self.execute_sql(sql)
            if resp.exceptions:
                raise RuntimeError("; ".join(resp.exceptions))
            yield resp.result_table
            return
        raw = raw_table_name(query.table_name)
        schema_json = self.store.get(f"/SCHEMAS/{raw}")
        reducer = BrokerReducer(
            Schema.from_json(schema_json) if schema_json else None)
        remaining = query.limit
        for ttype in ("OFFLINE", "REALTIME"):
            nwt = table_name_with_type(raw, ttype)
            if self.store.get(f"/CONFIGS/TABLE/{nwt}") is None:
                continue
            routing = self.routing_table(nwt)
            if not routing:
                continue
            plan = self._select_instances(routing)
            sub = _with_filter(query, nwt, None)
            for inst, segs in plan.items():
                stream = self._client(inst).call_stream(
                    {"type": "query_stream", "table": nwt,
                     "segments": segs, "query": sub})
                for blob in stream:
                    combined, _st = decode_datatable(blob)
                    if isinstance(combined, SelectionIntermediate) and \
                            not combined.rows:
                        continue
                    page = reducer.reduce(sub, combined)
                    if remaining is not None:
                        page.rows = page.rows[:remaining]
                        remaining -= len(page.rows)
                    if page.rows:
                        yield page
                    if remaining is not None and remaining <= 0:
                        stream.close()  # early termination
                        return

    @property
    def mse_dispatcher(self):
        """The multi-stage dispatcher with its mailbox endpoint, built on
        the first multi-stage statement."""
        with self._lock:
            if not hasattr(self, "_mse_dispatcher"):
                from ..mse.distributed import DistributedMseDispatcher

                self._mse_dispatcher = DistributedMseDispatcher(self)
            return self._mse_dispatcher

    def _execute_sql_impl(self, query: QueryContext, segments: Optional[dict],
                          sql: str) -> BrokerResponse:
        t0 = time.perf_counter()
        if getattr(query, "explain", False) == "analyze":
            # EXPLAIN ANALYZE: run the scatter for real with tracing armed
            # (caches live) and render ONE merged broker-side tree
            try:
                return self._execute_analyze(query, segments, t0)
            except Exception as e:
                return BrokerResponse(exceptions=[f"{type(e).__name__}: {e}"])
        if getattr(query, "explain", False):
            # plan-only: route to ONE server hosting routed segments
            try:
                return self._explain(query)
            except Exception as e:
                return BrokerResponse(exceptions=[f"{type(e).__name__}: {e}"])
        try:
            self.quota.acquire(raw_table_name(query.table_name))
        except QueryQuotaExceededError as e:
            return BrokerResponse(
                exceptions=[f"QueryQuotaExceededError: {e}"])
        ck = self._result_cache_key(query, segments)
        ledger_key = f"fp:{str(ck[0])[:16]}" if ck is not None else None
        if ck is not None:
            cached = self.result_cache.get(ck)
            if cached is not None:
                BROKER_METRICS.add_meter(BrokerMeter.RESULT_CACHE_HITS)
                cached.cache_outcome = "hit"
                cached.time_used_ms = (time.perf_counter() - t0) * 1000
                cached._ledger_key = ledger_key
                return cached
        # exemplar pinning (engine/perf_ledger.py): ONE attribute read while
        # disarmed; when the sentinel armed this plan or table, the claim
        # forces head sampling and tags the trace with the alert
        exemplar_alert = None
        if PERF_LEDGER.exemplar_armed:
            exemplar_alert = PERF_LEDGER.claim_exemplar(
                ledger_key or _sql_key(sql), query.table_name)
        # admission control (load shedding): the budget starts ticking NOW,
        # so time queued for a broker slot comes out of the query's own
        # deadline; an overloaded broker sheds with a 429-style rejection
        # instead of stacking unbounded work
        budget = _QueryBudget(self._timeout_ms(query),
                              self._partial_allowed(query))
        try:
            with self.admission.admit(
                    timeout_s=budget.remaining_s(),
                    cost_hint_ms=self.workload.expected_cost_ms(
                        raw_table_name(query.table_name))):
                resp = self._execute(query, only_segments=segments,
                                     budget=budget,
                                     force_trace=bool(exemplar_alert))
        except AdmissionRejectedError as e:
            resp = self._rejected_response(e)
        except Exception as e:
            resp = BrokerResponse(exceptions=[f"{type(e).__name__}: {e}"],
                                  query_id=budget.query_id)
        resp.time_used_ms = (time.perf_counter() - t0) * 1000
        resp.cache_outcome = "miss" if ck is not None else "bypass"
        if ledger_key is not None:
            resp._ledger_key = ledger_key
        if exemplar_alert:
            resp._alert_id = exemplar_alert
        if ck is not None and not resp.exceptions \
                and not resp.partial_result \
                and resp.result_table is not None:
            BROKER_METRICS.add_meter(BrokerMeter.RESULT_CACHE_MISSES)
            if getattr(resp, "trace_sampled", False) and resp.trace_info:
                # a head-sampled query is cacheable (the client never asked
                # for a trace), but the cached copy is plain, or the next
                # client's hit would replay a stale trace
                plain = copy.copy(resp)
                plain.trace_info = None
                plain.trace_sampled = False
                self.result_cache.put(ck, plain)
            else:
                self.result_cache.put(ck, resp)
        return resp

    def _execute_analyze(self, query: QueryContext,
                         segments: Optional[dict],
                         t0: float) -> BrokerResponse:
        """EXPLAIN ANALYZE at the broker: consult the result cache first
        (a warm hit renders with zero dispatches), otherwise scatter the
        real query with an analyze-flagged trace and render the merged
        cross-server span tree as the annotated plan."""
        raw = raw_table_name(query.table_name)
        ck = self._result_cache_key(query, segments)
        if ck is not None:
            cached = self.result_cache.get(ck)
            if cached is not None:
                BROKER_METRICS.add_meter(BrokerMeter.RESULT_CACHE_HITS)
                base = copy.copy(cached)
                base.cache_outcome = "hit"
                base.time_used_ms = (time.perf_counter() - t0) * 1000
                out = copy.copy(base)
                out.result_table = analyze_table(
                    base.trace_info or [], base, table_name=raw)
                return out
        sub = copy.copy(query)
        sub.explain = False
        sub.query_options = dict(query.query_options)
        sub.query_options["trace"] = True
        # the analyze marker rides the query to every server so their
        # traces keep the cache tiers live (spi/trace.py analyze flag)
        sub.query_options["analyze"] = True
        budget = _QueryBudget(self._timeout_ms(query),
                              self._partial_allowed(query))
        try:
            with self.admission.admit(
                    timeout_s=budget.remaining_s(),
                    cost_hint_ms=self.workload.expected_cost_ms(raw)):
                resp = self._execute(sub, only_segments=segments,
                                     budget=budget)
        except AdmissionRejectedError as e:
            return self._rejected_response(e)
        resp.time_used_ms = (time.perf_counter() - t0) * 1000
        if resp.exceptions:
            return resp
        resp.cache_outcome = "miss" if ck is not None else "bypass"
        if ck is not None and not resp.partial_result \
                and resp.result_table is not None:
            # cache the PLAIN result (trace scrubbed): the next run — plain
            # or ANALYZE — hits, and ANALYZE then reports cache: hit
            BROKER_METRICS.add_meter(BrokerMeter.RESULT_CACHE_MISSES)
            plain = copy.copy(resp)
            plain.trace_info = None
            self.result_cache.put(ck, plain)
        out = copy.copy(resp)
        out.result_table = analyze_table(resp.trace_info or [], resp,
                                         table_name=raw)
        return out

    def _result_cache_key(self, query: QueryContext,
                          only_segments: Optional[dict]) -> Optional[tuple]:
        """No explicit segment restriction, no trace, no SET
        resultCache=false, no non-deterministic functions, and no REALTIME
        half (a consuming snapshot's rows advance without any lineage
        event). Returns the (query_fp, table, lineage epoch) key, or None
        → bypass."""
        if only_segments is not None or not result_cache_enabled():
            return None
        opt = query.query_options.get("resultCache")
        if opt is not None and str(opt).lower() in ("false", "0", "off"):
            return None
        if query.query_options.get("trace") in (True, "true", 1):
            return None
        text = str(query).lower()
        if "now(" in text or "rand(" in text or "ago(" in text:
            return None
        raw = raw_table_name(query.table_name)
        if self.store.get(
                f"/CONFIGS/TABLE/{table_name_with_type(raw, 'REALTIME')}") \
                is not None:
            return None
        fp = query_fingerprint(query)
        if fp is None:
            return None
        offline = table_name_with_type(raw, "OFFLINE")
        return (fp, offline, lineage_epoch(self.store, offline))

    def _explain(self, query: QueryContext) -> BrokerResponse:
        raw = raw_table_name(query.table_name)
        for ttype in ("OFFLINE", "REALTIME"):
            nwt = table_name_with_type(raw, ttype)
            if self.store.get(f"/CONFIGS/TABLE/{nwt}") is None:
                continue
            routing = self.routing_table(nwt)
            if not routing:
                continue
            plan = self._select_instances(routing)
            inst, segs = next(iter(plan.items()))
            out = self._client(inst).call({
                "type": "explain", "table": nwt, "segments": segs,
                "query": query})
            return BrokerResponse(result_table=ResultTable(
                DataSchema(out["columns"], out["types"]), out["rows"]))
        return BrokerResponse(
            exceptions=[f"table {raw} not found or has no routable segments"])

    def _execute(self, query: QueryContext,
                 only_segments: Optional[dict] = None,
                 budget: Optional[_QueryBudget] = None,
                 force_trace: bool = False) -> BrokerResponse:
        t_route = time.perf_counter()
        raw = raw_table_name(query.table_name)
        offline = table_name_with_type(raw, "OFFLINE")
        realtime = table_name_with_type(raw, "REALTIME")
        has_offline = self.store.get(f"/CONFIGS/TABLE/{offline}") is not None
        has_realtime = self.store.get(f"/CONFIGS/TABLE/{realtime}") is not None
        if not has_offline and not has_realtime:
            return BrokerResponse(exceptions=[f"table {raw} not found"])

        halves: list[tuple[str, Optional[FilterContext]]] = []
        if has_offline and has_realtime:
            boundary = self._time_boundary(offline)
            time_col = (self.store.get(f"/CONFIGS/TABLE/{offline}") or {}).get(
                "timeColumn")
            if boundary is not None and time_col:
                # hybrid split (reference TimeBoundaryManager:56):
                # offline ≤ boundary < realtime
                halves.append((offline, _range_filter(time_col, None, boundary)))
                halves.append((realtime, _range_filter(time_col, boundary, None)))
            else:
                halves.append((offline, None))
                halves.append((realtime, None))
        else:
            halves.append((offline if has_offline else realtime, None))

        schema_json = self.store.get(f"/SCHEMAS/{raw}")
        schema = Schema.from_json(schema_json) if schema_json else None

        if budget is None:
            budget = _QueryBudget(self._timeout_ms(query),
                                  self._partial_allowed(query))

        # the broker owns the root trace; each server ships its own span
        # list back next to the DataTable and they are merged (ids
        # namespaced per instance) into one response trace_info. Head
        # sampling: with PINOT_TPU_TRACE_SAMPLE set, a production query
        # whose id hashes into the rate is traced here and on every server
        # (each strips its `:<n>` shard suffix and decides the same), with
        # no option on the wire; analyze=True keeps the caches live, so a
        # sampled query behaves as its unsampled twin. `force_trace` is an
        # exemplar claim: sampled whatever the rate.
        trace = None
        sampled = False
        if TRACING.active_trace() is None:
            if query.query_options.get("trace") in (True, "true", 1):
                trace = TRACING.start_trace(
                    f"broker:{raw}",
                    analyze=query.query_options.get("analyze") in
                    (True, "true", 1))
            elif force_trace or sample_decision(budget.query_id,
                                                trace_sample_rate()):
                sampled = True
                trace = TRACING.start_trace(f"broker:{raw}", analyze=True)
        stats_sum = _stats_template()
        route_ms = (time.perf_counter() - t_route) * 1000
        try:
            try:
                with TRACING.scope("BROKER_SCATTER"):
                    all_results = []
                    for name_with_type, extra_filter in halves:
                        sub = _with_filter(query, name_with_type, extra_filter)
                        all_results.extend(self._scatter_gather(
                            name_with_type, sub, stats_sum, budget,
                            only_segments=(only_segments or {}).get(
                                name_with_type)))
            except TimeoutError:
                # broker abandons the query: best-effort cancel so server
                # device work stops (lands on ResourceAccountant.kill_prefix)
                BROKER_METRICS.add_meter(BrokerMeter.DEADLINE_EXCEEDED)
                self._broadcast_cancel(budget, stats_sum)
                raise
            t_reduce = time.perf_counter()
            with TRACING.scope("BROKER_REDUCE"):
                combined = self._merge(query, all_results)
                result = BrokerReducer(schema).reduce(query, combined)
            reduce_ms = (time.perf_counter() - t_reduce) * 1000
        finally:
            if trace is not None:
                TRACING.end_trace()
        trace_info = None
        if trace is not None:
            trace_info = trace.to_json()
            # span ids are namespaced per (instance, shard ordinal): a
            # retried shard can land a second trace from one instance
            shard_ordinal: dict[str, int] = {}
            for inst, server_spans in stats_sum["server_traces"]:
                n = shard_ordinal.get(inst, 0)
                shard_ordinal[inst] = n + 1
                prefix = inst if n == 0 else f"{inst}#{n}"
                for s in server_spans:
                    s = dict(s)
                    s["spanId"] = f"{prefix}:{s['spanId']}"
                    if s.get("parentId") is not None:
                        s["parentId"] = f"{prefix}:{s['parentId']}"
                    else:
                        s["server"] = inst
                    trace_info.append(s)
        queried = sorted(set(stats_sum["servers_queried"]))
        responded = sorted(set(stats_sum["servers_responded"]))
        partial_notes = stats_sum["partial_exceptions"]
        wire = stats_sum["wire"]
        for w in wire:
            w["routeMs"] = route_ms
            w["mergeReduceMs"] = reduce_ms
        resp = BrokerResponse(
            result_table=result,
            num_docs_scanned=getattr(combined, "num_docs_scanned", 0),
            total_docs=stats_sum["total_docs"],
            num_segments_queried=stats_sum["num_segments_queried"],
            num_segments_processed=stats_sum["num_segments_processed"],
            num_segments_pruned=stats_sum["num_segments_pruned"],
            num_groups_limit_reached=getattr(combined, "groups_trimmed",
                                             False),
            num_device_dispatches=stats_sum["num_device_dispatches"],
            num_compiles=stats_sum["num_compiles"],
            num_segments_cache_hit=stats_sum["num_segments_cache_hit"],
            num_segments_cache_miss=stats_sum["num_segments_cache_miss"],
            num_servers_queried=len(queried),
            num_servers_responded=len(responded),
            num_scatter_retries=stats_sum["scatter_retries"],
            num_hedged_requests=stats_sum["hedged_requests"],
            num_hedge_wins=stats_sum["hedge_wins"],
            num_corrupt_shards_retried=stats_sum["corrupt_shards_retried"],
            cold_segments_warming=stats_sum["cold_segments_warming"],
            num_coalesced_queries=stats_sum["num_coalesced_queries"],
            coalesce_wait_ms=stats_sum["coalesce_wait_ms"],
            query_id=budget.query_id,
            wire_stats=wire,
        )
        if partial_notes:
            # degraded gather: merged answer of the responding servers only,
            # flagged partial with per-server exceptions — and never cached
            resp.partial_result = True
            resp.exceptions = list(partial_notes)
            BROKER_METRICS.add_meter(BrokerMeter.PARTIAL_RESULTS)
            if any(n.startswith("TimeoutError") for n in partial_notes):
                BROKER_METRICS.add_meter(BrokerMeter.DEADLINE_EXCEEDED)
                self._broadcast_cancel(budget, stats_sum)
        if trace_info is not None:
            resp.trace_info = trace_info
        # the execute_sql funnel strips a trace the client never asked for
        # after the trace store and the query log took their copies
        resp.trace_sampled = sampled
        return resp

    def _timeout_ms(self, query: QueryContext) -> float:
        opt = query.query_options.get("timeoutMs")
        if opt is not None:
            try:
                return float(opt)
            except (TypeError, ValueError):
                pass
        return BROKER_TIMEOUT_MS

    def _partial_allowed(self, query: QueryContext) -> bool:
        opt = query.query_options.get("allowPartialResults")
        if opt is None:
            return ALLOW_PARTIAL_DEFAULT
        return opt in (True, 1) or str(opt).lower() in ("true", "1", "on")

    def _broadcast_cancel(self, budget: _QueryBudget, stats_sum: dict) -> None:
        """Best-effort cancel to every server that was sent a shard of the
        query but never responded; the server resolves the queryId PREFIX
        through the accountant so the segment loop's check_cancel stops
        device work, and a shard that hasn't registered yet dies on
        arrival via the accountant's tombstone."""
        pending = set(stats_sum.get("servers_queried", [])) - \
            set(stats_sum.get("servers_responded", []))
        for inst in pending:
            try:
                self._client(inst).call(
                    {"type": "cancel", "queryId": budget.query_id,
                     "prefix": True, "reason": "broker deadline exceeded"},
                    retry=False, timeout=2.0)
            except (TransportError, RemoteError):
                pass  # cancel is advisory; the server may already be gone

    def _cancel_shard(self, inst: str, shard_qid: str) -> None:
        """Cancel one hedging loser by its shard id, off-thread (the
        loser's server is usually the slow one: never block the winner on
        it). The server's accountant kills the shard's tracker, or
        tombstones the id so it dies on arrival, and its segment loop's
        check_cancel stops the device work. Uses a DEDICATED connection,
        never the pooled per-instance client: the losing RPC itself holds
        a pooled connection right now."""
        cfg = self.store.get(f"/LIVEINSTANCES/{inst}") or \
            self.store.get(f"/INSTANCECONFIGS/{inst}") or {}
        host, port = cfg.get("host"), cfg.get("port")
        if port is None:
            return  # instance gone; nothing left to cancel

        def _send():
            client = RpcClient(host, port, timeout=2.0)
            try:
                client.call(
                    {"type": "cancel", "queryId": shard_qid,
                     "reason": "hedged duplicate superseded"},
                    retry=False, timeout=2.0)
            except (TransportError, RemoteError):
                pass  # advisory, as the broadcast cancel
            finally:
                client.close()

        threading.Thread(target=_send, daemon=True,
                         name="broker-hedge-cancel").start()

    def _scatter_gather(self, table: str, query: QueryContext, stats_sum: dict,
                        budget: _QueryBudget,
                        only_segments: Optional[list] = None):
        """Scatter with a bounded whole-query restart: when a routed segment
        vanishes from routing mid-flight, per-segment retry would double-
        or under-count, so re-snapshot the routing and re-run. Per-attempt
        accounting lives in ``local`` and merges only on success."""
        last: Exception | None = None
        for _ in range(3):
            local = _stats_template()
            try:
                results = self._scatter_gather_once(
                    table, query, local, budget, only_segments)
            except _StaleRoutingError as e:
                last = e
                continue
            except TimeoutError:
                # the deadline path needs the attempt's server lists so
                # _broadcast_cancel knows which servers still hold a shard
                for k in ("servers_queried", "servers_responded"):
                    stats_sum[k].extend(local[k])
                raise
            for k, v in local.items():
                if isinstance(v, list):
                    stats_sum[k].extend(v)
                else:
                    stats_sum[k] += v
            return results
        raise RuntimeError(f"routing kept changing mid-query: {last}")

    def _scatter_gather_once(self, table: str, query: QueryContext,
                             stats_sum: dict, budget: _QueryBudget,
                             only_segments: Optional[list] = None):
        routing = self.routing_table(table)
        if only_segments is not None:
            missing = [s for s in only_segments if s not in routing]
            if missing:
                # an explicitly requested segment that is not routable must
                # fail loudly — silently skipping it would drop its rows
                raise RuntimeError(
                    f"requested segments not routable: {missing}")
            routing = {s: routing[s] for s in only_segments}
        if not routing:
            return []
        stats_sum["num_segments_queried"] += len(routing)
        unavailable: list[str] = []
        plan = self._select_instances(
            routing,
            unavailable_sink=unavailable if budget.partial_ok else None)
        if unavailable:
            stats_sum["partial_exceptions"].append(
                f"TransportError: no online replica for segments "
                f"{sorted(unavailable)}")

        def degrade(inst, segs, err) -> None:
            stats_sum["partial_exceptions"].append(
                f"{type(err).__name__}: {inst}: "
                f"segments {sorted(segs)}: {err}")

        results, failed = self._dispatch_round(
            plan, table, query, budget, stats_sum, routing)

        # replica-aware retry: a shard that failed at the connection level
        # re-scatters to replicas not yet tried, under capped exponential
        # backoff, for as long as the query's own budget allows. Terminal
        # errors never retry: a RemoteError would fail the same way on any
        # replica, a TimeoutError means the budget is gone — both degrade
        # (partial mode) or fail the query now.
        tried: dict[str, set] = {}
        for inst, segs in plan.items():
            for s in segs:
                tried.setdefault(s, set()).add(inst)
        attempt = 0
        while failed:
            retry_routing: dict[str, list[str]] = {}
            last_err: dict[str, tuple[str, Exception]] = {}
            for inst, segs, err in failed:
                if isinstance(err, (TimeoutError, RemoteError)):
                    if not budget.partial_ok:
                        raise err
                    degrade(inst, segs, err)
                    continue
                for s in segs:
                    replicas = [i for i in routing.get(s, [])
                                if i not in tried.get(s, ())]
                    if replicas:
                        retry_routing[s] = replicas
                        last_err[s] = (inst, err)
                    else:
                        exhausted = TransportError(
                            f"segment {s} unreachable on all replicas: "
                            f"{err}")
                        if not budget.partial_ok:
                            raise exhausted
                        degrade(inst, [s], exhausted)
            if not retry_routing:
                break
            if attempt >= SCATTER_RETRIES:
                for s, (inst, err) in last_err.items():
                    exhausted = TransportError(
                        f"segment {s}: scatter retries exhausted "
                        f"({SCATTER_RETRIES}): {err}")
                    if not budget.partial_ok:
                        raise exhausted
                    degrade(inst, [s], exhausted)
                break
            self._backoff_sleep(attempt, budget)
            retry_plan = self._select_instances(retry_routing)
            stats_sum["scatter_retries"] += len(retry_plan)
            BROKER_METRICS.add_meter(BrokerMeter.SCATTER_RETRIES,
                                     len(retry_plan))
            for inst, segs in retry_plan.items():
                for s in segs:
                    tried.setdefault(s, set()).add(inst)
            more, failed = self._dispatch_round(
                retry_plan, table, query, budget, stats_sum, retry_routing)
            results.extend(more)
            attempt += 1

        combineds = []
        cold_segs: set = set()

        def absorb(inst, r, missing_sink):
            combined, st = r["decoded"]
            combineds.append(combined)
            stats_sum["servers_responded"].append(inst)
            if r.get("trace"):
                stats_sum["server_traces"].append((inst, r["trace"]))
            for k in ("total_docs", "num_segments_processed",
                      "num_segments_pruned", "num_device_dispatches",
                      "num_compiles", "num_segments_cache_hit",
                      "num_segments_cache_miss", "num_coalesced_queries",
                      "coalesce_wait_ms"):
                stats_sum[k] += st.get(k, 0)
            # tiered storage: segments the server reported COLD (still
            # warming) ride the missing-segments retry below, and are
            # counted and hinted so routing and the response reflect it
            for s in st.get("cold_segments", []):
                cold_segs.add(s)
                self._note_cold(inst, s)
            stats_sum["cold_segments_warming"] += \
                len(st.get("cold_segments", []))
            for s in st.get("missing_segments", []):
                missing_sink.setdefault(inst, []).append(s)

        missing_by_inst: dict[str, list[str]] = {}
        for inst, r in results:
            absorb(inst, r, missing_by_inst)
        if missing_by_inst:
            # a routed segment the server no longer hosts (the routing
            # snapshot raced an unload): refresh the routing and retry
            # those segments on their CURRENT replicas, excluding the
            # instance that just reported them gone
            fresh = self.routing_table(table)
            sub_routing = {}
            for inst, segs in missing_by_inst.items():
                for s in segs:
                    if s not in fresh:
                        # the segment left the routing table entirely: the
                        # whole snapshot is stale, restart the query
                        raise _StaleRoutingError(
                            f"segment {s} replaced mid-query")
                    replicas = [i for i in fresh[s] if i != inst]
                    if not replicas and s in cold_segs:
                        # the only replica is still WARMING the segment:
                        # retry the same instance; its background warm
                        # (bounded by our remaining budget there) usually
                        # lands before the retry does
                        replicas = [inst]
                    if not replicas:
                        if budget.partial_ok:
                            degrade(inst, [s], RuntimeError(
                                "no remaining replicas"))
                            continue
                        raise RuntimeError(
                            f"segment {s} has no remaining replicas")
                    sub_routing[s] = replicas
            still_missing: dict[str, list[str]] = {}
            more, failed = self._dispatch_round(
                self._select_instances(sub_routing), table, query, budget,
                stats_sum, sub_routing)
            for inst, out in more:
                absorb(inst, out, still_missing)
            for inst, segs, err in failed:
                if budget.partial_ok:
                    degrade(inst, segs, err)
                    continue
                raise err if isinstance(err, (TimeoutError, RemoteError)) \
                    else TransportError(
                        f"segments {segs} unreachable on retry: {err}")
            if still_missing:
                # twice-missing → genuinely gone; fail loudly (or degrade)
                # rather than silently dropping rows
                gone = sorted(s for v in still_missing.values() for s in v)
                if budget.partial_ok:
                    stats_sum["partial_exceptions"].append(
                        f"RuntimeError: servers missing routed segments "
                        f"after retry: {gone}")
                else:
                    raise RuntimeError(
                        f"servers missing routed segments after retry: "
                        f"{gone}")
        return combineds

    def _call_one(self, inst: str, segs: list, table: str,
                  query: QueryContext, budget: _QueryBudget,
                  stats_sum: dict, shard_qid: str):
        """One scatter RPC shard. Returns ``(inst, segs, out, err)`` —
        never raises — and feeds the circuit breaker and the scatterRpcMs
        histogram."""
        remaining = budget.remaining_s()
        if remaining <= 0:
            return inst, segs, None, TimeoutError(
                f"deadline exceeded before dispatch to {inst}")
        # deadline propagation: the server clamps its scheduler wait and
        # per-segment loop to this remaining budget; the socket timeout
        # gets a little slack so the server-side timeout (which carries a
        # real error message) fires first
        request = {"type": "query", "table": table, "segments": segs,
                   "query": query, "deadlineMs": remaining * 1000.0,
                   "queryId": shard_qid}
        with self._lock:
            stats_sum["servers_queried"].append(inst)
            stats = self._server_stats.setdefault(inst, _ServerStats())
            stats.inflight += 1
        t0 = time.perf_counter()
        try:
            out = self._client(inst).call(request, timeout=remaining + 2.0)
            rpc_ms = (time.perf_counter() - t0) * 1000
            blob = out["datatable"]
            t_dec = time.perf_counter()
            try:
                # decode at the edge: the crc trailer catches damaged
                # bytes, the structural parse catches truncation — the
                # gather stage reuses this result
                out["decoded"] = decode_datatable(blob)
            except DataTableError as e:
                # wire-integrity failure: reclassified as a connection-
                # level failure so the replica retry re-dispatches the
                # shard; the corrupt response never enters the merge
                BROKER_METRICS.add_meter(BrokerMeter.DATATABLE_CORRUPTIONS)
                self.breakers.record_failure(inst)
                with self._lock:
                    stats_sum["corrupt_shards_retried"] += 1
                    self._clients.pop(inst, None)
                return inst, segs, None, TransportError(
                    f"corrupt DataTable from {inst}: {e}")
            server_ms = out.get("serverMs") or {}
            with self._lock:
                stats_sum["wire"].append({
                    "server": inst, "segments": len(segs),
                    "datatableBytes": len(blob),
                    "executeMs": server_ms.get("execute", 0.0),
                    "encodeMs": server_ms.get("encode", 0.0),
                    "rpcMs": rpc_ms,
                    "decodeMs": (time.perf_counter() - t_dec) * 1000})
            self.breakers.record_success(inst)
            BROKER_METRICS.update_timer(BrokerTimer.SCATTER_RPC_MS, rpc_ms)
            with self._lock:
                stats.record(rpc_ms)
            return inst, segs, out, None
        except RemoteError as e:
            # the server is alive — its handler raised. A replica retry
            # would deterministically fail the same way, so no failover
            # and no breaker signal
            return inst, segs, None, e
        except TransportError as e:
            self.breakers.record_failure(inst)
            with self._lock:
                self._clients.pop(inst, None)
            if time.monotonic() >= budget.deadline:
                # a slow server is indistinguishable from a dead one once
                # the budget is gone
                return inst, segs, None, TimeoutError(
                    f"deadline exceeded waiting on {inst}: {e}")
            return inst, segs, None, e
        finally:
            with self._lock:
                stats.inflight -= 1

    def _dispatch_round(self, plan: dict, table: str, query: QueryContext,
                        budget: _QueryBudget, stats_sum: dict,
                        routing: dict):
        """One scatter round with hedging: each (instance, segments) shard
        goes out as one RPC; a shard in flight past the hedge delay gets a
        duplicate on another replica holding all its segments. The first
        complete response wins: exactly one response per shard enters the
        merge, in shard submission order, so a hedged run stays
        bit-identical to an unhedged one, and the loser is cancelled by its
        shard id.

        Returns ``(results, failed)``: ``results`` = [(instance, out)] in
        plan order, ``failed`` = [(instance, segments, error)], one entry
        per shard whose every attempt failed."""
        hedge_delay = self._hedge_delay_s()
        shards = []
        pending: dict = {}  # future → (shard, inst, shard_qid)
        for idx, (inst, segs) in enumerate(plan.items()):
            sh = {"idx": idx, "primary": inst, "segs": segs,
                  "t0": time.monotonic(), "resolved": False,
                  "hedged": hedge_delay is None, "outstanding": 1,
                  "errors": []}
            qid = budget.next_shard_id()
            fut = self._pool.submit(self._call_one, inst, segs, table,
                                    query, budget, stats_sum, qid)
            pending[fut] = (sh, inst, qid)
            shards.append(sh)
        out_by_idx: dict[int, tuple] = {}
        failed: list[tuple[str, list, Exception]] = []
        while pending:
            timeout = None
            if hedge_delay is not None:
                due = [sh["t0"] + hedge_delay for sh in shards
                       if not sh["resolved"] and not sh["hedged"]]
                if due:
                    timeout = max(0.0, min(due) - time.monotonic())
            done, _ = wait(set(pending), timeout=timeout,
                           return_when=FIRST_COMPLETED)
            if not done:
                # a straggler crossed the hedge delay: duplicate its RPC
                # onto another replica (at most one hedge per shard)
                now = time.monotonic()
                for sh in shards:
                    if sh["resolved"] or sh["hedged"] or \
                            now - sh["t0"] < hedge_delay:
                        continue
                    sh["hedged"] = True
                    target = self._hedge_target(sh, routing)
                    if target is None or budget.remaining_s() <= 0:
                        continue
                    BROKER_METRICS.add_meter(BrokerMeter.HEDGED_REQUESTS)
                    with self._lock:
                        stats_sum["hedged_requests"] += 1
                    qid = budget.next_shard_id()
                    fut = self._pool.submit(
                        self._call_one, target, sh["segs"], table, query,
                        budget, stats_sum, qid)
                    pending[fut] = (sh, target, qid)
                    sh["outstanding"] += 1
                continue
            for fut in done:
                entry = pending.pop(fut, None)
                if entry is None:
                    # its shard already resolved in this same batch and the
                    # winner's cleanup dropped this duplicate
                    continue
                sh, inst, qid = entry
                sh["outstanding"] -= 1
                if sh["resolved"]:
                    continue  # a duplicate of an already-won shard
                _i, _s, out, err = fut.result()
                if err is None:
                    sh["resolved"] = True
                    if inst != sh["primary"]:
                        BROKER_METRICS.add_meter(BrokerMeter.HEDGE_WINS)
                        with self._lock:
                            stats_sum["hedge_wins"] += 1
                    out_by_idx[sh["idx"]] = (inst, out)
                    # first complete wins: drop and cancel the outstanding
                    # duplicate so it stops burning server and card time
                    for ofut, (osh, oinst, oqid) in list(pending.items()):
                        if osh is sh:
                            del pending[ofut]
                            self._cancel_shard(oinst, oqid)
                else:
                    sh["errors"].append((inst, err))
                    if sh["outstanding"] == 0:
                        # every attempt failed: classify on the primary's
                        # error when it is among them (the hedge may have
                        # failed differently)
                        pick = next((p for p in sh["errors"]
                                     if p[0] == sh["primary"]),
                                    sh["errors"][0])
                        failed.append((pick[0], sh["segs"], pick[1]))
        results = [out_by_idx[i] for i in sorted(out_by_idx)]
        return results, failed

    def _hedge_delay_s(self) -> Optional[float]:
        """Straggler threshold before a duplicate RPC goes out. A fixed
        `hedge_fixed_ms` wins (0 disables); otherwise the `hedge_quantile`
        of the scatterRpcMs histogram, once it holds enough samples to
        mean something. None = hedging off (the default)."""
        if self.hedge_fixed_ms is not None:
            return self.hedge_fixed_ms / 1000.0 \
                if self.hedge_fixed_ms > 0 else None
        if self.hedge_quantile <= 0:
            return None
        count, _total = BROKER_METRICS.timer_stats(BrokerTimer.SCATTER_RPC_MS)
        if count < self.hedge_min_samples:
            return None
        q_ms = BROKER_METRICS.timer_quantile(BrokerTimer.SCATTER_RPC_MS,
                                             self.hedge_quantile)
        return max(q_ms / 1000.0, 0.001)

    def _hedge_target(self, sh: dict, routing: dict) -> Optional[str]:
        """Another replica hosting EVERY segment of the straggling shard
        (never the primary, breaker permitting); None when the shard has
        no full-coverage alternative."""
        candidates: Optional[set] = None
        for seg in sh["segs"]:
            replicas = set(routing.get(seg, ()))
            candidates = replicas if candidates is None \
                else candidates & replicas
        picks = [i for i in (candidates or ())
                 if i != sh["primary"] and self.breakers.allow(i)]
        if not picks:
            return None
        with self._lock:
            return min(picks, key=lambda i: (
                self._server_stats.setdefault(i, _ServerStats()).score(),
                i))

    def _backoff_sleep(self, attempt: int, budget: _QueryBudget) -> None:
        """Capped exponential backoff before a retry round, never past the
        remaining budget. Jitter is deterministic (hashed from query id +
        attempt) so fault-schedule tests replay identically while
        concurrent queries still decorrelate."""
        delay = min(self.backoff_base_s * (2 ** attempt),
                    SCATTER_BACKOFF_CAP_MS / 1000.0)
        frac = zlib.crc32(f"{budget.query_id}:{attempt}".encode()) % 1000
        delay *= 0.5 + frac / 2000.0  # jitter in [0.5, 1.0)
        remaining = budget.remaining_s()
        if delay > 0 and remaining > 0:
            time.sleep(min(delay, remaining))

    def _merge(self, query: QueryContext, per_server: list):
        """The servers' combined intermediates into one: columnar group
        arrays merge as arrays where every server sent them (the same
        groups and states as the per-group merge), else per group."""
        semantics = [semantics_for(a) for a in query.aggregations]
        groupish = [r for r in per_server if isinstance(r, GroupByIntermediate)]
        # a server whose segments were all pruned sends AggIntermediate([])
        # (no states to merge); the JAX broker fails on it with an
        # IndexError, the port leaves it out
        aggish = [r for r in per_server
                  if isinstance(r, AggIntermediate) and r.states]
        selish = [r for r in per_server if isinstance(r, SelectionIntermediate)]
        if groupish:
            merged = None
            if all(isinstance(r, GroupArrays) for r in groupish):
                merged = combine_group_arrays(groupish)
            return merged if merged is not None \
                else combine_group_by(groupish, semantics)
        if aggish:
            return combine_aggregation(aggish, semantics)
        if selish:
            return combine_selection(selish)
        if query.is_aggregation_query and not query.is_group_by and not query.distinct:
            return AggIntermediate([])
        if query.is_group_by or query.distinct or query.is_aggregation_query:
            return GroupByIntermediate({})
        return SelectionIntermediate(
            [e.identifier for e in query.select_expressions if e.is_identifier], [])

    # -- hybrid time boundary ----------------------------------------------
    def _time_boundary(self, offline_table: str) -> Optional[int]:
        """max(endTimeMs) - 1 across offline segments (reference
        TimeBoundaryManager subtracts one time unit so the boundary instant
        itself is served from REALTIME: offline ≤ boundary, realtime >)."""
        best = None
        for seg in self.store.children(f"/SEGMENTS/{offline_table}"):
            meta = self.store.get(f"/SEGMENTS/{offline_table}/{seg}") or {}
            end = meta.get("endTimeMs")
            if end is not None:
                best = end if best is None else max(best, end)
        return None if best is None else best - 1


def _range_filter(column: str, gt: Optional[int], lte: Optional[int]) -> FilterContext:
    """time > gt AND time <= lte (None = unbounded)."""
    pred = Predicate(
        PredicateType.RANGE, ExpressionContext.for_identifier(column),
        lower=gt, lower_inclusive=False, upper=lte, upper_inclusive=True)
    return FilterContext.pred(pred)


def _with_filter(query: QueryContext, table: str,
                 extra: Optional[FilterContext]) -> QueryContext:
    if extra is None:
        q = copy.copy(query)
        q.table_name = table
        return q
    q = copy.deepcopy(query)
    q.table_name = table
    q.filter = extra if q.filter is None else FilterContext.and_(q.filter, extra)
    return q
