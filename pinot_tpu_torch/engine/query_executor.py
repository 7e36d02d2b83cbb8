"""In-process query executor: tables of segments -> BrokerResponse.

The port of pinot_tpu/engine/query_executor.py for single-stage queries:
parse -> prune -> per-segment plan -> dispatch -> ONE fetch -> collect ->
combine -> broker reduce. Segments the pruner (engine/pruner.py) proves
empty are never planned or dispatched. Segments whose plans agree (engine/executor.py
`batch_family_key`) run as one batch family: one dispatch and one launch
of kernel A for all of them (`SET segmentBatch = false` opts out). Every
packed output of the query, family and solo alike, comes to the host in
one copy. Multi-segment single-key sparse GROUP BYs merge their tables on
the device and fetch one merged table (`SET deviceCombine = false` opts
out). A consuming segment of a realtime table runs as a snapshot pinned
for the query (realtime/device_plane.py: append-only device planes, only
the rows appended since the last query uploaded). An aggregation that fits
a segment's star-tree runs over its pre-aggregated rows instead
(segment/startree.py; `use_star_tree`), through the same planner, families
and kernels; its states map back to the query's afterwards.

`backend` says which engine answers a segment. "device" (the default):
every segment runs on the executor's device, and a shape the planner
refuses raises UnsupportedQueryError (execute_sql then retries the query
on the multi-stage engine). "host": every segment runs on the host engine
(engine/host_executor.py, numpy), with no dispatch, no device combine and
no columnar multi-stage leaf. "auto": a segment whose plan the planner
refuses runs on the host engine in the same query, beside the device
segments, as the reference's default does. Only a planner refusal takes
that route: a CUDA error, a kernel that fails to build or launch, a device
OOM past its relief (HbmExhaustedError) or a realtime upload fault
(RealtimeUploadError) fails the query under every backend, where the
reference answers an upload fault on its host engine. Host segments run
on a pool of `num_threads` threads (one: the query's thread), after the
device work is dispatched and before it is fetched; their
`segment:<name>` spans nest under the query's.

The segment partial cache (cache/partial.py, on by default as in the JAX
package) serves a segment's aggregation or group-by partial it holds
without a dispatch; keys are content-addressed (cache/keys.py: the plan's
fingerprint and the segment's (name, crc), or a consuming snapshot's
generation), so a changed segment, a new row or an upsert flip misses.
`SET segmentCache = false` or PINOT_TPU_SEGMENT_CACHE=0 turns it off. A
device OOM in a dispatch or the fetch relieves pressure once and retries
(engine/oom.py); a second fails the query alone with HbmExhaustedError.

`execute_sql` sends multi-stage statements (joins, IN / NOT IN subqueries,
set operations, windows, CTEs; anything the single-stage parser rejects,
and `SET useMultistageEngine = true`) to the multi-stage engine (mse/),
whose leaf stages come back here: `execute` for a leaf aggregate and
`execute_selection_columnar` for a scan leaf.

EXPLAIN PLAN FOR and EXPLAIN IMPLEMENTATION PLAN FOR plan without running
(engine/explain.py); EXPLAIN ANALYZE runs the query under an analyze trace
and renders its spans. `SET trace = true` attaches the query's spans
(spi/trace.py: QUERY_PLAN_EXECUTION, family_dispatch, segment:<name>,
SERVER_COMBINE, BROKER_REDUCE) as `trace_info`; a traced run bypasses the
segment partial cache, except under EXPLAIN ANALYZE, which shows what a
real run does.

With more than one mesh device (`mesh_devices`: the process's cards by
default, parallel/mesh.py; a list may repeat a device), a family of at
least that many members splits over them, one dispatch and one fetch
still (engine/executor.py); PINOT_TPU_MESH_DEVICES caps the count and
`SET meshExecution = false` opts a query out. A failed sharded dispatch
fails the query.

Concurrent queries of one batch family over the same segments can share
one dispatch (engine/coalesce.py): with `PINOT_TPU_COALESCE_WINDOW_MS` set,
the first holds the family open for the others, launches once over all
their plans and fetches once; each query decodes its own rows. Traced
queries, consuming segments' families and `SET coalesce = false` never
join.

With PINOT_TPU_AOT_CACHE_DIR set, `add_table` prewarms the table's
persisted families on the executor's device (engine/aot_cache.py), and
each query stamps its table so a family's first dispatch persists under
it.
"""

from __future__ import annotations

import copy
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from ..cache.keys import program_fingerprint, segment_token
from ..cache.partial import GLOBAL_PARTIAL_CACHE, partial_cache_enabled
from ..ops import _cuda, kernels
from ..ops.kernels import PackedOuts, fetch_packed_batch
from ..parallel.mesh import mesh_device_count
from ..query.context import QueryContext
from ..query.optimizer import optimize_filter
from ..query.parser.sql import SqlParseError, parse_sql
from ..realtime.device_plane import note_realtime_device_query
from ..segment.bitpack import unpack_bitmap
from ..segment.device_cache import DeviceSegmentCache
from ..segment.loader import ImmutableSegment
from ..segment.startree import StarTreeRewrite, remap_states, try_rewrite
from ..spi.data_types import Schema
from ..spi.metrics import SERVER_METRICS, ServerMeter, ServerTimer
from ..spi.trace import TRACING, ServerQueryPhase
from . import aot_cache
from .aggregation import (MultistageRefusal, UnsupportedQueryError,
                          semantics_for)
from .coalesce import (QueryCoalescer, coalesce_enabled, coalesce_stats,
                       reset_coalesce_stats)
from .combine import (combine_aggregation, combine_batched_aggregation,
                      combine_batched_dense, combine_group_arrays,
                      combine_group_by, combine_selection, trim_group_by)
from .dim_tables import register_dimension_table
from .explain import analyze_table, explain_plan
from .executor import (BatchFamilyMismatch, SegmentExecutor,
                       batch_family_key, dispatch_counters,
                       reset_dispatch_counters)
from .host_executor import HostSegmentExecutor
from .oom import HbmExhaustedError, with_oom_retry
from .pruner import SegmentPrunerService
from .reduce import BrokerReducer
from .results import (AggIntermediate, BrokerResponse, GroupArrays,
                      GroupByIntermediate, SelectionIntermediate)
from .scheduler import GLOBAL_ACCOUNTANT

BACKENDS = ("device", "host", "auto")


class ReduceRefused(MultistageRefusal):
    """The broker reduce refused a query-level shape (a reference to a
    column outside the group-by result, a HAVING predicate it does not
    evaluate): the single-stage refusals the reference's engine selection
    retries on its multi-stage engine."""


def _group_arrays_bytes(ga: GroupArrays) -> int:
    """The host bytes of a GroupArrays' key and state columns."""
    return int(sum(np.asarray(k).nbytes for k in ga.key_cols)
               + sum(np.asarray(c).nbytes
                     for comps in ga.state_cols for c in comps))


def _estimate_bytes(inter) -> int:
    """A host intermediate's footprint for the resource accountant, by the
    reference's container-size heuristics."""
    if isinstance(inter, GroupArrays):
        return _group_arrays_bytes(inter) + 64
    if isinstance(inter, GroupByIntermediate):
        width = 1 + max((len(v) for v in inter.groups.values()), default=0)
        return 64 * width * len(inter.groups)
    if isinstance(inter, SelectionIntermediate):
        return 32 * max(1, len(inter.columns)) * len(inter.rows)
    if isinstance(inter, AggIntermediate):
        return 64 * max(1, len(inter.states))
    return 64


def _opted_out(query: QueryContext, option: str) -> bool:
    """`SET <option> = false` (or 0 / off) in the query."""
    return str(query.query_options.get(option)).lower() in ("false", "0", "off")


def _mesh_kw(mesh: tuple) -> dict:
    """A family dispatch's mesh argument: none for a solo family."""
    return {"mesh": mesh} if mesh else {}


@dataclass
class Pending:
    """What a query's dispatch left on the device: per-segment packs
    (index, PackedOuts), family packs (positions, PackedOuts), or the one
    merged table of the sparse device combine; the host arrays of families
    a coalesced group already fetched (positions, this query's [S, ...]
    rows); the dispatched segments' indexes in dispatch order; and the
    query's segment partial-cache state, from dispatch to collect: the hits
    (index -> intermediate, or the merged table's GroupArrays), the misses
    to insert once collected ((index, key, segment name), or the merged
    table's key) and the counts."""

    solo: list = field(default_factory=list)
    families: list = field(default_factory=list)
    hosts: list = field(default_factory=list)
    order: list = field(default_factory=list)
    merged: Optional[PackedOuts] = None
    hits: dict = field(default_factory=dict)
    inserts: list = field(default_factory=list)
    merged_hit: Optional[GroupArrays] = None
    merged_key: Optional[tuple] = None
    cache_hits: int = 0
    cache_misses: int = 0
    # re-dispatches the packs above in order: the fetch's retry after
    # device-memory relief (the packs' inputs may be freed stacks)
    redispatch: Optional[Callable[[], list]] = None


@dataclass
class Route:
    """How one segment runs a query: the query and segment it dispatches
    (a star-tree's rewritten query over its pre-aggregated view, or the
    query itself over the segment) and the rewrite to map states back."""

    query: QueryContext
    segment: object
    rewrite: Optional[StarTreeRewrite] = None


@dataclass
class PlannedQuery:
    """A query with its planning done and none of its device work: the
    pinned and kept segments, each kept segment's route (None for a
    columnar selection) and plan. Every refusal of the query's shape is
    behind it."""

    query: QueryContext
    segments: list
    kept: list
    num_pruned: int
    routes: Optional[list]
    plans: list
    t0: float
    # plan_query's cancel and deadline check, None with neither
    check: Optional[Callable[[int], None]] = None
    # the resource tracker (engine/scheduler.py) host segments charge
    tracker: object = None


@dataclass
class Table:
    name: str
    schema: Schema
    segments: list[ImmutableSegment] = field(default_factory=list)


class QueryExecutor:
    """Executes SQL over registered tables on one device: "cuda" (the
    default; construction raises unless an H100-class device, compute
    capability (9, 0), is present) or "cpu" (the kernels' plain PyTorch
    versions, used by the tests). `backend`: "device" (the default),
    "host" or "auto" (the module docstring); `num_threads`: the host
    engine's worker threads."""

    def __init__(self, device="cuda", backend: str = "device",
                 num_threads: int = 1, mesh_devices: Optional[list] = None):
        if backend not in BACKENDS:
            raise ValueError(f"backend {backend!r}: one of {BACKENDS}")
        device = torch.device(device)
        if device.type == "cuda":
            _cuda.require_cuda(device)
        elif device.type != "cpu":
            raise ValueError(f"unsupported device {device}")
        self.device = device
        self.backend = backend
        self.host = HostSegmentExecutor()
        # above 1, host segments run on a worker pool (the reference's
        # combine fan-out, GroupByCombineOperator.java:54)
        self.num_threads = max(1, int(num_threads))
        self._pool = None
        self.tables: dict[str, Table] = {}
        self.executor = SegmentExecutor(DeviceSegmentCache(device),
                                        mesh_devices)
        self.pruner = SegmentPrunerService()
        # reference: the useStarTree query option, default true
        self.use_star_tree = True
        # cross-query coalescing: shared by every concurrent query here
        self.coalescer = QueryCoalescer()

    def add_table(self, schema: Schema, segments: list,
                  name: Optional[str] = None):
        """Register a table of ImmutableSegments and, for a realtime or
        hybrid table, consuming MutableSegments (segment/mutable.py): each
        query pins a snapshot of every consuming segment. ``segments`` is
        held BY REFERENCE when it is a list: a realtime data manager
        (realtime/manager.py) rewrites its list in place as segments commit
        and rotate, and each query copies it once before pinning. A
        segment that predates a column of `schema` gets a virtual default
        column (segment/loader.py apply_schema: schema evolution without
        rewriting old segments); a consuming segment has no apply_schema
        and is registered as it is, as in the JAX package."""
        name = name or schema.schema_name
        if not isinstance(segments, list):
            segments = list(segments)  # may be a generator
        for seg in segments:
            if hasattr(seg, "apply_schema"):
                seg.apply_schema(schema)
        self.tables[name] = Table(name, schema, segments)
        # cold starts without the one-time costs: replay and install the
        # table's best persisted families, off the serving path
        if aot_cache.enabled():
            aot_cache.prewarm_table(name, device=self.device)

    def add_dimension_table(self, schema: Schema, segments: list,
                            name: Optional[str] = None) -> None:
        """Register a queryable table that also serves LOOKUP joins
        (reference: TableConfig.isDimTable + DimensionTableDataManager).
        The schema must declare exactly one primary key column; duplicate
        keys raise. The port's registry is per process
        (engine/dim_tables.py)."""
        name = name or schema.schema_name
        self.add_table(schema, segments, name)
        if len(schema.primary_key_columns) != 1:
            raise ValueError("dimension tables need exactly one primary key")
        cols = {}
        for c in schema.column_names():
            # a multi-value column raises ValueError, as in the reference
            parts = [s.get_values_at(c, np.arange(s.num_docs))
                     for s in self.tables[name].segments]
            cols[c] = parts[0] if len(parts) == 1 else np.concatenate(parts)
        register_dimension_table(name, schema.primary_key_columns[0], cols)

    def execute_sql(self, sql: str) -> BrokerResponse:
        """Engine selection as the reference's BrokerRequestHandlerDelegate
        (pinot_tpu/engine/query_executor.py:147-166): the multi-stage
        engine for a statement the single-stage parser rejects and for
        `SET useMultistageEngine = true`; the single-stage engine
        otherwise, and the multi-stage engine's answer, where it has one,
        for any shape the single-stage engine refuses with
        UnsupportedQueryError: a query-level MultistageRefusal (the broker
        reduce's ReduceRefused, a selection ORDER BY on an unselected
        column) and a segment planner's refusal alike (PERCENTILE over a
        raw column, a GROUP BY on a transform of a raw column), as the
        reference does under backend="tpu". The single-stage refusal is
        raised when the multi-stage engine fails too."""
        try:
            query = parse_sql(sql)
        except SqlParseError:
            return self.multistage.execute_sql(sql)
        if query.query_options.get("useMultistageEngine") in (True, "true", 1):
            return self.multistage.execute_sql(sql)
        try:
            return self.execute(query)
        except UnsupportedQueryError:
            mse = self.multistage.execute_sql(sql)
            if not mse.exceptions:
                return mse
            raise

    @property
    def multistage(self):
        """The multi-stage engine over this executor's tables (mse/)."""
        if not hasattr(self, "_multistage"):
            from ..mse.executor import MultistageExecutor

            self._multistage = MultistageExecutor(self)
        return self._multistage

    def _table(self, name: str) -> Table:
        table = self.tables.get(name)
        if table is None:
            # tolerate _OFFLINE/_REALTIME suffixes
            table = self.tables.get(name.rsplit("_", 1)[0])
        if table is None:
            raise KeyError(f"table {name} not found")
        return table

    def execute(self, query: QueryContext) -> BrokerResponse:
        """Run a parsed query; EXPLAIN plans it, EXPLAIN ANALYZE runs it
        under an analyze trace and returns the annotated span tree. A query
        that fails raises, after counting the server meter
        `queryExecutionExceptions` as the JAX package does for a query its
        single-stage engine answers with an exception, a refusal that
        `execute_sql` then retries on the multi-stage engine included."""
        explain = getattr(query, "explain", False)
        if explain == "analyze":
            return self._execute_analyze(query)
        if explain:
            t0 = time.perf_counter()
            rt = explain_plan(query, self._table(query.table_name),
                              self.pruner, self.executor.packed_on,
                              backend=self.backend,
                              use_star_tree=self.use_star_tree)
            return BrokerResponse(
                result_table=rt,
                time_used_ms=(time.perf_counter() - t0) * 1000)
        try:
            return self.run_planned(self.plan_query(query))
        except Exception:
            SERVER_METRICS.add_meter(ServerMeter.QUERY_EXECUTION_EXCEPTIONS)
            raise

    def _execute_analyze(self, query: QueryContext) -> BrokerResponse:
        """EXPLAIN ANALYZE: run the query for real under an analyze trace
        (the caches stay on) and return its span tree rendered as the
        annotated plan table, with the run's counts."""
        sub = copy.copy(query)
        sub.explain = False
        sub.query_options = dict(query.query_options)
        sub.query_options["trace"] = True
        owns = TRACING.active_trace() is None
        trace = TRACING.start_trace(f"analyze:{query.table_name}",
                                    analyze=True) if owns \
            else TRACING.active_trace()
        try:
            resp = self.run_planned(self.plan_query(sub))
        finally:
            if owns:
                TRACING.end_trace()
        trace_json = resp.trace_info if resp.trace_info is not None \
            else trace.to_json()
        out = copy.copy(resp)
        out.result_table = analyze_table(trace_json, resp,
                                         table_name=query.table_name)
        out.trace_info = trace_json
        return out

    def plan_query(self, query: QueryContext, segments: Optional[list] = None,
                   tracker=None) -> PlannedQuery:
        """The planning half of `execute`: prune, route and plan every
        segment of the table, or of `segments` where given (a cluster
        server's list, execute_segments). A shape the port does not lower
        raises UnsupportedQueryError here, before anything reaches the
        device. `tracker` (engine/scheduler.py QueryResourceTracker) and
        the ``timeoutMs`` option arm the plan's check, run between
        segments while planning and between families while dispatching."""
        t0 = time.perf_counter()
        if segments is None:
            segments = self._table(query.table_name).segments
        segments = self.pinned_segments(segments)
        kept, num_pruned = self.prune_segments(query, segments)
        routes = self.route_segments(query, kept)
        check = self._cancel_check(query, tracker, len(routes), t0)
        return PlannedQuery(query, segments, kept, num_pruned, routes,
                            self.plan_segments(routes, check), t0, check,
                            tracker)

    @staticmethod
    def _cancel_check(query: QueryContext, tracker, num_routes: int,
                      t0: float) -> Optional[Callable[[int], None]]:
        """`check(done)`: raise on a kill of `tracker` or past the
        ``timeoutMs`` deadline counted from `t0`; None with neither."""
        timeout_ms = query.query_options.get("timeoutMs")
        if tracker is None and timeout_ms is None:
            return None
        deadline = None if timeout_ms is None \
            else t0 + float(timeout_ms) / 1000

        def check(done: int):
            if tracker is not None:
                tracker.check_cancel()
            if deadline is not None and time.perf_counter() > deadline:
                raise TimeoutError(
                    f"query exceeded timeoutMs={timeout_ms} "
                    f"({done}/{num_routes} segments done)")

        return check

    def run_planned(self, p: PlannedQuery) -> BrokerResponse:
        """The running half of `execute`: the server half (serve_planned),
        then the broker reduce."""
        query = p.query
        # own the trace only when nobody upstream (EXPLAIN ANALYZE, the
        # multi-stage engine) started one: a nested run joins its tree
        owns_trace = query.query_options.get("trace") in (True, "true", 1) \
            and TRACING.active_trace() is None
        trace = TRACING.start_trace(f"{query.table_name}:{id(query):x}") \
            if owns_trace else None
        try:
            return self._run_planned(p, trace)
        finally:
            if owns_trace:
                TRACING.end_trace()

    def _run_planned(self, p: PlannedQuery, trace) -> BrokerResponse:
        query = p.query
        with TRACING.scope(ServerQueryPhase.QUERY_PLAN_EXECUTION):
            combined, stats = self.serve_planned(p)
        try:
            with TRACING.scope("BROKER_REDUCE"):
                result = BrokerReducer(self._table(
                    query.table_name).schema).reduce(query, combined)
        except UnsupportedQueryError as e:
            raise ReduceRefused(str(e)) from e
        return BrokerResponse(
            result_table=result,
            num_docs_scanned=combined.num_docs_scanned,
            total_docs=stats["total_docs"],
            num_segments_queried=len(p.segments),
            num_segments_processed=stats["num_segments_processed"],
            num_segments_pruned=stats["num_segments_pruned"],
            time_used_ms=(time.perf_counter() - p.t0) * 1000,
            num_device_dispatches=stats["num_device_dispatches"],
            num_groups_limit_reached=getattr(combined, "groups_trimmed",
                                             False),
            num_segments_cache_hit=stats["num_segments_cache_hit"],
            num_segments_cache_miss=stats["num_segments_cache_miss"],
            num_coalesced_queries=stats["num_coalesced_queries"],
            coalesce_wait_ms=stats["coalesce_wait_ms"],
            trace_info=None if trace is None else trace.to_json(),
        )

    def execute_segments(self, query: QueryContext, segments: list,
                         tracker=None):
        """The server half of a query over an explicit segment list (the
        port of pinot_tpu/engine/query_executor.py:373, what a cluster
        server runs for the segments the broker routed to it): plan_query
        over `segments`, then serve_planned. Returns (combined
        intermediate, stats)."""
        return self.serve_planned(self.plan_query(query, segments, tracker))

    def serve_planned(self, p: PlannedQuery):
        """The server half of a planned query, shared by the in-process
        path and the cluster data plane: serve what the segment partial
        cache holds, dispatch every family and lone segment of the rest
        (the device queue fills back to back), fetch all outputs in one
        copy, collect (inserting the misses) and combine, with no broker
        reduce. A device OOM relieves pressure once and retries
        (engine/oom.py); a second fails this query alone with
        HbmExhaustedError. Returns (combined intermediate, stats), the
        stats under the JAX package's keys, and records the server
        meters. The counters read here are thread-local: every dispatch of
        the query runs on the calling thread."""
        query = p.query
        reset_dispatch_counters()
        # the table a family's first dispatch persists under (AOT cache)
        aot_cache.set_current_table(query.table_name)
        reset_coalesce_stats()
        dev = [i for i, plan in enumerate(p.plans) if plan is not None]
        host = [i for i, plan in enumerate(p.plans) if plan is None]
        routes = [p.routes[i] for i in dev]
        plans = [p.plans[i] for i in dev]
        pending = Pending()
        if dev:
            # the sparse device combine merges every segment or none
            pending = self.dispatch_segments(query, routes, plans, p.check,
                                             device_combine=not host)
        # the host engine runs while the device works through the launches
        inters = self._run_host(p, host)
        if dev:
            collected = self.collect_segments(routes, plans, pending)
            if host:
                for i, inter in zip(dev, collected):
                    inters[i] = inter
            else:
                inters = collected
        with TRACING.scope(ServerQueryPhase.SERVER_COMBINE):
            combined = self._combine(query, inters)
        if any(getattr(r.segment, "is_mutable", False) for r in routes):
            note_realtime_device_query()
        num_dispatches = dispatch_counters()
        peers, wait_ms = coalesce_stats()
        SERVER_METRICS.update_timer(ServerTimer.QUERY_PROCESSING_TIME_MS,
                                    (time.perf_counter() - p.t0) * 1000)
        SERVER_METRICS.add_meter(ServerMeter.QUERIES)
        SERVER_METRICS.add_table_meter(query.table_name, ServerMeter.QUERIES)
        SERVER_METRICS.add_meter(ServerMeter.NUM_DOCS_SCANNED,
                                 combined.num_docs_scanned)
        SERVER_METRICS.add_meter(ServerMeter.NUM_SEGMENTS_PROCESSED,
                                 len(p.kept))
        SERVER_METRICS.add_meter(ServerMeter.NUM_SEGMENTS_PRUNED,
                                 p.num_pruned)
        SERVER_METRICS.add_meter(ServerMeter.NUM_DEVICE_DISPATCHES,
                                 num_dispatches)
        SERVER_METRICS.add_meter(ServerMeter.NUM_COMPILES, 0)
        SERVER_METRICS.add_meter(ServerMeter.SEGMENT_CACHE_HITS,
                                 pending.cache_hits)
        SERVER_METRICS.add_meter(ServerMeter.SEGMENT_CACHE_MISSES,
                                 pending.cache_misses)
        return combined, {
            "total_docs": sum(s.num_docs for s in p.segments),
            "num_segments_processed": len(p.kept),
            "num_segments_pruned": p.num_pruned,
            "num_device_dispatches": num_dispatches,
            "num_compiles": 0,
            "num_segments_cache_hit": pending.cache_hits,
            "num_segments_cache_miss": pending.cache_misses,
            "num_coalesced_queries": peers,
            "coalesce_wait_ms": wait_ms,
        }

    def _host_pool(self):
        if self._pool is None:
            from concurrent.futures import ThreadPoolExecutor

            self._pool = ThreadPoolExecutor(max_workers=self.num_threads,
                                            thread_name_prefix="host-engine")
        return self._pool

    def _run_host(self, p: PlannedQuery, positions: list) -> list:
        """The intermediates of the routes at `positions` on the host
        engine, each under its `segment:<name>` span, in a list as long as
        the routes (None elsewhere). Above one thread they run on the
        pool, each worker's spans nested under the caller's. Each charges
        its CPU time and an estimate of its bytes to the query's
        tracker."""
        inters: list = [None] * len(p.routes)

        def run(route):
            cpu0 = time.thread_time_ns()
            with TRACING.scope(
                    f"segment:{getattr(route.segment, 'name', '?')}"):
                inter = self.host.execute(route.query, route.segment)
            return inter, time.thread_time_ns() - cpu0

        if self.num_threads > 1 and len(positions) > 1:
            trace, span = TRACING.active_trace(), TRACING.current_span()

            def run_adopted(route):
                TRACING.adopt(trace, span)
                try:
                    return run(route)
                finally:
                    TRACING.adopt(None)

            jobs = [self._host_pool().submit(run_adopted, p.routes[i]).result
                    for i in positions]
        else:
            jobs = [lambda i=i: run(p.routes[i]) for i in positions]
        results = []
        for done, job in enumerate(jobs):
            if p.check is not None:
                p.check(done)
            results.append(job())
        for i, (inter, cpu_ns) in zip(positions, results):
            if p.tracker is not None:
                p.tracker.add_cpu_ns(cpu_ns)
                GLOBAL_ACCOUNTANT.on_allocation(p.tracker,
                                                _estimate_bytes(inter))
            rewrite = p.routes[i].rewrite
            inters[i] = inter if rewrite is None \
                else self._remap_star_tree(rewrite, inter)
        return inters

    def execute_selection_columnar(self, query: QueryContext):
        """The multi-stage engine's scan leaf (reference:
        pinot_tpu/engine/query_executor.py:285-371): the filter bitmap of
        every kept segment on the device, all fetched in one copy, then a
        numpy gather of the selected source columns, with no row
        materialization. Returns (column arrays, stats), or None for a
        shape the row path must run; a shape the planner refuses raises
        UnsupportedQueryError."""
        planned = self.plan_selection_columnar(query)
        return None if planned is None else self.run_selection_columnar(
            planned)

    def plan_selection_columnar(self, query: QueryContext,
                                segments: Optional[list] = None):
        """The planning half of `execute_selection_columnar`, over the
        table's segments or `segments` where given (a cluster stage
        worker's routed list): None for a shape the row path must run (not
        a plain identifier selection, or one with ordering, DISTINCT,
        offset or null handling, or traced: the row path records the
        query's spans; any shape under backend "host", and one the planner
        refuses under "auto": the row path answers it on the host
        engine)."""
        if self.backend == "host":
            return None
        if (not query.is_selection or query.distinct
                or query.group_by_expressions or query.order_by_expressions
                or query.having_filter is not None or query.offset
                or query.null_handling
                or query.query_options.get("trace") in (True, "true", 1)):
            return None
        if not query.select_expressions or not all(
                e.is_identifier and e.identifier != "*"
                for e in query.select_expressions):
            return None
        t0 = time.perf_counter()
        if segments is None:
            segments = self._table(query.table_name).segments
        segments = self.pinned_segments(segments)
        kept, num_pruned = self.prune_segments(query, segments)
        try:
            plans = [self.executor.plan(query, seg) for seg in kept]
        except UnsupportedQueryError:
            if self.backend == "auto":
                return None
            raise
        if any(p.program.mode != "selection" or p.selection_exprs
               for p in plans):
            return None
        return PlannedQuery(query, segments, kept, num_pruned, None, plans,
                            t0)

    def run_selection_columnar(self, planned: PlannedQuery):
        """The running half of `execute_selection_columnar`."""
        query, kept = planned.query, planned.kept
        names = [e.identifier for e in query.select_expressions]
        reset_dispatch_counters()
        ex = self.executor

        def dispatch_all():
            return [with_oom_retry(
                lambda seg=seg, plan=plan: ex.dispatch_plan(seg, plan),
                keep_segment=seg, cache=ex.cache)
                for seg, plan in zip(kept, planned.plans)]

        packs = dispatch_all()
        fetched = with_oom_retry(
            lambda: fetch_packed_batch(packs), cache=ex.cache,
            retry_fn=lambda: fetch_packed_batch(dispatch_all()))
        parts: dict[str, list] = {c: [] for c in names}
        scanned = 0
        remaining = max(0, int(query.limit))
        for seg, outs in zip(kept, fetched):
            if remaining <= 0:
                break
            doc_ids = np.nonzero(unpack_bitmap(outs[0], seg.num_docs))[0]
            doc_ids = doc_ids[:remaining]
            scanned += len(doc_ids)
            remaining -= len(doc_ids)
            for c in names:
                parts[c].append(seg.get_values_at(c, doc_ids))
        if any(getattr(s, "is_mutable", False) for s in kept):
            note_realtime_device_query()
        cols: dict = {}
        for c, ps in parts.items():
            if not ps:
                cols[c] = np.empty(0)
            elif len(ps) == 1:
                cols[c] = ps[0]
            else:
                if any(p.dtype.kind == "O" for p in ps):
                    ps = [p.astype(object) for p in ps]
                cols[c] = np.concatenate(ps)
        return cols, {"num_docs_scanned": scanned,
                      "total_docs": sum(s.num_docs
                                        for s in planned.segments),
                      "num_device_dispatches": dispatch_counters()}

    @staticmethod
    def pinned_segments(segments: list) -> list:
        """Segments as one query sees them: the (possibly live) list copied
        once, then each consuming segment's snapshot pinned (row count,
        dictionary cardinalities, upsert validity) for the whole query."""
        return [s.snapshot_view() if getattr(s, "is_mutable", False)
                else s for s in list(segments)]

    def prune_segments(self, query: QueryContext, segments: list):
        """(kept segments, number pruned): the segments whose metadata,
        partitions or bloom filters do not prove the filter empty, in
        order. The filter is canonicalized first, as the reference does."""
        query.filter = optimize_filter(query.filter)
        return self.pruner.prune(query, segments)

    def route_segments(self, query: QueryContext, segments: list) -> list:
        """Each segment's Route: a star-tree rewrite where one fits the
        query, else the query itself. Upsert segments never take the tree:
        its pre-aggregates ignore validity."""
        routes = []
        for s in segments:
            rewrite = None
            if self.use_star_tree \
                    and getattr(s, "valid_doc_ids", None) is None:
                rewrite = try_rewrite(query, s)
            routes.append(Route(query, s) if rewrite is None
                          else Route(rewrite.query, rewrite.view, rewrite))
        return routes

    def plan_segments(self, routes: list,
                      check: Optional[Callable[[int], None]] = None) -> list:
        """Each route's plan, or None for a route the host engine answers:
        every route under backend "host", a route the planner refuses under
        "auto" (under "device" the refusal raises). `check(done)`, where
        given, runs before each (plan_query's cancel and deadline
        check)."""
        plans = []
        for r in routes:
            if check is not None:
                check(len(plans))
            if self.backend == "host":
                plans.append(None)
                continue
            try:
                plans.append(self.executor.plan(r.query, r.segment))
            except UnsupportedQueryError:
                if self.backend != "auto":
                    raise
                plans.append(None)
        return plans

    def dispatch_segments(self, query: QueryContext, routes: list,
                          plans: list,
                          check: Optional[Callable[[int], None]] = None,
                          device_combine: bool = True) -> Pending:
        """Launch the query's device work: the sparse device combine when
        it applies, else one dispatch per batch family (a family of one,
        or one that turns out to mismatch, dispatches alone, with the
        fused kernel where it applies). `query` is the query as sent: its
        options decide the batching and the cache. With the segment
        partial cache on, a segment it holds fills its intermediate and
        never reaches dispatch; the families form over the rest.
        `check(done)`, where given, runs before each family's or lone
        segment's dispatch (plan_query's cancel and deadline check).
        `device_combine=False` keeps the sparse device combine off (a query
        whose other segments answer on the host engine)."""
        segments = [r.segment for r in routes]
        cache_on = bool(routes) and self._segment_cache_enabled(query)
        traced = TRACING.active_trace() is not None
        # a traced run's dispatch spans must describe device work: the
        # cache is bypassed, except under EXPLAIN ANALYZE
        bypass = cache_on and traced and not TRACING.analyze_active()
        if device_combine and len(segments) > 1 \
                and all(r.rewrite is None for r in routes):
            merged = self._sparse_device_combine(query, segments, plans,
                                                 cache_on and not bypass)
            if merged is not None:
                return merged
        if bypass:
            with TRACING.scope("SEGMENT_CACHE(bypass:trace)"):
                cache_on = False
        ex = self.executor
        pending = Pending()
        todo = list(range(len(routes)))
        if cache_on:
            todo = []
            for i, (r, plan) in enumerate(zip(routes, plans)):
                key = self._partial_cache_key(r, plan)
                hit = None if key is None else GLOBAL_PARTIAL_CACHE.get(key)
                if hit is not None:
                    pending.hits[i] = hit
                    pending.cache_hits += 1
                    continue
                if key is not None:
                    pending.inserts.append(
                        (i, key, getattr(r.segment, "name", "?")))
                    pending.cache_misses += 1
                todo.append(i)
        # a traced query's spans describe its own device work, and a
        # consuming segment's family is keyed without its snapshot
        # generation: neither joins a coalesced group
        co_on = not traced and coalesce_enabled(query)
        msig = self._mesh_sig(query)
        for fkey, positions in self._batch_families(
                query, [segments[i] for i in todo], [plans[i] for i in todo],
                msig):
            positions = [todo[p] for p in positions]
            if check is not None:
                check(len(pending.order))
            pending.order.extend(positions)
            if fkey is not None and len(positions) > 1:
                fam = [segments[i] for i in positions]
                if co_on and not any(getattr(s, "is_mutable", False)
                                     for s in fam):
                    co = self.coalescer.offer(
                        query.table_name, fkey, fam,
                        [plans[i] for i in positions], self._run_group)
                    if co is not None:
                        pending.hosts.append((positions, co.outs))
                        continue
                try:
                    pack = self._dispatch_family(segments, plans, positions,
                                                 mesh=msig)
                except (BatchFamilyMismatch, HbmExhaustedError):
                    # the host key over-grouped, or the [S, N] stacks do
                    # not fit even after relief: the members go alone
                    pass
                else:
                    pending.families.append((positions, pack))
                    continue
            for i in positions:
                pending.solo.append((i, self._dispatch_one(segments[i],
                                                           plans[i])))

        def redispatch():
            return ([ex.dispatch_plan(segments[i], plans[i])
                     for i, _ in pending.solo]
                    + [ex.dispatch_plan_batch([segments[i] for i in pos],
                                              [plans[i] for i in pos],
                                              **_mesh_kw(msig))
                       for pos, _ in pending.families])

        pending.redispatch = redispatch
        return pending

    def _dispatch_family(self, segments: list, plans: list, positions: list,
                         raw: bool = False, mesh: tuple = ()):
        """One dispatch of a batch family, relieving device memory once on
        an OOM (engine/oom.py); split over the mesh devices when `mesh`
        names a shape."""
        ex = self.executor
        run = ex.dispatch_plan_batch_raw if raw else ex.dispatch_plan_batch
        return with_oom_retry(
            lambda: run([segments[i] for i in positions],
                        [plans[i] for i in positions], **_mesh_kw(mesh)),
            keep_segment=segments[positions[0]], cache=ex.cache)

    def _run_group(self, segments: list, plans_all: list, q: int) -> list:
        """A coalesced group's leader (engine/coalesce.py): ONE family
        launch over the Q queries' plans on the family's planes repeated Q
        times, and ONE fetch; the host arrays, leading dim S*Q. Device OOM
        relieves once for each, as the solo family path does."""
        ex = self.executor

        def dispatch():
            return with_oom_retry(
                lambda: ex.dispatch_plan_batch(segments, plans_all, q),
                keep_segment=segments[0], cache=ex.cache)

        pack = dispatch()
        return with_oom_retry(
            lambda: fetch_packed_batch([pack]), cache=ex.cache,
            retry_fn=lambda: fetch_packed_batch([dispatch()]))[0]

    def _dispatch_one(self, segment, plan, raw: bool = False):
        """One segment's dispatch, relieving device memory once on an
        OOM."""
        ex = self.executor
        run = ex.dispatch_plan_raw if raw else ex.dispatch_plan
        return with_oom_retry(lambda: run(segment, plan),
                              keep_segment=segment, cache=ex.cache)

    def collect_segments(self, routes: list, plans: list,
                         pending: Pending) -> list:
        """Fetch every output of the query to the host in ONE copy and
        decode the intermediates: families all members in one pass
        (engine/combine.py), a coalesced group's rows as a family's, then
        each segment in dispatch order (under its `segment:<name>` span);
        a star-tree member's states map back to the query's; cache hits as
        they came. The misses' aggregation and group-by partials go into
        the segment partial cache (selections bypass it)."""
        if pending.merged_hit is not None:
            return [pending.merged_hit]
        ex = self.executor
        packs = ([pending.merged] if pending.merged is not None
                 else [p for _, p in pending.solo + pending.families])
        fetched = with_oom_retry(
            lambda: fetch_packed_batch(packs), cache=ex.cache,
            retry_fn=lambda: fetch_packed_batch(pending.redispatch()))
        if pending.merged is not None:
            ga = self._merged_group_arrays(plans, fetched[0])
            if pending.merged_key is not None:
                GLOBAL_PARTIAL_CACHE.put(
                    pending.merged_key, ga,
                    tuple(getattr(r.segment, "name", "?") for r in routes))
            return [ga]
        inters: list = [None] * len(routes)
        for i, hit in pending.hits.items():
            inters[i] = hit
        outs_of = {i: outs for (i, _), outs in zip(pending.solo, fetched)}
        for positions, outs_b in (
                [(pos, outs) for (pos, _), outs in zip(
                    pending.families, fetched[len(pending.solo):])]
                + pending.hosts):
            plans_f = [plans[i] for i in positions]
            mode = plans_f[0].program.mode
            batched = (combine_batched_aggregation(outs_b, plans_f)
                       if mode == "aggregation"
                       else combine_batched_dense(outs_b, plans_f))
            if batched is None:  # sparse: each member's row of the outputs
                for row, i in enumerate(positions):
                    outs_of[i] = [o[row] for o in outs_b]
            else:
                for i, inter in zip(positions, batched):
                    inters[i] = inter
        for i in pending.order:
            with TRACING.scope(
                    f"segment:{getattr(routes[i].segment, 'name', '?')}"):
                if inters[i] is None:
                    inters[i] = ex.collect(routes[i].query,
                                           routes[i].segment, plans[i],
                                           outs_of[i])
        for i, key, name in pending.inserts:
            # LIMIT makes a selection's rows order-dependent across
            # segments, and its cost is the host's row work: not cached
            if isinstance(inters[i], (AggIntermediate, GroupByIntermediate)):
                GLOBAL_PARTIAL_CACHE.put(key, inters[i], (name,))
        return [inter if r.rewrite is None
                else self._remap_star_tree(r.rewrite, inter)
                for r, inter in zip(routes, inters)]

    @staticmethod
    def _segment_cache_enabled(query: QueryContext) -> bool:
        """The segment partial cache is on by default; `SET segmentCache =
        false` opts a query out (checked first, so an opted-out query
        never fingerprints) and PINOT_TPU_SEGMENT_CACHE=0 turns it off."""
        return not _opted_out(query, "segmentCache") \
            and partial_cache_enabled()

    @staticmethod
    def _partial_cache_key(route: Route, plan) -> Optional[tuple]:
        """(program fingerprint, segment token) of one routed segment, or
        None where it cannot take part: a star-tree rewrite (its partial
        is pre-remap, over a derived view), a segment without a crc, a
        mutable object without a pinned generation, a plan without a
        canonical encoding."""
        if route.rewrite is not None:
            return None
        token = segment_token(route.segment)
        if token is None:
            return None
        fp = program_fingerprint(plan, route.query)
        return None if fp is None else (fp, token)

    @staticmethod
    def _remap_star_tree(rewrite: StarTreeRewrite, result):
        """Inner (pre-aggregated) states -> the query's aggregation states;
        the scanned-doc count stays the pre-aggregated rows read (the
        star-tree speedup shows in numDocsScanned, as in the reference)."""
        if isinstance(result, GroupByIntermediate):
            return GroupByIntermediate(
                {k: remap_states(rewrite, v)
                 for k, v in result.groups.items()},
                result.num_docs_scanned)
        return AggIntermediate(remap_states(rewrite, result.states),
                               result.num_docs_scanned)

    def _mesh_sig(self, query: QueryContext) -> tuple:
        """The mesh shape of this query's family dispatches: (ndev,) when
        the executor's mesh spans more than one device (parallel/mesh.py
        mesh_device_count, capped by PINOT_TPU_MESH_DEVICES), () for solo
        families. Mesh execution is on by default there; `SET
        meshExecution = false` opts a query out; the host backend has no
        mesh. Part of the batch family key."""
        if self.backend == "host" or _opted_out(query, "meshExecution"):
            return ()
        ndev = mesh_device_count(self.executor.mesh_devices)
        return (ndev,) if ndev > 1 else ()

    def _batch_families(self, query: QueryContext, segments: list,
                        plans: list, mesh: tuple = ()) -> list:
        """Group the segments into batch families by the host-side family
        key (engine/executor.py batch_family_key, `mesh` its mesh axis):
        ordered (key, positions) groups, key None for segments that
        dispatch alone (batching off, or a slot shape the key cannot
        predict)."""
        if len(segments) < 2 or _opted_out(query, "segmentBatch"):
            return [(None, [i]) for i in range(len(segments))]
        groups: dict = {}
        for pos, (segment, plan) in enumerate(zip(segments, plans)):
            fkey = batch_family_key(segment, plan, self.executor.packed_on,
                                    mesh)
            groups.setdefault(("__solo__", pos) if fkey is None else fkey,
                              []).append(pos)
        return [(None if k[0] == "__solo__" else k, v)
                for k, v in groups.items()]

    # device merge ops per sparse AggOp kind (count columns merge like sums)
    _SPARSE_COMBINE_KINDS = {"count": "add", "sum": "add", "sumsq": "add",
                             "min": "min", "max": "max"}

    def _sparse_device_combine(self, query: QueryContext, segments: list,
                               plans: list, cache_on: bool
                               ) -> Optional[Pending]:
        """Server-level merge ON THE DEVICE for multi-segment single-key
        sparse group-bys: dispatch every family (or segment), translate
        each key column to dictionary VALUE space on the device
        (dictionaries are segment-local), merge the S tables with one sort
        (kernels.combine_sparse_group_tables) and pack the ONE merged
        table. Only for shapes where value-space keys are exact: one
        identifier key over an integer dictionary, every agg mergeable;
        None otherwise, or under SET deviceCombine = false, and the query
        takes the per-segment collect and host merge. A DISTINCT bitmap has
        no device merge (its kind maps to None), so its queries take the
        host merge.

        Two cache tiers serve this path: the merged host GroupArrays in
        the segment partial cache, keyed by the sorted member keys (a hit
        is the whole query with no dispatch), and each member's value-space
        table kept on the device (segment/device_cache.py `put_partial`),
        so a member it holds skips its dispatch and feeds the merge."""
        if _opted_out(query, "deviceCombine"):
            return None
        p0 = plans[0].program
        kinds = tuple(self._SPARSE_COMBINE_KINDS.get(a.kind) for a in p0.aggs)
        agg_kinds = tuple(a.kind for a in p0.aggs)
        if p0.mode != "group_by_sparse" or not kinds or None in kinds:
            return None
        for pl in plans:
            p = pl.program
            if not (p.mode == "group_by_sparse"
                    and p.group_strides == (1,)
                    and len(p.group_slots) == 1
                    and not p.group_vexprs
                    and p.mv_group_slot is None
                    and p.exact_trim == p0.exact_trim
                    and tuple(a.kind for a in p.aggs) == agg_kinds
                    and pl.group_dims
                    and np.issubdtype(
                        np.asarray(pl.group_dims[0].dictionary.values).dtype,
                        np.integer)
                    and all(la.vec is not None for la in pl.lowered_aggs)):
                return None
        pending = Pending()
        keys = None
        if cache_on:
            keys = [self._partial_cache_key(Route(query, seg), pl)
                    for seg, pl in zip(segments, plans)]
            if all(k is not None for k in keys):
                # sorted: the merge is order-insensitive, so any order of
                # the same members hits
                pending.merged_key = ("sparse_merged",) + tuple(sorted(keys))
                hit = GLOBAL_PARTIAL_CACHE.get(pending.merged_key)
                if hit is not None:
                    pending.merged_hit = hit
                    pending.cache_hits = len(segments)
                    with TRACING.scope("SEGMENT_CACHE(hit:merged)") as sp:
                        if sp is not None:
                            sp.set_attribute("segments", len(segments))
                            sp.set_attribute("cache", "hit")
                            sp.set_attribute("cacheHitBytes",
                                             _group_arrays_bytes(hit))
                    return pending
        pending.merged = self._sparse_merge(query, segments, plans, kinds,
                                            keys, pending)
        pending.redispatch = lambda: [self._sparse_merge(
            query, segments, plans, kinds, None, Pending())]
        return pending

    @staticmethod
    def _owned(t: torch.Tensor) -> torch.Tensor:
        """`t`, or a copy of it when it is a view into a larger buffer (a
        family member's row): a cached table must not pin the family's
        outputs, which the budget does not count."""
        if t.untyped_storage().nbytes() == t.numel() * t.element_size():
            return t
        return t.clone()

    def _sparse_merge(self, query: QueryContext, segments: list, plans: list,
                      kinds: tuple, keys: Optional[list],
                      pending: Pending) -> PackedOuts:
        """The device half of `_sparse_device_combine`: each member's
        value-space table from the device tier (`keys` given) or from its
        family's (or its own) dispatch, kept in the tier on a miss, then
        the merge and its pack. Counts hits and misses into `pending`."""
        dcache = self.executor.cache
        cached: dict = {}
        if keys is not None:
            for i, k in enumerate(keys):
                if k is not None:
                    tab = dcache.get_partial(("sparse_tab",) + k)
                    if tab is not None:
                        cached[i] = tab
        member_outs: list = [None] * len(segments)
        msig = self._mesh_sig(query)
        for fkey, positions in self._batch_families(query, segments, plans,
                                                    msig):
            positions = [i for i in positions if i not in cached]
            if not positions:
                continue
            if fkey is not None and len(positions) > 1:
                try:
                    outs_b, views_b = self._dispatch_family(
                        segments, plans, positions, raw=True, mesh=msig)
                except (BatchFamilyMismatch, HbmExhaustedError):
                    pass  # the members go alone
                else:
                    # members' rows of the family's outputs stay on the device
                    for row, i in enumerate(positions):
                        member_outs[i] = (tuple(o[row] for o in outs_b),
                                          views_b[row])
                    continue
            for i in positions:
                member_outs[i] = self._dispatch_one(segments[i], plans[i],
                                                    raw=True)
        seg_keys, seg_counts, seg_states = [], [], []
        for i, (seg, pl) in enumerate(zip(segments, plans)):
            tab = cached.get(i)
            if tab is not None:
                pending.cache_hits += 1
            else:
                outs, view = member_outs[i]
                tab = (kernels.ids_to_values_i64(
                    outs[-1], view.dict_values(pl.group_dims[0].column)),
                       outs[0]) + tuple(outs[1:-1])
                if keys is not None and keys[i] is not None:
                    dcache.put_partial(("sparse_tab",) + keys[i],
                                       tuple(self._owned(t) for t in tab),
                                       getattr(seg, "name", "?"))
                    pending.cache_misses += 1
            seg_keys.append(tab[0])
            seg_counts.append(tab[1])
            seg_states.append(tuple(tab[2:]))
        return with_oom_retry(
            lambda: kernels.pack_outputs(kernels.combine_sparse_group_tables(
                seg_keys, seg_counts, seg_states, kinds)), cache=dcache)

    @staticmethod
    def _merged_group_arrays(plans: list, outs: list) -> GroupArrays:
        """The host GroupArrays of the device-merged sparse table."""
        p0 = plans[0].program
        counts = outs[0][:-1]
        gids = np.nonzero(counts)[0]
        trash = int(outs[0][-1])
        dim = plans[0].group_dims[0]
        key_col = outs[-1][gids].astype(
            np.asarray(dim.dictionary.values).dtype, copy=False)
        las = plans[0].lowered_aggs
        return GroupArrays(
            [key_col],
            [la.vec.extract(outs, gids) for la in las],
            [la.vec.spec for la in las],
            [la.vec.fin_tag for la in las],
            num_docs_scanned=int(counts.sum()) + trash,
            groups_trimmed=trash > 0 and not p0.exact_trim)

    def _combine(self, query: QueryContext, intermediates):
        semantics = [semantics_for(a) for a in query.aggregations]
        first = intermediates[0] if intermediates else None
        if isinstance(first, GroupByIntermediate):
            merged = None
            if all(isinstance(im, GroupArrays) for im in intermediates):
                merged = combine_group_arrays(intermediates)
            if merged is None:  # object states, or composite key overflow
                merged = combine_group_by(intermediates, semantics)
            return trim_group_by(merged, query, semantics)
        if isinstance(first, AggIntermediate):
            return combine_aggregation(intermediates, semantics)
        if isinstance(first, SelectionIntermediate):
            return combine_selection(intermediates)
        # no segments (none in the table, or all pruned): shape an empty
        # intermediate from the query
        if query.is_aggregation_query and not query.is_group_by \
                and not query.distinct:
            return AggIntermediate([])
        if query.is_group_by or query.distinct or query.is_aggregation_query:
            return GroupByIntermediate({})
        return SelectionIntermediate(
            [e.identifier for e in query.select_expressions if e.is_identifier],
            [])
