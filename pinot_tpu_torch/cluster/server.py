"""Server role: converge to ideal state, host segments, serve queries.

The port of pinot_tpu/cluster/server.py. Reference analogue:
pinot-server — BaseServerStarter.start:578 boots the instance data manager
+ query executor + Netty server and joins Helix; the state model
SegmentOnlineOfflineStateModelFactory.java:44 handles OFFLINE→ONLINE (load
segment), ONLINE→OFFLINE (release), →DROPPED transitions (:73-140). Here
the transitions are driven by a watch on the ideal state; after each
transition the server updates the external view, exactly Helix's
contract.

A server runs its segments through the port's QueryExecutor on its device:
"cuda" by default (construction raises without an H100-class card), "cpu"
only when asked for (the tests). A query that fails on the server goes
back to the broker as the handler's error (transport RemoteError); there
is no CPU fallback. Each server's executor has its own device cache, so
in-process replicas each upload their own planes, and a dropped segment's
views, stacks and partials are released from this server's cache by name.

The multi-stage engine's stage worker (mse/distributed.py
`MseWorkerService`) answers the `mse_*` requests: it runs plan fragments
on this server's device over the segments the broker routed to it and
exchanges mailbox blocks with the other servers and the broker.

A segment loads under its table's config: the bloom filters the config
asks for and the segment was written without are built at load
(segment/loader.py backfill_indexes; reference SegmentPreProcessor), so
adding one to a live table prunes its old segments too.

With PINOT_TPU_TRACE_SAMPLE set, a shard whose query id the broker's
head sampling picks is traced here too (spi/trace.py `sample_decision`),
and its spans join the broker's retained trace.

Not ported yet: tiered storage (cold and lazy segments, prefetch, and the
AOT prewarm the JAX server runs when it prefetches a segment), the
repair path (a segment that fails verification is quarantined: advertised
ERROR, never routed), streaming queries and `scan_arrow`.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from types import SimpleNamespace
from typing import Optional

import torch

from ..cache.partial import GLOBAL_PARTIAL_CACHE
from ..engine.compile_registry import COMPILE_REGISTRY
from ..engine.dim_tables import alias_dimension_table
from ..engine.explain import explain_plan
from ..engine.query_executor import QueryExecutor
from ..engine.scheduler import QueryScheduler
from ..segment.loader import SegmentIntegrityError, load_segment
from ..spi import faults
from ..spi.data_types import Schema
from ..spi.metrics import SERVER_METRICS, ServerGauge, ServerMeter
from ..spi.table_config import TableConfig
from ..spi.trace import TRACING, sample_decision, trace_sample_rate
from .controller import ERROR, ONLINE, raw_table_name
from .datatable import encode
from .store import PropertyStore, StoreError
from .transport import RpcServer

log = logging.getLogger(__name__)

# transient load failures a segment gets before the server stops retrying
# it (integrity failures quarantine at once)
LOAD_RETRIES = 5


def _quantile(sorted_ms: list, q: float) -> float:
    """Nearest-rank quantile over an already-sorted latency sample."""
    if not sorted_ms:
        return 0.0
    idx = min(len(sorted_ms) - 1, int(q * len(sorted_ms)))
    return round(float(sorted_ms[idx]), 3)


def device_listing(device: torch.device) -> dict:
    """The server's device for health beacons: type, and on a card its
    name, compute capability and memory (total, allocated by torch,
    reserved by its allocator)."""
    out = {"type": device.type}
    if device.type != "cuda":
        return out
    i = device.index if device.index is not None else torch.cuda.current_device()
    props = torch.cuda.get_device_properties(i)
    out.update(index=i, name=props.name,
               computeCapability=f"{props.major}.{props.minor}",
               totalMemoryBytes=int(props.total_memory),
               allocatedBytes=int(torch.cuda.memory_allocated(i)),
               reservedBytes=int(torch.cuda.memory_reserved(i)))
    return out


class ServerInstance:
    def __init__(self, store: PropertyStore, instance_id: str,
                 device="cuda", tags: Optional[list[str]] = None,
                 max_concurrent_queries: int = 8):
        self.store = store
        self.instance_id = instance_id
        self.tags = tags or ["DefaultTenant"]
        # raises without a usable card unless the caller asked for the CPU
        self.executor = QueryExecutor(device=device)
        self.device = self.executor.device
        # admission control in front of execution (reference:
        # QueryScheduler.submit, fcfs default policy)
        self.scheduler = QueryScheduler(max_concurrent=max_concurrent_queries)
        # tableNameWithType → {segment_name: ImmutableSegment}
        self.segments: dict[str, dict[str, object]] = {}
        # integrity quarantine: tableNameWithType → {segment_name → entry}
        # (a replica that failed load-verify; advertised ERROR, never routed)
        self.quarantined: dict[str, dict[str, dict]] = {}
        # transient (non-integrity) load failures: (table, seg) → attempts;
        # bounded so one flaky deep-store read doesn't loop a converge hot
        self._load_failures: dict[tuple, int] = {}
        self._lock = threading.RLock()
        self._rpc = RpcServer(self._handle)
        # supplier gauges, polled only at scrape time: this server's device
        # cache bytes, each card's allocated bytes, and the process's
        # executable families with their summed cold cost (the compile
        # registry: the dispatch path never pays for these)
        cache = self.executor.executor.cache
        self._gauges = {
            ServerGauge.HBM_BYTES_USED: cache.bytes_used,
            ServerGauge.HBM_EVICTIONS: lambda: cache.evictions,
            ServerGauge.COMPILE_FAMILIES:
                lambda: COMPILE_REGISTRY.totals()["families"],
            ServerGauge.COMPILE_MS_TOTAL:
                lambda: COMPILE_REGISTRY.totals()["compileMs"]}
        if self.device.type == "cuda":
            for i in range(torch.cuda.device_count()):
                self._gauges[f"hbmBytesUsedDevice.{i}"] = \
                    lambda i=i: torch.cuda.memory_allocated(i)
        for name, fn in self._gauges.items():
            SERVER_METRICS.set_gauge(name, fn)
        self._started = False
        # readiness gates on the FIRST converge pass completing
        self._converged = False
        # per-INSTANCE wall-ms of recent query RPCs (the metrics-registry
        # timers are process-wide, shared by co-hosted instances)
        self._query_ms: deque = deque(maxlen=256)

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> None:
        self.store.set(f"/INSTANCECONFIGS/{self.instance_id}",
                       {"host": self._rpc.host, "port": self._rpc.port,
                        "tags": self.tags})
        self.store.set(f"/LIVEINSTANCES/{self.instance_id}",
                       {"host": self._rpc.host, "port": self._rpc.port},
                       ephemeral_owner=self.instance_id)
        self.store.watch("/IDEALSTATES/", self._on_ideal_state)
        self._started = True
        # replay current ideal states (Helix replays pending transitions on join)
        for table in self.store.children("/IDEALSTATES"):
            self._converge(table, self.store.get(f"/IDEALSTATES/{table}"))
        self._converged = True

    def stop(self) -> None:
        """Simulates process death: ephemeral live-instance entry expires.
        Instance config stays (reference: ZK session expiry vs config)."""
        self._started = False
        self._converged = False
        self._rpc.close()
        worker = getattr(self, "_mse_worker", None)
        if worker is not None:
            worker.close()
        # a dead server left in the store's watch list is pinned alive
        # with every loaded segment
        self.store.unwatch(self._on_ideal_state)
        self.store.expire_session(self.instance_id)
        for name, fn in self._gauges.items():
            SERVER_METRICS.remove_gauge(name, fn)

    @property
    def address(self) -> tuple[str, int]:
        return (self._rpc.host, self._rpc.port)

    # -- state transitions --------------------------------------------------
    def _on_ideal_state(self, path: str, value) -> None:
        if not self._started:
            return
        table = path.rsplit("/", 1)[-1]
        self._converge(table, value)

    def _converge(self, table: str, ideal: Optional[dict]) -> None:
        """Diff ideal vs hosted → load/drop (the OFFLINE→ONLINE / →DROPPED
        transitions)."""
        ideal = ideal or {}
        want = {seg for seg, m in ideal.items()
                if m.get(self.instance_id) == ONLINE}
        with self._lock:
            have = set(self.segments.get(table, {}))
            indexing = None
            if want - have:
                cfg_json = self.store.get(f"/CONFIGS/TABLE/{table}")
                if cfg_json and "tableName" in cfg_json:
                    indexing = TableConfig.from_json(cfg_json).indexing
            for seg in want - have:
                meta = self.store.get(f"/SEGMENTS/{table}/{seg}")
                if meta is None:
                    continue
                if seg in self.quarantined.get(table, {}):
                    continue  # failed verification; reloading fails again
                if self._load_failures.get((table, seg), 0) \
                        >= LOAD_RETRIES:
                    continue
                try:
                    segment = self._load_segment_verified(table, seg, meta,
                                                          indexing)
                except SegmentIntegrityError as e:
                    self._quarantine(table, seg, e)
                    continue
                except Exception:
                    # a failed load must not abort convergence of the other
                    # segments; the external view below advertises only
                    # what loaded, so the broker routes elsewhere
                    n = self._load_failures.get((table, seg), 0) + 1
                    self._load_failures[(table, seg)] = n
                    log.exception("%s: failed to load segment %s/%s "
                                  "(attempt %d/%d)", self.instance_id, table,
                                  seg, n, LOAD_RETRIES)
                    continue
                self.segments.setdefault(table, {})[seg] = segment
                self._load_failures.pop((table, seg), None)
            cache = self.executor.executor.cache
            for seg in have - want:
                # a dropped or replaced segment invalidates its cached
                # partials and releases its planes, stacks and device
                # partials from THIS server's cache (each executor has one)
                segment = self.segments.get(table, {}).pop(seg, None)
                GLOBAL_PARTIAL_CACHE.invalidate_segment(seg)
                if segment is not None:
                    cache.drop(segment)
                cache.drop_named(seg)
            for seg in set(self.quarantined.get(table, ())) - want:
                self.quarantined[table].pop(seg, None)
            for key in [k for k in self._load_failures
                        if k[0] == table and k[1] not in want]:
                self._load_failures.pop(key, None)
            self._register_table(table)
            loaded = set(self.segments.get(table, {}))
        # a skipped or FAILED load must not appear ONLINE, or the broker
        # would silently lose its rows
        self._update_external_view(table, want & loaded)

    def _load_segment_verified(self, table: str, seg: str, meta: dict,
                               indexing=None):
        """Load + verify one segment directory in place (the deep-store
        address is a plain directory: there is no tier manager to fetch
        into), then build the bloom filters `indexing` asks for and it
        lacks. The ``segment.load`` fault point fires here; a ``corrupt``
        fault fails verification as a damaged copy would."""
        if faults.ACTIVE:
            try:
                faults.FAULTS.fire("segment.load", table=table, segment=seg)
            except faults.InjectedCorruption as c:
                raise SegmentIntegrityError(seg, meta["location"],
                                            str(c)) from None
        segment = load_segment(meta["location"])
        want = meta.get("crc")
        have = getattr(getattr(segment, "metadata", None), "crc", None)
        if want is not None and have is not None and str(want) != str(have):
            raise SegmentIntegrityError(
                seg, meta["location"],
                f"crc {have} differs from the pushed crc {want}")
        if indexing is not None:
            segment.backfill_indexes(indexing)
        return segment

    def _quarantine(self, table: str, seg: str, err) -> None:
        """Record an integrity failure: the replica is advertised ERROR
        (excluded from broker routing) with the reason kept."""
        entry = {
            "reason": str(err),
            "columns": list(getattr(err, "columns", []) or []),
            "sinceMs": int(time.time() * 1000),
        }
        with self._lock:
            self.quarantined.setdefault(table, {})[seg] = entry
        SERVER_METRICS.add_meter(ServerMeter.SEGMENTS_QUARANTINED)
        log.error("%s: quarantined segment %s/%s: %s",
                  self.instance_id, table, seg, err)

    def health_status(self) -> dict:
        """Per-instance health beacon (the `status` RPC): instance-local
        state, the device listing and the process metric singletons."""
        lat = sorted(self._query_ms)
        with self._lock:
            quarantined = {t: sorted(q) for t, q in self.quarantined.items()
                           if q}
            num_segments = sum(len(s) for s in self.segments.values())
            num_docs = sum(int(getattr(seg, "num_docs", 0))
                           for table in self.segments.values()
                           for seg in table.values())
        return {
            "instanceId": self.instance_id,
            "started": self._started,
            "converged": self._converged,
            "queryLatencyMs": {
                "count": len(lat),
                "p50": _quantile(lat, 0.50),
                "p95": _quantile(lat, 0.95),
                "p99": _quantile(lat, 0.99),
            },
            "device": device_listing(self.device),
            "deviceCache": self.executor.executor.cache.stats(),
            "segmentCache": {
                "hits": SERVER_METRICS.meter_count(
                    ServerMeter.SEGMENT_CACHE_HITS),
                "misses": SERVER_METRICS.meter_count(
                    ServerMeter.SEGMENT_CACHE_MISSES),
            },
            "quarantined": quarantined,
            "numSegments": num_segments,
            "numDocs": num_docs,
        }

    def _register_table(self, table: str) -> None:
        raw = raw_table_name(table)
        schema_json = self.store.get(f"/SCHEMAS/{raw}")
        if schema_json is None or table not in self.segments:
            return
        schema = Schema.from_json(schema_json)
        segments = list(self.segments[table].values())
        cfg = self.store.get(f"/CONFIGS/TABLE/{table}") or {}
        if cfg.get("warmOnLoad"):
            # pre-upload column planes off the convergence thread
            # (reference: segment preload on load; the first query skips
            # the host-to-device copies)
            threading.Thread(target=self._warm, args=(table, segments),
                             daemon=True, name=f"warm-{table}").start()
        if cfg.get("isDimTable") and schema.primary_key_columns:
            # dimension table: every server holds the full copy and serves
            # LOOKUP joins from it (reference DimensionTableDataManager);
            # LOOKUP callers name the RAW table
            self.executor.add_dimension_table(schema, segments, name=table)
            alias_dimension_table(raw, table)
            return
        self.executor.add_table(schema, segments, name=table)

    def _warm(self, table: str, segments: list) -> None:
        cache = self.executor.executor.cache
        for seg in segments:
            try:
                cache.warm(seg)
            except Exception:
                # queries upload what they need; the failure is logged
                log.exception("%s: warmOnLoad of %s/%s failed",
                              self.instance_id, table,
                              getattr(seg, "name", "?"))
                return

    def _update_external_view(self, table: str, online: set) -> None:
        with self._lock:
            error = set(self.quarantined.get(table, ())) - set(online)

        def upd(view):
            view = view or {}
            for seg in list(view):
                view[seg].pop(self.instance_id, None)
                if not view[seg]:
                    del view[seg]
            for seg in online:
                view.setdefault(seg, {})[self.instance_id] = ONLINE
            # quarantined replicas are advertised ERROR: visible to the
            # controller, invisible to broker routing (ONLINE only)
            for seg in error:
                view.setdefault(seg, {})[self.instance_id] = ERROR
            return view

        # a glitching control plane (injected store.write fault, CAS
        # contention burst) must not abort convergence: retry briefly, then
        # leave the old advertisement — the next converge republishes
        for attempt in range(4):
            try:
                self.store.update(f"/EXTERNALVIEW/{table}", upd)
                return
            except (StoreError, faults.InjectedFault):
                if attempt == 3:
                    log.warning("%s: external-view update for %s kept "
                                "failing; serving stale view until next "
                                "converge", self.instance_id, table,
                                exc_info=True)
                else:
                    time.sleep(0.01 * (attempt + 1))

    # -- query plane --------------------------------------------------------
    def _handle(self, request):
        kind = request.get("type")
        if kind == "query":
            t0 = time.perf_counter()
            try:
                return self._handle_query(request)
            finally:
                # timed here so scheduler waits and injected server.query
                # delays land in the ring too
                self._query_ms.append((time.perf_counter() - t0) * 1000.0)
        if kind == "status":
            return self.health_status()
        if kind == "explain":
            return self._handle_explain(request)
        if kind == "ping":
            return "pong"
        if kind == "cancel":
            # broker abandon/timeout: flag the tracker so the segment loop's
            # check_cancel stops device work. A prefix cancel kills every
            # shard of the query (`<query_id>:<n>` ids) and tombstones the
            # prefix so a shard that lost the race still dies on arrival.
            reason = request.get("reason", "cancelled by broker")
            qid = request.get("queryId", "")
            if request.get("prefix"):
                return {"cancelled": self.scheduler.accountant.kill_prefix(
                    qid, reason=reason) > 0}
            return {"cancelled": self.scheduler.accountant.kill_query(
                qid, reason=reason)}
        if isinstance(kind, str) and kind.startswith("mse_"):
            return self.mse_worker.handle(request)
        raise ValueError(f"unknown request type {kind}")

    @property
    def mse_worker(self):
        """The multi-stage stage worker (mse/distributed.py), built on the
        first `mse_*` request. Double-checked under the instance lock:
        stage dispatches and mailbox deliveries arrive concurrently, and an
        unlocked first touch could build two services, the losing
        request's blocks landing in an orphaned store."""
        worker = getattr(self, "_mse_worker", None)
        if worker is None:
            with self._lock:
                worker = getattr(self, "_mse_worker", None)
                if worker is None:
                    from ..mse.distributed import MseWorkerService

                    worker = MseWorkerService(self)
                    self._mse_worker = worker
        return worker

    def _handle_query(self, request):
        """Execute a QueryContext over an explicit segment list (the broker
        names segments per server, reference InstanceRequest.searchSegments)
        under the scheduler's admission control."""
        table = request["table"]
        names = request["segments"]
        query = request["query"]
        if faults.ACTIVE:
            faults.FAULTS.fire("server.query", table=table,
                               instance=self.instance_id)
        # deadline propagation: the broker stamps its remaining budget on
        # the request; it bounds the scheduler queue wait AND clamps the
        # per-segment loop's timeoutMs (the request is unpickled fresh per
        # RPC, so mutating query_options here is private to this call)
        deadline_ms = request.get("deadlineMs")
        query_id = request.get("queryId")
        timeout_s = 60.0
        if deadline_ms is not None:
            left_ms = max(50.0, float(deadline_ms))
            timeout_s = max(0.05, min(60.0, left_ms / 1000.0))
            cur = query.query_options.get("timeoutMs")
            query.query_options["timeoutMs"] = (
                left_ms if cur is None else min(float(cur), left_ms))
        with self._lock:
            hosted = self.segments.get(table, {})
            segs = [hosted[n] for n in names if n in hosted]
            missing = [n for n in names if n not in hosted]

        def run(tracker):
            return self.executor.execute_segments(query, segs, tracker=tracker)

        # the server owns a trace for its shard of the query: scheduler
        # .submit runs `run` on this thread, so the thread-local trace
        # covers execute_segments and its dispatches; the span list rides
        # back next to the DataTable for the broker to merge
        trace = None
        if TRACING.active_trace() is None:
            if query.query_options.get("trace") in (True, "true", 1):
                # the analyze marker keeps cache tiers live under this trace
                trace = TRACING.start_trace(
                    f"server:{self.instance_id}",
                    analyze=query.query_options.get("analyze") in
                    (True, "true", 1))
            elif query_id:
                # flight-recorder head sampling: hash the broker's query id
                # (a shard carries `<query_id>:<n>`), so every shard makes
                # the broker's own decision with no option on the wire;
                # analyze=True keeps the caches live, so a sampled query
                # behaves as its unsampled twin
                root_qid = str(query_id).split(":", 1)[0]
                if sample_decision(root_qid, trace_sample_rate()):
                    trace = TRACING.start_trace(
                        f"server:{self.instance_id}", analyze=True)
        t_exec = time.perf_counter()
        try:
            combined, stats = self.scheduler.submit(
                run, group=table, timeout_s=timeout_s, query_id=query_id)
        finally:
            if trace is not None:
                TRACING.end_trace()
        exec_ms = (time.perf_counter() - t_exec) * 1000.0
        stats["missing_segments"] = missing
        # intermediates travel as the versioned binary DataTable, not as
        # pickled Python objects (reference: DataTableImplV4 on the wire)
        t_enc = time.perf_counter()
        blob = encode(combined, stats)
        encode_ms = (time.perf_counter() - t_enc) * 1000.0
        if faults.ACTIVE:
            # the "datatable.encode" corrupt fault damages the encoded
            # payload: the broker's checksum must catch it downstream
            blob = faults.corrupt_at("datatable.encode", blob, table=table,
                                     instance=self.instance_id)
        out = {"datatable": blob,
               "serverMs": {"execute": exec_ms, "encode": encode_ms}}
        if trace is not None:
            out["trace"] = trace.to_json()
        return out

    def _handle_explain(self, request):
        """Render the operator-tree plan for this server's hosted segments
        without executing (reference: EXPLAIN runs the plan maker only)."""
        table = request["table"]
        names = request["segments"]
        query = request["query"]
        with self._lock:
            hosted = self.segments.get(table, {})
            segs = [hosted[n] for n in names if n in hosted]
        rt = explain_plan(query, SimpleNamespace(segments=segs),
                          self.executor.pruner, self.executor.executor.packed_on,
                          use_star_tree=self.executor.use_star_tree)
        return {"columns": rt.schema.column_names,
                "types": rt.schema.column_types, "rows": rt.rows}
