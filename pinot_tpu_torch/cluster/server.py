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
only when asked for (the tests), under the executor's `backend`: "device"
by default, "host" (every segment on the host engine; warmOnLoad uploads
nothing) or "auto" (a segment the planner refuses on the host engine). A
query that fails on the server goes back to the broker as the handler's
error (transport RemoteError); no backend hides a device fault behind the
host engine. Each server's executor has its own device cache, so
in-process replicas each upload their own planes, and a dropped segment's
views, stacks and partials are released from this server's cache by name.

The multi-stage engine's stage worker (mse/distributed.py
`MseWorkerService`) answers the `mse_*` requests: it runs plan fragments
on this server's device over the segments the broker routed to it and
exchanges mailbox blocks with the other servers and the broker.

A segment loads under its table's config: the bloom filters the config
asks for and the segment was written without are built at load
(segment/loader.py backfill_indexes; reference SegmentPreProcessor), so
adding one to a live table prunes its old segments too; so are the
inverted, range, JSON, text, vector and geo indexes it asks for.

With PINOT_TPU_TRACE_SAMPLE set, a shard whose query id the broker's
head sampling picks is traced here too (spi/trace.py `sample_decision`),
and its spans join the broker's retained trace.

Tiered storage (storage/tier.py): every local copy of a segment goes
through the server's SegmentTierManager under one byte budget
(`local_storage_mb`; None = unbounded). A tarred deep-store location is
untarred into the tier; a plain directory is read in place. Once the tier
is at its budget, a newly assigned segment registers COLD (metadata only,
still advertised ONLINE) and the first query routed to it, a
/PREFETCH/{table} nudge or an MSE leaf warms it within the query's
deadline. Under byte pressure the tier demotes the coolest unpinned
segment to cold: its cached partials go at once, its device view and
family stacks when the tier finalizes the copy (after its last reader),
and the next query over the segment uploads fresh planes. A scan pins
its segments' tier copies, so none of them is demoted under its launches;
a query's own warm pins the routed segments already resident. A segment that fails
verification (at converge, on a cold warm under the `storage.fetch`
fault, or after a repair) is quarantined: advertised ERROR, never routed,
and repaired from a FRESH deep-store copy in the background (a bounded
number of attempts, then flagged `unrepairable`), or on a /REPAIRS/
nudge. A failed warm or repair never answers from the host: the segment
stays cold or quarantined and the broker retries a replica or degrades.

The destination load of an in-flight rebalance move (the /REBALANCE/
journal names this server) passes the `rebalance.move` fault point, with
the same corrupt-then-quarantine contract. A `scan_arrow` request reads
one hosted segment straight from its storage as Arrow IPC bytes
(`connectors/arrow_reader.py`), under the tier's reading pin; it needs
pyarrow, and without it raises the same ImportError as the JAX package's.
The JAX package's PINOT_TPU_AUTO_REPAIR, _REPAIR_RETRIES,
_REPAIR_BACKOFF_MS, _COLD_SYNC_FLOOR_MS and _LOAD_RETRIES are the
constructor's `auto_repair` and this module's constants here.
"""

from __future__ import annotations

import logging
import shutil
import tempfile
import threading
import time
from collections import deque
from pathlib import Path
from types import SimpleNamespace
from typing import Optional

import torch

from ..cache.partial import GLOBAL_PARTIAL_CACHE
from ..engine import aot_cache
from ..engine.compile_registry import COMPILE_REGISTRY
from ..engine.dim_tables import alias_dimension_table
from ..engine.explain import explain_plan
from ..engine.query_executor import QueryExecutor
from ..engine.scheduler import QueryScheduler
from ..parallel.mesh import mesh_device_count
from ..segment.format import DATA_FILE
from ..segment.loader import SegmentIntegrityError, load_segment
from ..spi import faults
from ..spi.data_types import Schema
from ..spi.metrics import SERVER_METRICS, ServerGauge, ServerMeter, ServerTimer
from ..spi.table_config import TableConfig
from ..spi.trace import TRACING, sample_decision, trace_sample_rate
from ..storage.tier import SegmentTierManager
from .controller import ERROR, ONLINE, raw_table_name
from .datatable import encode
from .store import PropertyStore, StoreError
from .transport import RpcServer

log = logging.getLogger(__name__)

# transient load failures a segment gets before the server stops retrying
# it (integrity failures quarantine at once)
LOAD_RETRIES = 5
# fresh deep-store fetches a quarantined segment gets, with exponential
# backoff from REPAIR_BACKOFF_MS (capped at 2 s), before it is flagged
# unrepairable
REPAIR_RETRIES = 3
REPAIR_BACKOFF_MS = 50.0
# a query warming cold segments stops waiting this long before its
# deadline, so the answer (partial, or retried by the broker) still
# arrives in time
COLD_SYNC_FLOOR_MS = 25.0
# how long a prefetch warm waits for one segment before moving on
PREFETCH_WARM_WAIT_S = 30.0


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


class _EvictedCopy:
    """What the tier's evict callback hands back: the release of a demoted
    segment's device state, run by the tier once the last reader of its
    tier copy has drained (storage/tier.py `_finalize`). Holding the
    segment object until then keeps its id() from naming another object,
    so the id-keyed view and family stacks released are this copy's."""

    __slots__ = ("server", "table", "name", "segment")

    def __init__(self, server, table: str, name: str, segment):
        self.server = server
        self.table = table
        self.name = name
        self.segment = segment

    def destroy(self) -> None:
        segment, self.segment = self.segment, None
        cache = self.server.executor.executor.cache
        if segment is not None:
            cache.release(segment)
        with self.server._lock:
            back = self.name in self.server.segments.get(self.table, {})
        if not back:
            # no newer copy is resident: whatever else is keyed by the
            # name (a stack of an earlier incarnation) goes too
            cache.drop_named(self.name)


class ServerInstance:
    def __init__(self, store: PropertyStore, instance_id: str,
                 device="cuda", tags: Optional[list[str]] = None,
                 max_concurrent_queries: int = 8,
                 local_storage_mb: Optional[float] = None,
                 auto_repair: bool = True, backend: str = "device"):
        self.store = store
        self.instance_id = instance_id
        self.tags = tags or ["DefaultTenant"]
        # raises without a usable card unless the caller asked for the CPU;
        # `backend` is QueryExecutor's ("device", "host" or "auto")
        self.executor = QueryExecutor(device=device, backend=backend)
        self.device = self.executor.device
        self.backend = backend
        # tiered storage: the byte-budgeted local disk tier beneath the
        # device plane cache. Every locally materialized segment directory
        # (converge load, cold lazy load, repair re-fetch) goes through
        # tier.acquire(), so ONE budget accounts for all of them
        self._tier = SegmentTierManager(
            instance_id=instance_id, budget_mb=local_storage_mb,
            evict_cb=self._evict_segment, heat_fn=self._broker_table_costs)
        # a quarantined segment is repaired in the background; off, only a
        # /REPAIRS/ nudge or a direct repair_segment() call repairs it
        self.auto_repair = auto_repair
        # cold (metadata-only) segments: advertised ONLINE but not local,
        # tableNameWithType → {segment_name: /SEGMENTS meta dict}
        self._cold: dict[str, dict[str, dict]] = {}
        # catalog meta of RESIDENT segments, kept so eviction can demote
        # them back to cold without a store read
        self._seg_meta: dict[tuple, dict] = {}
        # in-flight cold warms: (table, seg) → completion Event, so
        # concurrent queries coalesce on one fetch instead of racing
        self._warming: dict[tuple, threading.Event] = {}
        # admission control in front of execution (reference:
        # QueryScheduler.submit, fcfs default policy)
        self.scheduler = QueryScheduler(max_concurrent=max_concurrent_queries)
        # tableNameWithType → {segment_name: ImmutableSegment}
        self.segments: dict[str, dict[str, object]] = {}
        # integrity quarantine: tableNameWithType → {segment_name → entry}
        # (a replica that failed load-verify; advertised ERROR, never
        # routed, owned by the repair path until it re-verifies)
        self.quarantined: dict[str, dict[str, dict]] = {}
        # transient (non-integrity) load failures: (table, seg) → attempts;
        # bounded so one flaky deep-store read doesn't loop a converge hot,
        # reset by a repair nudge, a successful load, or a drop
        self._load_failures: dict[tuple, int] = {}
        self._lock = threading.RLock()
        self._rpc = RpcServer(self._handle)
        # supplier gauges, polled only at scrape time: this server's device
        # cache bytes (now and the most held at once), each card's
        # allocated bytes, and the process's executable families with
        # their summed cold cost (the compile registry: the dispatch path
        # never pays for these)
        cache = self.executor.executor.cache
        self._gauges = {
            ServerGauge.HBM_BYTES_USED: cache.bytes_used,
            ServerGauge.HBM_BYTES_HIGH_WATER: cache.high_water_bytes,
            ServerGauge.HBM_EVICTIONS: lambda: cache.evictions,
            ServerGauge.COMPILE_FAMILIES:
                lambda: COMPILE_REGISTRY.totals()["families"],
            ServerGauge.COMPILE_MS_TOTAL:
                lambda: COMPILE_REGISTRY.totals()["compileMs"]}
        if backend != "host":
            # the devices the segment-axis mesh spans (parallel/mesh.py)
            mesh_devices = self.executor.executor.mesh_devices
            self._gauges[ServerGauge.MESH_DEVICES] = \
                lambda: mesh_device_count(mesh_devices)
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
        self.store.watch("/REPAIRS/", self._on_repair_request)
        self.store.watch("/PREFETCH/", self._on_prefetch)
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
        self.store.unwatch(self._on_repair_request)
        self.store.unwatch(self._on_prefetch)
        self.store.expire_session(self.instance_id)
        for name, fn in self._gauges.items():
            SERVER_METRICS.remove_gauge(name, fn)
        # every tier-local copy goes with the process
        self._tier.close()

    @property
    def address(self) -> tuple[str, int]:
        return (self._rpc.host, self._rpc.port)

    # -- state transitions --------------------------------------------------
    def _on_ideal_state(self, path: str, value) -> None:
        if not self._started:
            return
        table = path.rsplit("/", 1)[-1]
        self._converge(table, value)

    def _indexing(self, table: str):
        """The table config's indexing (the bloom filters a load builds
        when the segment lacks them), or None."""
        cfg_json = self.store.get(f"/CONFIGS/TABLE/{table}")
        if cfg_json and "tableName" in cfg_json:
            return TableConfig.from_json(cfg_json).indexing
        return None

    def _converge(self, table: str, ideal: Optional[dict]) -> None:
        """Diff ideal vs hosted → load/drop (the OFFLINE→ONLINE / →DROPPED
        transitions)."""
        ideal = ideal or {}
        want = {seg for seg, m in ideal.items()
                if m.get(self.instance_id) == ONLINE}
        repair_kicks = []
        with self._lock:
            have = set(self.segments.get(table, {}))
            indexing = self._indexing(table) if want - have else None
            for seg in want - have:
                meta = self.store.get(f"/SEGMENTS/{table}/{seg}")
                if meta is None:
                    continue
                if seg in self.quarantined.get(table, {}):
                    # the local copy failed verification; the repair path
                    # owns it until a fresh deep-store fetch verifies
                    continue
                if self._load_failures.get((table, seg), 0) \
                        >= LOAD_RETRIES:
                    continue  # transient retries exhausted; needs a nudge
                if self._tier.should_lazy_load():
                    # the local tier is at its budget: register the segment
                    # COLD (metadata only, no fetch). It still advertises
                    # ONLINE below; the first query routed here, a
                    # prefetch nudge or an MSE leaf warms it
                    self._cold.setdefault(table, {})[seg] = meta
                    continue
                try:
                    segment = self._load_segment_verified(table, seg, meta,
                                                          indexing)
                except SegmentIntegrityError as e:
                    # quarantine (ERROR in the external view, excluded
                    # from routing) and hand off to repair
                    self._quarantine(table, seg, e)
                    repair_kicks.append(seg)
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
                self._seg_meta[(table, seg)] = meta
                self._cold.get(table, {}).pop(seg, None)
                self._load_failures.pop((table, seg), None)
            cache = self.executor.executor.cache
            cold_tbl = self._cold.get(table, {})
            for seg in set(cold_tbl) - want:
                # a departed cold segment has no local bytes or live object,
                # but name-keyed device leftovers of its resident days and
                # its cached partials must still go
                cold_tbl.pop(seg, None)
                GLOBAL_PARTIAL_CACHE.invalidate_segment(seg)
                cache.drop_named(seg)
            for seg in have - want:
                # a dropped or replaced segment invalidates its cached
                # partials and releases its planes, stacks and device
                # partials from THIS server's cache (each executor has one)
                segment = self.segments.get(table, {}).pop(seg, None)
                self._seg_meta.pop((table, seg), None)
                self._tier.forget(table, seg)
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
            online = want & (set(self.segments.get(table, {}))
                             | set(self._cold.get(table, ())))
        # advertise what loaded PLUS the cold registrations (a cold replica
        # is routable: the first query warms it); a skipped or FAILED load
        # must not appear ONLINE, or the broker would silently lose rows
        self._update_external_view(table, online)
        for seg in repair_kicks:
            self._kick_repair(table, seg)

    def _load_segment_verified(self, table: str, seg: str, meta: dict,
                               indexing=None, fresh: bool = False,
                               cold: bool = False):
        """Fetch + load + verify one segment, then build the bloom filters
        `indexing` asks for and it lacks. The ``segment.load`` fault point
        fires here, and a cold warm's ``storage.fetch`` too (a ``delay``
        models a slow deep store); an injected ``corrupt`` fault damages a
        local COPY of the fetched directory (the deep store stays
        pristine, so a repair heals) and the verifying loader catches it.
        The destination load of an in-flight rebalance move passes the
        ``rebalance.move`` point with the same contract."""
        corruption = None
        if faults.ACTIVE:
            try:
                faults.FAULTS.fire("segment.load", table=table, segment=seg)
            except faults.InjectedCorruption as c:
                corruption = c
            if corruption is None and cold:
                try:
                    faults.FAULTS.fire("storage.fetch", table=table,
                                       segment=seg,
                                       instance=self.instance_id)
                except faults.InjectedCorruption as c:
                    corruption = c
            if corruption is None and self._is_move_destination(table, seg):
                # chaos seam for a mid-rebalance failure: this load is the
                # DESTINATION fetch of an in-flight segment move (the
                # /REBALANCE journal names this instance as the target)
                try:
                    faults.FAULTS.fire("rebalance.move", table=table,
                                       segment=seg,
                                       instance=self.instance_id)
                except faults.InjectedCorruption as c:
                    corruption = c
        # the deep-store fetch goes THROUGH the tier (reference:
        # SegmentFetcherFactory on OFFLINE→ONLINE): a tarball is untarred
        # into its byte-budgeted cache, a plain directory loads in place;
        # `fresh` fetches a new copy, so a repair never reuses a damaged
        # one. The copy carries one reader ref (`hold`): no concurrent
        # fetch's eviction reclaims it before the loader has read it
        local = self._tier.acquire(table, seg, meta["location"],
                                   fresh=fresh, hold=True)
        damaged = None
        try:
            if corruption is not None:
                damaged = self._corrupt_local_copy(local, corruption)
                local = str(damaged / Path(local).name)
            segment = load_segment(local)
            want = meta.get("crc")
            have = getattr(getattr(segment, "metadata", None), "crc", None)
            if want is not None and have is not None \
                    and str(want) != str(have):
                raise SegmentIntegrityError(
                    seg, local,
                    f"crc {have} differs from the pushed crc {want}")
            if indexing is not None:
                segment.backfill_indexes(indexing)
        finally:
            self._tier.release(table, seg)
            if damaged is not None:
                shutil.rmtree(damaged, ignore_errors=True)
        return segment


    def _is_move_destination(self, table: str, seg: str) -> bool:
        """True when an active rebalance move targets (table, seg) AT this
        instance; consulted only under faults.ACTIVE, so the extra store
        read never taxes a normal load."""
        try:
            job = self.store.get(f"/REBALANCE/{table}")
        except (StoreError, OSError):
            return False
        if not job or job.get("status") not in ("IN_PROGRESS", "ABORTING"):
            return False
        return any(move.get("segment") == seg
                   and self.instance_id in (move.get("adds") or {})
                   and move.get("state") in ("PENDING", "ADDING")
                   for move in job.get("movePlan") or [])
    def _corrupt_local_copy(self, local: str, c) -> Path:
        """Copy the fetched segment directory and damage the copy's data
        file (on-disk or local-FS corruption, the source untouched).
        Returns the copy's parent, which the caller removes."""
        src = Path(local)
        root = Path(tempfile.mkdtemp(prefix=f"{self.instance_id}_corrupt_"))
        dst = root / src.name
        shutil.copytree(src, dst)
        data = dst / DATA_FILE
        data.write_bytes(faults.corrupt_bytes(
            data.read_bytes(), c.mode, c.seed, c.index))
        return root

    # -- integrity quarantine + repair --------------------------------------
    def _quarantine(self, table: str, seg: str, err) -> None:
        """Record an integrity failure: the replica is advertised ERROR
        (excluded from broker routing) with the reason kept, and the repair
        path takes ownership."""
        entry = {
            "reason": str(err),
            "columns": list(getattr(err, "columns", []) or []),
            "sinceMs": int(time.time() * 1000),
            "repairAttempts": 0,
            "unrepairable": False,
        }
        with self._lock:
            self.quarantined.setdefault(table, {})[seg] = entry
        SERVER_METRICS.add_meter(ServerMeter.SEGMENTS_QUARANTINED)
        log.error("%s: quarantined segment %s/%s: %s",
                  self.instance_id, table, seg, err)

    def _kick_repair(self, table: str, seg: str) -> None:
        """Start a background repair unless auto-repair is off (tests turn
        it off to drive repair deterministically)."""
        if not self.auto_repair:
            return
        threading.Thread(target=self.repair_segment, args=(table, seg),
                         daemon=True, name=f"repair-{seg}").start()

    def repair_segment(self, table: str, seg: str) -> bool:
        """Self-repair a quarantined segment: fetch a FRESH copy from the
        deep store, verify it, and rejoin the external view. Bounded
        attempts with exponential backoff; exhaustion flags the replica
        unrepairable, so the controller's integrity checker surfaces it
        instead of nudging forever. The fresh copy is a new segment object
        (new planes on the card: nothing keyed by the old one survives)."""
        for attempt in range(REPAIR_RETRIES):
            if attempt:
                time.sleep(min(REPAIR_BACKOFF_MS / 1000.0
                               * (2 ** (attempt - 1)), 2.0))
            meta = self.store.get(f"/SEGMENTS/{table}/{seg}")
            ideal = self.store.get(f"/IDEALSTATES/{table}") or {}
            assigned = (ideal.get(seg) or {}).get(self.instance_id) == ONLINE
            if meta is None or not assigned:
                # dropped or moved away while quarantined: nothing to heal
                with self._lock:
                    self.quarantined.get(table, {}).pop(seg, None)
                return False
            indexing = self._indexing(table)
            with self._lock:
                ent = self.quarantined.get(table, {}).get(seg)
                if ent is not None:
                    ent["repairAttempts"] += 1
            try:
                segment = self._load_segment_verified(
                    table, seg, meta, indexing, fresh=True)
            except Exception as e:
                log.warning("%s: repair attempt %d/%d for %s/%s failed: %s",
                            self.instance_id, attempt + 1, REPAIR_RETRIES,
                            table, seg, e)
                continue
            # whatever the card still holds under the name (a stack or a
            # partial of the damaged copy) must not meet the fresh bytes
            GLOBAL_PARTIAL_CACHE.invalidate_segment(seg)
            self.executor.executor.cache.drop_named(seg)
            with self._lock:
                self.segments.setdefault(table, {})[seg] = segment
                self._seg_meta[(table, seg)] = meta
                self._cold.get(table, {}).pop(seg, None)
                self.quarantined.get(table, {}).pop(seg, None)
                self._load_failures.pop((table, seg), None)
                self._register_table(table)
                want = {s for s, m in ideal.items()
                        if m.get(self.instance_id) == ONLINE}
                online = want & (set(self.segments.get(table, {}))
                                 | set(self._cold.get(table, ())))
            SERVER_METRICS.add_meter(ServerMeter.SEGMENT_REPAIRS)
            self._update_external_view(table, online)
            log.info("%s: repaired segment %s/%s from the deep store "
                     "(attempt %d)", self.instance_id, table, seg,
                     attempt + 1)
            return True
        with self._lock:
            ent = self.quarantined.get(table, {}).get(seg)
            if ent is not None:
                ent["unrepairable"] = True
        log.error("%s: segment %s/%s unrepairable after %d attempts",
                  self.instance_id, table, seg, REPAIR_RETRIES)
        return False

    def _on_repair_request(self, path: str, value) -> None:
        """Controller nudge via /REPAIRS/{table}/{seg} (the integrity
        checker noticed degraded replication): retry a quarantined
        replica's repair, synchronously and even with auto-repair off (an
        explicit nudge IS the operator asking), or re-converge a transient
        failure whose bounded retries were exhausted."""
        if not self._started or value is None:
            return
        parts = path.strip("/").split("/")
        if len(parts) != 3:
            return
        _, table, seg = parts
        with self._lock:
            ent = self.quarantined.get(table, {}).get(seg)
            if ent is not None:
                ent["unrepairable"] = False
            self._load_failures.pop((table, seg), None)
        if ent is not None:
            self.repair_segment(table, seg)
        else:
            self._converge(table, self.store.get(f"/IDEALSTATES/{table}"))

    # -- tiered storage: evict / warm / prefetch -----------------------------
    def _evict_segment(self, table: str, seg: str):
        """Tier evict callback: demote a resident segment to cold
        (metadata-only) under byte pressure. The deep-store bytes are
        unchanged, so the replica stays ONLINE and re-fetchable. Its
        cached partials (host and device: outputs, never an input of a
        launch) go now; its device view and family stacks go when the tier
        finalizes the copy, after its last reader (a scan pinned in
        `_handle_query`) has drained, through the returned object."""
        with self._lock:
            segment = self.segments.get(table, {}).pop(seg, None)
            meta = self._seg_meta.pop((table, seg), None)
            if meta is not None:
                self._cold.setdefault(table, {})[seg] = meta
            if segment is not None:
                self._register_table(table)
        GLOBAL_PARTIAL_CACHE.invalidate_segment(seg)
        self.executor.executor.cache.drop_partials(segment_name=seg)
        SERVER_METRICS.add_meter(ServerMeter.SEGMENT_EVICTIONS)
        log.info("%s: evicted segment %s/%s to cold (metadata-only)",
                 self.instance_id, table, seg)
        return _EvictedCopy(self, table, seg, segment)

    def _broker_table_costs(self) -> dict:
        """Fleet-wide decayed per-table query cost from the brokers'
        /BROKERSTATE beacons (cluster/workload.py): the tier's eviction
        heat. Read only when the tier must evict, never on the query
        path."""
        costs: dict[str, float] = {}
        try:
            ids = self.store.children("/BROKERSTATE")
        except StoreError:
            return costs
        for bid in ids:
            state = self.store.get(f"/BROKERSTATE/{bid}") or {}
            for t, c in (state.get("tableCostsMs") or {}).items():
                try:
                    costs[t] = max(costs.get(t, 0.0), float(c))
                except (TypeError, ValueError):
                    continue
        # beacons carry broker-facing table names; tier entries are keyed
        # by the type-suffixed internal name: project costs onto both
        for nwt in self._tables_named(list(costs)):
            raw = nwt.rsplit("_", 1)[0]
            if raw in costs:
                costs[nwt] = max(costs.get(nwt, 0.0), costs[raw])
        return costs

    def _tables_named(self, names) -> list:
        """Hosted (resident or cold) internal table names matching any of
        the given broker-facing names, exactly or modulo the
        ``_OFFLINE`` / ``_REALTIME`` type suffix."""
        wanted = set(names)
        with self._lock:
            hosted = set(self.segments) | set(self._cold)
        return sorted(t for t in hosted
                      if t in wanted or t.rsplit("_", 1)[0] in wanted)

    def _kick_warm(self, table: str, seg: str) -> threading.Event:
        """Start (or join) a background warm of one cold segment. Returns
        the completion event; concurrent callers coalesce on one fetch."""
        key = (table, seg)
        with self._lock:
            if seg in self.segments.get(table, {}):
                done = threading.Event()
                done.set()
                return done
            ev = self._warming.get(key)
            if ev is not None:
                return ev
            ev = self._warming[key] = threading.Event()
        threading.Thread(target=self._warm_leader, args=(table, seg, ev),
                         daemon=True, name=f"warm-{seg}").start()
        return ev

    def _warm_leader(self, table: str, seg: str, ev: threading.Event) -> None:
        """Fetch + verify + load one cold segment (the single in-flight
        warm for its (table, seg) key). An integrity failure quarantines
        and kicks repair, so a corrupt deep-store fetch heals with a fresh
        copy instead of being served or retried in place; a transient
        failure leaves the segment cold for the next query to retry."""
        t0 = time.perf_counter()
        try:
            with self._lock:
                meta = self._cold.get(table, {}).get(seg)
            if meta is None:
                return
            try:
                segment = self._load_segment_verified(
                    table, seg, meta, self._indexing(table), cold=True)
            except SegmentIntegrityError as e:
                with self._lock:
                    self._cold.get(table, {}).pop(seg, None)
                self._quarantine(table, seg, e)
                self._kick_repair(table, seg)
                return
            except Exception:
                with self._lock:
                    n = self._load_failures.get((table, seg), 0) + 1
                    self._load_failures[(table, seg)] = n
                log.warning("%s: cold load of %s/%s failed (attempt %d)",
                            self.instance_id, table, seg, n, exc_info=True)
                return
            with self._lock:
                self._cold.get(table, {}).pop(seg, None)
                self.segments.setdefault(table, {})[seg] = segment
                self._seg_meta[(table, seg)] = meta
                self._load_failures.pop((table, seg), None)
                self._register_table(table)
            SERVER_METRICS.add_meter(ServerMeter.SEGMENT_COLD_LOADS)
            SERVER_METRICS.update_timer(
                ServerTimer.COLD_LOAD_MS, (time.perf_counter() - t0) * 1000.0)
        finally:
            with self._lock:
                self._warming.pop((table, seg), None)
            ev.set()

    def _warm_cold_segments(self, table: str, cold_names: list,
                            deadline_ms) -> list:
        """Deadline-aware lazy warm of cold routed segments: kick all the
        warms, then wait for each inside the remaining budget less
        COLD_SYNC_FLOOR_MS. Returns the names still cold when the budget
        ran out: they keep warming in the background (the next query finds
        them resident) while THIS response degrades instead of blocking."""
        floor_s = COLD_SYNC_FLOOR_MS / 1000.0
        deadline = None
        if deadline_ms is not None:
            deadline = time.monotonic() + max(0.0, float(deadline_ms) / 1000.0)
        events = [(seg, self._kick_warm(table, seg)) for seg in cold_names]
        still = []
        for seg, ev in events:
            timeout = None
            if deadline is not None:
                timeout = max(0.0, deadline - time.monotonic() - floor_s)
            ev.wait(timeout)
            with self._lock:
                if seg not in self.segments.get(table, {}):
                    still.append(seg)
        return still

    def _warm_routed(self, table: str, names: list, deadline_ms) -> list:
        """Warm the cold segments among a query's routed `names` within
        `deadline_ms` (None: wait for the warms). The routed segments that
        are resident stay pinned while the warms fetch, so a query's own
        warm never evicts a segment the same query is about to scan: a
        tier smaller than one query's segments holds them all for that
        query, over its budget until the next fetch's eviction pass (the
        JAX server can evict them, then answers partial or fails). Returns
        the names still cold."""
        with self._lock:
            hosted = self.segments.get(table, {})
            cold = [n for n in names if n not in hosted
                    and n in self._cold.get(table, {})]
            if not cold:
                return []
            hold = self._tier.pin(table, [n for n in names if n in hosted])
        try:
            return self._warm_cold_segments(table, cold, deadline_ms)
        finally:
            self._tier.unpin(hold)

    def _on_prefetch(self, path: str, value) -> None:
        """/PREFETCH/{table} nudge from a StoragePrefetcher: mark the table
        hot (it goes last in eviction order for the hot TTL), warm its cold
        segments in the background while tier headroom remains, and replay
        the table's AOT family records (engine/aot_cache.py), so a hot
        table is resident and its kernels are loaded before traffic
        lands."""
        if not self._started or value is None:
            return
        parts = path.strip("/").split("/")
        if len(parts) != 2:
            return
        # the nudge names the broker-facing table; hosted state is keyed
        # by the type-suffixed internal name
        table = parts[1]
        self._tier.note_hot(table)
        for nwt in self._tables_named([table]):
            self._tier.note_hot(nwt)
            with self._lock:
                cold = sorted(self._cold.get(nwt, {}))
            if cold:
                threading.Thread(target=self._prefetch_warm,
                                 args=(nwt, cold), daemon=True,
                                 name=f"prefetch-{nwt}").start()
        if aot_cache.enabled():
            threading.Thread(target=aot_cache.prewarm_table, args=(table,),
                             kwargs={"device": self.device}, daemon=True,
                             name=f"aot-prewarm-{table}").start()

    def _prefetch_warm(self, table: str, names: list) -> None:
        for seg in names:
            if not self._started or not self._tier.headroom():
                return  # prefetch warms fill headroom; they never evict
            self._kick_warm(table, seg).wait(PREFETCH_WARM_WAIT_S)
            with self._lock:
                ok = seg in self.segments.get(table, {})
            if ok:
                SERVER_METRICS.add_meter(ServerMeter.PREFETCH_HITS)

    def debug_storage(self) -> dict:
        """Storage-tier inventory (the JAX server's GET /debug/storage):
        the local tier's budget and usage, resident vs cold segments per
        table, and the in-flight warms."""
        with self._lock:
            tables = sorted(set(self.segments) | set(self._cold))
            per_table = {
                t: {"resident": sorted(self.segments.get(t, {})),
                    "cold": sorted(self._cold.get(t, {}))}
                for t in tables}
            warming = sorted(f"{t}/{s}" for t, s in self._warming)
        return {
            "localTier": self._tier.stats(),
            "residentSegments": sum(len(v["resident"])
                                    for v in per_table.values()),
            "coldSegments": sum(len(v["cold"]) for v in per_table.values()),
            "warming": warming,
            "tables": per_table,
        }

    def health_status(self) -> dict:
        """Per-instance health beacon (the `status` RPC, GET /debug/status):
        instance-local state, the device listing, the card bytes this
        server's device cache holds against its budget (`hbm`) and the
        process metric singletons."""
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
            "hbm": self.executor.executor.cache.hbm_stats(),
            "segmentCache": {
                "hits": SERVER_METRICS.meter_count(
                    ServerMeter.SEGMENT_CACHE_HITS),
                "misses": SERVER_METRICS.meter_count(
                    ServerMeter.SEGMENT_CACHE_MISSES),
            },
            "hbmOomEvents": SERVER_METRICS.meter_count(
                ServerMeter.HBM_OOM_EVENTS),
            "quarantined": quarantined,
            "numSegments": num_segments,
            "numDocs": num_docs,
        }

    def debug_segments(self) -> dict:
        """Hosted-vs-quarantined segment inventory (the JAX server's GET
        /debug/segments)."""
        with self._lock:
            out = {}
            for table in sorted(set(self.segments) | set(self.quarantined)):
                q = self.quarantined.get(table, {})
                out[table] = {
                    "served": sorted(self.segments.get(table, {})),
                    "quarantined": {s: dict(e) for s, e in sorted(q.items())},
                }
            return out

    def _register_table(self, table: str) -> None:
        raw = raw_table_name(table)
        schema_json = self.store.get(f"/SCHEMAS/{raw}")
        if schema_json is None or table not in self.segments:
            return
        schema = Schema.from_json(schema_json)
        segments = list(self.segments[table].values())
        cfg = self.store.get(f"/CONFIGS/TABLE/{table}") or {}
        if cfg.get("warmOnLoad") and self.backend != "host":
            # pre-upload column planes off the convergence thread
            # (reference: segment preload on load; the first query skips
            # the host-to-device copies); the host engine reads no plane
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
        if kind == "query_stream":
            return self._handle_query_stream(request)
        if kind == "explain":
            return self._handle_explain(request)
        if kind == "scan_arrow":
            return self._handle_scan_arrow(request)
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
        t_enter = time.monotonic()
        # cold (metadata-only) routed segments warm BEFORE admission,
        # bounded by the remaining broker budget; the ones still cold ride
        # the missing-segments machinery (the broker retries a replica or
        # this server, or degrades) instead of blocking the response
        still_cold = self._warm_routed(table, names, deadline_ms)
        timeout_s = 60.0
        if deadline_ms is not None:
            left_ms = max(50.0, float(deadline_ms)
                          - (time.monotonic() - t_enter) * 1000.0)
            timeout_s = max(0.05, min(60.0, left_ms / 1000.0))
            cur = query.query_options.get("timeoutMs")
            query.query_options["timeoutMs"] = (
                left_ms if cur is None else min(float(cur), left_ms))
        with self._lock:
            hosted = self.segments.get(table, {})
            segs = [hosted[n] for n in names if n in hosted]
            missing = [n for n in names if n not in hosted]
            # refcount-pin the tier copies for the scan: an eviction racing
            # this query defers its directory removal AND the release of
            # the segment's device planes and stacks until the pin drops,
            # so no launch of this scan loses its inputs
            pins = self._tier.pin(table, [n for n in names if n in hosted])

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
            # the scan's one device->host fetch waits for its launches, so
            # they have all completed when the pins drop below
            combined, stats = self.scheduler.submit(
                run, group=table, timeout_s=timeout_s, query_id=query_id)
        except BaseException:
            if self.device.type == "cuda":
                # a scan killed between launch and fetch (a cancelled hedge
                # loser, a deadline) leaves no launch in flight behind its
                # pins: an eviction waiting on them then frees its planes
                torch.cuda.synchronize(self.device)
            raise
        finally:
            if trace is not None:
                TRACING.end_trace()
            self._tier.unpin(pins)
        exec_ms = (time.perf_counter() - t_exec) * 1000.0
        stats["missing_segments"] = missing
        if still_cold:
            # names the broker both counts (coldSegmentsWarming) and may
            # retry against this same instance once the warm completes
            stats["cold_segments"] = [n for n in still_cold if n in missing]
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

    def _handle_scan_arrow(self, request):
        """Direct Arrow IPC segment read for external engines — straight
        from segment storage, no SQL/DataTable in the data path
        (reference: the Spark connector's gRPC server reads;
        connectors/arrow_reader.py holds the client half)."""
        from ..connectors.arrow_reader import segment_ipc_bytes

        table = request["table"]
        name = request["segment"]
        with self._lock:
            seg = self.segments.get(table, {}).get(name)
        if seg is None:
            raise ValueError(f"segment {name} not hosted for {table}")
        with self._tier.reading(table, [name]):
            ipc = segment_ipc_bytes(seg, request.get("columns"))
        return {"ipc": ipc, "numRows": seg.num_docs}

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
                          backend=self.executor.backend,
                          use_star_tree=self.executor.use_star_tree)
        return {"columns": rt.schema.column_names,
                "types": rt.schema.column_types, "rows": rt.rows}

    def _handle_query_stream(self, request):
        """Server-streaming query: one DataTable chunk per segment as each
        finishes (reference: GrpcQueryServer.submit streaming per-segment
        blocks for streamable operators, GrpcQueryServer.java:65). The
        tier copies stay pinned while the stream runs; a consumer that
        stops early (LIMIT reached) closes the generator, which drops the
        pins."""
        table = request["table"]
        names = request["segments"]
        query = request["query"]
        with self._lock:
            hosted = self.segments.get(table, {})
            segs = [(n, hosted[n]) for n in names if n in hosted]
            missing = [n for n in names if n not in hosted]

        def stream():
            if missing:
                raise RuntimeError(f"missing routed segments: {missing}")
            with self._tier.reading(table, [n for n, _ in segs]):
                for name, seg in segs:
                    combined, stats = self.executor.execute_segments(
                        query, [seg])
                    stats["segment"] = name
                    yield encode(combined, stats)

        return stream()
