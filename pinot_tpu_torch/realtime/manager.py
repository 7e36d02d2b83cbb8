"""Realtime consumption: per-partition consumer threads + commit protocol
(the port of pinot_tpu/realtime/manager.py).

Reference call stack (SURVEY.md §3.3): RealtimeTableDataManager.
doAddConsumingSegment -> RealtimeSegmentDataManager (pinot-core/.../data/
manager/realtime/RealtimeSegmentDataManager.java:123) whose PartitionConsumer
thread (run:717-880) loops CONSUMING -> (end criteria) -> HOLDING -> COMMITTING
-> COMMITTED, then the table manager replaces the mutable segment with the
committed immutable one and opens the next consuming segment from the end
offset.

Single-process simplifications vs the reference, kept behind the same
interfaces so the cluster layer can swap them out:
- the segment-completion FSM (controller SegmentCompletionManager) collapses
  to an in-process ``commit()`` - one replica, always the winner;
- ZK segment metadata collapses to a JSON checkpoint file per table holding
  committed end offsets (crash -> resume from last committed offset, the
  reference's exactly-once guarantee via segments-as-checkpoints).

A committed (or discarded) consuming segment's device state is retired by
name once its immutable replacement is queryable: its append-only planes
(realtime/device_plane.py REALTIME_PLANES), the views, stacks and device
partials of every live executor's DeviceSegmentCache
(segment/device_cache.py `live_caches`) and its host partials
(cache/partial.py). A failure there never fails the commit; it is logged
and counted (`RealtimeTableDataManager.retirement_stats`).
"""

from __future__ import annotations

import json
import logging
import shutil
import threading
import time
from pathlib import Path
from typing import Callable, Optional

from ..cache.partial import GLOBAL_PARTIAL_CACHE
from ..ingestion.transform import build_transform_pipeline
from ..segment.device_cache import live_caches
from ..segment.format import partition_push_metadata
from ..segment.loader import ImmutableSegment, load_segment
from ..segment.mutable import MutableSegment
from ..spi import faults
from ..spi.metrics import SERVER_METRICS, ServerMeter
from ..spi.stream import (
    LongMsgOffset,
    MessageBatch,
    StreamConfig,
    get_decoder,
    get_stream_consumer_factory,
)
from ..upsert import TableDedupManager, TableUpsertMetadataManager
from .completion import (
    CATCHUP,
    COMMIT,
    COMMIT_SUCCESS,
    CONTINUE,
    DISCARD,
    NoControllerLeaderError,
)
from .converter import RealtimeSegmentConverter
from .device_plane import REALTIME_PLANES

log = logging.getLogger(__name__)

# consumption states (reference RealtimeSegmentDataManager.State)
CONSUMING = "CONSUMING"
HOLDING = "HOLDING"
COMMITTING = "COMMITTING"
COMMITTED = "COMMITTED"
ERROR = "ERROR"


def llc_segment_name(table: str, partition: int, seq: int,
                     ts_ms: Optional[int] = None) -> str:
    """LLC naming: {table}__{partition}__{seq}__{timestamp} (reference
    LLCSegmentName)."""
    ts = ts_ms if ts_ms is not None else int(time.time() * 1000)
    return f"{table}__{partition}__{seq}__{ts}"


class RealtimeSegmentDataManager:
    """One consuming segment on one partition: consumer thread with the
    consume -> end-criteria -> commit state machine."""

    def __init__(self, schema, table_config, stream_config: StreamConfig,
                 partition: int, seq: int, start_offset: LongMsgOffset,
                 on_commit: Callable[["RealtimeSegmentDataManager"], None],
                 poll_idle_s: float = 0.02, pk_manager=None,
                 completion=None, instance_id: str = "server_0",
                 on_build: Optional[Callable] = None,
                 on_commit_success: Optional[Callable] = None,
                 on_discard: Optional[Callable] = None,
                 on_elected: Optional[Callable] = None,
                 test_hooks: Optional[dict] = None):
        self.schema = schema
        self.table_config = table_config
        self.stream_config = stream_config
        self.partition = partition
        self.seq = seq
        self.start_offset = start_offset
        self.current_offset = start_offset
        self.on_commit = on_commit
        self.poll_idle_s = poll_idle_s
        # multi-replica completion protocol (realtime/completion.py); None ->
        # in-process commit, the single-replica fast path
        self.completion = completion
        self.instance_id = instance_id
        self.on_build = on_build
        self.on_commit_success = on_commit_success
        self.on_discard = on_discard
        self.on_elected = on_elected  # pauseless successor start
        self.test_hooks = test_hooks or {}
        # upsert/dedup metadata manager (upsert/manager.py): process_row
        # pre-index (partial merge / duplicate drop), add_record post-index
        self.pk_manager = pk_manager

        # under the replica completion protocol every replica must mint the
        # IDENTICAL segment name for (table, partition, seq) - the reference
        # has the controller assign it; here the name's timestamp field is
        # derived from the start offset so it is deterministic across hosts
        ts_ms = start_offset.offset if completion is not None else None
        self.segment = MutableSegment(
            schema, llc_segment_name(table_config.table_name, partition, seq,
                                     ts_ms=ts_ms))
        factory = get_stream_consumer_factory(stream_config)
        self.consumer = factory.create_partition_consumer(partition)
        self.decoder = get_decoder(stream_config)
        self.pipeline = build_transform_pipeline(schema, table_config)

        self.state = CONSUMING
        self.consume_start_ms = int(time.time() * 1000)
        self.last_consumed_ms = self.consume_start_ms  # IngestionDelayTracker
        self.rows_indexed = 0
        self.rows_filtered = 0
        self.rows_errored = 0
        self._stop = threading.Event()
        self._force_commit = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name=f"consumer-{self.segment.segment_name}", daemon=True)

    # -- lifecycle ---------------------------------------------------------
    def start(self):
        self._thread.start()

    def stop(self, timeout: float = 10.0):
        self._stop.set()
        self._thread.join(timeout)
        self.consumer.close()

    def force_commit(self):
        """Seal now regardless of thresholds (reference forceCommit /
        pauseless commit trigger; minion RealtimeToOfflineSegmentsTask uses
        this to roll segments)."""
        self._force_commit.set()

    def join_committed(self, timeout: float = 30.0) -> bool:
        t0 = time.time()
        while time.time() - t0 < timeout:
            if self.state in (COMMITTED, ERROR):
                return self.state == COMMITTED
            time.sleep(0.01)
        return False

    # -- the consume loop (reference PartitionConsumer.run:717-880) --------
    def _run(self):
        try:
            fetch_errors = 0
            while not self._stop.is_set():
                try:
                    batch = self._fetch()
                except Exception:
                    # transient stream hiccup (broker rebalance, network
                    # blip) must not kill the consumer: back off and retry;
                    # only persistent failure drops to ERROR (reference:
                    # the consumer's transient-exception handling in
                    # RealtimeSegmentDataManager.consumeLoop)
                    fetch_errors += 1
                    if fetch_errors > 5:
                        raise
                    log.warning("consumer %s: fetch failed (%d/5), retrying",
                                self.segment.segment_name, fetch_errors)
                    time.sleep(self.poll_idle_s)
                    continue
                fetch_errors = 0
                if batch.message_count:
                    self._index_batch(batch)
                    self.current_offset = batch.offset_of_next_batch
                    self.last_consumed_ms = int(time.time() * 1000)
                else:
                    time.sleep(self.poll_idle_s)
                if self._end_criteria_reached():
                    self._commit()
                    return
            # stopped while consuming: leave segment mutable (HOLDING);
            # offsets below the last commit re-consume on restart
            self.state = HOLDING
        except Exception:  # noqa: BLE001 - consumer thread must not die silently
            log.exception("consumer %s failed", self.segment.segment_name)
            self.state = ERROR

    def _fetch(self):
        """One consumer fetch - the stream.fetch injection point."""
        if faults.ACTIVE:
            faults.FAULTS.fire("stream.fetch",
                               segment=self.segment.segment_name,
                               offset=self.current_offset.offset)
        return self.consumer.fetch_messages(
            self.current_offset, self.stream_config.fetch_timeout_ms)

    def _index_batch(self, batch):
        for msg in batch.messages:
            row = self.decoder.decode(msg)
            if row is None:
                self.rows_errored += 1
                continue
            row = self.pipeline.transform(dict(row))
            if row is None:
                self.rows_filtered += 1
                continue
            if self.pk_manager is not None:
                row = self.pk_manager.process_row(self.segment, row)
                if row is None:  # dedup drop
                    self.rows_filtered += 1
                    continue
            doc_id = self.segment.index(row)
            if self.pk_manager is not None:
                self.pk_manager.add_record(self.segment, doc_id, row)
            self.rows_indexed += 1

    @property
    def num_docs(self) -> int:
        return self.segment.num_docs

    def _end_criteria_reached(self) -> bool:
        if self._force_commit.is_set() and self.segment.num_docs > 0:
            return True
        if self.segment.num_docs >= self.stream_config.flush_threshold_rows:
            return True
        age_ms = int(time.time() * 1000) - self.consume_start_ms
        return (age_ms >= self.stream_config.flush_threshold_time_ms
                and self.segment.num_docs > 0)

    def _commit(self):
        self.state = COMMITTING
        try:
            if self.completion is None:
                self.on_commit(self)
                self.state = COMMITTED
                return
            self._commit_via_protocol()
        except Exception:  # noqa: BLE001
            log.exception("commit of %s failed", self.segment.segment_name)
            self.state = ERROR

    def _completion_call(self, fn):
        """Run one completion-protocol call, retrying with capped backoff
        through controller outages: a vacant leader seat
        (NoControllerLeaderError) or a glitching store write keeps the
        consumer HOLDing - never ERROR - until leadership is claimable
        again (reference: ServerSegmentCompletionProtocolHandler retries
        NOT_LEADER responses). Returns None only when stopped mid-wait."""
        # the cluster package imports the engine, which imports this
        # package: the store is imported on use
        from ..cluster.store import StoreError

        delay = 0.02
        while not self._stop.is_set():
            try:
                return fn()
            except NoControllerLeaderError:
                SERVER_METRICS.add_meter(ServerMeter.COMPLETION_HOLDS_NO_LEADER)
            except (StoreError, faults.InjectedFault):
                log.warning("completion call failed transiently; retrying",
                            exc_info=True)
            self._stop.wait(delay)
            delay = min(delay * 2, 2.0)
        return None

    def _commit_via_protocol(self):
        """Replica-aware commit: segmentConsumed -> HOLD/CATCHUP until the
        controller elects a committer; the winner builds + commits, losers
        DISCARD and download (reference PartitionConsumer commit loop,
        RealtimeSegmentDataManager.java:880-960)."""
        table = self.table_config.table_name
        name = self.segment.segment_name
        while not self._stop.is_set():
            resp = self._completion_call(lambda: self.completion.segment_consumed(
                table, name, self.instance_id, self.current_offset.offset))
            if resp is None:
                break
            if resp.status == CATCHUP:
                self._catchup(resp.offset)
                continue
            if resp.status == COMMIT:
                start = self._completion_call(
                    lambda: self.completion.segment_commit_start(
                        table, name, self.instance_id,
                        self.current_offset.offset))
                if start is None:
                    break
                if start.status != CONTINUE:
                    continue
                if self.on_elected is not None:
                    # pauseless: the successor consumer starts at the
                    # elected end offset BEFORE the build/upload completes
                    # (reference: PauselessSegmentCompletionFSM - ingestion
                    # never pauses for the commit)
                    self.on_elected(self, self.current_offset.offset)
                location = self.on_build(self)
                die = self.test_hooks.get("die_before_commit_end")
                if die is not None and die(self):
                    # simulated process death between build and commit -
                    # the lease expires and another replica is re-elected
                    return
                # DONE records carry partition stamps ({} when the table
                # declares no partitioning); the MSE dispatcher reads them
                # (falling back from the name-with-type namespace to this
                # completion-protocol one) to place colocated workers next
                # to realtime segments
                end = self._completion_call(
                    lambda: self.completion.segment_commit_end(
                        table, name, self.instance_id,
                        self.current_offset.offset, location,
                        metadata=partition_push_metadata(location)))
                if end is None:
                    break
                if end.status == COMMIT_SUCCESS:
                    self.on_commit_success(self, location)
                    self.state = COMMITTED
                    return
                # lost a late race: re-poll (likely DISCARD next); never
                # hot-spin on repeated FAILED responses
                time.sleep(self.poll_idle_s)
                continue
            if resp.status == DISCARD:
                self.on_discard(self, resp.location, resp.offset)
                # downloaded the winner's build; done with this segment
                self.state = COMMITTED
                return
            # HOLD
            time.sleep(self.poll_idle_s)
        self.state = HOLDING

    def _catchup(self, target_offset: int):
        """Consume up to the elected committer's end offset so every replica
        commits the identical row set (reference: CatchingUp state)."""
        while (not self._stop.is_set()
               and self.current_offset.offset < target_offset):
            batch = self._fetch()
            if not batch.message_count:
                time.sleep(self.poll_idle_s)
                continue
            # never index past the elected end offset. Record offsets may be
            # sparse (Kafka log compaction / txn markers), so truncate by
            # OFFSET when records carry one, by count only as a fallback
            if all(m.offset is not None for m in batch.messages):
                msgs = [m for m in batch.messages
                        if m.offset.offset < target_offset]
                if (len(msgs) < batch.message_count
                        or batch.offset_of_next_batch.offset > target_offset):
                    batch = MessageBatch(msgs, LongMsgOffset(target_offset))
            else:
                take = target_offset - self.current_offset.offset
                if batch.message_count > take:
                    batch = MessageBatch(list(batch.messages)[:take],
                                         LongMsgOffset(target_offset))
            self._index_batch(batch)
            self.current_offset = batch.offset_of_next_batch
            self.last_consumed_ms = int(time.time() * 1000)


class RealtimeTableDataManager:
    """Per-table realtime lifecycle: one consuming segment per partition,
    sealed segments on disk, committed-offset checkpointing.

    ``segments`` is a live list (committed immutables + consuming mutables) -
    the query executor snapshots it per query."""

    def __init__(self, schema, table_config, data_dir: str | Path,
                 segment_hook: Optional[Callable] = None,
                 completion=None, instance_id: str = "server_0",
                 pauseless: bool = False,
                 test_hooks: Optional[dict] = None):
        self.schema = schema
        self.table_config = table_config
        self.stream_config = StreamConfig.from_table_config(
            table_config.ingestion.stream_configs)
        self.data_dir = Path(data_dir)
        self.data_dir.mkdir(parents=True, exist_ok=True)
        self.pk_manager = None
        if table_config.upsert.mode.upper() != "NONE":
            self.pk_manager = TableUpsertMetadataManager(schema, table_config)
        elif table_config.dedup.enabled:
            self.pk_manager = TableDedupManager(schema, table_config)
        # upsert doc ids must survive conversion: never re-sort
        self.converter = RealtimeSegmentConverter(
            schema, table_config,
            preserve_doc_order=self.pk_manager is not None)
        self.segment_hook = segment_hook  # cluster layer: upsert/dedup attach
        # replica completion protocol (realtime/completion.py). Upsert/dedup
        # tables keep the single-replica fast path: their pk metadata is
        # partition-pinned and cannot be rebuilt from a downloaded build.
        self.completion = completion if self.pk_manager is None else None
        self.instance_id = instance_id
        # pauseless (reference PauselessSegmentCompletionFSM): the successor
        # consumer starts at election time, while the elected committer is
        # still building - requires the completion protocol
        self.pauseless = bool(pauseless and self.completion is not None)
        # segments sealed-but-not-yet-committed, still serving queries:
        # segment name -> (mutable segment, its manager - still mid-commit)
        self._committing: dict[str, tuple] = {}
        self.test_hooks = test_hooks or {}
        self.segments: list = []  # live view: immutables + mutables
        self._committed: list[ImmutableSegment] = []
        self._consuming: dict[int, RealtimeSegmentDataManager] = {}
        self._seq: dict[int, int] = {}
        self._lock = threading.RLock()
        self._shutdown = False
        # sealed consuming segments whose device state was retired, the
        # device bytes that freed, and the retirements that raised
        self._retired = {"segments": 0, "bytesFreed": 0, "errors": 0}
        self._checkpoint_file = self.data_dir / "_checkpoints.json"
        cp = self._load_checkpoints()
        self._offsets: dict[str, str] = cp.get("partitions", {})
        self._segment_names: list[str] = cp.get("segments", [])
        # freshness gauges (reference: IngestionDelayTracker publishing
        # realtimeIngestionDelayMs / realtimeIngestionOffsetLag per table)
        tname = self.table_config.table_name
        def _worst_delay():
            return max(self.ingestion_delay_ms().values(), default=0)

        def _worst_lag():
            # -1 (provider error on ANY partition) must surface, not be
            # masked by a healthy partition's larger non-negative lag
            lags = self.offset_lag().values()
            return -1 if any(v < 0 for v in lags) else max(lags, default=0)

        self._gauges = {f"realtimeIngestionDelayMs.{tname}": _worst_delay,
                        f"realtimeIngestionOffsetLag.{tname}": _worst_lag}
        for gname, fn in self._gauges.items():
            SERVER_METRICS.set_gauge(gname, fn)
        self._meta_provider = None  # cached for offset_lag polls

    # -- checkpoints (ZK segment-metadata equivalent) ----------------------
    # The checkpoint file is the COMMIT POINT: it atomically records both the
    # committed segment names and the advanced offsets, so a crash anywhere
    # around conversion either (a) leaves the file untouched - the partial
    # segment dir is ignored+removed on restart and its rows re-consume, or
    # (b) records both - the segment loads and consumption resumes past it.
    # Rows land in exactly one committed segment either way.
    def _load_checkpoints(self) -> dict:
        if self._checkpoint_file.exists():
            try:
                return json.loads(self._checkpoint_file.read_text())
            except ValueError:
                # torn write can only happen with the legacy non-atomic
                # writer; treat as empty (segments re-consume)
                return {}
        return {}

    def _save_checkpoints(self):
        tmp = self._checkpoint_file.with_suffix(".tmp")
        tmp.write_text(json.dumps(
            {"partitions": self._offsets, "segments": self._segment_names}))
        tmp.replace(self._checkpoint_file)  # atomic on POSIX

    # -- lifecycle ---------------------------------------------------------
    def start(self):
        """Load committed segments from disk, resume consumption from the
        last committed offsets (crash recovery - reference: servers replay
        Helix transitions then resume from segment.realtime.startOffset)."""
        with self._lock:
            known = set(self._segment_names)
            found: dict[str, object] = {}
            for d in sorted(self.data_dir.iterdir()):
                if not d.is_dir():
                    continue
                if d.name in known:
                    found[d.name] = d
                else:
                    # crash leftover: conversion finished (or half-finished)
                    # but the checkpoint never recorded it - rows re-consume
                    shutil.rmtree(d, ignore_errors=True)
            # load in COMMIT order (checkpoint list) so upsert bootstrap
            # resolves pk conflicts the same way the live path did
            for name in self._segment_names:
                if name in found:
                    seg = load_segment(found[name])
                    if self.pk_manager is not None:
                        self.pk_manager.add_segment(seg)
                    self._committed.append(seg)
            factory = get_stream_consumer_factory(self.stream_config)
            meta = factory.create_metadata_provider()
            n = meta.partition_count()
            meta.close()
            for p in range(n):
                self._start_partition(p)
            self._refresh_view()

    def _start_partition(self, partition: int):
        seq = self._seq.get(partition, 0)
        start = LongMsgOffset.parse(self._offsets.get(str(partition), "0"))
        if self._offsets.get(str(partition)) is None \
                and self.stream_config.offset_criteria == "largest":
            factory = get_stream_consumer_factory(self.stream_config)
            meta = factory.create_metadata_provider()
            start = meta.fetch_latest_offset(partition)
            meta.close()
        mgr = self._make_manager(partition, seq, start)
        self._consuming[partition] = mgr
        self._seq[partition] = seq + 1
        mgr.start()

    def _make_manager(self, partition: int, seq: int,
                      start: LongMsgOffset) -> RealtimeSegmentDataManager:
        return RealtimeSegmentDataManager(
            self.schema, self.table_config, self.stream_config, partition, seq,
            start, self._handle_commit, pk_manager=self.pk_manager,
            completion=self.completion, instance_id=self.instance_id,
            on_build=self._handle_build,
            on_commit_success=self._handle_commit_success,
            on_discard=self._handle_discard,
            on_elected=self._handle_elected if self.pauseless else None,
            test_hooks=self.test_hooks)

    def _handle_elected(self, mgr: RealtimeSegmentDataManager,
                        end_offset: int) -> None:
        """Pauseless: the sealed segment moves to a committing-holding list
        (still queryable) and the successor consumer starts NOW from the
        elected end offset - ingestion never waits for build/upload."""
        with self._lock:
            if self._consuming.get(mgr.partition) is not mgr:
                return  # successor already started (re-elected committer)
            self._committing[mgr.segment.segment_name] = (mgr.segment, mgr)
            self._consuming.pop(mgr.partition, None)
            if not self._shutdown:
                self._start_partition_from(mgr.partition,
                                           LongMsgOffset(end_offset))
            self._refresh_view()

    def stop(self):
        # order matters: the shutdown flag first, so a commit racing with us
        # cannot spawn a successor consumer after we snapshot; then drain
        # until no live managers remain (a successor may have started just
        # before the flag was set)
        with self._lock:
            self._shutdown = True
        while True:
            with self._lock:
                managers = [m for m in self._consuming.values()
                            if m._thread.is_alive() or not m._stop.is_set()]
                # pauseless: elected committers left _consuming but their
                # threads are still building/committing - drain them too, or
                # they'd keep writing checkpoints after "shutdown"
                managers += [m for _seg, m in self._committing.values()
                             if m._thread.is_alive() or not m._stop.is_set()]
            if not managers:
                break
            for m in managers:
                m.stop()
        # release the freshness gauges: they close over self, and the global
        # registry would otherwise pin this manager (and poll a dead table's
        # stream metadata) forever. Identity-guarded: if a replacement
        # manager for the same table already re-registered, leave its
        # gauges alone.
        for gname, fn in self._gauges.items():
            SERVER_METRICS.remove_gauge(gname, fn)
        with self._lock:
            provider, self._meta_provider = self._meta_provider, None
        if provider is not None:
            try:
                provider.close()
            except Exception:
                pass

    # -- commit (in-process completion FSM) --------------------------------
    def _handle_commit(self, mgr: RealtimeSegmentDataManager):
        out_dir = self.data_dir / mgr.segment.segment_name
        self.converter.convert(mgr.segment, out_dir)
        committed = load_segment(out_dir)
        if self.pk_manager is not None:
            # transfer validity plane + record locations mutable -> immutable
            self.pk_manager.replace_segment(mgr.segment, committed)
        if self.segment_hook is not None:
            self.segment_hook(committed)
        with self._lock:
            self._committed.append(committed)
            self._offsets[str(mgr.partition)] = str(mgr.current_offset)
            self._segment_names.append(mgr.segment.segment_name)
            self._save_checkpoints()  # <- the commit point (see above)
            self._consuming.pop(mgr.partition, None)
            if not self._shutdown:
                self._start_partition_from(mgr.partition, mgr.current_offset)
            self._refresh_view()
        # the mutable segment is NOT destroyed here: in-flight queries may
        # hold snapshot views of it; it drops out of the live list above and
        # the GC reclaims it once the last query releases its snapshot
        self._drop_device_state(mgr.segment.segment_name)

    def _drop_device_state(self, name: str) -> None:
        """Retire the mutable segment's device footprint once its immutable
        replacement is queryable: realtime planes, the views, stacks and
        device partials of every live executor's cache, and host partials
        all carry the segment name, so one name-drop clears them. These are
        performance caches, never correctness (a stale plane would never be
        consulted again since the name left the live list), so a failure
        is logged and counted and the commit goes on."""
        try:
            freed = REALTIME_PLANES.drop_named(name)
            for cache in live_caches():
                freed += cache.drop_named(name)
            GLOBAL_PARTIAL_CACHE.invalidate_segment(name)
        except Exception:  # noqa: BLE001 - a cache must never fail a commit
            log.exception("retiring the device state of %s failed", name)
            with self._lock:
                self._retired["errors"] += 1
            return
        with self._lock:
            self._retired["segments"] += 1
            self._retired["bytesFreed"] += freed

    def retirement_stats(self) -> dict:
        """Sealed segments whose device state was retired, the bytes that
        freed, and the retirements that raised."""
        with self._lock:
            return dict(self._retired)

    # -- replica completion protocol callbacks ------------------------------
    def _handle_build(self, mgr: RealtimeSegmentDataManager) -> str:
        """Build-only half of the commit (reference: buildSegmentInternal);
        registration waits for segmentCommitEnd success."""
        out_dir = self.data_dir / mgr.segment.segment_name
        self.converter.convert(mgr.segment, out_dir)
        return str(out_dir)

    def _handle_commit_success(self, mgr: RealtimeSegmentDataManager,
                               location: str) -> None:
        committed = load_segment(location)
        if self.segment_hook is not None:
            self.segment_hook(committed)
        with self._lock:
            self._committed.append(committed)
            # pauseless: the successor may have committed a LATER offset
            # already - never move the checkpoint backwards (restart would
            # re-ingest the successor's rows)
            cur = int(self._offsets.get(str(mgr.partition), "0") or 0)
            self._offsets[str(mgr.partition)] = str(
                max(cur, mgr.current_offset.offset))
            self._segment_names.append(mgr.segment.segment_name)
            self._save_checkpoints()
            was_pauseless = self._committing.pop(
                mgr.segment.segment_name, None) is not None
            if not was_pauseless:
                self._consuming.pop(mgr.partition, None)
                if not self._shutdown:
                    self._start_partition_from(mgr.partition,
                                               mgr.current_offset)
            # pauseless: the successor is already consuming
            self._refresh_view()
        self._drop_device_state(mgr.segment.segment_name)

    def _handle_discard(self, mgr: RealtimeSegmentDataManager,
                        location: str, end_offset: int) -> None:
        """This replica lost the election: drop the local build and download
        the committer's (reference: non-winner replicas download from deep
        store on SegmentCompletionProtocol DISCARD/KEEP)."""
        name = mgr.segment.segment_name
        local = self.data_dir / name
        if Path(location).resolve() != local.resolve():
            if local.exists():
                shutil.rmtree(local, ignore_errors=True)
            shutil.copytree(location, local)
        committed = load_segment(local)
        if self.segment_hook is not None:
            self.segment_hook(committed)
        with self._lock:
            self._committed.append(committed)
            cur = int(self._offsets.get(str(mgr.partition), "0") or 0)
            self._offsets[str(mgr.partition)] = str(max(cur, int(end_offset)))
            self._segment_names.append(name)
            self._save_checkpoints()
            was_pauseless = self._committing.pop(name, None) is not None
            if not was_pauseless:
                self._consuming.pop(mgr.partition, None)
                if not self._shutdown:
                    self._start_partition_from(mgr.partition,
                                               LongMsgOffset(end_offset))
            self._refresh_view()
        self._drop_device_state(name)

    def _start_partition_from(self, partition: int, offset: LongMsgOffset):
        seq = self._seq.get(partition, 0)
        nxt = self._make_manager(partition, seq, offset)
        self._consuming[partition] = nxt
        self._seq[partition] = seq + 1
        nxt.start()

    def _refresh_view(self):
        # committing-holding segments (pauseless) stay queryable until their
        # immutable replacement lands
        self.segments[:] = (list(self._committed)
                            + [seg for seg, _m in self._committing.values()]
                            + [m.segment for m in self._consuming.values()])

    # -- ops ---------------------------------------------------------------
    def force_commit(self, timeout: float = 30.0) -> list[str]:
        """Seal all non-empty consuming segments, wait for their commits, and
        return the committed segment names (ops endpoint + minion rollover).
        Empty partitions are skipped - there is nothing to seal."""
        with self._lock:
            managers = [m for m in self._consuming.values() if m.num_docs > 0]
        for m in managers:
            m.force_commit()
        out = []
        for m in managers:
            if m.join_committed(timeout):
                out.append(m.segment.segment_name)
        return out

    def ingestion_delay_ms(self) -> dict[int, int]:
        now = int(time.time() * 1000)
        with self._lock:
            return {p: now - m.last_consumed_ms for p, m in self._consuming.items()}

    def offset_lag(self) -> dict[int, int]:
        """Per-partition messages behind the stream head (reference:
        IngestionDelayTracker's offset lag companion metric). Uses the
        stream's metadata provider; a provider error reports -1 for that
        partition rather than failing the caller (it is a metric)."""
        with self._lock:
            current = {p: m.current_offset.offset
                       for p, m in self._consuming.items()}
        if not current:
            return {}
        out = {}
        # cache the metadata provider across polls (the gauge is scraped
        # continuously; a fresh client connection per scrape would churn);
        # drop it on any error so the next poll reconnects. The cache slot
        # is guarded by self._lock (creation races between concurrent
        # scrapes, and against stop(), would leak live client connections);
        # the fetches themselves run outside the lock - they are network I/O.
        with self._lock:
            if self._shutdown:
                return {p: -1 for p in current}
            provider = self._meta_provider
            if provider is None:
                try:
                    provider = get_stream_consumer_factory(
                        self.stream_config).create_metadata_provider()
                except Exception:
                    return {p: -1 for p in current}
                self._meta_provider = provider
        errored = False
        for p, off in current.items():
            try:
                out[p] = max(0, provider.fetch_latest_offset(p).offset - off)
            except Exception:
                out[p] = -1
                errored = True
        if errored:
            with self._lock:
                if self._meta_provider is provider:
                    self._meta_provider = None
            try:
                provider.close()
            except Exception:
                pass
        return out

    def total_docs(self) -> int:
        with self._lock:
            return sum(s.num_docs for s in self.segments)
