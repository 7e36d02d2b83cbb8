"""Cross-process MSE: plan dispatch + mailbox shuffle over the TCP transport.

The port of pinot_tpu/mse/distributed.py. Reference analogue:
QueryDispatcher.submit (pinot-query-runtime/.../service/dispatch/
QueryDispatcher.java:126) serializes plan fragments to workers over gRPC,
GrpcMailboxService carries shuffled blocks between worker processes
(pinot-common/src/main/proto/mailbox.proto), and the broker performs the
final receive + reduce.

Here the dispatcher lives on the broker (`DistributedMseDispatcher`), plan
fragments travel as the JSON contract in plan_serde.py, and mailbox blocks
ride the same framed-TCP RPC plane the scatter/gather query path uses
(cluster/transport.py). Stage workers are `ServerInstance`s, in this
process or another; each hosts an `MseWorkerService` holding its mailbox
store.

The data plane is PIPELINED, like the reference's streaming gRPC mailboxes
(GrpcMailboxServer.java:43 + .../runtime/operator/exchange/): all stages'
workers are dispatched CONCURRENTLY, producers ship their output in row
CHUNKS as they become available followed by a per-sender EOS marker, and a
receive blocks only until every declared sender has finished. A
final-phase aggregate consumes its mailbox incrementally (chunk →
partial-merge); buffered bytes are bounded by a credit
(`MAILBOX_BUFFER_BYTES`) that blocks producers when a draining consumer
falls behind (backpressure). A numeric block of at least
`DEVICE_PACK_MIN_BYTES` crosses servers as ONE PTDP blob packed on the
sending server's device (cluster/datatable.py `encode_packed_block`); a
pack that fails fails the query, there is no raw-block fallback.

Leaf stages run the single-stage engine on the worker's device over an
explicit per-worker segment list chosen by the broker's replica selector
(never "all hosted segments": with replication > 1 that would double-count
rows), and hybrid tables are split offline/realtime at the time boundary
exactly like the single-stage broker path. A routed segment registered
cold on the worker's server (tiered storage, cluster/server.py) is warmed
within the stage's deadline; one still cold at the deadline, or one the
worker does not host, fails the stage. Join stages run the pair join on
the worker's device (mse/operators.py); the fused join stage stays
in-process only, as in the JAX package.

At the broker, a statement passes the per-table QPS quota of every table a
leaf stage scans (`Broker.quota`) and, through `Broker._admitted_mse`, the
same admission gate as the single-stage path.

The cluster reads no environment variable: `CHUNK_ROWS`,
`MAILBOX_BUFFER_BYTES`, `MAILBOX_WAIT_S` and `DEVICE_PACK_MIN_BYTES` are
module constants with the JAX package's defaults.
"""

from __future__ import annotations

import copy
import itertools
import threading
import time
import uuid
from collections import Counter, OrderedDict, defaultdict
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional

import numpy as np

from ..cluster import datatable
from ..engine.aggregation import UnsupportedQueryError
from ..engine.results import BrokerResponse, DataSchema, ResultTable
from ..query.converter import filter_from_expression
from ..query.expressions import ExpressionContext
from ..query.filter import FilterContext
from ..spi import faults
from ..spi.metrics import SERVER_METRICS, ServerMeter
from ..spi.trace import TRACING
from .executor import _block_to_result, concat_columns, scan_segments
from .fragmenter import Stage, explain_stages, fragment, receive_nodes
from .logical import LogicalPlanner, prune_columns
from .mailbox import (Block, block_len, block_nbytes, concat_blocks,
                      hash_partition, table_partition)
from .operators import op_filter, pop_join_overflow
from .optimizer import push_filters
from .parser import parse_relational
from .plan_serde import expr_from_json, expr_to_json, stage_from_json, stage_to_json
from .runtime import StageRunner

EC = ExpressionContext


# rows per shipped chunk; small enough that a consumer overlaps a producer,
# large enough that framing overhead stays negligible
CHUNK_ROWS = 65536
# buffered-bytes credit per mailbox once a streaming consumer is draining it
MAILBOX_BUFFER_BYTES = 64 << 20
# ceiling on waiting for senders (a crashed producer must not hang a worker)
MAILBOX_WAIT_S = 300.0
# blocks at least this large cross servers as ONE device-packed byte blob
# (ops/kernels.pack_u8_wire flattens the columns on the device; the host
# side is a single memcpy to the socket instead of per-row encodes)
DEVICE_PACK_MIN_BYTES = 1 << 20
# re-sends of a mailbox delivery whose acknowledgement failed: safe, the
# receiving store drops a chunk it already holds by (sender, seq)
MAILBOX_SEND_RETRIES = 1
# query ids a store remembers after cleanup, so a delivery that lands
# late is dropped instead of re-creating the query's mailboxes (query ids
# carry a random part, so no later query of any broker reuses one)
_CLOSED_QUERIES = 4096
# workers of a hash-distributed intermediate stage
STAGE_PARALLELISM = 2


def _block_nbytes(block: Block) -> int:
    return sum(np.asarray(v).nbytes for v in block.values())


def _wire_packable(block: Block) -> bool:
    """Eligible for the device-packed wire format: numeric columnar block at
    least DEVICE_PACK_MIN_BYTES (below that, framing a second format is not
    worth skipping the row encodes). This test alone chooses between PTDP
    and the row path."""
    return (block is not None and _block_nbytes(block) >= DEVICE_PACK_MIN_BYTES
            and datatable.packable_block(block))


def _pack_for_wire(block: Block, device) -> Optional[bytes]:
    """An eligible block packed on ``device`` (the sending server's) for a
    cross-server hop, or None for a block that takes the row path. A pack
    that fails raises: the query fails rather than ship the raw block."""
    if not _wire_packable(block):
        return None
    return datatable.encode_packed_block(block, device=device)


class MailboxCancelled(Exception):
    pass


class SegmentNotHostedError(RuntimeError):
    """A leaf stage was routed a segment its worker does not host."""


class MailboxStore:
    """Per-process store of streamed chunks, keyed by
    (query_id, from_stage, to_stage, partition) — the mailbox id scheme of
    the reference (`{requestId}|{sender}|{receiver}|{worker}`).

    Producers append chunks and finally mark per-sender EOS; consumers
    either materialize (wait for all senders, concat) or stream (drain
    chunks as they arrive — registering as a streamer arms the buffer
    credit so `put` backpressures a runaway producer). Tracks cumulative
    and high-water buffered bytes per query for the pipeline stats."""

    def __init__(self):
        self._chunks: dict[tuple, list[Block]] = defaultdict(list)
        self._eos: dict[tuple, set] = defaultdict(set)
        self._buffered: dict[tuple, int] = defaultdict(int)
        self._streaming: set = set()
        self._cancelled: set = set()
        self._total_bytes: dict[str, int] = defaultdict(int)
        self._peak_bytes: dict[str, int] = defaultdict(int)
        self._duplicates: dict[str, int] = defaultdict(int)
        # (key, sender) → highest seq accepted: retried deliveries re-send
        # a chunk whose acknowledgement was lost; duplicates must be
        # dropped, not double-counted (reference: gRPC stream sequencing).
        # _inflight_seq guards the window where the ORIGINAL delivery is
        # still blocked in the backpressure wait — a retry arriving then
        # must neither enqueue a second copy nor mark the seq accepted
        # before the append actually happened.
        self._last_seq: dict[tuple, int] = {}
        self._inflight_seq: set = set()
        # query_id → absolute monotonic deadline: every wait clamps to the
        # query's REMAINING budget instead of the flat MAILBOX_WAIT_S
        # ceiling (deadline propagation across the shuffle plane)
        self._deadlines: dict[str, float] = {}
        # cleaned-up query ids (bounded): late deliveries are dropped
        self._closed: OrderedDict = OrderedDict()
        self._cond = threading.Condition()

    def set_deadline(self, query_id: str, deadline: float) -> None:
        """Register the query's absolute (monotonic) deadline."""
        with self._cond:
            if query_id not in self._closed:
                self._deadlines[query_id] = deadline
            self._cond.notify_all()

    def _deadline_for(self, query_id: str) -> float:
        return min(time.monotonic() + MAILBOX_WAIT_S,
                   self._deadlines.get(query_id, float("inf")))

    def _check(self, query_id: str) -> None:
        if query_id in self._cancelled or query_id in self._closed:
            raise MailboxCancelled(query_id)

    def put(self, query_id: str, from_stage: int, to_stage: int,
            partition: int, block: Block, sender: int = 0,
            seq: Optional[int] = None) -> None:
        key = (query_id, from_stage, to_stage, partition)
        nbytes = _block_nbytes(block)
        with self._cond:
            if query_id in self._closed:
                return  # the query is over: a late delivery
            skey = None
            if seq is not None:
                skey = (key, sender, seq)
                if seq <= self._last_seq.get((key, sender), -1) \
                        or skey in self._inflight_seq:
                    self._duplicates[query_id] += 1
                    return  # duplicate delivery (retried RPC)
                self._inflight_seq.add(skey)
            deadline = self._deadline_for(query_id)
            try:
                while (key in self._streaming
                       and self._buffered[key] + nbytes > MAILBOX_BUFFER_BYTES
                       and self._buffered[key] > 0):
                    self._check(query_id)
                    if not self._cond.wait(1.0) and time.monotonic() > deadline:
                        raise TimeoutError(f"mailbox {key} backpressure stall")
                self._check(query_id)
            finally:
                if skey is not None:
                    self._inflight_seq.discard(skey)
            if seq is not None:
                # accepted only now — a put that failed in the wait leaves
                # the seq unrecorded so a later retry can land it
                self._last_seq[(key, sender)] = seq
            self._chunks[key].append(block)
            self._buffered[key] += nbytes
            total = sum(v for k, v in self._buffered.items()
                        if k[0] == query_id)
            self._total_bytes[query_id] += nbytes
            self._peak_bytes[query_id] = max(
                self._peak_bytes[query_id], total)
            self._cond.notify_all()

    def deliver(self, request: dict) -> None:
        """Apply one mse_mailbox request (chunk and/or EOS) — the single
        decode point shared by worker and broker endpoints."""
        block = request.get("block")
        if block is None and request.get("packed") is not None:
            # device-packed exchange: one contiguous byte blob, split back
            # into columns on the host (CRC-checked: a corrupted frame
            # raises DataTableCorruptionError and is never materialized)
            block = datatable.decode_packed_block(request["packed"])
        if block is not None:
            self.put(request["query_id"], request["from_stage"],
                     request["to_stage"], request["partition"],
                     block, sender=request.get("sender", 0),
                     seq=request.get("seq"))
        if request.get("eos"):
            self.mark_eos(request["query_id"], request["from_stage"],
                          request["to_stage"], request["partition"],
                          request.get("sender", 0))

    def mark_eos(self, query_id: str, from_stage: int, to_stage: int,
                 partition: int, sender: int) -> None:
        with self._cond:
            if query_id in self._closed:
                return
            self._eos[(query_id, from_stage, to_stage, partition)].add(sender)
            self._cond.notify_all()

    def wait_all(self, query_id: str, from_stage: int, to_stage: int,
                 partition: int, expected_senders: int) -> list[Block]:
        """Materializing receive: all senders' chunks, after every EOS."""
        key = (query_id, from_stage, to_stage, partition)
        deadline = self._deadline_for(query_id)
        with self._cond:
            while len(self._eos.get(key, ())) < expected_senders:
                self._check(query_id)
                if not self._cond.wait(1.0) and time.monotonic() > deadline:
                    raise TimeoutError(
                        f"mailbox {key}: {len(self._eos.get(key, ()))}/"
                        f"{expected_senders} senders at deadline")
            self._check(query_id)
            chunks = self._chunks.pop(key, [])
            self._buffered.pop(key, None)
            self._cond.notify_all()
            return chunks

    def stream(self, query_id: str, from_stage: int, to_stage: int,
               partition: int, expected_senders: int):
        """Draining receive: yield chunks in arrival order, freeing each
        (credit release) — stops once all senders EOS'd and queue is dry."""
        key = (query_id, from_stage, to_stage, partition)
        with self._cond:
            self._streaming.add(key)
        deadline = self._deadline_for(query_id)
        try:
            while True:
                with self._cond:
                    while not self._chunks.get(key) and \
                            len(self._eos.get(key, ())) < expected_senders:
                        self._check(query_id)
                        if not self._cond.wait(1.0) and \
                                time.monotonic() > deadline:
                            raise TimeoutError(f"mailbox {key} stream stall")
                    self._check(query_id)
                    if self._chunks.get(key):
                        chunk = self._chunks[key].pop(0)
                        self._buffered[key] -= _block_nbytes(chunk)
                        self._cond.notify_all()
                    else:
                        return
                yield chunk
                deadline = self._deadline_for(query_id)
        finally:
            with self._cond:
                self._streaming.discard(key)

    def metrics(self, query_id: str) -> dict:
        with self._cond:
            return {"mailbox_bytes_total": self._total_bytes.get(query_id, 0),
                    "mailbox_bytes_peak": self._peak_bytes.get(query_id, 0),
                    "mailbox_duplicates_dropped":
                        self._duplicates.get(query_id, 0)}

    def open_queries(self) -> set:
        """Query ids that still hold any state here (empty once every
        query has been cleaned up)."""
        with self._cond:
            out = {k[0] for d in (self._chunks, self._eos, self._buffered)
                   for k in d}
            out |= {k[0][0] for k in self._last_seq}
            out |= {k[0][0] for k in self._inflight_seq}
            out |= set(self._total_bytes) | set(self._peak_bytes)
            out |= set(self._duplicates) | set(self._deadlines)
            return out | set(self._cancelled)

    def cancel(self, query_id: str) -> None:
        with self._cond:
            self._cancelled.add(query_id)
            self._cond.notify_all()

    def cleanup(self, query_id: str) -> None:
        with self._cond:
            for d in (self._chunks, self._eos, self._buffered):
                for key in [k for k in d if k[0] == query_id]:
                    del d[key]
            for skey in [k for k in self._last_seq if k[0][0] == query_id]:
                del self._last_seq[skey]
            self._inflight_seq = {k for k in self._inflight_seq
                                  if k[0][0] != query_id}
            self._total_bytes.pop(query_id, None)
            self._peak_bytes.pop(query_id, None)
            self._duplicates.pop(query_id, None)
            self._deadlines.pop(query_id, None)
            self._cancelled.discard(query_id)
            self._closed[query_id] = True
            while len(self._closed) > _CLOSED_QUERIES:
                self._closed.popitem(last=False)
            self._cond.notify_all()


class RoutedMailbox:
    """StageRunner-compatible mailbox whose sends cross process boundaries.

    ``routing`` maps (to_stage, partition) → (host, port); a partition routed
    to this process's own address short-circuits to the local store.
    ``sender`` identifies this worker in EOS markers; ``expected`` maps
    from_stage → number of sender workers a receive must wait for.
    ``device`` is the sending server's torch device, where PTDP blocks are
    packed."""

    def __init__(self, boxes: MailboxStore, query_id: str,
                 routing: dict[tuple[int, int], tuple[str, int]],
                 self_addr: tuple[str, int], send_rpc: Callable,
                 device, sender: int = 0,
                 expected: Optional[dict[int, int]] = None):
        self.boxes = boxes
        self.query_id = query_id
        self.routing = routing
        self.self_addr = self_addr
        self.send_rpc = send_rpc  # (addr, request_dict) → None
        self.device = device
        self.sender = sender
        self.expected = expected or {}
        self._seq: dict[tuple[int, int], int] = defaultdict(int)
        # same stage-stats counters as the in-process MailboxService, and
        # the PTDP blob bytes this worker shipped
        self.sent_rows: dict[int, int] = defaultdict(int)
        self.sent_bytes: dict[int, int] = defaultdict(int)
        self.packed_bytes = 0
        self.packed_blocks = 0

    def _expected_senders(self, from_stage: int) -> int:
        # an absent declared-sender count must be loud: defaulting to 0 would
        # make wait_all return immediately with whatever raced in (silently
        # empty/partial results). A genuinely zero-worker child (empty table)
        # is declared explicitly as 0 by the dispatcher.
        if from_stage not in self.expected:
            raise UnsupportedQueryError(
                f"no declared sender count for child stage {from_stage} "
                f"(dispatcher omitted child_workers)")
        return self.expected[from_stage]

    def receive(self, from_stage: int, to_stage: int, partition: int,
                schema=None) -> Block:
        chunks = self.boxes.wait_all(
            self.query_id, from_stage, to_stage, partition,
            self._expected_senders(from_stage))
        return concat_blocks(chunks, schema)

    def stream(self, from_stage: int, to_stage: int, partition: int,
               schema=None):
        return self.boxes.stream(self.query_id, from_stage, to_stage,
                                 partition, self._expected_senders(from_stage))

    def send(self, from_stage: int, to_stage: int, partition: int,
             block: Block, eos: bool = False) -> None:
        addr = self.routing.get((to_stage, partition))
        if addr is None:
            raise UnsupportedQueryError(
                f"no route for stage {to_stage} partition {partition}")
        if block is not None:
            self.sent_rows[from_stage] += block_len(block)
            self.sent_bytes[from_stage] += block_nbytes(block)
        seq = self._seq[(to_stage, partition)]
        self._seq[(to_stage, partition)] += 1
        if tuple(addr) == tuple(self.self_addr):
            if block is not None:
                self.boxes.put(self.query_id, from_stage, to_stage,
                               partition, block, sender=self.sender, seq=seq)
            if eos:
                self.boxes.mark_eos(self.query_id, from_stage, to_stage,
                                    partition, self.sender)
            return
        req = {"type": "mse_mailbox", "query_id": self.query_id,
               "from_stage": from_stage, "to_stage": to_stage,
               "partition": partition, "block": block,
               "sender": self.sender, "seq": seq}
        packed = _pack_for_wire(block, self.device)
        if packed is not None:
            req["block"] = None
            req["packed"] = packed
            self.packed_bytes += len(packed)
            self.packed_blocks += 1
            SERVER_METRICS.add_meter(
                ServerMeter.DEVICE_PACKED_EXCHANGE_BYTES, len(packed))
        if eos:
            req["eos"] = True
        self.send_rpc(tuple(addr), req)

    def finish(self, from_stage: int, to_stage: int,
               num_partitions: int) -> None:
        """EOS to every partition of the parent stage (empty ones too)."""
        for p in range(num_partitions):
            self.send(from_stage, to_stage, p, None, eos=True)

    def send_partitioned(self, from_stage: int, to_stage: int, block: Block,
                         dist: str, keys: list[str], num_partitions: int,
                         pfunc: Optional[str] = None) -> None:
        """Ship one output block in CHUNK_ROWS chunks (pipelining: the
        consumer starts while later chunks are still in flight), then EOS
        to every partition the block could reach."""
        # a pack-eligible block skips row-chunking: it crosses the wire as
        # ONE device-packed blob, so splitting it first would re-introduce
        # the per-chunk host encodes the packed path exists to avoid
        chunks = [block] if _wire_packable(block) else _iter_chunks(block)
        for chunk in chunks:
            if dist == "partitioned" and keys and num_partitions > 1:
                # colocated join: route by the TABLE partition function — a
                # leaf whose segments are all one partition sends one
                # non-empty box
                for p, b in enumerate(table_partition(
                        chunk, keys[0], pfunc, num_partitions)):
                    if block_len(b):
                        self.send(from_stage, to_stage, p, b)
            elif dist == "hash" and keys and num_partitions > 1:
                for p, b in enumerate(hash_partition(
                        chunk, keys, num_partitions)):
                    if block_len(b):
                        self.send(from_stage, to_stage, p, b)
            elif dist == "broadcast":
                for p in range(num_partitions):
                    self.send(from_stage, to_stage, p, chunk)
            else:
                self.send(from_stage, to_stage, 0, chunk)
        if dist == "broadcast" or (dist in ("hash", "partitioned")
                                   and keys and num_partitions > 1):
            self.finish(from_stage, to_stage, num_partitions)
        else:
            self.finish(from_stage, to_stage, 1)


def _iter_chunks(block: Block):
    n = block_len(block)
    if n <= CHUNK_ROWS:
        yield block
        return
    for lo in range(0, n, CHUNK_ROWS):
        yield {c: np.asarray(v)[lo:lo + CHUNK_ROWS]
               for c, v in block.items()}


# -- worker side --------------------------------------------------------------


class _LeafEngine:
    """The single-stage engine a worker's StageRunner pushes its leaf down
    to: the server's QueryExecutor over exactly the segments the broker
    assigned this worker, planned half by half (a hybrid table's OFFLINE
    and REALTIME halves, each with its time-boundary filter ANDed in and
    ``timeoutMs`` clamped to the stage's deadline). A planned leaf is the
    list of its halves' PlannedQuery. An aggregate leaf reduces each half
    table-locally and concatenates the rows (the parent's final aggregate
    merges partials across halves and workers); a scan leaf takes the
    columnar bitmap path when every half can, concatenating the halves'
    columns."""

    def __init__(self, worker: "MseWorkerService", halves: dict,
                 deadline: Optional[float]):
        self.worker = worker
        self.qe = worker.server.executor
        self.halves = halves
        self.deadline = deadline

    def _half_queries(self, qc):
        for nwt, seg_names, extra in self.worker._halves_for(
                self.halves, qc.table_name):
            segs = self.worker._leaf_segments(nwt, seg_names, self.deadline)
            q2 = copy.deepcopy(qc)
            q2.table_name = nwt
            if self.deadline is not None:
                remaining_ms = max(
                    50.0, (self.deadline - time.monotonic()) * 1000.0)
                cur = q2.query_options.get("timeoutMs")
                try:
                    cur = float(cur) if cur is not None else None
                except (TypeError, ValueError):
                    cur = None
                q2.query_options["timeoutMs"] = (
                    remaining_ms if cur is None else min(cur, remaining_ms))
            if extra is not None:
                fc = filter_from_expression(expr_from_json(extra))
                q2.filter = fc if q2.filter is None else \
                    FilterContext.and_(q2.filter, fc)
            yield q2, segs

    def plan_query(self, qc) -> list:
        return [self.qe.plan_query(q2, segments=segs)
                for q2, segs in self._half_queries(qc)]

    def run_planned(self, plans: list) -> BrokerResponse:
        rows, schema = [], None
        scanned = total = dispatches = 0
        trimmed = False
        for p in plans:
            resp = self.qe.run_planned(p)
            scanned += resp.num_docs_scanned
            total += resp.total_docs
            dispatches += resp.num_device_dispatches
            trimmed |= bool(resp.num_groups_limit_reached)
            if resp.result_table is not None:
                schema = schema or resp.result_table.schema
                rows.extend(resp.result_table.rows)
        return BrokerResponse(
            result_table=ResultTable(schema, rows) if schema is not None
            else None,
            num_docs_scanned=scanned, total_docs=total,
            num_device_dispatches=dispatches,
            num_groups_limit_reached=trimmed)

    def plan_selection_columnar(self, qc) -> Optional[list]:
        plans = []
        for q2, segs in self._half_queries(qc):
            p = self.qe.plan_selection_columnar(q2, segments=segs)
            if p is None:
                return None
            plans.append(p)
        return plans

    def run_selection_columnar(self, plans: list):
        parts: dict[str, list] = defaultdict(list)
        stats: Counter = Counter()
        for p in plans:
            cols, st = self.qe.run_selection_columnar(p)
            for c, v in cols.items():
                parts[c].append(v)
            stats.update(st)
        return ({c: concat_columns(v) for c, v in parts.items()},
                {k: stats.get(k, 0) for k in
                 ("num_docs_scanned", "total_docs", "num_device_dispatches")})


class MseWorkerService:
    """Stage execution endpoint living on a ServerInstance. Handles
    ``mse_stage`` (run one stage worker), ``mse_mailbox`` (accept a shuffled
    block), ``mse_cancel`` and ``mse_cleanup`` — the worker half of
    QueryRunner.processQuery + GrpcMailboxService."""

    def __init__(self, server):
        self.server = server  # cluster.server.ServerInstance
        self.boxes = MailboxStore()
        self._clients: dict[tuple, object] = {}
        self._lock = threading.Lock()

    # -- transport helpers -------------------------------------------------
    def _send_rpc(self, addr: tuple[str, int], request: dict) -> None:
        from ..cluster.transport import RemoteError, RpcClient, TransportError

        with self._lock:
            client = self._clients.get(addr)
            if client is None:
                client = RpcClient(addr[0], addr[1])
                self._clients[addr] = client
        for attempt in range(MAILBOX_SEND_RETRIES + 1):
            try:
                client.call(request)
                return
            except (RemoteError, TransportError) as e:
                # the receiver dedups on (sender, seq), so a delivery whose
                # acknowledgement failed is re-sent; a cancelled or timed
                # out mailbox is final
                if attempt == MAILBOX_SEND_RETRIES or str(e).startswith(
                        ("MailboxCancelled", "TimeoutError")):
                    raise

    def close(self) -> None:
        with self._lock:
            for c in self._clients.values():
                c.close()
            self._clients.clear()

    # -- request dispatch --------------------------------------------------
    def handle(self, request: dict):
        kind = request["type"]
        if kind == "mse_mailbox":
            _deliver(self.boxes, request)
            return True
        if kind == "mse_cancel":
            self.boxes.cancel(request["query_id"])
            return True
        if kind == "mse_cleanup":
            self.boxes.cleanup(request["query_id"])
            return True
        if kind == "mse_stage":
            return self._run_stage(request)
        raise ValueError(f"unknown mse request {kind}")

    # -- stage execution ---------------------------------------------------
    def _run_stage(self, request: dict) -> dict:
        # trace ships back in the stats payload so the dispatcher can merge
        # every worker's spans into one broker-side tree (the scatter/gather
        # path in cluster/broker.py does the same for leaf queries)
        opts = request.get("options") or {}
        if opts.get("trace") not in (True, "true", 1) \
                or TRACING.active_trace() is not None:
            return self._run_stage_inner(request)
        trace = TRACING.start_trace(
            f"mse:{self.server.instance_id}",
            analyze=opts.get("analyze") in (True, "true", 1))
        try:
            stats = self._run_stage_inner(request)
            stats["trace"] = trace.to_json()
            return stats
        finally:
            TRACING.end_trace()

    def _run_stage_inner(self, request: dict) -> dict:
        stage = stage_from_json(request["stage"])
        query_id = request["query_id"]
        worker = request["worker"]
        parent_workers = request["parent_workers"]
        routing = {(stage.parent_stage, int(p)): tuple(a)
                   for p, a in request["routing"].items()}
        # halves: raw table → [(name_with_type, [segment], extra_filter_json)]
        halves = request.get("tables", {})
        # deadline propagation: the dispatcher ships its remaining budget;
        # this worker's mailbox waits and leaf executions clamp to it
        deadline = None
        deadline_ms = request.get("deadline_ms")
        if deadline_ms is not None:
            deadline = time.monotonic() + float(deadline_ms) / 1000.0
            self.boxes.set_deadline(query_id, deadline)

        mailbox = RoutedMailbox(
            self.boxes, query_id, routing, self.server.address,
            self._send_rpc, self.server.device, sender=worker,
            expected={int(k): int(v) for k, v in
                      (request.get("child_workers") or {}).items()})
        # the server's device: the stage's pair joins run there
        runner = StageRunner([stage], request.get("parallelism", 1),
                             _LeafEngine(self, halves, deadline),
                             self._make_read_table(halves, deadline),
                             query_options=request.get("options") or {},
                             device=self.server.device)
        runner.mailbox = mailbox

        pop_join_overflow()  # clear any stale flag on this handler thread
        sstat = runner._sstat(stage.stage_id)
        t0 = time.perf_counter()
        with TRACING.scope(f"mse_stage:{stage.stage_id}") as span:
            pushed = runner._try_ssqe(stage) if stage.is_leaf else None
            if pushed is not None:
                runner.stats["leaf_ssqe_pushdowns"] += 1
                sstat["leaf_pushdown"] = True
                block = pushed
            else:
                if stage.is_leaf and runner._null_handling_requested():
                    raise UnsupportedQueryError(
                        "enableNullHandling requires this leaf stage to push "
                        "down to the single-stage engine")
                block = runner._exec(stage.root, stage, worker)
            sstat["workers"] = 1  # this worker's share; the dispatcher sums
            sstat["rows_out"] += block_len(block)
            mailbox.send_partitioned(stage.stage_id, stage.parent_stage,
                                     runner._trim_to_send(stage, block),
                                     stage.send_dist, stage.send_keys,
                                     parent_workers, pfunc=stage.send_pfunc)
            sstat["wall_ms"] += (time.perf_counter() - t0) * 1000
            sstat["shuffled_rows"] = mailbox.sent_rows[stage.stage_id]
            sstat["shuffled_bytes"] = mailbox.sent_bytes[stage.stage_id]
            sstat["packed_bytes"] = mailbox.packed_bytes
            if span is not None:
                span.set_attribute("worker", worker)
                span.set_attribute("rows_out", int(sstat["rows_out"]))
                span.set_attribute("shuffled_rows",
                                   int(sstat["shuffled_rows"]))
                span.set_attribute("shuffled_bytes",
                                   int(sstat["shuffled_bytes"]))
                if sstat.get("leaf_pushdown"):
                    span.set_attribute("leaf_pushdown", True)
        runner.stats["join_overflow"] = (
            pop_join_overflow() or bool(runner.stats.get("join_overflow")))
        runner.stats["packed_bytes"] = mailbox.packed_bytes
        runner.stats["packed_blocks"] = mailbox.packed_blocks
        runner.stats["device"] = str(self.server.device)
        runner.stats["stage_stats"] = {
            str(k): v for k, v in runner.stage_stats.items()}
        runner.stats.update(self.boxes.metrics(query_id))
        return runner.stats

    def _halves_for(self, halves: dict, table: str):
        entry = halves.get(table)
        if entry is None:
            raise UnsupportedQueryError(
                f"table {table} not assigned to this worker")
        return entry

    def _leaf_segments(self, nwt: str, seg_names,
                       deadline: Optional[float] = None) -> list:
        """The routed segments, in order, lazily warming cold (metadata-
        only) registrations within the stage deadline (`deadline`,
        absolute monotonic; None waits for the warm). An MSE leaf has no
        partial-results channel, so a routed segment still cold at the
        deadline, or one this server does not host, raises rather than be
        skipped into a silently truncated scan."""
        server = self.server
        deadline_ms = None
        if deadline is not None:
            deadline_ms = max(0.0, (deadline - time.monotonic()) * 1000.0)
        still = server._warm_routed(nwt, list(seg_names), deadline_ms)
        if still:
            raise RuntimeError(
                f"cold segments still warming for {nwt}: {still}")
        with server._lock:
            hosted = dict(server.segments.get(nwt, {}))
        missing = [n for n in seg_names if n not in hosted]
        if missing:
            raise SegmentNotHostedError(
                f"{server.instance_id} does not host {nwt} segments "
                f"{missing} routed to it")
        return [hosted[n] for n in seg_names]

    def _make_read_table(self, halves: dict,
                         deadline: Optional[float] = None) -> Callable:
        """Generic scan over assigned segments (leaf shapes the single-stage
        engine refuses), with the hybrid time-boundary filter applied per
        half, upsert-invalid rows dropped and a consuming segment read
        through its pinned snapshot."""

        def read_table(table: str, columns: list[str]) -> dict[str, np.ndarray]:
            blocks = []
            for nwt, seg_names, extra in self._halves_for(halves, table):
                segs = self._leaf_segments(nwt, seg_names, deadline)
                extra_ec = expr_from_json(extra) if extra is not None else None
                need = list(dict.fromkeys(
                    list(columns) + sorted(extra_ec.columns() if extra_ec else [])))
                block = scan_segments(segs, need)
                if extra_ec is not None:
                    block = op_filter(block, extra_ec)
                    block = {c: block[c] for c in columns}
                blocks.append(block)
            return concat_blocks(blocks, list(columns))

        return read_table


def _deliver(boxes: MailboxStore, request: dict) -> None:
    """One mse_mailbox request into ``boxes``. The ``mailbox.deliver``
    fault fires after the store took the chunk: it models a lost
    acknowledgement, which the sender answers by re-sending, and the store
    drops the re-sent chunk by (sender, seq)."""
    boxes.deliver(request)
    if faults.ACTIVE:
        faults.FAULTS.fire(
            "mailbox.deliver", query_id=request.get("query_id"),
            chunk=request.get("block") is not None
            or request.get("packed") is not None)


# -- dispatcher (broker side) -------------------------------------------------


class DistributedMseDispatcher:
    """Broker-side MSE entry: plan → fragment → assign stages to server
    processes → dispatch bottom-up → final receive + result assembly."""

    def __init__(self, broker):
        from ..cluster.transport import RpcServer

        self.broker = broker
        self.store = broker.store
        self.boxes = MailboxStore()
        self._rpc = RpcServer(self._handle)
        self._qid = itertools.count()
        self._pool = ThreadPoolExecutor(max_workers=8,
                                        thread_name_prefix="mse-dispatch")

    def close(self) -> None:
        self._rpc.close()
        self._pool.shutdown(wait=False)

    @property
    def address(self) -> tuple[str, int]:
        return (self._rpc.host, self._rpc.port)

    def _handle(self, request: dict):
        if request.get("type") == "mse_mailbox":
            _deliver(self.boxes, request)
            return True
        raise ValueError("broker mailbox accepts only mse_mailbox")

    # -- catalog -----------------------------------------------------------
    def _catalog(self) -> dict[str, list[str]]:
        from ..spi.data_types import Schema

        out = {}
        for raw in self.store.children("/SCHEMAS"):
            sj = self.store.get(f"/SCHEMAS/{raw}")
            if sj is not None:
                out[raw] = Schema.from_json(sj).column_names()
        return out

    def _partition_catalog(self) -> dict[str, dict]:
        """table → {column: (pfunc, n_partitions)} from the DECLARED
        segmentPartitionConfig of the stored table configs (reference:
        the broker's TablePartitionInfo). A hybrid table only qualifies
        when both halves declare identical partitioning."""
        from ..cluster.controller import table_name_with_type

        def column_partition_map(cfg: dict) -> dict:
            # canonical location is tableIndexConfig.segmentPartitionConfig
            # (TableConfig.to_json / from_json); accept the top level too for
            # hand-rolled cluster configs
            spc = (cfg.get("tableIndexConfig") or {}).get(
                "segmentPartitionConfig") or cfg.get(
                "segmentPartitionConfig") or {}
            return spc.get("columnPartitionMap") or {}

        out: dict[str, dict] = {}
        for raw in self.store.children("/SCHEMAS"):
            maps = []
            for ttype in ("OFFLINE", "REALTIME"):
                cfg = self.store.get(
                    f"/CONFIGS/TABLE/{table_name_with_type(raw, ttype)}")
                if cfg is not None:
                    maps.append(column_partition_map(cfg))
            if not maps or (len(maps) == 2 and maps[0] != maps[1]):
                continue
            per_col = {}
            for col, v in maps[0].items():
                if v.get("functionName") and v.get("numPartitions"):
                    per_col[col] = (str(v["functionName"]).lower(),
                                    int(v["numPartitions"]))
            if per_col:
                out[raw] = per_col
        return out

    def _server_instances(self) -> list[str]:
        out = []
        for inst in sorted(self.store.children("/LIVEINSTANCES")):
            cfg = self.store.get(f"/LIVEINSTANCES/{inst}") or {}
            if "host" in cfg:
                out.append(inst)
        return out

    def _instance_addr(self, instance: str) -> tuple[str, int]:
        cfg = self.store.get(f"/LIVEINSTANCES/{instance}") or \
            self.store.get(f"/INSTANCECONFIGS/{instance}") or {}
        return (cfg["host"], cfg["port"])

    # -- physical assignment ----------------------------------------------
    def _leaf_assignment(self, stage: Stage):
        """instance → {raw_table: [(name_with_type, [segments], extra_json)]}
        via the broker's replica selector, with hybrid time-boundary split."""
        from ..cluster.controller import table_name_with_type

        per_instance: dict[str, dict[str, list]] = {}
        for scan in stage.scans():
            raw = scan.table
            offline = table_name_with_type(raw, "OFFLINE")
            realtime = table_name_with_type(raw, "REALTIME")
            has_off = self.store.get(f"/CONFIGS/TABLE/{offline}") is not None
            has_rt = self.store.get(f"/CONFIGS/TABLE/{realtime}") is not None
            if not has_off and not has_rt:
                raise UnsupportedQueryError(f"table {raw} not found")
            halves: list[tuple[str, Optional[dict]]] = []
            if has_off and has_rt:
                boundary = self.broker._time_boundary(offline)
                time_col = (self.store.get(f"/CONFIGS/TABLE/{offline}") or {}) \
                    .get("timeColumn")
                if boundary is not None and time_col:
                    halves.append((offline, expr_to_json(EC.for_function(
                        "lessthanorequal", EC.for_identifier(time_col),
                        EC.for_literal(boundary)))))
                    halves.append((realtime, expr_to_json(EC.for_function(
                        "greaterthan", EC.for_identifier(time_col),
                        EC.for_literal(boundary)))))
                else:
                    halves.append((offline, None))
                    halves.append((realtime, None))
            else:
                halves.append((offline if has_off else realtime, None))
            for nwt, extra in halves:
                routing = self.broker.routing_table(nwt)
                if not routing:
                    # distinguish an empty table (no segments → empty scan)
                    # from segments hidden/unroutable — the latter must be
                    # an availability error, not silent zero rows
                    if self.store.get(f"/IDEALSTATES/{nwt}"):
                        raise UnsupportedQueryError(
                            f"no routable segments for {nwt}")
                    continue
                plan = self.broker._select_instances(routing)
                for inst, segs in plan.items():
                    per_instance.setdefault(inst, {}).setdefault(raw, []) \
                        .append([nwt, sorted(segs), extra])
        # an existing-but-empty table yields zero workers: the stage is
        # skipped and its parent receives an empty block — matching the
        # in-process StageRunner's scan over zero segments
        return per_instance

    def _partition_worker_placement(self, stage, stages, workers,
                                    n: int) -> dict:
        """partition id → instance for a stage fed by "partitioned"
        (colocated-join) exchanges: worker p lands on the instance whose
        assigned child segments carry partition p on the exchange's OWN
        key column with a COMPATIBLE stamp (same function and count — a
        stale stamp from a changed segmentPartitionConfig must not place),
        so a single-partition leaf's send short-circuits to the local
        mailbox instead of crossing the wire. Partitions without a stamped
        host fall back to round-robin."""
        if not any(node.dist == "partitioned"
                   for node in receive_nodes(stage.root)):
            return {}
        votes: dict[int, Counter] = defaultdict(Counter)
        for child_id in stage.child_stages:
            child = stages[child_id]
            if child.send_dist != "partitioned" or not child.send_keys:
                continue
            # the exchange key is qualified against the child's output
            # schema; map it to the scanned source column
            key_cols = set()
            for scan in child.scans():
                for q, src in zip(scan.schema, scan.source_columns):
                    if q == child.send_keys[0]:
                        key_cols.add(src)
            if not key_cols:
                continue
            for w in workers.get(child_id, []):
                for raw, entries in (w.get("tables") or {}).items():
                    for nwt, seg_names, _extra in entries:
                        for s in seg_names:
                            # name-with-type: controller-pushed segments;
                            # raw name: a realtime completion's DONE records
                            rec = self.store.get(f"/SEGMENTS/{nwt}/{s}") \
                                or self.store.get(f"/SEGMENTS/{raw}/{s}") or {}
                            for col, info in (rec.get("partitions") or {}).items():
                                if col not in key_cols:
                                    continue
                                if not isinstance(info, dict) \
                                        or info.get("numPartitions") != n \
                                        or (child.send_pfunc and
                                            info.get("functionName") != child.send_pfunc):
                                    continue
                                for p in info.get("partitions") or []:
                                    if 0 <= int(p) < n:
                                        votes[int(p)][w["instance"]] += 1
        return {p: c.most_common(1)[0][0] for p, c in votes.items()}

    # -- execution ---------------------------------------------------------
    def execute_sql(self, sql: str) -> BrokerResponse:
        from ..engine.explain import analyze_table

        t0 = time.perf_counter()
        analyze = False
        try:
            resp, analyze = self._execute(sql)
        except Exception as e:
            resp = BrokerResponse(exceptions=[f"{type(e).__name__}: {e}"])
        resp.time_used_ms = (time.perf_counter() - t0) * 1000
        if analyze:
            # rendered here, so the root row carries the real wall time
            resp.result_table = analyze_table(resp.trace_info or [], resp)
        return resp

    def _execute(self, sql: str) -> tuple[BrokerResponse, bool]:
        query = parse_relational(sql)
        planner = LogicalPlanner(query, self._catalog(),
                                 partition_catalog=self._partition_catalog)
        plan = planner.plan()
        plan = push_filters(plan)
        prune_columns(plan)
        stages = fragment(plan)
        analyze = query.explain == "analyze"
        if query.explain and not analyze:
            text = explain_stages(stages)
            return BrokerResponse(result_table=ResultTable(
                DataSchema(["plan"], ["STRING"]),
                [[line] for line in text.split("\n")])), False

        # the per-table QPS quota applies to every engine at the broker
        # (reference: the quota check in BrokerRequestHandler before the
        # dispatch), over every table a leaf stage scans
        quota_tables = set()
        for stage in stages:
            if stage.stage_id != 0:
                quota_tables.update(s.table for s in stage.scans())
        for t in sorted(quota_tables):
            self.broker.quota.acquire(t)

        topo = StageRunner(stages, STAGE_PARALLELISM, None, None)
        servers = self._server_instances()
        if not servers:
            raise UnsupportedQueryError("no live servers")
        query_id = f"q{next(self._qid)}_{uuid.uuid4().hex}"

        # deadline propagation: only when the query EXPLICITLY sets
        # timeoutMs (no default MSE budget — long analytical joins own
        # their wall time); the budget clamps the broker-side final
        # receive, every worker's mailbox waits, and the leaf timeoutMs
        deadline = None
        opt = (query.options or {}).get("timeoutMs")
        if opt is not None:
            try:
                deadline = time.monotonic() + float(opt) / 1000.0
            except (TypeError, ValueError):
                deadline = None
        if deadline is not None:
            self.boxes.set_deadline(query_id, deadline)

        # choose workers per stage: leaf stages follow segment placement,
        # intermediate stages round-robin over live servers
        workers: dict[int, list[dict]] = {}
        rr = 0
        for stage in sorted(stages, key=lambda s: -s.stage_id):
            if stage.stage_id == 0:
                continue
            if stage.scans():
                assignment = self._leaf_assignment(stage)
                workers[stage.stage_id] = [
                    {"instance": inst, "addr": self._instance_addr(inst),
                     "tables": assignment[inst]}
                    for inst in sorted(assignment)]
            else:
                n = topo.workers_of(stage)
                placed = self._partition_worker_placement(
                    stage, stages, workers, n)
                chosen = []
                for p in range(n):
                    inst = placed.get(p) if placed else None
                    if inst is None:
                        inst = servers[rr % len(servers)]
                        rr += 1
                    chosen.append({"instance": inst,
                                   "addr": self._instance_addr(inst),
                                   "tables": {}})
                workers[stage.stage_id] = chosen

        # PIPELINED dispatch: every stage's workers are submitted
        # concurrently, children strictly BEFORE parents (the pool queue is
        # FIFO, so child workers always get slots first and a parent can
        # never starve the children it waits on). A parent stage starts
        # executing immediately and blocks inside its mailbox receive/stream
        # while child chunks arrive — stages overlap in wall time, like the
        # reference's streaming gRPC OpChains. Each mse_stage call rides a
        # DEDICATED connection: the shared per-instance client serializes
        # calls under a lock, and a long-blocking parent stage on it would
        # deadlock the dispatch of its own children to the same instance.
        from ..cluster.transport import RpcClient

        # EXPLAIN ANALYZE (or an explicit trace option) arms a dispatcher
        # trace; workers see trace/analyze in their options and ship spans
        # back for the merge in the gather loop. Armed here — after worker
        # placement, which can raise — so the finally below always unwinds
        # the thread-local.
        own_trace = False
        if (analyze or (query.options or {}).get("trace") in
                (True, "true", 1)) and TRACING.active_trace() is None:
            trace = TRACING.start_trace(f"mse:{query_id}", analyze=analyze)
            own_trace = True
        else:
            trace = TRACING.active_trace()
        if trace is not None:
            query.options = dict(query.options or {})
            query.options["trace"] = True
            if getattr(trace, "analyze", False):
                query.options["analyze"] = True

        stats_agg = {"num_docs_scanned": 0, "total_docs": 0,
                     "leaf_ssqe_pushdowns": 0, "stages": len(stages),
                     "num_device_dispatches": 0,
                     "join_overflow": False, "num_groups_limit_reached": False}
        exchange = {"packed_bytes": 0, "packed_blocks": 0,
                    "mailbox_bytes_total": 0, "mailbox_bytes_peak": 0,
                    "mailbox_duplicates_dropped": 0, "workers": {},
                    "devices": {}, "packed_bytes_by": {}}
        touched: set[str] = set()

        def submit(stage, w_idx, w, parent_addrs, routing, sj, child_workers):
            touched.add(w["instance"])
            # a stage worker legitimately blocks in its receive while
            # upstream stages still run — the dispatch call must outlive
            # the worker's own mailbox-wait ceiling, and must NOT retry
            # (a re-sent mse_stage would re-run the stage against
            # already-consumed mailboxes)
            wait_s = MAILBOX_WAIT_S
            if deadline is not None:
                wait_s = min(wait_s, max(0.05, deadline - time.monotonic()))
            client = RpcClient(*w["addr"], timeout=wait_s + 30)
            req = {"type": "mse_stage", "query_id": query_id,
                   "stage": sj, "worker": w_idx,
                   "parent_workers": len(parent_addrs),
                   "routing": routing, "tables": w["tables"],
                   "child_workers": child_workers,
                   "parallelism": STAGE_PARALLELISM,
                   "options": dict(query.options)}
            if deadline is not None:
                req["deadline_ms"] = max(
                    50.0, (deadline - time.monotonic()) * 1000.0)
            try:
                return w["instance"], client.call(req, retry=False)
            finally:
                client.close()

        futures = []
        try:
            for stage in sorted(stages, key=lambda s: -s.stage_id):
                if stage.stage_id == 0:
                    continue
                parent_id = stage.parent_stage
                if parent_id == 0:
                    parent_addrs = [self.address]
                else:
                    parent_addrs = [w["addr"] for w in workers[parent_id]]
                routing = {str(p): list(a) for p, a in enumerate(parent_addrs)}
                sj = stage_to_json(stage)
                child_workers = {str(cid): len(workers.get(cid, []))
                                 for cid in stage.child_stages}
                for w_idx, w in enumerate(workers[stage.stage_id]):
                    futures.append(self._pool.submit(
                        submit, stage, w_idx, w, parent_addrs, routing, sj,
                        child_workers))

            stage_stats_agg: dict[int, dict] = {}
            dups: dict[str, int] = {}
            worker_traces: list[tuple[str, list]] = []
            for f in futures:
                inst, st = f.result()
                if st.get("trace"):
                    worker_traces.append((inst, st["trace"]))
                for k in ("num_docs_scanned", "total_docs",
                          "leaf_ssqe_pushdowns", "num_device_dispatches"):
                    stats_agg[k] += st.get(k, 0)
                stats_agg["join_overflow"] |= bool(st.get("join_overflow"))
                stats_agg["num_groups_limit_reached"] |= bool(
                    st.get("num_groups_limit_reached"))
                for k in ("packed_bytes", "packed_blocks",
                          "mailbox_bytes_total"):
                    exchange[k] += st.get(k, 0)
                # the duplicates and the peak are per store (one a
                # server): each worker reports its store's so far
                exchange["mailbox_bytes_peak"] = max(
                    exchange["mailbox_bytes_peak"],
                    st.get("mailbox_bytes_peak", 0))
                dups[inst] = max(dups.get(inst, 0),
                                 st.get("mailbox_duplicates_dropped", 0))
                exchange["workers"][inst] = exchange["workers"].get(inst, 0) + 1
                exchange["packed_bytes_by"][inst] = exchange[
                    "packed_bytes_by"].get(inst, 0) + st.get("packed_bytes", 0)
                exchange["devices"][inst] = st.get("device")
                for sid, ss in (st.get("stage_stats") or {}).items():
                    agg = stage_stats_agg.setdefault(int(sid), {
                        "workers": 0, "leaf_pushdown": False, "rows_in": 0,
                        "rows_out": 0, "shuffled_rows": 0,
                        "shuffled_bytes": 0, "cross_stage_bytes": 0,
                        "packed_bytes": 0, "host_crossings": 0,
                        "device_partition_ms": 0.0, "join_impl": "",
                        "wall_ms": 0.0})
                    for k in ("workers", "rows_in", "rows_out",
                              "shuffled_rows", "shuffled_bytes",
                              "cross_stage_bytes", "packed_bytes",
                              "host_crossings"):
                        agg[k] += ss.get(k, 0)
                    agg["device_partition_ms"] += float(
                        ss.get("device_partition_ms", 0.0))
                    # workers run concurrently: the stage's wall time is
                    # its slowest worker, not the sum
                    agg["wall_ms"] = max(agg["wall_ms"],
                                         float(ss.get("wall_ms", 0.0)))
                    agg["leaf_pushdown"] |= bool(ss.get("leaf_pushdown"))
                    agg["join_impl"] = ss.get("join_impl") or agg["join_impl"]

            final_sid = stages[0].child_stages[0]
            block = concat_blocks(
                self.boxes.wait_all(query_id, final_sid, 0, 0,
                                    len(workers.get(final_sid, []))),
                stages[0].root.schema)
            exchange["mailbox_duplicates_dropped"] = sum(dups.values())
            broker_box = self.boxes.metrics(query_id)
            exchange["mailbox_bytes_total"] += broker_box["mailbox_bytes_total"]
            exchange["mailbox_bytes_peak"] = max(
                exchange["mailbox_bytes_peak"],
                broker_box["mailbox_bytes_peak"])
            exchange["mailbox_duplicates_dropped"] += \
                broker_box["mailbox_duplicates_dropped"]
            resp = BrokerResponse(
                result_table=_block_to_result(block, stages[0].root.schema),
                num_docs_scanned=stats_agg["num_docs_scanned"],
                total_docs=stats_agg["total_docs"],
                partial_result=stats_agg["join_overflow"],
                num_groups_limit_reached=stats_agg["num_groups_limit_reached"],
                num_device_dispatches=stats_agg["num_device_dispatches"],
                mse_stage_stats=stage_stats_agg, query_id=query_id,
                mse_exchange=exchange)
            if trace is not None:
                trace_info = trace.to_json()
                # namespace per (instance, dispatch ordinal): one instance
                # can serve several stage workers, and bare instance
                # prefixes would collide their span ids
                ordinal: dict[str, int] = {}
                for inst, spans in worker_traces:
                    n = ordinal.get(inst, 0)
                    ordinal[inst] = n + 1
                    prefix = inst if n == 0 else f"{inst}#{n}"
                    for s in spans:
                        s = dict(s)
                        s["spanId"] = f"{prefix}:{s['spanId']}"
                        if s.get("parentId") is not None:
                            s["parentId"] = f"{prefix}:{s['parentId']}"
                        else:
                            s["server"] = inst
                        trace_info.append(s)
                resp.trace_info = trace_info
            return resp, analyze
        except Exception:
            # a failed worker must not hang its peers in receive/backpressure:
            # stop still-queued dispatches (they'd land on instances the
            # cancel broadcast below doesn't know about yet), cancel the
            # query's mailboxes everywhere, then re-raise
            for f in futures:
                f.cancel()
            self.boxes.cancel(query_id)
            for inst in touched:
                try:
                    self.broker._client(inst).call(
                        {"type": "mse_cancel", "query_id": query_id})
                except Exception:
                    pass
            for f in futures:
                try:
                    f.result()
                # CancelledError is a BaseException since 3.8
                except BaseException:
                    pass
            raise
        finally:
            if own_trace:
                TRACING.end_trace()
            self.boxes.cleanup(query_id)
            for inst in touched:
                try:
                    self.broker._client(inst).call(
                        {"type": "mse_cleanup", "query_id": query_id})
                except Exception:
                    pass
