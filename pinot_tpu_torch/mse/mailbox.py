"""Mailbox service: the MSE shuffle data plane.

Reference analogue: pinot-query-runtime/.../mailbox/MailboxService.java:40 —
getSendingMailbox:113 / getReceivingMailbox:125, with gRPC channels between
hosts and InMemory mailboxes for same-host pairs, and the exchange
strategies (hash/broadcast/singleton) in .../runtime/operator/exchange/.

The port's copy of pinot_tpu/mse/mailbox.py. Every mailbox is in-memory
(one process); the addressing scheme (from_stage, to_stage, partition)
matches the reference's mailbox id
`{requestId}|{senderStage}|{senderWorker}|{receiverStage}|{receiverWorker}`.
Payloads are columnar blocks (dict[str, np.ndarray]) — the analogue of
TransferableBlock wrapping a columnar DataBlock.
"""

from __future__ import annotations

import zlib
from collections import defaultdict
from typing import Optional

import numpy as np

from ..spi.partition import get_partition_function

Block = dict  # column name → np.ndarray (equal lengths)


def block_len(block: Block) -> int:
    for v in block.values():
        return len(v)
    return 0


def block_nbytes(block: Block) -> int:
    """Payload size of a block as shipped through a mailbox. Object columns
    count pointer width per row (cheap, consistent) — the stats consumer
    compares plans against each other, not against the wire."""
    return sum(np.asarray(v).nbytes for v in block.values())


def concat_blocks(blocks: list[Block], schema: Optional[list[str]] = None) -> Block:
    blocks = [b for b in blocks if b and block_len(b)]
    if not blocks:
        return {c: np.empty(0) for c in (schema or [])}
    cols = schema if schema is not None else list(blocks[0].keys())
    out = {}
    for c in cols:
        parts = [b[c] for b in blocks if c in b]
        if not parts:
            continue
        if len(parts) == 1:
            out[c] = np.asarray(parts[0])
        else:
            arrs = [np.asarray(p) for p in parts]
            if any(a.dtype.kind == "O" for a in arrs):
                arrs = [a.astype(object) for a in arrs]
            out[c] = np.concatenate(arrs)
    return out


def take_block(block: Block, idx) -> Block:
    return {c: np.asarray(v)[idx] for c, v in block.items()}


def _string_crc(v: np.ndarray) -> np.ndarray:
    """CRC32 memoized per distinct value — shuffle keys are dict-decoded
    strings with few distincts, so encode+crc runs once per distinct and
    every repeat is a dict hit (Python caches each str object's hash, and
    dict-decoded columns share value objects). Hash values are identical
    to the former per-row loop (str(x) then crc32)."""
    cache: dict = {}
    get = cache.get
    return np.fromiter(
        (h if (h := get(x)) is not None
         else cache.setdefault(x, zlib.crc32(str(x).encode("utf-8")))
         for x in v),
        dtype=np.uint64, count=len(v))


def hash_codes(block: Block, keys: list[str], n: int) -> np.ndarray:
    """uint64 combined hash of the key columns (row-wise)."""
    h = np.zeros(n, dtype=np.uint64)
    for k in keys:
        v = np.asarray(block[k])
        if v.dtype.kind in "iub":
            hv = v.astype(np.int64).view(np.uint64)
        elif v.dtype.kind == "f":
            f = v.astype(np.float64)
            f = np.where(f == 0.0, 0.0, f)  # -0.0 == 0.0 must hash equal
            hv = f.view(np.uint64)
        else:
            # deterministic across OS processes — Python's str hash is
            # randomized per process (PYTHONHASHSEED) and would route the
            # same key to different workers on different hosts
            hv = _string_crc(v)
        h = h * np.uint64(1000003) ^ hv
    return h


def split_by_partition(block: Block, part: np.ndarray,
                       num_partitions: int) -> list[Block]:
    """One stable argsort + one gather per column, then zero-copy slices —
    replaces the O(n·P) boolean-mask scan. Output blocks are views over the
    gathered arrays; consumers treat blocks as immutable."""
    order = np.argsort(part, kind="stable")
    counts = np.bincount(part, minlength=num_partitions)
    offs = np.zeros(num_partitions + 1, dtype=np.int64)
    np.cumsum(counts, out=offs[1:])
    gathered = {c: np.asarray(v)[order] for c, v in block.items()}
    return [{c: v[offs[p]:offs[p + 1]] for c, v in gathered.items()}
            for p in range(num_partitions)]


def hash_partition(block: Block, keys: list[str], num_partitions: int) -> list[Block]:
    """Deterministic value-hash partitioning — every producer must route the
    same key to the same consumer worker (reference: KeySelector hashCode %
    partitions in HashExchange)."""
    n = block_len(block)
    if num_partitions == 1 or not keys:
        return [block]
    h = hash_codes(block, keys, n)
    part = (h % np.uint64(num_partitions)).astype(np.int64)
    return split_by_partition(block, part, num_partitions)


def table_partition(block: Block, key: str, pfunc: str,
                    num_partitions: int) -> list[Block]:
    """Colocated-join routing: split by the TABLE's partition function on
    the partition key, so worker p sees exactly table partition p — the
    same assignment the segments were stamped with at build time."""
    fn = get_partition_function(pfunc, num_partitions)
    part = np.asarray(fn.partitions_of(np.asarray(block[key])), dtype=np.int64)
    return split_by_partition(block, part, num_partitions)


class MailboxService:
    """In-memory post office for one query execution."""

    # pseudo-partition for whole-block handoffs (device-resident path):
    # no hash split, the consumer takes the block as one unit
    RAW_PARTITION = -1

    def __init__(self):
        self._boxes: dict[tuple, list[Block]] = defaultdict(list)
        # per sending stage, for the stage-stats plane. sent_bytes is the
        # LOGICAL payload moved between stages (comparable across the
        # encode/decode and handoff paths); cross_bytes is what actually
        # crossed a process/host boundary — zero for raw handoffs.
        self.sent_rows: dict[int, int] = defaultdict(int)
        self.sent_bytes: dict[int, int] = defaultdict(int)
        self.cross_bytes: dict[int, int] = defaultdict(int)

    def send(self, from_stage: int, to_stage: int, partition: int, block: Block) -> None:
        self.sent_rows[from_stage] += block_len(block)
        nb = block_nbytes(block)
        self.sent_bytes[from_stage] += nb
        self.cross_bytes[from_stage] += nb
        self._boxes[(from_stage, to_stage, partition)].append(block)

    def send_raw(self, from_stage: int, to_stage: int, block: Block) -> None:
        """Same-process device handoff: the block changes hands by
        reference — no partition split, no encode/decode, nothing crosses
        a wire. Logical bytes still accrue to sent_bytes so the stage
        stats stay comparable across join paths;
        cross_bytes stays untouched (that is the 5x the fused path buys)."""
        self.sent_rows[from_stage] += block_len(block)
        self.sent_bytes[from_stage] += block_nbytes(block)
        self._boxes[(from_stage, to_stage, self.RAW_PARTITION)].append(block)

    def receive_raw(self, from_stage: int, to_stage: int,
                    schema: Optional[list[str]] = None) -> Block:
        return concat_blocks(
            self._boxes.get((from_stage, to_stage, self.RAW_PARTITION), []),
            schema)

    def receive(self, from_stage: int, to_stage: int, partition: int,
                schema: Optional[list[str]] = None) -> Block:
        return concat_blocks(self._boxes.get((from_stage, to_stage, partition), []),
                             schema)

    def stream(self, from_stage: int, to_stage: int, partition: int):
        """Chunk-at-a-time receive; in-process all chunks already exist."""
        yield from self._boxes.get((from_stage, to_stage, partition), [])

    def send_partitioned(self, from_stage: int, to_stage: int, block: Block,
                         dist: str, keys: list[str], num_partitions: int,
                         pfunc: Optional[str] = None) -> None:
        if dist == "partitioned" and keys and num_partitions > 1:
            for p, b in enumerate(table_partition(
                    block, keys[0], pfunc, num_partitions)):
                self.send(from_stage, to_stage, p, b)
        elif dist == "hash" and keys and num_partitions > 1:
            for p, b in enumerate(hash_partition(block, keys, num_partitions)):
                self.send(from_stage, to_stage, p, b)
        elif dist == "broadcast":
            for p in range(num_partitions):
                self.send(from_stage, to_stage, p, block)
        else:  # singleton
            self.send(from_stage, to_stage, 0, block)
