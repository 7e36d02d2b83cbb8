"""Broker result cache (cache tier 3) and table lineage epochs.

The port of pinot_tpu/cache/results.py: a TTL- and byte-budgeted LRU of
BrokerResponses. The multi-stage executor keys it by its plan fingerprint
and every scanned segment's token (mse/executor.py), so a replaced segment
changes the key. The cluster broker (cluster/broker.py) keys it by the
query's fingerprint and the table's **lineage epoch**: a counter in the
property store (``/CACHEEPOCH/{tableNameWithType}``) that the controller
bumps on every segment add, drop and replace (cluster/controller.py), so a
bumped epoch makes every older key of the table unreachable. Entries
expire by TTL (PINOT_TPU_RESULT_CACHE_TTL_S, default 300) and a byte
budget (PINOT_TPU_RESULT_CACHE_MB, default 64); the clock is injectable.
"""

from __future__ import annotations

import copy
import os
import threading
import time
from collections import OrderedDict
from typing import Optional

from ..spi.metrics import BROKER_METRICS, BrokerMeter

EPOCH_PREFIX = "/CACHEEPOCH"


def result_cache_enabled() -> bool:
    """On by default; PINOT_TPU_RESULT_CACHE=0 turns it off process-wide
    (per statement: `SET resultCache = false`)."""
    return os.environ.get("PINOT_TPU_RESULT_CACHE", "1") \
        not in ("0", "false", "")


def lineage_epoch(store, name_with_type: str) -> int:
    """Current lineage epoch for a table (0 = never bumped)."""
    return int(store.get(f"{EPOCH_PREFIX}/{name_with_type}") or 0)


def bump_lineage_epoch(store, name_with_type: str) -> None:
    """Advance the table's epoch: every broker result-cache key derived
    from the old epoch becomes unreachable at once."""
    store.update(f"{EPOCH_PREFIX}/{name_with_type}",
                 lambda cur: int(cur or 0) + 1)


def _estimate_response_bytes(resp) -> int:
    rt = getattr(resp, "result_table", None)
    if rt is None:
        return 512
    width = max(1, len(getattr(rt, "rows", None) and rt.rows[0] or ()))
    return 512 + 48 * width * len(rt.rows)


class BrokerResultCache:
    """TTL + byte-budgeted LRU of BrokerResponses."""

    def __init__(self, max_bytes: Optional[int] = None,
                 ttl_s: Optional[float] = None, clock=time.monotonic):
        if max_bytes is None:
            max_bytes = int(float(os.environ.get(
                "PINOT_TPU_RESULT_CACHE_MB", 64)) * (1 << 20))
        if ttl_s is None:
            ttl_s = float(os.environ.get("PINOT_TPU_RESULT_CACHE_TTL_S", 300))
        self.max_bytes = max_bytes
        self.ttl_s = ttl_s
        self._clock = clock
        # key -> (response, nbytes, inserted_at)
        self._entries: OrderedDict[tuple, tuple] = OrderedDict()
        self._bytes = 0
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def get(self, key: tuple):
        """A shallow copy: the caller restamps per-request fields
        (time_used_ms) without touching the cached object; the result
        table is shared read-only."""
        with self._lock:
            ent = self._entries.get(key)
            if ent is not None and self._clock() - ent[2] > self.ttl_s:
                self._entries.pop(key)
                self._bytes -= ent[1]
                ent = None
            if ent is None:
                self.misses += 1
                return None
            self._entries.move_to_end(key)
            self.hits += 1
            return copy.copy(ent[0])

    def put(self, key: tuple, resp) -> None:
        nbytes = _estimate_response_bytes(resp)
        with self._lock:
            if nbytes > self.max_bytes:
                return
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= old[1]
            self._entries[key] = (copy.copy(resp), nbytes, self._clock())
            self._bytes += nbytes
            while self._bytes > self.max_bytes and len(self._entries) > 1:
                _, (_, freed, _) = self._entries.popitem(last=False)
                self._bytes -= freed
                self.evictions += 1
                BROKER_METRICS.add_meter(BrokerMeter.RESULT_CACHE_EVICTIONS)

    def clear(self) -> int:
        with self._lock:
            n = len(self._entries)
            self._entries.clear()
            self._bytes = 0
            return n

    def stats(self) -> dict:
        with self._lock:
            return {"entries": len(self._entries), "bytes": self._bytes,
                    "maxBytes": self.max_bytes, "ttlS": self.ttl_s,
                    "hits": self.hits, "misses": self.misses,
                    "evictions": self.evictions}
