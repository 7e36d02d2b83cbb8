"""Segment partial-result cache (cache tier 2, host side).

The port of pinot_tpu/cache/partial.py: a map from (program fingerprint,
segment token) (cache/keys.py) to a segment's partial, an AggIntermediate
or a GroupByIntermediate. Segments are immutable and the fingerprint folds
in every result-affecting input, so a hit is exactly what the device would
recompute: the executor skips the segment's dispatch and feeds the
combine.

Values are deep-copied on both put and get: engine/combine.py merges into
its first intermediate in place, so a shared cached object would be
corrupted on the second merge.

The sparse device combine's per-segment tables stay on the device, in
segment/device_cache.py under its byte budget; this tier holds host objects
under its own (PINOT_TPU_PARTIAL_CACHE_MB, default 256). Counters live on
the cache (`stats()`); an eviction also counts the JAX package's server
meter `segmentCacheEvictions`.
"""

from __future__ import annotations

import copy
import os
import threading
from collections import OrderedDict
from typing import Optional

from ..spi.metrics import SERVER_METRICS, ServerMeter


def partial_cache_enabled() -> bool:
    """On by default; PINOT_TPU_SEGMENT_CACHE=0 turns it off process-wide
    (read on every call; per query: `SET segmentCache = false`)."""
    return os.environ.get("PINOT_TPU_SEGMENT_CACHE", "1") \
        not in ("0", "false", "")


def _default_budget() -> int:
    return int(float(os.environ.get("PINOT_TPU_PARTIAL_CACHE_MB", 256))
               * (1 << 20))


def estimate_partial_bytes(inter) -> int:
    """Footprint estimate for the byte budget: the arrays' bytes of a
    columnar group table, 64 B a state of the object forms."""
    from ..engine.results import (AggIntermediate, GroupArrays,
                                  GroupByIntermediate)

    if isinstance(inter, GroupArrays):
        return (sum(k.nbytes for k in inter.key_cols)
                + sum(c.nbytes for comps in inter.state_cols for c in comps)
                + 64)
    if isinstance(inter, GroupByIntermediate):
        width = 1 + max((len(v) for v in inter.groups.values()), default=0)
        return 64 * width * max(1, len(inter.groups))
    if isinstance(inter, AggIntermediate):
        return 64 * max(1, len(inter.states))
    return 256


class SegmentPartialCache:
    """LRU, byte-budgeted map of (program_fp, segment_token) -> partial.
    Thread-safe (the multi-stage engine runs leaf stages on threads).
    Entries remember the segment names that fed them, so a lineage event
    can drop them by name."""

    def __init__(self, max_bytes: Optional[int] = None):
        self.max_bytes = _default_budget() if max_bytes is None else max_bytes
        # key -> (value, nbytes, segment_names)
        self._entries: OrderedDict[tuple, tuple] = OrderedDict()
        self._bytes = 0
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def get(self, key: tuple):
        with self._lock:
            ent = self._entries.get(key)
            if ent is None:
                self.misses += 1
                return None
            self._entries.move_to_end(key)
            self.hits += 1
            value = ent[0]
        return copy.deepcopy(value)

    def put(self, key: tuple, value, segment_names: tuple) -> None:
        stored = copy.deepcopy(value)
        nbytes = estimate_partial_bytes(stored)
        with self._lock:
            if nbytes > self.max_bytes:
                return
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= old[1]
            self._entries[key] = (stored, nbytes, tuple(segment_names))
            self._bytes += nbytes
            while self._bytes > self.max_bytes and len(self._entries) > 1:
                _, (_, freed, _) = self._entries.popitem(last=False)
                self._bytes -= freed
                self.evictions += 1
                SERVER_METRICS.add_meter(ServerMeter.SEGMENT_CACHE_EVICTIONS)

    def invalidate_segment(self, segment_name: str) -> int:
        """Drop every entry derived from `segment_name`. Content-addressed
        keys make a stale hit impossible anyway; this frees the bytes."""
        with self._lock:
            stale = [k for k, ent in self._entries.items()
                     if segment_name in ent[2]]
            for k in stale:
                self._bytes -= self._entries.pop(k)[1]
            return len(stale)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._bytes = 0

    def stats(self) -> dict:
        with self._lock:
            return {"entries": len(self._entries), "bytes": self._bytes,
                    "maxBytes": self.max_bytes, "hits": self.hits,
                    "misses": self.misses, "evictions": self.evictions}


GLOBAL_PARTIAL_CACHE = SegmentPartialCache()
