"""Per-process family and dispatch telemetry registry.

The port of pinot_tpu/engine/compile_registry.py. Reference analogue: none
in Pinot. It says which executable families this process has dispatched,
what each cost the first time, and how often each is dispatched. Entries
are keyed by the family fingerprint (cache/keys.py `family_fingerprint`:
Program IR + padded bucket + fused variant + LUT runs + batch size, the
identity engine/aot_cache.py persists a family under), so the snapshot
names the families worth persisting, ranked by cost x recent reuse.

What the fields mean in the port. Eager PyTorch compiles no program, so
`compiles` stays 0 for every family (and responses' `numCompiles` is 0).
A family's FIRST dispatch in the process registers it
(`note_first_dispatch`, before it launches): fingerprint plus
`describe_family`, then that dispatch's host wall time as its cold cost in
`compileMsLast` / `compileMsTotal` (`note_cold_cost`), the field the AOT
ranking reads. The cold cost is the
one-time work a restart pays again: the lazy load of the CUDA kernels'
module, the first launch's geometry planning and the first allocations.
A family installed by the AOT prewarm (`note_preloaded`) keeps a cold
cost of 0. `note_compile` is the JAX package's entry, kept for parity.

Cost: the fingerprint, a canonical-bytes walk of the Program IR, is
computed on a family's first dispatch only. Every later dispatch is
`note_dispatch`: one dict lookup and counter bumps, no fingerprint walk,
no span, no device sync, no environment read.
"""

from __future__ import annotations

import os
import threading
import time
from collections import OrderedDict
from typing import Optional

# registry size tracks the compile-cache guard's own limit: an entry per
# live executable family plus headroom for evicted-then-recompiled ones
_MAX_ENTRIES = int(os.environ.get("PINOT_TPU_COMPILE_REGISTRY_MAX", 4096))

# recency window for the dispatch-rate term of the AOT-persist ranking:
# dispatches older than ~2 windows stop contributing, so the priority
# list tracks CURRENT traffic instead of all-time history. The warm path
# pays only an integer epoch compare + counter bump for this (no pow/exp,
# no extra clock read beyond the lastUsed stamp it already takes).
_RECENT_WINDOW_S = float(os.environ.get(
    "PINOT_TPU_COMPILE_RECENT_WINDOW_S", 300.0))


class CompileRegistry:
    """fingerprint → {compiles, compileMs, dispatches, family, lastUsed}."""

    def __init__(self, max_entries: int = _MAX_ENTRIES):
        self.max_entries = int(max_entries)
        self._lock = threading.Lock()
        # family key tuple → fingerprint: the warm-path lookup table. The
        # key is the exact tuple the executor's family guard consumed
        # (engine/executor.py), so a warm dispatch never re-walks the IR.
        self._by_key: dict = {}
        self._entries: "OrderedDict[str, dict]" = OrderedDict()  # LRU

    @staticmethod
    def _bump_recent(ent: dict, now: float) -> None:
        """Two-bucket epoch window: ``recentW`` counts dispatches in the
        current window, ``recentWPrev`` holds the previous window's count.
        On an epoch boundary the buckets shift (skipping ≥2 windows zeroes
        both) — an integer compare + at most two assignments, so the warm
        path stays counter bumps with no pow/exp work."""
        epoch = int(now / _RECENT_WINDOW_S)
        delta = epoch - ent["recentEpoch"]
        if delta:
            ent["recentWPrev"] = ent["recentW"] if delta == 1 else 0
            ent["recentW"] = 0
            ent["recentEpoch"] = epoch
        ent["recentW"] += 1

    def note_compile(self, guard_key, compile_ms: float,
                     fingerprint: Optional[str], family: dict) -> None:
        """Record a compile of ``guard_key`` (the JAX package's entry; the
        port's executor calls note_first_dispatch). ``fingerprint`` is None
        when the Program has no canonical encoding: the family is still
        counted under a key-local pseudo id so the totals stay honest."""
        self._note_cold(guard_key, compile_ms, fingerprint, family, 1)

    def _note_cold(self, guard_key, compile_ms: float,
                   fingerprint: Optional[str], family: dict,
                   compiles: int) -> None:
        fp = fingerprint or f"unfingerprintable:{abs(hash(guard_key)):x}"
        now = time.time()
        with self._lock:
            self._by_key[guard_key] = fp
            ent = self._entries.get(fp)
            if ent is None:
                ent = self._entries[fp] = {
                    "compiles": 0, "compileMsTotal": 0.0,
                    "compileMsLast": 0.0, "dispatches": 0,
                    "firstSeen": round(now, 3), "family": family,
                    "recentW": 0, "recentWPrev": 0,
                    "recentEpoch": int(now / _RECENT_WINDOW_S),
                }
            ent["compiles"] += compiles
            ent["compileMsTotal"] = round(
                ent["compileMsTotal"] + float(compile_ms), 3)
            ent["compileMsLast"] = round(float(compile_ms), 3)
            ent["dispatches"] += 1
            ent["lastUsed"] = round(now, 3)
            self._bump_recent(ent, now)
            self._entries.move_to_end(fp)
            while len(self._entries) > self.max_entries:
                victim, _ = self._entries.popitem(last=False)
                self._by_key = {k: v for k, v in self._by_key.items()
                                if v != victim}

    def note_first_dispatch(self, guard_key, fingerprint: Optional[str],
                            family: dict) -> None:
        """A family's first dispatch in this process, registered as
        `note_compile` registers a compile but with no compile counted,
        and before it launches: a concurrent dispatch of the family on
        another thread then counts. Its cost follows in note_cold_cost."""
        self._note_cold(guard_key, 0.0, fingerprint, family, 0)

    def note_cold_cost(self, guard_key, cold_ms: float) -> None:
        """The first dispatch's host wall time: the family's cold cost."""
        with self._lock:
            ent = self._entries.get(self._by_key.get(guard_key))
            if ent is None:
                return
            ent["compileMsTotal"] = round(
                ent["compileMsTotal"] + float(cold_ms), 3)
            ent["compileMsLast"] = round(float(cold_ms), 3)

    def note_preloaded(self, guard_key, fingerprint: str,
                       family: dict) -> None:
        """The AOT prewarm installed the family ``guard_key``
        (engine/aot_cache.py): teach the registry the key→fingerprint
        edge WITHOUT a cold cost, so the family's dispatches register under
        the persisted family with no IR walk. compileMsLast stays 0: a
        preloaded family never re-persists."""
        now = time.time()
        with self._lock:
            self._by_key[guard_key] = fingerprint
            if fingerprint not in self._entries:
                self._entries[fingerprint] = {
                    "compiles": 0, "compileMsTotal": 0.0,
                    "compileMsLast": 0.0, "dispatches": 0,
                    "firstSeen": round(now, 3), "family": dict(family),
                    "lastUsed": round(now, 3),
                    "recentW": 0, "recentWPrev": 0,
                    "recentEpoch": int(now / _RECENT_WINDOW_S),
                }

    def note_dispatch(self, guard_key) -> None:
        """Warm path: the family was dispatched before. One dict lookup +
        counter bumps; silently ignores keys the registry no longer knows
        (an evicted entry, or a family first dispatched before a
        reset)."""
        with self._lock:
            fp = self._by_key.get(guard_key)
            if fp is None:
                return
            ent = self._entries.get(fp)
            if ent is None:
                return
            now = time.time()
            ent["dispatches"] += 1
            ent["lastUsed"] = round(now, 3)
            self._bump_recent(ent, now)
            self._entries.move_to_end(fp)

    @staticmethod
    def _score(ent: dict, now: float) -> float:
        """AOT-persist priority: compile cost × recent traffic. The
        recency term interpolates the two window buckets (prev bucket
        fades linearly as the current window fills), so a family that
        stopped dispatching decays to bare compile cost within ~2 windows
        while a hot family's score tracks its current dispatch rate."""
        epoch = int(now / _RECENT_WINDOW_S)
        delta = epoch - ent["recentEpoch"]
        if delta == 0:
            frac = (now / _RECENT_WINDOW_S) - epoch
            recent = ent["recentW"] + (1.0 - frac) * ent["recentWPrev"]
        elif delta == 1:
            frac = (now / _RECENT_WINDOW_S) - epoch
            recent = (1.0 - frac) * ent["recentW"]
        else:
            recent = 0.0
        return float(ent["compileMsLast"]) * (1.0 + recent)

    def snapshot(self) -> dict:
        """Per-fingerprint entries (the JAX broker's GET /debug/compiles
        payload) ranked
        by decayed compile-cost × dispatch-recency (the AOT-persist
        priority order — tracks current traffic, not all-time history),
        plus process totals for /metrics. Scores are computed here, at
        scrape time, never on the dispatch path."""
        now = time.time()
        with self._lock:
            entries = {fp: dict(ent, family=dict(ent["family"]),
                                aotScore=round(self._score(ent, now), 3))
                       for fp, ent in self._entries.items()}
        ranked = sorted(entries.items(),
                        key=lambda kv: (-kv[1]["aotScore"],
                                        -kv[1]["compileMsTotal"]))
        out = []
        for fp, ent in ranked:
            ent = dict(ent, fingerprint=fp)
            ent.pop("recentEpoch", None)
            out.append(ent)
        return {
            "families": len(entries),
            "totalCompiles": sum(e["compiles"] for e in entries.values()),
            "totalCompileMs": round(sum(e["compileMsTotal"]
                                        for e in entries.values()), 3),
            "totalDispatches": sum(e["dispatches"]
                                   for e in entries.values()),
            "compiles": out,
        }

    def aot_priority(self) -> list:
        """[(fingerprint, score, family)] best-first: the AOT cache's
        prewarm order. Unfingerprintable families are excluded:
        there is nothing stable to key an on-disk artifact by."""
        now = time.time()
        with self._lock:
            scored = [(fp, self._score(ent, now), dict(ent["family"]))
                      for fp, ent in self._entries.items()
                      if not fp.startswith("unfingerprintable:")]
        scored.sort(key=lambda t: -t[1])
        return scored

    def totals(self) -> dict:
        """Cheap rollup for scrape-time /metrics gauges."""
        with self._lock:
            return {
                "families": len(self._entries),
                "compiles": sum(e["compiles"]
                                for e in self._entries.values()),
                "compileMs": round(sum(e["compileMsTotal"]
                                       for e in self._entries.values()), 3),
            }

    def reset(self) -> None:
        with self._lock:
            self._by_key.clear()
            self._entries.clear()


COMPILE_REGISTRY = CompileRegistry()


def describe_family(program, padded: int, fused: str = "",
                    lut_meta: tuple = (), batch_size: int = 0) -> dict:
    """Human-readable family shape for the registry entry."""
    return {
        "mode": getattr(program, "mode", "?"),
        "padded": int(padded),
        "fused": str(fused),
        "lutRuns": len(lut_meta) if lut_meta else 0,
        "batchSize": int(batch_size),
    }
