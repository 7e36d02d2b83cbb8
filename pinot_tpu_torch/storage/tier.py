"""SegmentTierManager: the byte-budgeted local storage tier.

The port of pinot_tpu/storage/tier.py. Every locally materialized segment
directory on a server goes through ``acquire()``: the converge-time eager
load, the first-query cold load and ``repair_segment``'s fresh
re-fetches. That gives the server ONE byte budget (the server's
``local_storage_mb``) accounting for all of them.

Semantics:

* Plain-directory locations (the deep store IS a local dir) are served
  in place: no copy, no bytes charged, never evicted here.
* Tarball locations (``.tar.gz`` / ``.tgz``, a local path or any URI a
  registered PinotFS serves: ``file://``, ``s3://``, ...) are fetched
  through ``spi/filesystem.get_fs`` and untarred (``ingestion/batch.py``
  ``untar_segment``) into a per-instance tier directory and
  charged their on-disk size. When the budget is exceeded, the manager
  evicts least-recently-used entries first, weighted by table heat
  (hot and pinned tables go last), calling ``evict_cb`` so the server can
  demote the segment to metadata-only (cold) state.
* Readers pin entries via ``reading()`` / ``pin()``: an entry with live
  refs is never deleted under a scan. Eviction defers the directory
  removal, and the ``destroy()`` of what ``evict_cb`` returned (on the
  server: the release of the segment's device planes and family stacks),
  until the last reader releases, so there is no ENOENT mid-query and no
  stack freed under a launch.
* ``fresh=True`` (repair) fetches into a brand-new directory; the old
  copy becomes a zombie reclaimed when its readers drain, so a damaged
  copy is never reused and never yanked from under a reader.

``TIER_PROBES`` is a module-level disk-operation counter: every untar
fetch, directory size walk and directory removal bumps it, so tests can
pin the warm resident query path to ZERO added disk work.

The JAX package reads its budget and hot TTL from
PINOT_TPU_LOCAL_STORAGE_MB and PINOT_TPU_HOT_TABLE_TTL_S; here they are
constructor arguments with the defaults of those variables unset (no
budget, 60 s). The copies go under a fresh temporary directory (the JAX
package's default; its PINOT_TPU_STORAGE_DIR has no counterpart).
``clock`` is injectable for the hot TTL and the LRU.
"""

from __future__ import annotations

import logging
import os
import shutil
import tempfile
import threading
import time
from contextlib import contextmanager
from typing import Callable, Optional

log = logging.getLogger(__name__)

# disk-operation counter for the perf guard: fetches + size walks +
# removals. The warm resident path must not move it at all.
TIER_PROBES = 0

# prefetch nudges mark a table hot for this long; explicit pins have no TTL
HOT_TTL_S = 60.0


def _bump_probes(n: int = 1) -> None:
    global TIER_PROBES
    TIER_PROBES += n


def _dir_bytes(path: str) -> int:
    _bump_probes()
    total = 0
    for root, _dirs, files in os.walk(path):
        for f in files:
            try:
                total += os.stat(os.path.join(root, f)).st_size
            except OSError:
                pass
    return total


class _Entry:
    """One locally materialized (untarred) segment directory."""

    __slots__ = ("table", "segment", "path", "root", "nbytes", "refs",
                 "last_used", "evicting", "segment_obj")

    def __init__(self, table: str, segment: str, path: str, root: str,
                 nbytes: int, tick: float):
        self.table = table
        self.segment = segment
        self.path = path          # the segment directory handed to the loader
        self.root = root          # the unique parent dir we rmtree on release
        self.nbytes = nbytes
        self.refs = 0
        self.last_used = tick
        self.evicting = False
        self.segment_obj = None   # set at evict time; destroyed on release


def _is_tar(location: str) -> bool:
    return str(location).endswith((".tar.gz", ".tgz"))


class SegmentTierManager:
    """Byte-budgeted local cache of segment directories (the disk tier)."""

    def __init__(self, instance_id: str = "server",
                 budget_mb: Optional[float] = None,
                 evict_cb: Optional[Callable] = None,
                 heat_fn: Optional[Callable[[], dict]] = None,
                 hot_ttl_s: float = HOT_TTL_S,
                 clock: Callable[[], float] = time.monotonic):
        self.instance_id = instance_id
        self.budget_bytes: Optional[int] = (
            int(float(budget_mb) * 1024 * 1024) if budget_mb else None)
        # evict_cb(table, segment) -> object with destroy() | None: the
        # server demotes the segment to cold metadata and returns what to
        # release (its device planes and stacks) once readers drain
        self.evict_cb = evict_cb
        # heat_fn() -> {table: cost_ms}; consulted ONLY at eviction time
        self.heat_fn = heat_fn
        self._lock = threading.RLock()
        self._entries: dict[tuple, _Entry] = {}   # (table, segment) -> entry
        self._zombies: list[_Entry] = []          # evicted, readers still on
        self._used = 0
        self._seq = 0
        self._base: Optional[str] = None
        self._clock = clock
        self._pinned: set[str] = set()            # explicit pins, no TTL
        self._hot: dict[str, float] = {}          # table -> hot-until (mono)
        self._hot_ttl = float(hot_ttl_s)
        self._evictions = 0
        self._fetches = 0

    # -- configuration ----------------------------------------------------

    def should_lazy_load(self) -> bool:
        """True when a not-yet-local segment should be registered cold
        (metadata-only) instead of eagerly fetched at converge time."""
        with self._lock:
            return (self.budget_bytes is not None
                    and self._used >= self.budget_bytes)

    def headroom(self) -> bool:
        """True while prefetch warming may fetch without causing evictions."""
        with self._lock:
            return (self.budget_bytes is None
                    or self._used < self.budget_bytes)

    # -- fetch / lookup ---------------------------------------------------

    def _base_dir(self) -> str:
        with self._lock:
            if self._base is None:
                self._base = tempfile.mkdtemp(
                    prefix=f"{self.instance_id}_tier_")
            return self._base

    def acquire(self, table: str, segment: str, location: str,
                fresh: bool = False, hold: bool = False) -> str:
        """Return a local directory for the segment, fetching if needed.

        Plain-dir locations are returned as-is (zero bytes charged).
        ``fresh=True`` always fetches a new copy (repair path) — the old
        entry, if any, is retired without being yanked from readers.
        ``hold=True`` returns with one reader ref already taken (drop it
        with ``release()``): the fetch→load window reads the directory by
        path, and a concurrent fetch's eviction pass must not reclaim it
        in between — nor may a budget smaller than one segment evict the
        copy being loaded out from under its own loader.
        """
        if not _is_tar(location):
            return str(location)
        key = (table, segment)
        with self._lock:
            e = self._entries.get(key)
            if e is not None and not fresh and not e.evicting:
                e.last_used = self._clock()
                if hold:
                    e.refs += 1
                return e.path
        # fetch OUTSIDE the lock: untar + size walk are the slow parts
        from ..ingestion.batch import untar_segment
        with self._lock:
            self._seq += 1
            seq = self._seq
        root = os.path.join(self._base_dir(), f"{table}__{segment}__{seq}")
        os.makedirs(root, exist_ok=True)
        _bump_probes()
        path = untar_segment(location, root)
        nbytes = _dir_bytes(root)
        entry = _Entry(table, segment, path, root, nbytes, self._clock())
        if hold:
            entry.refs = 1
        retired = None
        with self._lock:
            self._fetches += 1
            old = self._entries.get(key)
            if old is not None:
                # fresh re-fetch replaces a (possibly damaged) copy: never
                # reuse it, never delete it under a reader
                old.evicting = True
                self._used -= old.nbytes
                retired = old
                del self._entries[key]
            self._entries[key] = entry
            self._used += nbytes
        if retired is not None:
            self._release_if_idle(retired)
        self._make_room()
        return entry.path

    def release(self, table: str, segment: str) -> None:
        """Drop the reader ref taken by ``acquire(hold=True)``. Looks the
        entry up by key — including among zombies, for a copy evicted (or
        replaced by a fresh re-fetch) while its loader still held it."""
        with self._lock:
            e = self._entries.get((table, segment))
            if e is None or e.refs <= 0:
                e = next((z for z in self._zombies
                          if z.table == table and z.segment == segment
                          and z.refs > 0), e)
            if e is None or e.refs <= 0:
                return
        self.unpin([e])

    # -- reader refcounts -------------------------------------------------

    def pin(self, table: str, names) -> list:
        """Pin segment entries for the duration of a scan (memory-only:
        zero TIER_PROBES). Names without a tier entry (plain-dir deep
        store) are no-ops."""
        handles = []
        tick = self._clock()
        with self._lock:
            for name in names:
                e = self._entries.get((table, name))
                if e is not None:
                    e.refs += 1
                    e.last_used = tick
                    handles.append(e)
        return handles

    def unpin(self, handles) -> None:
        drained = []
        with self._lock:
            for e in handles:
                e.refs -= 1
                if e.evicting and e.refs <= 0:
                    drained.append(e)
        for e in drained:
            self._release_if_idle(e)

    @contextmanager
    def reading(self, table: str, names):
        """``with tier.reading(table, names):`` — no ENOENT mid-scan."""
        handles = self.pin(table, names)
        try:
            yield handles
        finally:
            self.unpin(handles)

    # -- heat / pinning ---------------------------------------------------

    def pin_table(self, table: str) -> None:
        with self._lock:
            self._pinned.add(table)

    def unpin_table(self, table: str) -> None:
        with self._lock:
            self._pinned.discard(table)

    def note_hot(self, table: str) -> None:
        """Mark a table hot (prefetch nudge); expires after the hot TTL."""
        with self._lock:
            self._hot[table] = self._clock() + self._hot_ttl

    def _hot_tables(self) -> set:
        now = self._clock()
        with self._lock:
            self._hot = {t: u for t, u in self._hot.items() if u > now}
            return self._pinned | set(self._hot)

    # -- eviction ---------------------------------------------------------

    def _heat(self) -> dict:
        if self.heat_fn is None:
            return {}
        try:
            return {str(t): float(c) for t, c in (self.heat_fn() or {}).items()}
        except Exception:
            return {}

    def _pick_victim(self, hot: set, heat: dict) -> Optional[_Entry]:
        candidates = [e for e in self._entries.values()
                      if not e.evicting and e.refs <= 0]
        if not candidates:
            return None
        cool = [e for e in candidates if e.table not in hot]
        pool = cool or candidates  # pinned/hot only as a last resort
        return min(pool, key=lambda e: (heat.get(e.table, 0.0), e.last_used))

    def _make_room(self) -> None:
        """Evict LRU (heat-weighted) entries until used <= budget. Entries
        with live readers are skipped, so disk transiently holds at most
        budget + the in-flight fetch."""
        if self.budget_bytes is None:
            return
        hot = heat = None
        while True:
            with self._lock:
                if self._used <= self.budget_bytes:
                    return
            if hot is None:
                hot, heat = self._hot_tables(), self._heat()
            with self._lock:
                victim = self._pick_victim(hot, heat)
                if victim is None:
                    return
                victim.evicting = True
                self._used -= victim.nbytes
                del self._entries[(victim.table, victim.segment)]
                self._evictions += 1
            if self.evict_cb is not None:
                try:
                    victim.segment_obj = self.evict_cb(victim.table,
                                                       victim.segment)
                except Exception:
                    # the directory still goes: the server keeps serving
                    # the loaded object it holds (its mapped file stays
                    # readable after the unlink)
                    log.exception("%s: evict callback for %s/%s failed",
                                  self.instance_id, victim.table,
                                  victim.segment)
                    victim.segment_obj = None
            self._release_if_idle(victim)

    def _release_if_idle(self, entry: _Entry) -> None:
        with self._lock:
            if entry.refs > 0:
                if entry not in self._zombies:
                    self._zombies.append(entry)
                return
            if entry in self._zombies:
                self._zombies.remove(entry)
        self._finalize(entry)

    def _finalize(self, entry: _Entry) -> None:
        seg = entry.segment_obj
        entry.segment_obj = None
        if seg is not None:
            try:
                seg.destroy()
            except Exception:
                log.exception("%s: release of evicted %s/%s failed",
                              self.instance_id, entry.table, entry.segment)
        _bump_probes()
        shutil.rmtree(entry.root, ignore_errors=True)

    def forget(self, table: str, segment: str) -> None:
        """Drop the local copy of a departed segment (converge to_drop):
        no evict_cb (the server already removed it), reader-safe."""
        with self._lock:
            e = self._entries.pop((table, segment), None)
            if e is None:
                return
            e.evicting = True
            self._used -= e.nbytes
        self._release_if_idle(e)

    # -- observability / lifecycle ----------------------------------------

    def stats(self) -> dict:
        with self._lock:
            pending = sum(e.nbytes for e in self._zombies)
            return {
                "budgetBytes": self.budget_bytes,
                "bytesUsed": self._used,
                "residentDirs": len(self._entries),
                "pendingRelease": len(self._zombies),
                "pendingReleaseBytes": pending,
                "evictions": self._evictions,
                "fetches": self._fetches,
                "pinnedTables": sorted(self._pinned),
                "hotTables": sorted(self._hot),
                "baseDir": self._base,
                "tierProbes": TIER_PROBES,
            }

    def resident(self, table: str, segment: str) -> bool:
        with self._lock:
            e = self._entries.get((table, segment))
            return e is not None and not e.evicting

    def close(self) -> None:
        """Release every local copy (server stop). Fixes the old leak of
        per-instance ``_seg``/``_repair`` temp dirs that were never
        removed."""
        with self._lock:
            entries = list(self._entries.values()) + list(self._zombies)
            self._entries.clear()
            self._zombies.clear()
            self._used = 0
            base, self._base = self._base, None
        for e in entries:
            self._finalize(e)
        if base is not None:
            _bump_probes()
            shutil.rmtree(base, ignore_errors=True)
