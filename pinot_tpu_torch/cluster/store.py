"""Property store: hierarchical versioned JSON store with watches.

The port's copy of pinot_tpu/cluster/store.py.

Reference analogue: ZooKeeper as used by Helix — the property store under
`/PROPERTYSTORE`, ideal states under `/IDEALSTATES`, external views, live
instances (SURVEY.md §2.10 control plane). Single-process implementation
with the same semantics the cluster code needs: compare-and-set versioning,
ephemeral entries tied to a session, and subtree watches delivered
synchronously (tests) or via a notifier thread.

Durability (optional ``data_dir``): ZooKeeper survives process death by
journaling every transaction before acking it; the in-memory default here
vaporizes ideal states, segment DONE records, and lineage epochs on
restart. With a ``data_dir`` the store becomes crash-consistent the same
way: every persistent mutation is appended to ``store.journal`` as a
length+crc32-framed JSON record BEFORE it is applied in memory
(write-ahead ordering), the journal is compacted into an atomically
replaced ``store.snapshot`` past a size threshold, and construction
recovers snapshot+journal, truncating a torn tail at the first bad frame.
CAS versions ride inside the records, so compare-and-set picks up exactly
where it left off across a restart. Ephemeral entries are session-scoped
by definition and are never journaled — a restarted store comes up with
no live instances and no leader, exactly like a fresh ZK session space.

Fsync policy (``PINOT_TPU_STORE_FSYNC`` or the ``fsync`` ctor arg):
``always`` fsyncs after every append (ZK ``forceSync=yes``), ``batch``
flushes per append but fsyncs only on snapshot/close, ``off`` never
fsyncs. Frame format: ``<u32 len><u32 crc32>``
followed by the JSON payload, crc over the payload bytes.
"""

from __future__ import annotations

import json
import os
import struct
import threading
import zlib
from dataclasses import dataclass
from typing import Any, Callable, Optional

from ..spi import faults
from ..spi.metrics import CONTROLLER_METRICS, ControllerGauge, ControllerMeter

# Module-level instrumentation counters (perf-guard pins: an in-memory
# store must never append/fsync; a durable store must not write on reads).
JOURNAL_APPENDS = 0
FSYNC_CALLS = 0

# frame header: payload length, crc32(payload) — little-endian u32 pair
_FRAME = struct.Struct("<II")

_JOURNAL_FILE = "store.journal"
_SNAPSHOT_FILE = "store.snapshot"

_FSYNC_POLICIES = ("always", "batch", "off")
_SNAPSHOT_BYTES = 1 << 20


class StoreError(Exception):
    pass


class BadVersionError(StoreError):
    """Compare-and-set failed (reference: ZK BadVersionException)."""


@dataclass
class _Entry:
    value: Any
    version: int = 0
    ephemeral_owner: Optional[str] = None


def _frame(payload: bytes) -> bytes:
    return _FRAME.pack(len(payload), zlib.crc32(payload)) + payload


class PropertyStore:
    """Path → JSON-value store. Paths are '/'-separated strings."""

    def __init__(self, data_dir: Optional[str] = None,
                 fsync: str = "batch"):
        self._lock = threading.RLock()
        self._data: dict[str, _Entry] = {}
        self._watches: list[tuple[str, Callable[[str, Optional[Any]], None]]] = []
        # -- durability state --------------------------------------------
        self._data_dir = str(data_dir) if data_dir is not None else None
        self._journal = None
        self._journal_bytes = 0
        self.recoveries = 0
        self.truncations = 0
        self.snapshots = 0
        if self._data_dir is None:
            return
        self._fsync_policy = fsync
        if self._fsync_policy not in _FSYNC_POLICIES:
            raise StoreError(f"bad fsync policy {self._fsync_policy!r} "
                             f"(one of {_FSYNC_POLICIES})")
        os.makedirs(self._data_dir, exist_ok=True)
        self._journal_path = os.path.join(self._data_dir, _JOURNAL_FILE)
        self._snapshot_path = os.path.join(self._data_dir, _SNAPSHOT_FILE)
        self._recover()
        self._journal = open(self._journal_path, "ab")
        self._journal_bytes = self._journal.tell()
        CONTROLLER_METRICS.set_gauge(ControllerGauge.STORE_JOURNAL_BYTES,
                                     lambda: float(self._journal_bytes))

    @property
    def durable(self) -> bool:
        return self._journal is not None

    # -- basic ops ---------------------------------------------------------
    def set(self, path: str, value: Any, expected_version: int = -1,
            ephemeral_owner: Optional[str] = None) -> int:
        """Set value; expected_version ≥ 0 makes it a compare-and-set.
        Returns the new version."""
        if faults.ACTIVE:
            faults.FAULTS.fire("store.write", path=path)
        json.dumps(value)  # enforce JSON-serializable (ZK stores bytes)
        with self._lock:
            cur = self._data.get(path)
            if expected_version >= 0:
                curv = cur.version if cur is not None else -1
                if curv != expected_version:
                    raise BadVersionError(
                        f"{path}: expected v{expected_version}, have v{curv}")
            newv = (cur.version + 1) if cur is not None else 0
            if self._journal is not None:
                if ephemeral_owner is None:
                    self._append({"op": "set", "path": path, "value": value,
                                  "version": newv})
                elif cur is not None and cur.ephemeral_owner is None:
                    # persistent entry shadowed by an ephemeral one: the
                    # journal must forget the old persistent value or a
                    # restart would resurrect it past the session death
                    self._append({"op": "delete", "path": path})
            self._data[path] = _Entry(value, newv, ephemeral_owner)
            self._maybe_compact()
        self._notify(path, value)
        return newv

    def create_if_absent(self, path: str, value: Any,
                         ephemeral_owner: Optional[str] = None) -> bool:
        """Atomic exclusive create (ZK create with EPHEMERAL flag): True if
        this call created the entry, False if it already existed."""
        if faults.ACTIVE:
            faults.FAULTS.fire("store.write", path=path)
        json.dumps(value)
        with self._lock:
            if path in self._data:
                return False
            if self._journal is not None and ephemeral_owner is None:
                self._append({"op": "set", "path": path, "value": value,
                              "version": 0})
            self._data[path] = _Entry(value, 0, ephemeral_owner)
            self._maybe_compact()
        self._notify(path, value)
        return True

    def get(self, path: str) -> Optional[Any]:
        with self._lock:
            e = self._data.get(path)
            return None if e is None else e.value

    def get_with_version(self, path: str) -> tuple[Optional[Any], int]:
        with self._lock:
            e = self._data.get(path)
            return (None, -1) if e is None else (e.value, e.version)

    def delete(self, path: str) -> bool:
        with self._lock:
            e = self._data.pop(path, None)
            existed = e is not None
            if existed and self._journal is not None and e.ephemeral_owner is None:
                self._append({"op": "delete", "path": path})
                self._maybe_compact()
        if existed:
            self._notify(path, None)
        return existed

    def delete_if(self, path: str,
                  predicate: Callable[[Any], bool]) -> bool:
        """Atomic conditional delete: remove ``path`` only if it exists and
        ``predicate(value)`` holds, all under one lock (ZK's versioned
        delete). Closes the get→check→delete race in graceful leader
        resignation, where a concurrent expiry + standby claim between the
        get and the delete would delete the NEW leader's entry."""
        if faults.ACTIVE:
            faults.FAULTS.fire("store.write", path=path)
        with self._lock:
            e = self._data.get(path)
            if e is None or not predicate(e.value):
                return False
            del self._data[path]
            if self._journal is not None and e.ephemeral_owner is None:
                self._append({"op": "delete", "path": path})
                self._maybe_compact()
        self._notify(path, None)
        return True

    def children(self, prefix: str) -> list[str]:
        """Direct child names under prefix (ZK getChildren)."""
        prefix = prefix.rstrip("/") + "/"
        with self._lock:
            names = set()
            for p in self._data:
                if p.startswith(prefix):
                    names.add(p[len(prefix):].split("/", 1)[0])
            return sorted(names)

    def list_paths(self, prefix: str) -> list[str]:
        with self._lock:
            return sorted(p for p in self._data if p.startswith(prefix))

    # -- ephemerals / sessions ---------------------------------------------
    def expire_session(self, owner: str) -> None:
        """Drop all ephemeral entries owned by a session (instance death).
        Nothing to journal: ephemerals are never persisted."""
        with self._lock:
            dead = [p for p, e in self._data.items() if e.ephemeral_owner == owner]
            for p in dead:
                del self._data[p]
        for p in dead:
            self._notify(p, None)

    # -- watches -----------------------------------------------------------
    def watch(self, prefix: str, callback: Callable[[str, Optional[Any]], None]) -> None:
        """callback(path, new_value_or_None) on every change under prefix.
        Persistent (unlike raw ZK one-shot watches; Helix re-registers —
        this is the post-re-registration behavior)."""
        with self._lock:
            self._watches.append((prefix, callback))

    def unwatch(self, callback: Callable) -> None:
        """Remove every watch registered with this callback. A stopped
        component MUST unregister, or the store pins it (and everything it
        references — loaded segments, sockets) for the store's lifetime:
        a real fd/memory leak under server churn (reference analogue: ZK
        watcher removal on Helix disconnect)."""
        with self._lock:
            # equality, not identity: bound methods are re-created per
            # access, so `is` would never match
            self._watches = [(p, cb) for p, cb in self._watches
                             if cb != callback]

    def _notify(self, path: str, value: Optional[Any]) -> None:
        with self._lock:
            targets = [cb for prefix, cb in self._watches if path.startswith(prefix)]
        for cb in targets:
            cb(path, value)

    # -- transactional helpers ---------------------------------------------
    def update(self, path: str, fn: Callable[[Optional[Any]], Any],
               max_retries: int = 20) -> Any:
        """Read-modify-write with CAS retry (Helix's ZkBaseDataAccessor
        update pattern)."""
        for _ in range(max_retries):
            cur, version = self.get_with_version(path)
            new = fn(json.loads(json.dumps(cur)) if cur is not None else None)
            try:
                self.set(path, new, expected_version=version)
                return new
            except BadVersionError:
                continue
        raise StoreError(f"update contention on {path}")

    # -- durability ---------------------------------------------------------
    def _append(self, record: dict) -> None:
        """Write-ahead append: called under self._lock BEFORE the in-memory
        mutation, so a crash between append and apply leaves a journal that
        is ahead of (never behind) the acked state — replay is idempotent.

        ``store.journal`` fault semantics: an ``error`` spec fires AFTER
        the frame hits the file (crash-after-append-before-notify — the
        caller sees a failure but recovery replays the record); a
        ``corrupt`` spec damages the frame bytes on disk while memory
        proceeds normally (torn write / bitflip — recovery truncates
        there)."""
        global JOURNAL_APPENDS
        payload = json.dumps(record, separators=(",", ":")).encode()
        frame = _frame(payload)
        crash: Optional[BaseException] = None
        if faults.ACTIVE:
            try:
                faults.FAULTS.fire("store.journal", path=record.get("path"))
            except faults.InjectedCorruption as c:
                frame = faults.corrupt_bytes(frame, c.mode, c.seed, c.index)
            except faults.InjectedFault as e:
                crash = e
        self._journal.write(frame)
        self._journal.flush()
        JOURNAL_APPENDS += 1
        self._journal_bytes += len(frame)
        if self._fsync_policy == "always":
            self._do_fsync(self._journal)
        if crash is not None:
            raise crash

    def _maybe_compact(self) -> None:
        """Called under self._lock AFTER the in-memory apply — compacting
        inside _append would snapshot a _data that doesn't yet hold the
        record that crossed the threshold, silently dropping it."""
        if (self._journal is not None
                and self._journal_bytes >= _SNAPSHOT_BYTES):
            self._compact()

    @staticmethod
    def _do_fsync(f) -> None:
        global FSYNC_CALLS
        os.fsync(f.fileno())
        FSYNC_CALLS += 1

    def _compact(self) -> None:
        """Snapshot + journal reset (atomic tmp+replace, the
        ``_save_checkpoints`` idiom). Called under self._lock."""
        entries = {p: {"value": e.value, "version": e.version}
                   for p, e in self._data.items()
                   if e.ephemeral_owner is None}
        payload = json.dumps({"entries": entries},
                             separators=(",", ":")).encode()
        tmp = self._snapshot_path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(_frame(payload))
            f.flush()
            if self._fsync_policy != "off":
                self._do_fsync(f)
        os.replace(tmp, self._snapshot_path)
        self._journal.close()
        self._journal = open(self._journal_path, "wb")
        self._journal_bytes = 0
        self.snapshots += 1
        CONTROLLER_METRICS.add_meter(ControllerMeter.STORE_SNAPSHOTS)

    def _recover(self) -> None:
        """Load snapshot (strict: snapshot writes are atomic, so a bad one
        is real corruption) then replay the journal, truncating at the
        first bad frame (torn tail from a crash or an injected bitflip)."""
        had_state = False
        if os.path.exists(self._snapshot_path):
            had_state = True
            with open(self._snapshot_path, "rb") as f:
                blob = f.read()
            payload = self._parse_frame(blob, 0)
            if payload is None:
                raise StoreError(
                    f"corrupt snapshot {self._snapshot_path} — snapshot "
                    "writes are atomic; refusing to guess at state")
            for p, rec in json.loads(payload)["entries"].items():
                self._data[p] = _Entry(rec["value"], rec["version"])
        if os.path.exists(self._journal_path):
            with open(self._journal_path, "rb") as f:
                blob = f.read()
            had_state = had_state or bool(blob)
            off = 0
            while off < len(blob):
                payload = self._parse_frame(blob, off)
                if payload is None:
                    # torn tail: keep everything before the bad frame,
                    # drop it and whatever follows
                    with open(self._journal_path, "r+b") as f:
                        f.truncate(off)
                    self.truncations += 1
                    CONTROLLER_METRICS.add_meter(
                        ControllerMeter.STORE_JOURNAL_TRUNCATIONS)
                    break
                rec = json.loads(payload)
                if rec["op"] == "set":
                    self._data[rec["path"]] = _Entry(rec["value"],
                                                     rec["version"])
                elif rec["op"] == "delete":
                    self._data.pop(rec["path"], None)
                off += _FRAME.size + len(payload)
        if had_state:
            self.recoveries += 1
            CONTROLLER_METRICS.add_meter(ControllerMeter.STORE_RECOVERIES)

    @staticmethod
    def _parse_frame(blob: bytes, off: int) -> Optional[bytes]:
        """Payload at ``off`` if header, length, crc, and JSON all check
        out; None for any damage (caller truncates there)."""
        if off + _FRAME.size > len(blob):
            return None
        length, crc = _FRAME.unpack_from(blob, off)
        start = off + _FRAME.size
        payload = blob[start:start + length]
        if len(payload) != length or zlib.crc32(payload) != crc:
            return None
        try:
            json.loads(payload)
        except ValueError:
            return None
        return payload

    def durability_stats(self) -> dict:
        """`GET /debug/store` payload: journal/snapshot/recovery state."""
        with self._lock:
            return {
                "durable": self.durable,
                "dataDir": self._data_dir,
                "fsyncPolicy": getattr(self, "_fsync_policy", None),
                "journalBytes": self._journal_bytes,
                "snapshotCount": self.snapshots,
                "recoveryCount": self.recoveries,
                "journalTruncations": self.truncations,
                "numEntries": len(self._data),
            }

    def close(self) -> None:
        """Flush and release the journal handle (tests reopening the same
        data_dir; harmless on an in-memory store)."""
        with self._lock:
            if self._journal is not None:
                self._journal.flush()
                if self._fsync_policy != "off":
                    self._do_fsync(self._journal)
                self._journal.close()
                self._journal = None
