"""Networked property store: the cluster metadata plane across OS processes.

The port's copy of pinot_tpu/cluster/remote_store.py, over the port's
cluster/store.py and cluster/transport.py. A ServerInstance runs against a
RemoteStore unchanged, so a server in another OS process (on the same card
or another) joins the cluster through it. Reference analogue: ZooKeeper. The in-memory PropertyStore (store.py) plays
ZK's role for roles hosted in one process; `PropertyStoreServer` exposes it
over the framed-TCP RPC plane so roles in *other OS processes* join the same
cluster through a `RemoteStore` proxy with the identical interface
(get/set/CAS/children/ephemerals/watches).

Watches are poll-based: every mutation appends to a bounded event log with a
monotonically increasing sequence number; remote clients long-poll
``("poll", since)`` from a background thread and dispatch matching callbacks
locally. That trades watch latency (~poll interval) for a wire protocol with
no server→client channel — acceptable where ZK delivers watch events
asynchronously anyway.

CAS (`update`) runs client-side: read version, apply fn locally, write with
expected_version, retry on BadVersionError — the same ZkBaseDataAccessor
pattern, over the wire.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Any, Callable, Optional

from .store import BadVersionError, PropertyStore, StoreError
from .transport import RemoteError, RpcClient, RpcServer

_MAX_EVENTS = 100_000


class PropertyStoreServer:
    """Wraps a PropertyStore with an RPC endpoint + change event log."""

    def __init__(self, store: Optional[PropertyStore] = None):
        self.store = store if store is not None else PropertyStore()
        self._events: list[tuple[int, str, Any]] = []
        self._seq = 0
        self._lock = threading.Lock()
        self.store.watch("/", self._on_change)
        self._rpc = RpcServer(self._handle)

    @property
    def address(self) -> tuple[str, int]:
        return (self._rpc.host, self._rpc.port)

    def close(self) -> None:
        self._rpc.close()
        try:
            # a closed server must not keep accumulating the shared
            # store's events (or be pinned by its watch list)
            self.store.unwatch(self._on_change)
        except AttributeError:
            pass

    def _on_change(self, path: str, value) -> None:
        with self._lock:
            self._seq += 1
            self._events.append((self._seq, path, value))
            if len(self._events) > _MAX_EVENTS:
                del self._events[: _MAX_EVENTS // 10]

    def _handle(self, request):
        op = request[0]
        args = request[1:]
        if op == "get":
            return self.store.get(*args)
        if op == "get_with_version":
            return self.store.get_with_version(*args)
        if op == "set":
            path, value, expected_version, ephemeral_owner = args
            return self.store.set(path, value, expected_version, ephemeral_owner)
        if op == "delete":
            return self.store.delete(*args)
        if op == "create_if_absent":
            return self.store.create_if_absent(*args)
        if op == "children":
            return self.store.children(*args)
        if op == "list_paths":
            return self.store.list_paths(*args)
        if op == "expire_session":
            return self.store.expire_session(*args)
        if op == "poll":
            (since,) = args
            with self._lock:
                first = self._events[0][0] if self._events else self._seq + 1
                if since is None:
                    return self._seq, [], first
                return (self._seq,
                        [e for e in self._events if e[0] > since], first)
        raise ValueError(f"unknown store op {op!r}")


class RemoteStore:
    """PropertyStore-compatible client proxy over the RPC plane."""

    POLL_INTERVAL_S = 0.03

    def __init__(self, host: str, port: int):
        self._client = RpcClient(host, port)
        self._watches: list[tuple[str, Callable[[str, Optional[Any]], None]]] = []
        self._lock = threading.Lock()
        self._closed = threading.Event()
        self._poller: Optional[threading.Thread] = None
        self._last_seq: Optional[int] = None
        # paths this client has observed via events — lets a gap resync
        # deliver deletions that happened inside the trimmed window
        self._known_paths: set[str] = set()

    # -- basic ops ---------------------------------------------------------
    def _call(self, *request):
        try:
            return self._client.call(request)
        except RemoteError as e:
            msg = str(e)
            if msg.startswith("BadVersionError"):
                raise BadVersionError(msg) from None
            if msg.startswith(("StoreError", "KeyError", "ValueError")):
                raise StoreError(msg) from None
            raise

    def set(self, path: str, value: Any, expected_version: int = -1,
            ephemeral_owner: Optional[str] = None) -> int:
        json.dumps(value)
        return self._call("set", path, value, expected_version, ephemeral_owner)

    def get(self, path: str) -> Optional[Any]:
        return self._call("get", path)

    def get_with_version(self, path: str) -> tuple[Optional[Any], int]:
        value, version = self._call("get_with_version", path)
        return value, version

    def delete(self, path: str) -> bool:
        return self._call("delete", path)

    def create_if_absent(self, path: str, value: Any,
                         ephemeral_owner: Optional[str] = None) -> bool:
        return self._call("create_if_absent", path, value, ephemeral_owner)

    def children(self, prefix: str) -> list[str]:
        return self._call("children", prefix)

    def list_paths(self, prefix: str) -> list[str]:
        return self._call("list_paths", prefix)

    def expire_session(self, owner: str) -> None:
        self._call("expire_session", owner)

    # -- watches -----------------------------------------------------------
    def unwatch(self, callback: Callable) -> None:
        with self._lock:
            # equality, not identity: bound methods are re-created per
            # access, so `is` would never match
            self._watches = [(p, cb) for p, cb in self._watches
                             if cb != callback]

    def watch(self, prefix: str, callback: Callable[[str, Optional[Any]], None]) -> None:
        with self._lock:
            self._watches.append((prefix, callback))
            if self._poller is None:
                self._last_seq = self._call("poll", None)[0]
                self._poller = threading.Thread(
                    target=self._poll_loop, name="remote-store-poll", daemon=True)
                self._poller.start()

    def _poll_loop(self) -> None:
        while not self._closed.is_set():
            try:
                seq, events, first = self._call("poll", self._last_seq)
            except Exception:
                if self._closed.is_set():
                    return
                time.sleep(0.2)
                continue
            if self._last_seq is not None and self._last_seq + 1 < first \
                    and seq > self._last_seq:
                # the server trimmed events we never saw: resync every
                # watched prefix from current state instead of silently
                # missing transitions (ZK watchers re-read after gaps too)
                self._last_seq = seq
                self._resync()
                continue
            self._last_seq = seq
            for _, path, value in events:
                with self._lock:
                    targets = [cb for prefix, cb in self._watches
                               if path.startswith(prefix)]
                    if value is None:
                        self._known_paths.discard(path)
                    else:
                        self._known_paths.add(path)
                for cb in targets:
                    try:
                        cb(path, value)
                    except Exception:
                        pass
            self._closed.wait(self.POLL_INTERVAL_S)

    def _resync(self) -> None:
        """Re-deliver current state for every watched prefix after an event
        gap — including deletions: paths this client has seen that no longer
        exist fire cb(path, None)."""
        with self._lock:
            watches = list(self._watches)
            known = set(self._known_paths)
        for prefix, cb in watches:
            try:
                live = set(self._call("list_paths", prefix))
            except Exception:
                continue
            for path in sorted(known):
                if path.startswith(prefix) and path not in live:
                    with self._lock:
                        self._known_paths.discard(path)
                    try:
                        cb(path, None)
                    except Exception:
                        pass
            for path in sorted(live):
                with self._lock:
                    self._known_paths.add(path)
                try:
                    cb(path, self._call("get", path))
                except Exception:
                    pass

    # -- transactional helpers ---------------------------------------------
    def update(self, path: str, fn: Callable[[Optional[Any]], Any],
               max_retries: int = 20) -> Any:
        for _ in range(max_retries):
            cur, version = self.get_with_version(path)
            new = fn(json.loads(json.dumps(cur)) if cur is not None else None)
            try:
                self.set(path, new, expected_version=version)
                return new
            except BadVersionError:
                continue
        raise StoreError(f"update contention on {path}")

    def close(self) -> None:
        self._closed.set()
        self._client.close()


def serve_server_process(store_host: str, store_port: int, instance_id: str,
                         device: str = "cuda",
                         tags: Optional[list[str]] = None) -> None:
    """Entry point of a server in its own OS process (a `multiprocessing`
    "spawn" target): join the cluster whose store a PropertyStoreServer
    serves at (store_host, store_port) through a RemoteStore, serve until
    ``/CONTROL/STOP/<instance_id>`` appears in the store or the store stops
    answering, then stop the server."""
    from .server import ServerInstance

    stop_path = f"/CONTROL/STOP/{instance_id}"
    store = RemoteStore(store_host, store_port)
    try:
        server = ServerInstance(store, instance_id, device=device, tags=tags)
        server.start()
        try:
            while store.get(stop_path) is None:
                time.sleep(0.05)
        finally:
            server.stop()
    finally:
        store.close()
