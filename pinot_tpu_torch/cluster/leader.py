"""Controller lead election over the property store.

The port's copy of pinot_tpu/cluster/leader.py.

Reference: Helix leader election for controllers (LeadControllerManager,
pinot-controller/.../LeadControllerManager.java) — among N controllers,
exactly one leads periodic tasks and the realtime segment completion; when
the leader's session dies, another controller claims leadership.

Here leadership is an ephemeral store entry claimed by compare-and-set:
``/CONTROLLER/LEADER = {"instance": id}`` owned by the instance's session.
``expire_session`` (the ZK session-death analogue) deletes it, the watch
fires, and every standby races one CAS to claim — exactly one wins.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional

LEADER_PATH = "/CONTROLLER/LEADER"


class LeadControllerManager:
    def __init__(self, store, instance_id: str,
                 on_change: Optional[Callable[[bool], None]] = None):
        self.store = store
        self.instance_id = instance_id
        self.on_change = on_change
        self._is_leader = False
        self._lock = threading.Lock()
        self._started = False
        self._watched = False

    def start(self) -> None:
        self._started = True
        if not self._watched:
            # watches are persistent: register ONCE even across
            # disconnect/rejoin cycles (re-registering would leak callbacks)
            self.store.watch(LEADER_PATH, self._on_event)
            self._watched = True
        self._try_claim()

    def disconnect(self) -> None:
        """Session loss / process death: stop reacting to events WITHOUT
        resigning — the ephemeral leader entry is reclaimed by the store's
        session expiry, and a real dead process can't respond to watches."""
        self._started = False
        with self._lock:
            self._is_leader = False

    def stop(self) -> None:
        """Graceful resignation (session stays alive, e.g. rolling restart)."""
        self._started = False
        try:
            self.store.unwatch(self._on_event)  # don't pin the elector
            self._watched = False  # a restart must re-register
        except AttributeError:
            pass
        with self._lock:
            was = self._is_leader
            self._is_leader = False
        if was:
            # atomic conditional delete: a plain get→check→delete races
            # with a concurrent session expiry + standby claim — the
            # delete would land on the NEW leader's entry
            self.store.delete_if(
                LEADER_PATH,
                lambda cur: isinstance(cur, dict)
                and cur.get("instance") == self.instance_id)
            self._notify(False)

    @property
    def is_leader(self) -> bool:
        with self._lock:
            return self._is_leader

    # -- internals -----------------------------------------------------------
    def _on_event(self, path: str, value) -> None:
        if not self._started:
            return
        if value is None:
            # leader vacated (session expiry or resignation): race to claim
            self._try_claim()
            return
        holder = value.get("instance")
        with self._lock:
            was = self._is_leader
            self._is_leader = holder == self.instance_id
            now = self._is_leader
        if was != now:
            self._notify(now)

    def _try_claim(self) -> None:
        # atomic exclusive create IS the election: exactly one racer's
        # create_if_absent returns True (ZK ephemeral-create semantics)
        self.store.create_if_absent(
            LEADER_PATH, {"instance": self.instance_id},
            ephemeral_owner=self.instance_id)
        cur = self.store.get(LEADER_PATH)
        if cur is not None:
            self._on_event(LEADER_PATH, cur)

    def _notify(self, is_leader: bool) -> None:
        if self.on_change is not None:
            try:
                self.on_change(is_leader)
            except Exception:
                pass
