"""Cross-query coalescing: concurrent queries of one family, one dispatch.

The port of pinot_tpu/engine/coalesce.py. Reference analogue: none in
Pinot (the JVM engine scales concurrency with threads); the shape is a
serving system's continuous batching. The batch family's stack axis grows
from "segments of one query" to "(query, segment) slots of concurrent
queries": in-flight queries with equal `batch_family_key` and segment set
meet here, the first (the leader) holds the group open for a window,
dispatches every member's plans as ONE family launch over `[S*Q, ...]`
planes (engine/executor.py `dispatch_plan_batch(..., repeat=Q)`), fetches
it in one copy and hands each member its own S rows. Every row of the
launch runs the solo family body, so coalesced rows equal solo rows;
per-query literals ride as stacked param planes.

Arming: the hold window (`PINOT_TPU_COALESCE_WINDOW_MS`, default 0 =
never hold) applies only to (table, family) pairs the traffic tracker has
seen repeat (`FamilyTraffic`), so a one-off query never waits. Joining a
group already open needs no arming. A group closes early at
`PINOT_TPU_COALESCE_MAX_QUERIES` members. `SET coalesce = false` opts a
query out; the caller keeps traced queries and consuming segments' families
out (engine/query_executor.py).

Leader failure, where the port differs from the reference on purpose: the
reference sends every member back to its solo dispatch on ANY leader
error. Here only the gates the solo family path itself accepts do that
(`BatchFamilyMismatch`, `HbmExhaustedError`: the group's planes do not
match or do not fit); any other error reaches every member's caller.

Server meters, as in the JAX package: `coalescedQueries` counts the peers
of each group a leader dispatched (Q - 1), and the `coalesceWaitMs` timer
takes each query's wait in the window, a leader's alone included;
`snapshot()` holds the coalescer's own counts.
"""

from __future__ import annotations

import os
import threading
import time

from ..spi.metrics import SERVER_METRICS, ServerMeter, ServerTimer
from .executor import BatchFamilyMismatch
from .oom import HbmExhaustedError

# leader errors after which every member dispatches alone, as the solo
# family path does after them
_SOLO_FALLBACK = (BatchFamilyMismatch, HbmExhaustedError)


def window_ms() -> float:
    """The hold window. 0 (the default) never holds, so no group forms and
    single-query workloads see the serving path without coalescing."""
    try:
        return float(os.environ.get("PINOT_TPU_COALESCE_WINDOW_MS", 0.0))
    except ValueError:
        return 0.0


def _max_queries() -> int:
    try:
        return max(2, int(os.environ.get(
            "PINOT_TPU_COALESCE_MAX_QUERIES", 16)))
    except ValueError:
        return 16


# -- per-query thread-local accounting (as the executor's dispatch count) ----

_TLS = threading.local()


def reset_coalesce_stats() -> None:
    _TLS.stats = [0, 0.0]  # [peer queries shared with, wait ms]


def coalesce_stats() -> tuple:
    s = getattr(_TLS, "stats", None)
    return (s[0], round(s[1], 3)) if s else (0, 0.0)


def _note_stats(peers: int, wait_ms: float) -> None:
    s = getattr(_TLS, "stats", None)
    if s is not None:
        s[0] += peers
        s[1] += wait_ms
    SERVER_METRICS.update_timer(ServerTimer.COALESCE_WAIT_MS, wait_ms)


# -- (table, family) traffic nomination --------------------------------------


class FamilyTraffic:
    """Decaying per-(table, family) query counter. `armed` nominates the
    pairs whose decayed count says repeat traffic exists, so the hold
    window delays only queries that have peers to wait for."""

    def __init__(self, half_life_s: float = None, min_traffic: float = None):
        self.half_life_s = float(
            half_life_s if half_life_s is not None else
            os.environ.get("PINOT_TPU_COALESCE_TRAFFIC_HALFLIFE_S", 10.0))
        self.min_traffic = float(
            min_traffic if min_traffic is not None else
            os.environ.get("PINOT_TPU_COALESCE_MIN_TRAFFIC", 2.0))
        self._lock = threading.Lock()
        self._counts: dict = {}  # (table, hash(family)) -> [value, t]
        self._max = 4096

    def _decayed(self, slot, now: float) -> float:
        value, t = slot
        dt = now - t
        return value * (2.0 ** (-dt / self.half_life_s)) if dt > 0 else value

    def note(self, table, family_key) -> float:
        """Fold one sighting in; returns the decayed count after it."""
        key = (table, hash(family_key))
        now = time.time()
        with self._lock:
            slot = self._counts.get(key)
            value = self._decayed(slot, now) + 1.0 if slot else 1.0
            self._counts[key] = [value, now]
            if len(self._counts) > self._max:
                # the stalest entries go first
                for k in sorted(self._counts,
                                key=lambda k: self._counts[k][1])[:256]:
                    del self._counts[k]
        return value

    def armed(self, table, family_key) -> bool:
        # min_traffic - 0.5: a sighting at most one half-life old (worth at
        # least half a query) plus the fresh one arms; a strict
        # >= min_traffic could never trigger at the default 2.0
        key = (table, hash(family_key))
        now = time.time()
        with self._lock:
            slot = self._counts.get(key)
        return slot is not None and self._decayed(slot, now) \
            >= self.min_traffic - 0.5

    def snapshot(self) -> dict:
        now = time.time()
        with self._lock:
            per_table: dict = {}
            for (table, _), slot in self._counts.items():
                per_table[table] = per_table.get(table, 0.0) \
                    + self._decayed(slot, now)
        return {t: round(v, 3) for t, v in per_table.items()}


class CoalesceResult:
    """What a member gets back: its own S rows of the group's fetched host
    arrays (views, no copy)."""

    __slots__ = ("outs", "peers", "wait_ms")

    def __init__(self, outs, peers: int, wait_ms: float):
        self.outs = outs
        self.peers = peers
        self.wait_ms = wait_ms


class _Group:
    __slots__ = ("key", "segs", "plans_list", "closed", "full", "done",
                 "outs", "error")

    def __init__(self, key, segs):
        self.key = key
        self.segs = segs
        self.plans_list: list = []
        self.closed = False
        self.full = threading.Event()
        self.done = threading.Event()
        self.outs = None
        self.error = None


class QueryCoalescer:
    """One per QueryExecutor. `offer` is the only entry point; it returns
    None whenever the query should take its own dispatch."""

    def __init__(self, traffic: FamilyTraffic = None):
        self.traffic = traffic if traffic is not None else FamilyTraffic()
        self._lock = threading.Lock()
        self._open: dict = {}
        # lifetime counts, for snapshot()
        self.groups_formed = 0
        self.queries_coalesced = 0
        self.solo_fallbacks = 0

    def offer(self, table, fkey, segs, plans, runner):
        """Coalesce this query's dispatch of family `fkey` over `segs`
        with concurrent peers. `runner(segs, plans_all, q)` dispatches the
        group's ONE launch over the Q members' plans (query by query) and
        returns its fetched host arrays, leading dim S*Q. Returns a
        CoalesceResult with this query's rows, or None: dispatch alone."""
        w_ms = window_ms()
        if w_ms <= 0:
            return None
        key = (fkey, tuple(getattr(s, "name", id(s)) for s in segs))
        t0 = time.perf_counter()
        with self._lock:
            g = self._open.get(key)
            if g is not None and not g.closed:
                member = len(g.plans_list)
                g.plans_list.append(plans)
                if member + 1 >= _max_queries():
                    g.full.set()
                lead = False
            else:
                self.traffic.note(table, fkey)
                if not self.traffic.armed(table, fkey):
                    return None
                g = _Group(key, segs)
                g.plans_list.append(plans)
                self._open[key] = g
                lead = True
        if lead:
            return self._lead(g, key, len(plans), w_ms, t0, runner)
        return self._follow(g, member, len(plans), w_ms, t0)

    def _follow(self, g: _Group, member: int, s: int, w_ms: float,
                t0: float):
        """Registered under the lock in offer(); waits here, on an event,
        never on the device. The timeout covers the leader's window and
        dispatch; on a timeout or a solo-fallback gate the member
        dispatches alone, any other leader error is raised here too."""
        ok = g.done.wait(timeout=w_ms / 1000.0 + 60.0)
        wait_ms = (time.perf_counter() - t0) * 1000
        if ok and g.error is not None \
                and not isinstance(g.error, _SOLO_FALLBACK):
            raise g.error
        if not ok or g.outs is None:
            return None
        row0 = member * s
        outs = [o[row0:row0 + s] for o in g.outs]
        peers = len(g.plans_list) - 1
        _note_stats(peers, wait_ms)
        return CoalesceResult(outs, peers, wait_ms)

    def _lead(self, g: _Group, key, s: int, w_ms: float, t0: float,
              runner):
        g.full.wait(timeout=w_ms / 1000.0)  # the window, or full early
        with self._lock:
            g.closed = True
            self._open.pop(key, None)
            plans_list = list(g.plans_list)
        q = len(plans_list)
        wait_ms = (time.perf_counter() - t0) * 1000
        if q == 1:
            # nobody joined: the leader dispatches alone
            g.error = TimeoutError("no peers joined the window")
            g.done.set()
            _note_stats(0, wait_ms)
            return None
        try:
            g.outs = runner(list(g.segs),
                            [p for member in plans_list for p in member], q)
        except _SOLO_FALLBACK as e:
            g.error = e
            g.done.set()
            with self._lock:
                self.solo_fallbacks += 1
            return None
        except BaseException as e:
            g.error = e
            g.done.set()
            raise
        g.done.set()
        with self._lock:
            self.groups_formed += 1
            self.queries_coalesced += q
        _note_stats(q - 1, wait_ms)
        SERVER_METRICS.add_meter(ServerMeter.COALESCED_QUERIES, q - 1)
        return CoalesceResult([o[:s] for o in g.outs], q - 1, wait_ms)

    def snapshot(self) -> dict:
        with self._lock:
            return {"openGroups": len(self._open),
                    "groupsFormed": self.groups_formed,
                    "queriesCoalesced": self.queries_coalesced,
                    "soloFallbacks": self.solo_fallbacks,
                    "windowMs": window_ms(),
                    "tableTraffic": self.traffic.snapshot()}


def coalesce_enabled(query) -> bool:
    """`SET coalesce = false` opts a query out; on by default."""
    return str(query.query_options.get("coalesce")).lower() \
        not in ("false", "0", "off")
