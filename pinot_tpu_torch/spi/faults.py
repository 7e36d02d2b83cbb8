"""Deterministic fault injection for failure-domain testing.

The port's copy of pinot_tpu/spi/faults.py, whole. An ``hbm_oom`` fault
raises the RESOURCE_EXHAUSTED RuntimeError that the port's
engine/oom.py `is_hbm_oom` classifies as a device OOM.

Reference analogue: the reference proves its failure semantics with
ChaosMonkeyIntegrationTest-style component kills plus targeted Mockito
fault stubs; neither is available to an in-process reproduction without a
seam. This module IS that seam: a registry of named injection points wired
into the transport, broker, server, engine dispatch, realtime consumer,
MSE mailbox, and property store, so chaos tests can raise a precisely
scheduled failure at any hop and assert the query either converges to the
healthy answer (fault absorbed by retry/failover) or degrades to a
well-formed partial/error response — never a hang.

Discipline (same as spi/trace.py): when nothing is armed, the only cost a
call site pays is reading the module-level ``ACTIVE`` flag — no function
call, no allocation, no lock. The idiom at every injection point is::

    from ..spi import faults
    ...
    if faults.ACTIVE:
        faults.FAULTS.fire("transport.call", host=host, port=port)

``fire`` applies the first matching armed spec: raise an error payload
(``InjectedFault``), simulate a dropped connection (``InjectedDrop`` — the
transport translates it into closing the socket), sleep a fixed delay, or
raise an HBM-OOM-shaped ``RuntimeError`` (``RESOURCE_EXHAUSTED`` text, so
``engine/oom.py`` classifies and absorbs it through its real retry path).
Schedules are deterministic: fail-the-next-N (``times``), an explicit
per-point call-index ``schedule``, or a seeded per-spec RNG
(``probability`` + ``seed``) whose decisions depend only on seed and call
order.
"""

from __future__ import annotations

import random
import threading
import time
import zlib
from contextlib import contextmanager
from typing import Callable, Iterable, Optional

# Module-level gate, maintained by FaultRegistry.arm/disarm. Call sites
# read this one attribute; everything else in this module is off-path.
ACTIVE = False

POINTS = (
    "transport.call",    # RpcClient.call (broker scatter, MSE mailbox RPCs)
    "transport.stream",  # RpcClient.call_stream
    "server.query",      # ServerInstance._handle_query admission
    "device.dispatch",   # engine/executor.py kernel dispatch (solo + batch)
    "segment.load",      # ServerInstance._converge OFFLINE→ONLINE load
    "stream.fetch",      # realtime consumer fetch_messages
    "mailbox.deliver",   # MSE mse_mailbox chunk delivery
    "store.write",       # PropertyStore.set / create_if_absent
    "broker.route",      # Broker.routing_table snapshot read
    "datatable.encode",  # ServerInstance._handle_query DataTable encode
    "store.journal",     # PropertyStore WAL append (error = crash after
                         # append before notify; corrupt = torn write)
    "rebalance.move",    # ServerInstance destination fetch of an in-flight
                         # segment move (error/delay stall the move and
                         # exercise retry/blacklist; corrupt damages the
                         # fetched copy so quarantine+repair must heal it)
    "storage.fetch",     # SegmentTierManager cold-load fetch of a
                         # metadata-only segment (error fails the warm so
                         # the broker retries a resident replica; delay
                         # stalls it into deadline degradation; corrupt
                         # damages the local copy so quarantine+repair
                         # must re-fetch fresh, like rebalance.move)
    "aot.load",          # AotExecutableCache artifact read (corrupt =
                         # bitflip/truncate the serialized executable —
                         # the loader must refuse it and fall back to a
                         # fresh compile, never a wrong answer or crash)
    "realtime.upload",   # realtime/device_plane.py delta upload of newly
                         # appended rows (error → this query answers on
                         # host, planes untouched; corrupt → the whole
                         # plane set is dropped and the next query fully
                         # re-uploads — never a wrong answer; delay →
                         # upload budget exceeded, host fallback inside
                         # the deadline)
)


class InjectedFault(Exception):
    """Error-payload fault raised at an injection point."""


class InjectedDrop(InjectedFault):
    """Drop-connection fault: transport call sites translate this into
    closing the socket and raising TransportError (peer-unreachable
    shape), so failover and client-retry paths are exercised."""


class InjectedCorruption(InjectedFault):
    """Data-corruption fault: the call site catches this and mutates its
    byte payload with ``corrupt_bytes`` (seeded bit-flip or truncation)
    instead of raising, so detection paths — segment CRC verify, the
    DataTable wire checksum — see genuinely wrong bytes. Call sites that
    carry no byte payload treat it like any InjectedFault (it subclasses
    it), so a corrupt spec armed at a payload-free point degrades to an
    error fault rather than silently doing nothing."""

    def __init__(self, point: str, mode: str, seed: int, index: int,
                 message: Optional[str] = None):
        super().__init__(message or f"injected {mode} corruption at {point}")
        self.point = point
        self.mode = mode
        self.seed = seed
        self.index = index


class FaultSpec:
    """One armed fault at one injection point.

    kind:        "error" | "drop" | "delay" | "hbm_oom" | "corrupt"
    times:       fire on the next N matching calls then expire (None =
                 every matching call, never expires)
    delay_s:     sleep length for kind="delay"
    message:     override the raised exception text
    probability: fire each call with this probability from a
                 ``random.Random(seed)`` private to the spec (seeded
                 schedule — deterministic given call order)
    schedule:    explicit set of per-point 0-based call indices to fire on
                 (scripted schedule; overrides probability)
    match:       optional predicate over the call-site context kwargs
    corrupt_mode: "bitflip" | "truncate" — how a kind="corrupt" spec
                 mutates the call site's bytes (see corrupt_bytes)
    """

    KINDS = ("error", "drop", "delay", "hbm_oom", "corrupt")

    def __init__(self, kind: str = "error", times: Optional[int] = 1,
                 delay_s: float = 0.0, message: Optional[str] = None,
                 probability: Optional[float] = None, seed: int = 0,
                 schedule: Optional[Iterable[int]] = None,
                 match: Optional[Callable[[dict], bool]] = None,
                 corrupt_mode: str = "bitflip"):
        if kind not in self.KINDS:
            raise ValueError(f"unknown fault kind {kind!r} (one of {self.KINDS})")
        if corrupt_mode not in ("bitflip", "truncate"):
            raise ValueError(f"unknown corrupt_mode {corrupt_mode!r}")
        self.kind = kind
        self.remaining = times  # None = unlimited
        self.delay_s = float(delay_s)
        self.message = message
        self.probability = probability
        self.schedule = frozenset(schedule) if schedule is not None else None
        self.match = match
        self.corrupt_mode = corrupt_mode
        self.seed = seed
        self._rng = random.Random(seed) if probability is not None else None

    def triggers(self, call_index: int, ctx: dict) -> bool:
        if self.remaining is not None and self.remaining <= 0:
            return False
        if self.match is not None and not self.match(ctx):
            return False
        if self.schedule is not None:
            return call_index in self.schedule
        if self.probability is not None:
            # the rng advances once per consulted call → decisions are a
            # pure function of (seed, per-point call order)
            return self._rng.random() < self.probability
        return True


class FaultRegistry:
    """Armed specs per injection point + deterministic per-point call
    counters. Thread-safe; only ever entered when something is armed."""

    def __init__(self):
        self._lock = threading.Lock()
        self._specs: dict[str, list[FaultSpec]] = {}
        self._calls: dict[str, int] = {}   # per-point call index
        self._fired: dict[str, int] = {}   # per-point fault count
        self._fired_kinds: dict[str, int] = {}  # per-kind fault count
        self._fire_calls = 0               # total fire() entries (perf guard)
        self._gauges_registered = False

    # -- arming -------------------------------------------------------------
    def arm(self, point: str, spec: Optional[FaultSpec] = None,
            **kwargs) -> FaultSpec:
        if point not in POINTS:
            raise ValueError(f"unknown injection point {point!r} "
                             f"(one of {POINTS})")
        spec = spec or FaultSpec(**kwargs)
        with self._lock:
            self._specs.setdefault(point, []).append(spec)
        self._register_gauges()
        _set_active(True)
        return spec

    def disarm(self, point: Optional[str] = None) -> None:
        with self._lock:
            if point is None:
                self._specs.clear()
            else:
                self._specs.pop(point, None)
            any_armed = any(self._specs.values())
        _set_active(any_armed)

    def reset(self) -> None:
        """Disarm everything and zero the counters (test isolation)."""
        with self._lock:
            self._specs.clear()
            self._calls.clear()
            self._fired.clear()
            self._fired_kinds.clear()
        _set_active(False)

    # -- observability ------------------------------------------------------
    def fired(self, point: Optional[str] = None) -> int:
        with self._lock:
            if point is not None:
                return self._fired.get(point, 0)
            return sum(self._fired.values())

    def fired_kind(self, kind: str) -> int:
        """Faults fired with this kind across all points (the soak summary
        separates corruptions injected from error/drop/delay faults)."""
        with self._lock:
            return self._fired_kinds.get(kind, 0)

    def total_fired(self) -> int:
        return self.fired()

    def fire_count(self) -> int:
        """Total fire() entries (fired or not) — pinned by the perf guard:
        with injection disabled this must not move, proving call sites
        never enter the registry."""
        with self._lock:
            return self._fire_calls

    def snapshot(self) -> dict:
        with self._lock:
            return {"armed": {p: len(s) for p, s in self._specs.items() if s},
                    "calls": dict(self._calls),
                    "fired": dict(self._fired)}

    def _register_gauges(self) -> None:
        """Expose injected-fault counts on both role registries the first
        time anything is armed (zero cost while disarmed — nothing is
        registered until chaos actually starts)."""
        if self._gauges_registered:
            return
        self._gauges_registered = True
        from .metrics import BROKER_METRICS, SERVER_METRICS

        for reg in (SERVER_METRICS, BROKER_METRICS):
            reg.set_gauge("injectedFaults", self.total_fired)

    # -- the hot seam -------------------------------------------------------
    def fire(self, point: str, **ctx) -> None:
        """Consult the armed specs for ``point``; apply the first match.
        Only reached behind an ``if faults.ACTIVE`` check."""
        with self._lock:
            self._fire_calls += 1
            idx = self._calls.get(point, 0)
            self._calls[point] = idx + 1
            spec = None
            for s in self._specs.get(point, ()):
                if s.triggers(idx, ctx):
                    spec = s
                    break
            if spec is None:
                return
            if spec.remaining is not None:
                spec.remaining -= 1
            self._fired[point] = self._fired.get(point, 0) + 1
            self._fired_kinds[spec.kind] = \
                self._fired_kinds.get(spec.kind, 0) + 1
            kind, delay_s, message = spec.kind, spec.delay_s, spec.message
            corrupt_mode, corrupt_seed = spec.corrupt_mode, spec.seed
        # apply OUTSIDE the lock: a delay must not serialize other points
        if kind == "delay":
            time.sleep(delay_s)
            return
        if kind == "drop":
            raise InjectedDrop(message or
                               f"injected connection drop at {point}")
        if kind == "corrupt":
            # the call site catches this and applies corrupt_bytes to its
            # payload; idx makes each strike of one spec mutate different
            # deterministic bytes
            raise InjectedCorruption(point, corrupt_mode, corrupt_seed, idx,
                                     message)
        if kind == "hbm_oom":
            # RESOURCE_EXHAUSTED text → engine/oom.py is_hbm_oom() classifies
            # it and with_oom_retry absorbs it through the REAL eviction+retry
            # path — the simulated HBM OOM / compile failure of the tentpole
            raise RuntimeError(message or
                               f"RESOURCE_EXHAUSTED: injected HBM OOM at {point}")
        raise InjectedFault(message or f"injected fault at {point}")


def _set_active(value: bool) -> None:
    global ACTIVE
    ACTIVE = value


FAULTS = FaultRegistry()


@contextmanager
def injected(point: str, **kwargs):
    """Arm one fault for the duration of a with-block (test helper)::

        with faults.injected("device.dispatch", kind="hbm_oom", times=1):
            resp = broker.execute_sql(sql)
    """
    spec = FAULTS.arm(point, **kwargs)
    try:
        yield spec
    finally:
        FAULTS.disarm(point)


def seed_schedule(seed: int, rate: float,
                  points: Optional[Iterable[str]] = None,
                  kind: str = "error") -> list[str]:
    """Arm a reproducible random fault schedule (the soak --fault-rate
    knob): each point gets a probability-``rate`` spec with its own RNG
    seeded from (seed, point), so two runs with the same seed and call
    order inject identical faults. Returns the armed point names."""
    armed = []
    for point in (points or POINTS):
        FAULTS.arm(point, kind=kind, times=None, probability=rate,
                   seed=seed ^ zlib.crc32(point.encode()))
        armed.append(point)
    return armed


# -- corruption helpers -------------------------------------------------------


def corrupt_bytes(data: bytes, mode: str = "bitflip", seed: int = 0,
                  index: int = 0) -> bytes:
    """Deterministically damage ``data``: flip one random bit (bitflip) or
    cut the tail (truncate). Pure function of (data length, mode, seed,
    index) — two runs with the same schedule corrupt identical bytes, so
    detection/repair behavior is reproducible from the seed alone."""
    if not data:
        return data
    rng = random.Random((seed << 20) ^ (index * 0x9E3779B1) ^ len(data))
    if mode == "truncate":
        # keep at least 1 byte and drop at least 1: always a REAL mutation
        keep = rng.randrange(1, len(data)) if len(data) > 1 else 0
        return bytes(data[:keep])
    buf = bytearray(data)
    pos = rng.randrange(len(buf))
    buf[pos] ^= 1 << rng.randrange(8)
    return bytes(buf)


def corrupt_at(point: str, data: bytes, **ctx) -> bytes:
    """Fire ``point``; if a corrupt fault strikes, return damaged bytes,
    else return ``data`` unchanged. Non-corrupt faults armed at the point
    propagate as usual. Only call behind ``if faults.ACTIVE``."""
    try:
        FAULTS.fire(point, **ctx)
    except InjectedCorruption as c:
        return corrupt_bytes(data, c.mode, c.seed, c.index)
    return data
