"""Per-server circuit breakers for the broker routing table.

The port's copy of pinot_tpu/cluster/breaker.py.

Reference analogue: ConnectionFailureDetector marks a server unhealthy
behind an exponential-backoff retry window; a circuit breaker is the
stronger contract the retry/hedge layer needs — a dead server must stop
eating retry budget the moment it trips, and must be re-admitted through
a bounded probe, not a thundering herd.

State machine per server (the classic closed → open → half-open cycle):

  closed     all traffic; ``failure_threshold`` CONSECUTIVE transport
             failures trip it.
  open       no traffic for ``cooldown_s`` (doubles on every re-trip,
             capped at ``max_cooldown_s``); selection skips the server.
  half-open  exactly one probe RPC is admitted; success closes the
             breaker (cooldown resets), failure re-opens it with a
             longer cooldown. A probe that never resolves (hung socket)
             releases the probe slot after another cooldown.

All transitions are pure call-count/clock bookkeeping — no background
thread — so the deterministic fault schedules in spi/faults.py drive the
full lifecycle from tests. Left out: the JAX package's error-rate trip
(off unless its environment knob is set).
"""

from __future__ import annotations

import threading
import time

from ..spi.metrics import BROKER_METRICS, BrokerMeter

CLOSED, HALF_OPEN, OPEN = "closed", "half_open", "open"
_STATE_VALUE = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}


class CircuitBreaker:
    """One server's breaker. Not thread-safe on its own — the owning
    CircuitBreakerTable serializes access."""

    __slots__ = ("state", "consecutive_failures", "cooldown_s", "open_until",
                 "probe_inflight_since", "opened_count")

    def __init__(self, base_cooldown_s: float):
        self.state = CLOSED
        self.consecutive_failures = 0
        self.cooldown_s = base_cooldown_s
        self.open_until = 0.0
        self.probe_inflight_since: float | None = None
        self.opened_count = 0


class CircuitBreakerTable:
    """Breaker per server instance, consulted by replica selection
    (``allow``) and fed by scatter-RPC outcomes (``record_success`` /
    ``record_failure``)."""

    def __init__(self, failure_threshold: int = 3,
                 cooldown_s: float = 2.0, max_cooldown_s: float = 30.0,
                 metrics=BROKER_METRICS):
        self.failure_threshold = max(1, failure_threshold)
        self.base_cooldown_s = cooldown_s
        self.max_cooldown_s = max_cooldown_s
        self.metrics = metrics
        self._lock = threading.Lock()
        self._breakers: dict[str, CircuitBreaker] = {}

    def _breaker_locked(self, instance: str) -> CircuitBreaker:
        b = self._breakers.get(instance)
        if b is None:
            b = CircuitBreaker(self.base_cooldown_s)
            self._breakers[instance] = b
            if self.metrics is not None:
                # per-server breaker state gauge (0=closed, 1=half-open,
                # 2=open) for GET /metrics
                self.metrics.set_gauge(
                    f"circuitBreakerState.{instance}",
                    lambda b=b: _STATE_VALUE[b.state])
        return b

    # -- selection side ------------------------------------------------------
    def allow(self, instance: str) -> bool:
        """May the next RPC go to this server? Open breakers whose cooldown
        has elapsed transition to half-open and admit ONE probe; open
        breakers inside the cooldown (and half-open breakers with a live
        probe) refuse."""
        now = time.monotonic()
        with self._lock:
            b = self._breakers.get(instance)
            if b is None or b.state == CLOSED:
                return True
            if b.state == OPEN:
                if now < b.open_until:
                    return False
                b.state = HALF_OPEN
                b.probe_inflight_since = now
                return True  # this caller carries the probe
            # half-open: one probe at a time; a probe stuck longer than
            # the cooldown is presumed lost — hand out another
            if b.probe_inflight_since is None or \
                    now - b.probe_inflight_since >= b.cooldown_s:
                b.probe_inflight_since = now
                return True
            return False

    # -- outcome side --------------------------------------------------------
    def record_success(self, instance: str) -> None:
        with self._lock:
            b = self._breaker_locked(instance)
            b.consecutive_failures = 0
            b.probe_inflight_since = None
            if b.state != CLOSED:
                b.state = CLOSED
                b.cooldown_s = self.base_cooldown_s

    def record_failure(self, instance: str) -> None:
        opened = False
        with self._lock:
            b = self._breaker_locked(instance)
            now = time.monotonic()
            b.consecutive_failures += 1
            if b.state == HALF_OPEN:
                # failed probe: re-open with a longer cooldown
                b.probe_inflight_since = None
                b.cooldown_s = min(b.cooldown_s * 2, self.max_cooldown_s)
                opened = self._open_locked(b, now)
            elif b.state == CLOSED and \
                    b.consecutive_failures >= self.failure_threshold:
                opened = self._open_locked(b, now)
        if opened and self.metrics is not None:
            self.metrics.add_meter(BrokerMeter.CIRCUIT_OPEN)

    def _open_locked(self, b: CircuitBreaker, now: float) -> bool:
        b.state = OPEN
        b.open_until = now + b.cooldown_s
        b.opened_count += 1
        return True

    # -- observability -------------------------------------------------------
    def state(self, instance: str) -> str:
        with self._lock:
            b = self._breakers.get(instance)
            if b is None:
                return CLOSED
            if b.state == OPEN and time.monotonic() >= b.open_until:
                return HALF_OPEN  # next allow() will hand out the probe
            return b.state

    def down_count(self) -> int:
        """Servers with an OPEN breaker still inside cooldown (the
        serversUnhealthy gauge)."""
        now = time.monotonic()
        with self._lock:
            return sum(1 for b in self._breakers.values()
                       if b.state == OPEN and b.open_until > now)

    def snapshot(self) -> dict:
        """The breaker table (the JAX broker's GET /debug/servers, and the
        /BROKERSTATE beacon)."""
        with self._lock:
            items = list(self._breakers.items())
        out = {}
        for inst, b in items:
            out[inst] = {
                "state": self.state(inst),
                "consecutiveFailures": b.consecutive_failures,
                "cooldownS": round(b.cooldown_s, 3),
                "timesOpened": b.opened_count,
            }
        return out
