"""Tracing SPI: per-query tracers and hierarchical phase spans.

The port of pinot_tpu/spi/trace.py. Reference analogue:
pinot-spi/.../spi/trace/Tracing.java:45 (a registerable Tracer, per-request
registration in ServerQueryExecutorV1Impl.execute:143-156) and the phase
timers (pinot-common/.../metrics/ServerQueryPhase.java:29-36). A trace
attaches to the broker response when the `trace` query option is set, as
the reference's `trace=true` does; EXPLAIN ANALYZE renders one.

Spans form a tree (broker reduce -> server execution -> per-family device
dispatch), but `Trace.to_json()` stays a FLAT list with `spanId` and
`parentId` carrying the hierarchy and an `attributes` dict carrying the
device-phase detail (deviceExecMs, transferBytes, compileMs).

With tracing off, a call site pays one thread-local read and allocates no
span (`span_allocations` counts every Span made, for the guard tests).

Head sampling (the flight recorder): with PINOT_TPU_TRACE_SAMPLE set, the
broker and every server trace the same production queries, each deciding
alone from a hash of the broker's query id (`sample_decision`).
"""

from __future__ import annotations

import itertools
import os
import threading
import time
import zlib
from contextlib import contextmanager
from typing import Any, Optional


class ServerQueryPhase:
    """Reference: ServerQueryPhase enum values."""

    REQUEST_DESERIALIZATION = "REQUEST_DESERIALIZATION"
    SCHEDULER_WAIT = "SCHEDULER_WAIT"
    BUILD_QUERY_PLAN = "BUILD_QUERY_PLAN"
    QUERY_PLAN_EXECUTION = "QUERY_PLAN_EXECUTION"
    RESPONSE_SERIALIZATION = "RESPONSE_SERIALIZATION"
    QUERY_PROCESSING = "QUERY_PROCESSING"
    SERVER_COMBINE = "SERVER_COMBINE"


# Process-wide count of Spans made: the tracing-off guard asserts it does
# not move when no trace is active.
_SPAN_ALLOCS = [0]


def span_allocations() -> int:
    return _SPAN_ALLOCS[0]


# PINOT_TPU_TRACE_SAMPLE in [0, 1] arms tracing of a share of production
# queries (no SET trace, no EXPLAIN ANALYZE). The decision is a hash of the
# query id, not a coin flip: the broker stamps one id a query and every
# scatter shard carries `<queryId>:<n>`, so the broker and the servers,
# each reading only its own environment, trace exactly the same queries
# and the merged trace is whole. The variable is read only where a trace
# could start (a broker or server entry), never per span.
TRACE_SAMPLE_ENV = "PINOT_TPU_TRACE_SAMPLE"

# crc32(queryId) % 10000 < rate * 10000: a 0.01% granularity, the same in
# every process and across restarts
_SAMPLE_SPACE = 10000


def trace_sample_rate() -> float:
    """The head-sampling rate, read per query (not cached) so a live
    process can be re-armed through the environment; clamped to [0, 1],
    0 when unset or not a number."""
    raw = os.environ.get(TRACE_SAMPLE_ENV)
    if not raw:
        return 0.0
    try:
        return min(1.0, max(0.0, float(raw)))
    except ValueError:
        return 0.0


def sample_decision(query_id: str, rate: float) -> bool:
    """Whether the query `query_id` is traced at `rate`: the same id and
    rate give the same answer in every process. The caller strips a shard
    id (`<queryId>:<n>`) to its query id, so every shard agrees with the
    broker."""
    if rate <= 0.0:
        return False
    if rate >= 1.0:
        return True
    return zlib.crc32(query_id.encode()) % _SAMPLE_SPACE \
        < int(rate * _SAMPLE_SPACE)


class Span:
    """One recorded scope: a node in the query's span tree."""

    __slots__ = ("name", "start_ms", "duration_ms", "span_id", "parent_id",
                 "seq", "attributes")

    def __init__(self, name: str, start_ms: float, span_id: int,
                 parent_id: Optional[int], seq: int):
        _SPAN_ALLOCS[0] += 1
        self.name = name
        self.start_ms = start_ms
        self.duration_ms = 0.0
        self.span_id = span_id
        self.parent_id = parent_id
        self.seq = seq
        self.attributes: dict[str, Any] = {}

    def set_attribute(self, key: str, value: Any) -> None:
        self.attributes[key] = value

    def to_json(self) -> dict:
        out = {"operator": self.name, "startMs": self.start_ms,
               "durationMs": self.duration_ms, "spanId": self.span_id}
        if self.parent_id is not None:
            out["parentId"] = self.parent_id
        if self.attributes:
            out["attributes"] = dict(self.attributes)
        return out


class Trace:
    """One query's recorded spans (a flat store; the tree via parentId)."""

    def __init__(self, query_id: str):
        self.query_id = query_id
        self.spans: list[Span] = []
        # EXPLAIN ANALYZE observes the real execution, caches included:
        # the cache layers read this flag instead of bypassing whenever a
        # trace is active
        self.analyze = False
        self._t0 = time.perf_counter()
        # list.append and itertools.count.__next__ are atomic under the
        # GIL, so pool workers on an adopted trace need no lock here
        self._ids = itertools.count(1)
        self._seq = itertools.count()

    def new_span(self, name: str, start: float,
                 parent: Optional[Span] = None) -> Span:
        span = Span(name, round((start - self._t0) * 1000, 3),
                    next(self._ids),
                    None if parent is None else parent.span_id,
                    next(self._seq))
        self.spans.append(span)
        return span

    def record(self, name: str, start: float, end: float,
               parent: Optional[Span] = None) -> Span:
        """Record a completed scope in one call."""
        span = self.new_span(name, start, parent)
        span.duration_ms = round((end - start) * 1000, 3)
        return span

    def _ordered(self) -> list:
        # workers append from several threads, so the list's order depends
        # on the interleaving: sort by start, ties by record order
        return sorted(self.spans, key=lambda s: (s.start_ms, s.seq))

    def to_json(self) -> list:
        return [s.to_json() for s in self._ordered()]

    def to_tree(self) -> list:
        """The nested form: children grouped under their parent span."""
        nodes = {s.span_id: dict(s.to_json(), children=[])
                 for s in self._ordered()}
        roots = []
        for node in nodes.values():
            parent = nodes.get(node.get("parentId"))
            (parent["children"] if parent else roots).append(node)
        return roots

    def phase_ms(self, name: str) -> float:
        return sum(s.duration_ms for s in self.spans if s.name == name)


def phase_breakdown(trace_json: list) -> dict:
    """Roll a flat span list up into the device-phase totals: compile,
    device-execute and host-combine ms and host->device bytes (each key
    sums over every span carrying the attribute)."""
    out = {"compileMs": 0.0, "deviceExecMs": 0.0, "hostCombineMs": 0.0,
           "transferBytes": 0, "shuffledBytes": 0}
    for span in trace_json:
        attrs = span.get("attributes") or {}
        out["compileMs"] += attrs.get("compileMs", 0.0)
        out["deviceExecMs"] += attrs.get("deviceExecMs", 0.0)
        out["transferBytes"] += attrs.get("transferBytes", 0)
        out["shuffledBytes"] += attrs.get("shuffled_bytes", 0)
        if span.get("operator") in (ServerQueryPhase.SERVER_COMBINE,
                                    "BROKER_REDUCE"):
            out["hostCombineMs"] += span.get("durationMs", 0.0)
    for k in ("compileMs", "deviceExecMs", "hostCombineMs"):
        out[k] = round(out[k], 3)
    if not out["shuffledBytes"]:
        # multi-stage only: single-stage queries keep the four keys
        del out["shuffledBytes"]
    return out


class Tracer:
    """Override to ship scopes elsewhere (reference: the pluggable
    Tracer)."""

    def new_trace(self, query_id: str) -> Trace:
        return Trace(query_id)


class _Tracing:
    """Per-thread active trace registry (reference: Tracing.ThreadLocal)."""

    def __init__(self):
        self._tracer = Tracer()
        self._local = threading.local()

    def register_tracer(self, tracer: Tracer) -> None:
        self._tracer = tracer

    def start_trace(self, query_id: str, analyze: bool = False) -> Trace:
        trace = self._tracer.new_trace(query_id)
        trace.analyze = analyze
        self._local.trace = trace
        self._local.stack = []
        return trace

    def active_trace(self) -> Optional[Trace]:
        return getattr(self._local, "trace", None)

    def analyze_active(self) -> bool:
        """True while the active trace belongs to an EXPLAIN ANALYZE run:
        the caches stay on (the annotated plan shows what a real run
        does)."""
        trace = self.active_trace()
        return trace is not None and trace.analyze

    def current_span(self) -> Optional[Span]:
        stack = getattr(self._local, "stack", None)
        return stack[-1] if stack else None

    def adopt(self, trace: Optional[Trace],
              parent: Optional[Span] = None) -> None:
        """Make another thread's trace active here (a worker pool's
        fan-out). `parent` seeds the span stack, so the worker's scopes
        nest under the caller's span instead of floating at the root."""
        self._local.trace = trace
        self._local.stack = [] if parent is None else [parent]

    def end_trace(self) -> Optional[Trace]:
        trace = self.active_trace()
        self._local.trace = None
        self._local.stack = []
        return trace

    @contextmanager
    def scope(self, name: str):
        """Record a span into the active trace, nested under the current
        span, and yield it so the caller can set attributes. With no trace
        active it yields None: one thread-local read, no Span made."""
        trace = self.active_trace()
        if trace is None:
            yield None
            return
        start = time.perf_counter()
        span = trace.new_span(name, start, self.current_span())
        stack = self._local.stack
        stack.append(span)
        try:
            yield span
        finally:
            span.duration_ms = round((time.perf_counter() - start) * 1000, 3)
            if stack and stack[-1] is span:
                stack.pop()


TRACING = _Tracing()
