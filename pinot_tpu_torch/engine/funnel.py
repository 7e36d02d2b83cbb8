"""FUNNEL aggregation family.

The port's copy of pinot_tpu/engine/funnel.py. Reference:
- pinot-core/.../query/aggregation/function/funnel/
  FunnelCountAggregationFunction.java (and its set / bitmap strategies):
  FUNNEL_COUNT(STEPS(expr, ...), CORRELATE_BY(col)[, SETTINGS(...)]), the
  count of correlation values that matched steps 0..i (a cascading set
  intersection at finalize, SetMergeStrategy.extractFinalResult).
- pinot-core/.../aggregation/function/funnel/window/
  FunnelBaseAggregationFunction.java and FunnelMaxStep / FunnelMatchStep /
  FunnelCompleteCount: FUNNEL_*(tsExpr, windowSize, numSteps, stepExpr...,
  [mode...]). Rows become (timestamp, first matching step) events, merged
  across segments by concatenation and finalized with a sliding-window
  scan that honours STRICT_DEDUPLICATION / STRICT_ORDER / STRICT_INCREASE
  / KEEP_ALL and MAXSTEPDURATION.

The per-row work (step masks, the first matching step, the events) is
whole-segment numpy on the host engine (engine/host_executor.py); only the
per-group scan at finalize is a Python loop over the group's events. No
device planner lowers a funnel: the single-stage planner refuses it
(engine/aggregation.py), and QueryExecutor's "host" and "auto" backends
answer it. States are numpy arrays and sets, so they ride DataTables
between servers unchanged.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field

import numpy as np

from ..query.expressions import ExpressionContext, FunctionContext

WINDOW_FNS = frozenset(
    ("funnelmaxstep", "funnelmatchstep", "funnelcompletecount"))
FUNNEL_FNS = WINDOW_FNS | {"funnelcount"}

_MODES = ("STRICT_DEDUPLICATION", "STRICT_ORDER", "STRICT_INCREASE",
          "KEEP_ALL")


class FunnelParseError(Exception):
    pass


# ---------------------------------------------------------------------------
# Specs
# ---------------------------------------------------------------------------


@dataclass
class FunnelCountSpec:
    step_exprs: list  # boolean ExpressionContexts
    correlate_expr: ExpressionContext
    settings: tuple = ()

    @property
    def num_steps(self) -> int:
        return len(self.step_exprs)


@dataclass
class FunnelWindowSpec:
    name: str
    ts_expr: ExpressionContext
    window: int
    num_steps: int
    step_exprs: list
    modes: set = field(default_factory=set)
    max_step_duration: int = 0


def parse_funnel(fn: FunctionContext):
    if fn.name == "funnelcount":
        return _parse_count(fn)
    return _parse_window(fn)


def _parse_count(fn: FunctionContext) -> FunnelCountSpec:
    steps = None
    correlate = None
    settings: tuple = ()
    for a in fn.arguments:
        inner = a.function if a.is_function else None
        if inner is not None and inner.name == "steps":
            steps = list(inner.arguments)
        elif inner is not None and inner.name in ("correlateby", "correlate_by"):
            if not inner.arguments:
                raise FunnelParseError("CORRELATE_BY needs a column")
            correlate = inner.arguments[0]
        elif inner is not None and inner.name == "settings":
            settings = tuple(str(x.literal) for x in inner.arguments)
        else:
            raise FunnelParseError(
                f"FUNNEL_COUNT argument must be STEPS(...)/CORRELATE_BY(...)"
                f"/SETTINGS(...), got {a}")
    if not steps or correlate is None:
        raise FunnelParseError(
            "FUNNEL_COUNT requires STEPS(...) and CORRELATE_BY(...)")
    # settings select a counting strategy in the reference (bitmap / set /
    # theta_sketch / partitioned / sorted); every strategy answers the same
    # counts modulo sketch error — this engine always counts exactly, so
    # settings are accepted and ignored.
    return FunnelCountSpec(steps, correlate, settings)


def _parse_window(fn: FunctionContext) -> FunnelWindowSpec:
    args = fn.arguments
    if len(args) < 4:
        raise FunnelParseError(
            f"{fn.name} expects (tsExpr, windowSize, numSteps, stepExpr...)")
    try:
        window = int(args[1].literal)
        num_steps = int(args[2].literal)
    except (TypeError, ValueError, AttributeError) as e:
        raise FunnelParseError(
            f"{fn.name}: windowSize/numSteps must be integer literals") from e
    if window <= 0:
        raise FunnelParseError("window size must be > 0")
    if len(args) < 3 + num_steps:
        raise FunnelParseError(
            f"{fn.name}: expected {num_steps} step expressions")
    spec = FunnelWindowSpec(fn.name, args[0], window, num_steps,
                            list(args[3:3 + num_steps]))
    # extras: bare mode names, or MODE=A,B / MAXSTEPDURATION=n key-values
    # (reference FunnelConfigs)
    for a in args[3 + num_steps:]:
        raw = str(a.literal).upper().strip()
        if "=" in raw:
            k, v = (x.strip() for x in raw.split("=", 1))
            if k == "MAXSTEPDURATION":
                spec.max_step_duration = int(v)
                if spec.max_step_duration <= 0:
                    raise FunnelParseError("MaxStepDuration must be > 0")
            elif k == "MODE":
                for m in v.split(","):
                    m = m.strip()
                    if m not in _MODES:
                        raise FunnelParseError(f"unrecognized funnel mode {m}")
                    spec.modes.add(m)
            else:
                raise FunnelParseError(f"unrecognized argument {raw}")
        elif raw in _MODES:
            spec.modes.add(raw)
        else:
            raise FunnelParseError(f"unrecognized funnel mode {raw}")
    return spec


# ---------------------------------------------------------------------------
# Row → state (vectorized per segment)
# ---------------------------------------------------------------------------


def window_row_arrays(executor, spec: FunnelWindowSpec, segment):
    """(ts int64, step int32, valid bool) whole-segment arrays. Step = the
    FIRST matching step expression (reference scans steps in order and
    breaks on the first hit); rows matching none are invalid unless
    KEEP_ALL, which emits step -1 dummy events."""
    n = segment.num_docs
    ts = np.asarray(executor.eval_value(spec.ts_expr, segment),
                    dtype=np.int64)
    step = np.full(n, -1, dtype=np.int32)
    found = np.zeros(n, dtype=bool)
    for j, e in enumerate(spec.step_exprs):
        m = executor._clause_mask(e, segment, False)
        step[~found & m] = j
        found |= m
    valid = np.ones(n, dtype=bool) if "KEEP_ALL" in spec.modes else found
    return ts, step, valid


def window_state(ts: np.ndarray, step: np.ndarray, rows: np.ndarray):
    """Intermediate state: the group's (ts, step) event arrays (unsorted —
    the merge is concat, ordering happens once at finalize, mirroring the
    reference's priority-queue merge)."""
    return (np.ascontiguousarray(ts[rows]), np.ascontiguousarray(step[rows]))


def merge_window_state(a, b):
    return (np.concatenate([a[0], b[0]]), np.concatenate([a[1], b[1]]))


def count_row_arrays(executor, spec: FunnelCountSpec, segment):
    """(correlate values, [step masks]) whole-segment arrays."""
    corr = np.asarray(executor.eval_value(spec.correlate_expr, segment))
    masks = [executor._clause_mask(e, segment, False)
             for e in spec.step_exprs]
    return corr, masks


def count_state(corr: np.ndarray, masks: list, rows: np.ndarray):
    """Per-step sets of correlation values that matched that step."""
    cr = corr[rows]
    return [set(np.unique(cr[m[rows]]).tolist()) for m in masks]


def merge_count_state(a, b):
    return [x | y for x, y in zip(a, b)]


def finalize_count(sets) -> list:
    """Cascading intersection (reference SetMergeStrategy
    .extractFinalResult): counts[i] = |S0 ∩ … ∩ Si|."""
    out = []
    running = None
    for s in sets:
        running = set(s) if running is None else (running & s)
        out.append(len(running))
    return out


# ---------------------------------------------------------------------------
# Finalize: sliding-window scans (reference FunnelBaseAggregationFunction)
# ---------------------------------------------------------------------------


def _sorted_events(state):
    ts, step = state
    if len(ts) == 0:
        return ts, step
    order = np.lexsort((step, ts))  # ts asc, step asc — FunnelStepEvent order
    return ts[order], step[order]


class _EventQueue:
    """Pointer over the sorted event arrays, deque-compatible with the
    reference's PriorityQueue consumption pattern."""

    def __init__(self, ts, step):
        self.ts = ts
        self.step = step
        self.i = 0

    def empty(self):
        return self.i >= len(self.ts)

    def peek(self):
        return self.ts[self.i], self.step[self.i]

    def poll(self):
        e = (int(self.ts[self.i]), int(self.step[self.i]))
        self.i += 1
        return e


def _fill_window(q: _EventQueue, win: deque, spec: FunnelWindowSpec) -> None:
    """Slide so the window starts at a step-0 event, then absorb events
    inside [start, start+window) (bounded by MAXSTEPDURATION gaps)."""
    while win and win[0][1] != 0:
        win.popleft()
    if not win:
        while not q.empty() and q.peek()[1] != 0:
            q.poll()
        if q.empty():
            return
        win.append(q.poll())
    window_end = win[0][0] + spec.window
    while not q.empty() and q.peek()[0] < window_end:
        if spec.max_step_duration > 0 and \
                q.peek()[0] - win[-1][0] > spec.max_step_duration:
            break
        win.append(q.poll())


def _scan_max_step(win: deque, spec: FunnelWindowSpec) -> int:
    """Longest step prefix within one window (FunnelMaxStep.processWindow)."""
    dedup = "STRICT_DEDUPLICATION" in spec.modes
    order = "STRICT_ORDER" in spec.modes
    increase = "STRICT_INCREASE" in spec.modes
    max_step = 0
    prev_ts = -1
    for ts, step in win:
        if dedup and step == max_step - 1:
            return max_step
        if order and step != max_step:
            return max_step
        if increase and prev_ts == ts:
            continue
        if max_step == step:
            max_step += 1
            prev_ts = ts
        if max_step == spec.num_steps:
            break
    return max_step


def max_step(state, spec: FunnelWindowSpec) -> int:
    ts, step = _sorted_events(state)
    q = _EventQueue(ts, step)
    win: deque = deque()
    best = 0
    while not q.empty() or win:
        _fill_window(q, win, spec)
        if not win:
            break
        best = max(best, _scan_max_step(win, spec))
        if best == spec.num_steps:
            break
        if win:
            win.popleft()
    return best


def match_step(state, spec: FunnelWindowSpec) -> list:
    """[1]*maxStep + [0]*(numSteps-maxStep) (FunnelMatchStep)."""
    m = max_step(state, spec)
    return [1] * m + [0] * (spec.num_steps - m)


def complete_count(state, spec: FunnelWindowSpec) -> int:
    """Number of completed funnel rounds (FunnelCompleteCount): maxStep
    RESETS (not returns) on mode violations, and a completed round resets
    the scan with the window re-anchored past the completing event."""
    dedup = "STRICT_DEDUPLICATION" in spec.modes
    order = "STRICT_ORDER" in spec.modes
    increase = "STRICT_INCREASE" in spec.modes
    ts_a, step_a = _sorted_events(state)
    q = _EventQueue(ts_a, step_a)
    win: deque = deque()
    total = 0
    while not q.empty() or win:
        _fill_window(q, win, spec)
        if not win:
            break
        window_start = win[0][0]
        max_stp = 0
        prev_ts = -1
        for ts, step in win:
            if dedup and step == max_stp - 1:
                max_stp = 0
            if order and step != max_stp:
                max_stp = 0
            if increase and prev_ts == ts:
                continue
            prev_ts = ts
            if max_stp == step:
                max_stp += 1
            if max_stp == spec.num_steps:
                total += 1
                max_stp = 0
                window_start = ts
        if win:
            win.popleft()
        while win and win[0][0] < window_start:
            win.popleft()
    return total


# ---------------------------------------------------------------------------
# AggSemantics wiring (engine/aggregation.py dispatches funnel names here)
# ---------------------------------------------------------------------------


def funnel_semantics(fn: FunctionContext):
    """AggSemantics for a funnel expression (imported lazily by
    aggregation.semantics_for to avoid a module cycle)."""
    from .aggregation import AggSemantics

    spec = parse_funnel(fn)
    if isinstance(spec, FunnelCountSpec):
        return AggSemantics(
            merge=merge_count_state,
            finalize=finalize_count,
            result_type="LONG_ARRAY",
            empty_value=[0] * spec.num_steps)
    if spec.name == "funnelmaxstep":
        return AggSemantics(merge_window_state,
                            lambda s, _sp=spec: int(max_step(s, _sp)),
                            "INT", 0)
    if spec.name == "funnelmatchstep":
        return AggSemantics(merge_window_state,
                            lambda s, _sp=spec: match_step(s, _sp),
                            "INT_ARRAY", [0] * spec.num_steps)
    return AggSemantics(merge_window_state,
                        lambda s, _sp=spec: int(complete_count(s, _sp)),
                        "LONG", 0)
