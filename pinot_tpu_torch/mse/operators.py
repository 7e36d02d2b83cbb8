"""MSE runtime operators over columnar blocks.

Reference analogue: pinot-query-runtime/.../runtime/operator/ —
HashJoinOperator, AggregateOperator (+MultistageGroupByExecutor),
WindowAggregateOperator (+.../operator/window/), SortOperator, SetOperator,
FilterOperator, TransformOperator. Execution model differs by design: each
stage materializes its hash-partitioned input and runs whole-partition
vectorized numpy (a host analogue of the reference's block-at-a-time
pull loops); the per-partition work is embarrassingly parallel across
workers, and big leaf aggregations never reach these operators at all —
they're pushed into the single-stage device engine by the leaf compiler.

The port's copy of pinot_tpu/mse/operators.py. Integer keys factorize in
the native host library (segment/native_bridge.py), in first-occurrence
order, as the reference's do. The difference: the pair join's device path (mse/device_join.py) runs on the device the
query's JoinCtx names; an error there fails the query instead of falling
back to the host join.
"""

from __future__ import annotations

import os
import re
import threading
from collections import Counter
from typing import Optional

import numpy as np

from ..engine.aggregation import UnsupportedQueryError, get_semantics, host_state_full
from ..segment import native_bridge
from ..query.expressions import ExpressionContext
from ..query.transforms import eval_expr_np
from .ast import OrderItem, WindowSpec
from .logical import AggCall, WindowCall
from .mailbox import Block, block_len, take_block

EC = ExpressionContext


# -- expression evaluation ---------------------------------------------------


def eval_expr(e: EC, block: Block, n: Optional[int] = None):
    """Evaluate an expression over a block; result is ndarray of length n or
    a scalar. Adds the predicate forms eval_expr_np leaves to FilterContext
    (in/between/like/isnull) since MSE filters stay as raw expressions."""
    if n is None:
        n = block_len(block)
    if e.is_function:
        name = e.function.name
        args = e.function.arguments
        if name in ("in", "notin"):
            v = np.asarray(eval_expr(args[0], block, n))
            vals = [a.literal if a.is_literal else eval_expr(a, block, n) for a in args[1:]]
            mask = np.zeros(len(v) if v.ndim else n, dtype=bool)
            for x in vals:
                mask |= v == x
            return ~mask if name == "notin" else mask
        if name == "between":
            v = eval_expr(args[0], block, n)
            lo = eval_expr(args[1], block, n)
            hi = eval_expr(args[2], block, n)
            return (v >= lo) & (v <= hi)
        if name == "like":
            v = np.asarray(eval_expr(args[0], block, n))
            pat = _like_regex(str(args[1].literal))
            return np.fromiter((bool(pat.fullmatch(str(x))) for x in v),
                               dtype=bool, count=len(v))
        if name in ("regexplike", "regexp_like"):
            v = np.asarray(eval_expr(args[0], block, n))
            pat = re.compile(str(args[1].literal))
            return np.fromiter((bool(pat.search(str(x))) for x in v),
                               dtype=bool, count=len(v))
        if name == "isnull":
            return _null_mask(np.asarray(eval_expr(args[0], block, n)))
        if name == "isnotnull":
            return ~_null_mask(np.asarray(eval_expr(args[0], block, n)))
        if name == "coalesce":
            out = None
            for a in args:
                v = np.asarray(eval_expr(a, block, n))
                if v.ndim == 0:
                    v = np.full(n, v.item() if hasattr(v, "item") else v)
                if out is None:
                    out = v.astype(object) if v.dtype.kind == "O" else v.astype(np.float64) \
                        if v.dtype.kind == "f" else v
                    continue
                mask = _null_mask(np.asarray(out))
                if not mask.any():
                    break
                out = np.where(mask, v, out)
            return out
        # recurse through composite ops so the predicate forms above are
        # reachable at ANY depth (e.g. `x > 5 OR y IN (...)`)
        from ..query.transforms import NP_BIN, NP_UN

        if name in NP_BIN:
            return NP_BIN[name](eval_expr(args[0], block, n),
                                eval_expr(args[1], block, n))
        if name in NP_UN:
            return NP_UN[name](eval_expr(args[0], block, n))
        if name == "case":
            out = eval_expr(args[-1], block, n)
            for i in range(len(args) - 3, -1, -2):
                cond = np.asarray(eval_expr(args[i], block, n)).astype(bool)
                out = np.where(cond, eval_expr(args[i + 1], block, n), out)
            return out
    return eval_expr_np(e, lambda name: _resolve_col(block, name))


def _resolve_col(block: Block, name: str):
    if name in block:
        return np.asarray(block[name])
    matches = [c for c in block if c.endswith("." + name)]
    if len(matches) == 1:
        return np.asarray(block[matches[0]])
    raise UnsupportedQueryError(f"unknown column {name!r} in block {list(block)}")


def _null_mask(v: np.ndarray) -> np.ndarray:
    if v.dtype.kind == "f":
        return np.isnan(v)
    if v.dtype.kind == "O":
        return np.fromiter((x is None or (isinstance(x, float) and np.isnan(x)) for x in v),
                           dtype=bool, count=len(v))
    return np.zeros(len(v), dtype=bool)


def _like_regex(pattern: str) -> "re.Pattern":
    out = []
    for ch in pattern:
        if ch == "%":
            out.append(".*")
        elif ch == "_":
            out.append(".")
        else:
            out.append(re.escape(ch))
    return re.compile("".join(out), re.DOTALL)


def _truthy(v, n: int) -> np.ndarray:
    a = np.asarray(v)
    if a.ndim == 0:
        return np.full(n, bool(a), dtype=bool)
    if a.dtype.kind == "f":
        return ~np.isnan(a) & (a != 0)
    return a.astype(bool)


# -- filter / project --------------------------------------------------------


def op_filter(block: Block, condition: EC) -> Block:
    n = block_len(block)
    mask = _truthy(eval_expr(condition, block, n), n)
    return take_block(block, mask)


def op_project(block: Block, names: list[str], exprs: list[EC]) -> Block:
    n = block_len(block)
    out: Block = {}
    for name, e in zip(names, exprs):
        v = np.asarray(eval_expr(e, block, n))
        if v.ndim == 0:
            v = np.full(n, v.item() if hasattr(v, "item") else v)
        out[name] = v
    return out


# -- group codes -------------------------------------------------------------


def group_codes(cols: list[np.ndarray]):
    """Row tuples → dense int codes. Returns (codes, num_groups,
    first_occurrence_index per group, in first-seen order? no — np.unique
    sorted order; callers use representative indices to recover values)."""
    n = len(cols[0]) if cols else 0
    codes = np.zeros(n, dtype=np.int64)
    num = 1 if n else 0
    for j, c in enumerate(cols):
        inv, card = _factorize(np.asarray(c))
        if j == 0:
            codes, num = inv, card
        else:
            codes, num = _factorize(codes * np.int64(card) + inv)
    # representative row per group (first occurrence in stable sort order)
    order = np.argsort(codes, kind="stable")
    starts = np.searchsorted(codes[order], np.arange(num), "left")
    first = order[starts] if n else starts
    return codes, num, first


def _factorize(a: np.ndarray) -> tuple[np.ndarray, int]:
    """Dense int64 codes + cardinality. Integer keys ride the native
    open-addressing factorizer (csrc/host_native.cpp, the
    DictionaryBasedGroupKeyGenerator analogue: first-occurrence codes);
    object columns dict-encode; everything else, and integers under
    PINOT_TPU_DISABLE_NATIVE, uses np.unique (sorted codes). Callers rely
    only on density, not on code order."""
    if a.dtype.kind in "iub" and native_bridge.enabled():
        codes, uniques = native_bridge.factorize_i64(
            a.astype(np.int64, copy=False))
        return codes, len(uniques)
    if a.dtype.kind == "O":
        # object columns may hold SQL NULLs (None / NaN from outer joins):
        # np.unique cannot order mixed None/str — dict-encode instead.
        # All NULLs land in one group (SQL GROUP BY null semantics).
        table: dict = {}
        codes = np.empty(len(a), dtype=np.int64)
        null_code = -1
        for i, v in enumerate(a):
            if v is None or (isinstance(v, float) and np.isnan(v)):
                if null_code < 0:
                    null_code = len(table)
                    table[_NULL_KEY] = null_code
                codes[i] = null_code
                continue
            c = table.get(v)
            if c is None:
                c = table[v] = len(table)
            codes[i] = c
        return codes, len(table)
    _, inv = np.unique(a, return_inverse=True)
    return inv.astype(np.int64), int(inv.max(initial=-1)) + 1


_NULL_KEY = object()  # sentinel: the NULL group in object factorize


# -- aggregate ---------------------------------------------------------------

_FAST_AGGS = {"count", "sum", "min", "max"}


def op_aggregate(block: Block, group_exprs: list[EC], agg_calls: list[AggCall],
                 schema: list[str]) -> Block:
    n = block_len(block)
    key_vals = [np.asarray(eval_expr(g, block, n)) for g in group_exprs]

    if not group_exprs:
        out: Block = {}
        for call in agg_calls:
            out[call.out_name] = np.asarray([_agg_full(call, block, n)], dtype=object)
        return _tighten(out)

    if n == 0:
        return {c: np.empty(0) for c in schema}

    codes, num, first = group_codes(key_vals)
    out = {}
    for name, kv in zip(schema, key_vals):
        out[name] = kv[first]
    for call in agg_calls:
        out[call.out_name] = _agg_grouped(call, block, codes, num, n)
    return out


def _agg_args(call: AggCall, block: Block, n: int):
    return [np.asarray(eval_expr(a, block, n)) for a in call.args]


def _valid_mask(arg_vals: list[np.ndarray], n: int) -> np.ndarray:
    mask = np.ones(n, dtype=bool)
    for v in arg_vals:
        mask &= ~_null_mask(v)
    return mask


def _cond_mask(call: AggCall, block: Block, n: int):
    """FILTER (WHERE cond) mask; a NULL clause result is false (3VL)."""
    if call.condition is None:
        return None
    v = np.asarray(eval_expr(call.condition, block, n))
    if v.dtype.kind == "O":
        return np.asarray([bool(x) and not (isinstance(x, float) and np.isnan(x))
                           and x is not None for x in v], dtype=bool)
    return v.astype(bool) & ~_null_mask(v)


def _agg_full(call: AggCall, block: Block, n: int):
    """Whole-input aggregate → finalized scalar."""
    sem = get_semantics(call.name, call.extra)
    cmask = _cond_mask(call, block, n)
    if call.name == "count" and not call.args:
        return n if cmask is None else int(cmask.sum())
    vals = _agg_args(call, block, n)
    mask = _valid_mask(vals, n)
    if cmask is not None:
        mask &= cmask
    vals = [v[mask] for v in vals]
    if not (len(vals[0]) if vals else 0) and call.name not in _ZERO_ON_EMPTY:
        return None  # SQL: aggregate over zero (non-null) rows is NULL
    state = host_state_full(call.name, vals, call.extra)
    return sem.finalize(state)


# aggregates whose empty result is a value, not NULL
_ZERO_ON_EMPTY = {"count", "countmv", "distinctcount", "distinctcounthll",
                  "distinctcountbitmap", "distinctcountrawhll", "booland",
                  "boolor", "boolagg", "arrayagg", "listagg", "histogram"}


def _agg_grouped(call: AggCall, block: Block, codes: np.ndarray, num: int, n: int):
    name = call.name
    cmask = _cond_mask(call, block, n)
    if name == "count" and not call.args:
        return np.bincount(codes if cmask is None else codes[cmask],
                           minlength=num).astype(np.int64)
    vals = _agg_args(call, block, n)
    mask = _valid_mask(vals, n)
    if cmask is not None:
        mask &= cmask
    v = vals[0] if vals else None
    if name in _FAST_AGGS and v is not None and v.dtype.kind in "iufb":
        c = codes[mask]
        x = v[mask].astype(np.float64)
        valid = np.bincount(c, minlength=num)
        if name == "count":
            return valid.astype(np.int64)
        if name == "sum":
            out = np.bincount(c, weights=x, minlength=num)
        else:
            out = np.full(num, np.inf if name == "min" else -np.inf)
            (np.minimum if name == "min" else np.maximum).at(out, c, x)
        out[valid == 0] = np.nan  # all-NULL group → NULL
        return out
    if name == "avg" and v is not None and v.dtype.kind in "iufb":
        c = codes[mask]
        s = np.bincount(c, weights=v[mask].astype(np.float64), minlength=num)
        cnt = np.bincount(c, minlength=num)
        with np.errstate(invalid="ignore"):
            return s / cnt
    # generic: per-group host state + finalize
    sem = get_semantics(name, call.extra)
    order = np.argsort(codes[mask], kind="stable")
    mvals = [x[mask][order] for x in vals]
    mcodes = codes[mask][order]
    bounds = np.searchsorted(mcodes, np.arange(num + 1), "left")
    out = []
    for g in range(num):
        lo, hi = bounds[g], bounds[g + 1]
        if lo == hi:
            out.append(sem.empty_value if name in _ZERO_ON_EMPTY else None)
            continue
        state = host_state_full(name, [x[lo:hi] for x in mvals], call.extra)
        out.append(sem.finalize(state))
    return _tighten_col(np.asarray(out, dtype=object))


def _tighten(block: Block) -> Block:
    return {k: _tighten_col(v) for k, v in block.items()}


def _tighten_col(v: np.ndarray) -> np.ndarray:
    if v.dtype.kind != "O":
        return v
    try:
        kinds = {type(x) for x in v}
        if kinds <= {int, np.int64, bool}:
            return v.astype(np.int64)
        if kinds <= {float, int, np.float64, np.int64}:
            return v.astype(np.float64)
    except (TypeError, ValueError):
        pass
    return v


# -- hash join ---------------------------------------------------------------


class JoinRowLimitExceeded(Exception):
    """The join would materialize more rows than maxRowsInJoin (reference:
    HashJoinOperator's join-overflow THROW mode)."""


# reference defaults: maxRowsInJoin (InstancePlanMakerImplV2 /
# HashJoinOperator); override per deployment via PINOT_TPU_MAX_ROWS_IN_JOIN
MAX_ROWS_IN_JOIN = int(os.environ.get("PINOT_TPU_MAX_ROWS_IN_JOIN",
                                      5_000_000))
# THROW (fail the query) or BREAK (truncate and mark partial)
JOIN_OVERFLOW_MODE = os.environ.get("PINOT_TPU_JOIN_OVERFLOW_MODE",
                                    "THROW").upper()


_overflow = threading.local()


def pop_join_overflow() -> bool:
    """True if a BREAK-mode truncation happened since the last call on this
    thread — the runtime surfaces it as a partial-result marker (reference:
    HashJoinOperator sets maxRowsInJoinReached in the stats)."""
    hit = getattr(_overflow, "hit", False)
    _overflow.hit = False
    return hit


def _guard_join_rows(total: int, ln: int, rn: int,
                     join_type: str) -> Optional[int]:
    """Returns a truncation bound in BREAK mode, raises in THROW mode, None
    when under the limit — checked BEFORE materializing index arrays so an
    accidental many-to-many cross blowup cannot OOM the host silently.
    ANTI/RIGHT/FULL joins always raise: truncating their inputs would emit
    WRONG rows (false anti-matches, false null-padded right rows), not a
    partial subset."""
    if total <= MAX_ROWS_IN_JOIN:
        return None
    if JOIN_OVERFLOW_MODE == "BREAK" and join_type in ("INNER", "LEFT",
                                                       "SEMI", "CROSS"):
        _overflow.hit = True
        return MAX_ROWS_IN_JOIN
    raise JoinRowLimitExceeded(
        f"{join_type} join would produce {total} rows ({ln}x{rn} inputs), "
        f"over maxRowsInJoin={MAX_ROWS_IN_JOIN}"
        + ("" if JOIN_OVERFLOW_MODE == "BREAK" else
           "; set PINOT_TPU_JOIN_OVERFLOW_MODE=BREAK to truncate instead"))


class JoinCtx:
    """Per-query join state shared by every partition (and worker thread)
    of a join stage: persistent value→code maps keyed by (stage, key
    position) so a second partition factorizes only values it has not seen,
    plus counters for the perf plane (int fast-path, cache reuse).
    ``device`` is the executor's torch device, where the device joins of
    the query run (None: host joins only)."""

    def __init__(self, device=None):
        self.device = device
        self.counters: Counter = Counter()
        self._maps: dict = {}
        self.lock = threading.RLock()

    def for_stage(self, stage_id: int) -> "_StageJoinCtx":
        return _StageJoinCtx(self, stage_id)

    def mapping(self, stage_id: int, pos: int) -> dict:
        with self.lock:
            return self._maps.setdefault((stage_id, pos), {})

    def bump(self, name: str) -> None:
        with self.lock:
            self.counters[name] += 1


class _StageJoinCtx:
    """JoinCtx view bound to one stage id (what op_join receives)."""

    __slots__ = ("_ctx", "_stage")

    def __init__(self, ctx: JoinCtx, stage_id: int):
        self._ctx = ctx
        self._stage = stage_id

    @property
    def device(self):
        return self._ctx.device

    @property
    def lock(self):
        return self._ctx.lock

    @property
    def counters(self) -> Counter:
        return self._ctx.counters

    def mapping(self, pos: int) -> dict:
        return self._ctx.mapping(self._stage, pos)

    def bump(self, name: str) -> None:
        self._ctx.bump(name)


def op_join(left: Block, right: Block, join_type: str,
            left_keys: list[str], right_keys: list[str],
            residual: Optional[EC], schema: list[str],
            ctx=None) -> Block:
    """Late-materialized hash join: match on key codes, thread (lidx, ridx)
    index pairs through residual/SEMI/ANTI/padding, and gather ONLY the
    columns the output schema demands at the very end. An empty schema means
    "emit everything" (back-compat for direct callers)."""
    ln = block_len(left)
    rn = block_len(right)

    if join_type == "CROSS" or not left_keys:
        kind = join_type if join_type in ("SEMI", "ANTI") else "CROSS"
        cap = _guard_join_rows(ln * rn, ln, rn, kind)
        if cap is not None:
            # truncate BOTH sides so ln*rn ≤ cap even when one side alone
            # exceeds it
            rn = min(rn, max(1, cap // max(ln, 1)))
            ln = min(ln, max(1, cap // rn))
            left = take_block(left, np.arange(ln))
            right = take_block(right, np.arange(rn))
        lidx = np.repeat(np.arange(ln), rn)
        ridx = np.tile(np.arange(rn), ln)
        if residual is not None and len(lidx):
            rb = _residual_block(left, right, lidx, ridx, residual)
            m = _truthy(eval_expr(residual, rb, len(lidx)), len(lidx))
            lidx, ridx = lidx[m], ridx[m]
        if join_type in ("SEMI", "ANTI"):
            sel = np.unique(lidx)
            if join_type == "ANTI":
                sel = np.setdiff1d(np.arange(ln), sel)
            return _project_side(left, schema, sel)
        return _emit(left, right, lidx, ridx, schema)

    # dict-encode key tuples across both sides so codes are comparable
    lcodes, rcodes = _joint_codes(
        [np.asarray(left[k]) for k in left_keys],
        [np.asarray(right[k]) for k in right_keys], ln, rn, ctx)

    lidx = ridx = None
    device_used = False
    from . import device_join

    device = getattr(ctx, "device", None)
    if device_join.enabled(ln, rn, device):
        # large sides: the sort + binary-search runs on the device
        # (mse/device_join.py); only int64 key codes travel. Overflow
        # takes the host path, which owns the THROW/BREAK guard
        # semantics; an error in the device join fails the query.
        li, ri, total = device_join.device_join_indices(
            lcodes, rcodes, MAX_ROWS_IN_JOIN, device)
        if total <= MAX_ROWS_IN_JOIN:
            lidx = li.astype(np.int64)
            ridx = ri.astype(np.int64)
            device_used = True

    if lidx is None:
        rs = np.argsort(rcodes, kind="stable")
        sorted_r = rcodes[rs]
        starts = np.searchsorted(sorted_r, lcodes, "left")
        ends = np.searchsorted(sorted_r, lcodes, "right")
        counts = ends - starts
        total = int(counts.sum())
        cap = _guard_join_rows(total, ln, rn, join_type)
        if cap is not None:
            # BREAK: keep whole left rows up to the cap (partial result)
            keep = np.searchsorted(np.cumsum(counts), cap, "right")
            counts = counts[:keep]
            starts = starts[:keep]
            ln = keep
            left = take_block(left, np.arange(keep))
            total = int(counts.sum())
        lidx = np.repeat(np.arange(ln), counts)
        offs = np.arange(total) - np.repeat(np.cumsum(counts) - counts, counts)
        ridx = rs[np.repeat(starts, counts) + offs]

    if residual is not None and len(lidx):
        # evaluate over a gather of ONLY the residual's columns, not the
        # whole combined row set
        rb = _residual_block(left, right, lidx, ridx, residual)
        m = _truthy(eval_expr(residual, rb, len(lidx)), len(lidx))
        lidx, ridx = lidx[m], ridx[m]

    if join_type == "SEMI":
        return _project_side(left, schema, np.unique(lidx))
    if join_type == "ANTI":
        return _project_side(left, schema,
                             np.setdiff1d(np.arange(ln), np.unique(lidx)))

    if join_type in ("LEFT", "FULL"):
        matched_l = np.zeros(ln, dtype=bool)
        matched_l[lidx] = True
        extra_l = np.nonzero(~matched_l)[0]
        lidx = np.concatenate([lidx, extra_l])
        ridx = np.concatenate([ridx, np.full(len(extra_l), -1, dtype=np.int64)])
        device_used = False
    if join_type in ("RIGHT", "FULL"):
        matched_r = np.zeros(rn, dtype=bool)
        if len(ridx):
            matched_r[ridx[ridx >= 0]] = True
        extra_r = np.nonzero(~matched_r)[0]
        lidx = np.concatenate([lidx, np.full(len(extra_r), -1, dtype=np.int64)])
        ridx = np.concatenate([ridx, extra_r])
        device_used = False

    return _emit(left, right, lidx, ridx, schema,
                 device if device_used else None)


def _expr_ids(e: EC, out: set) -> None:
    if e.is_identifier:
        out.add(e.identifier)
    elif e.is_function:
        for a in e.function.arguments:
            _expr_ids(a, out)


def _residual_block(left: Block, right: Block, lidx: np.ndarray,
                    ridx: np.ndarray, residual: EC) -> Block:
    """Gather only the columns the residual filter references (qualified or
    suffix-matchable), mirroring _combine's dup naming so eval_expr resolves
    identifiers identically to the old full-row path."""
    ids: set = set()
    _expr_ids(residual, ids)

    def want(c: str) -> bool:
        return c in ids or any(c.endswith("." + i) for i in ids)

    out: Block = {}
    for c, v in left.items():
        if want(c):
            out[c] = _gather_pad(np.asarray(v), lidx)
    for c, v in right.items():
        if not want(c):
            continue
        name = c if c not in out else c + "0"
        out[name] = _gather_pad(np.asarray(v), ridx)
    return out


def _project_side(side: Block, schema: list[str], sel: np.ndarray) -> Block:
    """SEMI/ANTI output: rows of one side, trimmed to the columns the
    output schema still needs."""
    proj = {c: side[c] for c in schema if c in side}
    return take_block(proj if proj else side, sel)


def _emit(left: Block, right: Block, lidx: np.ndarray, ridx: np.ndarray,
          schema: list[str], device=None) -> Block:
    """The deferred gather: materialize exactly the schema's columns from
    the surviving index pairs. Right-side columns may appear under their
    own name or _combine's dup suffix (c+"0"). ``device`` is set when the
    pairs came from the device join: numeric payload columns then gather
    there in one pass (mse/device_join.py gather_payload)."""
    if not schema:
        return _combine(left, right, lidx, ridx)
    plan: list[tuple] = []
    for name in schema:
        if name in left:
            plan.append((name, True, np.asarray(left[name])))
        elif name in right:
            plan.append((name, False, np.asarray(right[name])))
        elif name.endswith("0") and name[:-1] in right:
            plan.append((name, False, np.asarray(right[name[:-1]])))
        else:
            raise UnsupportedQueryError(
                f"join schema column {name!r} missing from inputs")
    out: Block = {}
    for is_left, idx in ((True, lidx), (False, ridx)):
        cols = {nm: a for nm, s, a in plan if s is is_left}
        if not cols:
            continue
        got = None
        if (device is not None and len(cols) > 1 and len(idx)
                and all(a.dtype.kind in "iufb" for a in cols.values())
                and int(idx.min()) >= 0):
            from . import device_join
            got = device_join.gather_payload(cols, idx, device)
        if got is None:
            got = {nm: _gather_pad(a, idx) for nm, a in cols.items()}
        out.update(got)
    return {nm: out[nm] for nm, _, _ in plan}


def _int_like(c: np.ndarray) -> bool:
    # uint64 is excluded: viewing it as int64 would alias large values onto
    # real negatives from the other side
    return c.dtype.kind in "ib" or (c.dtype.kind == "u" and c.dtype.itemsize < 8)


_FALLBACK_LOCK = threading.RLock()  # string-code path without a JoinCtx


def _joint_codes(lcols, rcols, ln, rn, ctx=None):
    if len(lcols) == 1:
        lc, rc = lcols[0], rcols[0]
        if _int_like(lc) and _int_like(rc):
            # already-integer keys ARE their own codes (q8's lo_orderkey):
            # skip factorization entirely. Int columns cannot hold SQL
            # NULL, so no sentinel handling is needed here.
            if ctx is not None:
                ctx.bump("joint_codes_int_fastpath")
            return lc.astype(np.int64), rc.astype(np.int64)
        il, ir, _ = _column_codes(lc, rc, ln, ctx, 0)
        return il, ir
    codes_l = np.zeros(ln, dtype=np.int64)
    codes_r = np.zeros(rn, dtype=np.int64)
    for pos, (lc, rc) in enumerate(zip(lcols, rcols)):
        il, ir, m = _column_codes(lc, rc, ln, ctx, pos)
        mm = np.int64(max(m, 1))
        combined_l = codes_l * mm + il
        combined_r = codes_r * mm + ir
        _, inv2 = np.unique(np.concatenate([combined_l, combined_r]),
                            return_inverse=True)
        codes_l, codes_r = inv2[:ln].astype(np.int64), inv2[ln:].astype(np.int64)
    return codes_l, codes_r


def _column_codes(lc: np.ndarray, rc: np.ndarray, ln: int, ctx, pos: int):
    """Per-column join codes: int64 arrays in [0, m) where equal non-NULL
    values share a code and NULL keys never match across sides (left NULLs
    take code m-2, right NULLs m-1). Returns (lcodes, rcodes, m)."""
    if _int_like(lc) and _int_like(rc):
        both = np.concatenate([lc.astype(np.int64), rc.astype(np.int64)])
        _, inv = np.unique(both, return_inverse=True)
        m = int(inv.max(initial=-1)) + 1
        return (inv[:ln].astype(np.int64), inv[ln:].astype(np.int64), m)
    if lc.dtype.kind in "iufb" and rc.dtype.kind in "iufb":
        l64 = lc.astype(np.float64)
        r64 = rc.astype(np.float64)
        nl, nr = np.isnan(l64), np.isnan(r64)
        both = np.concatenate([np.where(nl, 0.0, l64), np.where(nr, 0.0, r64)])
        _, inv = np.unique(both, return_inverse=True)
        m = int(inv.max(initial=-1)) + 1
        il = inv[:ln].astype(np.int64)
        ir = inv[ln:].astype(np.int64)
        il[nl] = m      # NaN is SQL NULL: never equal, not even to itself
        ir[nr] = m + 1
        return il, ir, m + 2
    # string/object path: persistent value→code map (JoinCtx) so a second
    # partition of the same stage reuses codes instead of re-factorizing
    lock = ctx.lock if ctx is not None else _FALLBACK_LOCK
    with lock:
        mp = ctx.mapping(pos) if ctx is not None else {}
        if ctx is not None and mp:
            ctx.bump("joint_codes_cache_hits")
        nl = _null_mask(lc) if lc.dtype.kind == "O" else \
            np.zeros(len(lc), dtype=bool)
        nr = _null_mask(rc) if rc.dtype.kind == "O" else \
            np.zeros(len(rc), dtype=bool)
        il = _mapped_codes(np.where(nl, "", lc) if nl.any() else lc, mp)
        ir = _mapped_codes(np.where(nr, "", rc) if nr.any() else rc, mp)
        m = len(mp)
    il[nl] = m
    ir[nr] = m + 1
    return il, ir, m + 2


def _mapped_codes(arr: np.ndarray, mp: dict) -> np.ndarray:
    """Dense codes from a persistent value→code dict; values normalize
    through str() (matching the old astype(str) factorization, where 1 and
    "1" joined). Caller holds the map's lock."""
    get = mp.get

    def code(x):
        if type(x) is not str:
            x = str(x)
        c = get(x)
        if c is None:
            c = mp[x] = len(mp)
        return c

    return np.fromiter((code(x) for x in arr), dtype=np.int64,
                       count=len(arr))


def _combine(left: Block, right: Block, lidx: np.ndarray, ridx: np.ndarray) -> Block:
    out: Block = {}
    for c, v in left.items():
        out[c] = _gather_pad(np.asarray(v), lidx)
    for c, v in right.items():
        name = c if c not in out else c + "0"
        out[name] = _gather_pad(np.asarray(v), ridx)
    return out


def _gather_pad(v: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """Gather with -1 → SQL NULL (NaN for numerics, None for objects)."""
    if not len(idx):
        return v[:0]
    mask = idx < 0
    out = v[np.clip(idx, 0, max(len(v) - 1, 0))]
    if mask.any():
        if v.dtype.kind in "iub":
            out = out.astype(np.float64)
            out[mask] = np.nan
        elif v.dtype.kind == "f":
            out = out.copy()
            out[mask] = np.nan
        else:
            out = out.astype(object)
            out[mask] = None
    return out


# -- window ------------------------------------------------------------------


def op_window(block: Block, calls: list[WindowCall], schema: list[str]) -> Block:
    n = block_len(block)
    out = dict(block)
    for call in calls:
        out[call.out_name] = _window_call(block, call, n)
    return out


def _desc_rank(r: np.ndarray) -> np.ndarray:
    """Descending sort key for one rank array. Floats negate exactly;
    integer keys dense-rank first (unique inverse) and negate in int64 —
    a float64 cast would collapse int64 keys above 2^53, and native int64
    negation overflows on INT64_MIN."""
    if r.dtype.kind == "f":
        return -r
    return -np.unique(r, return_inverse=True)[1].astype(np.int64)


def _order_rank_arrays(v: np.ndarray) -> list[np.ndarray]:
    """Sortable numeric arrays for one ORDER BY column, minor-first
    ([value, class]), matching _sort_key's NULL<numeric<string classes."""
    if v.dtype.kind in "iub":
        return [v]
    if v.dtype.kind == "f":
        nan = np.isnan(v)
        return [np.where(nan, 0.0, v), np.where(nan, 0, 1)]
    keys = [_sort_key(x) for x in v]
    uniq = {k: i for i, k in enumerate(sorted(set(keys)))}
    return [np.asarray([uniq[k] for k in keys], dtype=np.int64)]


def _window_call(block: Block, call: WindowCall, n: int) -> np.ndarray:
    """One window column, fully vectorized (reference:
    WindowAggregateOperator + window/ frames in pinot-query-runtime).
    Global lexsort (partition major, order keys minor) + segment-boundary
    arithmetic replaces per-group Python sorting; only exotic frames
    (sliding MIN/MAX etc.) drop to a per-partition loop."""
    spec: WindowSpec = call.spec
    pcols = [np.asarray(eval_expr(p, block, n)) for p in spec.partition_by]
    if pcols:
        codes, num, _ = group_codes(pcols)
    else:
        codes, num = np.zeros(n, dtype=np.int64), 1 if n else 0
    ocols = [(np.asarray(eval_expr(e, block, n)), asc) for e, asc in spec.order_by]

    if n == 0:
        return np.empty(0)

    # whole-partition aggregates don't need ordering at all: reuse the
    # grouped-aggregate kernels and broadcast per-group results
    if not spec.order_by and spec.frame is None and call.name not in (
            "rownumber", "rank", "denserank", "cumedist", "percentrank",
            "ntile", "lag", "lead", "firstvalue", "lastvalue"):
        per_group = _agg_grouped(AggCall(call.name, call.args, "$w"),
                                 block, codes, num, n)
        return _tighten_col(np.asarray(per_group, dtype=object)[codes])

    # global ordering: minor→major key list for lexsort (codes are primary)
    lex: list[np.ndarray] = []
    rank_arrays: list[list[np.ndarray]] = []  # per order col, asc direction
    for v, asc in ocols:
        rank_arrays.append(_order_rank_arrays(v))
    for (v, asc), ranks in zip(reversed(ocols), reversed(rank_arrays)):
        lex.extend(r if asc else _desc_rank(r) for r in ranks)
    lex.append(codes)
    order = np.lexsort(lex)

    scodes = codes[order]
    idx = np.arange(n, dtype=np.int64)
    pstart = np.empty(n, dtype=bool)
    pstart[0] = True
    pstart[1:] = scodes[1:] != scodes[:-1]
    pstart_idx = np.maximum.accumulate(np.where(pstart, idx, 0))
    is_last = np.empty(n, dtype=bool)
    is_last[:-1] = pstart[1:]
    is_last[-1] = True
    pend_idx = np.minimum.accumulate(
        np.where(is_last, idx, n - 1)[::-1])[::-1]
    pos = idx - pstart_idx
    k_arr = pend_idx - pstart_idx + 1

    newkey = pstart.copy()
    for ranks in rank_arrays:
        for r in ranks:
            rs = r[order]
            newkey[1:] |= rs[1:] != rs[:-1]

    out_sorted = np.asarray(_window_sorted(
        block, call, ocols, order, n, pstart, pstart_idx, pend_idx, pos,
        k_arr, newkey, idx))
    result = np.empty(n, dtype=out_sorted.dtype)
    result[order] = out_sorted
    return _tighten_col(result)


def _window_sorted(block, call, ocols, order, n, pstart, pstart_idx,
                   pend_idx, pos, k_arr, newkey, idx) -> np.ndarray:
    """Window values in sorted (partition, order-key) order."""
    name = call.name
    if name == "rownumber":
        return pos + 1
    if name in ("rank", "denserank", "percentrank"):
        lastkey_idx = np.maximum.accumulate(np.where(newkey, idx, 0))
        rank = lastkey_idx - pstart_idx + 1
        if name == "rank":
            return rank
        if name == "percentrank":
            return np.where(k_arr > 1, (rank - 1) / np.maximum(k_arr - 1, 1), 0.0)
        dense = np.cumsum(newkey)
        return dense - dense[pstart_idx] + 1
    if name == "cumedist":
        grp = np.cumsum(newkey) - 1  # global peer-group id, nondecreasing
        grp_end = np.searchsorted(grp, np.arange(grp[-1] + 2), "left")[1:] - 1
        return (grp_end[grp] - pstart_idx + 1) / k_arr
    if name == "ntile":
        buckets = int(call.args[0].literal) if call.args else 1
        return (pos * buckets // k_arr) + 1
    if name in ("lag", "lead"):
        v = np.asarray(eval_expr(call.args[0], block, n))[order]
        off = int(call.args[1].literal) if len(call.args) > 1 else 1
        default = call.args[2].literal if len(call.args) > 2 else None
        tgt = idx - off if name == "lag" else idx + off
        valid = (tgt >= pstart_idx) & (tgt <= pend_idx)
        out = np.empty(n, dtype=object)
        out[:] = v[np.clip(tgt, 0, n - 1)]
        out[~valid] = default
        return out
    if name in ("firstvalue", "lastvalue"):
        v = np.asarray(eval_expr(call.args[0], block, n))[order]
        return v[pstart_idx if name == "firstvalue" else pend_idx]

    # aggregates over the window frame
    frame = call.spec.frame
    if not call.spec.order_by and frame is None:
        per_group = _agg_grouped(AggCall(name, call.args, "$w"), block,
                                 np.cumsum(pstart) - 1, int(pstart.sum()), n)
        # codes in sorted space = partition ordinal
        return np.asarray(per_group, dtype=object)[np.cumsum(pstart) - 1]
    if frame is None:
        frame = ("RANGE", None, 0)
    kind, start, end = frame

    vals = [np.asarray(eval_expr(a, block, n))[order] for a in call.args]
    numeric = all(v.dtype.kind in "iufb" for v in vals)
    # vectorized running frames: UNBOUNDED PRECEDING → CURRENT ROW (+peers
    # for RANGE) for COUNT/SUM/AVG — prefix sums reproduce the sequential
    # left-to-right addition order of a from-scratch per-frame sum
    if start is None and end == 0 and name in ("count", "sum", "avg") \
            and (numeric or not vals):
        if kind == "RANGE" and call.spec.order_by:
            grp = np.cumsum(newkey) - 1
            grp_end = np.searchsorted(grp, np.arange(grp[-1] + 2), "left")[1:] - 1
            hi = grp_end[grp]  # frame end includes peers
        else:
            hi = idx
        if vals:
            nulls = _null_mask(vals[0])
            w = np.where(nulls, 0, vals[0])
            cnt_prefix = np.cumsum(~nulls)
        else:
            w = np.ones(n, dtype=np.int64)
            cnt_prefix = idx + 1
        counts = cnt_prefix[hi] - np.where(
            pstart_idx > 0, cnt_prefix[pstart_idx - 1], 0)
        if name == "count":
            return counts
        prefix = np.cumsum(w.astype(np.float64) if w.dtype.kind == "f"
                           else w.astype(np.int64))
        sums = prefix[hi] - np.where(pstart_idx > 0, prefix[pstart_idx - 1], 0)
        if name == "sum":
            return np.where(counts > 0, sums, np.nan) if vals else sums
        with np.errstate(invalid="ignore"):
            return np.where(counts > 0, sums / np.maximum(counts, 1), np.nan)

    # fallback: per-partition loop for exotic frames (sliding MIN/MAX, ...)
    sem = get_semantics(name)
    keys = None
    if kind == "RANGE" and call.spec.order_by:
        grp = np.cumsum(newkey) - 1
        grp_end = np.searchsorted(grp, np.arange(grp[-1] + 2), "left")[1:] - 1
    out = np.empty(n, dtype=object)
    for i in range(n):
        p0, p1 = pstart_idx[i], pend_idx[i]
        lo = p0 if start is None else max(p0, i + start)
        hi = p1 + 1 if end is None else min(p1 + 1, i + end + 1)
        if kind == "RANGE" and call.spec.order_by:
            hi = max(hi, grp_end[grp[i]] + 1)
        if name == "count" and not vals:
            out[i] = hi - lo
        else:
            seg = [v[lo:hi] for v in vals]
            out[i] = sem.finalize(host_state_full(name, seg, ()))
    return out


def _sort_key(x):
    if x is None:
        return (0, 0)
    if isinstance(x, (int, float, np.integer, np.floating)):
        if isinstance(x, float) and np.isnan(x):
            return (0, 0)
        return (1, float(x))
    return (2, str(x))


# -- set operations ----------------------------------------------------------


def op_setop(kind: str, all_: bool, left: Block, right: Block,
             schema: list[str]) -> Block:
    lrows = _rows_of(left, schema)
    rrows = _rows_of(right, schema)
    if kind == "UNION":
        rows = lrows + rrows if all_ else list(dict.fromkeys(lrows + rrows))
    elif kind == "INTERSECT":
        if all_:  # bag semantics: emit min(countL, countR) copies per row
            rcount = Counter(rrows)
            rows = []
            for r in lrows:
                if rcount.get(r, 0) > 0:
                    rcount[r] -= 1
                    rows.append(r)
        else:
            rset = set(rrows)
            rows = list(dict.fromkeys(r for r in lrows if r in rset))
    else:  # EXCEPT
        if all_:  # bag semantics: subtract counts, max(0, countL - countR)
            rcount = Counter(rrows)
            rows = []
            for r in lrows:
                if rcount.get(r, 0) > 0:
                    rcount[r] -= 1
                else:
                    rows.append(r)
        else:
            rset = set(rrows)
            rows = list(dict.fromkeys(r for r in lrows if r not in rset))
    return _rows_to_block(rows, schema)


def _rows_of(block: Block, schema: list[str]) -> list[tuple]:
    n = block_len(block)
    cols = [np.asarray(block[c]) for c in schema]
    return [tuple(_item(c[i]) for c in cols) for i in range(n)]


def _rows_to_block(rows: list[tuple], schema: list[str]) -> Block:
    if not rows:
        return {c: np.empty(0) for c in schema}
    out = {}
    for j, c in enumerate(schema):
        out[c] = _tighten_col(np.asarray([r[j] for r in rows], dtype=object))
    return out


def _item(v):
    return v.item() if isinstance(v, np.generic) else v


# -- sort --------------------------------------------------------------------


def op_sort(block: Block, sort_items: list[OrderItem], limit: Optional[int],
            offset: int) -> Block:
    n = block_len(block)
    if sort_items and n:
        idx = list(range(n))
        for it in reversed(sort_items):
            vals = np.asarray(eval_expr(it.expression, block, n))
            if vals.ndim == 0:
                continue
            idx.sort(key=lambda i: _sort_key(vals[i]), reverse=not it.ascending)
        block = take_block(block, np.asarray(idx))
    if limit is not None or offset:
        end = None if limit is None else offset + limit
        block = {c: np.asarray(v)[offset:end] for c, v in block.items()}
    return block
