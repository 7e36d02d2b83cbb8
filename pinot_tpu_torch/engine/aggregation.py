"""Aggregation functions: device lowering + host semantics.

The port of pinot_tpu/engine/aggregation.py for every aggregation the JAX
package lowers to its device: those over single-value columns, and the
*MV value functions (COUNTMV, SUMMV, MINMV, MAXMV, AVGMV, MINMAXRANGEMV)
over a multi-value column, which reduce each doc's values to one value
first. Each SQL aggregation splits into
  1. primitive device reductions (ir.AggOp: count / sum / sumsq / min /
     max, and the matrix-shaped distinct_bitmap / value_hist /
     hist_adaptive / hist_fixed) run by the segment interpreter
     (ops/kernels.py),
  2. a host-side intermediate state per group (a number, a tuple of
     sums, a set of values, or a sketch of utils/sketches.py), and
  3. `AggSemantics` (merge across segments + finalize at broker reduce).

Result types follow the reference (AggregationFunction
.getFinalResultColumnType): COUNT -> LONG, SUM/MIN/MAX/AVG/PERCENTILE* ->
DOUBLE, DISTINCTCOUNT -> INT, DISTINCTCOUNTHLL/THETA -> LONG. Where the JAX
package sends a query to its host engine (the matrix-shaped MV functions
such as DISTINCTCOUNTMV and PERCENTILEMV, the matrix-shaped functions over
a multi-value column, EXPRMIN and the other object-valued functions,
nullable operands of the non-filterable functions under
enableNullHandling, a FILTER clause over them, the FUNNEL family), the
port's planner raises UnsupportedQueryError. Under QueryExecutor's
backend "host" or "auto" the host engine (engine/host_executor.py) then
answers the segment; under the default "device", execute_sql retries the
query on the multi-stage engine, as the JAX package does under
backend="tpu". `get_semantics` and `host_state_full` know those functions,
and `semantics_for` the funnels (engine/funnel.py).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from decimal import Decimal
from typing import Callable

import numpy as np

from ..query.expressions import PERCENTILE_SUFFIX_RE as _PCT_SUFFIX
from ..query.expressions import ExpressionContext, FunctionContext
from ..utils.sketches import (HyperLogLog, SmartDistinctSet, TDigest,
                              ThetaSketch, ValueHist)
from . import ir
# funnel.py imports this module only inside funnel_semantics: no cycle
from .funnel import FUNNEL_FNS


class UnsupportedQueryError(Exception):
    """A query shape this port does not lower to the device. Under
    QueryExecutor's default backend "device" the query fails with it (and
    execute_sql retries it on the multi-stage engine); under "auto" the
    segment answers on the host engine (engine/host_executor.py)."""


class MultistageRefusal(UnsupportedQueryError):
    """A query-level shape the single-stage engine refuses and the
    multi-stage engine answers (a selection ORDER BY on an unselected
    column, a HAVING predicate the broker reduce does not evaluate):
    `QueryExecutor.execute_sql` retries these there, as the reference's
    engine selection does."""


@dataclass
class AggSemantics:
    """Cross-segment merge + broker finalize for one aggregation function."""

    merge: Callable  # (a, b) -> state
    finalize: Callable  # (state) -> python scalar
    result_type: str
    empty_value: object  # result when zero rows matched (aggregation query)


# (merge spec, finalize tag) per scalar aggregation
VEC_RECIPES = {
    "count": (("add",), ("id", 0)),
    "sum": (("add",), ("id", 0)),
    "min": (("min",), ("id", 0)),
    "max": (("max",), ("id", 0)),
    "avg": (("add", "add"), ("div", 0, 1)),
    "minmaxrange": (("min", "max"), ("sub", 1, 0)),
}


@dataclass
class VecAgg:
    """Columnar form of one aggregation: extract pulls per-component numpy
    columns for ALL groups at once; spec gives each component's
    cross-segment merge op; fin_tag is the finalize recipe evaluated by the
    broker reducer (("id", c) | ("div", a, b) | ("sub", a, b) over
    component indices)."""

    spec: tuple  # per component: "add" | "min" | "max"
    extract: Callable  # (outs, gids) -> tuple[np.ndarray, ...]
    fin_tag: tuple


@dataclass
class LoweredAgg:
    """Device lowering of one SQL aggregation: how to read kernel outputs.
    extract(outs, g) builds group g's intermediate state from the kernel
    output tuple (outs[0] is always the per-group row count). vec, when
    set, is the whole-table columnar form."""

    name: str
    semantics: AggSemantics
    extract: Callable  # (outs, g) -> state
    vec: "VecAgg | None" = None


# Argument model: leading args are data expressions, the rest literal
# parameters (PERCENTILE(col, 95), HISTOGRAM(col, 0, 100, 10), ...).
_DATA_ARITY = {
    "count": 1,
    "covarpop": 2,
    "covarsamp": 2,
    "corr": 2,
    "exprmin": 2,
    "exprmax": 2,
    "firstwithtime": 2,
    "lastwithtime": 2,
}


def canonicalize(name: str, extra: tuple) -> tuple[str, tuple]:
    """Legacy digit-suffixed percentiles: PERCENTILE95(col) is
    PERCENTILE(col, 95)."""
    m = _PCT_SUFFIX.match(name)
    if m:
        base = m.group(1) + (m.group(3) or "")
        return base, (int(m.group(2)),) + extra
    return name, extra


def split_args(fn: FunctionContext):
    """-> (data_arg_expressions, literal_extras)."""
    arity = _DATA_ARITY.get(_PCT_SUFFIX.sub(lambda m: m.group(1), fn.name), 1)
    data = list(fn.arguments[:arity])
    extra = []
    for a in fn.arguments[arity:]:
        if not a.is_literal:
            raise UnsupportedQueryError(
                f"{fn.name}: parameter {a} must be a literal")
        extra.append(a.literal)
    return data, tuple(extra)


def semantics_for(expr: ExpressionContext) -> AggSemantics:
    fn = expr.function
    if fn.name == "filter":  # FILTER (WHERE ...) wrapper: inner semantics
        return semantics_for(fn.arguments[0])
    if fn.name in FUNNEL_FNS:  # funnel args are not (data, literal*)
        from .funnel import funnel_semantics

        return funnel_semantics(fn)
    _, extra = split_args(fn)
    return get_semantics(fn.name, extra)


def _pct(extra, default=50.0) -> float:
    return float(extra[0]) if extra else default


def _var_finalize(name: str):
    def fin(state):
        n, s, sq = state
        if n == 0 or (name.endswith("samp") and n < 2):
            return math.nan
        var = sq / n - (s / n) ** 2
        if name.endswith("samp"):
            var = var * n / (n - 1)
        var = max(var, 0.0)
        return math.sqrt(var) if name.startswith("stddev") else var

    return fin


def _merge3(a, b):
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


def _merge_tuple(a, b):
    return tuple(x + y for x, y in zip(a, b))


def _covar_finalize(name: str):
    def fin(state):
        n, sx, sy, sxy, sxx, syy = state
        if n == 0 or (name == "covarsamp" and n < 2):
            return math.nan
        cov = sxy / n - (sx / n) * (sy / n)
        if name == "covarsamp":
            return cov * n / (n - 1)
        if name == "corr":
            vx = sxx / n - (sx / n) ** 2
            vy = syy / n - (sy / n) ** 2
            denom = math.sqrt(max(vx, 0.0) * max(vy, 0.0))
            return cov / denom if denom else math.nan
        return cov

    return fin


def _moments_finalize(name: str):
    def fin(state):
        n, s1, s2, s3, s4 = state
        if n == 0:
            return math.nan
        mu = s1 / n
        m2 = s2 / n - mu * mu
        if m2 <= 0:
            return math.nan
        if name == "skewness":
            m3 = s3 / n - 3 * mu * s2 / n + 2 * mu**3
            return m3 / m2**1.5
        m4 = s4 / n - 4 * mu * s3 / n + 6 * mu * mu * s2 / n - 3 * mu**4
        return m4 / (m2 * m2) - 3.0

    return fin


_EXACT_DISTINCT = ("distinctcount", "distinctcountbitmap",
                   "segmentpartitioneddistinctcount")
_HLL_FNS = ("distinctcounthll", "distinctcounthllplus", "distinctcountull",
            "distinctcountcpc")
_THETA_FNS = ("distinctcounttheta", "distinctcountrawtheta")
_SMART_FNS = ("distinctcountsmart", "distinctcountsmarthll")
_PCT_DIGEST = ("percentileest", "percentiletdigest", "percentilekll",
               "percentilesmarttdigest", "percentilerawest",
               "percentilerawtdigest", "percentilerawkll")
_MOMENT_FNS = ("stddevpop", "stddevsamp", "varpop", "varsamp")
# the matrix-shaped MV functions, each with the state of its single-value
# base: the multi-stage engine aggregates them (host_state_full), as the
# JAX package's does, and lower_aggregation refuses them, as the JAX
# package's device planner does
_MV_MATRIX = {"distinctcountmv": "distinctcount",
              "distinctcountbitmapmv": "distinctcountbitmap",
              "distinctcounthllmv": "distinctcounthll",
              "distinctcounthllplusmv": "distinctcounthllplus",
              "percentilemv": "percentile",
              "percentileestmv": "percentileest",
              "percentiletdigestmv": "percentiletdigest",
              "percentilekllmv": "percentilekll"}


def get_semantics(name: str, extra: tuple = ()) -> AggSemantics:
    name, extra = canonicalize(name, extra)
    name = _MV_MATRIX.get(name, name)
    if name in ("count", "countmv"):
        return AggSemantics(lambda a, b: a + b, lambda s: s, "LONG", 0)
    if name in ("sum", "summv"):
        return AggSemantics(lambda a, b: a + b, lambda s: s, "DOUBLE", 0.0)
    if name in ("min", "minmv"):
        return AggSemantics(min, lambda s: s, "DOUBLE", math.inf)
    if name in ("max", "maxmv"):
        return AggSemantics(max, lambda s: s, "DOUBLE", -math.inf)
    if name in ("minmaxrange", "minmaxrangemv"):
        return AggSemantics(lambda a, b: (min(a[0], b[0]), max(a[1], b[1])),
                            lambda s: s[1] - s[0], "DOUBLE", -math.inf)
    if name in ("avg", "avgmv"):
        return AggSemantics(lambda a, b: (a[0] + b[0], a[1] + b[1]),
                            lambda s: (s[0] / s[1]) if s[1] else math.nan,
                            "DOUBLE", math.nan)
    if name in _EXACT_DISTINCT:
        return AggSemantics(lambda a, b: a | b, len, "INT", 0)
    if name == "distinctsum":
        return AggSemantics(lambda a, b: a | b, lambda s: float(sum(s)),
                            "DOUBLE", 0.0)
    if name == "distinctavg":
        return AggSemantics(lambda a, b: a | b,
                            lambda s: sum(s) / len(s) if s else math.nan,
                            "DOUBLE", math.nan)
    if name in _HLL_FNS or name in _THETA_FNS:
        return AggSemantics(lambda a, b: a.merge(b), lambda s: s.cardinality(),
                            "LONG", 0)
    if name in _SMART_FNS:
        return AggSemantics(lambda a, b: a.merge(b), lambda s: s.cardinality(),
                            "INT", 0)
    if name == "percentile":
        pct = _pct(extra)
        return AggSemantics(lambda a, b: a.merge(b),
                            lambda s, _p=pct: s.percentile(_p), "DOUBLE",
                            math.nan)
    if name in _PCT_DIGEST:
        pct = _pct(extra)
        return AggSemantics(lambda a, b: a.merge(b),
                            lambda s, _p=pct: s.quantile(_p / 100.0),
                            "DOUBLE", math.nan)
    if name == "mode":
        return AggSemantics(lambda a, b: a.merge(b), lambda s: s.mode(),
                            "DOUBLE", math.nan)
    if name == "histogram":
        return AggSemantics(lambda a, b: a + b,
                            lambda s: [float(x) for x in s], "DOUBLE_ARRAY", [])
    if name in _MOMENT_FNS:
        return AggSemantics(_merge3, _var_finalize(name), "DOUBLE", math.nan)
    if name in ("skewness", "kurtosis"):
        return AggSemantics(_merge_tuple, _moments_finalize(name), "DOUBLE",
                            math.nan)
    if name in ("covarpop", "covarsamp", "corr"):
        return AggSemantics(_merge_tuple, _covar_finalize(name), "DOUBLE",
                            math.nan)
    if name == "booland":
        # the empty state is the AND identity (True)
        return AggSemantics(lambda a, b: a and b, bool, "BOOLEAN", True)
    if name in ("boolor", "boolagg"):
        return AggSemantics(lambda a, b: a or b, bool, "BOOLEAN", False)
    # the host-only functions below: the multi-stage engine aggregates them
    # (host_state_full); lower_aggregation refuses them, as the JAX
    # package's device planner does
    if name == "sumprecision":
        return AggSemantics(lambda a, b: a + b, str, "BIG_DECIMAL", "0")
    if name in ("exprmin", "firstwithtime"):
        return AggSemantics(_merge_maybe(lambda a, b: a if a[0] <= b[0] else b),
                            lambda s: None if s is None else s[1], "OBJECT",
                            None)
    if name in ("exprmax", "lastwithtime"):
        return AggSemantics(_merge_maybe(lambda a, b: a if a[0] >= b[0] else b),
                            lambda s: None if s is None else s[1], "OBJECT",
                            None)
    if name in ("arrayagg", "listagg"):
        distinct = len(extra) > 1 and bool(extra[1])
        dtype = str(extra[0]).upper() if extra else "DOUBLE"
        return AggSemantics(
            lambda a, b: a + b,
            lambda s, _d=distinct: list(dict.fromkeys(s)) if _d else list(s),
            f"{dtype}_ARRAY", [])
    raise UnsupportedQueryError(f"aggregation {name} is not lowered by this port")


_HOST_ONLY = ("sumprecision", "exprmin", "exprmax", "firstwithtime",
              "lastwithtime", "arrayagg", "listagg")


def _merge_maybe(pick):
    """Merge for states that may be None (an empty group)."""

    def merge(a, b):
        if a is None:
            return b
        if b is None:
            return a
        return pick(a, b)

    return merge


# ---------------------------------------------------------------------------
# Device lowering
# ---------------------------------------------------------------------------

# dense group-table ceiling shared with the planner's mode selection
DENSE_GROUP_LIMIT = 1 << 21


class AggPlanContext:
    """Planner callback surface used by lowerings to register device ops."""

    def __init__(self):
        self.ops: list[ir.AggOp] = []
        # group cardinality product, set by the planner before lowering:
        # approximate aggs use it to bound their occupancy matrices
        self.group_card_hint = 1

    def add_op(self, op: ir.AggOp) -> int:
        """Register a primitive op, dedup'd; returns its kernel output index
        (output 0 is the group count)."""
        if op in self.ops:
            return 1 + self.ops.index(op)
        self.ops.append(op)
        return len(self.ops)

    # provided by SegmentPlanner (engine/plan.py)
    def value_expr(self, e: ExpressionContext) -> ir.ValueExpr:  # pragma: no cover
        raise NotImplementedError

    def agg_operand(self, e: ExpressionContext, identity):  # pragma: no cover
        raise NotImplementedError

    def _null_cond_for(self, e: ExpressionContext):  # pragma: no cover
        raise NotImplementedError

    def lower_filter(self, f):  # pragma: no cover
        raise NotImplementedError

    def dict_info(self, e: ExpressionContext,
                  sv_only: bool = False):  # pragma: no cover
        raise NotImplementedError

    def mv_reduce_expr(self, e: ExpressionContext,
                       op: str):  # pragma: no cover
        raise NotImplementedError

    def col_meta(self, e: ExpressionContext):  # pragma: no cover
        raise NotImplementedError

    def col_minmax(self, e: ExpressionContext):  # pragma: no cover
        raise NotImplementedError

    def slot(self, column: str, kind: str) -> int:  # pragma: no cover
        raise NotImplementedError

    def param(self, value) -> int:  # pragma: no cover
        raise NotImplementedError


_HIST_BINS = 2048  # fixed-bin device histogram resolution for raw columns
# digest compression for histogram-fed digests: squeezing 2048 weighted
# bins into the default ~100 centroids compounds the binning error
_TDIGEST_COMPRESSION = 500
# the functions a FILTER (WHERE ...) clause composes with on the device
_FILTERABLE = frozenset(("count", "sum", "min", "max", "avg", "minmaxrange"))
_MV_VALUE_FNS = ("countmv", "summv", "minmv", "maxmv", "avgmv",
                 "minmaxrangemv")


def _lower_mv_value_agg(ctx: AggPlanContext, name: str, label: str,
                        sem: AggSemantics, arg) -> LoweredAgg:
    """The *MV value functions: the MV column reduces to one value per doc
    (ir.MvLutReduce), which then rides the scalar aggregations. The totals
    equal those over every value of the matched docs."""

    def op(kind: str) -> int:
        if ctx._null_cond_for(arg) is not None:
            raise UnsupportedQueryError(
                f"{name} over nullable {arg} with enableNullHandling has no "
                "device form")
        r = ctx.mv_reduce_expr(arg, kind)
        if r is None:
            raise UnsupportedQueryError(f"{name} on {arg} has no device MV form")
        ve, vmin, vmax = r
        agg_kind = "sum" if kind in ("sum", "count") else kind
        return ctx.add_op(ir.AggOp(agg_kind, vexpr=ve, vmin=vmin, vmax=vmax))

    if name == "countmv":
        i = op("count")
        spec, tag = VEC_RECIPES["count"]
        return LoweredAgg(
            label, sem, lambda outs, g: int(outs[i][g]),
            vec=VecAgg(spec, lambda outs, gids: (outs[i][gids],), tag))
    if name in ("summv", "minmv", "maxmv"):
        i = op(name[:-2])
        spec, tag = VEC_RECIPES[name[:-2]]
        return LoweredAgg(
            label, sem, lambda outs, g: float(outs[i][g]),
            vec=VecAgg(spec,
                       lambda outs, gids: (outs[i][gids].astype(float),), tag))
    if name == "minmaxrangemv":
        i_min, i_max = op("min"), op("max")
        spec, tag = VEC_RECIPES["minmaxrange"]
        return LoweredAgg(
            label, sem,
            lambda outs, g: (float(outs[i_min][g]), float(outs[i_max][g])),
            vec=VecAgg(spec,
                       lambda outs, gids: (outs[i_min][gids].astype(float),
                                           outs[i_max][gids].astype(float)),
                       tag))
    # avgmv: (sum of the values, count of the VALUES, not of the docs)
    i_s, i_c = op("sum"), op("count")
    spec, tag = VEC_RECIPES["avg"]
    return LoweredAgg(
        label, sem,
        lambda outs, g: (float(outs[i_s][g]), int(outs[i_c][g])),
        vec=VecAgg(spec,
                   lambda outs, gids: (outs[i_s][gids].astype(float),
                                       outs[i_c][gids]), tag))


def _mul(a: ir.ValueExpr, b: ir.ValueExpr) -> ir.ValueExpr:
    return ir.Bin("mul", a, b)


def _count_op(ctx: AggPlanContext, arg, cond) -> int:
    """Kernel output index for a COUNT under null handling and/or a FILTER
    clause; 0 (the shared per-group doc count) when neither applies."""
    ncond = ctx._null_cond_for(arg) if arg is not None else None
    if cond is None and ncond is None:
        return 0
    one = ir.ConstParam(ctx.param(np.int32(1)))
    zero = ir.ConstParam(ctx.param(np.int32(0)))
    base = one if ncond is None else ir.Where(ncond, zero, one)
    ve = base if cond is None else ir.Where(cond, base, zero)
    return ctx.add_op(ir.AggOp("sum", vexpr=ve, vmin=0, vmax=1))


def _scalar_op(ctx: AggPlanContext, kind: str, arg, cond) -> int:
    """Kernel output index for a sum/min/max reduction over ``arg`` with
    null handling (agg_operand identity wrap) and an optional FILTER clause
    composed on top."""
    nullable = ctx._null_cond_for(arg) is not None
    if kind == "sum":
        bounds = _int_bounds(ctx, arg)
        if bounds and (nullable or cond is not None):
            # identity rows contribute 0
            bounds = {"vmin": min(0, bounds["vmin"]),
                      "vmax": max(0, bounds["vmax"])}
        ve = ctx.agg_operand(arg, 0)
        if cond is not None:
            ve = ir.Where(cond, ve, ir.ConstParam(ctx.param(np.int64(0))))
        return ctx.add_op(ir.AggOp("sum", vexpr=ve, **bounds))
    # min / max: identity rows need +-inf, so compare in f64
    ident_tok = "inf" if kind == "min" else "-inf"
    bounds = {} if (nullable or cond is not None) else _int_bounds(ctx, arg)
    ve = ctx.agg_operand(arg, ident_tok)
    if cond is not None:
        inf = np.inf if kind == "min" else -np.inf
        ve = ir.Where(cond, ir.Cast(ve, "DOUBLE"),
                      ir.ConstParam(ctx.param(np.float64(inf))))
    return ctx.add_op(ir.AggOp(kind, vexpr=ve, **bounds))


def lower_aggregation(ctx: AggPlanContext, expr: ExpressionContext,
                      _cond=None, _label=None) -> LoweredAgg:
    fn = expr.function
    if fn.name == "filter":
        # AGG(x) FILTER (WHERE cond) — rows failing the clause contribute
        # the agg identity. The clause lowers through the predicate path,
        # bridged into value space.
        inner, cond_expr = fn.arguments
        try:
            from ..query.converter import (FilterConversionError,
                                           filter_from_expression)

            cond = ir.FilterVal(ctx.lower_filter(
                filter_from_expression(cond_expr)))
        except (FilterConversionError, UnsupportedQueryError, AttributeError):
            cond = ctx.value_expr(cond_expr)  # boolean plane
            ncond = ctx._null_cond_for(cond_expr)
            if ncond is not None:  # 3VL: a null clause input is false
                cond = ir.Bin("and", cond, ir.Un("not", ncond))
        return lower_aggregation(ctx, inner, _cond=cond, _label=str(expr))
    label = _label or str(expr)
    data, extra = split_args(fn)
    name, extra = canonicalize(fn.name, extra)
    sem = get_semantics(name, extra)
    if name in _HOST_ONLY or name in _MV_MATRIX:
        raise UnsupportedQueryError(f"aggregation {name} has no device form")
    if _cond is not None and name not in _FILTERABLE:
        raise UnsupportedQueryError(
            f"FILTER clause over {name} has no device form")

    if name == "count":
        i = _count_op(ctx, data[0] if data else None, _cond)
        spec, tag = VEC_RECIPES["count"]
        return LoweredAgg(
            label, sem, lambda outs, g: int(outs[i][g]),
            vec=VecAgg(spec, lambda outs, gids: (outs[i][gids],), tag))

    if name in ("sum", "min", "max"):
        i = _scalar_op(ctx, name, data[0], _cond)
        spec, tag = VEC_RECIPES[name]
        return LoweredAgg(
            label, sem, lambda outs, g: float(outs[i][g]),
            vec=VecAgg(spec,
                       lambda outs, gids, _i=i: (outs[_i][gids].astype(float),),
                       tag))

    if name in _MV_VALUE_FNS:
        return _lower_mv_value_agg(ctx, name, label, sem, data[0])

    if name == "minmaxrange":
        i_min = _scalar_op(ctx, "min", data[0], _cond)
        i_max = _scalar_op(ctx, "max", data[0], _cond)
        spec, tag = VEC_RECIPES["minmaxrange"]
        return LoweredAgg(
            label, sem,
            lambda outs, g: (float(outs[i_min][g]), float(outs[i_max][g])),
            vec=VecAgg(spec,
                       lambda outs, gids: (outs[i_min][gids].astype(float),
                                           outs[i_max][gids].astype(float)),
                       tag))

    if name == "avg":
        # (sum, count of the rows that CONTRIBUTED)
        i = _scalar_op(ctx, "sum", data[0], _cond)
        c = _count_op(ctx, data[0], _cond)
        spec, tag = VEC_RECIPES["avg"]
        return LoweredAgg(
            label, sem,
            lambda outs, g: (float(outs[i][g]), int(outs[c][g])),
            vec=VecAgg(spec,
                       lambda outs, gids, _i=i, _c=c: (
                           outs[_i][gids].astype(float), outs[_c][gids]),
                       tag))

    # the branches below have no device form that skips null rows: a
    # nullable operand under advanced null handling answers on the host
    # engine (engine/host_executor.py), as in the JAX package
    for a in data:
        if ctx._null_cond_for(a) is not None:
            raise UnsupportedQueryError(
                f"{name} over nullable {a} with enableNullHandling has no "
                "device form")

    if name in _EXACT_DISTINCT or name in ("distinctsum", "distinctavg"):
        numeric = name in ("distinctsum", "distinctavg")

        def state(values, _numeric=numeric):
            if _numeric:
                return frozenset(float(v) for v in values)
            return frozenset(values.tolist())

        return _occupancy_agg(ctx, data[0], name, label, sem, state)

    if name in _HLL_FNS:
        log2m = int(extra[0]) if extra else 12
        return _occupancy_agg(
            ctx, data[0], name, label, sem,
            lambda values, _m=log2m: HyperLogLog(_m).add_values(values))

    if name in _THETA_FNS:
        return _occupancy_agg(ctx, data[0], name, label, sem,
                              lambda values: ThetaSketch().add_values(values))

    if name in _SMART_FNS:
        return _occupancy_agg(
            ctx, data[0], name, label, sem,
            lambda values: SmartDistinctSet().add_values(values))

    if name in ("percentile", "mode"):
        i, dictionary = _value_hist_op(ctx, data[0], name)
        if not _numeric_dictionary(dictionary):
            raise UnsupportedQueryError(f"{name} requires a numeric column")
        return LoweredAgg(label, sem, lambda outs, g, _d=dictionary:
                          _value_hist(outs[i][g], _d))

    if name in _PCT_DIGEST:
        return _lower_digest(ctx, data[0], name, label, sem, extra)

    if name == "histogram":
        if len(extra) != 3:
            raise UnsupportedQueryError("histogram(col, lower, upper, numBins)")
        lo, hi, bins = float(extra[0]), float(extra[1]), int(extra[2])
        if hi <= lo or bins <= 0:
            raise UnsupportedQueryError(
                "histogram requires upper > lower and numBins > 0")
        i = ctx.add_op(ir.AggOp(
            "hist_fixed", vexpr=ctx.value_expr(data[0]), bins=bins,
            lo_param=ctx.param(np.float64(lo)),
            hi_param=ctx.param(np.float64(hi))))
        return LoweredAgg(label, sem,
                          lambda outs, g: outs[i][g].astype(np.float64))

    if name in _MOMENT_FNS:
        i_s = ctx.add_op(ir.AggOp("sum", vexpr=ctx.value_expr(data[0])))
        i_q = ctx.add_op(ir.AggOp("sumsq", vexpr=ctx.value_expr(data[0])))
        return LoweredAgg(
            label, sem,
            lambda outs, g: (int(outs[0][g]), float(outs[i_s][g]),
                             float(outs[i_q][g])))

    if name in ("skewness", "kurtosis"):
        # cast before powering: int32 column planes overflow at v**4
        v = ir.Cast(ctx.value_expr(data[0]), "DOUBLE")
        i1 = ctx.add_op(ir.AggOp("sum", vexpr=v))
        i2 = ctx.add_op(ir.AggOp("sumsq", vexpr=v))
        i3 = ctx.add_op(ir.AggOp("sum", vexpr=_mul(_mul(v, v), v)))
        i4 = ctx.add_op(ir.AggOp("sum", vexpr=_mul(_mul(v, v), _mul(v, v))))
        return LoweredAgg(
            label, sem,
            lambda outs, g: (int(outs[0][g]), float(outs[i1][g]),
                             float(outs[i2][g]), float(outs[i3][g]),
                             float(outs[i4][g])))

    if name in ("covarpop", "covarsamp", "corr"):
        x = ir.Cast(ctx.value_expr(data[0]), "DOUBLE")
        y = ir.Cast(ctx.value_expr(data[1]), "DOUBLE")
        ix = ctx.add_op(ir.AggOp("sum", vexpr=x))
        iy = ctx.add_op(ir.AggOp("sum", vexpr=y))
        ixy = ctx.add_op(ir.AggOp("sum", vexpr=_mul(x, y)))
        ixx = ctx.add_op(ir.AggOp("sumsq", vexpr=x))
        iyy = ctx.add_op(ir.AggOp("sumsq", vexpr=y))
        return LoweredAgg(
            label, sem,
            lambda outs, g: (int(outs[0][g]), float(outs[ix][g]),
                             float(outs[iy][g]), float(outs[ixy][g]),
                             float(outs[ixx][g]), float(outs[iyy][g])))

    # booland / boolor / boolagg: booleans are 0/1 ints, so AND is a min
    # (empty -> +inf -> True) and OR a max (empty -> -inf -> False)
    kind = "min" if name == "booland" else "max"
    i = ctx.add_op(ir.AggOp(kind, vexpr=ctx.value_expr(data[0])))
    return LoweredAgg(label, sem, lambda outs, g: bool(outs[i][g] > 0.5))


def _lower_digest(ctx: AggPlanContext, arg, name, label, sem,
                  extra) -> LoweredAgg:
    """The approximate percentiles, in one of three device forms: the
    exact value histogram of a dictionary column while groups x card fits
    the dense table; else the two-pass adaptive histogram where its table
    fits kernel A; else a fixed histogram of _HIST_BINS bins. Each decodes
    into a t-digest."""
    info = ctx.dict_info(arg, sv_only=True)
    if info is not None and _numeric_dictionary(info[2]) \
            and ctx.group_card_hint * info[1] <= DENSE_GROUP_LIMIT:
        i, dictionary = _value_hist_op(ctx, arg, name)
        return LoweredAgg(
            label, sem, lambda outs, g, _d=dictionary: _value_hist(
                outs[i][g], _d).to_tdigest(compression=_TDIGEST_COMPRESSION))
    # raw numeric column (or an occupancy-capped dict column)
    mm = ctx.col_minmax(arg)
    if mm is None:
        raise UnsupportedQueryError(f"{name} needs numeric column stats")
    lo, hi = float(mm[0]), float(mm[1])
    if hi <= lo:
        hi = lo + 1.0

    from ..ops import mxu_groupby

    bins = min(64, max(1, (mxu_groupby.MAX_GROUPS - 1)
                       // max(1, ctx.group_card_hint)))
    if bins >= 8 and mxu_groupby.supports(ctx.group_card_hint * bins + 1, 1):
        # two-level adaptive histogram (two count passes of kernel A, see
        # ops/kernels.py "hist_adaptive"): quantile resolution
        # (hi - lo) / bins^2 around the asked percentile. A plain raw
        # FLOAT/DOUBLE column bins from its pre-rebased f32 plane
        # ((v - column min), the rawf32r slot); lo is that same min.
        m = ctx.col_meta(arg)
        if m is not None and m.encoding == "RAW" and m.single_value \
                and str(m.data_type) in ("FLOAT", "DOUBLE"):
            vexpr, prebased = ir.Col(ctx.slot(arg.identifier, "rawf32r")), True
        else:
            vexpr, prebased = ctx.value_expr(arg), False
        i = ctx.add_op(ir.AggOp(
            "hist_adaptive", vexpr=vexpr, bins=bins,
            lo_param=ctx.param(np.float64(lo)),
            hi_param=ctx.param(np.float64(hi)), pct=_pct(extra),
            prebased=prebased))
        w1 = (hi - lo) / bins
        c1 = lo + (np.arange(bins) + 0.5) * w1

        def extract(outs, g, _b=bins, _lo=lo, _w1=w1, _c1=c1):
            row = outs[i][g]
            h1 = row[:_b].astype(np.float64)
            h2 = row[_b:2 * _b].astype(np.float64)
            bstar = int(row[2 * _b])
            # coarse weights without the refined bucket, plus the refined
            # sub-bins centred inside it
            w = h1.copy()
            w[bstar] = 0.0
            lo_g = _lo + bstar * _w1
            c2 = lo_g + (np.arange(_b) + 0.5) * (_w1 / _b)
            d = TDigest(_TDIGEST_COMPRESSION).add_weighted(_c1, w)
            return d.add_weighted(c2, h2)

        return LoweredAgg(label, sem, extract)

    # fixed-bin histogram -> weighted t-digest
    i = ctx.add_op(ir.AggOp(
        "hist_fixed", vexpr=ctx.value_expr(arg), bins=_HIST_BINS,
        lo_param=ctx.param(np.float64(lo)), hi_param=ctx.param(np.float64(hi))))
    centers = lo + (np.arange(_HIST_BINS) + 0.5) * (hi - lo) / _HIST_BINS
    return LoweredAgg(label, sem, lambda outs, g: TDigest(
        _TDIGEST_COMPRESSION).add_weighted(centers,
                                           outs[i][g].astype(np.float64)))


def _int_bounds(ctx, arg) -> dict:
    """Static integer bounds for the 32-bit fast paths (kernels._fits_i32,
    the limb planes); {} when unknown or non-integer. Quantized to
    power-of-two envelopes, as the JAX package does (there the bounds are
    static jit arguments)."""
    mm = ctx.col_minmax(arg)
    if mm is None:
        return {}
    lo, hi = mm
    if isinstance(lo, (int, np.integer)) and isinstance(hi, (int, np.integer)):
        lo, hi = int(lo), int(hi)
        qhi = (1 << max(hi, 1).bit_length()) - 1 if hi >= 0 else 0
        qlo = 0 if lo >= 0 else -(1 << max(-lo, 1).bit_length())
        return {"vmin": qlo, "vmax": qhi}
    return {}


def _occupancy_agg(ctx: AggPlanContext, arg, name, label, sem,
                   state_fn) -> LoweredAgg:
    """A DISTINCT-type function: one per-(group, dict id) occupancy op of
    the column; state_fn(values present in a group) builds the state."""
    info = ctx.dict_info(arg, sv_only=True)
    if info is None:
        raise UnsupportedQueryError(
            f"{name} needs a dict-encoded SV column: {arg}")
    ids_slot, card, dictionary = info
    i = ctx.add_op(ir.AggOp("distinct_bitmap", ids_slot=ids_slot, card=card))
    return LoweredAgg(label, sem, lambda outs, g: state_fn(
        dictionary.values[_occ_row_ids(outs[i], g)]))


def _occ_row_ids(o: np.ndarray, g) -> np.ndarray:
    """Dict ids present in group g, from either occupancy form:
    - dense: (groups, card) boolean matrix -> nonzero of row g
    - sparse: (slots, W) uint32 id bitmap words, little-endian bit j of
      word w standing for dict id w * 32 + j"""
    if o.dtype == np.uint32:
        return np.nonzero(np.unpackbits(
            np.ascontiguousarray(o[g]).view(np.uint8),
            bitorder="little"))[0]
    return np.nonzero(o[g])[0]


def _value_hist_op(ctx: AggPlanContext, arg, name):
    info = ctx.dict_info(arg, sv_only=True)
    if info is None:
        raise UnsupportedQueryError(
            f"{name} needs a dict-encoded SV column: {arg}")
    ids_slot, card, dictionary = info
    i = ctx.add_op(ir.AggOp("value_hist", ids_slot=ids_slot, card=card))
    return i, dictionary


def _value_hist(row: np.ndarray, dictionary) -> ValueHist:
    """The exact value histogram of one group's per-dict-id counts."""
    nz = np.nonzero(row)[0]
    return ValueHist.from_arrays(dictionary.values[nz], row[nz])


def _numeric_dictionary(d) -> bool:
    return np.asarray(d.values).dtype.kind in ("i", "u", "f")


# ---------------------------------------------------------------------------
# Host (numpy) states: the multi-stage engine's host aggregates
# ---------------------------------------------------------------------------


def host_state_full(name: str, cols: list, extra: tuple):
    """Per-group intermediate state from the group's (already filtered) raw
    value arrays, one array per data argument: the copy of
    pinot_tpu/engine/aggregation.py host_state_full for the functions
    `get_semantics` knows, so every state merges and finalizes through
    it. The multi-stage operators (mse/operators.py) aggregate with it."""
    name, extra = canonicalize(name, extra)
    get_semantics(name, extra)  # refuses the functions this port lacks
    name = _MV_MATRIX.get(name, name)
    values = cols[0] if cols else None
    n = 0 if values is None else len(values)

    if name in ("count", "countmv"):
        return n
    if values is None:
        raise UnsupportedQueryError(f"{name} requires an argument")

    if name in ("sum", "summv"):
        return float(np.sum(values)) if n else 0.0
    if name in ("min", "minmv"):
        return float(np.min(values)) if n else math.inf
    if name in ("max", "maxmv"):
        return float(np.max(values)) if n else -math.inf
    if name in ("minmaxrange", "minmaxrangemv"):
        return ((float(np.min(values)), float(np.max(values))) if n
                else (math.inf, -math.inf))
    if name in ("avg", "avgmv"):
        return (float(np.sum(values)), n)
    if name in _EXACT_DISTINCT:
        return frozenset(np.unique(values).tolist())
    if name in ("distinctsum", "distinctavg"):
        return frozenset(float(v) for v in np.unique(values))
    if name in _HLL_FNS:
        log2m = int(extra[0]) if extra else 12
        return HyperLogLog(log2m).add_values(np.unique(values))
    if name in _THETA_FNS:
        return ThetaSketch().add_values(np.unique(values))
    if name in _SMART_FNS:
        return SmartDistinctSet().add_values(np.unique(values))
    if name in ("percentile", "mode"):
        if np.asarray(values).dtype.kind not in ("i", "u", "f", "b"):
            raise UnsupportedQueryError(f"{name} requires a numeric column")
        return ValueHist.from_values(values)
    if name in _PCT_DIGEST:
        return TDigest().add_values(np.asarray(values, dtype=np.float64))
    if name == "histogram":
        if len(extra) != 3:
            raise UnsupportedQueryError("histogram(col, lower, upper, numBins)")
        lo, hi, bins = float(extra[0]), float(extra[1]), int(extra[2])
        if hi <= lo or bins <= 0:
            raise UnsupportedQueryError(
                "histogram requires upper > lower and numBins > 0")
        v = np.asarray(values, dtype=np.float64)
        counts, _ = np.histogram(v[(v >= lo) & (v <= hi)], bins=bins,
                                 range=(lo, hi))
        return counts.astype(np.float64)
    if name in _MOMENT_FNS:
        v = np.asarray(values, dtype=np.float64)
        return (n, float(v.sum()), float((v * v).sum()))
    if name in ("skewness", "kurtosis"):
        v = np.asarray(values, dtype=np.float64)
        return (n, float(v.sum()), float((v**2).sum()), float((v**3).sum()),
                float((v**4).sum()))
    if name in ("covarpop", "covarsamp", "corr"):
        x = np.asarray(cols[0], dtype=np.float64)
        y = np.asarray(cols[1], dtype=np.float64)
        return (n, float(x.sum()), float(y.sum()), float((x * y).sum()),
                float((x * x).sum()), float((y * y).sum()))
    if name == "booland":
        return bool(np.all(values)) if n else True
    if name in ("boolor", "boolagg"):
        return bool(np.any(values)) if n else False
    if name == "sumprecision":
        # exact decimal sum (reference SumPrecisionAggregationFunction's
        # BigDecimal); the column may hold strings
        return sum((Decimal(str(v)) for v in values), Decimal(0))
    if name in ("exprmin", "exprmax", "firstwithtime", "lastwithtime"):
        # EXPR_MIN(projection, measure); FIRST_WITH_TIME(data, time)
        if n == 0:
            return None
        proj, measure = cols[0], cols[1]
        pick = np.argmin if name in ("exprmin", "firstwithtime") else np.argmax
        idx = int(pick(measure))
        return (_item(measure[idx]), _item(proj[idx]))
    if name in ("arrayagg", "listagg"):
        return tuple(_item(v) for v in values)
    raise UnsupportedQueryError(f"aggregation {name} has no host state")


def _item(v):
    return v.item() if isinstance(v, np.generic) else v


def host_state(name: str, values, extra: tuple = ()):
    """Single-data-argument convenience wrapper."""
    return host_state_full(name, [values] if values is not None else [], extra)
