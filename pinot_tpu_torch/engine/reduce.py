"""Broker-side reduce: combined intermediates -> final ResultTable.

The port of pinot_tpu/engine/reduce.py for aggregation, GROUP BY and
selection results (reference: BrokerReduceService, GroupByDataTableReducer
and SelectionDataTableReducer -- HAVING, post-aggregation expressions,
ORDER BY, OFFSET/LIMIT). Post-aggregation expressions evaluate on the host
over finalized values, any registered transform (ROUNDDECIMAL, DATETRUNC,
string functions, ...) through its scalar form (query/transforms.py
`eval_scalar`); selection rows re-sort by Python's stable sort, one pass
per ORDER BY key from the last, and hidden ORDER BY-only columns are
projected away. A GAPFILL query's rows are filled before OFFSET/LIMIT
(engine/gapfill.py).
"""

from __future__ import annotations

import copy
import math
from typing import Optional

import numpy as np

from ..query.context import QueryContext
from ..query.expressions import ExpressionContext, is_aggregation
from ..query.filter import FilterContext, FilterNodeType, Predicate, PredicateType
from ..query.transforms import eval_scalar
from ..spi.data_types import Schema
from .aggregation import UnsupportedQueryError, semantics_for
from .gapfill import apply_gapfill, extract_gapfill
from .plan import like_to_regex
from .results import (
    AggIntermediate,
    DataSchema,
    GroupArrays,
    GroupByIntermediate,
    ResultTable,
    SelectionIntermediate,
)


class BrokerReducer:
    def __init__(self, schema: Optional[Schema] = None):
        self.schema = schema

    def reduce(self, query: QueryContext, combined) -> ResultTable:
        if isinstance(combined, GroupByIntermediate):
            spec = extract_gapfill(query)
            if spec is not None:
                # fill the full reduced group-by, then paginate (reference:
                # GapfillProcessor runs before the limit applies)
                full_query = copy.copy(query)
                full_query.offset = 0
                full_query.limit = 1 << 40
                filled = apply_gapfill(
                    self._reduce_group_by(full_query, combined), spec)
                return ResultTable(filled.schema, filled.rows[
                    query.offset: query.offset + query.limit])
            return self._reduce_group_by(query, combined)
        if isinstance(combined, AggIntermediate):
            return self._reduce_aggregation(query, combined)
        if isinstance(combined, SelectionIntermediate):
            return self._reduce_selection(query, combined)
        raise TypeError(type(combined))

    # -- group by ----------------------------------------------------------
    def _reduce_group_by(self, query: QueryContext, combined: GroupByIntermediate) -> ResultTable:
        group_exprs = list(query.group_by_expressions)
        if query.distinct and not query.is_aggregation_query:
            group_exprs = list(query.select_expressions)
        agg_exprs = query.aggregations
        semantics = [semantics_for(a) for a in agg_exprs]

        if isinstance(combined, GroupArrays):
            fast = self._fast_group_reduce(query, combined, group_exprs,
                                           agg_exprs)
            if fast is not None:
                return fast

        medium = self._medium_group_reduce(query, combined, group_exprs,
                                           agg_exprs, semantics)
        if medium is not None:
            return medium

        # env rows: expression-string -> value (+ select aliases, so ORDER BY
        # and HAVING can reference them)
        env_rows = []
        for key, states in combined.groups.items():
            env = {}
            for ge, kv in zip(group_exprs, key):
                env[str(ge)] = kv
            for ae, sem, st in zip(agg_exprs, semantics, states):
                env[str(ae)] = sem.finalize(st)
            for se, alias in zip(query.select_expressions, query.aliases):
                if alias:
                    env[alias] = _eval_post(se, env)
            env_rows.append(env)

        if query.having_filter is not None:
            env_rows = [e for e in env_rows if _eval_having(query.having_filter, e)]

        if query.order_by_expressions:
            for ob in reversed(query.order_by_expressions):
                env_rows.sort(
                    key=lambda env, _ob=ob: _sort_key(_eval_post(_ob.expression, env)),
                    reverse=not ob.ascending,
                )
        rows = []
        names, types = self._select_schema(query, group_exprs)
        for env in env_rows[query.offset : query.offset + query.limit]:
            rows.append([_round_type(_eval_post(e, env), t)
                         for e, t in zip(query.select_expressions, types)])
        return ResultTable(DataSchema(names, types), rows)

    def _medium_group_reduce(self, query: QueryContext, combined,
                             group_exprs, agg_exprs,
                             semantics) -> Optional[ResultTable]:
        """Columnar reduce of object states (sets, sketches) for the plain
        SELECT keys/aggs ... ORDER BY keys/aggs shape: one finalize pass
        into columns and one sort with the general path's comparator,
        instead of an env dict per group. None (-> the env-dict path) for
        HAVING, post-aggregation expressions, or aliases in ORDER BY."""
        if query.having_filter is not None or not combined.groups:
            return None
        gkeys = [str(ge) for ge in group_exprs]
        akeys = [str(ae) for ae in agg_exprs]
        colpos = {k: i for i, k in enumerate(gkeys)}
        for i, k in enumerate(akeys):
            colpos.setdefault(k, len(gkeys) + i)
        sel_keys = [str(e) for e in query.select_expressions]
        if any(k not in colpos for k in sel_keys):
            return None
        if any(str(ob.expression) not in colpos
               for ob in query.order_by_expressions or []):
            return None
        nk = len(gkeys)
        key_rows = list(combined.groups.keys())
        cols: list[list] = [[k[d] for k in key_rows] for d in range(nk)]
        fins = [sem.finalize for sem in semantics]
        cols += [[] for _ in fins]
        for states in combined.groups.values():
            for i, fin in enumerate(fins):
                cols[nk + i].append(fin(states[i]))
        idx = list(range(len(key_rows)))
        for ob in reversed(query.order_by_expressions or []):
            vals = cols[colpos[str(ob.expression)]]
            idx.sort(key=lambda i, _v=vals: _sort_key(_v[i]),
                     reverse=not ob.ascending)
        names, types = self._select_schema(query, group_exprs)
        sel_cols = [cols[colpos[k]] for k in sel_keys]
        rows = [[_round_type(c[i], t) for c, t in zip(sel_cols, types)]
                for i in idx[query.offset: query.offset + query.limit]]
        return ResultTable(DataSchema(names, types), rows)

    def _fast_group_reduce(self, query: QueryContext, ga: GroupArrays,
                           group_exprs, agg_exprs) -> Optional[ResultTable]:
        """Vectorized reduce for the standard SELECT keys..., aggs... shape:
        finalize as numpy columns, argsort for ORDER BY, materialize only
        the LIMIT window. None (-> the env-dict path) for HAVING,
        post-aggregation expressions, or anything else off the fast shape."""
        if query.having_filter is not None:
            return None
        colmap: dict[str, np.ndarray] = {}
        for ge, col in zip(group_exprs, ga.key_cols):
            colmap[str(ge)] = col
        for ae, tag, comps in zip(agg_exprs, ga.fin_tags, ga.state_cols):
            colmap[str(ae)] = _apply_fin_tag(tag, comps)
        for se, alias in zip(query.select_expressions, query.aliases):
            if alias and str(se) in colmap:
                colmap.setdefault(alias, colmap[str(se)])
        if any(str(e) not in colmap for e in query.select_expressions):
            return None
        order = []
        for ob in query.order_by_expressions or []:
            col = colmap.get(str(ob.expression))
            if col is None:
                return None
            if not ob.ascending and col.dtype == object:
                return None  # descending strings: the general path sorts
            order.append((col, ob.ascending))

        perm = np.arange(ga.num_groups)
        for col, asc in reversed(order):
            vals = col[perm]
            k = (np.argsort(vals, kind="stable") if asc
                 else np.argsort(-vals, kind="stable"))
            perm = perm[k]
        sel = perm[query.offset: query.offset + query.limit]
        names, types = self._select_schema(query, group_exprs)
        out_cols = [colmap[str(e)][sel].tolist()
                    for e in query.select_expressions]
        rows = [[_round_type(v, t) for v, t in zip(r, types)]
                for r in zip(*out_cols)]
        return ResultTable(DataSchema(names, types), rows)

    def _reduce_aggregation(self, query: QueryContext, combined: AggIntermediate) -> ResultTable:
        agg_exprs = query.aggregations
        semantics = [semantics_for(a) for a in agg_exprs]
        env = {}
        if combined.states:
            for ae, sem, st in zip(agg_exprs, semantics, combined.states):
                env[str(ae)] = sem.finalize(st)
        else:  # no segments at all: per-function empty results
            for ae, sem in zip(agg_exprs, semantics):
                env[str(ae)] = sem.empty_value
        names, types = self._select_schema(query, [])
        row = [_round_type(_eval_post(e, env), t) for e, t in zip(query.select_expressions, types)]
        return ResultTable(DataSchema(names, types), [row])

    # -- schema ------------------------------------------------------------
    def _reduce_selection(self, query: QueryContext,
                          combined: SelectionIntermediate) -> ResultTable:
        rows = combined.rows
        if query.order_by_expressions:
            idx = {c: i for i, c in enumerate(combined.columns)}
            rows = list(rows)
            for ob in reversed(query.order_by_expressions):
                key = (ob.expression.identifier if ob.expression.is_identifier
                       else str(ob.expression))
                ci = idx[key]
                rows.sort(key=lambda r, _ci=ci: _sort_key(r[_ci]),
                          reverse=not ob.ascending)
        rows = [list(r) for r in rows[query.offset: query.offset + query.limit]]
        # project away hidden ORDER BY-only columns the segments appended
        final_cols = self._selection_final_columns(query, combined.columns)
        if final_cols != list(combined.columns):
            idx = {c: i for i, c in enumerate(combined.columns)}
            keep = [idx[c] for c in final_cols]
            rows = [[r[i] for i in keep] for r in rows]
        types = [self._selection_column_type(c, i, rows)
                 for i, c in enumerate(final_cols)]
        return ResultTable(DataSchema(final_cols, types), rows)

    def _selection_final_columns(self, query: QueryContext,
                                 columns) -> list[str]:
        out = []
        for e in query.select_expressions:
            if e.is_identifier and e.identifier == "*":
                out.extend(c for c in columns
                           if self.schema is not None
                           and self.schema.has_column(c))
            elif e.is_identifier:
                out.append(e.identifier)
            else:
                out.append(str(e))
        return out

    def _selection_column_type(self, column: str, ci: int, rows) -> str:
        if self.schema is not None and self.schema.has_column(column):
            return self.schema.field_spec(column).data_type.value
        # a transform column: the type of its first materialized value
        for r in rows:
            v = r[ci]
            if isinstance(v, bool):
                return "BOOLEAN"
            if isinstance(v, int):
                return "LONG"
            if isinstance(v, float):
                return "DOUBLE"
            if isinstance(v, str):
                return "STRING"
        return "STRING"

    def _select_schema(self, query: QueryContext, group_exprs):
        names, types = [], []
        for e, alias in zip(query.select_expressions, query.aliases):
            names.append(alias or str(e))
            types.append(self._expr_type(e))
        return names, types

    def _expr_type(self, e: ExpressionContext) -> str:
        if is_aggregation(e):
            return semantics_for(e).result_type
        if e.is_identifier:
            if self.schema is not None and self.schema.has_column(e.identifier):
                return self.schema.field_spec(e.identifier).data_type.value
            return "STRING"
        if e.is_literal:
            v = e.literal
            if isinstance(v, bool):
                return "BOOLEAN"
            if isinstance(v, int):
                return "LONG"
            if isinstance(v, float):
                return "DOUBLE"
            return "STRING"
        return "DOUBLE"  # post-aggregation arithmetic


# -- post-aggregation expression eval (host scalars) -------------------------

_POST_BIN = {
    "plus": lambda a, b: a + b,
    "minus": lambda a, b: a - b,
    "times": lambda a, b: a * b,
    "divide": lambda a, b: a / b if b else math.nan,
    "mod": lambda a, b: a % b,
    "pow": lambda a, b: a ** b,
    "power": lambda a, b: a ** b,
    "equals": lambda a, b: a == b,
    "notequals": lambda a, b: a != b,
    "greaterthan": lambda a, b: a > b,
    "greaterthanorequal": lambda a, b: a >= b,
    "lessthan": lambda a, b: a < b,
    "lessthanorequal": lambda a, b: a <= b,
    "and": lambda a, b: bool(a) and bool(b),
    "or": lambda a, b: bool(a) or bool(b),
}

_POST_UN = {
    "abs": abs,
    "neg": lambda a: -a,
    "sqrt": math.sqrt,
    "ln": math.log,
    "log10": math.log10,
    "exp": math.exp,
    "ceil": math.ceil,
    "ceiling": math.ceil,
    "floor": math.floor,
    "not": lambda a: not a,
}


def _eval_post(e: ExpressionContext, env: dict):
    key = str(e)
    if key in env:
        return env[key]
    if e.is_literal:
        return e.literal
    if e.is_identifier:
        if e.identifier in env:
            return env[e.identifier]
        raise UnsupportedQueryError(f"column {e.identifier} not in group-by result")
    fn = e.function
    name, args = fn.name, fn.arguments
    a = [_eval_post(x, env) for x in args]
    if name in _POST_BIN:
        return _POST_BIN[name](a[0], a[1])
    if name in _POST_UN:
        return _POST_UN[name](a[0])
    if name == "cast":
        to = str(args[1].literal).upper()
        v = a[0]
        if to in ("INT", "LONG"):
            return int(v)
        if to in ("FLOAT", "DOUBLE"):
            return float(v)
        if to == "STRING":
            return str(v)
        if to == "BOOLEAN":
            return bool(v)
        return v
    if name == "case":
        for i in range(0, len(a) - 1, 2):
            if a[i]:
                return a[i + 1]
        return a[-1]
    if name == "coalesce":
        for v in a:
            if v is not None:
                return v
        return None
    # every other function: the registry's scalar form (an unregistered
    # name raises UnsupportedQueryError)
    return eval_scalar(name, a)


def _eval_having(f: FilterContext, env: dict) -> bool:
    if f.type == FilterNodeType.AND:
        return all(_eval_having(c, env) for c in f.children)
    if f.type == FilterNodeType.OR:
        return any(_eval_having(c, env) for c in f.children)
    if f.type == FilterNodeType.NOT:
        return not _eval_having(f.children[0], env)
    if f.type == FilterNodeType.CONSTANT:
        return f.constant_value
    p: Predicate = f.predicate
    v = _eval_post(p.lhs, env)
    if p.type == PredicateType.EQ:
        return v == p.values[0]
    if p.type == PredicateType.NOT_EQ:
        return v != p.values[0]
    if p.type == PredicateType.IN:
        return v in p.values
    if p.type == PredicateType.NOT_IN:
        return v not in p.values
    if p.type == PredicateType.RANGE:
        ok = True
        if p.lower is not None:
            ok = ok and ((v >= p.lower) if p.lower_inclusive else (v > p.lower))
        if p.upper is not None:
            ok = ok and ((v <= p.upper) if p.upper_inclusive else (v < p.upper))
        return ok
    if p.type == PredicateType.LIKE:
        return like_to_regex(p.values[0]).search(str(v)) is not None
    raise UnsupportedQueryError(f"HAVING predicate {p.type}")


def _sort_key(v):
    # mixed-type safe ordering: None/NaN last, bools as ints
    if v is None:
        return (2, 0)
    if isinstance(v, float) and math.isnan(v):
        return (1, 0)
    if isinstance(v, bool):
        return (0, int(v))
    return (0, v)


def _apply_fin_tag(tag: tuple, comps: tuple) -> np.ndarray:
    """Evaluate a finalize recipe over state component columns."""
    if tag[0] == "id":
        return comps[tag[1]]
    if tag[0] == "sub":
        return comps[tag[1]] - comps[tag[2]]
    if tag[0] == "div":
        num, den = comps[tag[1]].astype(float), comps[tag[2]]
        return np.divide(num, den, out=np.full(len(num), math.nan),
                         where=den != 0)
    raise ValueError(f"unknown finalize tag {tag}")


def _round_type(v, t: str):
    """Coerce finalized values to the declared result type (reference
    ColumnDataType.convert)."""
    if v is None:
        return None
    try:
        if t == "LONG" or t == "INT" or t == "TIMESTAMP":
            if isinstance(v, float) and (math.isnan(v) or math.isinf(v)):
                return v
            return int(v)
        if t == "DOUBLE" or t == "FLOAT":
            return float(v)
        if t == "BOOLEAN":
            return bool(v)
    except (TypeError, ValueError):
        return v
    return v
