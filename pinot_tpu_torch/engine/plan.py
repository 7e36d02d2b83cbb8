"""Per-segment query planner: QueryContext + segment -> kernel Program.

The port of pinot_tpu/engine/plan.py for the single-stage selection,
aggregation, dense GROUP BY and sparse (sort-based) GROUP BY modes, over
single- and multi-value columns. Predicates resolve against the segment's
sorted dictionaries at planning time into device kernel parameters: value
predicates become dict-id intervals or boolean LUTs, so the kernel never
touches a string; a predicate on a multi-value column becomes a LUT over
its (docs, max_mv) id matrix that matches when ANY value does. The Program
(engine/ir.py) is the same IR the JAX package builds, so both interpreters
run identical plans.

Transforms (query/transforms.py) lower in the reference's order: a
registered device lowering (date/time chains over int64, rounding) first,
else an evaluation over the DICTIONARY of one or two dict-encoded columns
on the host, gathered by id on the device (ir.ParamGather), which also
serves string-valued transforms as GROUP BY keys (a derived dimension) and
in predicates (a LUT over the ids), LOOKUP joins included.

Index-backed predicates (JSON_MATCH, TEXT_MATCH, VECTOR_SIMILARITY, and a
`mapvalue` predicate over a map index) evaluate on the host through the
segment's index into a doc mask, a boolean param plane of the same device
program (ir.MaskParam), as in the JAX package's device planner.

Shapes the JAX package answers on its host engine raise
UnsupportedQueryError here (QueryExecutor's backend "auto" then answers
the segment on the port's host engine, engine/host_executor.py): the
aggregations it does not lower, a GROUP BY on a transform of a raw column, a transform of
dictionary columns whose cartesian product exceeds the LUT limits, two
multi-value GROUP BY dimensions, a multi-value aggregation under a
multi-value GROUP BY. Selecting a multi-value column's values raises too.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ..query.context import QueryContext
from ..query.expressions import ExpressionContext
from ..query.filter import FilterContext, FilterNodeType, Predicate, PredicateType
from ..query.transforms import (IRBuilder, eval_expr_np, get_transform,
                                np_evaluable)
from ..segment.device_cache import SegmentDeviceView, pad_bucket
from ..segment.loader import ImmutableSegment
from ..spi.data_types import DataType
from . import ir
from .aggregation import (DENSE_GROUP_LIMIT, AggPlanContext, LoweredAgg,
                          MultistageRefusal, UnsupportedQueryError,
                          lower_aggregation)
from .host_masks import eval_host_mask, eval_map_index_predicate
from .selection import selection_columns_for

SPARSE_KEY_LIMIT = ir.SPARSE_KEY_SPACE  # keys stay below the kernel sentinel
SPARSE_GROUPS_LIMIT = 1 << 25  # cap on sparse output table slots
DEFAULT_NUM_GROUPS_LIMIT = 100_000  # reference InstancePlanMakerImplV2 default
_SPARSE_AGG_KINDS = {"count", "sum", "sumsq", "min", "max", "distinct_bitmap"}
# the sparse kernel ships ceil(card / 32) bitmap words per slot
SPARSE_DISTINCT_MAX_CARD = 1024


def _vexpr_uses_slots(ve, slots: set) -> bool:
    """True when a value expression reads any of the given array slots."""
    if ve is None:
        return False
    if isinstance(ve, (ir.Col, ir.IdsCol)):
        return ve.slot in slots
    if isinstance(ve, ir.DictGather):
        return ve.ids_slot in slots or ve.dict_slot in slots
    if isinstance(ve, ir.MvLutReduce):
        return True  # always reads an MV matrix
    if isinstance(ve, ir.ParamGather):
        return _vexpr_uses_slots(ve.ids, slots)
    if isinstance(ve, (ir.Un, ir.Cast)):
        return _vexpr_uses_slots(ve.a, slots)
    if isinstance(ve, ir.Bin):
        return _vexpr_uses_slots(ve.a, slots) or _vexpr_uses_slots(ve.b, slots)
    if isinstance(ve, ir.Where):
        return (_vexpr_uses_slots(ve.cond, slots)
                or _vexpr_uses_slots(ve.a, slots)
                or _vexpr_uses_slots(ve.b, slots))
    if isinstance(ve, ir.FilterVal):
        return _filter_uses_slots(ve.filter, slots)
    return False


def _filter_uses_slots(f, slots: set) -> bool:
    if isinstance(f, (ir.FAnd, ir.FOr)):
        return any(_filter_uses_slots(c, slots) for c in f.children)
    if isinstance(f, ir.FNot):
        return _filter_uses_slots(f.child, slots)
    if isinstance(f, ir.Lut):
        return f.ids_slot in slots
    if isinstance(f, ir.Null):
        return f.null_slot in slots
    if isinstance(f, ir.Interval):
        return _vexpr_uses_slots(f.vexpr, slots)
    if isinstance(f, ir.Isin):
        return _vexpr_uses_slots(f.vexpr, slots)
    return False


def _orderby_prefix_trim(q) -> "int | None":
    """offset+limit when ORDER BY is ALL the group-by keys, in stride
    order, all ASC with default null ordering and no HAVING: the shape
    where a per-segment keep-smallest-L composite trim cannot change the
    final result. The cover must be FULL: with a shorter prefix, a group
    trimmed in one segment but kept in another could be selected on a
    prefix tie with an incomplete aggregate."""
    if q.having_filter is not None or not q.order_by_expressions:
        return None
    gb = q.group_by_expressions
    if q.distinct and not q.is_aggregation_query:
        gb = q.select_expressions
    obs = q.order_by_expressions
    if not gb or len(obs) != len(gb):
        return None
    for ob, ge in zip(obs, gb):
        if not ob.ascending or ob.nulls_last is not None \
                or str(ob.expression) != str(ge):
            return None
    return int(q.offset) + int(q.limit)


@dataclass
class GroupDim:
    column: str
    cardinality: int
    dictionary: object  # segment Dictionary (host) — decodes ids at collect


@dataclass
class DerivedDictionary:
    """Group-index -> value table for a derived (expression) dimension."""

    values: np.ndarray


def collect_identifiers(e: ExpressionContext) -> set:
    out = set()
    if e.is_identifier:
        out.add(e.identifier)
    elif e.is_function:
        for a in e.function.arguments:
            out |= collect_identifiers(a)
    return out


def _coerce_like(vals: np.ndarray, v):
    """Coerce a predicate literal to the transformed-value dtype."""
    if vals.dtype.kind in "if":
        if isinstance(v, bool):
            return int(v)
        if isinstance(v, str):
            try:
                return float(v) if vals.dtype.kind == "f" else int(float(v))
            except ValueError:
                return v
        return v
    return str(v)


@dataclass
class SegmentPlan:
    program: ir.Program
    slots: list  # (column, kind); kind in ids|mvids|raw|rawf32r|dict|null
    params: list  # host param values in order (numpy scalars / arrays)
    lowered_aggs: list[LoweredAgg] = field(default_factory=list)
    group_dims: list[GroupDim] = field(default_factory=list)
    selection_columns: list[str] = field(default_factory=list)
    selection_exprs: dict = field(default_factory=dict)  # label -> transform
    # per-query kill switch for the single-pass fused kernel
    # (SET useFusedKernel = false)
    fused_ok: bool = True

    def gather_arrays_packed(self, view: SegmentDeviceView):
        """(arrays, packed) where packed lists (slot, width) for id planes
        kept narrow on the device — widened by ops/kernels._apply_packed."""
        out = []
        packed = []
        for i, (column, kind) in enumerate(self.slots):
            if kind == "ids":
                plane, width = view.dict_ids_packed(column)
                out.append(plane)
                if width:
                    packed.append((i, width))
            elif kind == "mvids":
                out.append(view.mv_dict_ids(column))
            elif kind == "raw":
                out.append(view.raw(column))
            elif kind == "rawf32r":
                out.append(view.raw_f32_rebased(column))
            elif kind == "dict":
                out.append(view.dict_values(column))
            elif kind == "null":
                out.append(view.null_plane(column))
            else:  # pragma: no cover
                raise ValueError(kind)
        return tuple(out), tuple(packed)


class SegmentPlanner(AggPlanContext):
    # realtime/device_plane.py's planner subclass lifts this: a pinned
    # MutableSegmentView exposes enough immutable state (snapshot
    # dictionaries, pinned metadata, pinned validity) to lower plans safely
    allow_mutable = False

    def __init__(self, query: QueryContext, segment: ImmutableSegment):
        if not self.allow_mutable and getattr(segment, "is_mutable", False):
            raise UnsupportedQueryError(
                "consuming (mutable) segments plan through "
                "realtime/device_plane.py realtime_plan")
        super().__init__()
        self.query = query
        self.segment = segment
        self._slots: list[tuple[str, str]] = []
        self._slot_index: dict[tuple[str, str], int] = {}
        self._params: list = []
        # advanced null handling: see QueryContext.null_handling
        self.null_handling = query.null_handling

    # -- slot/param bookkeeping -------------------------------------------
    def slot(self, column: str, kind: str) -> int:
        key = (column, kind)
        if key not in self._slot_index:
            self._slot_index[key] = len(self._slots)
            self._slots.append(key)
        return self._slot_index[key]

    def param(self, value) -> int:
        self._params.append(value)
        return len(self._params) - 1

    # -- column helpers ----------------------------------------------------
    def _meta(self, column: str):
        if not self.segment.has_column(column):
            raise UnsupportedQueryError(f"unknown column {column}")
        return self.segment.column_metadata(column)

    def dict_info(self, e: ExpressionContext, sv_only: bool = False):
        """(ids slot, cardinality, dictionary) of a dict-encoded column (its
        (docs, max_mv) id matrix, slot kind mvids, for a multi-value one,
        unless `sv_only`); None for anything else."""
        if not e.is_identifier or e.identifier == "*":
            return None
        m = self._meta(e.identifier)
        if m.encoding != "DICT" or (sv_only and not m.single_value):
            return None
        kind = "ids" if m.single_value else "mvids"
        return (self.slot(e.identifier, kind), m.cardinality,
                self.segment.get_dictionary(e.identifier))

    def mv_reduce_expr(self, e: ExpressionContext, op: str):
        """(vexpr, vmin, vmax): the per-doc reduce of a numeric MV dict
        column for the *MV aggregations, lut[id] over the id matrix with the
        pad sentinel's LUT slot holding the op identity, so row reduces need
        no mask. op "count" counts the non-pad slots and needs no LUT.
        vmin / vmax bound the per-doc result when known (integer sums then
        take the exact 32-bit paths). None for a column without that form
        (the JAX package answers it on its host engine)."""
        if not e.is_identifier:
            return None
        m = self._meta(e.identifier)
        if m.single_value or m.encoding != "DICT":
            return None
        slot, card, d = self.dict_info(e)
        max_mv = max(1, m.max_number_of_multi_values)
        if op == "count":
            return ir.MvLutReduce(slot, None, "count", card=card), 0, max_mv
        vals = np.asarray(d.values)
        if vals.dtype.kind not in "iuf" or not len(vals):
            return None  # non-numeric, or every row empty (no dictionary)
        if op == "sum" and vals.dtype.kind in "iu":
            # int64 entries and int64 row sums: exact
            lut = np.concatenate([vals.astype(np.int64),
                                  np.zeros(1, np.int64)])
            vmin = min(0, max_mv * int(vals[0]))
            vmax = max(0, max_mv * int(vals[-1]))
            return ir.MvLutReduce(slot, self.param(lut), "sum"), vmin, vmax
        ident = {"sum": 0.0, "min": np.inf, "max": -np.inf}[op]
        lut = np.concatenate([vals.astype(np.float64), [ident]])
        return ir.MvLutReduce(slot, self.param(lut), op), None, None

    def col_meta(self, e: ExpressionContext):
        """Column metadata of a plain identifier, else None."""
        if not e.is_identifier:
            return None
        return self._meta(e.identifier)

    def _null_cond_for(self, e: ExpressionContext):
        """Boolean ValueExpr true where any column referenced by e is null
        (a transform over a null input is null), or None when advanced null
        handling is off / no referenced column is nullable."""
        if not self.null_handling:
            return None
        cond = None
        for c in sorted(e.columns()):
            if c == "*" or not self.segment.has_column(c) \
                    or not self._meta(c).has_nulls:
                continue
            nc = ir.NullCol(self.slot(c, "null"))
            cond = nc if cond is None else ir.Bin("or", cond, nc)
        return cond

    def agg_operand(self, e: ExpressionContext, identity):
        """value_expr wrapped so null rows contribute the agg identity
        (advanced null handling). identity: 0 | "inf" | "-inf"."""
        ve = self.value_expr(e)
        cond = self._null_cond_for(e)
        if cond is None:
            return ve
        if identity in ("inf", "-inf"):
            # min/max compare in f64 so +-inf identities exist for any dtype
            ve = ir.Cast(ve, "DOUBLE")
            ident = ir.ConstParam(self.param(
                np.float64(np.inf if identity == "inf" else -np.inf)))
        else:
            ident = ir.ConstParam(self.param(np.int64(identity)))
        return ir.Where(cond, ident, ve)

    def _fused_ok(self) -> bool:
        opt = self.query.query_options.get("useFusedKernel")
        return str(opt).lower() not in ("false", "0", "off")

    def col_minmax(self, e: ExpressionContext):
        """(min, max) stats for a plain numeric column, else None."""
        if not e.is_identifier:
            return None
        m = self._meta(e.identifier)
        if m.min_value is None or m.max_value is None:
            return None
        if not DataType(m.data_type).is_numeric:
            return None
        return m.min_value, m.max_value

    # -- value expressions -------------------------------------------------
    def value_expr(self, e: ExpressionContext) -> ir.ValueExpr:
        if e.is_literal:
            v = e.literal
            if isinstance(v, bool):
                v = int(v)
            if not isinstance(v, (int, float)):
                raise UnsupportedQueryError(f"non-numeric literal in value context: {v!r}")
            return ir.ConstParam(self.param(np.float64(v) if isinstance(v, float) else np.int64(v)))
        if e.is_identifier:
            m = self._meta(e.identifier)
            if not m.single_value:
                raise UnsupportedQueryError(
                    f"MV column {e.identifier} in value context")
            dt = DataType(m.data_type)
            if not dt.is_fixed_width:
                raise UnsupportedQueryError(f"var-width column {e.identifier} in value context")
            if m.encoding == "RAW":
                return ir.Col(self.slot(e.identifier, "raw"))
            return ir.DictGather(self.slot(e.identifier, "ids"), self.slot(e.identifier, "dict"))
        fn = e.function
        name, args = fn.name, fn.arguments
        if name in _BIN_FN:
            return ir.Bin(_BIN_FN[name], self.value_expr(args[0]), self.value_expr(args[1]))
        if name in _UN_FN:
            return ir.Un(_UN_FN[name], self.value_expr(args[0]))
        if name == "cast":
            return ir.Cast(self.value_expr(args[0]), str(args[1].literal).upper())
        if name == "case":
            # case(c1,v1,c2,v2,...,else) -> nested Where
            pairs = args[:-1]
            out = self.value_expr(args[-1])
            for i in range(len(pairs) - 2, -1, -2):
                out = ir.Where(self.value_expr(pairs[i]), self.value_expr(pairs[i + 1]), out)
            return out
        if name == "coalesce" and args and args[0].is_identifier:
            m = self._meta(args[0].identifier)
            base = self.value_expr(args[0])
            if not m.has_nulls or len(args) < 2:
                return base
            null_slot = self.slot(args[0].identifier, "null")
            return ir.Where(ir.Un("not", ir.Col(null_slot)), base, self.value_expr(args[1]))
        td = get_transform(name)
        if td is not None and td.lower is not None:
            try:
                return td.lower(IRBuilder(self), list(args))
            except (UnsupportedQueryError, ValueError, KeyError):
                pass
        ve = self._dict_transform_expr(e)
        if ve is not None:
            return ve
        raise UnsupportedQueryError(f"transform function {name} not lowered to device")

    DICT_TRANSFORM_LIMIT = 1 << 18  # max cartesian LUT size for 2-col transforms
    DICT_TRANSFORM_LIMIT_1COL = 1 << 21

    def _dict_transform_expr(self, e: ExpressionContext) -> Optional[ir.ValueExpr]:
        """Numeric-valued transform over dict-encoded columns -> evaluate
        over the DICTIONARY (or the cartesian product of two dictionaries)
        on the host, ship the result as a LUT param, gather by (joint) dict
        id on the device (ir.ParamGather)."""
        prep = self._dict_transform_values(e)
        if prep is None:
            return None
        index_vexpr, out = prep
        if out.dtype.kind == "b":
            out = out.astype(np.int64)
        if out.dtype.kind not in "if":
            return None
        return ir.ParamGather(index_vexpr, self.param(out))

    def _dict_transform_values(self, e: ExpressionContext):
        """(joint-id ValueExpr, transform(dictionary values)) when e is a
        function of 1-2 dict-encoded SV columns, else None. For two columns
        the LUT covers the cardinality cartesian product and the joint id is
        id_a * card_b + id_b — the same arithmetic as the dense group key."""
        cols = sorted(collect_identifiers(e))
        if not 1 <= len(cols) <= 2:
            return None
        infos = []
        product = 1
        for c in cols:
            if not self.segment.has_column(c):
                return None
            m = self.segment.column_metadata(c)
            if m.encoding != "DICT" or not m.single_value:
                return None
            vals = np.asarray(self.segment.get_dictionary(c).values)
            infos.append((c, len(vals), vals))
            product *= len(vals)
        limit = (self.DICT_TRANSFORM_LIMIT_1COL if len(infos) == 1
                 else self.DICT_TRANSFORM_LIMIT)
        if product > limit:
            return None
        if len(infos) == 1:
            c, _, vals = infos[0]
            grids = {c: vals}
            index_vexpr: ir.ValueExpr = ir.IdsCol(self.slot(c, "ids"))
        else:
            (c1, k1, v1), (c2, k2, v2) = infos
            grids = {c1: np.repeat(v1, k2), c2: np.tile(v2, k1)}
            index_vexpr = ir.Bin(
                "add",
                ir.Bin("mul", ir.IdsCol(self.slot(c1, "ids")),
                       ir.ConstParam(self.param(np.int32(k2)))),
                ir.IdsCol(self.slot(c2, "ids")))
        try:
            out = eval_expr_np(e, lambda name: grids[name])
        except (UnsupportedQueryError, ValueError, KeyError, TypeError):
            return None
        out = np.asarray(out)
        if out.shape != (product,):
            out = np.broadcast_to(out, (product,)).copy()
        return index_vexpr, out

    def _derived_dim(self, ge: ExpressionContext):
        """Group-by key = transform of dict columns: transform the
        dictionary on the host, unique the results, remap dict ids -> dense
        group ids through a LUT gather."""
        prep = self._dict_transform_values(ge)
        if prep is None:
            return None
        index_vexpr, out = prep
        uniq, inv = np.unique(out, return_inverse=True)
        vexpr = ir.ParamGather(index_vexpr, self.param(inv.astype(np.int32)))
        return vexpr, len(uniq), DerivedDictionary(uniq)

    # -- filter lowering ---------------------------------------------------
    def lower_filter(self, f: Optional[FilterContext]) -> Optional[ir.FilterNode]:
        if f is None:
            return None
        if self.null_handling:
            true_node, _unknown = self._lower_filter3(f)
            return true_node
        return self._lower_filter(f)

    def _lower_filter(self, f: FilterContext) -> ir.FilterNode:
        if f.type == FilterNodeType.AND:
            return ir.FAnd(tuple(self._lower_filter(c) for c in f.children))
        if f.type == FilterNodeType.OR:
            return ir.FOr(tuple(self._lower_filter(c) for c in f.children))
        if f.type == FilterNodeType.NOT:
            return ir.FNot(self._lower_filter(f.children[0]))
        if f.type == FilterNodeType.CONSTANT:
            return ir.FConst(f.constant_value)
        return self._lower_predicate(f.predicate)

    # -- 3-valued lowering (advanced null handling) ------------------------
    def _lower_filter3(self, f: FilterContext):
        """Kleene logic as a (definitely-true, unknown) node pair. The final
        filter is the definitely-true mask."""
        FALSE = ir.FConst(False)

        def is_false(n):
            return isinstance(n, ir.FConst) and not n.value

        if f.type == FilterNodeType.AND:
            ts, us = zip(*(self._lower_filter3(c) for c in f.children))
            t = ir.FAnd(tuple(ts))
            if all(is_false(u) for u in us):
                return t, FALSE
            tu = ir.FAnd(tuple(ti if is_false(ui) else ir.FOr((ti, ui))
                               for ti, ui in zip(ts, us)))
            return t, ir.FAnd((tu, ir.FNot(t)))
        if f.type == FilterNodeType.OR:
            ts, us = zip(*(self._lower_filter3(c) for c in f.children))
            t = ir.FOr(tuple(ts))
            if all(is_false(u) for u in us):
                return t, FALSE
            return t, ir.FAnd((ir.FOr(tuple(u for u in us if not is_false(u))),
                               ir.FNot(t)))
        if f.type == FilterNodeType.NOT:
            ct, cu = self._lower_filter3(f.children[0])
            if is_false(cu):
                return ir.FNot(ct), FALSE
            return ir.FAnd((ir.FNot(ct), ir.FNot(cu))), cu
        if f.type == FilterNodeType.CONSTANT:
            return ir.FConst(f.constant_value), FALSE
        p = f.predicate
        node = self._lower_predicate(p)
        if p.type in (PredicateType.IS_NULL, PredicateType.IS_NOT_NULL):
            return node, FALSE  # defined for every row
        unknown = None
        for c in sorted(p.lhs.columns()):
            if self.segment.has_column(c) and self._meta(c).has_nulls:
                nc = ir.Null(self.slot(c, "null"))
                unknown = nc if unknown is None else ir.FOr((unknown, nc))
        if unknown is None:
            return node, FALSE
        return ir.FAnd((node, ir.FNot(unknown))), unknown

    def _lower_predicate(self, p: Predicate) -> ir.FilterNode:
        lhs = p.lhs
        if p.type in (PredicateType.IS_NULL, PredicateType.IS_NOT_NULL):
            if not lhs.is_identifier:
                raise UnsupportedQueryError("IS NULL on expressions unsupported")
            m = self._meta(lhs.identifier)
            if not m.has_nulls:
                node = ir.FConst(False)
            else:
                node = ir.Null(self.slot(lhs.identifier, "null"))
            return ir.FNot(node) if p.type == PredicateType.IS_NOT_NULL else node
        if p.type not in _LOWERED_PREDICATES:
            raise UnsupportedQueryError(f"predicate {p.type} is not lowered by this port")
        if p.type in _HOST_MASK_PREDICATES:
            return self._lower_host_mask(p)

        info = self.dict_info(lhs) if lhs.is_identifier else None
        if info is not None:
            return self._lower_dict_predicate(p, lhs, info)
        if lhs.is_function:
            # mapvalue(col, 'key') over a map index: a compare of the
            # index's dense plane on the host, shipped as a mask plane
            mm = eval_map_index_predicate(p, self.segment)
            if mm is not None:
                return self._mask_param(mm)
            try:
                return self._lower_value_predicate(p)
            except UnsupportedQueryError:
                node = self._lower_fn_dict_predicate(p)
                if node is not None:
                    return node
                raise
        return self._lower_value_predicate(p)

    def _lower_fn_dict_predicate(self, p: Predicate) -> Optional[ir.FilterNode]:
        """Predicate over a transform of dict columns: evaluate transform +
        predicate against the dictionary on the host -> boolean LUT."""
        prep = self._dict_transform_values(p.lhs)
        if prep is None:
            return None
        index_vexpr, vals = prep
        card = len(vals)
        m = np.zeros(card, dtype=bool)
        if p.type in (PredicateType.EQ, PredicateType.NOT_EQ):
            m = vals == _coerce_like(vals, p.values[0])
            if p.type == PredicateType.NOT_EQ:
                m = ~m
        elif p.type in (PredicateType.IN, PredicateType.NOT_IN):
            for v in p.values:
                m |= vals == _coerce_like(vals, v)
            if p.type == PredicateType.NOT_IN:
                m = ~m
        elif p.type == PredicateType.RANGE:
            m = np.ones(card, dtype=bool)
            if p.lower is not None:
                lo = _coerce_like(vals, p.lower)
                m &= (vals >= lo) if p.lower_inclusive else (vals > lo)
            if p.upper is not None:
                hi = _coerce_like(vals, p.upper)
                m &= (vals <= hi) if p.upper_inclusive else (vals < hi)
        elif p.type in (PredicateType.LIKE, PredicateType.REGEXP_LIKE):
            regex = (like_to_regex(p.values[0]) if p.type == PredicateType.LIKE
                     else re.compile(str(p.values[0])))
            m = np.asarray([regex.search(str(x)) is not None for x in vals], dtype=bool)
        else:
            return None
        if isinstance(index_vexpr, ir.IdsCol):
            lut = np.zeros(card + 1, dtype=bool)
            lut[:card] = m
            return ir.Lut(index_vexpr.slot, self.param(lut), mv=False)
        # joint-id LUT: gather 0/1 then compare
        pi = self.param(np.int32(1))
        return ir.Interval(
            ir.ParamGather(index_vexpr, self.param(m.astype(np.int32))),
            lo_param=pi, hi_param=pi)

    def _lower_dict_predicate(self, p: Predicate, lhs, info) -> ir.FilterNode:
        ids_slot, card, d = info
        m = self._meta(lhs.identifier)
        mv = not m.single_value
        dt = DataType(m.data_type)

        def coerce(v):
            if dt.is_numeric and isinstance(v, bool):
                return int(v)
            return v

        if p.type in (PredicateType.EQ, PredicateType.NOT_EQ):
            did = d.index_of(coerce(p.values[0]))
            if mv:
                # MV predicates hold per VALUE ("any value matches"), so
                # NOT_EQ inverts the LUT, not the document mask
                lut = np.zeros(card + 1, dtype=bool)
                if did >= 0:
                    lut[did] = True
                if p.type == PredicateType.NOT_EQ:
                    lut[:card] = ~lut[:card]
                return ir.Lut(ids_slot, self.param(lut), mv=True)
            if did < 0:
                node = ir.FConst(False)
            else:
                node = self._id_interval(ids_slot, did, did, mv, card)
            return ir.FNot(node) if p.type == PredicateType.NOT_EQ else node

        if p.type == PredicateType.RANGE:
            lo_id = 0
            hi_id = card - 1
            if p.lower is not None:
                lo_id = d.insertion_index(coerce(p.lower), "left" if p.lower_inclusive else "right")
            if p.upper is not None:
                hi_id = d.insertion_index(coerce(p.upper), "right" if p.upper_inclusive else "left") - 1
            if lo_id > hi_id:
                return ir.FConst(False)
            if lo_id <= 0 and hi_id >= card - 1 and not mv:
                return ir.FConst(True)
            return self._id_interval(ids_slot, lo_id, hi_id, mv, card)

        if p.type in (PredicateType.IN, PredicateType.NOT_IN):
            lut = np.zeros(card + 1, dtype=bool)
            for v in p.values:
                did = d.index_of(coerce(v))
                if did >= 0:
                    lut[did] = True
            if p.type == PredicateType.NOT_IN:
                lut[:card] = ~lut[:card]
            return ir.Lut(ids_slot, self.param(lut), mv=mv)

        # LIKE / REGEXP_LIKE
        pattern = p.values[0]
        regex = like_to_regex(pattern) if p.type == PredicateType.LIKE else re.compile(str(pattern))
        lut = np.zeros(card + 1, dtype=bool)
        for i, v in enumerate(d.values):
            if regex.search(str(v)) is not None:
                lut[i] = True
        return ir.Lut(ids_slot, self.param(lut), mv=mv)

    def _lower_host_mask(self, p: Predicate) -> ir.FilterNode:
        """JSON_MATCH, TEXT_MATCH and VECTOR_SIMILARITY have no vector form:
        they evaluate on the host through the column's index into a doc
        mask, shipped as a param plane (engine/host_masks.py)."""
        if not p.lhs.is_identifier:
            raise UnsupportedQueryError(f"{p.type} needs a column lhs")
        return self._mask_param(eval_host_mask(p, self.segment))

    def _mask_param(self, mask: np.ndarray) -> ir.MaskParam:
        """A host-computed doc mask as a boolean param plane padded to the
        segment's shape bucket (pad rows False)."""
        padded = np.zeros(pad_bucket(max(1, self.segment.num_docs)),
                          dtype=bool)
        padded[:len(mask)] = mask
        return ir.MaskParam(self.param(padded))

    def _and_valid_docs(self, filt: Optional[ir.FilterNode]
                        ) -> Optional[ir.FilterNode]:
        """Upsert tables AND the segment's validity plane into the filter
        (reference: FilterPlanNode wraps the filter with the validDocIds
        bitmap of upsert-enabled tables); a param plane, so the program is
        the same as validity evolves."""
        vd = getattr(self.segment, "valid_doc_ids", None)
        if vd is None:
            return filt
        node = self._mask_param(vd.mask(self.segment.num_docs))
        return node if filt is None else ir.FAnd((filt, node))

    def _id_interval(self, ids_slot, lo_id, hi_id, mv=False,
                     card=0) -> ir.FilterNode:
        if mv:
            lut = np.zeros(card + 1, dtype=bool)
            lut[lo_id:hi_id + 1] = True
            return ir.Lut(ids_slot, self.param(lut), mv=True)
        return ir.Interval(
            ir.IdsCol(ids_slot),
            lo_param=self.param(np.int32(lo_id)),
            hi_param=self.param(np.int32(hi_id)),
        )

    def _lower_value_predicate(self, p: Predicate) -> ir.FilterNode:
        ve = self.value_expr(p.lhs)
        if p.type in (PredicateType.EQ, PredicateType.NOT_EQ):
            v = p.values[0]
            if isinstance(v, bool):
                v = int(v)
            if isinstance(v, str):
                raise UnsupportedQueryError("string compare on raw column")
            pi = self.param(np.float64(v) if isinstance(v, float) else np.int64(v))
            node = ir.Interval(ve, lo_param=pi, hi_param=pi)
            return ir.FNot(node) if p.type == PredicateType.NOT_EQ else node
        if p.type == PredicateType.RANGE:
            lo = None if p.lower is None else self.param(_num(p.lower))
            hi = None if p.upper is None else self.param(_num(p.upper))
            return ir.Interval(ve, lo_param=lo, hi_param=hi,
                               lo_inclusive=p.lower_inclusive, hi_inclusive=p.upper_inclusive)
        if p.type in (PredicateType.IN, PredicateType.NOT_IN):
            vals = np.asarray([_num(v) for v in p.values])
            node = ir.Isin(ve, self.param(vals))
            return ir.FNot(node) if p.type == PredicateType.NOT_IN else node
        raise UnsupportedQueryError(f"predicate {p.type} on raw column not lowered")

    # -- top-level plan ----------------------------------------------------
    def plan(self) -> SegmentPlan:
        q = self.query
        filt = self._and_valid_docs(self.lower_filter(q.filter))
        if not (q.is_aggregation_query or q.distinct or q.is_group_by):
            return self._plan_selection(filt)

        group_dims: list[GroupDim] = []
        group_exprs = list(q.group_by_expressions)
        if q.distinct and not q.is_aggregation_query:
            group_exprs = [e for e in q.select_expressions]
        group_slots = []
        group_vexprs = []
        cards = []
        any_derived = False
        mv_group_slot = mv_group_card = None
        for ge in group_exprs:
            if ge.is_identifier:
                info = self.dict_info(ge)
                if info is None:
                    raise UnsupportedQueryError(f"group-by on non-dict column {ge}")
                slot, card, d = info
                if not self._meta(ge.identifier).single_value:
                    # ONE MV dim: the kernel expands (doc x mv-slot) pairs;
                    # a second would need a per-doc cross product
                    if mv_group_slot is not None:
                        raise UnsupportedQueryError(
                            "group-by on two MV columns is not lowered")
                    mv_group_slot, mv_group_card = slot, card
                group_slots.append(slot)
                group_vexprs.append(ir.IdsCol(slot))
                cards.append(card)
                group_dims.append(GroupDim(ge.identifier, card, d))
            else:
                derived = self._derived_dim(ge)
                if derived is None:
                    raise UnsupportedQueryError(f"group-by on expression {ge} is not lowered")
                vexpr, card, dd = derived
                any_derived = True
                group_vexprs.append(vexpr)
                cards.append(card)
                group_dims.append(GroupDim(str(ge), card, dd))
        num_groups = 1
        for c in cards:
            num_groups *= c
        # row-major strides (reference DictionaryBasedGroupKeyGenerator:119-137)
        strides = [1] * len(cards)
        for i in range(len(cards) - 2, -1, -1):
            strides[i] = strides[i + 1] * cards[i + 1]

        if num_groups >= SPARSE_KEY_LIMIT:
            raise UnsupportedQueryError(
                f"group cardinality product {num_groups} exceeds the "
                "int64 composite-key space")
        # approximate aggs size their occupancy matrices by it
        self.group_card_hint = num_groups
        lowered = [lower_aggregation(self, a) for a in q.aggregations]
        if mv_group_slot is not None:
            if any_derived:
                raise UnsupportedQueryError(
                    "MV group-by with expression keys is not lowered")
            # the expansion rewires every 1-D plane: an aggregation reading
            # an MV matrix (another MV column, or MvLutReduce of this one)
            # would see the wrong shape
            mv_slots = {i for i, (_c, k) in enumerate(self._slots)
                        if k == "mvids"}
            for op in self.ops:
                if (op.ids_slot in mv_slots
                        or _vexpr_uses_slots(op.vexpr, mv_slots)):
                    raise UnsupportedQueryError(
                        "MV aggregation under an MV group-by is not lowered")
        # mode selection: dense when the key product and every matrix
        # occupancy fit the dense table, else the sort-based sparse path
        # (SET sparseGroupBy = true routes a dense-eligible group-by there
        # too)
        sparse = num_groups > DENSE_GROUP_LIMIT
        reason = f"group cardinality product {num_groups}"
        for op in self.ops:
            width = op.card if op.kind in ("distinct_bitmap", "value_hist") \
                else op.bins if op.kind in ("hist_fixed", "hist_adaptive") \
                else None
            if width is not None and num_groups * width > DENSE_GROUP_LIMIT:
                sparse, reason = True, f"{op.kind} occupancy {num_groups}x{width}"
        if not sparse and group_exprs and self.query.query_options.get(
                "sparseGroupBy") in (True, "true", 1):
            sparse, reason = True, "sparseGroupBy=true"
        if sparse:
            distinct = [op for op in self.ops if op.kind == "distinct_bitmap"]
            if len(distinct) > 1:
                # one DISTINCT column rides the sort as its secondary key
                raise UnsupportedQueryError(
                    "the sparse group-by takes one DISTINCT column")
            if distinct and distinct[0].card > SPARSE_DISTINCT_MAX_CARD:
                raise UnsupportedQueryError(
                    f"sparse DISTINCTCOUNT bitmap over card "
                    f"{distinct[0].card} > {SPARSE_DISTINCT_MAX_CARD}")
            for op in self.ops:
                if op.kind not in _SPARSE_AGG_KINDS:
                    raise UnsupportedQueryError(
                        f"{reason} needs the sparse (sort-based) group-by, "
                        f"which does not lower {op.kind}")
        if sparse and not group_exprs:
            raise UnsupportedQueryError(
                f"{reason} exceeds the dense limit for an un-grouped "
                "aggregation")
        exact_trim = keys_presorted = False
        if sparse and not any_derived and mv_group_slot is None:
            # sorted-key fast path: group keys whose composite id is
            # nondecreasing in doc order need no sort (reference
            # SortedGroupByOperator): one key whose id plane is sorted
            # (ColumnMetadata.is_sorted), or keys that are, in order, a
            # prefix of the segment's lexicographic co-sort chain
            # (SegmentMetadata.sort_order)
            if len(group_exprs) == 1:
                keys_presorted = bool(
                    self._meta(group_exprs[0].identifier).is_sorted)
            else:
                cols = [e.identifier for e in group_exprs]
                so = list(getattr(getattr(self.segment, "metadata", None),
                                  "sort_order", None) or [])
                keys_presorted = so[:len(cols)] == cols
        if sparse:
            # output capacity = numGroupsLimit: groups beyond it are trimmed
            # on the device (reference InstancePlanMakerImplV2:245-270); an
            # ORDER BY over all the keys, ascending, makes the keep-smallest-L
            # trim exact
            limit = int(q.query_options.get(
                "numGroupsLimit", DEFAULT_NUM_GROUPS_LIMIT))
            trim = None if any_derived else _orderby_prefix_trim(q)
            if trim is not None and trim <= limit:
                limit, exact_trim = trim, True
            mode = "group_by_sparse"
            out_groups = min(num_groups, max(1, limit))
            if out_groups > SPARSE_GROUPS_LIMIT:
                raise UnsupportedQueryError(
                    f"numGroupsLimit {out_groups} exceeds sparse output "
                    f"cap {SPARSE_GROUPS_LIMIT}")
        else:
            mode = "group_by" if group_exprs else "aggregation"
            out_groups = num_groups
        if mode == "aggregation":
            mv_group_slot = mv_group_card = None
        program = ir.Program(
            mode=mode,
            filter=filt,
            aggs=tuple(self.ops),
            group_slots=() if any_derived else tuple(group_slots),
            group_strides=tuple(strides),
            num_groups=out_groups,
            group_vexprs=tuple(group_vexprs) if any_derived else (),
            key_space=num_groups if sparse else 0,
            exact_trim=exact_trim,
            keys_presorted=keys_presorted,
            mv_group_slot=mv_group_slot,
            mv_group_card=mv_group_card,
            # the per-doc planes the MV expansion broadcasts across max_mv
            mv_doc_slots=tuple(
                i for i, (_c, k) in enumerate(self._slots)
                if k in ("ids", "raw", "rawf32r", "null"))
            if mv_group_slot is not None else (),
        )
        return SegmentPlan(program, self._slots, self._params,
                           lowered, group_dims, fused_ok=self._fused_ok())

    def _plan_selection(self, filt) -> SegmentPlan:
        """Selection: the device computes the filter mask; the host
        materializes the matching rows. Transform select and ORDER BY items
        evaluate on the host over the filtered doc ids only, through the
        registry's numpy forms (query/transforms.py eval_expr_np); COALESCE
        or a multi-value column (the array functions included) raises (the
        JAX package answers those on its host engine); an ORDER BY on an
        unselected column raises MultistageRefusal, before any dispatch
        (`execute_sql` retries it on the multi-stage engine)."""
        sel_cols, sel_exprs = selection_columns_for(self.query, self.segment)
        for ob in self.query.order_by_expressions:
            if ob.expression.is_identifier \
                    and ob.expression.identifier not in sel_cols:
                raise MultistageRefusal(
                    "selection ORDER BY must reference selected columns")
        for c in sel_cols:
            e = sel_exprs.get(c)
            if e is not None and not np_evaluable(e):
                raise UnsupportedQueryError(
                    f"selection transform {c} is not evaluated by this port")
            for col in ([c] if e is None else sorted(e.columns())):
                if not self._meta(col).single_value:
                    raise UnsupportedQueryError(
                        f"selection of MV column {col} is not materialized "
                        "by this port")
        return SegmentPlan(ir.Program(mode="selection", filter=filt),
                           self._slots, self._params,
                           selection_columns=sel_cols,
                           selection_exprs=sel_exprs)


# index-backed predicates, evaluated on the host into a mask plane
_HOST_MASK_PREDICATES = (
    PredicateType.JSON_MATCH, PredicateType.TEXT_MATCH,
    PredicateType.VECTOR_SIMILARITY)
_LOWERED_PREDICATES = (
    PredicateType.EQ, PredicateType.NOT_EQ, PredicateType.RANGE,
    PredicateType.IN, PredicateType.NOT_IN, PredicateType.LIKE,
    PredicateType.REGEXP_LIKE) + _HOST_MASK_PREDICATES

_BIN_FN = {
    "plus": "add", "minus": "sub", "times": "mul", "divide": "div", "mod": "mod",
    "pow": "pow", "power": "pow",
    "equals": "eq", "notequals": "ne", "lessthan": "lt", "lessthanorequal": "le",
    "greaterthan": "gt", "greaterthanorequal": "ge",
    "and": "and", "or": "or", "least": "min", "greatest": "max",
}

_UN_FN = {
    "neg": "neg", "abs": "abs", "not": "not", "exp": "exp", "ln": "ln",
    "log10": "log10", "log2": "log2", "sqrt": "sqrt", "ceiling": "ceil",
    "ceil": "ceil", "floor": "floor", "sign": "sign",
}


def _num(v):
    if isinstance(v, bool):
        return np.int64(int(v))
    if isinstance(v, int):
        return np.int64(v)
    if isinstance(v, float):
        return np.float64(v)
    raise UnsupportedQueryError(f"non-numeric literal {v!r} on raw column")


def like_to_regex(pattern: str):
    """SQL LIKE -> compiled regex (% -> .*, _ -> ., everything else escaped)."""
    out = []
    for ch in str(pattern):
        if ch == "%":
            out.append(".*")
        elif ch == "_":
            out.append(".")
        else:
            out.append(re.escape(ch))
    return re.compile("^" + "".join(out) + "$")
