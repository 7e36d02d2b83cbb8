"""The host engine: numpy per-segment execution.

The port's copy of pinot_tpu/engine/host_executor.py. QueryExecutor runs a
segment here under backend "host" (every segment) and "auto" (a segment
whose plan the single-stage planner refuses, engine/plan.py), never under
the default "device". The filter reads the segment's inverted, sorted and
raw range indexes where they exist (segment/indexes.py), the geo grid index
for ST_DISTANCE(lat, lng, lat0, lng0) < r, the JSON / text / vector / map
indexes through engine/host_masks.py, and scans otherwise; MV columns match
when any value does. Aggregations build the same intermediate states as
the device path (engine/aggregation.py host_state / host_state_full,
engine/funnel.py for the FUNNEL family); a group-by of scalar aggregations
takes a columnar GroupArrays (np.unique + scatter), any other a per-group
loop; an MV key expands one row per value. A key over a sorted dictionary
factorizes by its dict ids, which order as its values do (the JAX
package's engine sorts the values themselves; the groups and their order
are the same). Selections share
engine/selection.py with the device path. Vectorized numpy where easy,
Python where not: clarity over speed.
"""

from __future__ import annotations

import re

import numpy as np

from ..query.context import QueryContext
from ..query.converter import FilterConversionError, filter_from_expression
from ..query.expressions import ExpressionContext
from ..query.filter import (FilterContext, FilterNodeType, Predicate,
                            PredicateType)
from ..query.transforms import eval_expr_np, get_transform
from ..segment.indexes import haversine_m
from ..spi.data_types import DataType
from . import funnel
from .aggregation import (VEC_RECIPES, UnsupportedQueryError, host_state,
                          host_state_full, split_args)
from .host_masks import eval_host_mask, eval_map_index_predicate
from .plan import like_to_regex
from .results import (AggIntermediate, GroupArrays, GroupByIntermediate,
                      SelectionIntermediate)
from .selection import selection_columns_for, selection_from_mask


class HostSegmentExecutor:
    def execute(self, query: QueryContext, segment):
        """One segment's intermediate for `query` (an ImmutableSegment,
        a consuming snapshot or a star-tree view)."""
        mask = self._filter_mask(query.filter, segment,
                                 nh=query.null_handling)
        if query.is_aggregation_query or query.distinct or query.is_group_by:
            group_exprs = list(query.group_by_expressions)
            if query.distinct and not query.is_aggregation_query:
                group_exprs = list(query.select_expressions)
            if group_exprs:
                return self._group_by(query, segment, mask, group_exprs)
            return self._aggregation(query, segment, mask)
        return self._selection(query, segment, mask)

    # -- filter ------------------------------------------------------------
    def _filter_mask(self, f, segment,
                     nh: bool = False) -> np.ndarray:
        n = segment.num_docs
        if f is None:
            mask = np.ones(n, dtype=bool)
        elif nh:
            mask, _unknown = self._eval_filter3(f, segment)
        else:
            mask = self._eval_filter(f, segment)
        vd = getattr(segment, "valid_doc_ids", None)
        if vd is not None:  # upsert validity plane (see plan._and_valid_docs)
            mask = mask & vd.mask(n)
        return mask

    def _eval_filter(self, f: FilterContext, segment) -> np.ndarray:
        n = segment.num_docs
        if f.type == FilterNodeType.AND:
            m = np.ones(n, dtype=bool)
            for c in f.children:
                m &= self._eval_filter(c, segment)
            return m
        if f.type == FilterNodeType.OR:
            m = np.zeros(n, dtype=bool)
            for c in f.children:
                m |= self._eval_filter(c, segment)
            return m
        if f.type == FilterNodeType.NOT:
            return ~self._eval_filter(f.children[0], segment)
        if f.type == FilterNodeType.CONSTANT:
            return np.full(n, f.constant_value, dtype=bool)
        return self._eval_predicate(f.predicate, segment)

    def _eval_filter3(self, f: FilterContext, segment):
        """Kleene 3-valued evaluation → (definitely-true, unknown) masks;
        mirrors plan.SegmentPlanner._lower_filter3."""
        n = segment.num_docs
        if f.type == FilterNodeType.AND:
            t = np.ones(n, dtype=bool)
            tu = np.ones(n, dtype=bool)  # true-or-unknown
            for c in f.children:
                ct, cu = self._eval_filter3(c, segment)
                t &= ct
                tu &= ct | cu
            return t, tu & ~t
        if f.type == FilterNodeType.OR:
            t = np.zeros(n, dtype=bool)
            u = np.zeros(n, dtype=bool)
            for c in f.children:
                ct, cu = self._eval_filter3(c, segment)
                t |= ct
                u |= cu
            return t, u & ~t
        if f.type == FilterNodeType.NOT:
            ct, cu = self._eval_filter3(f.children[0], segment)
            return ~ct & ~cu, cu
        if f.type == FilterNodeType.CONSTANT:
            return (np.full(n, f.constant_value, dtype=bool),
                    np.zeros(n, dtype=bool))
        m = self._eval_predicate(f.predicate, segment)
        if f.predicate.type in (PredicateType.IS_NULL,
                                PredicateType.IS_NOT_NULL):
            return m, np.zeros(n, dtype=bool)
        u = self._nulls_of(f.predicate.lhs.columns(), segment, n)
        return m & ~u, u

    def _nulls_of(self, cols, segment, n) -> np.ndarray:
        out = np.zeros(n, dtype=bool)
        for c in sorted(cols):
            if segment.has_column(c):
                nb = segment.get_null_bitmap(c)
                if nb is not None:
                    out |= nb
        return out

    def _eval_predicate(self, p: Predicate, segment) -> np.ndarray:
        n = segment.num_docs
        if p.type in (PredicateType.IS_NULL, PredicateType.IS_NOT_NULL):
            col = p.lhs.identifier
            nulls = segment.get_null_bitmap(col)
            m = np.zeros(n, dtype=bool) if nulls is None else nulls.copy()
            return ~m if p.type == PredicateType.IS_NOT_NULL else m
        if p.type in (PredicateType.JSON_MATCH, PredicateType.TEXT_MATCH,
                      PredicateType.VECTOR_SIMILARITY):
            return eval_host_mask(p, segment)
        geo = self._eval_geo_range(p, segment)
        if geo is not None:
            return geo

        m = self._eval_predicate_with_index(p, segment)
        if m is not None:
            return m

        # MV columns: row matches if ANY value matches (reference MV predicate
        # semantics)
        if p.lhs.is_identifier and not segment.column_metadata(p.lhs.identifier).single_value:
            return self._eval_mv_predicate(p, segment)

        mm = eval_map_index_predicate(p, segment)
        if mm is not None:
            return mm

        v = self.eval_value(p.lhs, segment)
        return self._compare_values(p, v, n)

    def _compare_values(self, p: Predicate, v: np.ndarray, n: int) -> np.ndarray:
        if p.type == PredicateType.EQ:
            return v == _coerce_to(v, p.values[0])
        if p.type == PredicateType.NOT_EQ:
            return v != _coerce_to(v, p.values[0])
        if p.type in (PredicateType.IN, PredicateType.NOT_IN):
            m = np.zeros(n, dtype=bool)
            for val in p.values:
                m |= v == _coerce_to(v, val)
            return ~m if p.type == PredicateType.NOT_IN else m
        if p.type == PredicateType.RANGE:
            m = np.ones(n, dtype=bool)
            if p.lower is not None:
                lo = _coerce_to(v, p.lower)
                m &= (v >= lo) if p.lower_inclusive else (v > lo)
            if p.upper is not None:
                hi = _coerce_to(v, p.upper)
                m &= (v <= hi) if p.upper_inclusive else (v < hi)
            return m
        if p.type in (PredicateType.LIKE, PredicateType.REGEXP_LIKE):
            regex = (like_to_regex(p.values[0]) if p.type == PredicateType.LIKE
                     else re.compile(str(p.values[0])))
            return np.asarray([regex.search(str(x)) is not None for x in v], dtype=bool)
        raise UnsupportedQueryError(f"host predicate {p.type}")

    def _eval_geo_range(self, p: Predicate, segment):
        """ST_DISTANCE(latCol, lngCol, lat, lng) < r accelerates through the
        geo grid index: candidate cells → exact haversine refine (reference:
        H3IndexFilterOperator's two-phase cells+refine). Returns None when
        the shape doesn't match — the generic transform path still answers
        it exactly, just without pruning."""
        if p.type != PredicateType.RANGE or p.upper is None:
            return None
        e = p.lhs
        if not (e.is_function and e.function.name in ("stdistance", "distance")):
            return None
        args = e.function.arguments
        if len(args) != 4 or not (args[0].is_identifier and args[1].is_identifier
                                  and args[2].is_literal and args[3].is_literal):
            return None
        lat_col, lng_col = args[0].identifier, args[1].identifier
        idx = segment.get_geo_index(lat_col, lng_col, or_build=True) \
            if hasattr(segment, "get_geo_index") else None
        if idx is None:
            return None
        lat0, lng0 = float(args[2].literal), float(args[3].literal)
        cand = idx.candidate_docs(lat0, lng0, float(p.upper))
        mask = np.zeros(segment.num_docs, dtype=bool)
        if len(cand):
            cand = cand[cand < segment.num_docs]
            lat = np.asarray(segment.get_values(lat_col), dtype=np.float64)[cand]
            lng = np.asarray(segment.get_values(lng_col), dtype=np.float64)[cand]
            d = haversine_m(lat, lng, lat0, lng0)
            ok = (d <= p.upper) if p.upper_inclusive else (d < p.upper)
            if p.lower is not None:
                ok &= (d >= p.lower) if p.lower_inclusive else (d > p.lower)
            mask[cand[ok]] = True
        return mask

    def _eval_predicate_with_index(self, p: Predicate, segment):
        """Index-backed predicate evaluation (reference: index-backed
        BaseFilterOperators, pinot-core/.../operator/filter/). Returns None
        when no applicable index exists — caller scans."""
        lhs = p.lhs
        if not lhs.is_identifier or not segment.has_column(lhs.identifier):
            return None
        col = lhs.identifier
        n = segment.num_docs
        m = segment.column_metadata(col)
        if m.encoding == "DICT" and m.single_value:
            d = segment.get_dictionary(col)
            inv = segment.get_inverted_index(col)
            srt = segment.get_sorted_index(col)
            if inv is None and srt is None:
                return None
            if p.type in (PredicateType.EQ, PredicateType.NOT_EQ):
                did = d.index_of(p.values[0])
                mask = self._ids_to_mask(inv, srt, did, did, n)
                return ~mask if p.type == PredicateType.NOT_EQ else mask
            if p.type in (PredicateType.IN, PredicateType.NOT_IN):
                mask = np.zeros(n, dtype=bool)
                for v in p.values:
                    did = d.index_of(v)
                    if did >= 0:
                        mask |= self._ids_to_mask(inv, srt, did, did, n)
                return ~mask if p.type == PredicateType.NOT_IN else mask
            if p.type == PredicateType.RANGE:
                lo_id = 0
                hi_id = m.cardinality - 1
                if p.lower is not None:
                    lo_id = d.insertion_index(p.lower, "left" if p.lower_inclusive else "right")
                if p.upper is not None:
                    hi_id = d.insertion_index(p.upper, "right" if p.upper_inclusive else "left") - 1
                return self._ids_to_mask(inv, srt, lo_id, hi_id, n)
            return None
        if m.encoding == "RAW" and m.single_value and p.type == PredicateType.RANGE:
            rng = segment.get_range_index(col)
            if rng is not None:
                return rng.mask_in_range(n, p.lower, p.upper,
                                         p.lower_inclusive, p.upper_inclusive)
        return None

    @staticmethod
    def _ids_to_mask(inv, srt, lo_id, hi_id, n) -> np.ndarray:
        if hi_id < lo_id or lo_id < 0:
            return np.zeros(n, dtype=bool)
        if srt is not None:
            s, e = srt.doc_range(lo_id, hi_id)
            mask = np.zeros(n, dtype=bool)
            mask[s:e] = True
            return mask
        return inv.mask_for_range(lo_id, hi_id, n)

    def _eval_mv_predicate(self, p: Predicate, segment) -> np.ndarray:
        col = p.lhs.identifier
        rows = segment.get_mv_values(col)

        def match_one(val) -> bool:
            if p.type == PredicateType.EQ:
                return any(x == p.values[0] for x in val)
            if p.type == PredicateType.NOT_EQ:
                return any(x != p.values[0] for x in val)
            if p.type == PredicateType.IN:
                return any(x in p.values for x in val)
            if p.type == PredicateType.NOT_IN:
                return any(x not in p.values for x in val)
            if p.type == PredicateType.RANGE:
                for x in val:
                    ok = True
                    if p.lower is not None:
                        ok &= (x >= p.lower) if p.lower_inclusive else (x > p.lower)
                    if p.upper is not None:
                        ok &= (x <= p.upper) if p.upper_inclusive else (x < p.upper)
                    if ok:
                        return True
                return False
            raise UnsupportedQueryError(f"host MV predicate {p.type}")

        return np.asarray([match_one(r) for r in rows], dtype=bool)

    # -- value expressions -------------------------------------------------
    def eval_value(self, e: ExpressionContext, segment) -> np.ndarray:
        n = segment.num_docs
        if e.is_literal:
            v = e.literal
            if isinstance(v, bool):
                v = int(v)
            return np.full(n, v)
        if e.is_identifier:
            vals = segment.get_values(e.identifier)
            if DataType(segment.column_metadata(e.identifier).data_type) == DataType.BOOLEAN:
                return vals.astype(np.int64)
            return vals
        fn = e.function
        name, args = fn.name, fn.arguments
        if name in _NP_BIN:
            return _NP_BIN[name](self.eval_value(args[0], segment), self.eval_value(args[1], segment))
        if name in _NP_UN:
            return _NP_UN[name](self.eval_value(args[0], segment))
        if name == "cast":
            return _np_cast(self.eval_value(args[0], segment), str(args[1].literal).upper())
        if name == "case":
            out = self.eval_value(args[-1], segment)
            for i in range(len(args) - 3, -1, -2):
                cond = self.eval_value(args[i], segment).astype(bool)
                out = np.where(cond, self.eval_value(args[i + 1], segment), out)
            return out
        if name == "coalesce" and args and args[0].is_identifier:
            base = self.eval_value(args[0], segment)
            nulls = segment.get_null_bitmap(args[0].identifier)
            if nulls is None or len(args) < 2:
                return base
            fallback = self.eval_value(args[1], segment)
            return np.where(nulls, fallback, base)
        td = get_transform(name)
        if td is not None:
            if td.mv_arg and args and args[0].is_identifier and segment.has_column(
                    args[0].identifier) and not segment.column_metadata(
                    args[0].identifier).single_value:
                rows = segment.get_mv_values(args[0].identifier)
                arr = np.empty(len(rows), dtype=object)
                arr[:] = [list(r) for r in rows]
                rest = [a.literal if a.is_literal else self.eval_value(a, segment)
                        for a in args[1:]]
                return td.eval_np(arr, *rest)
            vals = [(int(a.literal) if isinstance(a.literal, bool) else a.literal)
                    if a.is_literal else self.eval_value(a, segment) for a in args]
            return td.eval_np(*vals)
        raise UnsupportedQueryError(f"host transform {name}")

    # -- shapes ------------------------------------------------------------
    def _aggregation(self, query, segment, mask) -> AggIntermediate:
        nh = query.null_handling
        states = []
        for agg in query.aggregations:
            states.append(self._agg_state(agg, segment, mask, nh))
        return AggIntermediate(states, num_docs_scanned=int(mask.sum()))

    def _clause_mask(self, cond: ExpressionContext, segment,
                     nh: bool) -> np.ndarray:
        """FILTER (WHERE cond) clause mask via the same predicate
        machinery as WHERE (LIKE/IN/IS NULL all work; 3VL under null
        handling), mirroring the device's FilterVal lowering."""
        try:
            fc = filter_from_expression(cond)
        except FilterConversionError:
            m = np.asarray(self.eval_value(cond, segment)).astype(bool)
            if nh:  # a null clause input is false
                m &= ~self._nulls_of(cond.columns(), segment, segment.num_docs)
            return m
        if nh:
            t, _u = self._eval_filter3(fc, segment)
            return t
        return self._eval_filter(fc, segment)

    def _agg_state(self, agg: ExpressionContext, segment, mask, nh=False):
        name = agg.function.name
        if name == "filter":  # AGG(x) FILTER (WHERE cond)
            inner, cond = agg.function.arguments
            return self._agg_state(
                inner, segment, mask & self._clause_mask(cond, segment, nh), nh)
        if name in funnel.FUNNEL_FNS:
            return self._funnel_builder(agg.function, segment)(
                np.nonzero(mask)[0])
        data, extra = split_args(agg.function)
        if nh and data:
            # skip rows where ANY operand column is null (COUNT(expr) too;
            # multi-arg states must stay row-aligned)
            cols_ref = set().union(*(a.columns() for a in data)) - {"*"}
            drop = self._nulls_of(cols_ref, segment, segment.num_docs)
            if drop.any():
                mask = mask & ~drop
        if name == "count":
            return int(mask.sum())
        arg = data[0] if data else None
        if (len(data) == 1 and arg.is_identifier and segment.has_column(arg.identifier)
                and not segment.column_metadata(arg.identifier).single_value):
            # MV argument: aggregate over ALL values of the selected rows
            # (reference *MV aggregation functions)
            mv_rows = segment.get_mv_values(arg.identifier)
            flat = [v for i in np.nonzero(mask)[0] for v in mv_rows[i]]
            return host_state(name, np.asarray(flat), extra)
        cols = [np.asarray(self.eval_value(a, segment))[mask] for a in data]
        return host_state_full(name, cols, extra)

    def _funnel_builder(self, fn, segment):
        """rows_idx → funnel intermediate state, with the whole-segment row
        arrays (step masks, timestamps, correlation values) computed once
        and shared across groups (engine/funnel.py)."""
        spec = funnel.parse_funnel(fn)
        if isinstance(spec, funnel.FunnelCountSpec):
            corr, masks = funnel.count_row_arrays(self, spec, segment)

            def build_count(rows_idx):
                return funnel.count_state(corr, masks, rows_idx)

            return build_count
        ts, step, valid = funnel.window_row_arrays(self, spec, segment)

        def build_window(rows_idx):
            r = rows_idx[valid[rows_idx]]
            return funnel.window_state(ts, step, r)

        return build_window

    def _group_by(self, query, segment, mask, group_exprs) -> GroupByIntermediate:
        if any(e.is_identifier and segment.has_column(e.identifier)
               and not segment.column_metadata(e.identifier).single_value
               for e in group_exprs):
            return self._group_by_mv(query, segment, mask, group_exprs)
        key_cols = [np.asarray(self.eval_value(e, segment)) for e in group_exprs]
        key_ids = [_sorted_ids(e, segment) for e in group_exprs]
        sel = np.nonzero(mask)[0]
        fast = self._group_by_vectorized(query, segment, sel, key_cols, mask,
                                         key_ids)
        if fast is not None:
            return fast
        groups: dict[tuple, list] = {}
        # factorize each key col then group by linear code
        codes = np.zeros(len(sel), dtype=np.int64)
        for col, ids in zip(key_cols, key_ids):
            n_u, inv = _factorize(col, ids, sel)
            codes = codes * n_u + inv if n_u else codes
        order = np.argsort(codes, kind="stable")
        sel_sorted = sel[order]
        codes_sorted = codes[order]
        boundaries = np.nonzero(np.diff(codes_sorted))[0] + 1
        starts = np.concatenate([[0], boundaries])
        ends = np.concatenate([boundaries, [len(sel_sorted)]])
        agg_args = self._classify_agg_args(query, segment)
        for s, e in zip(starts, ends):
            if s == e:
                continue
            rows = sel_sorted[s:e]
            key = tuple(_to_python(col[rows[0]]) for col in key_cols)
            states = []
            for (kind, cols, extra, drop, fname) in agg_args:
                r = rows if drop is None else rows[~drop[rows]]
                if kind == "count":
                    states.append(len(r))
                elif kind == "funnel":
                    states.append(cols(r))
                elif kind == "mv":
                    flat = [v for i in r for v in cols[i]]
                    states.append(
                        host_state(fname, np.asarray(flat), extra))
                else:
                    states.append(
                        host_state_full(fname, [c[r] for c in cols], extra))
            groups[key] = states
        return GroupByIntermediate(groups, num_docs_scanned=int(mask.sum()))

    def _classify_agg_args(self, query, segment) -> list:
        """Per aggregation: (kind, payload, extra, drop, name) where kind is
        "count" | "mv" (MV column decoded ONCE per query) | "sv" (eval'd
        value arrays), drop is a bitmap of rows to skip for this agg
        (advanced null handling ∪ a FILTER (WHERE ...) clause; None = keep
        all), and name is the state function to build (the INNER name for
        filter-wrapped aggs). Shared by the SV and MV group-by paths."""
        nh = query.null_handling
        n = segment.num_docs
        agg_args = []
        mv_cache: dict[str, object] = {}

        def drop_for(exprs, clause_drop):
            d = clause_drop
            if nh:
                cols = set()
                for a in exprs:
                    cols |= a.columns()
                nd = self._nulls_of(cols - {"*"}, segment, n)
                if nd.any():
                    d = nd if d is None else (d | nd)
            return d

        for agg in query.aggregations:
            fexpr = agg.function
            clause_drop = None
            if fexpr.name == "filter":  # AGG(x) FILTER (WHERE cond)
                inner, cond = fexpr.arguments
                clause_drop = ~self._clause_mask(cond, segment, nh)
                fexpr = inner.function
            name = fexpr.name
            if name in funnel.FUNNEL_FNS:
                agg_args.append(("funnel", self._funnel_builder(fexpr, segment),
                                 (), clause_drop, name))
                continue
            data, extra = split_args(fexpr)
            if name == "count":
                # advanced null handling: COUNT(col) counts non-null rows
                agg_args.append(
                    ("count", None, (), drop_for(data, clause_drop), name))
                continue
            if (len(data) == 1 and data[0].is_identifier
                    and segment.has_column(data[0].identifier)
                    and not segment.column_metadata(
                        data[0].identifier).single_value):
                # MV argument: per group, aggregate over ALL entries of the
                # group's rows (same flattening as the ungrouped _agg_state
                # MV branch)
                col = data[0].identifier
                if col not in mv_cache:
                    mv_cache[col] = segment.get_mv_values(col)
                agg_args.append(("mv", mv_cache[col], extra,
                                 drop_for(data, clause_drop), name))
            else:
                agg_args.append(
                    ("sv", [np.asarray(self.eval_value(a, segment))
                            for a in data], extra,
                     drop_for(data, clause_drop), name))
        return agg_args

    def _group_by_mv(self, query, segment, mask, group_exprs) -> GroupByIntermediate:
        """MV group key(s): one expanded row per (doc × entry) combination
        per MV dim (cross product when several) — a doc contributes to the
        group of EACH of its values, and docs with empty arrays drop out
        (reference MVGroupKeyGenerator). Docs scanned counts matched DOCS,
        not expanded rows."""
        sel = np.nonzero(mask)[0]
        docs = sel
        expanded: dict[int, np.ndarray] = {}
        for di, e in enumerate(group_exprs):
            if not (e.is_identifier and segment.has_column(e.identifier)
                    and not segment.column_metadata(e.identifier).single_value):
                continue
            rows = segment.get_mv_values(e.identifier)
            lens = np.fromiter((len(rows[d]) for d in docs),
                               dtype=np.int64, count=len(docs))
            vals = [v for d in docs for v in rows[d]]
            for k in expanded:
                expanded[k] = np.repeat(expanded[k], lens)
            docs = np.repeat(docs, lens)
            expanded[di] = np.asarray(vals, dtype=object)
        key_cols = []
        for di, e in enumerate(group_exprs):
            if di in expanded:
                key_cols.append(expanded[di])
            else:
                key_cols.append(np.asarray(self.eval_value(e, segment))[docs])

        agg_args = self._classify_agg_args(query, segment)

        groups: dict[tuple, list] = {}
        order = np.lexsort([np.asarray([repr(v) for v in c], dtype=object)
                            for c in reversed(key_cols)]) \
            if key_cols and len(docs) else np.arange(len(docs))
        # group contiguity via sorted tuples
        keys_sorted = [tuple(_to_python(c[i]) for c in key_cols) for i in order]
        i = 0
        while i < len(order):
            j = i
            while j < len(order) and keys_sorted[j] == keys_sorted[i]:
                j += 1
            rows_idx = docs[order[i:j]]
            states = []
            for (kind, cols, extra, drop, fname) in agg_args:
                r = rows_idx if drop is None else rows_idx[~drop[rows_idx]]
                if kind == "count":
                    states.append(len(r))
                elif kind == "funnel":
                    states.append(cols(r))
                elif kind == "mv":
                    flat = [v for d in r for v in cols[d]]
                    states.append(
                        host_state(fname, np.asarray(flat), extra))
                else:
                    states.append(host_state_full(
                        fname, [c[r] for c in cols], extra))
            groups[keys_sorted[i]] = states
            i = j
        return GroupByIntermediate(groups, num_docs_scanned=int(mask.sum()))

    # scalar aggs with a columnar (GroupArrays) host form: same set the
    # device fast path supports, so host and device baselines are comparable
    _VEC_AGGS = frozenset(VEC_RECIPES)

    def _group_by_vectorized(self, query, segment, sel, key_cols, mask,
                             key_ids):
        """np.unique + scatter-reduce group-by → GroupArrays, no per-group
        Python. Returns None when any aggregation lacks a columnar form
        (the general host_state_full loop handles it)."""
        nh = query.null_handling
        agg_vals = []
        for agg in query.aggregations:
            name = agg.function.name
            if name not in self._VEC_AGGS:
                return None
            if name == "count" and not nh:
                agg_vals.append(None)
                continue
            data, extra = split_args(agg.function)
            if nh and any(self._nulls_of(a.columns() - {"*"}, segment,
                                         segment.num_docs).any()
                          for a in data):
                return None  # null-skipping states: general loop handles
            if name == "count":
                agg_vals.append(None)
                continue
            if len(data) != 1 or extra:
                return None
            try:
                v = np.asarray(self.eval_value(data[0], segment))
            except Exception:
                return None
            if v.dtype.kind not in "ifb" or v.shape != mask.shape:
                return None
            agg_vals.append(v[sel].astype(np.float64))

        codes = np.zeros(len(sel), dtype=np.int64)
        for col, ids in zip(key_cols, key_ids):
            n_u, inv = _factorize(col, ids, sel)
            codes = codes * max(1, n_u) + inv
        ucodes, first_idx, inv2 = np.unique(
            codes, return_index=True, return_inverse=True)
        g = len(ucodes)
        rep = sel[first_idx]  # representative row per group
        out_keys = [col[rep] for col in key_cols]
        counts = np.bincount(inv2, minlength=g).astype(np.int64)

        def scatter_sum(vals):
            out = np.zeros(g)
            np.add.at(out, inv2, vals)
            return out

        def scatter_min(vals):
            out = np.full(g, np.inf)
            np.minimum.at(out, inv2, vals)
            return out

        def scatter_max(vals):
            out = np.full(g, -np.inf)
            np.maximum.at(out, inv2, vals)
            return out

        states, specs, tags = [], [], []
        for agg, vals in zip(query.aggregations, agg_vals):
            name = agg.function.name
            spec, tag = VEC_RECIPES[name]  # shared with the device lowering
            if name == "count":
                states.append((counts,))
            elif name == "sum":
                states.append((scatter_sum(vals),))
            elif name == "min":
                states.append((scatter_min(vals),))
            elif name == "max":
                states.append((scatter_max(vals),))
            elif name == "avg":
                states.append((scatter_sum(vals), counts))
            else:  # minmaxrange
                states.append((scatter_min(vals), scatter_max(vals)))
            specs.append(spec)
            tags.append(tag)
        return GroupArrays(out_keys, states, specs, tags,
                           num_docs_scanned=int(mask.sum()))

    def _selection(self, query, segment, mask) -> SelectionIntermediate:
        cols, exprs = selection_columns_for(query, segment)
        return selection_from_mask(
            query, segment, cols, mask, extra_exprs=exprs or None,
            evaluator=lambda e, doc_ids: self.eval_value_at(e, segment, doc_ids))

    def eval_value_at(self, e: ExpressionContext, segment, doc_ids) -> np.ndarray:
        """Evaluate a transform expression over a row subset only (LIMIT-k
        selections must not pay O(num_docs) python time)."""
        try:
            out = eval_expr_np(
                e, lambda name: segment.get_values_at(name, doc_ids))
        except UnsupportedQueryError:
            return np.asarray(self.eval_value(e, segment))[doc_ids]
        out = np.asarray(out)
        if out.ndim == 0:
            out = np.broadcast_to(out, (len(doc_ids),)).copy()
        return out


_NP_BIN = {
    "plus": np.add, "minus": np.subtract, "times": np.multiply,
    "divide": np.true_divide, "mod": np.mod, "pow": np.power, "power": np.power,
    "equals": lambda a, b: a == b, "notequals": lambda a, b: a != b,
    "lessthan": lambda a, b: a < b, "lessthanorequal": lambda a, b: a <= b,
    "greaterthan": lambda a, b: a > b, "greaterthanorequal": lambda a, b: a >= b,
    "and": np.logical_and, "or": np.logical_or,
    "least": np.minimum, "greatest": np.maximum,
}

_NP_UN = {
    "neg": np.negative, "abs": np.abs, "not": np.logical_not, "exp": np.exp,
    "ln": np.log, "log10": np.log10, "log2": np.log2, "sqrt": np.sqrt,
    "ceiling": np.ceil, "ceil": np.ceil, "floor": np.floor, "sign": np.sign,
}


def _np_cast(v, to):
    m = {"INT": np.int32, "LONG": np.int64, "FLOAT": np.float32, "DOUBLE": np.float64,
         "BOOLEAN": bool, "STRING": np.str_, "TIMESTAMP": np.int64}
    if to not in m:
        raise UnsupportedQueryError(f"cast to {to}")
    return v.astype(m[to])


# dictionary types whose sorted dictionary orders its ids as np.unique
# orders its values (no NaN or signed zero, no bytes)
_ID_ORDERED = frozenset(("INT", "LONG", "STRING", "BOOLEAN", "TIMESTAMP"))


def _sorted_ids(e: ExpressionContext, segment):
    """The dict ids of a group key that names a single-value column of an
    immutable segment's sorted dictionary, else None: np.unique over the
    ids factorizes the rows as np.unique over the values does, without
    sorting the values (strings above all). A consuming segment's
    dictionary is in insertion order, so it is left out."""
    if not e.is_identifier or getattr(segment, "is_mutable", False) \
            or not segment.has_column(e.identifier):
        return None
    m = segment.column_metadata(e.identifier)
    if m.encoding != "DICT" or not m.single_value \
            or str(m.data_type) not in _ID_ORDERED:
        return None
    return segment.get_dict_ids(e.identifier)


def _factorize(col: np.ndarray, ids, sel: np.ndarray):
    """(distinct keys, each selected row's rank among them) of a key
    column at the rows `sel`, by its dict ids where given."""
    u, inv = np.unique(col[sel] if ids is None else ids[sel],
                       return_inverse=True)
    return len(u), inv


def _coerce_to(arr: np.ndarray, value):
    if isinstance(value, bool) and np.issubdtype(arr.dtype, np.number):
        return int(value)
    return value


def _to_python(v):
    if isinstance(v, np.generic):
        return v.item()
    return v
