"""Cross-segment combine.

The port of pinot_tpu/engine/combine.py (reference: GroupByCombineOperator
merging into an IndexedTable keyed on group Records). Intermediates are
already keyed by group VALUES, so combine is a merge using each
aggregation's AggSemantics, or a vectorized factorize + np.{add,min,max}.at
over the columnar group tables; selection rows concatenate.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from . import ir
from .aggregation import AggSemantics
from .results import (AggIntermediate, GroupArrays, GroupByIntermediate,
                      SelectionIntermediate)

_MERGE_INIT = {"add": 0.0, "min": np.inf, "max": -np.inf}
_MERGE_AT = {"add": np.add.at, "min": np.minimum.at, "max": np.maximum.at}


def combine_batched_dense(outs_b: Sequence, plans: Sequence) -> Optional[list]:
    """Per-member GroupArrays of a dense group-by FAMILY's host outputs
    (every array with a leading [S] member dim): ONE np.nonzero over the
    whole [S, G] counts block and one scanned-docs reduction instead of S
    of each. Key decodes stay per member (dictionaries are segment-local).
    Equal to each member's own collect(); None outside the dense mode, for
    an MV GROUP BY (its scanned docs are not its pair counts), and when an
    aggregation has no columnar form (its members then decode one
    by one into object states)."""
    p0 = plans[0].program
    if p0.mode != "group_by" or p0.mv_group_slot is not None:
        return None
    if any(la.vec is None for pl in plans for la in pl.lowered_aggs):
        return None
    num_groups = p0.num_groups
    counts_b = np.asarray(outs_b[0])[:, :num_groups]
    rows, gids = np.nonzero(counts_b)  # row-major: member order preserved
    bounds = np.searchsorted(rows, np.arange(len(plans) + 1))
    scanned_b = counts_b.sum(axis=1)
    result = []
    for s, pl in enumerate(plans):
        g = gids[bounds[s]:bounds[s + 1]]
        outs_s = [o[s] for o in outs_b]  # zero-copy views
        key_cols = [
            np.asarray(dim.dictionary.values[(g // stride) % dim.cardinality])
            for dim, stride in zip(pl.group_dims, pl.program.group_strides)]
        result.append(GroupArrays(
            key_cols,
            [la.vec.extract(outs_s, g) for la in pl.lowered_aggs],
            [la.vec.spec for la in pl.lowered_aggs],
            [la.vec.fin_tag for la in pl.lowered_aggs],
            num_docs_scanned=int(scanned_b[s])))
    return result


def combine_batched_aggregation(outs_b: Sequence, plans: Sequence) -> list:
    """Per-member AggIntermediates of an aggregation family's host outputs:
    the scanned-docs column reads once for the whole family. Equal to each
    member's own collect()."""
    scanned_b = np.asarray(outs_b[0])[:, 0]
    return [
        AggIntermediate(
            [la.extract([o[s] for o in outs_b], 0)
             for la in pl.lowered_aggs],
            num_docs_scanned=int(scanned_b[s]))
        for s, pl in enumerate(plans)]


def combine_group_arrays(
    intermediates: Sequence[GroupArrays],
) -> Optional[GroupArrays]:
    """Vectorized cross-segment merge of columnar group tables: factorize
    each key dimension over the concatenated columns, build a composite
    group id, and scatter-merge every state component. Returns None when
    the composite id would overflow (the caller falls back to the dict
    merge)."""
    first = intermediates[0]
    scanned = sum(im.num_docs_scanned for im in intermediates)
    trimmed = any(im.groups_trimmed for im in intermediates)
    if len(intermediates) == 1:
        first.num_docs_scanned = scanned
        return first
    ndim = len(first.key_cols)
    cat_keys = [np.concatenate([im.key_cols[d] for im in intermediates])
                for d in range(ndim)]
    total = len(cat_keys[0]) if ndim else 0
    if total == 0:
        return GroupArrays([np.empty(0, object)] * ndim,
                           [tuple(np.empty(0) for _ in s)
                            for s in first.vec_specs],
                           first.vec_specs, first.fin_tags, scanned,
                           groups_trimmed=trimmed)
    uniqs, composite, stride = [], np.zeros(total, dtype=np.int64), 1
    for col in reversed(cat_keys):
        uniq, inv = np.unique(col, return_inverse=True)
        if stride * len(uniq) >= ir.SPARSE_KEY_SPACE:
            return None  # composite id overflow; dict merge handles it
        composite += inv.astype(np.int64) * stride
        stride *= max(1, len(uniq))
        uniqs.append(uniq)
    uniqs.reverse()
    uniq_comp, inv = np.unique(composite, return_inverse=True)
    g = len(uniq_comp)
    # decode merged composite ids back to per-dim values
    out_keys = []
    strides = [1] * ndim
    for d in range(ndim - 2, -1, -1):
        strides[d] = strides[d + 1] * max(1, len(uniqs[d + 1]))
    for d in range(ndim):
        out_keys.append(uniqs[d][(uniq_comp // strides[d]) % max(1, len(uniqs[d]))])
    out_states = []
    for ai, spec in enumerate(first.vec_specs):
        comps = []
        for ci, op in enumerate(spec):
            cat = np.concatenate(
                [im.state_cols[ai][ci] for im in intermediates])
            if op == "add":
                out = np.zeros(g, dtype=cat.dtype)
            else:
                out = np.full(g, _MERGE_INIT[op], dtype=np.float64)
            _MERGE_AT[op](out, inv, cat)
            comps.append(out)
        out_states.append(tuple(comps))
    return GroupArrays(out_keys, out_states, first.vec_specs,
                       first.fin_tags, scanned, groups_trimmed=trimmed)


def combine_group_by(
    intermediates: Sequence[GroupByIntermediate], semantics: list[AggSemantics]
) -> GroupByIntermediate:
    merged: dict[tuple, list] = {}
    scanned = 0
    trimmed = False
    for im in intermediates:
        scanned += im.num_docs_scanned
        trimmed |= im.groups_trimmed
        for key, states in im.groups.items():
            cur = merged.get(key)
            if cur is None:
                merged[key] = list(states)
            else:
                for i, sem in enumerate(semantics):
                    cur[i] = sem.merge(cur[i], states[i])
    return GroupByIntermediate(merged, scanned, groups_trimmed=trimmed)


def combine_aggregation(
    intermediates: Sequence[AggIntermediate], semantics: list[AggSemantics]
) -> AggIntermediate:
    it = iter(intermediates)
    first = next(it)
    states = list(first.states)
    scanned = first.num_docs_scanned
    for im in it:
        scanned += im.num_docs_scanned
        for i, sem in enumerate(semantics):
            states[i] = sem.merge(states[i], im.states[i])
    return AggIntermediate(states, scanned)


def combine_selection(
    intermediates: Sequence[SelectionIntermediate],
) -> SelectionIntermediate:
    """Concatenate the segments' rows (each already capped or top-k'd to
    offset + limit); the broker re-sorts and trims."""
    first = intermediates[0]
    rows = list(first.rows)
    scanned = first.num_docs_scanned
    for im in intermediates[1:]:
        scanned += im.num_docs_scanned
        rows.extend(im.rows)
    return SelectionIntermediate(first.columns, rows, scanned)


# -- server-side group trim (reference: TableResizer in the IndexedTable) ----

DEFAULT_MIN_TRIM_SIZE = 5_000
DEFAULT_TRIM_THRESHOLD = 1_000_000


def trim_group_by(combined, query, semantics):
    """Trim an ordered group-by intermediate to max(5*limit, minTrimSize)
    groups when the group count exceeds the trim threshold (reference:
    TableResizer.resize). Trims ONLY when every ORDER BY expression is a
    group key or a finalized aggregation."""
    if not query.is_group_by or not query.order_by_expressions:
        return combined
    opts = query.query_options
    min_trim = int(opts.get("minServerGroupTrimSize", DEFAULT_MIN_TRIM_SIZE))
    threshold = int(opts.get("groupTrimThreshold", DEFAULT_TRIM_THRESHOLD))
    if min_trim <= 0 or threshold <= 0 or query.having_filter is not None:
        return combined
    trim_size = max((query.limit or 0) * 5, min_trim)
    num_groups = combined.num_groups if isinstance(combined, GroupArrays) \
        else len(combined.groups)
    if num_groups <= max(trim_size, 0) or num_groups <= threshold:
        return combined

    group_strs = [str(g) for g in query.group_by_expressions]
    agg_strs = [str(a) for a in query.aggregations]
    alias_map = {a: str(se) for se, a in
                 zip(query.select_expressions, query.aliases) if a}

    if isinstance(combined, GroupArrays):
        colmap = {s: c for s, c in zip(group_strs, combined.key_cols)}
        from .reduce import _apply_fin_tag

        for s, tag, comps in zip(agg_strs, combined.fin_tags,
                                 combined.state_cols):
            colmap[s] = _apply_fin_tag(tag, comps)
        order = []
        for ob in query.order_by_expressions:
            key = str(ob.expression)
            key = alias_map.get(key, key)
            col = colmap.get(key)
            if col is None or (not ob.ascending and col.dtype == object):
                return combined  # unsupported order expr: no trim
            order.append((col, ob.ascending))
        perm = np.arange(num_groups)
        for col, asc in reversed(order):
            vals = col[perm]
            k = (np.argsort(vals, kind="stable") if asc
                 else np.argsort(-vals, kind="stable"))
            perm = perm[k]
        sel = np.sort(perm[:trim_size])
        return GroupArrays(
            [c[sel] for c in combined.key_cols],
            [tuple(comp[sel] for comp in comps)
             for comps in combined.state_cols],
            combined.vec_specs, combined.fin_tags,
            num_docs_scanned=combined.num_docs_scanned,
            # the ordered trim is lossless for the final ORDER BY/LIMIT:
            # it does not read as numGroupsLimitReached
            groups_trimmed=combined.groups_trimmed)

    # dict-form intermediate: sort keys from key values / finalized states
    def sort_value(key, states, expr_str):
        if expr_str in group_strs:
            return key[group_strs.index(expr_str)]
        if expr_str in agg_strs:
            i = agg_strs.index(expr_str)
            return semantics[i].finalize(states[i])
        return None

    order_exprs = []
    for ob in query.order_by_expressions:
        key = str(ob.expression)
        key = alias_map.get(key, key)
        if key not in group_strs and key not in agg_strs:
            return combined
        order_exprs.append((key, ob.ascending))

    def rank(item):
        key, states = item
        return tuple(_TrimKey(sort_value(key, states, expr_str), asc)
                     for expr_str, asc in order_exprs)

    import heapq

    kept = heapq.nsmallest(trim_size, combined.groups.items(), key=rank)
    return GroupByIntermediate(dict(kept), combined.num_docs_scanned,
                               groups_trimmed=combined.groups_trimmed)


class _TrimKey:
    """Orderable wrapper honoring per-key direction + cross-type safety."""

    __slots__ = ("v", "asc")

    def __init__(self, v, asc):
        self.v = v
        self.asc = asc

    def __lt__(self, other):
        a, b = self.v, other.v
        if a is None:
            return False
        if b is None:
            return True
        try:
            return a < b if self.asc else b < a
        except TypeError:
            return str(a) < str(b) if self.asc else str(b) < str(a)

    def __eq__(self, other):
        return self.v == other.v
