"""EXPLAIN PLAN FOR and EXPLAIN ANALYZE for the single-stage engine.

The port of pinot_tpu/engine/explain.py. Reference: pinot-core's EXPLAIN
output (ExplainPlanDataTableReducer et al.) renders an operator tree as
(Operator, Operator_Id, Parent_Id) rows: BROKER_REDUCE -> COMBINE ->
per-segment plan operators. Here the per-segment "operators" are the
kernel IR the query lowers to, so the tree shows the program's mode, the
lowered filter algebra, the group dims, the device reductions and which
segments were pruned. EXPLAIN IMPLEMENTATION PLAN FOR adds how the
segments' tables merge (SERVER_COMBINE) and how many batch families the
segments form (SEGMENT_BATCH). Planning is host-only: an EXPLAIN gives the
same rows on every device.

Under QueryExecutor's backend "host" the kernel and its reductions render
as HOST_KERNEL and HOST_REDUCE, with no kernel B eligibility, no sparse
device combine and no batch families; a shape the segment planner refuses
renders HOST_ENGINE(numpy fallback: ...) under "host" and "auto", as in
the JAX package. Where the port differs: under the default "device" a
refusal renders UNSUPPORTED(no host engine: ...), since no host engine
answers it there. The COMBINE row counts consuming segments as
`consuming(host):N` and plans the immutable ones, the reference's
wording, as the JAX package does.

`analyze_table` renders an executed run's span tree (spi/trace.py) as the
same kind of table, each node annotated with its observed stats: the
EXPLAIN ANALYZE product of both engines.
"""

from __future__ import annotations

import copy

import numpy as np

from ..query.optimizer import optimize_filter
from ..segment.startree import try_rewrite
from . import ir
from .aggregation import UnsupportedQueryError
from .executor import batch_family_key
from .plan import SegmentPlanner
from .results import DataSchema, ResultTable


def explain_plan(query, table, pruner, packed_on: bool,
                 backend: str = "device",
                 use_star_tree: bool = True) -> ResultTable:
    """The plan rows of `query` over `table`'s segments under `backend`
    ("device", "host" or "auto"). `packed_on` says whether the device
    keeps narrow id planes (it shapes the batch family keys SEGMENT_BATCH
    counts)."""
    from ..ops import fused_groupby

    # explain what runs: the canonical filter the executor runs
    query = copy.copy(query)
    query.filter = optimize_filter(query.filter)

    rows: list[list] = []

    def add(op: str, parent: int) -> int:
        rows.append([op, len(rows), parent])
        return len(rows) - 1

    ob = ""
    if query.order_by_expressions:
        ob = ", sort:[" + ", ".join(map(str, query.order_by_expressions)) + "]"
    having = f", having:{query.having_filter}" if query.having_filter else ""
    root = add(f"BROKER_REDUCE(limit:{query.limit}{ob}{having})", -1)

    # one copy of the (possibly live) list: a commit between two reads
    # would skew the count of consuming segments
    every = list(table.segments)
    segments = [s for s in every if not getattr(s, "is_mutable", False)]
    kept, pruned = pruner.prune(query, segments) if segments else ([], 0)
    mutable = len(every) - len(segments)

    if query.is_aggregation_query or query.is_group_by or query.distinct:
        combine = "COMBINE_GROUP_BY" if (query.is_group_by or query.distinct) \
            else "COMBINE_AGGREGATE"
    else:
        combine = "COMBINE_SELECT"
    cid = add(f"{combine}(segments:{len(kept)}, pruned:{pruned}"
              + (f", consuming(host):{mutable}" if mutable else "") + ")",
              root)

    if not kept:
        add("EMPTY(no immutable segments matched)", cid)
        return _table(rows)

    def route(seg):
        """(query, segment) the segment plans, as route_segments routes
        it: a star-tree rewrite where one fits."""
        if use_star_tree and getattr(seg, "valid_doc_ids", None) is None:
            star = try_rewrite(query, seg)
            if star is not None:
                return star.query, star.view, True
        return query, seg, False

    plan_query, plan_seg, star = route(kept[0])
    if star:
        cid = add("FILTER_STARTREE_INDEX(pre-aggregated docs)", cid)
    try:
        plan = SegmentPlanner(plan_query, plan_seg).plan()
    except UnsupportedQueryError as e:
        add(f"UNSUPPORTED(no host engine: {e})" if backend == "device"
            else f"HOST_ENGINE(numpy fallback: {e})", cid)
        return _table(rows)

    on_host = backend == "host"
    p = plan.program
    desc = f"{'HOST' if on_host else 'DEVICE'}_KERNEL(mode:{p.mode}"
    if p.mode in ("group_by", "group_by_sparse"):
        dims = ", ".join(f"{d.column}[card:{d.cardinality}]"
                         for d in plan.group_dims)
        desc += f", groups:{p.num_groups}, dims:[{dims}]"
        # the group-by kernel variant: the dense table, kernel A or B, or
        # one of the sparse sort strategies (ir.sparse_groupby_path mirrors
        # the kernel's branch)
        path = "dense"
        if p.mode == "group_by_sparse":
            path = ir.sparse_groupby_path(p)
            desc += f", key_space:{p.key_space}"
            if p.exact_trim:
                desc += ", orderByTrim:exact"
        if p.mv_group_slot is not None:
            desc += ", mvExpansion:true"
        if not on_host and fused_groupby.plan(p, None) is not None:
            # kernel B's shape (ops/fused_groupby.py); its use still
            # depends on the planes' dtypes and the LUTs' runs
            desc += ", fusedMxu:eligible"
            if p.mode == "group_by":
                path = "mxu"
        desc += f", path:{path}"
    kid = add(desc + ")", cid)

    implementation = getattr(query, "explain", False) == "implementation"
    if implementation and p.mode in ("group_by", "group_by_sparse"):
        # how the per-segment tables merge: the sparse device merge, the
        # columnar merge, or the per-group dict merge
        vec_ok = all(la.vec is not None for la in plan.lowered_aggs)
        if (p.mode == "group_by_sparse" and not on_host and len(kept) > 1
                and p.group_strides == (1,) and len(p.group_slots) == 1
                and plan.group_dims and vec_ok
                and np.issubdtype(np.asarray(
                    plan.group_dims[0].dictionary.values).dtype,
                    np.integer)):
            impl = "device-sparse(concat+edge-reduce)"
        elif vec_ok:
            impl = "host-columnar-scatter"
        else:
            impl = "host-dict-merge"
        add(f"SERVER_COMBINE(impl:{impl}, segments:{len(kept)})", cid)

    if implementation and not on_host and len(kept) > 1:
        # batch families = device dispatches, over the key the dispatch
        # groups by
        if str(query.query_options.get("segmentBatch")).lower() in (
                "false", "0", "off"):
            add("SEGMENT_BATCH(disabled)", cid)
        else:
            fams: set = set()
            planned = 0
            for seg in kept:
                pq, ps, _ = route(seg)
                try:
                    pl = SegmentPlanner(pq, ps).plan()
                except UnsupportedQueryError:
                    continue
                fk = batch_family_key(ps, pl, packed_on)
                fams.add(fk if fk is not None else ("solo", id(ps)))
                planned += 1
            if planned:
                add(f"SEGMENT_BATCH(families:{len(fams)}, "
                    f"segments:{planned})", cid)

    for a in query.aggregations:
        # the SQL functions; COUNT(*) answers from the shared per-group
        # count and registers no device op of its own
        add(f"AGGREGATE(fn:{a})", kid)
    for agg in p.aggs:
        label = f"{'HOST' if on_host else 'DEVICE'}_REDUCE(op:{agg.kind}"
        if agg.card is not None:
            label += f", card:{agg.card}"
        if agg.bins is not None:
            label += f", bins:{agg.bins}"
        if agg.vmin is not None:
            label += f", bounds:[{agg.vmin},{agg.vmax}]"
        add(label + ")", kid)
    if not p.aggs and p.mode == "selection":
        cols = ", ".join(str(e) for e in query.select_expressions)
        add(f"SELECT(columns:[{cols}])", kid)

    fid = add("FILTER" if p.filter is not None else "MATCH_ALL", kid)
    if p.filter is not None:
        _walk_filter(p.filter, fid, add)
    return _table(rows)


# span attributes rendered on EXPLAIN ANALYZE nodes, in this order; the
# rest (transfers by plane, stack hits) stays in trace_info
_ANALYZE_ATTRS = ("segment", "numSegments", "segments", "device",
                  "meshDevices", "mode", "padded",
                  "fused", "workers", "leaf_pushdown", "rows_in", "rows_out",
                  "shuffled_rows", "shuffled_bytes", "join_impl",
                  "cross_stage_bytes", "device_partition_ms",
                  "host_crossings", "compileMs",
                  "deviceExecMs", "crossChipCombineMs", "transferBytes",
                  "cache")


def _cache_outcome(resp) -> str:
    """One word for the run's cache behaviour: the result cache's outcome
    when it answered, else the segment partial cache's hits and misses."""
    outcome = getattr(resp, "cache_outcome", None)
    if outcome == "hit":
        return "hit"
    hits = getattr(resp, "num_segments_cache_hit", 0)
    misses = getattr(resp, "num_segments_cache_miss", 0)
    if hits and not misses and not getattr(resp, "num_device_dispatches", 0):
        return "hit"
    if hits and misses:
        return "partial"
    if misses:
        return "miss"
    if hits:
        return "hit"
    # no segment-cache traffic: the result cache's outcome (a cacheable run
    # that missed is "miss"; a bypass is "off")
    return "miss" if outcome == "miss" else "off"


def analyze_table(trace_json: list, resp, table_name: str = "") -> ResultTable:
    """Render an executed run's span list as the (Operator, Operator_Id,
    Parent_Id) plan table, each node annotated with its observed stats. A
    span whose parent is missing attaches to the root, so a partial trace
    still renders one connected tree."""
    rows: list[list] = []

    def add(op: str, parent: int) -> int:
        rows.append([op, len(rows), parent])
        return len(rows) - 1

    n_rows = len(resp.result_table.rows) \
        if resp.result_table is not None else 0
    parts = [f"table:{table_name}"] if table_name else []
    parts += [f"rows:{n_rows}",
              f"timeMs:{round(resp.time_used_ms, 3)}",
              f"docsScanned:{resp.num_docs_scanned}",
              f"segments:{resp.num_segments_processed}",
              f"dispatches:{resp.num_device_dispatches}",
              f"compiles:{resp.num_compiles}",
              f"cacheHit:{resp.num_segments_cache_hit}",
              f"cacheMiss:{resp.num_segments_cache_miss}",
              f"cache:{_cache_outcome(resp)}"]
    if resp.num_coalesced_queries:
        parts.append(f"coalescedWith:{resp.num_coalesced_queries}")
        parts.append(f"coalesceWaitMs:{round(resp.coalesce_wait_ms, 3)}")
    root = add("EXPLAIN_ANALYZE(" + ", ".join(parts) + ")", -1)

    by_span: dict = {}  # trace spanId -> plan row id
    for s in trace_json:
        attrs = s.get("attributes") or {}
        bits = [f"{k}:{attrs[k]}" for k in _ANALYZE_ATTRS if k in attrs]
        bits.append(f"ms:{s.get('durationMs', 0.0)}")
        label = s.get("operator", "?")
        # a server's top spans in the broker's merged trace (cluster/
        # broker.py) carry the server they ran on
        if s.get("server"):
            label = f"{s['server']}/{label}"
        parent = by_span.get(s.get("parentId"), root)
        by_span[s.get("spanId")] = add(
            label + "(" + ", ".join(bits) + ")", parent)
    if not trace_json:
        if resp.cache_outcome == "hit":
            # a result-cache hit: nothing ran, no spans
            add(f"RESULT_CACHE(hit, rows:{n_rows}, dispatches:0)", root)
        else:
            add("NO_TRACE(execution recorded no spans)", root)
    return _table(rows)


def _walk_filter(node, parent: int, add) -> None:
    if isinstance(node, ir.FAnd):
        oid = add("AND", parent)
        for c in node.children:
            _walk_filter(c, oid, add)
    elif isinstance(node, ir.FOr):
        oid = add("OR", parent)
        for c in node.children:
            _walk_filter(c, oid, add)
    elif isinstance(node, ir.FNot):
        oid = add("NOT", parent)
        _walk_filter(node.child, oid, add)
    elif isinstance(node, ir.Interval):
        add(f"RANGE(slot dict-id/value interval, "
            f"inclusive:[{node.lo_inclusive},{node.hi_inclusive}])", parent)
    elif isinstance(node, ir.Lut):
        add(f"DICT_LUT(ids_slot:{node.ids_slot}, mv:{node.mv})", parent)
    elif isinstance(node, ir.Isin):
        add("RAW_IN", parent)
    elif isinstance(node, ir.Null):
        add(f"IS_NULL(slot:{node.null_slot})", parent)
    elif isinstance(node, ir.MaskParam):
        add("HOST_INDEX_MASK(text/json/vector posting list)", parent)
    elif isinstance(node, ir.FConst):
        add(f"CONST({node.value})", parent)
    else:
        add(type(node).__name__.upper(), parent)


def _table(rows) -> ResultTable:
    return ResultTable(
        DataSchema(["Operator", "Operator_Id", "Parent_Id"],
                   ["STRING", "INT", "INT"]), rows)
