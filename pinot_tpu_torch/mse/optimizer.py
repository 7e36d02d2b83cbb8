"""Rule-based logical-plan optimizer for the multi-stage engine.

The port's copy of pinot_tpu/mse/optimizer.py. Reference analogue: the
Calcite rule stack Pinot applies before converting
RelNodes to PlanNodes (pinot-query-planner/.../planner/logical/ and Calcite's
FilterJoinRule / FilterProjectTransposeRule / FilterAggregateTransposeRule /
FilterSetOpTransposeRule). The single rule that matters most for a
distributed columnar engine is **filter pushdown**: a predicate that reaches
the TableScan side of an exchange (a) runs on the device engine inside the
leaf SSQE compile (runtime._try_ssqe) instead of row-at-a-time above a
shuffle, and (b) shrinks the shuffle itself.

Rules implemented (all pure tree rewrites over logical.PlanNode):

- Filter ∘ Filter        → merge conjuncts
- Filter ∘ Exchange      → Exchange ∘ Filter          (filters are row-local)
- Filter ∘ Project       → Project ∘ Filter           (substitute expressions)
- Filter ∘ Join          → push side-local conjuncts into the inner-side
                           input(s); outer sides keep their predicates above
                           the join (null-extension would change results)
- Filter ∘ Aggregate     → push conjuncts over group keys below the agg
- Filter ∘ SetOp         → copy the filter into every branch
- Filter ∘ Sort(no lim)  → push below the sort
- Filter ∘ Window        → push conjuncts over plain-identifier partition
                           keys below the window (per-partition predicate)

Conjuncts that no rule accepts stay where they are, so the pass is always
semantics-preserving; it never duplicates non-deterministic work because the
expression language has no non-deterministic functions.
"""

from __future__ import annotations

from typing import Optional

from ..query.expressions import ExpressionContext
from .logical import (
    AggregateNode,
    ExchangeNode,
    FilterNode,
    JoinNode,
    PlanNode,
    ProjectNode,
    SetOpNode,
    SortNode,
    TableScanNode,
    WindowNode,
    _split_and,
)

EC = ExpressionContext


def _and_all(conjs: list[EC]) -> Optional[EC]:
    cond = None
    for c in conjs:
        cond = c if cond is None else EC.for_function("and", cond, c)
    return cond


def _substitute(e: EC, mapping: dict[str, EC]) -> Optional[EC]:
    """Rewrite identifiers through a projection; None if unmappable."""
    if e.is_identifier:
        return mapping.get(e.identifier)
    if e.is_function:
        args = []
        for a in e.function.arguments:
            s = _substitute(a, mapping)
            if s is None:
                return None
            args.append(s)
        return EC.for_function(e.function.name, *args)
    return e  # literal


def _filter_over(node: PlanNode, conjs: list[EC]) -> PlanNode:
    cond = _and_all(conjs)
    if cond is None:
        return node
    return FilterNode([node], list(node.schema), condition=cond)


def push_filters(root: PlanNode) -> PlanNode:
    """Run the pushdown rules to fixpoint (single recursive descent — each
    conjunct only ever moves down, so one pass that re-pushes at every sink
    point is a fixpoint)."""
    return _push(root)


def _push(node: PlanNode) -> PlanNode:
    if isinstance(node, FilterNode) and node.condition is not None:
        child = node.inputs[0]
        # merge stacked filters first so all conjuncts travel together
        conjs = _split_and(node.condition)
        while isinstance(child, FilterNode) and child.condition is not None:
            conjs.extend(_split_and(child.condition))
            child = child.inputs[0]
        new_child, kept = _sink(child, conjs)
        new_child = _push(new_child)
        return _filter_over(new_child, kept)
    node.inputs = [_push(i) for i in node.inputs]
    return node


def _sink(child: PlanNode, conjs: list[EC]) -> tuple[PlanNode, list[EC]]:
    """Try to sink ``conjs`` into ``child``. Returns (rewritten child,
    conjuncts that must remain above it)."""
    if isinstance(child, ExchangeNode):
        # row-local predicates commute with any re-distribution: whatever
        # the inner node rejects still sits below the exchange boundary
        inner, kept = _sink(child.inputs[0], conjs)
        child.inputs = [_filter_over(inner, kept)]
        return child, []

    if isinstance(child, ProjectNode):
        mapping = dict(zip(child.schema, child.exprs))
        moved: list[EC] = []
        kept: list[EC] = []
        for c in conjs:
            s = _substitute(c, mapping)
            (moved.append(s) if s is not None else kept.append(c))
        if moved:
            inner, inner_kept = _sink(child.inputs[0], moved)
            child.inputs = [_filter_over(inner, inner_kept)]
        return child, kept

    if isinstance(child, JoinNode):
        lschema = set(child.inputs[0].schema)
        rschema = set(child.inputs[1].schema)
        jt = child.join_type
        push_left = jt in ("INNER", "LEFT", "CROSS", "SEMI", "ANTI")
        push_right = jt in ("INNER", "RIGHT", "CROSS")
        left_c: list[EC] = []
        right_c: list[EC] = []
        kept = []
        for c in conjs:
            cols = c.columns()
            if cols and cols <= lschema and push_left:
                left_c.append(c)
            elif cols and cols <= rschema and push_right:
                right_c.append(c)
            else:
                kept.append(c)
        if left_c:
            inner, ik = _sink(child.inputs[0], left_c)
            child.inputs[0] = _filter_over(inner, ik)
        if right_c:
            inner, ik = _sink(child.inputs[1], right_c)
            child.inputs[1] = _filter_over(inner, ik)
        return child, kept

    if isinstance(child, AggregateNode):
        group_names = set(child.schema[:len(child.group_exprs)])
        mapping = {n: g for n, g in zip(child.schema, child.group_exprs)}
        moved, kept = [], []
        for c in conjs:
            cols = c.columns()
            # a column-free conjunct (HAVING 1 = 0) must NOT sink: a global
            # aggregate over zero rows still emits one row, so pushing the
            # constant predicate below the agg would change the row count
            if cols and cols <= group_names:
                moved.append(_substitute(c, mapping))
            else:
                kept.append(c)
        if moved:
            inner, ik = _sink(child.inputs[0], moved)
            child.inputs = [_filter_over(inner, ik)]
        return child, kept

    if isinstance(child, SetOpNode):
        # branches were projected to the left schema at planning time, so
        # the predicate applies verbatim on every branch
        new_inputs = []
        for inp in child.inputs:
            inner, ik = _sink(inp, list(conjs))
            new_inputs.append(_filter_over(inner, ik))
        child.inputs = new_inputs
        return child, []

    if isinstance(child, SortNode) and child.limit is None:
        inner, ik = _sink(child.inputs[0], conjs)
        child.inputs = [_filter_over(inner, ik)]
        return child, []

    if isinstance(child, WindowNode):
        # a predicate may only sink below the window if it is constant
        # within EVERY call's partitions — node.partition_keys reflects just
        # calls[0], so intersect the per-call PARTITION BY key sets
        pkeys = None
        for call in child.calls:
            spec = call.spec
            ck = {p.identifier for p in (spec.partition_by if spec else [])
                  if p.is_identifier}
            pkeys = ck if pkeys is None else (pkeys & ck)
        pkeys = pkeys or set()
        moved, kept = [], []
        for c in conjs:
            cols = c.columns()
            (moved.append(c) if cols and cols <= pkeys else kept.append(c))
        if moved:
            inner, ik = _sink(child.inputs[0], moved)
            child.inputs = [_filter_over(inner, ik)]
        return child, kept

    if isinstance(child, (TableScanNode, FilterNode)):
        # scans keep the filter directly above them (the leaf SSQE compile
        # consumes Filter ∘ Scan); stacked filters merge in _push
        return child, conjs

    return child, conjs
