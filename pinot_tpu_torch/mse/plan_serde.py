"""Plan fragment serde: stage DAG ↔ JSON-compatible dicts.

The port's copy of pinot_tpu/mse/plan_serde.py, whole: the JSON is the
JAX package's key for key, so a plan either package serializes reads the
same. Reference analogue: the reference ships serialized plan fragments to
workers over gRPC (pinot-common/src/main/proto/plan.proto, consumed by
QueryDispatcher.java:126 submit → PlanNode protobuf tree). Here the wire
form is plain JSON-compatible dicts: every PlanNode subclass gets a type
tag plus its fields, expressions serialize recursively. The contract is
explicit and versioned so a worker process can reconstruct and execute a
stage without sharing Python object identity with the dispatcher.
"""

from __future__ import annotations

from typing import Any, Optional

from ..query.expressions import ExpressionContext, ExpressionType, FunctionContext
from .ast import OrderItem, WindowSpec
from .fragmenter import MailboxReceiveNode, Stage
from .logical import (
    AggCall,
    AggregateNode,
    ExchangeNode,
    FilterNode,
    JoinNode,
    PlanNode,
    ProjectNode,
    SetOpNode,
    SortNode,
    TableScanNode,
    WindowCall,
    WindowNode,
)

SERDE_VERSION = 1

EC = ExpressionContext


# -- expressions --------------------------------------------------------------


def expr_to_json(e: Optional[EC]) -> Any:
    if e is None:
        return None
    if e.is_identifier:
        return {"t": "id", "v": e.identifier}
    if e.is_literal:
        v = e.literal
        if isinstance(v, bool) or v is None or isinstance(v, (int, float, str)):
            return {"t": "lit", "v": v}
        return {"t": "lit", "v": str(v)}
    return {"t": "fn", "n": e.function.name,
            "a": [expr_to_json(a) for a in e.function.arguments]}


def expr_from_json(d: Any) -> Optional[EC]:
    if d is None:
        return None
    t = d["t"]
    if t == "id":
        return EC.for_identifier(d["v"])
    if t == "lit":
        return EC.for_literal(d["v"])
    if t == "fn":
        return EC(ExpressionType.FUNCTION,
                  function=FunctionContext(d["n"],
                                           tuple(expr_from_json(a) for a in d["a"])))
    raise ValueError(f"bad expression tag {t!r}")


def _order_to_json(it: OrderItem) -> dict:
    return {"e": expr_to_json(it.expression), "asc": it.ascending,
            "nl": it.nulls_last}


def _order_from_json(d: dict) -> OrderItem:
    return OrderItem(expr_from_json(d["e"]), d["asc"], d.get("nl"))


def _wspec_to_json(s: Optional[WindowSpec]) -> Any:
    if s is None:
        return None
    return {"p": [expr_to_json(e) for e in s.partition_by],
            "o": [[expr_to_json(e), asc] for e, asc in s.order_by],
            "f": list(s.frame) if s.frame else None}


def _wspec_from_json(d: Any) -> Optional[WindowSpec]:
    if d is None:
        return None
    return WindowSpec(
        partition_by=[expr_from_json(e) for e in d["p"]],
        order_by=[(expr_from_json(e), asc) for e, asc in d["o"]],
        frame=tuple(d["f"]) if d.get("f") else None)


# -- plan nodes ---------------------------------------------------------------


def node_to_json(node: PlanNode) -> dict:
    d: dict = {"node": type(node).__name__, "schema": list(node.schema),
               "inputs": [node_to_json(i) for i in node.inputs]}
    if isinstance(node, TableScanNode):
        d.update(table=node.table, alias=node.alias,
                 source_columns=list(node.source_columns))
    elif isinstance(node, FilterNode):
        d.update(condition=expr_to_json(node.condition))
    elif isinstance(node, ProjectNode):
        d.update(exprs=[expr_to_json(e) for e in node.exprs])
    elif isinstance(node, AggregateNode):
        d.update(group_exprs=[expr_to_json(e) for e in node.group_exprs],
                 agg_calls=[{"n": c.name, "a": [expr_to_json(a) for a in c.args],
                             "o": c.out_name, "x": list(c.extra),
                             "f": expr_to_json(c.condition)
                             if c.condition is not None else None}
                            for c in node.agg_calls])
    elif isinstance(node, JoinNode):
        d.update(join_type=node.join_type, left_keys=list(node.left_keys),
                 right_keys=list(node.right_keys),
                 residual=expr_to_json(node.residual))
    elif isinstance(node, WindowNode):
        d.update(calls=[{"n": c.name, "a": [expr_to_json(a) for a in c.args],
                         "s": _wspec_to_json(c.spec), "o": c.out_name}
                        for c in node.calls],
                 partition_keys=[expr_to_json(e) for e in node.partition_keys])
    elif isinstance(node, SortNode):
        d.update(sort_items=[_order_to_json(it) for it in node.sort_items],
                 limit=node.limit, offset=node.offset)
    elif isinstance(node, SetOpNode):
        d.update(kind=node.kind, all=node.all)
    elif isinstance(node, ExchangeNode):
        d.update(dist=node.dist, keys=list(node.keys), pfunc=node.pfunc,
                 n_partitions=node.n_partitions)
    elif isinstance(node, MailboxReceiveNode):
        d.update(from_stage=node.from_stage, dist=node.dist, keys=list(node.keys),
                 pfunc=node.pfunc, n_partitions=node.n_partitions)
    else:
        raise TypeError(f"unserializable plan node {type(node).__name__}")
    return d


def node_from_json(d: dict) -> PlanNode:
    kind = d["node"]
    inputs = [node_from_json(i) for i in d["inputs"]]
    schema = list(d["schema"])
    if kind == "TableScanNode":
        return TableScanNode(inputs, schema, table=d["table"], alias=d["alias"],
                             source_columns=list(d["source_columns"]))
    if kind == "FilterNode":
        return FilterNode(inputs, schema, condition=expr_from_json(d["condition"]))
    if kind == "ProjectNode":
        return ProjectNode(inputs, schema,
                           exprs=[expr_from_json(e) for e in d["exprs"]])
    if kind == "AggregateNode":
        return AggregateNode(
            inputs, schema,
            group_exprs=[expr_from_json(e) for e in d["group_exprs"]],
            agg_calls=[AggCall(c["n"], [expr_from_json(a) for a in c["a"]],
                               c["o"], tuple(c["x"]),
                               condition=expr_from_json(c["f"])
                               if c.get("f") is not None else None)
                       for c in d["agg_calls"]])
    if kind == "JoinNode":
        return JoinNode(inputs, schema, join_type=d["join_type"],
                        left_keys=list(d["left_keys"]),
                        right_keys=list(d["right_keys"]),
                        residual=expr_from_json(d["residual"]))
    if kind == "WindowNode":
        return WindowNode(
            inputs, schema,
            calls=[WindowCall(c["n"], [expr_from_json(a) for a in c["a"]],
                              _wspec_from_json(c["s"]), c["o"])
                   for c in d["calls"]],
            partition_keys=[expr_from_json(e) for e in d["partition_keys"]])
    if kind == "SortNode":
        return SortNode(inputs, schema,
                        sort_items=[_order_from_json(it) for it in d["sort_items"]],
                        limit=d["limit"], offset=d["offset"])
    if kind == "SetOpNode":
        return SetOpNode(inputs, schema, kind=d["kind"], all=d["all"])
    if kind == "ExchangeNode":
        return ExchangeNode(inputs, schema, dist=d["dist"], keys=list(d["keys"]),
                            pfunc=d.get("pfunc"),
                            n_partitions=d.get("n_partitions"))
    if kind == "MailboxReceiveNode":
        return MailboxReceiveNode(inputs, schema, from_stage=d["from_stage"],
                                  dist=d["dist"], keys=list(d["keys"]),
                                  pfunc=d.get("pfunc"),
                                  n_partitions=d.get("n_partitions"))
    raise ValueError(f"unknown plan node tag {kind!r}")


# -- stages -------------------------------------------------------------------


def stage_to_json(stage: Stage) -> dict:
    return {"v": SERDE_VERSION, "stage_id": stage.stage_id,
            "root": node_to_json(stage.root), "send_dist": stage.send_dist,
            "send_keys": list(stage.send_keys),
            "parent_stage": stage.parent_stage,
            "child_stages": list(stage.child_stages),
            "send_pfunc": stage.send_pfunc,
            "send_schema": stage.send_schema}


def stage_from_json(d: dict) -> Stage:
    if d.get("v") != SERDE_VERSION:
        raise ValueError(f"unsupported plan serde version {d.get('v')}")
    return Stage(d["stage_id"], node_from_json(d["root"]), d["send_dist"],
                 list(d["send_keys"]), d["parent_stage"],
                 list(d["child_stages"]),
                 send_pfunc=d.get("send_pfunc"),
                 send_schema=d.get("send_schema"))
