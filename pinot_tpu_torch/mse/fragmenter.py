"""Plan fragmenter: logical plan with exchanges → stage DAG.

The port's copy of pinot_tpu/mse/fragmenter.py. Reference analogue:
PlanFragmenter + MailboxAssignmentVisitor
(pinot-query-planner/.../planner/PlanFragmenter.java, physical/
MailboxAssignmentVisitor.java). Every ExchangeNode becomes a stage
boundary: the subtree below it runs as its own stage whose output is sent
through the mailbox service with the exchange's distribution; the parent
stage reads it through a MailboxReceiveNode leaf. Stage 0 is the broker
rendezvous (reference: the final MailboxReceive at the broker in
QueryDispatcher.submitAndReduce).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from .logical import ExchangeNode, PlanNode, TableScanNode


@dataclass
class MailboxReceiveNode(PlanNode):
    from_stage: int = -1
    dist: str = "singleton"
    keys: list[str] = field(default_factory=list)
    pfunc: Optional[str] = None       # partitioned dist only
    n_partitions: Optional[int] = None

    def describe(self) -> str:
        return f"MailboxReceive(fromStage={self.from_stage}, dist={self.dist}, keys={self.keys})"


@dataclass
class Stage:
    stage_id: int
    root: PlanNode  # subtree with MailboxReceiveNode leaves
    send_dist: str  # distribution of this stage's output
    send_keys: list[str]
    parent_stage: Optional[int]  # None for stage 0
    # stages whose output this stage consumes, in receive order
    child_stages: list[int] = field(default_factory=list)
    # partitioned send only; the fan-out COUNT comes from the receive side
    # (MailboxReceiveNode.n_partitions → parent worker count)
    send_pfunc: Optional[str] = None
    # the exchange's (pruned) schema: the stage's output block is trimmed
    # to exactly these columns before it enters the mailbox. None (old
    # serialized plans) means "ship whatever the root produced".
    send_schema: Optional[list[str]] = None

    @property
    def is_leaf(self) -> bool:
        return not self.child_stages

    def scans(self) -> list[TableScanNode]:
        out: list[TableScanNode] = []

        def walk(n: PlanNode):
            if isinstance(n, TableScanNode):
                out.append(n)
            for i in n.inputs:
                walk(i)

        walk(self.root)
        return out


def receive_nodes(node: PlanNode) -> list[MailboxReceiveNode]:
    """All MailboxReceiveNode leaves under a stage root (shared by the
    runtime's worker-count topology and the dispatcher's placement)."""
    out: list[MailboxReceiveNode] = []
    if isinstance(node, MailboxReceiveNode):
        out.append(node)
    for i in node.inputs:
        out.extend(receive_nodes(i))
    return out


def fragment(root: ExchangeNode) -> list[Stage]:
    """Split at exchanges. Returns stages indexed by stage_id; stage 0 is
    the broker stage (a bare receive of the root exchange)."""
    if not isinstance(root, ExchangeNode):
        raise TypeError("plan root must be an ExchangeNode")
    stages: list[Stage] = []

    broker = Stage(0, None, send_dist="", send_keys=[], parent_stage=None)
    stages.append(broker)

    def make_stage(exchange: ExchangeNode, parent_id: int) -> int:
        sid = len(stages)
        stage = Stage(sid, None, send_dist=exchange.dist,
                      send_keys=list(exchange.keys), parent_stage=parent_id,
                      send_pfunc=exchange.pfunc,
                      send_schema=list(exchange.schema))
        stages.append(stage)
        stage.root = rewrite(exchange.inputs[0], sid)
        return sid

    def rewrite(node: PlanNode, owner_stage: int) -> PlanNode:
        if isinstance(node, ExchangeNode):
            child_id = make_stage(node, owner_stage)
            stages[owner_stage].child_stages.append(child_id)
            return MailboxReceiveNode([], list(node.schema), from_stage=child_id,
                                      dist=node.dist, keys=list(node.keys),
                                      pfunc=node.pfunc,
                                      n_partitions=node.n_partitions)
        node.inputs = [rewrite(i, owner_stage) for i in node.inputs]
        return node

    root_child = make_stage(root, 0)
    broker.child_stages.append(root_child)
    broker.root = MailboxReceiveNode([], list(root.schema), from_stage=root_child,
                                     dist=root.dist, keys=list(root.keys))
    return stages


def explain_stages(stages: list[Stage],
                   stage_stats: Optional[dict] = None) -> str:
    lines = []
    for s in stages:
        head = f"[Stage {s.stage_id}]"
        if s.parent_stage is not None:
            head += f" → stage {s.parent_stage} ({s.send_dist}" + (
                f" on {s.send_keys})" if s.send_keys else ")")
        lines.append(head)
        st = (stage_stats or {}).get(s.stage_id)
        if st is not None:
            line = ("  [impl] workers={workers} leaf_pushdown={leaf_pushdown} "
                    "rows_in={rows_in} rows_out={rows_out} "
                    "shuffled_rows={shuffled_rows} "
                    "shuffled_bytes={shuffled_bytes} "
                    "wall_ms={wall_ms:.1f}".format(**st))
            if st.get("join_impl"):
                line += (" join={join_impl} "
                         "cross_stage_bytes={cross_stage_bytes} "
                         "device_partition_ms={device_partition_ms:.1f}"
                         .format(**st))
                if st.get("host_crossings"):
                    line += " hostCrossings={host_crossings}".format(**st)
            elif "cross_stage_bytes" in st:
                line += " cross_stage_bytes={cross_stage_bytes}".format(**st)
            lines.append(line)
        lines.extend("  " + ln for ln in s.root.tree_lines())
    return "\n".join(lines)
