"""Multi-stage query engine (MSE) of the port.

The port of pinot_tpu/mse/ for in-process execution: the relational
parser, the logical planner with its partial/final aggregate split, the
filter pushdown, the fragmenter, the host operators (join, window, set
operations, sort) and the stage runtime with its in-memory mailboxes.
Leaf stages run through the port's single-stage engine
(engine/query_executor.py), so a leaf aggregate launches kernel A or B and
a scan leaf runs the selection bitmap. The join pipeline's device stages
(ops/join_pipeline.py, mse/device_join.py) are torch ops on the
executor's device. Reference analogue: the V2 engine — Calcite front-end
+ logical planner (pinot-query-planner/, QueryEnvironment.planQuery:179),
fragmenter (PlanFragmenter), and the worker runtime with mailbox shuffle
(pinot-query-runtime/, QueryRunner.processQuery:210, MailboxService:40).

Not ported: the cluster MSE (pinot_tpu/mse/distributed.py,
plan_serde.py), the MSE result cache and EXPLAIN ANALYZE.
"""

from .executor import MultistageExecutor
from .parser import parse_relational

__all__ = ["MultistageExecutor", "parse_relational"]
