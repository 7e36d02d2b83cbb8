"""Multi-stage query engine (MSE) of the port.

The port of pinot_tpu/mse/, in-process and across a cluster: the relational
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

Across a cluster (distributed.py), the broker's dispatcher sends each
stage as JSON (plan_serde.py) to stage workers on the servers, which run
it on their device and exchange blocks over TCP.
"""

from .executor import MultistageExecutor
from .parser import parse_relational

__all__ = ["MultistageExecutor", "parse_relational"]
