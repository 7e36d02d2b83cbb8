"""Relational AST for the multi-stage SQL dialect.

Reference analogue: Calcite's SqlNode tree as consumed by
pinot-query-planner/.../QueryEnvironment.java:179 (parse → validate). The
single-stage dialect (query/parser/sql.py) covers one-table queries; this
AST adds FROM-clause joins, derived tables, set operations, CTEs and window
functions — the constructs that force multi-stage execution. The port's
copy of pinot_tpu/mse/ast.py.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Union

from ..query.expressions import ExpressionContext


# -- FROM-clause relations ---------------------------------------------------


@dataclass
class TableRef:
    name: str
    alias: Optional[str] = None


@dataclass
class SubqueryRef:
    query: "Stmt"
    alias: str


@dataclass
class JoinRel:
    """join_type: INNER | LEFT | RIGHT | FULL | CROSS | SEMI | ANTI
    (SEMI/ANTI are produced by IN / NOT IN subquery rewrites, mirroring the
    reference's Calcite SubQueryRemoveRule)."""

    left: "Relation"
    right: "Relation"
    join_type: str
    condition: Optional[ExpressionContext] = None


Relation = Union[TableRef, SubqueryRef, JoinRel]


# -- window functions --------------------------------------------------------


@dataclass
class WindowSpec:
    """OVER (PARTITION BY ... ORDER BY ...). Frames default to the reference's
    semantics: RANGE UNBOUNDED PRECEDING..CURRENT ROW with ORDER BY, the whole
    partition without (pinot-query-runtime/.../operator/window/)."""

    partition_by: list[ExpressionContext] = field(default_factory=list)
    order_by: list[tuple[ExpressionContext, bool]] = field(default_factory=list)  # (expr, asc)
    # frame: (kind, start, end); start/end None = UNBOUNDED, int = offset rows
    frame: Optional[tuple[str, Optional[int], Optional[int]]] = None


@dataclass
class SelectItem:
    expression: ExpressionContext
    alias: Optional[str] = None
    window: Optional[WindowSpec] = None  # set when expression is `agg(...) OVER (...)`


# -- statements --------------------------------------------------------------


@dataclass
class OrderItem:
    expression: ExpressionContext
    ascending: bool = True
    nulls_last: Optional[bool] = None


@dataclass
class SelectStmt:
    select_items: list[SelectItem]
    from_rel: Relation
    distinct: bool = False
    where: Optional[ExpressionContext] = None
    group_by: list[ExpressionContext] = field(default_factory=list)
    having: Optional[ExpressionContext] = None
    order_by: list[OrderItem] = field(default_factory=list)
    limit: Optional[int] = None
    offset: int = 0


@dataclass
class SetOpStmt:
    kind: str  # UNION | INTERSECT | EXCEPT
    all: bool
    left: "Stmt"
    right: "Stmt"
    order_by: list[OrderItem] = field(default_factory=list)
    limit: Optional[int] = None
    offset: int = 0


Stmt = Union[SelectStmt, SetOpStmt]


@dataclass
class RelationalQuery:
    statement: Stmt
    options: dict = field(default_factory=dict)
    explain: bool = False
