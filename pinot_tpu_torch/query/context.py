"""Compiled query representation.

Reference: pinot-core/.../query/request/context/QueryContext.java — the single
compiled form the whole V1 engine consumes: select expressions, filter tree,
aggregations, group-by expressions, HAVING, ORDER BY, limit/offset, options.
The TPU engine additionally derives a *kernel signature* from it (see
engine/plan.py) so structurally identical queries share one compiled XLA
program regardless of literal values.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

from .expressions import ExpressionContext, extract_aggregations
from .filter import FilterContext


@dataclass
class OrderByExpressionContext:
    expression: ExpressionContext
    ascending: bool = True
    nulls_last: Optional[bool] = None  # None = default per direction

    def __str__(self) -> str:
        return f"{self.expression} {'ASC' if self.ascending else 'DESC'}"


@dataclass
class QueryContext:
    table_name: str
    select_expressions: list[ExpressionContext] = field(default_factory=list)
    aliases: list[Optional[str]] = field(default_factory=list)  # parallel to select
    distinct: bool = False
    filter: Optional[FilterContext] = None
    group_by_expressions: list[ExpressionContext] = field(default_factory=list)
    having_filter: Optional[FilterContext] = None
    order_by_expressions: list[OrderByExpressionContext] = field(default_factory=list)
    limit: int = 10  # reference default LIMIT 10 (CalciteSqlParser DEFAULT_LIMIT)
    offset: int = 0
    query_options: dict[str, Any] = field(default_factory=dict)
    explain: bool = False

    # Derived (filled by finish()):
    aggregations: list[ExpressionContext] = field(default_factory=list)

    def finish(self) -> "QueryContext":
        """Derive aggregation list from select/having/order-by expressions
        (reference QueryContext.Builder.build → generateAggregationFunctions).
        GROUP BY identifiers naming a SELECT alias resolve to the aliased
        expression first (reference: Calcite's groupByAliasEnabled
        behavior — GROUP BY dateTrunc('DAY', ts) AS d ... GROUP BY d)."""
        alias_map = {a: e for e, a in zip(self.select_expressions,
                                          self.aliases) if a}
        if alias_map and self.group_by_expressions:
            self.group_by_expressions = [
                alias_map.get(g.identifier, g) if g.is_identifier else g
                for g in self.group_by_expressions]
        aggs: list[ExpressionContext] = []
        for e in self.select_expressions:
            extract_aggregations(e, aggs)
        if self.having_filter is not None:
            _extract_from_filter(self.having_filter, aggs)
        for o in self.order_by_expressions:
            extract_aggregations(o.expression, aggs)
        self.aggregations = aggs
        return self

    @property
    def is_aggregation_query(self) -> bool:
        return bool(self.aggregations)

    @property
    def is_group_by(self) -> bool:
        return bool(self.group_by_expressions)

    @property
    def is_selection(self) -> bool:
        return not self.aggregations and not self.distinct

    @property
    def null_handling(self) -> bool:
        """Advanced null handling (reference
        QueryContext.isNullHandlingEnabled; SET enableNullHandling = true):
        predicates over null inputs are false (3-valued logic) and
        aggregations skip null operand values. Basic mode (default)
        treats stored default values as values. Group-by KEYS stay in
        basic mode either way (null keys group under the default value),
        and SUM/MIN/MAX over a group whose operand is entirely null
        return the op identity rather than SQL NULL (AVG returns NULL)."""
        opt = self.query_options.get("enableNullHandling")
        return opt is True or str(opt).lower() == "true"

    def __str__(self) -> str:
        parts = [f"SELECT {', '.join(map(str, self.select_expressions))}", f"FROM {self.table_name}"]
        if self.filter:
            parts.append(f"WHERE {self.filter}")
        if self.group_by_expressions:
            parts.append(f"GROUP BY {', '.join(map(str, self.group_by_expressions))}")
        if self.having_filter:
            parts.append(f"HAVING {self.having_filter}")
        if self.order_by_expressions:
            parts.append(f"ORDER BY {', '.join(map(str, self.order_by_expressions))}")
        parts.append(f"LIMIT {self.limit}")
        return " ".join(parts)


def _extract_from_filter(f: FilterContext, out: list) -> None:
    if f.predicate is not None:
        extract_aggregations(f.predicate.lhs, out)
    for c in f.children:
        _extract_from_filter(c, out)
