"""Multi-stage SQL parser: full relational dialect → ast.RelationalQuery.

Reference analogue: Calcite 1.37 parse+validate as driven by
pinot-query-planner/.../QueryEnvironment.java:179. Extends the single-stage
recursive-descent parser with: FROM-clause joins (INNER/LEFT/RIGHT/FULL/
CROSS + USING), derived tables, WITH CTEs, UNION/INTERSECT/EXCEPT [ALL],
window functions (`agg(...) OVER (PARTITION BY ... ORDER BY ... [frame])`),
and IN/NOT IN (SELECT ...) subqueries (kept as `__insubquery__` marker
functions; the planner rewrites them to SEMI/ANTI joins like Calcite's
SubQueryRemoveRule). The port's copy of pinot_tpu/mse/parser.py, over the
port's own single-stage parser (query/parser/sql.py).
"""

from __future__ import annotations

from typing import Any, Optional

from ..query.expressions import ExpressionContext
from ..query.parser.sql import SqlParseError, Token, _Parser, _literal_value, tokenize
from .ast import (
    JoinRel,
    OrderItem,
    RelationalQuery,
    Relation,
    SelectItem,
    SelectStmt,
    SetOpStmt,
    Stmt,
    SubqueryRef,
    TableRef,
    WindowSpec,
)

_JOIN_TYPES = ("INNER", "LEFT", "RIGHT", "FULL", "CROSS", "SEMI", "ANTI")


class _RelationalParser(_Parser):
    def __init__(self, tokens: list[Token]):
        super().__init__(tokens)
        self.ctes: dict[str, Stmt] = {}

    # keep full dotted qualifiers (t.col) for join disambiguation
    def _make_identifier(self, parts: list[str]) -> str:
        return ".".join(parts)

    # -- entry -------------------------------------------------------------
    def parse_relational_query(self) -> RelationalQuery:
        options: dict[str, Any] = {}
        while self.at_kw("SET"):
            self.next()
            key = self.next().value
            self.expect_op("=")
            options[key] = _literal_value(self.next())
            self.accept_op(";")
        explain: Any = False
        if self.accept_kw("EXPLAIN"):
            # EXPLAIN IMPLEMENTATION [PLAN] [FOR]: execute the query and
            # annotate each stage with its runtime stats (rows in/out,
            # shuffled bytes, wall time)
            if self.accept_kw("IMPLEMENTATION"):
                explain = "implementation"
            elif self.accept_kw("ANALYZE"):
                # EXPLAIN ANALYZE: run with tracing armed and annotate each
                # stage with observed rows, shuffle volume, and phase ms
                explain = "analyze"
            else:
                explain = True
            self.accept_kw("PLAN")
            self.accept_kw("FOR")
        stmt = self._parse_statement()
        self.accept_op(";")
        if self.peek().kind != "eof":
            raise SqlParseError(f"trailing input at {self.peek().value!r}")
        return RelationalQuery(stmt, options, explain)

    def _parse_statement(self) -> Stmt:
        if self.accept_kw("WITH"):
            while True:
                name = self.next().value
                self.expect_kw("AS")
                self.expect_op("(")
                self.ctes[name.lower()] = self._parse_statement()
                self.expect_op(")")
                if not self.accept_op(","):
                    break
        return self._parse_set_expr()

    # -- set operations (left-associative; INTERSECT binds tighter) --------
    def _parse_set_expr(self) -> Stmt:
        left = self._parse_intersect_expr()
        while self.at_kw("UNION", "EXCEPT"):
            kind = self.next().upper
            all_ = self.accept_kw("ALL")
            if not all_:
                self.accept_kw("DISTINCT")
            right = self._parse_intersect_expr()
            left = SetOpStmt(kind, all_, left, right)
        self._parse_trailing_order_limit(left)
        return left

    def _parse_intersect_expr(self) -> Stmt:
        left = self._parse_query_primary()
        while self.at_kw("INTERSECT"):
            self.next()
            all_ = self.accept_kw("ALL")
            if not all_:
                self.accept_kw("DISTINCT")
            right = self._parse_query_primary()
            left = SetOpStmt("INTERSECT", all_, left, right)
        return left

    def _parse_query_primary(self) -> Stmt:
        if self.accept_op("("):
            s = self._parse_statement()
            self.expect_op(")")
            return s
        return self._parse_select_stmt()

    def _parse_trailing_order_limit(self, stmt: Stmt) -> None:
        """ORDER BY / LIMIT after a set-op chain attach to the whole set op."""
        if not isinstance(stmt, SetOpStmt):
            return
        if self.accept_kw("ORDER"):
            self.expect_kw("BY")
            stmt.order_by = self._parse_order_items()
        if self.accept_kw("LIMIT"):
            first = self._expect_int()
            if self.accept_op(","):
                stmt.offset = first
                stmt.limit = self._expect_int()
            else:
                stmt.limit = first
                if self.accept_kw("OFFSET"):
                    stmt.offset = self._expect_int()

    # -- SELECT core -------------------------------------------------------
    def _parse_select_stmt(self) -> SelectStmt:
        self.expect_kw("SELECT")
        distinct = self.accept_kw("DISTINCT")
        items: list[SelectItem] = []
        while True:
            if self.peek().kind == "op" and self.peek().value == "*":
                self.next()
                items.append(SelectItem(ExpressionContext.for_identifier("*")))
            elif (self.peek().kind == "ident" and self.peek(1).kind == "op"
                  and self.peek(1).value == "." and self.peek(2).kind == "op"
                  and self.peek(2).value == "*"):
                alias = self.next().value
                self.next()
                self.next()
                items.append(SelectItem(ExpressionContext.for_identifier(alias + ".*")))
            else:
                e = self.parse_expression()
                win = self._maybe_window()
                items.append(SelectItem(e, self._maybe_alias(), win))
            if not self.accept_op(","):
                break
        self.expect_kw("FROM")
        from_rel = self._parse_from()
        stmt = SelectStmt(select_items=items, from_rel=from_rel, distinct=distinct)
        if self.accept_kw("WHERE"):
            stmt.where = self.parse_expression()
        if self.accept_kw("GROUP"):
            self.expect_kw("BY")
            stmt.group_by.append(self.parse_expression())
            while self.accept_op(","):
                stmt.group_by.append(self.parse_expression())
        if self.accept_kw("HAVING"):
            stmt.having = self.parse_expression()
        if self.accept_kw("ORDER"):
            self.expect_kw("BY")
            stmt.order_by = self._parse_order_items()
        if self.accept_kw("LIMIT"):
            first = self._expect_int()
            if self.accept_op(","):
                stmt.offset = first
                stmt.limit = self._expect_int()
            else:
                stmt.limit = first
                if self.accept_kw("OFFSET"):
                    stmt.offset = self._expect_int()
        return stmt

    def _parse_order_items(self) -> list[OrderItem]:
        out: list[OrderItem] = []
        while True:
            e = self.parse_expression()
            asc = True
            if self.accept_kw("DESC"):
                asc = False
            else:
                self.accept_kw("ASC")
            nulls_last = None
            if self.accept_kw("NULLS"):
                if self.accept_kw("LAST"):
                    nulls_last = True
                else:
                    self.expect_kw("FIRST")
                    nulls_last = False
            out.append(OrderItem(e, asc, nulls_last))
            if not self.accept_op(","):
                break
        return out

    # -- FROM clause -------------------------------------------------------
    def _parse_from(self) -> Relation:
        rel = self._parse_table_primary()
        while True:
            join_type = None
            if self.at_kw(*_JOIN_TYPES):
                join_type = self.next().upper
                self.accept_kw("OUTER")
                self.expect_kw("JOIN")
            elif self.at_kw("JOIN"):
                self.next()
                join_type = "INNER"
            elif self.accept_op(","):  # comma join = cross join + WHERE
                join_type = "CROSS"
            else:
                return rel
            right = self._parse_table_primary()
            condition = None
            if self.accept_kw("ON"):
                condition = self.parse_expression()
            elif self.accept_kw("USING"):
                self.expect_op("(")
                cols = [self.next().value]
                while self.accept_op(","):
                    cols.append(self.next().value)
                self.expect_op(")")
                condition = None
                for c in cols:
                    eq = ExpressionContext.for_function(
                        "equals",
                        ExpressionContext.for_identifier(_rel_alias(rel) + "." + c
                                                         if _rel_alias(rel) else c),
                        ExpressionContext.for_identifier(_rel_alias(right) + "." + c
                                                         if _rel_alias(right) else c),
                    )
                    condition = eq if condition is None else \
                        ExpressionContext.for_function("and", condition, eq)
            elif join_type != "CROSS":
                raise SqlParseError(f"{join_type} JOIN requires ON or USING")
            rel = JoinRel(rel, right, join_type, condition)

    def _parse_table_primary(self) -> Relation:
        if self.accept_op("("):
            sub = self._parse_statement()
            self.expect_op(")")
            if self.accept_kw("AS"):
                t = self.next()
                if t.kind != "ident":
                    raise SqlParseError(
                        f"derived table needs an alias, got {t.value!r}")
                return SubqueryRef(sub, t.value)
            if self.peek().kind == "ident" \
                    and self.peek().upper not in _STOP_ALIAS:
                return SubqueryRef(sub, self.next().value)
            # anonymous derived table: synthesize an alias (Calcite allows
            # unaliased subqueries in FROM; columns resolve unqualified)
            self._anon_subq = getattr(self, "_anon_subq", 0) + 1
            return SubqueryRef(sub, f"$sq{self._anon_subq}")
        t = self.next()
        if t.kind != "ident":
            raise SqlParseError(f"expected table name, got {t.value!r}")
        parts = [t.value]
        while self.accept_op("."):
            parts.append(self.next().value)
        name = ".".join(parts)
        alias = None
        if self.accept_kw("AS"):
            alias = self.next().value
        elif self.peek().kind == "ident" and self.peek().upper not in _STOP_ALIAS:
            alias = self.next().value
        if name.lower() in self.ctes:
            return SubqueryRef(self.ctes[name.lower()], alias or name)
        return TableRef(name, alias)

    # -- window functions --------------------------------------------------
    def _maybe_window(self) -> Optional[WindowSpec]:
        if not self.accept_kw("OVER"):
            return None
        self.expect_op("(")
        spec = WindowSpec()
        if self.accept_kw("PARTITION"):
            self.expect_kw("BY")
            spec.partition_by.append(self.parse_expression())
            while self.accept_op(","):
                spec.partition_by.append(self.parse_expression())
        if self.accept_kw("ORDER"):
            self.expect_kw("BY")
            while True:
                e = self.parse_expression()
                asc = True
                if self.accept_kw("DESC"):
                    asc = False
                else:
                    self.accept_kw("ASC")
                spec.order_by.append((e, asc))
                if not self.accept_op(","):
                    break
        if self.at_kw("ROWS", "RANGE"):
            kind = self.next().upper
            if self.accept_kw("BETWEEN"):
                start = self._parse_frame_bound()
                self.expect_kw("AND")
                end = self._parse_frame_bound()
            else:
                start = self._parse_frame_bound()
                end = 0  # CURRENT ROW
            spec.frame = (kind, start, end)
        self.expect_op(")")
        return spec

    def _parse_frame_bound(self) -> Optional[int]:
        """None = UNBOUNDED; int = signed row offset (0 = CURRENT ROW)."""
        if self.accept_kw("UNBOUNDED"):
            if self.accept_kw("PRECEDING") or self.accept_kw("FOLLOWING"):
                return None
            raise SqlParseError("expected PRECEDING/FOLLOWING after UNBOUNDED")
        if self.accept_kw("CURRENT"):
            self.expect_kw("ROW")
            return 0
        n = self._expect_int()
        if self.accept_kw("PRECEDING"):
            return -n
        self.expect_kw("FOLLOWING")
        return n

    # -- IN (SELECT ...) subqueries ----------------------------------------
    def _parse_comparison(self) -> ExpressionContext:
        # intercept `x [NOT] IN (SELECT ...)` before the base literal-IN path
        save = self.i
        left = self._parse_additive()
        negated = False
        if self.at_kw("NOT") and self.peek(1).upper == "IN":
            if self._in_select_ahead(2):
                self.next()
                negated = True
        if self.at_kw("IN") and (negated or self._in_select_ahead(1)):
            self.next()
            self.expect_op("(")
            sub = self._parse_statement()
            self.expect_op(")")
            name = "__notinsubquery__" if negated else "__insubquery__"
            return ExpressionContext.for_function(
                name, left, ExpressionContext.for_literal(sub))
        self.i = save
        return super()._parse_comparison()

    def _in_select_ahead(self, ahead: int) -> bool:
        t = self.peek(ahead)
        return (t.kind == "op" and t.value == "("
                and self.peek(ahead + 1).upper in ("SELECT", "WITH"))


_STOP_ALIAS = frozenset({
    "WHERE", "GROUP", "HAVING", "ORDER", "LIMIT", "OFFSET", "ON", "USING",
    "JOIN", "INNER", "LEFT", "RIGHT", "FULL", "OUTER", "CROSS", "SEMI", "ANTI",
    "UNION", "INTERSECT", "EXCEPT", "SET",
})


def _rel_alias(rel: Relation) -> Optional[str]:
    if isinstance(rel, TableRef):
        return rel.alias or rel.name
    if isinstance(rel, SubqueryRef):
        return rel.alias
    return None


def parse_relational(sql: str) -> RelationalQuery:
    """Parse the full multi-stage dialect."""
    return _RelationalParser(tokenize(sql)).parse_relational_query()
