"""SQL parser: text → QueryContext.

Replaces the reference's Calcite front-end for the single-stage engine
(pinot-common/.../sql/parsers/CalciteSqlParser.java:75,
compileToPinotQuery:160). Hand-rolled recursive descent over a small
tokenizer; expressions parse to ExpressionContext trees with boolean
operators as functions (and/or/not/equals/...), then WHERE/HAVING convert to
FilterContext via converter.filter_from_expression — the same two-layer shape
as the reference's PinotQuery → QueryContext pipeline.

Supports: SELECT [DISTINCT] list FROM t [WHERE e] [GROUP BY list] [HAVING e]
[ORDER BY e [ASC|DESC], ...] [LIMIT n [OFFSET m] | LIMIT o, n], SET options,
EXPLAIN PLAN FOR, expressions with arithmetic/comparison/IN/BETWEEN/LIKE/
IS NULL/CASE WHEN/CAST, function calls, quoted identifiers and aliases.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Any, Optional

from ..context import OrderByExpressionContext, QueryContext
from ..converter import FilterConversionError, filter_from_expression
from ..expressions import ExpressionContext

_TOKEN_RE = re.compile(
    r"""
    \s*(?:
      (?P<number>\d+\.\d*(?:[eE][+-]?\d+)?|\.\d+(?:[eE][+-]?\d+)?|\d+(?:[eE][+-]?\d+)?)
    | (?P<string>'(?:[^']|'')*')
    | (?P<qident>"(?:[^"]|"")*")
    | (?P<ident>[A-Za-z_][A-Za-z0-9_$]*)
    | (?P<op><>|!=|>=|<=|=|<|>|\(|\)|\[|\]|,|\+|-|\*|/|%|\.|;)
    )""",
    re.VERBOSE,
)


@dataclass
class Token:
    kind: str  # number|string|ident|qident|op|eof
    value: str
    upper: str = ""


def tokenize(sql: str) -> list[Token]:
    tokens: list[Token] = []
    pos = 0
    n = len(sql)
    while pos < n:
        m = _TOKEN_RE.match(sql, pos)
        if not m or m.end() == pos:
            if sql[pos:].strip() == "":
                break
            raise SqlParseError(f"unexpected character {sql[pos]!r} at position {pos}")
        pos = m.end()
        kind = m.lastgroup
        text = m.group(kind)
        if kind == "string":
            tokens.append(Token("string", text[1:-1].replace("''", "'")))
        elif kind == "qident":
            tokens.append(Token("ident", text[1:-1].replace('""', '"')))
        elif kind == "ident":
            tokens.append(Token("ident", text, text.upper()))
        else:
            tokens.append(Token(kind, text, text.upper()))
    tokens.append(Token("eof", ""))
    return tokens


class SqlParseError(Exception):
    pass


_CANON_RE = re.compile(r"[_\s]")


def canonical_function_name(name: str) -> str:
    """Lower-case, underscore-free (reference FunctionRegistry canonicalization:
    pinot-common/.../function/FunctionRegistry.java:70 canonicalize)."""
    return _CANON_RE.sub("", name.lower())


class _Parser:
    def __init__(self, tokens: list[Token]):
        self.tokens = tokens
        self.i = 0

    # -- token helpers -----------------------------------------------------
    def peek(self, ahead: int = 0) -> Token:
        return self.tokens[min(self.i + ahead, len(self.tokens) - 1)]

    def next(self) -> Token:
        t = self.tokens[self.i]
        if t.kind != "eof":
            self.i += 1
        return t

    def at_kw(self, *kws: str) -> bool:
        t = self.peek()
        return t.kind == "ident" and t.upper in kws

    def accept_kw(self, *kws: str) -> bool:
        if self.at_kw(*kws):
            self.i += 1
            return True
        return False

    def expect_kw(self, kw: str) -> None:
        if not self.accept_kw(kw):
            raise SqlParseError(f"expected {kw}, got {self.peek().value!r}")

    def accept_op(self, op: str) -> bool:
        t = self.peek()
        if t.kind == "op" and t.value == op:
            self.i += 1
            return True
        return False

    def expect_op(self, op: str) -> None:
        if not self.accept_op(op):
            raise SqlParseError(f"expected {op!r}, got {self.peek().value!r}")

    # -- entry -------------------------------------------------------------
    def parse_query(self) -> QueryContext:
        options: dict[str, Any] = {}
        while self.at_kw("SET"):
            self.next()
            key = self.next().value
            self.expect_op("=")
            val_tok = self.next()
            options[key] = _literal_value(val_tok)
            self.accept_op(";")
        explain: Any = False
        if self.accept_kw("EXPLAIN"):
            # EXPLAIN IMPLEMENTATION FOR names the concrete kernel variants
            # (group-by path, device combine) instead of the logical plan —
            # same contract as the MSE parser (mse/parser.py)
            if self.accept_kw("IMPLEMENTATION"):
                explain = "implementation"
            elif self.accept_kw("ANALYZE"):
                # EXPLAIN ANALYZE runs the query for real (tracing armed,
                # caches live) and annotates the plan with observed rows,
                # dispatches, and phase timings
                explain = "analyze"
            else:
                self.accept_kw("PLAN")
                explain = True
            self.accept_kw("FOR")
        qc = self._parse_select()
        qc.query_options.update(options)
        qc.explain = explain
        self.accept_op(";")
        if self.peek().kind != "eof":
            raise SqlParseError(f"trailing input at {self.peek().value!r}")
        return qc.finish()

    def _parse_select(self) -> QueryContext:
        self.expect_kw("SELECT")
        distinct = self.accept_kw("DISTINCT")
        select_exprs: list[ExpressionContext] = []
        aliases: list[Optional[str]] = []
        while True:
            if self.peek().kind == "op" and self.peek().value == "*":
                self.next()
                select_exprs.append(ExpressionContext.for_identifier("*"))
                aliases.append(None)
            else:
                select_exprs.append(self.parse_expression())
                aliases.append(self._maybe_alias())
            if not self.accept_op(","):
                break
        self.expect_kw("FROM")
        table = self._parse_table_name()
        qc = QueryContext(table_name=table, select_expressions=select_exprs,
                          aliases=aliases, distinct=distinct)
        if self.accept_kw("WHERE"):
            qc.filter = self._to_filter(self.parse_expression())
        if self.accept_kw("GROUP"):
            self.expect_kw("BY")
            qc.group_by_expressions.append(self.parse_expression())
            while self.accept_op(","):
                qc.group_by_expressions.append(self.parse_expression())
        if self.accept_kw("HAVING"):
            qc.having_filter = self._to_filter(self.parse_expression())
        if self.accept_kw("ORDER"):
            self.expect_kw("BY")
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
                qc.order_by_expressions.append(OrderByExpressionContext(e, asc, nulls_last))
                if not self.accept_op(","):
                    break
        if self.accept_kw("LIMIT"):
            first = self._expect_int()
            if self.accept_op(","):  # LIMIT offset, count (MySQL style)
                qc.offset = first
                qc.limit = self._expect_int()
            else:
                qc.limit = first
                if self.accept_kw("OFFSET"):
                    qc.offset = self._expect_int()
        return qc

    def _parse_table_name(self) -> str:
        name = self.next()
        if name.kind != "ident":
            raise SqlParseError(f"expected table name, got {name.value!r}")
        parts = [name.value]
        while self.accept_op("."):
            parts.append(self.next().value)
        # swallow optional alias (unused in single-table queries)
        if self.peek().kind == "ident" and not self.at_kw(
            "WHERE", "GROUP", "HAVING", "ORDER", "LIMIT", "OPTION", "AS"
        ):
            self.next()
        elif self.accept_kw("AS"):
            self.next()
        return ".".join(parts)

    def _to_filter(self, expr: ExpressionContext):
        try:
            return filter_from_expression(expr)
        except FilterConversionError as e:
            raise SqlParseError(str(e)) from e

    def _maybe_alias(self) -> Optional[str]:
        if self.accept_kw("AS"):
            t = self.next()
            if t.kind not in ("ident", "string"):
                raise SqlParseError(f"expected alias, got {t.value!r}")
            return t.value
        t = self.peek()
        if t.kind == "ident" and t.upper not in _RESERVED:
            self.next()
            return t.value
        return None

    def _expect_int(self) -> int:
        t = self.next()
        if t.kind != "number":
            raise SqlParseError(f"expected integer, got {t.value!r}")
        try:
            return int(t.value)
        except ValueError:
            raise SqlParseError(f"expected integer, got {t.value!r}") from None

    # -- expressions (precedence climbing) ---------------------------------
    def parse_expression(self) -> ExpressionContext:
        return self._parse_or()

    def _parse_or(self) -> ExpressionContext:
        left = self._parse_and()
        while self.accept_kw("OR"):
            right = self._parse_and()
            left = ExpressionContext.for_function("or", left, right)
        return left

    def _parse_and(self) -> ExpressionContext:
        left = self._parse_not()
        while self.accept_kw("AND"):
            right = self._parse_not()
            left = ExpressionContext.for_function("and", left, right)
        return left

    def _parse_not(self) -> ExpressionContext:
        if self.accept_kw("NOT"):
            return ExpressionContext.for_function("not", self._parse_not())
        return self._parse_comparison()

    def _parse_comparison(self) -> ExpressionContext:
        left = self._parse_additive()
        t = self.peek()
        if t.kind == "op" and t.value in ("=", "!=", "<>", "<", "<=", ">", ">="):
            self.next()
            right = self._parse_additive()
            name = {
                "=": "equals", "!=": "notequals", "<>": "notequals",
                "<": "lessthan", "<=": "lessthanorequal",
                ">": "greaterthan", ">=": "greaterthanorequal",
            }[t.value]
            return ExpressionContext.for_function(name, left, right)
        negated = False
        if self.at_kw("NOT") and self.peek(1).upper in ("IN", "BETWEEN", "LIKE"):
            self.next()
            negated = True
        if self.accept_kw("IN"):
            self.expect_op("(")
            args = [left]
            args.append(self.parse_expression())
            while self.accept_op(","):
                args.append(self.parse_expression())
            self.expect_op(")")
            return ExpressionContext.for_function("notin" if negated else "in", *args)
        if self.accept_kw("BETWEEN"):
            lo = self._parse_additive()
            self.expect_kw("AND")
            hi = self._parse_additive()
            e = ExpressionContext.for_function("between", left, lo, hi)
            return ExpressionContext.for_function("not", e) if negated else e
        if self.accept_kw("LIKE"):
            pattern = self._parse_additive()
            e = ExpressionContext.for_function("like", left, pattern)
            return ExpressionContext.for_function("not", e) if negated else e
        if self.accept_kw("IS"):
            if self.accept_kw("NOT"):
                self.expect_kw("NULL")
                return ExpressionContext.for_function("isnotnull", left)
            self.expect_kw("NULL")
            return ExpressionContext.for_function("isnull", left)
        return left

    def _parse_additive(self) -> ExpressionContext:
        left = self._parse_multiplicative()
        while True:
            if self.accept_op("+"):
                left = ExpressionContext.for_function("plus", left, self._parse_multiplicative())
            elif self.accept_op("-"):
                left = ExpressionContext.for_function("minus", left, self._parse_multiplicative())
            else:
                return left

    def _parse_multiplicative(self) -> ExpressionContext:
        left = self._parse_unary()
        while True:
            if self.accept_op("*"):
                left = ExpressionContext.for_function("times", left, self._parse_unary())
            elif self.accept_op("/"):
                left = ExpressionContext.for_function("divide", left, self._parse_unary())
            elif self.accept_op("%"):
                left = ExpressionContext.for_function("mod", left, self._parse_unary())
            else:
                return left

    def _parse_unary(self) -> ExpressionContext:
        if self.accept_op("-"):
            inner = self._parse_unary()
            if inner.is_literal and isinstance(inner.literal, (int, float)):
                return ExpressionContext.for_literal(-inner.literal)
            return ExpressionContext.for_function("minus", ExpressionContext.for_literal(0), inner)
        if self.accept_op("+"):
            return self._parse_unary()
        return self._parse_primary()

    def _parse_primary(self) -> ExpressionContext:
        t = self.peek()
        if t.kind == "number":
            self.next()
            return ExpressionContext.for_literal(_number(t.value))
        if t.kind == "string":
            self.next()
            return ExpressionContext.for_literal(t.value)
        if self.accept_op("("):
            e = self.parse_expression()
            self.expect_op(")")
            return e
        if t.kind == "ident":
            if t.upper == "TRUE":
                self.next()
                return ExpressionContext.for_literal(True)
            if t.upper == "FALSE":
                self.next()
                return ExpressionContext.for_literal(False)
            if t.upper == "NULL":
                self.next()
                return ExpressionContext.for_literal(None)
            if t.upper == "CASE":
                return self._parse_case()
            if t.upper == "CAST":
                return self._parse_cast()
            if t.upper == "ARRAY" and self.peek(1).kind == "op" \
                    and self.peek(1).value == "[":
                # ARRAY[1,2,3] literal (VECTOR_SIMILARITY query vectors,
                # array scalar fns)
                self.next()
                self.next()
                vals = []
                if not self.accept_op("]"):
                    while True:
                        e = self.parse_expression()
                        if not e.is_literal:
                            raise SqlParseError("ARRAY[...] takes literals")
                        vals.append(e.literal)
                        if not self.accept_op(","):
                            break
                    self.expect_op("]")
                return ExpressionContext.for_literal(vals)
            self.next()
            # function call?
            if self.accept_op("("):
                return self._parse_function_call(t.value)
            parts = [t.value]
            while self.accept_op("."):
                parts.append(self.next().value)
            return ExpressionContext.for_identifier(self._make_identifier(parts))
        raise SqlParseError(f"unexpected token {t.value!r}")

    def _make_identifier(self, parts: list[str]) -> str:
        """Dotted identifier resolution: the single-stage engine is
        single-table so qualifiers are dropped (reference does the same in
        BaseSingleStageBrokerRequestHandler column resolution); the MSE
        parser overrides this to keep qualifiers for join disambiguation."""
        return parts[-1]

    def _parse_function_call(self, raw_name: str) -> ExpressionContext:
        name = canonical_function_name(raw_name)
        args: list[ExpressionContext] = []
        if self.accept_op(")"):
            return ExpressionContext.for_function(name, *args)
        # COUNT(*) / COUNT(DISTINCT x)
        if self.peek().kind == "op" and self.peek().value == "*":
            self.next()
            args.append(ExpressionContext.for_identifier("*"))
        else:
            if self.at_kw("DISTINCT"):
                # agg(DISTINCT x) rewrites (reference CalciteSqlParser distinct rewrite)
                distinct_map = {"count": "distinctcount", "sum": "distinctsum", "avg": "distinctavg"}
                if name in distinct_map:
                    self.next()
                    name = distinct_map[name]
                elif name in ("distinctcount", "distinctsum", "distinctavg"):
                    self.next()
                else:
                    raise SqlParseError(f"DISTINCT is not supported inside {name}()")
            args.append(self.parse_expression())
        while self.accept_op(","):
            args.append(self.parse_expression())
        self.expect_op(")")
        e = ExpressionContext.for_function(name, *args)
        # AGG(x) FILTER (WHERE cond) — reference FilteredAggregationFunction;
        # postfix here so HAVING / ORDER BY positions parse too
        if self.peek().kind == "ident" and self.peek().upper == "FILTER":
            from ..expressions import is_aggregation

            if not is_aggregation(e):
                raise SqlParseError(
                    "FILTER clause requires an aggregation function")
            self.next()
            self.expect_op("(")
            self.expect_kw("WHERE")
            cond = self.parse_expression()
            self.expect_op(")")
            e = ExpressionContext.for_function("filter", e, cond)
        return e

    def _parse_case(self) -> ExpressionContext:
        """CASE WHEN c1 THEN v1 ... [ELSE d] END → case(c1,v1,...,d)
        (reference: CalciteSqlParser case-when rewrite)."""
        self.expect_kw("CASE")
        args: list[ExpressionContext] = []
        while self.accept_kw("WHEN"):
            args.append(self.parse_expression())
            self.expect_kw("THEN")
            args.append(self.parse_expression())
        if self.accept_kw("ELSE"):
            args.append(self.parse_expression())
        else:
            args.append(ExpressionContext.for_literal(None))
        self.expect_kw("END")
        return ExpressionContext.for_function("case", *args)

    def _parse_cast(self) -> ExpressionContext:
        self.expect_kw("CAST")
        self.expect_op("(")
        e = self.parse_expression()
        self.expect_kw("AS")
        type_name = self.next().value
        self.expect_op(")")
        return ExpressionContext.for_function("cast", e, ExpressionContext.for_literal(type_name.upper()))


_RESERVED = frozenset(
    {
        "FROM", "WHERE", "GROUP", "BY", "HAVING", "ORDER", "LIMIT", "OFFSET", "AS",
        "AND", "OR", "NOT", "IN", "BETWEEN", "LIKE", "IS", "NULL", "SELECT",
        "DISTINCT", "ASC", "DESC", "CASE", "WHEN", "THEN", "ELSE", "END", "SET",
        "OPTION", "EXPLAIN", "PLAN", "FOR", "NULLS", "FIRST", "LAST", "JOIN", "ON",
        "UNION", "INTERSECT", "EXCEPT", "ALL", "INNER", "LEFT", "RIGHT", "FULL",
        "OUTER", "CROSS", "SEMI", "ANTI", "USING", "WITH", "OVER", "PARTITION",
    }
)


def _number(text: str):
    if re.fullmatch(r"\d+", text):
        return int(text)
    return float(text)


def _literal_value(tok: Token):
    if tok.kind == "number":
        return _number(tok.value)
    if tok.kind == "string":
        return tok.value
    if tok.upper == "TRUE":
        return True
    if tok.upper == "FALSE":
        return False
    return tok.value


def parse_sql(sql: str) -> QueryContext:
    """Parse a SQL string into a finished QueryContext."""
    return _Parser(tokenize(sql)).parse_query()


def parse_filter_expression(expr: str):
    """Parse a standalone boolean expression into a FilterContext: the
    inner filter string of JSON_MATCH (segment/indexes.py
    JsonIndex.mask_match; reference: Pinot parses those with its own
    mini-grammar in JsonMatchPredicate; here the main parser serves)."""
    p = _Parser(tokenize(expr))
    e = p.parse_expression()
    if p.peek().kind != "eof":
        raise SqlParseError(f"trailing input in filter expression: {expr!r}")
    return p._to_filter(e)


def parse_expression_str(expr: str) -> ExpressionContext:
    """Parse a standalone value expression (ingestion transformConfigs and
    filterFunction, ingestion/transform.py)."""
    p = _Parser(tokenize(expr))
    e = p.parse_expression()
    if p.peek().kind != "eof":
        raise SqlParseError(f"trailing input in expression: {expr!r}")
    return e
