"""Logical planner: relational AST → PlanNode tree with exchanges.

The port's copy of pinot_tpu/mse/logical.py. Reference analogue:
pinot-query-planner's RelNode optimization +
RelToPlanNodeConverter (.../planner/logical/RelToPlanNodeConverter.java) and
the plan-node zoo (.../planner/plannode/: Join/Window/Aggregate/Sort/
SetOp/MailboxSend/MailboxReceive). Differences by design:

- Columns are carried by *qualified name* (``alias.col``), not ordinal — the
  runtime is columnar dicts, so names are the natural join currency.
- Exchange placement mirrors the reference's distribution traits: hash on
  join keys / group keys / window partition keys, singleton at the root and
  for set ops (PinotLogicalQueryPlanner + MailboxAssignmentVisitor).
- IN/NOT IN subqueries rewrite to SEMI/ANTI joins (Calcite
  SubQueryRemoveRule analogue) here in the planner.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from ..engine.aggregation import UnsupportedQueryError, get_semantics
from ..query.expressions import ExpressionContext
from ..query.parser.sql import SqlParseError
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

EC = ExpressionContext


class PlanError(SqlParseError):
    pass


# -- plan nodes --------------------------------------------------------------


@dataclass
class PlanNode:
    inputs: list["PlanNode"]
    schema: list[str]

    def tree_lines(self, indent: int = 0) -> list[str]:
        out = ["  " * indent + self.describe()]
        for i in self.inputs:
            out.extend(i.tree_lines(indent + 1))
        return out

    def describe(self) -> str:
        return type(self).__name__


@dataclass
class TableScanNode(PlanNode):
    table: str = ""
    alias: str = ""
    source_columns: list[str] = field(default_factory=list)  # parallel to schema

    def describe(self) -> str:
        return f"TableScan(table={self.table}, columns={self.source_columns})"


@dataclass
class FilterNode(PlanNode):
    condition: Optional[EC] = None

    def describe(self) -> str:
        return f"Filter(condition={self.condition})"


@dataclass
class ProjectNode(PlanNode):
    exprs: list[EC] = field(default_factory=list)

    def describe(self) -> str:
        return f"Project({', '.join(f'{n}={e}' for n, e in zip(self.schema, self.exprs))})"


@dataclass
class AggCall:
    name: str  # canonical aggregation function name
    args: list[EC]
    out_name: str
    extra: tuple = ()
    # AGG(x) FILTER (WHERE cond): rows failing cond contribute the identity
    # (reference: FilteredAggregationFunction). Evaluated over the
    # aggregate's INPUT rows — on the partial (pre-shuffle) phase when the
    # call decomposes, so leaf pushdowns compile it into the device plan.
    condition: Optional[EC] = None


@dataclass
class AggregateNode(PlanNode):
    group_exprs: list[EC] = field(default_factory=list)  # schema[:len(group_exprs)]
    agg_calls: list[AggCall] = field(default_factory=list)

    def describe(self) -> str:
        return (f"Aggregate(groups=[{', '.join(map(str, self.group_exprs))}], "
                f"aggs=[{', '.join(a.name + '(' + ','.join(map(str, a.args)) + ')' for a in self.agg_calls)}])")


@dataclass
class JoinNode(PlanNode):
    join_type: str = "INNER"  # INNER/LEFT/RIGHT/FULL/CROSS/SEMI/ANTI
    left_keys: list[str] = field(default_factory=list)
    right_keys: list[str] = field(default_factory=list)
    residual: Optional[EC] = None  # evaluated over combined schema

    def describe(self) -> str:
        return (f"Join(type={self.join_type}, left={self.left_keys}, "
                f"right={self.right_keys}, residual={self.residual})")


@dataclass
class WindowCall:
    name: str  # rownumber/rank/denserank/ntile/lag/lead/firstvalue/lastvalue or agg
    args: list[EC]
    spec: WindowSpec = None
    out_name: str = ""


@dataclass
class WindowNode(PlanNode):
    calls: list[WindowCall] = field(default_factory=list)
    partition_keys: list[EC] = field(default_factory=list)

    def describe(self) -> str:
        return f"Window(calls=[{', '.join(c.name for c in self.calls)}])"


@dataclass
class SortNode(PlanNode):
    sort_items: list[OrderItem] = field(default_factory=list)
    limit: Optional[int] = None
    offset: int = 0

    def describe(self) -> str:
        keys = ", ".join(f"{it.expression}{'' if it.ascending else ' DESC'}"
                         for it in self.sort_items)
        return f"Sort(keys=[{keys}], limit={self.limit}, offset={self.offset})"


@dataclass
class SetOpNode(PlanNode):
    kind: str = "UNION"
    all: bool = False

    def describe(self) -> str:
        return f"SetOp({self.kind}{' ALL' if self.all else ''})"


@dataclass
class ExchangeNode(PlanNode):
    """Distribution boundary → becomes MailboxSend/Receive at fragmenting
    (reference: PinotLogicalExchange → MailboxSendNode/MailboxReceiveNode).

    dist="partitioned" is the colocated-join exchange: both join sides are
    table-partitioned on a join key by the SAME function/count, so rows
    route by that table partition function instead of a generic row hash —
    worker p of the join joins table partition p from each side, and a
    distributed leaf serves partition p from its stamped segments without
    re-hashing (reference: partition-aware exchange elision behind the
    is_colocated_by_join_keys hint, PinotJoinToDynamicBroadcastRule's
    sibling rule in pinot-query-planner/.../rules/)."""

    dist: str = "singleton"  # hash | singleton | broadcast | partitioned
    keys: list[str] = field(default_factory=list)
    pfunc: Optional[str] = None       # partitioned: table partition function
    n_partitions: Optional[int] = None

    def describe(self) -> str:
        if self.dist == "partitioned":
            return (f"Exchange(dist=partitioned, keys={self.keys}, "
                    f"fn={self.pfunc}, n={self.n_partitions})")
        return f"Exchange(dist={self.dist}, keys={self.keys})"


# -- aggregation detection ---------------------------------------------------


def is_agg_function(name: str) -> bool:
    try:
        get_semantics(name)
        return True
    except (UnsupportedQueryError, KeyError):
        return False


_WINDOW_ONLY = {"rownumber", "rank", "denserank", "ntile", "lag", "lead",
                "firstvalue", "lastvalue", "cumedist", "percentrank"}

# aggregations splittable into partial (producer stage) + final merge
_DECOMPOSE = {"count", "sum", "min", "max", "avg", "minmaxrange"}


# -- planner -----------------------------------------------------------------


class LogicalPlanner:
    """Builds a PlanNode tree; identifiers are rewritten to exact input
    column names during planning so the runtime never resolves names.

    ``catalog`` maps table name → list of physical column names (the
    reference binds against ZK table schemas in Calcite's validator)."""

    def __init__(self, query: RelationalQuery, catalog: dict[str, list[str]],
                 partition_catalog=None):
        self.query = query
        self.catalog = catalog
        # table → {column: (partition function name, num_partitions)} — or a
        # zero-arg callable producing it, resolved only when a join asks
        # (metadata sweeps shouldn't tax joinless queries); drives
        # colocated joins
        self._partition_catalog = partition_catalog
        self._counter = 0

    def plan(self) -> PlanNode:
        root = self.plan_stmt(self.query.statement)
        return ExchangeNode([root], root.schema, dist="singleton")

    # -- statements --------------------------------------------------------
    def plan_stmt(self, stmt: Stmt) -> PlanNode:
        if isinstance(stmt, SetOpStmt):
            return self._plan_setop(stmt)
        return self._plan_select(stmt)

    def _plan_setop(self, stmt: SetOpStmt) -> PlanNode:
        left = self.plan_stmt(stmt.left)
        right = self.plan_stmt(stmt.right)
        if len(left.schema) != len(right.schema):
            raise PlanError(f"{stmt.kind} inputs have different column counts")
        # align right's names to left's (positional, like SQL set ops)
        if right.schema != left.schema:
            right = ProjectNode(
                [right], list(left.schema),
                exprs=[EC.for_identifier(c) for c in right.schema])
        node = SetOpNode(
            [ExchangeNode([left], left.schema, dist="singleton"),
             ExchangeNode([right], right.schema, dist="singleton")],
            list(left.schema), kind=stmt.kind, all=stmt.all)
        if stmt.order_by or stmt.limit is not None:
            node = SortNode([node], node.schema,
                            sort_items=self._resolve_order(stmt.order_by, node.schema),
                            limit=stmt.limit, offset=stmt.offset)
        return node

    # -- SELECT ------------------------------------------------------------
    def _plan_select(self, stmt: SelectStmt) -> PlanNode:
        node = self.plan_relation(stmt.from_rel)

        # WHERE (with IN-subquery → SEMI/ANTI join rewrite)
        if stmt.where is not None:
            node, remaining = self._rewrite_subqueries(node, stmt.where)
            if remaining is not None:
                _reject_nested_subqueries(remaining)
                node = FilterNode([node], node.schema,
                                  condition=self._resolve(remaining, node.schema))
        if stmt.having is not None:
            _reject_nested_subqueries(stmt.having)

        has_windows = any(it.window is not None for it in stmt.select_items)
        agg_in_select = any(
            self._contains_agg(it.expression) for it in stmt.select_items
            if it.window is None)
        grouped = bool(stmt.group_by) or agg_in_select or (
            stmt.having is not None and self._contains_agg(stmt.having))

        if grouped and has_windows:
            raise PlanError("window functions over grouped queries are not supported")

        if grouped:
            node, out_names, out_exprs = self._plan_aggregate(stmt, node)
        elif has_windows:
            node, out_names, out_exprs = self._plan_window(stmt, node)
        else:
            out_names, out_exprs = self._select_outputs(stmt.select_items, node.schema)

        # final projection
        proj = ProjectNode([node], out_names, exprs=out_exprs)

        if stmt.distinct:
            proj = AggregateNode(
                [ExchangeNode([proj], proj.schema, dist="hash", keys=list(proj.schema))],
                list(proj.schema),
                group_exprs=[EC.for_identifier(c) for c in proj.schema], agg_calls=[])

        if stmt.order_by or stmt.limit is not None:
            proj = self._plan_sort(proj, node, stmt)
        return proj

    def _plan_sort(self, proj: PlanNode, pre_proj: PlanNode,
                   stmt: SelectStmt) -> PlanNode:
        """Sort above the projection. ORDER BY keys not present in the
        projection become hidden `$sort{i}` columns (computed from the
        pre-projection input), dropped by a final trim projection —
        Calcite's Sort-with-hidden-fields pattern."""
        sort_items: list[OrderItem] = []
        hidden: list[tuple[str, EC]] = []
        for it in stmt.order_by:
            try:
                e = self._resolve(it.expression, proj.schema)
            except PlanError:
                resolved = self._resolve(it.expression, pre_proj.schema)
                hname = f"$sort{len(hidden)}"
                hidden.append((hname, resolved))
                e = EC.for_identifier(hname)
            sort_items.append(OrderItem(e, it.ascending, it.nulls_last))
        if hidden:
            if not isinstance(proj, ProjectNode) or proj.inputs[0] is not pre_proj:
                raise PlanError(
                    "ORDER BY expression must appear in the SELECT list here")
            visible = list(proj.schema)
            proj = ProjectNode([pre_proj], visible + [h for h, _ in hidden],
                               exprs=list(proj.exprs) + [e for _, e in hidden])
            sort = SortNode([self._gather(proj, sort_items, stmt)],
                            proj.schema, sort_items=sort_items,
                            limit=stmt.limit, offset=stmt.offset)
            return ProjectNode([sort], visible,
                               exprs=[EC.for_identifier(c) for c in visible])
        return SortNode([self._gather(proj, sort_items, stmt)], proj.schema,
                        sort_items=sort_items,
                        limit=stmt.limit, offset=stmt.offset)

    @staticmethod
    def _gather(node: PlanNode, sort_items: list, stmt) -> PlanNode:
        """Singleton exchange under a global Sort: its input may be
        hash-partitioned (e.g. a parallel aggregate), and a per-partition
        sort+LIMIT would emit workers×LIMIT rows in partition order
        (reference: Calcite plans a SortExchange gathering to one worker
        before the final Sort). With a LIMIT, each partition pre-sorts and
        keeps only its top offset+limit rows first, bounding the shuffle to
        workers×(offset+limit) instead of the full result."""
        if stmt.limit is not None and sort_items:
            node = SortNode([node], list(node.schema),
                            sort_items=list(sort_items),
                            limit=stmt.limit + (stmt.offset or 0), offset=0)
        return ExchangeNode([node], list(node.schema), dist="singleton")

    # -- relations ---------------------------------------------------------
    def plan_relation(self, rel: Relation) -> PlanNode:
        if isinstance(rel, TableRef):
            alias = rel.alias or rel.name
            cols = self.catalog.get(rel.name)
            if cols is None:
                raise PlanError(f"unknown table {rel.name!r}")
            return TableScanNode(
                [], [f"{alias}.{c}" for c in cols],
                table=rel.name, alias=alias, source_columns=list(cols))
        if isinstance(rel, SubqueryRef):
            sub = self.plan_stmt(rel.query)
            qualified = [f"{rel.alias}.{_short(c)}" for c in sub.schema]
            return ProjectNode([sub], qualified,
                               exprs=[EC.for_identifier(c) for c in sub.schema])
        if isinstance(rel, JoinRel):
            return self._plan_join(rel)
        raise PlanError(f"unsupported relation {rel!r}")

    def _plan_join(self, rel: JoinRel) -> PlanNode:
        left = self.plan_relation(rel.left)
        right = self.plan_relation(rel.right)
        return self._make_join(left, right, rel.join_type, rel.condition)

    def _make_join(self, left: PlanNode, right: PlanNode, join_type: str,
                   condition: Optional[EC]) -> PlanNode:
        lkeys: list[str] = []
        rkeys: list[str] = []
        residual_parts: list[EC] = []
        combined = list(left.schema) + [c for c in right.schema]
        if condition is not None:
            for conj in _split_and(condition):
                pair = self._equi_pair(conj, left.schema, right.schema)
                if pair:
                    lkeys.append(pair[0])
                    rkeys.append(pair[1])
                else:
                    residual_parts.append(self._resolve(conj, combined))
        residual = None
        for p in residual_parts:
            residual = p if residual is None else EC.for_function("and", residual, p)
        if join_type in ("SEMI", "ANTI"):
            schema = list(left.schema)
        else:
            schema = combined
        if lkeys:
            colo = self._colocation(left, right, lkeys, rkeys)
            if colo:
                lk, rk, fn, nparts = colo
                lx = ExchangeNode([left], left.schema, dist="partitioned",
                                  keys=[lk], pfunc=fn, n_partitions=nparts)
                rx = ExchangeNode([right], right.schema, dist="partitioned",
                                  keys=[rk], pfunc=fn, n_partitions=nparts)
            else:
                lx = ExchangeNode([left], left.schema, dist="hash", keys=lkeys)
                rx = ExchangeNode([right], right.schema, dist="hash", keys=rkeys)
        else:
            # non-equi / cross join: broadcast the right side
            lx = ExchangeNode([left], left.schema, dist="singleton")
            rx = ExchangeNode([right], right.schema, dist="broadcast")
        return JoinNode([lx, rx], schema, join_type=join_type,
                        left_keys=lkeys, right_keys=rkeys, residual=residual)

    # -- colocated join detection ------------------------------------------
    def _colocation(self, left: PlanNode, right: PlanNode,
                    lkeys: list[str], rkeys: list[str]):
        """If some equi-key pair is the partition column of BOTH sides'
        tables with the same function + count, route by that partition
        function: rows equal on ALL join keys are equal on the partition
        key, so matching rows meet in the same partition-indexed worker."""
        if self._partition_catalog is None:
            return None
        if callable(self._partition_catalog):
            self._partition_catalog = self._partition_catalog() or {}
        linfo = self._partition_info(left)
        rinfo = self._partition_info(right)
        for lk, rk in zip(lkeys, rkeys):
            li, ri = linfo.get(lk), rinfo.get(rk)
            if li is not None and li == ri:
                return lk, rk, li[0], li[1]
        return None

    def _partition_info(self, node: PlanNode) -> dict[str, tuple]:
        """qualified column name → (pfunc, n_partitions) for columns whose
        table partitioning SURVIVES to this node's output: propagates
        through Filter (row subset) and identifier Projects (rename); any
        other node breaks the guarantee."""
        if isinstance(node, TableScanNode):
            per_col = self._partition_catalog.get(node.table) or {}
            return {q: per_col[s] for q, s in
                    zip(node.schema, node.source_columns) if s in per_col}
        if isinstance(node, FilterNode):
            return self._partition_info(node.inputs[0])
        if isinstance(node, ProjectNode):
            inner = self._partition_info(node.inputs[0])
            out = {}
            for q, e in zip(node.schema, node.exprs):
                if e.is_identifier and e.identifier in inner:
                    out[q] = inner[e.identifier]
            return out
        return {}

    def _equi_pair(self, conj: EC, lschema: list[str], rschema: list[str]):
        """a.x = b.y with sides living in different inputs → (lcol, rcol)."""
        if not (conj.is_function and conj.function.name == "equals"):
            return None
        a, b = conj.function.arguments
        if not (a.is_identifier and b.is_identifier):
            return None
        try:
            ra = _resolve_name(a.identifier, lschema)
        except PlanError:
            ra = None
        try:
            rb = _resolve_name(b.identifier, rschema)
        except PlanError:
            rb = None
        if ra and rb:
            return ra, rb
        try:
            ra2 = _resolve_name(b.identifier, lschema)
            rb2 = _resolve_name(a.identifier, rschema)
            return ra2, rb2
        except PlanError:
            return None

    # -- IN-subquery rewrite ------------------------------------------------
    def _rewrite_subqueries(self, node: PlanNode, where: EC):
        """Pull top-level [NOT] IN (SELECT …) conjuncts out of WHERE and turn
        them into SEMI/ANTI joins; returns (new_node, remaining_filter)."""
        conjs = _split_and(where)
        remaining: list[EC] = []
        for conj in conjs:
            if conj.is_function and conj.function.name in (
                    "__insubquery__", "__notinsubquery__"):
                left_expr, sub_lit = conj.function.arguments
                sub_plan = self.plan_stmt(sub_lit.literal)
                if len(sub_plan.schema) != 1:
                    raise PlanError("IN subquery must select exactly one column")
                jt = "SEMI" if conj.function.name == "__insubquery__" else "ANTI"
                cond = EC.for_function(
                    "equals", left_expr, EC.for_identifier(sub_plan.schema[0]))
                # distinct-ify the subquery side so SEMI join is a set test
                sub_plan = AggregateNode(
                    [ExchangeNode([sub_plan], sub_plan.schema, dist="hash",
                                  keys=list(sub_plan.schema))],
                    list(sub_plan.schema),
                    group_exprs=[EC.for_identifier(sub_plan.schema[0])], agg_calls=[])
                node = self._make_join(node, sub_plan, jt, cond)
            else:
                remaining.append(conj)
        rem = None
        for p in remaining:
            rem = p if rem is None else EC.for_function("and", rem, p)
        return node, rem

    # -- aggregation --------------------------------------------------------
    def _plan_aggregate(self, stmt: SelectStmt, node: PlanNode):
        group_exprs = [self._resolve(g, node.schema) for g in stmt.group_by]
        group_names = [_expr_name(g, raw) for g, raw in zip(group_exprs, stmt.group_by)]
        agg_calls: list[AggCall] = []

        def add_agg(e: EC, cond: Optional[EC]) -> EC:
            args = [self._resolve(a, node.schema)
                    for a in e.function.arguments
                    if not (a.is_identifier and a.identifier == "*")]
            # literal trailing args (percentile level etc.) stay as extras
            value_args = [a for a in args if not a.is_literal]
            extra = tuple(a.literal for a in args if a.is_literal)
            sig = (e.function.name, tuple(map(str, value_args)),
                   tuple(map(repr, extra)), str(cond))
            for c in agg_calls:
                if (c.name, tuple(map(str, c.args)), tuple(map(repr, c.extra)),
                        str(c.condition)) == sig:
                    return EC.for_identifier(c.out_name)
            out = f"{e.function.name}({','.join(str(a) for a in e.function.arguments)})"
            if cond is not None:
                out += f" FILTER({cond})"
            agg_calls.append(AggCall(e.function.name, value_args, out, extra,
                                     condition=cond))
            return EC.for_identifier(out)

        def extract(e: EC, raw_alias: Optional[str] = None) -> EC:
            """Replace group exprs / agg calls in a post-agg expression with
            identifiers over the Aggregate's output schema."""
            resolved_candidates = [self._try_resolve(e, node.schema)]
            for ge, gn in zip(group_exprs, group_names):
                if resolved_candidates[0] is not None and resolved_candidates[0] == ge:
                    return EC.for_identifier(gn)
            if e.is_function and e.function.name == "filter":
                inner, cond_raw = e.function.arguments
                if not (inner.is_function and is_agg_function(inner.function.name)):
                    raise PlanError(
                        "FILTER (WHERE ...) must be attached to an aggregate")
                return add_agg(inner, self._resolve(cond_raw, node.schema))
            if e.is_function and is_agg_function(e.function.name):
                return add_agg(e, None)
            if e.is_function:
                return EC.for_function(
                    e.function.name, *[extract(a) for a in e.function.arguments])
            if e.is_identifier:
                resolved = self._resolve(e, node.schema)
                for ge, gn in zip(group_exprs, group_names):
                    if resolved == ge:
                        return EC.for_identifier(gn)
                raise PlanError(
                    f"column {e.identifier!r} must appear in GROUP BY or an aggregate")
            return e

        out_names: list[str] = []
        out_exprs: list[EC] = []
        for it in stmt.select_items:
            if it.expression.is_identifier and it.expression.identifier == "*":
                raise PlanError("SELECT * with GROUP BY is not supported")
            post = extract(it.expression)
            out_exprs.append(post)
            out_names.append(it.alias or str(it.expression))

        having_post = extract(stmt.having) if stmt.having is not None else None

        # ORDER BY may reference aggregates (even ones absent from SELECT) —
        # extract them BEFORE the phase build so their agg calls materialize
        if stmt.order_by:
            new_order = []
            for item in stmt.order_by:
                try:
                    resolved = extract(item.expression)
                except PlanError:
                    resolved = item.expression  # alias reference, resolved later
                new_order.append(OrderItem(resolved, item.ascending, item.nulls_last))
            stmt.order_by = new_order

        out = self._build_agg_phases(node, group_exprs, group_names, agg_calls)
        if having_post is not None:
            out = FilterNode([out], out.schema, condition=having_post)
        return out, out_names, out_exprs

    def _build_agg_phases(self, node: PlanNode, group_exprs: list[EC],
                          group_names: list[str], agg_calls: list[AggCall]) -> PlanNode:
        """Two-phase aggregation when every call is decomposable: a PARTIAL
        aggregate below the exchange (runs in the producer stage, where the
        leaf compiler can hand it to the single-stage device engine) and a FINAL
        merge above — the reference's leaf/intermediate AggType split
        (pinot-query-runtime/.../operator/AggregateOperator.java, AggType).
        Non-decomposable calls fall back to single-phase over shuffled rows."""
        decomposable = all(c.name in _DECOMPOSE and not c.extra for c in agg_calls)
        if not decomposable:
            keys = [g.identifier for g in group_exprs if g.is_identifier]
            ex = ExchangeNode([node], node.schema,
                              dist="hash" if keys and len(keys) == len(group_exprs)
                              else "singleton", keys=keys)
            return AggregateNode(
                [ex], group_names + [c.out_name for c in agg_calls],
                group_exprs=group_exprs, agg_calls=agg_calls)

        partial_calls: list[AggCall] = []
        final_calls: list[AggCall] = []
        reconstruct: list[EC] = []  # parallel to agg_calls

        def add_phase(pname: str, fname: str, args: list[EC],
                      cond: Optional[EC] = None) -> str:
            """The FILTER condition applies on the PARTIAL (pre-shuffle)
            phase where raw input rows live; the final merge is unfiltered."""
            p = f"$p{len(partial_calls)}"
            partial_calls.append(AggCall(pname, args, p, condition=cond))
            final_calls.append(AggCall(fname, [EC.for_identifier(p)], p))
            return p

        for c in agg_calls:
            if c.name in ("count", "countmv"):
                p = add_phase("count", "sum", c.args, c.condition)
                reconstruct.append(EC.for_function(
                    "cast", EC.for_identifier(p), EC.for_literal("LONG")))
            elif c.name == "sum":
                reconstruct.append(EC.for_identifier(
                    add_phase("sum", "sum", c.args, c.condition)))
            elif c.name == "min":
                reconstruct.append(EC.for_identifier(
                    add_phase("min", "min", c.args, c.condition)))
            elif c.name == "max":
                reconstruct.append(EC.for_identifier(
                    add_phase("max", "max", c.args, c.condition)))
            elif c.name == "avg":
                s = add_phase("sum", "sum", c.args, c.condition)
                n = add_phase("count", "sum", c.args, c.condition)
                reconstruct.append(EC.for_function(
                    "divide", EC.for_identifier(s), EC.for_identifier(n)))
            elif c.name == "minmaxrange":
                mx = add_phase("max", "max", c.args, c.condition)
                mn = add_phase("min", "min", c.args, c.condition)
                reconstruct.append(EC.for_function(
                    "minus", EC.for_identifier(mx), EC.for_identifier(mn)))
            else:  # pragma: no cover — guarded by _DECOMPOSE
                raise PlanError(c.name)

        partial_schema = group_names + [c.out_name for c in partial_calls]
        partial = AggregateNode([node], partial_schema,
                                group_exprs=group_exprs, agg_calls=partial_calls)
        ex = ExchangeNode([partial], partial_schema,
                          dist="hash" if group_names else "singleton",
                          keys=list(group_names))
        final = AggregateNode(
            [ex], group_names + [c.out_name for c in final_calls],
            group_exprs=[EC.for_identifier(g) for g in group_names],
            agg_calls=final_calls)
        return ProjectNode(
            [final], group_names + [c.out_name for c in agg_calls],
            exprs=[EC.for_identifier(g) for g in group_names] + reconstruct)

    # -- windows ------------------------------------------------------------
    def _plan_window(self, stmt: SelectStmt, node: PlanNode):
        calls: list[WindowCall] = []
        out_names: list[str] = []
        out_exprs: list[EC] = []
        for it in stmt.select_items:
            if it.window is not None:
                e = it.expression
                if not e.is_function:
                    raise PlanError("OVER must follow a function call")
                spec = WindowSpec(
                    partition_by=[self._resolve(p, node.schema) for p in it.window.partition_by],
                    order_by=[(self._resolve(o, node.schema), asc)
                              for o, asc in it.window.order_by],
                    frame=it.window.frame)
                name = e.function.name
                if name not in _WINDOW_ONLY and not is_agg_function(name):
                    raise PlanError(f"unsupported window function {name}")
                out = f"$w{len(calls)}"
                calls.append(WindowCall(
                    name, [self._resolve(a, node.schema) for a in e.function.arguments
                           if not (a.is_identifier and a.identifier == "*")],
                    spec, out))
                out_exprs.append(EC.for_identifier(out))
                out_names.append(it.alias or str(e) + " OVER(...)")
            else:
                if it.expression.is_identifier and it.expression.identifier in ("*",):
                    for c in node.schema:
                        out_exprs.append(EC.for_identifier(c))
                        out_names.append(_short(c))
                    continue
                out_exprs.append(self._resolve(it.expression, node.schema))
                out_names.append(it.alias or str(it.expression))
        partition_keys = calls[0].spec.partition_by if calls else []
        # all calls must share a partition for the hash exchange to be valid;
        # otherwise fall back to singleton (reference: one window group per
        # WindowNode, WindowAggregateOperator)
        same = all(c.spec.partition_by == partition_keys for c in calls)
        keys = [p.identifier for p in partition_keys if p.is_identifier] if same else []
        dist = "hash" if keys else "singleton"
        wnode = WindowNode(
            [ExchangeNode([node], node.schema, dist=dist, keys=keys)],
            node.schema + [c.out_name for c in calls],
            calls=calls, partition_keys=partition_keys)
        return wnode, out_names, out_exprs

    # -- helpers ------------------------------------------------------------
    def _select_outputs(self, items: list[SelectItem], schema: list[str]):
        names: list[str] = []
        exprs: list[EC] = []
        for it in items:
            e = it.expression
            if e.is_identifier and e.identifier == "*":
                for c in schema:
                    exprs.append(EC.for_identifier(c))
                    names.append(_short(c))
                continue
            if e.is_identifier and e.identifier.endswith(".*"):
                prefix = e.identifier[:-2] + "."
                matched = [c for c in schema if c.startswith(prefix)]
                if not matched:
                    raise PlanError(f"no columns match {e.identifier!r}")
                for c in matched:
                    exprs.append(EC.for_identifier(c))
                    names.append(_short(c))
                continue
            exprs.append(self._resolve(e, schema))
            names.append(it.alias or str(e))
        return names, exprs

    def _resolve_order(self, items: list[OrderItem], schema: list[str],
                       fallback: Optional[list[str]] = None) -> list[OrderItem]:
        out = []
        for it in items:
            try:
                e = self._resolve(it.expression, schema)
            except PlanError:
                if fallback is None:
                    raise
                e = self._resolve(it.expression, fallback)
            out.append(OrderItem(e, it.ascending, it.nulls_last))
        return out

    def _resolve(self, e: EC, schema: list[str]) -> EC:
        r = self._try_resolve(e, schema)
        if r is None:
            raise PlanError(f"cannot resolve expression {e} against {schema}")
        return r

    def _try_resolve(self, e: EC, schema: list[str]) -> Optional[EC]:
        if e.is_literal:
            return e
        if e.is_identifier:
            try:
                return EC.for_identifier(_resolve_name(e.identifier, schema))
            except PlanError:
                return None
        args = []
        for a in e.function.arguments:
            r = self._try_resolve(a, schema)
            if r is None:
                return None
            args.append(r)
        return EC.for_function(e.function.name, *args)

    def _contains_agg(self, e: EC) -> bool:
        if not e.is_function:
            return False
        if e.function.name in _WINDOW_ONLY:
            return False
        if is_agg_function(e.function.name):
            return True
        return any(self._contains_agg(a) for a in e.function.arguments)


# -- name utilities ----------------------------------------------------------


def _short(name: str) -> str:
    return name.rsplit(".", 1)[-1]


def _resolve_name(ident: str, schema: list[str]) -> str:
    """Resolve `col` or `alias.col` against qualified schema names."""
    if ident in schema:
        return ident
    matches = [c for c in schema if c.endswith("." + ident)]
    if len(matches) == 1:
        return matches[0]
    if len(matches) > 1:
        raise PlanError(f"ambiguous column {ident!r}: {matches}")
    # alias.col given but schema holds bare names (subquery outputs)
    if "." in ident:
        tail = _short(ident)
        if tail in schema:
            return tail
        matches = [c for c in schema if c.endswith("." + tail)]
        if len(matches) == 1:
            return matches[0]
    raise PlanError(f"unknown column {ident!r} (have {schema})")


def _reject_nested_subqueries(e: EC) -> None:
    """IN (SELECT …) is only rewritable as a top-level AND conjunct of WHERE
    (Calcite's SubQueryRemoveRule handles more; we fail clearly instead of
    leaking internal markers to the runtime)."""
    if e.is_function:
        if e.function.name in ("__insubquery__", "__notinsubquery__"):
            raise PlanError(
                "IN (SELECT ...) is only supported as a top-level AND "
                "conjunct of WHERE")
        for a in e.function.arguments:
            _reject_nested_subqueries(a)


def _split_and(e: EC) -> list[EC]:
    if e.is_function and e.function.name == "and":
        out = []
        for a in e.function.arguments:
            out.extend(_split_and(a))
        return out
    return [e]


def _expr_name(resolved: EC, raw: EC) -> str:
    if resolved.is_identifier:
        return resolved.identifier
    return str(raw)


# -- column pruning ----------------------------------------------------------


def prune_columns(node: PlanNode, required: Optional[set[str]] = None) -> PlanNode:
    """Trim the plan to columns actually consumed upstream (reference:
    Calcite's ProjectPushDown / field trimming). Three cuts, all in place:

    - TableScan outputs narrow to referenced columns (as before);
    - ExchangeNode schemas narrow to what the consuming stage references
      (plus routing keys) — the fragmenter turns these into each stage's
      send schema, so only referenced columns are shuffled. A column a
      pushed-down filter consumes at the leaf no longer crosses the wire;
    - JoinNode schemas narrow to what the parent references — the join's
      late-materialized gather then touches only those payload columns.
    """
    if required is None:
        required = set(node.schema)

    def node_refs(n: PlanNode) -> set[str]:
        out: set[str] = set()
        if isinstance(n, FilterNode) and n.condition is not None:
            out |= n.condition.columns()
        elif isinstance(n, ProjectNode):
            for e in n.exprs:
                out |= e.columns()
        elif isinstance(n, AggregateNode):
            for g in n.group_exprs:
                out |= g.columns()
            for c in n.agg_calls:
                for a in c.args:
                    out |= a.columns()
                if c.condition is not None:
                    out |= c.condition.columns()
        elif isinstance(n, JoinNode):
            out |= set(n.left_keys) | set(n.right_keys)
            if n.residual is not None:
                out |= n.residual.columns()
        elif isinstance(n, WindowNode):
            for c in n.calls:
                for a in c.args:
                    out |= a.columns()
                for p in c.spec.partition_by:
                    out |= p.columns()
                for o, _ in c.spec.order_by:
                    out |= o.columns()
        elif isinstance(n, SortNode):
            for it in n.sort_items:
                out |= it.expression.columns()
        elif isinstance(n, ExchangeNode):
            out |= set(n.keys)
        return out

    def visit(n: PlanNode, req: set[str]) -> None:
        if isinstance(n, TableScanNode):
            keep = [i for i, c in enumerate(n.schema) if c in req]
            if keep and len(keep) < len(n.schema):
                n.source_columns = [n.source_columns[i] for i in keep]
                n.schema = [n.schema[i] for i in keep]
            return
        refs = node_refs(n)
        if isinstance(n, ExchangeNode):
            # narrow the shuffle schema: only columns the consuming stage
            # references (plus the routing keys) cross the mailbox. Keep at
            # least one column so row counts survive (COUNT(*) shapes).
            keep = [c for c in n.schema if c in req or c in n.keys]
            n.schema = keep if keep else n.schema[:1]
            visit(n.inputs[0], set(n.schema))
            return
        if isinstance(n, JoinNode):
            # narrow the join OUTPUT: the late-materialized gather in
            # op_join only touches these columns. Keys/residual columns
            # still flow to the children via refs.
            keep = [c for c in n.schema if c in req]
            n.schema = keep if keep else n.schema[:1]
            child_req = set(n.schema) | refs
            for inp in n.inputs:
                visit(inp, child_req)
            return
        if isinstance(n, (ProjectNode, AggregateNode, WindowNode)):
            child_req = refs if not isinstance(n, WindowNode) else refs | {
                c for c in n.inputs[0].schema if c in req}
        elif isinstance(n, SetOpNode):
            child_req = None  # positional: keep everything
        else:
            # pass-through nodes: child columns flow to output
            child_req = (req | refs)
        for inp in n.inputs:
            visit(inp, child_req if child_req is not None else set(inp.schema))

    visit(node, required)
    return node
