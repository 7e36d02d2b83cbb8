"""Star-tree index: pre-aggregation as a dense pseudo-segment.

The port's own copy of pinot_tpu/segment/startree.py: the same stored
table (byte for byte), the same eligibility rules and the same rewrite, so
a query answers from the same pre-aggregated rows in both packages.
Reference: pinot-segment-local/.../startree/ (BaseSingleTreeBuilder,
OffHeapStarTree node format) + pinot-core/.../startree/ execution
(StarTreeGroupByExecutor transparently rewrites eligible aggregations onto
pre-aggregated docs) — SURVEY.md §2.2/2.3.

As in the JAX package, the tree is a PRE-AGGREGATED DENSE TABLE, not the
reference's pointer tree of split-order levels and star nodes: one
GROUP BY over the full split order, stored as dim dict-id planes plus one
aggregate column per function-column pair. Grouping on any SUBSET of the
split dims is a group sum over the pre-aggregated rows (kernel A over
their dict-id planes on the device), what star nodes precompute. The
pseudo-segment reuses the parent segment's dictionaries, so every
predicate and plan path works unchanged; engine/query_executor.py routes
an eligible query to it (`_segment_route`).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..spi.data_types import DataType
from .format import ColumnMetadata

# function-column pairs storable in a star tree (reference
# AggregationFunctionColumnPair; sketch pairs are out of scope for now)
STORABLE_FUNCTIONS = ("count", "sum", "min", "max")


@dataclass
class StarTreeConfig:
    """Reference StarTreeV2BuilderConfig subset."""

    split_order: list[str]
    function_column_pairs: list[str]  # "SUM__col" / "COUNT__*"
    max_leaf_records: int = 10_000  # accepted for config parity; dense rep doesn't split

    @staticmethod
    def from_json(d: dict) -> "StarTreeConfig":
        return StarTreeConfig(
            split_order=list(d.get("dimensionsSplitOrder", [])),
            function_column_pairs=list(d.get("functionColumnPairs", [])),
            max_leaf_records=int(d.get("maxLeafRecords", 10_000)),
        )

    def to_json(self) -> dict:
        return {
            "dimensionsSplitOrder": self.split_order,
            "functionColumnPairs": self.function_column_pairs,
            "maxLeafRecords": self.max_leaf_records,
        }

    def pairs(self) -> list[tuple[str, str]]:
        out = []
        for p in self.function_column_pairs:
            fn, _, col = p.partition("__")
            out.append((fn.lower(), col))
        return out


def build_star_tree(tree_id: int, config: StarTreeConfig, dict_ids: dict[str, np.ndarray],
                    raw_values: dict[str, np.ndarray]):
    """→ (buffers, meta_json). dict_ids: split-order dim → int32 id plane;
    raw_values: metric column → value array (decoded)."""
    dims = config.split_order
    n = len(next(iter(dict_ids.values()))) if dict_ids else 0
    if n == 0:
        codes = np.zeros(0, dtype=np.int64)
        uniq_rows = {d: np.zeros(0, dtype=np.int32) for d in dims}
        starts = ends = np.zeros(0, dtype=np.int64)
    else:
        # linear group code over the split order (row-major)
        codes = np.zeros(n, dtype=np.int64)
        for d in dims:
            ids = dict_ids[d].astype(np.int64)
            codes = codes * (ids.max() + 1 if len(ids) else 1) + ids
        order = np.argsort(codes, kind="stable")
        sorted_codes = codes[order]
        boundaries = np.nonzero(np.diff(sorted_codes))[0] + 1
        starts = np.concatenate([[0], boundaries])
        ends = np.concatenate([boundaries, [n]])
        first = order[starts]
        uniq_rows = {d: dict_ids[d][first].astype(np.int32) for d in dims}

    buffers: list[tuple[str, np.ndarray]] = []
    prefix = f"st{tree_id}"
    for d in dims:
        buffers.append((f"{prefix}.{d}.ids", uniq_rows[d]))

    pair_metas = []
    for i, (fn, col) in enumerate(config.pairs()):
        if fn not in STORABLE_FUNCTIONS:
            raise ValueError(f"star-tree pair {fn}__{col} not storable")
        if n == 0:
            agg = np.zeros(0, dtype=np.float64 if fn != "count" else np.int64)
        elif fn == "count":
            agg = (ends - starts).astype(np.int64)
        else:
            vals = raw_values[col].astype(np.float64)[order]
            ufunc = {"sum": np.add, "min": np.minimum, "max": np.maximum}[fn]
            agg = ufunc.reduceat(vals, starts)
        buffers.append((f"{prefix}.agg{i}", agg))
        pair_metas.append({"fn": fn, "col": col,
                           "dtype": "LONG" if fn == "count" else "DOUBLE"})

    meta = {
        "treeId": tree_id,
        "config": config.to_json(),
        "numRows": int(len(starts)),
        "pairs": pair_metas,
    }
    return buffers, meta


class StarTreeView:
    """Pseudo-segment over the pre-aggregated table. Duck-types the
    ImmutableSegment surface the planner/executors use; shares the parent's
    dictionaries so predicates resolve identically."""

    def __init__(self, parent, meta: dict):
        self.parent = parent
        self.tree_meta = meta
        self.config = StarTreeConfig.from_json(meta["config"])
        self._num_rows = meta["numRows"]
        self._prefix = f"st{meta['treeId']}"
        self._ids: dict[str, np.ndarray] = {}
        self._agg: dict[str, np.ndarray] = {}
        self._metas: dict[str, ColumnMetadata] = {}
        for d in self.config.split_order:
            pm = parent.column_metadata(d)
            self._metas[d] = ColumnMetadata(
                name=d, data_type=pm.data_type, field_type=pm.field_type,
                encoding="DICT", cardinality=pm.cardinality,
                bits_per_value=32, min_value=pm.min_value, max_value=pm.max_value,
                total_number_of_entries=self._num_rows,
            )
        self._agg_buf: dict[str, str] = {}
        for i, pm in enumerate(meta["pairs"]):
            col = agg_column_name(pm["fn"], pm["col"])
            self._metas[col] = ColumnMetadata(
                name=col, data_type=pm["dtype"], field_type="METRIC",
                encoding="RAW", bits_per_value=64,
                total_number_of_entries=self._num_rows,
            )
            self._agg_buf[col] = f"{self._prefix}.agg{i}"

    # -- ImmutableSegment surface -----------------------------------------
    @property
    def name(self) -> str:
        return f"{self.parent.name}:{self._prefix}"

    @property
    def num_docs(self) -> int:
        return self._num_rows

    def columns(self):
        return list(self._metas)

    def has_column(self, column: str) -> bool:
        return column in self._metas

    def column_metadata(self, column: str) -> ColumnMetadata:
        return self._metas[column]

    def get_dictionary(self, column: str):
        return self.parent.get_dictionary(column)

    def get_dict_ids(self, column: str) -> np.ndarray:
        if column not in self._ids:
            buf = self.parent._buffer(f"{self._prefix}.{column}.ids")
            self._ids[column] = np.frombuffer(buf, dtype=np.int32)
        return self._ids[column]

    def get_raw(self, column: str) -> np.ndarray:
        if column not in self._agg:
            dt = DataType(self._metas[column].data_type).numpy_dtype
            self._agg[column] = np.frombuffer(
                self.parent._buffer(self._agg_buf[column]), dtype=dt)
        return self._agg[column]

    def get_null_bitmap(self, column: str):
        return None

    # no auxiliary indexes on the pre-aggregated table: an index-backed
    # predicate planned against it raises (engine/host_masks.py), and the
    # host engine scans the view's columns
    def get_inverted_index(self, column: str):
        return None

    def get_sorted_index(self, column: str):
        return None

    def get_range_index(self, column: str):
        return None

    def get_json_index(self, column: str, or_build: bool = False):
        return None

    def get_text_index(self, column: str, or_build: bool = False):
        return None

    def get_vector_index(self, column: str, or_build: bool = False):
        return None

    def get_values(self, column: str) -> np.ndarray:
        m = self._metas[column]
        if m.encoding == "RAW":
            return self.get_raw(column)
        return self.get_dictionary(column).take(self.get_dict_ids(column))

    def get_mv_values(self, column: str):
        raise ValueError("star-tree has no MV columns")


def agg_column_name(fn: str, col: str) -> str:
    return f"__{fn}__{col.replace('*', 'star')}"


# ---------------------------------------------------------------------------
# Query rewrite (reference StarTreeUtils.isFitForStarTree +
# StarTreeGroupByExecutor): an aggregation/group-by query fits a tree when
# every filter + group-by column is a split dim and every aggregation maps
# onto stored pairs.
# ---------------------------------------------------------------------------


@dataclass
class StarTreeRewrite:
    view: StarTreeView
    query: object  # rewritten QueryContext executed against `view`
    state_builders: list  # per outer agg: (inner_indices, build(states)->state)


def try_rewrite(query, segment) -> StarTreeRewrite | None:
    trees = getattr(segment, "star_trees", None)
    if not trees:
        return None
    if query.distinct or (not query.is_aggregation_query):
        return None
    if query.null_handling:
        # pre-aggregated states were built in basic mode (default values
        # count as values) — advanced null handling must see raw rows
        return None
    from ..query.context import QueryContext
    from ..query.expressions import ExpressionContext

    for view in trees():
        dims = set(view.config.split_order)
        # null-sensitive queries can't use the tree: the pre-agg table has no
        # null bitmaps, and dims with nulls folded them into default values
        if query.filter is not None and _has_null_predicate(query.filter):
            continue
        if any(segment.column_metadata(d).has_nulls for d in dims
               if segment.has_column(d)):
            continue
        filter_cols = query.filter.columns() if query.filter is not None else set()
        group_cols = set()
        ok = True
        for ge in query.group_by_expressions:
            if not ge.is_identifier:
                ok = False
                break
            group_cols.add(ge.identifier)
        if not ok or not filter_cols <= dims or not group_cols <= dims:
            continue
        pairs = {(fn, col) for fn, col in view.config.pairs()}

        inner_aggs: list[ExpressionContext] = []
        inner_index: dict[tuple, int] = {}
        builders = []

        def inner(reduce_fn: str, stored_fn: str, stored_col: str) -> int:
            """Register an inner agg: reduce_fn over the STORED pair column.
            Dedup'd — QueryContext.finish() deduplicates aggregations, so
            indices must refer to the deduplicated list (e.g. COUNT(*) and
            AVG(x) share one sum(__count__star))."""
            key = (reduce_fn, stored_fn, stored_col)
            if key not in inner_index:
                inner_aggs.append(ExpressionContext.for_function(
                    reduce_fn,
                    ExpressionContext.for_identifier(agg_column_name(stored_fn, stored_col))))
                inner_index[key] = len(inner_aggs) - 1
            return inner_index[key]

        ok = True
        for agg in query.aggregations:
            fn = agg.function.name
            args = agg.function.arguments
            col = args[0].identifier if args and args[0].is_identifier else "*"
            if fn == "count":
                if ("count", "*") not in pairs:
                    ok = False
                    break
                i = inner("sum", "count", "*")
                builders.append(([i], lambda st: int(round(st[0]))))
            elif fn in ("sum", "min", "max"):
                if (fn, col) not in pairs or col == "*":
                    ok = False
                    break
                i = inner(fn, fn, col)
                builders.append(([i], lambda st: float(st[0])))
            elif fn == "avg":
                if ("sum", col) not in pairs or ("count", "*") not in pairs or col == "*":
                    ok = False
                    break
                i_s = inner("sum", "sum", col)
                i_c = inner("sum", "count", "*")
                builders.append(([i_s, i_c],
                                 lambda st: (float(st[0]), int(round(st[1])))))
            elif fn == "minmaxrange":
                if ("min", col) not in pairs or ("max", col) not in pairs:
                    ok = False
                    break
                i_min = inner("min", "min", col)
                i_max = inner("max", "max", col)
                builders.append(([i_min, i_max],
                                 lambda st: (float(st[0]), float(st[1]))))
            else:
                ok = False
                break
        if not ok:
            continue

        rewritten = QueryContext(
            table_name=query.table_name,
            select_expressions=list(query.group_by_expressions) + inner_aggs,
            aliases=[None] * (len(query.group_by_expressions) + len(inner_aggs)),
            filter=query.filter,
            group_by_expressions=list(query.group_by_expressions),
            limit=10**9,
        ).finish()
        return StarTreeRewrite(view, rewritten, builders)
    return None


def _has_null_predicate(f) -> bool:
    from ..query.filter import FilterNodeType, PredicateType

    if f.type == FilterNodeType.PREDICATE:
        return f.predicate.type in (PredicateType.IS_NULL, PredicateType.IS_NOT_NULL)
    return any(_has_null_predicate(c) for c in f.children)


def remap_states(rewrite: StarTreeRewrite, inner_states: list) -> list:
    """Inner (rewritten) per-group states → outer aggregation states."""
    out = []
    for idxs, build in rewrite.state_builders:
        out.append(build([inner_states[i] for i in idxs]))
    return out
