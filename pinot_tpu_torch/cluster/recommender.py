"""Rule-based config recommender.

The port's copy of pinot_tpu/cluster/recommender.py, over the port's own
SQL parser and filter tree. The broker's WorkloadTracker.recommender_input
feeds it (the controller's /recommender endpoint).

Reference: pinot-controller/.../recommender/ (RecommenderDriver + rule
engine: InvertedSortedIndexJointRule, BloomFilterRule, NoDictionaryOnHeapRule,
AggregateMetricsRule, KafkaPartitionRule...). Input: the table schema, a
sample of query patterns with frequencies, and data characteristics
(cardinalities, qps); output: recommended indexing/partitioning config with
per-recommendation rationale.

Input shape::

    recommend(
        schema,                       # spi Schema
        queries=[{"sql"| parsed parts..., "freq": 0.5}, ...]  OR
        query_stats={"eq_filters": {"col": weight}, "range_filters": {...},
                     "group_by": {...}, "aggregations": ["sum(v)", ...]},
        cardinalities={"col": n_distinct},
        num_rows=..., qps=...)
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from ..query.parser.sql import SqlParseError, parse_sql
from ..query.filter import FilterContext, FilterNodeType, PredicateType

# rule thresholds (reference RecommenderConstants)
INVERTED_MAX_CARD_FRACTION = 0.3   # dict id postings pay off below this
BLOOM_MIN_CARD = 10_000            # bloom pruning needs high cardinality
NO_DICT_CARD_FRACTION = 0.7        # mostly-unique strings: dict is waste
SORTED_MIN_WEIGHT = 0.4            # dominant filter column gets the sort
STAR_TREE_MIN_GROUP_WEIGHT = 0.3
RANGE_MIN_WEIGHT = 0.05
INVERTED_MIN_WEIGHT = 0.05


@dataclass
class Recommendation:
    indexing: dict = field(default_factory=dict)
    partition_column: Optional[str] = None
    rationale: list = field(default_factory=list)

    def to_json(self) -> dict:
        return {"tableIndexConfig": self.indexing,
                "partitionColumn": self.partition_column,
                "rationale": self.rationale}


def _collect_filter_weights(f: Optional[FilterContext], freq: float,
                            eq: dict, rng: dict) -> None:
    if f is None:
        return
    if f.type == FilterNodeType.PREDICATE:
        p = f.predicate
        if not p.lhs.is_identifier:
            return
        col = p.lhs.identifier
        if p.type in (PredicateType.EQ, PredicateType.IN,
                      PredicateType.NOT_EQ, PredicateType.NOT_IN):
            eq[col] = eq.get(col, 0.0) + freq
        elif p.type == PredicateType.RANGE:
            rng[col] = rng.get(col, 0.0) + freq
        return
    for c in f.children:
        _collect_filter_weights(c, freq, eq, rng)


def analyze_queries(queries: list[dict]) -> dict:
    """[{sql, freq}] → aggregated pattern stats (the recommender's input
    extraction — reference: QueryInvertedSortedIndexRecommender parsing)."""
    eq: dict[str, float] = {}
    rng: dict[str, float] = {}
    group: dict[str, float] = {}
    aggs: set[str] = set()
    for q in queries:
        freq = float(q.get("freq", 1.0))
        try:
            ctx = parse_sql(q["sql"])
        except SqlParseError:
            continue
        _collect_filter_weights(ctx.filter, freq, eq, rng)
        for g in ctx.group_by_expressions:
            if g.is_identifier:
                group[g.identifier] = group.get(g.identifier, 0.0) + freq
        for a in ctx.aggregations:
            aggs.add(str(a))
    total = sum(float(q.get("freq", 1.0)) for q in queries) or 1.0
    return {
        "eq_filters": {c: w / total for c, w in eq.items()},
        "range_filters": {c: w / total for c, w in rng.items()},
        "group_by": {c: w / total for c, w in group.items()},
        "aggregations": sorted(aggs),
    }


def recommend(schema, queries: Optional[list[dict]] = None,
              query_stats: Optional[dict] = None,
              cardinalities: Optional[dict] = None,
              num_rows: int = 1_000_000, qps: float = 10.0) -> Recommendation:
    stats = query_stats if query_stats is not None else \
        analyze_queries(queries or [])
    cards = cardinalities or {}
    rec = Recommendation()
    idx = rec.indexing
    eq = stats.get("eq_filters", {})
    rng = stats.get("range_filters", {})
    group = stats.get("group_by", {})
    aggs = stats.get("aggregations", [])

    def card(col: str) -> int:
        return int(cards.get(col, num_rows // 10))

    dims = set(schema.dimension_names())

    # sorted column: the single dominant equality filter (reference
    # InvertedSortedIndexJointRule picks sorted for the top column)
    sorted_col = None
    if eq:
        top, w = max(eq.items(), key=lambda kv: kv[1])
        if w >= SORTED_MIN_WEIGHT and top in dims:
            sorted_col = top
            idx["sortedColumn"] = top
            rec.rationale.append(
                f"sortedColumn={top}: dominates equality filters "
                f"(weight {w:.2f}) — sorted runs give range-slice filtering")

    inverted, blooms, ranges = [], [], []
    for col, w in sorted(eq.items(), key=lambda kv: -kv[1]):
        if col == sorted_col or w < INVERTED_MIN_WEIGHT:
            continue
        c = card(col)
        if c <= num_rows * INVERTED_MAX_CARD_FRACTION:
            inverted.append(col)
            rec.rationale.append(
                f"invertedIndex on {col}: equality weight {w:.2f}, "
                f"cardinality {c} — postings beat scans")
        if c >= BLOOM_MIN_CARD:
            blooms.append(col)
            rec.rationale.append(
                f"bloomFilter on {col}: cardinality {c} — prunes segments "
                f"on point lookups")
    for col, w in sorted(rng.items(), key=lambda kv: -kv[1]):
        if w >= RANGE_MIN_WEIGHT:
            ranges.append(col)
            rec.rationale.append(
                f"rangeIndex on {col}: range-filter weight {w:.2f}")
    if inverted:
        idx["invertedIndexColumns"] = inverted
    if blooms:
        idx["bloomFilterColumns"] = blooms
    if ranges:
        idx["rangeIndexColumns"] = ranges

    # no-dictionary for mostly-unique strings never used in group-by/eq
    no_dict = []
    for col in dims:
        if col in eq or col in group or col == sorted_col:
            continue
        if card(col) >= num_rows * NO_DICT_CARD_FRACTION:
            no_dict.append(col)
            rec.rationale.append(
                f"noDictionary + LZ4 on {col}: ~unique values make the "
                f"dictionary pure overhead")
    if no_dict:
        idx["noDictionaryColumns"] = sorted(no_dict)
        idx["compressionConfigs"] = {c: "LZ4" for c in sorted(no_dict)}

    # star-tree for heavy repeated group-by over low-card dims
    st_dims = [c for c, w in sorted(group.items(), key=lambda kv: -kv[1])
               if w >= STAR_TREE_MIN_GROUP_WEIGHT and card(c) <= 10_000]
    if st_dims and aggs:
        idx["starTreeIndexConfigs"] = [{
            "dimensionsSplitOrder": st_dims,
            "functionColumnPairs": aggs,
        }]
        rec.rationale.append(
            f"star-tree over {st_dims}: group-by weight ≥ "
            f"{STAR_TREE_MIN_GROUP_WEIGHT} and qps {qps} amortize the "
            f"pre-aggregation")

    # partitioning: route point lookups to one server
    if eq:
        top, w = max(eq.items(), key=lambda kv: kv[1])
        if card(top) >= 100:
            rec.partition_column = top
            rec.rationale.append(
                f"partition on {top}: equality-heavy — the broker prunes "
                f"partitions per query")
    return rec
