"""Server-side segment pruning: skip segments that cannot match the filter.

The port of pinot_tpu/engine/pruner.py (`SegmentPrunerService`; reference
pinot-core/.../query/pruner/: ColumnValueSegmentPruner on min/max and
partition metadata, BloomFilterSegmentPruner). It runs before planning, so
a pruned segment costs no plan, no dispatch and no fetch.

Conservative: a segment is pruned only when it PROVABLY holds no matching
row. Any uncertainty (expressions, NOT, incomparable types, missing
metadata) keeps it.
"""

from __future__ import annotations

from ..query.context import QueryContext
from ..query.filter import FilterContext, FilterNodeType, Predicate, PredicateType
from ..segment.loader import ImmutableSegment
from ..spi.partition import get_partition_function


class SegmentPrunerService:
    def prune(self, query: QueryContext, segments: list[ImmutableSegment]):
        """-> (kept_segments, num_pruned)."""
        f = query.filter
        if f is None:
            return list(segments), 0
        kept = [s for s in segments if self._may_match(f, s)]
        return kept, len(segments) - len(kept)

    def _may_match(self, f: FilterContext, seg: ImmutableSegment) -> bool:
        if f.type == FilterNodeType.AND:
            return all(self._may_match(c, seg) for c in f.children)
        if f.type == FilterNodeType.OR:
            return any(self._may_match(c, seg) for c in f.children)
        if f.type == FilterNodeType.NOT:
            return True  # NOT(no match) proves nothing cheaply
        if f.type == FilterNodeType.CONSTANT:
            return f.constant_value
        return self._predicate_may_match(f.predicate, seg)

    def _predicate_may_match(self, p: Predicate, seg: ImmutableSegment) -> bool:
        lhs = p.lhs
        if not lhs.is_identifier or not seg.has_column(lhs.identifier):
            return True
        col = lhs.identifier
        m = seg.column_metadata(col)
        lo, hi = m.min_value, m.max_value
        if p.type == PredicateType.EQ:
            v = p.values[0]
            if _outside(v, lo, hi) or _partition_excludes(m, v):
                return False
            bf = seg.get_bloom_filter(col)
            return bf is None or bf.might_contain(v)
        if p.type == PredicateType.IN:
            bf = seg.get_bloom_filter(col)
            for v in p.values:
                if _outside(v, lo, hi) or _partition_excludes(m, v):
                    continue
                if bf is not None and not bf.might_contain(v):
                    continue
                return True
            return False
        if p.type == PredicateType.RANGE:
            if lo is None or hi is None:
                return True
            try:
                if p.lower is not None:
                    if hi < p.lower or (hi == p.lower and not p.lower_inclusive):
                        return False
                if p.upper is not None:
                    if lo > p.upper or (lo == p.upper and not p.upper_inclusive):
                        return False
            except TypeError:
                return True  # incomparable types: keep
            return True
        return True


def _partition_excludes(m, v) -> bool:
    """True when stamped partition metadata PROVES the value's partition is
    absent from this segment."""
    if not m.partition_function or m.partitions is None \
            or m.num_partitions is None:
        return False
    try:
        fn = get_partition_function(m.partition_function, m.num_partitions)
        return fn.partition(v) not in m.partitions
    except (ValueError, TypeError):
        return False  # unknown function or unpartitionable value: keep


def _outside(v, lo, hi) -> bool:
    if lo is None or hi is None:
        return False
    try:
        return v < lo or v > hi
    except TypeError:
        return False
