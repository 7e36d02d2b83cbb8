"""Index-backed predicates evaluated on the host into doc masks.

The port's copy of pinot_tpu/engine/host_executor.py's `eval_json_match`,
`eval_map_index_predicate` and `eval_host_mask`, shared by the device
planner and the host engine (engine/host_executor.py). JSON_MATCH,
TEXT_MATCH and VECTOR_SIMILARITY have no vector form over a column plane,
and a `mapvalue(col, 'key')` predicate over a map index is one compare of
a dense host plane: the planner (engine/plan.py) evaluates each on the
host through the segment's index into a boolean doc mask and ships it
into the device program as an ir.MaskParam plane, as the JAX package's
device planner does (reference: index-backed filter operators,
TextMatchFilterOperator, VectorSimilarityFilterOperator,
JsonMatchFilterOperator).
"""

from __future__ import annotations

import numpy as np

from ..query.filter import Predicate, PredicateType
from ..segment.map_index import map_value_args
from .aggregation import UnsupportedQueryError


def eval_json_match(p: Predicate, segment) -> np.ndarray:
    """JSON_MATCH(col, 'filter') -> doc mask via the column's JSON index;
    builds a transient index when none was persisted. A consuming segment
    (or a star-tree view) has none and builds none: that raises (the JAX
    package fails there too)."""
    col = p.lhs.identifier
    if col is None or not segment.has_column(col):
        raise UnsupportedQueryError(f"JSON_MATCH needs a column: {p.lhs}")
    idx = segment.get_json_index(col, or_build=True)
    if idx is None:
        raise UnsupportedQueryError(
            f"JSON_MATCH on consuming segment column {col}")
    return idx.mask_match(str(p.values[0]), segment.num_docs)


def eval_map_index_predicate(p: Predicate, segment):
    """Predicate over mapvalue(col, 'key') answered from a map index's
    dense planes (segment/map_index.py): one vector compare instead of a
    row-wise JSON parse per doc. None when no index or key applies (the
    row-wise transform then answers exactly). Absent keys follow the
    row-wise None semantics: they fail EQ/IN/RANGE and pass
    NOT_EQ/NOT_IN."""
    args = map_value_args(p.lhs)
    if args is None:
        return None
    col, key, default = args
    if default is not None or not hasattr(segment, "get_map_index") \
            or not segment.has_column(col):
        return None
    idx = segment.get_map_index(col)
    if idx is None or not idx.has_key(key):
        return None
    lits = list(p.values or ())
    lits += [x for x in (p.lower, p.upper) if x is not None]
    try:
        lits = [float(x) for x in lits]
    except (TypeError, ValueError):
        return None  # non-numeric comparison: dense planes are numeric
    v, present = idx.value_plane(key)
    if p.type in (PredicateType.EQ, PredicateType.IN):
        m = np.zeros(len(v), dtype=bool)
        for x in lits:
            m |= v == x
        return m & present
    if p.type in (PredicateType.NOT_EQ, PredicateType.NOT_IN):
        m = np.zeros(len(v), dtype=bool)
        for x in lits:
            m |= v == x
        return ~(m & present)
    if p.type == PredicateType.RANGE:
        m = np.ones(len(v), dtype=bool)
        if p.lower is not None:
            lo = float(p.lower)
            m &= (v >= lo) if p.lower_inclusive else (v > lo)
        if p.upper is not None:
            hi = float(p.upper)
            m &= (v <= hi) if p.upper_inclusive else (v < hi)
        return m & present
    return None


def eval_host_mask(p: Predicate, segment) -> np.ndarray:
    """JSON_MATCH, TEXT_MATCH or VECTOR_SIMILARITY -> boolean doc plane;
    raises on a segment without the index (a consuming segment)."""
    if p.type == PredicateType.JSON_MATCH:
        return eval_json_match(p, segment)
    col = p.lhs.identifier
    if col is None or not segment.has_column(col):
        raise UnsupportedQueryError(f"{p.type.value} needs a column: {p.lhs}")
    if p.type == PredicateType.TEXT_MATCH:
        idx = segment.get_text_index(col, or_build=True)
        if idx is None:
            raise UnsupportedQueryError(
                f"TEXT_MATCH on consuming segment column {col}")
        return idx.mask_match(str(p.values[0]), segment.num_docs)
    if p.type == PredicateType.VECTOR_SIMILARITY:
        idx = segment.get_vector_index(col, or_build=True)
        if idx is None:
            raise UnsupportedQueryError(
                f"VECTOR_SIMILARITY on consuming segment column {col}")
        vec, k = p.values
        return idx.mask_top_k(np.asarray(vec, dtype=np.float32), int(k),
                              segment.num_docs)
    raise UnsupportedQueryError(f"host mask predicate {p.type}")
