"""Filter optimizer: canonicalize, merge, and fold the filter tree.

Reference: pinot-core/src/main/java/org/apache/pinot/core/query/optimizer/
QueryOptimizer.java and its filter passes —
FlattenAndOrFilterOptimizer, MergeEqInFilterOptimizer (EQ/IN union under OR,
intersection under AND), MergeRangeFilterOptimizer (range intersection under
AND), and constant folding. NOT elimination (De Morgan + predicate
inversion) plays the role Calcite's rewrites play upstream of the reference.

Applied once per query on the server execution path (prune_segments), so
the single-stage engine, the cluster scatter path, and MSE leaf pushdowns
all see optimized trees. Every pass is semantics-preserving; passes that
need value comparisons skip groups with incomparable mixed types rather
than guess.
"""

from __future__ import annotations

from typing import Optional

from .filter import FilterContext, FilterNodeType, Predicate, PredicateType

_P = PredicateType
_N = FilterNodeType

_INVERTIBLE = {
    _P.EQ: _P.NOT_EQ, _P.NOT_EQ: _P.EQ,
    _P.IN: _P.NOT_IN, _P.NOT_IN: _P.IN,
    _P.IS_NULL: _P.IS_NOT_NULL, _P.IS_NOT_NULL: _P.IS_NULL,
}


def optimize_filter(f: Optional[FilterContext]) -> Optional[FilterContext]:
    if f is None:
        return None
    f = _push_not(f, negate=False)
    f = _merge(f)
    return f


# -- NOT elimination ----------------------------------------------------------


def _push_not(f: FilterContext, negate: bool) -> FilterContext:
    """De Morgan + predicate inversion; NOT survives only over predicates
    with no natural inverse (RANGE, LIKE, text/json/vector)."""
    if f.type == _N.NOT:
        return _push_not(f.children[0], not negate)
    if f.type == _N.AND:
        kids = tuple(_push_not(c, negate) for c in f.children)
        return FilterContext.or_(*kids) if negate else FilterContext.and_(*kids)
    if f.type == _N.OR:
        kids = tuple(_push_not(c, negate) for c in f.children)
        return FilterContext.and_(*kids) if negate else FilterContext.or_(*kids)
    if f.type == _N.CONSTANT:
        return FilterContext.constant(f.constant_value != negate)
    # PREDICATE
    if not negate:
        return f
    p = f.predicate
    inv = _INVERTIBLE.get(p.type)
    if inv is not None:
        return FilterContext.pred(Predicate(
            inv, p.lhs, values=p.values, lower=p.lower, upper=p.upper,
            lower_inclusive=p.lower_inclusive, upper_inclusive=p.upper_inclusive))
    return FilterContext.not_(f)


# -- merge + fold (bottom-up) -------------------------------------------------


def _merge(f: FilterContext) -> FilterContext:
    if f.type == _N.AND:
        kids = [_merge(c) for c in f.children]
        return _merge_and(kids)
    if f.type == _N.OR:
        kids = [_merge(c) for c in f.children]
        return _merge_or(kids)
    if f.type == _N.NOT:
        child = _merge(f.children[0])
        if child.type == _N.CONSTANT:
            return FilterContext.constant(not child.constant_value)
        return FilterContext.not_(child)
    return f


def _comparable(values) -> bool:
    try:
        sorted(values)
        return True
    except TypeError:
        return False


def _key(p: Predicate) -> str:
    return str(p.lhs)


def _merge_and(kids: list[FilterContext]) -> FilterContext:
    out: list[FilterContext] = []
    eq_in: dict[str, set] = {}       # lhs → allowed-value intersection
    eq_order: dict[str, Predicate] = {}
    not_in: dict[str, set] = {}      # lhs → excluded-value union
    not_order: dict[str, Predicate] = {}
    ranges: dict[str, list[Predicate]] = {}  # unmergeable ones stay separate

    for c in kids:
        if c.type == _N.CONSTANT:
            if not c.constant_value:
                return FilterContext.constant(False)
            continue  # TRUE contributes nothing
        if c.type != _N.PREDICATE:
            out.append(c)
            continue
        p = c.predicate
        k = _key(p)
        if p.type in (_P.EQ, _P.IN):
            vals = set(p.values)
            eq_in[k] = eq_in[k] & vals if k in eq_in else vals
            eq_order.setdefault(k, p)
        elif p.type in (_P.NOT_EQ, _P.NOT_IN):
            not_in.setdefault(k, set()).update(p.values)
            not_order.setdefault(k, p)
        elif p.type == _P.RANGE:
            group = ranges.setdefault(k, [])
            for i, existing in enumerate(group):
                try:
                    merged = _intersect_ranges(existing, p)
                except TypeError:
                    continue  # incomparable bound types: keep both
                if merged is None:
                    return FilterContext.constant(False)
                group[i] = merged
                break
            else:
                group.append(p)
        else:
            out.append(c)

    # EQ/IN ∩ RANGE on the same column: filter allowed values through the
    # range — only when every value compares against the bounds
    for k in list(eq_in):
        for r in list(ranges.get(k, [])):
            try:
                vals = {v for v in eq_in[k] if _in_range(v, r)}
            except TypeError:
                continue  # incomparable: keep the range as its own predicate
            eq_in[k] = vals
            ranges[k].remove(r)
    # EQ/IN minus NOT_IN exclusions on the same column
    for k in list(eq_in):
        if k in not_in:
            eq_in[k] = eq_in[k] - not_in.pop(k)

    for k, vals in eq_in.items():
        if not vals:
            return FilterContext.constant(False)
        out.append(_values_pred(eq_order[k], vals, negated=False))
    for k, vals in not_in.items():
        out.append(_values_pred(not_order[k], vals, negated=True))
    out.extend(FilterContext.pred(r) for group in ranges.values()
               for r in group)

    if not out:
        return FilterContext.constant(True)
    if len(out) == 1:
        return out[0]
    return FilterContext.and_(*out)


def _merge_or(kids: list[FilterContext]) -> FilterContext:
    out: list[FilterContext] = []
    eq_in: dict[str, set] = {}  # lhs → allowed-value union
    eq_order: dict[str, Predicate] = {}

    for c in kids:
        if c.type == _N.CONSTANT:
            if c.constant_value:
                return FilterContext.constant(True)
            continue  # FALSE contributes nothing
        if c.type == _N.PREDICATE and c.predicate.type in (_P.EQ, _P.IN):
            p = c.predicate
            k = _key(p)
            eq_in.setdefault(k, set()).update(p.values)
            eq_order.setdefault(k, p)
        else:
            out.append(c)

    for k, vals in eq_in.items():
        out.append(_values_pred(eq_order[k], vals, negated=False))

    if not out:
        return FilterContext.constant(False)
    if len(out) == 1:
        return out[0]
    return FilterContext.or_(*out)


def _values_pred(template: Predicate, vals: set, negated: bool) -> FilterContext:
    ordered = tuple(sorted(vals)) if _comparable(vals) else tuple(vals)
    if len(ordered) == 1:
        t = _P.NOT_EQ if negated else _P.EQ
    else:
        t = _P.NOT_IN if negated else _P.IN
    return FilterContext.pred(Predicate(t, template.lhs, values=ordered))


def _intersect_ranges(a: Predicate, b: Predicate) -> Optional[Predicate]:
    """[a] ∩ [b], or None when provably empty. Raises TypeError on
    incomparable bound types — the caller keeps both ranges separate."""
    lower, lower_inc = _max_bound(
        (a.lower, a.lower_inclusive), (b.lower, b.lower_inclusive))
    upper, upper_inc = _min_bound(
        (a.upper, a.upper_inclusive), (b.upper, b.upper_inclusive))
    if lower is not None and upper is not None:
        if lower > upper:
            return None
        if lower == upper and not (lower_inc and upper_inc):
            return None
    return Predicate(_P.RANGE, a.lhs, lower=lower, upper=upper,
                     lower_inclusive=lower_inc, upper_inclusive=upper_inc)


def _max_bound(x, y):
    (xv, xi), (yv, yi) = x, y
    if xv is None:
        return yv, yi
    if yv is None:
        return xv, xi
    if xv > yv:
        return xv, xi
    if yv > xv:
        return yv, yi
    return xv, xi and yi


def _min_bound(x, y):
    (xv, xi), (yv, yi) = x, y
    if xv is None:
        return yv, yi
    if yv is None:
        return xv, xi
    if xv < yv:
        return xv, xi
    if yv < xv:
        return yv, yi
    return xv, xi and yi


def _in_range(v, r: Predicate) -> bool:
    """Raises TypeError on incomparable types (caller keeps the range)."""
    if r.lower is not None:
        if v < r.lower or (v == r.lower and not r.lower_inclusive):
            return False
    if r.upper is not None:
        if v > r.upper or (v == r.upper and not r.upper_inclusive):
            return False
    return True
