"""Selection rows from a filtered doc mask.

The port of pinot_tpu/engine/selection.py: the device computes the filter
mask (ops/kernels.py selection mode); the host materializes the rows of
the matching docs. Per segment, without ORDER BY the first offset + limit
matching docs are kept; with ORDER BY the rows sort (Python's stable sort,
one pass per key from the last, `reverse=` for DESC) and trim to
offset + limit, a valid per-segment top-k that the broker re-sorts
(engine/reduce.py). Reference: SelectionOperatorService ordering rules.
"""

from __future__ import annotations

import numpy as np

from ..query.transforms import eval_expr_np
from .aggregation import MultistageRefusal
from .results import SelectionIntermediate


def selection_from_mask(query, segment, columns: list[str], mask: np.ndarray,
                        extra_exprs: dict | None = None,
                        evaluator=None) -> SelectionIntermediate:
    """Materialize the selected rows of a boolean doc mask (len num_docs).

    ``extra_exprs`` maps labels in ``columns`` to the transform
    expressions of select or ORDER BY items; each evaluates over the
    already filtered (and, without ORDER BY, already capped) doc ids only,
    by ``evaluator(expr, doc_ids)`` where given (the host engine's), else
    with numpy (`eval_at`)."""
    doc_ids = np.nonzero(mask)[0]
    total = int(doc_ids.shape[0])
    cap = query.offset + query.limit
    if not query.order_by_expressions:
        doc_ids = doc_ids[:cap]

    def column_values(c: str) -> np.ndarray:
        if extra_exprs is not None and c in extra_exprs:
            if evaluator is not None:
                return np.asarray(evaluator(extra_exprs[c], doc_ids))
            return eval_at(extra_exprs[c], segment, doc_ids)
        return segment.get_values_at(c, doc_ids)

    cols = [column_values(c) for c in columns]
    rows = list(zip(*[c.tolist() for c in cols])) if cols else []
    if query.order_by_expressions:
        idx = {c: i for i, c in enumerate(columns)}
        order = list(range(len(rows)))
        for ob in reversed(query.order_by_expressions):
            key = (ob.expression.identifier if ob.expression.is_identifier
                   else str(ob.expression))
            if key not in idx:  # the device planner refuses it earlier
                raise MultistageRefusal(
                    "selection ORDER BY must reference selected columns")
            arr = cols[idx[key]].tolist()
            order.sort(key=lambda i, _a=arr: _a[i], reverse=not ob.ascending)
        rows = [rows[i] for i in order[:cap]]
    return SelectionIntermediate(columns, rows, num_docs_scanned=total)


def eval_at(e, segment, doc_ids) -> np.ndarray:
    """A transform expression over a subset of a segment's docs, by the
    registry's numpy forms: the planner admits only what eval_expr_np
    evaluates (the host engine passes its own evaluator, which falls back
    to evaluating the whole column)."""
    out = np.asarray(eval_expr_np(
        e, lambda name: segment.get_values_at(name, doc_ids)))
    if out.ndim == 0:
        out = np.broadcast_to(out, (len(doc_ids),)).copy()
    return out


def selection_columns_for(query, segment) -> tuple[list[str], dict]:
    """(column labels including hidden ORDER BY-only transforms, label ->
    expression for the transform columns), so the intermediates carry
    every column the broker needs to re-sort; the reducer projects the
    hidden ones away after the final sort."""
    cols: list[str] = []
    exprs: dict = {}
    for e in query.select_expressions:
        if e.is_identifier:
            if e.identifier == "*":
                cols.extend(segment.columns())
            else:
                cols.append(e.identifier)
        else:
            label = str(e)
            cols.append(label)
            exprs[label] = e
    for ob in query.order_by_expressions:
        if not ob.expression.is_identifier:
            label = str(ob.expression)
            if label not in cols:
                cols.append(label)
                exprs[label] = ob.expression
    return cols, exprs
