"""Numpy evaluation of the transforms the slice lowers: arithmetic,
comparisons, logic, unary math and CAST.

The port of the generic evaluator of pinot_tpu/query/transforms.py
(`eval_expr_np`, `NP_BIN`, `NP_UN`, `np_cast`). The planner uses it to
evaluate an expression over a column's DICTIONARY (a derived group-by key
such as `d_year + 1`, or a predicate over such an expression), and the
selection path evaluates a transform select or ORDER BY item over the
matching docs' values; the per-row arithmetic of a device plan lowers to
ir.Bin/ir.Un nodes, not through here. Every
other transform function (date/time, string, JSON, geo, lookup) raises
UnsupportedQueryError.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

NP_BIN = {
    "plus": np.add, "minus": np.subtract, "times": np.multiply,
    "divide": lambda a, b: np.true_divide(a, b, where=np.asarray(b) != 0,
                                          out=np.full(np.broadcast(a, b).shape, np.nan)),
    "mod": np.mod, "pow": np.power, "power": np.power,
    "equals": lambda a, b: a == b, "notequals": lambda a, b: a != b,
    "lessthan": lambda a, b: a < b, "lessthanorequal": lambda a, b: a <= b,
    "greaterthan": lambda a, b: a > b, "greaterthanorequal": lambda a, b: a >= b,
    "and": np.logical_and, "or": np.logical_or,
    "least": np.minimum, "greatest": np.maximum,
}

NP_UN = {
    "neg": np.negative, "abs": np.abs, "not": np.logical_not, "exp": np.exp,
    "ln": np.log, "log10": np.log10, "log2": np.log2, "sqrt": np.sqrt,
    "ceiling": np.ceil, "ceil": np.ceil, "floor": np.floor, "sign": np.sign,
}


def np_cast(v, to: str):
    to = to.upper()
    v = np.asarray(v)
    if to == "INT":
        return v.astype(np.float64).astype(np.int32) if v.dtype.kind == "f" else v.astype(np.int32)
    if to in ("LONG", "TIMESTAMP"):
        return v.astype(np.float64).astype(np.int64) if v.dtype.kind == "f" else v.astype(np.int64)
    if to == "FLOAT":
        return v.astype(np.float32)
    if to == "DOUBLE":
        return v.astype(np.float64)
    if to == "BOOLEAN":
        return v.astype(bool)
    from ..engine.aggregation import UnsupportedQueryError

    raise UnsupportedQueryError(f"CAST to {to}")


def eval_expr_np(e, resolve: Callable[[str], object]):
    """Evaluate an ExpressionContext with numpy semantics. ``resolve(name)``
    returns the values for an identifier (ndarray or scalar)."""
    from ..engine.aggregation import UnsupportedQueryError

    if e.is_literal:
        v = e.literal
        return int(v) if isinstance(v, bool) else v
    if e.is_identifier:
        return resolve(e.identifier)
    fn = e.function
    name, args = fn.name, fn.arguments
    if name in NP_BIN:
        return NP_BIN[name](eval_expr_np(args[0], resolve), eval_expr_np(args[1], resolve))
    if name in NP_UN:
        return NP_UN[name](eval_expr_np(args[0], resolve))
    if name == "cast":
        return np_cast(eval_expr_np(args[0], resolve), str(args[1].literal))
    if name == "case":
        out = eval_expr_np(args[-1], resolve)
        for i in range(len(args) - 3, -1, -2):
            cond = np.asarray(eval_expr_np(args[i], resolve)).astype(bool)
            out = np.where(cond, eval_expr_np(args[i + 1], resolve), out)
        return out
    raise UnsupportedQueryError(f"transform function {name}")


def np_evaluable(e) -> bool:
    """Whether eval_expr_np evaluates `e` (every function in it is one of
    the lowered transforms)."""
    if not e.is_function:
        return True
    name = e.function.name
    if name not in NP_BIN and name not in NP_UN \
            and name not in ("cast", "case"):
        return False
    return all(np_evaluable(a) for a in e.function.arguments)
