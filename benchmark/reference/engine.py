"""A plain evaluator of one query's declarative spec over reference columns.

The traffic files carry, beside each SQL template, the same query as data
(`reference`): a conjunction of predicates, the group-by columns, the
select list in SQL order and the ORDER BY. This module answers it over the
columns a dataset's reference module builds (plain torch tensors: values
for integer columns, codes into a list of strings for string columns),
with nothing of the program: the program is judged only by its answers.

Sums are exact: integer expressions in int64, accumulated per group with
index_add_, a row block at a time, and refused where the largest group
times the largest value could leave int64. `precision="float32"` evaluates
the same sums in float32 instead: the lower-precision control that the
comparison has to fail.
"""

from __future__ import annotations

import torch

BLOCK_ROWS = 1 << 25
_OPS = {"=": torch.eq, "<": torch.lt, "<=": torch.le, ">": torch.gt,
        ">=": torch.ge}


class Source:
    """A reference table: `n` rows and `get(name)` -> (tensor, domain),
    domain a list of strings for a coded string column, else None.
    Columns are built on first use by `builders[name]()` and kept."""

    def __init__(self, n: int, builders: dict):
        self.n = n
        self._builders = builders
        self._cols: dict = {}

    def get(self, name: str):
        if name not in self._cols:
            out = self._builders[name]()
            self._cols[name] = out if isinstance(out, tuple) else (out, None)
        return self._cols[name]


def _string_lut(domain: list, pred) -> torch.Tensor:
    return torch.tensor([bool(pred(v)) for v in domain], dtype=torch.bool)


def _predicate(src: Source, p: list, sl: slice) -> torch.Tensor:
    if p[0] == "or":
        out = _predicate(src, p[1], sl)
        for q in p[2:]:
            out = out | _predicate(src, q, sl)
        return out
    col, op, *args = p
    t, domain = src.get(col)
    t = t[sl]
    if domain is not None:
        if op == "between":
            test = lambda v: args[0] <= v <= args[1]  # noqa: E731
        elif op == "in":
            test = lambda v: v in args[0]  # noqa: E731
        else:
            test = {"=": lambda v: v == args[0], "<": lambda v: v < args[0],
                    "<=": lambda v: v <= args[0], ">": lambda v: v > args[0],
                    ">=": lambda v: v >= args[0]}[op]
        key = ("lut", col, op, repr(args))
        if key not in src._cols:
            src._cols[key] = _string_lut(domain, test).to(t.device)
        return src._cols[key][t.long()]
    if op == "between":
        return (t >= args[0]) & (t <= args[1])
    if op == "in":
        out = torch.zeros_like(t, dtype=torch.bool)
        for v in args[0]:
            out |= t == v
        return out
    return _OPS[op](t, args[0])


def _expr(src: Source, e, sl: slice) -> torch.Tensor:
    if isinstance(e, str):
        t, domain = src.get(e)
        if domain is not None:
            raise ValueError(f"arithmetic over the string column {e}")
        return t[sl].to(torch.int64)
    if isinstance(e, (int, float)):
        return torch.tensor(e, dtype=torch.int64)
    op, a, b = e
    x, y = _expr(src, a, sl), _expr(src, b, sl)
    return {"mul": torch.mul, "sub": torch.sub, "add": torch.add}[op](x, y)


def _key_domain(src: Source, col: str):
    """(index of each row's key value, list of key values) of a group-by
    column: a string column's codes and domain, or an integer column's
    sorted distinct values (kept on the source)."""
    t, domain = src.get(col)
    if domain is not None:
        return t, list(domain)
    key = ("distinct", col)
    if key not in src._cols:
        src._cols[key] = [int(v) for v in torch.unique(t).tolist()]
    return None, src._cols[key]


def evaluate(src: Source, spec: dict, precision: str = "exact") -> list:
    """The answer rows of `spec` over `src`, each in SQL select order:
    group keys as Python values, SUMs as Python ints (float32 under
    `precision="float32"`), AVGs as floats, COUNTs as ints; one row for an
    aggregation without GROUP BY, one row per non-empty group otherwise,
    in the ORDER BY's order."""
    keys = spec.get("group_by", [])
    aggs = [s for s in spec["select"] if not isinstance(s, str)]
    domains, strides, num_groups = [], [], 1
    for col in reversed(keys):
        idx, dom = _key_domain(src, col)
        domains.insert(0, (col, idx, dom))
        strides.insert(0, num_groups)
        num_groups *= len(dom)
    acc_dtype = torch.float32 if precision == "float32" else torch.int64
    # each group's adds spread over `spread` slots, summed at the end, so
    # a few groups do not serialise every row on one atomic address
    spread = max(1, min(1024, (1 << 22) // num_groups))
    slots = num_groups * spread
    counts = sums = None
    vmax = [0] * len(aggs)
    for start in range(0, src.n, BLOCK_ROWS):
        sl = slice(start, min(src.n, start + BLOCK_ROWS))
        mask = None
        for p in spec.get("where", []):
            m = _predicate(src, p, sl)
            mask = m if mask is None else mask & m
        if mask is None:
            raise ValueError("a query without a WHERE clause")
        gid = torch.zeros(int(mask.sum()), dtype=torch.int64,
                          device=mask.device)
        for (col, idx, dom), stride in zip(domains, strides):
            t = src.get(col)[0][sl][mask]
            if idx is None:
                vals = torch.tensor(dom, dtype=t.dtype, device=t.device)
                t = torch.searchsorted(vals, t)
            gid += t.to(torch.int64) * stride
        slot = gid * spread + torch.arange(
            gid.numel(), device=gid.device) % spread
        cnt = torch.bincount(slot, minlength=slots)
        counts = cnt if counts is None else counts + cnt
        if sums is None:
            sums = [torch.zeros(slots, dtype=acc_dtype, device=mask.device)
                    for _ in aggs]
        for k, agg in enumerate(aggs):
            if agg[0] == "count":
                continue
            v = _expr(src, agg[1], sl).expand(mask.shape)[mask]
            if v.numel():
                vmax[k] = max(vmax[k], int(v.abs().max()))
            sums[k].index_add_(0, slot, v.to(acc_dtype))
    counts = counts.view(num_groups, spread).sum(1)
    sums = [s.view(num_groups, spread).sum(1) for s in sums]
    if acc_dtype == torch.int64 and counts.numel() \
            and int(counts.max()) * max(vmax, default=0) >= 1 << 63:
        raise OverflowError("a group's sum could leave int64")
    if keys:
        occ = torch.nonzero(counts).flatten()
        occupied = occ.tolist()
    else:
        occ, occupied = torch.zeros(1, dtype=torch.int64,
                                    device=counts.device), [0]
    counts = dict(zip(occupied, counts[occ].tolist()))
    sums = [dict(zip(occupied, s[occ].tolist())) for s in sums]
    rows = []
    for g in occupied:
        key_vals = {}
        rest = g
        for (col, _idx, dom), stride in zip(domains, strides):
            key_vals[col], rest = dom[rest // stride], rest % stride
        row, k = [], 0
        for item in spec["select"]:
            if isinstance(item, str):
                row.append(key_vals[item])
                continue
            agg = aggs[k]
            if agg[0] == "count":
                row.append(counts[g])
            elif agg[0] == "sum":
                row.append(sums[k][g])
            elif agg[0] == "avg":
                row.append(sums[k][g] / counts[g] if counts[g] else None)
            else:
                raise ValueError(f"aggregation {agg[0]}")
            k += 1
        rows.append(row)
    if spec.get("order_by"):
        rows.sort(key=lambda r: [-r[i] if d == "desc" else r[i]
                                 for i, d in spec["order_by"]])
    return rows
