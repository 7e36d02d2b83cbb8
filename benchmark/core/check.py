"""The comparison that decides `correct`.

Every query answered in the window is compared with the reference's answer
to the same statement (reference/engine.py over the same generated data):

- key_mismatches: answers whose rows do not carry the reference's group
  keys (a row missing, extra or repeated), or whose order breaks their
  ORDER BY; exact, limit 0.
- max_rel_gap: the widest gap of an aggregate over every answer, as a
  share of the reference's value (or of 1 where that is smaller).
- errors: queries that raised, answered with exceptions, or never came.

The limits are the configuration's (`limits` in its file), each set in
PERF.md from the program's readings over many seeds and the control's.
"""

from __future__ import annotations

import math


def _key_positions(spec: dict) -> list:
    return [i for i, s in enumerate(spec["select"]) if isinstance(s, str)]


def _canon(v):
    if isinstance(v, float) and v.is_integer():
        return int(v)
    return v


def _ordered(rows: list, order_by: list) -> bool:
    """Whether `rows` keep their ORDER BY (ties in any order)."""
    def key(row):
        out = []
        for i, direction in order_by:
            v = row[i]
            out.append(-v if direction == "desc" else v)
        return out
    return all(key(a) <= key(b) for a, b in zip(rows, rows[1:]))


def rel_gap(got, want) -> float:
    if got is None or want is None:
        return 0.0 if got is None and want is None else math.inf
    got = float(got)
    if not math.isfinite(got):
        return math.inf
    return abs(got - want) / max(abs(want), 1.0)


def compare(spec: dict, got: list, want: list) -> tuple:
    """(keys match and order kept, widest relative gap of an aggregate)
    of one answer `got` against the reference's `want`."""
    keys = _key_positions(spec)
    aggs = [i for i in range(len(spec["select"])) if i not in keys]
    got_by = {}
    for row in got:
        if len(row) != len(spec["select"]):
            return False, math.inf
        got_by[tuple(_canon(row[i]) for i in keys)] = row
    want_by = {tuple(row[i] for i in keys): row for row in want}
    if len(got_by) != len(got) or got_by.keys() != want_by.keys():
        return False, math.inf
    if spec.get("order_by") and not _ordered(got, spec["order_by"]):
        return False, math.inf
    gap = 0.0
    for k, row in want_by.items():
        for i in aggs:
            gap = max(gap, rel_gap(got_by[k][i], row[i]))
    return True, gap


def judge(records: list, answer, limits: dict) -> dict:
    """Compare every record (harness.Record) with `answer(query)`, the
    reference's rows; returns the numbers compared, each with its limit,
    the failed count and `correct`."""
    errors = mismatches = over = 0
    widest = 0.0
    for rec in records:
        if rec.error is not None or rec.rows is None:
            errors += 1
            continue
        ok, gap = compare(rec.query.spec, rec.rows, answer(rec.query))
        if not ok:
            mismatches += 1
            continue
        widest = max(widest, gap)
        if gap > limits["max_rel_gap"]:
            over += 1
    numbers = {
        "key_mismatches": {"value": mismatches, "limit": 0},
        "max_rel_gap": {"value": widest, "limit": limits["max_rel_gap"]},
        "errors": {"value": errors, "limit": 0},
    }
    correct = (mismatches == 0 and errors == 0
               and widest <= limits["max_rel_gap"] and bool(records))
    return {"numbers": numbers, "failed": errors + mismatches + over,
            "correct": correct}
