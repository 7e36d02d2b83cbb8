"""Gapfill post-processing for time-bucketed group-by results.

The port of pinot_tpu/engine/gapfill.py (reference: BaseGapfillProcessor /
GapfillProcessor, pinot-core/.../query/reduce/BaseGapfillProcessor.java). A
gapfill query names a time-bucket expression plus [start, end) and the
bucket width; the reducer inserts a row for every missing (series, bucket)
pair, with per-column fill strategies:

    SELECT gapfill(<bucket_expr>, <startMs>, <endMs>, <bucketMs>), key...,
           fill(SUM(m), 'FILL_PREVIOUS_VALUE') ...
    GROUP BY gapfill(<bucket_expr>, ...), key...

``gapfill`` and ``fill`` evaluate as identity transforms during execution
(query/transforms.py); the bucketing itself is the user's expression. Series
keys default to every non-time group-by output (the reference's
TIMESERIESON). Fill modes: FILL_PREVIOUS_VALUE (last seen value in the
series, scanning buckets ascending) and FILL_DEFAULT_VALUE (type default);
columns without a FILL wrapper fill with null. Rows outside [start, end) are
dropped; output is time-major (bucket asc, then series), offset/limit apply
after filling (engine/reduce.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from ..query.context import QueryContext
from .results import DataSchema, ResultTable

FILL_PREVIOUS = "FILL_PREVIOUS_VALUE"
FILL_DEFAULT = "FILL_DEFAULT_VALUE"

_TYPE_DEFAULTS = {"INT": 0, "LONG": 0, "FLOAT": 0.0, "DOUBLE": 0.0,
                  "BOOLEAN": False, "TIMESTAMP": 0}


@dataclass
class GapfillSpec:
    time_idx: int
    start: int
    end: int
    bucket: int
    fill_modes: dict = field(default_factory=dict)  # select idx → mode
    series_idxs: list = field(default_factory=list)
    value_idxs: list = field(default_factory=list)


def extract_gapfill(query: QueryContext) -> Optional[GapfillSpec]:
    time_idx = None
    spec_args = None
    fill_modes: dict[int, str] = {}
    for i, se in enumerate(query.select_expressions):
        if se.is_function and se.function.name == "gapfill":
            if len(se.function.arguments) < 4:
                continue
            time_idx = i
            spec_args = se.function.arguments[1:4]
        elif se.is_function and se.function.name == "fill":
            args = se.function.arguments
            if len(args) >= 2 and args[1].is_literal:
                fill_modes[i] = str(args[1].literal).upper()
    if time_idx is None:
        return None
    try:
        start, end, bucket = (int(a.literal) for a in spec_args)
    except (TypeError, ValueError):
        return None
    if bucket <= 0 or end < start:
        return None
    group_strs = {str(g) for g in query.group_by_expressions}
    series, values = [], []
    for i, se in enumerate(query.select_expressions):
        if i == time_idx:
            continue
        (series if str(se) in group_strs else values).append(i)
    return GapfillSpec(time_idx, start, end, bucket, fill_modes, series, values)


MAX_GAPFILL_BUCKETS = 200_000
MAX_GAPFILL_ROWS = 2_000_000


def apply_gapfill(result: ResultTable, spec: GapfillSpec) -> ResultTable:
    n_cols = len(result.schema.column_names)
    num_buckets = (spec.end - spec.start + spec.bucket - 1) // spec.bucket
    if num_buckets > MAX_GAPFILL_BUCKETS:
        raise ValueError(
            f"gapfill would materialize {num_buckets} buckets "
            f"(limit {MAX_GAPFILL_BUCKETS}); widen the bucket or narrow "
            f"[start, end)")
    buckets = list(range(spec.start, spec.end, spec.bucket))
    # (series key tuple) → {bucket: row}
    by_series: dict[tuple, dict[int, list]] = {}
    series_order: list[tuple] = []
    for row in result.rows:
        t = row[spec.time_idx]
        if t is None:
            continue
        t = int(t)
        if not spec.start <= t < spec.end:
            continue
        key = tuple(row[i] for i in spec.series_idxs)
        if key not in by_series:
            by_series[key] = {}
            series_order.append(key)
        # snap to the bucket grid so observed and filled rows share the same
        # time axis; two result rows landing in one (series, bucket) would
        # mean the time expression is finer than the bucket — aggregates of
        # sub-buckets cannot be merged post-hoc, so reject loudly instead of
        # silently dropping rows
        b = spec.start + ((t - spec.start) // spec.bucket) * spec.bucket
        if b in by_series[key]:
            raise ValueError(
                "gapfill time expression produces multiple rows per bucket "
                f"(series {key}, bucket {b}); bucket-align the group-by "
                "time expression to the gapfill bucket width")
        if t != b:
            row = list(row)
            row[spec.time_idx] = b
        by_series[key][b] = row
    if num_buckets * max(1, len(series_order)) > MAX_GAPFILL_ROWS:
        raise ValueError(
            f"gapfill would emit {num_buckets * len(series_order)} rows "
            f"(limit {MAX_GAPFILL_ROWS})")

    types = result.schema.column_types
    out: list[list] = []
    for key in series_order:
        seen = by_series[key]
        prev: dict[int, object] = {}
        for b in buckets:
            row = seen.get(b)
            if row is not None:
                for vi in spec.value_idxs:
                    prev[vi] = row[vi]
                out.append(row)
                continue
            filled = [None] * n_cols
            filled[spec.time_idx] = b
            for si, kv in zip(spec.series_idxs, key):
                filled[si] = kv
            for vi in spec.value_idxs:
                mode = spec.fill_modes.get(vi)
                if mode == FILL_PREVIOUS and vi in prev:
                    filled[vi] = prev[vi]
                elif mode in (FILL_PREVIOUS, FILL_DEFAULT):
                    filled[vi] = _TYPE_DEFAULTS.get(types[vi])
                # no FILL wrapper → null
            out.append(filled)
    # time-major: bucket asc, then series in first-seen order
    series_rank = {k: i for i, k in enumerate(series_order)}
    out.sort(key=lambda r: (r[spec.time_idx],
                            series_rank[tuple(r[i] for i in spec.series_idxs)]))
    return ResultTable(DataSchema(result.schema.column_names, types), out)
