"""Timeseries planner + executor with an m3ql-style pipe language.

Reference analogue: TimeSeriesLogicalPlanner (pinot-timeseries/
pinot-timeseries-spi/.../TimeSeriesLogicalPlanner.java), the m3ql language
plugin (pinot-plugins/pinot-timeseries-lang/pinot-timeseries-m3ql/ —
pipe-separated stages), broker TimeSeriesRequestHandler, and the leaf
TimeSeriesPlanNode that runs on the V1 engine
(pinot-core/.../plan/TimeSeriesPlanNode.java).

Language (m3ql-shaped):

    fetch table=t value=col [filter="sql bool expr"] [time_col=ts]
      | sum [tag1,tag2]        (also min/max/avg/count)
      | rate | scale 2.5 | shift 1 | abs | transform_null 0
      | moving_avg 3 | keep_last_value | topk 5 | bottomk 5

The fetch stage compiles to a single-stage GROUP BY over
(bucket_index, tags...) — the device kernel does the heavy lifting; every
later stage is vectorized numpy over dense (num_series, num_buckets)
planes. The port's copy of pinot_tpu/timeseries/engine.py: the fetch runs
on the port's single-stage engine, which raises where the reference's
returns its exceptions, so a refused fetch (a bucket over a raw time
column, which neither package's device planner lowers) or an unknown
table raises TimeSeriesQueryError here as there under backend="tpu".
"""

from __future__ import annotations

import shlex
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ..engine.aggregation import UnsupportedQueryError
from ..query.context import QueryContext
from ..query.expressions import ExpressionContext
from ..query.parser.sql import SqlParseError, parse_filter_expression
from ..query.filter import FilterContext, Predicate, PredicateType
from .series import TimeBuckets, TimeSeries, TimeSeriesBlock

EC = ExpressionContext


class TimeSeriesQueryError(Exception):
    pass


@dataclass
class FetchNode:
    table: str
    value_col: str
    time_col: str
    agg: str = "sum"  # bucket aggregation
    filter_expr: Optional[str] = None
    group_tags: list[str] = field(default_factory=list)


@dataclass
class PipeStage:
    name: str
    args: list[str] = field(default_factory=list)


@dataclass
class TimeSeriesPlan:
    fetch: FetchNode
    stages: list[PipeStage] = field(default_factory=list)


# -- language ----------------------------------------------------------------

_AGG_STAGES = {"sum", "min", "max", "avg", "count"}


def parse_m3ql(query: str) -> TimeSeriesPlan:
    """`fetch k=v ... | stage args | ...` (reference: the m3ql plugin's
    pipe parser)."""
    parts = [p.strip() for p in query.split("|")]
    if not parts or not parts[0].startswith("fetch"):
        raise TimeSeriesQueryError("timeseries query must start with 'fetch'")
    kv = {}
    for tok in shlex.split(parts[0])[1:]:
        if "=" not in tok:
            raise TimeSeriesQueryError(f"fetch expects k=v args, got {tok!r}")
        k, v = tok.split("=", 1)
        kv[k] = v
    try:
        fetch = FetchNode(
            table=kv["table"], value_col=kv["value"],
            time_col=kv.get("time_col", "ts"),
            agg=kv.get("agg", "sum").lower(),
            filter_expr=kv.get("filter"))
    except KeyError as e:
        raise TimeSeriesQueryError(f"fetch missing required arg {e}") from e
    stages = []
    first_agg_seen = False
    for part in parts[1:]:
        if not part:
            continue
        toks = part.replace(",", " ").split()
        name = toks[0].lower()
        args = toks[1:]
        if name in _AGG_STAGES and not first_agg_seen:
            # the first aggregation stage defines the fetch's tag grouping
            # (reference: m3ql's groupByTags pushes into the leaf fetch)
            fetch.group_tags = args
            fetch.agg = fetch.agg if name == "sum" and kv.get("agg") else name
            first_agg_seen = True
            stages.append(PipeStage("aggregate_tags", [name] + args))
        else:
            stages.append(PipeStage(name, args))
    return TimeSeriesPlan(fetch, stages)


# -- engine ------------------------------------------------------------------


class TimeSeriesEngine:
    """Executes timeseries plans against a QueryExecutor's tables
    (reference: broker TimeSeriesRequestHandler → QueryEnvironment →
    leaf V1 execution). The fetch runs where the executor's device is:
    the card by default, the CPU where the caller built the executor
    so."""

    def __init__(self, query_executor):
        self.qe = query_executor

    def execute(self, query: str, start: int, end: int, step: int,
                language: str = "m3ql") -> TimeSeriesBlock:
        if language != "m3ql":
            raise TimeSeriesQueryError(f"unknown timeseries language {language}")
        plan = parse_m3ql(query)
        buckets = TimeBuckets.for_range(start, end, step)
        block = self._fetch(plan.fetch, buckets, start, end, step)
        for stage in plan.stages:
            block = self._apply(stage, block)
        return block

    # -- leaf fetch (rides the SQL engine / device kernel) ------------------
    def _fetch(self, f: FetchNode, buckets: TimeBuckets,
               start: int, end: int, step: int) -> TimeSeriesBlock:
        bucket_expr = EC.for_function(
            "minus",
            EC.for_identifier(f.time_col),
            EC.for_function("mod", EC.for_identifier(f.time_col),
                            EC.for_literal(step)))
        group = [bucket_expr] + [EC.for_identifier(t) for t in f.group_tags]
        agg_fn = {"sum": "sum", "min": "min", "max": "max", "avg": "avg",
                  "count": "count"}.get(f.agg)
        if agg_fn is None:
            raise TimeSeriesQueryError(f"unknown fetch agg {f.agg!r}")
        select = group + [EC.for_function(agg_fn, EC.for_identifier(f.value_col))]
        time_filter = FilterContext.pred(Predicate(
            PredicateType.RANGE, EC.for_identifier(f.time_col),
            lower=start, lower_inclusive=True, upper=end, upper_inclusive=True))
        fctx = time_filter
        if f.filter_expr:
            try:
                fctx = FilterContext.and_(
                    parse_filter_expression(f.filter_expr), time_filter)
            except SqlParseError as e:
                raise TimeSeriesQueryError(f"bad fetch filter: {e}") from e
        qc = QueryContext(
            table_name=f.table, select_expressions=select,
            aliases=[None] * len(select), group_by_expressions=group,
            filter=fctx, limit=10_000_000)
        try:
            resp = self.qe.execute(qc.finish())
        except (UnsupportedQueryError, KeyError) as e:
            raise TimeSeriesQueryError(
                f"fetch failed: ['{type(e).__name__}: {e}']") from e
        rows = resp.result_table.rows if resp.result_table else []
        series: dict[tuple, TimeSeries] = {}
        nb = buckets.num_buckets
        for row in rows:
            bucket_time = row[0]
            tags = {t: row[1 + i] for i, t in enumerate(f.group_tags)}
            val = row[-1]
            key = tuple(sorted(tags.items()))
            s = series.get(key)
            if s is None:
                s = TimeSeries(tags, np.full(nb, np.nan))
                series[key] = s
            idx = int((bucket_time - buckets.start) // buckets.step)
            if 0 <= idx < nb and val is not None:
                s.values[idx] = float(val)
        return TimeSeriesBlock(buckets, sorted(series.values(), key=lambda s: s.id))

    # -- pipe stages (vectorized host combinators) --------------------------
    def _apply(self, stage: PipeStage, block: TimeSeriesBlock) -> TimeSeriesBlock:
        name, args = stage.name, stage.args
        if name == "aggregate_tags":
            return self._aggregate_tags(block, args[0], args[1:])
        if name in _AGG_STAGES:
            return self._aggregate_tags(block, name, args)
        if name == "rate":
            return self._map(block, lambda v: np.concatenate(
                [[np.nan], np.diff(v)]) / block.buckets.step)
        if name == "shift":
            k = int(args[0]) if args else 1
            def shift(v, _k=k):
                out = np.full_like(v, np.nan)
                if _k >= 0:
                    out[_k:] = v[:len(v) - _k] if _k < len(v) else []
                else:
                    out[:_k] = v[-_k:]
                return out
            return self._map(block, shift)
        if name == "scale":
            k = float(args[0])
            return self._map(block, lambda v: v * k)
        if name == "abs":
            return self._map(block, np.abs)
        if name in ("transform_null", "transformnull"):
            fill = float(args[0]) if args else 0.0
            return self._map(block, lambda v: np.where(np.isnan(v), fill, v))
        if name in ("moving_avg", "movingaverage"):
            w = int(args[0])
            def mavg(v, _w=w):
                out = np.full_like(v, np.nan)
                for i in range(len(v)):
                    lo = max(0, i - _w + 1)
                    win = v[lo:i + 1]
                    win = win[~np.isnan(win)]
                    if len(win):
                        out[i] = win.mean()
                return out
            return self._map(block, mavg)
        if name in ("keep_last_value", "keeplastvalue"):
            def ffill(v):
                out = v.copy()
                last = np.nan
                for i in range(len(out)):
                    if np.isnan(out[i]):
                        out[i] = last
                    else:
                        last = out[i]
                return out
            return self._map(block, ffill)
        if name in ("topk", "bottomk"):
            k = int(args[0]) if args else 1
            scored = [(np.nansum(s.values), s) for s in block.series]
            scored.sort(key=lambda x: x[0], reverse=(name == "topk"))
            return TimeSeriesBlock(block.buckets, [s for _, s in scored[:k]])
        raise TimeSeriesQueryError(f"unknown pipe stage {name!r}")

    def _map(self, block: TimeSeriesBlock, fn) -> TimeSeriesBlock:
        return TimeSeriesBlock(
            block.buckets,
            [TimeSeries(s.tags, np.asarray(fn(s.values), dtype=np.float64))
             for s in block.series])

    def _aggregate_tags(self, block: TimeSeriesBlock, agg: str,
                        keep_tags: list[str]) -> TimeSeriesBlock:
        """Re-aggregate series down to `keep_tags` (cross-series merge)."""
        groups: dict[tuple, list[TimeSeries]] = {}
        for s in block.series:
            tags = {k: v for k, v in s.tags.items() if k in keep_tags}
            groups.setdefault(tuple(sorted(tags.items())), []).append(s)
        out = []
        for key, members in sorted(groups.items()):
            stack = np.stack([m.values for m in members])
            with np.errstate(invalid="ignore"):
                if agg == "sum":
                    vals = np.nansum(stack, axis=0)
                    vals[np.isnan(stack).all(axis=0)] = np.nan
                elif agg == "min":
                    vals = np.nanmin(np.where(np.isnan(stack), np.inf, stack), axis=0)
                    vals[np.isinf(vals)] = np.nan
                elif agg == "max":
                    vals = np.nanmax(np.where(np.isnan(stack), -np.inf, stack), axis=0)
                    vals[np.isinf(vals)] = np.nan
                elif agg == "avg":
                    cnt = (~np.isnan(stack)).sum(axis=0)
                    vals = np.where(cnt > 0, np.nansum(stack, axis=0)
                                    / np.maximum(cnt, 1), np.nan)
                elif agg == "count":
                    vals = (~np.isnan(stack)).sum(axis=0).astype(np.float64)
                else:
                    raise TimeSeriesQueryError(f"unknown aggregation {agg!r}")
            out.append(TimeSeries(dict(key), vals))
        return TimeSeriesBlock(block.buckets, out)
