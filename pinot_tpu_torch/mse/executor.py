"""MSE facade: SQL → stage DAG → BrokerResponse.

The port of pinot_tpu/mse/executor.py for in-process execution. Reference
analogue: MultiStageBrokerRequestHandler + QueryDispatcher
(pinot-query-runtime/.../service/dispatch/QueryDispatcher.java:126 —
submitAndReduce) collapsed into one in-process entry point, the same
topology the reference uses in its own in-process MSE tests
(QueryRunnerTestBase).

A statement's response is cached (cache/results.py, on by default as in
the JAX package), keyed by the fingerprint of its stage DAG and the token
of every segment its scans read (cache/keys.py), so a replaced segment
misses; a statement over a consuming segment is not cached. A hit is the
cached rows with no dispatch. `SET resultCache = false` or
PINOT_TPU_RESULT_CACHE=0 turns it off.

`SET trace = true` and EXPLAIN ANALYZE start a trace here (unless one is
active): each stage records an `mse_stage:<id>` span with its stats, and
the leaf stages' single-stage spans (family_dispatch included) nest under
their stage. EXPLAIN ANALYZE renders the tree (engine/explain.py
`analyze_table`); a traced statement bypasses the result cache.
"""

from __future__ import annotations

import re
import time
from typing import Optional

import numpy as np

from ..cache.keys import mse_plan_fingerprint, segment_token
from ..cache.results import BrokerResultCache, result_cache_enabled
from ..engine.explain import analyze_table
from ..engine.results import BrokerResponse, DataSchema, ResultTable
from ..spi.trace import TRACING
from .fragmenter import explain_stages, fragment
from .logical import LogicalPlanner, prune_columns
from .mailbox import Block, block_len
from .operators import pop_join_overflow
from .optimizer import push_filters
from .parser import parse_relational
from .runtime import StageRunner



def concat_columns(parts: list) -> np.ndarray:
    """One column from its per-segment parts (object dtype when any part
    is)."""
    if not parts:
        return np.empty(0)
    if len(parts) == 1:
        return parts[0]
    if any(p.dtype.kind == "O" for p in parts):
        parts = [p.astype(object) for p in parts]
    return np.concatenate(parts)


def scan_segments(segments, columns) -> dict[str, np.ndarray]:
    """Host columns of a generic scan over ``segments``: a consuming
    segment read through its pinned snapshot, upsert-invalid rows
    dropped."""
    out: dict[str, list] = {c: [] for c in columns}
    for seg in segments:
        view = seg.snapshot_view() if getattr(seg, "is_mutable", False) else seg
        vd = getattr(view, "valid_doc_ids", None)
        keep = vd.mask(view.num_docs) if vd is not None else None
        for c in columns:
            vals = np.asarray(view.get_values(c))
            out[c].append(vals if keep is None else vals[keep])
    return {c: concat_columns(parts) for c, parts in out.items()}


class MultistageExecutor:
    """Runs the multi-stage dialect over a single-stage QueryExecutor's
    table registry (engine/query_executor.py), on its device."""

    def __init__(self, query_executor, parallelism: int = 2):
        self.qe = query_executor
        self.parallelism = parallelism
        # the executor lives as long as its QueryExecutor, so a warm repeat
        # of a statement skips the runner entirely
        self.result_cache = BrokerResultCache()

    def _cache_key(self, stages, options) -> Optional[tuple]:
        """(plan fingerprint, every scanned segment's (table,) + token,
        sorted), or None: an unfingerprintable plan, a missing table, a
        consuming or crc-less segment. Computed after the resultCache gate,
        so an opted-out statement never fingerprints."""
        fp = mse_plan_fingerprint(stages, options, self.parallelism)
        if fp is None:
            return None
        toks = []
        for st in stages:
            if st.root is None:
                continue
            for scan in st.scans():
                t = self.qe.tables.get(scan.table)
                if t is None:
                    return None
                for seg in list(t.segments):
                    tok = segment_token(seg)
                    if tok is None:
                        return None
                    toks.append((scan.table,) + tok)
        return (fp, tuple(sorted(toks)))

    # -- catalog -----------------------------------------------------------
    def _catalog(self) -> dict[str, list[str]]:
        return {name: t.schema.column_names()
                for name, t in self.qe.tables.items()}

    def _partition_catalog(self) -> dict[str, dict]:
        """table → {column: (pfunc, n_partitions)} where EVERY segment is
        stamped with the same function/count (reference: the broker's
        TablePartitionInfo is computed the same way — from per-segment
        ColumnPartitionMetadata, invalidated on any inconsistent segment)."""
        out: dict[str, dict] = {}
        for name, t in self.qe.tables.items():
            segs = list(t.segments)
            if not segs:
                continue
            per_col: dict[str, tuple] = {}
            for col in t.schema.column_names():
                infos = set()
                for seg in segs:
                    meta = getattr(seg, "metadata", None)
                    m = meta.columns.get(col) if meta is not None else None
                    if m is None or not getattr(m, "partition_function", None) \
                            or not getattr(m, "num_partitions", None):
                        infos = None
                        break
                    infos.add((m.partition_function, m.num_partitions))
                if infos and len(infos) == 1:
                    per_col[col] = next(iter(infos))
            if per_col:
                out[name] = per_col
        return out

    def _read_table(self, table: str, columns: list[str]) -> dict[str, np.ndarray]:
        """Host columns of a generic scan over every segment of the
        table."""
        t = self.qe.tables.get(table)
        if t is None:
            raise KeyError(f"table {table} not found")
        return scan_segments(list(t.segments), columns)

    # -- entry -------------------------------------------------------------
    def plan(self, query):
        """The stages of a parsed statement: plan, push filters down, prune
        columns and fragment."""
        planner = LogicalPlanner(query, self._catalog(),
                                 partition_catalog=self._partition_catalog)
        plan = push_filters(planner.plan())
        prune_columns(plan)
        return fragment(plan)

    def execute_sql(self, sql: str) -> BrokerResponse:
        """Run a statement; a failure of any stage comes back as the
        response's exception (the reference's broker contract)."""
        t0 = time.perf_counter()
        try:
            query = parse_relational(sql)
        except Exception as e:
            return _error_response(e, t0)
        # the statement owns the span tree: stage spans and the leaves'
        # nested single-stage spans join it. EXPLAIN ANALYZE arms it
        # always, flagged so the segment partial cache stays on
        analyze = query.explain == "analyze"
        trace = None
        if (analyze or query.options.get("trace") in (True, "true", 1)) \
                and TRACING.active_trace() is None:
            trace = TRACING.start_trace(f"mse:{id(query):x}",
                                        analyze=analyze)
        try:
            return self._execute(query, trace, analyze, t0)
        except Exception as e:
            return _error_response(e, t0)
        finally:
            if trace is not None:
                TRACING.end_trace()

    def _execute(self, query, trace, analyze: bool,
                 t0: float) -> BrokerResponse:
        stages = self.plan(query)
        if query.explain is True:
            return _plan_response(explain_stages(stages), t0)
        cache_key = None
        if query.explain is False and trace is None \
                and result_cache_enabled() \
                and not _option_false(query.options, "resultCache"):
            cache_key = self._cache_key(stages, query.options)
        if cache_key is not None:
            cached = self.result_cache.get(cache_key)
            if cached is not None:
                # the cached rows, no dispatch: restamp the shallow copy
                cached.cache_outcome = "hit"
                cached.num_device_dispatches = 0
                cached.time_used_ms = (time.perf_counter() - t0) * 1000
                return cached
        pop_join_overflow()  # clear any stale flag on this thread
        runner = StageRunner(
            stages, self.parallelism, self.qe, self._read_table,
            query_options=query.options, device=self.qe.device)
        block = runner.run()
        if query.explain == "implementation":
            # the query RAN; the plan text carries each stage's
            # measured rows/bytes/time
            return _plan_response(
                explain_stages(stages, runner.stage_stats), t0)
        resp = BrokerResponse(
            result_table=_block_to_result(block, stages[0].root.schema),
            num_docs_scanned=runner.stats["num_docs_scanned"],
            total_docs=runner.stats["total_docs"],
            partial_result=pop_join_overflow()
            or bool(runner.stats.get("join_overflow")),
            num_groups_limit_reached=runner.stats[
                "num_groups_limit_reached"],
            num_device_dispatches=runner.stats["num_device_dispatches"],
            mse_stage_stats=runner.stage_stats,
            time_used_ms=(time.perf_counter() - t0) * 1000)
        if cache_key is not None:
            resp.cache_outcome = "miss"
            if not resp.partial_result:  # a truncated join is not kept
                self.result_cache.put(cache_key, resp)
        if trace is not None:
            resp.trace_info = trace.to_json()
        if analyze:
            resp.result_table = analyze_table(resp.trace_info or [],
                                              resp)
        return resp


def _option_false(options: dict, name: str) -> bool:
    for k, v in (options or {}).items():
        if str(k).lower() == name.lower():
            return v is False or str(v).lower() in ("0", "false", "off")
    return False


def _error_response(e: Exception, t0: float) -> BrokerResponse:
    return BrokerResponse(exceptions=[f"{type(e).__name__}: {e}"],
                          time_used_ms=(time.perf_counter() - t0) * 1000)


def _plan_response(text: str, t0: float) -> BrokerResponse:
    return BrokerResponse(
        result_table=ResultTable(DataSchema(["plan"], ["STRING"]),
                                 [[line] for line in text.split("\n")]),
        time_used_ms=(time.perf_counter() - t0) * 1000)


def _block_to_result(block: Block, schema: list[str]) -> ResultTable:
    n = block_len(block)
    cols = []
    types = []
    for name in schema:
        v = np.asarray(block.get(name, np.empty(0)))
        cols.append(v)
        types.append(_np_type(v))
    rows = []
    for i in range(n):
        rows.append([_py(c[i]) for c in cols])
    return ResultTable(DataSchema([_display(s) for s in schema], types), rows)


def _np_type(v: np.ndarray) -> str:
    k = v.dtype.kind
    if k == "b":
        return "BOOLEAN"
    if k in "iu":
        return "LONG"
    if k == "f":
        return "DOUBLE"
    return "STRING"


def _py(v):
    if isinstance(v, np.generic):
        v = v.item()
    if isinstance(v, float) and np.isnan(v):
        return None
    return v


_QUALIFIED_RE = re.compile(r"[A-Za-z_][\w$]*(?:\.[A-Za-z_][\w$]*)+")


def _display(name: str) -> str:
    """Qualified plain identifiers render unqualified in the response header
    (reference: MSE result headers use the field name, not `table.field`);
    expression strings pass through untouched."""
    if _QUALIFIED_RE.fullmatch(name):
        return name.rsplit(".", 1)[-1]
    return name
