"""MSE stage runtime: executes the fragmented stage DAG.

Reference analogue: pinot-query-runtime's QueryRunner.processQuery:210 —
build an OpChain per stage, run leaf stages through the single-stage engine
(ServerPlanRequestUtils → ServerQueryExecutorV1Impl, results adapted by
LeafStageTransferableBlockOperator.java:87), run intermediate stages as
operator trees, connect everything through the mailbox service.

Leaf compilation is where the device shows up: a leaf stage whose shape
is ``[partial Aggregate] ← [Filter] ← Scan`` compiles to a single-stage
QueryContext and runs on the port's device engine (kernels A and B, the
selection bitmap, the segment combine); the fused join stages run on the
executor's device (mse/device_join.py); other stages above the first
exchange run on the host.

While a trace is active, each stage runs under an `mse_stage:<id>` span
carrying its stats; the partition workers adopt the trace with the stage's
span as parent, so the leaves' spans nest under their stage.

The port's copy of pinot_tpu/mse/runtime.py with its server meters
(MSE_DEVICE_JOINS, MSE_FUSED_STAGES, MSE_HOST_CROSSINGS,
MSE_DEVICE_JOIN_FALLBACKS) and the perf ledger's `device-join-host` event
(engine/perf_ledger.py, read by the sentinel's fallback-surge rule), and
without the reference's recovery from a device failure: an error in a
fused stage fails the query (only the deterministic gates of run_fused
send a stage to the host path).
"""

from __future__ import annotations

import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional

import numpy as np

from ..engine.aggregation import UnsupportedQueryError
from ..engine.perf_ledger import PERF_LEDGER
from ..ops import kernels
from ..query.context import QueryContext
from ..query.converter import FilterConversionError, filter_from_expression
from ..query.expressions import ExpressionContext
from ..spi.metrics import SERVER_METRICS, ServerMeter
from ..spi.trace import TRACING
from .fragmenter import MailboxReceiveNode, Stage, receive_nodes
from .logical import (
    AggregateNode,
    FilterNode,
    JoinNode,
    PlanNode,
    ProjectNode,
    SetOpNode,
    SortNode,
    TableScanNode,
    WindowNode,
)
from . import device_join
from .mailbox import (
    Block,
    MailboxService,
    block_len,
    concat_blocks,
    hash_partition,
)
from .operators import (
    JoinCtx,
    op_aggregate,
    op_filter,
    op_join,
    op_project,
    op_setop,
    op_sort,
    op_window,
    pop_join_overflow,
)

EC = ExpressionContext

_LEAF_LIMIT = 1_000_000_000  # effectively unlimited (leaf results feed merges)


def _plan_counted(eng, qc):
    """``eng.plan_query(qc)``; a refusal counts `queryExecutionExceptions`
    before the leaf takes the generic path, as the reference's leaf counts
    its single-stage engine's failure."""
    try:
        return eng.plan_query(qc)
    except UnsupportedQueryError:
        SERVER_METRICS.add_meter(ServerMeter.QUERY_EXECUTION_EXCEPTIONS)
        raise


class StageRunner:
    """Executes one fragmented plan. ``leaf_engine`` is the single-stage
    engine (engine/query_executor.QueryExecutor: plan_query / run_planned,
    plan_selection_columnar / run_selection_columnar); ``read_table``
    returns raw column arrays for generic scans."""

    def __init__(self, stages: list[Stage], parallelism: int,
                 leaf_engine, read_table: Callable,
                 query_options: Optional[dict] = None, device=None):
        self.stages = stages
        # the executor's torch device: the fused join stages and the pair
        # joins run there (None: host joins only)
        self.device = device
        self.parallelism = max(1, parallelism)
        self.leaf_engine = leaf_engine
        self.read_table = read_table
        # per-(stage, key-columns) joint-code cache + counters, shared by
        # every partition of a join stage (operators.JoinCtx)
        self._join_ctx = JoinCtx(device)
        self._overflow_lock = threading.Lock()
        # SET options from the MSE statement, forwarded into leaf SSQE
        # pushdowns (enableNullHandling / numGroupsLimit / timeoutMs act at
        # the single-stage engine)
        self.query_options = dict(query_options or {})
        self.mailbox = MailboxService()
        self.stats = {"stages": len(stages), "leaf_ssqe_pushdowns": 0,
                      "num_docs_scanned": 0, "total_docs": 0,
                      "num_device_dispatches": 0,
                      "num_groups_limit_reached": False}
        # per-stage observability: stage_id → counters (rows in/out,
        # shuffled rows/bytes, wall time) — the attribution plane for
        # EXPLAIN IMPLEMENTATION and BrokerResponse.mse_stage_stats
        self.stage_stats: dict[int, dict] = {}
        # device-resident join data path: stage_id → FusedStagePlan for
        # stages that run the fused partition→join→aggregate kernels, and
        # child stage_id → consumer stage_id for stages whose output stays
        # a same-process device handoff (mailbox send_raw) instead of a
        # hash shuffle. Populated by run().
        self._fused: dict[int, object] = {}
        self._handoff: dict[int, int] = {}
        # join stages absorbed INTO a fused consumer (multi-join chains):
        # absorbed stage_id → fused stage_id. Absorbed stages never
        # execute — the fused stage expands their join from the leaf
        # blocks, which hand off raw straight to it.
        self._absorbed: dict[int, int] = {}

    def _sstat(self, stage_id: int) -> dict:
        st = self.stage_stats.get(stage_id)
        if st is None:
            st = self.stage_stats[stage_id] = {
                "workers": 0, "leaf_pushdown": False, "rows_in": 0,
                "rows_out": 0, "shuffled_rows": 0, "shuffled_bytes": 0,
                "cross_stage_bytes": 0, "device_partition_ms": 0.0,
                "join_impl": "", "host_crossings": 0, "wall_ms": 0.0}
        return st

    def _null_handling_requested(self) -> bool:
        opt = self.query_options.get("enableNullHandling")
        return opt is True or str(opt).lower() == "true"

    def _device_join_option(self) -> Optional[bool]:
        """SET deviceJoin = true (force) / false (opt out) / unset (auto:
        size-gated at consume time)."""
        for k, v in self.query_options.items():
            if k.lower() == "devicejoin":
                s = str(v).lower()
                if s in ("0", "false", "off"):
                    return False
                if s in ("1", "true", "on", "force") or v is True:
                    return True
        return None

    def _plan_fused(self) -> None:
        """Mark the stages that take the device-resident join path. Only
        the in-process mailbox can hand device arrays across a stage
        boundary by reference; the cluster's RoutedMailbox keeps the wire
        path (its runners never call run(), so this is also never reached
        there)."""
        if type(self.mailbox) is not MailboxService:
            return
        if self.device is None or self._device_join_option() is False:
            return
        if device_join.env_mode() in ("0", "off", "false"):
            return
        by_id = {s.stage_id: s for s in self.stages}
        for stage in self.stages:
            if stage.stage_id == 0:
                continue
            plan = device_join.plan_fused_stage(stage)
            if plan is None:
                continue
            self._fused[stage.stage_id] = plan
            for recv in plan.receives:
                self._handoff[recv.from_stage] = stage.stage_id
        # multi-join chains: a fused stage whose input is itself a plain
        # INNER-join stage absorbs it — the child never executes, its leaf
        # blocks hand off raw to the fused stage, and the chain expands as
        # composed row indices (values gathered on device)
        for sid, plan in self._fused.items():
            if plan.residual:
                continue
            for pos, recv in zip(("left", "right"), plan.receives):
                src = self._build_chain(by_id.get(recv.from_stage), by_id, 0)
                if src is None or not self._chain_resolvable(plan, pos, src):
                    continue
                plan.chain_side, plan.chain = pos, src
                for csid in src.stage_ids():
                    self._absorbed[csid] = sid
                    self._handoff.pop(csid, None)
                for leaf in src.leaf_receives():
                    self._handoff[leaf.from_stage] = sid
                break   # at most one chained input per fused stage

    def _build_chain(self, stage, by_id: dict, depth: int):
        """ChainSource for an absorbable join stage, nesting absorbable
        grandchildren (up to 3 chained joins) when the level's own join
        keys stay resolvable through the nested source."""
        if stage is None or depth > 2 or stage.stage_id in self._fused:
            return None
        src = device_join.plan_chain_source(stage)
        if src is None:
            return None
        for attr, keys in (("left", src.join_node.left_keys),
                           ("right", src.join_node.right_keys)):
            recv = getattr(src, attr)
            nested = self._build_chain(by_id.get(recv.from_stage), by_id,
                                       depth + 1)
            if nested is not None and all(
                    device_join.chain_resolve(nested, k) is not None
                    for k in keys):
                setattr(src, attr, nested)
        return src

    def _chain_resolvable(self, plan, pos: str, src) -> bool:
        """Every column the fused stage needs from the chained side must
        reconstruct from the leaf blocks."""
        join = plan.join_node
        need = list(join.left_keys if pos == "left" else join.right_keys)
        chain_rel = "probe" if plan.probe_side == pos else "build"
        if chain_rel == "probe":
            need += [c for _, c in plan.group_cols]
        need += [c for _k, rel, c, _o in plan.aggs
                 if rel == chain_rel and c is not None]
        return all(device_join.chain_resolve(src, c) is not None
                   for c in need)

    # -- topology ----------------------------------------------------------
    def workers_of(self, stage: Stage) -> int:
        nodes = receive_nodes(stage.root)
        nparts = [n.n_partitions for n in nodes
                  if n.dist == "partitioned" and n.n_partitions]
        if nparts:
            # colocated join: one worker per table partition
            return max(nparts)
        return self.parallelism if any(n.dist == "hash" for n in nodes) else 1

    # -- run ---------------------------------------------------------------
    def run(self) -> Block:
        self._plan_fused()
        # children have higher ids than parents: run bottom-up. Absorbed
        # chain stages never run — their fused consumer expands them.
        for stage in sorted(self.stages, key=lambda s: -s.stage_id):
            if stage.stage_id == 0 or stage.stage_id in self._absorbed:
                continue
            self._run_stage(stage)
        self.stats["join_ctx"] = dict(self._join_ctx.counters)
        broker = self.stages[0]
        return self.mailbox.receive(broker.child_stages[0], 0, 0,
                                    broker.root.schema)

    def _trim_to_send(self, stage: Stage, block: Block) -> Block:
        """Drop columns the consuming stage never references (the pruned
        exchange schema) — e.g. a filter column a leaf consumed locally."""
        ss = stage.send_schema
        if ss is None or set(ss) >= set(block.keys()):
            return block
        return {c: block[c] for c in ss if c in block}

    def _worker_block(self, stage: Stage, w: int) -> Block:
        """One partition worker: execute the stage tree and capture the
        thread-local BREAK-overflow flag before leaving the thread (a
        pooled worker's flag would otherwise be stranded in the pool)."""
        block = self._exec(stage.root, stage, w)
        if pop_join_overflow():
            with self._overflow_lock:
                self.stats["join_overflow"] = True
        return block

    # the stage stats an mse_stage span carries
    _SPAN_STATS = ("workers", "rows_in", "rows_out", "shuffled_rows",
                   "shuffled_bytes", "cross_stage_bytes",
                   "device_partition_ms", "join_impl", "host_crossings",
                   "leaf_pushdown")

    def _run_stage(self, stage: Stage) -> None:
        if TRACING.active_trace() is None:
            return self._run_stage_inner(stage)
        # one span per stage, so broker reduce -> stage -> the leaf's
        # family_dispatch spans line up in one tree
        with TRACING.scope(f"mse_stage:{stage.stage_id}") as span:
            self._run_stage_inner(stage)
            st = self._sstat(stage.stage_id)
            for k in self._SPAN_STATS:
                if k in st and st[k] != "":
                    span.set_attribute(k, st[k])

    def _run_stage_inner(self, stage: Stage) -> None:
        parent = self.stages[stage.parent_stage]
        parent_workers = 1 if parent.stage_id == 0 else self.workers_of(parent)
        st = self._sstat(stage.stage_id)
        t0 = time.perf_counter()
        pushed = None
        blocks = None
        if stage.stage_id in self._fused:
            blocks = self._run_fused_stage(stage, st)
        elif stage.is_leaf:
            pushed = self._try_ssqe(stage)
            if pushed is None and self._null_handling_requested():
                # the generic scan path has no null semantics — failing is
                # honest; silently flipping to basic mode per plan shape
                # is not
                raise UnsupportedQueryError(
                    "enableNullHandling requires this leaf stage to push "
                    "down to the single-stage engine")
        if pushed is not None:
            self.stats["leaf_ssqe_pushdowns"] += 1
            st["workers"] = 1
            st["leaf_pushdown"] = True
            blocks = [pushed]
        elif blocks is None:
            st["workers"] = self.workers_of(stage)
            # NumPy releases the GIL on the hot kernels (argsort, unique,
            # gather), so partition-level threading pays off on CPython
            pool_size = min(st["workers"], os.cpu_count() or 1)
            if pool_size > 1:
                # independent partitions of the stage execute concurrently;
                # sends stay in worker order below, so mailbox contents are
                # deterministic regardless of completion order
                caller_trace = TRACING.active_trace()
                caller_span = TRACING.current_span()

                def run_worker(w):
                    if caller_trace is None:
                        return self._worker_block(stage, w)
                    # traces are thread-local: nest the worker's scopes
                    # under this stage's span
                    TRACING.adopt(caller_trace, caller_span)
                    try:
                        return self._worker_block(stage, w)
                    finally:
                        TRACING.adopt(None)

                with ThreadPoolExecutor(max_workers=pool_size) as pool:
                    futs = [pool.submit(run_worker, w)
                            for w in range(st["workers"])]
                    blocks = [f.result() for f in futs]
            else:
                blocks = [self._worker_block(stage, w)
                          for w in range(st["workers"])]
        # a stage feeding a fused consumer hands its block over whole: the
        # consumer partitions on device (or re-partitions itself on
        # fallback), so nothing is encoded or split here. A chain leaf's
        # direct parent is an ABSORBED stage — its blocks skip that stage
        # entirely and hand off to the fused consumer.
        target = self._handoff.get(stage.stage_id)
        handoff = target is not None and (
            target == parent.stage_id
            or self._absorbed.get(parent.stage_id) == target)
        for block in blocks:
            st["rows_out"] += block_len(block)
            trimmed = self._trim_to_send(stage, block)
            if handoff:
                self.mailbox.send_raw(stage.stage_id, target, trimmed)
            else:
                self.mailbox.send_partitioned(
                    stage.stage_id, parent.stage_id, trimmed,
                    stage.send_dist, stage.send_keys, parent_workers,
                    pfunc=stage.send_pfunc)
        st["wall_ms"] += (time.perf_counter() - t0) * 1000
        st["shuffled_rows"] = self.mailbox.sent_rows[stage.stage_id]
        st["shuffled_bytes"] = self.mailbox.sent_bytes[stage.stage_id]
        st["cross_stage_bytes"] = self.mailbox.cross_bytes[stage.stage_id]

    def _run_fused_stage(self, stage: Stage, st: dict) -> list[Block]:
        """The device-resident join stage: both inputs arrive as raw
        same-process handoffs; the whole Aggregate←Join subtree runs as
        three device stages (partition ×2, fused join+agg) with one host
        fetch. A deterministic gate that fails (run_fused returns None),
        or a stage below the size threshold, re-creates the hash shuffle
        the handoff skipped and runs the exact host operators per partition
        — bit-identical to the never-fused plan. An error in the device
        stages fails the query."""
        plan = self._fused[stage.stage_id]
        recv_l, recv_r = plan.receives
        chain_sids = list(plan.chain.stage_ids()) if plan.chain else []

        def _recv(r):
            return self.mailbox.receive_raw(r.from_stage, stage.stage_id,
                                            r.schema)

        leaf_blocks: dict[int, tuple] = {}
        rows_in = 0
        sides: dict[str, object] = {}
        for pos, recv in (("left", recv_l), ("right", recv_r)):
            if plan.chain_side == pos:
                for leaf in plan.chain.leaf_receives():
                    blk = _recv(leaf)
                    leaf_blocks[id(leaf)] = (blk, block_len(blk))
                    rows_in += block_len(blk)
                sides[pos] = None     # expanded below
            else:
                sides[pos] = _recv(recv)
                rows_in += block_len(sides[pos])
        st["rows_in"] += rows_in
        forced = self._device_join_option() is True \
            or device_join.env_mode() in ("1", "on", "force", "true")
        eligible = forced or rows_in >= device_join.FUSED_AUTO_MIN_ROWS
        ctx = self._join_ctx.for_stage(stage.stage_id)

        def get_leaf(r):
            return leaf_blocks[id(r)]

        fetches0 = kernels.thread_host_fetches()
        if eligible:
            t0 = time.perf_counter()
            result = None
            if plan.chain_side is not None:
                # host expands the chain's pair INDICES (the same argsort
                # expansion the host joiner runs); values stay put and
                # gather on the device
                view = device_join.expand_chain(plan.chain, get_leaf, ctx)
                if view is not None:
                    sides[plan.chain_side] = view
                    result = device_join.run_fused(
                        sides["left"], sides["right"], plan, self.device, ctx)
            else:
                result = device_join.run_fused(
                    sides["left"], sides["right"], plan, self.device, ctx)
            if result is not None:
                block, info = result
                st["device_partition_ms"] += (time.perf_counter() - t0) * 1000
                st["join_impl"] = "device-fused"
                st["workers"] = 1
                # measured: the deliberate device->host copies this
                # thread made for the stage
                st["host_crossings"] = (kernels.thread_host_fetches()
                                        - fetches0)
                self.stats["num_device_dispatches"] += info["dispatches"]
                SERVER_METRICS.add_meter(ServerMeter.MSE_DEVICE_JOINS)
                SERVER_METRICS.add_meter(ServerMeter.MSE_FUSED_STAGES,
                                         1 + len(chain_sids))
                SERVER_METRICS.add_meter(ServerMeter.MSE_HOST_CROSSINGS,
                                         st["host_crossings"])
                for csid in chain_sids:
                    self._sstat(csid)["join_impl"] = "device-fused"
                return [block]
            # an eligible stage whose deterministic gate failed takes the
            # host path (a stage below the size threshold counts nothing)
            SERVER_METRICS.add_meter(ServerMeter.MSE_DEVICE_JOIN_FALLBACKS)
            PERF_LEDGER.note_event("device-join-host")
        # host path: same hash routing the children would have used,
        # then the exact host join+aggregate operators per partition. An
        # absorbed chain re-materializes through the host joiner itself —
        # exact semantics including the join-row guards.
        st["join_impl"] = "host"
        for csid in chain_sids:
            self._sstat(csid)["join_impl"] = "host"
        if plan.chain_side is not None:
            sides[plan.chain_side] = device_join.host_expand_chain(
                plan.chain, get_leaf, ctx)
            if pop_join_overflow():
                self.stats["join_overflow"] = True
        left, right = sides["left"], sides["right"]
        workers = self.workers_of(stage)
        st["workers"] = workers
        lparts = hash_partition(left, recv_l.keys, workers)
        rparts = hash_partition(right, recv_r.keys, workers)
        blocks = []
        for lw, rw in zip(lparts, rparts):
            joined = op_join(lw, rw, plan.join_node.join_type,
                             plan.join_node.left_keys,
                             plan.join_node.right_keys,
                             plan.join_node.residual,
                             plan.join_node.schema, ctx=ctx)
            if pop_join_overflow():
                self.stats["join_overflow"] = True
            blocks.append(op_aggregate(
                joined, plan.agg_node.group_exprs, plan.agg_node.agg_calls,
                plan.agg_node.schema))
        return blocks

    # -- node execution ----------------------------------------------------
    def _exec(self, node: PlanNode, stage: Stage, worker: int) -> Block:
        if isinstance(node, MailboxReceiveNode):
            block = self.mailbox.receive(node.from_stage, stage.stage_id,
                                         worker, node.schema)
            self._sstat(stage.stage_id)["rows_in"] += block_len(block)
            return block
        if isinstance(node, TableScanNode):
            return self._scan(node)
        if isinstance(node, FilterNode):
            return op_filter(self._exec(node.inputs[0], stage, worker), node.condition)
        if isinstance(node, ProjectNode):
            return op_project(self._exec(node.inputs[0], stage, worker),
                              node.schema, node.exprs)
        if isinstance(node, AggregateNode):
            if self._can_stream_aggregate(node):
                return self._streaming_aggregate(node, stage, worker)
            return op_aggregate(self._exec(node.inputs[0], stage, worker),
                                node.group_exprs, node.agg_calls, node.schema)
        if isinstance(node, JoinNode):
            left = self._exec(node.inputs[0], stage, worker)
            right = self._exec(node.inputs[1], stage, worker)
            return op_join(left, right, node.join_type, node.left_keys,
                           node.right_keys, node.residual, node.schema,
                           ctx=self._join_ctx.for_stage(stage.stage_id))
        if isinstance(node, WindowNode):
            return op_window(self._exec(node.inputs[0], stage, worker),
                             node.calls, node.schema)
        if isinstance(node, SortNode):
            return op_sort(self._exec(node.inputs[0], stage, worker),
                           node.sort_items, node.limit, node.offset)
        if isinstance(node, SetOpNode):
            left = self._exec(node.inputs[0], stage, worker)
            right = self._exec(node.inputs[1], stage, worker)
            return op_setop(node.kind, node.all, left, right, node.schema)
        raise UnsupportedQueryError(f"MSE cannot execute node {type(node).__name__}")

    # rows buffered before an incremental collapse in a streaming aggregate
    STREAM_COLLAPSE_ROWS = 262_144

    def _can_stream_aggregate(self, node: AggregateNode) -> bool:
        """True for the FINAL-merge shape of a two-phase aggregation: input
        is a mailbox receive, every call is a re-mergeable merge fn
        (sum/min/max — applying the aggregate to its own output is a no-op
        on semantics), and the output schema equals the input schema so the
        collapsed partial feeds back in. This is the streaming consumer of
        the pipelined shuffle: chunks partial-merge as they arrive instead
        of materializing the whole mailbox (reference: AggregateOperator
        consuming TransferableBlocks incrementally)."""
        child = node.inputs[0]
        return (isinstance(child, MailboxReceiveNode)
                and bool(node.agg_calls)
                and all(c.name in ("sum", "min", "max") and c.condition is None
                        and not c.extra for c in node.agg_calls)
                and all(g.is_identifier for g in node.group_exprs)
                and list(node.schema) == list(child.schema))

    def _streaming_aggregate(self, node: AggregateNode, stage: Stage,
                             worker: int) -> Block:
        recv: MailboxReceiveNode = node.inputs[0]
        buf: list[Block] = []
        buf_rows = 0

        def collapse() -> Block:
            return op_aggregate(
                concat_blocks(buf, list(recv.schema)),
                node.group_exprs, node.agg_calls, node.schema)

        for chunk in self.mailbox.stream(recv.from_stage, stage.stage_id,
                                         worker):
            buf.append(chunk)
            self._sstat(stage.stage_id)["rows_in"] += block_len(chunk)
            buf_rows += block_len(chunk)
            if buf_rows >= self.STREAM_COLLAPSE_ROWS:
                buf = [collapse()]
                buf_rows = block_len(buf[0])
        return collapse()

    def _scan(self, node: TableScanNode) -> Block:
        cols = self.read_table(node.table, node.source_columns)
        return {q: cols[s] for q, s in zip(node.schema, node.source_columns)}

    # -- leaf → single-stage compilation -----------------------------------
    def _try_ssqe(self, stage: Stage) -> Optional[Block]:
        """Compile ``[partial Aggregate] ← [Filter]* ← Scan`` to a
        QueryContext and run it on the single-stage (device) engine. A
        shape that engine refuses while it plans (UnsupportedQueryError, a
        filter it cannot convert, a column outside the scan) takes the
        generic path, as in the reference; an error once the leaf runs
        fails the query."""
        try:
            leaf = self._plan_leaf(stage)
        except (FilterConversionError, UnsupportedQueryError, KeyError):
            return None
        if leaf is None:
            return None
        kind, planned, names = leaf
        eng = self.leaf_engine
        if kind == "columnar":
            cols, cstats = eng.run_selection_columnar(planned)
            self.stats["num_docs_scanned"] += cstats["num_docs_scanned"]
            self.stats["total_docs"] += cstats["total_docs"]
            self.stats["num_device_dispatches"] += \
                cstats["num_device_dispatches"]
            self.stats["leaf_columnar"] = \
                self.stats.get("leaf_columnar", 0) + 1
            return {q: cols[c] for q, c in names}
        return self._resp_to_block(eng.run_planned(planned), names)

    def _plan_leaf(self, stage: Stage):
        """The planning half of ``_try_ssqe``: (kind, planned query, output
        names), kind "columnar" (a scan leaf's bitmap path; names are
        (output, source column) pairs) or "rows"; None for a leaf shape the
        single-stage engine has no form for. Nothing here touches the
        device."""
        node = stage.root
        agg: Optional[AggregateNode] = None
        if isinstance(node, AggregateNode):
            agg = node
            node = node.inputs[0]
        filters = []
        while isinstance(node, FilterNode):
            filters.append(node.condition)
            node = node.inputs[0]
        if not isinstance(node, TableScanNode):
            return None
        scan = node
        unq = dict(zip(scan.schema, scan.source_columns))
        eng = self.leaf_engine

        cond = None
        for f in filters:
            cond = f if cond is None else EC.for_function("and", cond, f)
        fctx = None
        if cond is not None:
            fctx = filter_from_expression(_unqualify(cond, unq))

        if agg is None:
            # plain scan+filter leaf: the filter is pushed into the
            # QueryContext, so only the columns the exchange actually
            # ships (send_schema) need to be selected — consumed filter
            # columns stay on the server
            names = [c for c in (stage.send_schema or list(scan.schema))
                     if c in unq] or list(scan.schema)
            select = [EC.for_identifier(unq[c]) for c in names]
            qc = QueryContext(
                table_name=scan.table, select_expressions=select,
                aliases=[None] * len(select), filter=fctx, limit=_LEAF_LIMIT,
                query_options=dict(self.query_options)).finish()
            planned = eng.plan_selection_columnar(qc)
            if planned is not None:
                return "columnar", planned, [(q, unq[q]) for q in names]
            return "rows", _plan_counted(eng, qc), names

        select: list[EC] = []
        for g in agg.group_exprs:
            select.append(_unqualify(g, unq))
        for call in agg.agg_calls:
            if call.extra:
                return None
            args = [_unqualify(a, unq) for a in call.args] or \
                [EC.for_identifier("*")]
            e = EC.for_function(call.name, *args)
            if call.condition is not None:
                # AGG(x) FILTER (WHERE cond) — the V1 grammar's form
                e = EC.for_function(
                    "filter", e, _unqualify(call.condition, unq))
            select.append(e)
        qc = QueryContext(
            table_name=scan.table, select_expressions=select,
            aliases=[None] * len(select),
            group_by_expressions=[_unqualify(g, unq) for g in agg.group_exprs],
            filter=fctx, limit=_LEAF_LIMIT,
            query_options=dict(self.query_options))
        return "rows", _plan_counted(eng, qc.finish()), list(agg.schema)

    def _resp_to_block(self, resp, names: list[str]) -> Optional[Block]:
        self.stats["num_docs_scanned"] += resp.num_docs_scanned
        self.stats["total_docs"] += resp.total_docs
        self.stats["num_device_dispatches"] += resp.num_device_dispatches
        if getattr(resp, "num_groups_limit_reached", False):
            self.stats["num_groups_limit_reached"] = True
        rt = resp.result_table
        if rt is None:
            # empty result still counts as a successful pushdown — a None
            # here would re-run the leaf on the generic path
            return {name: np.empty(0, object) for name in names}
        rows = rt.rows
        out: Block = {}
        for j, name in enumerate(names):
            ctype = rt.schema.column_types[j] if j < len(rt.schema.column_types) else "STRING"
            vals = [r[j] for r in rows]
            if ctype in ("INT", "LONG", "TIMESTAMP"):
                out[name] = np.asarray(vals, dtype=np.int64) if vals else np.empty(0, np.int64)
            elif ctype in ("FLOAT", "DOUBLE"):
                out[name] = np.asarray(vals, dtype=np.float64) if vals else np.empty(0, np.float64)
            elif ctype == "BOOLEAN":
                out[name] = np.asarray(vals, dtype=bool) if vals else np.empty(0, bool)
            else:
                out[name] = np.asarray(vals, dtype=object) if vals else np.empty(0, object)
        return out


def _unqualify(e: EC, mapping: dict) -> EC:
    if e.is_identifier:
        name = mapping.get(e.identifier)
        if name is None:
            raise KeyError(e.identifier)
        return EC.for_identifier(name)
    if e.is_function:
        return EC.for_function(e.function.name,
                               *[_unqualify(a, mapping) for a in e.function.arguments])
    return e
