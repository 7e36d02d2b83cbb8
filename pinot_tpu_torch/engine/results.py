"""Intermediate + final result containers.

The port of pinot_tpu/engine/results.py for aggregation, GROUP BY and
selection queries. Intermediates are host-side and keyed by group VALUES, not dict
ids: dict ids are segment-local.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional


@dataclass
class DataSchema:
    column_names: list[str]
    column_types: list[str]  # INT/LONG/FLOAT/DOUBLE/BOOLEAN/STRING/...

    def to_json(self) -> dict:
        return {"columnNames": self.column_names, "columnDataTypes": self.column_types}


@dataclass
class ResultTable:
    schema: DataSchema
    rows: list[list]

    def to_json(self) -> dict:
        return {"dataSchema": self.schema.to_json(), "rows": self.rows}


@dataclass
class BrokerResponse:
    """Final response shape (reference BrokerResponseNative)."""

    result_table: Optional[ResultTable] = None
    num_docs_scanned: int = 0
    total_docs: int = 0
    num_segments_queried: int = 0
    num_segments_processed: int = 0
    # segments the pruner (engine/pruner.py) skipped before planning
    num_segments_pruned: int = 0
    time_used_ms: float = 0.0
    # device kernel-program dispatches (engine/executor.py counters): one
    # per batch family, one per segment outside a family, one per
    # coalesced group (counted on its leader's query alone)
    num_device_dispatches: int = 0
    # programs compiled for this query: always 0, eager PyTorch compiles
    # none (the JAX package counts its jit compiles here)
    num_compiles: int = 0
    # the span list of a traced query (`SET trace = true`, spi/trace.py)
    trace_info: Optional[list] = None
    # cross-query coalescing (engine/coalesce.py): the peer queries whose
    # family dispatch this query shared (every member reports the group
    # size less one) and how long this query held for its group
    num_coalesced_queries: int = 0
    coalesce_wait_ms: float = 0.0
    # a sparse group-by trimmed groups at numGroupsLimit (not by an exact
    # ORDER BY pushdown)
    num_groups_limit_reached: bool = False
    # multi-stage statements only (mse/executor.py): a failure, as
    # "<ExceptionType>: <message>" (the single-stage path raises instead)
    exceptions: list = field(default_factory=list)
    # a BREAK-mode join guard truncated the result (reference:
    # maxRowsInJoinReached)
    partial_result: bool = False
    # stage_id -> {rows_in, rows_out, shuffled_rows, shuffled_bytes,
    # wall_ms, workers, leaf_pushdown, join_impl, host_crossings, ...}
    mse_stage_stats: Optional[dict] = None
    # segment partial-result cache (cache/partial.py): kept segments served
    # from the cache and kept segments computed and inserted
    num_segments_cache_hit: int = 0
    num_segments_cache_miss: int = 0
    # result caches (mse/executor.py, cluster/broker.py): "hit", "miss",
    # or "" / "bypass" when the statement bypassed them
    cache_outcome: str = ""
    # scatter/gather accounting of the cluster broker (cluster/broker.py;
    # reference numServersQueried/Responded): responded < queried implies
    # a degraded path; RPCs re-scattered to another replica, straggler
    # RPCs duplicated after the hedge delay and hedges that beat their
    # primary, and shards whose DataTable failed its checksum and were
    # re-dispatched
    num_servers_queried: int = 0
    num_servers_responded: int = 0
    num_scatter_retries: int = 0
    num_hedged_requests: int = 0
    num_hedge_wins: int = 0
    num_corrupt_shards_retried: int = 0
    # the broker's admission control shed this query (429-style rejection)
    query_rejected: bool = False
    # tiered storage: cold (metadata-only) segments still warming when the
    # response was assembled; the answer may be partial, never wrong
    cold_segments_warming: int = 0
    # the broker's query id (shards carry "<query_id>:<n>")
    query_id: str = ""
    # the wire of a cluster query, one entry per answered shard: server
    # execute_segments and encode ms, DataTable bytes, the RPC's wall ms
    # at the broker and its decode ms (cluster/broker.py)
    wire_stats: Optional[list] = None
    # the exchange of a cluster multi-stage statement (mse/distributed.py):
    # PTDP blob bytes and blocks shipped (and the bytes per sending
    # instance), mailbox bytes (total and the largest store's peak),
    # re-sent chunks dropped, stage workers and device per instance
    mse_exchange: Optional[dict] = None

    def to_json(self) -> dict:
        out = {
            "resultTable": self.result_table.to_json() if self.result_table else None,
            "numDocsScanned": self.num_docs_scanned,
            "totalDocs": self.total_docs,
            "numSegmentsQueried": self.num_segments_queried,
            "numSegmentsProcessed": self.num_segments_processed,
            "numSegmentsPrunedByServer": self.num_segments_pruned,
            "timeUsedMs": self.time_used_ms,
            "exceptions": self.exceptions,
        }
        if self.trace_info is not None:
            out["traceInfo"] = self.trace_info
        if self.partial_result:
            out["partialResult"] = True
        if self.mse_stage_stats is not None:
            out["mseStageStats"] = {str(k): v for k, v in
                                    self.mse_stage_stats.items()}
        if self.num_groups_limit_reached:
            out["numGroupsLimitReached"] = True
        if self.num_device_dispatches:
            out["numDeviceDispatches"] = self.num_device_dispatches
            out["numCompiles"] = self.num_compiles
        if self.num_segments_cache_hit or self.num_segments_cache_miss:
            out["numSegmentsCacheHit"] = self.num_segments_cache_hit
            out["numSegmentsCacheMiss"] = self.num_segments_cache_miss
        if self.num_servers_queried:
            out["numServersQueried"] = self.num_servers_queried
            out["numServersResponded"] = self.num_servers_responded
        if self.num_scatter_retries:
            out["numScatterRetries"] = self.num_scatter_retries
        if self.num_hedged_requests:
            out["numHedgedRequests"] = self.num_hedged_requests
            out["numHedgeWins"] = self.num_hedge_wins
        if self.num_corrupt_shards_retried:
            out["numCorruptShardsRetried"] = self.num_corrupt_shards_retried
        if self.query_rejected:
            out["queryRejected"] = True
        if self.cold_segments_warming:
            out["coldSegmentsWarming"] = self.cold_segments_warming
        if self.num_coalesced_queries:
            out["numCoalescedQueries"] = self.num_coalesced_queries
            out["coalesceWindowMs"] = self.coalesce_wait_ms
        return out


# -- per-segment intermediates ----------------------------------------------


@dataclass
class GroupByIntermediate:
    """group key tuple (values) -> list of per-agg states: the form of
    aggregations without a columnar one (sets, sketches, value histograms,
    tuples of sums), one Python object per group and aggregation."""

    groups: dict[tuple, list]
    num_docs_scanned: int = 0
    groups_trimmed: bool = False


class GroupArrays(GroupByIntermediate):
    """Columnar group-by intermediate.

    ``key_cols`` hold decoded group VALUES per dimension and
    ``state_cols[i]`` is a tuple of per-component arrays for aggregation i
    (avg -> (sum, count)). ``vec_specs[i]`` gives each component's merge op
    ("add"|"min"|"max"); ``fin_tags[i]`` a finalize recipe (("id",c) |
    ("div",a,b)). ``groups`` materializes the per-group dict lazily for the
    general reduce path (HAVING, post-aggregation expressions).
    """

    def __init__(self, key_cols, state_cols, vec_specs, fin_tags,
                 num_docs_scanned: int = 0, groups_trimmed: bool = False):
        self.key_cols = list(key_cols)
        self.state_cols = [tuple(c) for c in state_cols]
        self.vec_specs = [tuple(s) for s in vec_specs]
        self.fin_tags = list(fin_tags)
        self.num_docs_scanned = num_docs_scanned
        self.groups_trimmed = groups_trimmed
        self._groups: Optional[dict] = None

    @property
    def num_groups(self) -> int:
        if self.key_cols:
            return len(self.key_cols[0])
        if self.state_cols:
            return len(self.state_cols[0][0])
        return 0

    @property
    def groups(self) -> dict:
        if self._groups is None:
            keys = list(zip(*(c.tolist() for c in self.key_cols)))
            per_agg = []
            for comps in self.state_cols:
                lists = [c.tolist() for c in comps]
                per_agg.append(lists[0] if len(lists) == 1 else list(zip(*lists)))
            self._groups = {
                k: [pa[j] for pa in per_agg] for j, k in enumerate(keys)}
        return self._groups

    @groups.setter
    def groups(self, value):
        self._groups = value


@dataclass
class AggIntermediate:
    states: list  # one state per aggregation
    num_docs_scanned: int = 0


@dataclass
class SelectionIntermediate:
    columns: list[str]
    rows: list[tuple]
    num_docs_scanned: int = 0
