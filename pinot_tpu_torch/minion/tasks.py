"""Built-in minion tasks.

Reference analogue: pinot-plugins/pinot-minion-tasks/
pinot-minion-builtin-tasks/.../tasks/ — MergeRollupTask,
RealtimeToOfflineSegmentsTask, PurgeTask, RefreshSegmentTask,
UpsertCompactionTask, SegmentGenerationAndPushTask. Each is a
(generator, executor) pair registered with the framework; generators run on
the controller (PinotTaskManager), executors on minions.

The port's copy of pinot_tpu/minion/tasks.py. One executor differs:
PurgeTask plans its purgeFilter through the port's single-stage planner
and evaluates it on the segment's device planes (the selection program's
filter bitmap), on the minion's device, where the JAX package evaluates
every filter on its host engine. A filter the planner refuses (one over a
raw var-width column) is evaluated on the port's host engine
(engine/host_executor.py), as there; an unknown column fails the task in
both.
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np

from ..cluster.controller import raw_table_name, table_name_with_type
from ..engine.aggregation import UnsupportedQueryError
from ..engine.executor import SegmentExecutor
from ..engine.host_executor import HostSegmentExecutor
from ..ops.kernels import unpack_outputs
from ..query.context import QueryContext
from ..query.expressions import ExpressionContext
from ..query.parser.sql import parse_filter_expression
from ..segment.bitpack import unpack_bitmap
from ..segment.builder import SegmentBuilder
from ..segment.device_cache import DeviceSegmentCache
from ..segment.loader import load_segment
from ..spi.data_types import Schema
from ..spi.table_config import TableConfig
from .framework import (
    TaskContext,
    TaskSpec,
    register_task_executor,
    register_task_generator,
)


# -- shared helpers ----------------------------------------------------------


def _schema_of(ctx: TaskContext, table: str) -> Schema:
    raw = raw_table_name(table)
    d = ctx.store.get(f"/SCHEMAS/{raw}")
    if d is None:
        raise KeyError(f"schema {raw} not registered")
    return Schema.from_json(d)


def _table_config_of(ctx: TaskContext, table: str) -> TableConfig:
    cfg = ctx.controller.table_config(table) or {}
    return TableConfig(table_name=raw_table_name(table))if not cfg.get("pinotConfig") \
        else TableConfig.from_json(cfg["pinotConfig"])


def _load(ctx: TaskContext, table: str, segment_name: str):
    meta = ctx.controller.segment_metadata(table, segment_name)
    if meta is None:
        raise KeyError(f"{table}/{segment_name} has no metadata")
    location = meta["location"]
    if location.endswith((".tar.gz", ".tgz")):
        from ..ingestion.batch import untar_segment

        location = untar_segment(location, str(Path(ctx.work_dir) / "untar"))
    return load_segment(location)


def segment_rows(segment) -> list[dict]:
    """Materialize a segment as row dicts (minion rewrite path — the
    reference's SegmentProcessorFramework mapper input)."""
    cols = {}
    for c in segment.columns():
        md = segment.column_metadata(c)
        if md.single_value:
            cols[c] = segment.get_values(c)
        else:
            cols[c] = segment.get_mv_values(c)
    n = segment.num_docs
    nulls = {c: segment.get_null_bitmap(c) for c in segment.columns()}
    out = []
    for i in range(n):
        row = {}
        for c, vals in cols.items():
            if nulls.get(c) is not None and nulls[c][i]:
                row[c] = None
            else:
                v = vals[i]
                row[c] = (v.item() if isinstance(v, np.generic)
                          else list(v) if isinstance(v, np.ndarray) else v)
        out.append(row)
    return out


def _build_and_add(ctx: TaskContext, table: str, segment_name: str,
                   schema: Schema, rows: list[dict], extra_meta=None) -> str:
    out_dir = Path(ctx.work_dir) / table / segment_name
    # rebuild WITH the table config: index declarations and partition
    # stamping survive minion rewrites (reference SegmentProcessorFramework
    # builds from the table config too)
    SegmentBuilder(schema, table_config=_table_config_of(ctx, table),
                   segment_name=segment_name).build_from_rows(rows, out_dir)
    from ..segment.format import partition_push_metadata

    meta = {"location": str(out_dir), "numDocs": len(rows)}
    meta.update(partition_push_metadata(out_dir))
    meta.update(extra_meta or {})
    ctx.controller.add_segment(table, segment_name, meta)
    return segment_name


# -- MergeRollupTask ---------------------------------------------------------


def merge_rollup_generator(controller, table: str, cfg: dict) -> list[TaskSpec]:
    """Bundle small segments into one merge task (reference:
    MergeRollupTaskGenerator buckets by time + merge level; here one bundle
    per run capped by maxNumRecordsPerTask)."""
    max_records = int(cfg.get("maxNumRecordsPerTask", 5_000_000))
    segs = []
    total = 0
    for name in controller.store.children(f"/SEGMENTS/{table}"):
        meta = controller.segment_metadata(table, name) or {}
        if meta.get("mergedFrom"):
            continue  # don't re-merge outputs
        n = int(meta.get("numDocs", 0))
        if total + n > max_records and segs:
            break
        segs.append(name)
        total += n
    if len(segs) < 2:
        return []
    return [TaskSpec("MergeRollupTask", table,
                     {**cfg, "segments": segs})]


def _replace_via_lineage(ctx: TaskContext, table: str, from_names: list[str],
                         add_fn, to_names: list[str],
                         online_timeout_s: float = 30.0) -> None:
    """Atomic segment replacement: start lineage (brokers keep routing the
    FROM set, ignore TO), add the replacement segments, wait until every TO
    segment has an online replica, then commit the swap with the lineage
    state flip. On timeout the replacement is reverted so queries never see
    a half-swapped table (reference: PinotHelixResourceManager
    startReplaceSegments/endReplaceSegments driven from minion merge
    tasks)."""
    from ..cluster.periodic import SegmentLineageManager

    lineage = SegmentLineageManager(ctx.controller.store, ctx.controller)
    lid = lineage.start_replace(table, from_names, to_names)
    try:
        add_fn()
        store = ctx.controller.store
        deadline = time.time() + online_timeout_s
        live_key = "/LIVEINSTANCES"
        while True:
            view = store.get(f"/EXTERNALVIEW/{table}") or {}
            live = set(store.children(live_key))
            ok = all(
                any(st == "ONLINE" and inst in live
                    for inst, st in (view.get(seg) or {}).items())
                for seg in to_names)
            if ok:
                break
            if time.time() > deadline:
                raise TimeoutError(
                    f"replacement segments {to_names} never came online")
            time.sleep(0.02)
    except Exception:
        lineage.revert_replace(table, lid)
        raise
    lineage.end_replace(table, lid)


def merge_rollup_executor(ctx: TaskContext, spec: TaskSpec) -> dict:
    """Concat or rollup N segments into one (reference:
    MergeRollupTaskExecutor over SegmentProcessorFramework)."""
    table = spec.table
    schema = _schema_of(ctx, table)
    names = spec.config["segments"]
    merge_type = spec.config.get("mergeType", "concat").lower()
    rows: list[dict] = []
    for name in names:
        rows.extend(segment_rows(_load(ctx, table, name)))
    if merge_type == "rollup":
        rows = _rollup(schema, rows, spec.config)
    out_name = f"merged_{raw_table_name(table)}_{int(time.time() * 1000)}"
    _replace_via_lineage(
        ctx, table, names,
        lambda: _build_and_add(ctx, table, out_name, schema, rows,
                               {"mergedFrom": names}),
        [out_name])
    return {"outputSegment": out_name, "numDocs": len(rows),
            "merged": names}


def _rollup(schema: Schema, rows: list[dict], cfg: dict) -> list[dict]:
    """Group by every dimension/date-time column, aggregate metrics
    (default SUM; cfg 'aggregationTypes': {metric: SUM|MIN|MAX})."""
    key_cols = [c for c in schema.column_names()
                if c not in schema.metric_names()]
    metrics = schema.metric_names()
    aggs = {m: (cfg.get("aggregationTypes", {}).get(m, "SUM")).upper()
            for m in metrics}
    grouped: dict[tuple, dict] = {}
    for row in rows:
        key = tuple(_hashable(row.get(c)) for c in key_cols)
        cur = grouped.get(key)
        if cur is None:
            grouped[key] = dict(row)
            continue
        for m in metrics:
            a, b = cur.get(m), row.get(m)
            if a is None:
                cur[m] = b
            elif b is not None:
                cur[m] = (a + b if aggs[m] == "SUM"
                          else min(a, b) if aggs[m] == "MIN" else max(a, b))
    return list(grouped.values())


def _hashable(v):
    return tuple(v) if isinstance(v, (list, np.ndarray)) else v


# -- RealtimeToOfflineSegmentsTask -------------------------------------------


def rt2off_generator(controller, table: str, cfg: dict) -> list[TaskSpec]:
    """Move committed realtime segments into the offline twin (reference:
    RealtimeToOfflineSegmentsTaskGenerator windows on the time column with
    a watermark; here: all registered realtime segments not yet moved)."""
    if not table.endswith("_REALTIME"):
        return []
    moved = set(controller.store.get(f"/MINION_WATERMARKS/{table}") or [])
    segs = [s for s in controller.store.children(f"/SEGMENTS/{table}")
            if s not in moved]
    if not segs:
        return []
    return [TaskSpec("RealtimeToOfflineSegmentsTask", table,
                     {**cfg, "segments": segs})]


def rt2off_executor(ctx: TaskContext, spec: TaskSpec) -> dict:
    table = spec.table
    offline = table_name_with_type(raw_table_name(table), "OFFLINE")
    if ctx.controller.table_config(offline) is None:
        raise KeyError(f"offline twin {offline} does not exist")
    schema = _schema_of(ctx, table)
    time_col = (ctx.controller.table_config(offline) or {}).get("timeColumn")
    rows = []
    for name in spec.config["segments"]:
        rows.extend(segment_rows(_load(ctx, table, name)))
    out_name = f"{raw_table_name(table)}_rt2off_{int(time.time() * 1000)}"
    extra = {}
    if time_col and rows:
        tv = [r[time_col] for r in rows if r.get(time_col) is not None]
        if tv:
            extra = {"startTimeMs": min(tv), "endTimeMs": max(tv)}
    _build_and_add(ctx, offline, out_name, schema, rows, extra)
    ctx.store.update(f"/MINION_WATERMARKS/{table}", lambda cur: sorted(
        set(cur or []) | set(spec.config["segments"])))
    return {"outputSegment": out_name, "offlineTable": offline,
            "numDocs": len(rows)}


# -- PurgeTask ---------------------------------------------------------------


def purge_generator(controller, table: str, cfg: dict) -> list[TaskSpec]:
    segs = controller.store.children(f"/SEGMENTS/{table}")
    return [TaskSpec("PurgeTask", table, {**cfg, "segments": segs})] if segs else []


def purge_mask(segment, fctx, device) -> np.ndarray:
    """The rows of ``segment`` that match ``fctx``, as a bool mask: the
    single-stage planner lowers the filter, and a selection program
    evaluates it over the segment's planes on ``device`` (ops/kernels.py
    _eval_filter) and packs it into the bitmap that one copy brings to the
    host. A filter the planner refuses is evaluated on the host engine."""
    col = next(c for c in segment.columns()
               if segment.column_metadata(c).single_value)
    qc = QueryContext(
        table_name=segment.name, select_expressions=[
            ExpressionContext.for_identifier(col)],
        aliases=[None], filter=fctx,
        limit=max(1, segment.num_docs)).finish()
    executor = SegmentExecutor(DeviceSegmentCache(device))
    try:
        plan = executor.plan(qc, segment)
    except UnsupportedQueryError:
        return HostSegmentExecutor()._filter_mask(fctx, segment)
    bitmap = unpack_outputs(executor.dispatch_plan(segment, plan))[0]
    return unpack_bitmap(np.asarray(bitmap), segment.num_docs)


def purge_executor(ctx: TaskContext, spec: TaskSpec) -> dict:
    """Rewrite segments dropping rows that match purgeFilter (reference:
    PurgeTaskExecutor with a RecordPurger; the filter here is a SQL boolean
    expression over the row, evaluated on the minion's device)."""
    table = spec.table
    schema = _schema_of(ctx, table)
    fctx = parse_filter_expression(spec.config["purgeFilter"])
    purged = {}
    for name in spec.config["segments"]:
        seg = _load(ctx, table, name)
        mask = purge_mask(seg, fctx, ctx.device)  # rows to PURGE
        if not mask.any():
            continue
        rows = [r for r, m in zip(segment_rows(seg), mask) if not m]
        new_name = f"{name}_purged"
        _replace_via_lineage(
            ctx, table, [name],
            lambda new_name=new_name, rows=rows:
                _build_and_add(ctx, table, new_name, schema, rows),
            [new_name])
        purged[name] = int(mask.sum())
    return {"purged": purged}


# -- UpsertCompactionTask ----------------------------------------------------


def upsert_compaction_executor(ctx: TaskContext, spec: TaskSpec) -> dict:
    """Rewrite segments keeping only upsert-valid docs (reference:
    UpsertCompactionTaskExecutor reads validDocIds from the server). The
    validity snapshot rides in the task config as {segment: [valid doc
    ids]} since minions don't share server memory."""
    table = spec.table
    schema = _schema_of(ctx, table)
    compacted = {}
    for name, valid_ids in spec.config["validDocIds"].items():
        seg = _load(ctx, table, name)
        keep = set(valid_ids)
        rows = [r for i, r in enumerate(segment_rows(seg)) if i in keep]
        if len(rows) == seg.num_docs:
            continue
        new_name = f"{name}_compacted"
        _replace_via_lineage(
            ctx, table, [name],
            lambda new_name=new_name, rows=rows:
                _build_and_add(ctx, table, new_name, schema, rows),
            [new_name])
        compacted[name] = seg.num_docs - len(rows)
    return {"compacted": compacted}


def upsert_compact_merge_executor(ctx: TaskContext, spec: TaskSpec) -> dict:
    """Compact N upsert segments AND merge the survivors into one segment
    (reference: UpsertCompactMergeTaskExecutor — the compact-only task
    still leaves many small segments; this variant concats the valid rows
    of a group of segments into a single replacement). Validity snapshots
    ride in the config exactly like UpsertCompactionTask."""
    table = spec.table
    schema = _schema_of(ctx, table)
    valid_ids = spec.config["validDocIds"]  # {segment: [valid doc ids]}
    group = spec.config.get("segments") or sorted(valid_ids)
    rows: list[dict] = []
    dropped = 0
    for name in group:
        seg = _load(ctx, table, name)
        keep = set(valid_ids.get(name, range(seg.num_docs)))
        kept = [r for i, r in enumerate(segment_rows(seg)) if i in keep]
        dropped += seg.num_docs - len(kept)
        rows.extend(kept)
    new_name = spec.config.get(
        "mergedSegmentName", f"{group[0]}_merged_{len(group)}")
    _replace_via_lineage(
        ctx, table, group,
        lambda: _build_and_add(ctx, table, new_name, schema, rows),
        [new_name])
    return {"merged": group, "outputSegment": new_name,
            "numDocs": len(rows), "invalidDropped": dropped}


# -- RefreshSegmentTask ------------------------------------------------------


def refresh_executor(ctx: TaskContext, spec: TaskSpec) -> dict:
    """Rebuild segments under the CURRENT schema/config so new indexes and
    schema evolution apply (reference: RefreshSegmentTaskExecutor)."""
    table = spec.table
    schema = _schema_of(ctx, table)
    refreshed = []
    for name in spec.config["segments"]:
        seg = _load(ctx, table, name)
        rows = segment_rows(seg)
        out_dir = Path(ctx.work_dir) / table / f"{name}_refreshed"
        SegmentBuilder(schema, table_config=_table_config_of(ctx, table),
                       segment_name=name).build_from_rows(rows, out_dir)
        from ..segment.format import partition_push_metadata

        meta = {"location": str(out_dir), "numDocs": len(rows),
                "refreshedAtMs": int(time.time() * 1000)}
        meta.update(partition_push_metadata(out_dir))
        ctx.controller.add_segment(table, name, meta)
        refreshed.append(name)
    return {"refreshed": refreshed}


# -- SegmentGenerationAndPushTask --------------------------------------------


def segment_gen_push_generator(controller, table: str,
                               cfg: dict) -> list[TaskSpec]:
    """ONE TASK PER INPUT FILE — the distributed batch-ingestion runner.

    The reference distributes file→segment build tasks over cluster
    executors (pinot-plugins/pinot-batch-ingestion/
    pinot-batch-ingestion-spark-3/.../SparkSegmentGenerationJobRunner.java
    parallelizes the input-file URI list; SegmentGenerationAndPushTask's
    generator emits tableMaxNumTasks single-file tasks). Here each file
    becomes its own TaskSpec, so any number of minion workers — on any
    host sharing the property store and filesystem — claim and build
    concurrently. Files already ingested are skipped by checking pushed
    segments' ``inputFile`` marker, mirroring the reference generator's
    ZK-metadata dedup."""
    from ..ingestion.batch import IngestionJobLauncher, SegmentGenerationJobSpec

    schema_raw = controller.store.get(f"/SCHEMAS/{raw_table_name(table)}")
    if schema_raw is None:
        raise KeyError(f"schema {raw_table_name(table)} not registered")
    job = SegmentGenerationJobSpec(
        input_dir_uri=cfg["inputDirURI"],
        output_dir_uri=cfg.get("outputDirURI", cfg["inputDirURI"]),
        schema=Schema.from_json(schema_raw),
        table_config=TableConfig(table_name=raw_table_name(table)),
        include_file_name_pattern=cfg.get("includeFileNamePattern"),
    )
    files = sorted(IngestionJobLauncher(job).list_input_files())
    done = set()
    for seg in controller.store.children(f"/SEGMENTS/{table}"):
        meta = controller.segment_metadata(table, seg) or {}
        if meta.get("inputFile"):
            done.add(meta["inputFile"])
    # also skip files with a non-terminal task in flight (reference: the
    # generator checks task states so a scheduler tick during a long build
    # cannot double-ingest a file)
    for tid in controller.store.children("/TASKS/SegmentGenerationAndPushTask"):
        t = controller.store.get(
            f"/TASKS/SegmentGenerationAndPushTask/{tid}") or {}
        if t.get("table") == table and t.get("state") in ("PENDING", "RUNNING"):
            f = (t.get("config") or {}).get("inputFile")
            if f:
                done.add(f)
    max_tasks = int(cfg.get("tableMaxNumTasks", 0) or 0)
    new_files = [p for p in files if p not in done]
    if max_tasks:
        new_files = new_files[:max_tasks]
    if not new_files:
        return []
    # sequence ids come from a monotonic per-table counter in the store —
    # NOT the file's position in today's listing, which would reuse a
    # consumed seq (and thus a segment name) when a late-arriving file
    # sorts before already-ingested ones. An ABSENT counter seeds past any
    # existing `{prefix}_{n}` segments (tables first loaded through the
    # standalone/whole-job path carry no counter, and reusing their names
    # would overwrite their metadata).
    import re as _re

    prefix = cfg.get("segmentNamePrefix") or raw_table_name(table)
    pat = _re.compile(rf"^{_re.escape(prefix)}_(\d+)$")
    floor = 0
    for seg in controller.store.children(f"/SEGMENTS/{table}"):
        m = pat.match(seg)
        if m:
            floor = max(floor, int(m.group(1)) + 1)
    base = {"n": 0}

    def alloc(cur):
        cur = max(int(cur or 0), floor)
        base["n"] = cur
        return cur + len(new_files)

    controller.store.update(f"/INGEST_SEQ/{table}", alloc)
    return [TaskSpec("SegmentGenerationAndPushTask", table,
                     config=dict(cfg, inputFile=path,
                                 sequenceId=base["n"] + i))
            for i, path in enumerate(new_files)]


def segment_gen_push_executor(ctx: TaskContext, spec: TaskSpec) -> dict:
    """Batch build + push as a minion task (reference:
    SegmentGenerationAndPushTaskExecutor). With ``inputFile`` in the
    config (set by the per-file generator) this builds exactly one file —
    the unit of cluster-wide distribution; without it, the whole job runs
    in-process (the standalone fallback)."""
    from ..ingestion.batch import (
        IngestionJobLauncher,
        SegmentGenerationJobSpec,
        _generate_one_job,
        push_segments_to_cluster,
    )

    table = spec.table
    schema = _schema_of(ctx, table)
    job = SegmentGenerationJobSpec(
        input_dir_uri=spec.config["inputDirURI"],
        output_dir_uri=spec.config.get(
            "outputDirURI", str(Path(ctx.work_dir) / table / "generated")),
        schema=schema,
        table_config=TableConfig(table_name=raw_table_name(table)),
        input_format=spec.config.get("inputFormat"),
        include_file_name_pattern=spec.config.get("includeFileNamePattern"),
        segment_name_prefix=spec.config.get("segmentNamePrefix"),
    )
    if spec.config.get("inputFile"):
        r = _generate_one_job(job, spec.config["inputFile"],
                              int(spec.config.get("sequenceId", 0)))
        push_segments_to_cluster([r], ctx.controller, table,
                                 extra_meta={"inputFile":
                                             spec.config["inputFile"]})
        return {"segments": [r.segment_name], "numDocs": r.num_docs,
                "inputFile": spec.config["inputFile"]}
    results = IngestionJobLauncher(job).run()
    push_segments_to_cluster(results, ctx.controller, table)
    return {"segments": [r.segment_name for r in results],
            "numDocs": sum(r.num_docs for r in results)}


# -- registration ------------------------------------------------------------

register_task_generator("MergeRollupTask", merge_rollup_generator)
register_task_executor("MergeRollupTask", merge_rollup_executor)
register_task_generator("RealtimeToOfflineSegmentsTask", rt2off_generator)
register_task_executor("RealtimeToOfflineSegmentsTask", rt2off_executor)
register_task_generator("PurgeTask", purge_generator)
register_task_executor("PurgeTask", purge_executor)
register_task_executor("UpsertCompactionTask", upsert_compaction_executor)
register_task_executor("UpsertCompactMergeTask", upsert_compact_merge_executor)
register_task_executor("RefreshSegmentTask", refresh_executor)
register_task_generator("SegmentGenerationAndPushTask",
                        segment_gen_push_generator)
register_task_executor("SegmentGenerationAndPushTask", segment_gen_push_executor)
