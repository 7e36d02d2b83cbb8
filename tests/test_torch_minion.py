"""The port's minion (task framework and built-in tasks) against the JAX
package's.

The cases of `tests/test_minion.py`, each run on a cluster of each package
(the port's servers on the CPU, the JAX package's on its host backend, as
its own tests run them; the port's minion runs its device work on the
CPU) over the same input segments, built by the port's builder. Each case
compares what the two packages leave behind: the task states and
outputs, the table's segment list, the lineage replacements the tasks
started, and the broker's answers, with the timestamps in generated
segment names taken out. A refresh case covers the eighth task type. The
purge mask, which the port evaluates with the planner's filter on the
device planes (on its host engine for a filter the planner refuses),
must equal the JAX host engine's mask on the same segment. Tolerance:
exact.
"""

from __future__ import annotations

import re
import uuid
from types import SimpleNamespace

import numpy as np
import pytest

import pinot_tpu.connectors as jconnectors
import pinot_tpu.minion as jminion
import pinot_tpu.minion.framework as jframework
import pinot_tpu.minion.tasks as jtasks
import pinot_tpu_torch.connectors as pconnectors
import pinot_tpu_torch.minion as pminion
import pinot_tpu_torch.minion.framework as pframework
import pinot_tpu_torch.minion.tasks as ptasks
from _torch_ops import JAX, PORT
from pinot_tpu.engine.host_executor import HostSegmentExecutor
from pinot_tpu.query.parser.sql import \
    parse_filter_expression as jax_parse_filter
from pinot_tpu.segment.loader import load_segment as jax_load
from pinot_tpu.spi.data_types import Schema as JaxSchema
from pinot_tpu_torch.engine.aggregation import UnsupportedQueryError
from pinot_tpu_torch.engine.executor import SegmentExecutor as PlanningExecutor
from pinot_tpu_torch.query.context import QueryContext
from pinot_tpu_torch.query.expressions import ExpressionContext
from pinot_tpu_torch.segment.device_cache import DeviceSegmentCache
from pinot_tpu_torch.query.parser.sql import parse_filter_expression
from pinot_tpu_torch.segment.builder import SegmentBuilder
from pinot_tpu_torch.segment.loader import load_segment
from pinot_tpu_torch.spi.data_types import Schema
from pinot_tpu_torch.spi.table_config import IndexingConfig, TableConfig

SPEC = {"dimensions": [("host", "STRING"), ("day", "INT")],
        "metrics": [("cpu", "DOUBLE")]}
SCHEMA = Schema.build("metrics", **SPEC)

PKGS = {
    "port": SimpleNamespace(ops=PORT, minion=pminion, framework=pframework,
                            tasks=ptasks, connectors=pconnectors,
                            schema=SCHEMA, minion_kw={"device": "cpu"}),
    "jax": SimpleNamespace(ops=JAX, minion=jminion, framework=jframework,
                           tasks=jtasks, connectors=jconnectors,
                           schema=JaxSchema.build("metrics", **SPEC),
                           minion_kw={}),
}
_STAMPED = re.compile(r"(merged_metrics|metrics_rt2off)_\d+")


def _norm(x):
    """x with the millisecond stamps of generated segment names taken
    out."""
    if isinstance(x, str):
        return _STAMPED.sub(r"\1_*", x)
    if isinstance(x, dict):
        return {_norm(k): _norm(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_norm(v) for v in x)
    return x


class Env:
    """One package's store, controller, server, broker, task manager and
    minion, and the lineage replacements its tasks started."""

    def __init__(self, pkg, root):
        cl = pkg.ops.cl
        self.pkg = pkg
        self.root = root
        self.store = cl.PropertyStore()
        self.controller = cl.ClusterController(self.store)
        self.server = cl.ServerInstance(self.store, "Server_0",
                                        **pkg.ops.server_kw)
        self.server.start()
        self.broker = cl.Broker(self.store)
        self.controller.add_schema(SCHEMA.to_json())
        self.task_mgr = pkg.minion.PinotTaskManager(self.store,
                                                    self.controller)
        self.minion = self.new_minion("Minion_0", "minion_work")
        self.lineage = []
        lineage_cls = pkg.ops.periodic.SegmentLineageManager
        start = lineage_cls.start_replace

        def recorded(mgr, table, from_segments, to_segments):
            self.lineage.append((table, list(from_segments),
                                 list(to_segments)))
            return start(mgr, table, from_segments, to_segments)

        self._mp = pytest.MonkeyPatch()
        self._mp.setattr(lineage_cls, "start_replace", recorded)

    def new_minion(self, name, work):
        return self.pkg.minion.MinionInstance(
            self.store, name, self.controller, str(self.root / work),
            **self.pkg.minion_kw)

    def add_segments(self, table, datasets):
        for i, rows in enumerate(datasets):
            name = f"seg_{i}"
            path = self.root / name
            SegmentBuilder(SCHEMA, None, name).build_from_rows(rows, path)
            self.controller.add_segment(table, name, {
                "location": str(path), "numDocs": len(rows)})

    def rows(self, sql):
        resp = self.broker.execute_sql(sql)
        assert not resp.exceptions, resp.exceptions
        return [list(r) for r in resp.result_table.rows]

    def segments(self, table):
        return _norm(self.store.children(f"/SEGMENTS/{table}"))

    def close(self):
        self._mp.undo()
        if hasattr(self.broker, "close"):
            self.broker.close()
        self.server.stop()
        self.controller.stop()


def _both(tmp_path, scenario):
    """scenario(env) on each package's cluster; the port's result after
    holding it equal to the JAX package's."""
    out = {}
    for name, pkg in PKGS.items():
        env = Env(pkg, tmp_path / name)
        try:
            out[name] = _norm(scenario(env))
        finally:
            env.close()
    assert out["port"] == out["jax"]
    return out["port"]


def _state(env, task_type, tid):
    st = env.task_mgr.task_state(task_type, tid)
    return {k: st.get(k) for k in ("state", "taskType", "table", "owner",
                                   "output")}


def test_merge_rollup_concat(tmp_path):
    def run(env):
        table = env.controller.create_table({
            "tableName": "metrics", "replication": 1,
            "taskConfigs": {"MergeRollupTask": {"mergeType": "concat"}}})
        env.add_segments(table, [
            [{"host": "a", "day": 1, "cpu": 0.5},
             {"host": "b", "day": 1, "cpu": 0.7}],
            [{"host": "a", "day": 2, "cpu": 0.9}],
        ])
        sql = "SELECT COUNT(*), SUM(cpu) FROM metrics"
        before = env.rows(sql)
        ids = env.task_mgr.schedule_tasks()
        ran = env.minion.run_pending_once()
        state = _state(env, "MergeRollupTask", ids[0])
        return {"ids": len(ids), "ran": ran, "state": state,
                "segments": env.segments(table), "lineage": env.lineage,
                "before": before, "after": env.rows(sql),
                "lineageStore": env.store.get(f"/LINEAGE/{table}")}

    got = _both(tmp_path, run)
    assert got["ids"] == got["ran"] == 1
    assert got["state"]["state"] == "COMPLETED"
    # one merged segment replaces the two inputs; results identical
    assert got["segments"] == [got["state"]["output"]["outputSegment"]]
    assert got["after"] == got["before"]


def test_merge_rollup_rollup(tmp_path):
    def run(env):
        table = env.controller.create_table({
            "tableName": "metrics", "replication": 1,
            "taskConfigs": {"MergeRollupTask": {"mergeType": "rollup"}}})
        env.add_segments(table, [
            [{"host": "a", "day": 1, "cpu": 1.0},
             {"host": "a", "day": 1, "cpu": 2.0}],
            [{"host": "a", "day": 1, "cpu": 4.0},
             {"host": "b", "day": 1, "cpu": 8.0}],
        ])
        env.task_mgr.schedule_tasks()
        env.minion.run_pending_once()
        return {"rows": env.rows(
            "SELECT host, SUM(cpu), COUNT(*) FROM metrics GROUP BY host "
            "ORDER BY host"), "lineage": env.lineage}

    got = _both(tmp_path, run)
    # 3 'a' rows rolled into one
    assert got["rows"] == [["a", 7.0, 1], ["b", 8.0, 1]]


def test_purge_task(tmp_path):
    def run(env):
        table = env.controller.create_table({
            "tableName": "metrics", "replication": 1,
            "taskConfigs": {"PurgeTask": {"purgeFilter": "host = 'evil'"}}})
        env.add_segments(table, [
            [{"host": "a", "day": 1, "cpu": 1.0},
             {"host": "evil", "day": 1, "cpu": 9.0},
             {"host": "b", "day": 2, "cpu": 2.0}],
        ])
        ids = env.task_mgr.schedule_tasks()
        env.minion.run_pending_once()
        return {"state": _state(env, "PurgeTask", ids[0]),
                "segments": env.segments(table), "lineage": env.lineage,
                "rows": env.rows(
                    "SELECT host FROM metrics ORDER BY host LIMIT 10")}

    got = _both(tmp_path, run)
    assert got["state"]["output"] == {"purged": {"seg_0": 1}}
    assert [x[0] for x in got["rows"]] == ["a", "b"]


def test_realtime_to_offline(tmp_path):
    def run(env):
        rt = env.controller.create_table({
            "tableName": "metrics", "tableType": "REALTIME",
            "replication": 1, "timeColumn": "day",
            "taskConfigs": {"RealtimeToOfflineSegmentsTask": {}}})
        off = env.controller.create_table({
            "tableName": "metrics", "tableType": "OFFLINE",
            "replication": 1, "timeColumn": "day"})
        env.add_segments(rt, [
            [{"host": "a", "day": 5, "cpu": 1.0},
             {"host": "b", "day": 6, "cpu": 2.0}],
        ])
        env.task_mgr.schedule_tasks()
        env.minion.run_pending_once()
        offline_segs = env.store.children(f"/SEGMENTS/{off}")
        meta = env.controller.segment_metadata(off, offline_segs[0])
        return {"offline": _norm(offline_segs),
                "time": (meta["startTimeMs"], meta["endTimeMs"]),
                "numDocs": meta["numDocs"],
                # re-scheduling produces no duplicate task (watermark)
                "again": env.task_mgr.schedule_tasks(table=rt)}

    got = _both(tmp_path, run)
    assert len(got["offline"]) == 1
    assert got["time"] == (5, 6) and got["again"] == []


def test_task_claim_exclusive(tmp_path):
    """Two minions race for one task; exactly one runs it."""
    def run(env):
        table = env.controller.create_table({
            "tableName": "metrics", "replication": 1,
            "taskConfigs": {"MergeRollupTask": {}}})
        env.add_segments(table, [[{"host": "a", "day": 1, "cpu": 1.0}],
                                 [{"host": "b", "day": 1, "cpu": 2.0}]])
        minion2 = env.new_minion("Minion_1", "m2")
        env.task_mgr.schedule_tasks()
        return env.minion.run_pending_once() + minion2.run_pending_once()

    assert _both(tmp_path, run) == 1


def test_error_surfaces(tmp_path):
    def run(env):
        table = env.controller.create_table({
            "tableName": "metrics", "replication": 1,
            "taskConfigs": {"PurgeTask": {
                "purgeFilter": "nonexistent_col = 1"}}})
        env.add_segments(table, [[{"host": "a", "day": 1, "cpu": 1.0}]])
        ids = env.task_mgr.schedule_tasks()
        env.minion.run_pending_once()
        st = env.task_mgr.task_state("PurgeTask", ids[0])
        return {"state": st["state"], "error": bool(st["error"]),
                "segments": env.segments(table)}

    got = _both(tmp_path, run)
    assert got == {"state": "ERROR", "error": True, "segments": ["seg_0"]}


def test_minion_never_assigned_segments(tmp_path):
    """A registered and live minion never receives segment assignments."""
    def run(env):
        env.minion.start()
        try:
            table = env.controller.create_table({"tableName": "metrics",
                                                 "replication": 1})
            env.add_segments(table, [[{"host": "a", "day": 1, "cpu": 1.0}]])
            ideal = env.store.get(f"/IDEALSTATES/{table}")
            return {"ideal": ideal,
                    "servers": env.controller.server_instances()}
        finally:
            env.minion.stop()

    got = _both(tmp_path, run)
    assert all("Minion_0" not in m for m in got["ideal"].values())
    assert got["servers"] == ["Server_0"]


def test_background_minion_polling(tmp_path):
    def run(env):
        table = env.controller.create_table({
            "tableName": "metrics", "replication": 1,
            "taskConfigs": {"MergeRollupTask": {}}})
        env.add_segments(table, [[{"host": "a", "day": 1, "cpu": 1.0}],
                                 [{"host": "b", "day": 1, "cpu": 2.0}]])
        env.minion.start()
        try:
            env.task_mgr.schedule_tasks()
            done = env.task_mgr.wait_all(timeout_s=10)
        finally:
            env.minion.stop()
        return {"done": done, "segments": env.segments(table),
                "rows": env.rows("SELECT COUNT(*), SUM(cpu) FROM metrics")}

    got = _both(tmp_path, run)
    assert got["done"] and got["rows"] == [[2, 3.0]]


def test_distributed_segment_generation_per_file_tasks(tmp_path):
    """One task per input file, built by two minion workers; rescheduling
    is a no-op thanks to the inputFile marker; a late file gets a fresh
    sequence id."""
    def run(env):
        input_dir = env.root / "input"
        input_dir.mkdir(parents=True)
        for i in range(3):
            (input_dir / f"part_{i}.csv").write_text(
                "host,day,cpu\n" + "".join(
                    f"h{i},{i + 1},{float(j)}\n" for j in range(4)))
        (input_dir / "ignore.txt").write_text("not data\n")
        table = env.controller.create_table({
            "tableName": "metrics", "replication": 1,
            "taskConfigs": {"SegmentGenerationAndPushTask": {
                "inputDirURI": str(input_dir),
                "outputDirURI": str(env.root / "generated"),
                "includeFileNamePattern": "*.csv",
            }}})
        ids = env.task_mgr.schedule_tasks()
        minion2 = env.new_minion("Minion_1", "minion2_work")
        ran = 0
        while True:
            a = env.minion.run_pending_once()
            b = minion2.run_pending_once()
            ran += a + b
            if not a and not b:
                break
        states = sorted(env.task_mgr.task_state(
            "SegmentGenerationAndPushTask", t)["state"] for t in ids)
        out = {"ids": len(ids), "ran": ran, "states": states,
               "rows": env.rows("SELECT COUNT(*), SUM(cpu) FROM metrics"),
               "again": env.task_mgr.schedule_tasks()}
        (input_dir / "part_3.csv").write_text("host,day,cpu\nh9,9,99.0\n")
        out["incremental"] = len(env.task_mgr.schedule_tasks())
        out["inflight"] = env.task_mgr.schedule_tasks()
        out["ran2"] = env.minion.run_pending_once()
        (input_dir / "a_first.csv").write_text("host,day,cpu\nh0,1,1.0\n")
        specs = env.pkg.tasks.segment_gen_push_generator(
            env.controller, table, {"inputDirURI": str(input_dir),
                                    "includeFileNamePattern": "*.csv"})
        out["late"] = [s.config["sequenceId"] for s in specs]
        out["segments"] = sorted(env.segments(table))
        out["count"] = env.rows("SELECT COUNT(*) FROM metrics")
        return out

    got = _both(tmp_path, run)
    assert got["ids"] == got["ran"] == 3
    assert got["states"] == ["COMPLETED"] * 3
    assert got["rows"] == [[12, 18.0]] and got["again"] == []
    assert got["incremental"] == 1 and got["inflight"] == []
    assert got["ran2"] == 1 and got["late"] == [4]
    assert len(got["segments"]) == 4 and got["count"] == [[13]]


def test_streaming_segment_writer_sink(tmp_path):
    """Row-at-a-time collect with a threshold flush; a restarted writer
    appends past the registered segments."""
    def run(env):
        env.controller.create_table({"tableName": "metrics",
                                     "replication": 1})
        out_dir = str(env.root / "sink_out")
        writer = env.pkg.connectors.StreamingSegmentWriter
        with writer(env.pkg.schema, out_dir, controller=env.controller,
                    partition_id=3, flush_max_rows=5) as w:
            for i in range(12):
                w.collect({"host": f"h{i % 2}", "day": i, "cpu": float(i)})
        first = [s.rsplit("/", 1)[-1] for s in w.segments]
        rows = env.rows("SELECT COUNT(*), SUM(cpu) FROM metrics")
        with writer(env.pkg.schema, out_dir, controller=env.controller,
                    partition_id=3, flush_max_rows=5) as w2:
            w2.collect({"host": "h9", "day": 99, "cpu": 1.5})
        return {"first": first, "rows": rows,
                "second": [s.rsplit("/", 1)[-1] for s in w2.segments],
                "after": env.rows("SELECT COUNT(*), SUM(cpu) FROM metrics")}

    got = _both(tmp_path, run)
    assert got["first"] == ["metrics_3_0", "metrics_3_1", "metrics_3_2"]
    assert got["rows"] == [[12, 66.0]]
    assert got["second"] == ["metrics_3_3"] and got["after"] == [[13, 67.5]]


def _enqueue_task(env, task_type, table, config):
    fw = env.pkg.framework
    spec = fw.TaskSpec(task_type, table, config=config,
                       task_id=f"{task_type}_{uuid.uuid4().hex[:8]}")
    env.store.set(spec.path(), {
        "state": fw.PENDING, "table": spec.table,
        "taskType": spec.task_type, "config": spec.config, "owner": None,
        "output": None, "error": None})
    return spec.task_id


def test_upsert_compaction_task(tmp_path):
    def run(env):
        table = env.controller.create_table({"tableName": "metrics",
                                             "replication": 1})
        env.add_segments(table, [
            [{"host": "a", "day": 1, "cpu": 1.0},
             {"host": "a", "day": 2, "cpu": 2.0},
             {"host": "b", "day": 1, "cpu": 4.0}],
        ])
        tid = _enqueue_task(env, "UpsertCompactionTask", table,
                            {"validDocIds": {"seg_0": [1, 2]}})
        ran = env.minion.run_pending_once()
        return {"ran": ran, "state": _state(env, "UpsertCompactionTask", tid),
                "segments": env.segments(table), "lineage": env.lineage,
                "rows": env.rows("SELECT COUNT(*), SUM(cpu) FROM metrics")}

    got = _both(tmp_path, run)
    assert got["state"]["output"]["compacted"] == {"seg_0": 1}
    assert got["rows"] == [[2, 6.0]]


def test_upsert_compact_merge_task(tmp_path):
    def run(env):
        table = env.controller.create_table({"tableName": "metrics",
                                             "replication": 1})
        env.add_segments(table, [
            [{"host": "a", "day": 1, "cpu": 1.0},
             {"host": "b", "day": 1, "cpu": 2.0}],
            [{"host": "a", "day": 2, "cpu": 4.0},
             {"host": "c", "day": 2, "cpu": 8.0}],
        ])
        tid = _enqueue_task(env, "UpsertCompactMergeTask", table, {
            "validDocIds": {"seg_0": [1], "seg_1": [0, 1]},
            "segments": ["seg_0", "seg_1"]})
        env.minion.run_pending_once()
        return {"state": _state(env, "UpsertCompactMergeTask", tid),
                "segments": env.segments(table), "lineage": env.lineage,
                "rows": env.rows("SELECT host, SUM(cpu) FROM metrics "
                                 "GROUP BY host ORDER BY host")}

    got = _both(tmp_path, run)
    out = got["state"]["output"]
    assert out["invalidDropped"] == 1 and out["numDocs"] == 3
    assert got["segments"] == [out["outputSegment"]]
    assert got["rows"] == [["a", 4.0], ["b", 2.0], ["c", 8.0]]


def test_segment_generation_seeds_past_existing_segments(tmp_path):
    def run(env):
        input_dir = env.root / "inc"
        input_dir.mkdir(parents=True)
        table = env.controller.create_table({
            "tableName": "metrics", "replication": 1,
            "taskConfigs": {"SegmentGenerationAndPushTask": {
                "inputDirURI": str(input_dir),
                "outputDirURI": str(env.root / "gen2"),
                "includeFileNamePattern": "*.csv"}}})
        env.add_segments(table, [[{"host": "x", "day": 1, "cpu": 1.0}]])
        env.store.set(f"/SEGMENTS/{table}/metrics_0",
                      {"location": "x", "numDocs": 1})
        env.store.set(f"/SEGMENTS/{table}/metrics_1",
                      {"location": "y", "numDocs": 1})
        (input_dir / "new.csv").write_text("host,day,cpu\nh1,1,5.0\n")
        ids = env.task_mgr.schedule_tasks()
        t = env.store.get(f"/TASKS/SegmentGenerationAndPushTask/{ids[0]}")
        return {"ids": len(ids), "seq": t["config"]["sequenceId"]}

    got = _both(tmp_path, run)
    assert got["ids"] == 1 and got["seq"] >= 2  # past metrics_0/metrics_1


def test_refresh_task(tmp_path):
    """RefreshSegmentTask rebuilds a segment under the table's current
    config: the same rows, the segment's name kept."""
    def run(env):
        table = env.controller.create_table({"tableName": "metrics",
                                             "replication": 1})
        env.add_segments(table, [[{"host": "a", "day": 1, "cpu": 1.5},
                                  {"host": "b", "day": 2, "cpu": 2.5}]])
        tid = _enqueue_task(env, "RefreshSegmentTask", table,
                            {"segments": ["seg_0"]})
        env.minion.run_pending_once()
        meta = env.controller.segment_metadata(table, "seg_0")
        return {"state": _state(env, "RefreshSegmentTask", tid),
                "segments": env.segments(table),
                "refreshed": meta["location"].endswith("seg_0_refreshed"),
                "rows": env.rows("SELECT host, SUM(cpu) FROM metrics "
                                 "GROUP BY host ORDER BY host")}

    got = _both(tmp_path, run)
    assert got["state"]["output"] == {"refreshed": ["seg_0"]}
    assert got["refreshed"] and got["rows"] == [["a", 1.5], ["b", 2.5]]


# -- the purge mask -------------------------------------------------------------

MASK_SCHEMA = Schema.build(
    "m", dimensions=[("host", "STRING"), ("day", "INT"), ("tag", "STRING")],
    metrics=[("cpu", "DOUBLE"), ("n", "INT")])


@pytest.fixture(scope="module")
def mask_segment(tmp_path_factory):
    rng = np.random.default_rng(21)
    rows = 5000
    cols = {"host": np.asarray([f"h{k}" for k in rng.integers(0, 40, rows)],
                               dtype=object),
            "day": rng.integers(0, 30, rows).astype(np.int32),
            "tag": np.asarray([f"t{k}" for k in rng.integers(0, 5, rows)],
                              dtype=object),
            "cpu": np.round(rng.gamma(2.0, 10.0, rows), 3),
            "n": rng.integers(-100, 100, rows).astype(np.int32)}
    path = tmp_path_factory.mktemp("torch_purge") / "s0"
    cfg = TableConfig("m", indexing=IndexingConfig(
        no_dictionary_columns=["cpu", "n", "tag"]))
    SegmentBuilder(MASK_SCHEMA, cfg, "s0").build(cols, path)
    return path


@pytest.mark.parametrize("flt", [
    "host = 'h3'",
    "host IN ('h1', 'h2', 'h39') AND day > 10",
    "day BETWEEN 3 AND 7 OR n < -90",
    "NOT (day < 29)",
    "cpu > 50.5",
    "host LIKE 'h1%'",
    "n % 7 = 0",
])
def test_purge_mask_equals_the_jax_host_mask(mask_segment, flt):
    got = ptasks.purge_mask(load_segment(mask_segment),
                            parse_filter_expression(flt), "cpu")
    want = HostSegmentExecutor()._filter_mask(jax_parse_filter(flt),
                                              jax_load(mask_segment))
    assert got.dtype == np.bool_ and got.shape == want.shape
    assert np.array_equal(got, np.asarray(want, dtype=bool))
    assert 0 < got.sum() < len(got)


def test_purge_filter_over_a_raw_string_fails_the_task(mask_segment):
    """A filter over a raw var-width column has no device form: the
    planner refuses it and the port's PurgeTask evaluates it on its host
    engine, where the JAX package evaluates every filter; the mask is the
    JAX host engine's."""
    flt = "tag = 't1'"
    want = HostSegmentExecutor()._filter_mask(jax_parse_filter(flt),
                                              jax_load(mask_segment))
    assert 0 < int(np.sum(want)) < len(want)
    with pytest.raises(UnsupportedQueryError):
        PlanningExecutor(DeviceSegmentCache("cpu")).plan(
            _selection_of(flt), load_segment(mask_segment))
    got = ptasks.purge_mask(load_segment(mask_segment),
                            parse_filter_expression(flt), "cpu")
    assert np.array_equal(got, np.asarray(want, dtype=bool))


@pytest.mark.parametrize("flt", [
    "tag IN ('t0', 't4')",
    "tag LIKE 't%3' AND day < 20",
    "tag <> 't2' OR n > 50",
])
def test_purge_mask_over_raw_strings_equals_the_jax_host_mask(mask_segment,
                                                              flt):
    got = ptasks.purge_mask(load_segment(mask_segment),
                            parse_filter_expression(flt), "cpu")
    want = HostSegmentExecutor()._filter_mask(jax_parse_filter(flt),
                                              jax_load(mask_segment))
    assert np.array_equal(got, np.asarray(want, dtype=bool))
    assert 0 < got.sum() < len(got)


def _selection_of(flt):
    return QueryContext(
        table_name="m", select_expressions=[
            ExpressionContext.for_identifier("day")], aliases=[None],
        filter=parse_filter_expression(flt), limit=10).finish()
