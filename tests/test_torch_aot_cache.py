"""The port's AOT family cache (engine/aot_cache.py) against the JAX
package's.

  * Budget and ranking: `_make_room` and `_budget_candidates` take the
    same manifests (made from a numpy seed) in both packages and make the
    same decisions: what is evicted, what is admitted and in which order.
  * Off without PINOT_TPU_AOT_CACHE_DIR, as in the JAX package.
  * A family's first dispatch persists its record; after a restart in
    this process (ready state, family guard and registry cleared) the
    prewarm replays and installs it: the registry shows the family with
    no compile and no cold cost, and the next query counts `aotCacheHits`
    with the rows of the first run.
  * Refusals, each counting `aotCacheMisses` and leaving the family to
    dispatch as usual with the same rows: a mismatch in each field of the
    environment tag, a corrupt record (the `aot.load` fault, bit flip and
    truncation), a file that is missing or not a record.
  * A type-suffixed table name finds the records of the raw one.
  * A restart in a subprocess prewarms the persisted families at
    `add_table`, before the first query, which counts `aotCacheHits`.
Tolerance: exact.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from pinot_tpu.engine import aot_cache as jaot
from pinot_tpu_torch.engine import aot_cache
from pinot_tpu_torch.engine import executor as executor_mod
from pinot_tpu_torch.engine.compile_registry import COMPILE_REGISTRY
from pinot_tpu_torch.engine.query_executor import QueryExecutor
from pinot_tpu_torch.ops import fused_groupby, mxu_groupby
from pinot_tpu_torch.segment.builder import SegmentBuilder
from pinot_tpu_torch.segment.loader import load_segment
from pinot_tpu_torch.spi import faults
from pinot_tpu_torch.spi.data_types import Schema
from pinot_tpu_torch.spi.metrics import SERVER_METRICS, ServerMeter
from pinot_tpu_torch.spi.table_config import IndexingConfig, TableConfig

SCHEMA = Schema.build("aot", dimensions=[("k", "INT"), ("r", "STRING")],
                      metrics=[("v", "LONG"), ("w", "INT")])
# `w` raw, so its SUM is in the fused kernel's scope
CONFIG = TableConfig(table_name="aot", indexing=IndexingConfig(
    no_dictionary_columns=["w"]))
# a batch family through kernel A, and kernel B a segment
SQL = "SELECT k, COUNT(*), SUM(v) FROM aot GROUP BY k ORDER BY k LIMIT 1000"
SQL_FUSED = ("SET segmentBatch = false; SELECT k, SUM(w) FROM aot "
             "WHERE r = 'b' GROUP BY k ORDER BY k LIMIT 1000")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# -- budget and ranking -------------------------------------------------------


def _manifest(rng, n: int) -> dict:
    return {"files": {f"f{k}.aot": {
        "bytes": int(rng.integers(100, 600)),
        "score": float(np.round(rng.random() * 100, 3)),
        "fingerprint": f"fp{k:03d}", "table": "t"} for k in range(n)}}


@pytest.mark.parametrize("seed", range(8))
def test_make_room_equals_jax(tmp_path, monkeypatch, seed):
    monkeypatch.setenv("PINOT_TPU_AOT_CACHE_MB", str(2 / 1024))  # 2 KiB
    rng = np.random.default_rng(seed)
    manifest = _manifest(rng, int(rng.integers(0, 9)))
    need = int(rng.integers(50, 2500))
    score = float(rng.random() * 100)
    out = {}
    for label, mod in (("port", aot_cache), ("ref", jaot)):
        d = tmp_path / label
        d.mkdir()
        for name, m in manifest["files"].items():
            (d / name).write_bytes(b"x" * m["bytes"])
        mine = json.loads(json.dumps(manifest))
        ok = mod._make_room(str(d), mine, need, score)
        out[label] = (ok, mine, sorted(os.listdir(d)))
    assert out["port"] == out["ref"]


@pytest.mark.parametrize("seed", range(8))
def test_budget_candidates_equal_jax(monkeypatch, seed):
    rng = np.random.default_rng(100 + seed)
    monkeypatch.setenv("PINOT_TPU_AOT_PREWARM_BUDGET_MS",
                       str(float(rng.choice([0.0, 50.0, 150.0, 5000.0]))))
    items = list(_manifest(rng, int(rng.integers(1, 12)))["files"].items())
    got = aot_cache._budget_candidates(items)
    # both packages' live registries rank the persisted fingerprints alike
    # (none of them is live in either here)
    assert got == jaot._budget_candidates(items)
    assert got and set(got) <= {name for name, _ in items}


@pytest.mark.parametrize("name", ["events", "events_OFFLINE",
                                  "events_REALTIME", "x_OFFLINE_y", None])
def test_raw_table_equals_jax(name):
    assert aot_cache._raw_table(name) == jaot._raw_table(name)


def test_disabled_without_env(tmp_path, monkeypatch):
    monkeypatch.delenv("PINOT_TPU_AOT_CACHE_DIR", raising=False)
    monkeypatch.setenv("PINOT_TPU_SEGMENT_CACHE", "0")
    assert not aot_cache.enabled()
    qe = _executor(tmp_path / "segs")
    assert not qe.execute_sql(SQL).exceptions
    assert aot_cache.stats() == {"enabled": False, "ready": 0}
    assert aot_cache.prewarm_table("aot", device="cpu") == \
        {"loaded": 0, "refused": 0}
    assert aot_cache.start_recording() is None


# -- persist, prewarm, refusals -----------------------------------------------


def _build(seg_dir, rows: int = 2048):
    rng = np.random.default_rng(7)
    cols = {"k": rng.integers(0, 20, rows).astype(np.int32),
            "r": np.asarray(["a", "b", "c"], dtype=object)[
                rng.integers(0, 3, rows)],
            "v": rng.integers(-100, 100, rows).astype(np.int64),
            "w": rng.integers(0, 1000, rows).astype(np.int32)}
    segs = []
    for i in range(2):
        path = os.path.join(seg_dir, f"a{i}")
        if not os.path.isdir(path):
            SegmentBuilder(SCHEMA, CONFIG, f"a{i}").build(cols, path)
        segs.append(load_segment(path))
    return segs


def _executor(seg_dir):
    qe = QueryExecutor(device="cpu")
    qe.add_table(SCHEMA, _build(str(seg_dir)))
    return qe


def _restart():
    """Drop the in-process state of every family (the records on disk
    stay), as a process restart would."""
    aot_cache.reset()
    executor_mod._FAMILIES.clear()
    COMPILE_REGISTRY.reset()


def _meter(name: str) -> int:
    return SERVER_METRICS.snapshot()["meters"].get(name, 0)


def _rows(resp) -> list:
    assert not resp.exceptions, resp.exceptions
    return [list(r) for r in resp.result_table.rows]


def _records(d) -> list:
    return sorted(p for p in os.listdir(d) if p.endswith(".aot"))


@pytest.fixture
def aot_dir(tmp_path, monkeypatch):
    d = tmp_path / "aotcache"
    d.mkdir()
    monkeypatch.setenv("PINOT_TPU_AOT_CACHE_DIR", str(d))
    monkeypatch.setenv("PINOT_TPU_SEGMENT_CACHE", "0")
    monkeypatch.setenv("PINOT_TPU_RESULT_CACHE", "0")
    _restart()
    yield d
    _restart()


@pytest.fixture
def persisted(tmp_path, aot_dir):
    """An executor whose two families (kernel A over the family, kernel B
    a segment) persisted their records, and the first run's rows."""
    qe = _executor(tmp_path / "segs")
    rows = {sql: _rows(qe.execute_sql(sql)) for sql in (SQL, SQL_FUSED)}
    names = _records(aot_dir)
    assert len(names) == 2, names
    return qe, rows, names


def test_first_dispatch_persists_then_prewarm_installs(persisted, aot_dir):
    qe, rows, names = persisted
    manifest = json.load(open(aot_dir / "manifest.json"))
    assert set(manifest["files"]) == set(names)
    assert all(m["table"] == "aot" and m["score"] > 0
               for m in manifest["files"].values())
    _restart()
    got = aot_cache.prewarm_table("aot", device="cpu")
    assert got["loaded"] == 2 and got["refused"] == 0
    snap = COMPILE_REGISTRY.snapshot()
    assert snap["families"] == 2 and snap["totalDispatches"] == 0
    assert all(e["compiles"] == 0 and e["compileMsTotal"] == 0
               for e in snap["compiles"])
    fused = {e["family"]["fused"] for e in snap["compiles"]}
    assert fused == {"", "plain"}
    hits = _meter(ServerMeter.AOT_CACHE_HITS)
    for sql in (SQL, SQL_FUSED):
        assert _rows(qe.execute_sql(sql)) == rows[sql]
    # one family dispatch each, both served as installed families
    assert _meter(ServerMeter.AOT_CACHE_HITS) == hits + 3
    snap = COMPILE_REGISTRY.snapshot()
    assert snap["totalCompileMs"] == 0 and snap["totalDispatches"] == 3
    # an installed family is not replayed again when the table re-registers
    assert aot_cache.prewarm_table("aot", device="cpu")["loaded"] == 0


def test_records_replay_both_kernels(persisted, aot_dir):
    import pickle

    _, _, names = persisted
    kernels = set()
    for name in names:
        blob = pickle.loads((aot_dir / name).read_bytes())
        record = pickle.loads(blob["payload"])
        for spec in record["launches"]:
            kernels.add(spec["kernel"])
            assert spec["mode"] in ("private", "split", "shared", "global")
            out = aot_cache.replay([spec], "cpu")
            (fn, args, sums), = out
            plain = (mxu_groupby.limb_sums_plain if fn == "limb_sums"
                     else fused_groupby.fused_limb_sums_plain)
            assert torch.equal(sums, plain(*args))
        assert blob["envTag"] == aot_cache.env_tag("cpu")
        assert blob["family"]["batchSize"] in (0, 2)
    assert kernels == {"limb_sums", "fused_limb_sums"}


@pytest.mark.parametrize("field,value", [
    ("torch", "0.0.1"), ("cuda", "99.9"), ("deviceName", "NVIDIA H200"),
    ("capability", [10, 0]), ("csrc", "0" * 64)])
def test_env_tag_mismatch_refuses(persisted, aot_dir, field, value):
    qe, rows, names = persisted
    _restart()
    misses = _meter(ServerMeter.AOT_CACHE_MISSES)
    doctored = dict(aot_cache.env_tag("cpu"), **{field: value})
    assert aot_cache.load_artifact(str(aot_dir / names[0]),
                                   expect_tag=doctored, device="cpu") is None
    assert not aot_cache.AOT_READY
    assert _meter(ServerMeter.AOT_CACHE_MISSES) == misses + 1
    # the family dispatches as usual, with the same rows
    assert _rows(qe.execute_sql(SQL)) == rows[SQL]
    # under the real tag the same record loads: the refusal was the tag
    _restart()
    assert aot_cache.load_artifact(str(aot_dir / names[0]),
                                   device="cpu") is not None


@pytest.mark.parametrize("mode", ["bitflip", "truncate"])
def test_corrupt_record_refused_and_query_answers(persisted, mode):
    qe, rows, _ = persisted
    _restart()
    misses = _meter(ServerMeter.AOT_CACHE_MISSES)
    with faults.injected("aot.load", kind="corrupt", corrupt_mode=mode,
                         times=None):
        got = aot_cache.prewarm_table("aot", device="cpu")
    assert got["loaded"] == 0 and got["refused"] == 2
    assert not aot_cache.AOT_READY
    assert _meter(ServerMeter.AOT_CACHE_MISSES) == misses + 2
    for sql in (SQL, SQL_FUSED):
        assert _rows(qe.execute_sql(sql)) == rows[sql]
    # refused families register their first dispatch in this process
    assert COMPILE_REGISTRY.snapshot()["totalCompileMs"] > 0


def test_unreadable_and_garbage_files_refused(aot_dir):
    misses = _meter(ServerMeter.AOT_CACHE_MISSES)
    assert aot_cache.load_artifact(str(aot_dir / "nope.aot"),
                                   device="cpu") is None
    junk = aot_dir / "junk.aot"
    junk.write_bytes(b"not a pickle at all")
    assert aot_cache.load_artifact(str(junk), device="cpu") is None
    assert not aot_cache.AOT_READY
    assert _meter(ServerMeter.AOT_CACHE_MISSES) == misses + 2


def test_type_suffixed_table_names_match(persisted):
    _restart()
    assert aot_cache.prewarm_table("aot_OFFLINE", device="cpu")["loaded"] == 2
    _restart()
    assert aot_cache.prewarm_table("other", device="cpu")["loaded"] == 0


def test_top_k_and_budget_admission(persisted, monkeypatch):
    _restart()
    assert aot_cache.prewarm_table("aot", top_k=1, device="cpu")["loaded"] \
        == 1
    _restart()
    # a zero budget still admits the single most valuable family
    monkeypatch.setenv("PINOT_TPU_AOT_PREWARM_BUDGET_MS", "0")
    assert aot_cache.prewarm_table("aot", device="cpu")["loaded"] == 1


# -- restart in a subprocess --------------------------------------------------

_CHILD = r"""
import json, os, sys
sys.path.insert(0, sys.argv[2])
import numpy as np
from pinot_tpu_torch.engine.compile_registry import COMPILE_REGISTRY
from pinot_tpu_torch.engine.query_executor import QueryExecutor
from pinot_tpu_torch.segment.loader import load_segment
from pinot_tpu_torch.spi.data_types import Schema
from pinot_tpu_torch.spi.metrics import SERVER_METRICS

seg_dir = sys.argv[1]
schema = Schema.build("aot", dimensions=[("k", "INT"), ("r", "STRING")],
                      metrics=[("v", "LONG"), ("w", "INT")])
qe = QueryExecutor(device="cpu")
qe.add_table(schema, [load_segment(os.path.join(seg_dir, f"a{i}"))
                      for i in range(2)])  # prewarms when the cache is on
before = COMPILE_REGISTRY.snapshot()
resp = qe.execute_sql(
    "SELECT k, COUNT(*), SUM(v) FROM aot GROUP BY k ORDER BY k LIMIT 1000")
meters = SERVER_METRICS.snapshot()["meters"]
print(json.dumps({
    "rows": [[int(c) for c in row] for row in resp.result_table.rows],
    "before": {"families": before["families"],
               "compiles": before["totalCompiles"],
               "dispatches": before["totalDispatches"]},
    "dispatches": resp.num_device_dispatches,
    "compileMs": COMPILE_REGISTRY.totals()["compileMs"],
    "hits": meters.get("aotCacheHits", 0),
    "misses": meters.get("aotCacheMisses", 0),
}))
"""


def _run_child(seg_dir, env):
    out = subprocess.run([sys.executable, "-c", _CHILD, str(seg_dir), REPO],
                         capture_output=True, text=True, timeout=300,
                         env=env, cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_subprocess_restart_prewarms_before_the_first_query(tmp_path):
    seg_dir = tmp_path / "segs"
    seg_dir.mkdir()
    _build(str(seg_dir))
    env = dict(os.environ, PINOT_TPU_AOT_CACHE_DIR=str(tmp_path / "aot"),
               PINOT_TPU_SEGMENT_CACHE="0", PINOT_TPU_RESULT_CACHE="0",
               OMP_NUM_THREADS="1")
    env.pop("PINOT_TPU_COALESCE_WINDOW_MS", None)
    first = _run_child(seg_dir, env)
    assert first["before"]["families"] == 0 and first["hits"] == 0
    assert first["compileMs"] > 0
    assert _records(tmp_path / "aot")

    second = _run_child(seg_dir, env)
    assert second["rows"] == first["rows"]
    # prewarmed at add_table: known before the first query, no compile
    assert second["before"]["families"] >= 1
    assert second["before"]["compiles"] == second["before"]["dispatches"] \
        == 0
    assert second["hits"] == second["dispatches"] >= 1
    assert second["misses"] == 0 and second["compileMs"] == 0
