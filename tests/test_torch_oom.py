"""Device-memory pressure in the port (engine/oom.py), against the JAX
package.

The cases of tests/test_oom.py: an OOM during device work triggers one
relief (the device cache's partials, stacks and views but the executing
segment's, then the realtime planes) and one retry; a second OOM fails the
query alone with HbmExhaustedError (the port raises it, the JAX package
returns it as the response's exception), and the next query answers.

On the CPU nothing runs out of memory, so the error is injected at a seam
with the type PyTorch raises on the card (`torch.cuda.OutOfMemoryError`);
the JAX package gets the XLA error its own tests inject at the same seam.
Rows equal the JAX package's (`QueryExecutor(backend="tpu")`, its Pallas
kernels interpreted, its segment cache off, as the port's). Tolerance:
exact (integer sums and counts).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from jax.errors import JaxRuntimeError

from pinot_tpu.engine import oom as jax_oom
from pinot_tpu.engine.query_executor import QueryExecutor as JaxQueryExecutor
from pinot_tpu.segment.loader import load_segment as jax_load
from pinot_tpu.spi.data_types import Schema as JaxSchema
from pinot_tpu_torch.engine import oom
from pinot_tpu_torch.engine import query_executor as qe_module
from pinot_tpu_torch.engine.oom import (HbmExhaustedError, is_hbm_oom,
                                        oom_stats, relieve_pressure,
                                        with_oom_retry)
from pinot_tpu_torch.engine.query_executor import QueryExecutor
from pinot_tpu_torch.realtime.device_plane import REALTIME_PLANES
from pinot_tpu_torch.segment.builder import SegmentBuilder
from pinot_tpu_torch.segment.device_cache import DeviceSegmentCache
from pinot_tpu_torch.segment.loader import load_segment
from pinot_tpu_torch.segment.mutable import MutableSegment
from pinot_tpu_torch.spi.data_types import Schema

XLA_OOM = ("RESOURCE_EXHAUSTED: Error allocating device buffer: "
           "Attempting to allocate 12.50G. That was not possible. "
           "There are 5.17G free.")
CUDA_OOM = ("CUDA out of memory. Tried to allocate 12.50 GiB. GPU 0 has a "
            "total capacity of 79.19 GiB of which 5.17 GiB is free.")
SCHEMA = Schema.build("t", dimensions=[("g", "INT")], metrics=[("v", "INT")])
JAX_SCHEMA = JaxSchema.build("t", dimensions=[("g", "INT")],
                             metrics=[("v", "INT")])
GROUP_SQL = "SELECT g, SUM(v), COUNT(*) FROM t GROUP BY g ORDER BY g LIMIT 20"
SPARSE_SQL = ("SET sparseGroupBy = true; SELECT g, SUM(v), COUNT(*) FROM t "
              "GROUP BY g ORDER BY g LIMIT 20")


@pytest.fixture(autouse=True)
def _reference_dispatches_every_query(monkeypatch):
    monkeypatch.setenv("PINOT_TPU_SEGMENT_CACHE", "0")
    monkeypatch.setenv("PINOT_TPU_RESULT_CACHE", "0")
    monkeypatch.setenv("PINOT_TPU_MESH_DEVICES", "1")
    monkeypatch.setenv("PINOT_TPU_FUSED", "interpret")


def _cuda_oom():
    return torch.cuda.OutOfMemoryError(CUDA_OOM)


def _build(root, name, n=400, seed=0):
    rng = np.random.default_rng(seed)
    SegmentBuilder(SCHEMA, segment_name=name).build(
        {"g": rng.integers(0, 8, n).astype(np.int32),
         "v": rng.integers(0, 100, n).astype(np.int32)}, root / name)
    return root / name


@pytest.fixture
def table(tmp_path):
    """Four segments in both packages."""
    paths = [_build(tmp_path, f"s{i}", seed=i) for i in range(4)]
    port = QueryExecutor(device="cpu")
    port.add_table(SCHEMA, [load_segment(p) for p in paths])
    jax = JaxQueryExecutor(backend="tpu")
    jax.add_table(JAX_SCHEMA, [jax_load(p) for p in paths])
    return port, jax


def _rows(resp):
    assert not resp.exceptions, resp.exceptions
    return resp.result_table.rows


def _flaky(real, times=1):
    """`real` raising a CUDA OOM on its first `times` calls."""
    state = {"calls": 0}

    def call(*args, **kwargs):
        state["calls"] += 1
        if state["calls"] <= times:
            raise _cuda_oom()
        return real(*args, **kwargs)

    call.state = state
    return call


def test_is_hbm_oom_classification():
    assert is_hbm_oom(_cuda_oom())
    assert is_hbm_oom(MemoryError())
    # the tag the JAX package keys on qualifies a bare RuntimeError too
    for exc in (RuntimeError(XLA_OOM), MemoryError(), ValueError(XLA_OOM),
                RuntimeError("INVALID_ARGUMENT: bad shape"),
                RuntimeError("error allocating thread pool")):
        assert is_hbm_oom(exc) == jax_oom.is_hbm_oom(exc), exc
    assert not is_hbm_oom(ValueError(CUDA_OOM))
    assert not is_hbm_oom(RuntimeError("CUDA error: an illegal memory "
                                       "access was encountered"))


def test_oom_retry_succeeds_after_relief():
    before = oom_stats()
    fn = _flaky(lambda: "ok")
    freed = []
    assert with_oom_retry(fn, on_relief=freed.append) == "ok"
    assert fn.state["calls"] == 2 and len(freed) == 1
    after = oom_stats()
    assert after["reliefs"] == before["reliefs"] + 1
    assert after["failures"] == before["failures"]


def test_oom_retry_fails_cleanly_when_persistent():
    before = oom_stats()["failures"]
    with pytest.raises(HbmExhaustedError) as err:
        with_oom_retry(_flaky(lambda: "ok", times=2))
    assert isinstance(err.value.__cause__, torch.cuda.OutOfMemoryError)
    assert oom_stats()["failures"] == before + 1
    # the retry function, not the first, runs after the relief
    calls = []
    assert with_oom_retry(_flaky(lambda: "first"),
                          retry_fn=lambda: calls.append(1) or "retry") \
        == "retry"


def test_non_oom_errors_pass_through():
    before = oom_stats()["reliefs"]

    def boom():
        raise ValueError("unrelated")

    with pytest.raises(ValueError):
        with_oom_retry(boom)
    assert oom_stats()["reliefs"] == before


def test_relieve_pressure_keeps_current_segment(tmp_path):
    cache = DeviceSegmentCache("cpu")
    a = load_segment(_build(tmp_path, "a", seed=1))
    b = load_segment(_build(tmp_path, "b", seed=2))
    cache.view(a).dict_ids("g")
    cache.view(b).dict_ids("g")
    cache.stacked_view([a, b]).plane(("g",), lambda: torch.zeros(8))
    cache.put_partial(("k",), (torch.zeros(4, dtype=torch.int64),), "a")
    freed = relieve_pressure(keep_segment=b, cache=cache)
    assert freed == 8192 * 4 + 32 + 32
    assert list(cache._views) == [id(b)]
    assert cache.stats()["stackBytes"] == 0
    assert cache.stats()["partialEntries"] == 0


def test_relief_keeps_the_consuming_segment_it_runs(tmp_path):
    """A snapshot's planes live under its underlying segment: relief for
    one keeps those and drops every other realtime plane set."""
    live = [MutableSegment(SCHEMA, f"rt{i}") for i in range(2)]
    for seg in live:
        for r in range(50):
            seg.index({"g": r % 8, "v": r})
    port = QueryExecutor(device="cpu")
    port.add_table(SCHEMA, live)
    port.execute_sql("SET segmentBatch = false; " + GROUP_SQL)
    names = lambda: sorted(ps.name for d in REALTIME_PLANES._sets.values()  # noqa: E731
                           for ps in d.values())
    assert {"rt0", "rt1"} <= set(names())
    relieve_pressure(keep_segment=live[1].snapshot_view(),
                     cache=port.executor.cache)
    assert "rt1" in names() and "rt0" not in names()
    REALTIME_PLANES.clear()


@pytest.mark.parametrize("batch", [True, False], ids=["family", "solo"])
def test_query_survives_one_dispatch_oom(table, tmp_path, monkeypatch, batch):
    """The first dispatch OOMs: a cold resident segment is evicted, the
    retry answers, rows equal the JAX package's (which survives its own
    injected OOM the same way)."""
    port, jax = table
    sql = GROUP_SQL if batch else "SET segmentBatch = false; " + GROUP_SQL
    cold = load_segment(_build(tmp_path, "cold", seed=9))
    port.executor.cache.view(cold).dict_ids("g")
    name = "dispatch_plan_batch" if batch else "dispatch_plan"
    flaky = _flaky(getattr(port.executor, name))
    monkeypatch.setattr(port.executor, name, flaky)
    jreal = getattr(jax.tpu, name)
    jstate = {"failed": False}

    def jflaky(*args, **kwargs):
        if not jstate["failed"]:
            jstate["failed"] = True
            raise JaxRuntimeError(XLA_OOM)
        return jreal(*args, **kwargs)

    monkeypatch.setattr(jax.tpu, name, jflaky)
    before = oom_stats()["reliefs"]
    got = port.execute_sql(sql)
    assert got.result_table.rows == _rows(jax.execute_sql(sql))
    assert flaky.state["calls"] == (2 if batch else 5)
    assert oom_stats()["reliefs"] == before + 1
    assert id(cold) not in port.executor.cache._views


@pytest.mark.parametrize("sql", [GROUP_SQL, SPARSE_SQL],
                         ids=["dense", "sparse"])
def test_persistent_family_oom_falls_back_to_segments(table, monkeypatch,
                                                      sql):
    """The [S, N] stacks never fit: the members dispatch one by one."""
    port, jax = table
    name = ("dispatch_plan_batch_raw" if "sparse" in sql
            else "dispatch_plan_batch")
    flaky = _flaky(getattr(port.executor, name), times=99)
    monkeypatch.setattr(port.executor, name, flaky)
    failures = oom_stats()["failures"]
    got = port.execute_sql(sql)
    assert got.result_table.rows == _rows(jax.execute_sql(sql))
    assert flaky.state["calls"] == 2
    assert got.num_device_dispatches == 4
    assert oom_stats()["failures"] == failures + 1


def test_query_survives_fetch_seam_oom(table, monkeypatch):
    """The fetch OOMs: the retry re-dispatches (its inputs may be the stacks
    relief freed) and fetches again."""
    port, jax = table
    sql = "SET segmentBatch = false; " + GROUP_SQL
    dispatch = _flaky(port.executor.dispatch_plan, times=0)
    monkeypatch.setattr(port.executor, "dispatch_plan", dispatch)
    fetch = _flaky(qe_module.fetch_packed_batch)
    monkeypatch.setattr(qe_module, "fetch_packed_batch", fetch)
    got = port.execute_sql(sql)
    assert got.result_table.rows == _rows(jax.execute_sql(sql))
    assert fetch.state["calls"] == 2
    assert dispatch.state["calls"] == 8  # every segment twice


def test_columnar_scan_survives_one_oom(table, monkeypatch):
    """The multi-stage engine's scan leaf takes the same relief."""
    port, jax = table
    sql = ("SELECT a.g, COUNT(*) FROM t a JOIN t b ON a.g = b.g "
           "WHERE a.v < 10 AND b.v > 90 GROUP BY a.g ORDER BY a.g")
    flaky = _flaky(port.executor.dispatch_plan)
    monkeypatch.setattr(port.executor, "dispatch_plan", flaky)
    got = port.execute_sql(sql)
    assert _rows(got) == _rows(jax.execute_sql(sql))
    assert flaky.state["calls"] == 9


def test_query_fails_cleanly_on_persistent_oom(table, monkeypatch):
    """Every attempt OOMs: the query fails alone with HbmExhaustedError,
    as the JAX package's does, and the executor answers the next query."""
    port, jax = table

    def always(*args, **kwargs):
        raise _cuda_oom()

    def jalways(*args, **kwargs):
        raise JaxRuntimeError(XLA_OOM)

    sql = "SET segmentBatch = false; " + GROUP_SQL
    monkeypatch.setattr(port.executor, "dispatch_plan", always)
    monkeypatch.setattr(jax.tpu, "dispatch_plan", jalways)
    before = oom_stats()["failures"]
    with pytest.raises(HbmExhaustedError):
        port.execute_sql(sql)
    want = jax.execute_sql(sql)
    assert want.exceptions and "HbmExhaustedError" in want.exceptions[0]
    assert oom_stats()["failures"] == before + 1
    with pytest.raises(HbmExhaustedError):
        port.execute_sql("SET segmentBatch = false; SELECT COUNT(*) FROM t")
    monkeypatch.undo()
    assert port.execute_sql("SELECT COUNT(*) FROM t").result_table.rows == \
        [[1600]]
    assert port.execute_sql(sql).result_table.rows == \
        _rows(jax.execute_sql(sql))
