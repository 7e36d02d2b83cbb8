"""Server meters of the port against the JAX package's, and the
`realtime.upload` fault seam.

Each scenario runs once through each package over the same segments (the
port's `QueryExecutor(device="cpu")`, the JAX package's
`QueryExecutor(backend="tpu")` with its Pallas kernels interpreted and one
mesh device) and compares the change of each package's `SERVER_METRICS`
meter, name for name:

  * a consuming table queried, fed, and queried again:
    `realtimeDeviceQueries`, `realtimeDeltaUploadBytes`,
    `realtimePlaneGenerations`;
  * one device-memory relief (an `hbm_oom` fault at `device.dispatch`),
    then a query whose every attempt runs out: `hbmOomEvents`,
    `hbmOomEvictions`, `hbmOomQueryFailures`;
  * a coalesced group of 4: `coalescedQueries` and the count of the
    `coalesceWaitMs` timer;
  * the partial cache at a budget of one entry: `segmentCacheEvictions`;
  * a failing query: `queryExecutionExceptions`.

The `realtime.upload` seam: an error fault, or a delay past the upload
budget, fails the query with RealtimeUploadError and leaves the planes and
their watermarks as they were; a corruption drops the plane set, and the
next query uploads it from row 0 and answers right. The JAX package
answers the faulted query on its host engine; the port has none and does
not hide the device, so the query fails (a deliberate difference, ROADMAP
"Deliberate differences"). Tolerance: exact.
"""

from __future__ import annotations

import threading

import numpy as np
import pytest
import torch

from pinot_tpu.cache import partial as jax_partial
from pinot_tpu.engine import coalesce as jax_coalesce
from pinot_tpu.engine.query_executor import QueryExecutor as JaxQueryExecutor
from pinot_tpu.realtime import device_plane as jax_dp
from pinot_tpu.segment.loader import load_segment as jax_load
from pinot_tpu.segment.mutable import MutableSegment as JaxMutable
from pinot_tpu.spi import faults as jax_faults
from pinot_tpu.spi.data_types import Schema as JaxSchema
from pinot_tpu.spi.metrics import SERVER_METRICS as JAX_METRICS
from pinot_tpu_torch.cache import partial
from pinot_tpu_torch.engine import coalesce
from pinot_tpu_torch.engine.aggregation import UnsupportedQueryError
from pinot_tpu_torch.engine.oom import HbmExhaustedError
from pinot_tpu_torch.engine.query_executor import QueryExecutor
from pinot_tpu_torch.realtime import device_plane as dp
from pinot_tpu_torch.realtime.device_plane import RealtimeUploadError
from pinot_tpu_torch.segment.builder import SegmentBuilder
from pinot_tpu_torch.segment.loader import load_segment
from pinot_tpu_torch.segment.mutable import MutableSegment
from pinot_tpu_torch.spi import faults
from pinot_tpu_torch.spi.data_types import Schema
from pinot_tpu_torch.spi.metrics import SERVER_METRICS, ServerMeter, ServerTimer

DIMS = [("k", "INT"), ("d", "INT")]
METRICS = [("v", "INT")]
ROWS = 2048
GROUP_SQL = "SELECT k, COUNT(*), SUM(v) FROM m GROUP BY k ORDER BY k LIMIT 100"
RT_SQL = ("SELECT k, COUNT(*), SUM(v) FROM m WHERE d < 12 GROUP BY k "
          "ORDER BY k LIMIT 100")
RT_METERS = [ServerMeter.REALTIME_DEVICE_QUERIES,
             ServerMeter.REALTIME_DELTA_UPLOAD_BYTES,
             ServerMeter.REALTIME_PLANE_GENERATIONS]
OOM_METERS = [ServerMeter.HBM_OOM_EVENTS, ServerMeter.HBM_OOM_EVICTIONS,
              ServerMeter.HBM_OOM_QUERY_FAILURES]


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("PINOT_TPU_SEGMENT_CACHE", "0")
    monkeypatch.setenv("PINOT_TPU_RESULT_CACHE", "0")
    monkeypatch.setenv("PINOT_TPU_MESH_DEVICES", "1")
    monkeypatch.setenv("PINOT_TPU_FUSED", "interpret")
    monkeypatch.delenv("PINOT_TPU_COALESCE_WINDOW_MS", raising=False)
    monkeypatch.delenv("PINOT_TPU_COALESCE_MAX_QUERIES", raising=False)
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)
    faults.FAULTS.reset()
    jax_faults.FAULTS.reset()


def _cols(rng, n):
    return {"k": rng.integers(0, 30, n).astype(np.int32),
            "d": rng.integers(0, 16, n).astype(np.int32),
            "v": rng.integers(-500, 500, n).astype(np.int32)}


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    """Three segments of one batch family."""
    rng = np.random.default_rng(77)
    root = tmp_path_factory.mktemp("torch_meters")
    schema = Schema.build("m", dimensions=DIMS, metrics=METRICS)
    out = []
    for i in range(3):
        SegmentBuilder(schema, None, f"m{i}").build(_cols(rng, ROWS),
                                                    root / f"m{i}")
        out.append(root / f"m{i}")
    return out


def _engines(paths, live=None, jlive=None):
    port = QueryExecutor(device="cpu")
    port.add_table(Schema.build("m", dimensions=DIMS, metrics=METRICS),
                   [load_segment(p) for p in paths]
                   + ([live] if live is not None else []))
    jax = JaxQueryExecutor(backend="tpu")
    jax.add_table(JaxSchema.build("m", dimensions=DIMS, metrics=METRICS),
                  [jax_load(p) for p in paths]
                  + ([jlive] if jlive is not None else []))
    return port, jax


class Deltas:
    """Meter changes of both packages since construction."""

    def __init__(self, names):
        self.names = names
        self.before = self._read()

    def _read(self):
        return ({n: SERVER_METRICS.meter_count(n) for n in self.names},
                {n: JAX_METRICS.meter_count(n) for n in self.names})

    def now(self):
        after = self._read()
        return tuple({n: a[n] - b[n] for n in self.names}
                     for a, b in zip(after, self.before))


def _rows(resp):
    assert not resp.exceptions, resp.exceptions
    return resp.result_table.rows


def _feed(segs, rows):
    for r in rows:
        for s in segs:
            s.index(dict(r))


def _rt_rows(n, seed):
    rng = np.random.default_rng(seed)
    c = _cols(rng, n)
    return [{k: int(v[i]) for k, v in c.items()} for i in range(n)]


def _live():
    return (MutableSegment(Schema.build("m", dimensions=DIMS,
                                        metrics=METRICS), "live"),
            JaxMutable(JaxSchema.build("m", dimensions=DIMS,
                                       metrics=METRICS), "live"))


def test_realtime_plane_meters_match_jax(paths):
    live, jlive = _live()
    _feed((live, jlive), _rt_rows(700, 1))
    port, jax = _engines(paths[:1], live, jlive)
    d = Deltas(RT_METERS)
    assert _rows(port.execute_sql(RT_SQL)) == _rows(jax.execute_sql(RT_SQL))
    _feed((live, jlive), _rt_rows(300, 2))
    assert _rows(port.execute_sql(RT_SQL)) == _rows(jax.execute_sql(RT_SQL))
    # an unchanged generation uploads nothing
    assert _rows(port.execute_sql(RT_SQL)) == _rows(jax.execute_sql(RT_SQL))
    got, want = d.now()
    assert got == want
    assert got[ServerMeter.REALTIME_DEVICE_QUERIES] == 3
    assert got[ServerMeter.REALTIME_PLANE_GENERATIONS] == 2
    assert got[ServerMeter.REALTIME_DELTA_UPLOAD_BYTES] > 0


def test_oom_meters_match_jax(paths):
    port, jax = _engines(paths)
    sql = "SET segmentBatch = false; " + GROUP_SQL
    # the JAX package's device cache is process-wide: start it empty, as
    # the port executor's own
    jax.tpu.cache.evict_all_except(None)
    # every segment resident in both caches, then one relief
    assert _rows(port.execute_sql(sql)) == _rows(jax.execute_sql(sql))
    d = Deltas(OOM_METERS)
    for f in (faults, jax_faults):
        f.FAULTS.arm("device.dispatch", kind="hbm_oom", times=1)
    assert _rows(port.execute_sql(sql)) == _rows(jax.execute_sql(sql))
    got, want = d.now()
    assert got == want
    assert got[ServerMeter.HBM_OOM_EVENTS] == 1
    assert got[ServerMeter.HBM_OOM_EVICTIONS] == 2  # the other two views
    assert got[ServerMeter.HBM_OOM_QUERY_FAILURES] == 0
    # every attempt runs out: the query fails alone, in both
    d = Deltas(OOM_METERS)
    for f in (faults, jax_faults):
        f.FAULTS.reset()
        f.FAULTS.arm("device.dispatch", kind="hbm_oom", times=None)
    with pytest.raises(HbmExhaustedError):
        port.execute_sql(sql)
    assert "HbmExhaustedError" in jax.execute_sql(sql).exceptions[0]
    got, want = d.now()
    assert got == want
    assert got[ServerMeter.HBM_OOM_EVENTS] == 1
    assert got[ServerMeter.HBM_OOM_QUERY_FAILURES] == 1


def _run_concurrent(qe, sqls):
    barrier = threading.Barrier(len(sqls))
    out: list = [None] * len(sqls)

    def work(i, sql):
        barrier.wait(timeout=30)
        try:
            out[i] = qe.execute_sql(sql)
        except Exception as e:  # noqa: BLE001 - reported below
            out[i] = e

    threads = [threading.Thread(target=work, args=(i, s), daemon=True)
               for i, s in enumerate(sqls)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    return out


def test_coalesce_meters_match_jax(paths, monkeypatch):
    port, jax = _engines(paths)
    port.coalescer = coalesce.QueryCoalescer(
        coalesce.FamilyTraffic(min_traffic=1.0))
    jax.coalescer = jax_coalesce.QueryCoalescer(
        jax_coalesce.FamilyTraffic(min_traffic=1.0))
    solo = _rows(port.execute_sql(GROUP_SQL))
    monkeypatch.setenv("PINOT_TPU_COALESCE_WINDOW_MS", "30000")
    monkeypatch.setenv("PINOT_TPU_COALESCE_MAX_QUERIES", "4")
    d = Deltas([ServerMeter.COALESCED_QUERIES])
    waits = (SERVER_METRICS.timer_stats(ServerTimer.COALESCE_WAIT_MS)[0],
             JAX_METRICS.timer_stats(ServerTimer.COALESCE_WAIT_MS)[0])
    for qe in (port, jax):
        out = _run_concurrent(qe, [GROUP_SQL] * 4)
        assert [_rows(r) for r in out] == [solo] * 4
        assert sum(r.num_device_dispatches for r in out) == 1
    got, want = d.now()
    assert got == want == {ServerMeter.COALESCED_QUERIES: 3}
    assert SERVER_METRICS.timer_stats(ServerTimer.COALESCE_WAIT_MS)[0] \
        - waits[0] == JAX_METRICS.timer_stats(
            ServerTimer.COALESCE_WAIT_MS)[0] - waits[1] == 4


def test_partial_cache_eviction_meter_matches_jax(paths, monkeypatch):
    """Each package's partial cache sized to one entry (its own estimate
    of an entry): every put after the first evicts one."""
    monkeypatch.setenv("PINOT_TPU_SEGMENT_CACHE", "1")
    port, jax = _engines(paths)
    caches = (partial.GLOBAL_PARTIAL_CACHE, jax_partial.GLOBAL_PARTIAL_CACHE)
    budgets = [c.max_bytes for c in caches]
    sql = "SELECT COUNT(*), SUM(v) FROM m WHERE v > {}"
    try:
        for c in caches:
            c.clear()
        assert _rows(port.execute_sql(sql.format(0))) == \
            _rows(jax.execute_sql(sql.format(0)))
        for c in caches:
            assert len(c._entries) == 3
            c.max_bytes = c._bytes // 3
            c.clear()
        d = Deltas([ServerMeter.SEGMENT_CACHE_EVICTIONS])
        for lit in (10, 20, 30):
            assert _rows(port.execute_sql(sql.format(lit))) == \
                _rows(jax.execute_sql(sql.format(lit)))
        got, want = d.now()
        assert got == want == {ServerMeter.SEGMENT_CACHE_EVICTIONS: 8}
        assert [len(c._entries) for c in caches] == [1, 1]
    finally:
        for c, b in zip(caches, budgets):
            c.max_bytes = b
            c.clear()


def test_query_execution_exception_meter_matches_jax(paths):
    port, jax = _engines(paths)
    d = Deltas([ServerMeter.QUERY_EXECUTION_EXCEPTIONS])
    sql = "SELECT nope, COUNT(*) FROM m GROUP BY nope"
    with pytest.raises(UnsupportedQueryError):
        port.execute_sql(sql)
    assert jax.execute_sql(sql).exceptions
    _rows(port.execute_sql(GROUP_SQL))
    _rows(jax.execute_sql(GROUP_SQL))
    got, want = d.now()
    assert got == want == {ServerMeter.QUERY_EXECUTION_EXCEPTIONS: 1}


# -- the realtime.upload seam -------------------------------------------------


def _marks(ps):
    return {(c, k): ps.watermark(c, k) for c in ("k", "d", "v")
            for k in ("ids", "raw", "dict")}


@pytest.fixture()
def rt(paths):
    live, jlive = _live()
    _feed((live, jlive), _rt_rows(500, 3))
    port, jax = _engines(paths[:1], live, jlive)
    assert _rows(port.execute_sql(RT_SQL)) == _rows(jax.execute_sql(RT_SQL))
    _feed((live, jlive), _rt_rows(200, 4))  # a delta to upload
    return port, jax, live, jlive


def _oracle(port):
    """RT_SQL's rows by numpy over every segment's values."""
    segs = port.tables["m"].segments
    v = {c: np.concatenate([s.get_values(c) for s in segs])
         for c in ("k", "d", "v")}
    out = []
    for k in sorted(set(v["k"][v["d"] < 12].tolist())):
        sel = (v["k"] == k) & (v["d"] < 12)
        out.append([k, int(sel.sum()), float(v["v"][sel].sum())])
    return out


@pytest.mark.parametrize("kind", ["error", "delay"])
def test_upload_fault_fails_the_query_and_keeps_the_planes(rt, kind,
                                                           monkeypatch):
    port, jax, live, jlive = rt
    monkeypatch.setenv("PINOT_TPU_RT_UPLOAD_BUDGET_MS", "5")
    spec = dict(kind=kind, times=1, delay_s=0.05)
    ps = dp.REALTIME_PLANES.plane_set(live, "cpu")
    jps = jax_dp.REALTIME_PLANES.plane_set(jlive)
    before, jbefore = _marks(ps), _marks(jps)
    d = Deltas(RT_METERS)
    faults.FAULTS.arm("realtime.upload", **spec)
    jax_faults.FAULTS.arm("realtime.upload", **spec)
    with pytest.raises(RealtimeUploadError):
        port.execute_sql(RT_SQL)
    # the JAX package answers on its host engine
    assert _rows(jax.execute_sql(RT_SQL)) == _oracle(port)
    assert _marks(ps) == before and _marks(jps) == jbefore
    got, _ = d.now()
    assert got[ServerMeter.REALTIME_DELTA_UPLOAD_BYTES] == 0
    assert got[ServerMeter.REALTIME_DEVICE_QUERIES] == 0
    # the fault spent: the next query uploads the delta and answers
    assert _rows(port.execute_sql(RT_SQL)) == _oracle(port)
    assert ps.watermark("k", "ids") == live.num_docs


def test_upload_corruption_drops_the_planes(rt):
    port, jax, live, jlive = rt
    ps = dp.REALTIME_PLANES.plane_set(live, "cpu")
    jps = jax_dp.REALTIME_PLANES.plane_set(jlive)
    assert ps.watermark("k", "ids") == 500
    faults.FAULTS.arm("realtime.upload", kind="corrupt", times=1)
    jax_faults.FAULTS.arm("realtime.upload", kind="corrupt", times=1)
    with pytest.raises(RealtimeUploadError, match="plane set dropped"):
        port.execute_sql(RT_SQL)
    assert _rows(jax.execute_sql(RT_SQL)) == _oracle(port)
    assert set(_marks(ps).values()) == {0} == set(_marks(jps).values())
    # the next query uploads every row from 0 and answers right
    dp.reset_realtime_stats()
    jax_dp.reset_realtime_stats()
    assert _rows(port.execute_sql(RT_SQL)) == _oracle(port) == \
        _rows(jax.execute_sql(RT_SQL))
    assert dp.realtime_stats()["deltaBytes"] == \
        jax_dp.realtime_stats()["deltaBytes"] > 700 * 4
    assert ps.watermark("k", "ids") == jps.watermark("k", "ids") == 700


def test_disarmed_seam_never_fires(rt):
    port, jax, live, _ = rt
    calls = faults.FAULTS.fire_count()
    assert _rows(port.execute_sql(RT_SQL)) == _oracle(port)
    assert faults.FAULTS.fire_count() == calls
