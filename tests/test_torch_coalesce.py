"""Cross-query coalescing in the port, against the JAX package; and fault F7.

The cases of tests/test_coalesce.py, each run on both packages over the
same segments (three built by the port's builder from identical rows, so
one batch family): the port's `QueryExecutor(device="cpu")` and the JAX
package's `QueryExecutor(backend="tpu")` (its Pallas kernels
interpreted), each with a coalescer that arms on first sight, the segment
partial cache off (a hit would answer without a dispatch), and groups that
close when full (`PINOT_TPU_COALESCE_MAX_QUERIES` = the thread count),
never on the window running out:

  * 8 identical concurrent queries make ONE dispatch in all, every
    response saying numCoalescedQueries 7, rows equal to a solo run's;
  * 8 queries differing only in a filter literal (a param plane each)
    make one dispatch, each with its solo rows and the JAX package's
    coalesced rows;
  * the default window (0) never holds; `SET coalesce = false` opts out;
    traced queries, a consuming segment's family and an unarmed family
    never hold; FamilyTraffic decays below its arming threshold;
  * leader failure: BatchFamilyMismatch or HbmExhaustedError in the
    group's dispatch sends every member to its own dispatch (right rows,
    nothing coalesced), in both packages; any other error reaches every
    member's caller in the port, where the JAX package falls back to solo
    on it as well (a deliberate difference: ROADMAP Queue 3);
  * F7: N threads running one family query on a fresh executor upload
    each plane once and build each family stack once (the parent of this
    change uploaded them once per thread that missed).

Tolerance: exact (integer counts and sums).
"""

from __future__ import annotations

import sys
import threading
import time
from collections import Counter

import numpy as np
import pytest
import torch

from pinot_tpu.engine import coalesce as jax_coalesce
from pinot_tpu.engine.executor import \
    BatchFamilyMismatch as JaxBatchFamilyMismatch
from pinot_tpu.engine.oom import HbmExhaustedError as JaxHbmExhausted
from pinot_tpu.engine.query_executor import QueryExecutor as JaxQueryExecutor
from pinot_tpu.segment.loader import load_segment as jax_load
from pinot_tpu.segment.mutable import MutableSegment as JaxMutableSegment
from pinot_tpu.spi.data_types import Schema as JaxSchema
from pinot_tpu_torch.engine import coalesce
from pinot_tpu_torch.engine import executor as port_executor
from pinot_tpu_torch.engine.executor import BatchFamilyMismatch
from pinot_tpu_torch.engine.oom import HbmExhaustedError
from pinot_tpu_torch.engine.query_executor import QueryExecutor
from pinot_tpu_torch.segment import device_cache
from pinot_tpu_torch.segment.builder import SegmentBuilder
from pinot_tpu_torch.segment.loader import load_segment
from pinot_tpu_torch.segment.mutable import MutableSegment
from pinot_tpu_torch.spi.data_types import Schema
from pinot_tpu_torch.spi.table_config import IndexingConfig, TableConfig

DIMS = [("k", "INT"), ("d", "INT")]
METRICS = [("v", "LONG")]
N_SEGS = 3
N_ROWS = 4096
GROUPBY_SQL = ("SELECT k, COUNT(*), SUM(v), MIN(v), MAX(v) FROM co "
               "WHERE v > {lit} GROUP BY k ORDER BY k LIMIT 100000")
LITERALS = [100, 200, -50, 0, 300, 150, 250, -100]
PACKAGES = ["port", "jax"]


@pytest.fixture(autouse=True)
def _uncached(monkeypatch):
    monkeypatch.setenv("PINOT_TPU_SEGMENT_CACHE", "0")
    monkeypatch.setenv("PINOT_TPU_MESH_DEVICES", "1")
    monkeypatch.setenv("PINOT_TPU_FUSED", "interpret")
    monkeypatch.delenv("PINOT_TPU_COALESCE_WINDOW_MS", raising=False)
    monkeypatch.delenv("PINOT_TPU_COALESCE_MAX_QUERIES", raising=False)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def dataset():
    rng = np.random.default_rng(1106)
    return {"k": rng.integers(0, 40, N_ROWS).astype(np.int32),
            "d": rng.integers(0, 16, N_ROWS).astype(np.int32),
            "v": rng.integers(-500, 500, N_ROWS).astype(np.int64)}


def _config():
    return TableConfig(table_name="co", indexing=IndexingConfig(
        no_dictionary_columns=["v"]))


@pytest.fixture(scope="module")
def paths(tmp_path_factory, dataset):
    """Three segments of identical rows: one batch family."""
    root = tmp_path_factory.mktemp("torch_coalesce")
    out = []
    for i in range(N_SEGS):
        SegmentBuilder(Schema.build("co", dimensions=DIMS, metrics=METRICS),
                       _config(), f"c{i}").build(dataset, root / f"c{i}")
        out.append(root / f"c{i}")
    return out


def _engine(package: str, paths):
    """A fresh executor of `package` over the segments, its coalescer
    arming on first sight."""
    if package == "port":
        qe = QueryExecutor(device="cpu")
        qe.add_table(Schema.build("co", dimensions=DIMS, metrics=METRICS),
                     [load_segment(p) for p in paths])
        qe.coalescer = coalesce.QueryCoalescer(
            coalesce.FamilyTraffic(min_traffic=1.0))
    else:
        qe = JaxQueryExecutor(backend="tpu")
        qe.add_table(JaxSchema.build("co", dimensions=DIMS, metrics=METRICS),
                     [jax_load(p) for p in paths])
        qe.coalescer = jax_coalesce.QueryCoalescer(
            jax_coalesce.FamilyTraffic(min_traffic=1.0))
    return qe


@pytest.fixture(scope="module")
def engines(paths):
    return {p: _engine(p, paths) for p in PACKAGES}


def _run_concurrent(qe, sqls, timeout=120.0):
    """Run the SQLs on one thread each, released together: (responses,
    errors), one of the two None for each thread."""
    barrier = threading.Barrier(len(sqls))
    results: list = [None] * len(sqls)
    errors: list = [None] * len(sqls)

    def work(i, sql):
        barrier.wait(timeout=30)
        try:
            results[i] = qe.execute_sql(sql)
        except Exception as e:
            errors[i] = e

    threads = [threading.Thread(target=work, args=(i, s), daemon=True)
               for i, s in enumerate(sqls)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=timeout)
    assert all(r is not None or e is not None
               for r, e in zip(results, errors)), "a worker thread hung"
    return results, errors


def _ok(results, errors) -> list:
    assert errors == [None] * len(errors), errors
    for r in results:
        assert not r.exceptions, r.exceptions
    return results


def _rows(resp):
    assert not resp.exceptions, resp.exceptions
    return resp.result_table.rows


def _arm(monkeypatch, n: int, window_ms: str = "30000"):
    # the group closes on the full event when its n-th member joins
    monkeypatch.setenv("PINOT_TPU_COALESCE_WINDOW_MS", window_ms)
    monkeypatch.setenv("PINOT_TPU_COALESCE_MAX_QUERIES", str(n))


# -- structure -------------------------------------------------------------------


@pytest.mark.parametrize("package", PACKAGES)
def test_eight_identical_queries_one_dispatch(engines, package, monkeypatch):
    qe = engines[package]
    qe.coalescer = type(qe.coalescer)(type(qe.coalescer.traffic)(
        min_traffic=1.0))
    sql = GROUPBY_SQL.format(lit=100)
    solo = qe.execute_sql(sql)  # before the window: a lone query holds
    other = engines["jax" if package == "port" else "port"].execute_sql(sql)
    assert _rows(solo) == _rows(other)
    _arm(monkeypatch, 8)
    results = _ok(*_run_concurrent(qe, [sql] * 8))
    assert sum(r.num_device_dispatches for r in results) == 1
    for r in results:
        assert _rows(r) == _rows(solo)
        assert r.num_coalesced_queries == 7
        assert r.coalesce_wait_ms >= 0.0
        j = r.to_json()
        assert j["numCoalescedQueries"] == 7 and "coalesceWindowMs" in j
    snap = qe.coalescer.snapshot()
    assert snap["groupsFormed"] == 1 and snap["queriesCoalesced"] == 8


def test_group_planes_repeat_the_family_stack(engines, monkeypatch):
    """The port builds a group's [S*Q, ...] planes from the family's
    cached [S, ...] stack for the launch only: no stack is cached per
    group size, and the bytes built are counted."""
    qe = engines["port"]
    sql = GROUPBY_SQL.format(lit=0)
    qe.execute_sql(sql)
    _arm(monkeypatch, 4)
    stacks0 = qe.executor.cache.stats()["stackBytes"]
    before = qe.executor.repeat_stats()
    _ok(*_run_concurrent(qe, [sql] * 4))
    after = qe.executor.repeat_stats()
    assert qe.executor.cache.stats()["stackBytes"] == stacks0
    assert after["builds"] == before["builds"] + 1
    assert after["bytes"] - before["bytes"] == 4 * stacks0


@pytest.mark.parametrize("package", PACKAGES)
def test_default_window_never_coalesces(engines, package):
    qe = engines[package]
    assert coalesce.window_ms() == 0.0 and jax_coalesce.window_ms() == 0.0
    sql = GROUPBY_SQL.format(lit=100)
    qe.execute_sql(sql)
    groups0 = qe.coalescer.snapshot()["groupsFormed"]
    results = _ok(*_run_concurrent(qe, [sql] * 4))
    assert sum(r.num_device_dispatches for r in results) == 4
    assert all(r.num_coalesced_queries == 0 for r in results)
    assert qe.coalescer.snapshot()["groupsFormed"] == groups0


@pytest.mark.parametrize("prefix", ["SET coalesce = false; ",
                                    "SET trace = true; "])
@pytest.mark.parametrize("package", PACKAGES)
def test_opted_out_and_traced_queries_never_hold(engines, package, prefix,
                                                 monkeypatch):
    qe = engines[package]
    sql = prefix + GROUPBY_SQL.format(lit=100)
    qe.execute_sql(sql)
    _arm(monkeypatch, 4, window_ms="250")
    groups0 = qe.coalescer.snapshot()["groupsFormed"]
    results = _ok(*_run_concurrent(qe, [sql] * 4))
    assert sum(r.num_device_dispatches for r in results) == 4
    assert all(r.num_coalesced_queries == 0 for r in results)
    assert qe.coalescer.snapshot()["groupsFormed"] == groups0


@pytest.mark.parametrize("package", PACKAGES)
def test_consuming_family_never_holds(paths, dataset, package, monkeypatch):
    """Two committed segments and a consuming one of the same rows: the
    consuming snapshot joins the committed segments' family on the CPU,
    and a family with a consuming member never coalesces."""
    rows = [{"k": int(k), "d": int(d), "v": int(v)}
            for k, d, v in zip(dataset["k"], dataset["d"], dataset["v"])]
    if package == "port":
        schema = Schema.build("co", dimensions=DIMS, metrics=METRICS)
        live = MutableSegment(schema, "c_live")
        qe = QueryExecutor(device="cpu")
        segs = [load_segment(p) for p in paths[:2]]
        cls = coalesce
    else:
        schema = JaxSchema.build("co", dimensions=DIMS, metrics=METRICS)
        live = JaxMutableSegment(schema, "c_live")
        qe = JaxQueryExecutor(backend="tpu")
        segs = [jax_load(p) for p in paths[:2]]
        cls = jax_coalesce
    for r in rows:
        live.index(dict(r))
    qe.add_table(schema, segs + [live])
    qe.coalescer = cls.QueryCoalescer(cls.FamilyTraffic(min_traffic=1.0))
    sql = GROUPBY_SQL.format(lit=100)
    solo = qe.execute_sql(sql)
    _arm(monkeypatch, 4, window_ms="250")
    results = _ok(*_run_concurrent(qe, [sql] * 4))
    assert all(r.num_coalesced_queries == 0 for r in results)
    assert all(_rows(r) == _rows(solo) for r in results)
    assert sum(r.num_device_dispatches for r in results) \
        == 4 * solo.num_device_dispatches
    assert qe.coalescer.snapshot()["groupsFormed"] == 0


@pytest.mark.parametrize("package", PACKAGES)
def test_unarmed_family_never_holds(package, monkeypatch):
    """A first sighting under the default min_traffic (2) returns at once:
    a one-off query pays no hold; the second sighting arms the pair."""
    mod = coalesce if package == "port" else jax_coalesce
    monkeypatch.setenv("PINOT_TPU_COALESCE_WINDOW_MS", "60000")
    co = mod.QueryCoalescer(mod.FamilyTraffic(half_life_s=10.0,
                                              min_traffic=2.0))

    def offer():
        if package == "port":
            return co.offer("t", ("fam",), ["s1"], ["p1"],
                            lambda s, p, q: [])
        return co.offer("t", ("fam",), ["s1"], ["p1"], (),
                        lambda s, p: [])

    t0 = time.perf_counter()
    assert offer() is None
    assert time.perf_counter() - t0 < 5.0  # no 60 s hold
    # armed now: the offer holds (leads) and, nobody joining, returns None
    monkeypatch.setenv("PINOT_TPU_COALESCE_WINDOW_MS", "50")
    assert offer() is None
    assert co.traffic.armed("t", ("fam",))


@pytest.mark.parametrize("package", PACKAGES)
def test_traffic_decays_below_arming_threshold(package, monkeypatch):
    mod = coalesce if package == "port" else jax_coalesce
    clock = [1000.0]
    monkeypatch.setattr(mod.time, "time", lambda: clock[0])
    tr = mod.FamilyTraffic(half_life_s=10.0, min_traffic=2.0)
    tr.note("t", "f")
    tr.note("t", "f")
    assert tr.armed("t", "f")
    clock[0] += 60.0  # six half-lives: 2.0 -> about 0.03
    assert not tr.armed("t", "f")
    tr.note("t", "f")  # one fresh sighting alone does not re-arm
    assert not tr.armed("t", "f")


@pytest.mark.parametrize("package", PACKAGES)
def test_coalesce_enabled_parsing(package):
    mod = coalesce if package == "port" else jax_coalesce

    class Q:
        def __init__(self, **opts):
            self.query_options = opts

    assert mod.coalesce_enabled(Q())
    assert mod.coalesce_enabled(Q(coalesce="true"))
    for off in ("false", False, "off", 0):
        assert not mod.coalesce_enabled(Q(coalesce=off))


# -- rows ----------------------------------------------------------------------


def test_literal_matrix_equals_solo_and_jax(engines, monkeypatch):
    """Eight concurrent queries differing only in the filter literal: one
    program, eight param planes, one dispatch in each package; every
    query's rows equal its solo rows and the JAX package's coalesced
    rows."""
    sqls = [GROUPBY_SQL.format(lit=lit) for lit in LITERALS]
    got = {}
    for package in PACKAGES:
        qe = engines[package]
        monkeypatch.delenv("PINOT_TPU_COALESCE_WINDOW_MS", raising=False)
        solos = [qe.execute_sql(s) for s in sqls]
        _arm(monkeypatch, 8)
        results = _ok(*_run_concurrent(qe, sqls))
        assert sum(r.num_device_dispatches for r in results) == 1, package
        for s, r in zip(solos, results):
            assert _rows(r) == _rows(s)
            assert r.num_coalesced_queries == 7
        got[package] = [_rows(r) for r in results]
    assert got["port"] == got["jax"]
    assert len({str(r) for r in got["port"]}) == len(LITERALS)


def test_mixed_traffic(engines, monkeypatch):
    """Group-bys and selections in flight together: the four group-bys
    share one dispatch, the four selections (a family of their own)
    another, every answer is right."""
    qe = engines["port"]
    sel = "SELECT k, d, v FROM co WHERE v > 450 ORDER BY v, k, d LIMIT 17"
    gb = [GROUPBY_SQL.format(lit=lit) for lit in (100, 200, -50, 0)]
    solos = [qe.execute_sql(s) for s in gb + [sel]]
    _arm(monkeypatch, 4)
    results = _ok(*_run_concurrent(qe, gb + [sel] * 4))
    for s, r in zip(solos[:4], results[:4]):
        assert _rows(r) == _rows(s) and r.num_coalesced_queries == 3
    for r in results[4:]:
        assert _rows(r) == _rows(solos[4]) and r.num_coalesced_queries == 3
    assert sum(r.num_device_dispatches for r in results) == 2


# -- leader failure ---------------------------------------------------------------


def _inject(monkeypatch, package, qe, error):
    """Make the group's dispatch (more plans than one query's S) raise
    `error`; the solo family dispatch still runs."""
    if package == "port":
        real = qe.executor.dispatch_plan_batch

        def failing(segs, plans, repeat=1):
            if repeat > 1:
                raise error
            return real(segs, plans, repeat)

        monkeypatch.setattr(qe.executor, "dispatch_plan_batch", failing)
    else:
        real = qe.tpu.dispatch_plan_batch

        def failing(segs, plans, mesh=()):
            if len(segs) > N_SEGS:
                raise error
            return real(segs, plans, mesh=mesh)

        monkeypatch.setattr(qe.tpu, "dispatch_plan_batch", failing)


@pytest.mark.parametrize("gate", ["mismatch", "exhausted"])
@pytest.mark.parametrize("package", PACKAGES)
def test_leader_gate_sends_every_member_solo(paths, package, gate,
                                             monkeypatch):
    qe = _engine(package, paths)
    if gate == "mismatch":
        error = (BatchFamilyMismatch if package == "port"
                 else JaxBatchFamilyMismatch)("injected")
    else:
        error = (HbmExhaustedError if package == "port"
                 else JaxHbmExhausted)("injected")
    sql = GROUPBY_SQL.format(lit=100)
    solo = qe.execute_sql(sql)
    _arm(monkeypatch, 3)
    _inject(monkeypatch, package, qe, error)
    results = _ok(*_run_concurrent(qe, [sql] * 3))
    for r in results:
        assert _rows(r) == _rows(solo)
        assert r.num_coalesced_queries == 0
    assert sum(r.num_device_dispatches for r in results) == 3
    assert qe.coalescer.snapshot()["groupsFormed"] == 0


@pytest.mark.parametrize("package", PACKAGES)
def test_other_leader_error(paths, package, monkeypatch):
    """Any other error in the group's dispatch: the port raises it to
    every member's caller; the JAX package sends every member solo."""
    qe = _engine(package, paths)
    sql = GROUPBY_SQL.format(lit=100)
    solo = qe.execute_sql(sql)
    _arm(monkeypatch, 3)
    _inject(monkeypatch, package, qe, RuntimeError("injected group fault"))
    results, errors = _run_concurrent(qe, [sql] * 3)
    if package == "port":
        assert results == [None] * 3
        assert all(isinstance(e, RuntimeError)
                   and str(e) == "injected group fault" for e in errors)
        assert qe.coalescer.snapshot()["openGroups"] == 0
        monkeypatch.delenv("PINOT_TPU_COALESCE_WINDOW_MS")
        assert _rows(qe.execute_sql(sql)) == _rows(solo)  # still serves
    else:
        for r in _ok(results, errors):
            assert _rows(r) == _rows(solo) and r.num_coalesced_queries == 0


# -- F7: the device caches' get-or-create ----------------------------------------------


def test_concurrent_family_uploads_each_plane_once(paths, monkeypatch):
    """N threads run one family query on a fresh executor: every plane is
    uploaded once (`SegmentDeviceView._put` once per key) and every stack
    built once (`_stack` once per family plane). Both are slowed so the
    threads miss together; before the repair each thread that missed
    uploaded (and built) its own copy, the last one kept."""
    n = 6
    puts: Counter = Counter()
    stacks: list = []
    real_put = device_cache.SegmentDeviceView._put
    real_stack = port_executor._stack

    def slow_put(view, key, host):
        puts[(view.segment.name, key)] += 1
        time.sleep(0.05)
        return real_put(view, key, host)

    def slow_stack(planes):
        stacks.append(planes[0].shape)
        time.sleep(0.05)
        return real_stack(planes)

    monkeypatch.setattr(device_cache.SegmentDeviceView, "_put", slow_put)
    monkeypatch.setattr(port_executor, "_stack", slow_stack)
    qe = _engine("port", paths)
    sql = GROUPBY_SQL.format(lit=100)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        results = _ok(*_run_concurrent(qe, [sql] * n))
    finally:
        sys.setswitchinterval(interval)
    assert all(r.num_device_dispatches == 1 for r in results)
    assert all(_rows(r) == _rows(results[0]) for r in results)
    assert puts and max(puts.values()) == 1, puts
    view_bytes = qe.executor.cache.stats()["viewBytes"]
    stack_bytes = qe.executor.cache.stats()["stackBytes"]
    # one stack per family plane, and the budget counts what is kept
    assert len(stacks) == len(puts) // N_SEGS
    assert stack_bytes == view_bytes
