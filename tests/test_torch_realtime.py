"""Consuming (realtime) segments in the port (pinot_tpu_torch), against the
JAX package.

The same seeded rows go through both packages' `MutableSegment.index`, a
row at a time, and both packages answer on their device paths (the JAX
package as `QueryExecutor(backend="tpu")` with `PINOT_TPU_FUSED=interpret`,
its segment cache off). On the CPU:

  * delta uploads: `realtime_stats()["deltaBytes"]` and `["uploads"]` equal
    the JAX package's exactly at every generation (cold, a warm repeat at
    0, a tail, a tail that crosses a pad bucket), and the port's device
    planes hold exactly the fed rows, grown on the device;
  * plans: `RealtimeSegmentPlanner` plans equal the JAX package's realtime
    planner's (`repr(program)`, slots, param dtypes and values), the
    value-space RANGE LUT over the insertion-ordered dictionary included;
  * rows: the reference's parity matrix at three generations, equal to the
    JAX package's rows and to a sqlite oracle; FUNNEL_COUNT, which the port
    does not lower, raises; a hybrid table of 3 immutable segments and 1
    consuming segment makes 2 dispatches (the family of 3, then the
    consuming snapshot) and 1 host fetch, as the JAX package's dispatches;
  * family stacks of consuming snapshots: a repeat of one generation reuses
    the cached stack, a newer generation evicts the old one;
  * refusals: an MV column or a rebased float plane of a consuming
    segment, `SET realtimeDevicePlanes = false` and the immutable planner
    given a mutable segment raise UnsupportedQueryError.

Tolerance: exact. Every compared value is an integer or a string (sums of
INT/LONG columns, counts); floats never enter these tables.
"""

from __future__ import annotations

import sqlite3

import numpy as np
import pytest
import torch

from pinot_tpu.engine.query_executor import QueryExecutor as JaxQueryExecutor
from pinot_tpu.query.parser.sql import parse_sql as jax_parse
from pinot_tpu.realtime import device_plane as jax_dp
from pinot_tpu.segment.loader import load_segment as jax_load
from pinot_tpu.segment.mutable import MutableSegment as JaxMutableSegment
from pinot_tpu.spi.data_types import Schema as JaxSchema
from pinot_tpu_torch.engine.aggregation import UnsupportedQueryError
from pinot_tpu_torch.engine.plan import SegmentPlanner
from pinot_tpu_torch.engine.query_executor import QueryExecutor
from pinot_tpu_torch.ops import kernels
from pinot_tpu_torch.query.parser.sql import parse_sql
from pinot_tpu_torch.realtime import device_plane
from pinot_tpu_torch.realtime.device_plane import (REALTIME_PLANES,
                                                   RealtimeSegmentPlanner,
                                                   realtime_stats,
                                                   reset_realtime_stats)
from pinot_tpu_torch.segment.builder import SegmentBuilder
from pinot_tpu_torch.segment.loader import load_segment
from pinot_tpu_torch.segment.mutable import MutableSegment
from pinot_tpu_torch.spi.data_types import Schema

DIMS = [("site", "STRING"), ("code", "INT"), ("ts", "LONG")]
METRICS = [("clicks", "INT"), ("revenue", "LONG")]
LIVE = Schema.build("live", dimensions=DIMS, metrics=METRICS)
JAX_LIVE = JaxSchema.build("live", dimensions=DIMS, metrics=METRICS)
# the JAX package's result and segment caches off: it dispatches every query
NOCACHE = "SET segmentCache = false; SET resultCache = false; "


@pytest.fixture(autouse=True)
def _jax_dispatches_every_query(monkeypatch):
    monkeypatch.setenv("PINOT_TPU_SEGMENT_CACHE", "0")
    monkeypatch.setenv("PINOT_TPU_MESH_DEVICES", "1")
    monkeypatch.setenv("PINOT_TPU_FUSED", "interpret")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _gen_rows(n, seed=0, t0=1_700_000_000):
    rng = np.random.default_rng(seed)
    sites = [f"s{i}" for i in range(12)]
    return [{"site": sites[int(rng.integers(12))],
             "code": int(rng.integers(0, 40)),
             "ts": t0 + int(i // 7),
             "clicks": int(rng.integers(1, 10)),
             "revenue": int(rng.integers(0, 1000))}
            for i in range(n)]


class Live:
    """One consuming segment per package, fed the same rows, each behind
    its package's query executor."""

    def __init__(self, name="live_0", schema=LIVE, jax_schema=JAX_LIVE,
                 table="live"):
        self.seg = MutableSegment(schema, name)
        self.jseg = JaxMutableSegment(jax_schema, name)
        self.port = QueryExecutor(device="cpu")
        self.jax = JaxQueryExecutor(backend="tpu")
        self.port.add_table(schema, [self.seg], table)
        self.jax.add_table(jax_schema, [self.jseg], table)
        self.fed: list = []

    def feed(self, rows):
        for r in rows:
            self.seg.index(dict(r))
            self.jseg.index(dict(r))
        self.fed.extend(rows)

    def query(self, sql):
        """(port response, port stats, JAX response, JAX stats)."""
        reset_realtime_stats()
        jax_dp.reset_realtime_stats()
        got = self.port.execute_sql(sql)
        st = dict(realtime_stats())
        want = self.jax.execute_sql(NOCACHE + sql)
        assert not want.exceptions, want.exceptions
        jst = dict(jax_dp.realtime_stats())
        return got, st, want, jst


def _sorted_rows(resp):
    return sorted(tuple(r) for r in resp.result_table.rows)


def _canon(rows):
    return sorted(tuple(int(v) if isinstance(v, (int, float))
                        and not isinstance(v, bool) else v for v in r)
                  for r in rows)


def _oracle(fed_rows, sql):
    con = sqlite3.connect(":memory:")
    con.execute("CREATE TABLE live (site TEXT, code INT, ts INT, "
                "clicks INT, revenue INT)")
    con.executemany(
        "INSERT INTO live VALUES (?, ?, ?, ?, ?)",
        [(r["site"], r["code"], r["ts"], r["clicks"], r["revenue"])
         for r in fed_rows])
    return con.execute(sql).fetchall()


# ---------------------------------------------------------------------------
# delta uploads
# ---------------------------------------------------------------------------


def test_delta_uploads_equal_jax_every_generation():
    """Cold: the whole snapshot; warm: nothing; a tail: its pow2 chunk per
    plane; a tail across the 8192-row bucket: the plane grows on the device
    and only the tail crosses. Bytes and uploads equal the JAX package's
    at each step, and the planes hold exactly the fed rows."""
    live = Live("live_delta_0")
    sql = ("SELECT site, SUM(clicks), COUNT(*) FROM live "
           "GROUP BY site ORDER BY site LIMIT 100")
    steps = [("cold", 5000, 1), ("warm", 0, None), ("tail", 300, 2),
             ("warm", 0, None), ("bucket", 4000, 3)]
    seen = {}
    for label, n, seed in steps:
        if n:
            live.feed(_gen_rows(n, seed))
        got, st, want, jst = live.query(sql)
        assert (st["deltaBytes"], st["uploads"]) == \
            (jst["deltaBytes"], jst["uploads"]), label
        assert st["deviceQueries"] == 1
        assert _sorted_rows(got) == _sorted_rows(want), label
        assert _canon(got.result_table.rows) == _canon(_oracle(
            live.fed, "SELECT site, SUM(clicks), COUNT(*) FROM live "
            "GROUP BY site"))
        seen.setdefault(label, []).append(st)
    cold = seen["cold"][0]["deltaBytes"]
    assert cold > 0
    assert all(s["deltaBytes"] == 0 and s["uploads"] == 0
               for s in seen["warm"])
    assert 0 < seen["tail"][0]["deltaBytes"] < cold / 8
    # 9300 rows: bucket 16384, grown on the device from 8192
    ps = REALTIME_PLANES.plane_set(live.seg, "cpu")
    assert ps.capacity("site", "ids") == 16384
    assert ps.capacity("clicks", "raw") == 16384
    assert ps.watermark("site", "ids") == len(live.fed)
    view = live.seg.snapshot_view()
    n = len(live.fed)
    ids = ps.row_plane(view, "site", "ids").numpy()
    d = view.get_dictionary("site")
    assert [d.get(int(i)) for i in ids[:n]] == [r["site"] for r in live.fed]
    assert not ids[n:].any()
    clicks = ps.row_plane(view, "clicks", "raw").numpy()
    np.testing.assert_array_equal(clicks[:n], [r["clicks"] for r in live.fed])
    assert clicks.dtype == np.int32 and not clicks[n:].any()


def test_dict_plane_delta_equals_jax():
    """A numeric dictionary plane (SUM over the dict-encoded `code`)
    uploads its new entries only, and the registry's totals move with the
    per-query counters."""
    live = Live("live_dict_0")
    sql = "SELECT site, SUM(code) FROM live GROUP BY site LIMIT 100"
    before = REALTIME_PLANES.stats()
    total = 0
    for n, seed in ((3000, 4), (0, None), (50, 5)):
        if n:
            live.feed(_gen_rows(n, seed))
        got, st, want, jst = live.query(sql)
        assert (st["deltaBytes"], st["uploads"]) == \
            (jst["deltaBytes"], jst["uploads"])
        assert _sorted_rows(got) == _sorted_rows(want)
        total += st["deltaBytes"]
    ps = REALTIME_PLANES.plane_set(live.seg, "cpu")
    assert ps.watermark("code", "dict") == 40
    after = REALTIME_PLANES.stats()
    assert after["deltaBytes"] - before["deltaBytes"] == total
    assert REALTIME_PLANES.drop_named("live_dict_0") > 0
    assert ps.nbytes() == 0
    # a later query uploads from row zero again; clear() drops every set
    # but the one it spares
    other = Live("live_dict_1")
    other.feed(_gen_rows(100, 6))
    for t in (live, other):
        t.port.execute_sql(sql)
    assert REALTIME_PLANES.plane_set(live.seg, "cpu").watermark(
        "code", "dict") == 40
    assert REALTIME_PLANES.clear(keep=other.seg) > 0
    assert REALTIME_PLANES.plane_set(live.seg, "cpu").nbytes() == 0
    assert REALTIME_PLANES.plane_set(other.seg, "cpu").nbytes() > 0


# ---------------------------------------------------------------------------
# plans
# ---------------------------------------------------------------------------

PLAN_QUERIES = [
    "SELECT SUM(revenue) FROM live WHERE code BETWEEN 5 AND 20",
    "SELECT site, COUNT(*) FROM live WHERE code > 30 GROUP BY site",
    "SELECT code, SUM(clicks) FROM live WHERE site IN ('s1', 's3') "
    "AND ts < 1700000100 GROUP BY code LIMIT 100",
    "SELECT site, code, SUM(revenue), MIN(clicks), MAX(revenue) FROM live "
    "WHERE site <> 's2' GROUP BY site, code LIMIT 1000",
    "SELECT SUM(code), COUNT(*) FROM live WHERE site LIKE 's1%'",
    "SELECT site, ts, clicks FROM live WHERE code <= 3 "
    "ORDER BY ts DESC LIMIT 10",
]


@pytest.mark.parametrize("sql", PLAN_QUERIES)
def test_realtime_plans_equal_jax(sql):
    live = Live("live_plan_0")
    live.feed(_gen_rows(2500, 6))
    jplan = jax_dp.realtime_plan(jax_parse(sql), live.jseg.snapshot_view())
    pplan = device_plane.realtime_plan(parse_sql(sql),
                                       live.seg.snapshot_view())
    assert repr(pplan.program) == repr(jplan.program)
    assert pplan.slots == jplan.slots
    assert len(pplan.params) == len(jplan.params)
    for a, b in zip(pplan.params, jplan.params):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_range_lowers_to_a_value_space_lut():
    """`code` arrives in insertion order: its ids are no interval of
    values, so the RANGE is a LUT over the snapshot dictionary."""
    live = Live("live_lut_0")
    live.feed(_gen_rows(500, 7))
    view = live.seg.snapshot_view()
    plan = RealtimeSegmentPlanner(parse_sql(
        "SELECT COUNT(*) FROM live WHERE code BETWEEN 5 AND 20"), view).plan()
    lut = next(p for p in plan.params
               if np.asarray(p).dtype == bool and np.asarray(p).ndim == 1)
    vals = view.get_dictionary("code").values
    np.testing.assert_array_equal(lut[:-1], (vals >= 5) & (vals <= 20))
    assert not lut[-1]


# ---------------------------------------------------------------------------
# rows at every generation
# ---------------------------------------------------------------------------

PARITY_MATRIX = [
    ("SELECT SUM(clicks), COUNT(*), MIN(revenue), MAX(revenue) FROM live",
     "SELECT SUM(clicks), COUNT(*), MIN(revenue), MAX(revenue) FROM live"),
    ("SELECT SUM(revenue) FROM live WHERE code < 13 AND clicks > 2",
     "SELECT SUM(revenue) FROM live WHERE code < 13 AND clicks > 2"),
    ("SELECT code, SUM(clicks), COUNT(*) FROM live GROUP BY code "
     "ORDER BY code LIMIT 1000",
     "SELECT code, SUM(clicks), COUNT(*) FROM live GROUP BY code "
     "ORDER BY code"),
    ("SELECT site, SUM(revenue), MAX(clicks) FROM live GROUP BY site "
     "ORDER BY site LIMIT 100",
     "SELECT site, SUM(revenue), MAX(clicks) FROM live GROUP BY site "
     "ORDER BY site"),
    ("SELECT ts, COUNT(*), SUM(clicks) FROM live GROUP BY ts "
     "ORDER BY ts LIMIT 5000",
     "SELECT ts, COUNT(*), SUM(clicks) FROM live GROUP BY ts "
     "ORDER BY ts"),
    ("SELECT COUNT(*) FROM live WHERE code BETWEEN 10 AND 19",
     "SELECT COUNT(*) FROM live WHERE code BETWEEN 10 AND 19"),
]


@pytest.mark.parametrize("esql,osql", PARITY_MATRIX)
def test_parity_matrix_every_generation(esql, osql):
    """Generations g0 -> g1 -> g2: rows equal the JAX package's and the
    sqlite oracle over the same fed rows at each, dispatches equal."""
    live = Live("live_par_0")
    for n, seed in ((2000, 10), (700, 11), (64, 12)):
        live.feed(_gen_rows(n, seed))
        got, _, want, _ = live.query(esql)
        assert _sorted_rows(got) == _sorted_rows(want)
        assert got.num_device_dispatches == want.num_device_dispatches == 1
        assert _canon(got.result_table.rows) == _canon(_oracle(live.fed,
                                                               osql))


def test_selection_over_a_consuming_segment_equals_jax():
    live = Live("live_sel_0")
    live.feed(_gen_rows(3000, 13))
    got, _, want, _ = live.query(
        "SELECT site, ts, clicks FROM live WHERE code <= 3 "
        "ORDER BY ts DESC, clicks LIMIT 25")
    assert [tuple(r) for r in got.result_table.rows] == \
        [tuple(r) for r in want.result_table.rows]


def test_funnel_over_a_consuming_segment_raises():
    """The port lowers no FUNNEL function (the JAX package answers it)."""
    schema = Schema.build("ev", dimensions=[("uid", "INT"), ("url", "STRING")],
                          metrics=[("n", "INT")])
    seg = MutableSegment(schema, "live_fun_0")
    for i in range(50):
        seg.index({"uid": i % 7, "url": ["/home", "/cart"][i % 2], "n": 1})
    qe = QueryExecutor(device="cpu")
    qe.add_table(schema, [seg], "ev")
    with pytest.raises(UnsupportedQueryError):
        qe.execute_sql("SELECT FUNNEL_COUNT(STEPS(url = '/home', "
                       "url = '/cart'), CORRELATE_BY(uid)) FROM ev")


def test_hybrid_immutables_keep_their_family(tmp_path):
    """3 immutable segments + 1 consuming segment: 2 dispatches (the
    family of 3, then the snapshot) and 1 host fetch, as the JAX package
    dispatches; rows equal the JAX package's and the oracle's."""
    rng = np.random.default_rng(7)
    fed = []
    paths = []
    for i in range(3):
        n = 500
        cols = {
            "site": np.asarray([f"s{int(v)}" for v in rng.integers(0, 12, n)],
                               dtype=object),
            "code": rng.integers(0, 40, n).astype(np.int32),
            "ts": (1_700_000_000 + rng.integers(0, 50, n)).astype(np.int64),
            "clicks": rng.integers(1, 10, n).astype(np.int32),
            "revenue": rng.integers(0, 1000, n).astype(np.int64),
        }
        path = tmp_path / f"live_imm_{i}"
        SegmentBuilder(LIVE, segment_name=f"live_imm_{i}").build(cols, path)
        paths.append(path)
        fed.extend({k: v[j].item() if hasattr(v[j], "item") else v[j]
                    for k, v in cols.items()} for j in range(n))
    live = Live("live_cons_0")
    live.feed(_gen_rows(800, 8))
    live.port.add_table(LIVE, [load_segment(p) for p in paths] + [live.seg],
                        "live")
    live.jax.add_table(JAX_LIVE, [jax_load(p) for p in paths] + [live.jseg],
                       "live")
    sql = "SELECT site, SUM(clicks) FROM live GROUP BY site LIMIT 100"
    fetches = kernels.host_fetches()
    got, _, want, _ = live.query(sql)
    assert kernels.host_fetches() - fetches == 1
    assert got.num_device_dispatches == want.num_device_dispatches == 2
    assert _sorted_rows(got) == _sorted_rows(want)
    assert _canon(got.result_table.rows) == _canon(_oracle(
        fed + live.fed, "SELECT site, SUM(clicks) FROM live GROUP BY site"))


# ---------------------------------------------------------------------------
# family stacks of consuming snapshots
# ---------------------------------------------------------------------------


def test_stacked_view_keys_snapshots_by_generation():
    """Two consuming segments of one shape form a family. A repeat of one
    generation reuses its cached stack; a newer generation evicts it (the
    stack of a dead snapshot object is never handed to a later one)."""
    a = MutableSegment(LIVE, "live_fam_a")
    b = MutableSegment(LIVE, "live_fam_b")
    rows = _gen_rows(3000, 14)
    for r in rows[:1500]:
        a.index(dict(r))
    for r in rows[1500:]:
        b.index(dict(r))
    qe = QueryExecutor(device="cpu")
    qe.add_table(LIVE, [a, b], "live")
    sql = ("SELECT site, SUM(revenue), COUNT(*) FROM live GROUP BY site "
           "LIMIT 100")
    cache = qe.executor.cache
    r1 = qe.execute_sql(sql)
    assert r1.num_device_dispatches == 1
    keys1 = list(cache._stacks)
    assert len(keys1) == 1 and all(m[0] == "rt" for m in keys1[0])
    stack1 = cache._stacks[keys1[0]]
    r2 = qe.execute_sql(sql)
    assert list(cache._stacks) == keys1 and cache._stacks[keys1[0]] is stack1
    assert _sorted_rows(r2) == _sorted_rows(r1)
    extra = _gen_rows(40, 15)
    for r in extra:
        a.index(dict(r))
    r3 = qe.execute_sql(sql)
    keys3 = list(cache._stacks)
    assert len(keys3) == 1 and keys3 != keys1
    assert stack1.nbytes() == 0  # evicted
    want = {}
    for r in rows + extra:
        s, c = want.get(r["site"], (0, 0))
        want[r["site"]] = (s + r["revenue"], c + 1)
    assert {row[0]: (int(row[1]), row[2])
            for row in r3.result_table.rows} == want


def test_stacked_view_of_an_unpinned_mutable_is_not_cached():
    seg = MutableSegment(LIVE, "live_unpinned")
    qe = QueryExecutor(device="cpu")
    sv = qe.executor.cache.stacked_view([seg, seg])
    assert sv.key == (id(seg), id(seg))
    assert not qe.executor.cache._stacks


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------


def test_mv_column_on_a_consuming_segment_raises():
    schema = Schema.build("mvlive", dimensions=[("tags", "INT", False),
                                                ("site", "STRING")],
                          metrics=[("clicks", "INT")])
    seg = MutableSegment(schema, "live_mv_0")
    for i in range(100):
        seg.index({"tags": [i % 5, i % 3], "site": f"s{i % 4}", "clicks": 1})
    qe = QueryExecutor(device="cpu")
    qe.add_table(schema, [seg], "mvlive")
    with pytest.raises(UnsupportedQueryError):
        qe.execute_sql("SELECT COUNT(*) FROM mvlive WHERE tags IN (1, 2)")
    # a query that reads no MV plane still runs
    got = qe.execute_sql("SELECT site, SUM(clicks) FROM mvlive GROUP BY site")
    assert _canon(got.result_table.rows) == [(f"s{i}", 25) for i in range(4)]


def test_rebased_float_plane_on_a_consuming_segment_raises():
    """The adaptive histogram bins a raw DOUBLE column from its min, which
    moves while the segment consumes: the realtime planner refuses it.
    execute_sql then answers on the multi-stage engine, with the JAX
    package's multi-stage rows (the JAX package's single-stage engine
    answers the snapshot on its host engine, which the port does not
    have)."""
    spec = {"dimensions": [("day", "INT")], "metrics": [("fare", "DOUBLE")]}
    schema = Schema.build("fares", **spec)
    jschema = JaxSchema.build("fares", **spec)
    seg = MutableSegment(schema, "live_fare_0")
    jseg = JaxMutableSegment(jschema, "live_fare_0")
    for i in range(200):
        seg.index({"day": i % 3, "fare": 0.5 * i})
        jseg.index({"day": i % 3, "fare": 0.5 * i})
    qe = QueryExecutor(device="cpu")
    qe.add_table(schema, [seg], "fares")
    jax = JaxQueryExecutor(backend="tpu")
    jax.add_table(jschema, [jseg], "fares")
    sql = "SELECT day, PERCENTILETDIGEST(fare, 50) FROM fares GROUP BY day"
    with pytest.raises(UnsupportedQueryError, match="rawf32r"):
        qe.execute(parse_sql(sql))
    got = qe.execute_sql(sql)
    want = jax.execute_sql("SET useMultistageEngine = true; " + sql)
    assert got.mse_stage_stats and not want.exceptions
    assert _canon(got.result_table.rows) == _canon(want.result_table.rows)
    got = qe.execute_sql("SELECT day, COUNT(*) FROM fares GROUP BY day")
    assert _canon(got.result_table.rows) == [(0, 67), (1, 67), (2, 66)]


def test_realtime_device_planes_off_raises():
    """With the device planes off the single-stage engine refuses the
    consuming segment; execute_sql answers on the multi-stage engine, with
    the JAX package's rows (its host engine answers there)."""
    live = Live("live_off_0")
    live.feed(_gen_rows(100, 16))
    sql = "SET realtimeDevicePlanes = false; SELECT COUNT(*) FROM live"
    with pytest.raises(UnsupportedQueryError):
        live.port.execute(parse_sql(sql))
    got = live.port.execute_sql(sql)
    assert got.mse_stage_stats
    assert got.result_table.rows == live.jax.execute_sql(sql).result_table.rows
    got = live.port.execute_sql("SET realtimeDevicePlanes = true; "
                                "SELECT COUNT(*) FROM live")
    assert got.result_table.rows == [[100]]


def test_immutable_planner_refuses_a_mutable_segment():
    """The allow_mutable guard: only the realtime planner plans a
    consuming segment (the reference's engine/plan.py:198-204)."""
    seg = MutableSegment(LIVE, "live_guard_0")
    seg.index(_gen_rows(1, 17)[0])
    with pytest.raises(UnsupportedQueryError):
        SegmentPlanner(parse_sql("SELECT COUNT(*) FROM live"),
                       seg.snapshot_view())
    with pytest.raises(UnsupportedQueryError):
        device_plane.realtime_plan(parse_sql("SELECT COUNT(*) FROM live"),
                                   seg)  # no pinned generation
