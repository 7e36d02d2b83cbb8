"""The port's result caches, against the JAX package with its caches on.

The single-stage and multi-stage cases of tests/test_result_cache.py and
tests/test_cache_perf_guard.py, on seeded numpy segments: the port's
`QueryExecutor(device="cpu")` against the JAX package's
`QueryExecutor(backend="tpu")` (its Pallas kernels interpreted), both with
their segment partial caches and result caches ON (the default) and the
process-global partial caches cleared before every test.

  * fingerprints: stable across fresh planners and segment loads, changed
    by every literal and result option, not by execution-only options;
    the closed-world encoder (no repr / id fallback, a torch.Tensor
    raises);
  * the segment partial cache: a warm repeat of a dense, an aggregation
    and a sparse statement makes no dispatch with rows equal to the cold
    run's; the sparse path's device-resident tier alone serves every
    member; partial overlap; cross-executor reuse; `SET segmentCache =
    false` computes no fingerprint and fetches no more; three runs stay
    equal (deep copies); budgets evict (partials first on the device);
  * invalidation by content: a replaced same-name segment, a new
    generation of a consuming segment, an upsert overwrite that flips a row
    of a committed segment and `replace_segment` each miss and answer
    fresh rows;
  * the multi-stage result cache: a warm repeat is a hit with no dispatch;
    the opt-outs; the leaf's partial cache with the result cache off.

Every statement's rows, hits, misses and dispatches equal the JAX
package's on the same sequence of statements. Tolerance: exact (integer
sums and counts; AVG of integers).
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from pinot_tpu.cache.partial import GLOBAL_PARTIAL_CACHE as JAX_PARTIALS
from pinot_tpu.engine.query_executor import QueryExecutor as JaxQueryExecutor
from pinot_tpu.segment.device_cache import GLOBAL_DEVICE_CACHE as JAX_DEVICE
from pinot_tpu.segment.loader import load_segment as jax_load
from pinot_tpu.segment.mutable import MutableSegment as JaxMutableSegment
from pinot_tpu.spi import table_config as jax_tc
from pinot_tpu.spi.data_types import Schema as JaxSchema
from pinot_tpu.upsert import TableUpsertMetadataManager as JaxUpsert
from pinot_tpu_torch.cache.keys import (UnfingerprintableError,
                                        canonical_bytes,
                                        fingerprint_computations,
                                        mse_plan_fingerprint,
                                        program_fingerprint,
                                        query_fingerprint, segment_token)
from pinot_tpu_torch.cache.partial import (GLOBAL_PARTIAL_CACHE,
                                           SegmentPartialCache,
                                           partial_cache_enabled)
from pinot_tpu_torch.cache.results import (BrokerResultCache,
                                           result_cache_enabled)
from pinot_tpu_torch.engine.query_executor import QueryExecutor
from pinot_tpu_torch.ops import kernels
from pinot_tpu_torch.query.parser.sql import parse_sql
from pinot_tpu_torch.segment.builder import SegmentBuilder
from pinot_tpu_torch.segment.device_cache import DeviceSegmentCache
from pinot_tpu_torch.segment.loader import load_segment
from pinot_tpu_torch.segment.mutable import MutableSegment
from pinot_tpu_torch.spi import table_config as tc
from pinot_tpu_torch.spi.data_types import Schema
from pinot_tpu_torch.upsert import TableUpsertMetadataManager

DIMS = [("rck", "INT"), ("rcd", "INT")]
METRICS = [("rcv", "LONG")]
SCHEMA = Schema.build("rc", dimensions=DIMS, metrics=METRICS)
JAX_SCHEMA = JaxSchema.build("rc", dimensions=DIMS, metrics=METRICS)

DENSE_SQL = ("SELECT rck, COUNT(*), SUM(rcv), AVG(rcv) FROM rc "
             "GROUP BY rck ORDER BY rck LIMIT 1000")
AGG_SQL = "SELECT COUNT(*), SUM(rcv), MIN(rcv), MAX(rcv) FROM rc"
SPARSE_SQL = ("SET sparseGroupBy = true; "
              "SELECT rck, COUNT(*), SUM(rcv) FROM rc "
              "GROUP BY rck ORDER BY rck LIMIT 100000")
OBJECT_SQL = ("SELECT rck, DISTINCTCOUNT(rcd), AVG(rcv) FROM rc "
              "GROUP BY rck ORDER BY rck LIMIT 1000")
SELECT_SQL = "SELECT rck, rcv FROM rc WHERE rcd = 3 ORDER BY rcv, rck LIMIT 7"
JOIN_SQL = ("SELECT a.rcd, COUNT(*), SUM(b.rcv) FROM rc a JOIN rc b "
            "ON a.rck = b.rck WHERE a.rcd < 3 AND b.rcd = 5 "
            "GROUP BY a.rcd ORDER BY a.rcd")
MSE_AGG_SQL = ("SET useMultistageEngine = true; SELECT rcd, SUM(rcv), "
               "COUNT(*) FROM rc GROUP BY rcd ORDER BY rcd")


@pytest.fixture(autouse=True)
def _caches_on(monkeypatch):
    """Both packages with the caches at their default (on), cold: the JAX
    package's partial caches are process-global under `--dist loadfile`,
    so they are cleared here, as are the port's."""
    monkeypatch.setenv("PINOT_TPU_SEGMENT_CACHE", "1")
    monkeypatch.setenv("PINOT_TPU_RESULT_CACHE", "1")
    monkeypatch.setenv("PINOT_TPU_MESH_DEVICES", "1")
    monkeypatch.setenv("PINOT_TPU_FUSED", "interpret")
    for clear in (GLOBAL_PARTIAL_CACHE.clear, JAX_PARTIALS.clear,
                  JAX_DEVICE.drop_partials):
        clear()
    yield
    for clear in (GLOBAL_PARTIAL_CACHE.clear, JAX_PARTIALS.clear,
                  JAX_DEVICE.drop_partials):
        clear()


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _gen(rng, n=3000):
    return {"rck": rng.integers(0, 32, n).astype(np.int32),
            "rcd": rng.integers(0, 12, n).astype(np.int32),
            "rcv": rng.integers(-200, 200, n).astype(np.int64)}


def _build(path, name, cols, schema=SCHEMA):
    SegmentBuilder(schema, segment_name=name).build(cols, path)
    return path


def _pair(paths):
    """A port and a JAX executor over the same segment directories."""
    port = QueryExecutor(device="cpu")
    port.add_table(SCHEMA, [load_segment(p) for p in paths])
    jax = JaxQueryExecutor(backend="tpu")
    jax.add_table(JAX_SCHEMA, [jax_load(p) for p in paths])
    return port, jax


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    rng = np.random.default_rng(53)
    root = tmp_path_factory.mktemp("torch_cache")
    return [_build(root / f"rc{i}", f"rc{i}", _gen(rng)) for i in range(4)]


@pytest.fixture
def engine(dirs):
    port, jax = _pair(dirs)
    yield SimpleNamespace(port=port, jax=jax, dirs=dirs)
    port.executor.cache.drop_partials()


def _counts(resp):
    return (resp.num_segments_cache_hit, resp.num_segments_cache_miss,
            resp.num_device_dispatches)


def _both(port, jax, sql):
    """The port's and the JAX package's response to one statement: rows,
    hits, misses and dispatches equal."""
    want = jax.execute_sql(sql)
    assert not want.exceptions, want.exceptions
    got = port.execute_sql(sql)
    assert not got.exceptions, got.exceptions
    assert got.result_table.rows == want.result_table.rows
    assert _counts(got) == _counts(want), (_counts(got), _counts(want))
    return got


# -- fingerprints --------------------------------------------------------------


def test_program_fingerprint_stable_across_fresh_planners(dirs):
    q1, q2 = parse_sql(DENSE_SQL), parse_sql(DENSE_SQL)
    s1, s2 = load_segment(dirs[0]), load_segment(dirs[0])
    e1, e2 = QueryExecutor(device="cpu"), QueryExecutor(device="cpu")
    fp1 = program_fingerprint(e1.executor.plan(q1, s1), q1)
    fp2 = program_fingerprint(e2.executor.plan(q2, s2), q2)
    assert fp1 is not None and fp1 == fp2
    assert segment_token(s1) == segment_token(s2) == \
        ("rc0", s1.metadata.crc)
    assert query_fingerprint(q1) == query_fingerprint(q2)


@pytest.mark.parametrize("other,changes", [
    ("SELECT SUM(rcv) FROM rc WHERE rck > 3", True),
    ("SELECT MAX(rcv) FROM rc WHERE rck > 4", True),
    ("SET numGroupsLimit = 5; SELECT SUM(rcv) FROM rc WHERE rck > 4", True),
    ("SET segmentBatch = false; SELECT SUM(rcv) FROM rc WHERE rck > 4",
     False),
    ("SET resultCache = false; SELECT SUM(rcv) FROM rc WHERE rck > 4",
     False),
], ids=["literal", "aggregation", "result-option", "execution-option",
        "cache-option"])
def test_literal_and_option_sensitivity(dirs, other, changes):
    seg = load_segment(dirs[0])
    ex = QueryExecutor(device="cpu").executor
    base = parse_sql("SELECT SUM(rcv) FROM rc WHERE rck > 4")
    q = parse_sql(other)
    fpa = program_fingerprint(ex.plan(base, seg), base)
    fpb = program_fingerprint(ex.plan(q, seg), q)
    assert fpa is not None and fpb is not None
    assert (fpa != fpb) is changes
    assert (query_fingerprint(base) != query_fingerprint(q)) is changes


def test_canonical_encoder_is_closed_world():
    assert canonical_bytes({"a": 1, "b": 2}) == canonical_bytes({"b": 2, "a": 1})
    assert canonical_bytes((1, "x", 2.5)) == canonical_bytes([1, "x", 2.5])
    assert canonical_bytes(np.int32(7)) == \
        canonical_bytes(np.asarray(7, np.int32))
    assert canonical_bytes(1) != canonical_bytes(1.0)
    assert canonical_bytes(True) != canonical_bytes(1)
    assert canonical_bytes(np.zeros(3, np.int32)) != \
        canonical_bytes(np.zeros(3, np.int64))

    class Opaque:
        pass

    for bad in (object(), {"k": Opaque()}, torch.zeros(3),
                (1, torch.tensor(2)), np.asarray(["a"], dtype=object)):
        with pytest.raises(UnfingerprintableError):
            canonical_bytes(bad)
    # a plan carrying one gives no key: the cache is bypassed
    fake = SimpleNamespace(program=Opaque(), slots=(), fused_ok=True,
                           params=())
    before = fingerprint_computations()
    assert program_fingerprint(fake, parse_sql("SELECT COUNT(*) FROM rc")) \
        is None
    device_param = SimpleNamespace(program=(), slots=(), fused_ok=True,
                                   params=(torch.zeros(4),))
    assert program_fingerprint(
        device_param, parse_sql("SELECT COUNT(*) FROM rc")) is None
    assert mse_plan_fingerprint([Opaque()], {}, 2) is None
    assert fingerprint_computations() == before


def test_switches_read_the_environment(monkeypatch):
    assert partial_cache_enabled() and result_cache_enabled()
    monkeypatch.setenv("PINOT_TPU_SEGMENT_CACHE", "0")
    monkeypatch.setenv("PINOT_TPU_RESULT_CACHE", "false")
    assert not partial_cache_enabled() and not result_cache_enabled()


# -- the segment partial cache -------------------------------------------------


@pytest.mark.parametrize("sql", [DENSE_SQL, AGG_SQL, OBJECT_SQL],
                         ids=["groupby", "agg", "object-states"])
def test_warm_repeat_is_zero_dispatch_bit_identical(engine, sql):
    cold = _both(engine.port, engine.jax, sql)
    assert cold.num_segments_cache_miss == 4
    assert cold.num_device_dispatches > 0
    warm = _both(engine.port, engine.jax, sql)
    assert warm.result_table.rows == cold.result_table.rows
    assert warm.num_segments_cache_hit == 4
    assert warm.num_device_dispatches == 0
    j = warm.to_json()
    assert j["numSegmentsCacheHit"] == 4
    assert "numDeviceDispatches" not in j


def test_sparse_warm_repeat_is_zero_dispatch(engine):
    cold = _both(engine.port, engine.jax, SPARSE_SQL)
    assert cold.num_device_dispatches > 0
    warm = _both(engine.port, engine.jax, SPARSE_SQL)
    assert warm.result_table.rows == cold.result_table.rows
    assert (warm.num_segments_cache_hit, warm.num_device_dispatches) == (4, 0)
    # the device tier alone: the host tier wiped, every member's value-space
    # table still serves the merge
    GLOBAL_PARTIAL_CACHE.clear()
    JAX_PARTIALS.clear()
    tab_warm = _both(engine.port, engine.jax, SPARSE_SQL)
    assert tab_warm.result_table.rows == cold.result_table.rows
    assert tab_warm.num_device_dispatches == 0
    st = engine.port.executor.cache.stats()
    assert st["partialEntries"] == 4 and st["partialHits"] == 4
    assert st["partialBytes"] > 0
    # partial overlap: one member's table gone, only it dispatches
    GLOBAL_PARTIAL_CACHE.clear()
    JAX_PARTIALS.clear()
    key = next(iter(engine.port.executor.cache._partials))
    engine.port.executor.cache._partials.pop(key)
    jkey = next(iter(JAX_DEVICE._partials))
    JAX_DEVICE._partials.pop(jkey)
    overlap = _both(engine.port, engine.jax, SPARSE_SQL)
    assert overlap.result_table.rows == cold.result_table.rows
    assert _counts(overlap) == (3, 1, 1)


def test_partial_overlap_in_a_family_dispatches_the_rest(engine, dirs):
    """A cached segment drops out of its family: the three others run as
    one family of three."""
    sql = DENSE_SQL
    one = QueryExecutor(device="cpu")
    one.add_table(SCHEMA, [load_segment(dirs[0])])
    jone = JaxQueryExecutor(backend="tpu")
    jone.add_table(JAX_SCHEMA, [jax_load(dirs[0])])
    _both(one, jone, sql)  # caches rc0's partial in both packages
    got = _both(engine.port, engine.jax, sql)
    assert _counts(got) == (1, 3, 1)


def test_cross_executor_warm_reuse(engine, dirs):
    cold = _both(engine.port, engine.jax, DENSE_SQL)
    port2, jax2 = _pair(dirs)
    warm = _both(port2, jax2, DENSE_SQL)
    assert warm.result_table.rows == cold.result_table.rows
    assert (warm.num_segments_cache_hit, warm.num_device_dispatches) == (4, 0)


@pytest.mark.parametrize("sql", [DENSE_SQL, SPARSE_SQL, SELECT_SQL],
                         ids=["dense", "sparse", "selection"])
def test_segment_cache_opt_out_computes_no_fingerprint(engine, sql):
    off = "SET segmentCache = false; "
    _both(engine.port, engine.jax, off + sql)
    fetches, fps = kernels.host_fetches(), fingerprint_computations()
    again = _both(engine.port, engine.jax, off + sql)
    assert _counts(again)[:2] == (0, 0)
    assert again.num_device_dispatches > 0
    assert fingerprint_computations() == fps
    assert kernels.host_fetches() - fetches == 1
    # cache on: the counter watches live sites; the fetches stay one
    fetches = kernels.host_fetches()
    on = _both(engine.port, engine.jax, sql)
    assert fingerprint_computations() > fps
    assert kernels.host_fetches() - fetches == 1
    assert on.result_table.rows == again.result_table.rows


def test_selection_is_keyed_but_never_stored(engine):
    for _ in range(2):
        resp = _both(engine.port, engine.jax, SELECT_SQL)
        assert _counts(resp)[:2] == (0, 4)
    assert GLOBAL_PARTIAL_CACHE.stats()["entries"] == 0


def test_cache_off_by_environment(engine, monkeypatch):
    monkeypatch.setenv("PINOT_TPU_SEGMENT_CACHE", "0")
    fps = fingerprint_computations()
    for _ in range(2):
        resp = _both(engine.port, engine.jax, DENSE_SQL)
        assert _counts(resp)[:2] == (0, 0) and resp.num_device_dispatches
    assert fingerprint_computations() == fps


def test_triple_run_mutation_safety(engine):
    """combine merges states in place: three runs stay equal (the cache
    deep-copies on put and on get)."""
    first = _both(engine.port, engine.jax, OBJECT_SQL).result_table.rows
    for _ in range(2):
        assert _both(engine.port, engine.jax,
                     OBJECT_SQL).result_table.rows == first


def test_replaced_segment_same_name_never_serves_stale(tmp_path):
    rng = np.random.default_rng(99)
    old = _build(tmp_path / "va", "swap0", _gen(rng))
    new = _build(tmp_path / "vb", "swap0", _gen(rng))
    sql = "SELECT COUNT(*), SUM(rcv) FROM rc"
    rows_old = _both(*_pair([old]), sql).result_table.rows
    resp = _both(*_pair([new]), sql)
    assert resp.num_segments_cache_hit == 0
    assert resp.result_table.rows != rows_old
    assert segment_token(load_segment(old)) != segment_token(load_segment(new))


def test_consuming_generation_mints_a_new_key(dirs):
    """A hybrid table: the committed segments hit, the consuming snapshot
    misses after each new row, and rows follow every generation."""
    port, jax = _pair(dirs[:2])
    live, jlive = MutableSegment(SCHEMA, "rc_live"), \
        JaxMutableSegment(JAX_SCHEMA, "rc_live")
    port.add_table(SCHEMA, port.tables["rc"].segments + [live])
    jax.add_table(JAX_SCHEMA, jax.tables["rc"].segments + [jlive])
    rng = np.random.default_rng(7)
    sql = "SELECT rcd, SUM(rcv), COUNT(*) FROM rc GROUP BY rcd ORDER BY rcd"
    seen = []
    for gen in range(3):
        for _ in range(40 * (gen + 1)):
            row = {"rck": int(rng.integers(0, 32)),
                   "rcd": int(rng.integers(0, 12)),
                   "rcv": int(rng.integers(-200, 200))}
            live.index(row)
            jlive.index(row)
        cold = _both(port, jax, sql)
        assert _counts(cold)[:2] == ((2, 1) if gen else (0, 3))
        warm = _both(port, jax, sql)
        assert _counts(warm) == (3, 0, 0)
        seen.append(cold.result_table.rows)
    assert seen[0] != seen[1] != seen[2]
    assert segment_token(live.snapshot_view())[:2] == ("rt", "rc_live")
    assert segment_token(live) is None


UPS_DIMS = [("pk", "STRING"), ("city", "STRING")]
UPS_METRICS = [("clicks", "INT")]
UPS_DATES = [("ts", "LONG")]
UPS_SQL = ("SELECT city, SUM(clicks), COUNT(*) FROM ups GROUP BY city "
           "ORDER BY city")


def _ups_schemas():
    kw = dict(dimensions=UPS_DIMS, metrics=UPS_METRICS, date_times=UPS_DATES,
              primary_key_columns=["pk"])
    return Schema.build("ups", **kw), JaxSchema.build("ups", **kw)


def test_upsert_overwrite_changes_the_committed_segments_key(tmp_path):
    """A committed upsert segment's token stays (name, crc), but its
    validity rides in the plan's mask param: an overwrite that flips one of
    its rows misses there and answers fresh rows; the consuming segment
    misses too (a new generation). `replace_segment` of the committed
    consuming segment answers as before, from a new key."""
    schema, jschema = _ups_schemas()
    upsert = dict(mode="FULL", comparison_columns=["ts"])
    cfg = tc.TableConfig(table_name="ups", upsert=tc.UpsertConfig(**upsert))
    jcfg = jax_tc.TableConfig(table_name="ups",
                              upsert=jax_tc.UpsertConfig(**upsert))
    mgr, jmgr = TableUpsertMetadataManager(schema, cfg), \
        JaxUpsert(jschema, jcfg)
    rng = np.random.default_rng(17)
    cities = ["sf", "la", "ny"]

    def row(i, ts):
        return {"pk": f"k{i}", "city": cities[int(rng.integers(0, 3))],
                "clicks": int(rng.integers(0, 100)), "ts": ts}

    first = [row(i, 1000 + i) for i in range(300)]
    cols = {k: np.asarray([r[k] for r in first],
                          dtype=object if k in ("pk", "city") else np.int64)
            for k in ("pk", "city", "clicks", "ts")}
    cols["clicks"] = cols["clicks"].astype(np.int32)
    path = tmp_path / "ups_0"
    SegmentBuilder(schema, segment_name="ups_0").build(cols, path)
    seg, jseg = load_segment(path), jax_load(path)
    mgr.add_segment(seg)
    jmgr.add_segment(jseg)
    live, jlive = MutableSegment(schema, "ups_1"), \
        JaxMutableSegment(jschema, "ups_1")
    port, jax = QueryExecutor(device="cpu"), JaxQueryExecutor(backend="tpu")
    port.add_table(schema, [seg, live])
    jax.add_table(jschema, [jseg, jlive])

    def put(r):
        for m, s in ((mgr, live), (jmgr, jlive)):
            m.add_record(s, s.index(dict(r)), dict(r))

    for i in range(300, 360):
        put(row(i, 2000 + i))
    cold = _both(port, jax, UPS_SQL)
    assert _counts(cold)[:2] == (0, 2)
    assert _counts(_both(port, jax, UPS_SQL)) == (2, 0, 0)
    fp_before = program_fingerprint(port.executor.plan(
        parse_sql(UPS_SQL), seg), parse_sql(UPS_SQL))
    put(row(5, 9000))  # overwrites k5 of the committed segment
    flipped = _both(port, jax, UPS_SQL)
    assert _counts(flipped)[:2] == (0, 2)
    assert flipped.result_table.rows != cold.result_table.rows
    assert program_fingerprint(port.executor.plan(
        parse_sql(UPS_SQL), seg), parse_sql(UPS_SQL)) != fp_before
    put(row(400, 50))  # a new key: only the consuming segment changes
    fresh = _both(port, jax, UPS_SQL)
    assert _counts(fresh)[:2] == (1, 1)
    # commit: the consuming segment becomes an immutable one, validity
    # moved one to one; the same rows from a new key
    from pinot_tpu.realtime.converter import \
        RealtimeSegmentConverter as JaxConverter
    from pinot_tpu_torch.realtime.converter import RealtimeSegmentConverter

    cpath = RealtimeSegmentConverter(schema, cfg,
                                     preserve_doc_order=True).convert(
        live, tmp_path / "port_c")
    jcpath = JaxConverter(jschema, jcfg,
                          preserve_doc_order=True).convert(
        jlive, tmp_path / "jax_c")
    new, jnew = load_segment(cpath), jax_load(jcpath)
    mgr.replace_segment(live, new)
    jmgr.replace_segment(jlive, jnew)
    port.add_table(schema, [seg, new])
    jax.add_table(jschema, [jseg, jnew])
    committed = _both(port, jax, UPS_SQL)
    assert committed.result_table.rows == fresh.result_table.rows
    assert _counts(committed)[:2] == (1, 1)


def test_partial_cache_eviction_respects_budget():
    c = SegmentPartialCache(max_bytes=600)  # opaque entries estimate 256 B
    c.put(("k1",), ["p1"], ("s1",))
    c.put(("k2",), ["p2"], ("s2",))
    c.put(("k3",), ["p3"], ("s3",))  # over budget: the LRU k1 goes
    assert c.get(("k1",)) is None
    assert c.get(("k2",)) == ["p2"]
    assert c.get(("k3",)) == ["p3"]
    st = c.stats()
    assert st["entries"] == 2 and st["evictions"] == 1
    assert st["bytes"] <= c.max_bytes
    assert c.invalidate_segment("s2") == 1
    assert c.get(("k2",)) is None
    tiny = SegmentPartialCache(max_bytes=100)
    tiny.put(("big",), ["x"], ("s",))
    assert tiny.stats()["entries"] == 0


def test_device_partial_budget_evicts_partials_first(dirs):
    cache = DeviceSegmentCache("cpu", budget_bytes=2000)
    cache.put_partial(("k1",), (torch.zeros(150, dtype=torch.int64),), "segA")
    cache.put_partial(("k2",), (torch.zeros(150, dtype=torch.int64),), "segB")
    # 2400 > 2000: the oldest partial goes, the fresh one stays
    assert cache.get_partial(("k1",)) is None
    assert cache.get_partial(("k2",)) is not None
    st = cache.stats()
    assert (st["partialEntries"], st["partialBytes"]) == (1, 1200)
    cache.put_partial(("big",), (torch.zeros(1000, dtype=torch.int64),),
                      "segC")
    assert cache.get_partial(("big",)) is None
    assert cache.drop_partials(segment_name="segB") == 1
    assert cache.stats()["partialEntries"] == 0
    # a view's upload evicts the partials before the view itself
    cache.put_partial(("k3",), (torch.zeros(100, dtype=torch.int64),), "s")
    seg = load_segment(dirs[0])
    cache.view(seg).dict_ids("rck")  # 8192 * 4 B: over the budget alone
    cache.view(seg)
    assert cache.stats()["partialEntries"] == 0
    assert id(seg) in cache._views
    # relief sheds every partial and every view but the kept one
    other = load_segment(dirs[1])
    cache.budget_bytes = None
    cache.view(other).dict_ids("rck")
    cache.put_partial(("k4",), (torch.zeros(8, dtype=torch.int64),), "s")
    freed, victims = cache.evict_all_except(seg)
    assert (freed, victims) == (8192 * 4 + 64, 2)
    assert list(cache._views) == [id(seg)]
    # drop / drop_named release a segment's views, stacks and partials
    cache.put_partial(("k5",), (torch.zeros(8, dtype=torch.int64),),
                      seg.name)
    cache.stacked_view([seg, other]).plane(("x",), lambda: torch.zeros(4))
    assert cache.drop_named(seg.name) == 8192 * 4 + 16 + 64
    assert cache.stats() == {**cache.stats(), "viewBytes": 0,
                             "stackBytes": 0, "partialEntries": 0}
    cache.view(other).dict_ids("rck")
    cache.drop(other)
    assert cache.bytes_used() == 0


def test_broker_result_cache_ttl_and_capacity():
    clk = [0.0]
    c = BrokerResultCache(max_bytes=10_000, ttl_s=10.0, clock=lambda: clk[0])
    c.put(("k",), SimpleNamespace(result_table=None))
    assert c.get(("k",)) is not None
    clk[0] = 9.0
    assert c.get(("k",)) is not None
    clk[0] = 10.5  # past the TTL: expired on read, a miss
    assert c.get(("k",)) is None
    assert c.stats()["entries"] == 0 and c.stats()["misses"] == 1
    cap = BrokerResultCache(max_bytes=1200, ttl_s=1e9, clock=lambda: clk[0])
    for i in range(3):  # 512 B each: the third evicts the LRU
        cap.put((f"k{i}",), SimpleNamespace(result_table=None))
    assert cap.get(("k0",)) is None
    assert cap.get(("k2",)) is not None
    st = cap.stats()
    assert st["evictions"] == 1 and st["bytes"] <= 1200
    assert cap.clear() == 2


# -- the multi-stage result cache ------------------------------------------------


def _mse_both(port, jax, sql):
    want = jax.execute_sql(sql)
    got = port.execute_sql(sql)
    assert not want.exceptions and not got.exceptions, (want.exceptions,
                                                        got.exceptions)
    assert got.result_table.rows == want.result_table.rows
    assert got.num_device_dispatches == want.num_device_dispatches
    assert got.cache_outcome == (getattr(want, "cache_outcome", "") or "")
    return got


@pytest.mark.parametrize("sql", [JOIN_SQL, MSE_AGG_SQL], ids=["join", "agg"])
def test_mse_warm_repeat_is_a_hit(engine, sql):
    cold = _mse_both(engine.port, engine.jax, sql)
    assert cold.cache_outcome == "miss" and cold.num_device_dispatches > 0
    warm = _mse_both(engine.port, engine.jax, sql)
    assert warm.cache_outcome == "hit" and warm.num_device_dispatches == 0
    assert warm.result_table.rows == cold.result_table.rows
    assert engine.port.multistage.result_cache.stats()["hits"] == 1
    again = _mse_both(engine.port, engine.jax, sql)
    assert again.result_table is cold.result_table  # shared, read-only


def test_mse_opt_outs(engine, monkeypatch):
    off = "SET resultCache = false; "
    for _ in range(2):
        resp = _mse_both(engine.port, engine.jax, off + JOIN_SQL)
        assert resp.cache_outcome == "" and resp.num_device_dispatches > 0
    monkeypatch.setenv("PINOT_TPU_RESULT_CACHE", "0")
    fps = fingerprint_computations()
    resp = _mse_both(engine.port, engine.jax, JOIN_SQL)
    assert resp.cache_outcome == ""
    # opted out before any key: the statement (its leaves are scans, which
    # the partial cache does not key) computes no fingerprint
    assert fingerprint_computations() == fps
    assert engine.port.multistage.result_cache.stats()["entries"] == 0


def test_mse_leaf_hits_the_partial_cache(engine):
    """With the result cache off, the leaf partial aggregate (the
    single-stage family) is served by the segment partial cache."""
    sql = "SET resultCache = false; " + MSE_AGG_SQL
    cold = _mse_both(engine.port, engine.jax, sql)
    assert cold.num_device_dispatches == 1
    warm = _mse_both(engine.port, engine.jax, sql)
    assert warm.num_device_dispatches == 0
    assert warm.result_table.rows == cold.result_table.rows


def test_mse_replaced_segment_misses(dirs, tmp_path):
    port, jax = _pair(dirs[:2])
    _mse_both(port, jax, JOIN_SQL)
    assert _mse_both(port, jax, JOIN_SQL).cache_outcome == "hit"
    fresh = _build(tmp_path / "r1", "rc1", _gen(np.random.default_rng(5)))
    port.add_table(SCHEMA, [load_segment(dirs[0]), load_segment(fresh)])
    jax.add_table(JAX_SCHEMA, [jax_load(dirs[0]), jax_load(fresh)])
    assert _mse_both(port, jax, JOIN_SQL).cache_outcome == "miss"
