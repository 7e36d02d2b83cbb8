"""Upsert and dedup tables in the port (pinot_tpu_torch), against the JAX
package.

Both packages' managers (`upsert/manager.py`) take the same seeded rows a
row at a time; validity goes into the filter as an `ir.MaskParam` plane
(`engine/plan.py` `_and_valid_docs`, evaluated in `ops/kernels.py`). The
JAX package answers as `QueryExecutor(backend="tpu")` with
`PINOT_TPU_FUSED=interpret`, its segment cache off. On the CPU:

  * FULL mode on a consuming segment: an overwrite flips visibility on the
    next query, a row with an older comparison value loses (the
    reference's tests/test_realtime_device_planes.py:305);
  * PARTIAL mode merges each column by its strategy; a truthy delete
    column tombstones the key, and an older delete loses; dedup drops
    repeated keys; metadata TTL drops old keys as the JAX package does;
  * a commit through `RealtimeSegmentConverter` (doc order kept) and
    `replace_segment` moves validity one to one; `add_segment` replays an
    immutable segment's validity; the MaskParam runs in a batch family of
    immutable segments (one dispatch, `[S, padded]` mask) and solo, and in
    a hybrid table of committed and consuming segments;
  * plans with the validity plane equal the JAX package's.

Every result is held against the JAX package's rows and an oracle (the
last version of each key). Tolerance: exact (integer sums and counts).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from pinot_tpu.engine.query_executor import QueryExecutor as JaxQueryExecutor
from pinot_tpu.query.parser.sql import parse_sql as jax_parse
from pinot_tpu.realtime import device_plane as jax_dp
from pinot_tpu.realtime.converter import \
    RealtimeSegmentConverter as JaxConverter
from pinot_tpu.segment.loader import load_segment as jax_load
from pinot_tpu.segment.mutable import MutableSegment as JaxMutableSegment
from pinot_tpu.spi import table_config as jax_tc
from pinot_tpu.spi.data_types import Schema as JaxSchema
from pinot_tpu.upsert import TableDedupManager as JaxDedup
from pinot_tpu.upsert import TableUpsertMetadataManager as JaxUpsert
from pinot_tpu_torch.engine import ir
from pinot_tpu_torch.engine.plan import SegmentPlanner
from pinot_tpu_torch.engine.query_executor import QueryExecutor
from pinot_tpu_torch.ops import kernels
from pinot_tpu_torch.query.parser.sql import parse_sql
from pinot_tpu_torch.realtime import device_plane
from pinot_tpu_torch.realtime.converter import RealtimeSegmentConverter
from pinot_tpu_torch.segment.builder import SegmentBuilder
from pinot_tpu_torch.segment.loader import load_segment
from pinot_tpu_torch.segment.mutable import MutableSegment
from pinot_tpu_torch.spi import table_config as tc
from pinot_tpu_torch.spi.data_types import Schema
from pinot_tpu_torch.upsert import (TableDedupManager,
                                    TableUpsertMetadataManager, ValidDocIds)

DIMS = [("pk", "STRING"), ("city", "STRING"), ("deleted", "INT")]
METRICS = [("clicks", "INT")]
DATES = [("ts", "LONG")]
SCHEMA = Schema.build("events", dimensions=DIMS, metrics=METRICS,
                      date_times=DATES, primary_key_columns=["pk"])
JAX_SCHEMA = JaxSchema.build("events", dimensions=DIMS, metrics=METRICS,
                             date_times=DATES, primary_key_columns=["pk"])
NOCACHE = "SET segmentCache = false; SET resultCache = false; "
CITY_SQL = ("SELECT city, SUM(clicks), COUNT(*) FROM events "
            "GROUP BY city ORDER BY city LIMIT 100")
CITIES = ["sf", "la", "ny", "sea", "chi"]


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


def _configs(**upsert):
    """(port TableConfig, JAX TableConfig) with the same upsert config."""
    upsert.setdefault("comparison_columns", ["ts"])
    return (tc.TableConfig(table_name="events",
                           upsert=tc.UpsertConfig(**upsert)),
            jax_tc.TableConfig(table_name="events",
                               upsert=jax_tc.UpsertConfig(**upsert)))


class Table:
    """An upsert (or dedup) table in each package: managers, segments and
    query executors, fed the same rows."""

    def __init__(self, dedup=False, **upsert):
        cfg, jcfg = _configs(**upsert)
        if dedup:
            self.mgr = TableDedupManager(SCHEMA, cfg)
            self.jmgr = JaxDedup(JAX_SCHEMA, jcfg)
        else:
            self.mgr = TableUpsertMetadataManager(SCHEMA, cfg)
            self.jmgr = JaxUpsert(JAX_SCHEMA, jcfg)
        self.cfg, self.jcfg = cfg, jcfg
        self.port = QueryExecutor(device="cpu")
        self.jax = JaxQueryExecutor(backend="tpu")
        self.segs, self.jsegs = [], []
        self.consuming = self.jconsuming = None

    def register(self):
        self.port.add_table(SCHEMA, self.segs, "events")
        self.jax.add_table(JAX_SCHEMA, self.jsegs, "events")

    def start_consuming(self, name):
        self.consuming = MutableSegment(SCHEMA, name)
        self.jconsuming = JaxMutableSegment(JAX_SCHEMA, name)
        self.segs.append(self.consuming)
        self.jsegs.append(self.jconsuming)
        self.register()

    def put(self, row):
        for mgr, seg in ((self.mgr, self.consuming),
                         (self.jmgr, self.jconsuming)):
            r = mgr.process_row(seg, dict(row))
            if r is None:
                continue  # a dedup table drops the repeated key
            mgr.add_record(seg, seg.index(r), r)

    def rows(self, sql=CITY_SQL):
        got = self.port.execute_sql(sql)
        want = self.jax.execute_sql(NOCACHE + sql)
        assert not want.exceptions, want.exceptions
        assert [tuple(r) for r in got.result_table.rows] == \
            [tuple(r) for r in want.result_table.rows]
        assert got.num_device_dispatches == want.num_device_dispatches
        return got


def _row(pk, city, clicks, ts, deleted=0):
    return {"pk": pk, "city": city, "clicks": clicks, "ts": ts,
            "deleted": deleted}


def _city_oracle(latest: dict):
    out = {}
    for r in latest.values():
        s, c = out.get(r["city"], (0, 0))
        out[r["city"]] = (s + r["clicks"], c + 1)
    return sorted((k, s, c) for k, (s, c) in out.items())


def _canon(resp):
    return sorted((r[0], int(r[1]), int(r[2]))
                  for r in resp.result_table.rows)


def _gen(n, keys, seed, t0=1000, stale_every=0):
    """n rows over `keys` keys; with stale_every, one row in that many
    arrives with an older ts than its key's last."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        ts = t0 + i
        if stale_every and i % stale_every == stale_every - 1:
            ts = t0 - 1 - i
        rows.append(_row(f"k{int(rng.integers(keys))}",
                         CITIES[int(rng.integers(len(CITIES)))],
                         int(rng.integers(1, 100)), ts))
    return rows


def _latest(rows, latest=None):
    """The oracle: the newest version of each key (ties to the later
    arrival), as the manager resolves FULL mode."""
    latest = {} if latest is None else latest
    for r in rows:
        old = latest.get(r["pk"])
        if old is None or r["ts"] >= old["ts"]:
            latest[r["pk"]] = r
    return latest


# ---------------------------------------------------------------------------
# FULL mode on a consuming segment
# ---------------------------------------------------------------------------


def test_full_overwrite_flips_visibility_and_stale_loses():
    t = Table(mode="FULL")
    t.start_consuming("ups_full_0")
    for i in range(40):
        t.put(_row(f"k{i}", "sf", 1, 100))
    assert _canon(t.rows()) == [("sf", 40, 40)]
    for i in range(20):
        t.put(_row(f"k{i}", "la", 5, 200))
    assert _canon(t.rows()) == [("la", 100, 20), ("sf", 20, 20)]
    # an older ts loses: visibility does not flip
    t.put(_row("k0", "ny", 9, 50))
    assert _canon(t.rows()) == [("la", 100, 20), ("sf", 20, 20)]
    assert t.mgr.num_primary_keys() == t.jmgr.num_primary_keys() == 40


def test_full_mode_random_rows_equal_oracle_every_generation():
    t = Table(mode="FULL")
    t.start_consuming("ups_rand_0")
    latest = {}
    for n, seed in ((3000, 1), (500, 2), (40, 3)):
        rows = _gen(n, 700, seed, t0=1000 * seed, stale_every=16)
        for r in rows:
            t.put(r)
        _latest(rows, latest)
        assert _canon(t.rows()) == _city_oracle(latest)


def test_validity_plan_equals_jax():
    t = Table(mode="FULL")
    t.start_consuming("ups_plan_0")
    for r in _gen(1500, 300, 4, stale_every=8):
        t.put(r)
    sql = ("SELECT city, SUM(clicks) FROM events WHERE ts > 1200 "
           "GROUP BY city LIMIT 100")
    pplan = device_plane.realtime_plan(parse_sql(sql),
                                       t.consuming.snapshot_view())
    jplan = jax_dp.realtime_plan(jax_parse(sql),
                                 t.jconsuming.snapshot_view())
    assert repr(pplan.program) == repr(jplan.program)
    assert "MaskParam" in repr(pplan.program)
    assert len(pplan.params) == len(jplan.params)
    for a, b in zip(pplan.params, jplan.params):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ---------------------------------------------------------------------------
# PARTIAL, deletes, dedup, TTL
# ---------------------------------------------------------------------------


def test_partial_upsert_merges():
    t = Table(mode="PARTIAL",
              partial_upsert_strategies={"clicks": "INCREMENT",
                                         "city": "IGNORE"})
    t.start_consuming("ups_partial_0")
    for i in range(30):
        t.put(_row(f"k{i % 10}", CITIES[i % 5], i, 100 + i))
    got = t.rows()
    # clicks add up per key; the city stays the first version's
    want = {}
    for i in range(30):
        k = f"k{i % 10}"
        city, clicks = want.get(k, (CITIES[i % 5], 0))
        want[k] = (city, clicks + i)
    assert _canon(got) == _city_oracle(
        {k: {"city": c, "clicks": s} for k, (c, s) in want.items()})


def test_delete_record_column_tombstones():
    t = Table(mode="FULL", delete_record_column="deleted")
    t.start_consuming("ups_del_0")
    for i in range(20):
        t.put(_row(f"k{i}", "sf", 1, 100))
    t.put(_row("k0", "sf", 0, 150, deleted=1))
    t.put(_row("k1", "sf", 0, 150, deleted=1))
    t.put(_row("k2", "sf", 0, 50, deleted=1))  # older than k2: loses
    t.put(_row("k1", "la", 7, 200))  # newer than its tombstone: back
    t.put(_row("k0", "la", 7, 120))  # older than its tombstone: stays gone
    assert _canon(t.rows()) == [("la", 7, 1), ("sf", 18, 18)]


def test_dedup_drops_repeated_keys():
    t = Table(dedup=True, mode="NONE")
    t.start_consuming("dedup_0")
    rows = _gen(400, 100, 5)
    for r in rows:
        t.put(r)
    first = {}
    for r in rows:
        first.setdefault(r["pk"], r)
    assert t.consuming.num_docs == len(first) == t.jconsuming.num_docs
    assert _canon(t.rows()) == _city_oracle(first)


def test_metadata_ttl_drops_old_keys_as_jax_does():
    t = Table(mode="FULL", metadata_ttl=100.0)
    t.start_consuming("ups_ttl_0")
    for r in _gen(300, 80, 6):
        t.put(r)
    assert t.mgr.remove_expired_metadata() == \
        t.jmgr.remove_expired_metadata() > 0
    assert t.mgr.num_primary_keys() == t.jmgr.num_primary_keys()


def test_sync_consistency_shares_the_manager_lock():
    t = Table(mode="FULL", consistency_mode="SYNC")
    t.start_consuming("ups_sync_0")
    t.put(_row("k0", "sf", 1, 1))
    assert t.consuming.valid_doc_ids._lock is t.mgr._lock


# ---------------------------------------------------------------------------
# committed segments
# ---------------------------------------------------------------------------


def test_commit_moves_validity_one_to_one(tmp_path):
    """Consuming -> immutable through the converter (doc order kept):
    replace_segment moves validity, and the table answers as before; later
    overwrites invalidate docs of the committed segment."""
    t = Table(mode="FULL")
    t.start_consuming("ups_commit_0")
    rows = _gen(2000, 400, 7, stale_every=10)
    for r in rows:
        t.put(r)
    latest = _latest(rows)
    before = _canon(t.rows())
    assert before == _city_oracle(latest)
    old, jold = t.consuming, t.jconsuming
    path = RealtimeSegmentConverter(SCHEMA, t.cfg, preserve_doc_order=True) \
        .convert(old, tmp_path / "port")
    jpath = JaxConverter(JAX_SCHEMA, t.jcfg, preserve_doc_order=True) \
        .convert(jold, tmp_path / "jax")
    new, jnew = load_segment(path), jax_load(jpath)
    t.mgr.replace_segment(old, new)
    t.jmgr.replace_segment(jold, jnew)
    np.testing.assert_array_equal(new.valid_doc_ids.mask(new.num_docs),
                                  old.valid_doc_ids.mask(old.num_docs))
    t.segs, t.jsegs = [new], [jnew]
    t.start_consuming("ups_commit_1")
    assert _canon(t.rows()) == before
    more = _gen(300, 400, 8, t0=5000)
    for r in more:
        t.put(r)
    assert _canon(t.rows()) == _city_oracle(_latest(more, latest))


def _built(tmp_path, name, rows):
    cols = {c: [r[c] for r in rows] for c in
            ("pk", "city", "deleted", "clicks", "ts")}
    path = tmp_path / name
    SegmentBuilder(SCHEMA, segment_name=name).build(cols, path)
    return load_segment(path), jax_load(path)


def _replayed(tmp_path, chunks, **upsert):
    """An upsert table of committed segments, one per chunk of rows,
    replayed through add_segment in commit order."""
    upsert.setdefault("mode", "FULL")
    t = Table(**upsert)
    for i, rows in enumerate(chunks):
        seg, jseg = _built(tmp_path, f"ups_imm_{i}", rows)
        t.mgr.add_segment(seg)
        t.jmgr.add_segment(jseg)
        t.segs.append(seg)
        t.jsegs.append(jseg)
    t.register()
    return t


def test_add_segment_replays_validity_family_and_solo(tmp_path):
    """Three committed segments in one pad bucket: one family dispatch
    with a [3, padded] validity mask, and three solo dispatches, both
    equal to the JAX package and the oracle."""
    rows = _gen(3 * 1500, 900, 9, stale_every=12)
    chunks = [rows[i * 1500:(i + 1) * 1500] for i in range(3)]
    t = _replayed(tmp_path, chunks)
    want = _city_oracle(_latest(rows))
    for seg, jseg in zip(t.segs, t.jsegs):
        np.testing.assert_array_equal(
            seg.valid_doc_ids.mask(seg.num_docs),
            jseg.valid_doc_ids.mask(jseg.num_docs))
    fetches = kernels.host_fetches()
    fam = t.rows()
    assert kernels.host_fetches() - fetches == 1
    assert fam.num_device_dispatches == 1
    assert _canon(fam) == want
    solo = t.rows("SET segmentBatch = false; " + CITY_SQL)
    assert solo.num_device_dispatches == 3
    assert _canon(solo) == want


def test_partial_merge_reads_the_committed_version(tmp_path):
    """PARTIAL mode over a committed segment: the consuming row merges
    with the previous version read out of the immutable segment
    (`ImmutableSegment.read_cell`)."""
    rows = [_row(f"k{i}", CITIES[i % 5], 10 + i, 100 + i) for i in range(20)]
    t = _replayed(tmp_path, [rows], mode="PARTIAL",
                  partial_upsert_strategies={"clicks": "INCREMENT",
                                             "city": "IGNORE"})
    t.start_consuming("ups_partial_1")
    for i in range(0, 20, 2):
        t.put(_row(f"k{i}", "la", 1000, 500 + i))
    want = {r["pk"]: dict(r) for r in rows}
    for i in range(0, 20, 2):
        want[f"k{i}"]["clicks"] += 1000
    assert _canon(t.rows()) == _city_oracle(want)


def test_hybrid_upsert_table_masks_every_segment(tmp_path):
    """A committed segment and a consuming one, both carrying a
    MaskParam; overwrites in the consuming segment invalidate committed
    docs."""
    rows = _gen(2000, 500, 10, stale_every=20)
    t = _replayed(tmp_path, [rows])
    t.start_consuming("ups_hyb_1")
    more = _gen(800, 500, 11, t0=9000, stale_every=20)
    for r in more:
        t.put(r)
    got = t.rows()
    assert got.num_device_dispatches == 2
    assert _canon(got) == _city_oracle(_latest(more, _latest(rows)))
    committed = SegmentPlanner(parse_sql(CITY_SQL), t.segs[0]).plan()
    consuming = device_plane.realtime_plan(parse_sql(CITY_SQL),
                                           t.consuming.snapshot_view())
    for plan in (committed, consuming):
        assert isinstance(plan.program.filter, ir.MaskParam)


def test_valid_doc_ids_snapshot_is_pinned():
    v = ValidDocIds()
    v.set(3, True)
    mask, gen = v.snapshot(5)
    v.set(3, False)
    assert mask.tolist() == [False, False, False, True, False]
    assert v.snapshot(5)[1] == gen + 1
