"""Realtime ingestion through the port's `RealtimeTableDataManager`
(pinot_tpu_torch/realtime/manager.py), against the JAX package's.

Each test publishes the same seeded rows to each package's own in-memory
topic (each package's `GLOBAL_STREAM_REGISTRY` replaced by a fresh
registry) and runs one manager of each package over it, each with its own
data directory. At each settle point the two agree on: the rows the port's
`QueryExecutor(device="cpu")` answers over `mgr.segments` and the JAX
package's `QueryExecutor(backend="tpu")` (`PINOT_TPU_FUSED=interpret`,
caches off, one mesh device); the checkpoint JSON; the committed segments'
names and every column of them; and, under the completion protocol, the
DONE records. Segment names carry the wall clock outside the protocol, so
those compare with the timestamp field stripped.

Cases: consume, query, force-commit and resume from the checkpoint with no
row lost or consumed twice; a sorted-column conversion; 2 partitions;
upsert and dedup tables committing through the manager; two replicas
electing one committer (the loser downloads the build); a committer that
dies before `segment_commit_end`, replaced after its lease; a pauseless
commit overlapping the successor's consumption (driven by events, no
sleeps); consumers holding through a leaderless window and committing once
a leader is back; and fault F8, rows published after a commit counted by an
executor registered before it.

Every wait is bounded and every manager is stopped at teardown. Tolerance:
exact (integer sums and counts).
"""

from __future__ import annotations

import json
import threading
import time

import numpy as np
import pytest
import torch

from pinot_tpu.cluster.controller import ClusterController as JaxController
from pinot_tpu.cluster.store import PropertyStore as JaxStore
from pinot_tpu.engine.query_executor import QueryExecutor as JaxQueryExecutor
from pinot_tpu.realtime import completion as jax_completion
from pinot_tpu.realtime.manager import \
    RealtimeTableDataManager as JaxRealtimeManager
from pinot_tpu.spi import stream as jax_stream
from pinot_tpu.spi import table_config as jax_tc
from pinot_tpu.spi.data_types import Schema as JaxSchema
from pinot_tpu.spi.metrics import SERVER_METRICS as JAX_SERVER_METRICS
from pinot_tpu_torch.cluster.controller import ClusterController
from pinot_tpu_torch.cluster.store import PropertyStore
from pinot_tpu_torch.engine.query_executor import QueryExecutor
from pinot_tpu_torch.realtime import RealtimeTableDataManager, completion
from pinot_tpu_torch.spi import stream
from pinot_tpu_torch.spi import table_config as tc
from pinot_tpu_torch.spi.data_types import Schema
from pinot_tpu_torch.spi.metrics import SERVER_METRICS, ServerMeter

DIMS = [("user", "STRING"), ("site", "STRING"), ("ts", "LONG")]
METRICS = [("clicks", "INT")]
UPSERT_DIMS = DIMS + [("pk", "LONG")]
NOCACHE = "SET segmentCache = false; SET resultCache = false; "
SUM_SQL = "SELECT COUNT(*), SUM(clicks) FROM clicks"
GROUP_SQL = ("SELECT user, COUNT(*), SUM(clicks) FROM clicks GROUP BY user "
             "ORDER BY user LIMIT 100")
WAIT_S = 20.0


@pytest.fixture(autouse=True)
def _jax_dispatches_every_query(monkeypatch):
    monkeypatch.setenv("PINOT_TPU_SEGMENT_CACHE", "0")
    monkeypatch.setenv("PINOT_TPU_RESULT_CACHE", "0")
    monkeypatch.setenv("PINOT_TPU_MESH_DEVICES", "1")
    monkeypatch.setenv("PINOT_TPU_FUSED", "interpret")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


class Topics:
    """One fresh in-memory registry per package; every row goes to both."""

    def __init__(self, port, jax):
        self.port, self.jax = port, jax

    def create(self, topic, partitions=1):
        self.port.create_topic(topic, num_partitions=partitions)
        self.jax.create_topic(topic, num_partitions=partitions)

    def publish(self, topic, rows, partition_key=None):
        self.port.publish(topic, [dict(r) for r in rows], partition_key)
        self.jax.publish(topic, [dict(r) for r in rows], partition_key)


@pytest.fixture()
def topics(monkeypatch):
    t = Topics(stream.InMemoryStreamRegistry(),
               jax_stream.InMemoryStreamRegistry())
    monkeypatch.setattr(stream, "GLOBAL_STREAM_REGISTRY", t.port)
    monkeypatch.setattr(jax_stream, "GLOBAL_STREAM_REGISTRY", t.jax)
    return t


@pytest.fixture()
def started():
    """Managers (and controllers) to stop at teardown, whatever happens."""
    out: list = []
    yield out
    for m in reversed(out):
        m.stop()


def wait_until(pred, timeout=WAIT_S):
    t0 = time.time()
    while time.time() - t0 < timeout:
        if pred():
            return True
        time.sleep(0.01)
    return False


def rows(n, start=0, seed=0, keys=None):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(start, start + n):
        r = {"user": f"u{int(rng.integers(6))}",
             "site": ["a.com", "b.com", "c.com"][int(rng.integers(3))],
             "ts": 1_600_000_000_000 + i * 1000,
             "clicks": int(rng.integers(1, 50))}
        if keys is not None:
            r["pk"] = int(rng.integers(keys))
        out.append(r)
    return out


def schemas(dims=DIMS, pk=None):
    kw = dict(dimensions=dims, metrics=METRICS,
              primary_key_columns=[pk] if pk else None)
    return Schema.build("clicks", **kw), JaxSchema.build("clicks", **kw)


def configs(topic, flush_rows, sorted_column=None, upsert=None,
            dedup=False):
    """The same table config in each package."""
    out = []
    for m in (tc, jax_tc):
        out.append(m.TableConfig(
            table_name="clicks", table_type=m.TableType.REALTIME,
            indexing=m.IndexingConfig(sorted_column=sorted_column),
            validation=m.SegmentsValidationConfig(time_column_name="ts"),
            upsert=m.UpsertConfig(**upsert) if upsert else m.UpsertConfig(),
            dedup=m.DedupConfig(enabled=dedup),
            ingestion=m.IngestionConfig(stream_configs={
                "streamType": "inmemory",
                "stream.inmemory.topic.name": topic,
                "realtime.segment.flush.threshold.rows": flush_rows})))
    return out


class Pair:
    """A port manager and a JAX manager over the same rows, each behind its
    package's executor, registered before consumption starts."""

    def __init__(self, started, root, schemas_, configs_, start=True,
                 **kw):
        (self.schema, self.jschema), (cfg, jcfg) = schemas_, configs_
        self.port = RealtimeTableDataManager(self.schema, cfg, root / "port",
                                             **kw)
        self.jax = JaxRealtimeManager(self.jschema, jcfg, root / "jax", **kw)
        started += [self.port, self.jax]
        self.qe = QueryExecutor(device="cpu")
        self.qe.add_table(self.schema, self.port.segments)
        self.jqe = JaxQueryExecutor(backend="tpu")
        self.jqe.add_table(self.jschema, self.jax.segments)
        if start:
            self.start()

    def start(self):
        self.port.start()
        self.jax.start()

    def settle(self, total, committed):
        assert wait_until(lambda: all(
            m.total_docs() == total and len(m._committed) == committed
            for m in (self.port, self.jax))), (
            self.port.total_docs(), len(self.port._committed),
            self.jax.total_docs(), len(self.jax._committed))

    def query(self, sql):
        got = self.qe.execute_sql(sql)
        want = self.jqe.execute_sql(NOCACHE + sql)
        assert not want.exceptions, want.exceptions
        assert got.result_table.rows == want.result_table.rows, sql
        return got.result_table.rows

    def same_commits(self):
        """Equal committed segments (names without their timestamps, row
        counts, every column) and equal checkpoints. Partitions commit in
        their own threads, so segments compare in (partition, seq)
        order."""
        got, want = (sorted(m._committed, key=lambda s: llc_key(s.name))
                     for m in (self.port, self.jax))
        assert [strip(s.name) for s in got] == [strip(s.name) for s in want]
        for s, j in zip(got, want):
            assert s.num_docs == j.num_docs
            for c in self.schema.column_names():
                assert s.get_values(c).tolist() == j.get_values(c).tolist()
        assert checkpoint(self.port) == checkpoint(self.jax)
        return checkpoint(self.port)


def strip(name):
    """An LLC segment name without its timestamp field."""
    return "__".join(name.split("__")[:3])


def llc_key(name):
    """(partition, seq) of an LLC segment name."""
    return tuple(int(x) for x in name.split("__")[1:3])


def checkpoint(mgr):
    cp = json.loads((mgr.data_dir / "_checkpoints.json").read_text())
    return {"partitions": cp["partitions"],
            "segments": [strip(n) for n in sorted(cp["segments"],
                                                  key=llc_key)]}


def test_consume_query_commit_and_resume(topics, tmp_path, started):
    topics.create("rt1")
    data = rows(100, seed=1)
    topics.publish("rt1", data[:80])
    p = Pair(started, tmp_path, schemas(), configs("rt1", 60))
    p.settle(80, 1)  # 80 rows in one fetch: the segment seals at 80
    assert p.query(SUM_SQL) == [[80, sum(r["clicks"] for r in data[:80])]]
    p.query(GROUP_SQL)
    p.same_commits()
    topics.publish("rt1", data[80:])
    p.settle(100, 1)
    assert p.query(SUM_SQL)[0][0] == 100
    assert [strip(n) for n in p.port.force_commit()] == \
        [strip(n) for n in p.jax.force_commit()] == ["clicks__0__1"]
    p.settle(100, 2)
    p.query(GROUP_SQL)
    assert p.same_commits() == {"partitions": {"0": "100"},
                                "segments": ["clicks__0__0", "clicks__0__1"]}
    names = [s.name for s in p.port._committed]
    p.port.stop()
    p.jax.stop()

    # restart from the checkpoints: nothing re-consumed, commit order kept
    topics.publish("rt1", data[:0])
    again = Pair(started, tmp_path, schemas(), configs("rt1", 60))
    again.settle(100, 2)
    time.sleep(0.05)  # a re-consume would show in the totals
    assert again.port.total_docs() == again.jax.total_docs() == 100
    assert [s.name for s in again.port._committed] == names
    again.query(GROUP_SQL)
    again.same_commits()
    # rows published after the restart are consumed once
    topics.publish("rt1", rows(7, start=100, seed=2))
    again.settle(107, 2)
    again.query(SUM_SQL)


def test_sorted_column_conversion(topics, tmp_path, started):
    topics.create("rt2")
    topics.publish("rt2", rows(40, seed=3))
    p = Pair(started, tmp_path, schemas(),
             configs("rt2", 40, sorted_column="user"))
    p.settle(40, 1)
    p.same_commits()
    seg, jseg = p.port._committed[0], p.jax._committed[0]
    users = seg.get_values("user").tolist()
    assert users == sorted(users)
    assert seg.column_metadata("user").is_sorted \
        == jseg.column_metadata("user").is_sorted is True


def test_two_partitions(topics, tmp_path, started):
    topics.create("rt3", partitions=2)
    data = rows(90, seed=4)
    # routing hashes the key in this process: both packages route alike,
    # and the split between the partitions is read back from the topic
    topics.publish("rt3", data, partition_key="ts")
    sizes = [len(part) for part in topics.port.topic("rt3").partitions]
    assert sizes == [len(part) for part in topics.jax.topic("rt3").partitions]
    # each partition's first fetch takes all its rows: one seal at >= 30
    p = Pair(started, tmp_path, schemas(), configs("rt3", 30))
    sealed = sum(n >= 30 for n in sizes)
    p.settle(90, sealed)
    assert sorted(p.port._consuming) == [0, 1]
    p.query(SUM_SQL)
    p.query(GROUP_SQL)
    p.same_commits()
    topics.publish("rt3", rows(20, start=90, seed=5), partition_key="ts")
    p.settle(110, sealed)
    forced = [len(m.force_commit()) for m in (p.port, p.jax)]
    assert forced[0] == forced[1] > 0
    p.settle(110, sealed + forced[0])
    cp = p.same_commits()
    assert sum(int(v) for v in cp["partitions"].values()) == 110
    p.query(GROUP_SQL)


def latest(data, key="pk", cmp="ts"):
    """The newest version of each key (the last of equal comparison
    values)."""
    out = {}
    for r in data:
        if r[key] not in out or r[cmp] >= out[r[key]][cmp]:
            out[r[key]] = r
    return list(out.values())


def test_upsert_table_through_the_manager(topics, tmp_path, started):
    topics.create("rt4")
    data = rows(45, seed=6, keys=20)
    topics.publish("rt4", data)
    p = Pair(started, tmp_path, schemas(UPSERT_DIMS, pk="pk"),
             configs("rt4", 40, upsert={"mode": "FULL",
                                        "comparison_columns": ["ts"]}))
    p.settle(45, 1)
    # overwrites of committed keys cross the commit
    more = rows(30, start=45, seed=7, keys=20)
    topics.publish("rt4", more)
    p.settle(75, 1)
    want = latest(data + more)
    assert p.query(SUM_SQL) == [[len(want),
                                 sum(r["clicks"] for r in want)]]
    p.query(GROUP_SQL)
    p.same_commits()
    p.port.force_commit()
    p.jax.force_commit()
    p.settle(75, 2)
    assert p.query(SUM_SQL)[0][0] == len(want)
    p.same_commits()


def test_dedup_table_through_the_manager(topics, tmp_path, started):
    topics.create("rt5")
    data = rows(45, seed=8, keys=30)
    topics.publish("rt5", data)
    p = Pair(started, tmp_path, schemas(UPSERT_DIMS, pk="pk"),
             configs("rt5", 20, dedup=True))
    first = len({r["pk"] for r in data})
    p.settle(first, 1)  # duplicates dropped before indexing
    more = rows(20, start=45, seed=9, keys=40)
    topics.publish("rt5", more)
    unique = len({r["pk"] for r in data + more})
    p.settle(unique, 1)
    assert p.query(SUM_SQL)[0][0] == unique
    p.port.force_commit()
    p.jax.force_commit()
    p.settle(unique, 2)
    for m in (p.port, p.jax):
        assert all(c.state != "ERROR" for c in m._consuming.values())
    p.query(GROUP_SQL)
    p.same_commits()


class Replicas:
    """Managers A and B of each package over one completion manager of
    that package (or one client per package), one stream."""

    def __init__(self, started, root, topic, flush, port_completion,
                 jax_completion_, hooks=None, start=True):
        schema, jschema = schemas()
        cfg, jcfg = configs(topic, flush)
        self.port, self.jax = {}, {}
        for inst in ("A", "B"):
            self.port[inst] = RealtimeTableDataManager(
                schema, cfg, root / f"port_{inst}",
                completion=port_completion, instance_id=inst,
                test_hooks=hooks)
            self.jax[inst] = JaxRealtimeManager(
                jschema, jcfg, root / f"jax_{inst}",
                completion=jax_completion_, instance_id=inst,
                test_hooks=hooks)
            started += [self.port[inst], self.jax[inst]]
        self.schema = schema
        if start:
            self.start()

    def start(self):
        for m in (*self.port.values(), *self.jax.values()):
            m.start()

    def names(self, pkg):
        return {i: list(m._segment_names) for i, m in pkg.items()}

    def committed_columns(self, mgr):
        return [[s.get_values(c).tolist() for c in self.schema.column_names()]
                for s in mgr._committed]


def _done(store, table="clicks"):
    """{segment: record without its clock and build path}."""
    out = {}
    for seg in store.children(f"/SEGMENTS/{table}"):
        rec = dict(store.get(f"/SEGMENTS/{table}/{seg}"))
        rec.pop("commitTimeMs")
        rec.pop("location")
        rec.pop("committer")
        out[seg] = rec
    return out


def test_two_replicas_one_commit(topics, tmp_path, started):
    topics.create("rt6")
    store, jstore = PropertyStore(), JaxStore()
    kw = dict(num_replicas=2, commit_lease_s=5, decision_wait_s=3)
    r = Replicas(started, tmp_path, "rt6", 40,
                 completion.SegmentCompletionManager(store, **kw),
                 jax_completion.SegmentCompletionManager(jstore, **kw),
                 start=False)
    # published before the consumers start: each first fetch takes all 60
    topics.publish("rt6", rows(60, seed=10))
    r.start()
    assert wait_until(lambda: all(
        len(m._segment_names) == 1 and m.total_docs() == 60
        for m in (*r.port.values(), *r.jax.values())))
    names = r.names(r.port)
    # under the protocol the name's timestamp is the start offset: every
    # replica of both packages mints the same name
    assert names == r.names(r.jax) == {"A": ["clicks__0__0__0"],
                                       "B": ["clicks__0__0__0"]}
    assert _done(store) == _done(jstore) == {"clicks__0__0__0": {
        "segmentName": "clicks__0__0__0", "endOffset": "60",
        "status": "DONE"}}
    rec = store.get("/SEGMENTS/clicks/clicks__0__0__0")
    loser = "B" if rec["committer"] == "A" else "A"
    # the loser downloaded the winner's build into its own directory
    assert (tmp_path / f"port_{loser}" / "clicks__0__0__0").is_dir()
    assert rec["location"] == str(tmp_path / f"port_{rec['committer']}"
                                  / "clicks__0__0__0")
    cols = r.committed_columns(r.port["A"])
    assert cols == r.committed_columns(r.port["B"]) \
        == r.committed_columns(r.jax["A"])
    qe, jqe = QueryExecutor(device="cpu"), JaxQueryExecutor(backend="tpu")
    qe.add_table(r.schema, r.port[loser].segments)
    jqe.add_table(schemas()[1], r.jax[loser].segments)
    assert qe.execute_sql(GROUP_SQL).result_table.rows \
        == jqe.execute_sql(NOCACHE + GROUP_SQL).result_table.rows


def test_committer_crash_is_replaced_after_its_lease(topics, tmp_path,
                                                    started):
    topics.create("rt7")
    store, jstore = PropertyStore(), JaxStore()
    kw = dict(num_replicas=2, commit_lease_s=1.0, decision_wait_s=3)
    killed = {"port": [], "jax": []}

    def die_once(mgr):
        # the first elected committer of each package dies between its
        # build and segment_commit_end
        key = "jax" if type(mgr).__module__.startswith("pinot_tpu.") \
            else "port"
        if mgr.seq == 0 and not killed[key]:
            killed[key].append(mgr.instance_id)
            return True
        return False

    r = Replicas(started, tmp_path, "rt7", 40,
                 completion.SegmentCompletionManager(store, **kw),
                 jax_completion.SegmentCompletionManager(jstore, **kw),
                 hooks={"die_before_commit_end": die_once}, start=False)
    topics.publish("rt7", rows(50, seed=11))
    r.start()
    assert wait_until(lambda: store.children("/SEGMENTS/clicks")
                      and jstore.children("/SEGMENTS/clicks"))
    assert _done(store) == _done(jstore) == {"clicks__0__0__0": {
        "segmentName": "clicks__0__0__0", "endOffset": "50",
        "status": "DONE"}}
    for st, pkg, key in ((store, r.port, "port"), (jstore, r.jax, "jax")):
        rec = st.get("/SEGMENTS/clicks/clicks__0__0__0")
        assert killed[key] and rec["committer"] != killed[key][0]
        survivor = pkg[rec["committer"]]
        assert wait_until(lambda: survivor._committed)
        assert survivor._committed[0].num_docs == 50
        # the dead replica's consumer never reached ERROR
        assert all(c.state != "ERROR"
                   for m in pkg.values() for c in m._consuming.values())
    port_survivor = r.port[store.get(
        "/SEGMENTS/clicks/clicks__0__0__0")["committer"]]
    jax_survivor = r.jax[jstore.get(
        "/SEGMENTS/clicks/clicks__0__0__0")["committer"]]
    assert r.committed_columns(port_survivor) \
        == r.committed_columns(jax_survivor)


def test_pauseless_commit_overlaps_the_successor(topics, tmp_path, started):
    """The elected committer holds between its build and commit_end until
    released; meanwhile the successor consumes the rows published after
    the election (ingestion never pauses). Events order it, not sleeps."""
    topics.create("rt8")
    built = {"port": threading.Event(), "jax": threading.Event()}
    release = threading.Event()

    def hold(mgr):
        key = "jax" if type(mgr).__module__.startswith("pinot_tpu.") \
            else "port"
        if mgr.seq == 0:
            built[key].set()
            assert release.wait(WAIT_S)
        return False

    store, jstore = PropertyStore(), JaxStore()
    p = Pair(started, tmp_path, schemas(), configs("rt8", 20),
             completion=completion.SegmentCompletionManager(
                 store, num_replicas=1, commit_lease_s=30),
             instance_id="A", pauseless=True,
             test_hooks={"die_before_commit_end": hold}, start=False)
    try:
        topics.publish("rt8", rows(25, seed=12))
        p.start()
        assert built["port"].wait(WAIT_S) and built["jax"].wait(WAIT_S)
        for m in (p.port, p.jax):
            with m._lock:
                assert m._committing and m._consuming  # both at once
        topics.publish("rt8", rows(10, start=25, seed=13))
        p.settle(35, 0)  # the successor consumed while the commit waits
        p.query(SUM_SQL)
    finally:
        release.set()
    p.settle(35, 1)
    assert wait_until(lambda: not p.port._committing
                      and not p.jax._committing)
    assert p.query(SUM_SQL)[0][0] == 35
    assert p.same_commits() == {"partitions": {"0": "25"},
                                "segments": ["clicks__0__0"]}


def _kill(live, store, cid):
    """Crash-death of a controller: gone from the resolver, its session
    expired."""
    ctrl = live.pop(cid)
    ctrl.leader.disconnect()
    store.expire_session(cid)
    ctrl.leader.stop()


def test_consumers_hold_through_a_leaderless_window(topics, tmp_path,
                                                   started):
    topics.create("rt9")
    cfg = {"num_replicas": 2, "commit_lease_s": 2.0, "decision_wait_s": 1.0}
    store, jstore = PropertyStore(), JaxStore()
    live = {"c1": ClusterController(store, instance_id="c1",
                                    completion_config=cfg)}
    jlive = {"c1": JaxController(jstore, instance_id="c1",
                                 completion_config=cfg)}
    r = Replicas(started, tmp_path, "rt9", 40,
                 completion.LeaderCompletionClient(store, live.get),
                 jax_completion.LeaderCompletionClient(jstore, jlive.get),
                 start=False)
    _kill(live, store, "c1")  # no leader before the flush is reached
    _kill(jlive, jstore, "c1")
    meter = ServerMeter.COMPLETION_HOLDS_NO_LEADER
    before = SERVER_METRICS.meter_count(meter)
    jbefore = JAX_SERVER_METRICS.meter_count(meter)
    r.start()
    topics.publish("rt9", rows(40, seed=14))
    try:
        assert wait_until(
            lambda: SERVER_METRICS.meter_count(meter) > before
            and JAX_SERVER_METRICS.meter_count(meter) > jbefore)
        assert not store.children("/SEGMENTS/clicks")
        for m in (*r.port.values(), *r.jax.values()):
            assert all(c.state != "ERROR" for c in m._consuming.values())
        # a controller comes back: the held commits drain
        live["c2"] = ClusterController(store, instance_id="c2",
                                       completion_config=cfg)
        jlive["c2"] = JaxController(jstore, instance_id="c2",
                                    completion_config=cfg)
        assert wait_until(lambda: all(
            len(m._committed) == 1
            for m in (*r.port.values(), *r.jax.values())))
        assert _done(store) == _done(jstore) == {"clicks__0__0__0": {
            "segmentName": "clicks__0__0__0", "endOffset": "40",
            "status": "DONE"}}
        assert r.committed_columns(r.port["A"]) \
            == r.committed_columns(r.port["B"]) \
            == r.committed_columns(r.jax["A"])
    finally:
        for c in (*live.values(), *jlive.values()):
            c.stop()


def test_rows_published_after_a_commit_are_counted(topics, tmp_path,
                                                   started):
    """F8: the executor keeps the manager's live list, so the segment
    opened by a commit after `add_table` is queried. An executor registered
    while segment 0 consumes, given a copy of the list, would still answer
    over that sealed segment alone (40 rows) and miss the 10 published
    after the commit."""
    topics.create("rt10")
    p = Pair(started, tmp_path, schemas(), configs("rt10", 40))
    assert wait_until(lambda: len(p.port.segments) == 1)
    qe = QueryExecutor(device="cpu")
    qe.add_table(p.schema, p.port.segments)
    data = rows(40, seed=15)
    topics.publish("rt10", data)
    p.settle(40, 1)
    more = rows(10, start=40, seed=16)
    topics.publish("rt10", more)
    p.settle(50, 1)
    want = [[50, sum(r["clicks"] for r in data + more)]]
    assert p.query(SUM_SQL) == want
    assert qe.execute_sql(SUM_SQL).result_table.rows == want
    assert qe.tables["clicks"].segments is p.port.segments


def test_commit_retires_the_consuming_segment_device_state(topics, tmp_path,
                                                           started):
    """On commit the sealed segment's planes leave REALTIME_PLANES and
    every live executor's cache (a second executor over the same table
    too); nothing raised while retiring."""
    from pinot_tpu_torch.realtime.device_plane import REALTIME_PLANES

    topics.create("rt11")
    schema, _ = schemas()
    cfg, _ = configs("rt11", 1000)
    mgr = RealtimeTableDataManager(schema, cfg, tmp_path / "m")
    started.append(mgr)
    qes = [QueryExecutor(device="cpu") for _ in range(2)]
    for qe in qes:
        qe.add_table(schema, mgr.segments)
    mgr.start()
    topics.publish("rt11", rows(30, seed=17))
    assert wait_until(lambda: mgr.total_docs() == 30)
    for qe in qes:
        assert qe.execute_sql(SUM_SQL).result_table.rows[0][0] == 30
    name = mgr.segments[0].name
    assert name in REALTIME_PLANES.names()
    assert mgr.force_commit() == [name]
    assert wait_until(lambda: mgr.retirement_stats()["segments"] == 1)
    stats = mgr.retirement_stats()
    assert stats["errors"] == 0 and stats["bytesFreed"] > 0
    assert name not in REALTIME_PLANES.names()
    for qe in qes:
        assert name not in qe.executor.cache.segment_names()
        assert qe.execute_sql(SUM_SQL).result_table.rows[0][0] == 30
