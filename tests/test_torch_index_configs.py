"""Index configs on the segments the port builds (fault F12), against the
JAX package.

The port's `IndexingConfig` carries every field of the JAX package's and
its JSON round-trips to the same `tableIndexConfig`. Its builder writes
the bloom filters (`bloomFilterColumns`) and partition stamps
(`segmentPartitionConfig`: modulo, murmur, hashcode) the pruner reads, the
JAX builder's bytes; so a realtime table's commit prunes as the JAX
package's does. A server loading a segment written without a bloom filter
its table's config now asks for builds one at load
(segment/loader.py `backfill_indexes`, cluster/server.py), and its broker
prunes as the JAX cluster's.

Both packages run with the caches off, `PINOT_TPU_FUSED=interpret` and one
mesh device; the realtime cases drive each package's
`RealtimeTableDataManager` over the same rows (tests/
test_torch_realtime_manager.py's pair), the port's config loaded from the
JAX config's JSON. Compared: rows, `numSegmentsPrunedByServer`,
`numSegmentsProcessed`, dispatches, the stamps. Tolerance: exact.
"""

from __future__ import annotations

import numpy as np
import pytest

import pinot_tpu.cluster as jcl
from pinot_tpu.engine import perf_ledger as _jax_perf_ledger
from pinot_tpu.segment.builder import SegmentBuilder as JaxBuilder
from pinot_tpu.segment.loader import load_segment as jax_load
from pinot_tpu.spi import stream as jax_stream
from pinot_tpu.spi import table_config as jax_tc
from pinot_tpu.spi.data_types import Schema as JaxSchema
from pinot_tpu_torch import cluster as pcl
from pinot_tpu_torch.engine import perf_ledger as _port_perf_ledger
from pinot_tpu_torch.segment.builder import SegmentBuilder
from pinot_tpu_torch.segment.loader import load_segment
from pinot_tpu_torch.spi import stream
from pinot_tpu_torch.spi import table_config as tc
from pinot_tpu_torch.spi.data_types import Schema
from pinot_tpu_torch.spi.partition import get_partition_function
from test_torch_realtime_manager import (NOCACHE, Pair, Topics, rows,
                                         schemas, strip)

EVERY_FIELD = dict(
    inverted_index_columns=["user"], range_index_columns=["ts"],
    bloom_filter_columns=["site", "clicks"], no_dictionary_columns=["clicks"],
    sorted_column="user",
    star_tree_index_configs=[{"dimensionsSplitOrder": ["user"],
                              "functionColumnPairs": ["COUNT__*"]}],
    json_index_columns=["j"], text_index_columns=["t"],
    vector_index_columns=["v"],
    geo_index_configs=[{"latColumn": "la", "lngColumn": "lo",
                        "resolutionDeg": 0.5}],
    compression_configs={"clicks": "LZ4", "site": "GZIP"},
    segment_partition_config={
        "user": {"functionName": "murmur", "numPartitions": 4}})
COUNT_SQL = "SELECT COUNT(*), SUM(clicks) FROM clicks WHERE site = '{}'"


@pytest.fixture(scope="module", autouse=True)
def _no_ledger_left_behind():
    """Both packages' brokers record every query, failures included, in
    their process-wide perf ledgers: leave the ledgers and alert books
    empty, so a later module's sentinel does not judge this module's
    queries (an SLO burn it fires arms exemplars that outlive it)."""
    yield
    for mod in (_jax_perf_ledger, _port_perf_ledger):
        mod.PERF_LEDGER.clear()
        mod.ALERTS.clear()


@pytest.fixture(autouse=True)
def _jax_dispatches_every_query(monkeypatch):
    monkeypatch.setenv("PINOT_TPU_SEGMENT_CACHE", "0")
    monkeypatch.setenv("PINOT_TPU_RESULT_CACHE", "0")
    monkeypatch.setenv("PINOT_TPU_MESH_DEVICES", "1")
    monkeypatch.setenv("PINOT_TPU_FUSED", "interpret")


def _jax_config(**indexing):
    return jax_tc.TableConfig(table_name="clicks",
                              indexing=jax_tc.IndexingConfig(**indexing))


@pytest.mark.parametrize("direction", ["from_jax", "to_jax"])
def test_indexing_json_round_trips_as_jax(direction):
    jcfg = _jax_config(**EVERY_FIELD)
    if direction == "from_jax":
        cfg = tc.TableConfig.from_json(jcfg.to_json())
        assert cfg.to_json()["tableIndexConfig"] == \
            jcfg.to_json()["tableIndexConfig"]
    else:
        cfg = tc.TableConfig(table_name="clicks",
                             indexing=tc.IndexingConfig(**EVERY_FIELD))
        back = jax_tc.TableConfig.from_json(cfg.to_json())
        assert back.indexing == jcfg.indexing
    for name, value in EVERY_FIELD.items():
        assert getattr(cfg.indexing, name) == value


def test_nothing_is_dropped_from_a_partial_json():
    d = {"tableName": "clicks", "tableIndexConfig": {
        "bloomFilterColumns": ["site"],
        "segmentPartitionConfig": {"columnPartitionMap": {
            "clicks": {"functionName": "modulo", "numPartitions": 3}}}}}
    cfg, jcfg = tc.TableConfig.from_json(d), jax_tc.TableConfig.from_json(d)
    assert cfg.indexing == tc.IndexingConfig(
        bloom_filter_columns=["site"], segment_partition_config={
            "clicks": {"functionName": "modulo", "numPartitions": 3}})
    assert cfg.to_json()["tableIndexConfig"] == \
        jcfg.to_json()["tableIndexConfig"]


# -- the builder's bloom filters and partition stamps -------------------------

DIMS = [("user", "STRING"), ("site", "STRING"), ("ts", "LONG")]
METRICS = [("clicks", "INT"), ("price", "DOUBLE")]
PARTITIONS = [("user", "murmur", 4), ("clicks", "modulo", 5),
              ("site", "hashcode", 3), ("ts", "murmur", 8)]


def _cols(rng, n, sites):
    users = [f"u{i}" for i in rng.integers(0, 12, n)]
    users[4] = None
    return {"user": np.asarray(users, dtype=object),
            "site": np.asarray(sites, dtype=object)[
                rng.integers(0, len(sites), n)],
            "ts": (1_600_000_000_000 + np.arange(n) * 1000).astype(np.int64),
            "clicks": rng.integers(0, 50, n).astype(np.int32),
            "price": np.round(rng.uniform(0, 10, n), 2)}


@pytest.mark.parametrize("column,fn,n", PARTITIONS)
def test_builder_stamps_and_blooms_as_jax(tmp_path, column, fn, n):
    rng = np.random.default_rng(n)
    cols = _cols(rng, 700, ["a.com", "b.com", "c.com"])
    ix = dict(bloom_filter_columns=["site", "clicks", "price", "user"],
              no_dictionary_columns=["price"],
              segment_partition_config={
                  column: {"functionName": fn, "numPartitions": n}})
    SegmentBuilder(Schema.build("t", dimensions=DIMS, metrics=METRICS),
                   tc.TableConfig("t", indexing=tc.IndexingConfig(**ix)),
                   "s").build(cols, tmp_path / "port")
    JaxBuilder(JaxSchema.build("t", dimensions=DIMS, metrics=METRICS),
               jax_tc.TableConfig("t", indexing=jax_tc.IndexingConfig(**ix)),
               "s").build(cols, tmp_path / "jax")
    assert (tmp_path / "port" / "data.bin").read_bytes() == \
        (tmp_path / "jax" / "data.bin").read_bytes()
    seg, jseg = load_segment(tmp_path / "port"), jax_load(tmp_path / "jax")
    m, jm = seg.column_metadata(column), jseg.column_metadata(column)
    assert (m.partition_function, m.num_partitions, m.partitions,
            m.partition_id) == (jm.partition_function, jm.num_partitions,
                                jm.partitions, jm.partition_id)
    assert m.partitions
    for col in ix["bloom_filter_columns"]:
        bf, jbf = seg.get_bloom_filter(col), jseg.get_bloom_filter(col)
        assert (bf.num_bits, bf.num_hashes) == (jbf.num_bits, jbf.num_hashes)
        np.testing.assert_array_equal(bf.bits, jbf.bits)
    assert seg.get_bloom_filter("site").might_contain("b.com")


# -- realtime commits through the managers -----------------------------------


@pytest.fixture()
def topics(monkeypatch):
    t = Topics(stream.InMemoryStreamRegistry(),
               jax_stream.InMemoryStreamRegistry())
    monkeypatch.setattr(stream, "GLOBAL_STREAM_REGISTRY", t.port)
    monkeypatch.setattr(jax_stream, "GLOBAL_STREAM_REGISTRY", t.jax)
    return t


@pytest.fixture()
def started():
    out: list = []
    yield out
    for m in reversed(out):
        m.stop()


def _configs(topic, flush_rows, **indexing):
    """The JAX config, and the port's read from its JSON."""
    jcfg = jax_tc.TableConfig(
        table_name="clicks", table_type=jax_tc.TableType.REALTIME,
        indexing=jax_tc.IndexingConfig(**indexing),
        validation=jax_tc.SegmentsValidationConfig(time_column_name="ts"),
        ingestion=jax_tc.IngestionConfig(stream_configs={
            "streamType": "inmemory", "stream.inmemory.topic.name": topic,
            "realtime.segment.flush.threshold.rows": flush_rows}))
    return tc.TableConfig.from_json(jcfg.to_json()), jcfg


def _counts_match(p, sql):
    got = p.qe.execute_sql(sql)
    want = p.jqe.execute_sql(NOCACHE + sql)
    assert not want.exceptions, want.exceptions
    assert got.result_table.rows == want.result_table.rows, sql
    assert got.to_json()["numSegmentsPrunedByServer"] == \
        want.num_segments_pruned
    assert got.num_segments_processed == want.num_segments_processed
    assert got.num_device_dispatches == want.num_device_dispatches
    return got


def _no_site(data, site):
    return [dict(r, site="a.com") if r["site"] == site else r for r in data]


def test_committed_bloom_filter_prunes_as_jax(topics, tmp_path, started):
    topics.create("ix1")
    topics.publish("ix1", _no_site(rows(200, seed=21), "b.com"))
    p = Pair(started, tmp_path, schemas(),
             _configs("ix1", 200, bloom_filter_columns=["site"]))
    p.settle(200, 1)
    topics.publish("ix1", rows(30, start=200, seed=22))
    p.settle(230, 1)
    got = _counts_match(p, COUNT_SQL.format("b.com"))
    assert got.num_segments_pruned == 1
    assert got.num_segments_processed == 1
    assert got.result_table.rows[0][0] > 0
    # 'a.com' and 'c.com' are in both; min/max alone cannot prune 'b.com'
    assert _counts_match(p, COUNT_SQL.format("c.com")) \
        .num_segments_pruned == 0
    seg, jseg = p.port._committed[0], p.jax._committed[0]
    np.testing.assert_array_equal(seg.get_bloom_filter("site").bits,
                                  jseg.get_bloom_filter("site").bits)


@pytest.mark.parametrize("column,fn,n,probe", [
    ("clicks", "modulo", 4, "clicks = 7"),
    ("user", "murmur", 8, "user = 'u3'"),
])
def test_committed_partition_stamps_prune_as_jax(topics, tmp_path, started,
                                                 column, fn, n, probe):
    """Two commits, each of rows of one partition of `column`; a filter on
    one value prunes the other's segment."""
    topics.create("ix2")
    data = rows(400, seed=23)
    p = Pair(started, tmp_path, schemas(), _configs(
        "ix2", 40, segment_partition_config={
            column: {"functionName": fn, "numPartitions": n}}))
    part = get_partition_function(fn, n)
    want_part = part.partition(7 if column == "clicks" else "u3")
    first = [r for r in data if part.partition(r[column]) == want_part][:40]
    other = [r for r in data if part.partition(r[column]) != want_part][:40]
    assert len(first) == len(other) == 40
    topics.publish("ix2", first)
    p.settle(40, 1)
    topics.publish("ix2", other)
    p.settle(80, 2)
    for seg, jseg in zip(p.port._committed, p.jax._committed):
        assert strip(seg.name) == strip(jseg.name)
        m, jm = seg.column_metadata(column), jseg.column_metadata(column)
        assert (m.partition_function, m.num_partitions, m.partitions) == \
            (jm.partition_function, jm.num_partitions, jm.partitions)
    got = _counts_match(p, f"SELECT COUNT(*) FROM clicks WHERE {probe}")
    assert got.num_segments_pruned >= 1


# -- a server backfills a bloom filter at load --------------------------------

CL_SCHEMA = Schema.build("bf", dimensions=[("site", "STRING")],
                         metrics=[("clicks", "INT")])


@pytest.fixture(scope="module")
def old_segments(tmp_path_factory):
    """Two segments written with no bloom filter: 'b.com' only in the
    second, between the first's min and max."""
    root = tmp_path_factory.mktemp("bloom_backfill")
    rng = np.random.default_rng(31)
    out = []
    for k, sites in enumerate((["a.com", "c.com"], ["b.com", "c.com"])):
        name = f"bf_{k}"
        SegmentBuilder(CL_SCHEMA, None, name).build(
            {"site": np.asarray(sites, dtype=object)[rng.integers(0, 2, 500)],
             "clicks": rng.integers(0, 9, 500).astype(np.int32)}, root / name)
        out.append((name, str(root / name)))
    return out


@pytest.mark.parametrize("bloom", [True, False])
def test_server_backfills_bloom_filters_as_jax(old_segments, bloom):
    results = []
    for pkg in (pcl, jcl):
        store = pkg.PropertyStore()
        ctl = pkg.ClusterController(store)
        srv = pkg.ServerInstance(store, "Server_0", device="cpu") \
            if pkg is pcl else pkg.ServerInstance(store, "Server_0",
                                                  backend="tpu")
        srv.start()
        try:
            ctl.add_schema(CL_SCHEMA.to_json())
            cfg = {"tableName": "bf", "replication": 1}
            if bloom:
                cfg["tableIndexConfig"] = {"bloomFilterColumns": ["site"]}
            t = ctl.create_table(cfg)
            for name, path in old_segments:
                ctl.add_segment(t, name, {"numDocs": 500, "location": path})
            broker = pkg.Broker(store)
            try:
                resp = broker.execute_sql(
                    "SELECT COUNT(*), SUM(clicks) FROM bf "
                    "WHERE site = 'b.com'")
            finally:
                if pkg is pcl:
                    broker.close()
            hosted = srv.segments["bf_OFFLINE"]["bf_0"]
            results.append((resp, hosted.get_bloom_filter("site")))
        finally:
            srv.stop()
    (got, bf), (want, jbf) = results
    assert not want.exceptions, want.exceptions
    assert got.result_table.rows == want.result_table.rows
    assert got.num_segments_pruned == want.num_segments_pruned \
        == (1 if bloom else 0)
    assert got.num_segments_processed == want.num_segments_processed
    if bloom:
        np.testing.assert_array_equal(bf.bits, jbf.bits)
    else:
        assert bf is None and jbf is None
