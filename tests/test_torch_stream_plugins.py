"""The port's stream plugins (Kafka, Kinesis, Pulsar, the Confluent Avro
decoder) against the JAX package's.

The cases of `tests/test_kafka_stream.py` and `tests/test_kinesis_pulsar.py`,
each run through both packages' plugins on the same inputs. Kafka runs over
`chip_smoke.py`'s `MemKafka`, the one in-process stand-in for a Kafka
cluster with kafka-python's consumer surface (the smoke's `streamType:
kafka` cell reads through it too); Kinesis and Pulsar over the fakes of
`tests/test_kinesis_pulsar.py`, which implement each plugin's adapter
surface. Every fetched batch (values, offsets, the next offset), every
metadata answer, a realtime table's committed segments, rows and
checkpoints, and the `ImportError` of a missing client library must equal
the JAX package's. A Confluent wire-format message decodes through
`get_decoder` to the same row. Tolerance: exact.
"""

from __future__ import annotations

import importlib.util
import json
import time
from pathlib import Path
from types import SimpleNamespace

import pytest

import pinot_tpu.plugins.stream.confluent as jconfluent
import pinot_tpu.plugins.stream.kafka as jkafka
import pinot_tpu.plugins.stream.kinesis as jkinesis
import pinot_tpu.plugins.stream.pulsar as jpulsar
import pinot_tpu.realtime.manager as jmanager
import pinot_tpu.spi.data_types as jtypes
import pinot_tpu.spi.stream as jstream
import pinot_tpu.spi.table_config as jtc
import pinot_tpu_torch.plugins.stream.confluent as pconfluent
import pinot_tpu_torch.plugins.stream.kafka as pkafka
import pinot_tpu_torch.plugins.stream.kinesis as pkinesis
import pinot_tpu_torch.plugins.stream.pulsar as ppulsar
import pinot_tpu_torch.realtime.manager as pmanager
import pinot_tpu_torch.spi.data_types as ptypes
import pinot_tpu_torch.spi.stream as pstream
import pinot_tpu_torch.spi.table_config as ptc

ROOT = Path(__file__).resolve().parent.parent


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_kafka", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# the smoke's own in-process Kafka cluster
MemKafka = _smoke().MemKafka

PKGS = {
    "port": SimpleNamespace(kafka=pkafka, kinesis=pkinesis, pulsar=ppulsar,
                            confluent=pconfluent, stream=pstream,
                            manager=pmanager, types=ptypes, tc=ptc),
    "jax": SimpleNamespace(kafka=jkafka, kinesis=jkinesis, pulsar=jpulsar,
                           confluent=jconfluent, stream=jstream,
                           manager=jmanager, types=jtypes, tc=jtc),
}


def _both(fn):
    """fn(pkg) for each package; the port's result after holding it equal
    to the JAX package's."""
    out = {name: fn(pkg) for name, pkg in PKGS.items()}
    assert out["port"] == out["jax"]
    return out["port"]


def _batch(batch):
    return ([(m.value, m.key, m.offset.offset) for m in batch.messages],
            batch.offset_of_next_batch.offset)


# -- Kafka ----------------------------------------------------------------------


@pytest.fixture()
def kafka(monkeypatch):
    """{package name: its MemKafka}, each package's factory reading its
    own."""
    out = {}
    for name, pkg in PKGS.items():
        k = MemKafka()
        monkeypatch.setattr(
            pkg.kafka.KafkaStreamConsumerFactory, "client_factory",
            staticmethod(lambda config, _k=k, _tp=pkg.kafka.TopicPartition:
                         (_k.consumer(), _tp)))
        out[name] = k
    return out


def _kafka_config(pkg, topic="clicks", flush_rows=25):
    return pkg.stream.StreamConfig.from_table_config({
        "streamType": "kafka",
        "stream.kafka.topic.name": topic,
        "stream.kafka.broker.list": "fake:9092",
        "realtime.segment.flush.threshold.rows": flush_rows,
    })


def test_factory_resolution_and_fetch(kafka):
    def run(pkg):
        k = kafka["port" if pkg is PKGS["port"] else "jax"]
        k.create_topic("clicks", 2)
        for i in range(10):
            k.produce("clicks", 0, json.dumps({"i": i}).encode())
        factory = pkg.stream.get_stream_consumer_factory(_kafka_config(pkg))
        assert isinstance(factory, pkg.kafka.KafkaStreamConsumerFactory)
        meta = factory.create_metadata_provider()
        out = {"partitions": meta.partition_count(),
               "offsets": [meta.fetch_earliest_offset(0).offset,
                           meta.fetch_latest_offset(0).offset,
                           meta.fetch_latest_offset(1).offset]}
        c = factory.create_partition_consumer(0)
        out["all"] = _batch(c.fetch_messages(pkg.stream.LongMsgOffset(0),
                                             100))
        # replay from a checkpoint: seek semantics
        out["replay"] = _batch(c.fetch_messages(
            pkg.stream.LongMsgOffset(7), 100))
        # sequential fetch continues without a re-seek
        k.produce("clicks", 0, json.dumps({"i": 10}).encode())
        out["next"] = _batch(c.fetch_messages(
            pkg.stream.LongMsgOffset(10), 100))
        c.close()
        return out

    got = _both(run)
    assert got["partitions"] == 2 and got["offsets"] == [0, 10, 0]
    assert len(got["all"][0]) == 10 and got["all"][1] == 10
    assert [json.loads(v)["i"] for v, _, _ in got["replay"][0]] == [7, 8, 9]
    assert [json.loads(v)["i"] for v, _, _ in got["next"][0]] == [10]


def test_missing_client_library_is_a_clear_error():
    def run(pkg):
        factory = pkg.kafka.KafkaStreamConsumerFactory(_kafka_config(pkg))
        with pytest.raises(ImportError, match="kafka") as e:
            factory.create_partition_consumer(0)
        return str(e.value)

    _both(run)


def _clicks_table(pkg, flush_rows=25):
    schema = pkg.types.Schema.build(
        "clicks", dimensions=[("user", "STRING"), ("ts", "LONG")],
        metrics=[("n", "INT")])
    cfg = pkg.tc.TableConfig(
        table_name="clicks", table_type=pkg.tc.TableType.REALTIME,
        validation=pkg.tc.SegmentsValidationConfig(time_column_name="ts"),
        ingestion=pkg.tc.IngestionConfig(stream_configs={
            "streamType": "kafka",
            "stream.kafka.topic.name": "clicks",
            "stream.kafka.broker.list": "fake:9092",
            "realtime.segment.flush.threshold.rows": flush_rows,
        }))
    return schema, cfg


def _produce_rows(k, n, start=0):
    for i in range(start, start + n):
        k.produce("clicks", 0, json.dumps(
            {"user": f"u{i % 4}", "ts": 1_600_000_000_000 + i,
             "n": 1}).encode())


def _wait_until(pred, timeout=15.0):
    t0 = time.time()
    while time.time() - t0 < timeout:
        if pred():
            return True
        time.sleep(0.02)
    return False


def test_kafka_table_consumes_commits_and_resumes(kafka, tmp_path):
    def run(pkg):
        name = "port" if pkg is PKGS["port"] else "jax"
        k, data_dir = kafka[name], tmp_path / name
        k.create_topic("clicks", 1)
        _produce_rows(k, 30)
        schema, cfg = _clicks_table(pkg)
        mgr = pkg.manager.RealtimeTableDataManager(schema, cfg, data_dir)
        mgr.start()
        try:
            assert _wait_until(lambda: len(mgr._segment_names) >= 1)
            assert _wait_until(
                lambda: sum(s.num_docs for s in mgr.segments) == 30)
            # read under the table's lock: a commit appends its name and
            # then swaps in the new view, both under that lock
            with mgr._lock:
                first = [n.rsplit("__", 1)[0] for n in mgr._segment_names]
                docs = [s.num_docs for s in mgr.segments]
        finally:
            mgr.stop()
        cp = json.loads((data_dir / "_checkpoints.json").read_text())
        # a restart resumes from the committed checkpoint: no duplicates,
        # and the rows produced while it was down are picked up
        _produce_rows(k, 40, start=30)
        mgr2 = pkg.manager.RealtimeTableDataManager(schema, cfg, data_dir)
        mgr2.start()
        try:
            # the 40 rows pass the 25-row threshold in one fetch: wait for
            # their commit, so both packages are read in the same state
            assert _wait_until(lambda: len(mgr2._segment_names) >= 2)
            assert _wait_until(
                lambda: sum(s.num_docs for s in mgr2.segments) == 70)
            assert _wait_until(lambda: mgr2._offsets.get("0") is not None)
            with mgr2._lock:
                names = [n.rsplit("__", 1)[0] for n in mgr2._segment_names]
                docs2 = sorted(s.num_docs for s in mgr2.segments)
        finally:
            mgr2.stop()
        return {"first": first, "docs": docs, "checkpoint": cp["partitions"],
                "names": names, "docs2": docs2}

    got = _both(run)
    assert got["first"][0] == "clicks__0__0"
    assert got["docs"] == [30, 0] and got["checkpoint"] == {"0": "30"}
    assert sum(got["docs2"]) == 70
    assert len(got["names"]) == 2 and got["docs2"] == [0, 30, 40]


# -- Kinesis ----------------------------------------------------------------------


class FakeKinesis:
    """Two shards with pre-seeded records; sequence numbers are sparse
    (Kinesis-like: large, gappy). Honors the sentinel checkpoint model: 0
    = TRIM_HORIZON, 1 = LATEST, c >= 2 = records with seq > c - 1."""

    def __init__(self, mod):
        self.mod = mod
        self.shards = {
            "shardId-000": [(1000, None, b'{"a": 1}', 1),
                            (1007, None, b'{"a": 2}', 2)],
            "shardId-001": [(2005, b"k", b'{"a": 3}', 3)],
        }

    def list_shards(self, stream):
        return sorted(self.shards)

    def get_records(self, stream, shard_id, checkpoint, limit):
        recs = self.shards[shard_id]
        if checkpoint <= self.mod.TRIM_HORIZON:
            return recs[:limit]
        if checkpoint == self.mod.LATEST:
            return []  # nothing arrives during the probe
        return [r for r in recs if r[0] > checkpoint - 1][:limit]

    def latest_checkpoint(self, stream, shard_id):
        return self.mod.LATEST  # idle shard during the probe

    def close(self):
        pass


@pytest.fixture()
def kinesis(monkeypatch):
    for pkg in PKGS.values():
        fake = FakeKinesis(pkg.kinesis)
        monkeypatch.setattr(pkg.kinesis.KinesisStreamConsumerFactory,
                            "client_factory",
                            staticmethod(lambda config, _f=fake: _f))


def _kinesis_consumer(pkg, **props):
    cfg = pkg.stream.StreamConfig(stream_type="kinesis", topic_name="events",
                                  props=props)
    return pkg.stream.get_stream_consumer_factory(cfg)


def test_kinesis_resolves_and_fetches(kinesis):
    def run(pkg):
        factory = _kinesis_consumer(
            pkg, **{"stream.kinesis.consumer.prop.region": "us-east-1"})
        meta = factory.create_metadata_provider()
        off = pkg.stream.LongMsgOffset
        out = {"partitions": meta.partition_count(),
               "earliest": meta.fetch_earliest_offset(0).offset,
               "latest": meta.fetch_latest_offset(0).offset}
        consumer = factory.create_partition_consumer(0)
        batch = consumer.fetch_messages(off(pkg.kinesis.TRIM_HORIZON), 100)
        out["first"] = _batch(batch)
        out["resume"] = _batch(consumer.fetch_messages(
            batch.offset_of_next_batch, 100))
        return out

    got = _both(run)
    assert got["partitions"] == 2 and got["latest"] == pkinesis.LATEST
    assert [v for v, _, _ in got["first"][0]] == [b'{"a": 1}', b'{"a": 2}']
    assert got["first"][1] == 1008 and got["resume"] == ([], 1008)


def test_kinesis_mid_stream_resume(kinesis):
    def run(pkg):
        consumer = _kinesis_consumer(pkg).create_partition_consumer(0)
        return _batch(consumer.fetch_messages(pkg.stream.LongMsgOffset(1001),
                                              100))

    got = _both(run)
    assert [o for _, _, o in got[0]] == [1007]


def test_kinesis_latest_sentinel_skips_history(kinesis):
    def run(pkg):
        consumer = _kinesis_consumer(pkg).create_partition_consumer(0)
        return _batch(consumer.fetch_messages(
            pkg.stream.LongMsgOffset(pkg.kinesis.LATEST), 100))

    assert _both(run) == ([], pkinesis.LATEST)


def test_kinesis_boto3_adapter_recovers_expired_iterator():
    """An expired cached shard iterator re-mints from the checkpoint."""
    class FakeBoto:
        def __init__(self):
            self.minted = 0

        def get_shard_iterator(self, **kw):
            self.minted += 1
            assert kw["ShardIteratorType"] == "AFTER_SEQUENCE_NUMBER"
            assert kw["StartingSequenceNumber"] == "41"
            return {"ShardIterator": f"it{self.minted}"}

        def get_records(self, ShardIterator, Limit):
            if ShardIterator == "stale":
                raise RuntimeError("ExpiredIteratorException")
            return {"Records": [{"SequenceNumber": "42", "Data": b"v",
                                 "PartitionKey": "k"}],
                    "NextShardIterator": "it-next"}

    def run(pkg):
        adapter = pkg.kinesis._Boto3Adapter(FakeBoto(), 1000)
        adapter._iters[("s", "sh")] = (42, "stale")
        recs = adapter.get_records("s", "sh", 42, 10)
        return [r[0] for r in recs], adapter._iters[("s", "sh")]

    assert _both(run) == ([42], (43, "it-next"))


# -- Pulsar ---------------------------------------------------------------------


class FakePulsar:
    """Partitioned topic 'events' (2 partitions) and non-partitioned topic
    'solo' (read with partition=-1); readers are persistent handles with a
    cursor, like real Pulsar readers."""

    def __init__(self, mod):
        self.mod = mod
        ids = [mod.pack_message_id(5, 0), mod.pack_message_id(5, 1),
               mod.pack_message_id(6, 0)]
        self.topics = {
            ("events", 0): [(ids[0], None, b"x", 10), (ids[1], None, b"y", 11),
                            (ids[2], b"k", b"z", 12)],
            ("events", 1): [],
            ("solo", -1): [(ids[0], None, b"s", 1)],
        }
        self.open_handles = 0

    def publish(self, topic, partition, packed, value):
        self.topics[(topic, partition)].append((packed, None, value, 99))

    def partition_count(self, topic):
        return len([p for (t, p) in self.topics if t == topic and p >= 0])

    def open_reader(self, topic, partition, from_packed):
        recs = self.topics[(topic, partition)]
        if from_packed == self.mod.LATEST:
            cursor = recs[-1][0] + 1 if recs else 0
        else:
            cursor = from_packed
        self.open_handles += 1
        return {"key": (topic, partition), "cursor": cursor}

    def read_batch(self, handle, max_records, timeout_ms):
        recs = [r for r in self.topics[handle["key"]]
                if r[0] >= handle["cursor"]][:max_records]
        if recs:
            handle["cursor"] = recs[-1][0] + 1
        return recs

    def close_reader(self, handle):
        self.open_handles -= 1

    def latest(self, topic, partition):
        recs = self.topics[(topic, partition)]
        return recs[-1][0] + 1 if recs else self.mod.LATEST

    def close(self):
        pass


@pytest.fixture()
def pulsar(monkeypatch):
    fakes = {}
    for name, pkg in PKGS.items():
        fakes[name] = FakePulsar(pkg.pulsar)
        monkeypatch.setattr(pkg.pulsar.PulsarStreamConsumerFactory,
                            "client_factory",
                            staticmethod(lambda config, _f=fakes[name]: _f))
    return fakes


def _pulsar_factory(pkg, topic="events"):
    return pkg.stream.get_stream_consumer_factory(
        pkg.stream.StreamConfig(stream_type="pulsar", topic_name=topic))


def test_pulsar_message_id_packing_is_monotone_and_checked():
    def run(pkg):
        p = pkg.pulsar
        a, b, c = (p.pack_message_id(5, 100, 3), p.pack_message_id(5, 101, 0),
                   p.pack_message_id(6, 0, 0))
        assert p.LATEST < a < b < c
        assert p.pack_message_id(0, 0, 0) > p.LATEST
        errors = []
        for args in ((1, 1 << 28), (1, 0, 256)):
            with pytest.raises(ValueError) as e:
                p.pack_message_id(*args)
            errors.append(str(e.value))
        return a, b, c, p.unpack_message_id(a), errors

    got = _both(run)
    assert got[3] == (5, 100, 3)


def test_pulsar_resolves_and_fetches(pulsar):
    def run(pkg):
        factory = _pulsar_factory(pkg)
        meta = factory.create_metadata_provider()
        off = pkg.stream.LongMsgOffset
        consumer = factory.create_partition_consumer(0)
        batch = consumer.fetch_messages(off(pkg.pulsar.EARLIEST), 100)
        return {"partitions": meta.partition_count(),
                "earliest": meta.fetch_earliest_offset(0).offset,
                "first": _batch(batch),
                "resume": _batch(consumer.fetch_messages(
                    batch.offset_of_next_batch, 100)),
                "idle": meta.fetch_latest_offset(1).offset}

    got = _both(run)
    assert got["partitions"] == 2 and got["idle"] == ppulsar.LATEST
    assert [v for v, _, _ in got["first"][0]] == [b"x", b"y", b"z"]
    assert got["resume"][0] == []


def test_pulsar_latest_start_sees_later_publishes(pulsar):
    def run(pkg):
        name = "port" if pkg is PKGS["port"] else "jax"
        consumer = _pulsar_factory(pkg).create_partition_consumer(0)
        off = pkg.stream.LongMsgOffset
        b0 = consumer.fetch_messages(off(pkg.pulsar.LATEST), 10)
        late_id = pkg.pulsar.pack_message_id(7, 0)
        pulsar[name].publish("events", 0, late_id, b"late")
        b1 = consumer.fetch_messages(b0.offset_of_next_batch, 10)
        return (_batch(b0), _batch(b1), late_id, pulsar[name].open_handles)

    b0, b1, late_id, handles = _both(run)
    assert b0[0] == [] and [v for v, _, _ in b1[0]] == [b"late"]
    assert b1[1] == late_id + 1 and handles == 1


def test_pulsar_non_partitioned_topic(pulsar):
    def run(pkg):
        factory = _pulsar_factory(pkg, "solo")
        consumer = factory.create_partition_consumer(0)
        return (factory.create_metadata_provider().partition_count(),
                _batch(consumer.fetch_messages(
                    pkg.stream.LongMsgOffset(pkg.pulsar.EARLIEST), 100)))

    count, batch = _both(run)
    assert count == 1 and [v for v, _, _ in batch[0]] == [b"s"]


def test_missing_client_libraries_error_clearly():
    def run(pkg):
        out = []
        for stype, err in (("kinesis", "boto3"), ("pulsar", "pulsar-client")):
            cfg = pkg.stream.StreamConfig(stream_type=stype, topic_name="t")
            factory = pkg.stream.get_stream_consumer_factory(cfg)
            with pytest.raises(ImportError, match=err) as e:
                factory.create_metadata_provider()
            out.append(str(e.value))
        return out

    _both(run)


# -- the Confluent Avro decoder ---------------------------------------------------

AVRO_SCHEMA = {"type": "record", "name": "Click", "fields": [
    {"name": "user", "type": "string"}, {"name": "n", "type": "int"},
    {"name": "ts", "type": "long"},
    {"name": "note", "type": ["null", "string"]}]}


@pytest.mark.parametrize("how", ["inline", "provider"])
def test_confluent_decoder_through_get_decoder(how):
    """A decoder name holding "confluent" auto-imports the plugin; the
    schema comes inline in the stream config or from a registered schema
    provider; a message without the magic byte decodes to None."""
    rows = [{"user": "u1", "n": 3, "ts": 1_600_000_000_123, "note": None},
            {"user": "ué", "n": -7, "ts": -5, "note": "hi"}]

    def run(pkg):
        props = {"schema.registry.schemas": {"7": json.dumps(AVRO_SCHEMA)}}
        if how == "provider":
            url = f"mem://registry-{pkg is PKGS['port']}"
            pkg.confluent.register_schema_provider(
                url, lambda sid: AVRO_SCHEMA if sid == 7 else None)
            props = {"schema.registry.rest.url": url}
        cfg = pkg.stream.StreamConfig(
            stream_type="kafka", topic_name="t",
            decoder="org.apache.pinot.plugin.inputformat.avro.confluent."
                    "KafkaConfluentSchemaRegistryAvroMessageDecoder",
            props=props)
        dec = pkg.stream.get_decoder(cfg)
        msgs = [pkg.confluent.encode_confluent(7, AVRO_SCHEMA, r)
                for r in rows]
        out = [dec.decode(pkg.stream.StreamMessage(
            value=m, key=None, offset=pkg.stream.LongMsgOffset(i)))
            for i, m in enumerate(msgs)]
        out.append(dec.decode(pkg.stream.StreamMessage(
            value=b"\x01junk", key=None, offset=pkg.stream.LongMsgOffset(9))))
        return type(dec).__name__, msgs, out

    name, _, decoded = _both(run)
    assert name == "ConfluentAvroDecoder"
    assert decoded == rows + [None]
