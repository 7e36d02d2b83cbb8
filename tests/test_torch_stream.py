"""The stream SPI of the port (pinot_tpu_torch/spi/stream.py) and the
pieces of the realtime path around it, against the JAX package.

On the same seeded inputs, both packages give equal:

  * offsets (`LongMsgOffset` order, str, parse), stream configs parsed from
    a table config's `streamConfigs` (every key and default), and decoded
    rows (`JsonDecoder` over dicts, str, bytes and garbage);
  * in-memory topics: the same rows published to each package's own
    registry route to the same partitions (`partition_key`, one process),
    fetch in batches of at most 1000 messages with the same offsets, keys
    and values, and report the same earliest and latest offsets;
  * the factory and decoder registries: an unknown streamType raises
    ValueError, an unknown decoder name falls back to JSON;
  * `TableConfig`'s `ingestionConfig` JSON round trip, `parse_expression_str`
    trees (and its refusal of trailing input), and `partition_push_metadata`
    of a segment the JAX builder stamped with partitions ({} for the port's
    builder, which stamps none).

Tolerance: exact.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest

from pinot_tpu.query.parser import sql as jax_sql
from pinot_tpu.segment.builder import SegmentBuilder as JaxBuilder
from pinot_tpu.segment.format import \
    partition_push_metadata as jax_push_metadata
from pinot_tpu.spi import stream as jax_stream
from pinot_tpu.spi.data_types import Schema as JaxSchema
from pinot_tpu.spi.table_config import IndexingConfig as JaxIndexing
from pinot_tpu.spi.table_config import TableConfig as JaxTableConfig
from pinot_tpu_torch.query.parser import sql
from pinot_tpu_torch.query.parser.sql import SqlParseError
from pinot_tpu_torch.segment.builder import SegmentBuilder
from pinot_tpu_torch.segment.format import partition_push_metadata
from pinot_tpu_torch.spi import stream
from pinot_tpu_torch.spi.data_types import Schema
from pinot_tpu_torch.spi.table_config import TableConfig

STREAM_CONFIGS = [
    {},
    {"streamType": "inmemory", "stream.inmemory.topic.name": "clicks",
     "realtime.segment.flush.threshold.rows": 5_000_000},
    {"streamType": "kafka", "stream.kafka.topic.name": "orders",
     "stream.kafka.decoder.class.name": "json",
     "stream.kafka.consumer.prop.auto.offset.reset": "largest",
     "realtime.segment.flush.threshold.rows": "512000",
     "realtime.segment.flush.threshold.time.ms": "3600000",
     "stream.fetch.timeout.ms": "250"},
    {"topic.name": "legacy", "decoder": "avro"},
]


@pytest.mark.parametrize("configs", STREAM_CONFIGS)
def test_stream_config_equals_jax(configs):
    got = dataclasses.asdict(stream.StreamConfig.from_table_config(configs))
    want = dataclasses.asdict(
        jax_stream.StreamConfig.from_table_config(configs))
    assert got == want


def test_offsets_equal_jax():
    vals = [5, 0, 17, 3, 1 << 40]
    got = sorted(stream.LongMsgOffset(v) for v in vals)
    want = sorted(jax_stream.LongMsgOffset(v) for v in vals)
    assert [o.offset for o in got] == [o.offset for o in want]
    assert [str(o) for o in got] == [str(o) for o in want]
    assert stream.LongMsgOffset.parse("42") == stream.LongMsgOffset(42)
    assert (stream.LongMsgOffset(3) < stream.LongMsgOffset(4)) \
        == (jax_stream.LongMsgOffset(3) < jax_stream.LongMsgOffset(4))


@pytest.mark.parametrize("value", [
    {"a": 1, "b": "x"}, '{"a": 2}', b'{"a": 3, "c": [1, 2]}', "not json",
    b"\x7b\x7d", "[1, 2]", None, 7])
def test_json_decoder_equals_jax(value):
    got = stream.JsonDecoder().decode(stream.StreamMessage(value=value))
    want = jax_stream.JsonDecoder().decode(
        jax_stream.StreamMessage(value=value))
    assert got == want


def _rows(n, seed):
    rng = np.random.default_rng(seed)
    return [{"user": f"u{int(rng.integers(50))}",
             "n": int(rng.integers(1, 100)), "i": i} for i in range(n)]


def _batches(pkg, reg, topic, partition):
    cfg = pkg.StreamConfig(stream_type="inmemory", topic_name=topic)
    consumer = pkg.InMemoryStreamConsumerFactory(
        cfg, reg).create_partition_consumer(partition)
    out, offset = [], pkg.LongMsgOffset(0)
    while True:
        batch = consumer.fetch_messages(offset, 100)
        out.append((batch.offset_of_next_batch.offset,
                    [(m.offset.offset, m.key, m.value)
                     for m in batch.messages]))
        if not batch.message_count:
            return out
        offset = batch.offset_of_next_batch


@pytest.mark.parametrize("partitions,key", [(1, None), (3, "user"),
                                            (2, None)])
def test_in_memory_topic_equals_jax(partitions, key):
    rows = _rows(2500, seed=partitions)
    port_reg, jax_reg = (stream.InMemoryStreamRegistry(),
                         jax_stream.InMemoryStreamRegistry())
    for reg in (port_reg, jax_reg):
        reg.create_topic("t", num_partitions=partitions)
        reg.publish("t", rows[:1200], partition_key=key)
        reg.publish("t", rows[1200:], partition_key=key)
    meta = stream.InMemoryStreamConsumerFactory(
        stream.StreamConfig(topic_name="t"), port_reg
    ).create_metadata_provider()
    jmeta = jax_stream.InMemoryStreamConsumerFactory(
        jax_stream.StreamConfig(topic_name="t"), jax_reg
    ).create_metadata_provider()
    assert meta.partition_count() == jmeta.partition_count() == partitions
    for p in range(partitions):
        assert meta.fetch_earliest_offset(p) == stream.LongMsgOffset(0)
        assert (meta.fetch_latest_offset(p).offset
                == jmeta.fetch_latest_offset(p).offset)
        got = _batches(stream, port_reg, "t", p)
        assert got == _batches(jax_stream, jax_reg, "t", p)
        # at most 1000 messages a fetch, offsets dense from 0
        assert all(len(msgs) <= 1000 for _, msgs in got)
        flat = [o for _, msgs in got for o, _, _ in msgs]
        assert flat == list(range(len(flat)))
    # every row lands once
    assert sum(meta.fetch_latest_offset(p).offset
               for p in range(partitions)) == len(rows)


def test_registries_resolve_like_jax(monkeypatch):
    reg = stream.InMemoryStreamRegistry()
    monkeypatch.setattr(stream, "GLOBAL_STREAM_REGISTRY", reg)
    reg.create_topic("g", num_partitions=2)
    cfg = stream.StreamConfig.from_table_config(
        {"streamType": "inmemory", "stream.inmemory.topic.name": "g"})
    factory = stream.get_stream_consumer_factory(cfg)
    assert factory.create_metadata_provider().partition_count() == 2
    with pytest.raises(ValueError, match="unknown streamType 'nope'"):
        stream.get_stream_consumer_factory(stream.StreamConfig(
            stream_type="nope"))
    with pytest.raises(ValueError, match="unknown streamType 'nope'"):
        jax_stream.get_stream_consumer_factory(jax_stream.StreamConfig(
            stream_type="nope"))
    for name in ("json", "no-such-decoder"):
        got = stream.get_decoder(stream.StreamConfig(decoder=name))
        want = jax_stream.get_decoder(jax_stream.StreamConfig(decoder=name))
        assert type(got).__name__ == type(want).__name__ == "JsonDecoder"

    class Upper(stream.StreamDataDecoder):
        def decode(self, message):
            return {"v": str(message.value).upper()}

    stream.register_decoder("upper", Upper)
    try:
        dec = stream.get_decoder(stream.StreamConfig(decoder="upper"))
        assert dec.decode(stream.StreamMessage(value="a")) == {"v": "A"}
    finally:
        stream._DECODERS.pop("upper")


@pytest.mark.parametrize("ingestion", [
    None,
    {"streamConfigs": {"streamType": "inmemory",
                       "stream.inmemory.topic.name": "clicks",
                       "realtime.segment.flush.threshold.rows": 40}},
    {"streamConfigs": {"streamType": "kafka"},
     "transformConfigs": [{"columnName": "day",
                           "transformFunction": "toEpochDays(ts)"}],
     "filterFunction": "name = 'drop_me'"},
])
def test_ingestion_config_json_equals_jax(ingestion):
    d = {"tableName": "clicks", "tableType": "REALTIME"}
    if ingestion is not None:
        d["ingestionConfig"] = ingestion
    got = TableConfig.from_json(d)
    want = JaxTableConfig.from_json(d)
    assert dataclasses.asdict(got.ingestion) == \
        dataclasses.asdict(want.ingestion)
    assert got.to_json()["ingestionConfig"] == \
        want.to_json()["ingestionConfig"]
    # and back again
    again = TableConfig.from_json(json.loads(json.dumps(got.to_json())))
    assert again.ingestion == got.ingestion


@pytest.mark.parametrize("expr", [
    "toEpochDays(ts)", "a + b * 2", "name = 'drop_me'",
    "CASE WHEN a > 1 THEN 'x' ELSE 'y' END", "concat(first, last, '-')",
    "jsonExtractScalar(payload, '$.id', 'INT')", "NOT (a > 3 AND b < 2)"])
def test_parse_expression_str_equals_jax(expr):
    assert repr(sql.parse_expression_str(expr)) == \
        repr(jax_sql.parse_expression_str(expr))


def test_parse_expression_str_refuses_trailing_input():
    with pytest.raises(SqlParseError, match="trailing input"):
        sql.parse_expression_str("a + 1 b")
    with pytest.raises(jax_sql.SqlParseError, match="trailing input"):
        jax_sql.parse_expression_str("a + 1 b")


def test_partition_push_metadata_equals_jax(tmp_path):
    dims = [("region", "STRING"), ("code", "INT")]
    metrics = [("n", "INT")]
    rng = np.random.default_rng(5)
    cols = {"region": np.asarray(["a", "b", "c"], dtype=object)[
                rng.integers(0, 3, 200)],
            "code": rng.integers(0, 64, 200).astype(np.int32) * 4 + 1,
            "n": rng.integers(0, 9, 200).astype(np.int32)}
    jcfg = JaxTableConfig(table_name="p", indexing=JaxIndexing(
        segment_partition_config={
            "code": {"functionName": "modulo", "numPartitions": 4},
            "region": {"functionName": "murmur", "numPartitions": 8}}))
    JaxBuilder(JaxSchema.build("p", dimensions=dims, metrics=metrics), jcfg,
               "p0").build(cols, tmp_path / "stamped")
    got = partition_push_metadata(tmp_path / "stamped")
    assert got == jax_push_metadata(tmp_path / "stamped")
    assert got["partitions"]["code"] == {
        "functionName": "modulo", "numPartitions": 4, "partitions": [1]}
    SegmentBuilder(Schema.build("p", dimensions=dims, metrics=metrics),
                   TableConfig(table_name="p"), "p1").build(
        cols, tmp_path / "port")
    assert partition_push_metadata(tmp_path / "port") == {} \
        == jax_push_metadata(tmp_path / "port")
    assert partition_push_metadata(tmp_path / "missing") == {}
