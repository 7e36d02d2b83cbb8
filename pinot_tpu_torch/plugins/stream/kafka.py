"""Kafka stream connector on the stream SPI.

The port's copy of pinot_tpu/plugins/stream/kafka.py.

Reference: KafkaPartitionLevelConsumer / KafkaStreamMetadataProvider
(pinot-plugins/pinot-stream-ingestion/pinot-kafka-2.0/src/main/java/org/
apache/pinot/plugin/stream/kafka20/KafkaPartitionLevelConsumer.java:45) —
partition-level pull consumption: assign one (topic, partition), seek to the
requested start offset, poll a batch, report the next offset; metadata
provider exposes partition count and earliest/latest offsets.

The Kafka client library (kafka-python) is an OPTIONAL dependency: the
default ``client_factory`` imports it lazily and raises a clear error when
absent. Tests (and alternative client libraries) inject a different factory
returning any object with the kafka-python consumer surface used here:
``assign/seek/poll/partitions_for_topic/beginning_offsets/end_offsets/
close``.

Config keys (reference-compatible):
    streamType: kafka
    stream.kafka.topic.name
    stream.kafka.broker.list                  (bootstrap servers)
    stream.kafka.consumer.prop.auto.offset.reset    smallest | largest
    stream.kafka.consumer.prop.*              (passed through to the client)
"""

from __future__ import annotations

from collections import namedtuple
from typing import Callable

from ...spi.stream import (
    LongMsgOffset,
    MessageBatch,
    PartitionGroupConsumer,
    StreamConfig,
    StreamConsumerFactory,
    StreamMessage,
    StreamMetadataProvider,
    register_stream_type,
)

# structural TopicPartition for client factories that don't bring their own
# (kafka-python's is also a namedtuple with these fields)
TopicPartition = namedtuple("TopicPartition", ["topic", "partition"])

_CONSUMER_PROP_PREFIX = "stream.kafka.consumer.prop."
# client props handled by the SPI itself, never forwarded
_EXCLUDED_PROPS = {"auto.offset.reset"}


def _default_client_factory(config: StreamConfig):
    """(consumer, topic_partition_ctor) using kafka-python."""
    try:
        import kafka  # type: ignore[import-not-found]
    except ImportError as e:
        raise ImportError(
            "streamType 'kafka' needs the kafka-python package (or inject "
            "KafkaStreamConsumerFactory.client_factory)") from e
    props = {}
    for k, v in config.props.items():
        if k.startswith(_CONSUMER_PROP_PREFIX):
            prop = k[len(_CONSUMER_PROP_PREFIX):]
            if prop not in _EXCLUDED_PROPS:
                props[prop.replace(".", "_")] = v
    consumer = kafka.KafkaConsumer(
        bootstrap_servers=config.props.get("stream.kafka.broker.list",
                                           "localhost:9092"),
        enable_auto_commit=False,  # offsets are Pinot's segment checkpoints
        **props)
    return consumer, kafka.TopicPartition


class KafkaPartitionConsumer(PartitionGroupConsumer):
    """Partition-level consumer: seek to the requested offset, poll once.

    Stateless between fetches from the caller's viewpoint — the engine
    passes the start offset on every call (its checkpoint), so a crash or
    catch-up replays exactly from the committed offset; ``seek`` is skipped
    when the consumer is already positioned there."""

    def __init__(self, consumer, tp):
        self._consumer = consumer
        self._tp = tp
        self._position: int | None = None
        self._consumer.assign([tp])

    def fetch_messages(self, start_offset: LongMsgOffset,
                       timeout_ms: int) -> MessageBatch:
        start = start_offset.offset
        if self._position != start:
            self._consumer.seek(self._tp, start)
        polled = self._consumer.poll(timeout_ms=timeout_ms)
        records = polled.get(self._tp, []) if polled else []
        messages = []
        next_offset = start
        for rec in records:
            messages.append(StreamMessage(
                value=rec.value, key=rec.key,
                offset=LongMsgOffset(rec.offset),
                timestamp_ms=getattr(rec, "timestamp", None)))
            next_offset = rec.offset + 1
        self._position = next_offset
        return MessageBatch(messages, LongMsgOffset(next_offset))

    def close(self) -> None:
        self._consumer.close()


class KafkaMetadataProvider(StreamMetadataProvider):
    def __init__(self, consumer, tp_ctor, topic: str):
        self._consumer = consumer
        self._tp_ctor = tp_ctor
        self._topic = topic

    def partition_count(self) -> int:
        parts = self._consumer.partitions_for_topic(self._topic)
        if not parts:
            raise ValueError(f"kafka topic {self._topic!r} has no partitions")
        return len(parts)

    def fetch_earliest_offset(self, partition: int) -> LongMsgOffset:
        tp = self._tp_ctor(self._topic, partition)
        return LongMsgOffset(self._consumer.beginning_offsets([tp])[tp])

    def fetch_latest_offset(self, partition: int) -> LongMsgOffset:
        tp = self._tp_ctor(self._topic, partition)
        return LongMsgOffset(self._consumer.end_offsets([tp])[tp])

    def close(self) -> None:
        self._consumer.close()


class KafkaStreamConsumerFactory(StreamConsumerFactory):
    """``client_factory`` is the injection point: config → (consumer,
    topic_partition_ctor). Swap it for a fake in tests or for an alternate
    client library (confluent-kafka adapter, etc.)."""

    client_factory: Callable = staticmethod(_default_client_factory)

    def create_partition_consumer(self, partition: int) -> KafkaPartitionConsumer:
        consumer, tp_ctor = type(self).client_factory(self.config)
        return KafkaPartitionConsumer(
            consumer, tp_ctor(self.config.topic_name, partition))

    def create_metadata_provider(self) -> KafkaMetadataProvider:
        consumer, tp_ctor = type(self).client_factory(self.config)
        return KafkaMetadataProvider(consumer, tp_ctor, self.config.topic_name)


register_stream_type("kafka", KafkaStreamConsumerFactory)
