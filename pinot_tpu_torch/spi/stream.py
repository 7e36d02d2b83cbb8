"""Stream ingestion SPI (the port of pinot_tpu/spi/stream.py).

Reference: pinot-spi/.../spi/stream/ (33 files - StreamConsumerFactory,
PartitionGroupConsumer, MessageBatch, StreamPartitionMsgOffset,
StreamMetadataProvider, StreamDataDecoder). Same pluggable shape here:
a ``StreamConfig`` names a stream type; the registry resolves a factory that
creates per-partition consumers and a metadata provider. The in-memory stream
(streamType "inmemory") is both the test double (reference
FakeStreamConsumerFactory, pinot-core/src/test/.../fakestream/) and the
process-local producer API used by quickstarts.

An unregistered streamType resolves through the plugin loader
(``spi/plugins.py`` ``resolve("stream", name)``, which imports
``pinot_tpu_torch.plugins.stream.<name>``: kafka, kinesis, pulsar), as in
the JAX package; a decoder name holding "confluent" imports the Confluent
Avro decoder (``plugins/stream/confluent.py``) first.
"""

from __future__ import annotations

import json
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Iterable, Optional


# ---------------------------------------------------------------------------
# offsets
# ---------------------------------------------------------------------------


@dataclass(frozen=True, order=True)
class LongMsgOffset:
    """Monotonic long offset (reference LongMsgOffset - Kafka-style)."""

    offset: int

    def __str__(self) -> str:
        return str(self.offset)

    @staticmethod
    def parse(s: str) -> "LongMsgOffset":
        return LongMsgOffset(int(s))


# ---------------------------------------------------------------------------
# messages
# ---------------------------------------------------------------------------


@dataclass
class StreamMessage:
    value: Any
    key: Optional[Any] = None
    offset: Optional[LongMsgOffset] = None
    timestamp_ms: Optional[int] = None


@dataclass
class MessageBatch:
    messages: list[StreamMessage]
    offset_of_next_batch: LongMsgOffset

    @property
    def message_count(self) -> int:
        return len(self.messages)


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------


@dataclass
class StreamConfig:
    """Parsed view of TableConfig.ingestion.stream_configs (reference
    StreamConfig.java - key names kept compatible where sensible)."""

    stream_type: str = "inmemory"
    topic_name: str = ""
    decoder: str = "json"
    flush_threshold_rows: int = 100_000
    flush_threshold_time_ms: int = 6 * 3600 * 1000
    offset_criteria: str = "smallest"  # smallest | largest
    fetch_timeout_ms: int = 100
    props: dict = field(default_factory=dict)

    @classmethod
    def from_table_config(cls, stream_configs: dict) -> "StreamConfig":
        sc = dict(stream_configs or {})
        stype = sc.get("streamType", "inmemory")
        return cls(
            stream_type=stype,
            topic_name=sc.get(f"stream.{stype}.topic.name", sc.get("topic.name", "")),
            decoder=sc.get(f"stream.{stype}.decoder.class.name", sc.get("decoder", "json")),
            flush_threshold_rows=int(sc.get("realtime.segment.flush.threshold.rows", 100_000)),
            flush_threshold_time_ms=int(
                sc.get("realtime.segment.flush.threshold.time.ms", 6 * 3600 * 1000)),
            offset_criteria=sc.get(
                f"stream.{stype}.consumer.prop.auto.offset.reset", "smallest"),
            fetch_timeout_ms=int(sc.get("stream.fetch.timeout.ms", 100)),
            props=sc,
        )


# ---------------------------------------------------------------------------
# SPI interfaces
# ---------------------------------------------------------------------------


class PartitionGroupConsumer:
    """Per-partition pull consumer (reference PartitionGroupConsumer)."""

    def fetch_messages(self, start_offset: LongMsgOffset, timeout_ms: int) -> MessageBatch:
        raise NotImplementedError

    def close(self) -> None:
        pass


class StreamMetadataProvider:
    def partition_count(self) -> int:
        raise NotImplementedError

    def fetch_earliest_offset(self, partition: int) -> LongMsgOffset:
        raise NotImplementedError

    def fetch_latest_offset(self, partition: int) -> LongMsgOffset:
        """Offset one past the last published message."""
        raise NotImplementedError

    def close(self) -> None:
        pass


class StreamConsumerFactory:
    def __init__(self, config: StreamConfig):
        self.config = config

    def create_partition_consumer(self, partition: int) -> PartitionGroupConsumer:
        raise NotImplementedError

    def create_metadata_provider(self) -> StreamMetadataProvider:
        raise NotImplementedError


class StreamDataDecoder:
    """message → row dict, or None to skip (reference StreamDataDecoder)."""

    def decode(self, message: StreamMessage) -> Optional[dict]:
        raise NotImplementedError


class JsonDecoder(StreamDataDecoder):
    def decode(self, message: StreamMessage) -> Optional[dict]:
        v = message.value
        if isinstance(v, dict):
            return v
        if isinstance(v, bytes):
            v = v.decode()
        try:
            row = json.loads(v)
        except (TypeError, ValueError):
            return None
        return row if isinstance(row, dict) else None


# ---------------------------------------------------------------------------
# registries
# ---------------------------------------------------------------------------

_FACTORIES: dict[str, Callable[[StreamConfig], StreamConsumerFactory]] = {}
_DECODERS: dict[str, Callable[[], StreamDataDecoder]] = {"json": JsonDecoder}


def register_stream_type(name: str, factory: Callable[[StreamConfig], StreamConsumerFactory]):
    _FACTORIES[name] = factory


def register_decoder(name: str, decoder: Callable[[], StreamDataDecoder]):
    _DECODERS[name] = decoder


def get_stream_consumer_factory(config: StreamConfig) -> StreamConsumerFactory:
    if config.stream_type not in _FACTORIES:
        # plugin discovery via the shared loader (reference: PluginManager
        # resolving the stream factory class name)
        from .plugins import resolve

        try:
            resolve("stream", config.stream_type)
        except ValueError:
            raise ValueError(
                f"unknown streamType {config.stream_type!r}; "
                f"registered: {sorted(_FACTORIES)}") from None
    return _FACTORIES[config.stream_type](config)


def get_decoder(config: StreamConfig) -> StreamDataDecoder:
    name = config.decoder
    if name not in _DECODERS and "confluent" in name.lower():
        # auto-import like stream types: decoder class names resolve on use
        from ..plugins.stream import confluent  # noqa: F401
    if name not in _DECODERS:
        name = "json"
    factory = _DECODERS[name]
    try:
        import inspect

        takes_config = bool(inspect.signature(factory).parameters)
    except (TypeError, ValueError):
        takes_config = False
    return factory(config) if takes_config else factory()


# ---------------------------------------------------------------------------
# in-memory stream (test double + process-local producer)
# ---------------------------------------------------------------------------


class _InMemoryTopic:
    def __init__(self, num_partitions: int):
        self.lock = threading.Lock()
        self.partitions: list[list[StreamMessage]] = [[] for _ in range(num_partitions)]

    def publish(self, partition: int, value, key=None):
        with self.lock:
            log = self.partitions[partition]
            msg = StreamMessage(value=value, key=key,
                                offset=LongMsgOffset(len(log)),
                                timestamp_ms=int(time.time() * 1000))
            log.append(msg)
            return msg.offset


class InMemoryStreamRegistry:
    """Process-global topics. ``create_topic`` then ``publish`` rows; any
    table whose stream config names the topic consumes them."""

    def __init__(self):
        self._lock = threading.Lock()
        self._topics: dict[str, _InMemoryTopic] = {}

    def create_topic(self, name: str, num_partitions: int = 1) -> None:
        with self._lock:
            if name not in self._topics:
                self._topics[name] = _InMemoryTopic(num_partitions)

    def delete_topic(self, name: str) -> None:
        with self._lock:
            self._topics.pop(name, None)

    def topic(self, name: str) -> _InMemoryTopic:
        with self._lock:
            if name not in self._topics:
                self._topics[name] = _InMemoryTopic(1)
            return self._topics[name]

    def publish(self, topic: str, rows: Iterable[dict], partition_key: Optional[str] = None):
        """Publish row dicts; ``partition_key`` routes by hash(column value)."""
        t = self.topic(topic)
        n = len(t.partitions)
        for row in rows:
            if partition_key is not None and n > 1:
                p = hash(str(row.get(partition_key))) % n
            else:
                p = 0
            t.publish(p, row, key=row.get(partition_key) if partition_key else None)


GLOBAL_STREAM_REGISTRY = InMemoryStreamRegistry()


class _InMemoryPartitionConsumer(PartitionGroupConsumer):
    def __init__(self, topic: _InMemoryTopic, partition: int, max_batch: int = 1000):
        self.topic = topic
        self.partition = partition
        self.max_batch = max_batch

    def fetch_messages(self, start_offset: LongMsgOffset, timeout_ms: int) -> MessageBatch:
        log = self.topic.partitions[self.partition]
        start = start_offset.offset
        end = min(len(log), start + self.max_batch)
        msgs = log[start:end]
        return MessageBatch(list(msgs), LongMsgOffset(max(start, end)))


class _InMemoryMetadataProvider(StreamMetadataProvider):
    def __init__(self, topic: _InMemoryTopic):
        self.topic = topic

    def partition_count(self) -> int:
        return len(self.topic.partitions)

    def fetch_earliest_offset(self, partition: int) -> LongMsgOffset:
        return LongMsgOffset(0)

    def fetch_latest_offset(self, partition: int) -> LongMsgOffset:
        return LongMsgOffset(len(self.topic.partitions[partition]))


class InMemoryStreamConsumerFactory(StreamConsumerFactory):
    def __init__(self, config: StreamConfig, registry: InMemoryStreamRegistry = None):
        super().__init__(config)
        self.registry = registry or GLOBAL_STREAM_REGISTRY

    def _topic(self) -> _InMemoryTopic:
        return self.registry.topic(self.config.topic_name)

    def create_partition_consumer(self, partition: int) -> PartitionGroupConsumer:
        return _InMemoryPartitionConsumer(self._topic(), partition)

    def create_metadata_provider(self) -> StreamMetadataProvider:
        return _InMemoryMetadataProvider(self._topic())


register_stream_type("inmemory", InMemoryStreamConsumerFactory)


from .plugins import register_kind as _register_kind  # noqa: E402

_register_kind("stream", _FACTORIES.get)
