"""Pulsar stream connector on the stream SPI.

The port's copy of pinot_tpu/plugins/stream/pulsar.py.

Reference: PulsarPartitionLevelConsumer / PulsarStreamMetadataProvider
(pinot-plugins/pinot-stream-ingestion/pinot-pulsar/src/main/java/org/
apache/pinot/plugin/stream/pulsar/PulsarPartitionLevelConsumer.java) —
reader-based (not subscription) partition consumption seeded at a
MessageId, checkpointed per segment.

Offset model (rides the SPI's ``LongMsgOffset``): Pulsar MessageIds are
(ledgerId, entryId, batchIndex) triples packed as

    ((ledgerId + 1) << 36) | (entryId << 8) | batchIndex

monotone within a partition because ledger and entry ids are assigned in
order. The +1 ledger bias keeps every real packed id above the sentinels:

    0  EARLIEST  (MessageId.earliest)
    1  LATEST    (MessageId.latest — only new messages)

entryId is bounded to 28 bits and batchIndex to 8; overflow raises rather
than silently wrapping the checkpoint stream backwards. The pulsar-client
library is OPTIONAL behind ``client_factory``; tests inject a fake with
the adapter surface:

    partition_count(topic) -> int      (0 → non-partitioned, treated as 1)
    open_reader(topic, partition, from_packed:int) -> handle
        (from_packed follows the sentinel model above; inclusive start.
         The handle PERSISTS across polls — a reader opened at LATEST must
         see messages published between polls, which a fresh per-poll
         reader at MessageId.latest would silently skip forever)
    read_batch(handle, max_records, timeout_ms)
        -> [(packed:int, key:bytes|None, value:bytes, ts_ms:int|None), ...]
    close_reader(handle)
    latest(topic, partition) -> int    (1 when idle)
    close()

Config keys (reference-compatible):
    streamType: pulsar
    stream.pulsar.topic.name
    stream.pulsar.consumer.prop.serviceUrl    (pulsar://host:6650)
"""

from __future__ import annotations

from typing import Callable

from ...spi.stream import (
    LongMsgOffset,
    MessageBatch,
    PartitionGroupConsumer,
    StreamConsumerFactory,
    StreamMessage,
    StreamMetadataProvider,
    register_stream_type,
)

_PROP = "stream.pulsar.consumer.prop."
EARLIEST = 0
LATEST = 1
_ENTRY_BITS = 28
_BATCH_BITS = 8


def pack_message_id(ledger: int, entry: int, batch: int = 0) -> int:
    """(ledger, entry, batch) → flat monotone int offset (> all sentinels)."""
    if not (0 <= entry < (1 << _ENTRY_BITS)):
        raise ValueError(f"entryId {entry} out of the {_ENTRY_BITS}-bit "
                         "packable range — checkpoint would wrap")
    if not (0 <= batch < (1 << _BATCH_BITS)):
        raise ValueError(f"batchIndex {batch} out of the {_BATCH_BITS}-bit "
                         "packable range — checkpoint would wrap")
    return ((ledger + 1) << (_ENTRY_BITS + _BATCH_BITS)) \
        | (entry << _BATCH_BITS) | batch


def unpack_message_id(packed: int) -> tuple[int, int, int]:
    return ((packed >> (_ENTRY_BITS + _BATCH_BITS)) - 1,
            (packed >> _BATCH_BITS) & ((1 << _ENTRY_BITS) - 1),
            packed & ((1 << _BATCH_BITS) - 1))


class _PulsarClientAdapter:
    """Adapts the pulsar-client library to the adapter surface above."""

    def __init__(self, service_url: str, max_records: int = 1000):
        import pulsar  # type: ignore[import-not-found]

        self._pulsar = pulsar
        self._client = pulsar.Client(service_url)
        self.max_records = max_records

    def partition_count(self, topic) -> int:
        parts = self._client.get_topic_partitions(topic)
        # a non-partitioned topic reports itself as its only "partition"
        return len(parts) if len(parts) > 1 or (
            parts and parts[0] != topic) else 0

    def _reader_topic(self, topic, partition):
        # partition -1 = non-partitioned: read the topic itself
        return topic if partition < 0 else f"{topic}-partition-{partition}"

    def _start_id(self, partition, from_packed):
        if from_packed <= EARLIEST:
            return self._pulsar.MessageId.earliest, True
        if from_packed == LATEST:
            return self._pulsar.MessageId.latest, False
        ledger, entry, batch = unpack_message_id(from_packed)
        return self._pulsar.MessageId(max(partition, -1), ledger, entry,
                                      batch), True

    def open_reader(self, topic, partition, from_packed):
        start, inclusive = self._start_id(partition, from_packed)
        reader = self._client.create_reader(
            self._reader_topic(topic, partition), start_message_id=start,
            start_message_id_inclusive=inclusive)
        return {"reader": reader, "skip_below": from_packed if inclusive
                else None}

    def read_batch(self, handle, max_records, timeout_ms):
        reader = handle["reader"]
        out = []
        while len(out) < min(max_records, self.max_records) \
                and reader.has_message_available():
            msg = reader.read_next(timeout_millis=timeout_ms)
            mid = msg.message_id()
            packed = pack_message_id(mid.ledger_id(), mid.entry_id(),
                                     max(0, mid.batch_index()))
            skip = handle["skip_below"]
            if skip is not None and packed < skip:
                continue  # replayed prefix of a batch
            out.append((packed,
                        (msg.partition_key() or "").encode() or None,
                        msg.data(), msg.publish_timestamp()))
        return out

    def close_reader(self, handle):
        handle["reader"].close()

    def latest(self, topic, partition) -> int:
        # a reader seeded at MessageId.latest sees only the tail; an idle
        # partition therefore reports the LATEST sentinel — never a replay
        # of retained history
        handle = self.open_reader(topic, partition, LATEST)
        try:
            recs = self.read_batch(handle, 100, 1000)
        finally:
            self.close_reader(handle)
        return recs[-1][0] + 1 if recs else LATEST

    def close(self):
        self._client.close()


def _default_client_factory(config):
    try:
        import pulsar  # noqa: F401  type: ignore[import-not-found]
    except ImportError as e:
        raise ImportError(
            "streamType 'pulsar' needs the pulsar-client package (or inject "
            "PulsarStreamConsumerFactory.client_factory)") from e
    url = config.props.get(_PROP + "serviceUrl", "pulsar://localhost:6650")
    max_records = int(config.props.get(_PROP + "maxRecordsToFetch", 1000))
    return _PulsarClientAdapter(url, max_records)


class PulsarPartitionConsumer(PartitionGroupConsumer):
    """Holds ONE persistent reader across polls: required for LATEST
    starts (a fresh per-poll reader at MessageId.latest would lose every
    message published between polls) and avoids a create-reader broker
    round trip per poll. Reopens only when the engine rewinds/seeks."""

    def __init__(self, client, topic: str, partition: int,
                 max_records: int = 1000):
        self._client = client
        self._topic = topic
        self._partition = partition
        self._max_records = max_records
        self._handle = None
        self._position: int | None = None  # checkpoint the reader sits at

    def fetch_messages(self, start_offset: LongMsgOffset,
                       timeout_ms: int) -> MessageBatch:
        start = start_offset.offset
        if self._handle is None or self._position != start:
            if self._handle is not None:
                self._client.close_reader(self._handle)
            self._handle = self._client.open_reader(
                self._topic, self._partition, start)
        recs = self._client.read_batch(self._handle, self._max_records,
                                       timeout_ms)
        messages = [
            StreamMessage(value=value, key=key,
                          offset=LongMsgOffset(packed), timestamp_ms=ts)
            for packed, key, value, ts in recs]
        next_off = recs[-1][0] + 1 if recs else start
        self._position = next_off
        return MessageBatch(messages, LongMsgOffset(next_off))

    def close(self) -> None:
        if self._handle is not None:
            self._client.close_reader(self._handle)
            self._handle = None
        self._client.close()


class PulsarMetadataProvider(StreamMetadataProvider):
    def __init__(self, client, topic: str):
        self._client = client
        self._topic = topic
        # partitioned-ness is immutable: resolve once, not per probe
        self._raw_count = client.partition_count(topic)

    def partition_count(self) -> int:
        return max(1, self._raw_count)

    def fetch_earliest_offset(self, partition: int) -> LongMsgOffset:
        return LongMsgOffset(EARLIEST)

    def fetch_latest_offset(self, partition: int) -> LongMsgOffset:
        eff = -1 if self._raw_count == 0 else partition
        return LongMsgOffset(self._client.latest(self._topic, eff))

    def close(self) -> None:
        self._client.close()


class PulsarStreamConsumerFactory(StreamConsumerFactory):
    client_factory: Callable = staticmethod(_default_client_factory)

    def create_partition_consumer(self, partition: int) -> PulsarPartitionConsumer:
        client = type(self).client_factory(self.config)
        if client.partition_count(self.config.topic_name) == 0:
            partition = -1  # non-partitioned: read the topic itself
        return PulsarPartitionConsumer(client, self.config.topic_name,
                                       partition)

    def create_metadata_provider(self) -> PulsarMetadataProvider:
        return PulsarMetadataProvider(
            type(self).client_factory(self.config), self.config.topic_name)


register_stream_type("pulsar", PulsarStreamConsumerFactory)
