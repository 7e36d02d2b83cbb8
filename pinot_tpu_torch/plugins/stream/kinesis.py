"""Kinesis stream connector on the stream SPI.

The port's copy of pinot_tpu/plugins/stream/kinesis.py.

Reference: KinesisConsumer / KinesisStreamMetadataProvider
(pinot-plugins/pinot-stream-ingestion/pinot-kinesis/src/main/java/org/
apache/pinot/plugin/stream/kinesis/KinesisConsumer.java) — shard-level
consumption via shard iterators, checkpointed on sequence numbers.

Offset model (rides the SPI's ``LongMsgOffset``; Kinesis sequence numbers
are decimal integer strings, unbounded Python ints hold them):

    0      TRIM_HORIZON  — earliest retained record
    1      LATEST        — only records arriving after the probe
    c >= 2 AFTER_SEQUENCE_NUMBER(c - 1) — and c-1 is always the sequence
           number of a record this consumer actually returned (checkpoints
           are only ever minted as ``last_seq + 1``), so the iterator
           request is valid against the real API.

The boto3 client is an OPTIONAL dependency behind ``client_factory``;
tests inject a fake exposing the adapter surface:

    list_shards(stream) -> [shard_id, ...]                    (sorted)
    get_records(stream, shard_id, checkpoint:int, limit)
        -> [(seq:int, key:bytes|None, value:bytes, ts_ms:int|None), ...]
           (checkpoint follows the sentinel model above)
    latest_checkpoint(stream, shard_id) -> int   (1 when idle)
    close()

Config keys (reference-compatible):
    streamType: kinesis
    stream.kinesis.topic.name                 (stream name)
    stream.kinesis.consumer.prop.region       (AWS region)
    stream.kinesis.consumer.prop.maxRecordsToFetch
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

_PROP = "stream.kinesis.consumer.prop."
TRIM_HORIZON = 0
LATEST = 1


class _Boto3Adapter:
    """Adapts a boto3 kinesis client to the shard-level surface above.
    Caches each shard's NextShardIterator keyed by the checkpoint it will
    resume from, so steady-state polling costs one API call (the reference
    consumer likewise holds its iterator between polls)."""

    def __init__(self, client, max_records: int):
        self._c = client
        self._max = max_records
        self._iters: dict[tuple, tuple] = {}  # (stream, shard) → (ckpt, iter)

    def list_shards(self, stream):
        shards = []
        kwargs = {"StreamName": stream}
        while True:
            resp = self._c.list_shards(**kwargs)
            shards.extend(s["ShardId"] for s in resp.get("Shards", []))
            token = resp.get("NextToken")
            if not token:
                return sorted(shards)
            kwargs = {"NextToken": token}

    def _iterator(self, stream, shard_id, checkpoint):
        cached = self._iters.get((stream, shard_id))
        if cached and cached[0] == checkpoint and cached[1]:
            return cached[1]
        kwargs = {"StreamName": stream, "ShardId": shard_id}
        if checkpoint <= TRIM_HORIZON:
            kwargs["ShardIteratorType"] = "TRIM_HORIZON"
        elif checkpoint == LATEST:
            kwargs["ShardIteratorType"] = "LATEST"
        else:
            kwargs["ShardIteratorType"] = "AFTER_SEQUENCE_NUMBER"
            kwargs["StartingSequenceNumber"] = str(checkpoint - 1)
        return self._c.get_shard_iterator(**kwargs)["ShardIterator"]

    def get_records(self, stream, shard_id, checkpoint, limit):
        it = self._iterator(stream, shard_id, checkpoint)
        try:
            resp = self._c.get_records(ShardIterator=it,
                                       Limit=min(limit, self._max))
        except Exception:
            # shard iterators expire after ~5 minutes: a consumer idle (or
            # slow) between polls must re-mint from its checkpoint, not
            # kill the partition. One retry with a fresh iterator; a
            # second failure is a real error.
            self._iters.pop((stream, shard_id), None)
            it = self._iterator(stream, shard_id, checkpoint)
            resp = self._c.get_records(ShardIterator=it,
                                       Limit=min(limit, self._max))
        out = []
        for r in resp.get("Records", []):
            ts = r.get("ApproximateArrivalTimestamp")
            out.append((int(r["SequenceNumber"]),
                        (r.get("PartitionKey") or "").encode() or None,
                        r["Data"],
                        int(ts.timestamp() * 1000) if ts else None))
        next_ckpt = out[-1][0] + 1 if out else checkpoint
        self._iters[(stream, shard_id)] = (next_ckpt,
                                           resp.get("NextShardIterator"))
        return out

    def latest_checkpoint(self, stream, shard_id):
        it = self._iterator(stream, shard_id, LATEST)
        resp = self._c.get_records(ShardIterator=it, Limit=1)
        recs = resp.get("Records", [])
        return int(recs[0]["SequenceNumber"]) + 1 if recs else LATEST

    def close(self):
        pass


def _default_client_factory(config):
    try:
        import boto3  # type: ignore[import-not-found]
    except ImportError as e:
        raise ImportError(
            "streamType 'kinesis' needs the boto3 package (or inject "
            "KinesisStreamConsumerFactory.client_factory)") from e
    region = config.props.get(_PROP + "region")
    max_records = int(config.props.get(_PROP + "maxRecordsToFetch", 1000))
    client = boto3.client("kinesis", region_name=region)
    return _Boto3Adapter(client, max_records)


class KinesisShardConsumer(PartitionGroupConsumer):
    def __init__(self, client, stream: str, shard_id: str):
        self._client = client
        self._stream = stream
        self._shard = shard_id

    def fetch_messages(self, start_offset: LongMsgOffset,
                       timeout_ms: int) -> MessageBatch:
        recs = self._client.get_records(self._stream, self._shard,
                                        start_offset.offset, 1000)
        messages = [
            StreamMessage(value=value, key=key,
                          offset=LongMsgOffset(seq), timestamp_ms=ts)
            for seq, key, value, ts in recs]
        next_off = recs[-1][0] + 1 if recs else start_offset.offset
        return MessageBatch(messages, LongMsgOffset(next_off))

    def close(self) -> None:
        self._client.close()


class KinesisMetadataProvider(StreamMetadataProvider):
    def __init__(self, client, stream: str):
        self._client = client
        self._stream = stream

    def partition_count(self) -> int:
        return len(self._client.list_shards(self._stream))

    def fetch_earliest_offset(self, partition: int) -> LongMsgOffset:
        # the TRIM_HORIZON sentinel: "everything retained", no record reads
        return LongMsgOffset(TRIM_HORIZON)

    def fetch_latest_offset(self, partition: int) -> LongMsgOffset:
        shard = self._client.list_shards(self._stream)[partition]
        return LongMsgOffset(self._client.latest_checkpoint(
            self._stream, shard))

    def close(self) -> None:
        self._client.close()


class KinesisStreamConsumerFactory(StreamConsumerFactory):
    client_factory: Callable = staticmethod(_default_client_factory)

    def create_partition_consumer(self, partition: int) -> KinesisShardConsumer:
        client = type(self).client_factory(self.config)
        shard = client.list_shards(self.config.topic_name)[partition]
        return KinesisShardConsumer(client, self.config.topic_name, shard)

    def create_metadata_provider(self) -> KinesisMetadataProvider:
        return KinesisMetadataProvider(
            type(self).client_factory(self.config), self.config.topic_name)


register_stream_type("kinesis", KinesisStreamConsumerFactory)
