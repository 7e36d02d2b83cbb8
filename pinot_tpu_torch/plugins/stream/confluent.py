"""Confluent Schema-Registry Avro stream decoder.

The port's copy of pinot_tpu/plugins/stream/confluent.py.

Reference analogue: pinot-plugins/pinot-input-format/pinot-confluent-avro
(KafkaConfluentSchemaRegistryAvroMessageDecoder.java) — Kafka payloads in
the Confluent wire format: magic byte 0x00, 4-byte big-endian schema id,
then the Avro binary record. The schema id resolves against the registry.

Zero-egress redesign: schema resolution is injectable. The stream config
can carry inline schemas (``schema.registry.schemas``: {id: avro schema
json}, or a single ``schema.json`` used for every id), or a registry
client object can be injected via ``register_schema_provider`` (the test /
embedded-cluster seam, where the reference would hit the REST registry).
"""

from __future__ import annotations

import json
import struct
from typing import Callable, Optional

from ...spi.stream import (StreamConfig, StreamDataDecoder, StreamMessage,
                           register_decoder)

_MAGIC = 0

# process-global injectable registry: schema id → avro schema (dict)
_PROVIDERS: dict[str, Callable[[int], dict]] = {}


def register_schema_provider(url: str, provider: Callable[[int], dict]) -> None:
    """Bind a schema-registry URL to a resolver (id → avro schema dict) —
    the injectable client seam (same pattern as the kafka plugin's
    injectable consumer)."""
    _PROVIDERS[url] = provider


class ConfluentAvroDecoder(StreamDataDecoder):
    def __init__(self, config: Optional[StreamConfig] = None):
        props = (config.props if config is not None else {}) or {}
        self._schemas: dict[int, dict] = {}
        inline = props.get("schema.registry.schemas")
        if isinstance(inline, str):
            inline = json.loads(inline)
        if isinstance(inline, dict):
            self._schemas = {int(k): (json.loads(v) if isinstance(v, str) else v)
                             for k, v in inline.items()}
        default = props.get("schema.json")
        self._default = (json.loads(default) if isinstance(default, str)
                         else default)
        self._provider = _PROVIDERS.get(
            props.get("schema.registry.rest.url", ""))

    def _schema(self, schema_id: int) -> Optional[dict]:
        s = self._schemas.get(schema_id)
        if s is None and self._provider is not None:
            s = self._provider(schema_id)
            if s is not None:
                self._schemas[schema_id] = s
        return s if s is not None else self._default

    def decode(self, message: StreamMessage) -> Optional[dict]:
        from ..inputformat.avro import _Decoder

        v = message.value
        if not isinstance(v, (bytes, bytearray)) or len(v) < 5 \
                or v[0] != _MAGIC:
            return None
        (schema_id,) = struct.unpack(">i", bytes(v[1:5]))
        schema = self._schema(schema_id)
        if schema is None:
            return None
        try:
            row = _Decoder(bytes(v[5:])).read_value(schema)
        except Exception:
            return None
        return row if isinstance(row, dict) else None


def encode_confluent(schema_id: int, schema: dict, row: dict) -> bytes:
    """Test/producer helper: Confluent wire-format encoding of one row."""
    from ..inputformat.avro import _write_value

    out = bytearray()
    _write_value(schema, row, out)
    return bytes([_MAGIC]) + struct.pack(">i", schema_id) + bytes(out)


register_decoder("confluentavro", ConfluentAvroDecoder)
register_decoder(
    "org.apache.pinot.plugin.inputformat.avro.confluent."
    "KafkaConfluentSchemaRegistryAvroMessageDecoder", ConfluentAvroDecoder)
