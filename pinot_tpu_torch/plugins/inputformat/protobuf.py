"""Protobuf record reader (the port of
pinot_tpu/plugins/inputformat/protobuf.py).

Reference analogue: pinot-plugins/pinot-input-format/pinot-protobuf
(ProtoBufRecordReader.java) — reads a file of size-delimited protobuf
messages, decoded against a descriptor set generated by
``protoc --descriptor_set_out`` and a message class name from the reader
config (``descriptorFile`` + ``protoClassName``).

Uses the bundled ``google.protobuf`` runtime (descriptor pool + message
factory); rows surface as plain dicts with proto field names.
"""

from __future__ import annotations

from typing import Iterator

from .readers import RecordReader, register_record_reader


def _read_varint(f) -> int | None:
    """Base-128 varint (the parseDelimitedFrom length prefix)."""
    shift = 0
    result = 0
    while True:
        b = f.read(1)
        if not b:
            return None if shift == 0 else _raise_eof()
        byte = b[0]
        result |= (byte & 0x7F) << shift
        if not byte & 0x80:
            return result
        shift += 7
        if shift > 63:
            raise ValueError("varint too long")


def _raise_eof():
    raise ValueError("truncated varint length prefix")


def load_message_class(descriptor_bytes: bytes, full_name: str):
    """Message class from a serialized FileDescriptorSet + full type name."""
    from google.protobuf import descriptor_pb2, descriptor_pool, message_factory

    fds = descriptor_pb2.FileDescriptorSet()
    fds.MergeFromString(descriptor_bytes)
    pool = descriptor_pool.DescriptorPool()
    for fd in fds.file:
        pool.Add(fd)
    desc = pool.FindMessageTypeByName(full_name)
    return message_factory.GetMessageClass(desc)


class ProtobufRecordReader(RecordReader):
    """config: ``descriptorFile`` (path to protoc --descriptor_set_out
    output), ``protoClassName`` (full message name). The data file holds
    varint-size-delimited serialized messages, optionally gzipped."""

    def _iter(self) -> Iterator[dict]:
        from google.protobuf.json_format import MessageToDict

        desc_path = self.config.get("descriptorFile")
        class_name = self.config.get("protoClassName")
        if not desc_path or not class_name:
            raise ValueError(
                "protobuf reader needs descriptorFile + protoClassName")
        with open(desc_path, "rb") as df:
            cls = load_message_class(df.read(), class_name)
        with self._open_binary() as f:
            while True:
                size = _read_varint(f)
                if size is None:
                    return
                payload = f.read(size)
                if len(payload) != size:
                    raise ValueError("truncated protobuf message")
                msg = cls()
                msg.ParseFromString(payload)
                yield MessageToDict(msg, preserving_proto_field_name=True)


def write_delimited(f, messages) -> None:
    """Test/producer helper: size-delimited encoding of proto messages."""
    for m in messages:
        payload = m.SerializeToString()
        size = len(payload)
        out = bytearray()
        while True:
            b = size & 0x7F
            size >>= 7
            out.append(b | (0x80 if size else 0))
            if not size:
                break
        f.write(bytes(out) + payload)


register_record_reader("proto", ProtobufRecordReader)
register_record_reader("protobuf", ProtobufRecordReader)
