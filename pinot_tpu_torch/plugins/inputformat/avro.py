"""Minimal Avro Object Container File codec (the port of
pinot_tpu/plugins/inputformat/avro.py).

Reference analogue: the pinot-avro input-format plugin, which delegates to
the Apache Avro Java library. That library isn't in this image, so the
container format (header/sync/blocks) and binary encoding (zig-zag varints,
length-prefixed bytes, blocked arrays/maps, union indices) are implemented
here directly from the Avro 1.11 spec. Supports codecs null and deflate and
the full primitive + complex type set needed for ingestion; logical types
surface as their underlying primitive (the schema's data-type transformer
coerces downstream).
"""

from __future__ import annotations

import json
import struct
import zlib
from typing import Any, BinaryIO, Iterator

MAGIC = b"Obj\x01"


class AvroError(Exception):
    pass


class _Decoder:
    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def read(self, n: int) -> bytes:
        if self.pos + n > len(self.buf):
            raise AvroError("truncated avro data")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def read_long(self) -> int:
        """Zig-zag varint."""
        shift = 0
        acc = 0
        while True:
            b = self.buf[self.pos]
            self.pos += 1
            acc |= (b & 0x7F) << shift
            if not (b & 0x80):
                break
            shift += 7
        return (acc >> 1) ^ -(acc & 1)

    def read_bytes(self) -> bytes:
        return self.read(self.read_long())

    def read_value(self, schema) -> Any:
        if isinstance(schema, list):  # union: index then value
            idx = self.read_long()
            return self.read_value(schema[idx])
        if isinstance(schema, str):
            return self._read_primitive(schema)
        t = schema["type"]
        if t == "record":
            return {f["name"]: self.read_value(f["type"])
                    for f in schema["fields"]}
        if t == "array":
            out = []
            while True:
                n = self.read_long()
                if n == 0:
                    break
                if n < 0:  # block with byte size prefix
                    n = -n
                    self.read_long()
                for _ in range(n):
                    out.append(self.read_value(schema["items"]))
            return out
        if t == "map":
            out = {}
            while True:
                n = self.read_long()
                if n == 0:
                    break
                if n < 0:
                    n = -n
                    self.read_long()
                for _ in range(n):
                    k = self.read_bytes().decode("utf-8")
                    out[k] = self.read_value(schema["values"])
            return out
        if t == "enum":
            return schema["symbols"][self.read_long()]
        if t == "fixed":
            return self.read(schema["size"])
        if t == "bytes":
            return self.read_bytes()
        return self._read_primitive(t)

    def _read_primitive(self, t: str) -> Any:
        if t == "null":
            return None
        if t == "boolean":
            return self.read(1) != b"\x00"
        if t in ("int", "long"):
            return self.read_long()
        if t == "float":
            return struct.unpack("<f", self.read(4))[0]
        if t == "double":
            return struct.unpack("<d", self.read(8))[0]
        if t == "bytes":
            return self.read_bytes()
        if t == "string":
            return self.read_bytes().decode("utf-8")
        raise AvroError(f"unsupported avro type {t!r}")


def read_avro_file(f: BinaryIO) -> Iterator[dict]:
    """Yield records from an Avro Object Container File."""
    header = f.read()
    dec = _Decoder(header)
    if dec.read(4) != MAGIC:
        raise AvroError("not an avro object container file")
    meta: dict[str, bytes] = {}
    while True:
        n = dec.read_long()
        if n == 0:
            break
        if n < 0:
            n = -n
            dec.read_long()
        for _ in range(n):
            k = dec.read_bytes().decode("utf-8")
            meta[k] = dec.read_bytes()
    schema = json.loads(meta["avro.schema"].decode("utf-8"))
    codec = meta.get("avro.codec", b"null").decode("utf-8")
    if codec not in ("null", "deflate"):
        raise AvroError(f"unsupported avro codec {codec!r}")
    sync = dec.read(16)
    while dec.pos < len(dec.buf):
        count = dec.read_long()
        size = dec.read_long()
        block = dec.read(size)
        if codec == "deflate":
            block = zlib.decompress(block, -15)
        bdec = _Decoder(block)
        for _ in range(count):
            yield bdec.read_value(schema)
        if dec.read(16) != sync:
            raise AvroError("sync marker mismatch")


# -- writer (tests + FakeStream fixtures need round-trips) -------------------


def _zigzag(n: int) -> bytes:
    u = (n << 1) ^ (n >> 63)
    out = bytearray()
    while True:
        b = u & 0x7F
        u >>= 7
        if u:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _write_value(schema, v, out: bytearray) -> None:
    if isinstance(schema, list):
        for i, branch in enumerate(schema):
            t = branch if isinstance(branch, str) else branch["type"]
            if (v is None) == (t == "null"):
                out.extend(_zigzag(i))
                _write_value(branch, v, out)
                return
        raise AvroError(f"no union branch for {v!r}")
    t = schema if isinstance(schema, str) else schema["type"]
    if t == "null":
        return
    if t == "boolean":
        out.append(1 if v else 0)
    elif t in ("int", "long"):
        out.extend(_zigzag(int(v)))
    elif t == "float":
        out.extend(struct.pack("<f", float(v)))
    elif t == "double":
        out.extend(struct.pack("<d", float(v)))
    elif t == "string":
        b = str(v).encode("utf-8")
        out.extend(_zigzag(len(b)))
        out.extend(b)
    elif t == "bytes":
        out.extend(_zigzag(len(v)))
        out.extend(v)
    elif t == "record":
        for fld in schema["fields"]:
            _write_value(fld["type"], v.get(fld["name"]), out)
    elif t == "array":
        if v:
            out.extend(_zigzag(len(v)))
            for item in v:
                _write_value(schema["items"], item, out)
        out.extend(_zigzag(0))
    elif t == "map":
        if v:
            out.extend(_zigzag(len(v)))
            for k, item in v.items():
                b = str(k).encode("utf-8")
                out.extend(_zigzag(len(b)))
                out.extend(b)
                _write_value(schema["values"], item, out)
        out.extend(_zigzag(0))
    elif t == "enum":
        out.extend(_zigzag(schema["symbols"].index(v)))
    else:
        raise AvroError(f"unsupported avro type {t!r}")


def write_avro_file(f: BinaryIO, schema: dict, records: list[dict],
                    codec: str = "deflate") -> None:
    f.write(MAGIC)
    meta = {"avro.schema": json.dumps(schema).encode("utf-8"),
            "avro.codec": codec.encode("utf-8")}
    out = bytearray()
    out.extend(_zigzag(len(meta)))
    for k, v in meta.items():
        kb = k.encode("utf-8")
        out.extend(_zigzag(len(kb)))
        out.extend(kb)
        out.extend(_zigzag(len(v)))
        out.extend(v)
    out.extend(_zigzag(0))
    f.write(bytes(out))
    sync = b"\x00\x01\x02\x03" * 4
    f.write(sync)
    block = bytearray()
    for r in records:
        _write_value(schema, r, block)
    payload = bytes(block)
    if codec == "deflate":
        payload = zlib.compress(payload)[2:-4]  # raw deflate (no zlib wrapper)
    f.write(_zigzag(len(records)))
    f.write(_zigzag(len(payload)))
    f.write(payload)
    f.write(sync)
