"""Thrift record reader: self-contained TBinaryProtocol struct decoder (the
port of pinot_tpu/plugins/inputformat/thrift.py).

Reference analogue: pinot-plugins/pinot-input-format/pinot-thrift
(ThriftRecordReader.java) — reads concatenated TBinaryProtocol-serialized
structs. The reference binds field names through the generated thrift
class's metadata map; no thrift runtime is bundled here, so the reader
config supplies the same mapping explicitly:

    {"fieldIdToName": {"1": "name", "2": "price", ...}}

Unmapped fields keep their numeric id as a string key. Nested structs
decode to dicts (their ids unmapped), lists/sets to lists, maps to dicts.
"""

from __future__ import annotations

import struct
from typing import Iterator

from .readers import RecordReader, register_record_reader

# TBinaryProtocol type ids
_STOP, _BOOL, _BYTE, _DOUBLE, _I16, _I32, _I64 = 0, 2, 3, 4, 6, 8, 10
_STRING, _STRUCT, _MAP, _SET, _LIST = 11, 12, 13, 14, 15


class _Reader:
    def __init__(self, f):
        self.f = f

    def read(self, n: int) -> bytes:
        b = self.f.read(n)
        if len(b) != n:
            raise EOFError("truncated thrift data")
        return b

    def value(self, ttype: int):
        if ttype == _BOOL:
            return self.read(1)[0] != 0
        if ttype == _BYTE:
            return struct.unpack(">b", self.read(1))[0]
        if ttype == _DOUBLE:
            return struct.unpack(">d", self.read(8))[0]
        if ttype == _I16:
            return struct.unpack(">h", self.read(2))[0]
        if ttype == _I32:
            return struct.unpack(">i", self.read(4))[0]
        if ttype == _I64:
            return struct.unpack(">q", self.read(8))[0]
        if ttype == _STRING:
            n = struct.unpack(">i", self.read(4))[0]
            raw = self.read(n)
            try:
                return raw.decode("utf-8")
            except UnicodeDecodeError:
                return raw
        if ttype == _STRUCT:
            return self.struct()
        if ttype in (_LIST, _SET):
            etype = self.read(1)[0]
            n = struct.unpack(">i", self.read(4))[0]
            return [self.value(etype) for _ in range(n)]
        if ttype == _MAP:
            ktype = self.read(1)[0]
            vtype = self.read(1)[0]
            n = struct.unpack(">i", self.read(4))[0]
            return {self.value(ktype): self.value(vtype) for _ in range(n)}
        raise ValueError(f"unknown thrift type {ttype}")

    def struct(self) -> dict:
        out = {}
        while True:
            ttype = self.read(1)[0]
            if ttype == _STOP:
                return out
            (fid,) = struct.unpack(">h", self.read(2))
            out[str(fid)] = self.value(ttype)


class ThriftRecordReader(RecordReader):
    """config: ``fieldIdToName`` mapping top-level field ids to row keys."""

    def _iter(self) -> Iterator[dict]:
        names = {str(k): v for k, v in
                 (self.config.get("fieldIdToName") or {}).items()}
        with self._open_binary() as f:
            r = _Reader(f)
            while True:
                first = f.read(1)
                if not first:
                    return
                if first[0] == _STOP:  # empty struct
                    yield {}
                    continue
                (fid,) = struct.unpack(">h", r.read(2))
                row = {str(fid): r.value(first[0])}
                row.update(r.struct())
                yield {names.get(k, k): v for k, v in row.items()}


def write_struct(out: bytearray, fields: dict) -> None:
    """Test/producer helper: TBinaryProtocol-encode {field_id: value}."""
    for fid, v in fields.items():
        fid = int(fid)
        if isinstance(v, bool):
            out += struct.pack(">bhB", _BOOL, fid, 1 if v else 0)
        elif isinstance(v, int):
            out += struct.pack(">bhq", _I64, fid, v)
        elif isinstance(v, float):
            out += struct.pack(">bhd", _DOUBLE, fid, v)
        elif isinstance(v, str):
            raw = v.encode("utf-8")
            out += struct.pack(">bhi", _STRING, fid, len(raw)) + raw
        elif isinstance(v, list):
            out += struct.pack(">bhbi", _LIST, fid, _I64, len(v))
            for x in v:
                out += struct.pack(">q", int(x))
        elif isinstance(v, dict):
            out += struct.pack(">bh", _STRUCT, fid)
            write_struct(out, v)
        else:
            raise TypeError(f"unsupported test value {type(v)}")
    out.append(_STOP)


register_record_reader("thrift", ThriftRecordReader)
