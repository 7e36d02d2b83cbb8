"""Binary DataTable: the server→broker intermediate wire format.

The port's copy of pinot_tpu/cluster/datatable.py, whole. Its blobs are
byte-identical to the JAX package's for the same intermediate, PTDT and
PTDP alike, so a fleet that mixes the two packages exchanges DataTables
(the RPC frames around them pickle each package's own classes and are
not shared). The PTDP encoder packs with torch ops on the tensors'
device (ops/kernels.py `pack_u8_wire`), float64 in the JAX package's
4-word layout.

Reference: DataTableImplV4 (pinot-core/.../common/datatable/
DataTableImplV4.java:82) — a versioned binary container carrying the
server's combined intermediate plus a metadata map, with a custom object
SerDe for sketch types (ObjectSerDeUtils type ids). The transport used to
pickle intermediates; this module replaces that with an explicit, versioned
contract: tagged scalars, numpy buffers shipped as dtype+shape+raw bytes,
and a type-id registry for the sketch state objects (utils/sketches.py).
No pickle anywhere — every byte on the query data plane is accounted for.

Layout (little-endian):

    magic  b"PTDT"
    u16    version (=2)
    u8     kind    (GroupArrays | GroupByDict | Agg | Selection)
    u32    metadata JSON length, then the JSON (stats map)
    ...    kind-specific payload built from the tagged value encoding
    u32    crc32 of everything above   ┐ integrity trailer, tagged by the
    4s     b"PTcs" trailer magic       ┘ magic (see below)

The integrity trailer is deliberately NOT a header version bump: the
body is self-delimiting, so pre-trailer readers parse it and never look
at the trailing 8 bytes — a new server's payload stays readable by a
previous-release broker mid-rolling-upgrade (tests/test_upgrade_matrix).
New readers detect the trailer by its magic and verify the crc.
"""

from __future__ import annotations

import dataclasses
import json
import struct
import zlib
from typing import Any

import numpy as np

from ..engine.results import (
    AggIntermediate,
    GroupArrays,
    GroupByIntermediate,
    SelectionIntermediate,
)
from ..utils import sketches

MAGIC = b"PTDT"
# v2: groups_trimmed flag on group intermediates
VERSION = 2
# wire-integrity trailer: little-endian crc32 over everything before it,
# tagged by a trailing magic so old readers (which ignore trailing bytes)
# stay compatible. Checked at broker decode — a corrupt payload surfaces
# as DataTableCorruptionError, which the broker reclassifies as a
# connection-level shard failure so replica retry heals it.
TRAILER_MAGIC = b"PTcs"
_TRAILER = struct.Struct("<I4s")

KIND_GROUP_ARRAYS = 0
KIND_GROUP_DICT = 1
KIND_AGG = 2
KIND_SELECTION = 3

# value tags
_T_NONE, _T_BOOL, _T_INT, _T_FLOAT, _T_STR, _T_BYTES = 0, 1, 2, 3, 4, 5
_T_TUPLE, _T_LIST, _T_SET, _T_DICT, _T_NDARRAY, _T_OBJECT = 6, 7, 8, 9, 10, 11
_T_FROZENSET = 12

# sketch/state object registry (reference ObjectSerDeUtils type ids) —
# numpy-field dataclasses encode generically by field
OBJECT_TYPES: dict[int, type] = {
    1: sketches.HyperLogLog,
    2: sketches.ThetaSketch,
    3: sketches.SmartDistinctSet,
    4: sketches.TDigest,
    5: sketches.ValueHist,
}
_OBJECT_IDS = {cls: tid for tid, cls in OBJECT_TYPES.items()}


class DataTableError(ValueError):
    pass


class DataTableCorruptionError(DataTableError):
    """The payload's crc32 trailer (or framing) does not match its bytes:
    wire/memory corruption, not a version or encoding problem."""


# -- tagged value encoding ----------------------------------------------------

# lifetime count of tagged-value encodes (the row-wise wire path). The
# device-packed exchange ships one PTDP blob instead; its perf guard pins
# this counter's delta to ZERO across a packed send.
_ROW_ENCODES = [0]


def row_encodes() -> int:
    return _ROW_ENCODES[0]


def _w_value(out: bytearray, v: Any) -> None:
    _ROW_ENCODES[0] += 1
    if v is None:
        out.append(_T_NONE)
    elif isinstance(v, (bool, np.bool_)):
        out.append(_T_BOOL)
        out.append(1 if v else 0)
    elif isinstance(v, (int, np.integer)):
        out.append(_T_INT)
        b = str(int(v)).encode()  # arbitrary precision (sumprecision)
        out += struct.pack("<I", len(b)) + b
    elif isinstance(v, (float, np.floating)):
        out.append(_T_FLOAT)
        out += struct.pack("<d", float(v))
    elif isinstance(v, str):
        out.append(_T_STR)
        b = v.encode("utf-8")
        out += struct.pack("<I", len(b)) + b
    elif isinstance(v, (bytes, bytearray)):
        out.append(_T_BYTES)
        out += struct.pack("<I", len(v)) + bytes(v)
    elif isinstance(v, tuple):
        out.append(_T_TUPLE)
        out += struct.pack("<I", len(v))
        for x in v:
            _w_value(out, x)
    elif isinstance(v, list):
        out.append(_T_LIST)
        out += struct.pack("<I", len(v))
        for x in v:
            _w_value(out, x)
    elif isinstance(v, frozenset):
        out.append(_T_FROZENSET)
        out += struct.pack("<I", len(v))
        for x in sorted(v, key=repr):
            _w_value(out, x)
    elif isinstance(v, set):
        out.append(_T_SET)
        out += struct.pack("<I", len(v))
        for x in sorted(v, key=repr):
            _w_value(out, x)
    elif isinstance(v, dict):
        out.append(_T_DICT)
        out += struct.pack("<I", len(v))
        for k, x in v.items():
            _w_value(out, k)
            _w_value(out, x)
    elif isinstance(v, np.ndarray):
        out.append(_T_NDARRAY)
        _w_array(out, v)
    elif type(v) in _OBJECT_IDS:
        out.append(_T_OBJECT)
        out.append(_OBJECT_IDS[type(v)])
        fields = [(f.name, getattr(v, f.name))
                  for f in dataclasses.fields(v)]
        _w_value(out, fields)
    else:
        raise DataTableError(
            f"value of type {type(v).__name__} has no wire encoding; "
            f"register it in cluster/datatable.py OBJECT_TYPES")


def _w_array(out: bytearray, a: np.ndarray) -> None:
    if a.dtype.kind == "O":
        out += struct.pack("<B", 1)  # object array: element-tagged
        out += struct.pack("<I", a.size)
        for x in a.reshape(-1):
            _w_value(out, x)
        _w_value(out, list(a.shape))
        return
    a = np.ascontiguousarray(a)
    out += struct.pack("<B", 0)
    ds = a.dtype.str.encode()
    out += struct.pack("<B", len(ds)) + ds
    out += struct.pack("<B", a.ndim)
    for d in a.shape:
        out += struct.pack("<q", d)
    raw = a.tobytes()
    out += struct.pack("<Q", len(raw)) + raw


class _Reader:
    def __init__(self, buf: bytes, pos: int = 0):
        self.buf = buf
        self.pos = pos

    def take(self, n: int) -> bytes:
        b = self.buf[self.pos:self.pos + n]
        if len(b) != n:
            raise DataTableCorruptionError("truncated DataTable")
        self.pos += n
        return b

    def u8(self) -> int:
        return self.take(1)[0]

    def unpack(self, fmt: str):
        size = struct.calcsize(fmt)
        return struct.unpack(fmt, self.take(size))


def _r_value(r: _Reader) -> Any:
    tag = r.u8()
    if tag == _T_NONE:
        return None
    if tag == _T_BOOL:
        return bool(r.u8())
    if tag == _T_INT:
        (n,) = r.unpack("<I")
        return int(r.take(n).decode())
    if tag == _T_FLOAT:
        return r.unpack("<d")[0]
    if tag == _T_STR:
        (n,) = r.unpack("<I")
        return r.take(n).decode("utf-8")
    if tag == _T_BYTES:
        (n,) = r.unpack("<I")
        return r.take(n)
    if tag in (_T_TUPLE, _T_LIST, _T_SET, _T_FROZENSET):
        (n,) = r.unpack("<I")
        items = [_r_value(r) for _ in range(n)]
        if tag == _T_TUPLE:
            return tuple(items)
        if tag == _T_SET:
            return set(items)
        if tag == _T_FROZENSET:
            return frozenset(items)
        return items
    if tag == _T_DICT:
        (n,) = r.unpack("<I")
        return {_r_value(r): _r_value(r) for _ in range(n)}
    if tag == _T_NDARRAY:
        return _r_array(r)
    if tag == _T_OBJECT:
        tid = r.u8()
        cls = OBJECT_TYPES.get(tid)
        if cls is None:
            raise DataTableError(f"unknown object type id {tid}")
        fields = _r_value(r)
        obj = cls.__new__(cls)
        for name, value in fields:
            setattr(obj, name, value)
        return obj
    raise DataTableError(f"unknown value tag {tag}")


def _r_array(r: _Reader) -> np.ndarray:
    is_obj = r.unpack("<B")[0]
    if is_obj:
        (size,) = r.unpack("<I")
        items = [_r_value(r) for _ in range(size)]
        shape = _r_value(r)
        a = np.empty(size, dtype=object)
        a[:] = items
        return a.reshape(shape)
    (dlen,) = r.unpack("<B")
    dtype = np.dtype(r.take(dlen).decode())
    (ndim,) = r.unpack("<B")
    shape = tuple(r.unpack("<q")[0] for _ in range(ndim))
    (rawlen,) = r.unpack("<Q")
    return np.frombuffer(r.take(rawlen), dtype=dtype).reshape(shape).copy()


# -- container ----------------------------------------------------------------


def encode(combined, stats: dict) -> bytes:
    out = bytearray(MAGIC)
    out += struct.pack("<H", VERSION)
    if isinstance(combined, GroupArrays):
        kind = KIND_GROUP_ARRAYS
    elif isinstance(combined, GroupByIntermediate):
        kind = KIND_GROUP_DICT
    elif isinstance(combined, AggIntermediate):
        kind = KIND_AGG
    elif isinstance(combined, SelectionIntermediate):
        kind = KIND_SELECTION
    else:
        raise DataTableError(f"cannot encode {type(combined).__name__}")
    out.append(kind)
    meta = json.dumps(stats).encode()
    out += struct.pack("<I", len(meta)) + meta

    if kind == KIND_GROUP_ARRAYS:
        _w_value(out, list(combined.key_cols))
        _w_value(out, [list(c) for c in combined.state_cols])
        _w_value(out, [list(s) for s in combined.vec_specs])
        _w_value(out, list(combined.fin_tags))
        _w_value(out, combined.num_docs_scanned)
        _w_value(out, bool(combined.groups_trimmed))
    elif kind == KIND_GROUP_DICT:
        _w_value(out, combined.groups)
        _w_value(out, combined.num_docs_scanned)
        _w_value(out, bool(combined.groups_trimmed))
    elif kind == KIND_AGG:
        _w_value(out, list(combined.states))
        _w_value(out, combined.num_docs_scanned)
    else:
        _w_value(out, list(combined.columns))
        _w_value(out, list(combined.rows))
        _w_value(out, combined.num_docs_scanned)
    # integrity trailer: crc32 of every byte before it, plus the magic
    # that lets new readers tell trailered from legacy payloads
    out += _TRAILER.pack(zlib.crc32(out), TRAILER_MAGIC)
    return bytes(out)


def _blob_version(blob: bytes) -> int:
    if blob[:4] != MAGIC:
        raise DataTableError("not a PTDT DataTable")
    if len(blob) < 6:
        raise DataTableCorruptionError("truncated DataTable header")
    return struct.unpack_from("<H", blob, 4)[0]


def _has_trailer(blob: bytes) -> bool:
    return len(blob) >= 6 + _TRAILER.size and blob[-4:] == TRAILER_MAGIC


def verify_blob(blob: bytes) -> bool:
    """Cheap wire-integrity check: True iff the blob frames as a PTDT
    payload whose crc32 trailer (when present) matches — legacy payloads
    without the trailer magic pass, they carry no checksum to verify.
    The broker runs a full decode per scatter RPC before counting the
    response; this is the standalone check for everything else."""
    try:
        _blob_version(blob)
    except DataTableError:
        return False
    if not _has_trailer(blob):
        return True
    want, _ = _TRAILER.unpack_from(blob, len(blob) - _TRAILER.size)
    return zlib.crc32(blob[:-_TRAILER.size]) == want


def decode(blob: bytes):
    """→ (combined_intermediate, stats dict).

    A payload without the trailer magic decodes as a legacy one, and must
    end where its last value ends: bytes left over mean a trailer whose
    magic was damaged (a flipped bit in its last 4 bytes), and raise
    DataTableCorruptionError, where the JAX package decodes such a blob
    as a legacy payload and the damage goes unnoticed."""
    version = _blob_version(blob)
    if not 1 <= version <= VERSION:
        # a NEWER writer (rolling upgrade, new server → old broker) fails
        # loudly; OLDER versions decode below (old server → new broker —
        # the compatibility-verifier guarantee, compCheck.sh analogue)
        raise DataTableError(f"unsupported DataTable version {version}")
    if _has_trailer(blob):
        want, _ = _TRAILER.unpack_from(blob, len(blob) - _TRAILER.size)
        body = blob[:-_TRAILER.size]
        if zlib.crc32(body) != want:
            raise DataTableCorruptionError(
                f"DataTable checksum mismatch (crc32 "
                f"{zlib.crc32(body):08x} != trailer {want:08x})")
        blob = body
    r = _Reader(blob, 6)
    out = _decode_body(r, version)
    if r.pos != len(blob):
        raise DataTableCorruptionError(
            f"{len(blob) - r.pos} bytes past the DataTable's last value "
            "(a damaged trailer)")
    return out


def _decode_body(r: _Reader, version: int):
    kind = r.u8()
    (mlen,) = r.unpack("<I")
    stats = json.loads(r.take(mlen).decode())

    if kind == KIND_GROUP_ARRAYS:
        key_cols = _r_value(r)
        state_cols = _r_value(r)
        vec_specs = _r_value(r)
        fin_tags = [_to_tag(t) for t in _r_value(r)]
        nds = _r_value(r)
        # v1 predates the groups_trimmed flag: absent → not trimmed
        trimmed = _r_value(r) if version >= 2 else False
        return GroupArrays(key_cols, [tuple(c) for c in state_cols],
                           [tuple(s) for s in vec_specs], fin_tags,
                           num_docs_scanned=nds,
                           groups_trimmed=trimmed), stats
    if kind == KIND_GROUP_DICT:
        groups = _r_value(r)
        nds = _r_value(r)
        trimmed = _r_value(r) if version >= 2 else False
        return GroupByIntermediate(groups, num_docs_scanned=nds,
                                   groups_trimmed=trimmed), stats
    if kind == KIND_AGG:
        states = _r_value(r)
        nds = _r_value(r)
        return AggIntermediate(states, num_docs_scanned=nds), stats
    if kind == KIND_SELECTION:
        columns = _r_value(r)
        rows = _r_value(r)
        nds = _r_value(r)
        return SelectionIntermediate(columns, rows, num_docs_scanned=nds), stats
    raise DataTableError(f"unknown DataTable kind {kind}")


def _to_tag(t):
    return tuple(t) if isinstance(t, list) else t


# -- device-packed exchange block (PTDP) --------------------------------------
#
# The MSE cross-server shuffle's fast wire format: every numeric column of
# an exchange block is byte-packed into ONE buffer on the device
# (ops/kernels.pack_u8_wire) of the sending server, so the host path is
# memcpy→socket with zero per-row Python encodes; its caller is the
# cluster MSE's exchange (mse/distributed.py). Its own magic keeps
# it loudly incompatible with the row-wise PTDT container: an old reader
# handed a PTDP blob raises DataTableError instead of misparsing.
#
# Layout (little-endian):
#
#     magic  b"PTDP"
#     u16    version (=1)
#     u32    column-header JSON length, then the JSON
#            {"cols": [{"name", "dtype", "shape"}, ...]}
#     u32    crc32 of the packed payload  ┐ integrity, checked before the
#     u64    payload length               ┘ receiver touches the bytes
#     ...    payload: the packed u8 buffer

PACKED_MAGIC = b"PTDP"
PACKED_VERSION = 1


def packable_block(block: dict) -> bool:
    """True iff every column is a 1-D numeric/bool numpy array — the
    shapes the device pack kernel serializes. Object (string) columns keep
    the row-wise path."""
    return bool(block) and all(
        isinstance(v, np.ndarray) and v.ndim == 1 and v.dtype.kind in "biuf"
        for v in block.values())


def is_packed_blob(blob) -> bool:
    return isinstance(blob, (bytes, bytearray, memoryview)) \
        and bytes(blob[:4]) == PACKED_MAGIC


def encode_packed_block(block: dict, device="cuda") -> bytes:
    """Pack an exchange block into one PTDP blob with the byte pack on
    ``device`` (torch ops: one copy up, one copy of the packed buffer
    down). The only other host work is the header JSON. "cuda", the
    default, raises without an H100-class card; "cpu" packs on the host
    (the tests)."""
    import torch

    from ..ops import _cuda, kernels

    device = torch.device(device)
    if device.type == "cuda":
        _cuda.require_cuda(device)
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {device}")
    cols, arrs = [], []
    for name, v in block.items():
        a = np.ascontiguousarray(v)
        cols.append({"name": name, "dtype": a.dtype.str,
                     "shape": list(a.shape)})
        arrs.append(torch.from_numpy(a).to(device))
    payload = kernels.pack_u8_wire(tuple(arrs)).cpu().numpy().tobytes()
    header = json.dumps({"cols": cols}).encode()
    out = bytearray(PACKED_MAGIC)
    out += struct.pack("<H", PACKED_VERSION)
    out += struct.pack("<I", len(header)) + header
    out += struct.pack("<IQ", zlib.crc32(payload), len(payload))
    out += payload
    return bytes(out)


def decode_packed_block(blob: bytes) -> dict:
    """PTDP blob → column block (zero-copy views over the payload where
    the dtype allows)."""
    from ..ops import kernels

    if bytes(blob[:4]) != PACKED_MAGIC:
        raise DataTableError("not a PTDP packed block")
    (version,) = struct.unpack_from("<H", blob, 4)
    if version != PACKED_VERSION:
        raise DataTableError(
            f"unsupported packed-block version {version}")
    (hlen,) = struct.unpack_from("<I", blob, 6)
    pos = 10
    header = json.loads(bytes(blob[pos:pos + hlen]).decode())
    pos += hlen
    crc, plen = struct.unpack_from("<IQ", blob, pos)
    pos += 12
    payload = bytes(blob[pos:pos + plen])
    if len(payload) != plen:
        raise DataTableCorruptionError("truncated packed block")
    if zlib.crc32(payload) != crc:
        raise DataTableCorruptionError(
            f"packed block checksum mismatch (crc32 "
            f"{zlib.crc32(payload):08x} != header {crc:08x})")
    flat = np.frombuffer(payload, dtype=np.uint8)
    metas = [(np.dtype(c["dtype"]), tuple(c["shape"]))
             for c in header["cols"]]
    arrs = kernels.split_flat_wire(flat, metas)
    return {c["name"]: a for c, a in zip(header["cols"], arrs)}
