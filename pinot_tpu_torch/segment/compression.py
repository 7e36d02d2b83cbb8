"""Chunk compression of segment buffers.

The port's copy of pinot_tpu/segment/compression.py. Reference:
ChunkCompressionType (pinot-segment-spi/.../compression/
ChunkCompressionType.java:22: PASS_THROUGH / SNAPPY / ZSTANDARD / LZ4 /
GZIP) and the chunked raw forward indexes that use it
(pinot-segment-local/.../io/writer/impl/BaseChunkForwardIndexWriter.java).

Container layout (self-describing, little-endian), the JAX package's byte
for byte:

    magic  b"PTCC"
    u8     codec id
    u8[3]  reserved
    u32    chunk size (uncompressed bytes per chunk)
    u32    num chunks
    u64    total uncompressed size
    u32[n] compressed chunk sizes
    bytes  chunk payloads back-to-back

LZ4 (block format) and Snappy encode and decode in the native host
library (segment/native_bridge.py, csrc/host_native.cpp), so the port's
chunks are the JAX builder's bytes. Under PINOT_TPU_DISABLE_NATIVE they
decode in Python (a stream from either package's builder reads there, match
sequences included) and encode spec-valid literal-only streams. ZSTANDARD
uses the `zstandard` package and raises ImportError where it is missing, as
in the JAX package; GZIP uses zlib.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from . import native_bridge

MAGIC = b"PTCC"
DEFAULT_CHUNK = 1 << 20

CODEC_IDS = {"PASS_THROUGH": 0, "LZ4": 1, "ZSTANDARD": 2, "GZIP": 3,
             "SNAPPY": 4}
CODEC_NAMES = {v: k for k, v in CODEC_IDS.items()}


# -- chunk codecs ------------------------------------------------------------


def _zstd():
    import zstandard

    return zstandard


def _compress_chunk(codec: str, chunk: bytes) -> bytes:
    if codec == "PASS_THROUGH":
        return chunk
    if codec == "LZ4":
        if native_bridge.enabled():
            return native_bridge.lz4_compress(chunk)
        return _lz4_compress_literal(chunk)
    if codec == "SNAPPY":
        if native_bridge.enabled():
            return native_bridge.snappy_compress(chunk)
        return _snappy_compress_literal(chunk)
    if codec == "ZSTANDARD":
        return _zstd().ZstdCompressor(level=3).compress(chunk)
    if codec == "GZIP":
        return zlib.compress(chunk, 6)
    raise ValueError(f"unknown compression codec {codec!r}")


def _decompress_chunk(codec: str, blob: bytes, raw_size: int) -> bytes:
    if codec == "PASS_THROUGH":
        return blob
    if codec == "LZ4":
        if native_bridge.enabled():
            return native_bridge.lz4_decompress(blob, raw_size)
        return lz4_decompress_py(blob, raw_size)
    if codec == "SNAPPY":
        if native_bridge.enabled():
            return native_bridge.snappy_decompress(blob, raw_size)
        return snappy_decompress_py(blob, raw_size)
    if codec == "ZSTANDARD":
        return _zstd().ZstdDecompressor().decompress(
            blob, max_output_size=raw_size)
    if codec == "GZIP":
        return zlib.decompress(blob)
    raise ValueError(f"unknown compression codec {codec!r}")


# -- container ---------------------------------------------------------------


def compress_buffer(data: bytes | np.ndarray, codec: str,
                    chunk_size: int = DEFAULT_CHUNK) -> bytes:
    if isinstance(data, np.ndarray):
        data = data.tobytes()
    codec = codec.upper()
    cid = CODEC_IDS[codec]
    n = len(data)
    num_chunks = max(1, (n + chunk_size - 1) // chunk_size)
    chunks = [
        _compress_chunk(codec, data[i * chunk_size:(i + 1) * chunk_size])
        for i in range(num_chunks)
    ]
    head = MAGIC + struct.pack("<B3xIIQ", cid, chunk_size, num_chunks, n)
    sizes = struct.pack(f"<{num_chunks}I", *(len(c) for c in chunks))
    return head + sizes + b"".join(chunks)


def decompress_buffer(blob: bytes | memoryview | np.ndarray) -> bytes:
    if isinstance(blob, np.ndarray):
        blob = blob.tobytes()
    blob = bytes(blob)
    if blob[:4] != MAGIC:
        raise ValueError("not a PTCC compressed buffer")
    cid, chunk_size, num_chunks, raw_size = struct.unpack_from(
        "<B3xIIQ", blob, 4)
    codec = CODEC_NAMES[cid]
    sizes = struct.unpack_from(f"<{num_chunks}I", blob, 24)
    off = 24 + 4 * num_chunks
    out = []
    remaining = raw_size
    for i, sz in enumerate(sizes):
        this_raw = min(chunk_size, remaining)
        out.append(_decompress_chunk(codec, blob[off:off + sz], this_raw))
        if len(out[-1]) != this_raw:
            raise ValueError(
                f"chunk {i}: decompressed {len(out[-1])} bytes, "
                f"expected {this_raw}")
        off += sz
        remaining -= this_raw
    return b"".join(out)


def _copy_match(out: bytearray, offset: int, length: int) -> None:
    """Append `length` bytes copied from `offset` back. An overlapping
    match (offset < length) repeats its last `offset` bytes, which is what
    a byte-at-a-time copy gives."""
    start = len(out) - offset
    if offset >= length:
        out += out[start:start + length]
    else:
        pattern = bytes(out[start:])
        out += (pattern * (length // offset + 1))[:length]


# -- LZ4 block format --------------------------------------------------------


def lz4_decompress_py(src: bytes, dst_cap: int) -> bytes:
    out = bytearray()
    i, n = 0, len(src)
    while i < n:
        token = src[i]
        i += 1
        lit = token >> 4
        if lit == 15:
            while True:
                b = src[i]
                i += 1
                lit += b
                if b != 255:
                    break
        out += src[i:i + lit]
        i += lit
        if i >= n:
            break
        offset = src[i] | (src[i + 1] << 8)
        i += 2
        if offset == 0 or offset > len(out):
            raise ValueError("corrupt LZ4 stream")
        mlen = token & 15
        if mlen == 15:
            while True:
                b = src[i]
                i += 1
                mlen += b
                if b != 255:
                    break
        _copy_match(out, offset, mlen + 4)
    if len(out) > dst_cap:
        raise ValueError("LZ4 output exceeds expected size")
    return bytes(out)


def _lz4_compress_literal(data: bytes) -> bytes:
    """Spec-valid literals-only LZ4 stream."""
    n = len(data)
    out = bytearray()
    if n < 15:
        out.append(n << 4)
    else:
        out.append(0xF0)
        rest = n - 15
        while rest >= 255:
            out.append(255)
            rest -= 255
        out.append(rest)
    out += data
    return bytes(out)


# -- Snappy ------------------------------------------------------------------


def _uvarint(src: bytes, i: int) -> tuple[int, int]:
    v = shift = 0
    while True:
        b = src[i]
        i += 1
        v |= (b & 0x7F) << shift
        if not b & 0x80:
            return v, i
        shift += 7


def snappy_decompress_py(src: bytes, dst_cap: int) -> bytes:
    expect, i = _uvarint(src, 0)
    if expect > dst_cap:
        raise ValueError("snappy output exceeds expected size")
    out = bytearray()
    n = len(src)
    while i < n:
        tag = src[i]
        i += 1
        kind = tag & 3
        if kind == 0:
            length = (tag >> 2) + 1
            if length > 60:
                extra = length - 60
                length = int.from_bytes(src[i:i + extra], "little") + 1
                i += extra
            out += src[i:i + length]
            i += length
            continue
        if kind == 1:
            length = ((tag >> 2) & 0x7) + 4
            offset = ((tag >> 5) << 8) | src[i]
            i += 1
        elif kind == 2:
            length = (tag >> 2) + 1
            offset = src[i] | (src[i + 1] << 8)
            i += 2
        else:
            length = (tag >> 2) + 1
            offset = int.from_bytes(src[i:i + 4], "little")
            i += 4
        if offset == 0 or offset > len(out):
            raise ValueError("corrupt snappy stream")
        _copy_match(out, offset, length)
    if len(out) != expect:
        raise ValueError("snappy length mismatch")
    return bytes(out)


def _snappy_compress_literal(data: bytes) -> bytes:
    """Spec-valid literals-only Snappy stream."""
    n = len(data)
    out = bytearray()
    v = n
    while True:
        b = v & 0x7F
        v >>= 7
        out.append(b | 0x80 if v else b)
        if not v:
            break
    pos = 0
    while pos < n:
        chunk = min(n - pos, 1 << 24)
        line = chunk - 1
        if line < 60:
            out.append(line << 2)
        elif line < (1 << 8):
            out.append(60 << 2)
            out += line.to_bytes(1, "little")
        elif line < (1 << 16):
            out.append(61 << 2)
            out += line.to_bytes(2, "little")
        else:
            out.append(62 << 2)
            out += line.to_bytes(3, "little")
        out += data[pos:pos + chunk]
        pos += chunk
    return bytes(out)
