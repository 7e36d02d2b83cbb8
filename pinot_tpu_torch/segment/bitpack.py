"""Fixed-bit packing of dictionary ids.

The reference stores dict-encoded forward indexes bit-packed at
ceil(log2(cardinality)) bits/value and decodes them with hand-unrolled shift
code (pinot-segment-local/.../io/reader/impl/FixedBitIntReader.java:27,
readUnchecked:44). Here the on-disk format is the same idea (LSB-first packed
bitstream) but decode is a vectorized whole-column operation: the loader
unpacks the full column once into an int32 plane destined for HBM, so there is
no per-lookup decode at query time at all.

`pack` and `unpack` run in the native host library (segment/native_bridge.py,
csrc/host_native.cpp), as the JAX package's do; the numpy versions below run
under PINOT_TPU_DISABLE_NATIVE. Both write and read the same bytes.
"""

from __future__ import annotations

import numpy as np

from . import native_bridge

_CHUNK = 1 << 20  # rows per packing chunk, bounds transient bit-matrix memory


def num_bits_for_cardinality(cardinality: int) -> int:
    """Bits needed to store dict ids in [0, cardinality)."""
    if cardinality <= 1:
        return 1
    return int(cardinality - 1).bit_length()


def pack(values: np.ndarray, num_bits: int) -> np.ndarray:
    """Pack non-negative ints < 2**num_bits into an LSB-first uint8 bitstream."""
    assert 1 <= num_bits <= 32
    if native_bridge.enabled():
        return native_bridge.pack_bits(np.asarray(values), num_bits)
    values = np.ascontiguousarray(values, dtype=np.uint32)
    n = values.shape[0]
    if num_bits == 8:
        return values.astype(np.uint8)
    if num_bits == 16:
        return values.astype(np.uint16).view(np.uint8)
    if num_bits == 32:
        return values.view(np.uint8)
    out = np.empty((n * num_bits + 7) // 8, dtype=np.uint8)
    # Chunk on boundaries where chunk_rows * num_bits is a multiple of 8 so
    # each chunk packs to whole bytes.
    rows_per_chunk = max(8, (_CHUNK // 8) * 8)
    shifts = np.arange(num_bits, dtype=np.uint32)
    pos = 0
    for start in range(0, n, rows_per_chunk):
        chunk = values[start : start + rows_per_chunk]
        bits = ((chunk[:, None] >> shifts) & 1).astype(np.uint8)
        packed = np.packbits(bits.reshape(-1), bitorder="little")
        out[pos : pos + packed.shape[0]] = packed
        pos += packed.shape[0]
    return out[:pos] if pos != out.shape[0] else out


def unpack(data: np.ndarray, num_bits: int, count: int, dtype=np.int32) -> np.ndarray:
    """Unpack `count` values from an LSB-first bitstream produced by pack()."""
    assert 1 <= num_bits <= 32
    if native_bridge.enabled():
        return native_bridge.unpack_bits(np.asarray(data), num_bits, count,
                                         dtype)
    data = np.ascontiguousarray(data, dtype=np.uint8)
    if num_bits == 8:
        return data[:count].astype(dtype)
    if num_bits == 16:
        return data.view(np.uint16)[:count].astype(dtype)
    if num_bits == 32:
        return data.view(np.uint32)[:count].astype(dtype)
    out = np.empty(count, dtype=dtype)
    rows_per_chunk = max(8, (_CHUNK // 8) * 8)
    weights = (np.uint32(1) << np.arange(num_bits, dtype=np.uint32)).astype(np.uint32)
    for start in range(0, count, rows_per_chunk):
        stop = min(start + rows_per_chunk, count)
        bit_lo = start * num_bits
        bit_hi = stop * num_bits
        byte_lo, byte_hi = bit_lo // 8, (bit_hi + 7) // 8
        bits = np.unpackbits(data[byte_lo:byte_hi], bitorder="little")
        bits = bits[bit_lo - byte_lo * 8 : bit_lo - byte_lo * 8 + (stop - start) * num_bits]
        mat = bits.reshape(stop - start, num_bits).astype(np.uint32)
        out[start:stop] = (mat * weights).sum(axis=1).astype(dtype)
    return out


def pack_bitmap(bools: np.ndarray) -> np.ndarray:
    """Dense boolean vector -> packed uint8 bitmap (null vectors, filter masks)."""
    return np.packbits(np.ascontiguousarray(bools, dtype=bool), bitorder="little")


def unpack_bitmap(data: np.ndarray, count: int) -> np.ndarray:
    return np.unpackbits(np.ascontiguousarray(data, dtype=np.uint8), bitorder="little")[:count].astype(bool)
