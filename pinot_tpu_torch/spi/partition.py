"""Partition functions: value -> partition id, for partition-based
segment pruning (engine/pruner.py).

The port's own copy of pinot_tpu/spi/partition.py (numpy only, the same
functions and hashes), so the ids it computes equal the ones the JAX
builder stamped into a segment's column metadata. Reference analogue:
pinot-segment-spi/.../spi/partition/ -- PartitionFunction.java,
PartitionFunctionFactory.java:40 (name -> impl), ModuloPartitionFunction,
MurmurPartitionFunction (Kafka's murmur2), HashCodePartitionFunction (Java
hashCode semantics). All functions return non-negative ids in
[0, num_partitions).
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "PartitionFunction",
    "get_partition_function",
    "partition_function_names",
]

_U32 = 0xFFFFFFFF
_I32_MIN = -(1 << 31)


class PartitionFunction:
    """name + num_partitions; ``partition(value)`` maps one value,
    ``partitions_of(values)`` maps a batch (numpy array or list)."""

    name = "base"

    def __init__(self, num_partitions: int):
        if num_partitions <= 0:
            raise ValueError(f"num_partitions must be > 0, got {num_partitions}")
        self.num_partitions = num_partitions

    def partition(self, value) -> int:
        raise NotImplementedError

    def partitions_of(self, values) -> np.ndarray:
        return np.asarray([self.partition(v) for v in values], dtype=np.int32)

    def to_json(self) -> dict:
        return {"functionName": self.name, "numPartitions": self.num_partitions}


class ModuloPartitionFunction(PartitionFunction):
    """Integer values → value mod N, always non-negative (the reference's
    ModuloPartitionFunction.java:47 keeps Java's signed %; we normalize so
    a partition id is always a valid array index)."""

    name = "modulo"

    def partition(self, value) -> int:
        return int(value) % self.num_partitions

    def partitions_of(self, values) -> np.ndarray:
        v = np.asarray(values)
        if v.dtype.kind not in "iu":
            v = np.asarray([int(x) for x in values], dtype=np.int64)
        return (v.astype(np.int64) % self.num_partitions).astype(np.int32)


def _java_string_hash(s: str) -> int:
    """Java String.hashCode: h = 31*h + c over UTF-16 code units, int32
    wraparound."""
    h = 0
    for ch in s:
        o = ord(ch)
        if o >= 0x10000:  # outside BMP → surrogate pair, like Java chars
            o -= 0x10000
            for unit in (0xD800 + (o >> 10), 0xDC00 + (o & 0x3FF)):
                h = (31 * h + unit) & _U32
        else:
            h = (31 * h + o) & _U32
    return h - (1 << 32) if h >= (1 << 31) else h


def _java_hash(value) -> int:
    if isinstance(value, (bool, np.bool_)):
        return 1231 if value else 1237  # Boolean.hashCode
    if isinstance(value, (int, np.integer)):
        v = int(value)
        if _I32_MIN <= v < (1 << 31):
            return v  # Integer.hashCode == the value
        u = v & 0xFFFFFFFFFFFFFFFF
        h = (u ^ (u >> 32)) & _U32  # Long.hashCode
        return h - (1 << 32) if h >= (1 << 31) else h
    if isinstance(value, (float, np.floating)):
        bits = np.float64(value).view(np.uint64)
        h = int(bits ^ (bits >> 32)) & _U32  # Double.hashCode
        return h - (1 << 32) if h >= (1 << 31) else h
    return _java_string_hash(str(value))


class HashCodePartitionFunction(PartitionFunction):
    """abs(java hashCode) % N (HashCodePartitionFunction.java:38; abs of
    Integer.MIN_VALUE stays negative in Java — we fold it to 0 so the id
    is always in range)."""

    name = "hashcode"

    def partition(self, value) -> int:
        h = abs(_java_hash(value))
        if h < 0 or h == (1 << 31):
            h = 0
        return h % self.num_partitions


def _murmur2(data: bytes, seed: int = 0x9747B28C) -> int:
    """MurmurHash2 (32-bit) of the public algorithm, as used by Kafka's
    default partitioner and MurmurPartitionFunction.java:37."""
    m = 0x5BD1E995
    r = 24
    length = len(data)
    h = (seed ^ length) & _U32
    i = 0
    while length - i >= 4:
        k = int.from_bytes(data[i:i + 4], "little")
        k = (k * m) & _U32
        k ^= k >> r
        k = (k * m) & _U32
        h = (h * m) & _U32
        h ^= k
        i += 4
    tail = length - i
    if tail >= 3:
        h ^= data[i + 2] << 16
    if tail >= 2:
        h ^= data[i + 1] << 8
    if tail >= 1:
        h ^= data[i]
        h = (h * m) & _U32
    h ^= h >> 13
    h = (h * m) & _U32
    h ^= h >> 15
    return h


class MurmurPartitionFunction(PartitionFunction):
    """murmur2(utf-8 of the string form) masked to 31 bits, % N — the
    Kafka default-partitioner recipe (hash & 0x7fffffff) so streams
    partitioned by Kafka land where this function says they do."""

    name = "murmur"

    def partition(self, value) -> int:
        if isinstance(value, bytes):
            data = value
        else:
            data = _to_string(value).encode("utf-8")
        return (_murmur2(data) & 0x7FFFFFFF) % self.num_partitions


def _to_string(value) -> str:
    # canonical string forms so ids are stable across int/np.int64/str inputs
    if isinstance(value, (bool, np.bool_)):
        return "true" if value else "false"
    if isinstance(value, (int, np.integer)):
        return str(int(value))
    if isinstance(value, (float, np.floating)):
        f = float(value)
        return str(int(f)) if f.is_integer() else str(f)
    return str(value)


_FUNCTIONS = {
    "modulo": ModuloPartitionFunction,
    "murmur": MurmurPartitionFunction,
    "hashcode": HashCodePartitionFunction,
}


def partition_function_names() -> list[str]:
    return sorted(_FUNCTIONS)


def get_partition_function(name: str, num_partitions: int) -> PartitionFunction:
    """Factory (PartitionFunctionFactory.java:40) — names are
    case-insensitive."""
    cls = _FUNCTIONS.get(name.strip().lower())
    if cls is None:
        raise ValueError(
            f"unknown partition function {name!r}; known: {partition_function_names()}")
    return cls(num_partitions)
