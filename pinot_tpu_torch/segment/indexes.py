"""Bloom filter reader, for segment pruning (engine/pruner.py).

The port's own copy of the reader half of pinot_tpu/segment/indexes.py
(`BloomFilter.might_contain`, `_bloom_canon`, `deserialize_bloom`): the
same bit layout and hashes (utils/sketches.hash64_any), so a filter the JAX
builder wrote answers here as it does there. The port's builder writes no
bloom filters. Reference: guava-backed BloomFilterSegmentPruner.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..utils.sketches import hash64_any


@dataclass
class BloomFilter:
    bits: np.ndarray  # packed u8, little-endian bit order
    num_bits: int
    num_hashes: int

    def _positions(self, h: np.ndarray) -> np.ndarray:
        h1 = h & np.uint64(0xFFFFFFFF)
        h2 = h >> np.uint64(32)
        ks = np.arange(self.num_hashes, dtype=np.uint64)
        with np.errstate(over="ignore"):
            return ((h1[:, None] + ks[None, :] * h2[:, None])
                    % np.uint64(self.num_bits)).astype(np.int64)

    def might_contain(self, value) -> bool:
        pos = self._positions(
            hash64_any(_bloom_canon(np.asarray([value])))).ravel()
        return bool(np.all((self.bits[pos >> 3] >> (pos & 7)) & 1))


def _bloom_canon(vals: np.ndarray) -> np.ndarray:
    """Numerics hash as float64, so `WHERE fare = 5` (an int literal) finds
    rows of a DOUBLE column and vice versa."""
    if vals.dtype.kind in ("i", "u", "f", "b"):
        return vals.astype(np.float64)
    return vals


def deserialize_bloom(hdr: np.ndarray, bits: np.ndarray) -> BloomFilter:
    hdr = hdr.view(np.int64)
    return BloomFilter(bits.view(np.uint8), int(hdr[0]), int(hdr[1]))
