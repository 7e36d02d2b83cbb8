"""Mergeable sketch states backing approximate aggregation functions.

The port's own copy of pinot_tpu/utils/sketches.py (plain numpy, no change
of hashing or constants), so that a sketch built by the port from the same
values has the same registers, centroids and estimates as the JAX
package's. Reference: Apache Pinot's approximate aggs delegate to the
DataSketches / stream-lib libraries (DistinctCountHLLAggregationFunction,
PercentileTDigestAggregationFunction,
DistinctCountThetaSketchAggregationFunction); these are direct
implementations. All states are value-based (never dict-id based) so they
merge across segments with different dictionaries.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

# ---------------------------------------------------------------------------
# 64-bit hashing (vectorized splitmix64; strings go through a stable FNV-1a)
# ---------------------------------------------------------------------------

_FNV_OFFSET = np.uint64(0xCBF29CE484222325)
_FNV_PRIME = np.uint64(0x100000001B3)


def hash64_ints(v: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer over int64/float64 bit patterns."""
    with np.errstate(over="ignore"):
        if v.dtype.kind == "f":
            x = v.astype(np.float64).view(np.uint64).copy()
        else:
            x = v.astype(np.int64).view(np.uint64).copy()
        x += np.uint64(0x9E3779B97F4A7C15)
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        x = x ^ (x >> np.uint64(31))
    return x


def _fnv1a(s: str) -> int:
    h = int(_FNV_OFFSET)
    for b in s.encode("utf-8"):
        h = ((h ^ b) * int(_FNV_PRIME)) & 0xFFFFFFFFFFFFFFFF
    return h


def hash64_any(values) -> np.ndarray:
    """Hash arbitrary python/numpy values to uint64."""
    arr = np.asarray(values)
    if arr.dtype.kind in ("i", "u", "f", "b"):
        return hash64_ints(arr.astype(np.int64) if arr.dtype.kind in ("b",) else arr)
    # strings / objects: FNV then splitmix finalize
    h = np.fromiter((_fnv1a(str(x)) for x in arr.ravel()), dtype=np.uint64, count=arr.size)
    return hash64_ints(h.view(np.int64))


# ---------------------------------------------------------------------------
# HyperLogLog
# ---------------------------------------------------------------------------


@dataclass
class HyperLogLog:
    """Dense HLL. log2m=12 matches the reference default
    (CommonConstants.Helix.DEFAULT_HYPERLOGLOG_LOG2M = 12)."""

    log2m: int = 12
    registers: np.ndarray = None  # uint8[m]

    def __post_init__(self):
        if self.registers is None:
            self.registers = np.zeros(1 << self.log2m, dtype=np.uint8)

    def add_hashes(self, h: np.ndarray) -> "HyperLogLog":
        m = 1 << self.log2m
        idx = (h & np.uint64(m - 1)).astype(np.int64)
        rest = h >> np.uint64(self.log2m)
        # rho = leading position of first set bit in remaining 64-log2m bits
        nbits = 64 - self.log2m
        rho = np.full(len(h), nbits + 1, dtype=np.uint8)
        found = np.zeros(len(h), dtype=bool)
        for bit in range(nbits):
            hit = ~found & ((rest >> np.uint64(bit)) & np.uint64(1)).astype(bool)
            rho[hit] = bit + 1
            found |= hit
        np.maximum.at(self.registers, idx, rho)
        return self

    def add_values(self, values) -> "HyperLogLog":
        if len(values):
            self.add_hashes(hash64_any(values))
        return self

    def merge(self, other: "HyperLogLog") -> "HyperLogLog":
        if self.log2m != other.log2m:
            raise ValueError("HLL log2m mismatch")
        return HyperLogLog(self.log2m, np.maximum(self.registers, other.registers))

    def cardinality(self) -> int:
        m = 1 << self.log2m
        inv = np.power(2.0, -self.registers.astype(np.float64))
        est = (0.7213 / (1 + 1.079 / m)) * m * m / inv.sum()
        zeros = int((self.registers == 0).sum())
        if est <= 2.5 * m and zeros:
            est = m * math.log(m / zeros)  # linear counting
        return int(round(est))


# ---------------------------------------------------------------------------
# Theta sketch (KMV — k minimum hash values)
# ---------------------------------------------------------------------------


@dataclass
class ThetaSketch:
    k: int = 4096
    hashes: np.ndarray = None  # sorted uint64, len<=k

    def __post_init__(self):
        if self.hashes is None:
            self.hashes = np.empty(0, dtype=np.uint64)

    def add_values(self, values) -> "ThetaSketch":
        if not len(values):
            return self
        h = np.unique(hash64_any(values))
        self.hashes = np.unique(np.concatenate([self.hashes, h]))[: self.k]
        return self

    def merge(self, other: "ThetaSketch") -> "ThetaSketch":
        merged = np.unique(np.concatenate([self.hashes, other.hashes]))[: max(self.k, other.k)]
        return ThetaSketch(max(self.k, other.k), merged)

    def cardinality(self) -> int:
        n = len(self.hashes)
        if n < self.k:
            return n
        theta = float(self.hashes[self.k - 1]) / float(1 << 64)
        return int(round((self.k - 1) / theta))


# ---------------------------------------------------------------------------
# Smart distinct set (exact set until threshold, then HLL) — reference
# DistinctCountSmartHLLAggregationFunction
# ---------------------------------------------------------------------------


@dataclass
class SmartDistinctSet:
    threshold: int = 100_000
    exact: frozenset = frozenset()
    hll: HyperLogLog = None

    def add_values(self, values) -> "SmartDistinctSet":
        if self.hll is not None:
            self.hll.add_values(values)
            return self
        self.exact = self.exact | frozenset(np.asarray(values).tolist())
        self._maybe_degrade()
        return self

    def _maybe_degrade(self):
        if self.hll is None and len(self.exact) > self.threshold:
            self.hll = HyperLogLog().add_values(list(self.exact))
            self.exact = frozenset()

    def merge(self, other: "SmartDistinctSet") -> "SmartDistinctSet":
        out = SmartDistinctSet(self.threshold)
        if self.hll is None and other.hll is None:
            out.exact = self.exact | other.exact
            out._maybe_degrade()
            return out
        h = HyperLogLog()
        h = h.merge(self.hll) if self.hll is not None else h.add_values(list(self.exact))
        h = h.merge(other.hll) if other.hll is not None else h.add_values(list(other.exact))
        out.hll = h
        return out

    def cardinality(self) -> int:
        return self.hll.cardinality() if self.hll is not None else len(self.exact)


# ---------------------------------------------------------------------------
# t-digest (merging variant; accepts weighted points so device histograms
# convert losslessly into centroids)
# ---------------------------------------------------------------------------


@dataclass
class TDigest:
    compression: float = 100.0
    means: np.ndarray = None
    weights: np.ndarray = None

    def __post_init__(self):
        if self.means is None:
            self.means = np.empty(0, dtype=np.float64)
            self.weights = np.empty(0, dtype=np.float64)

    def add_weighted(self, means, weights) -> "TDigest":
        means = np.asarray(means, dtype=np.float64)
        weights = np.asarray(weights, dtype=np.float64)
        keep = weights > 0
        self.means = np.concatenate([self.means, means[keep]])
        self.weights = np.concatenate([self.weights, weights[keep]])
        self._compress()
        return self

    def add_values(self, values) -> "TDigest":
        values = np.asarray(values, dtype=np.float64)
        return self.add_weighted(values, np.ones(len(values)))

    def merge(self, other: "TDigest") -> "TDigest":
        out = TDigest(max(self.compression, other.compression))
        out.means = np.concatenate([self.means, other.means])
        out.weights = np.concatenate([self.weights, other.weights])
        out._compress()
        return out

    def _compress(self):
        if len(self.means) <= self.compression * 2:
            if len(self.means) and not np.all(np.diff(self.means) >= 0):
                order = np.argsort(self.means, kind="stable")
                self.means, self.weights = self.means[order], self.weights[order]
            return
        order = np.argsort(self.means, kind="stable")
        means, weights = self.means[order], self.weights[order]
        total = weights.sum()
        # k1 scale function: centroids sized by quantile-dependent capacity
        out_m, out_w = [], []
        cur_m, cur_w = means[0], weights[0]
        cum = 0.0
        c = self.compression
        for m, w in zip(means[1:], weights[1:]):
            q = (cum + cur_w / 2) / total
            cap = 4 * total * q * (1 - q) / c + 1e-9
            if cur_w + w <= cap:
                cur_m = (cur_m * cur_w + m * w) / (cur_w + w)
                cur_w += w
            else:
                out_m.append(cur_m)
                out_w.append(cur_w)
                cum += cur_w
                cur_m, cur_w = m, w
        out_m.append(cur_m)
        out_w.append(cur_w)
        self.means = np.asarray(out_m)
        self.weights = np.asarray(out_w)

    def quantile(self, q: float) -> float:
        if not len(self.means):
            return math.nan
        if len(self.means) == 1:
            return float(self.means[0])
        total = self.weights.sum()
        target = q * total
        cum = np.cumsum(self.weights) - self.weights / 2
        if target <= cum[0]:
            return float(self.means[0])
        if target >= cum[-1]:
            return float(self.means[-1])
        i = np.searchsorted(cum, target) - 1
        t = (target - cum[i]) / (cum[i + 1] - cum[i])
        return float(self.means[i] + t * (self.means[i + 1] - self.means[i]))


# ---------------------------------------------------------------------------
# Exact weighted value histogram (value → count). Backs exact PERCENTILE /
# MODE / DISTINCT* group-by states produced by the device value_hist kernel.
# ---------------------------------------------------------------------------


@dataclass
class ValueHist:
    counts: dict = field(default_factory=dict)  # value → int count

    @staticmethod
    def from_arrays(values, counts) -> "ValueHist":
        vh = ValueHist()
        for v, c in zip(np.asarray(values), np.asarray(counts)):
            if c > 0:
                key = v.item() if isinstance(v, np.generic) else v
                vh.counts[key] = vh.counts.get(key, 0) + int(c)
        return vh

    @staticmethod
    def from_values(values) -> "ValueHist":
        u, c = np.unique(np.asarray(values), return_counts=True)
        return ValueHist.from_arrays(u, c)

    def merge(self, other: "ValueHist") -> "ValueHist":
        out = ValueHist(dict(self.counts))
        for v, c in other.counts.items():
            out.counts[v] = out.counts.get(v, 0) + c
        return out

    @property
    def total(self) -> int:
        return sum(self.counts.values())

    def percentile(self, pct: float) -> float:
        """Reference PercentileAggregationFunction semantics: element at
        index floor(n * pct / 100) of the sorted multiset (clamped)."""
        n = self.total
        if n == 0:
            return math.nan
        rank = min(int(n * pct / 100.0), n - 1)
        for v in sorted(self.counts):
            rank -= self.counts[v]
            if rank < 0:
                return float(v)
        return math.nan  # pragma: no cover

    def mode(self) -> float:
        """Max-frequency value; ties resolve to the smallest value."""
        if not self.counts:
            return math.nan
        best_v, best_c = None, -1
        for v in sorted(self.counts):
            if self.counts[v] > best_c:
                best_v, best_c = v, self.counts[v]
        return float(best_v)

    def to_tdigest(self, compression: float = 100.0) -> TDigest:
        vals = np.asarray(sorted(self.counts), dtype=np.float64)
        w = np.asarray([self.counts[v] for v in sorted(self.counts)], dtype=np.float64)
        return TDigest(compression).add_weighted(vals, w)
