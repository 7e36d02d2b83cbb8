"""Timeseries value model.

The port's copy of pinot_tpu/timeseries/series.py. Reference analogue:
pinot-timeseries-spi's TimeSeries / TimeSeriesBlock /
TimeBuckets (pinot-timeseries/pinot-timeseries-spi/.../series/). A series
is a dense value vector over shared uniform time buckets, keyed by its tag
values; a block is the set of series flowing between plan operators.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np


@dataclass(frozen=True)
class TimeBuckets:
    """Uniform buckets [start, start+step), … covering [start, end]."""

    start: int  # inclusive, in time-column units
    step: int
    num_buckets: int

    @classmethod
    def for_range(cls, start: int, end: int, step: int) -> "TimeBuckets":
        if step <= 0:
            raise ValueError("step must be positive")
        num = max(1, -(-(end - start) // step))
        return cls(start, step, num)

    def edges(self) -> np.ndarray:
        return self.start + self.step * np.arange(self.num_buckets)

    def index_of(self, t) -> np.ndarray:
        return ((np.asarray(t) - self.start) // self.step).astype(np.int64)


@dataclass
class TimeSeries:
    tags: dict  # tag name → value (defines series identity)
    values: np.ndarray  # float64, NaN = no data in bucket

    @property
    def id(self) -> tuple:
        return tuple(sorted(self.tags.items()))

    def label(self) -> str:
        if not self.tags:
            return "*"
        return ",".join(f"{k}={v}" for k, v in sorted(self.tags.items()))


@dataclass
class TimeSeriesBlock:
    buckets: TimeBuckets
    series: list[TimeSeries] = field(default_factory=list)

    def to_json(self) -> dict:
        return {
            "timeBuckets": {"start": self.buckets.start,
                            "step": self.buckets.step,
                            "numBuckets": self.buckets.num_buckets},
            "series": [
                {"tags": s.tags,
                 "values": [None if np.isnan(v) else float(v)
                            for v in s.values]}
                for s in self.series],
        }
