"""Timeseries engine: time-bucketed series queries over OLAP tables.

The port of pinot_tpu/timeseries/. Reference analogue: pinot-timeseries/
(SPI + planner) with the m3ql language plugin (pinot-plugins/
pinot-timeseries-lang/pinot-timeseries-m3ql/) and the broker's
TimeSeriesRequestHandler. The leaf fetch compiles onto the single-stage
engine as a time-bucketed group-by, so it rides the same device kernels
as SQL (kernel A over a batch family, kernel B on a lone segment), and
the series combinators run vectorized in numpy on the host.
"""

from .series import TimeBuckets, TimeSeries, TimeSeriesBlock
from .engine import TimeSeriesEngine

__all__ = ["TimeSeries", "TimeSeriesBlock", "TimeBuckets", "TimeSeriesEngine"]
