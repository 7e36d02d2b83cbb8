"""The 50th percentile (linear interpolation) of the latency of every query
sent in the window, over all of them (metrics/_latency.py)."""

from benchmark.metrics._latency import percentile


def read(run):
    return percentile(run, 50)
