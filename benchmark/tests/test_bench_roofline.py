"""The byte count of kernel A and the device readers, on hand-worked
shapes."""

import pytest

from benchmark.core import harness
from benchmark.core.roofline import hbm_bytes_per_s, kernel_a_bytes

H100 = "NVIDIA H100 80GB HBM3"


def test_kernel_a_bytes_one_segment():
    # 1,000 rows: a 4-byte group id and 3 one-byte limbs each; 3 x 10
    # int64 sums out
    assert kernel_a_bytes(1000, 1, 3, 10) == 1000 * 7 + 8 * 3 * 10


def test_kernel_a_bytes_family_counts_rows_not_pad():
    # 16 members of 6,000,000 live rows in 2^23-row pads, P = 6, G = 281
    live = 16 * 6_000_000
    assert kernel_a_bytes(live, 16, 6, 281) == live * 10 + 16 * 8 * 6 * 281
    assert kernel_a_bytes(live, 16, 6, 281) < 16 * (2**23 * 10) \
        + 16 * 8 * 6 * 281


def test_kernel_a_bytes_matches_kernel_bench_arithmetic():
    # kernel_bench.py: n * (4 + P) + 8 * P * G for a segment of n rows
    n, p, g = 2**23, 4, 7001
    assert kernel_a_bytes(n, 1, p, g) == n * (4 + p) + 8 * p * g


class _Run:
    def __init__(self, profile, name=H100):
        self.profile, self.device_name = profile, name


def test_roofline_reader():
    read = harness.metric_reader("kernel_a_roofline")
    # 10 launches of 3.35e9 bytes each in 10 ms of device time: 100 %
    p = {"kernel_a_events": 10, "kernel_a_calls": 10,
         "kernel_a_bytes": 3.35e10, "kernel_a_s": 0.01}
    assert read(_Run(p)) == pytest.approx(100.0)
    # the profiler kept half the launches: the bytes scale to them
    p2 = dict(p, kernel_a_events=5, kernel_a_s=0.01)
    assert read(_Run(p2)) == pytest.approx(50.0)
    assert read(_Run(dict(p, kernel_a_events=0))) is None
    assert read(_Run(p, name="some other card")) is None
    assert read(_Run(None)) is None
    assert hbm_bytes_per_s(H100) == 3.35e12


def test_idle_share_reader():
    read = harness.metric_reader("device_idle_share")
    assert read(_Run({"window_s": 4.0, "busy_s": 1.0})) == pytest.approx(75.0)
    assert read(_Run({"window_s": 4.0, "busy_s": 0.0})) is None


def test_union_of_busy_intervals():
    from benchmark.core.trace import _union

    assert _union([(5, 7), (0, 2), (1, 3), (7, 8)]) == [[0, 3], [5, 8]]


class _Rec:
    def __init__(self, t_done):
        self.t_done = t_done


def test_device_exec_reader():
    read = harness.metric_reader("device_exec_ms")
    run = _Run({"busy_s": 2.0, "t_start": 10.0, "t_stop": 18.0})
    # 4 queries completed inside the stretch, 2 outside, 1 never
    run.records = [_Rec(t) for t in (9.5, 10.0, 12.0, 15.0, 18.0, 18.5)] \
        + [_Rec(None)]
    assert read(run) == pytest.approx(500.0)
    run.records = [_Rec(9.0)]
    assert read(run) is None
    run.profile = None
    assert read(run) is None


def test_reduce_reader():
    read = harness.metric_reader("reduce_ms")
    # 0.3 s in combine and 0.1 s in reduce over 40 reduces: 10 ms a query
    p = {"layers": {"combine": [0.3, 40], "reduce": [0.1, 40],
                    "plan": [5.0, 40]}}
    assert read(_Run(p)) == pytest.approx(10.0)
    assert read(_Run({"layers": {"combine": [0.3, 40]}})) is None
    assert read(_Run(None)) is None
