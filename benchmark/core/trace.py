"""What a `--trace 1` run records beside the program's own spans.

Instruments: wrappers installed from the benchmark's side around the calls
into each layer of the port (parse, plan, dispatch, collect, combine,
reduce) and around kernel A's entry (ops/mxu_groupby.limb_sums), recording
host intervals and each launch's shape while a profiled stretch runs.

DeviceProfile: torch.profiler over that stretch. Device activity comes
from the raw Kineto events (every kernel, copy and set on the card,
whichever thread launched it); host intervals are placed on the same clock
through a marker recorded at the stretch's start.
"""

from __future__ import annotations

import time
from collections import defaultdict

from .roofline import kernel_a_bytes

KERNEL_A = "limb_sums_kernel"
SYNC_MARK = "benchmark_clock_mark"


class Instruments:
    """Layer and kernel-A wrappers, recording only while `active`."""

    LAYERS = (("engine.query_executor", "QueryExecutor", "plan_query", "plan"),
              ("engine.query_executor", "QueryExecutor", "dispatch_segments",
               "dispatch"),
              ("engine.query_executor", "QueryExecutor", "collect_segments",
               "collect"),
              ("engine.query_executor", "QueryExecutor", "_combine", "combine"),
              ("engine.reduce", "BrokerReducer", "reduce", "reduce"))

    def __init__(self, segment_rows: list):
        self.segment_rows = sorted(segment_rows)
        self.active = False
        self.spans: list = []      # (layer, t0, t1), perf_counter seconds
        self.launches: list = []   # (t, bytes) of kernel A calls
        self._saved: list = []

    def _timed(self, layer, fn):
        def wrapper(*args, **kwargs):
            if not self.active:
                return fn(*args, **kwargs)
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                self.spans.append((layer, t0, time.perf_counter()))
        return wrapper

    def _kernel_a(self, fn):
        def wrapper(planes, gid, num_segments):
            if self.active:
                family = planes.dim() == 3
                s = planes.shape[0] if family else 1
                p, n = planes.shape[-2], planes.shape[-1]
                live = sum(min(n, r) for r in self.segment_rows[:s])
                self.launches.append((time.perf_counter(),
                                      kernel_a_bytes(live, s, p,
                                                     num_segments)))
            return fn(planes, gid, num_segments)
        return wrapper

    def install(self) -> None:
        import importlib

        from pinot_tpu_torch.engine import query_executor
        from pinot_tpu_torch.ops import mxu_groupby

        for mod, cls, meth, layer in self.LAYERS:
            owner = getattr(importlib.import_module(f"pinot_tpu_torch.{mod}"),
                            cls)
            fn = owner.__dict__[meth]
            self._saved.append((owner, meth, fn))
            setattr(owner, meth, self._timed(layer, fn))
        self._saved.append((query_executor, "parse_sql",
                            query_executor.parse_sql))
        query_executor.parse_sql = self._timed("parse",
                                               query_executor.parse_sql)
        self._saved.append((mxu_groupby, "limb_sums", mxu_groupby.limb_sums))
        mxu_groupby.limb_sums = self._kernel_a(mxu_groupby.limb_sums)

    def uninstall(self) -> None:
        for owner, name, fn in reversed(self._saved):
            setattr(owner, name, fn)
        self._saved.clear()


def _union(intervals: list) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class DeviceProfile:
    """torch.profiler over one stretch of the traced window."""

    def __init__(self):
        self.prof = None
        self.t_sync = self.t_start = self.t_stop = None

    def prime(self) -> None:
        """Start and stop the profiler once, in set-up: the first start in
        a process initialises CUPTI, which takes seconds; later starts take
        milliseconds."""
        self.start()
        self.stop()
        self.prof = None

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.__enter__()
        with record_function(SYNC_MARK):
            self.t_sync = time.perf_counter()
        self.t_start = time.perf_counter()
        self._torch = torch

    def stop(self) -> None:
        self._torch.cuda.synchronize()
        self.t_stop = time.perf_counter()
        self.prof.__exit__(None, None, None)

    def summary(self, inst: Instruments) -> dict:
        """busy_s, window_s, the top device operations and idle gaps by
        the layers the host was in, kernel A's device time and its
        launches' bytes over the stretch, the stretch's bounds on the host
        clock, and each host layer's seconds and calls within it."""
        events = self.prof.profiler.kineto_results.events()
        mark = next(e for e in events if e.name() == SYNC_MARK)
        off = mark.start_ns() - self.t_sync * 1e9
        w0, w1 = self.t_start * 1e9 + off, self.t_stop * 1e9 + off
        busy, by_name = [], defaultdict(float)
        ka_ns, ka_n = 0, 0
        for e in events:
            if e.device_type().name != "CUDA":
                continue
            s, d = e.start_ns(), e.duration_ns()
            if s + d <= w0 or s >= w1:
                continue
            busy.append((max(s, w0), min(s + d, w1)))
            name = e.name()
            by_name[name[:120]] += (min(s + d, w1) - max(s, w0)) / 1e9
            if KERNEL_A in name and "fused" not in name and s >= w0:
                ka_ns += d
                ka_n += 1
        merged = _union(busy)
        busy_ns = sum(e - s for s, e in merged)
        gaps, prev = [], w0
        for s, e in merged:
            if s > prev:
                gaps.append((prev, s))
            prev = e
        if w1 > prev:
            gaps.append((prev, w1))
        # sweep the host layers' intervals and the gaps' midpoints in time
        # order, keeping the layers open at each midpoint
        marks = []
        for layer, t0, t1 in list(inst.spans):
            marks.append((t0 * 1e9 + off, 1, layer))
            marks.append((t1 * 1e9 + off, -1, layer))
        marks += [((s + e) / 2, 2, e - s) for s, e in gaps]
        open_layers, idle = defaultdict(int), defaultdict(float)
        for _t, kind, x in sorted(marks, key=lambda m: (m[0], m[1])):
            if kind == 2:
                active = sorted(k for k, v in open_layers.items() if v > 0)
                idle["+".join(active) or "no query layer"] += x / 1e9
            else:
                open_layers[x] += kind
        calls = [b for t, b in list(inst.launches)
                 if self.t_start <= t < self.t_stop]
        layers: dict = defaultdict(lambda: [0.0, 0])
        for layer, t0, t1 in list(inst.spans):
            if self.t_start <= t0 and t1 <= self.t_stop:
                layers[layer][0] += t1 - t0
                layers[layer][1] += 1
        top = lambda d: [[k, v] for k, v in sorted(  # noqa: E731
            d.items(), key=lambda kv: -kv[1])[:10]]
        return {"window_s": (w1 - w0) / 1e9, "busy_s": busy_ns / 1e9,
                "device_ops": top(by_name), "idle_gaps": top(idle),
                "kernel_a_s": ka_ns / 1e9, "kernel_a_events": ka_n,
                "kernel_a_calls": len(calls),
                "kernel_a_bytes": float(sum(calls)),
                "t_start": self.t_start, "t_stop": self.t_stop,
                "layers": dict(layers)}
