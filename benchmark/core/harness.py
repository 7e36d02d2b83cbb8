"""One run of one cell: set-up, the measured window, the reference's check.

`run` drives the port through its entry point,
`QueryExecutor(device, backend="device").execute_sql`, from closed-loop
client threads, each sending its next query when the last one returns.
It is the whole of a run except the look for a chip, so the tests drive it
on the CPU at a small size.
"""

from __future__ import annotations

import gc
import importlib.util
import sys
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Optional

from . import build, check, traffic as traffic_mod
from .trace import DeviceProfile, Instruments

BENCH_DIR = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "pinot_tpu")
GRACE_S = 60.0
# the first streams past any client's draw the warm-up queries
WARM_STREAM = 1_000_000
PROFILE_MAX_S = 8.0


@dataclass
class Record:
    client: int
    query: Any
    t_send: float
    t_done: Optional[float] = None
    rows: Optional[list] = None
    error: Optional[str] = None


@dataclass
class RunData:
    """What the metric readers (benchmark/metrics/<name>.py) read."""
    records: list
    seconds: float
    t_start: float
    t_stop: float
    setup_s: float
    profile: Optional[dict]
    device_name: str


def metric_reader(name: str):
    """benchmark/metrics/<name>.py, loaded by its path."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def reference_module(name: str):
    return importlib.import_module(f"benchmark.reference.{name}")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _send(execute, rec: Record) -> None:
    try:
        resp = execute(rec.query.sql)
        if getattr(resp, "exceptions", None):
            rec.error = repr(resp.exceptions)[:300]
        else:
            rec.rows = resp.result_table.rows
    except Exception as e:  # a failed query is counted, never fatal
        rec.error = repr(e)[:300]
    rec.t_done = time.perf_counter()


def warm(execute, traffic: dict, seed: int) -> list:
    """Each template once (its planes uploaded, family stacks built,
    kernels loaded), then one query from every client at once."""
    out = []
    first = traffic_mod.client_queries(traffic, seed, WARM_STREAM)
    n = sum(t["weight"] for t in traffic["templates"])
    for _ in range(n):
        rec = Record(-1, next(first), time.perf_counter())
        _send(execute, rec)
        out.append(rec)
    recs = [Record(-1, next(traffic_mod.client_queries(
        traffic, seed, WARM_STREAM + 1 + c)), 0.0)
        for c in range(traffic["clients"])]
    threads = [threading.Thread(target=_send, args=(execute, r))
               for r in recs]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return out + recs


def closed_loop(execute, traffic: dict, seed: int, seconds: float,
                on_start=None, meanwhile=None):
    """Every client sends its stream's next query when the last returns,
    from t_start until t_stop; queries in flight at t_stop are waited for
    up to GRACE_S. `on_start(t_start, t_stop)` runs before the clients
    go, `meanwhile(t_start, t_stop)` in this thread while they run.
    Returns (records, t_start, t_stop)."""
    records: list = []
    go = threading.Event()
    bounds = {}

    def client(c: int):
        stream = traffic_mod.client_queries(traffic, seed, c)
        go.wait()
        stop = bounds["stop"]
        while time.perf_counter() < stop:
            rec = Record(c, next(stream), 0.0)
            records.append(rec)
            rec.t_send = time.perf_counter()
            _send(execute, rec)

    threads = [threading.Thread(target=client, args=(c,), daemon=True)
               for c in range(traffic["clients"])]
    for t in threads:
        t.start()
    t_start = time.perf_counter()
    bounds["stop"] = t_stop = t_start + seconds
    if on_start is not None:
        on_start(t_start, t_stop)
    go.set()
    if meanwhile is not None:
        meanwhile(t_start, t_stop)
    for t in threads:
        t.join(max(0.0, t_stop + GRACE_S - time.perf_counter()))
    return list(records), t_start, t_stop


def _template_p50(records: list) -> dict:
    by: dict = {}
    for r in records:
        if r.t_done is not None:
            by.setdefault(r.query.template, []).append(
                (r.t_done - r.t_send) * 1e3)
    return {k: sorted(v)[len(v) // 2] for k, v in sorted(by.items())}


def run(cfg: dict, traffic: dict, seed: int, seconds: float, trace: bool,
        device: str, workers: int, t0: float, metrics: list) -> tuple:
    """One run of a cell, its configuration `cfg` under the traffic mix
    `traffic`, reporting `metrics` (BENCHMARK.json entries) with `t0` the
    process's start; returns (the result line's object, details for
    standard error)."""
    import torch

    from pinot_tpu_torch.engine.query_executor import QueryExecutor
    from pinot_tpu_torch.segment.loader import load_segment
    from pinot_tpu_torch.spi.data_types import Schema

    cuda = device.startswith("cuda")
    ds = build.dataset(cfg["dataset"])
    setup = {}
    t = time.perf_counter()
    dirs, rows, timings, ref_data = build.build_table(
        cfg, seed, workers, meanwhile=lambda: ds.reference_data(cfg, seed))
    setup["draw_and_build_s"] = time.perf_counter() - t
    setup.update(timings)
    t = time.perf_counter()
    segments = [load_segment(d) for d in dirs]
    qe = QueryExecutor(device=device, backend="device")
    qe.add_table(Schema.from_json(cfg["schema"]), segments, cfg["table"])
    setup["load_s"] = time.perf_counter() - t
    execute = qe.execute_sql

    t = time.perf_counter()
    warmed = warm(execute, traffic, seed)
    if cuda:
        torch.cuda.synchronize()
    bad_warm = [r.error for r in warmed if r.error]
    if bad_warm:
        raise RuntimeError(f"warm-up queries failed: {bad_warm[:3]}")
    setup["warm_s"] = time.perf_counter() - t
    gc.collect()
    gc.freeze()

    inst = profile = None
    if trace:
        inst = Instruments(rows)
        inst.install()
        if cuda:
            profile = DeviceProfile()
            profile.prime()

    def on_start(t_start, t_stop):
        setup["setup_s"] = t_start - t0

    def profiled(t_start, t_stop):
        # the profiler starts and stops in the thread that set up CUDA
        time.sleep(max(0.0, t_start + 0.25 * seconds - time.perf_counter()))
        profile.start()
        inst.active = True
        time.sleep(min(PROFILE_MAX_S, 0.5 * seconds))
        inst.active = False
        profile.stop()

    from pinot_tpu_torch.engine.oom import oom_stats, reset_oom_stats

    reset_oom_stats()
    records, t_start, t_stop = closed_loop(
        execute, traffic, seed, seconds, on_start,
        profiled if profile is not None else None)
    program = {"oom": oom_stats(), "device_cache": qe.executor.cache.stats()}
    if inst is not None:
        inst.uninstall()
    if cuda:
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    summary = profile.summary(inst) if profile is not None else None
    bad = forbidden_modules()
    if bad:
        raise ImportError(f"modules loaded in the run: {bad}")

    # the program's state goes before the reference runs on the device
    del qe, segments, execute
    gc.unfreeze()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    src = reference_module(cfg["dataset"]).source(cfg, ref_data, device)
    from ..reference.engine import evaluate

    answers: dict = {}

    def answer(q):
        if q.key not in answers:
            answers[q.key] = evaluate(src, q.spec)
        return answers[q.key]

    verdict = check.judge(records, answer, cfg["limits"])
    reference_s = time.perf_counter() - t
    build.remove_table(cfg)

    data = RunData(records, seconds, t_start, t_stop, setup["setup_s"],
                   summary, torch.cuda.get_device_name(device) if cuda
                   else "cpu")
    values = {}
    for m in metrics:
        v = metric_reader(m["name"])(data)
        if v is not None:
            values[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu", "kind": data.device_name,
           "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": verdict["correct"], "attempted": len(records),
              "failed": verdict["failed"], "metrics": values, "device": dev}
    if summary is not None:
        dev["busy_s"] = summary["busy_s"]
        dev["window_s"] = summary["window_s"]
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    result["checks"] = verdict["numbers"]
    detail = {"setup": setup, "reference_s": reference_s,
              "program": program,
              "answers_checked": len(answers),
              "template_p50_ms": _template_p50(records),
              "completed_in_window": sum(
                  1 for r in records
                  if r.t_done is not None and r.t_done <= t_stop),
              "profile": None if summary is None else {
                  k: v for k, v in summary.items()
                  if k.startswith("kernel_a") or k == "layers"}}
    return result, detail
