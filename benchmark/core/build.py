"""Set-up of a configuration's table: draw its rows and build its segments.

Each segment is one chunk of the dataset's rows, drawn from (seed, chunk)
and built by the port's SegmentBuilder in a spawn worker process, into a
fixed directory under the checkout (benchmark/.cache/segments/<config>),
emptied first: every run draws and builds its table anew, so set-up is the
same work for every seed.
"""

from __future__ import annotations

import importlib
import multiprocessing
import os
import shutil
import time
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

SEGMENT_ROOT = Path(__file__).resolve().parents[1] / ".cache" / "segments"


def dataset(name: str):
    return importlib.import_module(f"benchmark.datasets.{name}")


def build_chunk(job: tuple) -> tuple:
    """Worker: draw chunk i of the config's rows and build its segment in
    `out_dir`; returns (i, rows, seconds drawing, seconds building)."""
    cfg, seed, i, out_dir = job
    from pinot_tpu_torch.segment.builder import SegmentBuilder
    from pinot_tpu_torch.spi.data_types import Schema
    from pinot_tpu_torch.spi.table_config import TableConfig

    t0 = time.perf_counter()
    cols = dataset(cfg["dataset"]).chunk_columns(cfg, seed, i)
    t1 = time.perf_counter()
    SegmentBuilder(Schema.from_json(cfg["schema"]),
                   TableConfig.from_json(cfg["table_config"]),
                   f"{cfg['table']}_{i}").build(cols, out_dir)
    return i, len(next(iter(cols.values()))), t1 - t0, \
        time.perf_counter() - t1


def build_table(cfg: dict, seed: int, workers: int, meanwhile=None,
                root: Path = SEGMENT_ROOT):
    """Build every segment of the config's table in `workers` spawn
    processes, calling `meanwhile()` in this process while they run;
    returns (segment directories in chunk order, per-chunk rows, timings
    with the bytes written, what `meanwhile` returned)."""
    out = root / cfg["name"]
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    chunks = dataset(cfg["dataset"]).num_chunks(cfg)
    dirs = [str(out / f"seg_{i:02d}") for i in range(chunks)]
    t0 = time.perf_counter()
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=max(1, min(workers, chunks)),
                             mp_context=ctx) as pool:
        futures = [pool.submit(build_chunk, (cfg, seed, i, d))
                   for i, d in enumerate(dirs)]
        t1 = time.perf_counter()
        extra = meanwhile() if meanwhile is not None else None
        t2 = time.perf_counter()
        done = [f.result() for f in futures]
    rows = [r for _, r, _, _ in sorted(done)]
    timings = {"build_wall_s": time.perf_counter() - t0,
               "segment_bytes": sum(f.stat().st_size
                                    for f in out.rglob("*") if f.is_file()),
               "meanwhile_s": t2 - t1,
               "draw_cpu_s": sum(d[2] for d in done),
               "build_cpu_s": sum(d[3] for d in done),
               "workers": max(1, min(workers, chunks))}
    return dirs, rows, timings, extra


def remove_table(cfg: dict, root: Path = SEGMENT_ROOT) -> None:
    shutil.rmtree(root / cfg["name"], ignore_errors=True)


def cpu_workers() -> int:
    return len(os.sched_getaffinity(0))
