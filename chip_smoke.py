#!/usr/bin/env python3
"""On-card smoke run of pinot_tpu_torch, the PyTorch/CUDA port.

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py [--seed 2024] [--rows-per-segment 8388608]
                          [--segments 4] [--iters 10]

Phases, each printing one JSON line:
  device   the card, its compute capability and power limit
  build    nvcc builds csrc/*.cu for sm_90a; ptxas register/smem lines
  parity   each CUDA kernel against its plain PyTorch version on the card,
           element-equal int64, at the main path's shapes and at the edges
           of the kernels' domain and geometry: a table split across the
           cluster, G = 32768, unaligned n, n below and at one tile, n = 0,
           and 2^25 + 5 rows of 127 on one group (the sum passes 2^31), also
           with one lone CTA and one lone cluster taking every row
  data     an SSB-shaped table generated from --seed, built into segments
           with the port's builder and loaded with its loader
  queries  q1, q2, q9, q2 unfused and the flagship GROUP BY through
           QueryExecutor(device="cuda").execute_sql, each held against a
           numpy oracle; kernel launch counts of that run
  times    p50 query latency over --iters warm runs
  layers   a warm query's host time split into parse + plan, dispatch,
           collect and combine + reduce
  profile  device busy share and the top device kernels under
           torch.profiler
  geometry each main-path shape's launch geometry and the card's
           cluster occupancy
  kernels  the kernel table: per kernel and main-path shape, the kernel's
           own device time per launch (`ms`, torch.profiler, 20 launches
           rotated over the 4 segments' recorded inputs so that the 50 MB L2
           holds none of them), the wrapper's time with CUDA events around
           the calls (`call_ms`), the bytes bound and its share, the plain
           version's time and one PyTorch library call computing the same
           sums

The line before the last is the kernel table, the last line
{"ok": true, "device": {...}}. Any failure raises and the script exits
non-zero without that line. It exits non-zero at once when no CUDA device
is present or the pinot_tpu_torch package is not beside it.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

DEVICE = "cuda"

# NVIDIA H100 SXM data sheet figures (dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12  # the card's non-tensor-core peak, used for int32 ops

SCHEMA_DIMS = [("d_year", "INT"), ("p_brand", "INT"), ("s_region", "STRING"),
               ("lo_discount", "INT"), ("lo_quantity", "INT"),
               ("lo_orderkey", "INT")]
SCHEMA_METRICS = [("lo_extendedprice", "INT"), ("lo_revenue", "INT")]
RAW_COLUMNS = ["lo_extendedprice", "lo_revenue", "lo_quantity"]
REGIONS = ["AMERICA", "ASIA", "EUROPE", "AFRICA", "MIDDLE EAST"]

Q1 = ("SELECT SUM(lo_extendedprice) FROM ssb WHERE d_year = 1993 "
      "AND lo_discount BETWEEN 1 AND 3 AND lo_quantity < 25")
Q2 = ("SELECT d_year, p_brand, SUM(lo_revenue) FROM ssb "
      "WHERE s_region = 'ASIA' GROUP BY d_year, p_brand LIMIT 10000")
Q9 = ("SELECT d_year, p_brand, SUM(lo_revenue), SUM(lo_extendedprice), "
      "SUM(lo_quantity) FROM ssb WHERE s_region = 'ASIA' "
      "GROUP BY d_year, p_brand LIMIT 10000")
Q2_UNFUSED = "SET useFusedKernel = false; " + Q2
FLAGSHIP = ("SELECT p_brand, SUM(lo_revenue), COUNT(*), MIN(lo_revenue), "
            "MAX(lo_revenue) FROM ssb WHERE d_year >= 1995 "
            "GROUP BY p_brand LIMIT 1000")
QUERIES = {"q1": Q1, "q2": Q2, "q9": Q9, "q2_unfused": Q2_UNFUSED,
           "flagship": FLAGSHIP}
# the kernel each query must launch (q1 is ungrouped: it launches neither)
EXPECTED_KERNEL = {"q2": "fused_limb_sums", "q9": "fused_limb_sums",
                   "q2_unfused": "limb_sums", "flagship": "limb_sums"}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def gen_ssb(rows: int, seed: int) -> dict:
    """The SSB-shaped columns of the JAX package's benchmark (bench.py
    `_gen_ssb`), drawn in the same order from the same generator."""
    rng = np.random.default_rng(seed)
    return {
        "d_year": rng.integers(1992, 1999, rows).astype(np.int32),
        "p_brand": (rng.integers(0, 1000, rows)).astype(np.int32),
        "s_region": np.asarray(REGIONS, dtype=object)[rng.integers(0, 5, rows)],
        "lo_discount": rng.integers(0, 11, rows).astype(np.int32),
        "lo_quantity": rng.integers(1, 51, rows).astype(np.int32),
        "lo_extendedprice": rng.integers(1, 55_001, rows).astype(np.int32),
        "lo_revenue": rng.integers(1, 600_000, rows).astype(np.int32),
        # high-card key sorted in ingestion order, as SSB lineorder arrives
        "lo_orderkey": np.sort(
            rng.integers(0, max(1 << 22, rows // 10), rows)).astype(np.int32),
    }


# -- oracle -------------------------------------------------------------------


def oracle(cols: dict) -> dict:
    """Expected result rows of every query, from the generated columns with
    numpy alone. Group sums come from np.bincount with float64 weights:
    every partial sum is an integer below 2^53, so they are exact."""
    year, brand = cols["d_year"].astype(np.int64), cols["p_brand"].astype(np.int64)
    rev = cols["lo_revenue"].astype(np.int64)
    price = cols["lo_extendedprice"].astype(np.int64)
    qty = cols["lo_quantity"].astype(np.int64)
    out = {}
    m1 = ((year == 1993) & (cols["lo_discount"] >= 1) & (cols["lo_discount"] <= 3)
          & (qty < 25))
    out["q1"] = [[float(price[m1].sum())]]

    asia = cols["s_region"] == "ASIA"
    key = ((year - 1992) * 1000 + brand)[asia]
    cnt = np.bincount(key, minlength=7000)
    sums = [np.bincount(key, weights=v[asia].astype(np.float64), minlength=7000)
            for v in (rev, price, qty)]
    occ = np.nonzero(cnt)[0]
    out["q2"] = [[int(1992 + k // 1000), int(k % 1000), float(sums[0][k])]
                 for k in occ]
    out["q2_unfused"] = out["q2"]
    out["q9"] = [[int(1992 + k // 1000), int(k % 1000), float(sums[0][k]),
                  float(sums[1][k]), float(sums[2][k])] for k in occ]

    mf = year >= 1995
    b, r = brand[mf], rev[mf]
    fcnt = np.bincount(b, minlength=1000)
    fsum = np.bincount(b, weights=r.astype(np.float64), minlength=1000)
    fmin = np.full(1000, np.iinfo(np.int64).max)
    fmax = np.full(1000, np.iinfo(np.int64).min)
    np.minimum.at(fmin, b, r)
    np.maximum.at(fmax, b, r)
    out["flagship"] = [[int(k), float(fsum[k]), int(fcnt[k]), float(fmin[k]),
                        float(fmax[k])] for k in np.nonzero(fcnt)[0]]
    return out


# -- phases -------------------------------------------------------------------


def phase_device(torch) -> dict:
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        raise RuntimeError(f"{name}: compute capability {cap}, need (9, 0)")
    smi = shutil.which("nvidia-smi")
    power = "not measured (nvidia-smi not found)"
    if smi:
        power = subprocess.run(
            [smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip()
    info = {"phase": "device", "name": name, "capability": list(cap),
            "count": torch.cuda.device_count(), "nvidia_smi": power,
            "torch": torch.__version__, "cuda": torch.version.cuda}
    emit(info)
    return info


def phase_build(_cuda) -> None:
    t0 = time.perf_counter()
    _cuda.library()
    lines = [ln.strip() for ln in _cuda.build_log().splitlines()
             if "registers" in ln or "spill" in ln or "smem" in ln
             or ln.startswith("==")]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "ptxas": lines})


def limb_inputs(torch, n, P, G, seed, masked_frac=0.8):
    """Kernel A inputs shaped like the dense path's: ~masked_frac of the
    rows are filtered out, so they carry the trash gid and zero payloads."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    gid = torch.randint(0, max(1, G - 1), (n,), dtype=torch.int32,
                        device=DEVICE, generator=g)
    masked = torch.rand(n, device=DEVICE, generator=g) < masked_frac
    gid[masked] = G - 1
    planes = torch.randint(0, 128, (P, n), dtype=torch.int8, device=DEVICE,
                           generator=g)
    planes[:, masked] = 0
    return planes, gid


def check_equal(torch, name, got, ref) -> int:
    torch.cuda.synchronize()
    if got.shape != ref.shape or got.dtype != ref.dtype:
        raise AssertionError(f"{name}: {got.dtype}{tuple(got.shape)} vs "
                             f"{ref.dtype}{tuple(ref.shape)}")
    err = int((got - ref).abs().max().item()) if got.numel() else 0
    if err != 0:
        raise AssertionError(f"{name}: max |kernel - plain| = {err}")
    return err


def synthetic_fused_cases(torch, fg, seed, n=(1 << 22) + 3):
    """Kernel B cases beyond the main path's plans: an interval term over
    a uint16 plane, a dict-id run term over a uint8 plane, a signed SUM
    (five limbs plus the negative-count plane), and 24 planes of 1001
    groups, at a ragged length."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)

    def rnd(lo, hi, dtype):
        return torch.randint(lo, hi, (n,), dtype=torch.int64, device=DEVICE,
                             generator=g).to(dtype)

    u16, u8 = rnd(0, 2000, torch.uint16), rnd(0, 100, torch.uint8)
    pos, signed = rnd(0, 1 << 20, torch.int32), rnd(-(1 << 30), 1 << 30, torch.int32)
    sc = lambda *v: torch.tensor(v, dtype=torch.int32, device=DEVICE)  # noqa: E731
    sc_n = max(0, n - 5)
    limbs = lambda slot, bits: tuple(("limb", slot, s) for s in range(0, bits, 7))  # noqa: E731
    cases = {
        "interval": (fg.FusedPlan((("iv", 0, 0, 1, True, True),), ((1, 1),),
                                  (("count",),) + limbs(2, 20), (), (0, 1, 2)),
                     (u16, u8, pos), sc(sc_n, 0, 500, 1500), 101),
        "runs": (fg.FusedPlan((("runs", 1, 0, 3),), ((0, 1),),
                              (("count",),) + limbs(2, 20), (), (1, 0, 2)),
                 (u8, u16, pos), sc(n, 0, 2, 5, 9, 9, 20, 40), 2001),
        "signed_sum": (fg.FusedPlan((), ((0, 1),),
                                    (("count",),) + limbs(1, 32) + (("neg", 1),),
                                    (), (0, 1)),
                       (u16, signed), sc(n, 0), 2001),
        "P24_G1001": (fg.FusedPlan((), ((0, 1),),
                                   (("count",),) + limbs(1, 32) + limbs(2, 32)
                                   + limbs(3, 32) + limbs(4, 32)
                                   + (("neg", 1), ("neg", 4)) + limbs(2, 7),
                                   (), (0, 1, 2, 3, 4)),
                      (rnd(0, 1001, torch.uint16), signed, pos, u8.to(torch.int32),
                       signed.flip(0)), sc(n, 0), 1001),
    }
    return {k: (fp, planes, scal, G, n) for k, (fp, planes, scal, G) in cases.items()}


@contextlib.contextmanager
def recording(owner, name):
    """Record the arguments of every call to owner.name (calls go through)."""
    calls = []
    orig = getattr(owner, name)

    def wrapper(*args, **kwargs):
        calls.append(args)
        return orig(*args, **kwargs)

    setattr(owner, name, wrapper)
    try:
        yield calls
    finally:
        setattr(owner, name, orig)


def phase_data(args, torch):
    from pinot_tpu_torch.segment.builder import SegmentBuilder
    from pinot_tpu_torch.segment.loader import load_segment
    from pinot_tpu_torch.spi.data_types import Schema
    from pinot_tpu_torch.spi.table_config import IndexingConfig, TableConfig

    t0 = time.perf_counter()
    rows = args.rows_per_segment * args.segments
    cols = gen_ssb(rows, args.seed)
    t_gen = time.perf_counter() - t0
    schema = Schema.build("ssb", dimensions=SCHEMA_DIMS, metrics=SCHEMA_METRICS)
    cfg = TableConfig(table_name="ssb", indexing=IndexingConfig(
        no_dictionary_columns=RAW_COLUMNS))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    segments = []
    for i in range(args.segments):
        sl = slice(i * args.rows_per_segment, (i + 1) * args.rows_per_segment)
        d = f"{tmp}/ssb_{i}"
        SegmentBuilder(schema, cfg, f"ssb_{i}").build(
            {k: v[sl] for k, v in cols.items()}, d)
        segments.append(load_segment(d))
    setup = time.perf_counter() - t0
    emit({"phase": "data", "rows": rows, "segments": args.segments,
          "rows_per_segment": args.rows_per_segment, "seed": args.seed,
          "generate_s": t_gen, "setup_s": setup, "dir": tmp})
    return schema, segments, cols, tmp


def phase_queries(torch, qe, expected, _cuda):
    """The main path: every query once, counted launches, oracle check."""
    results = {}
    _cuda.reset_launches()
    per_query, cold = {}, {}
    for qname, sql in QUERIES.items():
        before = dict(_cuda.LAUNCHES)
        resident = qe.executor.cache.bytes_used()
        t0 = time.perf_counter()
        resp = qe.execute_sql(sql)
        torch.cuda.synchronize()
        # the first run uploads the planes the query needs and has not
        # found resident yet
        cold[qname] = {"ms": (time.perf_counter() - t0) * 1e3,
                       "uploaded_bytes": qe.executor.cache.bytes_used() - resident}
        per_query[qname] = {k: _cuda.LAUNCHES[k] - before[k] for k in before}
        results[qname] = resp
    launches = dict(_cuda.LAUNCHES)
    for qname, resp in results.items():
        got = sorted(map(tuple, resp.result_table.rows))
        want = sorted(map(tuple, expected[qname]))
        if got != want:
            bad = next((a, b) for a, b in zip(got + [None] * len(want),
                                              want + [None] * len(got))
                       if a != b)
            raise AssertionError(f"{qname}: {len(got)} rows vs oracle "
                                 f"{len(want)}; first difference {bad}")
        kernel = EXPECTED_KERNEL.get(qname)
        if kernel is not None and per_query[qname][kernel] == 0:
            raise AssertionError(f"{qname} did not launch {kernel}")
    for k, v in launches.items():
        if v == 0:
            raise AssertionError(f"the main path never launched {k}")
    emit({"phase": "queries", "rows_checked": {k: len(r.result_table.rows)
                                               for k, r in results.items()},
          "oracle": "equal", "launches": launches,
          "launches_per_query": per_query, "first_run": cold,
          "docs_scanned": {k: r.num_docs_scanned for k, r in results.items()},
          "device_dispatches": {k: r.num_device_dispatches
                                for k, r in results.items()}})
    return launches, per_query


def phase_geometry(torch, _cuda, mxu, fg, recorded) -> None:
    """The launch geometry of each main-path shape, and how many clusters
    of each size the card holds at that shape's shared memory."""
    out = {}
    for qname, recs in recorded.items():
        if qname in ("q2", "q9"):
            fp, planes_in, scalars, G, n = recs[0]
            name, P = "fused_limb_sums", len(fp.planes)
            layout, index = fg.slot_layout(planes_in), scalars.device.index
        else:
            planes, gid, G = recs[0]
            name, (P, n) = "limb_sums", planes.shape
            layout, index = mxu.slot_layout(planes, gid), gid.device.index
        geo = _cuda.geometry_for(name, n, P, G, *layout, index)
        out[qname] = dict(geometry_of(geo), kernel=name, n=n, P=P, G=G,
                          active_clusters={c: _cuda.max_active_clusters(
                              name, c, geo.smem_bytes) for c in (1, 2, 4, 8)})
    emit({"phase": "geometry", "sms": torch.cuda.get_device_properties(0)
          .multi_processor_count, "shapes": out})


def phase_layers(torch, qe, schema, segments, iters, card) -> dict:
    """Where a warm query's time goes, layer by layer, with the host clock:
    parse + plan, dispatch (planes already resident; ends in
    torch.cuda.synchronize(), so it holds the kernels' device time),
    collect (the one device->host copy per segment and the key decode),
    combine + reduce. Medians over `iters` runs."""
    from pinot_tpu_torch.engine.reduce import BrokerReducer
    from pinot_tpu_torch.query.optimizer import optimize_filter
    from pinot_tpu_torch.query.parser.sql import parse_sql

    ex = qe.executor
    out = {}
    for qname, sql in QUERIES.items():
        ts = []
        for _ in range(iters):
            t0 = time.perf_counter()
            query = parse_sql(sql)
            query.filter = optimize_filter(query.filter)
            plans = [ex.plan(query, s) for s in segments]
            t1 = time.perf_counter()
            pending = [ex.dispatch_plan(s, p) for s, p in zip(segments, plans)]
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            inter = [ex.collect(query, s, p, o)
                     for s, p, o in zip(segments, plans, pending)]
            t3 = time.perf_counter()
            BrokerReducer(schema).reduce(query, qe._combine(query, inter))
            t4 = time.perf_counter()
            ts.append([t1 - t0, t2 - t1, t3 - t2, t4 - t3])
        med = np.median(np.asarray(ts), axis=0) * 1e3
        out[qname] = dict(zip(("parse_plan_ms", "dispatch_ms", "collect_ms",
                               "combine_reduce_ms"), map(float, med)))
    emit({"phase": "layers", "card": card, "iters": iters, "layers": out})
    return out


def phase_profile(torch, qe, card) -> dict:
    """Device busy share of warm q2 and flagship runs under torch.profiler:
    the device time of every CUDA kernel over the host wall time, and the
    kernels that take the most of it."""
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for qname in ("q2", "q2_unfused", "flagship"):
        qe.execute_sql(QUERIES[qname])
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(3):
                qe.execute_sql(QUERIES[qname])
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        # device-side events only (kernels and copies): the CPU-side ops
        # that launched them carry the same time again
        device = [(e.key, e.self_device_time_total, e.count)
                  for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and e.self_device_time_total > 0]
        busy_us = sum(d[1] for d in device)
        device.sort(key=lambda d: -d[1])
        out[qname] = {
            "wall_ms_per_query": wall_us / 3e3,
            "device_ms_per_query": busy_us / 3e3 if device else "not measured",
            "device_busy_share": busy_us / wall_us if device else "not measured",
            "top_device": [{"name": k[:60], "ms_per_query": t / 3e3,
                            "calls_per_query": c / 3}
                           for k, t, c in device[:6]]}
    emit({"phase": "profile", "card": card, "profile": out})
    return out


def cuda_ms(torch, fn, iters=20) -> float:
    """Mean time of fn() with CUDA events around `iters` calls, after a
    warm-up: what a caller waits for, the host's launch work included."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fns, kernel, iters=20):
    """The kernel's own device time per launch: torch.profiler's
    self_device_time_total of the CUDA kernel named `kernel`, over `iters`
    calls cycling through `fns` (one per segment's inputs). The profiler
    may drop some of a window's kernel events: the mean is over the events
    it kept, gathered over up to 5 windows until `iters` are in."""
    from torch.profiler import ProfilerActivity, profile

    for fn in fns:
        fn()
    torch.cuda.synchronize()
    total_us, count, seen = 0.0, 0, set()
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for i in range(iters):
                fns[i % len(fns)]()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            if (e.device_type == torch.autograd.DeviceType.CUDA
                    and kernel_name(e.key) == kernel):
                total_us += e.self_device_time_total
                count += e.count
                seen.add(e.key)
        if count >= iters:
            break
    if count < iters:
        raise AssertionError(f"profiler saw {count} launches of {kernel} "
                             f"in 5 windows of {iters}: {sorted(seen)}")
    return total_us / 1e3 / count


def kernel_name(key: str):
    """Which of the port's kernels a profiler event key names, if any."""
    if "fused_limb_sums_kernel" in key:
        return "fused_limb_sums"
    if "limb_sums_kernel" in key:
        return "limb_sums"
    return None


def bound(nbytes: float, ops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def geometry_of(geo) -> dict:
    return {"mode": geo.mode, "cluster": geo.cluster, "clusters": geo.clusters,
            "table_planes": geo.table_planes, "table_groups": geo.table_groups,
            "tile_rows": geo.tile_rows, "stages": geo.stages,
            "stage_bytes": geo.stage_bytes, "smem_bytes": geo.smem_bytes,
            "iters": geo.iters, "tail_rows": geo.tail_rows,
            "warp_agg": geo.warp_agg}


def kernel_row(torch, name, calls, plain, library, nbytes, ops, shape,
               launches, err, note, geo) -> dict:
    """One row of the kernel table; `calls` are the kernel's wrapper calls
    on each segment's recorded inputs."""
    ms = device_ms(torch, calls, name)
    k = iter(range(1 << 30))
    call_ms = cuda_ms(torch, lambda: calls[next(k) % len(calls)]())
    plain_ms = cuda_ms(torch, plain, 5)
    lib_ms = cuda_ms(torch, library, 5)
    bound_ms, by = bound(nbytes, ops)
    src = {"limb_sums": ("pinot_tpu_torch/csrc/limb_sums.cu",
                         "pinot_tpu/ops/mxu_groupby.py:211"),
           "fused_limb_sums": ("pinot_tpu_torch/csrc/fused_limb_sums.cu",
                               "pinot_tpu/ops/fused_groupby.py:314")}[name]
    return {"name": name, "route": "cuda", "source": src[0], "replaces": src[1],
            "launches": launches, "max_abs_err": err, "ms": ms,
            "call_ms": call_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": by, "bound_share": bound_ms / ms,
            "library_ms": lib_ms, "shape": shape, "inputs": note,
            "geometry": geometry_of(geo), "redesigned": "PR 3"}


def kernel_a_row(torch, mxu, _cuda, recs, launches, err, note):
    """Kernel A over the recorded (planes, gid, G) of each segment."""
    planes, gid, G = recs[0]
    P, n = planes.shape
    calls = [lambda r=r: mxu.limb_sums(*r) for r in recs]
    planes64, gid64 = planes.to(torch.int64), gid.to(torch.int64)
    geo = _cuda.geometry_for("limb_sums", n, P, G,
                             *mxu.slot_layout(planes, gid), gid.device.index)
    row = kernel_row(
        torch, "limb_sums", calls, lambda: mxu.limb_sums_plain(planes, gid, G),
        lambda: torch.zeros((P, G), dtype=torch.int64, device=DEVICE
                            ).index_add_(1, gid64, planes64),
        n * (4 + P) + 8 * P * G, n * P, {"n": n, "P": P, "G": G},
        launches, err, note, geo)
    del planes64, gid64
    return row


def fused_cost(fp, planes_in, n, G):
    width = sum(t.element_size() for t in planes_in)
    runs = sum(t[3] if t[0] == "runs" else 1 for t in fp.terms)
    P = len(fp.planes)
    ops = n * (1 + 2 * runs + 2 * len(fp.groups) + 4 * P)
    return n * width + 8 * P * G, ops


def kernel_b_row(torch, fg, _cuda, recs, launches, err, note):
    """Kernel B over the recorded (fp, planes_in, scalars, G, n) of each
    segment."""
    fp, planes_in, scalars, G, n = recs[0]
    calls = [lambda r=r: fg.fused_limb_sums(*r) for r in recs]
    gid64, vals = fg.fused_planes(fp, planes_in, scalars, G, n)
    P = len(fp.planes)
    nbytes, ops = fused_cost(fp, planes_in, n, G)
    geo = _cuda.geometry_for("fused_limb_sums", n, P, G,
                             *fg.slot_layout(planes_in), scalars.device.index)
    row = kernel_row(
        torch, "fused_limb_sums", calls,
        lambda: fg.fused_limb_sums_plain(fp, planes_in, scalars, G, n),
        lambda: torch.zeros((P, G), dtype=torch.int64, device=DEVICE
                            ).index_add_(1, gid64, vals),
        nbytes + 4 * scalars.numel(), ops,
        {"n": n, "P": P, "G": G,
         "slot_bytes_per_row": sum(t.element_size() for t in planes_in)},
        launches, err, note, geo)
    del gid64, vals
    return row


def phase_edges(torch, mxu, fg, geometry, _cuda, seed) -> dict:
    """The kernels at the edges of the new geometry, each element-equal to
    its plain version (or, for the saturation cases, to the exact sum)."""
    out = {}
    one_tile = geometry.tile_rows_for((4, 1, 1))
    for label, (n, P, G) in {"n0": (0, 2, 10), "below_one_tile": (1000, 2, 10),
                             "one_tile": (one_tile, 2, 10),
                             "one_tile_plus_3": (one_tile + 3, 2, 10)}.items():
        planes, gid = limb_inputs(torch, n, P, G, seed)
        out[f"limb_sums/{label}"] = check_equal(
            torch, f"limb_sums {label}", mxu.limb_sums(planes, gid, G),
            mxu.limb_sums_plain(planes, gid, G))

    def only(name, cluster=None):
        return lambda c, smem: (0 if cluster is not None and c != cluster
                                else min(1, _cuda.max_active_clusters(name, c, smem)))

    n = (1 << 25) + 5
    for label, (P, G, occupancy) in {
            "saturation": (1, 1, None),
            "saturation_one_cta": (1, 1, only("limb_sums", 1)),
            "saturation_one_cluster": (8, 7001, only("limb_sums"))}.items():
        planes = torch.full((P, n), 127, dtype=torch.int8, device=DEVICE)
        gid = torch.zeros(n, dtype=torch.int32, device=DEVICE)
        if occupancy is None:
            got = mxu.limb_sums(planes, gid, G)
        else:
            geo = geometry.plan(n, P, G, *mxu.slot_layout(planes, gid),
                                active_clusters=occupancy)
            if geo.iters <= geo.epoch_iters:
                raise AssertionError(f"{label}: no flush mid-run in {geo}")
            got = mxu.launch(planes, gid, G, geo)
        want = torch.zeros((P, G), dtype=torch.int64, device=DEVICE)
        want[:, 0] = 127 * n
        out[f"limb_sums/{label}"] = check_equal(torch, f"limb_sums {label}",
                                                got, want)
        del planes, gid
    u8 = torch.zeros(n, dtype=torch.uint8, device=DEVICE)
    val = torch.full((n,), 127, dtype=torch.int32, device=DEVICE)
    fp = fg.FusedPlan((), ((0, 1),), (("count",), ("limb", 1, 0)), (), (0, 1))
    scal = torch.tensor([n, 0], dtype=torch.int32, device=DEVICE)
    want = torch.tensor([[n], [127 * n]], dtype=torch.int64, device=DEVICE)
    out["fused_limb_sums/saturation"] = check_equal(
        torch, "fused_limb_sums saturation",
        fg.fused_limb_sums(fp, (u8, val), scal, 1, n), want)
    geo = geometry.plan(n, 2, 1, *fg.slot_layout((u8, val)),
                        active_clusters=only("fused_limb_sums", 1))
    out["fused_limb_sums/saturation_one_cta"] = check_equal(
        torch, "fused_limb_sums saturation one CTA",
        fg.launch(fp, (u8, val), scal, 1, geo), want)
    del u8, val
    for label, n in {"n0": 0, "below_one_tile": 1000,
                     "ragged": (1 << 20) + 3}.items():
        fp, planes_in, scal, G, _ = synthetic_fused_cases(torch, fg, seed, n)["interval"]
        out[f"fused_limb_sums/{label}"] = check_equal(
            torch, f"fused_limb_sums {label}",
            fg.fused_limb_sums(fp, planes_in, scal, G, n),
            fg.fused_limb_sums_plain(fp, planes_in, scal, G, n))
    torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=2024)
    ap.add_argument("--rows-per-segment", type=int, default=1 << 23)
    ap.add_argument("--segments", type=int, default=4)
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run "
              "needs an NVIDIA H100", file=sys.stderr)
        return 2
    try:
        from pinot_tpu_torch.engine.query_executor import QueryExecutor
        from pinot_tpu_torch.ops import _cuda, fused_groupby, geometry, mxu_groupby
    except ImportError as e:
        print(f"chip_smoke: the pinot_tpu_torch package is missing ({e}); "
              "run from the repository root", file=sys.stderr)
        return 2

    dev = phase_device(torch)
    phase_build(_cuda)

    # -- parity: each kernel against its plain version, on the card -------
    parity = {}
    for label, (n, P, G) in {"q2_shape": (1 << 23, 4, 7001),
                             "q9_shape": (1 << 23, 8, 7001),
                             "G32768_P1": (1 << 23, 1, 32768),
                             "P24_G128": (1 << 23, 24, 128),
                             "P24_G1001": (1 << 23, 24, 1001),
                             "P16_G32768": (1 << 21, 16, 32768),
                             "ragged_n": ((1 << 23) - 12345, 5, 1001),
                             "G1": (100_003, 3, 1)}.items():
        planes, gid = limb_inputs(torch, n, P, G, args.seed)
        err = check_equal(torch, f"limb_sums {label}",
                          mxu_groupby.limb_sums(planes, gid, G),
                          mxu_groupby.limb_sums_plain(planes, gid, G))
        parity[f"limb_sums/{label}"] = err
        del planes, gid
    for label, (fp, planes_in, scal, G, n) in synthetic_fused_cases(
            torch, fused_groupby, args.seed).items():
        parity[f"fused_limb_sums/{label}"] = check_equal(
            torch, f"fused_limb_sums {label}",
            fused_groupby.fused_limb_sums(fp, planes_in, scal, G, n),
            fused_groupby.fused_limb_sums_plain(fp, planes_in, scal, G, n))
    parity.update(phase_edges(torch, mxu_groupby, fused_groupby, geometry,
                              _cuda, args.seed))
    torch.cuda.empty_cache()

    schema, segments, cols, tmp = phase_data(args, torch)
    try:
        expected = oracle(cols)
        del cols
        qe = QueryExecutor(device=DEVICE)
        qe.add_table(schema, segments)
        launches, per_query = phase_queries(torch, qe, expected, _cuda)

        # the main path's own kernel inputs, one call per segment and query,
        # for the parity over q2/q9's plans and the kernel timings
        recorded = {}
        for qname, owner, fn in (("q2", fused_groupby, "fused_limb_sums"),
                                 ("q9", fused_groupby, "fused_limb_sums"),
                                 ("q2_unfused", mxu_groupby, "limb_sums"),
                                 ("flagship", mxu_groupby, "limb_sums")):
            with recording(owner, fn) as calls:
                qe.execute_sql(QUERIES[qname])
            if len(calls) != len(segments):
                raise AssertionError(f"{qname}: {len(calls)} calls of {fn}")
            recorded[qname] = calls
        for qname in ("q2", "q9"):
            for k, (fp, planes_in, scal, G, n) in enumerate(recorded[qname]):
                parity[f"fused_limb_sums/{qname}_plan/segment{k}"] = check_equal(
                    torch, f"fused_limb_sums {qname} plan, segment {k}",
                    fused_groupby.fused_limb_sums(fp, planes_in, scal, G, n),
                    fused_groupby.fused_limb_sums_plain(fp, planes_in, scal, G, n))
        for qname in ("q2_unfused", "flagship"):
            for k, (planes, gid, G) in enumerate(recorded[qname]):
                parity[f"limb_sums/{qname}_inputs/segment{k}"] = check_equal(
                    torch, f"limb_sums {qname} inputs, segment {k}",
                    mxu_groupby.limb_sums(planes, gid, G),
                    mxu_groupby.limb_sums_plain(planes, gid, G))
        emit({"phase": "parity", "max_abs_err": parity,
              "tolerance": "element-equal int64"})
        phase_geometry(torch, _cuda, mxu_groupby, fused_groupby, recorded)

        # -- times ----------------------------------------------------------
        p50, quartiles = {}, {}
        for qname, sql in QUERIES.items():
            ts = []
            for _ in range(args.iters):
                t0 = time.perf_counter()
                qe.execute_sql(sql)
                torch.cuda.synchronize()
                ts.append((time.perf_counter() - t0) * 1e3)
            p50[qname] = float(np.median(ts))
            quartiles[qname] = [float(q) for q in np.percentile(ts, [25, 75])]
        rows = args.rows_per_segment * args.segments
        emit({"phase": "times", "card": dev["nvidia_smi"],
              "query_p50_ms": p50, "query_p25_p75_ms": quartiles,
              "rows_per_s": {k: rows / (v / 1e3) for k, v in p50.items()},
              "iters": args.iters})
        phase_layers(torch, qe, schema, segments, args.iters, dev["nvidia_smi"])
        phase_profile(torch, qe, dev["nvidia_smi"])
        del qe
        torch.cuda.empty_cache()
        kernels = []
        for qname in ("q2_unfused", "flagship"):
            kernels.append(kernel_a_row(
                torch, mxu_groupby, _cuda, recorded[qname],
                per_query[qname]["limb_sums"],
                parity[f"limb_sums/{qname}_inputs/segment0"],
                f"{qname}: the main path's planes of the {len(segments)} "
                "segments, in turn"))
        for qname in ("q2", "q9"):
            kernels.append(kernel_b_row(
                torch, fused_groupby, _cuda, recorded[qname],
                per_query[qname]["fused_limb_sums"],
                parity[f"fused_limb_sums/{qname}_plan/segment0"],
                f"{qname}: the main path's raw planes of the {len(segments)} "
                "segments, in turn"))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    print(dev["nvidia_smi"], flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": dev["name"],
                                 "count": dev["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
