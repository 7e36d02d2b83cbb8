#!/usr/bin/env python3
"""The benchmark of pinot_tpu_torch: one run of one cell on the card.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the H100s the cell asks
for. The cell (BENCHMARK.json `workloads`) names a configuration
(`configs`: its file under benchmark/configs/, whose `dataset` names the
generator in benchmark/datasets/ and the reference in
benchmark/reference/) and a traffic mix (benchmark/traffic/<name>.json).
Each metric is read by benchmark/metrics/<name>.py. A cell, a traffic mix
or a per-layer metric is added by adding those files alone.

Prints, as the last line of standard output, one JSON object: `correct`,
`attempted`, `failed`, `metrics` (the end-to-end metrics, or with
`--trace 1` the per-layer ones), `device`, with `--trace 1` `breakdown`,
and last `checks`, the numbers compared with the reference beside their
limits, which also end standard error. Exits non-zero with no result
without enough CUDA devices, or when jax, jaxlib, flax or pinot_tpu was
loaded.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _fail(msg: str, code: int) -> int:
    print(f"benchmark: {msg}", file=sys.stderr, flush=True)
    return code


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    # the port's libraries load no JAX of their own; keep any that could
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")
    with open(ROOT / "BENCHMARK.json") as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        return _fail(f"no workload {args.workload!r} in BENCHMARK.json", 2)
    cell = cells[args.workload]
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    with open(ROOT / entry["file"]) as f:
        cfg = json.load(f)

    import torch

    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell["chips"]:
        return _fail(f"{cell['chips']} CUDA device(s) needed, "
                     f"{torch.cuda.device_count()} available", 2)

    from benchmark.core import build, harness, traffic

    key = "per_layer" if args.trace else "end_to_end"
    metrics = [m for m in bench[key]
               if args.workload in m.get("workloads", [args.workload])]
    try:
        result, detail = harness.run(
            cfg, traffic.load(cell["traffic"]), args.seed,
            args.seconds, bool(args.trace), "cuda:0",
            build.cpu_workers(), T0, metrics)
    except ImportError as e:
        return _fail(str(e), 3)
    if harness.forbidden_modules():
        return _fail(f"modules loaded: {harness.forbidden_modules()}", 3)
    print(json.dumps({"detail": detail}), file=sys.stderr)
    for name, n in result["checks"].items():
        print(f"check {name} = {n['value']!r} (limit {n['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
