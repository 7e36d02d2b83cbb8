#!/usr/bin/env python3
"""The control of the comparison that decides `correct`.

The reference, put in the program's place and computed in float32 (the
precision below the exact integer sums and float64 results that the
configurations state), answers the queries a run would check; each answer
is judged against the exact reference as a run's answers are
(core/check.py). A sound limit has this control fail:

    python3 benchmark/control.py --workload <name> --seeds 1,2,3 \
        [--queries 1500] [--device cuda]

prints one JSON line per seed: the control's key mismatches and widest
relative gap beside the configuration's limit. It needs no program and no
measured window: the queries are the first of each client's stream, as
many as `--queries`, over the cell's full-size table.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def control_reading(cfg: dict, mix: dict, seed: int, queries: int,
                    device: str) -> dict:
    from benchmark.core import build, check, harness, traffic
    from benchmark.reference.engine import evaluate

    t0 = time.perf_counter()
    data = build.dataset(cfg["dataset"]).reference_data(cfg, seed)
    src = harness.reference_module(cfg["dataset"]).source(cfg, data, device)
    streams = [traffic.client_queries(mix, seed, c)
               for c in range(mix["clients"])]
    drawn = [next(streams[k % len(streams)]) for k in range(queries)]
    exact, low = {}, {}
    mismatches, widest = 0, 0.0
    for q in drawn:
        if q.key not in exact:
            exact[q.key] = evaluate(src, q.spec)
            low[q.key] = evaluate(src, q.spec, precision="float32")
        ok, gap = check.compare(q.spec, low[q.key], exact[q.key])
        if not ok:
            mismatches += 1
        else:
            widest = max(widest, gap)
    limit = cfg["limits"]["max_rel_gap"]
    return {"seed": seed, "queries": queries, "distinct": len(exact),
            "control_key_mismatches": mismatches,
            "control_max_rel_gap": widest, "limit": limit,
            "control_fails": mismatches > 0 or widest > limit,
            "seconds": time.perf_counter() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--queries", type=int, default=1500)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from benchmark.core import traffic

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next(w for w in bench["workloads"] if w["name"] == args.workload)
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    cfg = json.loads((ROOT / entry["file"]).read_text())
    mix = traffic.load(cell["traffic"])
    for seed in args.seeds.split(","):
        out = control_reading(cfg, mix, int(seed), args.queries, args.device)
        print(json.dumps(dict(out, workload=args.workload)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
