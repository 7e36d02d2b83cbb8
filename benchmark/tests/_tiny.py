"""Small tables of the benchmark's configurations for the CPU tests."""

import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def bench() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def config(name: str, scale: float = 0.004, segments: int = 2) -> dict:
    entry = next(c for c in bench()["configs"] if c["name"] == name)
    cfg = json.loads((ROOT / entry["file"]).read_text())
    cfg["scale_factor"], cfg["segments"] = scale, segments
    return cfg


def cell(name: str) -> dict:
    return next(w for w in bench()["workloads"] if w["name"] == name)
