"""The port's bench gate (pinot_tpu_torch/tools/bench_gate.py) against the
JAX package's (pinot_tpu/tools/bench_gate.py): on every round pair below,
`compare` gives the same report, and `main` the same exit code and output,
as a table and as --json. Every round file is written under tmp_path; no
committed BENCH_*.json is read.
"""

from __future__ import annotations

import copy
import json

import pytest

from pinot_tpu.tools import bench_gate as jax_gate
from pinot_tpu_torch.tools import bench_gate


def _payload(**overrides):
    detail = {
        "q1_filter_sum": {"tpu_p50_s": 0.100, "rows_per_sec": 1e9,
                          "match": True, "iters": 10},
        "q2_groupby": {"tpu_p50_s": 0.200, "rows_per_sec": 5e8,
                       "match": True, "iters": 10},
        "q3_highcard": {"tpu_p50_s": 1.500, "rows_per_sec": 9e7,
                        "match": True, "iters": 3},
    }
    out = {"metric": "x", "value": 1.0, "platform": "tpu", "detail": detail}
    out.update(overrides)
    return out


def _with(doc, cfg, **fields):
    doc = copy.deepcopy(doc)
    doc["detail"][cfg].update(fields)
    return doc


def _without(doc, cfg):
    doc = copy.deepcopy(doc)
    del doc["detail"][cfg]
    return doc


def _wrapper(doc, cut=None):
    """The runner's wrapper around a round: parsed null, the payload the
    last JSON object of the tail (its head cut off at `cut`)."""
    text = json.dumps(doc)
    tail = text[cut:] if cut is not None else "[bench] log {noise}\n" + text
    return {"cmd": "python bench.py", "rc": 0, "parsed": None, "tail": tail}


BASE = _payload()
TIERED = _with(BASE, "q2_groupby", cold_p50_s=0.200, warm_p50_s=0.010,
               warm_match=True)
RT = _with(BASE, "q2_groupby", rt_full_bytes=524_288, rt_delta_bytes=4096,
           rt_warm_bytes=0)
MESH = _with(BASE, "q1_filter_sum", mesh_p50_s=0.05, mesh_devices=4,
             mesh_match=True)
SHAPE8 = _payload(runner={"physicalCores": 8, "logicalCores": 16})
SHAPE1 = _payload(runner={"physicalCores": 1, "logicalCores": 2})

PAIRS = {
    "identical": (BASE, BASE),
    "p50_regression": (BASE, _with(BASE, "q2_groupby", tpu_p50_s=0.260)),
    "p50_improvement": (BASE, _with(_with(BASE, "q1_filter_sum",
                                          tpu_p50_s=0.05),
                                    "q2_groupby", tpu_p50_s=0.1)),
    "match_flip": (BASE, _with(BASE, "q1_filter_sum", tpu_p50_s=0.05,
                               match=False)),
    "missing_config": (BASE, _without(BASE, "q3_highcard")),
    "min_abs_floor": (_with(BASE, "q1_filter_sum", tpu_p50_s=0.0004),
                      _with(BASE, "q1_filter_sum", tpu_p50_s=0.0008)),
    "cross_platform": (BASE, _with(_payload(platform="cpu"), "q2_groupby",
                                   tpu_p50_s=40.0)),
    "wrapper": (_wrapper(BASE), BASE),
    "truncated_tail": (_wrapper(BASE, cut=len(json.dumps(BASE)) // 2), BASE),
    "shuffled_bytes_regression": (
        _with(BASE, "q2_groupby", shuffled_bytes=100_000),
        _with(BASE, "q2_groupby", shuffled_bytes=600_000)),
    "shuffled_bytes_small": (_with(BASE, "q2_groupby", shuffled_bytes=1000),
                             _with(BASE, "q2_groupby", shuffled_bytes=3000)),
    "shuffled_bytes_cross_platform": (
        _with(BASE, "q2_groupby", shuffled_bytes=100_000),
        _with(_payload(platform="cpu"), "q2_groupby",
              shuffled_bytes=600_000)),
    "shuffled_bytes_dropped": (
        _with(BASE, "q2_groupby", shuffled_bytes=600_000), BASE),
    "host_crossings_regression": (
        _with(BASE, "q2_groupby", host_crossings=1),
        _with(BASE, "q2_groupby", host_crossings=3)),
    "host_crossings_cross_platform": (
        _with(BASE, "q2_groupby", host_crossings=1),
        _with(_payload(platform="cpu"), "q2_groupby", host_crossings=3)),
    "host_crossings_dropped": (
        _with(BASE, "q2_groupby", host_crossings=1), BASE),
    "rt_delta_full": (BASE, _with(RT, "q2_groupby", rt_delta_bytes=524_288)),
    "rt_delta_cross_platform": (BASE, _with(
        _payload(platform="cpu"), "q2_groupby", rt_full_bytes=524_288,
        rt_delta_bytes=600_000)),
    "rt_warm_upload": (BASE, _with(RT, "q2_groupby", rt_warm_bytes=2048)),
    "rt_healthy": (RT, RT),
    "rt_delta_growth": (RT, _with(RT, "q2_groupby", rt_delta_bytes=65_536)),
    "rt_dropped": (RT, BASE),
    "tiered_warm_regression": (TIERED, _with(TIERED, "q2_groupby",
                                             warm_p50_s=0.040)),
    "tiered_cold_regression": (TIERED, _with(TIERED, "q2_groupby",
                                             cold_p50_s=0.5)),
    "tiered_warm_match_flip": (TIERED, _with(TIERED, "q2_groupby",
                                             cold_p50_s=0.01,
                                             warm_p50_s=0.002,
                                             warm_match=False)),
    "tiered_cross_platform": (TIERED, _with(
        _payload(platform="cpu"), "q2_groupby", cold_p50_s=2.0,
        warm_p50_s=0.1, warm_match=True)),
    "tiered_dropped": (TIERED, BASE),
    "mesh_regression": (MESH, _with(MESH, "q1_filter_sum", mesh_p50_s=0.2)),
    "mesh_sizes_differ": (MESH, _with(MESH, "q1_filter_sum", mesh_p50_s=0.2,
                                      mesh_devices=8)),
    "mesh_match_flip": (MESH, _with(MESH, "q1_filter_sum",
                                    mesh_match=False)),
    "mesh_dropped": (MESH, BASE),
    "runner_shape_differs": (SHAPE8, _with(SHAPE1, "q2_groupby",
                                           tpu_p50_s=0.8)),
    "runner_shape_match_flip": (SHAPE8, _with(SHAPE1, "q1_filter_sum",
                                              match=False)),
    "runner_shape_same": (SHAPE8, _with(SHAPE8, "q2_groupby",
                                        tpu_p50_s=0.8)),
    "runner_block_missing": (BASE, _with(_payload(
        runner={"physicalCores": 8}), "q2_groupby", tpu_p50_s=0.8)),
}


def _write(tmp_path, name, doc):
    path = tmp_path / name
    path.write_text(json.dumps(doc))
    return str(path)


@pytest.mark.parametrize("pair", sorted(PAIRS))
def test_compare_and_main_equal_the_jax_gate(pair, tmp_path, capsys):
    base, cand = PAIRS[pair]
    a = _write(tmp_path, "base.json", base)
    b = _write(tmp_path, "cand.json", cand)
    loaded = bench_gate.load_round(a), bench_gate.load_round(b)
    assert loaded == (jax_gate.load_round(a), jax_gate.load_round(b))
    for threshold in (0.25, 0.10):
        assert bench_gate.compare(*loaded, threshold=threshold) == \
            jax_gate.compare(*loaded, threshold=threshold)
    for extra in ([], ["--json"], ["--threshold", "0.1", "--min-abs-ms",
                                   "0.1"]):
        rc = bench_gate.main([a, b, *extra])
        out = capsys.readouterr()
        jax_rc = jax_gate.main([a, b, *extra])
        ref = capsys.readouterr()
        assert rc == jax_rc
        assert (out.out, out.err) == (ref.out, ref.err)


def test_listed_pairs_reach_every_verdict(tmp_path):
    """The pairs above pass and fail the gate, warn and salvage."""
    reports = {p: bench_gate.compare(
        bench_gate.load_round(_write(tmp_path, f"{p}_a.json", a)),
        bench_gate.load_round(_write(tmp_path, f"{p}_b.json", b)))
        for p, (a, b) in PAIRS.items()}
    assert reports["identical"]["pass"]
    assert not reports["match_flip"]["pass"]
    assert not reports["runner_shape_match_flip"]["pass"]
    assert reports["runner_shape_differs"]["pass"]
    assert reports["runner_shape_differs"]["warnings"]
    assert bench_gate.load_round(_write(tmp_path, "t.json", PAIRS[
        "truncated_tail"][0])).get("salvaged") is True


def test_unparseable_round_is_a_usage_error(tmp_path, capsys):
    a = _write(tmp_path, "a.json", {"cmd": "x", "tail": "no json here"})
    b = _write(tmp_path, "b.json", BASE)
    assert bench_gate.main([a, b]) == jax_gate.main([a, b]) == 2
    err = capsys.readouterr().err
    assert err.count("bench_gate:") == 2
