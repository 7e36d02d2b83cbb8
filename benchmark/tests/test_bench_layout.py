"""BENCHMARK.json's names resolve to files of their own: each cell's
configuration, dataset generator, reference and traffic mix, and each
metric's reader. A cell or a metric is added by adding files alone."""

import json
import re

import pytest

from benchmark.core import build, harness, traffic
from benchmark.tests._tiny import ROOT, bench

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_every_name_resolves():
    b = bench()
    for c in b["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert all(k in cfg and k in cfg["reduced"] for k in c["reduced"])
        build.dataset(cfg["dataset"])
        harness.reference_module(cfg["dataset"])
        assert cfg["limits"]["max_rel_gap"] > 0
    for w in b["workloads"]:
        assert any(c["name"] == w["config"] for c in b["configs"])
        assert traffic.load(w["traffic"])["clients"] >= 1
    for m in b["end_to_end"] + b["per_layer"]:
        assert callable(harness.metric_reader(m["name"]))


def test_names_and_lengths():
    b = bench()
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in b[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    assert all(NAME.match(w[k]) for w in b["workloads"]
               for k in ("config", "traffic"))
    assert all(1 <= len(x["why"]) <= 200 for k in ("configs", "workloads")
               for x in b[k])
    assert all(m["moves"] in {e["name"] for e in b["end_to_end"]}
               for m in b["per_layer"])
    assert any(e["name"] == "setup_s" for e in b["end_to_end"])
    assert all(0.01 <= e["bound"] <= 0.25 for e in b["end_to_end"])


@pytest.mark.parametrize("mix", ["ssb_flights", "tpch_pricing"])
def test_every_template_has_a_reference_spec(mix):
    for t in traffic.load(mix)["templates"]:
        assert {"where", "select"} <= set(t["reference"]), t["name"]
        assert t["weight"] >= 1
