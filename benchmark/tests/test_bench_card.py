"""A run of the smallest cell on the card; skips without one."""

import json
import subprocess
import sys

import pytest

from benchmark.tests._tiny import ROOT


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA H100: no CUDA device here")


@pytest.mark.gpu
def test_pricing_run_on_the_card(card):
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "tpch_lineitem_sf3.pricing", "--seed", "2718281828",
         "--seconds", "5", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
    assert list(result)[-1] == "checks"
