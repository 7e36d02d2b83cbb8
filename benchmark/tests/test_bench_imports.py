"""The import checks compare whole top-level names."""

import subprocess
import sys

from benchmark.core import harness
from benchmark.tests._tiny import ROOT


def test_forbidden_by_whole_top_level_name(monkeypatch):
    monkeypatch.setitem(sys.modules, "pinot_tpu_torch_fake", object())
    assert "pinot_tpu" not in harness.forbidden_modules() or \
        "pinot_tpu" in {m.split(".")[0] for m in sys.modules}
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert "jax" in harness.forbidden_modules()


def _loaded(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\nprint(' '.join("
         "sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, check=True)
    return set(out.stdout.split())


def test_reference_loads_nothing_of_the_program():
    mods = _loaded("import benchmark.reference.ssb_flat, "
                   "benchmark.reference.tpch_lineitem, "
                   "benchmark.reference.engine")
    assert not mods & {"pinot_tpu_torch", "pinot_tpu", "jax", "jaxlib",
                       "flax"}, mods


def test_harness_and_port_load_no_jax():
    mods = _loaded("import benchmark.core.harness, benchmark.core.build, "
                   "pinot_tpu_torch.engine.query_executor, "
                   "pinot_tpu_torch.segment.builder")
    assert not mods & {"pinot_tpu", "jax", "jaxlib", "flax"}, mods
    assert "pinot_tpu_torch" in mods
