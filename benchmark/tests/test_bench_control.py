"""The control (the reference in float32 in the program's place) fails
the comparison that decides `correct`, at a size a test run holds."""

import pytest

from benchmark.control import control_reading
from benchmark.core import traffic
from benchmark.tests._tiny import config


@pytest.mark.parametrize("name,mix", [("ssb_flat_sf4", "ssb_flights"),
                                      ("tpch_lineitem_sf3", "tpch_pricing")])
@pytest.mark.parametrize("seed", [11, 2**33 + 1])
def test_control_fails(name, mix, seed):
    out = control_reading(config(name, scale=0.02), traffic.load(mix), seed,
                          120, "cpu")
    assert out["control_fails"], out
    assert out["control_max_rel_gap"] > 10 * out["limit"], out
