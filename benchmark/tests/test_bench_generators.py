"""The generators are functions of the seed alone."""

import numpy as np
import pytest

from benchmark.core import build, traffic
from benchmark.tests._tiny import config

CONFIGS = ["ssb_flat_sf4", "tpch_lineitem_sf3"]


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("seed", [0, 2**31 + 7, 2**40 + 3, -5])
def test_same_seed_same_rows(name, seed):
    cfg = config(name)
    ds = build.dataset(cfg["dataset"])
    a, b = ds.chunk_columns(cfg, seed, 1), ds.chunk_columns(cfg, seed, 1)
    assert a.keys() == b.keys() == set(
        f["name"] for kind in ("dimensionFieldSpecs", "metricFieldSpecs")
        for f in cfg["schema"][kind])
    for k in a:
        assert np.array_equal(a[k], b[k]), k
    ra, rb = ds.reference_data(cfg, seed), ds.reference_data(cfg, seed)
    for k in ra:
        assert np.array_equal(ra[k], rb[k]), k


@pytest.mark.parametrize("name", CONFIGS)
def test_other_seed_other_rows(name):
    cfg = config(name)
    ds = build.dataset(cfg["dataset"])
    a, b = ds.chunk_columns(cfg, 1, 0), ds.chunk_columns(cfg, 2, 0)
    assert any(len(a[k]) != len(b[k]) or not np.array_equal(a[k], b[k])
               for k in a)


@pytest.mark.parametrize("name,row_key", [("ssb_flat_sf4", "datekey"),
                                          ("tpch_lineitem_sf3", "orderdate")])
def test_chunks_cover_the_reference_rows(name, row_key):
    cfg = config(name, segments=3)
    ds = build.dataset(cfg["dataset"])
    rows = sum(len(next(iter(ds.chunk_columns(cfg, 9, i).values())))
               for i in range(3))
    assert rows == len(ds.reference_data(cfg, 9)[row_key])


def test_ssb_domains():
    cfg = config("ssb_flat_sf4", scale=0.02, segments=1)
    cols = build.dataset("ssb_flat").chunk_columns(cfg, 4, 0)
    assert set(cols["c_region"]) <= {"AFRICA", "AMERICA", "ASIA", "EUROPE",
                                     "MIDDLE EAST"}
    assert len(set(cols["p_category"])) == 25
    assert all(len(c) == 10 for c in set(cols["c_city"]))
    assert cols["d_year"].min() >= 1992 and cols["d_year"].max() <= 1998
    assert cols["lo_quantity"].min() >= 1 and cols["lo_quantity"].max() <= 50
    assert np.array_equal(cols["lo_revenue"], cols["lo_extendedprice"] * (
        100 - cols["lo_discount"]) // 100)


@pytest.mark.parametrize("mix", ["ssb_flights", "tpch_pricing"])
def test_traffic_is_seeded_and_sends_every_template_a_round(mix):
    t = traffic.load(mix)
    n = sum(x["weight"] for x in t["templates"])
    a = traffic.client_queries(t, 77, 3)
    b = traffic.client_queries(t, 77, 3)
    first = [next(a) for _ in range(2 * n)]
    assert first == [next(b) for _ in range(2 * n)]
    names = sorted(x["name"] for x in t["templates"] for _ in range(x["weight"]))
    assert sorted(q.template for q in first[:n]) == names
    assert sorted(q.template for q in first[n:]) == names
    other = [next(traffic.client_queries(t, 78, 3)) for _ in range(1)]
    assert all(q.sql.startswith(t["query_prefix"]) for q in first + other)


def test_parameter_kinds():
    r = np.random.default_rng(0)
    p = traffic.draw_params({
        "a": {"int": [3, 3]}, "b": {"choice": [{"x": 1, "y": 2}]},
        "c": {"sample": [5, 6], "names": ["c1", "c2"]},
        "d": {"linear": [["a", 10], ["x", 1]], "plus": -1}}, r)
    assert p["a"] == 3 and p["x"] == 1 and p["y"] == 2
    assert {p["c1"], p["c2"]} == {5, 6}
    assert p["d"] == 30
    assert traffic.render(["{a}", "v{a:02d}", {"k": "{c1}"}], p) == \
        [3, "v03", {"k": p["c1"]}]
