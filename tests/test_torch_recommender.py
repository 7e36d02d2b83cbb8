"""The port's config recommender against the JAX package's.

Cases from `tests/test_recommender.py`: `analyze_queries` over a weighted
query sample, `recommend` over it with the sample's cardinalities, the
same over pre-aggregated pattern stats and over edge inputs (no queries,
unparseable SQL, OR / NOT / IN / range filters, transforms), and the
traffic a port broker's WorkloadTracker observed fed through
`recommender_input` into the port's recommender and into the JAX
package's. The schemas are built by each package's own Schema from the
same field list. Tolerance: exact (the frequencies are the same floats).
"""

from __future__ import annotations

import pytest

from _torch_ops import (BOTH, JAX, PORT, Cluster, build_segments,
                        reset_process_state)
from pinot_tpu.spi.data_types import Schema as JSchema
from pinot_tpu_torch.spi.data_types import Schema as PSchema

FIELDS = dict(
    dimensions=[("country", "STRING"), ("userId", "STRING"),
                ("url", "STRING"), ("device", "STRING")],
    metrics=[("views", "LONG"), ("cost", "DOUBLE")],
    date_times=[("ts", "TIMESTAMP")])
SCHEMAS = {"port": PSchema.build("clicks", **FIELDS),
           "jax": JSchema.build("clicks", **FIELDS)}

QUERIES = [
    {"sql": "SELECT COUNT(*) FROM clicks WHERE country = 'us'", "freq": 5},
    {"sql": "SELECT SUM(views) FROM clicks WHERE country = 'uk' AND "
            "ts > 1000", "freq": 2},
    {"sql": "SELECT device, SUM(views), SUM(cost) FROM clicks "
            "GROUP BY device", "freq": 4},
    {"sql": "SELECT COUNT(*) FROM clicks WHERE userId = 'u1'", "freq": 1},
]
CARDS = {"country": 200, "userId": 5_000_000, "url": 9_000_000,
         "device": 12, "ts": 8_000_000}

EDGE_SAMPLES = [
    [],
    [{"sql": "this is not sql", "freq": 3},
     {"sql": "SELECT COUNT(*) FROM clicks WHERE device IN ('a', 'b')"}],
    [{"sql": "SELECT url, COUNT(*) FROM clicks WHERE country <> 'x' OR "
             "NOT (device = 'd') GROUP BY url", "freq": 2.5},
     {"sql": "SELECT MAX(cost) FROM clicks WHERE ts BETWEEN 1 AND 9 AND "
             "views >= 10", "freq": 0.5},
     {"sql": "SELECT COUNT(*) FROM clicks WHERE UPPER(country) = 'US'"}],
]


@pytest.fixture(scope="module", autouse=True)
def _module_hygiene():
    reset_process_state()
    yield
    reset_process_state()


def _both(fn):
    return {pkg.name: fn(pkg, SCHEMAS[pkg.name]) for pkg in BOTH}


def test_analyze_queries_matches():
    got = _both(lambda pkg, _s: pkg.recommender.analyze_queries(QUERIES))
    assert got["port"] == got["jax"]
    assert got["port"]["eq_filters"]["country"] == pytest.approx(7 / 12)
    assert "sum(views)" in got["port"]["aggregations"]


@pytest.mark.parametrize("sample", range(len(EDGE_SAMPLES)))
def test_analyze_queries_edge_inputs(sample):
    got = _both(lambda pkg, _s: pkg.recommender.analyze_queries(
        EDGE_SAMPLES[sample]))
    assert got["port"] == got["jax"]


def test_recommendations_match():
    got = _both(lambda pkg, s: pkg.recommender.recommend(
        s, queries=QUERIES, cardinalities=CARDS, num_rows=10_000_000,
        qps=50).to_json())
    assert got["port"] == got["jax"]
    idx = got["port"]["tableIndexConfig"]
    assert idx["sortedColumn"] == "country"
    assert idx["noDictionaryColumns"] == ["url"]
    assert idx["starTreeIndexConfigs"][0]["dimensionsSplitOrder"] == \
        ["device"]
    assert got["port"]["partitionColumn"] == "country"


@pytest.mark.parametrize("num_rows,qps", [(1000, 1.0), (50_000, 10.0),
                                          (10_000_000, 500.0)])
def test_recommendations_over_pattern_stats(num_rows, qps):
    stats = {"eq_filters": {"country": 0.2, "userId": 0.5, "device": 0.04},
             "range_filters": {"ts": 0.3, "views": 0.01},
             "group_by": {"device": 0.6, "country": 0.35},
             "aggregations": ["count(*)", "sum(cost)"]}
    got = _both(lambda pkg, s: pkg.recommender.recommend(
        s, query_stats=stats, cardinalities=CARDS, num_rows=num_rows,
        qps=qps).to_json())
    assert got["port"] == got["jax"]


@pytest.mark.parametrize("sample", range(len(EDGE_SAMPLES)))
def test_recommendations_over_edge_inputs(sample):
    got = _both(lambda pkg, s: pkg.recommender.recommend(
        s, queries=EDGE_SAMPLES[sample]).to_json())
    assert got["port"] == got["jax"]


def test_observed_traffic_feeds_the_recommender(tmp_path, monkeypatch):
    """A port broker's workload rollup, through `recommender_input`, gives
    the same recommendation in both packages' recommenders."""
    monkeypatch.setenv("PINOT_TPU_RESULT_CACHE", "0")
    c = Cluster(PORT, n_servers=1)
    try:
        c.table(build_segments(tmp_path, n=2, rows=500))
        for sql, n in (("SELECT COUNT(*) FROM ops WHERE team = 'BOS'", 3),
                       ("SELECT year, SUM(runs) FROM ops GROUP BY year", 2),
                       ("SELECT COUNT(*) FROM ops WHERE year > 2004", 1)):
            for _ in range(n):
                assert not c.broker.execute_sql(sql).exceptions
        body = c.broker.workload.recommender_input("ops")
        schema = c.store.get("/SCHEMAS/ops")
    finally:
        c.close()
    assert len(body["queries"]) == 3
    recs = {pkg.name: pkg.recommender.recommend(
        (PSchema if pkg is PORT else JSchema).from_json(schema),
        queries=body["queries"], cardinalities={"team": 4, "year": 10},
        num_rows=1000, qps=body["qps"]).to_json() for pkg in (PORT, JAX)}
    assert recs["port"] == recs["jax"]
    assert recs["port"]["tableIndexConfig"]["sortedColumn"] == "team"
