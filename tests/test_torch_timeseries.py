"""The port's timeseries engine against the JAX package's.

The cases of `tests/test_timeseries.py`, each run through both engines on
the same two segments (built once by the port's builder): the JAX
`TimeSeriesEngine` over `QueryExecutor(backend="tpu")` (its Pallas kernels
interpreted, its caches off) and the port's over
`QueryExecutor(device="cpu")`. Every block must equal the reference's
`to_json()` exactly, as must the fetch's dispatches. A fetch over a raw
time column is refused by both. The REST cases send the same request to
the broker's `/timeseries/api/v1/query_range` of each package: 200 with
the reference's JSON, 501 without an engine, 403 for a table-scoped
principal, 500 for a refused fetch.
"""

from __future__ import annotations

import numpy as np
import pytest

from _torch_ops import http
from pinot_tpu.cluster import Broker as JaxBroker
from pinot_tpu.cluster import PropertyStore as JaxStore
from pinot_tpu.cluster.auth import BasicAuthAccessControl as JaxAuth
from pinot_tpu.cluster.rest import BrokerRestServer as JaxRest
from pinot_tpu.engine.query_executor import QueryExecutor as JaxQueryExecutor
from pinot_tpu.segment.loader import load_segment as jax_load
from pinot_tpu.spi.data_types import Schema as JaxSchema
from pinot_tpu.timeseries import TimeSeriesEngine as JaxEngine
from pinot_tpu.timeseries.engine import \
    TimeSeriesQueryError as JaxTimeSeriesQueryError
from pinot_tpu_torch.cluster import Broker, PropertyStore
from pinot_tpu_torch.cluster.auth import BasicAuthAccessControl
from pinot_tpu_torch.cluster.rest import BrokerRestServer
from pinot_tpu_torch.engine.query_executor import QueryExecutor
from pinot_tpu_torch.segment.builder import SegmentBuilder
from pinot_tpu_torch.segment.loader import load_segment
from pinot_tpu_torch.spi.data_types import Schema
from pinot_tpu_torch.spi.table_config import IndexingConfig, TableConfig
from pinot_tpu_torch.timeseries import TimeSeriesEngine
from pinot_tpu_torch.timeseries.engine import (TimeSeriesQueryError,
                                               parse_m3ql)

DIMS = [("svc", "STRING"), ("dc", "STRING")]
METRICS = [("lat", "DOUBLE")]
DATE_TIMES = [("ts", "LONG")]
AUTH = [{"username": "admin", "password": "verysecret"},
        {"username": "scoped", "password": "pw", "tables": ["otherTable"]}]


def _rows(ts_range):
    # 2 services x 2 dcs at each ts
    return [{"svc": svc, "dc": dc, "ts": t,
             "lat": 1.0 if svc == "api" else 2.0}
            for t in ts_range for svc in ("api", "web")
            for dc in ("east", "west")]


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    """(port engine, JAX engine) over ts 0..39, split into two segments
    (a batch family); "reqs_raw" holds the same rows with a raw ts."""
    mp = pytest.MonkeyPatch()
    mp.setenv("PINOT_TPU_SEGMENT_CACHE", "0")
    mp.setenv("PINOT_TPU_RESULT_CACHE", "0")
    mp.setenv("PINOT_TPU_MESH_DEVICES", "1")
    mp.setenv("PINOT_TPU_FUSED", "interpret")
    root = tmp_path_factory.mktemp("torch_ts")
    port = QueryExecutor(device="cpu")
    jax = JaxQueryExecutor(backend="tpu")
    for table, raw in (("reqs", []), ("reqs_raw", ["ts"])):
        schema = Schema.build(table, dimensions=DIMS, metrics=METRICS,
                              date_times=DATE_TIMES)
        cfg = TableConfig(table_name=table,
                          indexing=IndexingConfig(no_dictionary_columns=raw))
        paths = []
        for i, rng in enumerate((range(0, 20), range(20, 40))):
            path = root / f"{table}_{i}"
            SegmentBuilder(schema, cfg, f"{table}_{i}").build_from_rows(
                _rows(rng), path)
            paths.append(path)
        port.add_table(schema, [load_segment(p) for p in paths])
        jax.add_table(JaxSchema.build(table, dimensions=DIMS, metrics=METRICS,
                                      date_times=DATE_TIMES),
                      [jax_load(p) for p in paths])
    yield TimeSeriesEngine(port), JaxEngine(jax)
    mp.undo()


def _both(engines, query, start, end, step):
    """The port's block, after holding its JSON and its fetch's dispatches
    to the JAX engine's."""
    blocks, dispatches = [], []
    for eng in engines:
        execute = eng.qe.execute

        def counted(qc, _execute=execute, **kw):
            resp = _execute(qc, **kw)
            dispatches.append(resp.num_device_dispatches)
            return resp

        eng.qe.execute = counted
        try:
            blocks.append(eng.execute(query, start=start, end=end, step=step))
        finally:
            del eng.qe.execute
    got, want = blocks
    assert got.to_json() == want.to_json()
    assert dispatches[0] == dispatches[1] > 0
    return got


def test_parse_m3ql():
    plan = parse_m3ql(
        'fetch table=reqs value=lat time_col=ts filter="svc = \'api\'" '
        "| sum svc,dc | rate | scale 2")
    assert plan.fetch.table == "reqs"
    assert plan.fetch.group_tags == ["svc", "dc"]
    assert [s.name for s in plan.stages] == ["aggregate_tags", "rate", "scale"]


def test_fetch_sum_by_tag(engines):
    block = _both(engines, "fetch table=reqs value=lat time_col=ts | sum svc",
                  0, 40, 10)
    assert block.buckets.num_buckets == 4
    by_tag = {s.label(): s.values for s in block.series}
    # api: 1.0 x 2 dcs x 10 ts per bucket = 20; web: 2.0 x 20 = 40
    assert list(by_tag["svc=api"]) == [20.0] * 4
    assert list(by_tag["svc=web"]) == [40.0] * 4


def test_fetch_filter_and_global_sum(engines):
    block = _both(
        engines,
        "fetch table=reqs value=lat time_col=ts filter=\"dc = 'east'\" | sum",
        0, 40, 10)
    assert len(block.series) == 1
    assert list(block.series[0].values) == [30.0] * 4  # (1+2) x 10 per bucket


def test_avg_and_count(engines):
    block = _both(
        engines, "fetch table=reqs value=lat time_col=ts agg=avg | avg svc",
        0, 40, 10)
    by_tag = {s.label(): s.values for s in block.series}
    assert list(by_tag["svc=api"]) == [1.0] * 4
    assert list(by_tag["svc=web"]) == [2.0] * 4
    block = _both(engines, "fetch table=reqs value=lat time_col=ts | count dc",
                  0, 40, 10)
    # the fetch counts rows per (bucket, dc); `count` then counts series
    assert [list(s.values) for s in block.series] == [[1.0] * 4] * 2


def test_pipe_combinators(engines):
    block = _both(engines,
                  "fetch table=reqs value=lat time_col=ts | sum | scale 0.5",
                  0, 40, 10)
    assert list(block.series[0].values) == [30.0] * 4  # 60 x 0.5

    block = _both(engines, "fetch table=reqs value=lat time_col=ts | sum | rate",
                  0, 40, 10)
    v = block.series[0].values
    assert np.isnan(v[0]) and list(v[1:]) == [0.0, 0.0, 0.0]

    block = _both(engines,
                  "fetch table=reqs value=lat time_col=ts | sum | shift 1",
                  0, 40, 10)
    v = block.series[0].values
    assert np.isnan(v[0]) and list(v[1:]) == [60.0] * 3


def test_transform_null_and_sparse(engines):
    # query beyond the data range: empty buckets are NaN then filled
    block = _both(
        engines, "fetch table=reqs value=lat time_col=ts | sum | transform_null 0",
        0, 80, 10)
    assert list(block.series[0].values) == [60.0] * 4 + [0.0] * 4


def test_topk(engines):
    block = _both(engines,
                  "fetch table=reqs value=lat time_col=ts | sum svc,dc | topk 2",
                  0, 40, 10)
    assert len(block.series) == 2
    assert all(s.tags["svc"] == "web" for s in block.series)


def test_moving_avg_and_keep_last(engines):
    block = _both(engines,
                  "fetch table=reqs value=lat time_col=ts | sum | moving_avg 2",
                  0, 40, 10)
    assert list(block.series[0].values) == [60.0] * 4

    block = _both(
        engines, "fetch table=reqs value=lat time_col=ts | sum | keep_last_value",
        0, 80, 10)
    assert list(block.series[0].values) == [60.0] * 8


def test_json_shape(engines):
    block = _both(engines, "fetch table=reqs value=lat time_col=ts | sum svc",
                  0, 40, 10)
    j = block.to_json()
    assert j["timeBuckets"] == {"start": 0, "step": 10, "numBuckets": 4}
    assert len(j["series"]) == 2


def test_errors(engines):
    port, jax = engines
    for eng, err in ((port, TimeSeriesQueryError),
                     (jax, JaxTimeSeriesQueryError)):
        with pytest.raises(err, match="must start with 'fetch'"):
            eng.execute("sum svc", 0, 10, 1)
        with pytest.raises(err, match="missing required"):
            eng.execute("fetch table=reqs", 0, 10, 1)
        with pytest.raises(err, match="unknown pipe stage"):
            eng.execute("fetch table=reqs value=lat time_col=ts | frobnicate",
                        0, 10, 1)
        with pytest.raises(err, match="fetch failed"):
            eng.execute("fetch table=nope value=lat time_col=ts", 0, 10, 1)


def test_raw_time_column_refused_by_both(engines):
    """Neither package's device planner lowers the bucket transform over a
    raw time column: both fetches fail with TimeSeriesQueryError."""
    port, jax = engines
    q = "fetch table=reqs_raw value=lat time_col=ts | sum svc"
    with pytest.raises(TimeSeriesQueryError, match="fetch failed") as got:
        port.execute(q, 0, 40, 10)
    with pytest.raises(JaxTimeSeriesQueryError, match="fetch failed") as want:
        jax.execute(q, 0, 40, 10)
    assert "UnsupportedQueryError" in str(got.value)
    assert "UnsupportedQueryError" in str(want.value)


# -- the broker's REST route ----------------------------------------------------

BODY = {"query": "fetch table=reqs value=lat time_col=ts | sum svc",
        "start": 0, "end": 40, "step": 10}


def _rest_each(engines, body, headers=None, with_engine=True, auth=False):
    """(status, body) of the route on a fresh REST server of each
    package; the servers are closed afterwards."""
    port, jax = engines
    out = {}
    for name, rest_cls, broker, eng, ac in (
            ("port", BrokerRestServer, Broker(PropertyStore()), port,
             BasicAuthAccessControl),
            ("jax", JaxRest, JaxBroker(JaxStore()), jax, JaxAuth)):
        kw = {"timeseries_engine": eng} if with_engine else {}
        if auth:
            kw["access_control"] = ac(AUTH)
        rest = rest_cls(broker, **kw)
        try:
            out[name] = http(rest.url + "/timeseries/api/v1/query_range",
                             body, headers=headers)
        finally:
            rest.close()
    return out


def test_rest_query_range_answers_the_reference_json(engines):
    got = _rest_each(engines, BODY)
    assert got["port"] == got["jax"]
    assert got["port"][0] == 200
    assert got["port"][1] == engines[1].execute(
        BODY["query"], 0, 40, 10).to_json()


def test_rest_query_range_without_an_engine(engines):
    got = _rest_each(engines, BODY, with_engine=False)
    assert got["port"] == got["jax"] == (
        501, {"error": "timeseries engine not configured"})


def test_rest_query_range_table_scoped_principal(engines):
    from _torch_ops import basic

    got = _rest_each(engines, BODY, headers=basic("scoped", "pw"), auth=True)
    assert got["port"] == got["jax"]
    assert got["port"] == (403, {"error": "READ on reqs not permitted"})
    got = _rest_each(engines, BODY, headers=basic("admin", "verysecret"),
                     auth=True)
    assert got["port"] == got["jax"] and got["port"][0] == 200


def test_rest_refused_fetch_answers_500(engines):
    body = dict(BODY, query="fetch table=reqs_raw value=lat time_col=ts")
    got = _rest_each(engines, body)
    assert got["port"][0] == got["jax"][0] == 500
    for code, payload in got.values():
        assert payload["error"].startswith(
            "TimeSeriesQueryError: fetch failed")
