"""The port broker's streaming query path against the JAX broker's.

`Broker.execute_sql_stream` yields a selection's ResultTable pages one
server segment at a time through the servers' `query_stream` handler and
stops at the query's LIMIT; a shape that cannot stream (aggregation,
GROUP BY, ORDER BY, OFFSET) runs whole and yields one page. A port
cluster (2 `ServerInstance(device="cpu")`, replication 1, 4 segments of
2,000 rows) and a JAX cluster (`ServerInstance(backend="host")`) serve the
same segment directories, built by the port's builder from a numpy seed;
each case holds the port's pages (count, rows, early stop) against the
JAX broker's. A segment is one page, so the pages are the selection rows
of each segment in the broker's plan order. Tolerance: exact.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest

import pinot_tpu.cluster as jcl
from pinot_tpu.engine import perf_ledger as _jax_perf_ledger
from pinot_tpu_torch import cluster as pcl
from pinot_tpu_torch.engine import perf_ledger as _port_perf_ledger
from pinot_tpu_torch.segment.builder import SegmentBuilder
from pinot_tpu_torch.spi.data_types import Schema

ROWS = 2000
SEGMENTS = 4
SCHEMA = Schema.build("strm", dimensions=[("team", "STRING"), ("year", "INT")],
                      metrics=[("runs", "INT")])
TEAMS = ["BOS", "NYA", "SFN", "LAN"]


@pytest.fixture(scope="module", autouse=True)
def _no_ledger_left_behind():
    yield
    for mod in (_jax_perf_ledger, _port_perf_ledger):
        mod.PERF_LEDGER.clear()
        mod.ALERTS.clear()


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("PINOT_TPU_SEGMENT_CACHE", "0")
    monkeypatch.setenv("PINOT_TPU_RESULT_CACHE", "0")


@pytest.fixture(scope="module")
def clusters(tmp_path_factory):
    rng = np.random.default_rng(20261020)
    root = tmp_path_factory.mktemp("streaming_segs")
    paths, cols_all = [], []
    for i in range(SEGMENTS):
        cols = {
            "team": np.asarray(TEAMS, dtype=object)[rng.integers(0, 4, ROWS)],
            "year": rng.integers(2000, 2010, ROWS).astype(np.int32),
            "runs": rng.integers(0, 100, ROWS).astype(np.int32),
        }
        SegmentBuilder(SCHEMA, None, f"strm_{i}").build(
            cols, root / f"strm_{i}")
        paths.append((f"strm_{i}", str(root / f"strm_{i}")))
        cols_all.append(cols)
    out = {}
    for name, cl, kw in (("port", pcl, {"device": "cpu"}),
                         ("jax", jcl, {"backend": "host"})):
        store = cl.PropertyStore()
        ctl = cl.ClusterController(store)
        servers = [cl.ServerInstance(store, f"Server_{i}", **kw)
                   for i in range(2)]
        for s in servers:
            s.start()
        ctl.add_schema(SCHEMA.to_json())
        table = ctl.create_table({"tableName": "strm", "replication": 1})
        for seg, path in paths:
            ctl.add_segment(table, seg, {"location": path, "numDocs": ROWS})
        out[name] = SimpleNamespace(servers=servers,
                                    broker=cl.Broker(store,
                                                     adaptive_selection=False))
    out["cols"] = cols_all
    yield out
    for name in ("port", "jax"):
        for s in out[name].servers:
            s.stop()
    out["port"].broker.close()


def _pages(broker, sql) -> list:
    return [[list(r) for r in page.rows]
            for page in broker.execute_sql_stream(sql)]


@pytest.mark.parametrize("sql,pages", [
    # every segment streams its own page; the LIMIT cuts inside the third
    ("SELECT team, year, runs FROM strm WHERE runs > 10 LIMIT 4500", 3),
    # LIMIT 100: the first segment's page alone, then the stream stops
    ("SELECT team, runs FROM strm LIMIT 100", 1),
    # a filter that keeps few rows: every segment pages, nothing is cut
    ("SELECT team, year FROM strm WHERE runs = 7 AND year = 2003 LIMIT 1000",
     None),
])
def test_stream_pages_equal_the_jax_broker(clusters, sql, pages):
    got = _pages(clusters["port"].broker, sql)
    want = _pages(clusters["jax"].broker, sql)
    assert got == want
    if pages is not None:
        assert len(got) == pages
    limit = int(sql.rsplit("LIMIT", 1)[1])
    assert sum(map(len, got)) <= limit


def test_stream_stops_early_at_the_limit(clusters):
    """LIMIT 100 reads one segment's page of the segments routed: the
    stream closes before the other segments are scanned."""
    port = clusters["port"]
    seen = []
    for s in port.servers:
        orig = s.executor.execute_segments

        def counting(query, segs, tracker=None, _orig=orig):
            seen.append([x.name for x in segs])
            return _orig(query, segs, tracker=tracker)

        s.executor.execute_segments = counting
    try:
        pages = _pages(port.broker, "SELECT team, runs FROM strm LIMIT 100")
    finally:
        for s in port.servers:
            del s.executor.execute_segments
    assert len(pages) == 1 and len(pages[0]) == 100
    assert len(seen) < SEGMENTS


@pytest.mark.parametrize("sql", [
    "SELECT team, SUM(runs) FROM strm GROUP BY team ORDER BY team",
    "SELECT COUNT(*), MAX(runs) FROM strm",
    "SELECT team, runs FROM strm ORDER BY runs DESC, team LIMIT 7",
    "SELECT team, runs FROM strm LIMIT 5 OFFSET 3",
])
def test_unstreamable_shapes_answer_in_one_page(clusters, sql):
    got = _pages(clusters["port"].broker, sql)
    want = _pages(clusters["jax"].broker, sql)
    assert len(got) == len(want) == 1
    if "ORDER BY" in sql or "COUNT" in sql:
        assert [[r[0], int(r[1])] if isinstance(r[0], str) else
                [int(x) for x in r] for r in got[0]] == \
            [[r[0], int(r[1])] if isinstance(r[0], str) else
             [int(x) for x in r] for r in want[0]]
    else:
        assert len(got[0]) == len(want[0]) == 5


def test_stream_of_a_parse_error_raises(clusters):
    with pytest.raises(ValueError, match="SqlParseError"):
        list(clusters["port"].broker.execute_sql_stream("SELEKT nope"))
