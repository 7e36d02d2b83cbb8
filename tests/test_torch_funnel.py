"""The FUNNEL family on the port's host engine against the JAX package.

Every case of tests/test_funnel.py (FUNNELCOUNT with a WHERE, a GROUP BY
and SETTINGS; FUNNELMAXSTEP in each mode, grouped, with KEEP_ALL and
MAXSTEPDURATION; FUNNELMATCHSTEP; FUNNELCOMPLETECOUNT and FUNNELMAXSTEP
over hand-checked event sequences) runs through the port's
`QueryExecutor(device="cpu", backend=b).execute_sql` and the JAX
package's `QueryExecutor(backend=b).execute_sql`, for b in "host" and
"auto" (no device planner lowers a funnel: "auto" answers every segment
on the host engine), over the same two segments (600 rows each, numpy
seeds 100 and 101). Compared: rows, docs scanned and dispatches; the
hand-checked cases also against their known answers. Then the funnel
module's window scans and parse errors against the JAX module's, over
seeded random event sequences. Tolerance: exact.
"""

from __future__ import annotations

import numpy as np
import pytest

from pinot_tpu.engine import funnel as jax_funnel
from pinot_tpu.engine.query_executor import QueryExecutor as JaxQueryExecutor
from pinot_tpu.query.parser.sql import parse_sql as jax_parse_sql
from pinot_tpu.segment.loader import load_segment as jax_load
from pinot_tpu.spi.data_types import Schema as JaxSchema
from pinot_tpu_torch.engine import funnel
from pinot_tpu_torch.engine.query_executor import QueryExecutor
from pinot_tpu_torch.query.parser.sql import parse_sql
from pinot_tpu_torch.segment.builder import SegmentBuilder
from pinot_tpu_torch.segment.loader import load_segment
from pinot_tpu_torch.spi.data_types import Schema

DIMS = [("uid", "INT"), ("url", "STRING"), ("ts", "LONG"), ("day", "INT")]
URLS = ["/home", "/cart", "/pay", "/done", "/other"]
S3 = "url = '/cart', url = '/pay', url = '/done'"
MODES = ["", ", 'STRICT_ORDER'", ", 'STRICT_DEDUPLICATION'",
         ", 'STRICT_INCREASE'"]

CASES = [
    f"SELECT FUNNEL_COUNT(STEPS({S3}), CORRELATE_BY(uid)) FROM ev",
    f"SELECT FUNNEL_COUNT(STEPS({S3}), CORRELATE_BY(uid)) FROM ev "
    "WHERE day = 1",
    f"SELECT day, FUNNEL_COUNT(STEPS({S3}), CORRELATE_BY(uid)) FROM ev "
    "GROUP BY day LIMIT 10",
    f"SELECT FUNNEL_COUNT(STEPS({S3}), CORRELATE_BY(uid), "
    "SETTINGS('theta_sketch')) FROM ev",
    *[f"SELECT FUNNEL_MAX_STEP(ts, 800, 3, {S3}{m}) FROM ev" for m in MODES],
    f"SELECT day, FUNNEL_MAX_STEP(ts, 500, 3, {S3}) FROM ev GROUP BY day "
    "LIMIT 10",
    f"SELECT FUNNEL_MATCH_STEP(ts, 800, 3, {S3}) FROM ev",
    f"SELECT FUNNEL_MAX_STEP(ts, 800, 3, {S3}, 'KEEP_ALL', 'STRICT_ORDER') "
    "FROM ev",
    f"SELECT FUNNEL_MAX_STEP(ts, 2000, 3, {S3}, 'MAXSTEPDURATION=50') "
    "FROM ev",
    f"SELECT day, FUNNEL_MAX_STEP(ts, 800, 3, {S3}) FROM ev GROUP BY day "
    "LIMIT 10",
    f"SELECT day, FUNNEL_COMPLETE_COUNT(ts, 600, 3, {S3}, 'MODE=STRICT_ORDER')"
    " FROM ev GROUP BY day LIMIT 10",
    # the shape the default backend refuses: a CORRELATE_BY argument
    "SELECT FUNNELCOUNT(STEPS(url = '/cart', url = '/pay'), "
    "CORRELATE_BY(uid)) FROM ev",
]


@pytest.fixture(autouse=True)
def _jax_dispatches_every_query(monkeypatch):
    monkeypatch.setenv("PINOT_TPU_SEGMENT_CACHE", "0")
    monkeypatch.setenv("PINOT_TPU_RESULT_CACHE", "0")
    monkeypatch.setenv("PINOT_TPU_MESH_DEVICES", "1")
    monkeypatch.setenv("PINOT_TPU_FUSED", "interpret")


def _gen(n, seed):
    rng = np.random.default_rng(seed)
    return {
        "uid": rng.integers(0, 40, n).astype(np.int32),
        "url": np.asarray(URLS, dtype=object)[rng.integers(0, len(URLS), n)],
        "ts": (1_000 + rng.integers(0, 5_000, n)).astype(np.int64),
        "day": rng.integers(0, 3, n).astype(np.int32),
    }


def _engines(paths, backend):
    port = QueryExecutor(device="cpu", backend=backend)
    port.add_table(Schema.build("ev", dimensions=DIMS),
                   [load_segment(p) for p in paths])
    jax = JaxQueryExecutor(backend=backend)
    jax.add_table(JaxSchema.build("ev", dimensions=DIMS),
                  [jax_load(p) for p in paths])
    return port, jax


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_funnel")
    schema = Schema.build("ev", dimensions=DIMS)
    paths = []
    for i in range(2):
        SegmentBuilder(schema, segment_name=f"ev{i}").build(
            _gen(600, seed=100 + i), d / f"s{i}")
        paths.append(d / f"s{i}")
    return {b: _engines(paths, b) for b in ("host", "auto")}


@pytest.mark.parametrize("backend", ["host", "auto"])
@pytest.mark.parametrize("sql", CASES)
def test_funnel_answers_as_jax(env, backend, sql):
    port, jax = env[backend]
    got, want = port.execute_sql(sql), jax.execute_sql(sql)
    assert not want.exceptions, want.exceptions
    assert got.result_table.rows == want.result_table.rows
    assert got.result_table.schema.column_types == \
        want.result_table.schema.column_types
    assert got.num_docs_scanned == want.num_docs_scanned
    assert got.num_docs_scanned == 1200 or "WHERE" in sql
    assert got.num_device_dispatches == want.num_device_dispatches == 0


def _hand_table(tmp_path, rows, backend):
    cols = {
        "uid": np.asarray([r[0] for r in rows], dtype=np.int32),
        "url": np.asarray([r[1] for r in rows], dtype=object),
        "ts": np.asarray([r[2] for r in rows], dtype=np.int64),
        "day": np.zeros(len(rows), dtype=np.int32),
    }
    SegmentBuilder(Schema.build("ev", dimensions=DIMS),
                   segment_name="h").build(cols, tmp_path / "h")
    return _engines([tmp_path / "h"], backend)


COMPLETE_ROWS = [
    # two full rounds inside one window, then a partial one
    (1, "/cart", 10), (1, "/pay", 20), (1, "/done", 30),
    (1, "/cart", 40), (1, "/pay", 50), (1, "/done", 60),
    (1, "/cart", 70), (1, "/pay", 80),
]
MAXSTEP_ROWS = [
    (1, "/cart", 10), (1, "/other", 15), (1, "/pay", 20),
    (1, "/done", 500),  # outside the 100-wide window from ts=10
]


@pytest.mark.parametrize("backend", ["host", "auto"])
@pytest.mark.parametrize("rows,sql,want", [
    (COMPLETE_ROWS, f"SELECT FUNNEL_COMPLETE_COUNT(ts, 1000, 3, {S3}) "
     "FROM ev", 2),
    (COMPLETE_ROWS, f"SELECT FUNNEL_COMPLETE_COUNT(ts, 15, 3, {S3}) FROM ev",
     0),
    (MAXSTEP_ROWS, f"SELECT FUNNEL_MAX_STEP(ts, 100, 3, {S3}) FROM ev", 2),
    (MAXSTEP_ROWS, f"SELECT FUNNEL_MAX_STEP(ts, 100, 3, {S3}, "
     "'STRICT_ORDER') FROM ev", 2),
    (MAXSTEP_ROWS, f"SELECT FUNNEL_MAX_STEP(ts, 100, 3, {S3}, 'KEEP_ALL', "
     "'STRICT_ORDER') FROM ev", 1),
])
def test_hand_checked_funnels_as_jax(tmp_path, backend, rows, sql, want):
    port, jax = _hand_table(tmp_path, rows, backend)
    got = port.execute_sql(sql).result_table.rows
    assert got == jax.execute_sql(sql).result_table.rows == [[want]]


@pytest.mark.parametrize("name", ["funnelmaxstep", "funnelmatchstep",
                                  "funnelcompletecount"])
@pytest.mark.parametrize("modes", ["", ", 'STRICT_ORDER'",
                                   ", 'STRICT_DEDUPLICATION', 'KEEP_ALL'",
                                   ", 'STRICT_INCREASE'",
                                   ", 'MODE=STRICT_ORDER,STRICT_INCREASE', "
                                   "'MAXSTEPDURATION=40'"])
def test_window_scans_as_jax(name, modes):
    """The finalize scans over seeded random event sequences: the port's
    module gives the JAX module's answer for every group."""
    sql = f"SELECT {name}(ts, 120, 4, a = 1, a = 2, a = 3, a = 4{modes}) FROM t"
    fn = parse_sql(sql).aggregations[0].function
    jfn = jax_parse_sql(sql).aggregations[0].function
    sem, jsem = (funnel.funnel_semantics(fn),
                 jax_funnel.funnel_semantics(jfn))
    rng = np.random.default_rng(len(modes) * 7 + len(name))
    for _ in range(40):
        n = int(rng.integers(0, 60))
        halves = []
        for _ in range(2):  # two segments' states, merged
            ts = rng.integers(0, 600, n).astype(np.int64)
            step = rng.integers(-1, 4, n).astype(np.int32)
            halves.append((ts, step))
        state = sem.merge(*halves)
        jstate = jsem.merge(*halves)
        assert sem.finalize(state) == jsem.finalize(jstate)
    assert sem.result_type == jsem.result_type


@pytest.mark.parametrize("sql", [
    "SELECT FUNNEL_COUNT(STEPS(url = 'a')) FROM ev",
    "SELECT FUNNEL_COUNT(CORRELATE_BY(uid), uid) FROM ev",
    "SELECT FUNNEL_MAX_STEP(ts, 0, 2, url = 'a', url = 'b') FROM ev",
    "SELECT FUNNEL_MAX_STEP(ts, 10, 3, url = 'a', url = 'b') FROM ev",
    "SELECT FUNNEL_MAX_STEP(ts, 10, 1, url = 'a', 'STRICT_NOPE') FROM ev",
    "SELECT FUNNEL_MAX_STEP(ts, 10, 1, url = 'a', 'MAXSTEPDURATION=0') "
    "FROM ev",
])
def test_parse_errors_as_jax(sql):
    fn = parse_sql(sql).aggregations[0].function
    jfn = jax_parse_sql(sql).aggregations[0].function
    with pytest.raises(jax_funnel.FunnelParseError) as want:
        jax_funnel.parse_funnel(jfn)
    with pytest.raises(funnel.FunnelParseError) as got:
        funnel.parse_funnel(fn)
    assert str(got.value) == str(want.value)
