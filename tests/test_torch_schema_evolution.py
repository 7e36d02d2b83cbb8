"""Schema evolution in the port (fault F9), against the JAX package.

A table's schema gains columns after some of its segments were built. On
registration (`QueryExecutor.add_table`) each immutable segment that
predates a column gets a virtual dictionary column of cardinality 1
holding the field's default (segment/loader.py `apply_schema`), as the JAX
package's does; a consuming segment has no `apply_schema` in either
package and is registered as it is.

The segments are built once by the JAX builder and loaded by both
packages. The port's `QueryExecutor(device="cpu")` and the JAX package's
`QueryExecutor(backend="tpu")` (`PINOT_TPU_FUSED=interpret`, both caches
off, one mesh device) then agree on rows, result schemas, device
dispatches and pruned / processed segment counts; on a table that mixes
old segments (virtual column) with new ones (real column), on each
segment's batch family key and plan params (group-id strides included);
and on a realtime table whose schema gained a column after a commit.
Tolerance: exact.
"""

from __future__ import annotations

import numpy as np
import pytest

from pinot_tpu.engine.executor import batch_family_key as jax_family_key
from pinot_tpu.engine.plan import SegmentPlanner as JaxPlanner
from pinot_tpu.engine.query_executor import QueryExecutor as JaxQueryExecutor
from pinot_tpu.query.parser.sql import parse_sql as jax_parse
from pinot_tpu.realtime.converter import \
    RealtimeSegmentConverter as JaxConverter
from pinot_tpu.segment.builder import SegmentBuilder as JaxBuilder
from pinot_tpu.segment.loader import load_segment as jax_load
from pinot_tpu.segment.mutable import MutableSegment as JaxMutable
from pinot_tpu.spi.data_types import Schema as JaxSchema
from pinot_tpu_torch.engine.aggregation import UnsupportedQueryError
from pinot_tpu_torch.engine.executor import batch_family_key
from pinot_tpu_torch.engine.plan import SegmentPlanner
from pinot_tpu_torch.engine.query_executor import QueryExecutor
from pinot_tpu_torch.query.parser.sql import parse_sql
from pinot_tpu_torch.realtime.converter import RealtimeSegmentConverter
from pinot_tpu_torch.segment.loader import load_segment
from pinot_tpu_torch.segment.mutable import MutableSegment
from pinot_tpu_torch.spi.data_types import Schema

OLD = dict(dimensions=[("d_year", "INT")], metrics=[("rev", "INT")])
NEW = dict(dimensions=[("d_year", "INT"), ("region", "STRING")],
           metrics=[("rev", "INT"), ("qty", "INT")])
REGIONS = np.asarray(["AMERICA", "ASIA", "EUROPE"], dtype=object)

QUERIES = [
    "SELECT region, SUM(qty), COUNT(*) FROM t GROUP BY region",
    "SELECT d_year, region, qty FROM t LIMIT 2",
    "SELECT d_year, region, SUM(rev), SUM(qty) FROM t GROUP BY d_year, "
    "region ORDER BY d_year, region LIMIT 50",
    "SELECT COUNT(*), SUM(rev) FROM t WHERE region = 'null'",
    "SELECT COUNT(*) FROM t WHERE region = 'ASIA' AND qty > 10",
    "SELECT d_year, region, qty FROM t WHERE d_year = 1995 "
    "ORDER BY rev DESC, qty LIMIT 5",
    "SET segmentBatch = false; SELECT region, SUM(qty), COUNT(*) FROM t "
    "GROUP BY region",
]


@pytest.fixture(autouse=True)
def _jax_dispatches_every_query(monkeypatch):
    monkeypatch.setenv("PINOT_TPU_SEGMENT_CACHE", "0")
    monkeypatch.setenv("PINOT_TPU_RESULT_CACHE", "0")
    monkeypatch.setenv("PINOT_TPU_MESH_DEVICES", "1")
    monkeypatch.setenv("PINOT_TPU_FUSED", "interpret")


def _old_cols(rng, n):
    return {"d_year": rng.integers(1992, 1999, n).astype(np.int32),
            "rev": rng.integers(1, 1000, n).astype(np.int32)}


def _new_cols(rng, n):
    return dict(_old_cols(rng, n),
                region=REGIONS[rng.integers(0, 3, n)],
                qty=rng.integers(1, 50, n).astype(np.int32))


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """One 3000-row segment of the old schema, two more of it and two of
    the new schema."""
    rng = np.random.default_rng(9)
    root = tmp_path_factory.mktemp("torch_schema_evolution")
    out = {}
    for name, kw, cols, n in (("lone", OLD, _old_cols, 3000),
                              ("o0", OLD, _old_cols, 1500),
                              ("o1", OLD, _old_cols, 1500),
                              ("n0", NEW, _new_cols, 1500),
                              ("n1", NEW, _new_cols, 1500)):
        JaxBuilder(JaxSchema.build("t", **kw), segment_name=name).build(
            cols(rng, n), root / name)
        out[name] = root / name
    return out


def _engines(paths, extra=(), jextra=()):
    port = QueryExecutor(device="cpu")
    port.add_table(Schema.build("t", **NEW),
                   [load_segment(p) for p in paths] + list(extra))
    jax = JaxQueryExecutor(backend="tpu")
    jax.add_table(JaxSchema.build("t", **NEW),
                  [jax_load(p) for p in paths] + list(jextra))
    return port, jax


def _same(port, jax, sql):
    got, want = port.execute_sql(sql), jax.execute_sql(sql)
    assert not want.exceptions, want.exceptions
    assert got.result_table.rows == want.result_table.rows, sql
    assert got.result_table.schema.to_json() == \
        want.result_table.schema.to_json()
    assert got.num_device_dispatches == want.num_device_dispatches
    assert got.num_segments_processed == want.num_segments_processed
    assert got.num_segments_pruned == want.num_segments_pruned
    assert got.num_docs_scanned == want.num_docs_scanned
    return got


def test_old_segment_reads_virtual_default_columns(dirs):
    port, jax = _engines([dirs["lone"]])
    got = _same(port, jax, QUERIES[0])
    assert got.result_table.rows == [["null", 0.0, 3000]]
    assert got.num_device_dispatches == 1
    sel = _same(port, jax, QUERIES[1]).result_table.rows
    assert len(sel) == 2 and all(r[1:] == ["null", 0] for r in sel)
    seg = port.tables["t"].segments[0]
    m = seg.column_metadata("region")
    assert (m.encoding, m.cardinality, m.min_value) == ("DICT", 1, "null")
    assert seg.get_dict_ids("qty").tolist() == [0] * 3000


@pytest.mark.parametrize("sql", QUERIES)
@pytest.mark.parametrize("which", ["old", "mixed"])
def test_queries_match_jax(dirs, which, sql):
    names = ["o0", "o1"] + (["n0", "n1"] if which == "mixed" else [])
    port, jax = _engines([dirs[n] for n in names])
    _same(port, jax, sql)


@pytest.mark.parametrize("sql", [QUERIES[0], QUERIES[2], QUERIES[4]])
def test_mixed_family_keys_and_strides_match_jax(dirs, sql):
    """Old segments (a virtual `region` of cardinality 1) and new ones (a
    real dictionary) plan the same programs, params (group-id strides and
    LUTs) and family keys in both packages, so they stack into the same
    families."""
    port, jax = _engines([dirs[n] for n in ("o0", "o1", "n0", "n1")])
    keys, jkeys = [], []
    for seg, jseg in zip(port.tables["t"].segments, jax.tables["t"].segments):
        plan = SegmentPlanner(parse_sql(sql), seg).plan()
        jplan = JaxPlanner(jax_parse(sql), jseg).plan()
        assert repr(plan.program) == repr(jplan.program)
        assert len(plan.params) == len(jplan.params)
        for p, jp in zip(plan.params, jplan.params):
            np.testing.assert_array_equal(np.asarray(p), np.asarray(jp))
            assert np.asarray(p).dtype == np.asarray(jp).dtype
        key = batch_family_key(seg, plan, packed_on=False)
        jkey = jax_family_key(jseg, jplan)
        assert repr(key[0]) == repr(jkey[0]) and key[1:] == jkey[1:]
        keys.append(key)
        jkeys.append(jkey)
    # the same partition of the four segments into families
    assert [keys.index(k) for k in keys] == [jkeys.index(k) for k in jkeys]


def _realtime_pair(schema_kw, rows):
    seg = MutableSegment(Schema.build("t", **schema_kw), "consuming")
    jseg = JaxMutable(JaxSchema.build("t", **schema_kw), "consuming")
    for r in rows:
        seg.index(r)
        jseg.index(r)
    return seg, jseg


def _rt_rows(n, seed, new):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        r = {"d_year": 1992 + int(rng.integers(7)),
             "rev": int(rng.integers(1, 1000))}
        if new:
            r.update(region=str(REGIONS[int(rng.integers(3))]),
                     qty=int(rng.integers(1, 50)))
        out.append(r)
    return out


@pytest.fixture(scope="module")
def committed(tmp_path_factory):
    """A realtime table's segment committed under the old schema by each
    package's converter."""
    root = tmp_path_factory.mktemp("torch_schema_commit")
    seg, jseg = _realtime_pair(OLD, _rt_rows(300, 1, new=False))
    RealtimeSegmentConverter(Schema.build("t", **OLD)).convert(
        seg, root / "port")
    JaxConverter(JaxSchema.build("t", **OLD)).convert(jseg, root / "jax")
    return root / "port", root / "jax"


def test_realtime_consuming_segment_after_the_schema_change(committed):
    """The common case: the next consuming segment is created under the
    new schema and holds the columns; the committed segment reads them as
    virtual defaults."""
    seg, jseg = _realtime_pair(NEW, _rt_rows(200, 2, new=True))
    port = QueryExecutor(device="cpu")
    port.add_table(Schema.build("t", **NEW),
                   [load_segment(committed[0]), seg])
    jax = JaxQueryExecutor(backend="tpu")
    jax.add_table(JaxSchema.build("t", **NEW),
                  [jax_load(committed[1]), jseg])
    for sql in QUERIES[:5] + [QUERIES[6]]:
        _same(port, jax, sql)
    rows = _same(port, jax, QUERIES[0]).result_table.rows
    assert ["null", 0.0, 300] in rows and sum(r[2] for r in rows) == 500


def test_realtime_consuming_segment_predating_the_column(committed):
    """A consuming segment created under the old schema has no
    apply_schema in either package: a query of a new column fails in both
    (the JAX package answers with an exception, the port raises), and a
    query of the old columns answers alike."""
    seg, jseg = _realtime_pair(OLD, _rt_rows(200, 3, new=False))
    port = QueryExecutor(device="cpu")
    port.add_table(Schema.build("t", **NEW),
                   [load_segment(committed[0]), seg])
    jax = JaxQueryExecutor(backend="tpu")
    jax.add_table(JaxSchema.build("t", **NEW),
                  [jax_load(committed[1]), jseg])
    for sql in (QUERIES[0], QUERIES[1]):
        want = jax.execute_sql(sql)
        assert want.exceptions and want.num_device_dispatches == 0
        with pytest.raises(UnsupportedQueryError, match="region"):
            port.execute_sql(sql)
    got = _same(port, jax, "SELECT d_year, SUM(rev), COUNT(*) FROM t "
                "GROUP BY d_year ORDER BY d_year")
    assert sum(r[2] for r in got.result_table.rows) == 500
