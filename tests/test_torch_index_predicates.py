"""Index-backed predicates in the port against the JAX package.

JSON_MATCH, TEXT_MATCH and VECTOR_SIMILARITY evaluate on the host through
the column's index, and a `mapValue(col, 'key')` predicate through the
column's map index; each becomes a boolean mask plane (ir.MaskParam) of the
same device program. On the CPU, over seeded segments built by the port's
builder:

  * plans (program, slots, params) equal the JAX planner's, the mask plane
    included, and a mapValue predicate over an indexed key plans the mask
    (not the row-wise transform) where the JAX planner does;
  * `execute_sql` rows, scanned docs, device dispatches and host fetches
    equal the JAX package's, ANDed and ORed with dictionary and raw
    predicates, as one family and segment by segment, for aggregations,
    GROUP BYs and selections;
  * a column without a persisted index builds a transient one, as in the
    JAX package;
  * on a consuming segment, TEXT_MATCH, VECTOR_SIMILARITY and JSON_MATCH
    raise UnsupportedQueryError (the JAX package's realtime planner refuses
    the first two; it fails the third too), and a mapValue predicate takes
    the row-wise path there.
"""

from __future__ import annotations

import json
import math

import numpy as np
import pytest
import torch

from pinot_tpu.engine.aggregation import \
    UnsupportedQueryError as JaxUnsupported
from pinot_tpu.engine.plan import SegmentPlanner as JaxPlanner
from pinot_tpu.engine.query_executor import QueryExecutor as JaxQueryExecutor
from pinot_tpu.ops import kernels as jax_kernels
from pinot_tpu.query.parser.sql import parse_sql as jax_parse
from pinot_tpu.realtime import device_plane as jax_dp
from pinot_tpu.segment.loader import load_segment as jax_load
from pinot_tpu.segment.mutable import MutableSegment as JaxMutableSegment
from pinot_tpu.spi.data_types import Schema as JaxSchema
from pinot_tpu_torch.engine import ir
from pinot_tpu_torch.engine.aggregation import UnsupportedQueryError
from pinot_tpu_torch.engine.plan import SegmentPlanner
from pinot_tpu_torch.engine.query_executor import QueryExecutor
from pinot_tpu_torch.ops import kernels
from pinot_tpu_torch.query.parser.sql import parse_sql
from pinot_tpu_torch.realtime import device_plane
from pinot_tpu_torch.segment.builder import SegmentBuilder
from pinot_tpu_torch.segment.loader import load_segment
from pinot_tpu_torch.segment.mutable import MutableSegment
from pinot_tpu_torch.spi.data_types import Schema
from pinot_tpu_torch.spi.table_config import IndexingConfig, TableConfig

TABLE = "ev"
ROWS = 1200
SEGMENTS = 3
DIM = 8
DIMS = [("d_year", "INT"), ("s_region", "STRING"), ("attrs", "JSON"),
        ("msg", "STRING"), ("props", "STRING"), ("emb", "FLOAT", False),
        ("plain", "JSON")]
METRICS = [("lo_revenue", "INT"), ("lo_qty", "INT")]
REGIONS = ["AMERICA", "ASIA", "EUROPE"]
WORDS = ["connection", "reset", "time", "timeout", "error", "disk"] + [
    f"w{i}" for i in range(30)]
QVEC = "ARRAY[" + ", ".join(f"{x:.6f}" for x in np.random.default_rng(
    99).normal(size=DIM)) + "]"
JSON_PRED = ("JSON_MATCH(attrs, '\"$.device.os\" = ''ios'' AND "
             "\"$.tags[*]\" = ''t7''')")
TEXT_PRED = "TEXT_MATCH(msg, '\"connection reset\" OR time*')"
QUERIES = [
    f"SELECT d_year, COUNT(*), SUM(lo_revenue) FROM ev WHERE {JSON_PRED} "
    "GROUP BY d_year",
    f"SELECT d_year, COUNT(*), SUM(lo_revenue) FROM ev WHERE {TEXT_PRED} "
    "AND s_region = 'ASIA' GROUP BY d_year",
    "SELECT s_region, COUNT(*), SUM(lo_revenue) FROM ev WHERE "
    "mapValue(props, 'clicks') > 40 GROUP BY s_region",
    f"SELECT d_year, COUNT(*) FROM ev WHERE VECTOR_SIMILARITY(emb, {QVEC}, "
    "25) GROUP BY d_year",
    "SELECT COUNT(*), SUM(lo_qty), MAX(lo_revenue) FROM ev WHERE "
    "JSON_MATCH(attrs, '\"$.country\" IN (''c1'', ''c2'') OR "
    "\"$.note\" IS NOT NULL') AND lo_qty < 30",
    "SELECT s_region, MIN(lo_revenue), AVG(lo_qty) FROM ev WHERE "
    "TEXT_MATCH(msg, 'error AND /d[a-z]+k/') OR d_year = 1995 "
    "GROUP BY s_region",
    "SELECT d_year, s_region, COUNT(*) FROM ev WHERE NOT "
    "JSON_MATCH(attrs, '\"$.device.ver\" = 2') AND "
    "mapValue(props, 'clicks') BETWEEN 5 AND 45 GROUP BY d_year, s_region "
    "ORDER BY COUNT(*) DESC, d_year, s_region LIMIT 10",
    "SELECT COUNT(*) FROM ev WHERE mapValue(props, 'clicks') <> 7 AND "
    "mapValue(props, 'dwell') < 20.5 AND lo_revenue > 1000",
    "SELECT d_year, COUNT(*) FROM ev WHERE mapValue(props, 'clicks') IN "
    "(1, 2, 3) OR mapValue(props, 'flag') = 1 GROUP BY d_year",
    f"SELECT d_year, lo_revenue FROM ev WHERE {TEXT_PRED} AND lo_qty > 20 "
    "ORDER BY lo_revenue DESC, d_year LIMIT 15",
    f"SELECT s_region, lo_qty FROM ev WHERE VECTOR_SIMILARITY(emb, {QVEC}, "
    "10) ORDER BY lo_qty, s_region LIMIT 50",
    "SELECT d_year, COUNT(*) FROM ev WHERE JSON_MATCH(plain, "
    "'\"$.k\" = ''v1''') GROUP BY d_year",
    "SELECT COUNT(*) FROM ev WHERE mapValue(props, 'clicks', 0) = 0",
]


@pytest.fixture(autouse=True)
def _jax_dispatches_every_query(monkeypatch):
    monkeypatch.setenv("PINOT_TPU_SEGMENT_CACHE", "0")
    monkeypatch.setenv("PINOT_TPU_MESH_DEVICES", "1")
    monkeypatch.setenv("PINOT_TPU_FUSED", "interpret")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _cols(rng, rows):
    """Every segment holds every year and region (equal dictionaries: the
    segments form one family)."""
    os_names = ["ios", "android", "linux"]
    attrs, props = [], []
    for i in range(rows):
        doc = {"country": f"c{rng.integers(0, 5)}",
               "device": {"os": os_names[rng.integers(0, 3)],
                          "ver": int(rng.integers(1, 4))},
               "tags": [f"t{t}" for t in rng.integers(0, 10,
                                                      rng.integers(0, 4))]}
        if i % 9 == 0:
            doc["note"] = "n"
        attrs.append(json.dumps(doc))
        m = {"dwell": float(np.round(rng.random() * 40, 2))}
        if i % 11:
            m["clicks"] = int(rng.integers(0, 51))
        if i % 7 == 0:
            m["flag"] = bool(i % 2)
        props.append(json.dumps(m))
    words = np.asarray(WORDS, dtype=object)
    msg = [" ".join(words[rng.integers(0, len(WORDS), rng.integers(2, 9))])
           for _ in range(rows)]
    years = rng.integers(1992, 1999, rows)
    years[:7] = np.arange(1992, 1999)
    regions = rng.integers(0, 3, rows)
    regions[:3] = np.arange(3)
    return {
        "d_year": years.astype(np.int32),
        "s_region": np.asarray(REGIONS, dtype=object)[regions],
        "attrs": attrs, "msg": msg, "props": props,
        "emb": [list(v) for v in rng.normal(size=(rows, DIM)).astype(
            np.float32)],
        "plain": [json.dumps({"k": f"v{k}"}) for k in rng.integers(0, 4, rows)],
        "lo_revenue": rng.integers(1, 5000, rows).astype(np.int32),
        "lo_qty": rng.integers(1, 51, rows).astype(np.int32),
    }


def _schema(mod):
    return mod.build(TABLE, dimensions=DIMS, metrics=METRICS)


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    rng = np.random.default_rng(7)
    cfg = TableConfig(table_name=TABLE, indexing=IndexingConfig(
        no_dictionary_columns=["lo_revenue", "lo_qty"],
        json_index_columns=["attrs"], text_index_columns=["msg"],
        vector_index_columns=["emb"],
        custom_index_configs={"props": {"type": "map", "maxKeys": 2}}))
    root = tmp_path_factory.mktemp("torch_index_predicates")
    paths = []
    for i in range(SEGMENTS):
        SegmentBuilder(_schema(Schema), cfg, f"s{i}").build(
            _cols(rng, ROWS), root / f"s{i}")
        paths.append(root / f"s{i}")
    port = QueryExecutor(device="cpu")
    port.add_table(_schema(Schema), [load_segment(p) for p in paths])
    jax = JaxQueryExecutor(backend="tpu")
    jax.add_table(_schema(JaxSchema), [jax_load(p) for p in paths])
    return port, jax, paths


def _rows_equal(got, want, ordered):
    if not ordered:
        got, want = sorted(got, key=repr), sorted(want, key=repr)
    assert len(got) == len(want)
    for rg, rw in zip(got, want):
        for a, b in zip(rg, rw):
            if isinstance(a, float) or isinstance(b, float):
                assert math.isclose(float(a), float(b), rel_tol=1e-12), (rg, rw)
            else:
                assert a == b, (rg, rw)


def _mask_leaves(node) -> list:
    if isinstance(node, ir.MaskParam):
        return [node]
    kids = getattr(node, "children", None) or (
        [node.child] if isinstance(node, ir.FNot) else [])
    return [m for k in kids for m in _mask_leaves(k)]


@pytest.mark.parametrize("sql", QUERIES)
def test_plans_equal_jax(tables, sql):
    _, _, paths = tables
    pplan = SegmentPlanner(parse_sql(sql), load_segment(paths[0])).plan()
    jplan = JaxPlanner(jax_parse(sql), jax_load(paths[0])).plan()
    assert repr(pplan.program) == repr(jplan.program)
    assert pplan.slots == jplan.slots
    assert len(pplan.params) == len(jplan.params)
    for a, b in zip(pplan.params, jplan.params):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    masks = _mask_leaves(pplan.program.filter)
    for m in masks:  # padded to the segment's shape bucket, pad rows False
        plane = np.asarray(pplan.params[m.idx])
        assert plane.dtype == bool and plane.shape == (8192,)
        assert not plane[ROWS:].any()
    index_backed = any(k in sql for k in ("JSON_MATCH", "TEXT_MATCH",
                                          "VECTOR_SIMILARITY"))
    indexed_map = "'clicks') " in sql or "'dwell')" in sql
    assert bool(masks) == (index_backed or indexed_map)


@pytest.mark.parametrize("batch", [True, False], ids=["family", "solo"])
@pytest.mark.parametrize("sql", QUERIES)
def test_execute_sql_matches_jax(tables, sql, batch):
    port, jax, _ = tables
    if not batch:
        sql = "SET segmentBatch = false; " + sql
    before, jbefore = kernels.host_fetches(), jax_kernels.host_fetches()
    got = port.execute_sql(sql)
    want = jax.execute_sql(sql)
    assert not want.exceptions, want.exceptions
    assert kernels.host_fetches() - before == 1
    assert jax_kernels.host_fetches() - jbefore == 1
    _rows_equal(got.result_table.rows, want.result_table.rows,
                "ORDER BY" in sql)
    assert got.result_table.schema.to_json() == \
        want.result_table.schema.to_json()
    assert got.num_docs_scanned == want.num_docs_scanned
    assert got.num_device_dispatches == want.num_device_dispatches
    if not batch:
        assert got.num_device_dispatches == SEGMENTS
    elif "'flag')" not in sql and "0) =" not in sql:
        # a mask plane keeps the family: a row-wise mapValue's LUT over
        # each segment's own dictionary does not
        assert got.num_device_dispatches == 1


def test_vector_similarity_is_per_segment_top_k(tables):
    port = tables[0]
    got = port.execute_sql(f"SELECT COUNT(*) FROM ev WHERE "
                           f"VECTOR_SIMILARITY(emb, {QVEC}, 25)")
    assert got.result_table.rows == [[25 * SEGMENTS]]


def test_unindexed_column_builds_a_transient_index(tables):
    _, _, paths = tables
    seg = load_segment(paths[0])
    port = QueryExecutor(device="cpu")
    port.add_table(_schema(Schema), [seg])
    assert seg.get_json_index("plain") is None
    port.execute_sql(QUERIES[-2])
    assert seg.get_json_index("plain") is not None


def _live(rows: int):
    seg = MutableSegment(_schema(Schema), "ev_live_0")
    jseg = JaxMutableSegment(_schema(JaxSchema), "ev_live_0")
    cols = _cols(np.random.default_rng(8), rows)
    for i in range(rows):
        row = {c: v[i] for c, v in cols.items()}
        row["emb"] = [float(x) for x in row["emb"]]
        for c in ("d_year", "lo_revenue", "lo_qty"):
            row[c] = int(row[c])
        seg.index(row)
        jseg.index(dict(row))
    return seg, jseg


@pytest.mark.parametrize("pred", [
    TEXT_PRED, f"VECTOR_SIMILARITY(emb, {QVEC}, 5)", JSON_PRED])
def test_consuming_segment_refuses_index_predicates(pred):
    seg, jseg = _live(60)
    sql = f"SELECT d_year, COUNT(*) FROM ev WHERE {pred} GROUP BY d_year"
    with pytest.raises(UnsupportedQueryError):
        device_plane.realtime_plan(parse_sql(sql), seg.snapshot_view())
    if "JSON_MATCH" in pred:
        # the JAX package has no JSON index on a consuming segment either
        assert jseg.snapshot_view().get_json_index("attrs",
                                                   or_build=True) is None
    else:
        with pytest.raises(JaxUnsupported):
            jax_dp.realtime_plan(jax_parse(sql), jseg.snapshot_view())
    port = QueryExecutor(device="cpu")
    port.add_table(_schema(Schema), [seg])
    with pytest.raises(UnsupportedQueryError):
        port.execute_sql(sql)


def test_consuming_segment_map_predicate_takes_the_row_wise_path():
    """No map index while consuming: the realtime planner lowers the
    mapValue predicate as the JAX package's does (no mask plane), or both
    refuse it."""
    seg, jseg = _live(60)
    sql = ("SELECT COUNT(*) FROM ev WHERE mapValue(props, 'clicks') = 40")
    try:
        jplan = jax_dp.realtime_plan(jax_parse(sql), jseg.snapshot_view())
    except JaxUnsupported:
        with pytest.raises(UnsupportedQueryError):
            device_plane.realtime_plan(parse_sql(sql), seg.snapshot_view())
        return
    pplan = device_plane.realtime_plan(parse_sql(sql), seg.snapshot_view())
    assert repr(pplan.program) == repr(jplan.program)
    assert not _mask_leaves(pplan.program.filter)
