"""A seeded differential run of the port against the JAX package.

Some hundreds of random selection and multi-value queries (random
literals in a set of query templates, so the JAX package compiles each
program shape once) over a table of segments of unequal sizes with nulls,
raw and dictionary columns and an MV column: the port's
`QueryExecutor(device="cpu")` against the JAX package's
`QueryExecutor(backend="tpu")` (its Pallas kernels interpreted, its
segment cache off). Every query gives rows equal to the reference's (in
order where the query orders them, or is a selection), with the same
scanned docs, pruned segments and device dispatches.

The transform templates add TIMESTAMP columns (day-resolution millis
dictionary-encoded, raw millis from 1900 to 2100) and a dimension table
in both packages: date/time over raw and dictionary columns, string
transforms in filters and GROUP BY keys, LOOKUP, post-aggregation and
HAVING functions, and selections with transform items. Where the JAX
package's device planner refuses a segment's plan, both packages retry
the query on their multi-stage engine: the port must give the JAX
package's answer there, or raise UnsupportedQueryError where the JAX
package's multi-stage engine fails too.

The index templates run over a second table with JSON, text, map and
vector indexes and a star-tree: random index predicates ANDed and ORed
with dictionary and raw predicates, and star-tree-eligible GROUP BYs
(three segments read their pre-aggregated views, one with a null split
dimension scans its rows).
"""

from __future__ import annotations

import json
import math

import numpy as np
import pytest

from pinot_tpu.engine import dim_tables as jax_dim_tables
from pinot_tpu.engine.aggregation import \
    UnsupportedQueryError as JaxUnsupportedQueryError
from pinot_tpu.engine.plan import SegmentPlanner as JaxPlanner
from pinot_tpu.engine.query_executor import QueryExecutor as JaxQueryExecutor
from pinot_tpu.query.parser.sql import parse_sql as jax_parse
from pinot_tpu.segment.loader import load_segment as jax_load
from pinot_tpu.spi.data_types import Schema as JaxSchema
from pinot_tpu_torch.engine import dim_tables
from pinot_tpu_torch.engine.aggregation import UnsupportedQueryError
from pinot_tpu_torch.engine.query_executor import QueryExecutor
from pinot_tpu_torch.query.parser.sql import parse_sql
from pinot_tpu_torch.segment.builder import SegmentBuilder
from pinot_tpu_torch.segment.loader import load_segment
from pinot_tpu_torch.spi.data_types import Schema
from pinot_tpu_torch.spi.table_config import IndexingConfig, TableConfig

TABLE = "d"
SIZES = [1200, 1200, 700, 9000]
DIMS = [("d_year", "INT"), ("s_region", "STRING"), ("p_brand", "INT"),
        ("tags", "INT", False), ("lo_orderkey", "LONG"),
        ("ts", "TIMESTAMP"), ("tsr", "TIMESTAMP")]
METRICS = [("lo_revenue", "INT"), ("lo_tax", "DOUBLE"), ("lo_qty", "FLOAT")]
RAW = ["lo_revenue", "lo_tax", "lo_qty", "tsr"]
REGIONS = ["AMERICA", "ASIA", "EUROPE", "AFRICA", None]
PER_TEMPLATE = 22
DAY = 86_400_000
# 1900-01-01 and 2101-01-01 in epoch millis
MS_LO, MS_HI = -2_208_988_800_000, 4_133_980_800_000
DIM_TABLE = "dd_brands"
DIM_KEYS = 35  # p_brand runs to 39: keys 35..39 are missing


@pytest.fixture(autouse=True)
def _jax_dispatches_every_query(monkeypatch):
    monkeypatch.setenv("PINOT_TPU_SEGMENT_CACHE", "0")
    monkeypatch.setenv("PINOT_TPU_RESULT_CACHE", "0")
    monkeypatch.setenv("PINOT_TPU_MESH_DEVICES", "1")
    monkeypatch.setenv("PINOT_TPU_FUSED", "interpret")


def _cols(rng, rows, base):
    tags = [list(rng.integers(0, 60, k)) for k in rng.integers(1, 5, rows)]
    tags[:15] = [list(range(4 * j, 4 * j + 4)) for j in range(15)]
    return {
        "d_year": rng.integers(1992, 1999, rows).astype(np.int32),
        "s_region": np.asarray(REGIONS, dtype=object)[
            rng.integers(0, 5, rows)],
        "p_brand": rng.integers(0, 40, rows).astype(np.int32),
        "tags": tags,
        "lo_orderkey": base + np.arange(rows, dtype=np.int64),
        "lo_revenue": rng.integers(-500, 5000, rows).astype(np.int32),
        "lo_tax": np.round(rng.gamma(3.0, 9.0, rows), 2),
        "lo_qty": rng.integers(0, 50, rows).astype(np.float32) / 4,
    }


def _time_cols(rng, rows):
    """ts: a day of 1992-1998 (dictionary-encoded), tsr: millis from 1900
    to 2100 (raw), from a generator of their own."""
    return {"ts": rng.integers(8035, 10592, rows).astype(np.int64) * DAY,
            "tsr": rng.integers(MS_LO, MS_HI, rows).astype(np.int64)}


def _dim_cols():
    keys = np.arange(DIM_KEYS, dtype=np.int32)
    return {"b_id": keys,
            "b_cat": np.asarray([f"C{k % 7}" for k in keys], dtype=object),
            "b_rank": (keys * 3) % 17}


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    rng = np.random.default_rng(2026)
    schema = Schema.build(TABLE, dimensions=DIMS, metrics=METRICS)
    cfg = TableConfig(table_name=TABLE,
                      indexing=IndexingConfig(no_dictionary_columns=RAW))
    root = tmp_path_factory.mktemp("torch_differential")
    paths = []
    for i, rows in enumerate(SIZES):
        cols = _cols(rng, rows, 100_000 * i)
        cols.update(_time_cols(np.random.default_rng(1000 + i), rows))
        SegmentBuilder(schema, cfg, f"s{i}").build(cols, root / f"s{i}")
        paths.append(root / f"s{i}")
    port = QueryExecutor(device="cpu")
    port.add_table(schema, [load_segment(p) for p in paths])
    jax = JaxQueryExecutor(backend="tpu")
    jax.add_table(JaxSchema.build(TABLE, dimensions=DIMS, metrics=METRICS),
                  [jax_load(p) for p in paths])
    dim_tables.register_dimension_table(DIM_TABLE, "b_id", _dim_cols())
    jax_dim_tables.register_dimension_table(DIM_TABLE, "b_id", _dim_cols())
    yield port, jax, paths
    dim_tables.unregister_dimension_table(DIM_TABLE)
    jax_dim_tables.unregister_dimension_table(DIM_TABLE)


def _tags(r, k):
    return ", ".join(str(int(t)) for t in r.integers(0, 64, k))


# each template draws its literals from the generator it is given
TEMPLATES = [
    lambda r: (f"SELECT lo_orderkey, lo_revenue FROM d WHERE d_year = "
               f"{r.integers(1991, 2000)} AND lo_qty < {r.integers(0, 14)} "
               f"LIMIT {r.integers(1, 60)}"),
    lambda r: (f"SELECT d_year, lo_tax, lo_orderkey FROM d WHERE lo_revenue "
               f"BETWEEN {r.integers(-500, 2000)} AND {r.integers(2000, 5000)} "
               f"ORDER BY lo_tax DESC, lo_orderkey LIMIT {r.integers(1, 40)}"),
    lambda r: (f"SELECT s_region, p_brand, lo_orderkey FROM d WHERE p_brand "
               f"IN ({r.integers(0, 40)}, {r.integers(0, 40)}) ORDER BY "
               f"s_region, p_brand DESC LIMIT {r.integers(1, 50)} "
               f"OFFSET {r.integers(0, 30)}"),
    lambda r: (f"SELECT lo_revenue * {r.integers(1, 5)}, d_year FROM d WHERE "
               f"s_region <> '{REGIONS[r.integers(0, 4)]}' ORDER BY d_year, "
               f"lo_orderkey + 0 LIMIT {r.integers(1, 30)}"),
    lambda r: (f"SELECT d_year, s_region, p_brand, lo_orderkey, lo_revenue, "
               f"lo_tax, lo_qty FROM d WHERE tags IN ({_tags(r, 3)}) "
               f"AND lo_orderkey > {r.integers(0, 300_000)} "
               f"LIMIT {r.integers(1, 20)}"),
    lambda r: (f"SELECT lo_orderkey FROM d WHERE tags = {r.integers(0, 64)} "
               f"OR d_year = {r.integers(1990, 1999)} LIMIT {r.integers(1, 90)} "
               f"OFFSET {r.integers(0, 900)}"),
    lambda r: (f"SELECT d_year, COUNT(*), SUM(lo_revenue) FROM d WHERE tags "
               f"NOT IN ({_tags(r, 4)}) GROUP BY d_year"),
    lambda r: (f"SELECT s_region, COUNT(*), MAX(lo_tax) FROM d WHERE tags "
               f"BETWEEN {r.integers(0, 30)} AND {r.integers(30, 64)} "
               f"GROUP BY s_region"),
    lambda r: (f"SELECT tags, COUNT(*), SUM(lo_revenue), MIN(lo_qty) FROM d "
               f"WHERE d_year >= {r.integers(1992, 1999)} GROUP BY tags "
               f"ORDER BY COUNT(*) DESC, tags LIMIT {r.integers(1, 70)}"),
    lambda r: (f"SELECT p_brand, tags, COUNT(*) FROM d WHERE lo_tax < "
               f"{r.integers(5, 60)} GROUP BY p_brand, tags ORDER BY p_brand, "
               f"tags LIMIT {r.integers(1, 200)}"),
    lambda r: (f"SELECT d_year, COUNTMV(tags), SUMMV(tags), MINMV(tags), "
               f"MAXMV(tags), AVGMV(tags) FROM d WHERE p_brand < "
               f"{r.integers(0, 41)} GROUP BY d_year"),
    lambda r: (f"SELECT COUNTMV(tags), SUMMV(tags), MINMAXRANGEMV(tags) "
               f"FROM d WHERE tags IN ({_tags(r, 2)}) "
               f"AND s_region = '{REGIONS[r.integers(0, 4)]}'"),
    lambda r: (f"SET sparseGroupBy = true; SELECT tags, COUNT(*), "
               f"MAX(lo_revenue) FROM d WHERE lo_revenue > {r.integers(-500, 4000)} "
               f"GROUP BY tags ORDER BY tags LIMIT {r.integers(1, 70)}"),
    lambda r: (f"SELECT d_year, COUNT(*) FROM d WHERE d_year = "
               f"{r.integers(1985, 1992)} OR lo_orderkey < "
               f"{r.integers(-5, 0)} GROUP BY d_year"),
]


_UNITS = ["MONTH", "QUARTER", "YEAR", "WEEK"]
_LOOKUP = f"LOOKUP('{DIM_TABLE}', '{{}}', 'b_id', p_brand)"
# the GROUP BY keys of x9: the JAX device planner takes a transform of a
# dictionary column, refuses one of a raw column (tsr) and a two-column
# transform past the 2^18 LUT limit
_KEYS = ["YEAR(tsr)", "YEAR(ts)", "toEpochDays(tsr)", "MONTH(ts) + d_year",
         "lo_orderkey - toEpochDays(ts)", "CONCAT(s_region, p_brand, '/')"]

def _datetrunc_query(r, unit):
    return (f"SELECT DATETRUNC('{unit}', ts), COUNT(*), SUM(lo_revenue) "
            f"FROM d WHERE s_region = '{REGIONS[r.integers(0, 4)]}' "
            f"GROUP BY DATETRUNC('{unit}', ts) ORDER BY DATETRUNC('{unit}', "
            f"ts) LIMIT {r.integers(1, 400)}")


def _key_query(r, key):
    return (f"SELECT {key}, COUNT(*) FROM d WHERE d_year > "
            f"{r.integers(1990, 1998)} GROUP BY {key} ORDER BY "
            f"COUNT(*) DESC, {key} LIMIT 50")


# (the selections keep a matching row: with every segment pruned, the JAX
# package's reduce fails on a selection's transform columns)
TRANSFORM_TEMPLATES = [
    lambda r: (f"SELECT d_year, COUNT(*), SUM(toEpochDays(tsr) - "
               f"toEpochDays(ts)) FROM d WHERE MONTH(tsr) = "
               f"{r.integers(1, 13)} GROUP BY d_year"),
    lambda r: _datetrunc_query(r, _UNITS[r.integers(0, 4)]),
    lambda r: (f"SELECT COUNT(*), MIN(HOUR(tsr)), MAX(DAYOFWEEK(tsr)), "
               f"SUM(MINUTE(tsr)) FROM d WHERE YEAR(tsr) BETWEEN "
               f"{r.integers(1890, 2000)} AND {r.integers(2000, 2110)} AND "
               f"DAYOFWEEK(tsr) <> {r.integers(1, 8)}"),
    lambda r: (f"SELECT UPPER(s_region), COUNT(*), MAX(lo_tax) FROM d WHERE "
               f"SUBSTR(s_region, 0, {r.integers(1, 3)}) IN ('A', 'AS', 'EU', "
               f"'{['AF', 'n', 'nu'][r.integers(0, 3)]}') "
               f"GROUP BY UPPER(s_region)"),
    lambda r: (f"SELECT {_LOOKUP.format('b_cat')}, SUM(lo_revenue), COUNT(*) "
               f"FROM d WHERE {_LOOKUP.format('b_rank')} > "
               f"{r.integers(-1, 17)} AND d_year >= {r.integers(1992, 1999)} "
               f"GROUP BY {_LOOKUP.format('b_cat')}"),
    lambda r: (f"SELECT d_year, ROUNDDECIMAL(SUM(lo_tax) / COUNT(*), "
               f"{r.integers(0, 4)}), TRUNCATE(AVG(lo_qty), 1), "
               f"todatetime(MAX(ts), 'yyyy-MM-dd') FROM d WHERE p_brand < "
               f"{r.integers(1, 41)} GROUP BY d_year ORDER BY d_year"),
    lambda r: (f"SELECT s_region, COUNT(*) FROM d GROUP BY s_region HAVING "
               f"ROUND(SUM(lo_revenue) / 1000) > {r.integers(0, 6000)} "
               f"ORDER BY s_region"),
    lambda r: (f"SELECT lo_orderkey, toDateTime(tsr, 'yyyy-MM-dd'), "
               f"CONCAT(s_region, 'x', '-') FROM d WHERE d_year = "
               f"{r.integers(1992, 1999)} ORDER BY lo_orderkey "
               f"LIMIT {r.integers(1, 50)}"),
    lambda r: (f"SELECT lo_orderkey, YEAR(ts), LOWER(s_region) FROM d WHERE "
               f"lo_qty < {r.integers(1, 14)} ORDER BY YEAR(ts) DESC, "
               f"lo_orderkey LIMIT {r.integers(1, 60)}"),
    lambda r: _key_query(r, _KEYS[r.integers(0, len(_KEYS))]),
]


def _queries(templates=TEMPLATES, prefix="t", seed=20261017,
             per_template=PER_TEMPLATE):
    rng = np.random.default_rng(seed)
    out = []
    for t, make in enumerate(templates):
        for i in range(per_template):
            sql = make(rng)
            if i % 2:
                sql = "SET segmentBatch = false; " + sql
            out.append(pytest.param(sql, id=f"{prefix}{t}-{i}"))
    return out


def _cell_equal(a, b):
    if isinstance(a, float) or isinstance(b, float):
        a, b = float(a), float(b)
        if math.isnan(a) or math.isnan(b):
            return math.isnan(a) and math.isnan(b)
        return math.isclose(a, b, rel_tol=1e-12)
    return a == b


@pytest.mark.parametrize("sql", _queries())
def test_random_query_matches_jax(tables, sql):
    _assert_matches_jax(*tables[:2], sql)


@pytest.mark.parametrize("sql", _queries(TRANSFORM_TEMPLATES, "x", 20261018,
                                         20))
def test_random_transform_query_matches_jax(tables, sql):
    port, jax, paths = tables
    refused = False
    for p in paths:
        try:
            JaxPlanner(jax_parse(sql), jax_load(p)).plan()
        except JaxUnsupportedQueryError:
            refused = True
    if refused and jax.execute_sql(sql).exceptions:
        # neither package's multi-stage engine answers it either
        with pytest.raises(UnsupportedQueryError):
            port.execute_sql(sql)
    else:
        # a planner refusal is answered by both multi-stage engines
        _assert_matches_jax(port, jax, sql)


def _assert_matches_jax(port, jax, sql):
    want = jax.execute_sql(sql)
    assert not want.exceptions, want.exceptions
    got = port.execute_sql(sql)
    g, w = got.result_table.rows, want.result_table.rows
    ordered = "ORDER BY" in sql or "GROUP BY" not in sql
    if not ordered:
        g, w = sorted(g, key=repr), sorted(w, key=repr)
    assert len(g) == len(w)
    for rg, rw in zip(g, w):
        assert len(rg) == len(rw)
        assert all(_cell_equal(a, b) for a, b in zip(rg, rw)), (rg, rw)
    assert got.result_table.schema.to_json() == \
        want.result_table.schema.to_json()
    assert got.num_docs_scanned == want.num_docs_scanned
    assert got.num_segments_pruned == want.num_segments_pruned
    assert got.num_device_dispatches == want.num_device_dispatches


# -- GAPFILL -----------------------------------------------------------------
# yearly buckets of the day column over 1992-1998 (365-day buckets: a leap
# year's DATETRUNC snaps onto the grid), years dropped by the filter left
# as gaps to fill, with and without a series key

_GAPFILL = ("gapfill(DATETRUNC('YEAR', ts), '694224000000', '915148800000', "
            "'31536000000')")
GAPFILL_TEMPLATES = [
    lambda r: (f"SELECT {_GAPFILL}, fill(COUNT(*), 'FILL_PREVIOUS_VALUE'), "
               f"fill(SUM(lo_revenue), 'FILL_DEFAULT_VALUE'), MAX(p_brand) "
               f"FROM d WHERE YEAR(ts) NOT IN ({r.integers(1992, 1999)}, "
               f"{r.integers(1992, 1999)}) AND p_brand < "
               f"{r.integers(5, 41)} GROUP BY {_GAPFILL} "
               f"LIMIT {r.integers(3, 12)}"),
    lambda r: (f"SELECT {_GAPFILL}, d_year, fill(SUM(lo_revenue), "
               f"'FILL_PREVIOUS_VALUE') FROM d WHERE d_year IN "
               f"({r.integers(1992, 1999)}, {r.integers(1992, 1999)}) AND "
               f"YEAR(ts) <> {r.integers(1992, 1999)} GROUP BY {_GAPFILL}, "
               f"d_year LIMIT {r.integers(5, 20)}"),
]


@pytest.mark.parametrize("sql", _queries(GAPFILL_TEMPLATES, "g", 20261022, 6))
def test_random_gapfill_query_matches_jax(tables, sql):
    """Filled rows in the reference's order (time-major, then series), with
    OFFSET/LIMIT applied after filling."""
    port, jax, _ = tables
    want = jax.execute_sql(sql)
    assert not want.exceptions, want.exceptions
    got = port.execute_sql(sql)
    assert got.result_table.rows == want.result_table.rows
    assert got.result_table.schema.to_json() == \
        want.result_table.schema.to_json()
    assert got.num_device_dispatches == want.num_device_dispatches


# a selection ordered by a column it does not select: the single-stage
# engine refuses it while planning and the multi-stage engine answers
@pytest.mark.parametrize("sql,rows", [
    ("SELECT lo_orderkey FROM d ORDER BY lo_revenue DESC, lo_orderkey "
     "LIMIT 5", [[20], [100409], [302847], [301688], [300283]]),
    ("SELECT lo_orderkey, d_year FROM d WHERE d_year = 1993 ORDER BY "
     "p_brand, lo_orderkey LIMIT 3", None),
])
def test_order_by_unselected_column_matches_jax(tables, sql, rows):
    port, jax, _ = tables
    want = jax.execute_sql(sql)
    assert not want.exceptions, want.exceptions
    got = port.execute_sql(sql)
    assert not got.exceptions and got.mse_stage_stats is not None
    assert got.result_table.rows == want.result_table.rows
    assert got.result_table.schema.to_json() == \
        want.result_table.schema.to_json()
    if rows is not None:
        assert got.result_table.rows == rows


# -- index predicates and star-tree GROUP BYs --------------------------------
# a second table: JSON, text, map and vector index columns and a star-tree,
# segments of unequal sizes, one with a null in a split dimension (its tree
# cannot answer, so that segment scans its rows while the others read their
# pre-aggregated views)

INDEX_TABLE = "dx"
INDEX_SIZES = [1500, 1500, 900, 4000]
INDEX_DIMS = [("d_year", "INT"), ("s_region", "STRING"), ("p_brand", "INT"),
              ("attrs", "JSON"), ("msg", "STRING"), ("props", "STRING"),
              ("emb", "FLOAT", False)]
INDEX_METRICS = [("lo_revenue", "INT"), ("lo_qty", "INT")]
INDEX_TREE = {"dimensionsSplitOrder": ["d_year", "s_region", "p_brand"],
              "functionColumnPairs": ["COUNT__*", "SUM__lo_revenue",
                                      "SUM__lo_qty", "MIN__lo_qty",
                                      "MAX__lo_qty"]}
INDEX_WORDS = ["connection", "reset", "time", "timeout", "error", "disk"] + [
    f"w{i}" for i in range(20)]
INDEX_OS = ["ios", "android", "linux"]
EMB_DIM = 6


def _index_cols(rng, rows, null_region):
    attrs, props = [], []
    for i in range(rows):
        attrs.append(json.dumps({
            "os": INDEX_OS[rng.integers(0, 3)], "ver": int(rng.integers(1, 5)),
            "tags": [f"t{t}" for t in rng.integers(0, 8, rng.integers(0, 3))]}))
        m = {"dwell": float(np.round(rng.random() * 40, 1))}
        if i % 9:
            m["clicks"] = int(rng.integers(0, 51))
        props.append(json.dumps(m))
    words = np.asarray(INDEX_WORDS, dtype=object)
    regions = list(np.asarray(REGIONS[:4], dtype=object)[
        rng.integers(0, 4, rows)])
    if null_region:
        regions[3] = None
    return {
        "d_year": rng.integers(1992, 1999, rows).astype(np.int32),
        "s_region": regions,
        "p_brand": rng.integers(0, 12, rows).astype(np.int32),
        "attrs": attrs, "props": props,
        "msg": [" ".join(words[rng.integers(0, len(words),
                                            rng.integers(1, 7))])
                for _ in range(rows)],
        "emb": [list(v) for v in rng.normal(size=(rows, EMB_DIM)).astype(
            np.float32)],
        "lo_revenue": rng.integers(-500, 5000, rows).astype(np.int32),
        "lo_qty": rng.integers(0, 50, rows).astype(np.int32),
    }


@pytest.fixture(scope="module")
def index_tables(tmp_path_factory):
    rng = np.random.default_rng(2027)
    schema = Schema.build(INDEX_TABLE, dimensions=INDEX_DIMS,
                          metrics=INDEX_METRICS)
    cfg = TableConfig(table_name=INDEX_TABLE, indexing=IndexingConfig(
        no_dictionary_columns=["lo_revenue", "lo_qty"],
        star_tree_index_configs=[INDEX_TREE], json_index_columns=["attrs"],
        text_index_columns=["msg"], vector_index_columns=["emb"],
        custom_index_configs={"props": {"type": "map", "maxKeys": 4}}))
    root = tmp_path_factory.mktemp("torch_differential_index")
    paths = []
    for i, rows in enumerate(INDEX_SIZES):
        SegmentBuilder(schema, cfg, f"x{i}").build(
            _index_cols(rng, rows, null_region=i == 2), root / f"x{i}")
        paths.append(root / f"x{i}")
    port = QueryExecutor(device="cpu")
    port.add_table(schema, [load_segment(p) for p in paths])
    jax = JaxQueryExecutor(backend="tpu")
    jax.add_table(JaxSchema.build(INDEX_TABLE, dimensions=INDEX_DIMS,
                                  metrics=INDEX_METRICS),
                  [jax_load(p) for p in paths])
    return port, jax


def _vec(r):
    return "ARRAY[" + ", ".join(f"{x:.4f}" for x in r.normal(size=EMB_DIM)) \
        + "]"


def _os(r):
    return INDEX_OS[r.integers(0, 3)]


def _word(r):
    return INDEX_WORDS[r.integers(0, len(INDEX_WORDS))]


INDEX_TEMPLATES = [
    lambda r: (f"SELECT d_year, COUNT(*), SUM(lo_revenue) FROM dx WHERE "
               f"JSON_MATCH(attrs, '\"$.os\" = ''{_os(r)}'' AND "
               f"\"$.tags[*]\" = ''t{r.integers(0, 8)}''') AND d_year >= "
               f"{r.integers(1992, 1999)} GROUP BY d_year"),
    lambda r: (f"SELECT COUNT(*), SUM(lo_qty), MIN(lo_revenue) FROM dx WHERE "
               f"TEXT_MATCH(msg, '\"{_word(r)} {_word(r)}\" OR "
               f"{_word(r)[:2]}*') AND lo_qty < {r.integers(1, 50)}"),
    lambda r: (f"SELECT s_region, COUNT(*), SUM(lo_revenue) FROM dx WHERE "
               f"mapValue(props, 'clicks') > {r.integers(0, 50)} AND "
               f"s_region <> '{REGIONS[r.integers(0, 4)]}' GROUP BY s_region"),
    lambda r: (f"SELECT d_year, COUNT(*) FROM dx WHERE VECTOR_SIMILARITY(emb, "
               f"{_vec(r)}, {r.integers(1, 60)}) AND lo_revenue > "
               f"{r.integers(-500, 3000)} GROUP BY d_year"),
    lambda r: (f"SELECT p_brand, lo_revenue FROM dx WHERE JSON_MATCH(attrs, "
               f"'\"$.ver\" IN ({r.integers(1, 5)}, {r.integers(1, 5)})') "
               f"AND TEXT_MATCH(msg, '{_word(r)}') ORDER BY lo_revenue DESC, "
               f"p_brand LIMIT {r.integers(1, 30)}"),
    lambda r: (f"SELECT COUNT(*) FROM dx WHERE NOT TEXT_MATCH(msg, "
               f"'{_word(r)}') OR mapValue(props, 'dwell') BETWEEN "
               f"{r.integers(0, 20)} AND {r.integers(20, 41)}"),
]
STAR_TEMPLATES = [
    lambda r: (f"SELECT d_year, SUM(lo_revenue), COUNT(*) FROM dx WHERE "
               f"s_region IN ('{REGIONS[r.integers(0, 4)]}', "
               f"'{REGIONS[r.integers(0, 4)]}') GROUP BY d_year"),
    lambda r: (f"SELECT s_region, p_brand, MIN(lo_qty), MAX(lo_qty), "
               f"AVG(lo_revenue) FROM dx WHERE d_year BETWEEN "
               f"{r.integers(1991, 1996)} AND {r.integers(1995, 2000)} GROUP "
               f"BY s_region, p_brand ORDER BY s_region, p_brand "
               f"LIMIT {r.integers(1, 60)}"),
    lambda r: (f"SELECT COUNT(*), SUM(lo_qty), MINMAXRANGE(lo_qty) FROM dx "
               f"WHERE p_brand < {r.integers(0, 13)} AND NOT d_year = "
               f"{r.integers(1992, 1999)}"),
    lambda r: (f"SELECT p_brand, COUNT(*), SUM(lo_revenue) FROM dx GROUP BY "
               f"p_brand HAVING COUNT(*) > {r.integers(0, 700)} ORDER BY "
               f"SUM(lo_revenue) DESC, p_brand LIMIT {r.integers(1, 13)}"),
    lambda r: (f"SELECT d_year, s_region, AVG(lo_qty) FROM dx WHERE "
               f"s_region = '{REGIONS[r.integers(0, 4)]}' OR p_brand = "
               f"{r.integers(0, 12)} GROUP BY d_year, s_region"),
]


@pytest.mark.parametrize("sql", _queries(INDEX_TEMPLATES, "i", 20261019, 12))
def test_random_index_query_matches_jax(index_tables, sql):
    _assert_matches_jax(*index_tables, sql)


@pytest.mark.parametrize("sql", _queries(STAR_TEMPLATES, "s", 20261020, 12))
def test_random_star_tree_query_matches_jax(index_tables, sql):
    port, _ = index_tables
    routes = port.route_segments(parse_sql(sql),
                                 port.tables[INDEX_TABLE].segments)
    # every segment but the one with a null split dimension takes its tree
    assert [r.rewrite is not None for r in routes] == [True, True, False,
                                                       True]
    _assert_matches_jax(*index_tables, sql)


# -- multi-stage statements --------------------------------------------------
# joins (the fused device join forced on or off), IN / NOT IN subqueries,
# set operations, windows and derived tables over the first table; rows
# equal to the JAX package's multi-stage engine exactly (integer-gated on
# the device path, the same numpy operators elsewhere), with the same
# scanned docs and device dispatches

def _dj(r):
    return f"SET deviceJoin = {['true', 'false'][r.integers(0, 2)]}; "


def _years(r):
    return int(r.integers(1992, 1999))


MSE_TEMPLATES = [
    lambda r: (f"{_dj(r)}SELECT a.d_year, COUNT(*), SUM(b.lo_revenue), "
               f"MIN(b.lo_revenue), MAX(a.lo_revenue) FROM d a JOIN d b "
               f"ON a.p_brand = b.p_brand WHERE a.lo_revenue < "
               f"{r.integers(0, 500)} AND b.d_year = {_years(r)} AND "
               f"b.lo_revenue < {r.integers(0, 1500)} GROUP BY a.d_year "
               f"ORDER BY a.d_year"),
    lambda r: (f"{_dj(r)}SELECT a.d_year, COUNT(*), SUM(b.lo_revenue) "
               f"FROM d a LEFT JOIN d b ON a.p_brand = b.p_brand AND "
               f"b.d_year = {_years(r)} AND b.lo_revenue < "
               f"{r.integers(0, 400)} WHERE a.lo_revenue < "
               f"{r.integers(0, 400)} GROUP BY a.d_year ORDER BY a.d_year"),
    lambda r: (f"{_dj(r)}SELECT d_year, COUNT(*), SUM(lo_revenue) FROM d "
               f"WHERE lo_revenue < {r.integers(0, 2000)} AND p_brand "
               f"{['IN', 'NOT IN'][r.integers(0, 2)]} (SELECT p_brand FROM d "
               f"WHERE d_year = {_years(r)} AND lo_qty < "
               f"{r.integers(0, 4)}) GROUP BY d_year ORDER BY d_year"),
    lambda r: (f"SELECT p_brand FROM d WHERE d_year = {_years(r)} AND "
               f"lo_revenue < {r.integers(0, 900)} "
               f"{['UNION', 'UNION ALL', 'INTERSECT', 'EXCEPT'][r.integers(0, 4)]}"
               f" SELECT p_brand FROM d WHERE lo_revenue < "
               f"{r.integers(-500, 0)} ORDER BY p_brand LIMIT 100"),
    lambda r: (f"SELECT lo_orderkey, p_brand, RANK() OVER (PARTITION BY "
               f"p_brand ORDER BY lo_revenue DESC), SUM(lo_revenue) OVER "
               f"(PARTITION BY p_brand) FROM d WHERE d_year = {_years(r)} AND "
               f"lo_revenue < {r.integers(0, 600)} ORDER BY lo_orderkey "
               f"LIMIT 60"),
    lambda r: (f"SELECT t.p_brand, t.s, y.n FROM (SELECT p_brand, d_year, "
               f"SUM(lo_revenue) AS s FROM d WHERE lo_qty < "
               f"{r.integers(1, 6)} GROUP BY p_brand, d_year) t JOIN (SELECT "
               f"d_year, COUNT(*) AS n FROM d GROUP BY d_year) y ON "
               f"t.d_year = y.d_year WHERE t.d_year = {_years(r)} "
               f"ORDER BY t.p_brand"),
]


@pytest.mark.parametrize("sql", _queries(MSE_TEMPLATES, "m", 20261021, 8))
def test_random_multistage_statement_matches_jax(tables, sql):
    port, jax, _ = tables
    sql = "SET resultCache = false; " + sql
    want = jax.execute_sql(sql)
    assert not want.exceptions, want.exceptions
    got = port.execute_sql(sql)
    assert not got.exceptions, got.exceptions
    assert got.mse_stage_stats is not None
    norm = [[None if isinstance(v, float) and math.isnan(v) else v
             for v in row] for row in got.result_table.rows]
    assert norm == [[None if isinstance(v, float) and math.isnan(v) else v
                     for v in row] for row in want.result_table.rows]
    assert got.result_table.schema.to_json() == \
        want.result_table.schema.to_json()
    assert got.num_docs_scanned == want.num_docs_scanned
    assert got.num_device_dispatches == want.num_device_dispatches
