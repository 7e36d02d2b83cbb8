"""Star-tree pre-aggregation in the port against the JAX package.

On the CPU, over segments with a star-tree built by the port's builder
(and one built by the JAX builder, carried across to the port's loader):

  * `execute_sql` rows, scanned docs (the pre-aggregated rows read), device
    dispatches and host fetches equal the JAX package's, as one family of
    the segments' views and segment by segment, and the rows equal a full
    scan of the same rows without a tree;
  * the rewrite's eligibility is the JAX package's: a null split
    dimension, a filter on a column off the split order, an aggregation
    without a stored pair, a selection, advanced null handling and a null
    predicate all bypass the tree; COUNT and AVG share one count pair;
  * `use_star_tree = False` and upsert tables bypass the tree;
  * a view's planes are cached on the device under the view's own name.
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from pinot_tpu.engine.query_executor import QueryExecutor as JaxQueryExecutor
from pinot_tpu.ops import kernels as jax_kernels
from pinot_tpu.query.parser.sql import parse_sql as jax_parse
from pinot_tpu.segment.builder import SegmentBuilder as JaxBuilder
from pinot_tpu.segment.loader import load_segment as jax_load
from pinot_tpu.segment.startree import try_rewrite as jax_try_rewrite
from pinot_tpu.spi import table_config as jax_tc
from pinot_tpu.spi.data_types import Schema as JaxSchema
from pinot_tpu.upsert import TableUpsertMetadataManager as JaxUpsert
from pinot_tpu_torch.engine.query_executor import QueryExecutor
from pinot_tpu_torch.ops import kernels
from pinot_tpu_torch.query.parser.sql import parse_sql
from pinot_tpu_torch.segment.builder import SegmentBuilder
from pinot_tpu_torch.segment.loader import load_segment
from pinot_tpu_torch.segment.startree import StarTreeView, try_rewrite
from pinot_tpu_torch.spi import table_config as tc
from pinot_tpu_torch.spi.data_types import Schema
from pinot_tpu_torch.upsert import TableUpsertMetadataManager

N = 3000
SEGMENTS = 3
DIMS = [("country", "STRING"), ("browser", "STRING"), ("gender", "STRING"),
        ("age", "INT")]
METRICS = [("impressions", "INT"), ("cost", "DOUBLE")]
TREE = {"dimensionsSplitOrder": ["country", "browser", "gender"],
        "functionColumnPairs": ["COUNT__*", "SUM__impressions", "SUM__cost",
                                "MIN__impressions", "MAX__impressions"],
        "maxLeafRecords": 100}
COUNTRIES = ["US", "DE", "JP", "IN", "BR"]
BROWSERS = ["chrome", "firefox", "safari"]
GENDERS = ["F", "M", "U"]
QUERIES = [
    "SELECT country, SUM(impressions) FROM sales GROUP BY country",
    "SELECT country, browser, SUM(impressions), COUNT(*), SUM(cost) FROM "
    "sales GROUP BY country, browser LIMIT 100",
    "SELECT SUM(impressions), COUNT(*) FROM sales WHERE country = 'US'",
    "SELECT browser, AVG(cost), MIN(impressions), MAX(impressions) FROM sales "
    "WHERE country IN ('US', 'DE') GROUP BY browser",
    "SELECT gender, MINMAXRANGE(impressions) FROM sales GROUP BY gender",
    "SELECT COUNT(*) FROM sales WHERE country = 'US' AND browser <> 'safari'",
    "SELECT country, COUNT(*), AVG(cost) FROM sales GROUP BY country",
    "SELECT country, gender, COUNT(*) FROM sales WHERE browser BETWEEN 'c' "
    "AND 'g' OR gender = 'U' GROUP BY country, gender ORDER BY "
    "COUNT(*) DESC, country, gender LIMIT 7",
    "SELECT browser, SUM(impressions) FROM sales WHERE NOT country = 'JP' "
    "GROUP BY browser HAVING SUM(impressions) > 10 ORDER BY browser",
    "SELECT MAX(impressions), MIN(impressions), SUM(cost) FROM sales WHERE "
    "gender IN ('F', 'M') AND country LIKE '%E%'",
]
# each bypasses the tree: (sql, reason)
BYPASS = [
    ("SELECT SUM(impressions) FROM sales WHERE cost > 5", "filter off split"),
    ("SELECT SUM(impressions) FROM sales WHERE age = 30", "filter off split"),
    ("SELECT DISTINCTCOUNT(country) FROM sales", "unstored aggregation"),
    ("SELECT MIN(cost) FROM sales", "no MIN pair for cost"),
    ("SELECT MAX(cost) FROM sales GROUP BY country", "no MAX pair for cost"),
    ("SELECT AVG(age) FROM sales", "no SUM pair for age"),
    ("SELECT age, COUNT(*) FROM sales GROUP BY age", "group off split"),
    ("SELECT country FROM sales LIMIT 5", "selection"),
    ("SELECT DISTINCT country FROM sales", "distinct"),
    ("SELECT UPPER(country), COUNT(*) FROM sales GROUP BY UPPER(country)",
     "group by expression"),
    ("SELECT COUNT(*) FROM sales WHERE country IS NOT NULL", "null predicate"),
    ("SET enableNullHandling = true; SELECT COUNT(*) FROM sales",
     "null handling"),
    ("SELECT SUM(impressions * 2) FROM sales", "expression argument"),
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


def _cols(seed, n, null_gender=False):
    r = np.random.default_rng(seed)
    cols = {
        "country": np.asarray(COUNTRIES, dtype=object)[r.integers(0, 5, n)],
        "browser": np.asarray(BROWSERS, dtype=object)[r.integers(0, 3, n)],
        "gender": np.asarray(GENDERS, dtype=object)[r.integers(0, 3, n)],
        "age": r.integers(18, 70, n).astype(np.int32),
        "impressions": r.integers(0, 1000, n).astype(np.int32),
        "cost": np.round(r.random(n) * 50, 2),
    }
    if null_gender:
        cols["gender"] = list(cols["gender"])
        cols["gender"][5] = None
    return cols


def _schema(mod, name="sales", pk=None):
    return mod.build(name, dimensions=DIMS, metrics=METRICS,
                     primary_key_columns=pk)


def _config(mod, tree=True, **kw):
    return mod.TableConfig(table_name="sales", indexing=mod.IndexingConfig(
        no_dictionary_columns=["cost"],
        star_tree_index_configs=[TREE] if tree else []), **kw)


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    """Port and JAX executors over the same star-tree segments (the port's
    builder), and the port over the same rows without a tree."""
    root = tmp_path_factory.mktemp("torch_startree")
    tree, plain = [], []
    for i in range(SEGMENTS):
        cols = _cols(i, N)
        SegmentBuilder(_schema(Schema), _config(tc), f"st_{i}").build(
            cols, root / f"st_{i}")
        SegmentBuilder(_schema(Schema), _config(tc, tree=False),
                       f"plain_{i}").build(cols, root / f"plain_{i}")
        tree.append(root / f"st_{i}")
        plain.append(root / f"plain_{i}")
    port = QueryExecutor(device="cpu")
    port.add_table(_schema(Schema), [load_segment(p) for p in tree])
    jax = JaxQueryExecutor(backend="tpu")
    jax.add_table(_schema(JaxSchema), [jax_load(p) for p in tree])
    scan = QueryExecutor(device="cpu")
    scan.add_table(_schema(Schema), [load_segment(p) for p in plain])
    return port, jax, scan, root


def _rows_equal(got, want, ordered):
    if not ordered:
        got, want = sorted(got, key=repr), sorted(want, key=repr)
    assert len(got) == len(want)
    for rg, rw in zip(got, want):
        assert len(rg) == len(rw)
        for a, b in zip(rg, rw):
            if isinstance(a, float) or isinstance(b, float):
                # pre-aggregation adds float sums in another order
                assert math.isclose(float(a), float(b), rel_tol=1e-12), (rg, rw)
            else:
                assert a == b, (rg, rw)


def _matches_jax(port, jax, sql, jax_fetches=1):
    """The port's answer equals the JAX package's; one host fetch. The
    JAX package fetches outputs of unequal lengths one by one
    (`jax_fetches`), the port copies every output of a query at once."""
    before = kernels.host_fetches()
    got = port.execute_sql(sql)
    fetches = kernels.host_fetches() - before
    jbefore = jax_kernels.host_fetches()
    want = jax.execute_sql(sql)
    assert not want.exceptions, want.exceptions
    assert fetches == 1
    assert jax_kernels.host_fetches() - jbefore == jax_fetches
    _rows_equal(got.result_table.rows, want.result_table.rows,
                "ORDER BY" in sql)
    assert got.result_table.schema.to_json() == \
        want.result_table.schema.to_json()
    assert got.num_docs_scanned == want.num_docs_scanned
    assert got.num_device_dispatches == want.num_device_dispatches
    return got


@pytest.mark.parametrize("batch", [True, False], ids=["family", "solo"])
@pytest.mark.parametrize("sql", QUERIES)
def test_star_tree_matches_jax_and_full_scan(tables, sql, batch):
    port, jax, scan, _ = tables
    if not batch:
        sql = "SET segmentBatch = false; " + sql
    got = _matches_jax(port, jax, sql)
    assert got.num_device_dispatches == (1 if batch else SEGMENTS)
    full = scan.execute_sql(sql)
    _rows_equal(got.result_table.rows, full.result_table.rows,
                "ORDER BY" in sql)
    # the point of the tree: fewer docs scanned
    assert got.num_docs_scanned < full.num_docs_scanned


@pytest.mark.parametrize("sql,reason", BYPASS, ids=[r for _, r in BYPASS])
def test_rewrite_eligibility_matches_jax(tables, sql, reason):
    port, jax, _, _ = tables
    seg = port.tables["sales"].segments[0]
    jseg = jax.tables["sales"].segments[0]
    assert try_rewrite(parse_sql(sql), seg) is None, reason
    assert jax_try_rewrite(jax_parse(sql), jseg) is None, reason
    if "SELECT country FROM" not in sql:
        # no rewrite: the port scans the table's rows, as the JAX package
        got = _matches_jax(port, jax, sql)
        assert got.num_docs_scanned == port.execute(
            parse_sql(sql)).num_docs_scanned


@pytest.mark.parametrize("sql", QUERIES)
def test_rewritten_query_is_the_jax_rewrite(tables, sql):
    port, jax, _, _ = tables
    seg = port.tables["sales"].segments[0]
    jseg = jax.tables["sales"].segments[0]
    rw, jrw = try_rewrite(parse_sql(sql), seg), jax_try_rewrite(
        jax_parse(sql), jseg)
    assert str(rw.query) == str(jrw.query)
    assert [i for i, _ in rw.state_builders] == \
        [i for i, _ in jrw.state_builders]
    assert rw.view.name == jrw.view.name == "st_0:st0"


def test_count_and_avg_share_the_count_pair(tables):
    port, jax, _, _ = tables
    sql = "SELECT country, COUNT(*), AVG(cost) FROM sales GROUP BY country"
    rw = try_rewrite(parse_sql(sql), port.tables["sales"].segments[0])
    assert [str(a) for a in rw.query.aggregations] == [
        "sum(__count__star)", "sum(__sum__cost)"]
    assert [i for i, _ in rw.state_builders] == [[0], [1, 0]]
    _matches_jax(port, jax, sql)


def test_null_split_dimension_bypasses_the_tree(tmp_path):
    """A segment whose split dimension holds a null folded it into the
    default value: the tree cannot answer, in either package; the other
    segments still take theirs."""
    paths = []
    for i, nulls in enumerate((True, False)):
        SegmentBuilder(_schema(Schema), _config(tc), f"n_{i}").build(
            _cols(10 + i, 800, null_gender=nulls), tmp_path / f"n_{i}")
        paths.append(tmp_path / f"n_{i}")
    port = QueryExecutor(device="cpu")
    port.add_table(_schema(Schema), [load_segment(p) for p in paths])
    jax = JaxQueryExecutor(backend="tpu")
    jax.add_table(_schema(JaxSchema), [jax_load(p) for p in paths])
    sql = "SELECT gender, COUNT(*), SUM(impressions) FROM sales GROUP BY gender"
    routes = port.route_segments(parse_sql(sql), port.tables["sales"].segments)
    assert [r.rewrite is None for r in routes] == [True, False]
    # a view and a segment: no family, two outputs of unequal lengths
    got = _matches_jax(port, jax, sql, jax_fetches=2)
    assert got.num_device_dispatches == 2


def test_use_star_tree_off_scans_the_rows(tables):
    port, jax, scan, _ = tables
    sql = "SELECT country, SUM(impressions) FROM sales GROUP BY country"
    fast = port.execute_sql(sql)
    port.use_star_tree = jax.use_star_tree = False
    try:
        full = _matches_jax(port, jax, sql)
    finally:
        port.use_star_tree = jax.use_star_tree = True
    assert full.num_docs_scanned == scan.execute_sql(sql).num_docs_scanned
    assert fast.num_docs_scanned < full.num_docs_scanned
    _rows_equal(fast.result_table.rows, full.result_table.rows, False)


def test_upsert_table_bypasses_the_tree(tmp_path):
    """Pre-aggregates ignore upsert validity: a committed segment of an
    upsert table scans its valid rows, in both packages."""
    r = np.random.default_rng(4)
    cols = _cols(4, 600)
    cols["pk"] = [f"k{i}" for i in r.integers(0, 200, 600)]
    cols["ts"] = np.arange(600, dtype=np.int64)
    dims = DIMS + [("pk", "STRING")]
    schema = Schema.build("sales", dimensions=dims, metrics=METRICS,
                          date_times=[("ts", "LONG")],
                          primary_key_columns=["pk"])
    jschema = JaxSchema.build("sales", dimensions=dims, metrics=METRICS,
                              date_times=[("ts", "LONG")],
                              primary_key_columns=["pk"])
    up = dict(mode="FULL", comparison_columns=["ts"])
    SegmentBuilder(schema, _config(tc), "u_0").build(cols, tmp_path / "u_0")
    seg, jseg = load_segment(tmp_path / "u_0"), jax_load(tmp_path / "u_0")
    TableUpsertMetadataManager(schema, _config(
        tc, upsert=tc.UpsertConfig(**up))).add_segment(seg)
    JaxUpsert(jschema, _config(
        jax_tc, upsert=jax_tc.UpsertConfig(**up))).add_segment(jseg)
    port = QueryExecutor(device="cpu")
    port.add_table(schema, [seg])
    jax = JaxQueryExecutor(backend="tpu")
    jax.add_table(jschema, [jseg])
    sql = "SELECT country, COUNT(*), SUM(impressions) FROM sales GROUP BY country"
    assert try_rewrite(parse_sql(sql), seg) is not None
    assert port.route_segments(parse_sql(sql), [seg])[0].rewrite is None
    got = _matches_jax(port, jax, sql)
    assert got.num_docs_scanned == len(set(cols["pk"]))


def test_jax_built_segments_answer_the_same(tables, tmp_path):
    """The data carried across: star-tree segments the JAX builder wrote,
    read by the port's loader, answer as in the JAX package."""
    paths = []
    for i in range(2):
        JaxBuilder(_schema(JaxSchema), _config(jax_tc), f"j_{i}").build(
            _cols(20 + i, 1000), tmp_path / f"j_{i}")
        paths.append(tmp_path / f"j_{i}")
    port = QueryExecutor(device="cpu")
    port.add_table(_schema(Schema), [load_segment(p) for p in paths])
    jax = JaxQueryExecutor(backend="tpu")
    jax.add_table(_schema(JaxSchema), [jax_load(p) for p in paths])
    for sql in QUERIES[:4]:
        _matches_jax(port, jax, sql)


def test_views_cached_on_the_device_under_their_name(tables):
    port = tables[0]
    port.execute_sql(QUERIES[1])
    views = [v for v in port.executor.cache._views.values()
             if isinstance(v.segment, StarTreeView)]
    assert sorted(v.segment.name for v in views) == [
        f"st_{i}:st0" for i in range(SEGMENTS)]
    before = port.executor.cache.bytes_used()
    port.execute_sql(QUERIES[1])  # warm: nothing uploaded again
    assert port.executor.cache.bytes_used() == before
    seg = port.tables["sales"].segments[0]
    assert seg.star_trees() is seg.star_trees()
