"""Segment pruning of the port against the JAX package.

Segments built by the JAX builder carry min/max metadata, partition stamps
(modulo on an INT column, murmur on a STRING one) and bloom filters; the
port reads that shared format. On the CPU:

  * `SegmentPrunerService.prune` keeps exactly the segments the JAX
    package's pruner keeps, for EQ, IN, RANGE, AND, OR, NOT and constant
    filters;
  * `execute_sql` gives the JAX package's rows, `num_segments_pruned`,
    `num_segments_processed`, scanned docs and device dispatches on
    partly and wholly pruned queries, batched and with
    `SET segmentBatch = false`; a query with every segment pruned makes no
    dispatch and shapes its empty result as the reference does
    (`[[0, []]]` for COUNT(*) with HISTOGRAM);
  * the partition functions and bloom filters of the port equal the JAX
    package's on the same values.
"""

from __future__ import annotations

import numpy as np
import pytest

from pinot_tpu.engine.pruner import SegmentPrunerService as JaxPruner
from pinot_tpu.engine.query_executor import QueryExecutor as JaxQueryExecutor
from pinot_tpu.query.optimizer import optimize_filter as jax_optimize
from pinot_tpu.query.parser.sql import parse_sql as jax_parse
from pinot_tpu.segment.builder import SegmentBuilder as JaxBuilder
from pinot_tpu.segment.loader import load_segment as jax_load
from pinot_tpu.spi import partition as jax_partition
from pinot_tpu.spi.data_types import Schema as JaxSchema
from pinot_tpu.spi.table_config import IndexingConfig as JaxIndexing
from pinot_tpu.spi.table_config import TableConfig as JaxTableConfig
from pinot_tpu_torch.engine.pruner import SegmentPrunerService
from pinot_tpu_torch.engine.query_executor import QueryExecutor
from pinot_tpu_torch.query.optimizer import optimize_filter
from pinot_tpu_torch.query.parser.sql import parse_sql
from pinot_tpu_torch.segment.loader import load_segment
from pinot_tpu_torch.spi import partition
from pinot_tpu_torch.spi.data_types import Schema

ROWS = 1000
SEGMENTS = 3
TABLE = "t"
DIMS = [("d_year", "INT"), ("p_brand", "INT"), ("s_city", "STRING"),
        ("s_nation", "STRING"), ("lo_orderkey", "INT")]
METRICS = [("lo_revenue", "INT"), ("x", "DOUBLE")]
CITIES = [f"city{i}" for i in range(40)]


@pytest.fixture(autouse=True)
def _jax_dispatches_every_query(monkeypatch):
    monkeypatch.setenv("PINOT_TPU_SEGMENT_CACHE", "0")
    monkeypatch.setenv("PINOT_TPU_MESH_DEVICES", "1")
    monkeypatch.setenv("PINOT_TPU_FUSED", "interpret")


def _cols(rng, k):
    """Segment k: years 1992 + 2k .. 1993 + 2k, brands of partition k
    (mod 4), its own cities (murmur partitions differ), nations of its
    own, order keys in a disjoint ascending range."""
    city = np.asarray(CITIES[10 * k:10 * k + 10], dtype=object)
    nation = np.asarray([f"N{k}_{j}" for j in range(3)], dtype=object)
    return {
        "d_year": rng.integers(1992 + 2 * k, 1994 + 2 * k, ROWS)
        .astype(np.int32),
        "p_brand": (4 * rng.integers(0, 25, ROWS) + k).astype(np.int32),
        "s_city": city[rng.integers(0, len(city), ROWS)],
        "s_nation": nation[rng.integers(0, 3, ROWS)],
        "lo_orderkey": (10_000 * k + np.arange(ROWS)).astype(np.int32),
        "lo_revenue": rng.integers(1, 600_000, ROWS).astype(np.int32),
        "x": np.round(rng.uniform(0, 100, ROWS), 2),
    }


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    rng = np.random.default_rng(41)
    jschema = JaxSchema.build(TABLE, dimensions=DIMS, metrics=METRICS)
    cfg = JaxTableConfig(table_name=TABLE, indexing=JaxIndexing(
        no_dictionary_columns=["lo_revenue", "x"],
        bloom_filter_columns=["s_nation", "lo_orderkey"],
        segment_partition_config={
            "p_brand": {"functionName": "modulo", "numPartitions": 4},
            "s_city": {"functionName": "murmur", "numPartitions": 8}}))
    root = tmp_path_factory.mktemp("torch_pruner")
    paths = []
    for k in range(SEGMENTS):
        JaxBuilder(jschema, cfg, f"s{k}").build(_cols(rng, k), root / f"s{k}")
        paths.append(root / f"s{k}")
    port = QueryExecutor(device="cpu")
    port.add_table(Schema.build(TABLE, dimensions=DIMS, metrics=METRICS),
                   [load_segment(p) for p in paths])
    jax = JaxQueryExecutor(backend="tpu")
    jax.add_table(jschema, [jax_load(p) for p in paths])
    return port, jax


FILTERS = [
    "d_year = 0",                                   # min/max: none
    "d_year = 1995",                                # min/max: segment 1
    "d_year IN (1992, 1997)",                       # min/max: 0 and 2
    "d_year IN (1, 2, 3)",
    "lo_orderkey BETWEEN 10100 AND 10200",          # range inside 1
    "lo_orderkey < 0",
    "lo_orderkey > 20998",
    "lo_orderkey >= 20999",
    "lo_orderkey > 20999",                          # exclusive edge
    "p_brand = 9",                                  # modulo partition 1
    "p_brand IN (2, 6, 11)",                        # partitions 2, 3
    "s_city = 'city25'",                            # murmur partitions
    "s_city IN ('city3', 'city39')",
    "s_nation = 'N2_1'",                            # bloom filter
    "s_nation = 'nowhere'",
    "s_nation IN ('N0_0', 'N1_2')",
    "d_year = 0 OR lo_orderkey < 5",
    "d_year = 1995 AND p_brand = 4",                # both hold, apart
    "NOT d_year = 0",                               # NOT proves nothing
    "d_year + 0 = 0",                               # expressions keep
    "x > 1000",                                     # raw min/max
]


@pytest.mark.parametrize("where", FILTERS)
def test_kept_segments_equal_jax(tables, where):
    port, jax = tables
    sql = f"SELECT COUNT(*) FROM {TABLE} WHERE {where}"
    q, jq = parse_sql(sql), jax_parse(sql)
    q.filter, jq.filter = optimize_filter(q.filter), jax_optimize(jq.filter)
    kept, pruned = SegmentPrunerService().prune(q, port.tables[TABLE].segments)
    jkept, jpruned = JaxPruner().prune(jq, jax.tables[TABLE].segments)
    assert [s.name for s in kept] == [s.name for s in jkept]
    assert pruned == jpruned


QUERIES = [
    # every segment pruned: no dispatch, the reference's empty shapes
    f"SELECT COUNT(*) FROM {TABLE} WHERE d_year = 0",
    f"SELECT COUNT(*), HISTOGRAM(x, 0, 100, 4) FROM {TABLE} "
    "WHERE lo_orderkey < 0",
    f"SELECT COUNT(*), SUM(lo_revenue), MAX(x), AVG(x) FROM {TABLE} "
    "WHERE s_nation = 'nowhere'",
    f"SELECT d_year, COUNT(*) FROM {TABLE} WHERE d_year = 0 GROUP BY d_year",
    f"SELECT DISTINCT s_city FROM {TABLE} WHERE p_brand = 1000",
    f"SELECT * FROM {TABLE} WHERE lo_orderkey > 99999 LIMIT 5",
    f"SELECT d_year, lo_revenue FROM {TABLE} WHERE d_year = 0 "
    "ORDER BY lo_revenue LIMIT 5",
    # partly pruned
    f"SELECT d_year, COUNT(*), SUM(lo_revenue) FROM {TABLE} "
    "WHERE p_brand IN (2, 6, 11) GROUP BY d_year",
    f"SELECT COUNT(*), HISTOGRAM(x, 0, 100, 4) FROM {TABLE} "
    "WHERE lo_orderkey BETWEEN 10100 AND 10200",
    f"SELECT s_nation, COUNT(*) FROM {TABLE} WHERE s_nation = 'N2_1' "
    "GROUP BY s_nation",
    f"SELECT lo_orderkey, x FROM {TABLE} WHERE d_year IN (1992, 1997) "
    "ORDER BY x DESC LIMIT 7",
    f"SELECT d_year, MIN(x) FROM {TABLE} WHERE s_city IN ('city3', 'city39') "
    "GROUP BY d_year",
]


@pytest.mark.parametrize("batch", [True, False])
@pytest.mark.parametrize("sql", QUERIES)
def test_execute_sql_matches_jax(tables, sql, batch):
    port, jax = tables
    if not batch:
        sql = "SET segmentBatch = false; " + sql
    got, want = port.execute_sql(sql), jax.execute_sql(sql)
    assert not want.exceptions, want.exceptions
    assert got.result_table.rows == want.result_table.rows
    assert got.result_table.schema.to_json() == \
        want.result_table.schema.to_json()
    assert got.num_segments_pruned == want.num_segments_pruned
    assert got.num_segments_processed == want.num_segments_processed
    assert got.num_segments_queried == SEGMENTS
    assert got.num_docs_scanned == want.num_docs_scanned
    assert got.num_device_dispatches == want.num_device_dispatches
    assert got.to_json()["numSegmentsPrunedByServer"] == \
        want.num_segments_pruned


def test_all_pruned_histogram_row(tables):
    """The all-pruned row of F1: the reference's empty aggregation
    state finalizes HISTOGRAM to an empty list; planning the segments
    anyway gave four zeros."""
    port, _ = tables
    got = port.execute_sql(f"SELECT COUNT(*), HISTOGRAM(x, 0, 100, 4) "
                           f"FROM {TABLE} WHERE lo_orderkey < 0")
    assert got.result_table.rows == [[0, []]]
    assert got.num_device_dispatches == 0
    assert got.num_segments_pruned == SEGMENTS
    assert got.num_segments_processed == 0
    # a filter the pruner cannot bound plans every segment
    kept = port.execute_sql(f"SELECT COUNT(*), HISTOGRAM(x, 0, 100, 4) "
                            f"FROM {TABLE} WHERE lo_orderkey + 0 < 0")
    assert kept.result_table.rows == [[0, [0.0, 0.0, 0.0, 0.0]]]
    assert kept.num_segments_pruned == 0


@pytest.mark.parametrize("name,n", [("modulo", 4), ("murmur", 8),
                                    ("hashcode", 5)])
def test_partition_functions_equal_jax(name, n):
    rng = np.random.default_rng(3)
    ints = rng.integers(-(1 << 31), 1 << 31, 200)
    strings = [f"v{i}" for i in rng.integers(0, 10_000, 200)]
    fn = partition.get_partition_function(name, n)
    jfn = jax_partition.get_partition_function(name, n)
    for vals in (ints, strings):
        if name == "modulo" and vals is strings:
            continue
        np.testing.assert_array_equal(fn.partitions_of(vals),
                                      jfn.partitions_of(vals))
        assert [fn.partition(v) for v in vals[:20]] == \
            [jfn.partition(v) for v in vals[:20]]


def test_bloom_filter_reads_as_jax(tables):
    port, jax = tables
    for pseg, jseg in zip(port.tables[TABLE].segments,
                          jax.tables[TABLE].segments):
        for col, probes in (("s_nation", ["N0_0", "N1_1", "N2_2", "x", ""]),
                            ("lo_orderkey", [0, 10_500, 20_999, -1, 5.0])):
            bf, jbf = pseg.get_bloom_filter(col), jseg.get_bloom_filter(col)
            assert (bf.num_bits, bf.num_hashes) == \
                (jbf.num_bits, jbf.num_hashes)
            for v in probes:
                assert bf.might_contain(v) == jbf.might_contain(v)
        assert pseg.get_bloom_filter("d_year") is None
