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
"""

from __future__ import annotations

import math

import numpy as np
import pytest

from pinot_tpu.engine.query_executor import QueryExecutor as JaxQueryExecutor
from pinot_tpu.segment.loader import load_segment as jax_load
from pinot_tpu.spi.data_types import Schema as JaxSchema
from pinot_tpu_torch.engine.query_executor import QueryExecutor
from pinot_tpu_torch.segment.builder import SegmentBuilder
from pinot_tpu_torch.segment.loader import load_segment
from pinot_tpu_torch.spi.data_types import Schema
from pinot_tpu_torch.spi.table_config import IndexingConfig, TableConfig

TABLE = "d"
SIZES = [1200, 1200, 700, 9000]
DIMS = [("d_year", "INT"), ("s_region", "STRING"), ("p_brand", "INT"),
        ("tags", "INT", False), ("lo_orderkey", "LONG")]
METRICS = [("lo_revenue", "INT"), ("lo_tax", "DOUBLE"), ("lo_qty", "FLOAT")]
RAW = ["lo_revenue", "lo_tax", "lo_qty"]
REGIONS = ["AMERICA", "ASIA", "EUROPE", "AFRICA", None]
PER_TEMPLATE = 22


@pytest.fixture(autouse=True)
def _jax_dispatches_every_query(monkeypatch):
    monkeypatch.setenv("PINOT_TPU_SEGMENT_CACHE", "0")
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


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    rng = np.random.default_rng(2026)
    schema = Schema.build(TABLE, dimensions=DIMS, metrics=METRICS)
    cfg = TableConfig(table_name=TABLE,
                      indexing=IndexingConfig(no_dictionary_columns=RAW))
    root = tmp_path_factory.mktemp("torch_differential")
    paths = []
    for i, rows in enumerate(SIZES):
        SegmentBuilder(schema, cfg, f"s{i}").build(
            _cols(rng, rows, 100_000 * i), root / f"s{i}")
        paths.append(root / f"s{i}")
    port = QueryExecutor(device="cpu")
    port.add_table(schema, [load_segment(p) for p in paths])
    jax = JaxQueryExecutor(backend="tpu")
    jax.add_table(JaxSchema.build(TABLE, dimensions=DIMS, metrics=METRICS),
                  [jax_load(p) for p in paths])
    return port, jax


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


def _queries():
    rng = np.random.default_rng(20261017)
    out = []
    for t, make in enumerate(TEMPLATES):
        for i in range(PER_TEMPLATE):
            sql = make(rng)
            if i % 2:
                sql = "SET segmentBatch = false; " + sql
            out.append(pytest.param(sql, id=f"t{t}-{i}"))
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
    port, jax = tables
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
