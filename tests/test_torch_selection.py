"""Selection queries of the port against the JAX package.

On the CPU, over seeded tables of several segments (equal ones that form
one batch family, and one of another size that dispatches alone):

  * `execute_sql` of a selection gives the JAX package's rows in the same
    order, its schema and its scanned docs, with the same number of device
    dispatches (`QueryExecutor(backend="tpu")`, its segment cache off) and
    one host fetch a query: LIMIT without ORDER BY across segments and
    families, ORDER BY ASC / DESC with ties (Python's stable sort), several
    keys, OFFSET, `SELECT *`, transform select items and ORDER BY-only
    transforms projected away, nullable columns, empty and all-pruned
    tables;
  * the selection mode of `run_program` / `run_program_batch` returns the
    filter mask as the little-endian packed bitmap the JAX package returns
    (n / 8 bytes a segment), which `segment/bitpack.unpack_bitmap` reads.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from pinot_tpu.engine.plan import SegmentPlanner as JaxPlanner
from pinot_tpu.engine.query_executor import QueryExecutor as JaxQueryExecutor
from pinot_tpu.ops import kernels as jax_kernels
from pinot_tpu.query.parser.sql import parse_sql as jax_parse
from pinot_tpu.segment.device_cache import SegmentDeviceView as JaxView
from pinot_tpu.segment.loader import load_segment as jax_load
from pinot_tpu.spi.data_types import Schema as JaxSchema
from pinot_tpu_torch.engine.aggregation import UnsupportedQueryError
from pinot_tpu_torch.engine.plan import SegmentPlanner
from pinot_tpu_torch.engine.query_executor import QueryExecutor
from pinot_tpu_torch.ops import kernels
from pinot_tpu_torch.ops.kernels import (planes_from_numpy, run_program,
                                         run_program_batch)
from pinot_tpu_torch.query.parser.sql import parse_sql
from pinot_tpu_torch.segment.bitpack import unpack_bitmap
from pinot_tpu_torch.segment.builder import SegmentBuilder
from pinot_tpu_torch.segment.loader import load_segment
from pinot_tpu_torch.spi.data_types import Schema
from pinot_tpu_torch.spi.table_config import IndexingConfig, TableConfig

TABLE = "t"
SIZES = [2000, 2000, 2000, 9000]  # three form a family; the last is alone
DIMS = [("d_year", "INT"), ("s_region", "STRING"), ("s_nation", "STRING"),
        ("lo_orderkey", "LONG")]
METRICS = [("lo_revenue", "INT"), ("lo_tax", "DOUBLE"),
           ("lo_quantity", "INT")]
REGIONS = ["AMERICA", "ASIA", "EUROPE", "AFRICA", "MIDDLE EAST"]


@pytest.fixture(autouse=True)
def _jax_dispatches_every_query(monkeypatch):
    monkeypatch.setenv("PINOT_TPU_SEGMENT_CACHE", "0")
    monkeypatch.setenv("PINOT_TPU_MESH_DEVICES", "1")
    monkeypatch.setenv("PINOT_TPU_FUSED", "interpret")


def _cols(rng, rows, base):
    nation = np.asarray(["CHINA", "JAPAN", "PERU", None], dtype=object)
    return {
        "d_year": rng.integers(1992, 1999, rows).astype(np.int32),
        "s_region": np.asarray(REGIONS, dtype=object)[
            rng.integers(0, 5, rows)],
        "s_nation": nation[rng.integers(0, 4, rows)],
        "lo_orderkey": base + np.arange(rows, dtype=np.int64),
        "lo_revenue": rng.integers(1, 5000, rows).astype(np.int32),
        "lo_tax": np.round(rng.gamma(3.0, 9.0, rows), 2),
        "lo_quantity": rng.integers(1, 51, rows).astype(np.int32),
    }


def _executors(paths, name=TABLE):
    port = QueryExecutor(device="cpu")
    port.add_table(Schema.build(name, dimensions=DIMS, metrics=METRICS),
                   [load_segment(p) for p in paths], name)
    jax = JaxQueryExecutor(backend="tpu")
    jax.add_table(JaxSchema.build(name, dimensions=DIMS, metrics=METRICS),
                  [jax_load(p) for p in paths], name)
    return port, jax


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    rng = np.random.default_rng(7)
    schema = Schema.build(TABLE, dimensions=DIMS, metrics=METRICS)
    cfg = TableConfig(table_name=TABLE, indexing=IndexingConfig(
        no_dictionary_columns=["lo_revenue", "lo_tax"]))
    root = tmp_path_factory.mktemp("torch_selection")
    paths = []
    for i, rows in enumerate(SIZES):
        SegmentBuilder(schema, cfg, f"s{i}").build(
            _cols(rng, rows, 100_000 * i), root / f"s{i}")
        paths.append(root / f"s{i}")
    return _executors(paths)


QUERIES = [
    # LIMIT without ORDER BY: the first matching rows, segment by segment
    "SELECT d_year, lo_revenue FROM t WHERE s_region = 'ASIA' LIMIT 30",
    "SELECT d_year, lo_revenue FROM t WHERE s_region = 'ASIA' LIMIT 4000",
    "SELECT lo_orderkey FROM t LIMIT 5",
    # ORDER BY with ties: stable sorts, DESC by reverse=
    "SELECT d_year, lo_orderkey FROM t ORDER BY d_year DESC LIMIT 50",
    "SELECT d_year, lo_orderkey FROM t WHERE lo_quantity < 5 "
    "ORDER BY d_year LIMIT 40",
    "SELECT s_region, d_year, lo_revenue FROM t ORDER BY s_region, "
    "d_year DESC, lo_revenue LIMIT 60",
    "SELECT lo_tax, lo_orderkey FROM t WHERE d_year = 1995 "
    "ORDER BY lo_tax DESC, lo_orderkey LIMIT 25",
    # OFFSET, with and without ORDER BY
    "SELECT lo_orderkey, lo_revenue FROM t ORDER BY lo_revenue, lo_orderkey "
    "LIMIT 10 OFFSET 95",
    "SELECT lo_orderkey FROM t WHERE d_year > 1996 LIMIT 7 OFFSET 2100",
    # SELECT *, nullable columns
    "SELECT * FROM t WHERE lo_quantity = 7 AND d_year = 1993 LIMIT 20",
    "SELECT * FROM t ORDER BY lo_orderkey DESC LIMIT 3",
    "SELECT s_nation, lo_orderkey FROM t WHERE s_nation <> 'PERU' "
    "ORDER BY s_nation, lo_orderkey LIMIT 30",
    # transforms in the select list and ORDER BY-only transforms
    "SELECT lo_revenue * 2, d_year + 1, lo_tax / 3 FROM t "
    "WHERE s_region IN ('ASIA', 'EUROPE') LIMIT 12",
    "SELECT lo_orderkey FROM t ORDER BY lo_revenue - lo_quantity DESC, "
    "lo_orderkey LIMIT 15",
    "SELECT lo_revenue + lo_quantity, lo_orderkey FROM t "
    "ORDER BY lo_revenue + lo_quantity, lo_orderkey LIMIT 9",
    "SELECT lo_orderkey, CASE WHEN lo_quantity > 25 THEN 1 ELSE 0 END "
    "FROM t WHERE d_year = 1997 LIMIT 11",
    # no row matches; and every segment pruned
    "SELECT d_year, lo_revenue FROM t WHERE lo_revenue < 0 LIMIT 5",
    "SELECT d_year, lo_revenue FROM t WHERE d_year = 1900 "
    "ORDER BY lo_revenue LIMIT 5",
    "SELECT * FROM t WHERE lo_orderkey > 900000 LIMIT 5",
]


def _check(port, jax, sql):
    before = kernels.host_fetches()
    got = port.execute_sql(sql)
    fetched = kernels.host_fetches() - before
    want = jax.execute_sql(sql)
    assert not want.exceptions, want.exceptions
    assert got.result_table.schema.to_json() == \
        want.result_table.schema.to_json()
    assert got.result_table.rows == want.result_table.rows
    assert got.num_docs_scanned == want.num_docs_scanned
    assert got.num_device_dispatches == want.num_device_dispatches
    assert got.num_segments_pruned == want.num_segments_pruned
    assert fetched == (1 if got.num_device_dispatches else 0)
    return got


@pytest.mark.parametrize("batch", [True, False], ids=["family", "solo"])
@pytest.mark.parametrize("sql", QUERIES)
def test_selection_matches_jax(tables, sql, batch):
    port, jax = tables
    if not batch:
        sql = "SET segmentBatch = false; " + sql
    got = _check(port, jax, sql)
    if got.num_segments_pruned == 0:
        # one family of three plus the lone segment; or four alone
        assert got.num_device_dispatches == (2 if batch else 4)


def test_selection_rows_from_a_family(tables):
    """A family's rows are its members' rows, in segment order: the first
    matching rows come from the first segment."""
    port, _ = tables
    got = port.execute_sql("SELECT lo_orderkey FROM t LIMIT 2500")
    keys = [r[0] for r in got.result_table.rows]
    assert keys == list(range(2000)) + list(range(100_000, 100_500))


@pytest.fixture(scope="module")
def empty_tables(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_selection_empty")
    schema = Schema.build("e", dimensions=DIMS, metrics=METRICS)
    SegmentBuilder(schema, None, "e0").build(
        _cols(np.random.default_rng(1), 0, 0), root / "e0")
    port, jax = _executors([root / "e0"], "e")
    port.add_table(Schema.build("none", dimensions=DIMS, metrics=METRICS), [],
                   "none")
    jax.add_table(JaxSchema.build("none", dimensions=DIMS, metrics=METRICS),
                  [], "none")
    return port, jax


@pytest.mark.parametrize("sql", [
    "SELECT * FROM e LIMIT 5",
    "SELECT d_year, lo_revenue FROM e ORDER BY lo_revenue LIMIT 5",
    "SELECT * FROM none LIMIT 5",
    "SELECT d_year, lo_tax FROM none WHERE d_year = 1 LIMIT 5",
])
def test_empty_tables_match_jax(empty_tables, sql):
    _check(*empty_tables, sql)


SELECTION_PLANS = [
    "SELECT d_year FROM t WHERE s_region = 'ASIA' AND lo_quantity < 25 "
    "LIMIT 10",
    "SELECT d_year FROM t WHERE lo_tax > 30.5 OR d_year IN (1993, 1995) "
    "LIMIT 10",
    "SELECT * FROM t LIMIT 10",
]


@pytest.mark.parametrize("sql", SELECTION_PLANS)
def test_selection_bitmap_matches_jax(tables, sql):
    """run_program's selection output is the JAX package's packed bitmap,
    element for element; run_program_batch's row s is member s's."""
    port, jax = tables
    psegs, jsegs = port.tables[TABLE].segments, jax.tables[TABLE].segments
    rows = []
    for pseg, jseg in zip(psegs[:3], jsegs[:3]):
        jplan = JaxPlanner(jax_parse(sql), jseg).plan()
        pplan = SegmentPlanner(parse_sql(sql), pseg).plan()
        assert repr(pplan.program) == repr(jplan.program)
        assert pplan.selection_columns == jplan.selection_columns
        view = JaxView(jseg)
        arrays, packed = jplan.gather_arrays_packed(view)
        arrays = tuple(np.asarray(a) for a in arrays)
        params = tuple(np.asarray(p) for p in jplan.params)
        (want,) = jax_kernels.run_program(jplan.program, arrays, params,
                                          np.int32(jseg.num_docs),
                                          view.padded, packed=packed,
                                          fused="")
        targs, tparams = planes_from_numpy(arrays, params, "cpu")
        (got,) = run_program(pplan.program, targs, tparams, pseg.num_docs,
                             view.padded, packed=packed, device="cpu")
        assert got.dtype == torch.uint8 and got.shape == (view.padded // 8,)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        bits = unpack_bitmap(got.numpy(), pseg.num_docs)
        assert bits.sum() <= pseg.num_docs
        rows.append((pplan, targs, tparams, got))
    pplan = rows[0][0]
    stacked = tuple(torch.stack([r[1][i] for r in rows])
                    for i in range(len(rows[0][1])))
    params_b = tuple(torch.stack([r[2][j] for r in rows])
                     for j in range(len(rows[0][2])))
    (got_b,) = run_program_batch(pplan.program, stacked, params_b,
                                 [s.num_docs for s in psegs[:3]],
                                 stacked[0].shape[1] if stacked else 8192,
                                 device="cpu")
    for s, r in enumerate(rows):
        np.testing.assert_array_equal(got_b[s].numpy(), r[3].numpy())


@pytest.mark.parametrize("sql", [
    "SELECT coalesce(lo_tax, 0) FROM t LIMIT 5",    # needs null planes
    "SELECT d_year FROM t ORDER BY lo_tax LIMIT 5",  # key not selected
])
def test_unported_selection_shapes_raise(tables, sql):
    """The single-stage path refuses both while planning (`execute_sql`
    retries the second on the multi-stage engine, below)."""
    with pytest.raises(UnsupportedQueryError):
        tables[0].execute(parse_sql(sql))


@pytest.mark.parametrize("sql", [
    "SELECT lo_orderkey FROM t ORDER BY lo_revenue DESC, lo_orderkey LIMIT 5",
    "SELECT lo_orderkey, d_year FROM t WHERE d_year = 1993 "
    "ORDER BY s_region, lo_orderkey LIMIT 3",
    "SELECT d_year FROM t ORDER BY lo_tax LIMIT 5",
])
def test_order_by_unselected_column_answers_on_the_mse(tables, sql,
                                                       monkeypatch):
    """A selection ordered by a column it does not select is refused while
    planning and answered by the multi-stage engine, as the reference's
    engine selection answers it: its rows and schema, and no dispatch spent
    on the single-stage path (every dispatch made is the MSE leaves')."""
    port, jax = tables
    made = []
    for name in ("dispatch_plan", "dispatch_plan_batch",
                 "dispatch_plan_batch_raw", "dispatch_plan_raw"):
        real = getattr(port.executor, name)
        monkeypatch.setattr(port.executor, name,
                            lambda *a, _r=real, _n=name, **k:
                            made.append(_n) or _r(*a, **k))
    want = jax.execute_sql(sql)
    assert not want.exceptions, want.exceptions
    got = port.execute_sql(sql)
    assert not got.exceptions, got.exceptions
    assert got.mse_stage_stats is not None
    assert got.result_table.rows == want.result_table.rows
    assert got.result_table.schema.to_json() == \
        want.result_table.schema.to_json()
    assert len(made) == got.num_device_dispatches
