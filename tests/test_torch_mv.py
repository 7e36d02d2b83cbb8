"""Multi-value columns in the port against the JAX package.

On the CPU, over seeded tables with an INT and a STRING multi-value column
(empty rows and null rows included):

  * the port's builder writes the JAX builder's bytes and metadata for
    the same rows, from per-document lists and from the flat
    `MultiValues` form alike;
  * the loader's offsets, padded (docs, max_mv) id matrix and values, and
    the device view's matrix, equal the JAX package's;
  * plans are the JAX planner's (MV predicates as `mv=True` LUTs, the MV
    group dimension and its `mv_doc_slots`, `ir.MvLutReduce` operands),
    and `run_program` / `run_program_batch` outputs are element-equal to
    its interpreter's, the appended matched-doc count included;
  * `execute_sql` rows, scanned docs and dispatches equal the JAX
    package's for MV filters (EQ, NOT EQ, IN, NOT IN, RANGE, LIKE), MV
    GROUP BY (dense and sparse, solo and as one family) and the *MV value
    aggregations;
  * the shapes the JAX package sends to its host engine raise
    UnsupportedQueryError in both planners.
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
from pinot_tpu.segment.builder import SegmentBuilder as JaxBuilder
from pinot_tpu.segment.device_cache import SegmentDeviceView as JaxView
from pinot_tpu.segment.loader import load_segment as jax_load
from pinot_tpu.spi.data_types import Schema as JaxSchema
from pinot_tpu.spi.table_config import IndexingConfig as JaxIndexing
from pinot_tpu.spi.table_config import TableConfig as JaxTableConfig
from pinot_tpu_torch.engine.aggregation import UnsupportedQueryError
from pinot_tpu_torch.engine.plan import SegmentPlanner
from pinot_tpu_torch.engine.query_executor import QueryExecutor
from pinot_tpu_torch.ops import kernels
from pinot_tpu_torch.ops.kernels import (planes_from_numpy, run_program,
                                         run_program_batch)
from pinot_tpu_torch.query.parser.sql import parse_sql
from pinot_tpu_torch.segment.builder import MultiValues, SegmentBuilder
from pinot_tpu_torch.segment.device_cache import SegmentDeviceView
from pinot_tpu_torch.segment.loader import load_segment
from pinot_tpu_torch.spi.data_types import Schema
from pinot_tpu_torch.spi.table_config import IndexingConfig, TableConfig

TABLE = "m"
ROWS = 1500
SEGMENTS = 3
DIMS = [("d_year", "INT"), ("s_region", "STRING"), ("tags", "INT", False),
        ("names", "STRING", False), ("lo_orderkey", "INT")]
METRICS = [("lo_revenue", "INT"), ("lo_tax", "DOUBLE")]
RAW = ["lo_revenue", "lo_tax"]
REGIONS = ["AMERICA", "ASIA", "EUROPE"]


@pytest.fixture(autouse=True)
def _jax_dispatches_every_query(monkeypatch):
    monkeypatch.setenv("PINOT_TPU_SEGMENT_CACHE", "0")
    monkeypatch.setenv("PINOT_TPU_MESH_DEVICES", "1")
    monkeypatch.setenv("PINOT_TPU_FUSED", "interpret")


def _cols(rng, rows, base, nulls=True):
    """Every segment holds every tag value and name (equal cardinalities
    and max_mv, so the segments form one batch family)."""
    lens = rng.integers(1, 5, rows)
    lens[:4] = 4
    tags = [list(rng.integers(0, 40, k)) for k in lens]
    tags[:10] = [list(range(4 * j, 4 * j + 4)) for j in range(10)]
    if nulls:
        tags[20] = None
        tags[21] = []
    names = [[f"n{x}" for x in rng.integers(0, 12, k)]
             for k in rng.integers(1, 4, rows)]
    names[:12] = [[f"n{j}"] for j in range(12)]
    return {
        "d_year": rng.integers(1992, 1999, rows).astype(np.int32),
        "s_region": np.asarray(REGIONS, dtype=object)[
            rng.integers(0, 3, rows)],
        "tags": tags,
        "names": names,
        "lo_orderkey": (base + np.arange(rows)).astype(np.int32),
        "lo_revenue": rng.integers(1, 600_000, rows).astype(np.int32),
        "lo_tax": np.round(rng.gamma(3.0, 9.0, rows), 2),
    }


def _schema(mod):
    return mod.build(TABLE, dimensions=DIMS, metrics=METRICS)


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    rng = np.random.default_rng(5)
    cfg = TableConfig(table_name=TABLE,
                      indexing=IndexingConfig(no_dictionary_columns=RAW))
    root = tmp_path_factory.mktemp("torch_mv")
    paths = []
    for i in range(SEGMENTS):
        SegmentBuilder(_schema(Schema), cfg, f"s{i}").build(
            _cols(rng, ROWS, 10_000 * i), root / f"s{i}")
        paths.append(root / f"s{i}")
    port = QueryExecutor(device="cpu")
    port.add_table(_schema(Schema), [load_segment(p) for p in paths])
    jsegs = [jax_load(p) for p in paths]
    jax = JaxQueryExecutor(backend="tpu")
    jax.add_table(_schema(JaxSchema), jsegs)
    return port, jax, jsegs, [load_segment(p) for p in paths]


# -- build and load ---------------------------------------------------------------


def _same_segment(a, b):
    assert (a / "data.bin").read_bytes() == (b / "data.bin").read_bytes()
    ma = json.loads((a / "metadata.json").read_text())
    mb = json.loads((b / "metadata.json").read_text())
    ma.pop("creationTimeMs")
    mb.pop("creationTimeMs")
    assert ma == mb


@pytest.mark.parametrize("nulls", [True, False])
def test_builder_bytes_equal_jax(tmp_path, nulls):
    cols = _cols(np.random.default_rng(9), 700, 0, nulls)
    cfg = TableConfig(table_name=TABLE,
                      indexing=IndexingConfig(no_dictionary_columns=RAW))
    jcfg = JaxTableConfig(table_name=TABLE,
                          indexing=JaxIndexing(no_dictionary_columns=RAW))
    SegmentBuilder(_schema(Schema), cfg, "s").build(cols, tmp_path / "p")
    JaxBuilder(_schema(JaxSchema), jcfg, "s").build(cols, tmp_path / "j")
    _same_segment(tmp_path / "p", tmp_path / "j")
    if not nulls:
        # the flat form builds the same bytes
        flat = dict(cols)
        for c in ("tags", "names"):
            flat[c] = MultiValues(
                np.asarray([v for row in cols[c] for v in row]),
                np.asarray([len(row) for row in cols[c]]))
        SegmentBuilder(_schema(Schema), cfg, "s").build(flat, tmp_path / "f")
        _same_segment(tmp_path / "f", tmp_path / "j")


def test_loader_matrix_equals_jax(tables):
    _, _, jsegs, psegs = tables
    for jseg, pseg in zip(jsegs, psegs):
        for col in ("tags", "names"):
            np.testing.assert_array_equal(pseg.get_mv_offsets(col),
                                          jseg.get_mv_offsets(col))
            got = pseg.get_mv_dict_id_matrix(col)
            want = jseg.get_mv_dict_id_matrix(col)
            assert got.dtype == want.dtype == np.int32
            np.testing.assert_array_equal(got, want)
            card = pseg.column_metadata(col).cardinality
            assert got.shape[1] == (4 if col == "tags" else 3)
            if col == "tags":
                # a null row holds one default value, an empty row none
                assert (got[20] == card).sum() == 3
                assert (got[21] == card).sum() == 4
            for a, b in zip(pseg.get_mv_values(col)[:50],
                            jseg.get_mv_values(col)[:50]):
                np.testing.assert_array_equal(a, b)
            view = SegmentDeviceView(pseg, "cpu").mv_dict_ids(col)
            np.testing.assert_array_equal(
                view.numpy(), np.asarray(JaxView(jseg).mv_dict_ids(col)))
        assert pseg.get_null_bitmap("tags")[20]


# -- plans and the interpreter ------------------------------------------------------

PROGRAMS = [
    "SELECT d_year, COUNT(*), SUM(lo_revenue) FROM m "
    "WHERE tags IN (3, 17, 22) GROUP BY d_year",
    "SELECT d_year, COUNT(*) FROM m WHERE tags BETWEEN 5 AND 9 "
    "AND names <> 'n3' GROUP BY d_year",
    "SELECT COUNT(*), MAX(lo_tax) FROM m WHERE names LIKE 'n1%'",
    "SELECT tags, COUNT(*), SUM(lo_revenue), MIN(lo_tax) FROM m "
    "WHERE s_region = 'ASIA' GROUP BY tags LIMIT 100",
    "SELECT d_year, names, COUNT(*), MAX(lo_revenue) FROM m "
    "WHERE tags NOT IN (1, 2) GROUP BY d_year, names LIMIT 200",
    "SET sparseGroupBy = true; SELECT tags, COUNT(*), SUM(lo_revenue) "
    "FROM m WHERE d_year > 1994 GROUP BY tags LIMIT 100",
    "SELECT d_year, COUNTMV(tags), SUMMV(tags), MINMV(tags), MAXMV(tags), "
    "AVGMV(tags), MINMAXRANGEMV(tags) FROM m GROUP BY d_year",
    "SELECT COUNTMV(names), SUMMV(tags), AVGMV(tags) FROM m "
    "WHERE tags = 7",
    "SELECT tags, DISTINCTCOUNT(d_year), PERCENTILE(d_year, 50) FROM m "
    "GROUP BY tags LIMIT 100",
]


def _compare(got, want):
    assert len(got) == len(want)
    for o, w in zip(got, want):
        o, w = np.asarray(o), np.asarray(w)
        assert o.dtype == w.dtype and o.shape == w.shape
        if o.dtype.kind == "f":
            np.testing.assert_allclose(o, w, rtol=1e-12, atol=0)
        else:
            np.testing.assert_array_equal(o, w)


def _jax_inputs(plan, seg):
    view = JaxView(seg)
    arrays, packed = plan.gather_arrays_packed(view)
    return (tuple(np.asarray(a) for a in arrays),
            tuple(np.asarray(p) for p in plan.params), packed, view.padded)


@pytest.mark.parametrize("sql", PROGRAMS)
def test_run_program_matches_jax(tables, sql):
    _, _, jsegs, psegs = tables
    per_seg = []
    for jseg, pseg in zip(jsegs, psegs):
        jplan = JaxPlanner(jax_parse(sql), jseg).plan()
        pplan = SegmentPlanner(parse_sql(sql), pseg).plan()
        assert repr(pplan.program) == repr(jplan.program)
        assert pplan.slots == jplan.slots
        for a, b in zip(pplan.params, jplan.params):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        arrays, params, packed, padded = _jax_inputs(jplan, jseg)
        want = jax_kernels.run_program(jplan.program, arrays, params,
                                       np.int32(jseg.num_docs), padded,
                                       packed=packed, fused="")
        targs, tparams = planes_from_numpy(arrays, params, "cpu")
        got = run_program(pplan.program, targs, tparams, pseg.num_docs,
                          padded, packed=packed, device="cpu")
        _compare([o.numpy() for o in got], want)
        # the port's own device view gives the same outputs
        pview = SegmentDeviceView(pseg, "cpu", packed=True)
        parrays, ppacked = pplan.gather_arrays_packed(pview)
        got2 = run_program(pplan.program, parrays, tparams, pseg.num_docs,
                           pview.padded, packed=ppacked, device="cpu")
        _compare([o.numpy() for o in got2], want)
        per_seg.append((pplan, targs, tparams, packed, padded, want))
    # a family of the three: row s is member s's outputs
    pplan, _, _, packed, padded, _ = per_seg[0]
    arrays_b = tuple(torch.stack([r[1][i] for r in per_seg])
                     for i in range(len(per_seg[0][1])))
    params_b = tuple(torch.stack([r[2][j] for r in per_seg])
                     for j in range(len(per_seg[0][2])))
    got_b = run_program_batch(pplan.program, arrays_b, params_b,
                              [s.num_docs for s in psegs], padded,
                              packed=packed, device="cpu")
    for s, r in enumerate(per_seg):
        _compare([o[s].numpy() for o in got_b], r[5])


def test_mv_group_expansion_counts_pairs(tables):
    """The MV GROUP BY's counts are (doc, value) pairs, its appended last
    output the matched docs: the pairs of a doc with k tags are k."""
    _, _, _, psegs = tables
    sql = "SELECT tags, COUNT(*) FROM m GROUP BY tags LIMIT 100"
    seg = psegs[0]
    plan = SegmentPlanner(parse_sql(sql), seg).plan()
    assert plan.program.mv_group_slot is not None
    view = SegmentDeviceView(seg, "cpu")
    arrays, packed = plan.gather_arrays_packed(view)
    params = tuple(torch.from_numpy(np.array(p)) for p in plan.params)
    outs = run_program(plan.program, arrays, params, seg.num_docs,
                       view.padded, packed=packed, device="cpu")
    lens = np.diff(seg.get_mv_offsets("tags"))
    assert int(outs[0][:-1].sum()) == int(lens.sum())
    assert outs[-1].tolist() == [seg.num_docs]


# -- SQL end to end ---------------------------------------------------------------

QUERIES = [
    # MV filters: any value matches
    "SELECT d_year, COUNT(*), SUM(lo_revenue) FROM m "
    "WHERE tags IN (3, 17, 42) GROUP BY d_year",
    "SELECT d_year, COUNT(*) FROM m WHERE tags NOT IN (3, 17) GROUP BY d_year",
    "SELECT COUNT(*) FROM m WHERE tags = 5",
    "SELECT COUNT(*), SUM(lo_revenue) FROM m WHERE tags <> 5",
    "SELECT s_region, COUNT(*) FROM m WHERE tags >= 30 GROUP BY s_region",
    "SELECT COUNT(*) FROM m WHERE tags BETWEEN 0 AND 39",
    "SELECT COUNT(*) FROM m WHERE names = 'n3' OR tags < 2",
    "SELECT d_year, MAX(lo_tax) FROM m WHERE names LIKE 'n1%' "
    "AND NOT tags IN (7) GROUP BY d_year",
    "SELECT lo_orderkey, lo_revenue FROM m WHERE tags = 13 "
    "ORDER BY lo_revenue DESC LIMIT 20",
    # MV GROUP BY
    "SELECT tags, COUNT(*), SUM(lo_revenue) FROM m WHERE s_region = 'ASIA' "
    "GROUP BY tags LIMIT 2000",
    "SELECT names, COUNT(*), MIN(lo_revenue), MAX(lo_tax), AVG(lo_revenue) "
    "FROM m GROUP BY names ORDER BY names LIMIT 5",
    "SELECT d_year, tags, COUNT(*) FROM m WHERE tags < 10 "
    "GROUP BY d_year, tags ORDER BY COUNT(*) DESC, d_year, tags LIMIT 30",
    "SELECT tags, DISTINCTCOUNT(s_region), PERCENTILETDIGEST(lo_tax, 90) "
    "FROM m GROUP BY tags LIMIT 2000",
    "SET sparseGroupBy = true; SELECT tags, COUNT(*), SUM(lo_revenue) "
    "FROM m GROUP BY tags ORDER BY tags LIMIT 15",
    "SET sparseGroupBy = true; SET deviceCombine = false; SELECT tags, "
    "COUNT(*) FROM m GROUP BY tags ORDER BY tags LIMIT 15",
    "SELECT DISTINCT tags FROM m WHERE d_year = 1996 ORDER BY tags LIMIT 50",
    # the *MV value aggregations
    "SELECT d_year, COUNTMV(tags), SUMMV(tags), MINMV(tags), MAXMV(tags), "
    "AVGMV(tags), MINMAXRANGEMV(tags) FROM m GROUP BY d_year",
    "SELECT COUNTMV(tags), SUMMV(tags), MAXMV(tags), AVGMV(tags), "
    "COUNTMV(names) FROM m WHERE s_region <> 'ASIA'",
    "SELECT s_region, COUNTMV(names) FROM m WHERE tags IN (1, 2) "
    "GROUP BY s_region",
]


def _rows_equal(got, want, ordered):
    if not ordered:
        got, want = sorted(map(repr, got)), sorted(map(repr, want))
        assert got == want
        return
    assert len(got) == len(want)
    for rg, rw in zip(got, want):
        for a, b in zip(rg, rw):
            if isinstance(a, float) or isinstance(b, float):
                assert math.isclose(float(a), float(b), rel_tol=1e-12)
            else:
                assert a == b


@pytest.mark.parametrize("batch", [True, False], ids=["family", "solo"])
@pytest.mark.parametrize("sql", QUERIES)
def test_execute_sql_matches_jax(tables, sql, batch):
    port, jax, jsegs, _ = tables
    if not batch:
        sql = "SET segmentBatch = false; " + sql
    for seg in jsegs:  # the JAX package's device path answers
        JaxPlanner(jax_parse(sql), seg).plan()
    before = kernels.host_fetches()
    got = port.execute_sql(sql)
    assert kernels.host_fetches() - before == 1
    want = jax.execute_sql(sql)
    assert not want.exceptions, want.exceptions
    _rows_equal(got.result_table.rows, want.result_table.rows,
                "ORDER BY" in sql)
    assert got.result_table.schema.to_json() == \
        want.result_table.schema.to_json()
    assert got.num_docs_scanned == want.num_docs_scanned
    assert got.num_device_dispatches == want.num_device_dispatches
    if batch and "deviceCombine = false" not in sql \
            and "sparseGroupBy" not in sql:
        assert got.num_device_dispatches == 1  # one family of three


def test_mv_group_by_scans_docs_not_pairs(tables):
    port = tables[0]
    got = port.execute_sql("SELECT tags, COUNT(*) FROM m GROUP BY tags "
                           "LIMIT 2000")
    assert got.num_docs_scanned == ROWS * SEGMENTS
    assert sum(r[1] for r in got.result_table.rows) > ROWS * SEGMENTS


@pytest.mark.parametrize("sql", [
    "SELECT tags, names, COUNT(*) FROM m GROUP BY tags, names",
    "SELECT tags, SUMMV(tags) FROM m GROUP BY tags",
    "SELECT names, COUNTMV(tags) FROM m GROUP BY names",
    "SELECT tags, d_year + 1, COUNT(*) FROM m GROUP BY tags, d_year + 1",
    "SELECT d_year, DISTINCTCOUNTMV(tags) FROM m GROUP BY d_year",
    "SELECT d_year, PERCENTILEMV(tags, 90) FROM m GROUP BY d_year",
    "SELECT d_year, DISTINCTCOUNTHLLMV(tags) FROM m GROUP BY d_year",
    "SELECT d_year, PERCENTILETDIGESTMV(tags, 50) FROM m GROUP BY d_year",
    "SELECT d_year, DISTINCTCOUNT(tags) FROM m GROUP BY d_year",
    "SELECT d_year, SUM(tags) FROM m GROUP BY d_year",
    "SELECT SUMMV(names) FROM m",
    "SELECT SUMMV(lo_revenue) FROM m",
])
def test_host_engine_shapes_raise(tables, sql):
    """Each raises in the JAX planner too (that package then answers it on
    its host engine, which the port does not have)."""
    _, _, jsegs, psegs = tables
    with pytest.raises(JaxUnsupported):
        JaxPlanner(jax_parse(sql), jsegs[0]).plan()
    with pytest.raises(UnsupportedQueryError):
        SegmentPlanner(parse_sql(sql), psegs[0]).plan()


def test_mv_selection_raises(tables):
    """Selecting an MV column's values is not materialized by the port."""
    with pytest.raises(UnsupportedQueryError):
        tables[0].execute_sql("SELECT tags FROM m LIMIT 5")
