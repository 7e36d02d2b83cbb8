"""Batch families in the port (pinot_tpu_torch), against the JAX package.

Segments whose plans agree run as ONE dispatch over [S, ...] stacks of
their planes (`run_program_batch`, kernel A with its family axis). On the
CPU, with seeded numpy segments:

  * the port's `run_program_batch` equals the JAX package's (a vmap of its
    per-segment body) on the JAX package's own family inputs: dense
    group-by over 1, 2 and 3 keys, ungrouped aggregation, a dict-LUT
    filter whose ids differ per member, dictionary planes of different
    cardinalities zero-padded to one bucket, and members with different
    num_docs in one pad bucket. Integers element-equal; float64 sums of
    DOUBLE columns within rtol 1e-12 (the two add in another order);
  * row s of the port's family dispatch equals the port's own solo
    unfused dispatch of member s, element for element, floats included;
  * the repaired fault: `num_device_dispatches` equals the JAX package's
    on the uniform 4-segment table (1) and on the mixed-bucket table (2
    batched, 3 with SET segmentBatch = false), and a query makes one host
    fetch.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from pinot_tpu.engine.executor import TpuSegmentExecutor as JaxExecutor
from pinot_tpu.engine.plan import SegmentPlanner as JaxPlanner
from pinot_tpu.engine.query_executor import QueryExecutor as JaxQueryExecutor
from pinot_tpu.ops.kernels import run_program_batch as jax_run_program_batch
from pinot_tpu.query.parser.sql import parse_sql as jax_parse
from pinot_tpu.segment.loader import load_segment as jax_load
from pinot_tpu.spi.data_types import Schema as JaxSchema
from pinot_tpu_torch.engine.executor import SegmentExecutor, batch_family_key
from pinot_tpu_torch.engine.plan import SegmentPlanner
from pinot_tpu_torch.engine.query_executor import QueryExecutor
from pinot_tpu_torch.ops import kernels
from pinot_tpu_torch.ops.kernels import run_program_batch
from pinot_tpu_torch.query.parser.sql import parse_sql
from pinot_tpu_torch.segment.builder import SegmentBuilder
from pinot_tpu_torch.segment.device_cache import DeviceSegmentCache
from pinot_tpu_torch.segment.loader import load_segment
from pinot_tpu_torch.spi.data_types import Schema
from pinot_tpu_torch.spi.table_config import IndexingConfig, TableConfig

TABLE = "fam"
DIMS = [("d_year", "INT"), ("p_brand", "INT"), ("s_region", "STRING"),
        ("lo_discount", "INT")]
METRICS = [("lo_revenue", "INT"), ("lo_supp", "INT"), ("lo_tax", "DOUBLE"),
           ("lo_delta", "INT")]
RAW = ["lo_revenue", "lo_tax", "lo_delta"]
# one pad bucket (8192), four row counts
FAMILY_ROWS = [5000, 8000, 6500, 7100]
# each member draws its regions from its own four: the dictionaries (and
# so the ids of 'ASIA' and the LUT of an IN list) differ per member
MEMBER_REGIONS = [["AMERICA", "ASIA", "EUROPE", "AFRICA"],
                  ["ASIA", "EUROPE", "AFRICA", "MIDDLE EAST"],
                  ["AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"],
                  ["AMERICA", "ASIA", "EUROPE", "AFRICA"]]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _jax_dispatches_every_query(monkeypatch):
    # the JAX package's segment partial cache would answer a repeated
    # program with zero dispatches; its segment-axis mesh is a multi-device
    # path outside this slice
    monkeypatch.setenv("PINOT_TPU_SEGMENT_CACHE", "0")
    monkeypatch.setenv("PINOT_TPU_MESH_DEVICES", "1")


def _member_cols(rng, n, regions):
    return {
        "d_year": rng.integers(1992, 1999, n).astype(np.int32),
        "p_brand": rng.integers(0, 40, n).astype(np.int32),
        "s_region": np.asarray(regions, dtype=object)[
            rng.integers(0, len(regions), n)],
        "lo_discount": rng.integers(0, 11, n).astype(np.int32),
        "lo_revenue": rng.integers(1, 600_000, n).astype(np.int32),
        # ~700 of 800 values per member: dictionaries of different sizes
        # in one power-of-two bucket
        "lo_supp": rng.integers(0, 800, n).astype(np.int32) * 3,
        "lo_tax": rng.normal(0.0, 1e3, n),
        "lo_delta": rng.integers(-70_000, 70_000, n).astype(np.int32),
    }


@pytest.fixture(scope="module")
def family(tmp_path_factory):
    rng = np.random.default_rng(41)
    schema = Schema.build(TABLE, dimensions=DIMS, metrics=METRICS)
    cfg = TableConfig(table_name=TABLE,
                      indexing=IndexingConfig(no_dictionary_columns=RAW))
    root = tmp_path_factory.mktemp("torch_batch")
    paths = []
    for i, (n, regions) in enumerate(zip(FAMILY_ROWS, MEMBER_REGIONS)):
        path = root / f"m{i}"
        SegmentBuilder(schema, cfg, f"m{i}").build(
            _member_cols(rng, n, regions), path)
        paths.append(path)
    return [jax_load(p) for p in paths], [load_segment(p) for p in paths]


# (sql, exact): exact=False only for float64 sums of DOUBLE values
BATCH_QUERIES = [
    (f"SELECT d_year, SUM(lo_revenue), COUNT(*), MIN(lo_revenue), "
     f"MAX(lo_revenue) FROM {TABLE} WHERE s_region IN ('ASIA', 'EUROPE') "
     "GROUP BY d_year LIMIT 10", True),
    (f"SELECT d_year, p_brand, SUM(lo_revenue) FROM {TABLE} "
     "WHERE s_region = 'ASIA' GROUP BY d_year, p_brand LIMIT 10000", True),
    (f"SELECT d_year, p_brand, lo_discount, SUM(lo_delta), COUNT(*) "
     f"FROM {TABLE} GROUP BY d_year, p_brand, lo_discount LIMIT 100000",
     True),
    (f"SELECT COUNT(*), SUM(lo_revenue), MIN(lo_delta), MAX(lo_delta), "
     f"AVG(lo_supp) FROM {TABLE} WHERE s_region <> 'ASIA'", True),
    # dictionary-decoded values: lo_supp's dictionary sizes differ
    (f"SELECT p_brand, SUM(lo_supp), MAX(lo_supp) FROM {TABLE} "
     "WHERE lo_discount BETWEEN 2 AND 8 GROUP BY p_brand LIMIT 100", True),
    (f"SELECT d_year, SUM(lo_tax), MIN(lo_tax), AVG(lo_tax) FROM {TABLE} "
     "GROUP BY d_year LIMIT 10", False),
    (f"SELECT SUM(lo_tax), MAX(lo_tax), COUNT(*) FROM {TABLE} "
     "WHERE d_year > 1994", False),
]


def _plans(family, sql):
    jsegs, psegs = family
    jplans = [JaxPlanner(jax_parse(sql), s).plan() for s in jsegs]
    pplans = [SegmentPlanner(parse_sql(sql), s).plan() for s in psegs]
    return jplans, pplans


def _assert_outs(got, want, exact):
    assert len(got) == len(want)
    for o, w in zip(got, want):
        o, w = np.asarray(o), np.asarray(w)
        assert o.dtype == w.dtype and o.shape == w.shape
        if exact or o.dtype.kind != "f":
            np.testing.assert_array_equal(o, w)
        else:
            np.testing.assert_allclose(o, w, rtol=1e-12, atol=0)


@pytest.mark.parametrize("sql,exact", BATCH_QUERIES)
def test_run_program_batch_matches_jax(family, sql, exact):
    jsegs, psegs = family
    jplans, pplans = _plans(family, sql)
    assert repr(pplans[0].program) == repr(jplans[0].program)
    # the four members are one family for both packages
    keys = {batch_family_key(s, p, packed_on=False)
            for s, p in zip(psegs, pplans)}
    assert len(keys) == 1
    views, arrays, params_b, packed, num_docs = JaxExecutor()._gather_batch(
        jsegs, jplans)
    arrays = tuple(np.asarray(a) for a in arrays)
    want = jax_run_program_batch(jplans[0].program, arrays, params_b,
                                 num_docs, views[0].padded, packed=packed)
    got = run_program_batch(
        pplans[0].program, tuple(torch.from_numpy(np.array(a)) for a in arrays),
        tuple(torch.from_numpy(np.asarray(p)) for p in params_b),
        np.asarray(num_docs), views[0].padded, packed=packed,
        device=torch.device("cpu"))
    _assert_outs([o.numpy() for o in got], [np.asarray(w) for w in want],
                 exact)


@pytest.mark.parametrize("sql,exact", BATCH_QUERIES)
def test_family_row_equals_solo_dispatch(family, sql, exact):
    _, psegs = family
    _, pplans = _plans(family, sql)
    ex = SegmentExecutor(DeviceSegmentCache("cpu"))
    outs_b, views = ex.dispatch_plan_batch_raw(psegs, pplans)
    assert all(o.shape[0] == len(psegs) for o in outs_b)
    for row, (seg, plan) in enumerate(zip(psegs, pplans)):
        solo, _ = ex.dispatch_plan_raw(seg, plan)
        _assert_outs([o[row].numpy() for o in outs_b],
                     [o.numpy() for o in solo], exact=True)


def test_family_stacks_are_cached_under_the_budget(family):
    _, psegs = family
    _, pplans = _plans(family, BATCH_QUERIES[1][0])
    cache = DeviceSegmentCache("cpu")
    ex = SegmentExecutor(cache)
    ex.dispatch_plan_batch_raw(psegs, pplans)
    members = sum(cache.view(s).nbytes() for s in psegs)
    stacks = cache.bytes_used() - members
    assert stacks == members  # one [S, N] stack per member plane
    ex.dispatch_plan_batch_raw(psegs, pplans)
    assert cache.bytes_used() - members == stacks  # reused, not rebuilt
    # room for the members and one family's stacks: a second family's
    # stacks push the older stacks out, never a member's planes
    tight = DeviceSegmentCache("cpu", budget_bytes=members + stacks)
    ex = SegmentExecutor(tight)
    ex.dispatch_plan_batch_raw(psegs, pplans)
    ex.dispatch_plan_batch_raw(psegs[:2], pplans[:2])
    tight.stacked_view(psegs[:2])  # the budget is enforced on the next call
    assert tight.evictions == 1
    assert all(tight.view(s).nbytes() for s in psegs)


# -- the repaired fault: one dispatch and one fetch per family -------------

SB_SCHEMA = [("k", "INT"), ("d", "INT")], [("v", "LONG"), ("f", "DOUBLE")]
MIXED_SIZES = [6000, 9000, 3000]
STRUCT_SQL = ("SELECT k, SUM(v), COUNT(*) FROM sb GROUP BY k ORDER BY k "
              "LIMIT 1000")
NO_BATCH = "SET segmentBatch = false; "


def _sb_cols(rng, n):
    return {
        "k": rng.integers(0, 40, n).astype(np.int32),
        "d": rng.integers(0, 16, n).astype(np.int32),
        "v": rng.integers(-500, 500, n).astype(np.int64),
        "f": rng.normal(100.0, 25.0, n).astype(np.float64),
    }


def _sb_tables(root, cols_per_segment):
    dims, metrics = SB_SCHEMA
    schema = Schema.build("sb", dimensions=dims, metrics=metrics)
    cfg = TableConfig(table_name="sb")
    paths = []
    for i, cols in enumerate(cols_per_segment):
        SegmentBuilder(schema, cfg, f"s{i}").build(cols, root / f"s{i}")
        paths.append(root / f"s{i}")
    port = QueryExecutor(device="cpu")
    port.add_table(schema, [load_segment(p) for p in paths])
    jax = JaxQueryExecutor(backend="tpu")
    jax.add_table(JaxSchema.build("sb", dimensions=dims, metrics=metrics),
                  [jax_load(p) for p in paths])
    return port, jax


@pytest.fixture(scope="module")
def uniform(tmp_path_factory):
    """Four segments of identical rows: one family by construction."""
    cols = _sb_cols(np.random.default_rng(77), 2048)
    return _sb_tables(tmp_path_factory.mktemp("torch_sb_uniform"), [cols] * 4)


@pytest.fixture(scope="module")
def mixed(tmp_path_factory):
    """6000 and 3000 rows share the 8192 pad bucket, 9000 pads to 16384."""
    rng = np.random.default_rng(31)
    return _sb_tables(tmp_path_factory.mktemp("torch_sb_mixed"),
                      [_sb_cols(rng, n) for n in MIXED_SIZES])


@pytest.mark.parametrize("table,batched,solo", [("uniform", 1, 4),
                                                ("mixed", 2, 3)])
def test_dispatches_equal_the_reference(request, table, batched, solo):
    port, jax = request.getfixturevalue(table)
    for prefix, want in (("", batched), (NO_BATCH, solo)):
        got = port.execute_sql(prefix + STRUCT_SQL)
        ref = jax.execute_sql(prefix + STRUCT_SQL)
        assert not ref.exceptions, ref.exceptions
        assert got.num_device_dispatches == ref.num_device_dispatches == want
        assert got.result_table.rows == ref.result_table.rows
        assert got.num_docs_scanned == ref.num_docs_scanned


@pytest.mark.parametrize("sql", [
    STRUCT_SQL,
    "SELECT COUNT(*), SUM(v), MIN(v), MAX(v), AVG(f) FROM sb WHERE d < 12",
    "SELECT k, SUM(f), AVG(f) FROM sb GROUP BY k ORDER BY k LIMIT 1000",
])
def test_batched_rows_equal_solo_rows(mixed, sql):
    port, _ = mixed
    before = kernels.host_fetches()
    batched = port.execute_sql(sql)
    assert kernels.host_fetches() - before == 1  # one copy for the query
    solo = port.execute_sql(NO_BATCH + sql)
    # element for element: a family row is the member's solo run
    assert batched.result_table.rows == solo.result_table.rows
    assert batched.num_docs_scanned == solo.num_docs_scanned
