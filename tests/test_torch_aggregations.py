"""The matrix-shaped aggregations of the port against the JAX package.

Every aggregation the JAX package lowers to its device for a single-value
column (the DISTINCT family and its sketches, PERCENTILE, MODE, the
approximate percentiles, HISTOGRAM, the moment functions, BOOLAND/BOOLOR,
MINMAXRANGE), on a 3-segment table of seeded numpy columns, on the CPU:

  * the sketch classes of the port's utils/sketches.py give the same
    registers, hashes, centroids, estimates and quantiles as the JAX
    package's on the same values;
  * `run_program` / `run_program_batch` of one SegmentPlan give outputs
    element-equal to the JAX package's interpreter, dtypes included: bool
    occupancy, int64 value histograms, the adaptive histogram's
    [h1, h2, bstar], and the sparse mode's uint32 bitmap words on the
    presorted path, the sort path with the ids packed into the key, and
    the two-key sort;
  * `execute_sql` rows equal the JAX package's `QueryExecutor(backend=
    "tpu")` rows, in every mode: ungrouped, dense solo (`SET segmentBatch
    = false`), one batch family, and the sparse modes. The JAX side's
    planner lowers every one of these queries (so its rows come from its
    device path, not its host engine). Finalized rows are equal: the same
    host code runs on equal counts, and every sum of these columns is
    exact in float64 (integer values; squares and products of them
    below 2^53), save the DOUBLE column's, which agree to rtol 1e-12
    because the engines add in another order;
  * the shapes the JAX package answers on its host engine raise
    UnsupportedQueryError.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import pytest
import torch

from pinot_tpu.engine.executor import TpuSegmentExecutor as JaxExecutor
from pinot_tpu.engine.plan import SegmentPlanner as JaxPlanner
from pinot_tpu.engine.query_executor import QueryExecutor as JaxQueryExecutor
from pinot_tpu.ops import kernels as jax_kernels
from pinot_tpu.query.parser.sql import parse_sql as jax_parse
from pinot_tpu.segment.device_cache import SegmentDeviceView as JaxView
from pinot_tpu.segment.loader import load_segment as jax_load
from pinot_tpu.spi.data_types import Schema as JaxSchema
from pinot_tpu.utils import sketches as jax_sketches
from pinot_tpu_torch.engine.aggregation import UnsupportedQueryError
from pinot_tpu_torch.engine.plan import SegmentPlanner
from pinot_tpu_torch.engine.query_executor import QueryExecutor
from pinot_tpu_torch.ops import _cuda, kernels
from pinot_tpu_torch.ops.kernels import (planes_from_numpy, run_program,
                                         run_program_batch)
from pinot_tpu_torch.query.parser.sql import parse_sql
from pinot_tpu_torch.segment.builder import SegmentBuilder
from pinot_tpu_torch.segment.device_cache import SegmentDeviceView
from pinot_tpu_torch.segment.loader import load_segment
from pinot_tpu_torch.spi.data_types import Schema
from pinot_tpu_torch.spi.table_config import IndexingConfig, TableConfig
from pinot_tpu_torch.utils import sketches

ROWS = 3000
SEGMENTS = 3
ORDERS = 1000  # distinct lo_orderkey values of every segment
TABLE = "t"
DIMS = [("d_year", "INT"), ("p_brand", "INT"), ("s_region", "STRING"),
        ("s_nation", "STRING"), ("lo_discount", "INT"), ("lo_flag", "INT"),
        ("lo_orderkey", "INT"), ("a", "INT")]
METRICS = [("lo_quantity", "INT"), ("lo_extendedprice", "INT"),
           ("lo_revenue", "INT"), ("lo_tax", "DOUBLE")]
RAW = ["lo_quantity", "lo_extendedprice", "lo_revenue", "lo_tax"]
REGIONS = ["AMERICA", "ASIA", "EUROPE", "AFRICA", "MIDDLE EAST"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _jax_dispatches_every_query(monkeypatch):
    # the JAX package's segment partial cache would answer a repeated
    # program with zero dispatches; its segment-axis mesh is a
    # multi-device path outside the port
    monkeypatch.setenv("PINOT_TPU_SEGMENT_CACHE", "0")
    monkeypatch.setenv("PINOT_TPU_MESH_DEVICES", "1")


def _cols(rng, base):
    """One segment's rows: every dictionary column holds all its values in
    every segment (equal cardinalities, so the segments form one batch
    family), lo_orderkey sorted in ingestion order."""
    nation = np.asarray(["CHINA", "JAPAN", "PERU", "KENYA", None],
                        dtype=object)
    return {
        "d_year": rng.integers(1992, 1999, ROWS).astype(np.int32),
        "p_brand": rng.integers(0, 100, ROWS).astype(np.int32),
        "s_region": np.asarray(REGIONS, dtype=object)[
            rng.integers(0, 5, ROWS)],
        "s_nation": nation[rng.integers(0, 5, ROWS)],
        "lo_discount": rng.integers(0, 11, ROWS).astype(np.int32),
        "lo_flag": rng.integers(0, 2, ROWS).astype(np.int32),
        "lo_orderkey": np.repeat(base + 3 * np.arange(ORDERS, dtype=np.int32),
                                 ROWS // ORDERS),
        "a": rng.integers(0, 100_000, ROWS).astype(np.int32),
        "lo_quantity": rng.integers(1, 51, ROWS).astype(np.int32),
        "lo_extendedprice": rng.integers(1, 55_001, ROWS).astype(np.int32),
        "lo_revenue": rng.integers(1, 600_000, ROWS).astype(np.int32),
        "lo_tax": np.round(rng.gamma(3.0, 9.0, ROWS), 2),
    }


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    rng = np.random.default_rng(29)
    schema = Schema.build(TABLE, dimensions=DIMS, metrics=METRICS)
    cfg = TableConfig(table_name=TABLE,
                      indexing=IndexingConfig(no_dictionary_columns=RAW))
    root = tmp_path_factory.mktemp("torch_aggs")
    paths = []
    for i in range(SEGMENTS):
        SegmentBuilder(schema, cfg, f"s{i}").build(
            _cols(rng, 10_000 * i), root / f"s{i}")
        paths.append(root / f"s{i}")
    port = QueryExecutor(device="cpu")
    port.add_table(schema, [load_segment(p) for p in paths])
    jsegs = [jax_load(p) for p in paths]
    jax = JaxQueryExecutor(backend="tpu")
    jax.add_table(JaxSchema.build(TABLE, dimensions=DIMS, metrics=METRICS),
                  jsegs)
    return port, jax, jsegs, [load_segment(p) for p in paths]


# -- the sketches ----------------------------------------------------------------


def test_sketches_equal_jax():
    rng = np.random.default_rng(11)
    ints = rng.integers(-(1 << 40), 1 << 40, 5000)
    floats = np.round(rng.gamma(3.0, 9.0, 5000), 2)
    strings = np.asarray([f"v{i}" for i in rng.integers(0, 3000, 700)],
                         dtype=object)
    for vals in (ints, floats, strings):
        np.testing.assert_array_equal(sketches.hash64_any(vals),
                                      jax_sketches.hash64_any(vals))
        for log2m in (8, 12):
            a = sketches.HyperLogLog(log2m).add_values(vals)
            b = jax_sketches.HyperLogLog(log2m).add_values(vals)
            np.testing.assert_array_equal(a.registers, b.registers)
            assert a.cardinality() == b.cardinality()
        a = sketches.ThetaSketch(k=256).add_values(vals)
        b = jax_sketches.ThetaSketch(k=256).add_values(vals)
        np.testing.assert_array_equal(a.hashes, b.hashes)
        assert a.cardinality() == b.cardinality()
        halves = np.array_split(vals, 2)
        a = sketches.SmartDistinctSet(threshold=1000).add_values(
            halves[0]).merge(sketches.SmartDistinctSet(
                threshold=1000).add_values(halves[1]))
        b = jax_sketches.SmartDistinctSet(threshold=1000).add_values(
            halves[0]).merge(jax_sketches.SmartDistinctSet(
                threshold=1000).add_values(halves[1]))
        assert a.cardinality() == b.cardinality()
    for compression in (100, 500):
        a = sketches.TDigest(compression).add_values(floats[:2500]).merge(
            sketches.TDigest(compression).add_weighted(floats[2500:],
                                                       np.arange(2500) % 3))
        b = jax_sketches.TDigest(compression).add_values(floats[:2500]).merge(
            jax_sketches.TDigest(compression).add_weighted(
                floats[2500:], np.arange(2500) % 3))
        np.testing.assert_array_equal(a.means, b.means)
        np.testing.assert_array_equal(a.weights, b.weights)
        for q in (0.0, 0.05, 0.5, 0.95, 1.0):
            assert a.quantile(q) == b.quantile(q)
    small = rng.integers(0, 30, 4000)
    a = sketches.ValueHist.from_values(small[:1000]).merge(
        sketches.ValueHist.from_values(small[1000:]))
    b = jax_sketches.ValueHist.from_values(small[:1000]).merge(
        jax_sketches.ValueHist.from_values(small[1000:]))
    assert a.counts == b.counts
    assert a.mode() == b.mode()
    for p in (0, 10, 50, 90, 99, 100):
        assert a.percentile(p) == b.percentile(p)
    np.testing.assert_array_equal(a.to_tdigest(500).means,
                                  b.to_tdigest(500).means)


def test_rebased_f32_plane_and_warm(tables):
    """The rawf32r plane is bit-identical to the JAX package's; warm()
    uploads every plane a query of the table reads, so the query uploads
    nothing more."""
    _, _, jsegs, psegs = tables
    got = SegmentDeviceView(psegs[0], "cpu").raw_f32_rebased("lo_tax")
    want = np.asarray(JaxView(jsegs[0]).raw_f32_rebased("lo_tax"))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.view(np.uint32))
    port = QueryExecutor(device="cpu")
    port.add_table(Schema.build(TABLE, dimensions=DIMS, metrics=METRICS),
                   psegs)
    cache = port.executor.cache
    # 8 dictionary columns (id plane; the 6 numeric ones their values too),
    # 4 raw ones, and the DOUBLE one's rebased plane
    assert [cache.warm(s) for s in psegs] == [19] * SEGMENTS
    warmed = cache.bytes_used()
    port.execute_sql("SET segmentBatch = false; SELECT p_brand, "
                     "PERCENTILETDIGEST(lo_tax, 95), STDDEVPOP(lo_revenue) "
                     "FROM t GROUP BY p_brand")
    assert cache.bytes_used() == warmed


# -- the interpreter ------------------------------------------------------------

# (sql, path): one plan per matrix kind and mode, path as the plan must take
PROGRAMS = [
    ("SELECT d_year, DISTINCTCOUNT(p_brand), PERCENTILE(lo_discount, 50) "
     "FROM t WHERE s_region <> 'ASIA' GROUP BY d_year", "dense"),
    ("SELECT p_brand, PERCENTILETDIGEST(lo_tax, 95), "
     "PERCENTILEEST(lo_revenue, 20) FROM t GROUP BY p_brand", "dense"),
    ("SELECT lo_orderkey, PERCENTILEKLL(a, 90) FROM t "
     "WHERE lo_discount > 1 GROUP BY lo_orderkey", "dense"),
    ("SELECT d_year, HISTOGRAM(lo_quantity, 0, 50, 10), "
     "HISTOGRAM(lo_tax, 10, 40, 7) FROM t GROUP BY d_year", "dense"),
    ("SELECT DISTINCTCOUNT(p_brand), MODE(lo_discount), "
     "PERCENTILETDIGEST(lo_tax, 50), HISTOGRAM(lo_tax, 0, 100, 20) FROM t "
     "WHERE d_year > 1993", "aggregation"),
    ("SET sparseGroupBy = true; SELECT lo_orderkey, DISTINCTCOUNT(lo_discount), "
     "SUM(lo_revenue), COUNT(*) FROM t WHERE lo_flag = 1 "
     "GROUP BY lo_orderkey ORDER BY lo_orderkey LIMIT 800", "presorted"),
    ("SET sparseGroupBy = true; SET numGroupsLimit = 3000; SELECT d_year, "
     "lo_orderkey, DISTINCTCOUNT(p_brand), MAX(lo_revenue) FROM t "
     "WHERE s_region IN ('ASIA', 'EUROPE') GROUP BY d_year, lo_orderkey",
     "packed"),
    # 7 x 1000 x 11 x 2966 key combinations: above the dense limit; times
    # the 100 brands, above 2^31: the ids sort as a second key
    ("SET numGroupsLimit = 2000; SELECT d_year, lo_orderkey, lo_discount, "
     "a, DISTINCTCOUNT(p_brand), MIN(lo_tax) FROM t GROUP BY d_year, "
     "lo_orderkey, lo_discount, a", "two_key"),
]


def _path(program):
    if program.mode != "group_by_sparse":
        return "dense" if program.mode == "group_by" else program.mode
    if program.keys_presorted:
        return "presorted"
    card = next(a.card for a in program.aggs if a.kind == "distinct_bitmap")
    return "packed" if program.key_space * card < (1 << 31) - 1 else "two_key"


def _compare(got, want):
    """Element-equal with equal dtypes; float64 sums of the DOUBLE column
    within rtol 1e-12 (the engines add in another order)."""
    assert len(got) == len(want)
    for o, w in zip(got, want):
        o, w = np.asarray(o), np.asarray(w)
        assert o.dtype == w.dtype and o.shape == w.shape
        if o.dtype.kind == "f":
            np.testing.assert_allclose(o, w, rtol=1e-12, atol=0)
        else:
            np.testing.assert_array_equal(o, w)


@pytest.mark.parametrize("sql,path", PROGRAMS)
def test_run_program_matches_jax(tables, sql, path):
    _, _, jsegs, psegs = tables
    kinds = set()
    for jseg, pseg in zip(jsegs, psegs):
        jplan = JaxPlanner(jax_parse(sql), jseg).plan()
        pplan = SegmentPlanner(parse_sql(sql), pseg).plan()
        assert repr(pplan.program) == repr(jplan.program)
        assert pplan.slots == jplan.slots
        assert _path(pplan.program) == path
        kinds |= {a.kind for a in pplan.program.aggs}
        view = JaxView(jseg)
        arrays, packed = jplan.gather_arrays_packed(view)
        arrays = tuple(np.asarray(a) for a in arrays)
        params = tuple(np.asarray(p) for p in jplan.params)
        want = jax_kernels.run_program(jplan.program, arrays, params,
                                       np.int32(jseg.num_docs), view.padded,
                                       packed=packed, fused="")
        targs, tparams = planes_from_numpy(arrays, params, "cpu")
        got = run_program(pplan.program, targs, tparams, pseg.num_docs,
                          view.padded, packed=packed, device="cpu")
        _compare([o.numpy() for o in got], want)
        # the port's own planes (its device view) give the same outputs
        pview = SegmentDeviceView(pseg, "cpu", packed=True)
        parrays, ppacked = pplan.gather_arrays_packed(pview)
        got2 = run_program(pplan.program, parrays, tparams, pseg.num_docs,
                           pview.padded, packed=ppacked, device="cpu")
        _compare([o.numpy() for o in got2], want)
    assert kinds & {"distinct_bitmap", "value_hist", "hist_adaptive",
                    "hist_fixed"}


def test_two_key_sort_over_repeated_ids(tables):
    """The two-key sort where groups hold many rows and repeat their ids:
    the program of a 7-group sparse DISTINCTCOUNT with its static key
    space raised (in both packages alike) so that key space x card passes
    2^31 while the keys stay int32."""
    _, _, jsegs, psegs = tables
    sql = ("SET sparseGroupBy = true; SELECT d_year, DISTINCTCOUNT(p_brand), "
           "COUNT(*) FROM t WHERE lo_flag = 1 GROUP BY d_year")
    jplan = JaxPlanner(jax_parse(sql), jsegs[1]).plan()
    pplan = SegmentPlanner(parse_sql(sql), psegs[1]).plan()
    key_space = (1 << 31) // 100 + 1
    jprog = dataclasses.replace(jplan.program, key_space=key_space)
    pprog = dataclasses.replace(pplan.program, key_space=key_space)
    assert _path(pprog) == "two_key"
    view = JaxView(jsegs[1])
    arrays, packed = jplan.gather_arrays_packed(view)
    arrays = tuple(np.asarray(a) for a in arrays)
    params = tuple(np.asarray(p) for p in jplan.params)
    want = jax_kernels.run_program(jprog, arrays, params,
                                   np.int32(jsegs[1].num_docs), view.padded,
                                   packed=packed, fused="")
    targs, tparams = planes_from_numpy(arrays, params, "cpu")
    got = run_program(pprog, targs, tparams, psegs[1].num_docs, view.padded,
                      packed=packed, device="cpu")
    _compare([o.numpy() for o in got], want)
    assert int(np.asarray(want[0])[:7].min()) > 100  # rows a group


@pytest.mark.parametrize("sql,path", [p for p in PROGRAMS
                                      if p[1] in ("dense", "aggregation",
                                                  "presorted")])
def test_run_program_batch_matches_jax(tables, sql, path):
    _, _, jsegs, psegs = tables
    jplans = [JaxPlanner(jax_parse(sql), s).plan() for s in jsegs]
    pplans = [SegmentPlanner(parse_sql(sql), s).plan() for s in psegs]
    if path == "presorted":  # each segment's key space is its own
        jplans, jsegs = jplans[:1], jsegs[:1]
    views, arrays, params_b, packed, num_docs = JaxExecutor()._gather_batch(
        jsegs, jplans)
    arrays = tuple(np.asarray(a) for a in arrays)
    want = jax_kernels.run_program_batch(
        jplans[0].program, arrays, params_b, num_docs, views[0].padded,
        packed=packed)
    got = run_program_batch(
        pplans[0].program, tuple(torch.from_numpy(np.array(a)) for a in arrays),
        tuple(torch.from_numpy(np.array(p)) for p in params_b),
        np.asarray(num_docs), views[0].padded, packed=packed, device="cpu")
    _compare([o.numpy() for o in got], want)


def test_adaptive_histogram_rows(tables):
    """The hist_adaptive output: pass-1 counts of each group sum to its
    in-range rows, pass 2 holds exactly the rows of the group's bucket
    bstar, which is where the asked rank falls."""
    _, _, _, psegs = tables
    sql = "SELECT p_brand, PERCENTILETDIGEST(lo_tax, 95) FROM t GROUP BY p_brand"
    plan = SegmentPlanner(parse_sql(sql), psegs[0]).plan()
    (agg,) = plan.program.aggs
    assert agg.kind == "hist_adaptive" and agg.prebased
    assert plan.slots[agg.vexpr.slot] == ("lo_tax", "rawf32r")
    view = SegmentDeviceView(psegs[0], "cpu")
    arrays, packed = plan.gather_arrays_packed(view)
    params = tuple(torch.from_numpy(np.array(p)) for p in plan.params)
    counts, out = run_program(plan.program, arrays, params, psegs[0].num_docs,
                              view.padded, packed=packed, device="cpu")
    b = agg.bins
    h1, h2, bstar = out[:, :b], out[:, b:2 * b], out[:, 2 * b]
    np.testing.assert_array_equal(h1.sum(1).numpy(), counts[:-1].numpy())
    np.testing.assert_array_equal(
        h2.sum(1).numpy(), torch.gather(h1, 1, bstar.unsqueeze(1))[:, 0].numpy())
    cum = h1.cumsum(1).double()
    rank = cum[:, -1] * 0.95
    live = counts[:-1] > 0
    assert bool((cum.gather(1, bstar.unsqueeze(1))[:, 0] >= rank)[live].all())


# -- SQL end to end -------------------------------------------------------------

# every function in scope, each over the column shape it takes
FUNCTIONS = [
    "DISTINCTCOUNT(p_brand)", "DISTINCTCOUNT(s_region)",
    "DISTINCTCOUNTBITMAP(p_brand)", "SEGMENTPARTITIONEDDISTINCTCOUNT(p_brand)",
    "DISTINCTSUM(lo_discount)", "DISTINCTAVG(p_brand)",
    "DISTINCTCOUNTHLL(p_brand)", "DISTINCTCOUNTHLL(s_region, 8)",
    "DISTINCTCOUNTHLLPLUS(p_brand)", "DISTINCTCOUNTULL(p_brand)",
    "DISTINCTCOUNTCPC(p_brand)", "DISTINCTCOUNTTHETA(p_brand)",
    "DISTINCTCOUNTRAWTHETA(s_region)", "DISTINCTCOUNTSMART(p_brand)",
    "DISTINCTCOUNTSMARTHLL(p_brand)",
    "PERCENTILE(lo_discount, 90)", "PERCENTILE95(p_brand)",
    "MODE(lo_discount)",
    "PERCENTILEEST(lo_discount, 50)", "PERCENTILETDIGEST(lo_tax, 95)",
    "PERCENTILETDIGEST99(lo_revenue)", "PERCENTILEKLL(lo_tax, 75)",
    "PERCENTILESMARTTDIGEST(lo_tax, 5)", "PERCENTILERAWEST(p_brand, 30)",
    "PERCENTILERAWTDIGEST(lo_extendedprice, 60)",
    "PERCENTILERAWKLL(lo_quantity, 10)",
    "HISTOGRAM(lo_quantity, 0, 50, 10)", "HISTOGRAM(lo_tax, 0, 100, 20)",
    "STDDEVPOP(lo_extendedprice)", "STDDEVSAMP(lo_tax)",
    "VARPOP(lo_revenue)", "VARSAMP(lo_quantity)",
    "SKEWNESS(lo_discount)", "KURTOSIS(lo_quantity)",
    "COVARPOP(lo_quantity, lo_revenue)", "COVARSAMP(lo_discount, lo_tax)",
    "CORR(lo_quantity, lo_revenue)",
    "BOOLAND(lo_flag)", "BOOLOR(lo_flag)", "BOOLAGG(lo_flag)",
    "MINMAXRANGE(lo_revenue)", "MINMAXRANGE(lo_tax)",
]


def _cells_equal(a, b):
    if isinstance(a, list) or isinstance(b, list):
        return len(a) == len(b) and all(_cells_equal(x, y)
                                        for x, y in zip(a, b))
    if isinstance(a, float) or isinstance(b, float):
        a, b = float(a), float(b)
        if math.isnan(a) or math.isnan(b):
            return math.isnan(a) and math.isnan(b)
        return math.isclose(a, b, rel_tol=1e-12, abs_tol=0.0)
    return a == b and type(a) is type(b)


def _check(port, jax, jsegs, sql, ordered=False):
    """Rows, schema and scanned docs equal the JAX package's; its planner
    lowers the query on every segment (its device path answered)."""
    for seg in jsegs:
        JaxPlanner(jax_parse(sql), seg).plan()
    got = port.execute_sql(sql)
    want = jax.execute_sql(sql)
    assert not want.exceptions, want.exceptions
    assert got.result_table.schema.to_json() == \
        want.result_table.schema.to_json()
    g, w = got.result_table.rows, want.result_table.rows
    if not ordered:
        g, w = sorted(map(tuple, g)), sorted(map(tuple, w))
    assert len(g) == len(w)
    for rg, rw in zip(g, w):
        assert len(rg) == len(rw)
        assert all(_cells_equal(a, b) for a, b in zip(rg, rw)), (rg, rw)
    assert got.num_docs_scanned == want.num_docs_scanned
    assert got.num_device_dispatches == want.num_device_dispatches
    return got


@pytest.mark.parametrize("fn", FUNCTIONS)
def test_function_matches_jax(tables, fn):
    """One batch family of the three segments (one dispatch), and the
    un-grouped form."""
    port, jax, jsegs, _ = tables
    got = _check(port, jax, jsegs,
                 f"SELECT d_year, {fn} FROM t WHERE lo_discount <> 3 "
                 "GROUP BY d_year LIMIT 100")
    assert got.num_device_dispatches == 1
    _check(port, jax, jsegs, f"SELECT {fn} FROM t WHERE s_region <> 'ASIA'")


AGGMIX = ("DISTINCTCOUNT(p_brand), DISTINCTCOUNTHLL(p_brand), "
          "PERCENTILE(lo_discount, 90), MODE(lo_discount), "
          "HISTOGRAM(lo_quantity, 0, 50, 10), PERCENTILETDIGEST(lo_revenue, 95), "
          "STDDEVPOP(lo_extendedprice), CORR(lo_quantity, lo_revenue)")

# (sql, ordered) per mode
MODE_QUERIES = [
    # dense solo: one dispatch per segment
    (f"SET segmentBatch = false; SELECT d_year, {AGGMIX} FROM t "
     "WHERE s_region = 'ASIA' GROUP BY d_year LIMIT 100", False),
    # a family, then the broker's ORDER BY over object states
    (f"SELECT d_year, s_region, {AGGMIX} FROM t GROUP BY d_year, s_region "
     "ORDER BY DISTINCTCOUNT(p_brand) DESC, d_year, s_region LIMIT 20", True),
    # HAVING and post-aggregation arithmetic over object states
    ("SELECT p_brand, DISTINCTCOUNT(lo_discount) * 2, "
     "PERCENTILE(lo_discount, 50) FROM t GROUP BY p_brand "
     "HAVING DISTINCTCOUNT(lo_discount) > 9 ORDER BY p_brand LIMIT 50", True),
    # un-grouped, solo and as a family
    (f"SET segmentBatch = false; SELECT {AGGMIX}, MINMAXRANGE(lo_tax), "
     "PERCENTILETDIGEST(lo_tax, 50) FROM t", False),
    (f"SELECT {AGGMIX}, SKEWNESS(lo_tax), KURTOSIS(lo_revenue) FROM t "
     "WHERE lo_flag = 0", False),
    # the adaptive histogram of a high-card dictionary column
    ("SELECT lo_orderkey, PERCENTILETDIGEST(a, 50) FROM t GROUP BY "
     "lo_orderkey ORDER BY lo_orderkey LIMIT 3000", True),
    # sparse: presorted keys, the host merge of 3 x 800 slots
    ("SET sparseGroupBy = true; SELECT lo_orderkey, DISTINCTCOUNT(lo_discount), "
     "SUM(lo_revenue) FROM t GROUP BY lo_orderkey ORDER BY lo_orderkey "
     "LIMIT 800", True),
    ("SET sparseGroupBy = true; SET numGroupsLimit = 500; SELECT lo_orderkey, "
     "DISTINCTCOUNTHLL(p_brand), COUNT(*) FROM t WHERE lo_flag = 1 "
     "GROUP BY lo_orderkey", False),
    # sparse: the sort path, ids packed into the key
    ("SET sparseGroupBy = true; SELECT d_year, lo_orderkey, "
     "DISTINCTCOUNT(lo_discount), DISTINCTSUM(lo_discount) FROM t "
     "GROUP BY d_year, lo_orderkey ORDER BY d_year, lo_orderkey LIMIT 4000",
     True),
    # sparse: the two-key sort (key space x card above 2^31), the
    # numGroupsLimit trim
    ("SET numGroupsLimit = 1500; SELECT d_year, lo_orderkey, lo_discount, a, "
     "DISTINCTCOUNTTHETA(p_brand), DISTINCTCOUNT(p_brand), MAX(lo_tax) FROM t "
     "GROUP BY d_year, lo_orderkey, lo_discount, a", False),
]


@pytest.mark.parametrize("sql,ordered", MODE_QUERIES)
def test_modes_match_jax(tables, sql, ordered):
    port, jax, jsegs, _ = tables
    before = kernels.host_fetches()
    _check(port, jax, jsegs, sql, ordered)
    assert kernels.host_fetches() - before == 1


def test_sparse_distinct_declines_device_combine(tables):
    """A DISTINCT bitmap has no device merge: the segments run as one
    family and merge on the host; the same query without it merges on the
    device."""
    port, _, _, _ = tables
    sql = ("SET sparseGroupBy = true; SELECT lo_orderkey, {} FROM t "
           "GROUP BY lo_orderkey ORDER BY lo_orderkey LIMIT 800")
    calls = []
    orig = kernels.combine_sparse_group_tables
    kernels.combine_sparse_group_tables = lambda *a: calls.append(a) or orig(*a)
    try:
        got = port.execute_sql(sql.format("DISTINCTCOUNT(lo_discount)"))
        assert not calls and got.num_device_dispatches == 1
        port.execute_sql(sql.format("SUM(lo_revenue)"))
        assert len(calls) == 1
    finally:
        kernels.combine_sparse_group_tables = orig


def test_cpu_run_launches_no_kernel(tables):
    port = tables[0]
    before = dict(_cuda.LAUNCHES)
    port.execute_sql(f"SELECT d_year, {AGGMIX} FROM t GROUP BY d_year")
    assert _cuda.LAUNCHES == before


@pytest.mark.parametrize("sql", [
    # the JAX package's host engine answers these
    "SELECT d_year, EXPRMIN(lo_revenue, lo_tax) FROM t GROUP BY d_year",
    "SELECT d_year, SUMMV(lo_revenue) FROM t GROUP BY d_year",
    "SELECT DISTINCTCOUNTMV(p_brand) FROM t",
    "SELECT d_year, ARRAYAGG(p_brand, 'INT') FROM t GROUP BY d_year",
    "SELECT d_year, DISTINCTCOUNT(p_brand) FILTER (WHERE lo_flag = 1) FROM t "
    "GROUP BY d_year",
    "SET enableNullHandling = true; SELECT d_year, DISTINCTCOUNT(s_nation) "
    "FROM t GROUP BY d_year",
    # PERCENTILE and DISTINCTCOUNT need a dictionary column
    "SELECT d_year, PERCENTILE(lo_revenue, 50) FROM t GROUP BY d_year",
    "SELECT DISTINCTCOUNT(lo_tax) FROM t",
    "SELECT d_year, PERCENTILE(s_region, 50) FROM t GROUP BY d_year",
    # the sparse group-by takes one DISTINCT column and no histogram
    "SET sparseGroupBy = true; SELECT d_year, DISTINCTCOUNT(p_brand), "
    "DISTINCTCOUNT(lo_discount) FROM t GROUP BY d_year",
    "SET sparseGroupBy = true; SELECT d_year, PERCENTILE(lo_discount, 5) "
    "FROM t GROUP BY d_year",
])
def test_host_engine_shapes_raise(tables, sql):
    """The single-stage planners of both packages refuse these. Both then
    retry on their multi-stage engine (execute_sql under backend="tpu"):
    the port answers what the JAX package answers there, with the same
    rows, docs scanned and dispatches, and raises where it fails."""
    port, jax, jsegs, psegs = tables
    from pinot_tpu.engine.aggregation import \
        UnsupportedQueryError as JaxUnsupported

    with pytest.raises(JaxUnsupported):
        JaxPlanner(jax_parse(sql), jsegs[0]).plan()
    want = jax.execute_sql(sql)
    if want.exceptions:
        with pytest.raises(UnsupportedQueryError):
            port.execute_sql(sql)
        return
    got = port.execute_sql(sql)
    assert sorted(map(repr, got.result_table.rows)) == \
        sorted(map(repr, want.result_table.rows))
    assert got.num_docs_scanned == want.num_docs_scanned
    assert got.num_device_dispatches == want.num_device_dispatches


# -- the compiled reference's bin widths (faults F3 and F4) ---------------------

# values on HISTOGRAM(x, 0, 3, 10)'s bin edges: (hi - lo) / 10 by IEEE
# division puts 0.3, 0.9, 1.5, 2.1 and 2.7 one bin lower than the JAX
# package's compiled `(hi - lo) * f64(1 / 10)` does
EDGE_VALUES = [0.3, 0.6, 0.7, 0.9, 1.5, 2.1, 2.4, 2.7]


@pytest.fixture(scope="module")
def edge_table(tmp_path_factory):
    schema = Schema.build("e", dimensions=[("g", "INT")],
                          metrics=[("x", "DOUBLE")])
    cfg = TableConfig(table_name="e",
                      indexing=IndexingConfig(no_dictionary_columns=["x"]))
    path = tmp_path_factory.mktemp("torch_edges") / "s0"
    SegmentBuilder(schema, cfg, "s0").build(
        {"g": np.arange(8, dtype=np.int32) % 2,
         "x": np.asarray(EDGE_VALUES)}, path)
    port = QueryExecutor(device="cpu")
    port.add_table(schema, [load_segment(path)])
    jax = JaxQueryExecutor(backend="tpu")
    jax.add_table(JaxSchema.build("e", dimensions=[("g", "INT")],
                                  metrics=[("x", "DOUBLE")]), [jax_load(path)])
    return port, jax, path


@pytest.mark.parametrize("sql", [
    "SELECT HISTOGRAM(x, 0, 3, 10) FROM e",
    "SELECT g, HISTOGRAM(x, 0, 3, 10), HISTOGRAM(x, 0.3, 2.7, 8) FROM e "
    "GROUP BY g",
])
def test_hist_fixed_edges_equal_jax(edge_table, sql):
    """F3: run_program's fixed-bin counts element-equal to the JAX
    package's compiled program on values at bin edges, and the rows
    equal its rows."""
    port, jax, path = edge_table
    jseg, pseg = jax_load(path), load_segment(path)
    jplan = JaxPlanner(jax_parse(sql), jseg).plan()
    pplan = SegmentPlanner(parse_sql(sql), pseg).plan()
    view = JaxView(jseg)
    arrays, packed = jplan.gather_arrays_packed(view)
    arrays = tuple(np.asarray(a) for a in arrays)
    params = tuple(np.asarray(p) for p in jplan.params)
    want = jax_kernels.run_program(jplan.program, arrays, params,
                                   np.int32(jseg.num_docs), view.padded,
                                   packed=packed, fused="")
    targs, tparams = planes_from_numpy(arrays, params, "cpu")
    got = run_program(pplan.program, targs, tparams, pseg.num_docs,
                      view.padded, packed=packed, device="cpu")
    _compare([o.numpy() for o in got], want)
    assert port.execute_sql(sql).result_table.rows == \
        jax.execute_sql(sql).result_table.rows
    if "GROUP BY" not in sql:
        assert port.execute_sql(sql).result_table.rows == \
            [[[1.0, 1.0, 2.0, 0.0, 1.0, 0.0, 1.0, 1.0, 0.0, 1.0]]]


def _adaptive_program(ir_mod, bins):
    agg = ir_mod.AggOp("hist_adaptive", vexpr=ir_mod.Col(0), bins=bins,
                       lo_param=0, hi_param=1, pct=99.0, prebased=True)
    return ir_mod.Program(mode="group_by", filter=None, aggs=(agg,),
                          group_slots=(1,), group_strides=(1,), num_groups=2)


@pytest.mark.parametrize("v,group", [(31.226402, 0), (31.226402, 1),
                                     (28.501868, 0), (60.56665, 1)])
def test_hist_adaptive_widths_equal_jax(v, group):
    """F4: the adaptive histogram's two widths are the compiled
    reference's `span * f32(1 / bins)` and `span * f32(1 / bins^2)`. The
    rebased value 31.226402 over lo -30.9284687, hi 29.63817787 and 17
    bins sits on a pass-2 edge of bucket 8: the reference puts it in fine
    bin 12 (IEEE `width1 / bins` gave 13)."""
    from pinot_tpu.engine import ir as jax_ir
    from pinot_tpu_torch.engine import ir

    bins, padded = 17, 8192
    plane = np.zeros(padded, np.float32)
    plane[0] = np.float32(v)
    gids = np.zeros(padded, np.int32)
    gids[0] = group
    params = (np.float64(-30.9284687), np.float64(29.63817787))
    want = jax_kernels.run_program(_adaptive_program(jax_ir, bins),
                                   (plane, gids), params, np.int32(1), padded,
                                   fused="")
    targs, tparams = planes_from_numpy((plane, gids), params, "cpu")
    got = run_program(_adaptive_program(ir, bins), targs, tparams, 1, padded,
                      device="cpu")
    _compare([o.numpy() for o in got], want)
    if v == 31.226402:
        row = got[1][group].numpy()
        assert row[2 * bins] == 8                     # bstar
        assert row[bins + 12] == 1 and row[bins:2 * bins].sum() == 1
