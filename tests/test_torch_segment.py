"""The port's segment format, builder and loader against the JAX package's.

The on-disk format is shared: the JAX builder's output loads in the port,
the port builder's output loads in the JAX package, and both builders write
the same bytes, metadata and CRCs from the same seeded columns. Both
planners then lower the same queries to the same Program (engine/ir.py is a
verbatim copy, so the reprs are equal).
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from pinot_tpu.engine.plan import SegmentPlanner as JaxPlanner
from pinot_tpu.query.parser.sql import parse_sql as jax_parse
from pinot_tpu.segment.builder import SegmentBuilder as JaxBuilder
from pinot_tpu.segment.loader import load_segment as jax_load
from pinot_tpu.spi.data_types import Schema as JaxSchema
from pinot_tpu.spi.table_config import IndexingConfig as JaxIndexing
from pinot_tpu.spi.table_config import TableConfig as JaxTableConfig
from pinot_tpu_torch.engine.aggregation import UnsupportedQueryError
from pinot_tpu_torch.engine.plan import SegmentPlanner
from pinot_tpu_torch.query.parser.sql import parse_sql
from pinot_tpu_torch.segment.builder import SegmentBuilder
from pinot_tpu_torch.segment.device_cache import DeviceSegmentCache, SegmentDeviceView, pad_bucket
from pinot_tpu_torch.segment.loader import SegmentIntegrityError, load_segment
from pinot_tpu_torch.spi.data_types import Schema
from pinot_tpu_torch.spi.table_config import IndexingConfig, TableConfig

N = 3000
DIMS = [("year", "INT"), ("brand", "INT"), ("region", "STRING"),
        ("score", "DOUBLE"), ("code", "LONG")]
METRICS = [("rev", "INT"), ("price", "DOUBLE"), ("big", "LONG")]
RAW = ["rev", "price", "big"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _columns(seed):
    rng = np.random.default_rng(seed)
    return {
        "year": rng.integers(1992, 1999, N).astype(np.int32),
        "brand": rng.integers(0, 400, N).astype(np.int32),
        "region": [["ASIA", "EUROPE", "AMERICA", None][i]
                   for i in rng.integers(0, 4, N)],
        "score": np.round(rng.normal(0, 10, N), 1),
        "code": rng.integers(-(1 << 40), 1 << 40, N).astype(np.int64),
        "rev": rng.integers(-5000, 600_000, N).astype(np.int32),
        "price": rng.normal(100.0, 25.0, N),
        "big": rng.integers(0, 1 << 50, N).astype(np.int64),
    }


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_seg")
    cols = _columns(5)
    JaxBuilder(JaxSchema.build("t", dimensions=DIMS, metrics=METRICS),
               JaxTableConfig(table_name="t",
                              indexing=JaxIndexing(no_dictionary_columns=RAW)),
               "s").build(cols, root / "jax")
    SegmentBuilder(Schema.build("t", dimensions=DIMS, metrics=METRICS),
                   TableConfig(table_name="t",
                               indexing=IndexingConfig(no_dictionary_columns=RAW)),
                   "s").build(cols, root / "torch")
    return root


def _meta_json(path):
    meta = json.loads((path / "metadata.json").read_text())
    meta.pop("creationTimeMs")
    return meta


def test_builders_write_the_same_segment(built):
    assert (built / "jax" / "data.bin").read_bytes() == \
        (built / "torch" / "data.bin").read_bytes()
    jm, tm = _meta_json(built / "jax"), _meta_json(built / "torch")
    assert tm == jm
    assert tm["crc"] and tm["bufferCrcs"] and tm["columnCrcs"]


@pytest.mark.parametrize("writer,reader", [("jax", "torch"), ("torch", "jax")])
def test_loaders_read_each_others_segments(built, writer, reader):
    path = built / writer
    a = jax_load(path) if writer == "jax" else load_segment(path)
    b = load_segment(path) if reader == "torch" else jax_load(path)
    assert a.num_docs == b.num_docs == N
    for name, _ in DIMS + METRICS:
        ma, mb = a.column_metadata(name), b.column_metadata(name)
        assert (ma.encoding, ma.cardinality, ma.bits_per_value, ma.is_sorted,
                ma.min_value, ma.max_value, ma.has_nulls) == \
            (mb.encoding, mb.cardinality, mb.bits_per_value, mb.is_sorted,
             mb.min_value, mb.max_value, mb.has_nulls)
        if ma.encoding == "DICT":
            np.testing.assert_array_equal(a.get_dict_ids(name), b.get_dict_ids(name))
            np.testing.assert_array_equal(np.asarray(a.get_dictionary(name).values),
                                          np.asarray(b.get_dictionary(name).values))
        else:
            np.testing.assert_array_equal(a.get_raw(name), b.get_raw(name))
        na, nb = a.get_null_bitmap(name), b.get_null_bitmap(name)
        assert (na is None) == (nb is None)
        if na is not None:
            np.testing.assert_array_equal(na, nb)


def test_loader_verifies_crcs(built, tmp_path):
    import shutil

    bad = tmp_path / "bad"
    shutil.copytree(built / "torch", bad)
    data = bytearray((bad / "data.bin").read_bytes())
    data[len(data) // 2] ^= 0xFF
    (bad / "data.bin").write_bytes(bytes(data))
    with pytest.raises(SegmentIntegrityError):
        load_segment(bad)
    load_segment(bad, verify=False)  # opt-out still loads


PLAN_SQLS = [
    "SELECT year, brand, SUM(rev), COUNT(*) FROM t WHERE region = 'ASIA' "
    "GROUP BY year, brand LIMIT 10000",
    "SELECT SUM(price), MIN(score), MAX(big), AVG(rev) FROM t "
    "WHERE year BETWEEN 1993 AND 1995 AND rev > 100",
    "SELECT region, COUNT(*), SUM(rev) FROM t WHERE brand IN (1, 2, 3, 50) "
    "OR code < 0 GROUP BY region LIMIT 10",
    "SELECT year, SUM(rev) FILTER (WHERE brand < 10), MAX(price - score) "
    "FROM t WHERE region LIKE 'A%' GROUP BY year LIMIT 10",
    "SET enableNullHandling = true; SELECT year, COUNT(region), MIN(rev) "
    "FROM t WHERE region <> 'ASIA' GROUP BY year LIMIT 10",
    # group cardinality product 3000 * 400 * 7 is above the dense limit:
    # the sparse mode, its ORDER BY trim exact
    "SELECT code, brand, year, COUNT(*) FROM t GROUP BY code, brand, year "
    "ORDER BY code, brand, year LIMIT 500",
    "SET sparseGroupBy = true; SET numGroupsLimit = 50; SELECT brand, "
    "SUM(rev), MIN(price) FROM t WHERE year > 1993 GROUP BY brand",
    # DISTINCTCOUNT in the sparse (sort-based) mode, the ids packed into
    # the key
    "SET sparseGroupBy = true; SELECT year, DISTINCTCOUNT(brand) FROM t "
    "GROUP BY year",
    # PERCENTILE over a dictionary column: a value histogram
    "SELECT year, PERCENTILE(brand, 50) FROM t GROUP BY year",
    # the adaptive histogram: the rebased f32 plane of a raw DOUBLE, the
    # value plane of a raw INT; HISTOGRAM's fixed bins; the moments
    "SELECT region, PERCENTILETDIGEST(price, 95), PERCENTILEEST(rev, 20), "
    "HISTOGRAM(score, -10, 10, 8), STDDEVSAMP(rev), CORR(price, big), "
    "KURTOSIS(year), BOOLOR(brand) FROM t GROUP BY region LIMIT 10",
    # the occupancy of 400 brands x 3000 codes x 7 years sends it sparse
    "SELECT code, year, DISTINCTCOUNTHLL(brand), COUNT(*) FROM t "
    "GROUP BY code, year ORDER BY code, year LIMIT 100",
    # selection: the device computes the filter mask only
    "SELECT year, rev FROM t LIMIT 10",
    "SELECT rev * 2, year FROM t WHERE region = 'ASIA' ORDER BY year DESC, "
    "price + 1 LIMIT 10",
]


@pytest.mark.parametrize("sql", PLAN_SQLS)
def test_programs_equal_jax(built, sql):
    jplan = JaxPlanner(jax_parse(sql), jax_load(built / "jax")).plan()
    pplan = SegmentPlanner(parse_sql(sql), load_segment(built / "jax")).plan()
    assert repr(pplan.program) == repr(jplan.program)
    assert pplan.slots == jplan.slots
    assert len(pplan.params) == len(jplan.params)
    for a, b in zip(pplan.params, jplan.params):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert np.asarray(a).dtype == np.asarray(b).dtype
    assert pplan.selection_columns == jplan.selection_columns
    assert pplan.selection_exprs.keys() == jplan.selection_exprs.keys()


@pytest.mark.parametrize("sql", [
    # a selection transform numpy does not evaluate here (null planes)
    "SELECT coalesce(rev, 0) FROM t LIMIT 10",
    # PERCENTILE over a raw column: the JAX package's host engine
    "SELECT year, PERCENTILE(rev, 50) FROM t GROUP BY year",
    # a GROUP BY on a transform of a raw column: the host engine's
    "SELECT year(rev), COUNT(*) FROM t GROUP BY year(rev)",
    # an MV function, and EXPRMIN: the JAX package's host engine
    "SELECT year, SUMMV(rev) FROM t GROUP BY year",
    "SELECT year, EXPRMIN(rev, price) FROM t GROUP BY year",
])
def test_out_of_slice_shapes_raise(built, sql):
    with pytest.raises(UnsupportedQueryError):
        SegmentPlanner(parse_sql(sql), load_segment(built / "torch")).plan()


def test_device_view_planes(built):
    seg = load_segment(built / "torch")
    view = SegmentDeviceView(seg, "cpu", packed=True)
    assert view.padded == pad_bucket(N) == 8192
    ids, width = view.dict_ids_packed("year")
    assert ids.dtype == torch.uint8 and width == 8
    np.testing.assert_array_equal(ids[:N].to(torch.int32).numpy(),
                                  seg.get_dict_ids("year"))
    assert int(ids[N:].sum()) == 0
    ids16, width16 = view.dict_ids_packed("brand")
    assert ids16.dtype == torch.uint16 and width16 == 16
    plain, width0 = SegmentDeviceView(seg, "cpu").dict_ids_packed("brand")
    assert plain.dtype == torch.int32 and width0 == 0  # CPU default: off
    assert view.raw("big").dtype == torch.int64
    assert view.null_plane("region").sum().item() == \
        seg.get_null_bitmap("region").sum()
    assert view.dict_ids_packed("year")[0] is ids  # uploaded once, cached


def test_device_cache_budget_evicts_lru(built, tmp_path):
    segs = [load_segment(built / "torch"), load_segment(built / "jax")]
    cache = DeviceSegmentCache("cpu", budget_bytes=40_000)
    cache.view(segs[0]).raw("big")  # 64 KiB: over budget on its own
    cache.view(segs[1]).raw("rev")  # the older view goes
    assert cache.evictions == 1
    assert cache.bytes_used() == 8192 * 4
