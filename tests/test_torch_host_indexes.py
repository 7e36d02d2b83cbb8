"""The inverted, sorted, raw range and geo indexes of the port against the
JAX package's.

Each index built over the same seeded numpy input serializes to the JAX
package's buffers, byte for byte, and answers the same postings, ranges
and candidate cells (the geo grid at the poles and across the
antimeridian too). The port's builder writes the JAX builder's data.bin
for a table config that asks for every one of them (single- and
multi-value inverted, a dictionary range riding the inverted index, raw
INT / LONG / DOUBLE ranges, a geo pair, a sorted column); the port loads
JAX-built indexed segments and reads the JAX loader's indexes; and
`backfill_indexes` builds what the JAX loader's builds, for a segment
written without them. Consuming segments and their snapshots carry none.
Tolerance: exact.
"""

from __future__ import annotations

import json

import numpy as np
import pytest

from pinot_tpu.segment import indexes as jix
from pinot_tpu.segment.builder import SegmentBuilder as JaxBuilder
from pinot_tpu.segment.loader import load_segment as jax_load
from pinot_tpu.spi import table_config as jtc
from pinot_tpu.spi.data_types import Schema as JaxSchema
from pinot_tpu_torch.segment import indexes as ix
from pinot_tpu_torch.segment.builder import SegmentBuilder
from pinot_tpu_torch.segment.loader import load_segment
from pinot_tpu_torch.segment.mutable import MutableSegment
from pinot_tpu_torch.spi import table_config as tc
from pinot_tpu_torch.spi.data_types import Schema

SEEDS = [0, 1, 2]


def _same_bufs(got, want):
    assert [n for n, _ in got] == [n for n, _ in want]
    for (_, a), (_, b) in zip(got, want):
        assert np.ascontiguousarray(a).tobytes() == \
            np.ascontiguousarray(b).tobytes()


@pytest.mark.parametrize("seed", SEEDS)
def test_inverted_and_sorted_as_jax(seed):
    rng = np.random.default_rng(seed)
    card = int(rng.integers(1, 60))
    ids = rng.integers(0, card, 3000).astype(np.int32)
    inv, jinv = ix.InvertedIndex.build(ids, card), \
        jix.InvertedIndex.build(ids, card)
    _same_bufs(ix.serialize_inverted(inv), jix.serialize_inverted(jinv))
    back = ix.deserialize_inverted(*(b for _, b in ix.serialize_inverted(inv)))
    for lo, hi in [(0, card - 1), (card // 3, card // 2), (5, 2)]:
        assert back.postings_range(lo, hi).tolist() == \
            jinv.postings_range(lo, hi).tolist()
        assert back.mask_for_range(lo, hi, 3000).tolist() == \
            jinv.mask_for_range(lo, hi, 3000).tolist()
    some = rng.integers(0, card, 4)
    assert inv.mask_for_ids(some, 3000).tolist() == \
        jinv.mask_for_ids(some, 3000).tolist()
    srt = np.sort(ids)
    s, js = ix.SortedIndex.build(srt, card), jix.SortedIndex.build(srt, card)
    assert s.starts.tobytes() == js.starts.tobytes()
    for lo, hi in [(0, card - 1), (card // 2, card // 2), (3, 1)]:
        assert s.doc_range(lo, hi) == js.doc_range(lo, hi)


@pytest.mark.parametrize("dtype", [np.int32, np.int64, np.float64])
@pytest.mark.parametrize("seed", SEEDS)
def test_raw_range_as_jax(seed, dtype):
    rng = np.random.default_rng(seed)
    vals = (rng.normal(0, 1000, 2500)).astype(dtype)
    r, jr = ix.RawRangeIndex.build(vals), jix.RawRangeIndex.build(vals)
    _same_bufs(ix.serialize_raw_range(r), jix.serialize_raw_range(jr))
    for lo, hi, li, ui in [(-100, 100, True, True), (None, 0, True, False),
                           (500, None, False, True), (7, 7, True, True)]:
        lo = None if lo is None else dtype(lo)
        hi = None if hi is None else dtype(hi)
        assert r.mask_in_range(2500, lo, hi, li, ui).tolist() == \
            jr.mask_in_range(2500, lo, hi, li, ui).tolist()


@pytest.mark.parametrize("res", [0.5, 2.0, 7.3])
@pytest.mark.parametrize("seed", SEEDS)
def test_geo_grid_as_jax(seed, res):
    rng = np.random.default_rng(seed)
    lat = np.concatenate([rng.uniform(-90, 90, 2000), [90.0, -90.0, 0.0]])
    lng = np.concatenate([rng.uniform(-180, 180, 2000), [180.0, -180.0,
                                                         179.99]])
    g, jg = ix.GeoGridIndex.build(lat, lng, res), \
        jix.GeoGridIndex.build(lat, lng, res)
    _same_bufs(ix.serialize_geo_index(g), jix.serialize_geo_index(jg))
    back = ix.deserialize_geo_index(dict(ix.serialize_geo_index(g)))
    # interior circles, a pole, the antimeridian, a circle around the globe
    for la, lo, r in [(40.0, -100.0, 300e3), (-33.0, 151.0, 2e6),
                      (89.5, 10.0, 200e3), (0.0, 179.9, 500e3),
                      (0.0, -179.9, 50e3), (10.0, 20.0, 2.1e7)]:
        assert back.candidate_docs(la, lo, r).tolist() == \
            jg.candidate_docs(la, lo, r).tolist()
        d = ix.haversine_m(lat, lng, la, lo)
        assert d.tobytes() == jix.haversine_m(lat, lng, la, lo).tobytes()


# -- the builder, the loader, backfill -----------------------------------------

DIMS = [("d_year", "INT"), ("s_region", "STRING"), ("tags", "STRING", False),
        ("codes", "INT", False)]
METRICS = [("ts", "LONG"), ("lo_revenue", "INT"), ("lo_tax", "DOUBLE"),
           ("lat", "DOUBLE"), ("lng", "DOUBLE")]
EVERY_INDEX = dict(
    inverted_index_columns=["s_region", "tags", "codes", "lo_revenue"],
    range_index_columns=["d_year", "ts", "lo_revenue", "lo_tax"],
    no_dictionary_columns=["ts", "lo_tax", "lat", "lng"],
    geo_index_configs=[{"latColumn": "lat", "lngColumn": "lng",
                        "resolutionDeg": 1.5}])


def _cols(seed, n=1800):
    rng = np.random.default_rng(seed)
    regions = np.asarray(["AFRICA", "AMERICA", "ASIA", "EUROPE"], dtype=object)
    return {
        "d_year": np.sort(rng.integers(1992, 1999, n)).astype(np.int32),
        "s_region": regions[rng.integers(0, 4, n)],
        "tags": [list(regions[rng.integers(0, 4, int(k))])
                 for k in rng.integers(0, 4, n)],
        "codes": [list(rng.integers(0, 9, int(k)).astype(np.int32))
                  for k in rng.integers(1, 3, n)],
        "ts": rng.integers(0, 10 ** 9, n).astype(np.int64),
        "lo_revenue": rng.integers(-50, 5000, n).astype(np.int32),
        "lo_tax": np.round(rng.gamma(3.0, 9.0, n), 2),
        "lat": rng.uniform(-60, 60, n),
        "lng": rng.uniform(-180, 180, n),
    }


def _build_both(tmp_path, seed, indexing):
    cols = _cols(seed)
    port_dir, jax_dir = tmp_path / f"p{seed}", tmp_path / f"j{seed}"
    SegmentBuilder(Schema.build("d", dimensions=DIMS, metrics=METRICS),
                   tc.TableConfig(table_name="d",
                                  indexing=tc.IndexingConfig(**indexing)),
                   "s").build(cols, port_dir)
    JaxBuilder(JaxSchema.build("d", dimensions=DIMS, metrics=METRICS),
               jtc.TableConfig(table_name="d",
                               indexing=jtc.IndexingConfig(**indexing)),
               "s").build(cols, jax_dir)
    return port_dir, jax_dir


def _meta(d):
    m = json.loads((d / "metadata.json").read_text())
    m.pop("creationTimeMs", None)
    return m


@pytest.mark.parametrize("seed", SEEDS)
def test_builder_writes_the_jax_builders_bytes(tmp_path, seed):
    port_dir, jax_dir = _build_both(tmp_path, seed, EVERY_INDEX)
    assert (port_dir / "data.bin").read_bytes() == \
        (jax_dir / "data.bin").read_bytes()
    assert _meta(port_dir) == _meta(jax_dir)
    names = set(_meta(port_dir)["buffers"])
    for want in ("s_region.inv.off", "tags.inv.docs", "codes.inv.off",
                 "d_year.inv.off", "ts.rng.perm", "lo_tax.rng.sorted",
                 "lat__lng.geo.cells"):
        assert want in names


def _index_bytes(seg, col):
    inv = seg.get_inverted_index(col)
    rng = seg.get_range_index(col)
    srt = seg.get_sorted_index(col)
    return ((None if inv is None else (inv.offsets.tobytes(),
                                       inv.docs.tobytes())),
            (None if rng is None else (rng.sorted_values.tobytes(),
                                       rng.perm.tobytes())),
            (None if srt is None else srt.starts.tobytes()))


def _geo_bytes(g):
    return (g.res_deg, g.cell_ids.tobytes(), g.offsets.tobytes(),
            g.docs.tobytes())


@pytest.mark.parametrize("seed", SEEDS)
def test_port_loads_jax_built_indexes(tmp_path, seed):
    _, jax_dir = _build_both(tmp_path, seed, EVERY_INDEX)
    seg, jseg = load_segment(jax_dir), jax_load(jax_dir)
    for col in seg.columns():
        assert _index_bytes(seg, col) == _index_bytes(jseg, col), col
    assert _geo_bytes(seg.get_geo_index("lat", "lng")) == \
        _geo_bytes(jseg.get_geo_index("lat", "lng"))
    assert seg.get_sorted_index("d_year") is not None
    assert seg.get_geo_index("lng", "lat") is None
    built = seg.get_geo_index("lng", "lat", or_build=True)
    assert _geo_bytes(built) == \
        _geo_bytes(jseg.get_geo_index("lng", "lat", or_build=True))


@pytest.mark.parametrize("seed", SEEDS)
def test_backfill_builds_what_jax_builds(tmp_path, seed):
    plain = dict(no_dictionary_columns=EVERY_INDEX["no_dictionary_columns"])
    port_dir, _ = _build_both(tmp_path, seed, plain)
    seg, jseg = load_segment(port_dir), jax_load(port_dir)
    for col in seg.columns():
        assert _index_bytes(seg, col) == (None, None,
                                          _index_bytes(seg, col)[2])
    want_cfg = jtc.IndexingConfig(**EVERY_INDEX)
    got = seg.backfill_indexes(tc.IndexingConfig(**EVERY_INDEX))
    assert got == jseg.backfill_indexes(want_cfg)
    assert got  # something was built
    for col in seg.columns():
        assert _index_bytes(seg, col) == _index_bytes(jseg, col), col
    assert _geo_bytes(seg.get_geo_index("lat", "lng")) == \
        _geo_bytes(jseg.get_geo_index("lat", "lng"))
    assert seg.backfill_indexes(tc.IndexingConfig(**EVERY_INDEX)) == \
        jseg.backfill_indexes(want_cfg) == []


def test_consuming_segments_carry_none():
    schema = Schema.build("d", dimensions=[("s", "STRING")],
                          metrics=[("v", "INT")])
    live = MutableSegment(schema, "live")
    live.index({"s": "a", "v": 1})
    live.index({"s": None, "v": 2})
    for seg in (live, live.snapshot_view()):
        assert seg.get_inverted_index("s") is None
        assert seg.get_sorted_index("s") is None
        assert seg.get_range_index("v") is None
        assert seg.get_geo_index("v", "v", or_build=True) is None
        assert seg.get_null_bitmap("s").tolist() == [False, True]
        assert seg.get_null_bitmap("v") is None
