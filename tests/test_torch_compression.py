"""Compressed forward indexes in the port (fault F10), against the JAX
package.

A table config's `compressionConfigs` stores a column's forward buffers in
a PTCC container (segment/compression.py) under LZ4, SNAPPY, GZIP,
ZSTANDARD or PASS_THROUGH. For each codec, segments are built once by the
JAX builder (its LZ4 and Snappy streams come from its native encoder, so
they hold real match sequences, and the port's decoder has to follow
them) and once by the port's builder, and loaded by both packages. The
port's `QueryExecutor(device="cpu")` and the JAX package's
`QueryExecutor(backend="tpu")` (`PINOT_TPU_FUSED=interpret`, both caches
off, one mesh device) then agree on rows, dispatches and segment counts:
`SELECT d_year, SUM(rev) ... GROUP BY d_year` gives the 7 year sums in one
dispatch, over a raw INT column and a dictionary-encoded GROUP BY key, each
compressed, in a family and segment by segment.

Also: the port's decoders against the JAX package's encoders on streams
with overlapping matches; the container's round trip at chunk edges; the
port's builder writing the JAX builder's bytes for every codec (LZ4 and
Snappy through both packages' native encoders); one decompression a buffer; ZSTANDARD without `zstandard` raising
ImportError as in the JAX package. Tolerance: exact.
"""

from __future__ import annotations

import sys

import numpy as np
import pytest

from pinot_tpu.engine.query_executor import QueryExecutor as JaxQueryExecutor
from pinot_tpu.segment import compression as jax_compression
from pinot_tpu.segment import native_bridge
from pinot_tpu.segment.builder import SegmentBuilder as JaxBuilder
from pinot_tpu.segment.loader import load_segment as jax_load
from pinot_tpu.spi.data_types import Schema as JaxSchema
from pinot_tpu.spi.table_config import IndexingConfig as JaxIndexing
from pinot_tpu.spi.table_config import TableConfig as JaxTableConfig
from pinot_tpu_torch.engine.query_executor import QueryExecutor
from pinot_tpu_torch.segment import compression
from pinot_tpu_torch.segment.builder import SegmentBuilder
from pinot_tpu_torch.segment.loader import load_segment
from pinot_tpu_torch.spi.data_types import Schema
from pinot_tpu_torch.spi.table_config import IndexingConfig, TableConfig

CODECS = ["LZ4", "SNAPPY", "GZIP", "ZSTANDARD", "PASS_THROUGH"]
DIMS = [("d_year", "INT"), ("p_brand", "STRING")]
METRICS = [("rev", "INT"), ("price", "DOUBLE")]
ROWS = 2500
BRANDS = np.asarray([f"MFGR#{i}" for i in range(40)], dtype=object)
QUERIES = [
    "SELECT d_year, SUM(rev) FROM t GROUP BY d_year",
    "SELECT p_brand, SUM(rev), COUNT(*), MAX(price) FROM t "
    "WHERE d_year BETWEEN 1993 AND 1996 GROUP BY p_brand "
    "ORDER BY p_brand LIMIT 100",
    "SELECT p_brand, d_year, price FROM t WHERE rev > 900 "
    "ORDER BY price DESC, p_brand LIMIT 5",
]


@pytest.fixture(autouse=True)
def _jax_dispatches_every_query(monkeypatch):
    monkeypatch.setenv("PINOT_TPU_SEGMENT_CACHE", "0")
    monkeypatch.setenv("PINOT_TPU_RESULT_CACHE", "0")
    monkeypatch.setenv("PINOT_TPU_MESH_DEVICES", "1")
    monkeypatch.setenv("PINOT_TPU_FUSED", "interpret")


def _cols(rng):
    """Years in runs and brands from a short list: streams an LZ
    encoder finds matches in."""
    return {"d_year": np.sort(rng.integers(1992, 1999, ROWS)).astype(np.int32),
            "p_brand": BRANDS[rng.integers(0, 40, ROWS)],
            "rev": rng.integers(1, 1000, ROWS).astype(np.int32),
            "price": np.round(rng.uniform(0, 100, ROWS), 2)}


def _indexing(mod, codec):
    return mod(no_dictionary_columns=["rev", "price"],
               compression_configs={c: codec for c in
                                    ("rev", "price", "p_brand", "d_year")})


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """{(codec, builder): [two segment dirs]}; each pair of builds from
    the same columns."""
    root = tmp_path_factory.mktemp("torch_compression")
    rng = np.random.default_rng(16)
    cols = [_cols(rng) for _ in range(2)]
    jschema = JaxSchema.build("t", dimensions=DIMS, metrics=METRICS)
    schema = Schema.build("t", dimensions=DIMS, metrics=METRICS)
    out = {}
    for codec in CODECS:
        jcfg = JaxTableConfig("t", indexing=_indexing(JaxIndexing, codec))
        cfg = TableConfig("t", indexing=_indexing(IndexingConfig, codec))
        for who, build in (
                ("jax", lambda k, d: JaxBuilder(jschema, jcfg, f"s{k}")
                 .build(cols[k], d)),
                ("port", lambda k, d: SegmentBuilder(schema, cfg, f"s{k}")
                 .build(cols[k], d))):
            dirs = [root / f"{codec}_{who}_{k}" for k in range(2)]
            for k, d in enumerate(dirs):
                build(k, d)
            out[codec, who] = dirs
    return out, cols


def _engines(dirs):
    port = QueryExecutor(device="cpu")
    port.add_table(Schema.build("t", dimensions=DIMS, metrics=METRICS),
                   [load_segment(d) for d in dirs])
    jax = JaxQueryExecutor(backend="tpu")
    jax.add_table(JaxSchema.build("t", dimensions=DIMS, metrics=METRICS),
                  [jax_load(d) for d in dirs])
    return port, jax


@pytest.mark.parametrize("batch", [True, False])
@pytest.mark.parametrize("who", ["jax", "port"])
@pytest.mark.parametrize("codec", CODECS)
def test_compressed_segments_query_like_jax(built, codec, who, batch):
    dirs, cols = built
    port, jax = _engines(dirs[codec, who])
    prefix = "" if batch else "SET segmentBatch = false; "
    for sql in QUERIES:
        got = port.execute_sql(prefix + sql)
        want = jax.execute_sql(prefix + sql)
        assert not want.exceptions, want.exceptions
        assert got.result_table.rows == want.result_table.rows, sql
        assert got.num_device_dispatches == want.num_device_dispatches
        assert got.num_segments_processed == want.num_segments_processed
        assert got.num_docs_scanned == want.num_docs_scanned
    years = port.execute_sql(prefix + QUERIES[0])
    assert years.num_device_dispatches == (1 if batch else 2)
    # the numpy oracle of the 7 year sums
    year = np.concatenate([c["d_year"] for c in cols])
    rev = np.concatenate([c["rev"] for c in cols]).astype(np.int64)
    want = {int(y): float(rev[year == y].sum()) for y in np.unique(year)}
    assert len(want) == 7
    assert {r[0]: r[1] for r in years.result_table.rows} == want


@pytest.mark.parametrize("codec", CODECS)
def test_buffers_are_containers_and_decode_once(built, codec):
    dirs, cols = built
    for who in ("jax", "port"):
        seg = load_segment(dirs[codec, who][0])
        entry = seg.metadata.buffers["rev.fwd"]
        if codec == "PASS_THROUGH":
            assert len(entry) == 2
            continue
        assert entry[2] == codec and len(entry) == 3
        assert len(seg.metadata.buffers["p_brand.fwd"]) == 3
        assert len(seg.metadata.buffers["p_brand.dict"]) == 2
        first = seg._buffer("rev.fwd")
        assert seg._buffer("rev.fwd") is first
        np.testing.assert_array_equal(seg.get_raw("rev"), cols[0]["rev"])
        np.testing.assert_array_equal(seg.get_values("p_brand"),
                                      cols[0]["p_brand"])


@pytest.mark.parametrize("codec", ["LZ4", "SNAPPY"])
def test_jax_streams_hold_matches(built, codec):
    """The JAX builder's native encoder wrote matches (its output is
    shorter than the raw column); the port decodes them."""
    if native_bridge.lz4_compress(b"ab" * 64) is None:
        pytest.skip("the JAX package's native codec library is not built")
    dirs, _ = built
    seg = load_segment(dirs[codec, "jax"][0])
    off, size, _ = seg.metadata.buffers["d_year.fwd"]
    raw = seg._buffer("d_year.fwd")
    assert size < len(raw)
    jseg = jax_load(dirs[codec, "jax"][0])
    np.testing.assert_array_equal(seg.get_dict_ids("d_year"),
                                  jseg.get_dict_ids("d_year"))


@pytest.mark.parametrize("codec", ["PASS_THROUGH", "GZIP", "ZSTANDARD",
                                   "LZ4", "SNAPPY"])
def test_port_builder_writes_jax_bytes(built, codec):
    if codec in ("LZ4", "SNAPPY") and \
            native_bridge.lz4_compress(b"ab" * 64) is None:
        pytest.skip("the JAX package's native codec library is not built")
    dirs, _ = built
    for k in range(2):
        got = (dirs[codec, "port"][k] / "data.bin").read_bytes()
        want = (dirs[codec, "jax"][k] / "data.bin").read_bytes()
        assert got == want
        assert load_segment(dirs[codec, "port"][k]).metadata.buffers == \
            jax_load(dirs[codec, "jax"][k]).metadata.buffers


def _payloads():
    rng = np.random.default_rng(5)
    return {
        "runs": np.repeat(rng.integers(0, 5, 300), 37).astype(np.int32)
        .tobytes(),
        "overlap": b"a" * 5000 + b"abc" * 2000 + b"xyz",
        "random": rng.integers(0, 256, 7000).astype(np.uint8).tobytes(),
        "text": " ".join(f"task_{i % 17} ok" for i in range(900)).encode(),
        "empty": b"",
    }


@pytest.mark.parametrize("name", ["runs", "overlap", "random", "text",
                                  "empty"])
@pytest.mark.parametrize("codec", ["LZ4", "SNAPPY"])
def test_decoders_follow_native_match_streams(codec, name):
    data = _payloads()[name]
    enc = (native_bridge.lz4_compress if codec == "LZ4"
           else native_bridge.snappy_compress)(data)
    if enc is None:
        pytest.skip("the JAX package's native codec library is not built")
    dec = (compression.lz4_decompress_py if codec == "LZ4"
           else compression.snappy_decompress_py)
    assert dec(enc, len(data)) == data
    if name in ("runs", "overlap", "text"):
        assert len(enc) < len(data) // 2  # matches, overlapping ones too


@pytest.mark.parametrize("codec", CODECS)
def test_container_round_trip_across_chunks(codec):
    data = _payloads()["runs"] + _payloads()["random"]
    for chunk in (1000, 4096, 1 << 20):
        blob = compression.compress_buffer(data, codec, chunk_size=chunk)
        assert blob[:4] == compression.MAGIC
        assert compression.decompress_buffer(blob) == data
        assert jax_compression.decompress_buffer(blob) == data
        jblob = jax_compression.compress_buffer(data, codec, chunk_size=chunk)
        assert compression.decompress_buffer(jblob) == data
        assert blob[:24] == jblob[:24]  # the same header


def test_zstandard_missing_raises_as_jax(monkeypatch):
    blob = compression.compress_buffer(b"x" * 100, "ZSTANDARD")
    monkeypatch.setitem(sys.modules, "zstandard", None)
    with pytest.raises(ImportError):
        jax_compression.decompress_buffer(blob)
    with pytest.raises(ImportError):
        compression.decompress_buffer(blob)
    with pytest.raises(ImportError):
        compression.compress_buffer(b"x" * 100, "ZSTANDARD")


def test_corrupt_streams_raise():
    with pytest.raises(ValueError, match="not a PTCC"):
        compression.decompress_buffer(b"nope" + b"\0" * 30)
    with pytest.raises(ValueError, match="corrupt LZ4"):
        compression.lz4_decompress_py(bytes([0x14, ord("a"), 9, 0]), 100)
    with pytest.raises(ValueError, match="corrupt snappy"):
        compression.snappy_decompress_py(bytes([8, 0x01, 7]), 100)
