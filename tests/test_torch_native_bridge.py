"""The port's native host library (pinot_tpu_torch/segment/native_bridge.py
over csrc/host_native.cpp) against the JAX package's, on the CPU.

Mirrors tests/test_native.py: bit pack / unpack at every width 1 to 32
(the unpadded tail and the 64-bit widening too), the bitmap unpack, the
first-occurrence int64 factorizer, the grouped float64 aggregate and the
LZ4 / Snappy block codecs. Each is held against the JAX package's numpy
results (its native entry points switched off for the call), the port's
plain versions (PINOT_TPU_DISABLE_NATIVE) and, where the JAX package's
own tests find its library, its native bytes: the port's compressed
chunks and LZ4 / Snappy segments are the JAX builder's. Tolerance: exact
(float64 group sums within rtol 1e-12 of numpy's, which adds pairwise).

The build: once per source digest into pinot_tpu_torch/_build/, under a
lock and a rename, so threads (or test workers) building at once load one
whole library; a failed build or a missing compiler raises; nothing is
written under the JAX package's native/ directory.
"""

from __future__ import annotations

import subprocess
import threading
from pathlib import Path

import numpy as np
import pytest

from pinot_tpu.mse import operators as jax_ops
from pinot_tpu.segment import bitpack as jax_bitpack
from pinot_tpu.segment import compression as jax_compression
from pinot_tpu.segment import native_bridge as jax_native
from pinot_tpu.segment.builder import SegmentBuilder as JaxBuilder
from pinot_tpu.spi.data_types import Schema as JaxSchema
from pinot_tpu.spi.table_config import IndexingConfig as JaxIndexing
from pinot_tpu.spi.table_config import TableConfig as JaxTableConfig
from pinot_tpu_torch.engine.query_executor import QueryExecutor
from pinot_tpu_torch.mse import operators as ops
from pinot_tpu_torch.segment import bitpack, compression, native_bridge
from pinot_tpu_torch.segment.builder import SegmentBuilder
from pinot_tpu_torch.segment.loader import load_segment
from pinot_tpu_torch.spi.data_types import Schema
from pinot_tpu_torch.spi.table_config import IndexingConfig, TableConfig

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _native_on(monkeypatch):
    monkeypatch.delenv("PINOT_TPU_DISABLE_NATIVE", raising=False)


def _jax_native_built() -> bool:
    return jax_native.get_lib() is not None


def _jax_numpy(monkeypatch, fn, *args):
    """The JAX package's numpy result: its bitpack with the native entry
    points answering None, as without its library."""
    with monkeypatch.context() as m:
        m.setattr(jax_native, "pack_bits", lambda *a, **k: None)
        m.setattr(jax_native, "unpack_bits", lambda *a, **k: None)
        return fn(*args)


def _plain(monkeypatch, fn, *args):
    """The port's plain version of `fn(*args)`."""
    with monkeypatch.context() as m:
        m.setenv("PINOT_TPU_DISABLE_NATIVE", "1")
        return fn(*args)


@pytest.mark.parametrize("num_bits", list(range(1, 33)))
def test_pack_unpack_parity(monkeypatch, num_bits):
    rng = np.random.default_rng(num_bits)
    vals = rng.integers(0, np.uint64(1) << num_bits, 10_001,
                        dtype=np.uint64).astype(np.uint32)
    packed = native_bridge.pack_bits(vals, num_bits)
    assert np.array_equal(bitpack.pack(vals, num_bits), packed)
    want = _jax_numpy(monkeypatch, jax_bitpack.pack, vals, num_bits)
    np.testing.assert_array_equal(np.asarray(want), packed)
    np.testing.assert_array_equal(
        np.asarray(_plain(monkeypatch, bitpack.pack, vals, num_bits)), packed)
    out = native_bridge.unpack_bits(packed, num_bits, len(vals))
    np.testing.assert_array_equal(out, vals.astype(np.int32))
    np.testing.assert_array_equal(
        bitpack.unpack(packed, num_bits, len(vals)),
        _jax_numpy(monkeypatch, jax_bitpack.unpack, packed, num_bits,
                   len(vals)))
    wide = bitpack.unpack(packed, num_bits, len(vals), np.int64)
    np.testing.assert_array_equal(wide, vals.astype(np.int64))
    np.testing.assert_array_equal(
        wide, _plain(monkeypatch, bitpack.unpack, packed, num_bits,
                     len(vals), np.int64))
    if _jax_native_built():
        np.testing.assert_array_equal(jax_native.pack_bits(vals, num_bits),
                                      packed)


def test_unpack_unpadded_tail():
    """An exact-size buffer (no 8-byte slack) must not overrun."""
    vals = np.arange(13, dtype=np.uint32) % 8
    packed = native_bridge.pack_bits(vals, 3)
    assert len(packed) == (13 * 3 + 7) // 8
    np.testing.assert_array_equal(native_bridge.unpack_bits(packed, 3, 13),
                                  vals.astype(np.int32))
    assert native_bridge.unpack_bits(packed, 3, 0).shape == (0,)


def test_bitmap_roundtrip():
    rng = np.random.default_rng(0)
    bools = rng.random(1001) < 0.3
    packed = bitpack.pack_bitmap(bools)
    np.testing.assert_array_equal(native_bridge.unpack_bitmap(
        packed, len(bools)), bools)
    np.testing.assert_array_equal(bitpack.unpack_bitmap(packed, len(bools)),
                                  jax_bitpack.unpack_bitmap(packed,
                                                            len(bools)))


def test_factorize():
    rng = np.random.default_rng(1)
    keys = rng.integers(-50, 50, 20_000)
    codes, uniques = native_bridge.factorize_i64(keys)
    # dense codes, consistent mapping, first-occurrence order
    assert codes.max() == len(uniques) - 1
    np.testing.assert_array_equal(uniques[codes], keys)
    _, first = np.unique(keys, return_index=True)
    np.testing.assert_array_equal(uniques, keys[np.sort(first)])
    if _jax_native_built():
        jcodes, juniques = jax_native.factorize_i64(keys)
        np.testing.assert_array_equal(codes, jcodes)
        np.testing.assert_array_equal(uniques, juniques)


@pytest.mark.parametrize("dtype", [np.int32, np.int64, np.uint8, np.bool_])
def test_mse_factorize_codes_equal_jax(monkeypatch, dtype):
    """The MSE's integer keys factorize natively in first-occurrence order,
    as the JAX MSE's do where its library is built; the plain version
    numbers them in sorted order, with the same density."""
    rng = np.random.default_rng(2)
    keys = rng.integers(0, 2 if dtype is np.bool_ else 90, 5000).astype(dtype)
    codes, card = ops._factorize(keys)
    jcodes, jcard = jax_ops._factorize(keys)
    assert card == jcard
    if _jax_native_built():
        np.testing.assert_array_equal(codes, jcodes)
    pcodes, pcard = _plain(monkeypatch, ops._factorize, keys)
    assert pcard == card
    _, inv = np.unique(keys, return_inverse=True)
    np.testing.assert_array_equal(pcodes, inv)
    # one partition either way: code c of one is code m[c] of the other
    m = np.full(card, -1)
    m[codes] = pcodes
    np.testing.assert_array_equal(m[codes], pcodes)


def test_bad_inputs_raise_before_the_library_reads():
    """Sizes and bounds are checked in Python: nothing reaches a pointer
    that would read or write past a buffer."""
    with pytest.raises(ValueError, match="bits"):
        native_bridge.pack_bits(np.asarray([8], np.uint32), 3)
    with pytest.raises(ValueError, match="1..32"):
        native_bridge.pack_bits(np.asarray([1], np.uint32), 33)
    with pytest.raises(ValueError, match="bytes"):
        native_bridge.unpack_bits(np.zeros(3, np.uint8), 7, 10)
    with pytest.raises(ValueError, match="bytes"):
        native_bridge.unpack_bitmap(np.zeros(1, np.uint8), 9)
    with pytest.raises(ValueError, match="outside"):
        native_bridge.group_agg_f64(np.asarray([0, 3]), np.ones(2), 3)


def test_group_agg():
    rng = np.random.default_rng(2)
    codes = rng.integers(0, 7, 5000).astype(np.int64)
    vals = rng.random(5000) * 100
    sums, counts, mins, maxs = native_bridge.group_agg_f64(codes, vals, 7)
    for g in range(7):
        sel = vals[codes == g]
        np.testing.assert_allclose(sums[g], sel.sum(), rtol=1e-12)
        assert counts[g] == len(sel)
        assert mins[g] == sel.min() and maxs[g] == sel.max()


def _payloads():
    rng = np.random.default_rng(5)
    return {
        "runs": np.repeat(rng.integers(0, 5, 300), 37).astype(np.int32)
        .tobytes(),
        "overlap": b"a" * 5000 + b"abc" * 2000 + b"xyz",
        "random": rng.integers(0, 256, 7000).astype(np.uint8).tobytes(),
        "text": " ".join(f"task_{i % 17} ok" for i in range(900)).encode(),
        "short": b"abcabcab",
        "empty": b"",
    }


@pytest.mark.parametrize("name", sorted(_payloads()))
@pytest.mark.parametrize("codec", ["LZ4", "SNAPPY"])
def test_codec_round_trips(codec, name):
    data = _payloads()[name]
    enc, dec = ((native_bridge.lz4_compress, native_bridge.lz4_decompress)
                if codec == "LZ4" else
                (native_bridge.snappy_compress,
                 native_bridge.snappy_decompress))
    py_dec = (compression.lz4_decompress_py if codec == "LZ4"
              else compression.snappy_decompress_py)
    literal = (compression._lz4_compress_literal if codec == "LZ4"
               else compression._snappy_compress_literal)
    blob = enc(data)
    assert dec(blob, len(data)) == data
    assert py_dec(blob, len(data)) == data
    assert dec(literal(data), len(data)) == data
    if name in ("runs", "overlap", "text"):
        assert len(blob) < len(data) // 2  # matches, overlapping ones too
    if _jax_native_built():
        jenc = (jax_native.lz4_compress if codec == "LZ4"
                else jax_native.snappy_compress)
        assert jenc(data) == blob


@pytest.mark.parametrize("codec", ["LZ4", "SNAPPY"])
def test_corrupt_stream_raises(codec):
    data = _payloads()["text"]
    enc, dec = ((native_bridge.lz4_compress, native_bridge.lz4_decompress)
                if codec == "LZ4" else
                (native_bridge.snappy_compress,
                 native_bridge.snappy_decompress))
    blob = enc(data)
    with pytest.raises(ValueError):
        dec(blob, len(data) // 2)  # the output does not fit


@pytest.mark.parametrize("codec", ["LZ4", "SNAPPY"])
def test_compressed_chunks_are_the_jax_builders(monkeypatch, codec):
    p = _payloads()
    data = p["runs"] + p["random"] + p["text"]
    for chunk in (1000, 4096, 1 << 20):
        blob = compression.compress_buffer(data, codec, chunk_size=chunk)
        assert compression.decompress_buffer(blob) == data
        assert jax_compression.decompress_buffer(blob) == data
        assert _plain(monkeypatch, compression.decompress_buffer, blob) \
            == data
        if _jax_native_built():
            assert blob == jax_compression.compress_buffer(
                data, codec, chunk_size=chunk)


@pytest.mark.parametrize("codec", ["LZ4", "SNAPPY"])
def test_segment_roundtrip_uses_native(tmp_path, codec):
    """A segment with LZ4 / Snappy forward indexes built by the port is the
    JAX builder's, byte for byte, and queries the same sums."""
    dims, metrics = [("d", "STRING")], [("m", "INT")]
    rng = np.random.default_rng(3)
    cols = {"d": np.asarray([f"v{i}" for i in rng.integers(0, 500, 20_000)],
                            dtype=object),
            "m": rng.integers(0, 1000, 20_000).astype(np.int32)}
    comp = {"d": codec, "m": codec}
    SegmentBuilder(Schema.build("nat", dimensions=dims, metrics=metrics),
                   TableConfig(table_name="nat", indexing=IndexingConfig(
                       compression_configs=comp)), "n0").build(
        cols, tmp_path / "port")
    JaxBuilder(JaxSchema.build("nat", dimensions=dims, metrics=metrics),
               JaxTableConfig(table_name="nat", indexing=JaxIndexing(
                   compression_configs=comp)), "n0").build(
        cols, tmp_path / "jax")
    if _jax_native_built():
        assert (tmp_path / "port" / "data.bin").read_bytes() == \
            (tmp_path / "jax" / "data.bin").read_bytes()
    seg = load_segment(tmp_path / "port")
    qe = QueryExecutor(device="cpu", backend="host")
    qe.add_table(Schema.build("nat", dimensions=dims, metrics=metrics),
                 [seg])
    r = qe.execute_sql("SELECT SUM(m), COUNT(*) FROM nat")
    assert r.result_table.rows[0] == [float(cols["m"].sum()), 20_000]


def test_disable_native_takes_the_plain_versions(monkeypatch):
    """PINOT_TPU_DISABLE_NATIVE: no call reaches the library."""

    def refuse():
        raise AssertionError("the native library was asked for")

    monkeypatch.setenv("PINOT_TPU_DISABLE_NATIVE", "1")
    monkeypatch.setattr(native_bridge, "get_lib", refuse)
    vals = np.arange(100, dtype=np.uint32) % 13
    assert np.array_equal(bitpack.unpack(bitpack.pack(vals, 4), 4, 100),
                          vals.astype(np.int32))
    data = _payloads()["text"]
    for codec in ("LZ4", "SNAPPY"):
        blob = compression.compress_buffer(data, codec)
        assert compression.decompress_buffer(blob) == data
    codes, card = ops._factorize(np.asarray([5, 3, 5]))
    assert card == 2 and codes.tolist() == [1, 0, 1]


def test_library_builds_once_under_concurrent_callers(tmp_path, monkeypatch):
    """Eight threads building at once into an empty build directory: one
    compile, one library, every caller handed its whole path; a later
    build finds it."""
    monkeypatch.setattr(native_bridge, "BUILD_DIR", tmp_path / "_build")
    compiles = []
    real_run = subprocess.run

    def counting_run(cmd, *a, **k):
        compiles.append(cmd)
        return real_run(cmd, *a, **k)

    monkeypatch.setattr(native_bridge.subprocess, "run", counting_run)
    paths, errors = [], []
    barrier = threading.Barrier(8)

    def build():
        barrier.wait()
        try:
            paths.append(native_bridge.build())
        except Exception as e:  # pragma: no cover - reported below
            errors.append(e)

    threads = [threading.Thread(target=build) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
        assert not t.is_alive()
    assert not errors and len(compiles) == 1
    assert set(paths) == {native_bridge.library_path()}
    assert paths[0].parent == tmp_path / "_build"
    assert sorted(p.name for p in (tmp_path / "_build").iterdir()
                  if p.suffix == ".so") == [paths[0].name]
    assert native_bridge.build() == paths[0] and len(compiles) == 1


def test_failed_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "host_native.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native_bridge, "SOURCE", bad)
    monkeypatch.setattr(native_bridge, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(native_bridge.NativeLibraryError, match="failed"):
        native_bridge.build()
    assert not [p for p in (tmp_path / "_build").iterdir()
                if p.suffix == ".so"]
    monkeypatch.setattr(native_bridge.shutil, "which", lambda name: None)
    with pytest.raises(native_bridge.NativeLibraryError, match="compiler"):
        native_bridge.build()


def test_library_lives_in_the_ports_build_directory():
    """The port builds from its own source into its own build directory:
    never beside the JAX package's native/ source."""
    path = Path(native_bridge.get_lib()._name)
    assert path.parent == REPO / "pinot_tpu_torch" / "_build"
    assert native_bridge.SOURCE == \
        REPO / "pinot_tpu_torch" / "csrc" / "host_native.cpp"
    assert "native" not in path.parent.relative_to(REPO).parts
