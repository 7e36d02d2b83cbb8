"""The port's wire formats and serving helpers against the JAX package's.

  * PTDT DataTables: the port decodes the committed golden blobs
    (tests/golden/datatable_v2_*.bin) and re-encodes them byte for byte;
    for GroupArrays, group dicts, aggregations (every registered sketch
    type: HyperLogLog, ThetaSketch, SmartDistinctSet, TDigest, ValueHist)
    and selections made from a numpy seed, the port's encoder and the JAX
    package's write identical bytes, and each package decodes the
    other's blob;
  * PTDP packed blocks: int, bool and float64 blocks pack to the JAX
    package's bytes (the port packs with torch ops, the JAX package with
    its jitted `_pack_u8`), ±0.0, ±inf and NaN included. Float64
    subnormals are held against a numpy transcription of the JAX
    package's `_encode_f64`, which keeps them exactly as its docstring
    promises; the JAX package's CPU run flushes them to zero (XLA's CPU
    denormal mode), so its CPU bytes differ there and only there;
  * the scheduler (admission, kill, prefix kill and its tombstone), the
    circuit breaker's closed → open → half-open cycle, and the doctor's
    classifier on canned stderr, plus its real probe on this machine.

Tolerance: exact (bytes, and decoded values bit for bit).
"""

from __future__ import annotations

import struct
import threading
import time
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

from pinot_tpu.cluster import datatable as jdt
from pinot_tpu.engine import results as jres
from pinot_tpu.utils import sketches as jsk
from pinot_tpu_torch.cluster import datatable as pdt
from pinot_tpu_torch.cluster.breaker import CircuitBreakerTable
from pinot_tpu_torch.engine import results as pres
from pinot_tpu_torch.engine.scheduler import (QueryKilledError,
                                              QueryRejectedError,
                                              QueryScheduler,
                                              ResourceAccountant)
from pinot_tpu_torch.ops import kernels
from pinot_tpu_torch.tools import doctor
from pinot_tpu_torch.utils import sketches as psk

GOLDEN = Path(__file__).parent / "golden"


@pytest.mark.parametrize("name", ["agg", "groupdict", "selection"])
def test_golden_datatables_round_trip_byte_for_byte(name):
    # the goldens predate the crc trailer: a re-encode is their bytes with
    # the 8-byte trailer (crc32 of those bytes, b"PTcs") appended
    blob = (GOLDEN / f"datatable_v2_{name}.bin").read_bytes()
    assert pdt.verify_blob(blob)
    combined, stats = pdt.decode(blob)
    again = pdt.encode(combined, stats)
    assert again[:-8] == blob
    assert again[-8:] == struct.pack("<I4s", zlib.crc32(blob), b"PTcs")
    jcombined, jstats = jdt.decode(blob)
    assert jstats == stats
    assert jdt.encode(jcombined, jstats) == again


def _sketches(pkg, rng):
    vals = rng.integers(0, 5000, 3000)
    fvals = rng.normal(0.0, 100.0, 2000)
    return [pkg.HyperLogLog(log2m=10).add_values(vals),
            pkg.ThetaSketch(k=256).add_values(vals),
            pkg.SmartDistinctSet(threshold=50).add_values(vals),
            pkg.TDigest(compression=50.0).add_values(fvals),
            pkg.ValueHist.from_values(rng.integers(0, 20, 500))]


def _intermediates(res, sk, seed: int):
    """One intermediate of each kind, from the same seed in either
    package's classes."""
    rng = np.random.default_rng(seed)
    n = 64
    keys = [rng.integers(0, 1000, n).astype(np.int32),
            np.asarray([f"b{i % 7}" for i in range(n)], dtype=object)]
    ga = res.GroupArrays(
        keys,
        [(rng.integers(0, 1 << 40, n),), (rng.normal(size=n),
                                          rng.integers(1, 9, n))],
        [("add",), ("add", "add")], [("id", 0), ("div", 0, 1)],
        num_docs_scanned=12345, groups_trimmed=True)
    groups = {(int(k), f"s{k % 3}"): [int(k) * 3, float(k) / 7.0,
                                      frozenset({k, k + 1})]
              for k in rng.integers(0, 500, 20).tolist()}
    gd = res.GroupByIntermediate(groups, num_docs_scanned=77)
    agg = res.AggIntermediate(
        [3.5, 10 ** 30, None, True, "text", b"\x00\x01", {1, 2},
         rng.integers(0, 9, 5)] + _sketches(sk, rng),
        num_docs_scanned=999)
    sel = res.SelectionIntermediate(
        ["c1", "c2", "c3"],
        [(int(i), f"v{i}", float(i) / 3) for i in range(15)],
        num_docs_scanned=15)
    return {"group_arrays": ga, "group_dict": gd, "agg": agg,
            "selection": sel}


STATS = {"total_docs": 4096, "num_segments_processed": 2,
         "num_segments_pruned": 1, "num_device_dispatches": 1,
         "num_compiles": 0, "missing_segments": []}


@pytest.mark.parametrize("kind", ["group_arrays", "group_dict", "agg",
                                  "selection"])
@pytest.mark.parametrize("seed", [3, 11])
def test_encoders_write_identical_bytes_and_cross_decode(kind, seed):
    port = _intermediates(pres, psk, seed)[kind]
    ref = _intermediates(jres, jsk, seed)[kind]
    blob = pdt.encode(port, STATS)
    assert blob == jdt.encode(ref, STATS)
    # each package decodes the other's blob back into equal bytes
    j_of_p, st = jdt.decode(blob)
    assert st == STATS and jdt.encode(j_of_p, st) == blob
    p_of_j, st = pdt.decode(jdt.encode(ref, STATS))
    assert st == STATS and pdt.encode(p_of_j, st) == blob
    assert type(p_of_j).__module__.startswith("pinot_tpu_torch.")


def test_every_registered_sketch_type_rides_the_wire():
    assert set(pdt.OBJECT_TYPES) == set(jdt.OBJECT_TYPES)
    for tid, cls in pdt.OBJECT_TYPES.items():
        assert cls.__name__ == jdt.OBJECT_TYPES[tid].__name__
    agg = _intermediates(pres, psk, 5)["agg"]
    back, _ = pdt.decode(pdt.encode(agg, {}))
    kinds = {type(s).__name__ for s in back.states}
    assert {c.__name__ for c in pdt.OBJECT_TYPES.values()} <= kinds


def test_corrupt_blob_is_detected():
    blob = pdt.encode(_intermediates(pres, psk, 1)["selection"], STATS)
    bad = bytearray(blob)
    bad[20] ^= 0x10
    assert not pdt.verify_blob(bytes(bad))
    with pytest.raises(pdt.DataTableCorruptionError):
        pdt.decode(bytes(bad))
    with pytest.raises(pdt.DataTableCorruptionError):
        pdt.decode(blob[:-9] + blob[-8:])


SPECIALS = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1.0, -3.5, 1e-300,
                     -1e-300, 2.2250738585072014e-308, 1e308,
                     -1.7976931348623157e308, 123456.789], dtype=np.float64)


def _block(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    n = 257
    return {"i32": rng.integers(-2 ** 31, 2 ** 31 - 1, n, dtype=np.int64
                                ).astype(np.int32),
            "i64": rng.integers(-2 ** 62, 2 ** 62, n),
            "u8": rng.integers(0, 256, n).astype(np.uint8),
            "b": rng.integers(0, 2, n).astype(bool),
            "f32": rng.normal(size=n).astype(np.float32),
            "f64": np.concatenate([SPECIALS, rng.normal(0, 1e6, n),
                                   rng.normal(size=n) * 1e-200,
                                   rng.normal(size=n) * 1e250])}


def _same(a: np.ndarray, b: np.ndarray) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and \
        a.tobytes() == b.tobytes()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_packed_blocks_equal_the_jax_encoder(seed):
    block = _block(seed)
    blob = pdt.encode_packed_block(block, device="cpu")
    assert blob == jdt.encode_packed_block(block)
    for pkg in (pdt, jdt):
        back = pkg.decode_packed_block(blob)
        for k, v in block.items():
            assert _same(np.asarray(back[k]), v), (pkg.__name__, k)


def test_packed_block_encoder_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        pdt.encode_packed_block(_block(0))
    with pytest.raises(RuntimeError):
        pdt.encode_packed_block(_block(0), device="cuda")


def _encode_f64_numpy(x: np.ndarray) -> np.ndarray:
    """pinot_tpu/ops/kernels.py `_encode_f64` transcribed to numpy (which
    keeps float64 subnormals), as uint32 words [n, 4]."""
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        finite = np.isfinite(x)
        xs = np.where(finite, x, 0.0)
        ax = np.abs(xs)
        k = sum((ax >= 2.0 ** (180 * kk - 60)).astype(np.int32)
                for kk in range(-5, 7)) - 6
        half = np.asarray([2.0 ** (-90 * j) for j in range(-6, 7)])[k + 6]
        y = xs * half * half
        a = y.astype(np.float32)
        r1 = y - a.astype(np.float64)
        b = r1.astype(np.float32)
        c = (r1 - b.astype(np.float64)).astype(np.float32)
        neg = (x < 0) | ((x == 0) & (np.float64(1.0) / x < 0))
    nan = np.isnan(x)
    meta = ((k + 6).astype(np.uint32) | (nan.astype(np.uint32) << 8)
            | ((~finite & ~nan).astype(np.uint32) << 9)
            | (neg.astype(np.uint32) << 10))
    return np.stack([a.view(np.uint32), b.view(np.uint32),
                     c.view(np.uint32), meta], axis=-1)


def test_float64_words_keep_subnormals_exactly():
    tiny = np.array([5e-324, -5e-324, 1e-310, -2.5e-320,
                     np.nextafter(2.2250738585072014e-308, 0.0)])
    x = np.concatenate([SPECIALS, tiny, _block(4)["f64"]])
    words = kernels.pack_u8_wire((torch.from_numpy(x),)).numpy()
    assert words.tobytes() == _encode_f64_numpy(x).tobytes()
    back = kernels.split_flat_wire(words, [(np.dtype(np.float64),
                                            x.shape)])[0]
    # the JAX package's decoder restores the port's subnormals exactly
    from pinot_tpu.ops import kernels as jk
    jback = jk._decode_f64(words.view(np.uint8), x.shape)
    for got in (back, jback):
        assert np.array_equal(np.isnan(got), np.isnan(x))
        assert _same(np.where(np.isnan(got), 0.0, got),
                     np.where(np.isnan(x), 0.0, x))


def test_scheduler_admission_kill_and_prefix_tombstone():
    acc = ResourceAccountant(tombstone_ttl_s=5.0)
    sched = QueryScheduler(max_concurrent=1, max_pending=1, accountant=acc)
    assert sched.submit(lambda t, x: x * 2, 21) == 42
    # a cancel that lands before its shard registers kills it on arrival
    assert acc.kill_prefix("q1", reason="deadline") == 0

    def shard(tracker):
        tracker.check_cancel()
        return "ran"

    with pytest.raises(QueryKilledError, match="deadline"):
        sched.submit(shard, query_id="q1:0")
    assert sched.submit(shard, query_id="q2:0") == "ran"
    # a live query is killed by id and stops at its next check
    started, release = threading.Event(), threading.Event()
    errors = []

    def long_query(tracker):
        started.set()
        release.wait(5)
        try:
            tracker.check_cancel()
        except QueryKilledError as e:
            errors.append(str(e))

    th = threading.Thread(target=lambda: sched.submit(long_query,
                                                      query_id="q3:0"))
    th.start()
    assert started.wait(5)
    assert acc.inflight() == ["q3:0"]
    assert acc.kill_query("q3:0", reason="admin")
    # the one slot is taken: a second query waits and times out
    with pytest.raises(QueryRejectedError):
        sched.submit(lambda t: None, timeout_s=0.05)
    release.set()
    th.join(5)
    assert not th.is_alive() and errors == ["admin"]


def test_breaker_opens_half_opens_and_closes(monkeypatch):
    now = [100.0]
    monkeypatch.setattr(time, "monotonic", lambda: now[0])
    b = CircuitBreakerTable(failure_threshold=2, cooldown_s=1.0,
                            metrics=None)
    assert b.allow("s0")
    b.record_failure("s0")
    assert b.allow("s0") and b.state("s0") == "closed"
    b.record_failure("s0")
    assert not b.allow("s0") and b.down_count() == 1
    now[0] += 1.5
    assert b.allow("s0")        # the one half-open probe
    assert not b.allow("s0")    # no second probe while it is in flight
    b.record_failure("s0")      # failed probe: re-open, cooldown doubles
    now[0] += 1.5
    assert not b.allow("s0")
    now[0] += 1.0
    assert b.allow("s0")
    b.record_success("s0")
    assert b.state("s0") == "closed" and b.allow("s0")


@pytest.mark.parametrize("status,stderr,want", [
    ("ok", "", "ok"),
    ("errored", "DOCTOR: no CUDA device is available", "no-gpu"),
    ("errored", "RuntimeError: Found no NVIDIA driver on your system",
     "no-gpu"),
    ("errored", "DOCTOR: compute capability (8, 0), the kernels need (9, 0)",
     "wrong-capability"),
    ("errored", "RuntimeError: nvcc not found: the CUDA kernels cannot be "
     "built", "no-nvcc"),
    ("errored", "RuntimeError: nvcc failed on ['limb_sums.cu']:\nerror",
     "kernel-build-failure"),
    ("errored", "DOCTOR: kernel A disagrees with its plain version",
     "kernel-build-failure"),
    ("errored", "ModuleNotFoundError: No module named 'torch'",
     "import-error"),
    ("errored", "Timeout (0:05:00)!\nThread 0x1 (most recent call first):",
     "device-hang"),
    ("hung", "", "device-hang"),
    ("errored", "Segmentation fault", "unknown-error"),
])
def test_doctor_classifies_canned_stderr(status, stderr, want):
    assert doctor.classify(status, stderr)[0] == want


def test_doctor_probe_names_this_machines_state():
    # a CPU host: the real probe says no-gpu (or ok on a card), exit 3
    report = doctor.run_probe(timeout_s=120)
    want = "ok" if torch.cuda.is_available() else "no-gpu"
    assert report["classification"] == want, report["stderrTail"]


def test_doctor_names_a_hang_from_the_watchdog_dump():
    report = doctor.run_probe(timeout_s=1, probe_code=(
        "import faulthandler, sys, time\n"
        "faulthandler.dump_traceback_later({timeout}, exit=True, "
        "file=sys.stderr)\n"
        "time.sleep(30)\n"))
    assert report["status"] == "hung"
    assert report["classification"] == "device-hang"


@pytest.mark.parametrize("bit", range(32))
def test_damaged_trailer_magic_is_detected(bit):
    """A flipped bit in the trailer's magic leaves a blob that frames as a
    legacy payload with 8 bytes past its last value: the port raises
    DataTableCorruptionError; the JAX package decodes it as a legacy
    payload, so the damage goes unnoticed there (a deliberate difference:
    the soak's corrupt schedule holds every strike to a detection)."""
    blob = pdt.encode(_intermediates(pres, psk, 2)["group_dict"], STATS)
    bad = bytearray(blob)
    bad[len(bad) - 4 + bit // 8] ^= 1 << (bit % 8)
    with pytest.raises(pdt.DataTableCorruptionError, match="damaged trailer"):
        pdt.decode(bytes(bad))
    combined, _ = jdt.decode(bytes(bad))
    assert combined is not None
