"""ctypes bridge to the port's native host library (csrc/host_native.cpp).

The port of pinot_tpu/segment/native_bridge.py, with the same entry points
and argument types: bit packing and unpacking, the bitmap unpack, the
first-occurrence int64 factorizer, the grouped float64 aggregate, and the
LZ4 / Snappy block codecs. The reference's equivalent machinery is the
hand-unrolled Java in SURVEY.md §2.9 (FixedBitIntReader etc.).

The library builds at first use with `g++ -O3 -shared -fPIC` into
pinot_tpu_torch/_build/, named by a digest of the source and the flags, so
an edited source never loads a stale library. Processes building at once
(test workers, a spawn pool) serialize on an fcntl lock in that directory;
the one that builds compiles to a temporary name there and renames it into
place with os.replace, so a reader sees no library or a whole one. Nothing
is written beside the JAX package's native/ source, and nothing is built
at import.

There is no silent fallback: a missing compiler, a failed build or a
failed load raises NativeLibraryError. PINOT_TPU_DISABLE_NATIVE=1 is the
explicit way to ask for the plain Python versions (segment/bitpack.py,
segment/compression.py, mse/operators.py), read at each call through
`enabled()`.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "host_native.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC")

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None


class NativeLibraryError(RuntimeError):
    """The native host library could not be built or loaded."""


def enabled() -> bool:
    """Whether the native library serves its callers: unless
    PINOT_TPU_DISABLE_NATIVE is set, which asks for the plain versions."""
    return not os.environ.get("PINOT_TPU_DISABLE_NATIVE")


def library_path() -> Path:
    """The library's path in the build directory, named by a digest of
    the source and the compiler flags."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libhost_native_{h.hexdigest()[:16]}.so"


def _compiler() -> str:
    for name in ("g++", "c++"):
        found = shutil.which(name)
        if found:
            return found
    raise NativeLibraryError("no C++ compiler (g++ or c++) on PATH: the "
                             "native host library cannot be built")


def build() -> Path:
    """Compile the library unless it exists; returns its path. Concurrent
    builders wait on one lock file, and the first writes the library whole
    (temporary name, then os.replace); the others find it built."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / f"{lib.name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if lib.exists():
            return lib
        fd, tmp = tempfile.mkstemp(prefix=f".{lib.stem}.", suffix=".so",
                                   dir=BUILD_DIR)
        os.close(fd)
        try:
            proc = subprocess.run(
                [_compiler(), *CXX_FLAGS, str(SOURCE), "-o", tmp],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                timeout=600)
            if proc.returncode != 0:
                raise NativeLibraryError(
                    f"building {SOURCE.name} failed:\n{proc.stdout}")
            os.replace(tmp, lib)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return lib


def get_lib() -> ctypes.CDLL:
    """The loaded library, built on first call; raises NativeLibraryError
    when it cannot be built or loaded."""
    global _LIB
    if _LIB is not None:
        return _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        try:
            lib = ctypes.CDLL(str(build()))
        except OSError as e:
            raise NativeLibraryError(f"loading the native library: {e}") from e
        u8 = ctypes.POINTER(ctypes.c_uint8)
        i32 = ctypes.POINTER(ctypes.c_int32)
        i64 = ctypes.POINTER(ctypes.c_int64)
        f64 = ctypes.POINTER(ctypes.c_double)
        u32 = ctypes.POINTER(ctypes.c_uint32)
        lib.unpack_bits.argtypes = [u8, ctypes.c_int, ctypes.c_int64, i32,
                                    ctypes.c_int]
        lib.pack_bits.argtypes = [u32, ctypes.c_int64, ctypes.c_int, u8]
        lib.pack_bitmap.argtypes = [u8, ctypes.c_int64, u8]
        lib.unpack_bitmap.argtypes = [u8, ctypes.c_int64, u8]
        lib.factorize_i64.argtypes = [i64, ctypes.c_int64, i64, i64]
        lib.factorize_i64.restype = ctypes.c_int64
        lib.group_agg_f64.argtypes = [i64, f64, ctypes.c_int64,
                                      ctypes.c_int64, f64, i64, f64, f64]
        for fn in ("lz4_compress", "lz4_decompress",
                   "snappy_compress", "snappy_decompress"):
            f = getattr(lib, fn)
            f.argtypes = [u8, ctypes.c_int64, u8, ctypes.c_int64]
            f.restype = ctypes.c_int64
        _LIB = lib
        return _LIB


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _check_bits(num_bits: int) -> None:
    if not 1 <= num_bits <= 32:
        raise ValueError(f"num_bits {num_bits} outside 1..32")


def _check_bytes(data: np.ndarray, needed: int, what: str) -> None:
    if len(data) < needed:
        raise ValueError(f"{what}: {len(data)} bytes, need {needed}")


def unpack_bits(data: np.ndarray, num_bits: int, count: int,
                dtype=np.int32) -> np.ndarray:
    """`count` values of `num_bits` from an LSB-first bitstream."""
    _check_bits(num_bits)
    if count == 0:
        return np.empty(0, dtype=dtype)
    lib = get_lib()
    data = np.ascontiguousarray(data, dtype=np.uint8)
    # the fast path reads an 8-byte window at the last value's byte offset
    needed = (count * num_bits + 7) // 8
    _check_bytes(data, needed, "unpack_bits")
    padded = 1 if len(data) >= needed + 8 else 0
    out = np.empty(count, dtype=np.int32)
    lib.unpack_bits(_ptr(data, ctypes.c_uint8), num_bits, count,
                    _ptr(out, ctypes.c_int32), padded)
    if dtype == np.int32:
        return out
    if num_bits == 32:
        # full-width values are unsigned in the bitstream: widen without
        # sign extension (the plain path's uint32 view)
        return out.view(np.uint32).astype(dtype)
    return out.astype(dtype)


def pack_bits(values: np.ndarray, num_bits: int) -> np.ndarray:
    """Non-negative ints < 2**num_bits as an LSB-first uint8 bitstream."""
    _check_bits(num_bits)
    lib = get_lib()
    values = np.ascontiguousarray(values, dtype=np.uint32)
    n = len(values)
    # a wider value would write past the stream's last byte
    if n and num_bits < 32 and int(values.max()) >> num_bits:
        raise ValueError(f"pack_bits: a value needs more than {num_bits} bits")
    out = np.zeros((n * num_bits + 7) // 8, dtype=np.uint8)
    lib.pack_bits(_ptr(values, ctypes.c_uint32), n, num_bits,
                  _ptr(out, ctypes.c_uint8))
    return out


def unpack_bitmap(data: np.ndarray, count: int) -> np.ndarray:
    """A packed LSB-first bitmap as `count` bools."""
    lib = get_lib()
    data = np.ascontiguousarray(data, dtype=np.uint8)
    _check_bytes(data, (count + 7) // 8, "unpack_bitmap")
    out = np.empty(count, dtype=np.uint8)
    lib.unpack_bitmap(_ptr(data, ctypes.c_uint8), count,
                      _ptr(out, ctypes.c_uint8))
    return out.view(bool)


def factorize_i64(keys: np.ndarray):
    """(codes, uniques): dense int64 codes in first-occurrence order."""
    lib = get_lib()
    keys = np.ascontiguousarray(keys, dtype=np.int64)
    n = len(keys)
    codes = np.empty(n, dtype=np.int64)
    uniques = np.empty(n, dtype=np.int64)
    num = lib.factorize_i64(_ptr(keys, ctypes.c_int64), n,
                            _ptr(codes, ctypes.c_int64),
                            _ptr(uniques, ctypes.c_int64))
    return codes, uniques[:num]


def group_agg_f64(codes: np.ndarray, vals: np.ndarray, num_groups: int):
    """(sums, counts, mins, maxs) per group of dense `codes`."""
    lib = get_lib()
    codes = np.ascontiguousarray(codes, dtype=np.int64)
    vals = np.ascontiguousarray(vals, dtype=np.float64)
    if len(vals) != len(codes):
        raise ValueError(f"group_agg_f64: {len(codes)} codes, "
                         f"{len(vals)} values")
    if len(codes) and (codes.min() < 0 or codes.max() >= num_groups):
        raise ValueError(f"group_agg_f64: a code outside [0, {num_groups})")
    sums = np.empty(num_groups, dtype=np.float64)
    counts = np.empty(num_groups, dtype=np.int64)
    mins = np.empty(num_groups, dtype=np.float64)
    maxs = np.empty(num_groups, dtype=np.float64)
    lib.group_agg_f64(_ptr(codes, ctypes.c_int64), _ptr(vals, ctypes.c_double),
                      len(codes), num_groups, _ptr(sums, ctypes.c_double),
                      _ptr(counts, ctypes.c_int64), _ptr(mins, ctypes.c_double),
                      _ptr(maxs, ctypes.c_double))
    return sums, counts, mins, maxs


def _codec_call(fn_name: str, src: bytes, dst_cap: int) -> bytes:
    lib = get_lib()
    src_arr = np.frombuffer(src, dtype=np.uint8) if src else np.empty(0, np.uint8)
    src_arr = np.ascontiguousarray(src_arr)
    dst = np.empty(max(1, dst_cap), dtype=np.uint8)
    n = getattr(lib, fn_name)(_ptr(src_arr, ctypes.c_uint8), len(src),
                              _ptr(dst, ctypes.c_uint8), dst_cap)
    if n < 0:
        raise ValueError(f"{fn_name}: corrupt or oversized stream")
    return dst[:n].tobytes()


def lz4_compress(data: bytes) -> bytes:
    return _codec_call("lz4_compress", data, len(data) + len(data) // 255 + 16)


def lz4_decompress(blob: bytes, raw_size: int) -> bytes:
    return _codec_call("lz4_decompress", blob, raw_size)


def snappy_compress(data: bytes) -> bytes:
    return _codec_call("snappy_compress", data, 32 + len(data) + len(data) // 6)


def snappy_decompress(blob: bytes, raw_size: int) -> bytes:
    return _codec_call("snappy_decompress", blob, raw_size)
