"""Build, load and launch the hand-written CUDA kernels (csrc/*.cu).

Each source compiles with its own nvcc process (all started together) for
sm_90a into an object file; the objects link into one shared library with
a plain C interface, loaded with ctypes. The build happens at first use,
into pinot_tpu_torch/_build/, keyed by a hash of the sources and flags so
an edited source never loads a stale library. Nothing here runs at import.

At load, each kernel's shared-memory limit is raised once for the process.
Every launch goes through `launch`, which counts it per kernel and raises
on a non-zero CUDA error code: there is no fallback to the plain versions.
Both kernels take their launch geometry (ops/geometry.py) as a `_Geom`
struct, laid out as `pinot::Geom` in csrc/group_table.cuh.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from functools import lru_cache
from pathlib import Path

import torch

from . import geometry

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
SOURCES = ("limb_sums.cu", "fused_limb_sums.cu")
HEADERS = ("group_table.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# kernel name -> launches since the last reset_launches()
LAUNCHES = {"limb_sums": 0, "fused_limb_sums": 0}

_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()
_LIB: "ctypes.CDLL | None" = None
_BUILD_LOG = ""


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _library_path() -> Path:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libpinot_kernels_{h.hexdigest()[:16]}.so"


def build() -> tuple[Path, str]:
    """Compile every source in parallel and link the shared library;
    returns (library path, nvcc/ptxas output). Reuses an existing library
    built from the same sources and flags."""
    lib = _library_path()
    if lib.exists():
        return lib, _BUILD_LOG
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in SOURCES:
            obj = Path(tmp) / (Path(src).stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(CSRC / src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, failed = [], []
        for src, _obj, proc in procs:
            out, _ = proc.communicate()
            logs.append(f"== {src}\n{out}")
            if proc.returncode != 0:
                failed.append(src)
        log = "\n".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
        tmp_lib = Path(tmp) / lib.name
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp_lib),
             *[str(obj) for _src, obj, _p in procs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_lib, lib)
    return lib, log


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _LIB, _BUILD_LOG
    with _LOCK:
        if _LIB is None:
            path, _BUILD_LOG = build()
            lib = ctypes.CDLL(str(path))
            vp, i = ctypes.c_void_p, ctypes.c_int
            lib.pinot_limb_sums.argtypes = [vp, vp, vp, i, i, vp, vp]
            lib.pinot_fused_limb_sums.argtypes = [vp, vp, vp, i, i, vp, vp]
            lib.pinot_error_string.argtypes = [i]
            lib.pinot_error_string.restype = ctypes.c_char_p
            for name in LAUNCHES:
                getattr(lib, f"pinot_{name}").restype = i
                getattr(lib, f"pinot_{name}_setup").restype = i
                getattr(lib, f"pinot_{name}_max_clusters").argtypes = [
                    i, i, ctypes.POINTER(i)]
                getattr(lib, f"pinot_{name}_max_clusters").restype = i
                _check(lib, f"{name} setup",
                       getattr(lib, f"pinot_{name}_setup")())
            _LIB = lib
        return _LIB


def _check(lib, what: str, rc: int) -> None:
    if rc != 0:
        msg = lib.pinot_error_string(rc).decode()
        raise RuntimeError(f"CUDA {what} failed: {msg} ({rc})")


@lru_cache(maxsize=None)
def max_active_clusters(name: str, cluster: int, smem: int) -> int:
    """How many clusters of `cluster` CTAs with `smem` bytes of dynamic
    shared memory kernel `name` can keep resident on the current card."""
    lib = library()
    count = ctypes.c_int(0)
    _check(lib, f"{name} occupancy query",
           getattr(lib, f"pinot_{name}_max_clusters")(
               cluster, smem, ctypes.byref(count)))
    return count.value


class _Geom(ctypes.Structure):
    """pinot::Geom (csrc/group_table.cuh)."""
    _fields_ = [
        ("n", ctypes.c_longlong),
        ("full_rows", ctypes.c_longlong),
        ("vec_mask", ctypes.c_ulonglong),
        *[(f, ctypes.c_int) for f in (
            "tile_rows", "stages", "stage_bytes", "tx_bytes", "num_slots",
            "mode", "cluster", "clusters", "units", "epoch_iters",
            "table_planes", "table_groups", "table_counters", "table_off",
            "ring_off", "smem_bytes", "warp_agg", "segments", "seg_units",
            "unit_tiles")],
        ("tg_inv", ctypes.c_uint),
        *[(f, ctypes.c_int * geometry.MAX_SLOTS)
          for f in ("mis", "copy_bytes", "smem_off", "row_off")],
    ]


@lru_cache(maxsize=256)
def geometry_for(name: str, n: int, planes: int, groups: int, widths: tuple,
                 mis: tuple, device_index: int,
                 segments: int = 1) -> "geometry.Geometry":
    """The launch geometry of kernel `name` on the card, with the card's own
    SM count and cluster occupancy; cached per shape and alignment."""
    sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    return geometry.plan(
        n, planes, groups, widths, mis, segments=segments, sms=sms,
        active_clusters=lambda c, smem: max_active_clusters(name, c, smem))


@lru_cache(maxsize=256)
def geom_struct(geo: "geometry.Geometry") -> _Geom:
    g = _Geom()
    for f in ("n", "full_rows", "vec_mask", "tile_rows", "stages",
              "stage_bytes", "tx_bytes", "cluster", "clusters", "units",
              "epoch_iters", "table_planes", "table_groups", "table_counters",
              "table_off", "ring_off", "smem_bytes", "segments", "seg_units",
              "unit_tiles", "tg_inv"):
        setattr(g, f, getattr(geo, f))
    g.num_slots, g.mode = len(geo.widths), geometry.MODES[geo.mode]
    g.warp_agg = int(geo.warp_agg)
    for f in ("mis", "copy_bytes", "smem_off", "row_off"):
        getattr(g, f)[:len(geo.widths)] = getattr(geo, f)
    return g


def build_log() -> str:
    return _BUILD_LOG


def new_output(planes: int, groups: int, device) -> torch.Tensor:
    """A zeroed (planes, groups) int64 output for the kernels, 16-byte
    aligned with the spare int64s the last flush's padding may touch."""
    buf = torch.zeros(geometry.output_len(planes, groups), dtype=torch.int64,
                      device=device)
    return buf[:planes * groups].view(planes, groups)


def stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def launch(name: str, *args) -> None:
    """Launch kernel `name` (its C entry point pinot_<name>) and raise on a
    CUDA error; counts the launch."""
    lib = library()
    with _COUNT_LOCK:
        LAUNCHES[name] += 1
    _check(lib, f"kernel {name}", getattr(lib, f"pinot_{name}")(*args))


def require_cuda(device: torch.device) -> None:
    """Raise unless `device` is a usable CUDA device of compute capability
    (9, 0) — the sm_90a target the kernels are built for."""
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: the GPU path needs an H100")
    index = device.index if device.index is not None else torch.cuda.current_device()
    cap = torch.cuda.get_device_capability(index)
    if cap != (9, 0):
        raise RuntimeError(
            f"device {index} has compute capability {cap}; the kernels are "
            "built for sm_90a (9, 0)")
