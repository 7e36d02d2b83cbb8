"""Dense group-by sums of small-integer limb planes.

The port of pinot_tpu/ops/mxu_groupby.py. There the TPU answers the
reference's `DefaultGroupByExecutor` hot loop
(pinot-core/.../query/aggregation/groupby/DefaultGroupByExecutor.java:191)
with a one-hot matmul on the MXU; here `limb_sums` launches the CUDA kernel
csrc/limb_sums.cu (a persistent grid of clusters with the group tables in
shared memory, geometry from ops/geometry.py) on a CUDA tensor and runs
`limb_sums_plain` on a CPU tensor. A batch family of S segments is one
launch over (S, P, n) planes; the kernel keeps each table to one segment
at a time and flushes it into that segment's sums (it never folds the
family into one table of S x G groups, which would leave the supported
domain and push every add onto global atomics).

Exactness: payloads are int8 planes holding 7-bit limbs ([0, 127]); sums
are int64. Masked rows must already be routed to the trash slot by the
caller (gid == num_segments - 1) with zeroed payloads.
"""

from __future__ import annotations

import ctypes

import torch

from . import _cuda, geometry
from ..engine import aot_cache

LANES = 128
# the same domain as the TPU kernel, so planner decisions match
MAX_GROUPS = 1 << 15
PLANE_DTYPE = torch.int8
LIMB_BITS = 7
MAX_PLANES = 24


def supports(num_segments: int, num_planes: int) -> bool:
    if not (0 < num_planes <= MAX_PLANES and num_segments <= MAX_GROUPS):
        return False
    s1 = max(1, -(-num_segments // LANES))
    return num_planes * s1 <= 4096


def limb_sums(planes: torch.Tensor, gid: torch.Tensor,
              num_segments: int) -> torch.Tensor:
    """Sum each plane per group: planes (P, n) int8 holding limb values in
    [0, 127], gid (n,) int32 in [0, num_segments); returns
    (P, num_segments) int64. With a family axis, planes (S, P, n) and gid
    (S, n) give (S, P, num_segments): member s's sums in row s, in ONE
    launch of kernel A (the JAX package's vmap of the Pallas call)."""
    family = planes.dim() == 3
    if planes.dim() not in (2, 3):
        raise ValueError(f"limb_sums: planes shape {tuple(planes.shape)}, "
                         "want (P, n) or (S, P, n)")
    if not family:
        planes, gid = planes.unsqueeze(0), gid.unsqueeze(0)
    segments, num_planes, n = planes.shape
    if not supports(num_segments, num_planes):
        raise ValueError(
            f"limb_sums: {num_planes} planes x {num_segments} groups is "
            "outside the supported domain")
    if planes.dtype != PLANE_DTYPE or gid.dtype != torch.int32:
        raise TypeError(f"limb_sums: planes {planes.dtype}, gid {gid.dtype}; "
                        "want int8 and int32")
    if gid.shape != (segments, n):
        raise ValueError(f"limb_sums: gid shape {tuple(gid.shape)} does not "
                         f"match planes {tuple(planes.shape)}")
    if planes.device != gid.device:
        raise ValueError("limb_sums: planes and gid on different devices")
    if aot_cache.RECORDING[0]:
        aot_cache.note_kernel_call({"kernel": "limb_sums",
                                    "segments": segments,
                                    "planes": num_planes,
                                    "groups": num_segments, "rows": n})
    if gid.device.type == "cpu":
        out = limb_sums_plain(planes, gid, num_segments)
    elif gid.device.type != "cuda":
        raise ValueError(f"limb_sums: unsupported device {gid.device}")
    elif not n or not segments:
        out = torch.zeros((segments, num_planes, num_segments),
                          dtype=torch.int64, device=gid.device)
    else:
        planes, gid = planes.contiguous(), gid.contiguous()
        if segments > 1 and n % 16:
            planes, gid = pad_family(planes, gid)
        geo = _cuda.geometry_for("limb_sums", planes.shape[2], num_planes,
                                 num_segments, *slot_layout(planes, gid),
                                 gid.device.index, segments)
        out = launch(planes, gid, num_segments, geo)
    return out if family else out[0]


def pad_family(planes: torch.Tensor, gid: torch.Tensor):
    """(S, P, n) planes and (S, n) gid with n padded to a multiple of 16:
    in a family, segment s of every slot plane must start a multiple of 16
    bytes after segment 0 for the kernel's bulk copies. The pad rows carry
    zero payloads (group 0), so they add nothing."""
    segments, num_planes, n = planes.shape
    m = -(-n // 16) * 16
    pp = planes.new_zeros((segments, num_planes, m))
    pp[:, :, :n] = planes
    gg = gid.new_zeros((segments, m))
    gg[:, :n] = gid
    return pp, gg


def slot_layout(planes: torch.Tensor, gid: torch.Tensor):
    """(widths, addresses modulo 16) of the kernel's slot planes: gid, then
    each payload plane (plane p starts p * n bytes into `planes`; with a
    family axis, segment 0's)."""
    n, num_planes = gid.shape[-1], planes.shape[-2]
    widths = (4,) + (1,) * num_planes
    mis = (gid.data_ptr() % 16,) + tuple(
        (planes.data_ptr() + p * n) % 16 for p in range(num_planes))
    return widths, mis


def launch(planes: torch.Tensor, gid: torch.Tensor, num_segments: int,
           geo: geometry.Geometry) -> torch.Tensor:
    """Launch kernel A with geometry `geo` over contiguous CUDA inputs
    (limb_sums has checked them): (P, n) planes give (P, num_segments)
    sums, (S, P, n) planes (S, P, num_segments)."""
    family = planes.dim() == 3
    if not family:
        planes, gid = planes.unsqueeze(0), gid.unsqueeze(0)
    segments, num_planes, _ = planes.shape
    if geo.segments != segments:
        raise ValueError(f"limb_sums: geometry for {geo.segments} segments, "
                         f"inputs of {segments}")
    out = _cuda.new_output(segments * num_planes, num_segments, gid.device)
    _cuda.launch("limb_sums", ctypes.addressof(_cuda.geom_struct(geo)),
                 planes.data_ptr(), gid.data_ptr(), num_planes,
                 num_segments, out.data_ptr(), _cuda.stream_handle(gid.device))
    out = out.view(segments, num_planes, num_segments)
    return out if family else out[0]


def limb_sums_plain(planes: torch.Tensor, gid: torch.Tensor,
                    num_segments: int) -> torch.Tensor:
    """The same function in plain PyTorch: one int64 index_add_ per plane
    over the family's rows flattened, member s's groups at s * G."""
    if planes.dim() == 2:
        return limb_sums_plain(planes.unsqueeze(0), gid.unsqueeze(0),
                               num_segments)[0]
    segments, num_planes, n = planes.shape
    index = (gid.to(torch.int64) + num_segments * torch.arange(
        segments, dtype=torch.int64, device=gid.device).unsqueeze(1))
    index = index.reshape(-1)
    out = torch.zeros((num_planes, segments * num_segments),
                      dtype=torch.int64, device=planes.device)
    for p in range(num_planes):
        out[p].index_add_(0, index, planes[:, p].reshape(-1).to(torch.int64))
    return out.view(num_planes, segments, num_segments).transpose(0, 1) \
        .contiguous()
