"""Dense group-by sums of small-integer limb planes.

The port of pinot_tpu/ops/mxu_groupby.py. There the TPU answers the
reference's `DefaultGroupByExecutor` hot loop
(pinot-core/.../query/aggregation/groupby/DefaultGroupByExecutor.java:191)
with a one-hot matmul on the MXU; here `limb_sums` launches the CUDA kernel
csrc/limb_sums.cu (a persistent grid of clusters with the group tables in
shared memory, geometry from ops/geometry.py) on a CUDA tensor and runs
`limb_sums_plain` on a CPU tensor.

Exactness: payloads are int8 planes holding 7-bit limbs ([0, 127]); sums
are int64. Masked rows must already be routed to the trash slot by the
caller (gid == num_segments - 1) with zeroed payloads.
"""

from __future__ import annotations

import ctypes

import torch

from . import _cuda, geometry

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
    (P, num_segments) int64."""
    if planes.dim() != 2:
        raise ValueError(f"limb_sums: planes shape {tuple(planes.shape)}, "
                         "want (P, n)")
    num_planes, n = planes.shape
    if not supports(num_segments, num_planes):
        raise ValueError(
            f"limb_sums: {num_planes} planes x {num_segments} groups is "
            "outside the supported domain")
    if planes.dtype != PLANE_DTYPE or gid.dtype != torch.int32:
        raise TypeError(f"limb_sums: planes {planes.dtype}, gid {gid.dtype}; "
                        "want int8 and int32")
    if gid.shape != (n,):
        raise ValueError(f"limb_sums: gid shape {tuple(gid.shape)}, want ({n},)")
    if planes.device != gid.device:
        raise ValueError("limb_sums: planes and gid on different devices")
    if gid.device.type == "cpu":
        return limb_sums_plain(planes, gid, num_segments)
    if gid.device.type != "cuda":
        raise ValueError(f"limb_sums: unsupported device {gid.device}")
    planes = planes.contiguous()
    gid = gid.contiguous()
    if not n:
        return torch.zeros((num_planes, num_segments), dtype=torch.int64,
                           device=gid.device)
    geo = _cuda.geometry_for("limb_sums", n, num_planes, num_segments,
                             *slot_layout(planes, gid), gid.device.index)
    return launch(planes, gid, num_segments, geo)


def slot_layout(planes: torch.Tensor, gid: torch.Tensor):
    """(widths, addresses modulo 16) of the kernel's slot planes: gid, then
    each payload plane (plane p starts p * n bytes into `planes`)."""
    n = gid.shape[0]
    widths = (4,) + (1,) * planes.shape[0]
    mis = (gid.data_ptr() % 16,) + tuple(
        (planes.data_ptr() + p * n) % 16 for p in range(planes.shape[0]))
    return widths, mis


def launch(planes: torch.Tensor, gid: torch.Tensor, num_segments: int,
           geo: geometry.Geometry) -> torch.Tensor:
    """Launch kernel A with geometry `geo` over contiguous CUDA inputs
    (limb_sums has checked them); returns the (P, num_segments) sums."""
    out = _cuda.new_output(planes.shape[0], num_segments, gid.device)
    _cuda.launch("limb_sums", ctypes.addressof(_cuda.geom_struct(geo)),
                 planes.data_ptr(), gid.data_ptr(), planes.shape[0],
                 num_segments, out.data_ptr(), _cuda.stream_handle(gid.device))
    return out


def limb_sums_plain(planes: torch.Tensor, gid: torch.Tensor,
                    num_segments: int) -> torch.Tensor:
    """The same function in plain PyTorch: one int64 index_add_ per plane."""
    out = torch.zeros((planes.shape[0], num_segments), dtype=torch.int64,
                      device=planes.device)
    index = gid.to(torch.int64)
    for p in range(planes.shape[0]):
        out[p].index_add_(0, index, planes[p].to(torch.int64))
    return out
