"""Multi-device execution: row-sharded segments and segment-sharded batch
families over a mesh of torch devices.

The port of pinot_tpu/parallel/mesh.py. A `Mesh` is an explicit list of
torch devices with named axes, `sp` (rows of one segment) and `dp`
(segments of a batch family). Everything runs in one process: there is no
torch.distributed and no process group. Each shard's inputs move to its
device, the shard runs the same interpreter (ops/kernels.py) on its slice,
and the shards' outputs come back to the first device of the axis, where
they merge as the JAX package's collectives merge them:

    sum / sumsq / count and the histograms   add
    min / max                                elementwise min / max
    distinct occupancy                       any
    selection mask                           stays split by rows

A list may name one device more than once. On a host with one card the
mesh is `cuda:0` several times, and on the CPU `cpu` several times: every
shard is then its own launch on that device, at its own row offset or over
its own members. `mesh_device_count()` counts the cards of the process, so
on one card the engine's default path stays solo, as the JAX package's
does on one chip.

Row sharding (`run_program_row_sharded`): the row planes split by slot
kind (a dictionary plane is replicated, whatever its length), and shard k
runs its `padded / shards` rows at row offset k * padded / shards: kernel
B where the fused plan applies (its scalar vector carries the offset),
else the interpreter, kernel A included. Sparse group-by, adaptive
histograms and MV group-by refuse, as in the JAX package: their outputs
do not merge by addition.

Segment sharding (`run_program_batch_sharded`): a family's [S, ...] stacks
split over `dp`, a ragged family padded by its last member with num_docs 0
(the row-validity mask makes the pad contribute nothing), and each device
runs `run_program_batch` over its members: kernel A once a shard. The
outputs gather to the first device in member order, so the packed buffer
is byte for byte the solo family's.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import torch

from ..engine import ir
from ..ops import kernels

ROW_AXIS = "sp"  # intra-segment row sharding (sequence-parallel analogue)
SEGMENT_AXIS = "dp"  # across segments (data-parallel analogue)


def local_devices(device=None) -> list:
    """The devices of this process a mesh may span: every visible card,
    `device`'s first when it names one; `[device]` for a CPU device; no
    device on a host without a card when none is named."""
    if device is not None:
        device = torch.device(device)
        if device.type != "cuda":
            return [device]
    if not torch.cuda.is_available():
        return [] if device is None else [device]
    n = torch.cuda.device_count()
    first = 0
    if device is not None:
        first = (device.index if device.index is not None
                 else torch.cuda.current_device())
    return [torch.device("cuda", (first + i) % n) for i in range(n)]


def mesh_device_count(devices: Optional[list] = None) -> int:
    """Devices the segment-axis mesh may span: `devices` (the process's
    cards when None), capped by the PINOT_TPU_MESH_DEVICES knob (<= 1
    disables mesh execution)."""
    n = len(local_devices() if devices is None else devices)
    cap = os.environ.get("PINOT_TPU_MESH_DEVICES")
    if cap:
        try:
            n = min(n, int(cap))
        except ValueError:
            pass
    return max(1, n)


class Mesh:
    """Devices on named axes, row-major: with axes (dp, sp) and shape
    (2, 4), device i * 4 + j is at dp = i, sp = j."""

    def __init__(self, devices: list, axes: tuple = (ROW_AXIS,),
                 shape: Optional[tuple] = None):
        self.devices = [torch.device(d) for d in devices]
        self.axis_names = tuple(axes)
        shape = tuple(shape) if shape is not None else (len(self.devices),)
        if len(shape) != len(self.axis_names) \
                or int(np.prod(shape)) != len(self.devices) \
                or not self.devices:
            raise ValueError(f"mesh of {len(self.devices)} devices cannot "
                             f"take shape {shape} over axes {axes}")
        self.shape = dict(zip(self.axis_names, shape))

    def axis_devices(self, axis: str) -> list:
        """The devices along `axis`, at index 0 of every other axis."""
        dims = list(self.shape.values())
        pos = self.axis_names.index(axis)
        stride = int(np.prod(dims[pos + 1:], dtype=np.int64))
        return [self.devices[k * stride] for k in range(dims[pos])]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(d) for d in self.devices]})"


def make_mesh(n_devices: Optional[int] = None, axes=(ROW_AXIS,),
              devices: Optional[list] = None) -> Mesh:
    """A mesh over `devices` (the process's cards when None), the first
    `n_devices` of them when given. Over two axes it favours more row
    shards than segment shards, as the JAX package does."""
    devices = list(local_devices() if devices is None else devices)
    if n_devices is not None:
        devices = devices[:n_devices]
    n = len(devices)
    if len(axes) == 2:
        seg = 2 if n % 2 == 0 and n > 2 else 1
        return Mesh(devices, axes, (seg, n // seg))
    return Mesh(devices, axes)


def segment_mesh(devices: list, ndev: int) -> Mesh:
    """1-D mesh over the first `ndev` of `devices` on SEGMENT_AXIS."""
    return Mesh(list(devices)[:ndev], (SEGMENT_AXIS,))


class Sharded:
    """One tensor split over a mesh axis: `parts[k]` lives on `devices[k]`,
    along dim 0 (rows of a plane, members of a family stack), or the whole
    tensor on every device when `replicated`. `done[k]`, where set, is a
    CUDA event recorded after shard k's launches."""

    __slots__ = ("parts", "devices", "replicated", "done")

    def __init__(self, parts, devices, replicated: bool = False, done=None):
        self.parts = tuple(parts)
        self.devices = tuple(devices)
        self.replicated = replicated
        self.done = done

    def gather(self, device=None) -> torch.Tensor:
        """The whole tensor on `device` (the axis's first by default)."""
        device = self.devices[0] if device is None else torch.device(device)
        if self.replicated:
            return self.parts[0].to(device)
        return _cat([p.to(device) for p in self.parts])


def _cat(parts: list) -> torch.Tensor:
    """torch.cat along dim 0; unsigned 16/32-bit tensors through their
    signed views (the unsigned types have only view-level support)."""
    if len(parts) == 1:
        return parts[0]
    dt = parts[0].dtype
    view = {torch.uint16: torch.int16, torch.uint32: torch.int32}.get(dt)
    if view is None:
        return torch.cat(parts)
    return torch.cat([p.view(view) for p in parts]).view(dt)


def shard_rows(t: torch.Tensor, devices: list) -> Sharded:
    """`t` split into len(devices) equal row blocks, block k on device k
    (a view where the device is t's own)."""
    n = len(devices)
    if t.shape[0] % n:
        raise ValueError(f"{t.shape[0]} rows do not split over {n} shards")
    step = t.shape[0] // n
    return Sharded([t[k * step:(k + 1) * step].to(d)
                    for k, d in enumerate(devices)], devices)


def replicate(t: torch.Tensor, devices: list) -> Sharded:
    return Sharded([t.to(d) for d in devices], devices, replicated=True)


def _mask_param_indices(node) -> frozenset:
    """Param slots holding host-evaluated doc-mask planes (ir.MaskParam):
    those are row-aligned and shard with the row axis."""
    if node is None:
        return frozenset()
    if isinstance(node, ir.MaskParam):
        return frozenset((node.idx,))
    if isinstance(node, (ir.FAnd, ir.FOr)):
        out = frozenset()
        for c in node.children:
            out |= _mask_param_indices(c)
        return out
    if isinstance(node, ir.FNot):
        return _mask_param_indices(node.child)
    return frozenset()


def slot_specs(slots) -> tuple:
    """The axis each kernel input slot splits on: row planes on ROW_AXIS,
    dictionaries replicated (None). Driven by slot KIND, never by shape (a
    dictionary whose cardinality equals the pad bucket still replicates)."""
    return tuple(None if kind == "dict" else ROW_AXIS for _col, kind in slots)


def _reduce(ts: list, op: str) -> torch.Tensor:
    out = ts[0]
    for t in ts[1:]:
        if op == "add":
            out = out + t
        elif op == "min":
            out = torch.minimum(out, t)
        elif op == "max":
            out = torch.maximum(out, t)
        else:  # any
            out = out | t
    return out


_MERGE = {"sum": "add", "sumsq": "add", "count": "add", "min": "min",
          "max": "max", "distinct_bitmap": "any", "value_hist": "add",
          "hist_fixed": "add"}


def _combine_collectives(program: ir.Program, shard_outs: list,
                         device: torch.device) -> tuple:
    """Merge the shards' outputs on `device`, shard 0 first: the counts
    column and every aggregation by its kind (the JAX package's psum, pmin,
    pmax and any over the row axis)."""
    cols = [[t.to(device) for t in col] for col in zip(*shard_outs)]
    merged = [_reduce(cols[0], "add")]
    for agg, col in zip(program.aggs, cols[1:]):
        op = _MERGE.get(agg.kind)
        if op is None:  # pragma: no cover
            raise ValueError(agg.kind)
        merged.append(_reduce(col, op))
    return tuple(merged)


def _row_parts(a, kind: str, devices: list) -> Sharded:
    if isinstance(a, Sharded):
        return a
    if kind == "dict":
        return replicate(a, devices)
    return shard_rows(a, devices)


def run_program_row_sharded(program: ir.Program, arrays: tuple,
                            params: tuple, num_docs: int, padded: int,
                            mesh: Mesh, slots=None, fused: bool = False,
                            lut_meta: tuple = (), packed: tuple = ()):
    """Execute one segment's program with its rows split over
    mesh[ROW_AXIS]: `ops.kernels.run_program` per shard at its row offset,
    then the merge on the axis's first device. `arrays` are the segment's
    padded planes (tensors) or `shard_segment_arrays`' shards; `params` are
    tensors (a host-evaluated mask plane splits by rows, the rest
    replicate); `padded` must divide by the row-axis size. `fused`,
    `lut_meta` and `packed` are run_program's. Group-by and aggregation
    outputs come back merged, one tensor each; a selection's packed bitmap
    as a Sharded of the shards' bitmaps, in row order."""
    if program.mode == "group_by_sparse":
        # keyed (sorted) outputs do not merge by addition; the caller runs
        # sparse programs whole-segment and merges at combine instead
        raise ValueError("sparse group-by does not row-shard; run unsharded")
    if any(op.kind == "hist_adaptive" for op in program.aggs):
        # each shard refines a DIFFERENT per-group bucket (data-dependent),
        # so the refined histograms do not add
        raise ValueError("adaptive histograms do not row-shard; run unsharded")
    if program.mv_group_slot is not None:
        # the MV expansion's trailing scanned-docs output has no merge
        raise ValueError("MV group-by does not row-shard; run unsharded")
    devices = mesh.axis_devices(ROW_AXIS)
    n_shards = len(devices)
    if padded % n_shards:
        raise ValueError(f"{padded} rows do not split over {n_shards} shards")
    local_n = padded // n_shards
    kinds = (tuple(kind for _col, kind in slots) if slots else tuple(
        "dict" if (not isinstance(a, Sharded) and a.dim() >= 1
                   and a.shape[0] != padded) else "ids" for a in arrays))
    shard_a = [_row_parts(a, k, devices) for a, k in zip(arrays, kinds)]
    mask_idxs = _mask_param_indices(program.filter)
    shard_p = [shard_rows(p, devices) if i in mask_idxs
               else replicate(p, devices) for i, p in enumerate(params)]
    outs = []
    for k, dev in enumerate(devices):
        outs.append(kernels.run_program(
            program, tuple(s.parts[k] for s in shard_a),
            tuple(s.parts[k] for s in shard_p), num_docs, local_n,
            row_offset=k * local_n, packed=packed, fused=fused,
            fused_lut_meta=lut_meta, device=dev))
    if program.mode == "selection":
        return tuple(Sharded([o[i] for o in outs], devices)
                     for i in range(len(outs[0])))
    return _combine_collectives(program, outs, devices[0])


def shard_segment_arrays(arrays: tuple, mesh: Mesh, padded: int,
                         slots=None) -> tuple:
    """Place a segment's padded planes on mesh[ROW_AXIS] ahead of its
    queries: row planes split by rows, dictionaries replicated, so
    repeated row-sharded runs reuse the placed shards."""
    devices = mesh.axis_devices(ROW_AXIS)
    if slots is not None:
        kinds = tuple("dict" if s is None else "ids" for s in slot_specs(slots))
    else:
        kinds = tuple("ids" if a.dim() >= 1 and a.shape[0] == padded
                      else "dict" for a in arrays)
    return tuple(_row_parts(a, k, devices) for a, k in zip(arrays, kinds))


def _stack_parts(x, devices: list) -> Sharded:
    """A family-stacked input as a Sharded over `devices`: as it is when
    already split, else split by members (numpy moves to the devices)."""
    if isinstance(x, Sharded):
        return x
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return shard_rows(x, devices)


def _shard_done(device: torch.device):
    """A CUDA event recorded on `device`'s current stream, or None on the
    CPU, where the plain versions have already run."""
    if device.type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(device))
    return ev


def run_program_batch_sharded(program: ir.Program, arrays: tuple,
                              params: tuple, num_docs, padded: int,
                              mesh: Mesh, packed: tuple = ()) -> tuple:
    """`ops.kernels.run_program_batch` with the family's members split over
    mesh[SEGMENT_AXIS]: each device runs its S_pad / ndev members.

    `arrays` and `params` are [S_pad, ...] stacks (tensors or numpy) or
    their Sharded parts, `num_docs` the S_pad members' row counts; S_pad is
    a multiple of the axis size (a ragged family repeats its last member
    with num_docs 0). Returns one Sharded per output, parts in member
    order, each carrying the shards' completion events; callers gather
    them (`pack_outputs_gathered`, `gather_outputs`)."""
    devices = mesh.axis_devices(SEGMENT_AXIS)
    shard_a = [_stack_parts(a, devices) for a in arrays]
    shard_p = [_stack_parts(p, devices) for p in params]
    docs = np.asarray(num_docs, dtype=np.int64)
    if len(docs) % len(devices):
        raise ValueError(f"{len(docs)} members do not split over "
                         f"{len(devices)} devices")
    step = len(docs) // len(devices)
    outs, done = [], []
    for k, dev in enumerate(devices):
        outs.append(kernels.run_program_batch(
            program, tuple(s.parts[k] for s in shard_a),
            tuple(s.parts[k] for s in shard_p),
            docs[k * step:(k + 1) * step], padded, packed=packed,
            device=dev))
        done.append(_shard_done(dev))
    return tuple(Sharded([o[i] for o in outs], devices, done=done)
                 for i in range(len(outs[0])))


def gather_outputs(outs: tuple, s_real: int) -> tuple:
    """The cross-device gather for the raw path (the sparse device
    combine): every [S_pad, ...] output whole on the axis's first device,
    its pad members dropped, so the per-member rows and the table merge
    colocate with that device's dictionaries. No host crossing."""
    return tuple(o.gather()[:s_real] for o in outs)


def pack_outputs_gathered(outs: tuple, s_real: int) -> kernels.PackedOuts:
    """The cross-device combine for the packed path: gather to the first
    device, drop the pad members, and byte-pack exactly as the solo family
    does, so the query's one host fetch reads the same bytes."""
    return kernels.pack_outputs(gather_outputs(outs, s_real))


def pack_outputs_collective(outs: tuple, s_real: int,
                            ndev: int) -> kernels.PackedOuts:
    """The JAX package's all_gather inside the sharded program, then the
    pack. On one process without a process group that gather is the
    in-process one of `pack_outputs_gathered`; an NCCL all_gather waits
    for a host with more than one card."""
    if outs and len(outs[0].parts) != ndev:
        raise ValueError(f"outputs over {len(outs[0].parts)} devices, "
                         f"mesh of {ndev}")
    return pack_outputs_gathered(outs, s_real)


def block_per_device(outs: tuple, ndev: int, t0: float) -> list:
    """Wait for each mesh device's shard in device order (its completion
    event on a card); returns [(mesh position, host ms since t0)]: the
    per-device deviceExecMs of a traced dispatch (monotone: device i's
    stamp includes devices 0..i-1)."""
    done = outs[0].done if outs and outs[0].done else [None] * ndev
    stamps = []
    for k in range(ndev):
        if done[k] is not None:
            done[k].synchronize()
        stamps.append((k, round((time.perf_counter() - t0) * 1000.0, 3)))
    return stamps
