#!/usr/bin/env python3
"""Time the port's two group-by kernels on one H100 at the main path's
shapes, under their default launch geometry and under the alternatives
that geometry.plan offers (each cluster size the card can schedule).

Run from the repository root on a machine with the card:

    python3 kernel_bench.py [--seed 2024] [--rows 8388608] [--segments 4]
                            [--iters 20] [--shapes q2_plan ...]
                            [--default-only]

Inputs are SSB-shaped planes made on the card from --seed, one set per
segment, laid out as the main path hands them to the kernels: kernel B
(fused_limb_sums) reads the raw uint8/uint16/int32 planes of the q2 and q9
plans; kernel A (limb_sums) reads the gid and int8 limb planes of q2
unfused (G = 7001) and of the flagship (G = 1001). Each time is the
kernel's own device time per launch (torch.profiler), over --iters launches
that cycle through the segments' inputs, so the 50 MB L2 holds none of
them; each geometry's sums are checked element-equal to the plain
version's first. The shape q2_unfused_zero is q2 unfused with every
payload 0: every add goes to a junk word. One JSON line per shape and
geometry, then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys

DEVICE = "cuda"
HBM_BYTES_PER_S = 3.35e12  # NVIDIA H100 SXM data sheet


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def ssb_planes(torch, n, seed):
    """One segment's planes: s_region, d_year, p_brand dictionary ids and
    the raw lo_revenue, lo_extendedprice, lo_quantity."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)

    def rnd(lo, hi, dtype):
        return torch.randint(lo, hi, (n,), dtype=torch.int32, device=DEVICE,
                             generator=g).to(dtype)

    return {"region": rnd(0, 5, torch.uint8), "year": rnd(0, 7, torch.uint8),
            "brand": rnd(0, 1000, torch.uint16),
            "revenue": rnd(1, 600_000, torch.int32),
            "price": rnd(1, 55_001, torch.int32),
            "quantity": rnd(1, 51, torch.int32)}


def limbs(slot, bits):
    return tuple(("limb", slot, s) for s in range(0, bits, 7))


def fused_case(torch, fg, cols, n, q9):
    """The q2 (or q9) plan: s_region = 'ASIA' (id 2), GROUP BY d_year,
    p_brand (7000 groups and the trash slot), SUM(lo_revenue) (and the
    price and quantity sums)."""
    planes = (("count",),) + limbs(3, 20)
    slots = [cols["region"], cols["year"], cols["brand"], cols["revenue"]]
    if q9:
        planes += limbs(4, 16) + limbs(5, 6)
        slots += [cols["price"], cols["quantity"]]
    fp = fg.FusedPlan((("iv", 0, 0, 1, True, True),), ((1, 1000), (2, 1)),
                      planes, (), tuple(range(len(slots))))
    scalars = torch.tensor([n, 0, 2, 2], dtype=torch.int32, device=DEVICE)
    return fp, tuple(slots), scalars, 7001, n


def limb_case(torch, cols, shape):
    """Kernel A's inputs after the torch filter: q2 unfused (ASIA, by
    d_year and p_brand) or the flagship (d_year >= 1995, by p_brand)."""
    if shape == "flagship":
        mask = cols["year"] >= 3
        gid = cols["brand"].to(torch.int32)
        G = 1001
    else:
        mask = cols["region"] == 2
        gid = cols["year"].to(torch.int32) * 1000 + cols["brand"].to(torch.int32)
        G = 7001
    if shape == "q2_unfused_zero":
        mask = torch.zeros_like(mask)
    gid = torch.where(mask, gid, G - 1).to(torch.int32)
    rev = torch.where(mask, cols["revenue"], 0)
    planes = [mask.to(torch.int8)] + [((rev >> s) & 127).to(torch.int8)
                                      for s in (0, 7, 14)]
    return torch.stack(planes), gid, G


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=2024)
    ap.add_argument("--rows", type=int, default=1 << 23)
    ap.add_argument("--segments", type=int, default=4)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--shapes", nargs="*", default=[
        "q2_plan", "q9_plan", "q2_unfused", "flagship", "q2_unfused_zero"])
    ap.add_argument("--default-only", action="store_true")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("kernel_bench: torch.cuda.is_available() is false; this run "
              "needs an NVIDIA H100", file=sys.stderr)
        return 2
    from chip_smoke import check_equal, device_ms
    from pinot_tpu_torch.ops import _cuda, fused_groupby as fg, geometry
    from pinot_tpu_torch.ops import mxu_groupby as mxu

    n = args.rows
    segs = [ssb_planes(torch, n, args.seed + k) for k in range(args.segments)]
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def geometries(name, P, G, layout):
        real = lambda c, smem: _cuda.max_active_clusters(name, c, smem)  # noqa: E731
        out = {"default": geometry.plan(n, P, G, *layout, sms=sms,
                                        active_clusters=real)}
        if args.default_only:
            return out
        for c in (1, 2, 4, 8):
            only = lambda k, smem, c=c: real(k, smem) if k == c else 0  # noqa: E731
            try:
                geo = geometry.plan(n, P, G, *layout, sms=sms,
                                    active_clusters=only)
            except RuntimeError:
                continue
            out[f"{geo.mode}_C{c}"] = geo
        return out

    for shape in [s for s in ("q2_plan", "q9_plan") if s in args.shapes]:
        recs = [fused_case(torch, fg, cols, n, shape == "q9_plan") for cols in segs]
        fp, planes_in, scalars, G, _ = recs[0]
        P = len(fp.planes)
        nbytes = n * sum(t.element_size() for t in planes_in) + 8 * P * G
        for label, geo in geometries("fused_limb_sums", P, G,
                                     fg.slot_layout(planes_in)).items():
            check_equal(torch, f"{shape} {label}",
                        fg.launch(fp, planes_in, scalars, G, geo),
                        fg.fused_limb_sums_plain(fp, planes_in, scalars, G, n))
            calls = [lambda r=r, geo=geo: fg.launch(r[0], r[1], r[2], G, geo)
                     for r in recs]
            ms = device_ms(torch, calls, "fused_limb_sums", args.iters)
            emit({"kernel": "fused_limb_sums", "shape": shape, "geometry": label,
                  "mode": geo.mode, "cluster": geo.cluster, "ctas": geo.ctas,
                  "tile_rows": geo.tile_rows, "stages": geo.stages,
                  "smem_bytes": geo.smem_bytes, "n": n, "ms": ms,
                  "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3})
        del recs
    for shape in [s for s in ("q2_unfused", "flagship", "q2_unfused_zero")
                  if s in args.shapes]:
        recs = [limb_case(torch, cols, shape) for cols in segs]
        planes, gid, G = recs[0]
        P = planes.shape[0]
        nbytes = n * (4 + P) + 8 * P * G
        for label, geo in geometries("limb_sums", P, G,
                                     mxu.slot_layout(planes, gid)).items():
            check_equal(torch, f"{shape} {label}", mxu.launch(planes, gid, G, geo),
                        mxu.limb_sums_plain(planes, gid, G))
            calls = [lambda r=r, geo=geo: mxu.launch(r[0], r[1], G, geo)
                     for r in recs]
            ms = device_ms(torch, calls, "limb_sums", args.iters)
            emit({"kernel": "limb_sums", "shape": shape, "geometry": label,
                  "mode": geo.mode, "cluster": geo.cluster, "ctas": geo.ctas,
                  "tile_rows": geo.tile_rows, "stages": geo.stages,
                  "smem_bytes": geo.smem_bytes, "n": n, "ms": ms,
                  "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3})
        del recs
    smi = shutil.which("nvidia-smi")
    print(subprocess.run([smi, "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
          if smi else "nvidia-smi not found", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
