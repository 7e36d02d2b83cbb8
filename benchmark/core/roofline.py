"""Peaks of the card and the bytes a kernel launch must move.

The peaks are NVIDIA's data sheet for the H100 SXM (dense rates, at the
700 W limit), keyed by the name torch.cuda.get_device_name() gives. A card
not in the table has no roofline: its readers report nothing.

kernel_a_bytes is kernel_bench.py's arithmetic for kernel A
(csrc/limb_sums.cu): each input byte read once (an int32 group id and one
int8 limb per plane for every row the segments hold, not the pad past
them) and each output byte written once (an int64 sum per plane and group
of each segment).
"""

from __future__ import annotations

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12,
                              "bf16_flops": 989e12},
}


def kernel_a_bytes(live_rows: int, segments: int, planes: int,
                   groups: int) -> int:
    """Bytes one launch of kernel A must move: `live_rows` rows summed
    over its `segments` members, `planes` int8 planes, `groups` output
    groups a member."""
    return live_rows * (4 + planes) + segments * 8 * planes * groups


def hbm_bytes_per_s(device_name: str):
    peak = PEAKS.get(device_name)
    return None if peak is None else peak["hbm_bytes_per_s"]
