"""Kernel A's (csrc/limb_sums.cu) share of its bytes roofline over the
profiled stretch, in %: the bytes its launches must move
(core/roofline.py kernel_a_bytes, counted per launch from its shape and
the rows the segments hold) at the card's HBM peak, over the profiler's
device time of its launches. Where the profiler kept fewer events than
there were launches, the bytes are scaled to the events kept. Nothing
without a launch, a device time or a known peak."""

from benchmark.core.roofline import hbm_bytes_per_s


def read(run):
    p = run.profile
    peak = hbm_bytes_per_s(run.device_name)
    if not p or not peak or not p["kernel_a_events"] \
            or not p["kernel_a_calls"] or p["kernel_a_s"] <= 0:
        return None
    nbytes = p["kernel_a_bytes"] * p["kernel_a_events"] / p["kernel_a_calls"]
    return 100.0 * nbytes / peak / p["kernel_a_s"]
