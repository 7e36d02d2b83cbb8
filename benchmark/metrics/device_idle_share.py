"""The share of the profiled stretch in which no operation ran on the
card, in %: 1 - the union of the device's busy intervals (every kernel,
copy and set in the profiler's trace) over the stretch's length."""


def read(run):
    p = run.profile
    if not p or p["window_s"] <= 0 or p["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
