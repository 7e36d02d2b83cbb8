"""Device time a query, in ms: the seconds in which an operation ran on the
card over the profiled stretch (the union of every kernel, copy and set in
the profiler's trace), over the queries completed in the stretch. Under
concurrent clients it counts each second of device work once, however
many queries' launches were queued."""


def read(run):
    p = run.profile
    if not p or p["busy_s"] <= 0:
        return None
    done = sum(1 for r in run.records if r.t_done is not None
               and p["t_start"] <= r.t_done <= p["t_stop"])
    return 1e3 * p["busy_s"] / done if done else None
