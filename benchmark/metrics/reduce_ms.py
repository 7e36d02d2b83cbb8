"""Host time of combine + reduce a query, in ms: over the profiled
stretch, the host clock's seconds in QueryExecutor._combine and
BrokerReducer.reduce (the bodies of the program's SERVER_COMBINE and
BROKER_REDUCE spans, timed by the benchmark's wrappers, core/trace.py),
over the reduces that ran in it. A thread's wait for the GIL inside
them counts."""


def read(run):
    p = run.profile
    if not p:
        return None
    layers = p["layers"]
    calls = layers.get("reduce", (0.0, 0))[1]
    if not calls:
        return None
    seconds = sum(layers.get(k, (0.0, 0))[0] for k in ("combine", "reduce"))
    return 1e3 * seconds / calls
