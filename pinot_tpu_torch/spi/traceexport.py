"""Chrome Trace Event export of retained traces (opens in Perfetto).

The port of pinot_tpu/spi/traceexport.py. It renders the broker's merged
flat span list (spi/trace.py `to_json`, with server spans namespaced
`<instance>:<id>` / `<instance>#<n>:<id>` by cluster/broker.py) as Chrome
Trace Event JSON:

- one PROCESS row per participant, the broker and every (instance, shard
  ordinal) that sent spans, named by `process_name` metadata events;
- duration events as matched `B`/`E` pairs (not `X`), laid out on greedily
  assigned THREAD lanes, so overlapping sibling spans (combine workers,
  multi-stage stages running in parallel) never break each other's
  begin/end nesting;
- FLOW events (`s`/`f`) for the hops the span tree cannot express: the
  broker's scatter to each server shard's root span, each shard's end to
  the broker's reduce, and a shard root to any parentless multi-stage
  stage span on that shard.

A server's spans carry times relative to its OWN trace start; each shard
is re-based onto the broker's timeline at the broker's scatter span. The
wire's latency is not measured apart, so the alignment is approximate:
good to read, wrong to time microseconds by.

The output, byte for byte the JAX package's for the same spans (its
`generator` included), loads in ui.perfetto.dev or chrome://tracing.
"""

from __future__ import annotations

from typing import Optional

# broker-side span names the flow stitching anchors on (cluster/broker.py)
SCATTER_SPAN = "BROKER_SCATTER"
REDUCE_SPAN = "BROKER_REDUCE"

_EPS = 1e-6  # ms; float-equality slack for containment tests


def _process_of(span: dict) -> str:
    """'broker' or the merged span-id namespace prefix (instance, shard)."""
    sid = span.get("spanId")
    if isinstance(sid, str) and ":" in sid:
        return sid.rsplit(":", 1)[0]
    return "broker"


def _assign_lanes(spans: list) -> dict:
    """Greedy flame-graph lane assignment within one process: a span may
    share a lane only with spans that strictly contain it (its open
    ancestors) — overlapping siblings get separate lanes, so each lane's
    B/E events nest like a call stack. Returns span index → lane."""
    order = sorted(
        range(len(spans)),
        key=lambda i: (spans[i]["startMs"],
                       -(spans[i]["startMs"]
                         + spans[i].get("durationMs", 0.0))))
    lanes: list = []  # per lane: stack of (start, end) open intervals
    assignment = {}
    for i in order:
        s0 = spans[i]["startMs"]
        e0 = s0 + spans[i].get("durationMs", 0.0)
        placed = None
        for lane_no, stack in enumerate(lanes):
            while stack and stack[-1][1] <= s0 + _EPS:
                stack.pop()
            if not stack or (stack[-1][0] <= s0 + _EPS
                             and stack[-1][1] + _EPS >= e0):
                stack.append((s0, e0))
                placed = lane_no
                break
        if placed is None:
            lanes.append([(s0, e0)])
            placed = len(lanes) - 1
        assignment[i] = placed
    return assignment


def _json_safe_attrs(attrs: Optional[dict]) -> dict:
    out = {}
    for k, v in (attrs or {}).items():
        if isinstance(v, (str, int, float, bool)) or v is None:
            out[k] = v
        else:
            out[k] = str(v)
    return out


def to_chrome_trace(spans: list, query_id: str = "") -> dict:
    """Flat merged span list → Chrome Trace Event JSON object."""
    procs: dict[str, list] = {}
    for span in spans:
        procs.setdefault(_process_of(span), []).append(span)
    # stable pids: broker first, shards in first-span order
    pids = {"broker": 1}
    for name in procs:
        if name not in pids:
            pids[name] = len(pids) + 1

    broker_spans = procs.get("broker", [])
    scatter = next((s for s in broker_spans
                    if s.get("operator") == SCATTER_SPAN), None)
    reduce_ = next((s for s in broker_spans
                    if s.get("operator") == REDUCE_SPAN), None)
    anchor = scatter or (min(broker_spans, key=lambda s: s["startMs"])
                         if broker_spans else None)
    # shard timelines re-base onto the broker's scatter start
    shard_offset_ms = anchor["startMs"] if anchor is not None else 0.0

    events: list = []
    # (process, local span index) → (pid, tid, begin ts µs, end ts µs)
    placed: dict = {}
    for pname, pspans in procs.items():
        pid = pids[pname]
        events.append({"name": "process_name", "ph": "M", "pid": pid,
                       "tid": 0, "args": {"name": pname}})
        events.append({"name": "process_sort_index", "ph": "M", "pid": pid,
                       "tid": 0, "args": {"sort_index": pid}})
        lanes = _assign_lanes(pspans)
        offset = 0.0 if pname == "broker" else shard_offset_ms
        # outer-before-inner emit order (same order the lane assigner
        # used) keeps same-timestamp B events parent-first
        order = sorted(
            range(len(pspans)),
            key=lambda i: (pspans[i]["startMs"],
                           -(pspans[i]["startMs"]
                             + pspans[i].get("durationMs", 0.0))))
        for rank, i in enumerate(order):
            span = pspans[i]
            tid = lanes[i]
            ts = round((span["startMs"] + offset) * 1000.0, 3)
            dur = round(span.get("durationMs", 0.0) * 1000.0, 3)
            args = _json_safe_attrs(span.get("attributes"))
            args["spanId"] = str(span.get("spanId"))
            if span.get("parentId") is not None:
                args["parentId"] = str(span["parentId"])
            events.append({"name": span.get("operator", "span"),
                           "cat": "query", "ph": "B", "pid": pid,
                           "tid": tid, "ts": ts, "args": args,
                           "_order": (ts, 1, rank)})
            events.append({"name": span.get("operator", "span"),
                           "cat": "query", "ph": "E", "pid": pid,
                           "tid": tid, "ts": round(ts + dur, 3),
                           "_order": (round(ts + dur, 3), 0, -rank)})
            placed[(pname, i)] = (pid, tid, ts, round(ts + dur, 3))

    # flow stitching: broker scatter → shard roots → broker reduce, plus
    # shard root → parentless MSE stage spans on that shard
    flow_seq = 0

    def _flow(src, dst, name):
        nonlocal flow_seq
        flow_seq += 1
        fid = f"{name}-{flow_seq}"
        s_pid, s_tid, _s_b, s_e = src
        d_pid, d_tid, d_b, _d_e = dst
        # flow start sits at the source span's begin (scatter fans out as
        # soon as the broker span opens; finish binds enclosing slice)
        events.append({"name": name, "cat": "flow", "ph": "s", "id": fid,
                       "pid": s_pid, "tid": s_tid, "ts": src[2]})
        events.append({"name": name, "cat": "flow", "ph": "f", "bp": "e",
                       "id": fid, "pid": d_pid, "tid": d_tid, "ts": d_b})

    anchor_key = None
    reduce_key = None
    for i, s in enumerate(broker_spans):
        if anchor is not None and s is anchor:
            anchor_key = placed.get(("broker", i))
        if reduce_ is not None and s is reduce_:
            reduce_key = placed.get(("broker", i))
    for pname, pspans in procs.items():
        if pname == "broker":
            continue
        # shard roots are the parentless non-stage spans; MSE stage spans
        # recorded from worker threads can also surface parentless, and
        # those are flow DESTINATIONS, not roots
        roots = [i for i, s in enumerate(pspans)
                 if s.get("parentId") is None
                 and not str(s.get("operator", "")).startswith("mse_stage:")]
        for i in roots:
            dst = placed[(pname, i)]
            if anchor_key is not None:
                _flow(anchor_key, dst, "scatter")
            if reduce_key is not None:
                # gather: shard completion feeds the broker reduce
                src_pid, src_tid, _b, src_e = dst
                _flow((src_pid, src_tid, src_e, src_e), reduce_key,
                      "gather")
            # parentless MSE stage spans on this shard hang off its root
            for j, s in enumerate(pspans):
                if j in roots:
                    continue
                if s.get("parentId") is None and str(
                        s.get("operator", "")).startswith("mse_stage:"):
                    _flow(dst, placed[(pname, j)], "stage")

    # deterministic, nesting-safe emit order: metadata first, then by
    # (pid, tid, ts, E-before-B, outer-before-inner)
    meta = [e for e in events if e["ph"] == "M"]
    rest = sorted((e for e in events if e["ph"] != "M"),
                  key=lambda e: (e["pid"], e.get("tid", 0),
                                 e.get("_order", (e["ts"], 2, 0))))
    for e in rest:
        e.pop("_order", None)
    return {"traceEvents": meta + rest,
            "displayTimeUnit": "ms",
            "otherData": {"queryId": query_id,
                          "format": "chrome-trace-event",
                          "generator": "pinot_tpu"}}
