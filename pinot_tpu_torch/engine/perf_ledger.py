"""Per-plan performance ledger and alert book (the regression sentinel).

The port of pinot_tpu/engine/perf_ledger.py. A plan can get slower with
no query answering wrong: a coalesced group that stops forming, a result
cache that stops hitting, a fused device join that falls back to the
host. This module is the always-on half of the watch for that:

`PerfLedger`
    One entry per plan fingerprint (the broker's result-cache fingerprint
    when the query computed one, a crc of the SQL text otherwise), holding
    a rolling SHORT window and a decayed long-term REFERENCE window of: a
    log-bucketed latency histogram (4 buckets an octave, as
    spi/metrics.TimerHistogram), and counts of dispatches, compiles, host
    crossings, bytes shuffled, result-cache and segment-cache outcomes,
    coalesced peers, errors and partials. Recording is counter bumps over
    fields the response already carries: no device sync, no span, no
    fingerprint walk. Engine fallback events are counted where the
    fallback happens; the port notes `device-join-host` (mse/runtime.py).
    Eager PyTorch compiles nothing, so the port's compile counts are 0;
    it has no fused-kernel fallback (`fused-host`) and no mesh
    (`mesh-solo`), so neither event is ever noted. The ledger is bounded
    (PINOT_TPU_LEDGER_MAX plans, evicting the stalest tenth when full) and
    persists its reference windows in the property store
    (`/PERF/LEDGER`), so a restarted cluster keeps its notion of normal.

`AlertBook`
    The alerts the drift detector (cluster/sentinel.py) fires and
    resolves: named anomaly types deduplicated per (type, key), the
    exemplar trace ids the broker pins under each, and a bounded history.

Exemplar pinning closes the loop from metrics to traces: when an alert
fires, the sentinel arms `claim_exemplar` for the next N matching queries;
the broker reads ONE attribute (`exemplar_armed`, False when disarmed) and
forces head sampling on a claim, pinning the trace in its TraceStore
tagged with the alert id.
"""

from __future__ import annotations

import math
import os
import threading
import time

# SHORT window length: the ledger folds the live window into the decayed
# reference once it ages past this (lazily, on the next record() or on a
# sentinel scrape). Tests and soaks call rotate_now() instead of waiting.
WINDOW_S_ENV = "PINOT_TPU_LEDGER_WINDOW_S"
# bound on distinct plan fingerprints held (fingerprint churn — e.g. a
# literal-heavy workload hashing to many SQL keys — evicts, never grows)
MAX_PLANS_ENV = "PINOT_TPU_LEDGER_MAX"
# decay applied to the reference window at every fold: ref = ref*d + cur
REF_DECAY_ENV = "PINOT_TPU_LEDGER_REF_DECAY"

LEDGER_PATH = "/PERF/LEDGER"

# SLO objectives (env defaults; per-table override via table config keys
# sloLatencyMs / sloErrorRate / sloPartialRate, folded in by the
# sentinel). Latency objective reads "this fraction of queries finishes
# under sloLatencyMs"; its error budget is 1 - pct.
SLO_LATENCY_MS_ENV = "PINOT_TPU_SLO_LATENCY_MS"
SLO_LATENCY_PCT_ENV = "PINOT_TPU_SLO_LATENCY_PCT"
SLO_ERROR_RATE_ENV = "PINOT_TPU_SLO_ERROR_RATE"
SLO_PARTIAL_RATE_ENV = "PINOT_TPU_SLO_PARTIAL_RATE"
SLO_FAST_WINDOW_S_ENV = "PINOT_TPU_SLO_FAST_WINDOW_S"
SLO_SLOW_WINDOW_S_ENV = "PINOT_TPU_SLO_SLOW_WINDOW_S"

# same histogram resolution as spi/metrics.TimerHistogram: 4 buckets per
# power of two -> worst-case quantile error 2**0.25 - 1 ~= 19%
_BUCKETS_PER_OCTAVE = 4

_COUNTER_KEYS = (
    "queries", "errors", "partials", "dispatches", "compiles",
    "hostCrossings", "bytesShuffled", "cacheHits", "cacheMisses",
    "cacheBypass", "segCacheHits", "segCacheMisses", "coalesced",
    "latencySumMs",
)

# monotonic clock hook — tests freeze/advance it to drive window math
# deterministically without sleeping
_mono = time.monotonic


def _bucket_index(ms: float) -> int:
    if ms <= 0:
        return -64
    return math.ceil(math.log2(ms) * _BUCKETS_PER_OCTAVE)


def _bucket_upper_ms(idx: int) -> float:
    return 2.0 ** (idx / _BUCKETS_PER_OCTAVE)


def bucket_quantile(buckets: dict, q: float) -> float:
    """Quantile estimate (upper bucket bound, ms) from a log-bucketed
    histogram whose counts may be decayed floats."""
    total = sum(buckets.values())
    if total <= 0:
        return 0.0
    target = q * total
    acc = 0.0
    for idx in sorted(buckets):
        acc += buckets[idx]
        if acc >= target:
            return _bucket_upper_ms(idx)
    return _bucket_upper_ms(max(buckets))


def _fresh_window() -> dict:
    w = dict.fromkeys(_COUNTER_KEYS, 0)
    w["latBuckets"] = {}
    return w


def _fold(ref: dict, cur: dict, decay: float) -> None:
    for k in _COUNTER_KEYS:
        ref[k] = ref[k] * decay + cur[k]
    rb = ref["latBuckets"]
    for idx in rb:
        rb[idx] *= decay
    for idx, n in cur["latBuckets"].items():
        rb[idx] = rb.get(idx, 0.0) + n


class _Plan:
    """One fingerprint's rolling state. All mutation happens under the
    ledger lock; no per-plan locks."""

    __slots__ = ("key", "table", "sql", "first_seen", "last_update",
                 "cur", "cur_start", "ref", "ref_weight", "tot")

    def __init__(self, key: str, table: str, sql: str, now: float):
        self.key = key
        self.table = table
        self.sql = sql
        self.first_seen = time.time()
        self.last_update = now
        self.cur = _fresh_window()
        self.cur_start = now
        self.ref = _fresh_window()
        self.ref["latBuckets"] = {}
        self.ref_weight = 0.0
        self.tot = dict.fromkeys(
            ("queries", "errors", "partials", "compiles"), 0)


class _TableSlo:
    """Per-table SLO time series: small fixed-duration buckets pruned past
    the slow burn window, each counting queries / errors / partials /
    latency-objective breaches."""

    __slots__ = ("buckets",)

    def __init__(self):
        self.buckets: list = []  # [bucket_id, q, err, part, lat_breach]

    def bump(self, bucket_id: int, error: bool, partial: bool,
             lat_breach: bool, keep: int) -> None:
        b = self.buckets
        if not b or b[-1][0] != bucket_id:
            b.append([bucket_id, 0, 0, 0, 0])
            if len(b) > keep:
                del b[:len(b) - keep]
        row = b[-1]
        row[1] += 1
        row[2] += int(error)
        row[3] += int(partial)
        row[4] += int(lat_breach)

    def window(self, bucket_id: int, n_buckets: int) -> tuple:
        lo = bucket_id - n_buckets
        q = err = part = lat = 0
        for row in reversed(self.buckets):
            if row[0] <= lo:
                break
            q += row[1]
            err += row[2]
            part += row[3]
            lat += row[4]
        return q, err, part, lat


class PerfLedger:
    def __init__(self, window_s: float = None, max_plans: int = None,
                 ref_decay: float = None):
        self.window_s = float(
            os.environ.get(WINDOW_S_ENV, 60.0)
            if window_s is None else window_s)
        self.max_plans = int(
            os.environ.get(MAX_PLANS_ENV, 512)
            if max_plans is None else max_plans)
        self.ref_decay = float(
            os.environ.get(REF_DECAY_ENV, 0.8)
            if ref_decay is None else ref_decay)
        self._lock = threading.Lock()
        self._plans: dict[str, _Plan] = {}
        self._tables: dict[str, _TableSlo] = {}
        self._slo_overrides: dict[str, dict] = {}
        self._slo_cache: dict[str, dict] = {}
        # global fallback-event windows (mesh-solo / device-join-host /
        # fused-host / ...): cur + decayed ref, same fold cycle as plans
        self._ev_cur: dict[str, int] = {}
        self._ev_start = _mono()
        self._ev_ref: dict[str, float] = {}
        self._ev_ref_weight = 0.0
        self._ev_tot: dict[str, int] = {}
        self._evictions = 0
        # exemplar arming: False is the entire disarmed hot-path cost
        # (one attribute read at the broker sampling site)
        self.exemplar_armed = False
        self._exemplar_targets: dict = {}  # ("plan"|"table", key) -> [id, n]

    # -- SLO objectives ------------------------------------------------------

    def slo_for(self, table: str) -> dict:
        slo = self._slo_cache.get(table)
        if slo is None:
            slo = {
                "latencyMs": float(
                    os.environ.get(SLO_LATENCY_MS_ENV, 1000.0)),
                "latencyPct": float(
                    os.environ.get(SLO_LATENCY_PCT_ENV, 0.99)),
                "errorRate": float(
                    os.environ.get(SLO_ERROR_RATE_ENV, 0.01)),
                "partialRate": float(
                    os.environ.get(SLO_PARTIAL_RATE_ENV, 0.05)),
                "fastWindowS": float(
                    os.environ.get(SLO_FAST_WINDOW_S_ENV, 60.0)),
                "slowWindowS": float(
                    os.environ.get(SLO_SLOW_WINDOW_S_ENV, 600.0)),
            }
            slo.update(self._slo_overrides.get(table, {}))
            self._slo_cache[table] = slo
        return slo

    def set_slo_override(self, table: str, override: dict) -> None:
        """Table-config SLO override (sentinel folds these in from
        /CONFIGS/TABLE/* keys sloLatencyMs/sloErrorRate/sloPartialRate)."""
        with self._lock:
            self._slo_overrides[table] = dict(override)
            self._slo_cache.pop(table, None)

    def _slo_bucket_s(self, slo: dict) -> float:
        # ≥6 buckets across the fast window keeps the burn rate readable
        return max(slo["fastWindowS"] / 6.0, 0.05)

    # -- recording (broker funnel: pure counter bumps) -----------------------

    def record(self, key: str, *, table: str = "", time_ms: float = 0.0,
               error: bool = False, partial: bool = False,
               dispatches: int = 0, compiles: int = 0,
               cache_outcome: str = "", seg_cache_hits: int = 0,
               seg_cache_misses: int = 0, coalesced: int = 0,
               host_crossings: int = 0, bytes_shuffled: int = 0,
               sql: str = "") -> None:
        now = _mono()
        bidx = _bucket_index(time_ms)
        with self._lock:
            plan = self._plans.get(key)
            if plan is None:
                if len(self._plans) >= self.max_plans:
                    self._evict_locked()
                plan = _Plan(key, table, sql[:120], now)
                self._plans[key] = plan
            elif now - plan.cur_start >= self.window_s:
                self._rotate_plan_locked(plan, now)
            plan.last_update = now
            cur = plan.cur
            cur["queries"] += 1
            cur["latencySumMs"] += time_ms
            cur["latBuckets"][bidx] = cur["latBuckets"].get(bidx, 0) + 1
            cur["dispatches"] += dispatches
            cur["compiles"] += compiles
            cur["hostCrossings"] += host_crossings
            cur["bytesShuffled"] += bytes_shuffled
            cur["segCacheHits"] += seg_cache_hits
            cur["segCacheMisses"] += seg_cache_misses
            cur["coalesced"] += coalesced
            if error:
                cur["errors"] += 1
            if partial:
                cur["partials"] += 1
            if cache_outcome == "hit":
                cur["cacheHits"] += 1
            elif cache_outcome == "miss":
                cur["cacheMisses"] += 1
            elif cache_outcome:
                cur["cacheBypass"] += 1
            tot = plan.tot
            tot["queries"] += 1
            tot["compiles"] += compiles
            if error:
                tot["errors"] += 1
            if partial:
                tot["partials"] += 1
            if table:
                slo = self.slo_for(table)
                bucket_s = self._slo_bucket_s(slo)
                keep = int(slo["slowWindowS"] / bucket_s) + 2
                ts = self._tables.get(table)
                if ts is None:
                    ts = self._tables[table] = _TableSlo()
                ts.bump(int(now / bucket_s), error, partial,
                        time_ms > slo["latencyMs"], keep)

    def note_event(self, kind: str) -> None:
        """Count one engine fallback event (e.g. ``mesh-solo``,
        ``device-join-host``, ``fused-host``). Called from the fallback
        paths themselves — rare by definition, so a lock is fine."""
        with self._lock:
            self._ev_cur[kind] = self._ev_cur.get(kind, 0) + 1
            self._ev_tot[kind] = self._ev_tot.get(kind, 0) + 1

    # -- window rotation -----------------------------------------------------

    def _rotate_plan_locked(self, plan: _Plan, now: float) -> None:
        if plan.cur["queries"]:
            _fold(plan.ref, plan.cur, self.ref_decay)
            plan.ref_weight = plan.ref_weight * self.ref_decay + 1.0
            plan.cur = _fresh_window()
        plan.cur_start = now

    def _rotate_events_locked(self, now: float) -> None:
        if self._ev_cur:
            for k, n in self._ev_cur.items():
                self._ev_ref[k] = self._ev_ref.get(k, 0.0) \
                    * self.ref_decay + n
            self._ev_cur = {}
        self._ev_ref_weight = self._ev_ref_weight * self.ref_decay + 1.0
        self._ev_start = now

    def maybe_rotate(self) -> None:
        """Fold any aged-out short windows into their references (the
        sentinel calls this at every scrape so idle plans still age)."""
        now = _mono()
        with self._lock:
            for plan in self._plans.values():
                if now - plan.cur_start >= self.window_s:
                    self._rotate_plan_locked(plan, now)
            if now - self._ev_start >= self.window_s:
                self._rotate_events_locked(now)

    def rotate_now(self) -> None:
        """Force-fold every live short window into its reference — the
        deterministic handle tests and soaks use to establish a baseline
        without waiting out a wall-clock window."""
        now = _mono()
        with self._lock:
            for plan in self._plans.values():
                self._rotate_plan_locked(plan, now)
            self._rotate_events_locked(now)

    def _evict_locked(self) -> None:
        # batch-evict the stalest ~10% so fingerprint churn amortizes to
        # one scan per max_plans/10 inserts instead of one per insert
        n = max(1, self.max_plans // 10)
        stalest = sorted(self._plans.values(),
                         key=lambda p: p.last_update)[:n]
        for plan in stalest:
            del self._plans[plan.key]
        self._evictions += len(stalest)

    # -- exemplar arming -----------------------------------------------------

    def arm_exemplars(self, alert_id: str, *, plan_key: str = "",
                      table: str = "", count: int = 3) -> None:
        with self._lock:
            if plan_key:
                self._exemplar_targets[("plan", plan_key)] = \
                    [alert_id, count]
            elif table:
                self._exemplar_targets[("table", table)] = [alert_id, count]
            else:
                return
            self.exemplar_armed = True

    def claim_exemplar(self, plan_key: str, table: str):
        """Armed-path half of exemplar pinning: returns the alert id to
        tag the forced sample with, or None. Callers gate on the
        ``exemplar_armed`` attribute first — disarmed queries never take
        this lock."""
        with self._lock:
            for tkey in (("plan", plan_key), ("table", table)):
                tgt = self._exemplar_targets.get(tkey)
                if tgt is not None and tgt[1] > 0:
                    tgt[1] -= 1
                    if tgt[1] <= 0:
                        del self._exemplar_targets[tkey]
                        if not self._exemplar_targets:
                            self.exemplar_armed = False
                    return tgt[0]
        return None

    def disarm_exemplars(self, alert_id: str = "") -> None:
        with self._lock:
            if alert_id:
                self._exemplar_targets = {
                    k: v for k, v in self._exemplar_targets.items()
                    if v[0] != alert_id}
            else:
                self._exemplar_targets = {}
            self.exemplar_armed = bool(self._exemplar_targets)

    # -- introspection -------------------------------------------------------

    def __len__(self) -> int:
        return len(self._plans)

    def plan_windows(self, key: str):
        """(cur, ref, ref_weight, table) snapshot for one plan — the
        sentinel's drift-rule input. Returns None when unseen."""
        with self._lock:
            plan = self._plans.get(key)
            if plan is None:
                return None
            return (dict(plan.cur, latBuckets=dict(plan.cur["latBuckets"])),
                    dict(plan.ref, latBuckets=dict(plan.ref["latBuckets"])),
                    plan.ref_weight, plan.table)

    def keys(self) -> list:
        with self._lock:
            return list(self._plans)

    def tables(self) -> list:
        with self._lock:
            return list(self._tables)

    def burn_rates(self, table: str) -> dict:
        """Multi-window SLO burn rates for one table: consumption rate of
        each error budget over the fast and slow windows (burn 1.0 =
        exactly on budget; the sentinel alerts when BOTH windows burn hot,
        the Google-SRE multiwindow rule that makes one noisy minute
        unable to page)."""
        slo = self.slo_for(table)
        bucket_s = self._slo_bucket_s(slo)
        now_b = int(_mono() / bucket_s)
        with self._lock:
            ts = self._tables.get(table)
            if ts is None:
                return {}
            out = {}
            for label, win_s in (("fast", slo["fastWindowS"]),
                                 ("slow", slo["slowWindowS"])):
                q, err, part, lat = ts.window(
                    now_b + 1, max(1, int(win_s / bucket_s)))
                if q == 0:
                    out[label] = {"queries": 0}
                    continue
                lat_budget = max(1e-9, 1.0 - slo["latencyPct"])
                out[label] = {
                    "queries": q,
                    "errorBurn": (err / q) / max(1e-9, slo["errorRate"]),
                    "partialBurn": (part / q) / max(1e-9,
                                                    slo["partialRate"]),
                    "latencyBurn": (lat / q) / lat_budget,
                }
            out["slo"] = slo
            return out

    def events_windows(self) -> tuple:
        with self._lock:
            return (dict(self._ev_cur), dict(self._ev_ref),
                    self._ev_ref_weight, dict(self._ev_tot))

    def snapshot(self) -> dict:
        """Per-plan window summaries plus the global fallback-event windows
        (the payload of the JAX broker's GET /debug/ledger)."""
        with self._lock:
            plans = []
            for plan in self._plans.values():
                cur, ref = plan.cur, plan.ref
                plans.append({
                    "fingerprint": plan.key,
                    "table": plan.table,
                    "sql": plan.sql,
                    "firstSeen": plan.first_seen,
                    "totals": dict(plan.tot),
                    "short": {k: cur[k] for k in _COUNTER_KEYS},
                    "shortP50Ms": round(
                        bucket_quantile(cur["latBuckets"], 0.5), 3),
                    "shortP99Ms": round(
                        bucket_quantile(cur["latBuckets"], 0.99), 3),
                    "refWeight": round(plan.ref_weight, 3),
                    "refP50Ms": round(
                        bucket_quantile(ref["latBuckets"], 0.5), 3),
                    "refQueries": round(ref["queries"], 2),
                    "refCompiles": round(ref["compiles"], 2),
                })
            plans.sort(key=lambda p: -p["totals"]["queries"])
            return {
                "windowS": self.window_s,
                "maxPlans": self.max_plans,
                "numPlans": len(self._plans),
                "evictions": self._evictions,
                "plans": plans,
                "fallbackEvents": {
                    "short": dict(self._ev_cur),
                    "ref": {k: round(v, 2)
                            for k, v in self._ev_ref.items()},
                    "total": dict(self._ev_tot),
                },
            }

    # -- persistence (WAL store) ---------------------------------------------

    def persist(self, store) -> None:
        """Snapshot the reference windows into the PropertyStore (one
        ``set`` on LEDGER_PATH — WAL-journaled, so it survives a store
        restart). Called from the sentinel's scrape, NEVER from the query
        path: a query makes no journal append."""
        with self._lock:
            plans = {}
            # persist the busiest plans first; cap keeps the journal entry
            # bounded no matter how churned the ledger got
            ranked = sorted(self._plans.values(),
                            key=lambda p: -p.tot["queries"])[:256]
            for plan in ranked:
                ref = dict(plan.ref)
                ref["latBuckets"] = {str(k): v for k, v
                                     in plan.ref["latBuckets"].items()}
                plans[plan.key] = {
                    "table": plan.table, "sql": plan.sql,
                    "firstSeen": plan.first_seen,
                    "ref": ref, "refWeight": plan.ref_weight,
                    "totals": dict(plan.tot),
                }
            payload = {
                "version": 1,
                "savedAtMs": int(time.time() * 1000),
                "plans": plans,
                "events": {"ref": dict(self._ev_ref),
                           "refWeight": self._ev_ref_weight,
                           "total": dict(self._ev_tot)},
            }
        store.set(LEDGER_PATH, payload)

    def restore(self, store) -> int:
        """Load persisted reference windows for plans this process has not
        seen yet (live state always wins). Returns the number of plans
        restored."""
        payload = store.get(LEDGER_PATH)
        if not isinstance(payload, dict) or payload.get("version") != 1:
            return 0
        now = _mono()
        restored = 0
        with self._lock:
            for key, rec in (payload.get("plans") or {}).items():
                if key in self._plans:
                    continue
                if len(self._plans) >= self.max_plans:
                    break
                plan = _Plan(key, rec.get("table", ""),
                             rec.get("sql", ""), now)
                plan.first_seen = rec.get("firstSeen", plan.first_seen)
                ref = dict(_fresh_window())
                ref.update({k: v for k, v in (rec.get("ref") or {}).items()
                            if k in _COUNTER_KEYS})
                ref["latBuckets"] = {
                    int(k): float(v) for k, v in
                    ((rec.get("ref") or {}).get("latBuckets") or {}).items()}
                plan.ref = ref
                plan.ref_weight = float(rec.get("refWeight", 0.0))
                plan.tot.update(rec.get("totals") or {})
                self._plans[key] = plan
                restored += 1
            ev = payload.get("events") or {}
            for k, v in (ev.get("ref") or {}).items():
                self._ev_ref.setdefault(k, float(v))
            self._ev_ref_weight = max(self._ev_ref_weight,
                                      float(ev.get("refWeight", 0.0)))
            for k, v in (ev.get("total") or {}).items():
                self._ev_tot[k] = self._ev_tot.get(k, 0) + int(v)
        return restored

    def clear(self) -> None:
        with self._lock:
            self._plans.clear()
            self._tables.clear()
            self._slo_cache.clear()
            self._slo_overrides.clear()
            self._ev_cur, self._ev_ref, self._ev_tot = {}, {}, {}
            self._ev_ref_weight = 0.0
            self._evictions = 0
            self._exemplar_targets = {}
            self.exemplar_armed = False


class AlertBook:
    """Structured alerts keyed by (type, scope key): the sentinel fires
    and resolves; the broker appends exemplar trace ids; the query log
    and REST layer read. Bounded history, newest-first snapshots."""

    def __init__(self, max_history: int = 256):
        self.max_history = max_history
        self._lock = threading.Lock()
        self._alerts: dict[str, dict] = {}  # id -> record
        self._active: dict[tuple, str] = {}  # (type, key) -> id
        self._seq = 0
        self.active_count = 0  # cheap cross-thread read (GIL-atomic int)

    def fire(self, type_: str, key: str, table: str, summary: str,
             details: dict = None) -> tuple:
        """Fire or refresh the (type, key) alert. Returns (id, new)."""
        now_ms = int(time.time() * 1000)
        with self._lock:
            aid = self._active.get((type_, key))
            if aid is not None:
                rec = self._alerts[aid]
                rec["lastUpdateMs"] = now_ms
                rec["fireCount"] += 1
                if summary:
                    rec["summary"] = summary
                if details:
                    rec["details"] = details
                return aid, False
            self._seq += 1
            aid = f"{type_}-{self._seq:04d}"
            self._alerts[aid] = {
                "id": aid, "type": type_, "key": key, "table": table,
                "state": "firing", "summary": summary,
                "details": details or {}, "firstFiredMs": now_ms,
                "lastUpdateMs": now_ms, "fireCount": 1,
                "exemplarTraceIds": [],
            }
            self._active[(type_, key)] = aid
            self.active_count = len(self._active)
            if len(self._alerts) > self.max_history:
                for old in sorted(
                        (a for a in self._alerts.values()
                         if a["state"] != "firing"),
                        key=lambda a: a["lastUpdateMs"])[
                            :len(self._alerts) - self.max_history]:
                    del self._alerts[old["id"]]
            return aid, True

    def resolve(self, type_: str, key: str, reason: str = "recovered"):
        with self._lock:
            aid = self._active.pop((type_, key), None)
            self.active_count = len(self._active)
            if aid is None:
                return None
            rec = self._alerts[aid]
            rec["state"] = "cleared"
            rec["clearedMs"] = int(time.time() * 1000)
            rec["clearReason"] = reason
            return aid

    def note_exemplar(self, alert_id: str, trace_id: str) -> None:
        with self._lock:
            rec = self._alerts.get(alert_id)
            if rec is not None and trace_id not in rec["exemplarTraceIds"]:
                rec["exemplarTraceIds"].append(trace_id)

    def exemplars_pinned(self) -> int:
        with self._lock:
            return sum(len(a["exemplarTraceIds"])
                       for a in self._alerts.values())

    def active_ids_for(self, key: str, table: str) -> list:
        """Active alert ids whose scope matches a plan key or table —
        the querylog cross-link. Only consulted off the hot path (slow
        queries, REST), and only when ``active_count`` is nonzero."""
        with self._lock:
            out = []
            for (typ, k), aid in self._active.items():
                rec = self._alerts[aid]
                if k == key or (table and rec.get("table") == table):
                    out.append(aid)
            return out

    def get(self, alert_id: str):
        with self._lock:
            rec = self._alerts.get(alert_id)
            return dict(rec) if rec is not None else None

    def active(self) -> list:
        with self._lock:
            out = [dict(self._alerts[aid]) for aid in self._active.values()]
            out.sort(key=lambda a: -a["lastUpdateMs"])
            return out

    def snapshot(self) -> dict:
        with self._lock:
            alerts = sorted((dict(a) for a in self._alerts.values()),
                            key=lambda a: -a["lastUpdateMs"])
            return {"active": sum(1 for a in alerts
                                  if a["state"] == "firing"),
                    "alerts": alerts}

    def clear(self) -> None:
        with self._lock:
            self._alerts.clear()
            self._active.clear()
            self._seq = 0
            self.active_count = 0


PERF_LEDGER = PerfLedger()
ALERTS = AlertBook()
