"""Continuous performance regression sentinel (the drift detector half).

The port of pinot_tpu/cluster/sentinel.py. The ledger
(engine/perf_ledger.py) keeps per-plan rolling windows; this task, gated
on the controller's leadership, turns them into named anomalies and SLO
burn-rate alerts with hysteresis:

- ``latency-drift``        a plan's short-window p50 regressed past its
                           decayed reference by a ratio threshold AND an
                           absolute jitter floor
- ``compile-storm``        compiles per query in the short window blew past
                           the reference rate. The port's responses count
                           0 compiles (eager PyTorch compiles nothing), so
                           on the port's own traffic it never fires
- ``fallback-surge``       engine fallback events (device-join→host, the
                           one the port notes) spiking against their
                           reference window
- ``cache-collapse``       a plan that used to serve from the result cache
                           stopped hitting (epoch churn, key drift)
- ``crossing-regression``  device→host crossings per query rose: a fused
                           plan silently losing residency
- ``slo-burn``             a table's error budget (latency / error /
                           partial-rate objective) burning hot in BOTH the
                           fast and slow windows (the multiwindow rule:
                           one noisy minute cannot page, a sustained burn
                           cannot hide)

Every rule must breach ``PINOT_TPU_SENTINEL_BREACHES`` consecutive
evaluations to fire and pass ``PINOT_TPU_SENTINEL_CLEARS`` clean ones to
resolve. On a NEW alert the sentinel arms exemplar pinning: the next N
matching queries are head-sampled and their traces pinned in the broker's
TraceStore under the alert id, so every alert links to a trace of the
regressed shape.

Each call (`__call__`) also persists the ledger's reference windows in the
property store (a restart keeps its notion of normal) and publishes its
report at ``/PERF/SENTINEL``. Where the JAX package attaches its newest
committed ``BENCH_r*.json`` round (TPU numbers), the port's
``benchBaseline`` is None. The JAX package schedules the sentinel as a
periodic task (cluster/periodic.py), which the port has not yet: callers
run it directly.
"""

from __future__ import annotations

import os
import time

from ..engine.perf_ledger import ALERTS, PERF_LEDGER, bucket_quantile
from ..spi.metrics import CONTROLLER_METRICS, ControllerGauge

SENTINEL_REPORT_PATH = "/PERF/SENTINEL"

# drift thresholds: the JAX package's offline bench gate's values (the
# sentinel is the always-on version of the same judgement)
THRESHOLD_ENV = "PINOT_TPU_SENTINEL_THRESHOLD"
MIN_ABS_MS_ENV = "PINOT_TPU_SENTINEL_MIN_ABS_MS"
# fewest short-window queries before a plan's windows are judged at all
MIN_QUERIES_ENV = "PINOT_TPU_SENTINEL_MIN_QUERIES"
# hysteresis: consecutive breaching evaluations to fire / clean ones to clear
BREACHES_ENV = "PINOT_TPU_SENTINEL_BREACHES"
CLEARS_ENV = "PINOT_TPU_SENTINEL_CLEARS"
# exemplars pinned per new alert
EXEMPLARS_ENV = "PINOT_TPU_SENTINEL_EXEMPLARS"

# table-config keys that override the PINOT_TPU_SLO_* env objectives
_SLO_CFG_KEYS = {"sloLatencyMs": "latencyMs", "sloLatencyPct": "latencyPct",
                 "sloErrorRate": "errorRate", "sloPartialRate": "partialRate"}


class PerfRegressionSentinel:
    """Leader-gated drift detector over the perf ledger."""

    def __init__(self, store, controller=None,
                 threshold: float = None, min_abs_ms: float = None,
                 min_queries: int = None, breaches: int = None,
                 clears: int = None, exemplars: int = None,
                 ledger=None, alerts=None):
        self.store = store
        self.controller = controller
        self.ledger = PERF_LEDGER if ledger is None else ledger
        self.alerts = ALERTS if alerts is None else alerts
        self.threshold = float(os.environ.get(THRESHOLD_ENV, 0.25)) \
            if threshold is None else threshold
        self.min_abs_ms = float(os.environ.get(MIN_ABS_MS_ENV, 2.0)) \
            if min_abs_ms is None else min_abs_ms
        self.min_queries = int(os.environ.get(MIN_QUERIES_ENV, 5)) \
            if min_queries is None else min_queries
        self.breaches = int(os.environ.get(BREACHES_ENV, 2)) \
            if breaches is None else breaches
        self.clears = int(os.environ.get(CLEARS_ENV, 2)) \
            if clears is None else clears
        self.exemplars = int(os.environ.get(EXEMPLARS_ENV, 3)) \
            if exemplars is None else exemplars
        self._streak: dict[tuple, int] = {}
        self._ok: dict[tuple, int] = {}
        self._restored = False
        CONTROLLER_METRICS.set_gauge(
            ControllerGauge.PERF_ANOMALIES_ACTIVE,
            lambda: self.alerts.active_count)

    # -- periodic entry point ------------------------------------------------

    def __call__(self) -> dict:
        leader = getattr(self.controller, "leader", None)
        if leader is not None and not leader.is_leader:
            return {"skipped": "standby controller does not evaluate"}
        if not self._restored:
            # first leader scrape after boot: preload "normal" from the
            # WAL store so a restart doesn't start amnesiac
            self._restored = True
            self.ledger.restore(self.store)
        self._load_slo_overrides()
        report = self.evaluate()
        self.ledger.persist(self.store)
        self.store.set(SENTINEL_REPORT_PATH, report)
        return report

    def _load_slo_overrides(self) -> None:
        from .controller import raw_table_name

        for table in self.store.children("/CONFIGS/TABLE"):
            cfg = self.store.get(f"/CONFIGS/TABLE/{table}") or {}
            override = {dst: float(cfg[src])
                        for src, dst in _SLO_CFG_KEYS.items() if src in cfg}
            if override:
                # ledger tables are keyed by the raw parsed table name;
                # store config children carry the _OFFLINE/_REALTIME suffix
                self.ledger.set_slo_override(raw_table_name(table), override)

    # -- drift rules ---------------------------------------------------------

    def evaluate(self) -> dict:
        """One full evaluation pass: rotate aged windows, judge every rule,
        apply hysteresis, fire/resolve alerts, arm exemplars on NEW fires.
        Pure in-process — callable directly from tests and soaks."""
        self.ledger.maybe_rotate()
        breaching: dict[tuple, dict] = {}
        plans_judged = 0
        for key in self.ledger.keys():
            win = self.ledger.plan_windows(key)
            if win is None:
                continue
            cur, ref, ref_weight, table = win
            if ref_weight <= 0.0 or cur["queries"] < self.min_queries:
                continue
            plans_judged += 1
            self._judge_plan(key, table, cur, ref, ref_weight, breaching)
        self._judge_fallbacks(breaching)
        burn_report = self._judge_slo(breaching)
        anomalies = self._apply_hysteresis(breaching)
        return {
            "checkedAtMs": int(time.time() * 1000),
            "plansJudged": plans_judged,
            "anomalies": anomalies,
            "burnRates": burn_report,
            "alertsActive": self.alerts.active_count,
            # no committed benchmark round of the port to attach
            "benchBaseline": None,
            "thresholds": {"threshold": self.threshold,
                           "minAbsMs": self.min_abs_ms,
                           "minQueries": self.min_queries,
                           "breachesToFire": self.breaches,
                           "clearsToResolve": self.clears},
        }

    def _judge_plan(self, key: str, table: str, cur: dict, ref: dict,
                    ref_weight: float, breaching: dict) -> None:
        qn = cur["queries"]
        ref_q = ref["queries"] / ref_weight  # per-window averages
        if ref_q <= 0:
            return
        # latency-drift: the bench gate's p50 rule (ratio threshold + absolute
        # jitter floor) applied short-window vs decayed reference
        cur_p50 = bucket_quantile(cur["latBuckets"], 0.5)
        ref_p50 = bucket_quantile(ref["latBuckets"], 0.5)
        if ref_p50 > 0 and cur_p50 > ref_p50 * (1.0 + self.threshold) \
                and cur_p50 - ref_p50 >= self.min_abs_ms:
            breaching[("latency-drift", key)] = {
                "table": table,
                "summary": f"p50 {ref_p50:.1f}ms -> {cur_p50:.1f}ms "
                           f"({cur_p50 / ref_p50:.2f}x, threshold "
                           f"{1.0 + self.threshold:.2f}x)",
                "details": {"refP50Ms": round(ref_p50, 3),
                            "shortP50Ms": round(cur_p50, 3),
                            "shortQueries": qn}}
        # compile-storm: compiles per query vs the reference rate — a
        # recompiling family (AOT refuse-and-recompile loop, cache churn)
        cur_rate = cur["compiles"] / qn
        ref_rate = (ref["compiles"] / ref_weight) / ref_q
        if cur["compiles"] >= 2 \
                and cur_rate > ref_rate * (1.0 + self.threshold) + 0.01:
            breaching[("compile-storm", key)] = {
                "table": table,
                "summary": f"compiles/query {ref_rate:.3f} -> "
                           f"{cur_rate:.3f} ({cur['compiles']} compiles "
                           f"over {qn} queries)",
                "details": {"refCompilesPerQuery": round(ref_rate, 4),
                            "shortCompilesPerQuery": round(cur_rate, 4)}}
        # cache-collapse: a plan that used to hit the result cache stopped
        cur_lookups = cur["cacheHits"] + cur["cacheMisses"]
        ref_lookups = ref["cacheHits"] + ref["cacheMisses"]
        if cur_lookups >= self.min_queries and ref_lookups > 0:
            cur_hit = cur["cacheHits"] / cur_lookups
            ref_hit = ref["cacheHits"] / ref_lookups
            if ref_hit >= 0.2 and cur_hit < ref_hit / 2.0:
                breaching[("cache-collapse", key)] = {
                    "table": table,
                    "summary": f"result-cache hit rate {ref_hit:.0%} -> "
                               f"{cur_hit:.0%} over {cur_lookups} lookups",
                    "details": {"refHitRate": round(ref_hit, 4),
                                "shortHitRate": round(cur_hit, 4)}}
        # crossing-regression: device→host crossings per query rose (plan
        # property — the bench gate fails ANY increase; live windows get half
        # a crossing of slack for mixed traffic under one fingerprint)
        cur_x = cur["hostCrossings"] / qn
        ref_x = (ref["hostCrossings"] / ref_weight) / ref_q
        if ref["hostCrossings"] > 0 and cur_x > ref_x + 0.5:
            breaching[("crossing-regression", key)] = {
                "table": table,
                "summary": f"host crossings/query {ref_x:.2f} -> "
                           f"{cur_x:.2f} (fused plan losing residency)",
                "details": {"refCrossingsPerQuery": round(ref_x, 3),
                            "shortCrossingsPerQuery": round(cur_x, 3)}}

    def _judge_fallbacks(self, breaching: dict) -> None:
        cur, ref, ref_weight, _tot = self.ledger.events_windows()
        for kind, n in cur.items():
            ref_rate = ref.get(kind, 0.0) / max(ref_weight, 1.0)
            if n >= 3 and n > ref_rate * (1.0 + self.threshold) + 1.0:
                breaching[("fallback-surge", kind)] = {
                    "table": "",
                    "summary": f"{n} {kind} fallbacks this window "
                               f"(reference {ref_rate:.2f}/window)",
                    "details": {"kind": kind, "shortCount": n,
                                "refPerWindow": round(ref_rate, 3)}}

    def _judge_slo(self, breaching: dict) -> dict:
        burn_report = {}
        for table in self.ledger.tables():
            rates = self.ledger.burn_rates(table)
            if not rates:
                continue
            fast, slow = rates.get("fast", {}), rates.get("slow", {})
            burn_report[table] = {"fast": fast, "slow": slow}
            CONTROLLER_METRICS.set_gauge(
                f"sloBurnRate.{table}",
                lambda t=table: max(
                    (self.ledger.burn_rates(t).get("fast") or {}).get(
                        "latencyBurn", 0.0),
                    (self.ledger.burn_rates(t).get("fast") or {}).get(
                        "errorBurn", 0.0),
                    (self.ledger.burn_rates(t).get("fast") or {}).get(
                        "partialBurn", 0.0)))
            if fast.get("queries", 0) < self.min_queries:
                continue
            for kind, field in (("latency", "latencyBurn"),
                                ("error", "errorBurn"),
                                ("partial", "partialBurn")):
                fb, sb = fast.get(field, 0.0), slow.get(field, 0.0)
                # multiwindow rule: BOTH windows must burn above 1x
                if fb > 1.0 and sb > 1.0:
                    breaching[("slo-burn", f"{table}:{kind}")] = {
                        "table": table,
                        "summary": f"{kind} budget burning {fb:.1f}x "
                                   f"(fast) / {sb:.1f}x (slow) on "
                                   f"{table}",
                        "details": {"objective": kind,
                                    "fastBurn": round(fb, 3),
                                    "slowBurn": round(sb, 3),
                                    "slo": rates.get("slo", {})}}
        return burn_report

    # -- hysteresis + alert lifecycle ----------------------------------------

    def _apply_hysteresis(self, breaching: dict) -> list:
        anomalies = []
        for (typ, key), info in breaching.items():
            tk = (typ, key)
            self._streak[tk] = self._streak.get(tk, 0) + 1
            self._ok.pop(tk, None)
            anomalies.append({"type": typ, "key": key,
                              "table": info["table"],
                              "streak": self._streak[tk],
                              "summary": info["summary"]})
            if self._streak[tk] < self.breaches:
                continue  # hysteresis: one noisy window never fires
            aid, new = self.alerts.fire(typ, key, info["table"],
                                        info["summary"], info["details"])
            if new:
                # close the metrics→traces loop: force head-sampling for
                # the next N matching queries, pinned under this alert id
                if typ in ("slo-burn", "fallback-surge"):
                    self.ledger.arm_exemplars(aid, table=info["table"],
                                              count=self.exemplars)
                else:
                    self.ledger.arm_exemplars(aid, plan_key=key,
                                              count=self.exemplars)
        # clean evaluations resolve, also with hysteresis; an active alert
        # whose scope vanished (plan evicted, table idle) counts clean
        for rec in self.alerts.active():
            tk = (rec["type"], rec["key"])
            if tk in breaching:
                continue
            self._streak.pop(tk, None)
            self._ok[tk] = self._ok.get(tk, 0) + 1
            if self._ok[tk] >= self.clears:
                aid = self.alerts.resolve(rec["type"], rec["key"])
                if aid:
                    self.ledger.disarm_exemplars(aid)
                self._ok.pop(tk, None)
        # forget streaks for rules that stopped breaching before firing
        for tk in [t for t in self._streak
                   if t not in breaching
                   and not any(a["type"] == t[0] and a["key"] == t[1]
                               for a in self.alerts.active())]:
            del self._streak[tk]
        return anomalies
