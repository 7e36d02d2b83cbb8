"""StoragePrefetcher: leader-side, workload-driven warm-up nudges.

The port of pinot_tpu/storage/prefetch.py. Each call walks the broker
``/BROKERSTATE/*`` cost beacons (the WorkloadTracker's decaying per-table
query-cost rollups, cluster/workload.py), ranks tables by observed cost,
and writes a ``/PREFETCH/{table}`` nudge for the top-K hot tables. Servers
watch the prefix: a nudge marks the table hot in their SegmentTierManager
(pinning it against eviction for the hot TTL), background-warms its cold
segments while tier headroom remains and replays the table's AOT family
records, so a hot table is resident BEFORE the next query lands.

Nudges are written only when a table ENTERS the hot set (a membership
change), not every tick, so the property store is not churned under
steady load. The JAX package runs it on the leader's periodic scheduler;
the port has none yet (`cluster/periodic.py` is still to be ported), so
callers invoke it directly. The JAX package reads its defaults from
PINOT_TPU_PREFETCH_TOP_K and PINOT_TPU_PREFETCH_MIN_COST_MS; here they
are constructor arguments with the same defaults.
"""

from __future__ import annotations

import itertools
import time

PREFETCH_PREFIX = "/PREFETCH"


class StoragePrefetcher:
    def __init__(self, store, top_k: int = 3, min_cost_ms: float = 0.5):
        self.store = store
        self.top_k = int(top_k)
        self.min_cost_ms = float(min_cost_ms)
        self._nonce = itertools.count(1)
        self._last_hot: set = set()

    def _table_costs(self) -> dict:
        costs: dict[str, float] = {}
        try:
            brokers = self.store.children("/BROKERSTATE")
        except Exception:
            return costs
        for bid in brokers:
            state = self.store.get(f"/BROKERSTATE/{bid}") or {}
            for table, cost in (state.get("tableCostsMs") or {}).items():
                try:
                    c = float(cost)
                except (TypeError, ValueError):
                    continue
                costs[table] = max(costs.get(table, 0.0), c)
        return costs

    def __call__(self) -> dict:
        costs = self._table_costs()
        hot = sorted((t for t, c in costs.items() if c >= self.min_cost_ms),
                     key=lambda t: -costs[t])[:self.top_k]
        nudged = []
        for table in hot:
            if table in self._last_hot:
                continue
            self.store.set(f"{PREFETCH_PREFIX}/{table}", {
                "nonce": next(self._nonce),
                "costMs": round(costs[table], 3),
                "atMs": int(time.time() * 1000),
            })
            nudged.append(table)
        self._last_hot = set(hot)
        return {"hotTables": hot, "nudged": nudged,
                "tablesSeen": len(costs)}
