"""The port's perf ledger and alert book against the JAX package's.

Both packages' `PerfLedger` and `AlertBook` take the same sequence of
calls, made from a numpy seed: `record` over a few plans and tables,
`note_event`, clock advances past and within the window, `rotate_now` /
`maybe_rotate`, SLO overrides, exemplar arm / claim / disarm, and
`fire` / `resolve` / `note_exemplar`. Each module's `_mono` clock and
wall clock are frozen to one shared clock, so the window math and the
alert book's order are the same in both. After
every call the snapshots, burn rates, event windows, plan windows and
claims must be equal, with the wall-clock stamps masked (`firstSeen`,
`savedAtMs`, and the alert records' `firstFiredMs`, `lastUpdateMs`,
`clearedMs`). The persisted `/PERF/LEDGER` payloads are equal too, and
the JAX package's payload written into the port's property store restores
to the JAX package's snapshot. Tolerance: exact.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest

from pinot_tpu.cluster import PropertyStore as JaxStore
from pinot_tpu.engine import perf_ledger as jpl
from pinot_tpu_torch.cluster import PropertyStore
from pinot_tpu_torch.engine import perf_ledger as ppl

PLANS = ("fp:aaaa", "fp:bbbb", "sql:0000beef", "fp:cccc", "fp:dddd",
         "sql:12345678", "fp:eeee", "fp:ffff", "fp:0123", "fp:4567")
TABLES = ("t0", "t1", "t2")
EVENTS = ("device-join-host", "mesh-solo", "fused-host")
ALERT_TYPES = ("latency-drift", "slo-burn", "fallback-surge")
WALL = ("firstSeen", "savedAtMs", "firstFiredMs", "lastUpdateMs",
        "clearedMs", "checkedAtMs")


class _Clock:
    def __init__(self):
        self.t = 10_000.0

    def __call__(self):
        return self.t


@pytest.fixture
def clock(monkeypatch):
    """One frozen clock for both packages' window math and wall stamps:
    the alert book orders and evicts by its wall stamps, so both packages
    must see the same ties."""
    c = _Clock()
    for mod in (ppl, jpl):
        monkeypatch.setattr(mod, "_mono", c)
        monkeypatch.setattr(mod, "time", SimpleNamespace(time=c))
    return c


def _masked(obj):
    """`obj` with every wall-clock stamp replaced by a marker."""
    if isinstance(obj, dict):
        return {k: ("*" if k in WALL else _masked(v)) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_masked(v) for v in obj)
    return obj


def _ops(seed: int, n: int) -> list:
    """A call sequence: (name, args, kwargs) tuples."""
    rng = np.random.default_rng(seed)
    ops, alerts = [], 0
    for _ in range(n):
        r = rng.random()
        if r < 0.55:
            ops.append(("record", (PLANS[int(rng.integers(len(PLANS)))],), {
                "table": TABLES[int(rng.integers(len(TABLES)))],
                "time_ms": float(np.exp(rng.normal(2.0, 1.5))),
                "error": bool(rng.random() < 0.05),
                "partial": bool(rng.random() < 0.05),
                "dispatches": int(rng.integers(0, 5)),
                "compiles": int(rng.random() < 0.1),
                "cache_outcome": ("", "hit", "miss", "bypass")[
                    int(rng.integers(4))],
                "seg_cache_hits": int(rng.integers(0, 3)),
                "seg_cache_misses": int(rng.integers(0, 3)),
                "coalesced": int(rng.integers(0, 2)),
                "host_crossings": int(rng.integers(0, 3)),
                "bytes_shuffled": int(rng.integers(0, 1 << 20)),
                "sql": "SELECT " + "x" * int(rng.integers(0, 200))}))
        elif r < 0.62:
            ops.append(("note_event", (EVENTS[int(rng.integers(3))],), {}))
        elif r < 0.72:
            ops.append(("advance", (float(rng.choice([0.5, 7.0, 45.0,
                                                      130.0])),), {}))
        elif r < 0.75:
            ops.append(("rotate_now", (), {}))
        elif r < 0.78:
            ops.append(("maybe_rotate", (), {}))
        elif r < 0.80:
            ops.append(("set_slo_override",
                        (TABLES[int(rng.integers(3))],
                         {"latencyMs": float(rng.choice([5.0, 50.0])),
                          "errorRate": 0.02}), {}))
        elif r < 0.84:
            alerts += 1
            kw = ({"plan_key": PLANS[int(rng.integers(len(PLANS)))]}
                  if rng.random() < 0.5 else
                  {"table": TABLES[int(rng.integers(3))]})
            ops.append(("arm_exemplars", (f"a-{alerts}",),
                        dict(kw, count=int(rng.integers(1, 4)))))
        elif r < 0.90:
            ops.append(("claim_exemplar",
                        (PLANS[int(rng.integers(len(PLANS)))],
                         TABLES[int(rng.integers(3))]), {}))
        elif r < 0.92:
            ops.append(("disarm_exemplars",
                        (f"a-{int(rng.integers(1, alerts + 2))}"
                         if rng.random() < 0.7 else "",), {}))
        elif r < 0.96:
            typ = ALERT_TYPES[int(rng.integers(3))]
            ops.append(("fire", (typ, PLANS[int(rng.integers(4))],
                                 TABLES[int(rng.integers(3))],
                                 f"summary {int(rng.integers(99))}",
                                 {"n": int(rng.integers(9))}), {}))
        elif r < 0.98:
            ops.append(("resolve", (ALERT_TYPES[int(rng.integers(3))],
                                    PLANS[int(rng.integers(4))]), {}))
        else:
            ops.append(("note_exemplar",
                        (f"{ALERT_TYPES[int(rng.integers(3))]}-"
                         f"{int(rng.integers(1, 6)):04d}",
                         f"trace{int(rng.integers(20))}"), {}))
    return ops


def _apply(ledger, book, clock, op):
    name, args, kwargs = op
    if name == "advance":
        clock.t += args[0]
        return None
    if name in ("fire", "resolve", "note_exemplar"):
        return getattr(book, name)(*args, **kwargs)
    return getattr(ledger, name)(*args, **kwargs)


def _state(ledger, book) -> dict:
    return _masked({
        "snapshot": ledger.snapshot(),
        "burn": {t: ledger.burn_rates(t) for t in TABLES},
        "events": ledger.events_windows(),
        "windows": {k: ledger.plan_windows(k) for k in PLANS},
        "keys": ledger.keys(), "tables": ledger.tables(),
        "armed": ledger.exemplar_armed, "len": len(ledger),
        "alerts": book.snapshot(), "active": book.active(),
        "activeCount": book.active_count,
        "pinned": book.exemplars_pinned(),
        "crosslink": {(k, t): book.active_ids_for(k, t)
                      for k in PLANS[:4] for t in TABLES}})


@pytest.mark.parametrize("seed,max_plans", [(1, 64), (2, 6), (3, 4),
                                            (4, 512)])
def test_ledger_and_alert_book_equal_jax(clock, seed, max_plans):
    port = (ppl.PerfLedger(window_s=60.0, max_plans=max_plans,
                           ref_decay=0.8), ppl.AlertBook(max_history=6))
    ref = (jpl.PerfLedger(window_s=60.0, max_plans=max_plans,
                          ref_decay=0.8), jpl.AlertBook(max_history=6))
    for op in _ops(seed, 400):
        t0 = clock.t
        got = _apply(*port, clock, op)
        clock.t = t0
        want = _apply(*ref, clock, op)
        assert _masked(got) == _masked(want), op
        assert _state(*port) == _state(*ref), op
    assert len(port[0]) <= max_plans


@pytest.mark.parametrize("buckets", [{}, {3: 5}, {-2: 1.5, 4: 2.25, 9: 0.5},
                                     {0: 90, 26: 10}])
@pytest.mark.parametrize("q", [0.0, 0.5, 0.99, 1.0])
def test_bucket_quantile_equals_jax(buckets, q):
    assert ppl.bucket_quantile(buckets, q) == jpl.bucket_quantile(buckets, q)
    for ms in (-1.0, 0.0, 0.3, 1.0, 47.0, 9000.0):
        assert ppl._bucket_index(ms) == jpl._bucket_index(ms)


def _fed(mod, clock, seed: int = 5):
    ledger = mod.PerfLedger(window_s=60.0, max_plans=64, ref_decay=0.8)
    book = mod.AlertBook()
    for op in _ops(seed, 300):
        _apply(ledger, book, clock, op)
    ledger.rotate_now()
    return ledger


def test_persisted_payloads_equal_jax(clock):
    t0 = clock.t
    port = _fed(ppl, clock)
    clock.t = t0
    ref = _fed(jpl, clock)
    pstore, jstore = PropertyStore(), JaxStore()
    port.persist(pstore)
    ref.persist(jstore)
    got, want = pstore.get(ppl.LEDGER_PATH), jstore.get(jpl.LEDGER_PATH)
    assert got["plans"] and _masked(got) == _masked(want)
    assert ppl.LEDGER_PATH == jpl.LEDGER_PATH == "/PERF/LEDGER"


def test_jax_payload_restores_into_the_port(clock):
    """State carried across: the JAX package's persisted /PERF/LEDGER
    written into the port's store restores to the JAX package's own
    restored snapshot; live plans win over restored ones in both."""
    ref = _fed(jpl, clock)
    jstore = JaxStore()
    ref.persist(jstore)
    pstore = PropertyStore()
    pstore.set(ppl.LEDGER_PATH, jstore.get(jpl.LEDGER_PATH))
    port_fresh = ppl.PerfLedger(window_s=60.0, max_plans=64, ref_decay=0.8)
    ref_fresh = jpl.PerfLedger(window_s=60.0, max_plans=64, ref_decay=0.8)
    for ledger in (port_fresh, ref_fresh):
        ledger.record(PLANS[0], table="t0", time_ms=3.0)  # live wins
    n = port_fresh.restore(pstore)
    assert n == ref_fresh.restore(jstore) and n >= 1
    assert _masked(port_fresh.snapshot()) == _masked(ref_fresh.snapshot())
    # restored plans keep the persisted firstSeen: unmasked equality
    restored = {p["fingerprint"]: p for p in port_fresh.snapshot()["plans"]}
    for p in ref_fresh.snapshot()["plans"]:
        if p["fingerprint"] != PLANS[0]:
            assert restored[p["fingerprint"]] == p
    for key in PLANS[1:]:
        assert port_fresh.plan_windows(key) == ref_fresh.plan_windows(key)
    assert port_fresh.events_windows() == ref_fresh.events_windows()


def test_restore_refuses_foreign_payloads():
    store = PropertyStore()
    ledger = ppl.PerfLedger()
    assert ledger.restore(store) == 0
    store.set(ppl.LEDGER_PATH, {"version": 2, "plans": {}})
    assert ledger.restore(store) == 0
    store.set(ppl.LEDGER_PATH, ["not", "a", "dict"])
    assert ledger.restore(store) == 0


def test_clear_resets_both():
    ledger, book = ppl.PerfLedger(), ppl.AlertBook()
    ledger.record("k", table="t", time_ms=1.0)
    ledger.arm_exemplars("a", plan_key="k")
    book.fire("latency-drift", "k", "t", "s")
    ledger.clear()
    book.clear()
    assert len(ledger) == 0 and not ledger.exemplar_armed
    assert book.active_count == 0 and book.snapshot()["alerts"] == []
