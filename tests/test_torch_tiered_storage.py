"""Tiered storage on the port's servers against the JAX package's.

The port's `storage/tier.py` (the byte-budgeted local tier),
`storage/prefetch.py` (the StoragePrefetcher) and the tiered paths of
`cluster/server.py` (cold registration, the first query's lazy warm,
eviction to cold, the ``storage.fetch`` fault's corrupt -> quarantine ->
fresh-repair contract, the /REPAIRS/ nudge, the /PREFETCH/ nudge and the
MSE leaf's warm) run beside a JAX cluster (`ServerInstance(backend=
"host")`, as its own tests run it) over the same tarred segments, built
once by the port's builder from a numpy seed. Each cluster case holds the
port's rows, its cold / resident inventory, its meter deltas and its
disk bound against the JAX cluster's outcome under the same fault
schedule; the tier's unit cases run the same calls on both packages'
managers and compare every step. The port's device side is held on the
CPU too: a demoted segment leaves nothing in its server's device cache,
and a segment fetched again gets a new view.

Ported from `tests/test_tiered_storage.py` and the repair cases of
`tests/test_data_integrity.py`; the soak smoke stays with
`tools/soak.py` (not ported). Every wait is bounded. Tolerance: exact.
"""

from __future__ import annotations

import os
import tarfile
import time
from types import SimpleNamespace

import numpy as np
import pytest

import pinot_tpu.cluster as jcl
from pinot_tpu.engine import perf_ledger as _jax_perf_ledger
from pinot_tpu.segment import loader as jloader
from pinot_tpu.spi import faults as jfaults
from pinot_tpu.spi.metrics import SERVER_METRICS as JSM
from pinot_tpu.spi.metrics import ServerMeter as JSMeter
from pinot_tpu.storage import tier as jtier
from pinot_tpu.storage.prefetch import StoragePrefetcher as JaxPrefetcher
from pinot_tpu_torch import cluster as pcl
from pinot_tpu_torch.engine import perf_ledger as _port_perf_ledger
from pinot_tpu_torch.segment import loader as ploader
from pinot_tpu_torch.segment.builder import SegmentBuilder
from pinot_tpu_torch.spi import faults as pfaults
from pinot_tpu_torch.spi.data_types import Schema
from pinot_tpu_torch.spi.metrics import SERVER_METRICS as PSM
from pinot_tpu_torch.spi.metrics import ServerMeter as PSMeter
from pinot_tpu_torch.storage import tier as ptier
from pinot_tpu_torch.storage.prefetch import StoragePrefetcher

TEAMS = ["BOS", "NYA", "SFN", "LAN"]
GROUP_SQL = "SELECT team, SUM(runs) FROM {t} GROUP BY team ORDER BY team"
NOCACHE = "SET resultCache=false; "
ST = "stats_OFFLINE"
FL = "filler_OFFLINE"

PORT = SimpleNamespace(name="port", cl=pcl, faults=pfaults, metrics=PSM,
                       meter=PSMeter, tier=ptier, loader=ploader,
                       prefetcher=StoragePrefetcher,
                       server_kw={"device": "cpu"})
JAX = SimpleNamespace(name="jax", cl=jcl, faults=jfaults, metrics=JSM,
                      meter=JSMeter, tier=jtier, loader=jloader,
                      prefetcher=JaxPrefetcher,
                      server_kw={"backend": "host"})
BOTH = (PORT, JAX)


@pytest.fixture(scope="module", autouse=True)
def _no_ledger_left_behind():
    yield
    for mod in (_jax_perf_ledger, _port_perf_ledger):
        mod.PERF_LEDGER.clear()
        mod.ALERTS.clear()


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("PINOT_TPU_SEGMENT_CACHE", "0")
    monkeypatch.setenv("PINOT_TPU_RESULT_CACHE", "0")
    monkeypatch.setenv("PINOT_TPU_FUSED", "interpret")
    yield
    pfaults.FAULTS.reset()
    jfaults.FAULTS.reset()


def _schema(table: str) -> Schema:
    return Schema.build(table,
                        dimensions=[("team", "STRING"), ("year", "INT")],
                        metrics=[("runs", "INT")])


def _walk_bytes(path) -> int:
    return sum(os.stat(os.path.join(root, f)).st_size
               for root, _dirs, files in os.walk(path) for f in files)


def _build_tar(root, table: str, name: str, seed: int, n: int = 250):
    """One segment directory and its tarball: (tar, dir bytes, columns)."""
    rng = np.random.default_rng(seed)
    cols = {
        "team": np.asarray(TEAMS, dtype=object)[rng.integers(0, 4, n)],
        "year": rng.integers(2000, 2010, n).astype(np.int32),
        "runs": rng.integers(0, 100, n).astype(np.int32),
    }
    local = root / table / name
    SegmentBuilder(_schema(table), None, name).build(cols, local)
    tar = root / table / f"{name}.tar.gz"
    with tarfile.open(tar, "w:gz") as tf:
        tf.add(local, arcname=name)
    return str(tar), _walk_bytes(local), cols


@pytest.fixture(scope="module")
def tars(tmp_path_factory):
    """Two tables of tarred segments: stats s0..s1, filler f0..f1."""
    root = tmp_path_factory.mktemp("tier_segs")
    return {
        "stats": [(f"s{i}",) + _build_tar(root, "stats", f"s{i}", seed=i)
                  for i in range(2)],
        "filler": [(f"f{i}",) + _build_tar(root, "filler", f"f{i}",
                                           seed=100 + i)
                   for i in range(2)],
    }


def _team_sums(cols_list) -> list:
    agg: dict = {}
    for cols in cols_list:
        for team, runs in zip(cols["team"], cols["runs"]):
            agg[team] = agg.get(team, 0) + int(runs)
    return [(t, agg[t]) for t in sorted(agg)]


def _rows(resp) -> list:
    return [(r[0], int(r[1])) for r in resp.result_table.rows]


def _full(resp) -> bool:
    return not resp.exceptions and not resp.partial_result


def _wait(cond, timeout=15.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {msg}")


def _inventory(server, table) -> tuple:
    t = server.debug_storage()["tables"].get(table, {})
    return tuple(t.get("resident", [])), tuple(t.get("cold", []))


def _meter(pkg, name) -> int:
    return pkg.metrics.meter_count(getattr(pkg.meter, name))


def _cold_cluster(pkg, tars, stats_segs=2, filler_segs=2, extra=0.5,
                  **server_kw):
    """One server whose budget fits `stats` plus `extra` segment widths of
    slack: `stats` registers first (resident), then `filler`, whose loads
    evict the now-LRU stats entries. End state: every stats segment cold
    (still advertised ONLINE), filler resident."""
    stats = tars["stats"][:stats_segs]
    filler = tars["filler"][:filler_segs]
    max_seg = max(b for _, _, b, _ in stats + filler)
    budget = sum(b for _, _, b, _ in stats) + int(extra * max_seg)
    store = pkg.cl.PropertyStore()
    ctl = pkg.cl.ClusterController(store)
    server = pkg.cl.ServerInstance(store, "S0", **pkg.server_kw,
                                   local_storage_mb=budget / (1024 * 1024),
                                   **server_kw)
    server.start()
    broker = pkg.cl.Broker(store)
    for t in ("stats", "filler"):
        ctl.add_schema(_schema(t).to_json())
    h_stats = ctl.create_table({"tableName": "stats", "replication": 1})
    h_filler = ctl.create_table({"tableName": "filler", "replication": 1})
    for name, tar, _, _ in stats:
        ctl.add_segment(h_stats, name, {"location": tar, "numDocs": 250})
    names = tuple(n for n, *_ in stats)
    _wait(lambda: _inventory(server, ST)[0] == names, msg="stats resident")
    for name, tar, _, _ in filler:
        ctl.add_segment(h_filler, name, {"location": tar, "numDocs": 250})
    fnames = tuple(n for n, *_ in filler)
    _wait(lambda: _inventory(server, ST)[1] == names
          and _inventory(server, FL)[0] == fnames, msg="stats demoted cold")
    return SimpleNamespace(
        store=store, ctl=ctl, server=server, broker=broker,
        stats_names=list(names), filler_names=list(fnames),
        want_stats=_team_sums([c for *_, c in stats]),
        want_filler=_team_sums([c for *_, c in filler]),
        budget=budget, max_seg=max_seg)


def _close(c) -> None:
    c.server.stop()
    if hasattr(c.broker, "close"):
        c.broker.close()


def _both(tars, body, **kw) -> dict:
    """Run `body(pkg, cluster)` on a fresh cluster of each package;
    returns {package name: body's outcome}."""
    out = {}
    for pkg in BOTH:
        c = _cold_cluster(pkg, tars, **kw)
        try:
            out[pkg.name] = body(pkg, c)
        finally:
            _close(c)
    return out


def _port_cache_names(server) -> set:
    return server.executor.executor.cache.segment_names()


# -- cluster: cold registration, lazy warm, evict / fetch again --------------


def test_cold_replica_routes_and_first_query_warms(tars):
    def body(pkg, c):
        view = c.store.get(f"/EXTERNALVIEW/{ST}") or {}
        dbg = c.server.debug_storage()
        before = (sorted(view), {s: view[s].get("S0") for s in view},
                  dbg["coldSegments"], dbg["residentSegments"],
                  sorted(dbg["warming"]))
        if pkg is PORT:
            # the demoted stats segments left nothing on the device
            assert not _port_cache_names(c.server) & set(c.stats_names)
        cold0 = _meter(pkg, "SEGMENT_COLD_LOADS")
        evict0 = _meter(pkg, "SEGMENT_EVICTIONS")
        verify0 = pkg.loader.VERIFY_CALLS
        resp = c.broker.execute_sql(NOCACHE + GROUP_SQL.format(t="stats"))
        assert _full(resp), resp.exceptions
        st = c.server._tier.stats()
        assert st["bytesUsed"] <= c.budget + c.max_seg
        return {"before": before, "rows": _rows(resp),
                "exact": _rows(resp) == c.want_stats,
                "cold_loads": _meter(pkg, "SEGMENT_COLD_LOADS") - cold0,
                "evictions": _meter(pkg, "SEGMENT_EVICTIONS") - evict0,
                "verified": pkg.loader.VERIFY_CALLS - verify0 >= 2,
                "resident": [c.server._tier.resident(ST, s)
                             for s in c.stats_names],
                "after": (_inventory(c.server, ST), _inventory(c.server, FL))}

    out = _both(tars, body)
    assert out["port"] == out["jax"]
    assert out["port"]["exact"] and out["port"]["cold_loads"] >= 2
    assert out["port"]["evictions"] >= 2
    assert out["port"]["before"][2:4] == (2, 2)


def test_evict_refetch_ping_pong_stays_exact(tars):
    """Alternating strict queries over two tables that cannot both fit:
    every round fetches evicted segments again and stays exact; on the
    port each fetch again gets a new device view (fresh planes)."""
    def body(pkg, c):
        evict0 = _meter(pkg, "SEGMENT_EVICTIONS")
        rows, fresh_views = [], []
        for _round in range(2):
            for table, want in (("stats", c.want_stats),
                                ("filler", c.want_filler)):
                if pkg is PORT and table == "stats":
                    # held, so no new view can reuse an old one's id
                    seen = list(c.server.executor.executor
                                .cache._views.values())
                resp = c.broker.execute_sql(NOCACHE + GROUP_SQL.format(t=table))
                assert _full(resp), (table, resp.exceptions)
                rows.append(_rows(resp) == want)
                if pkg is PORT and table == "stats":
                    views = c.server.executor.executor.cache._views.values()
                    stats_views = [v for v in views
                                   if v.segment.name in c.stats_names]
                    fresh_views.append(len(stats_views) == 2 and not any(
                        v is old for v in stats_views for old in seen))
        assert c.server._tier.stats()["bytesUsed"] <= c.budget + c.max_seg
        if pkg is PORT:
            assert all(fresh_views), fresh_views
        return {"exact": rows,
                "evictions": _meter(pkg, "SEGMENT_EVICTIONS") - evict0}

    out = _both(tars, body)
    assert out["port"] == out["jax"]
    assert all(out["port"]["exact"]) and out["port"]["evictions"] >= 4


def test_warm_resident_path_makes_zero_disk_probes(tars):
    """Once a table is resident, repeat queries touch the tier in memory
    only: TIER_PROBES and the loader's verifications do not move."""
    out = {}
    for pkg in BOTH:
        store = pkg.cl.PropertyStore()
        ctl = pkg.cl.ClusterController(store)
        server = pkg.cl.ServerInstance(store, "S0", **pkg.server_kw,
                                       local_storage_mb=100.0)
        server.start()
        broker = pkg.cl.Broker(store)
        ctl.add_schema(_schema("stats").to_json())
        h = ctl.create_table({"tableName": "stats", "replication": 1})
        for name, tar, _, _ in tars["stats"]:
            ctl.add_segment(h, name, {"location": tar, "numDocs": 250})
        want = _team_sums([c for *_, c in tars["stats"]])
        try:
            sql = NOCACHE + GROUP_SQL.format(t="stats")
            resp = broker.execute_sql(sql)
            assert _full(resp) and _rows(resp) == want
            probes0 = pkg.tier.TIER_PROBES
            verify0 = pkg.loader.VERIFY_CALLS
            for _ in range(3):
                resp = broker.execute_sql(sql)
                assert _full(resp) and _rows(resp) == want
            out[pkg.name] = (pkg.tier.TIER_PROBES - probes0,
                             pkg.loader.VERIFY_CALLS - verify0)
        finally:
            server.stop()
    assert out["port"] == out["jax"] == (0, 0)


# -- cluster: the storage.fetch fault point ----------------------------------


def test_cold_fetch_corruption_quarantines_then_repairs(tars):
    """A corrupt cold fetch quarantines the replica (never served), the
    automatic repair fetches a FRESH copy, and the next strict query is
    exact; converge loads, the cold warm and the repair all went through
    the one tier."""
    def body(pkg, c):
        q0 = _meter(pkg, "SEGMENTS_QUARANTINED")
        r0 = _meter(pkg, "SEGMENT_REPAIRS")
        pkg.faults.FAULTS.arm("storage.fetch", kind="corrupt", times=1)
        # the first touch races quarantine + repair: it may degrade, it
        # never lies
        resp = c.broker.execute_sql("SET allowPartialResults=true; "
                                    + NOCACHE + GROUP_SQL.format(t="stats"))
        first_exact = _rows(resp) == c.want_stats if _full(resp) else None
        assert first_exact in (None, True)
        fired = pkg.faults.FAULTS.fired("storage.fetch")
        _wait(lambda: _meter(pkg, "SEGMENTS_QUARANTINED") > q0,
              msg="quarantine")
        _wait(lambda: list(_inventory(c.server, ST)[0]) == c.stats_names,
              msg="repair fetched again")
        resp = c.broker.execute_sql(NOCACHE + GROUP_SQL.format(t="stats"))
        assert _full(resp), resp.exceptions
        return {"fired": fired,
                "quarantined": _meter(pkg, "SEGMENTS_QUARANTINED") - q0,
                "repaired": _meter(pkg, "SEGMENT_REPAIRS") - r0 >= 1,
                "exact": _rows(resp) == c.want_stats,
                "fetches": c.server._tier.stats()["fetches"] >= 4}

    out = _both(tars, body, stats_segs=1, filler_segs=1)
    assert out["port"] == out["jax"]
    assert out["port"] == {"fired": 1, "quarantined": 1, "repaired": True,
                           "exact": True, "fetches": True}


def test_delayed_cold_fetch_degrades_and_partial_is_never_cached(
        tars, monkeypatch):
    """A slow deep store under a tight timeoutMs answers a FLAGGED partial
    (coldSegmentsWarming), and the result cache does not keep it: the same
    query again returns the full exact rows."""
    monkeypatch.setenv("PINOT_TPU_RESULT_CACHE", "1")

    def body(pkg, c):
        pkg.faults.FAULTS.arm("storage.fetch", kind="delay", times=1,
                              delay_s=0.6)
        sql = ("SET allowPartialResults=true; SET timeoutMs=150; "
               + GROUP_SQL.format(t="stats"))
        resp = c.broker.execute_sql(sql)
        first = (resp.partial_result, resp.cold_segments_warming >= 1,
                 resp.to_json().get("coldSegmentsWarming", 0) >= 1)
        _wait(lambda: list(_inventory(c.server, ST)[0]) == c.stats_names,
              msg="background warm finishing")
        resp = c.broker.execute_sql(sql)
        return {"first": first, "full": _full(resp),
                "exact": _rows(resp) == c.want_stats}

    out = _both(tars, body, stats_segs=1, filler_segs=1)
    assert out["port"] == out["jax"]
    assert out["port"] == {"first": (True, True, True), "full": True,
                           "exact": True}


# -- cluster: workload-driven prefetch ---------------------------------------


def test_prefetcher_nudges_hot_table_warm(tars):
    """A /BROKERSTATE beacon ranks `stats` hot; the prefetcher's nudge
    makes the server mark it hot and warm it before any query lands, and
    a second tick with the same beacons is silent."""
    def body(pkg, c):
        hits0 = _meter(pkg, "PREFETCH_HITS")
        c.store.set("/BROKERSTATE/Broker_pf",
                    {"tableCostsMs": {"stats": 42.0}})
        pf = pkg.prefetcher(c.store)
        first = pf()
        _wait(lambda: list(_inventory(c.server, ST)[0]) == c.stats_names,
              msg="prefetch warm")
        _wait(lambda: _meter(pkg, "PREFETCH_HITS") > hits0,
              msg="prefetch hit meter")
        second = pf()
        resp = c.broker.execute_sql(NOCACHE + GROUP_SQL.format(t="stats"))
        return {"first": (first["hotTables"], first["nudged"],
                          first["tablesSeen"]),
                "nudge": c.store.get("/PREFETCH/stats") is not None,
                "hot": "stats" in c.server._tier.stats()["hotTables"],
                "second": second["nudged"],
                "exact": _full(resp) and _rows(resp) == c.want_stats}

    out = _both(tars, body, stats_segs=1, filler_segs=1)
    assert out["port"] == out["jax"]
    assert out["port"]["first"][1] == ["stats"] and out["port"]["exact"]


def test_broker_beacon_feeds_the_prefetcher(tars):
    """The port broker's own beacon (publish_state) carries the table's
    decayed cost, which the prefetcher ranks hot."""
    c = _cold_cluster(PORT, tars, stats_segs=1, filler_segs=1)
    try:
        resp = c.broker.execute_sql(NOCACHE + GROUP_SQL.format(t="filler"))
        assert _full(resp)
        state = c.broker.publish_state()
        assert state["tableCostsMs"]["filler"] > 0
        assert c.store.get(f"/BROKERSTATE/{c.broker.broker_id}") == state
        out = StoragePrefetcher(c.store, min_cost_ms=0.0)()
        assert out["nudged"] == ["filler"]
        assert "filler" in c.server._tier.stats()["hotTables"]
    finally:
        _close(c)


# -- cluster: repair through /REPAIRS/ and the unrepairable flag -------------


def test_repair_nudge_and_unrepairable_flag(tars, monkeypatch):
    """With automatic repair off, a corrupt load stays quarantined; a
    repair whose every fresh copy fails verification flags the replica
    unrepairable after its bounded attempts; a /REPAIRS/ nudge clears the
    flag and repairs it, and the segment is served exactly again."""
    out = {}
    for pkg in BOTH:
        store = pkg.cl.PropertyStore()
        ctl = pkg.cl.ClusterController(store)
        if pkg is PORT:
            server = pkg.cl.ServerInstance(store, "S0", **pkg.server_kw,
                                           local_storage_mb=100.0,
                                           auto_repair=False)
        else:
            # the JAX server reads these at repair time
            monkeypatch.setenv("PINOT_TPU_AUTO_REPAIR", "false")
            monkeypatch.setenv("PINOT_TPU_REPAIR_BACKOFF_MS", "1")
            server = pkg.cl.ServerInstance(store, "S0", **pkg.server_kw,
                                           local_storage_mb=100.0)
        server.start()
        broker = pkg.cl.Broker(store)
        try:
            ctl.add_schema(_schema("stats").to_json())
            h = ctl.create_table({"tableName": "stats", "replication": 1})
            pkg.faults.FAULTS.arm("segment.load", kind="corrupt", times=1)
            for name, tar, _, _ in tars["stats"]:
                ctl.add_segment(h, name, {"location": tar, "numDocs": 250})
            pkg.faults.FAULTS.reset()
            bad = sorted(server.debug_segments()[ST]["quarantined"])
            view = store.get(f"/EXTERNALVIEW/{ST}")
            state = {s: view[s]["S0"] for s in sorted(view)}
            pkg.faults.FAULTS.arm("segment.load", kind="corrupt", times=None,
                                  probability=1.0, seed=7)
            repaired = server.repair_segment(ST, bad[0])
            entry = server.debug_segments()[ST]["quarantined"][bad[0]]
            pkg.faults.FAULTS.reset()
            r0 = _meter(pkg, "SEGMENT_REPAIRS")
            store.set(f"/REPAIRS/{ST}/{bad[0]}", {"nudge": 1})
            after = server.debug_segments()[ST]
            resp = broker.execute_sql(NOCACHE + GROUP_SQL.format(t="stats"))
            out[pkg.name] = {
                "bad": bad, "view": state, "repaired": repaired,
                "unrepairable": entry["unrepairable"],
                "attempts": entry["repairAttempts"],
                "nudged": (_meter(pkg, "SEGMENT_REPAIRS") - r0,
                           after["quarantined"], after["served"]),
                "exact": _full(resp) and _rows(resp) == _team_sums(
                    [c for *_, c in tars["stats"]])}
        finally:
            server.stop()
    assert out["port"] == out["jax"]
    assert out["port"]["unrepairable"] is True
    assert out["port"]["attempts"] == 3 and out["port"]["exact"]
    assert out["port"]["view"][out["port"]["bad"][0]] == "ERROR"


# -- cluster: the MSE leaf over a cold segment -------------------------------


def test_mse_leaf_warms_a_cold_segment(tars):
    """A multi-stage statement whose leaf is routed the cold stats
    segments warms them within the stage deadline and answers exactly."""
    sql = ("SET useMultistageEngine = true; SELECT team, SUM(runs) FROM "
           "stats GROUP BY team ORDER BY team")

    def body(pkg, c):
        cold0 = _meter(pkg, "SEGMENT_COLD_LOADS")
        resp = c.broker.execute_sql(sql)
        assert not resp.exceptions, resp.exceptions
        return {"rows": _rows(resp),
                "cold_loads": _meter(pkg, "SEGMENT_COLD_LOADS") - cold0,
                "resident": _inventory(c.server, ST)[0]}

    out = _both(tars, body)
    assert out["port"] == out["jax"]
    assert out["port"]["cold_loads"] == 2


# -- tier unit: refcounts, budget and pins, on both managers -----------------


def _unit_tiers(name, nbytes, factor):
    return [(pkg, pkg.tier.SegmentTierManager(
        f"{name}_{pkg.name}", budget_mb=factor * nbytes / (1024 * 1024)))
        for pkg in BOTH]


def test_tier_hold_and_zombie_refcounts(tars):
    """acquire(hold=True) protects the fetch -> load window; a fresh
    fetch retires the old copy as a zombie that survives until its
    readers drain."""
    _, tar_a, nbytes, _ = tars["stats"][0]
    out = {}
    for pkg, tier in _unit_tiers("unit0", nbytes, 1.5):
        steps = []
        try:
            path1 = tier.acquire("t", "a", tar_a, hold=True)
            steps.append(os.path.isdir(path1))
            tier.release("t", "a")
            steps.append(tier.resident("t", "a"))
            handles = tier.pin("t", ["a"])
            steps.append(len(handles))
            path2 = tier.acquire("t", "a", tar_a, fresh=True, hold=True)
            steps.append((path2 != path1, os.path.isdir(path1),
                          os.path.isdir(path2)))
            st = tier.stats()
            steps.append((st["pendingRelease"], st["bytesUsed"] == nbytes,
                          st["pendingReleaseBytes"] == nbytes))
            tier.release("t", "a")
            steps.append((tier.resident("t", "a"), os.path.isdir(path1)))
            tier.unpin(handles)
            steps.append((os.path.isdir(path1),
                          tier.stats()["pendingRelease"]))
            tier.release("t", "a")  # no ref left: a no-op
            steps.append(tier.resident("t", "a"))
        finally:
            tier.close()
        out[pkg.name] = steps
    assert out["port"] == out["jax"]
    assert out["port"][4] == (1, True, True) and out["port"][6] == (False, 0)


def test_tier_budget_smaller_than_one_segment_still_loads(tars):
    """The held load ref turns a budget below one segment into single-slot
    churn, not a self-eviction of the copy being loaded."""
    _, tar_a, nbytes, _ = tars["stats"][0]
    _, tar_b, _, _ = tars["stats"][1]
    out = {}
    for pkg, tier in _unit_tiers("unit1", nbytes, 0.5):
        evicted = []
        tier.evict_cb = lambda table, seg: evicted.append((table, seg))
        try:
            path_a = tier.acquire("t", "a", tar_a, hold=True)
            steps = [os.path.isdir(path_a)]
            tier.release("t", "a")
            steps.append(tier.resident("t", "a"))
            path_b = tier.acquire("t", "b", tar_b, hold=True)
            steps.append((os.path.isdir(path_b), tier.resident("t", "a")))
            tier.release("t", "b")
            steps.append((list(evicted), tier.stats()["residentDirs"]))
        finally:
            tier.close()
        out[pkg.name] = steps
    assert out["port"] == out["jax"]
    assert out["port"] == [True, True, (True, False), ([("t", "a")], 1)]


def test_tier_pinned_table_survives_pressure(tars):
    """A pinned table is evicted only as a last resort: under repeated
    byte pressure the victims are the cool tables."""
    (_, tar_a, nbytes, _), (_, tar_b, _, _) = tars["stats"]
    _, tar_c, _, _ = tars["filler"][0]
    out = {}
    for pkg, tier in _unit_tiers("unit2", nbytes, 2.5):
        steps = []
        try:
            for table, seg, tar in (("A", "a", tar_a), ("B", "b", tar_b)):
                tier.acquire(table, seg, tar, hold=True)
                tier.release(table, seg)
                if table == "A":
                    tier.pin_table("A")
            steps.append(tier.stats()["evictions"])
            tier.acquire("C", "c", tar_c, hold=True)
            tier.release("C", "c")
            steps.append((tier.resident("A", "a"), tier.resident("B", "b")))
            tier.acquire("B", "b", tar_b, hold=True)
            tier.release("B", "b")
            steps.append((tier.resident("A", "a"), tier.resident("C", "c"),
                          tier.stats()["evictions"],
                          tier.stats()["pinnedTables"]))
            tier.unpin_table("A")
            steps.append(tier.stats()["pinnedTables"])
        finally:
            tier.close()
        out[pkg.name] = steps
    assert out["port"] == out["jax"]
    assert out["port"] == [0, (True, False), (True, False, 2, ["A"]), []]


def test_tier_hot_table_expires_on_the_clock(tars):
    """A prefetch nudge's heat lasts the hot TTL on the tier's clock."""
    now = [100.0]
    tier = ptier.SegmentTierManager("unit3", hot_ttl_s=60.0,
                                    clock=lambda: now[0])
    try:
        tier.note_hot("t")
        assert tier._hot_tables() == {"t"}
        now[0] += 61.0
        assert tier._hot_tables() == set()
    finally:
        tier.close()


def test_scan_pin_holds_eviction_and_the_device_planes(tars):
    """While a scan holds its tier pins the segment is never a victim: its
    directory and its device view stay. Once the pins drop, the next
    eviction pass demotes it and releases its view and family stacks from
    the device cache, and the cold segment answers exactly again through
    a new view."""
    c = _cold_cluster(PORT, tars, stats_segs=1, filler_segs=1)
    try:
        resp = c.broker.execute_sql(NOCACHE + GROUP_SQL.format(t="stats"))
        assert _full(resp) and _rows(resp) == c.want_stats
        cache = c.server.executor.executor.cache
        views = [v for v in cache._views.values()
                 if v.segment.name in c.stats_names]
        assert len(views) == 1 and set(c.stats_names) <= \
            cache.segment_names()
        pins = c.server._tier.pin(ST, c.stats_names)
        resp = c.broker.execute_sql(NOCACHE + GROUP_SQL.format(t="filler"))
        assert _full(resp) and _rows(resp) == c.want_filler
        # the filler warm found no unpinned victim: stats stay resident,
        # on disk and on the device, over the budget for now
        assert list(_inventory(c.server, ST)[0]) == c.stats_names
        assert all(any(v is w for w in cache._views.values())
                   for v in views)
        st = c.server._tier.stats()
        assert c.budget < st["bytesUsed"] <= c.budget + c.max_seg
        c.server._tier.unpin(pins)
        c.server._tier._make_room()  # the next fetch's eviction pass
        assert list(_inventory(c.server, ST)[1]) == c.stats_names
        assert not set(c.stats_names) & cache.segment_names()
        assert c.server._tier.stats()["bytesUsed"] <= c.budget
        resp = c.broker.execute_sql(NOCACHE + GROUP_SQL.format(t="stats"))
        assert _full(resp) and _rows(resp) == c.want_stats
        assert not any(v is w for v in views for w in cache._views.values())
    finally:
        _close(c)


def test_high_water_gauge_tracks_the_device_cache(tars):
    c = _cold_cluster(PORT, tars)
    try:
        cache = c.server.executor.executor.cache
        c.broker.execute_sql(NOCACHE + GROUP_SQL.format(t="stats"))
        peak = cache.bytes_used()
        assert peak > 0
        c.broker.execute_sql(NOCACHE + GROUP_SQL.format(t="filler"))
        assert PSM.gauge_value("hbmBytesHighWater") >= peak
    finally:
        _close(c)


def test_a_query_warm_never_evicts_its_own_routed_segments(tars):
    """A tier that holds one of a table's two segments: converge loads one
    and registers the other cold. The port's first query pins the
    resident one while its warm fetches the other, so both are scanned
    (over budget until the next eviction pass); the JAX server's warm
    evicts the resident one, and its query comes back short of a segment
    (a deliberate difference)."""
    stats = tars["stats"]
    budget = max(b for _, _, b, _ in stats)
    out = {}
    for pkg in BOTH:
        store = pkg.cl.PropertyStore()
        ctl = pkg.cl.ClusterController(store)
        server = pkg.cl.ServerInstance(store, "S0", **pkg.server_kw,
                                       local_storage_mb=budget / (1 << 20))
        server.start()
        broker = pkg.cl.Broker(store)
        try:
            ctl.add_schema(_schema("stats").to_json())
            h = ctl.create_table({"tableName": "stats", "replication": 1})
            for name, tar, _, _ in stats:
                ctl.add_segment(h, name, {"location": tar, "numDocs": 250})
            before = _inventory(server, ST)
            resp = broker.execute_sql("SET allowPartialResults=true; "
                                      + NOCACHE + GROUP_SQL.format(t="stats"))
            out[pkg.name] = (before, _full(resp),
                             _full(resp) and _rows(resp) == _team_sums(
                                 [c for *_, c in stats]))
        finally:
            server.stop()
            if hasattr(broker, "close"):
                broker.close()
    for before, *_ in out.values():
        assert len(before[0]) == len(before[1]) == 1
        assert sorted(before[0] + before[1]) == ["s0", "s1"]
    assert out["port"][1:] == (True, True)
    assert out["jax"][1] is False
