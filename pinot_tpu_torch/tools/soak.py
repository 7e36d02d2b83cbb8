"""Soak and chaos harness: seeded, reproducible reliability runs.

The port of pinot_tpu/tools/soak.py. Eight suites, each a function that
returns a stats dict (or raises SoakFailure), plus a CLI:

  sql       randomized SQL against a sqlite oracle on the host engine
            (QueryExecutor backend "host"), with device-against-host
            parity (backend "auto") on `device`: the QueryGenerator/H2
            pattern (reference: pinot-integration-test-base/.../
            QueryGenerator.java, ClusterIntegrationTestUtils.testQueries).
  chaos     an embedded cluster (controller + servers + broker,
            replication 2) under continuous exact-result queries while
            servers are killed and restarted, RebalanceChecker heals
            placement, and minion merge-rollup compacts the table
            concurrently (reference: pinot-integration-tests/.../
            ChaosMonkeyIntegrationTest.java).
  qps       open-loop paced load over an embedded cluster: p50/p99 under
            load, self-healing counters, fault and corruption schedules,
            admission, query-family rotation; backend "host" or "device"
            (the port's device engine, the reference's "tpu").
  realtime  repeated committer-crash/re-election rounds with zero row loss
            (reference: pinot-controller/src/test/.../realtime/
            SegmentCompletionTest.java), then live ingest into a consuming
            segment's device planes under concurrent device queries.
  failover  controller kills/restarts (leader handoff + leaderless
            windows) over a durable property store mid query + realtime
            ingest: exact responses throughout, consumers HOLD through
            outages, zero lost or duplicated committed segments afterward.
  rebalance elastic capacity under live load: servers are killed and
            added while the durable rebalance actuation loop
            (cluster/rebalance.py) rebuilds dead replicas and spreads onto
            new hosts; queries stay exact-or-degraded, one leader kill
            mid-job exercises journal resume, and --fault-rate arms the
            rebalance.move point on in-flight destinations.
  tiered    tiered storage: several tables whose total tarred-segment
            bytes are a small multiple of each server's local byte
            budget, under a randomized query mix (dense agg, sparse
            group-by, selection ORDER BY, MSE join) that forces continuous
            cold loads + LRU evictions; every full response must match a
            fully resident control cluster, disk stays inside the budget
            plus in-flight fetches, and a final strict pass over every
            table must be identical to the control.
  sentinel  the regression sentinel's detect -> pin -> recover loop on a
            live cluster (a seeded device.dispatch delay).

Every suite takes `device`, "cuda" by default (construction raises without
an H100 unless "cpu" is asked for; no suite falls back to the CPU), and
hands it to every QueryExecutor, ServerInstance and MinionInstance it
builds. The suites keep the reference's engine choices: the sql oracle
side and the chaos, failover, rebalance and tiered clusters run on the
host engine (backend "host": they exercise cluster mechanics, as in the
reference); the sql parity side, qps under "device", the realtime churn
and the sentinel reach the card.

Where the port differs from the reference:

- QueryExecutor.execute_sql raises where the reference returns the
  response's exceptions (the Broker still returns them): the sql suite
  and the realtime querier turn a raised error into the same SoakFailure,
  naming the SQL.
- A realtime.upload fault fails the query with RealtimeUploadError where
  the reference answers it on its host engine: under --fault-rate the
  realtime churn counts each such query in `device_faulted_uploads`, asks
  again at a settle point, and still requires every settle point to be
  exact against the host engine and the running aggregate.
- The port counts no compiles, so qps's `num_compiles` reads 0; family
  rotation still checks every family's full answers exactly.
- The sql and qps summaries add `device_dispatches` (the device side's
  dispatches), and the sql summary the device side's per-query latency.

Default profile is a ~2-minute run across the sql, chaos and realtime
suites:

    python -m pinot_tpu_torch.tools.soak --device cpu
    python -m pinot_tpu_torch.tools.soak --suite qps --backend device

Bigger knobs give longer runs, e.g.:

    python -m pinot_tpu_torch.tools.soak --suite sql --seconds 7200
    python -m pinot_tpu_torch.tools.soak --suite chaos --seconds 14400
    python -m pinot_tpu_torch.tools.soak --suite realtime --rounds 1500

Every run is seeded; a failure prints the offending SQL/round and the seed
that reproduces it, then exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import math
import sqlite3
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

# -- shared result normalization (FP jitter + None/str/float mixing) ----------


def _norm(v):
    if v is None:
        return None
    if isinstance(v, float):
        if math.isnan(v):
            return None
        if math.isinf(v):
            return "Infinity" if v > 0 else "-Infinity"
        return v
    if isinstance(v, (int, np.integer)):
        return float(v)
    return v


def _sort_key(row):
    out = []
    for v in row:
        if v is None:
            out.append((0, ""))
        elif isinstance(v, float):
            out.append((1, round(v, 2)))
        else:
            out.append((2, str(v)))
    return tuple(out)


def _rows_equal(a, b) -> bool:
    if len(a) != len(b):
        return False
    for ra, rb in zip(a, b):
        if len(ra) != len(rb):
            return False
        for va, vb in zip(ra, rb):
            if isinstance(va, float) and isinstance(vb, float):
                if not math.isclose(va, vb, rel_tol=1e-9, abs_tol=1e-6):
                    return False
            elif va != vb:
                return False
    return True


def _exact_key(row):
    return tuple((0, "") if v is None else (1, v) if isinstance(v, float)
                 else (2, str(v)) for v in row)


def _canon(rows):
    """Rows normalized and sorted by _sort_key (floats rounded, so FP
    jitter keeps the order); rows whose rounded keys tie are ordered by
    their exact values, where the reference keeps their input order: with
    tens of thousands of rows, two rows that differ only in the third
    decimal of a float would otherwise sit in either order and fail the
    element-wise comparison although both sides hold the same rows."""
    return sorted([tuple(_norm(v) for v in r) for r in rows],
                  key=lambda r: (_sort_key(r), _exact_key(r)))


class SoakFailure(AssertionError):
    pass


def _capture_cluster_report(store, controller, broker) -> dict:
    """Pre-teardown capture for ``--report``: the broker's per-table cost
    aggregates plus one cluster-health scrape (anomaly list + fleet
    rollup) taken while the servers are still live."""
    from pinot_tpu_torch.cluster.periodic import ClusterHealthChecker

    out = {"workload": broker.workload.snapshot()}
    health = ClusterHealthChecker(store, controller)()
    out["anomalies"] = health.get("anomalies", [])
    if health.get("fleet"):
        out["fleet"] = health["fleet"]
    return out


# ════════════════════════════════════════════════════════════════════════════
# Suite 1: randomized SQL vs sqlite oracle
# ════════════════════════════════════════════════════════════════════════════

_CITIES = ["sf", "ny", "la", "chi", "sea", "aus", "bos", "den"]
_STATUSES = ["open", "closed", "pending"]
_NUM_COLS = ["code", "amount", "score"]
_STR_COLS = ["city", "status"]
_AGGS = ["SUM", "COUNT", "MIN", "MAX", "AVG"]


class _SqlSoak:
    """Self-contained generator + oracle + engines for the sql suite: the
    host engine against sqlite, and with `device_parity` the device
    engine (backend "auto") against the host engine, both on `device`."""

    def __init__(self, seed: int, rows: int = 1600, device_parity: bool = True,
                 device="cuda"):
        from pinot_tpu_torch.engine.query_executor import QueryExecutor
        from pinot_tpu_torch.segment.builder import SegmentBuilder
        from pinot_tpu_torch.segment.loader import load_segment
        from pinot_tpu_torch.spi.data_types import Schema

        self.rng = np.random.default_rng(seed)
        self.device_parity = device_parity
        # a row-returning shape's LIMIT never truncates (the oracle's SQL
        # has none): the reference's 5000 and 9000 up to 4500 rows, the
        # table's rows (twice them for a set operation's) above
        self.limit = f" LIMIT {max(5000, rows)}"
        self.set_limit = f" LIMIT {max(9000, 2 * rows)}"
        schema = Schema.build(
            "fz",
            dimensions=[("city", "STRING"), ("status", "STRING"),
                        ("code", "INT")],
            metrics=[("amount", "INT"), ("score", "DOUBLE")])
        dim_schema = Schema.build(
            "fzdim", dimensions=[("dcode", "INT"), ("region", "STRING")])

        rng = np.random.default_rng(seed)
        n = rows
        data = {
            "city": np.asarray(_CITIES, dtype=object)[
                rng.integers(0, len(_CITIES), n)],
            "status": np.asarray(_STATUSES, dtype=object)[
                rng.integers(0, len(_STATUSES), n)],
            "code": rng.integers(0, 40, n).astype(np.int32),
            "amount": rng.integers(-50, 1000, n).astype(np.int32),
            "score": np.round(rng.random(n) * 100, 3),
        }
        dim = {"dcode": np.arange(0, 30, dtype=np.int32),
               "region": np.asarray([["west", "east", "south"][i % 3]
                                     for i in range(30)], dtype=object)}

        self._tmp = tempfile.TemporaryDirectory(prefix="pinot_soak_sql_")
        d = Path(self._tmp.name)
        half = n // 2
        segs = []
        for i, sl in enumerate([slice(0, half), slice(half, n)]):
            SegmentBuilder(schema, segment_name=f"fz_{i}").build(
                {k: v[sl] for k, v in data.items()}, d / f"s{i}")
            segs.append(load_segment(d / f"s{i}"))
        SegmentBuilder(dim_schema, segment_name="dim0").build(dim, d / "dim")

        self.qe = QueryExecutor(device=device, backend="host")
        self.qe.add_table(schema, segs)
        self.qe.add_table(dim_schema, [load_segment(d / "dim")])
        self.device_dispatches = 0
        self.device_ms: list[float] = []
        if device_parity:
            self.qe_dev = QueryExecutor(device=device, backend="auto")
            for name, t in self.qe.tables.items():
                self.qe_dev.add_table(t.schema, t.segments, name=name)

        self.oracle = sqlite3.connect(":memory:")
        self.oracle.execute(
            "CREATE TABLE fz (city TEXT, status TEXT, code INT, "
            "amount INT, score REAL)")
        self.oracle.execute("CREATE TABLE fzdim (dcode INT, region TEXT)")
        self.oracle.executemany(
            "INSERT INTO fz VALUES (?,?,?,?,?)",
            [(data["city"][i], data["status"][i], int(data["code"][i]),
              int(data["amount"][i]), float(data["score"][i]))
             for i in range(n)])
        self.oracle.executemany(
            "INSERT INTO fzdim VALUES (?,?)",
            [(int(dim["dcode"][i]), dim["region"][i]) for i in range(30)])

    # -- generators ----------------------------------------------------------

    def _pred(self, p: str = "") -> str:
        rng = self.rng
        kind = rng.integers(0, 6)
        if kind == 0:
            return f"{p}{rng.choice(_STR_COLS)} = '{rng.choice(_CITIES + _STATUSES)}'"
        if kind == 1:
            return f"{p}{rng.choice(_STR_COLS)} <> '{rng.choice(_CITIES + _STATUSES)}'"
        if kind == 2:
            col = rng.choice(_NUM_COLS)
            op = rng.choice(["<", ">", "<=", ">="])
            return f"{p}{col} {op} {rng.integers(-20, 500)}"
        if kind == 3:
            col = rng.choice(_NUM_COLS)
            lo = int(rng.integers(-20, 200))
            return f"{p}{col} BETWEEN {lo} AND {lo + int(rng.integers(1, 300))}"
        if kind == 4:
            vals = ", ".join(
                f"'{v}'" for v in self.rng.choice(_CITIES, size=3, replace=False))
            return f"{p}city IN ({vals})"
        return f"{p}code = {rng.integers(0, 40)}"

    def _where(self, prefix: str = "") -> str:
        n = int(self.rng.integers(0, 3))
        if n == 0:
            return ""
        parts = [self._pred(prefix) for _ in range(n)]
        joiner = " AND " if self.rng.random() < 0.7 else " OR "
        return " WHERE " + joiner.join(parts)

    def _agg_expr(self):
        # oracle side encodes Pinot's empty-group defaults: SUM()=0,
        # MIN()=+inf, MAX()=-inf (not SQL NULL)
        fn = self.rng.choice(_AGGS)
        if fn == "COUNT":
            return "COUNT(*)", "COUNT(*)"
        col = self.rng.choice(_NUM_COLS)
        e = f"{fn}({col})"
        if fn == "SUM":
            return e, f"COALESCE(SUM({col}), 0.0)"
        if fn == "MIN":
            return e, f"COALESCE(MIN({col}), 9e999)"
        if fn == "MAX":
            return e, f"COALESCE(MAX({col}), -9e999)"
        return e, e

    def _gen(self):
        """One random (sql, oracle_sql, parity_eligible) triple."""
        rng = self.rng
        shape = rng.integers(0, 8)
        if shape == 0:  # plain aggregation
            pairs = [self._agg_expr() for _ in range(int(rng.integers(1, 4)))]
            w = self._where()
            return (f"SELECT {', '.join(p[0] for p in pairs)} FROM fz{w}",
                    f"SELECT {', '.join(p[1] for p in pairs)} FROM fz{w}",
                    True)
        if shape == 1:  # group by
            dims = list(rng.choice(_STR_COLS + ["code"],
                                   size=int(rng.integers(1, 3)), replace=False))
            pairs = [self._agg_expr() for _ in range(int(rng.integers(1, 3)))]
            w = self._where()
            g = f" GROUP BY {', '.join(dims)}"
            return (f"SELECT {', '.join(dims + [p[0] for p in pairs])} "
                    f"FROM fz{w}{g} LIMIT 5000",
                    f"SELECT {', '.join(dims + [p[1] for p in pairs])} "
                    f"FROM fz{w}{g}",
                    True)
        if shape == 2:  # selection
            cols = list(rng.choice(_STR_COLS + _NUM_COLS,
                                   size=int(rng.integers(1, 4)), replace=False))
            sql = (f"SELECT {', '.join(cols)} FROM fz{self._where()}"
                   f"{self.limit}")
            return sql, sql.replace(self.limit, ""), True
        if shape == 3:  # having
            dim = rng.choice(_STR_COLS + ["code"])
            cut = int(rng.integers(0, 400))
            w = self._where()
            return (f"SELECT {dim}, COUNT(*), SUM(amount) FROM fz{w} "
                    f"GROUP BY {dim} HAVING SUM(amount) > {cut} LIMIT 5000",
                    f"SELECT {dim}, COUNT(*), COALESCE(SUM(amount), 0.0) "
                    f"FROM fz{w} GROUP BY {dim} HAVING SUM(amount) > {cut}",
                    False)
        if shape == 4:  # join through MSE
            jt = rng.choice(["JOIN", "LEFT JOIN"])
            w = self._where(prefix="a.")
            if rng.random() < 0.5:
                sql = (f"SELECT b.region, SUM(a.amount) FROM fz a {jt} fzdim b "
                       f"ON a.code = b.dcode{w} GROUP BY b.region"
                       f"{self.limit}")
            else:
                sql = (f"SELECT a.city, b.region FROM fz a {jt} fzdim b "
                       f"ON a.code = b.dcode{w}{self.limit}")
            return sql, sql.replace(self.limit, ""), False
        if shape == 5:  # window through MSE
            fn = rng.choice(["ROW_NUMBER()", "RANK()", "DENSE_RANK()",
                             "SUM(amount)", "COUNT(*)", "MIN(score)",
                             "MAX(score)"])
            part = rng.choice(_STR_COLS)
            w = self._where()
            sql = (f"SELECT city, code, amount, {fn} OVER "
                   f"(PARTITION BY {part} ORDER BY amount, code, city) "
                   f"FROM fz{w}{self.limit}")
            return sql, sql.replace(self.limit, ""), False
        if shape == 6:  # set op through MSE
            op = rng.choice(["UNION", "UNION ALL", "INTERSECT", "EXCEPT"])
            c1, c2 = int(rng.integers(0, 400)), int(rng.integers(0, 400))
            sql = (f"SELECT city, code FROM fz WHERE amount > {c1} "
                   f"{op} SELECT city, code FROM fz WHERE score > {c2}"
                   f"{self.set_limit}")
            return sql, sql.replace(self.set_limit, ""), False
        # derived table + FILTER clause mix
        if rng.random() < 0.5:
            dim = rng.choice(_STR_COLS)
            cut = int(rng.integers(0, 300))
            sql = (f"SELECT COUNT(*) FROM (SELECT {dim}, SUM(amount) AS s "
                   f"FROM fz GROUP BY {dim}) WHERE s > {cut}")
            return sql, sql, False
        cond = self._pred()
        col = rng.choice(_NUM_COLS)
        w = self._where()
        return (f"SELECT SUM({col}) FILTER (WHERE {cond}), COUNT(*) "
                f"FILTER (WHERE {cond}) FROM fz{w}",
                f"SELECT COALESCE(SUM({col}) FILTER (WHERE {cond}), 0.0), "
                f"COUNT(*) FILTER (WHERE {cond}) FROM fz{w}",
                False)

    # -- one soak step -------------------------------------------------------

    @staticmethod
    def _run(qe, sql: str, what: str):
        """execute_sql, with a raised error (the port's single-stage engine
        raises where the reference returns the response's exceptions) and
        a response's exceptions (the multi-stage engine's) alike turned
        into the SoakFailure that names the SQL."""
        try:
            resp = qe.execute_sql(sql)
        except Exception as e:  # noqa: BLE001 - the soak reports it
            raise SoakFailure(f"{what} error\n{sql}\n→ {e!r}") from e
        if resp.exceptions:
            raise SoakFailure(f"{what} error\n{sql}\n→ {resp.exceptions}")
        return resp

    def step(self) -> dict:
        sql, oracle_sql, parity = self._gen()
        resp = self._run(self.qe, sql, "engine")
        got = _canon(resp.result_table.rows)
        want = _canon(self.oracle.execute(oracle_sql).fetchall())
        if not _rows_equal(got, want):
            raise SoakFailure(
                f"oracle mismatch\n{sql}\ngot:  {got[:6]}…\nwant: {want[:6]}…")
        checks = 1
        if parity and self.device_parity:
            t0 = time.perf_counter()
            dresp = self._run(self.qe_dev, sql, "device")
            self.device_ms.append((time.perf_counter() - t0) * 1e3)
            self.device_dispatches += dresp.num_device_dispatches
            dgot = _canon(dresp.result_table.rows)
            if not _rows_equal(dgot, got):
                raise SoakFailure(
                    f"device/host mismatch\n{sql}\n"
                    f"dev:  {dgot[:6]}…\nhost: {got[:6]}…")
            checks += 1
        return {"checks": checks}

    def close(self):
        self.oracle.close()
        self._tmp.cleanup()


def soak_sql(seconds: float = 60.0, seed: int = 0, rows: int = 1600,
             device_parity: bool = True, max_checks: int | None = None,
             progress=None, device="cuda") -> dict:
    """Randomized SQL soak: checks until `seconds` pass or `max_checks`
    are made. Returns the reference's {'suite', 'checks', 'elapsed_s',
    'seed', 'device_parity'} plus the device side's dispatches and its
    p50 / p99 ms a query (host clock; None without device parity)."""
    s = _SqlSoak(seed, rows=rows, device_parity=device_parity, device=device)
    t0 = time.time()
    checks = 0
    try:
        while time.time() - t0 < seconds:
            checks += s.step()["checks"]
            if max_checks and checks >= max_checks:
                break
            if progress and checks % 500 < 2:
                progress(f"sql: {checks} checks")
    finally:
        s.close()
    lat = s.device_ms
    return {"suite": "sql", "checks": checks,
            "elapsed_s": round(time.time() - t0, 1), "seed": seed,
            "device_parity": device_parity,
            "device_dispatches": s.device_dispatches,
            "device_p50_ms": float(np.percentile(lat, 50)) if lat else None,
            "device_p99_ms": float(np.percentile(lat, 99)) if lat else None}


# ════════════════════════════════════════════════════════════════════════════
# Suite 2: cluster chaos — kills + rebalance + concurrent compaction
# ════════════════════════════════════════════════════════════════════════════


def soak_chaos(seconds: float = 60.0, seed: int = 0, n_servers: int = 3,
               replication: int = 2, n_segments: int = 6,
               rows_per_segment: int = 400, fault_rate: float = 0.0,
               corrupt_rate: float = 0.0, progress=None,
               capture_report: bool = False, device="cuda") -> dict:
    """ChaosMonkey soak: continuous exact-result broker queries while
    servers die/restart, RebalanceChecker heals, and minion merge-rollup
    compacts concurrently. Returns counters.

    With ``fault_rate`` > 0 a seeded fault-injection schedule is armed on
    top of the kill/restart churn (transport.call, server.query,
    device.dispatch — see spi/faults.py). Queries then run with
    allowPartialResults=true and the invariant relaxes from "exact,
    always" to "exact OR well-formed partial/error, never silent
    corruption": a full (non-partial, non-error) response must still
    match the oracle bit-for-bit.

    ``corrupt_rate`` > 0 additionally arms a seeded ``corrupt`` schedule
    (segment.load, transport.call, datatable.encode): bit-flips that MUST
    be detected by the integrity layer — the summary reports corruptions
    injected vs detected vs repaired, and the same exact-or-degraded
    invariant holds (a silently wrong full answer is a failure)."""
    from pinot_tpu_torch.cluster import (Broker, ClusterController,
                                         PropertyStore, ServerInstance)
    from pinot_tpu_torch.spi import faults
    from pinot_tpu_torch.spi.metrics import (BROKER_METRICS, SERVER_METRICS,
                                             BrokerMeter, ServerMeter)
    from pinot_tpu_torch.cluster.periodic import RebalanceChecker
    from pinot_tpu_torch.minion import MinionInstance, PinotTaskManager
    from pinot_tpu_torch.segment.builder import SegmentBuilder
    from pinot_tpu_torch.spi.data_types import Schema

    schema = Schema.build(
        "stats",
        dimensions=[("team", "STRING"), ("year", "INT")],
        metrics=[("runs", "INT")])
    teams = ["BOS", "NYA", "SFN", "LAN", "CHC", "HOU"]
    rng = np.random.default_rng(seed)

    tmp = tempfile.TemporaryDirectory(prefix="pinot_soak_chaos_")
    d = Path(tmp.name)
    store = PropertyStore()
    controller = ClusterController(store)
    servers = {}
    for i in range(n_servers):
        s = ServerInstance(store, f"Server_{i}", device=device,
                           backend="host")
        s.start()
        servers[f"Server_{i}"] = s
    broker = Broker(store)
    controller.add_schema(schema.to_json())
    table = controller.create_table({
        "tableName": "stats", "replication": replication,
        "taskConfigs": {"MergeRollupTask": {"mergeType": "concat"}}})
    task_mgr = PinotTaskManager(store, controller)
    minion = MinionInstance(store, "Minion_0", controller, str(d / "minion"),
                            device=device)
    checker = RebalanceChecker(controller)

    expected = {}
    total_docs = 0
    for i in range(n_segments):
        n = rows_per_segment
        cols = {
            "team": np.asarray(teams, dtype=object)[
                rng.integers(0, len(teams), n)],
            "year": rng.integers(2000, 2020, n).astype(np.int32),
            "runs": rng.integers(0, 100, n).astype(np.int32),
        }
        name = f"stats_{i}"
        SegmentBuilder(schema, segment_name=name).build(cols, d / name)
        controller.add_segment(table, name,
                               {"location": str(d / name), "numDocs": n})
        for t, r in zip(cols["team"], cols["runs"]):
            expected[t] = expected.get(t, 0) + int(r)
        total_docs += n

    sql = "SELECT team, SUM(runs) FROM stats GROUP BY team LIMIT 20"
    stats = {"queries": 0, "kills": 0, "restarts": 0, "rebalances": 0,
             "compactions": 0}
    if fault_rate > 0:
        armed = faults.seed_schedule(
            seed, fault_rate,
            points=("transport.call", "server.query", "device.dispatch"))
        # resultCache off: the soak repeats one statement, and a broker
        # cache hit would short-circuit every armed transport/server fault
        # point after the first query
        sql = ("SET allowPartialResults=true; SET resultCache=false; "
               + sql)
        stats["faulted_queries"] = 0
        if progress:
            progress(f"chaos: armed fault schedule on {sorted(armed)} "
                     f"(rate={fault_rate}, seed={seed})")
    integrity0 = None
    if corrupt_rate > 0:
        # distinct derived seed: corruption strikes stay decorrelated from
        # the error/drop schedule above while both reproduce from --seed
        armed_c = faults.seed_schedule(
            seed + 0x5EED, corrupt_rate, kind="corrupt",
            points=("segment.load", "transport.call", "datatable.encode"))
        if fault_rate <= 0:
            sql = ("SET allowPartialResults=true; SET resultCache=false; "
                   + sql)
            stats["faulted_queries"] = 0
        integrity0 = {
            "crc": SERVER_METRICS.meter_count(
                ServerMeter.SEGMENT_CRC_MISMATCH),
            "wire": BROKER_METRICS.meter_count(
                BrokerMeter.DATATABLE_CORRUPTIONS),
            "repairs": SERVER_METRICS.meter_count(
                ServerMeter.SEGMENT_REPAIRS),
        }
        if progress:
            progress(f"chaos: armed corrupt schedule on {sorted(armed_c)} "
                     f"(rate={corrupt_rate}, seed={seed})")
    down: list[str] = []
    t0 = time.time()
    try:
        while time.time() - t0 < seconds:
            # the soak invariant: EXACT results, always — relaxed under
            # --fault-rate to exact-or-degraded (partial/error), never a
            # silently wrong full answer
            resp = broker.execute_sql(sql)
            if resp.exceptions:
                if fault_rate > 0 or corrupt_rate > 0:
                    stats["faulted_queries"] += 1
                    stats["queries"] += 1
                    continue
                raise SoakFailure(f"query error during chaos: {resp.exceptions}")
            got = {r[0]: r[1] for r in resp.result_table.rows}
            if got != expected:
                raise SoakFailure(
                    f"wrong results during chaos (seed {seed}): "
                    f"got {got} want {expected}")
            stats["queries"] += 1

            r = rng.random()
            if r < 0.08 and len(down) < replication - 1:
                # kill a random live server; at most replication-1 down at
                # once so every segment keeps >=1 online replica (the soak
                # asserts EXACT results, not graceful degradation)
                name = rng.choice([n for n in servers if n not in down])
                servers[name].stop()
                down.append(name)
                stats["kills"] += 1
            elif r < 0.16 and down:
                # resurrect: fresh instance, same identity; converges from
                # ideal state
                name = down.pop(0)
                s = ServerInstance(store, name, device=device, backend="host")
                s.start()
                servers[name] = s
                stats["restarts"] += 1
            elif r < 0.22:
                fixed = checker()
                stats["rebalances"] += sum(1 for _ in fixed)
            elif r < 0.26:
                ids = task_mgr.schedule_tasks()
                if ids:
                    stats["compactions"] += minion.run_pending_once()
            if progress and stats["queries"] % 500 == 0:
                progress(f"chaos: {stats}")
    finally:
        if capture_report:
            # must run before teardown: the broker's workload tracker and
            # a health scrape of still-live servers feed the --report
            # artifact; never let capture mask a soak failure
            try:
                stats.update(_capture_cluster_report(store, controller,
                                                     broker))
            except Exception:
                pass
        if corrupt_rate > 0 and integrity0 is not None:
            # the integrity ledger: every injected corruption must show up
            # as a detection (load-verify or wire checksum), and repairs +
            # replica retries say how many healed
            stats["corruptions"] = {
                "injected": faults.FAULTS.fired_kind("corrupt"),
                "detected": (SERVER_METRICS.meter_count(
                                 ServerMeter.SEGMENT_CRC_MISMATCH)
                             - integrity0["crc"])
                            + (BROKER_METRICS.meter_count(
                                   BrokerMeter.DATATABLE_CORRUPTIONS)
                               - integrity0["wire"]),
                "repaired": SERVER_METRICS.meter_count(
                    ServerMeter.SEGMENT_REPAIRS) - integrity0["repairs"],
            }
        if fault_rate > 0 or corrupt_rate > 0:
            stats["injected_faults"] = faults.FAULTS.total_fired()
            faults.FAULTS.reset()
        for s in servers.values():
            try:
                s.stop()
            except Exception:
                pass
        tmp.cleanup()
    stats.update({"suite": "chaos", "elapsed_s": round(time.time() - t0, 1),
                  "seed": seed, "total_docs": total_docs})
    return stats


# ════════════════════════════════════════════════════════════════════════════
# Suite 2b: QPS mode — concurrent load, latency-under-load, self-healing
# ════════════════════════════════════════════════════════════════════════════


def soak_qps(seconds: float = 30.0, seed: int = 0, qps: float = 50.0,
             concurrency: int = 8, n_servers: int = 3, replication: int = 2,
             n_segments: int = 6, rows_per_segment: int = 400,
             fault_rate: float = 0.0, corrupt_rate: float = 0.0,
             max_inflight: int = 0, backend: str = "host",
             families: int = 0, progress=None,
             capture_report: bool = False, device="cuda") -> dict:
    """Closed-loop QPS soak: ``concurrency`` workers pace an aggregate
    ``qps`` arrival rate of exact-result queries against an embedded
    cluster, reporting p50/p99 latency under load, achieved QPS, and the
    self-healing counters (retried / hedged / rejected queries).

    The invariant matches the chaos suite's: every full response must be
    exact; with ``fault_rate`` > 0 (seeded schedule over transport.call +
    server.query) a response may instead be a WELL-FORMED partial/error —
    never silently wrong. ``corrupt_rate`` > 0 arms a seeded ``corrupt``
    schedule on the wire points (transport.call, datatable.encode) — every
    strike must be absorbed by the DataTable checksum + replica retry, so
    full answers stay bit-exact under corruption. ``max_inflight`` > 0
    additionally arms broker admission control, so overload sheds as
    queryRejected=true responses (counted, not failed).

    ``families`` > 0 turns the run into a TRAFFIC SHIFT: the workload
    rotates through that many distinct query families (different
    programs → different compile fingerprints), each hot for an equal
    slice of the run, and every family's full responses are verified
    exactly against precomputed aggregates. The reference's ``tpu``
    backend pays each new family's XLA compile at a shift boundary; the
    port's ``device`` backend (its servers' device engine on `device`)
    compiles nothing, so ``num_compiles`` (summed off BrokerResponse, as
    in the reference) reads 0 and a boundary costs the new family's
    first dispatch. The summary adds ``device_dispatches`` (summed off
    BrokerResponse)."""
    import threading

    from pinot_tpu_torch.cluster import (Broker, ClusterController,
                                         PropertyStore, ServerInstance)
    from pinot_tpu_torch.cluster.quota import AdmissionController
    from pinot_tpu_torch.segment.builder import SegmentBuilder
    from pinot_tpu_torch.spi import faults
    from pinot_tpu_torch.spi.data_types import Schema
    from pinot_tpu_torch.spi.metrics import BROKER_METRICS, BrokerMeter

    schema = Schema.build(
        "stats",
        dimensions=[("team", "STRING"), ("year", "INT")],
        metrics=[("runs", "INT")])
    teams = ["BOS", "NYA", "SFN", "LAN", "CHC", "HOU"]
    rng = np.random.default_rng(seed)

    tmp = tempfile.TemporaryDirectory(prefix="pinot_soak_qps_")
    d = Path(tmp.name)
    store = PropertyStore()
    controller = ClusterController(store)
    servers = []
    for i in range(n_servers):
        s = ServerInstance(store, f"Server_{i}", device=device,
                           backend=backend)
        s.start()
        servers.append(s)
    broker = Broker(store)
    if max_inflight > 0:
        broker.admission = AdmissionController(max_inflight=max_inflight)
    controller.add_schema(schema.to_json())
    table = controller.create_table({"tableName": "stats",
                                     "replication": replication})
    all_cols = {"team": [], "year": [], "runs": []}
    for i in range(n_segments):
        n = rows_per_segment
        # the team codes are kept beside the strings: the expected answers
        # below group by code (the same groups, without comparing millions
        # of strings at the card's data size)
        code = rng.integers(0, len(teams), n)
        cols = {
            "team": np.asarray(teams, dtype=object)[code],
            "year": rng.integers(2000, 2020, n).astype(np.int32),
            "runs": rng.integers(0, 100, n).astype(np.int32),
        }
        name = f"stats_{i}"
        SegmentBuilder(schema, segment_name=name).build(cols, d / name)
        controller.add_segment(table, name,
                               {"location": str(d / name), "numDocs": n})
        all_cols["team"].append(code)
        all_cols["year"].append(cols["year"])
        all_cols["runs"].append(cols["runs"])
        del cols

    def _fam_list():
        """The rotation workload: up to five distinct-program families
        over the stats table, each with its exact expected
        {group-key: measures} answer (key None = ungrouped)."""
        code = np.concatenate(all_cols["team"])
        yr = np.concatenate(all_cols["year"]).astype(np.int64) - 2000
        runs = np.concatenate(all_cols["runs"]).astype(np.int64)
        hi = runs >= 50

        def sums(keys, vals, size):
            return [int(v) for v in np.bincount(keys, weights=vals,
                                                minlength=size)]

        t_n, y_n = np.bincount(code, minlength=len(teams)), \
            np.bincount(yr, minlength=20)
        t_sum, y_sum = sums(code, runs, len(teams)), sums(yr, runs, 20)
        h_n, h_sum = np.bincount(yr[hi], minlength=20), \
            sums(yr[hi], runs[hi], 20)
        t_min = np.full(len(teams), np.iinfo(np.int64).max)
        t_max = np.full(len(teams), np.iinfo(np.int64).min)
        np.minimum.at(t_min, code, runs)
        np.maximum.at(t_max, code, runs)
        ts = [k for k in range(len(teams)) if t_n[k]]
        fams = [
            ("SELECT team, SUM(runs) FROM stats GROUP BY team LIMIT 20",
             {teams[k]: (t_sum[k],) for k in ts}),
            ("SELECT year, COUNT(*), SUM(runs) FROM stats "
             "GROUP BY year LIMIT 40",
             {2000 + k: (int(y_n[k]), y_sum[k]) for k in range(20)
              if y_n[k]}),
            ("SELECT team, MIN(runs), MAX(runs) FROM stats "
             "GROUP BY team LIMIT 20",
             {teams[k]: (int(t_min[k]), int(t_max[k])) for k in ts}),
            ("SELECT year, SUM(runs) FROM stats WHERE runs >= 50 "
             "GROUP BY year LIMIT 40",
             {2000 + k: (h_sum[k],) for k in range(20) if h_n[k]}),
            ("SELECT COUNT(*), SUM(runs), MIN(runs) FROM stats",
             {None: (len(runs), int(runs.sum()), int(runs.min()))}),
        ]
        if families <= 0:
            return fams[:1]
        return [fams[i % len(fams)] for i in range(families)]

    fam_list = [("SET resultCache=false; " + s, e) for s, e in _fam_list()]
    prefix = None
    if fault_rate > 0:
        faults.seed_schedule(seed, fault_rate,
                             points=("transport.call", "server.query"))
        prefix = "SET allowPartialResults=true; "
    if corrupt_rate > 0:
        # wire points only: this suite never restarts servers, so a
        # segment.load strike would have nothing to hit
        faults.seed_schedule(seed + 0x5EED, corrupt_rate, kind="corrupt",
                             points=("transport.call", "datatable.encode"))
        prefix = prefix or "SET allowPartialResults=true; "
    if prefix:
        fam_list = [(prefix + s, e) for s, e in fam_list]
    meters0 = {m: BROKER_METRICS.meter_count(m) for m in (
        BrokerMeter.SCATTER_RETRIES, BrokerMeter.HEDGED_REQUESTS,
        BrokerMeter.HEDGE_WINS, BrokerMeter.QUERIES_REJECTED,
        BrokerMeter.CIRCUIT_OPEN, BrokerMeter.DATATABLE_CORRUPTIONS)}

    lock = threading.Lock()
    state = {"next": 0, "ok": 0, "degraded": 0, "rejected": 0,
             "compiles": 0, "dispatches": 0}
    latencies: list[float] = []
    failures: list[str] = []
    t0 = time.time()
    deadline = t0 + seconds

    def worker():
        while True:
            with lock:
                i = state["next"]
                state["next"] += 1
            target = t0 + i / qps  # open-loop pacing: i-th arrival time
            now = time.time()
            if target >= deadline or failures:
                return
            if target > now:
                time.sleep(target - now)
            # the SCHEDULED arrival time picks the hot family, so the
            # shift boundaries are deterministic for a given seed/qps
            fi = min(len(fam_list) - 1,
                     int((target - t0) / (seconds / len(fam_list))))
            q_sql, q_exp = fam_list[fi]
            q0 = time.perf_counter()
            resp = broker.execute_sql(q_sql)
            lat_ms = (time.perf_counter() - q0) * 1000
            with lock:
                state["compiles"] += getattr(resp, "num_compiles", 0) or 0
                state["dispatches"] += resp.num_device_dispatches
            if getattr(resp, "query_rejected", False):
                with lock:
                    state["rejected"] += 1
                continue
            if resp.exceptions and not resp.partial_result:
                if fault_rate > 0 or corrupt_rate > 0:
                    with lock:
                        state["degraded"] += 1
                        latencies.append(lat_ms)
                    continue
                with lock:
                    failures.append(f"query error: {resp.exceptions}")
                return
            if resp.partial_result:
                with lock:
                    state["degraded"] += 1
                    latencies.append(lat_ms)
                continue
            rows = resp.result_table.rows
            if None in q_exp:  # ungrouped aggregation family
                got = {None: tuple(int(v) for v in rows[0])} if rows else {}
            else:
                got = {(r[0] if isinstance(r[0], str) else int(r[0])):
                       tuple(int(v) for v in r[1:]) for r in rows}
            if got != q_exp:
                with lock:
                    failures.append(
                        f"wrong FULL results under load (seed {seed}, "
                        f"family {fi}): got {got} want {q_exp}")
                return
            with lock:
                state["ok"] += 1
                latencies.append(lat_ms)

    threads = [threading.Thread(target=worker, daemon=True)
               for _ in range(max(1, concurrency))]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        corruptions_injected = faults.FAULTS.fired_kind("corrupt")
        report_extra: dict = {}
        if capture_report:
            try:
                report_extra = _capture_cluster_report(store, controller,
                                                       broker)
            except Exception:
                pass
        if fault_rate > 0 or corrupt_rate > 0:
            faults.FAULTS.reset()
        for s in servers:
            try:
                s.stop()
            except Exception:
                pass
        tmp.cleanup()
    if failures:
        raise SoakFailure(failures[0])
    elapsed = time.time() - t0
    done = state["ok"] + state["degraded"]
    lat = sorted(latencies)
    meters = {m: BROKER_METRICS.meter_count(m) - v
              for m, v in meters0.items()}
    out = {
        "suite": "qps", "seed": seed, "elapsed_s": round(elapsed, 1),
        "target_qps": qps, "concurrency": concurrency,
        "backend": backend, "families": len(fam_list),
        "num_compiles": state["compiles"],
        "device_dispatches": state["dispatches"],
        "queries_ok": state["ok"], "queries_degraded": state["degraded"],
        "queries_rejected": state["rejected"],
        "achieved_qps": round(done / elapsed, 1) if elapsed > 0 else 0.0,
        "p50_ms": round(float(np.percentile(lat, 50)), 2) if lat else None,
        "p99_ms": round(float(np.percentile(lat, 99)), 2) if lat else None,
        "scatter_retries": meters[BrokerMeter.SCATTER_RETRIES],
        "hedged_requests": meters[BrokerMeter.HEDGED_REQUESTS],
        "hedge_wins": meters[BrokerMeter.HEDGE_WINS],
        "rejected_meter": meters[BrokerMeter.QUERIES_REJECTED],
        "circuit_opened": meters[BrokerMeter.CIRCUIT_OPEN],
    }
    out.update(report_extra)
    if corrupt_rate > 0:
        out["corruptions"] = {
            "injected": corruptions_injected,
            "detected": meters[BrokerMeter.DATATABLE_CORRUPTIONS],
            "retried": meters[BrokerMeter.DATATABLE_CORRUPTIONS],
        }
    if progress:
        progress(f"qps: {out}")
    return out


# ════════════════════════════════════════════════════════════════════════════
# Suite 3: realtime committer-crash rounds
# ════════════════════════════════════════════════════════════════════════════

# times a settle point asks the device side again after a query failed on an
# injected upload fault: an attempt that uploads k planes fails with
# probability 1 - (1 - rate) ** k, so at rate 0.1 and k = 4 all 20 fail with
# odds below 1e-9
SETTLE_ATTEMPTS = 20


def _soak_realtime_device(seconds: float = 15.0, seed: int = 0,
                          fault_rate: float = 0.0, progress=None,
                          device="cuda") -> dict:
    """Live-ingest churn on the realtime device planes
    (realtime/device_plane.py): a feeder thread appends rows into a
    CONSUMING segment while a query thread hammers it on the device path
    (backend "auto" on `device`); at every settle point (feeder parked)
    the device result, the host engine's result and a Python-side running
    aggregate must agree EXACTLY.

    With ``fault_rate`` > 0 a seeded schedule is armed on
    ``realtime.upload`` (kind=error for the first half of the run,
    re-armed kind=corrupt for the second half). The reference answers a
    faulted upload on its host engine; the port fails that query with
    RealtimeUploadError (an error leaves the planes as they were, a
    corruption drops the segment's plane set for a full re-upload). Each
    such query counts in ``device_faulted_uploads``: the querier goes on,
    a settle point asks again (up to SETTLE_ATTEMPTS times), and every
    settle point must still be exact. Any other error, a wrong full
    answer, or a RealtimeUploadError with no fault armed is a failure."""
    import threading

    from pinot_tpu_torch.engine.query_executor import QueryExecutor
    from pinot_tpu_torch.ingestion.transform import build_transform_pipeline
    from pinot_tpu_torch.realtime.device_plane import (REALTIME_PLANES,
                                                       RealtimeUploadError)
    from pinot_tpu_torch.segment.mutable import MutableSegment
    from pinot_tpu_torch.spi import faults
    from pinot_tpu_torch.spi.data_types import Schema

    schema = Schema.build(
        "live",
        dimensions=[("team", "STRING"), ("code", "INT")],
        metrics=[("runs", "INT")])
    seg = MutableSegment(schema, "live_dev_0")
    pipe = build_transform_pipeline(schema)
    dev = QueryExecutor(device=device, backend="auto")
    host = QueryExecutor(device=device, backend="host")
    for qe in (dev, host):
        qe.add_table(schema, [seg], name="live")
    sql = "SELECT team, SUM(runs), COUNT(*) FROM live GROUP BY team LIMIT 50"
    # caches off on the device side so every settle re-executes the plane
    # path instead of serving the generation-stamped partial entry
    nocache = "SET segmentCache = false; SET resultCache = false; " + sql
    if fault_rate > 0:
        faults.seed_schedule(seed, fault_rate, points=("realtime.upload",))
        if progress:
            progress(f"realtime-device: armed realtime.upload faults "
                     f"(rate={fault_rate}, seed={seed})")

    teams = [f"t{i}" for i in range(8)]
    stop = threading.Event()
    pause = threading.Event()
    idle = threading.Event()
    lock = threading.Lock()
    expected: dict = {}
    fed = {"rows": 0}
    fail: list = []
    faulted = {"queries": 0}

    def device_query():
        """The device side's answer, or None for a query that failed with
        an injected upload fault (counted; a failure with none armed)."""
        try:
            return dev.execute_sql(nocache)
        except RealtimeUploadError:
            if fault_rate <= 0:
                raise
            with lock:
                faulted["queries"] += 1
            return None

    def feeder():
        i = 0
        while not stop.is_set():
            if pause.is_set():
                idle.set()
                time.sleep(0.002)
                continue
            idle.clear()
            team = teams[i % len(teams)]
            runs = i % 7
            seg.index(pipe.transform(
                {"team": team, "code": i % 100, "runs": runs}))
            with lock:
                expected[team] = expected.get(team, 0) + runs
                fed["rows"] += 1
            i += 1
            if i % 40 == 0:
                time.sleep(0.001)  # let queries interleave
        idle.set()

    qstats = {"queries": 0}

    def querier():
        # concurrent reads under churn: full well-formed answers only, and
        # the visible row count may never go backwards (append-only
        # snapshot invariant — rows below the published generation are
        # immutable)
        last_total = 0
        while not stop.is_set():
            try:
                resp = device_query()
            except Exception as e:  # noqa: BLE001 — surfaced as soak failure
                fail.append(f"realtime-device: concurrent query raised "
                            f"{e!r}\n{nocache}")
                return
            if resp is None:
                continue
            if resp.exceptions:
                fail.append(f"realtime-device: concurrent query error "
                            f"under churn: {resp.exceptions}")
                return
            total = sum(int(r[2]) for r in resp.result_table.rows)
            if total < last_total:
                fail.append(f"realtime-device: append-only violated — "
                            f"visible COUNT went {last_total} -> {total}")
                return
            last_total = total
            qstats["queries"] += 1

    base = REALTIME_PLANES.stats()
    feeder_th = threading.Thread(target=feeder, daemon=True)
    query_th = threading.Thread(target=querier, daemon=True)
    t0 = time.time()
    settles = dispatches = nrows = 0
    flipped = False
    feeder_th.start()
    query_th.start()
    try:
        while time.time() - t0 < seconds and not fail:
            time.sleep(min(1.0, max(0.2, seconds / 10)))
            if fault_rate > 0 and not flipped \
                    and time.time() - t0 > seconds / 2:
                # second half: corruption strikes (plane drop + full
                # re-upload) replace plain upload errors
                faults.seed_schedule(seed ^ 0xC0FFEE, fault_rate,
                                     kind="corrupt",
                                     points=("realtime.upload",))
                flipped = True
            pause.set()
            if not idle.wait(10.0):
                raise SoakFailure("realtime-device: feeder failed to park")
            with lock:
                want = dict(expected)
                nrows = fed["rows"]
            rd = None
            for _ in range(SETTLE_ATTEMPTS):
                try:
                    rd = device_query()
                except Exception as e:  # noqa: BLE001 — the soak reports it
                    raise SoakFailure(
                        f"realtime-device: settle {settles} raised {e!r}\n"
                        f"{nocache}") from e
                if rd is not None:
                    break
            if rd is None:
                raise SoakFailure(
                    f"realtime-device: settle {settles} failed "
                    f"{SETTLE_ATTEMPTS} times on upload faults (seed {seed})")
            try:
                rh = host.execute_sql(sql)
            except Exception as e:  # noqa: BLE001 — the soak reports it
                raise SoakFailure(f"realtime-device: settle {settles} "
                                  f"host engine raised {e!r}\n{sql}") from e
            if rd.exceptions or rh.exceptions:
                raise SoakFailure(
                    f"realtime-device: settle {settles} errored "
                    f"(device={rd.exceptions}, host={rh.exceptions})")
            got_d = {r[0]: int(r[1]) for r in rd.result_table.rows}
            got_h = {r[0]: int(r[1]) for r in rh.result_table.rows}
            if got_d != want or got_h != want:
                raise SoakFailure(
                    f"realtime-device: settle {settles} mismatch at "
                    f"{nrows} rows — device={got_d} host={got_h} "
                    f"expected={want} (seed {seed})")
            dispatches += getattr(rd, "num_device_dispatches", 0)
            settles += 1
            if progress:
                progress(f"realtime-device: settle {settles} exact at "
                         f"{nrows} rows")
            pause.clear()
    finally:
        stop.set()
        pause.clear()
        feeder_th.join(5.0)
        query_th.join(5.0)
        if fault_rate > 0:
            faults.FAULTS.reset()
        REALTIME_PLANES.drop_named("live_dev_0")
    if fail:
        raise SoakFailure(fail[0])
    if settles == 0:
        raise SoakFailure("realtime-device: no settle point reached")
    if dispatches == 0 and fault_rate < 0.5:
        # the whole point of the phase: consuming segments must actually
        # ride the device fast path (at high fault rates every upload may
        # legitimately fall back to host, so only enforce below 0.5)
        raise SoakFailure("realtime-device: no device dispatches — "
                          "consuming segment never took the device path")
    end = REALTIME_PLANES.stats()
    out = {"device_settles": settles, "device_rows": nrows,
           "device_concurrent_queries": qstats["queries"],
           "device_dispatches": dispatches,
           "device_delta_uploads": end["uploads"] - base["uploads"],
           "device_delta_upload_bytes":
               end["deltaBytes"] - base["deltaBytes"]}
    if fault_rate > 0:
        out["device_faulted_uploads"] = faulted["queries"]
    return out


def soak_realtime(rounds: int = 3, seed: int = 0, rows_per_round: int = 50,
                  seconds: float = 15.0, fault_rate: float = 0.0,
                  progress=None, device="cuda") -> dict:
    """Repeated committer-crash/re-election rounds; every round must commit
    all published rows with zero loss after the first-elected committer dies
    between build and commit. Followed by the device-plane churn phase
    (``_soak_realtime_device``): live ingest + concurrent device queries
    with an exact-vs-host-control invariant at every settle point."""
    from pinot_tpu_torch.cluster.store import PropertyStore
    from pinot_tpu_torch.realtime.completion import SegmentCompletionManager
    from pinot_tpu_torch.realtime.manager import RealtimeTableDataManager
    from pinot_tpu_torch.spi.data_types import Schema
    from pinot_tpu_torch.spi.stream import GLOBAL_STREAM_REGISTRY
    from pinot_tpu_torch.spi.table_config import (IngestionConfig,
                                                  SegmentsValidationConfig,
                                                  TableConfig, TableType)

    schema = Schema.build(
        "events",
        dimensions=[("user", "STRING"), ("ts", "LONG")],
        metrics=[("n", "INT")])

    def wait_until(pred, timeout=30.0):
        t0 = time.time()
        while time.time() - t0 < timeout:
            if pred():
                return True
            time.sleep(0.02)
        return False

    t0 = time.time()
    completed = 0
    run_tag = f"{seed}_{int(t0 * 1000) % 100_000_000}"
    for rnd in range(rounds):
        registry = GLOBAL_STREAM_REGISTRY
        # consumers resolve topics through the process-global registry;
        # unique per-round topic names keep rounds independent
        topic = f"soak_ev_{run_tag}_{rnd}"
        registry.create_topic(topic, num_partitions=1)
        store = PropertyStore()
        completion = SegmentCompletionManager(store, num_replicas=2,
                                              commit_lease_s=1.0,
                                              decision_wait_s=2)
        cfg = TableConfig(
            table_name="events",
            table_type=TableType.REALTIME,
            validation=SegmentsValidationConfig(time_column_name="ts"),
            ingestion=IngestionConfig(stream_configs={
                "streamType": "inmemory",
                "stream.inmemory.topic.name": topic,
                "realtime.segment.flush.threshold.rows":
                    max(10, rows_per_round - 10),
            }))
        killed = {"done": False}

        def die_once(mgr, killed=killed):
            if mgr.seq == 0 and not killed["done"]:
                killed["done"] = True
                return True
            return False

        hooks = {"die_before_commit_end": die_once}
        with tempfile.TemporaryDirectory(prefix="pinot_soak_rt_") as td:
            tp = Path(td)
            a = RealtimeTableDataManager(schema, cfg, tp / "a",
                                         completion=completion,
                                         instance_id="A", test_hooks=hooks)
            b = RealtimeTableDataManager(schema, cfg, tp / "b",
                                         completion=completion,
                                         instance_id="B", test_hooks=hooks)
            a.start()
            b.start()
            try:
                registry.publish(topic, [
                    {"user": f"u{i % 5}", "ts": 1_600_000_000_000 + i, "n": 1}
                    for i in range(rows_per_round)])
                if not wait_until(lambda: store.children("/SEGMENTS/events")):
                    raise SoakFailure(
                        f"round {rnd}: no segment committed (seed {seed})")
                seg = store.children("/SEGMENTS/events")[0]

                def done(store=store, seg=seg):
                    rec = store.get(f"/SEGMENTS/events/{seg}")
                    return rec and rec["status"] == "DONE"

                if not wait_until(done):
                    raise SoakFailure(f"round {rnd}: segment never DONE")
                if not killed["done"]:
                    raise SoakFailure(f"round {rnd}: crash hook never fired")
                rec = store.get(f"/SEGMENTS/events/{seg}")
                survivor = a if rec["committer"] == "A" else b
                if not wait_until(lambda: survivor._committed):
                    raise SoakFailure(f"round {rnd}: committer list empty")
                if survivor._committed[0].num_docs != rows_per_round:
                    raise SoakFailure(
                        f"round {rnd}: row loss — committed "
                        f"{survivor._committed[0].num_docs} of "
                        f"{rows_per_round}")
                completed += 1
                if progress:
                    progress(f"realtime: round {rnd + 1}/{rounds} clean")
            finally:
                a.stop()
                b.stop()
    out = {"suite": "realtime", "rounds": completed,
           "rows_per_round": rows_per_round, "seed": seed}
    out.update(_soak_realtime_device(seconds=seconds, seed=seed,
                                     fault_rate=fault_rate,
                                     progress=progress, device=device))
    out["elapsed_s"] = round(time.time() - t0, 1)
    return out


# ════════════════════════════════════════════════════════════════════════════
# Suite 4: failover — controller kills/restarts mid qps+ingest
# ════════════════════════════════════════════════════════════════════════════


def soak_failover(seconds: float = 30.0, seed: int = 0,
                  rows_per_segment: int = 40, progress=None,
                  capture_report: bool = False, device="cuda") -> dict:
    """Controller chaos: continuous exact-result broker queries plus a
    two-replica realtime ingest while the lead controller is killed and
    restarted (including windows with NO claimable leader). Invariants:
    exact-or-degraded-never-silently-wrong query responses throughout,
    consumers HOLD (never ERROR) through leaderless windows, and zero lost
    or duplicated committed segments at the end — every (partition, seq)
    has exactly one DONE record and the committed doc total equals the
    published row total."""
    from pinot_tpu_torch.cluster import (Broker, ClusterController,
                                         PropertyStore, ServerInstance)
    from pinot_tpu_torch.realtime.completion import LeaderCompletionClient
    from pinot_tpu_torch.realtime.manager import RealtimeTableDataManager
    from pinot_tpu_torch.segment.builder import SegmentBuilder
    from pinot_tpu_torch.spi.data_types import Schema
    from pinot_tpu_torch.spi.stream import GLOBAL_STREAM_REGISTRY
    from pinot_tpu_torch.spi.table_config import (IngestionConfig,
                                                  SegmentsValidationConfig,
                                                  TableConfig, TableType)

    rng = np.random.default_rng(seed)
    t0 = time.time()
    stats = {"queries": 0, "leader_kills": 0, "leader_restarts": 0,
             "leaderless_windows": 0}
    tmp = tempfile.TemporaryDirectory(prefix="pinot_soak_failover_")
    d = Path(tmp.name)

    # durable store: controller deaths must never cost control-plane state
    store = PropertyStore(data_dir=str(d / "store"), fsync="off")
    completion_cfg = {"num_replicas": 2, "commit_lease_s": 1.0,
                      "decision_wait_s": 1.0}
    live: dict[str, ClusterController] = {}
    for cid in ("Ctrl_0", "Ctrl_1"):
        live[cid] = ClusterController(store, instance_id=cid,
                                      completion_config=completion_cfg)
    controller = live["Ctrl_0"]  # any live one works for lifecycle calls

    # offline query plane (controller death must not perturb it)
    offline_schema = Schema.build(
        "stats", dimensions=[("team", "STRING")], metrics=[("runs", "INT")])
    controller.add_schema(offline_schema.to_json())
    table = controller.create_table({"tableName": "stats", "replication": 2})
    servers = [ServerInstance(store, f"Server_{i}", device=device,
                              backend="host")
               for i in range(3)]
    for s in servers:
        s.start()
    broker = Broker(store)
    teams = ["BOS", "NYA", "SFN", "LAN"]
    expected = {}
    for i in range(4):
        n = 300
        cols = {"team": np.asarray(teams, dtype=object)[
                    rng.integers(0, len(teams), n)],
                "runs": rng.integers(0, 100, n).astype(np.int32)}
        SegmentBuilder(offline_schema, segment_name=f"stats_{i}").build(
            cols, d / f"stats_{i}")
        controller.add_segment(table, f"stats_{i}",
                               {"location": str(d / f"stats_{i}"),
                                "numDocs": n})
        for t, r in zip(cols["team"], cols["runs"]):
            expected[t] = expected.get(t, 0) + int(r)
    sql = "SELECT team, SUM(runs) FROM stats GROUP BY team LIMIT 20"

    # realtime ingest through the leader-resolving completion client
    rt_schema = Schema.build(
        "events", dimensions=[("user", "STRING"), ("ts", "LONG")],
        metrics=[("n", "INT")])
    topic = f"soak_fo_{seed}_{int(t0 * 1000) % 100_000_000}"
    GLOBAL_STREAM_REGISTRY.create_topic(topic, num_partitions=1)
    rt_cfg = TableConfig(
        table_name="events", table_type=TableType.REALTIME,
        validation=SegmentsValidationConfig(time_column_name="ts"),
        ingestion=IngestionConfig(stream_configs={
            "streamType": "inmemory",
            "stream.inmemory.topic.name": topic,
            "realtime.segment.flush.threshold.rows": rows_per_segment,
            # time-based flush sweeps up sub-threshold leftovers (the last
            # partial segment after publishing stops would otherwise never
            # commit); mid-run it just makes extra, smaller segments
            "realtime.segment.flush.threshold.time.ms": 2000,
        }))
    client = LeaderCompletionClient(store, resolver=live.get)
    rt_a = RealtimeTableDataManager(rt_schema, rt_cfg, d / "rt_a",
                                    completion=client, instance_id="A")
    rt_b = RealtimeTableDataManager(rt_schema, rt_cfg, d / "rt_b",
                                    completion=client, instance_id="B")
    rt_a.start()
    rt_b.start()

    def kill(cid: str) -> None:
        """Crash, not resignation: the seat frees via session expiry."""
        c = live.pop(cid)
        c.leader.disconnect()
        store.expire_session(cid)
        c.leader.stop()  # release the watch; was-leader already cleared
        stats["leader_kills"] += 1

    def wait_until(pred, timeout=60.0):
        t = time.time()
        while time.time() - t < timeout:
            if pred():
                return True
            time.sleep(0.02)
        return False

    published = 0
    try:
        while time.time() - t0 < seconds:
            resp = broker.execute_sql(sql)
            if resp.exceptions:
                raise SoakFailure(
                    f"query error during failover chaos (seed {seed}): "
                    f"{resp.exceptions}")
            got = {r[0]: r[1] for r in resp.result_table.rows}
            if got != expected:
                raise SoakFailure(
                    f"wrong results during failover chaos (seed {seed}): "
                    f"got {got} want {expected}")
            stats["queries"] += 1

            GLOBAL_STREAM_REGISTRY.publish(topic, [
                {"user": f"u{(published + i) % 7}",
                 "ts": 1_600_000_000_000 + published + i, "n": 1}
                for i in range(10)])
            published += 10

            r = rng.random()
            from pinot_tpu_torch.cluster.leader import LEADER_PATH
            leader = (store.get(LEADER_PATH) or {}).get("instance")
            if r < 0.15 and leader in live:
                kill(leader)
                if not live:
                    stats["leaderless_windows"] += 1
                if rng.random() < 0.5 and len(live) == 1:
                    # occasionally take the standby down too: a real
                    # no-leader outage — consumers must HOLD through it
                    kill(next(iter(live)))
                    stats["leaderless_windows"] += 1
                    time.sleep(0.2)
            elif r < 0.30 and len(live) < 2:
                cid = next(c for c in ("Ctrl_0", "Ctrl_1") if c not in live)
                live[cid] = ClusterController(store, instance_id=cid,
                                              completion_config=completion_cfg)
                stats["leader_restarts"] += 1
            time.sleep(0.02)

        # drain: a leader must exist for the final flushes to finish
        if not live:
            live["Ctrl_0"] = ClusterController(store, instance_id="Ctrl_0",
                                               completion_config=completion_cfg)
            stats["leader_restarts"] += 1

        def drained(mgr):
            return sum(s.num_docs for s in mgr._committed) == published

        if not (wait_until(lambda: drained(rt_a))
                and wait_until(lambda: drained(rt_b))):
            raise SoakFailure(
                f"failover (seed {seed}): row loss — A committed "
                f"{sum(s.num_docs for s in rt_a._committed)}, B committed "
                f"{sum(s.num_docs for s in rt_b._committed)} of {published}")

        # zero lost or duplicated committed segments: DONE records cover
        # exactly seq 0..k-1 for partition 0 (a gap is a lost segment),
        # every record is DONE, and each replica's committed list matches
        # the store's DONE set one-to-one (a duplicate commit would show up
        # as a repeated name, a lost one as a hole). Doc conservation
        # (sum committed == published, checked above) rules out the same
        # rows landing in two segments — segments flush at >= the row
        # threshold, catching up past a leaderless window can legally
        # overshoot it.
        segs = sorted(store.children("/SEGMENTS/events"))
        seqs = sorted(int(s.split("__")[2]) for s in segs)
        if seqs != list(range(len(segs))):
            raise SoakFailure(
                f"failover (seed {seed}): committed seqs {seqs} have gaps "
                "or duplicates")
        for s in segs:
            rec = store.get(f"/SEGMENTS/events/{s}")
            if rec.get("status") != "DONE":
                raise SoakFailure(f"failover (seed {seed}): {s} not DONE")
        for tag, mgr in (("A", rt_a), ("B", rt_b)):
            names = sorted(seg.name for seg in mgr._committed)
            if names != segs:
                raise SoakFailure(
                    f"failover (seed {seed}): replica {tag} committed "
                    f"{names}, store has {segs}")
        for tag, mgr in (("A", rt_a), ("B", rt_b)):
            if any(m.state == "ERROR" for m in mgr._consuming.values()):
                raise SoakFailure(
                    f"failover (seed {seed}): consumer {tag} reached ERROR "
                    "— outages must HOLD, never ERROR")
    finally:
        if capture_report:
            # scrape through whichever live controller holds the leader
            # seat — a standby's checker correctly refuses to scrape
            try:
                ctrl = next((c for c in live.values()
                             if c.leader.is_leader), None)
                if ctrl is not None:
                    stats.update(_capture_cluster_report(store, ctrl,
                                                         broker))
            except Exception:
                pass
        rt_a.stop()
        rt_b.stop()
        for s in servers:
            try:
                s.stop()
            except Exception:
                pass
        for c in list(live.values()):
            c.stop()
        stats["store"] = store.durability_stats()
        store.close()
        tmp.cleanup()
    stats.update({"suite": "failover", "published_rows": published,
                  "elapsed_s": round(time.time() - t0, 1), "seed": seed})
    return stats


# ════════════════════════════════════════════════════════════════════════════
# Suite 6: rebalance — elastic capacity under live load
# ════════════════════════════════════════════════════════════════════════════


def soak_rebalance(seconds: float = 30.0, seed: int = 0,
                   n_segments: int = 8, rows_per_segment: int = 300,
                   fault_rate: float = 0.0, progress=None,
                   capture_report: bool = False, device="cuda") -> dict:
    """Elastic-capacity soak: continuous broker queries while servers are
    killed and added and the controller's DURABLE rebalance actuation loop
    (cluster/rebalance.py) heals the cluster — dead-server rebuilds from
    deep store, server-add spreading, plus one leader kill mid-job so the
    standby must resume from the /REBALANCE journal.

    Invariants: every response is exact or explicitly degraded
    (partialResult/exceptions) — never silently wrong; every completed
    job's final replica sets match its journaled target plan; and at the
    end every segment holds its full replica count on live servers with
    zero active jobs left behind.

    With ``fault_rate`` > 0 a seeded schedule is armed on the
    ``rebalance.move`` point (destination fetch of an in-flight move):
    errors/delays stall moves into the retry path and the loop must still
    converge inside the run budget."""
    import threading

    from pinot_tpu_torch.cluster import (Broker, ClusterController,
                                         PropertyStore, ServerInstance)
    from pinot_tpu_torch.cluster.rebalance import (ACTIVE_STATUSES, DONE,
                                                   RebalanceActuator,
                                                   SegmentRebalancer)
    from pinot_tpu_torch.segment.builder import SegmentBuilder
    from pinot_tpu_torch.spi import faults
    from pinot_tpu_torch.spi.data_types import Schema

    schema = Schema.build(
        "stats",
        dimensions=[("team", "STRING"), ("year", "INT")],
        metrics=[("runs", "INT")])
    teams = ["BOS", "NYA", "SFN", "LAN", "CHC", "HOU"]
    rng = np.random.default_rng(seed)
    tmp = tempfile.TemporaryDirectory(prefix="pinot_soak_rebalance_")
    d = Path(tmp.name)
    store = PropertyStore()
    live_ctrl = {"Ctrl_0": ClusterController(store, instance_id="Ctrl_0"),
                 "Ctrl_1": ClusterController(store, instance_id="Ctrl_1")}
    controller = live_ctrl["Ctrl_0"]
    replication = 2
    servers: dict[str, ServerInstance] = {}
    for i in range(3):
        s = ServerInstance(store, f"Server_{i}", device=device,
                           backend="host")
        s.start()
        servers[f"Server_{i}"] = s
    broker = Broker(store)
    controller.add_schema(schema.to_json())
    table = controller.create_table(
        {"tableName": "stats", "replication": replication})

    expected = {}
    for i in range(n_segments):
        n = rows_per_segment
        cols = {
            "team": np.asarray(teams, dtype=object)[
                rng.integers(0, len(teams), n)],
            "year": rng.integers(2000, 2020, n).astype(np.int32),
            "runs": rng.integers(0, 100, n).astype(np.int32),
        }
        name = f"stats_{i}"
        SegmentBuilder(schema, segment_name=name).build(cols, d / name)
        controller.add_segment(table, name,
                               {"location": str(d / name), "numDocs": n})
        for t, r in zip(cols["team"], cols["runs"]):
            expected[t] = expected.get(t, 0) + int(r)

    sql = ("SET allowPartialResults=true; SET resultCache=false; "
           "SELECT team, SUM(runs) FROM stats GROUP BY team LIMIT 20")
    stats = {"queries": 0, "degraded_queries": 0, "server_kills": 0,
             "server_adds": 0, "leader_kills": 0, "jobs_done": 0,
             "moves_completed": 0}
    if fault_rate > 0:
        armed = faults.seed_schedule(seed, fault_rate,
                                     points=("rebalance.move",))
        if progress:
            progress(f"rebalance: armed fault schedule on {sorted(armed)} "
                     f"(rate={fault_rate}, seed={seed})")

    # the actuator follows whichever controller holds the leader seat
    engines = {cid: RebalanceActuator(
        SegmentRebalancer(c, move_timeout_s=2.0, backoff_ms=50.0,
                          max_moves=4))
        for cid, c in live_ctrl.items()}

    failures: list = []
    stop = threading.Event()

    def hammer():
        while not stop.is_set():
            try:
                resp = broker.execute_sql(sql)
            except Exception as e:  # noqa: BLE001 — the soak records it
                failures.append(f"query raised: {e!r}")
                return
            stats["queries"] += 1
            if resp.exceptions or getattr(resp, "partial_result", False):
                # degraded is allowed — silently wrong is not
                stats["degraded_queries"] += 1
                continue
            got = {r[0]: r[1] for r in resp.result_table.rows}
            if got != expected:
                failures.append(f"silently wrong: got {got} "
                                f"want {expected}")
                return

    def tick_actuators():
        for cid in list(live_ctrl):
            out = engines[cid]()
            for val in (out.get("auto") or {}).values():
                if isinstance(val, str) and ":" in val \
                        and not val.startswith("skipped"):
                    trig = val.split(":", 1)[0]
                    t = stats.setdefault("triggers", {})
                    t[trig] = t.get(trig, 0) + 1

    def wait_jobs_drained(timeout: float) -> bool:
        t = time.time()
        while time.time() - t < timeout:
            tick_actuators()
            job = store.get(f"/REBALANCE/{table}")
            if not job or job.get("status") not in ACTIVE_STATUSES:
                if job and job.get("status") == DONE:
                    # the converged ideal state must BE the journaled plan
                    ideal = store.get(f"/IDEALSTATES/{table}") or {}
                    want = {s: set(m)
                            for s, m in (job.get("target") or {}).items()}
                    got = {s: set(m) for s, m in ideal.items()}
                    if want and got != want:
                        failures.append(
                            f"final assignment diverges from plan "
                            f"{job.get('jobId')}: {got} != {want}")
                    stats["jobs_done"] += 1
                    stats["moves_completed"] += job.get("segmentsDone", 0)
                    store.delete(f"/REBALANCE/{table}")
                return True
            time.sleep(0.02)
        return False

    next_id = 3
    killed_leader = False
    t0 = time.time()
    threads = [threading.Thread(target=hammer)]
    for t in threads:
        t.start()
    try:
        while time.time() - t0 < seconds and not failures:
            act = rng.random()
            if act < 0.5 and len(servers) > replication:
                # kill a server: dead-server trigger must rebuild replicas
                name = str(rng.choice(sorted(servers)))
                servers.pop(name).stop()
                stats["server_kills"] += 1
                if progress:
                    progress(f"rebalance: killed {name}")
            else:
                name = f"Server_{next_id}"
                next_id += 1
                s = ServerInstance(store, name, device=device,
                                   backend="host")
                s.start()
                servers[name] = s
                stats["server_adds"] += 1
                if progress:
                    progress(f"rebalance: added {name}")
            if not killed_leader and stats["jobs_done"] >= 1:
                # one crash mid-job: the standby resumes from the journal
                tick_actuators()
                if (store.get(f"/REBALANCE/{table}") or {}).get(
                        "status") in ACTIVE_STATUSES:
                    leader_id = next(c for c in live_ctrl
                                     if live_ctrl[c].is_leader())
                    c = live_ctrl.pop(leader_id)
                    c.leader.disconnect()
                    store.expire_session(leader_id)
                    c.leader.stop()
                    engines.pop(leader_id)
                    stats["leader_kills"] += 1
                    killed_leader = True
                    if progress:
                        progress(f"rebalance: killed leader {leader_id} "
                                 "mid-job")
            if not wait_jobs_drained(timeout=30.0):
                failures.append(
                    f"rebalance job stuck: {store.get(f'/REBALANCE/{table}')}")
                break
        # settle: drain any straggling job, then check the end state
        wait_jobs_drained(timeout=30.0)
        stop.set()
        for t in threads:
            t.join(timeout=10)
        live = set(store.children("/LIVEINSTANCES"))
        ideal = store.get(f"/IDEALSTATES/{table}") or {}
        for seg, m in ideal.items():
            online_live = [i for i in m if i in live]
            if len(online_live) < replication:
                failures.append(
                    f"{seg}: {len(online_live)} live replicas "
                    f"{online_live} < replication {replication}")
        if failures:
            raise SoakFailure(
                f"rebalance soak (seed {seed}): {failures[0]}")
        if stats["jobs_done"] == 0:
            raise SoakFailure(
                f"rebalance soak (seed {seed}): churned "
                f"{stats['server_kills']}+{stats['server_adds']} servers "
                "but completed zero rebalance jobs")
    finally:
        stop.set()
        if capture_report:
            try:
                ctrl = next((c for c in live_ctrl.values()
                             if c.is_leader()), None)
                if ctrl is not None:
                    stats.update(_capture_cluster_report(store, ctrl,
                                                         broker))
            except Exception:
                pass
        if fault_rate > 0:
            stats["injected_faults"] = faults.FAULTS.total_fired()
            faults.FAULTS.reset()
        for s in servers.values():
            try:
                s.stop()
            except Exception:
                pass
        for c in live_ctrl.values():
            c.stop()
        tmp.cleanup()
    stats.update({"suite": "rebalance",
                  "elapsed_s": round(time.time() - t0, 1), "seed": seed})
    return stats


# ════════════════════════════════════════════════════════════════════════════
# Suite 7: tiered storage — byte-budgeted cache under eviction churn
# ════════════════════════════════════════════════════════════════════════════


def soak_tiered(seconds: float = 20.0, seed: int = 0, n_tables: int = 6,
                segments_per_table: int = 3, rows_per_segment: int = 400,
                progress=None, device="cuda") -> dict:
    """Tiered-storage soak: ``n_tables`` tables of tarred deep-store
    segments whose total extracted bytes are a small multiple of each
    server's local byte budget, hammered by a randomized query mix
    (dense aggregation, sparse group-by, selection ORDER BY, MSE join)
    with occasional tight ``timeoutMs`` overrides so queries race cold
    warms. Invariants:

    * exact-or-degraded-never-silently-wrong: every FULL response
      (no exceptions, not partial) must match a fully-resident control
      cluster bit-for-bit; partial/errored responses are counted as
      degraded, never compared.
    * disk stays bounded: each server's tier accounting and a direct
      walk of its tier directory never exceed the byte budget plus
      in-flight fetches (one fetch per concurrently warming segment)
      plus pending-release zombies held by in-flight readers.
    * churn actually happened: the run must record cold loads AND
      evictions, or the budget never bit and the soak proves nothing.
    * final strict pass: with the cluster quiet, every query shape on
      every table (allowPartialResults OFF) returns bit-identical rows
      vs the control cluster — evicted data is re-fetchable, always.
    """
    import os
    import tarfile

    from pinot_tpu_torch.cluster import (Broker, ClusterController,
                                         PropertyStore, ServerInstance)
    from pinot_tpu_torch.segment.builder import SegmentBuilder
    from pinot_tpu_torch.spi.data_types import Schema
    from pinot_tpu_torch.spi.metrics import SERVER_METRICS, ServerMeter

    teams = ["BOS", "NYA", "SFN", "LAN", "CHC", "HOU"]
    regions = ["west", "east", "south"]
    rng = np.random.default_rng(seed)
    t0 = time.time()
    tmp = tempfile.TemporaryDirectory(prefix="pinot_soak_tiered_")
    d = Path(tmp.name)

    # -- build deep store: dirs for the control cluster, tars for the
    #    tiered one; measure extracted bytes to size the budget ----------
    def _walk_bytes(path) -> int:
        total = 0
        for root, _dirs, files in os.walk(path):
            for f in files:
                try:
                    total += os.stat(os.path.join(root, f)).st_size
                except OSError:
                    pass
        return total

    tables = [f"tier_{i}" for i in range(n_tables)]
    schemas = {}
    seg_dirs: dict[str, list] = {}
    seg_tars: dict[str, list] = {}
    table_bytes: dict[str, int] = {}
    max_seg_bytes = 0
    total_bytes = 0
    for t in tables:
        schemas[t] = Schema.build(
            t, dimensions=[("team", "STRING"), ("year", "INT")],
            metrics=[("runs", "INT")])
        seg_dirs[t], seg_tars[t] = [], []
        table_bytes[t] = 0
        for i in range(segments_per_table):
            n = rows_per_segment
            cols = {
                "team": np.asarray(teams, dtype=object)[
                    rng.integers(0, len(teams), n)],
                "year": rng.integers(2000, 2020, n).astype(np.int32),
                "runs": rng.integers(0, 100, n).astype(np.int32),
            }
            name = f"{t}_{i}"
            local = d / t / name
            SegmentBuilder(schemas[t], segment_name=name).build(cols, local)
            tar = d / t / f"{name}.tar.gz"
            with tarfile.open(tar, "w:gz") as tf:
                tf.add(local, arcname=name)
            nbytes = _walk_bytes(local)
            max_seg_bytes = max(max_seg_bytes, nbytes)
            table_bytes[t] += nbytes
            total_bytes += nbytes
            seg_dirs[t].append((name, str(local), n))
            seg_tars[t].append((name, str(tar), n))
    dim_schema = Schema.build(
        "tierdim", dimensions=[("dyear", "INT"), ("region", "STRING")])
    dim_cols = {"dyear": np.arange(2000, 2020, dtype=np.int32),
                "region": np.asarray([regions[y % 3] for y in range(20)],
                                     dtype=object)}
    SegmentBuilder(dim_schema, segment_name="tierdim_0").build(
        dim_cols, d / "tierdim_0")

    # budget: one table's bytes + slack. Any single table (the per-query
    # working set) fits resident, but the fleet of tables is ~n_tables/1.2
    # times over budget, so rotating the query mix across tables forces
    # continuous evict/refetch churn.
    budget_bytes = int(max(table_bytes.values()) * 1.2) + 4096
    budget_mb = budget_bytes / (1024 * 1024)

    def _bootstrap(suffix: str, locations, n_servers: int, storage_mb):
        store = PropertyStore()
        controller = ClusterController(store)
        servers = [ServerInstance(store, f"Server_{suffix}_{i}",
                                  device=device, backend="host",
                                  local_storage_mb=storage_mb)
                   for i in range(n_servers)]
        for s in servers:
            s.start()
        broker = Broker(store)
        for t in tables:
            controller.add_schema(schemas[t].to_json())
            handle = controller.create_table({"tableName": t,
                                              "replication": 1})
            for name, loc, n in locations[t]:
                controller.add_segment(handle, name,
                                       {"location": loc, "numDocs": n})
        controller.add_schema(dim_schema.to_json())
        handle = controller.create_table({"tableName": "tierdim",
                                          "replication": 1})
        controller.add_segment(handle, "tierdim_0",
                               {"location": str(d / "tierdim_0"),
                                "numDocs": 20})
        return store, controller, servers, broker

    # tiered cluster: tar locations + a byte budget. control cluster:
    # plain-dir locations, budget explicitly OFF (0, as in the reference,
    # where it also defeats an ambient PINOT_TPU_LOCAL_STORAGE_MB; the
    # port's servers read no environment).
    _, _, tier_servers, tier_broker = _bootstrap(
        "t", seg_tars, 2, budget_mb)
    _, _, _ctl_servers, ctl_broker = _bootstrap("c", seg_dirs, 1, 0)

    def _gen(table: str):
        shape = int(rng.integers(0, 4))
        cut = int(rng.integers(0, 90))
        if shape == 0:  # dense aggregation
            return (f"SELECT COUNT(*), SUM(runs), MIN(runs), MAX(runs) "
                    f"FROM {table}")
        if shape == 1:  # sparse group-by
            return (f"SELECT team, year, SUM(runs), COUNT(*) FROM {table} "
                    f"WHERE runs > {cut} GROUP BY team, year LIMIT 2000")
        if shape == 2:  # selection ORDER BY (full tuple is the sort key,
            # so the LIMIT-truncated multiset is deterministic)
            return (f"SELECT runs, year, team FROM {table} "
                    f"WHERE runs >= {cut} "
                    f"ORDER BY runs, year, team LIMIT 64")
        return (f"SELECT b.region, SUM(a.runs) FROM {table} a "
                f"JOIN tierdim b ON a.year = b.dyear "
                f"GROUP BY b.region LIMIT 20")

    control_cache: dict[str, list] = {}

    def _control_rows(sql: str) -> list:
        if sql not in control_cache:
            resp = ctl_broker.execute_sql("SET resultCache=false; " + sql)
            if resp.exceptions or getattr(resp, "partial_result", False):
                raise SoakFailure(
                    f"control cluster degraded (seed {seed}): {sql} "
                    f"→ {resp.exceptions}")
            control_cache[sql] = _canon(resp.result_table.rows)
        return control_cache[sql]

    meters0 = {
        "cold": SERVER_METRICS.meter_count(ServerMeter.SEGMENT_COLD_LOADS),
        "evict": SERVER_METRICS.meter_count(ServerMeter.SEGMENT_EVICTIONS),
    }
    stats = {"queries": 0, "exact": 0, "degraded": 0,
             "cold_warming_responses": 0, "disk_checks": 0}
    max_used = max_walk = 0

    def _check_disk():
        nonlocal max_used, max_walk
        for s in tier_servers:
            st = s._tier.stats()
            dbg = s.debug_storage()
            # one in-flight fetch per concurrently warming segment can sit
            # on disk before eviction catches up; zombies (evicted dirs
            # pinned by in-flight readers) are accounted separately
            inflight = max(1, len(dbg.get("warming", ())) + 1)
            allow = budget_bytes + inflight * max_seg_bytes
            used = st["bytesUsed"]
            max_used = max(max_used, used)
            if used > allow:
                raise SoakFailure(
                    f"tier accounting over budget (seed {seed}): "
                    f"{used} > {allow} on {s.instance_id}: {st}")
            base = st["baseDir"]
            if base:
                walk = _walk_bytes(base)
                max_walk = max(max_walk, walk)
                # extra max_seg_bytes of slack: the walk races live
                # fetch/evict activity between the stats() call and here
                if walk > allow + st["pendingReleaseBytes"] + max_seg_bytes:
                    raise SoakFailure(
                        f"tier DISK over budget (seed {seed}): walked "
                        f"{walk} > {allow} + pending "
                        f"{st['pendingReleaseBytes']} on {s.instance_id}")
        stats["disk_checks"] += 1

    failures: list = []
    try:
        # deterministic warm sweep first: one query per table guarantees
        # cold loads and (past the budget) evictions even at --seconds 0
        order = list(tables)
        deadline = t0 + max(0.0, seconds)
        while order or time.time() < deadline:
            table = order.pop(0) if order else str(rng.choice(tables))
            sql = _gen(table)
            prefix = "SET allowPartialResults=true; SET resultCache=false; "
            if not order and rng.random() < 0.2:
                # tight deadline: the query races the cold warms and must
                # degrade to a flagged partial, never a wrong answer
                prefix += f"SET timeoutMs={int(rng.integers(40, 140))}; "
            resp = tier_broker.execute_sql(prefix + sql)
            stats["queries"] += 1
            if getattr(resp, "cold_segments_warming", 0):
                stats["cold_warming_responses"] += 1
            if resp.exceptions or getattr(resp, "partial_result", False):
                stats["degraded"] += 1
            else:
                got = _canon(resp.result_table.rows)
                want = _control_rows(sql)
                if not _rows_equal(got, want):
                    raise SoakFailure(
                        f"silently wrong FULL response (seed {seed})\n{sql}\n"
                        f"got:  {got[:6]}…\nwant: {want[:6]}…")
                stats["exact"] += 1
            _check_disk()
            if progress and stats["queries"] % 200 == 0:
                progress(f"tiered: {stats}")

        # final strict pass: quiet cluster, partials OFF — every shape on
        # every table must now be bit-identical to the resident control
        final_checks = 0
        for table in tables:
            for sql in (
                f"SELECT COUNT(*), SUM(runs), MIN(runs), MAX(runs) "
                f"FROM {table}",
                f"SELECT team, year, SUM(runs), COUNT(*) FROM {table} "
                f"GROUP BY team, year LIMIT 2000",
                f"SELECT runs, year, team FROM {table} WHERE runs >= 50 "
                f"ORDER BY runs, year, team LIMIT 64",
                f"SELECT b.region, SUM(a.runs) FROM {table} a "
                f"JOIN tierdim b ON a.year = b.dyear "
                f"GROUP BY b.region LIMIT 20",
            ):
                resp = tier_broker.execute_sql(
                    "SET resultCache=false; " + sql)
                if resp.exceptions or getattr(resp, "partial_result", False):
                    raise SoakFailure(
                        f"final strict pass degraded (seed {seed}): {sql} "
                        f"→ {resp.exceptions}")
                if not _rows_equal(_canon(resp.result_table.rows),
                                   _control_rows(sql)):
                    raise SoakFailure(
                        f"final strict pass mismatch (seed {seed}): {sql}")
                final_checks += 1
        stats["final_checks"] = final_checks

        cold = SERVER_METRICS.meter_count(
            ServerMeter.SEGMENT_COLD_LOADS) - meters0["cold"]
        evict = SERVER_METRICS.meter_count(
            ServerMeter.SEGMENT_EVICTIONS) - meters0["evict"]
        if cold == 0 or evict == 0:
            raise SoakFailure(
                f"tiered soak never churned (seed {seed}): coldLoads={cold} "
                f"evictions={evict} — budget {budget_bytes} vs total "
                f"{total_bytes} bytes never bit")
        stats.update({"cold_loads": cold, "evictions": evict})
    finally:
        for s in tier_servers + _ctl_servers:
            try:
                s.stop()
            except Exception:
                pass
        tmp.cleanup()
    stats.update({
        "suite": "tiered", "seed": seed,
        "elapsed_s": round(time.time() - t0, 1),
        "budget_bytes": budget_bytes, "total_segment_bytes": total_bytes,
        "data_to_budget_ratio": round(total_bytes / budget_bytes, 2),
        "max_tier_bytes_used": max_used, "max_tier_bytes_walked": max_walk,
    })
    return stats


# ════════════════════════════════════════════════════════════════════════════
# Suite 8: regression sentinel — seeded slowdown → alert → exemplar → clear
# ════════════════════════════════════════════════════════════════════════════


def soak_sentinel(seconds: float = 30.0, seed: int = 0,
                  progress=None, device="cuda") -> dict:
    """Sentinel smoke: the full detect→pin→recover loop on a live
    cluster. A small table is hammered with an uncached group-by to
    build a reference window, then a seeded ``device.dispatch`` delay
    fault makes every dispatch slow; the sentinel must classify the
    shift as a named ``latency-drift`` alert within its fast window,
    pin at least one exemplar trace linked by alert id, and — once the
    fault lifts and clean evaluations accumulate — resolve the alert
    on its own. Any missed phase raises SoakFailure.

    The recovery is judged as the port's sentinel tests judge it: the
    reference window is persisted before the fault, and the ledger
    restarts from it after the fault (as a controller taking over
    restores /PERF/LEDGER), so the short window holds recovery queries
    only. With the fault's queries left in it, its p50 can stay past the
    drift rule on a loaded host although the latency is back."""
    from pinot_tpu_torch.cluster import (Broker, ClusterController,
                                         PropertyStore, ServerInstance)
    from pinot_tpu_torch.cluster.sentinel import PerfRegressionSentinel
    from pinot_tpu_torch.engine.perf_ledger import ALERTS, PERF_LEDGER, PerfLedger
    from pinot_tpu_torch.segment.builder import SegmentBuilder
    from pinot_tpu_torch.spi import faults
    from pinot_tpu_torch.spi.data_types import Schema

    progress = progress or (lambda m: None)
    rng = np.random.default_rng(seed)
    t0 = time.time()
    deadline = t0 + max(seconds, 20.0)
    tmp = tempfile.TemporaryDirectory(prefix="pinot_soak_sentinel_")
    d = Path(tmp.name)
    PERF_LEDGER.clear()
    ALERTS.clear()
    store = PropertyStore()
    controller = ClusterController(store)
    # backend="auto": the injected fault point lives on the device
    # dispatch path — the pure-host combine would never consult it
    server = ServerInstance(store, "Server_0", device=device, backend="auto")
    server.start()
    schema = Schema.build("sentinel_t",
                          dimensions=[("sk", "STRING")],
                          metrics=[("sv", "INT")])
    controller.add_schema(schema.to_json())
    controller.create_table({"tableName": "sentinel_t", "replication": 1})
    for i in range(2):
        n = 200
        cols = {"sk": np.asarray(["a", "b", "c", "d"], dtype=object)[
                    rng.integers(0, 4, n)],
                "sv": rng.integers(0, 100, n).astype(np.int32)}
        name = f"sentinel_t_{i}"
        SegmentBuilder(schema, segment_name=name).build(cols, d / name)
        controller.add_segment("sentinel_t_OFFLINE", name,
                               {"location": str(d / name), "numDocs": n})
    broker = Broker(store)
    sql = ("SET resultCache = false; SET segmentCache = false; "
           "SELECT sk, SUM(sv) FROM sentinel_t GROUP BY sk")
    stats = {"queries": 0, "alerts_fired": 0, "exemplars_pinned": 0,
             "rounds_to_fire": 0, "rounds_to_clear": 0}

    def _burst(n=6):
        for _ in range(n):
            resp = broker.execute_sql(sql)
            if resp.exceptions:
                raise SoakFailure(
                    f"sentinel soak (seed {seed}): query error "
                    f"{resp.exceptions}")
            stats["queries"] += 1

    try:
        progress("building reference window")
        _burst(8)
        PERF_LEDGER.rotate_now()
        PERF_LEDGER.persist(store)
        sentinel = PerfRegressionSentinel(store, controller, min_queries=3,
                                          breaches=2, clears=2)
        report = sentinel.evaluate()
        if report["anomalies"]:
            raise SoakFailure(
                f"sentinel soak (seed {seed}): anomalies on a clean "
                f"baseline: {report['anomalies']}")

        progress("injecting device.dispatch delay fault")
        alert = None
        with faults.injected("device.dispatch", kind="delay",
                             delay_s=0.05, times=None):
            for rnd in range(1, 13):
                if time.time() > deadline:
                    break
                _burst(6)
                sentinel.evaluate()
                if ALERTS.active_count:
                    stats["rounds_to_fire"] = rnd
                    alert = ALERTS.active()[0]
                    break
            if alert is None:
                raise SoakFailure(
                    f"sentinel soak (seed {seed}): injected 50ms dispatch "
                    "delay never produced an active alert")
            if alert["type"] != "latency-drift":
                raise SoakFailure(
                    f"sentinel soak (seed {seed}): expected latency-drift, "
                    f"got {alert['type']}")
            stats["alerts_fired"] = 1
            # exemplar pinning: the next matching queries run force-traced
            _burst(4)
        rec = ALERTS.get(alert["id"])
        exemplars = rec.get("exemplarTraceIds") or []
        stats["exemplars_pinned"] = len(exemplars)
        if not exemplars:
            raise SoakFailure(
                f"sentinel soak (seed {seed}): alert {alert['id']} fired "
                "but pinned no exemplar traces")
        entry = broker.trace_store.get(exemplars[0])
        if not entry or alert["id"] not in (entry.get("alertIds") or []):
            raise SoakFailure(
                f"sentinel soak (seed {seed}): exemplar {exemplars[0]} "
                "not cross-linked to its alert in the trace store")

        progress("fault lifted — waiting for recovery")
        PERF_LEDGER.clear()
        if PERF_LEDGER.restore(store) < 1:
            raise SoakFailure(
                f"sentinel soak (seed {seed}): the persisted reference "
                "window restored zero plans")
        for rnd in range(1, 13):
            if time.time() > deadline and rnd > 2:
                break
            _burst(6)
            sentinel.evaluate()
            if not ALERTS.active_count:
                stats["rounds_to_clear"] = rnd
                break
        if ALERTS.active_count:
            raise SoakFailure(
                f"sentinel soak (seed {seed}): alert {alert['id']} never "
                "cleared after the fault lifted")

        # ledger persistence round-trip through the live store
        PERF_LEDGER.persist(store)
        if PerfLedger().restore(store) < 1:
            raise SoakFailure(
                f"sentinel soak (seed {seed}): persisted ledger restored "
                "zero plans")
    finally:
        faults.FAULTS.reset()
        PERF_LEDGER.clear()
        ALERTS.clear()
        try:
            server.stop()
        except Exception:
            pass
        tmp.cleanup()
    stats.update({"suite": "sentinel", "seed": seed,
                  "elapsed_s": round(time.time() - t0, 1)})
    return stats


# ════════════════════════════════════════════════════════════════════════════
# CLI
# ════════════════════════════════════════════════════════════════════════════


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="pinot_tpu_torch soak/chaos harness (seeded, "
                    "reproducible)")
    p.add_argument("--suite", choices=["sql", "chaos", "qps", "realtime",
                                       "failover", "rebalance", "tiered",
                                       "sentinel", "all"],
                   default="all")
    p.add_argument("--seconds", type=float, default=45.0,
                   help="wall-clock budget per time-based suite "
                        "(sql, chaos, qps)")
    p.add_argument("--qps", type=float, default=50.0,
                   help="qps suite: aggregate target arrival rate")
    p.add_argument("--concurrency", type=int, default=8,
                   help="qps suite: number of concurrent query workers")
    p.add_argument("--max-inflight", type=int, default=0,
                   help="qps suite: arm broker admission control at this "
                        "many in-flight queries (0 = disabled); overload "
                        "then sheds as counted queryRejected responses")
    p.add_argument("--backend", choices=["host", "device"], default="host",
                   help="qps suite: server execution backend (device = the "
                        "device engine on --device, the reference's tpu)")
    p.add_argument("--families", type=int, default=0,
                   help="qps suite: rotate through N distinct query "
                        "families over the run (a traffic shift; the port "
                        "compiles nothing, so a shift boundary pays the "
                        "new family's first dispatch); 0 = the classic "
                        "single-family run")
    p.add_argument("--device", default="cuda",
                   help="the device of every executor and server: cuda "
                        "(default; raises without an H100) or cpu")
    p.add_argument("--rounds", type=int, default=3,
                   help="committer-crash rounds for the realtime suite")
    p.add_argument("--seed", type=int, default=20260731)
    p.add_argument("--rows", type=int, default=1600,
                   help="fuzz table rows for the sql suite")
    p.add_argument("--no-device-parity", action="store_true",
                   help="skip device-vs-host parity checks in the sql suite")
    p.add_argument("--fault-rate", type=float, default=0.0,
                   help="chaos suite: probability (0..1) of a seeded "
                        "injected fault per call at transport.call, "
                        "server.query and device.dispatch (rebalance "
                        "suite: at rebalance.move; realtime suite: at "
                        "realtime.upload during the device-plane churn "
                        "phase — error first half, corrupt second half); "
                        "chaos queries run with allowPartialResults=true "
                        "and degraded (partial/error) responses are "
                        "counted as faulted_queries instead of failing "
                        "the soak — full responses must still match "
                        "exactly. A realtime.upload fault fails its query "
                        "with RealtimeUploadError (counted as "
                        "device_faulted_uploads; a settle point asks "
                        "again), and every settle point stays exact")
    p.add_argument("--corrupt-rate", type=float, default=0.0,
                   help="chaos/qps suites: probability (0..1) of a seeded "
                        "data CORRUPTION per call (segment.load, "
                        "transport.call, datatable.encode). The integrity "
                        "layer must detect every strike — the summary "
                        "reports corruptions injected/detected/repaired, "
                        "and a silently wrong full answer fails the soak")
    p.add_argument("--report", metavar="PATH", default=None,
                   help="write a machine-readable run artifact (JSON) to "
                        "PATH: per-suite results, final per-role metrics "
                        "snapshots, broker cost-report aggregates, and the "
                        "anomaly list from a closing cluster-health scrape")
    p.add_argument("--quiet", action="store_true")
    args = p.parse_args(argv)

    def progress(msg):
        if not args.quiet:
            print(f"  … {msg}", file=sys.stderr, flush=True)

    results = []
    failed = None
    try:
        if args.suite in ("sql", "all"):
            results.append(soak_sql(
                seconds=args.seconds, seed=args.seed, rows=args.rows,
                device_parity=not args.no_device_parity, progress=progress,
                device=args.device))
        if args.suite in ("chaos", "all"):
            results.append(soak_chaos(
                seconds=args.seconds, seed=args.seed,
                fault_rate=args.fault_rate,
                corrupt_rate=args.corrupt_rate, progress=progress,
                capture_report=bool(args.report), device=args.device))
        if args.suite == "qps":
            results.append(soak_qps(
                seconds=args.seconds, seed=args.seed, qps=args.qps,
                concurrency=args.concurrency, fault_rate=args.fault_rate,
                corrupt_rate=args.corrupt_rate,
                max_inflight=args.max_inflight, backend=args.backend,
                families=args.families, progress=progress,
                capture_report=bool(args.report), device=args.device))
        if args.suite in ("realtime", "all"):
            results.append(soak_realtime(
                rounds=args.rounds, seed=args.seed, seconds=args.seconds,
                fault_rate=args.fault_rate, progress=progress,
                device=args.device))
        if args.suite == "failover":
            results.append(soak_failover(
                seconds=args.seconds, seed=args.seed, progress=progress,
                capture_report=bool(args.report), device=args.device))
        if args.suite == "rebalance":
            results.append(soak_rebalance(
                seconds=args.seconds, seed=args.seed,
                fault_rate=args.fault_rate, progress=progress,
                capture_report=bool(args.report), device=args.device))
        if args.suite == "tiered":
            results.append(soak_tiered(
                seconds=args.seconds, seed=args.seed, progress=progress,
                device=args.device))
        if args.suite == "sentinel":
            results.append(soak_sentinel(
                seconds=args.seconds, seed=args.seed, progress=progress,
                device=args.device))
    except SoakFailure as e:
        failed = str(e)

    summary = {"ok": failed is None, "results": results}
    if failed:
        summary["failure"] = failed
    if args.report:
        from pinot_tpu_torch.spi.metrics import (BROKER_METRICS,
                                                 CONTROLLER_METRICS,
                                                 SERVER_METRICS)
        anomalies = []
        cost_reports = {}
        for r in results:
            for a in r.get("anomalies", ()):
                anomalies.append(dict(a, suite=r.get("suite")))
            if r.get("workload"):
                cost_reports[r["suite"]] = r["workload"]
        report = {
            "schemaVersion": 1,
            "generatedAtMs": int(time.time() * 1000),
            "ok": failed is None,
            "failure": failed,
            "config": vars(args),
            "results": results,
            "metrics": {"server": SERVER_METRICS.snapshot(),
                        "broker": BROKER_METRICS.snapshot(),
                        "controller": CONTROLLER_METRICS.snapshot()},
            "costReports": cost_reports,
            "anomalies": anomalies,
        }
        Path(args.report).write_text(json.dumps(report, indent=2))
        progress(f"report written to {args.report}")
    print(json.dumps(summary))
    return 0 if failed is None else 1


if __name__ == "__main__":
    sys.exit(main())
