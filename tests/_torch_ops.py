"""Shared scaffolding of the operations tests (REST, periodic tasks,
rebalance, fleet health): the two packages side by side, one set of
segment directories built by the port's builder from a numpy seed, small
clusters of either package over them, bounded waits, HTTP calls and the
field filter that takes ids, timestamps and ms fields out of a record
before two packages' records are compared.

A port cluster runs `ServerInstance(device="cpu")`, a JAX cluster
`ServerInstance(backend="host")`, as the JAX package's own tests run it.
"""

from __future__ import annotations

import base64
import json
import time
import urllib.error
import urllib.request
from types import SimpleNamespace

import numpy as np

import pinot_tpu.cluster as jcl
from pinot_tpu.cluster import auth as jauth
from pinot_tpu.cluster import periodic as jperiodic
from pinot_tpu.cluster import rebalance as jrebalance
from pinot_tpu.cluster import recommender as jrecommender
from pinot_tpu.cluster import rest as jrest
from pinot_tpu.engine import perf_ledger as jperf
from pinot_tpu.spi import faults as jfaults
from pinot_tpu.spi import metrics as jmetrics
from pinot_tpu_torch import cluster as pcl
from pinot_tpu_torch.cluster import auth as pauth
from pinot_tpu_torch.cluster import periodic as pperiodic
from pinot_tpu_torch.cluster import rebalance as prebalance
from pinot_tpu_torch.cluster import recommender as precommender
from pinot_tpu_torch.cluster import rest as prest
from pinot_tpu_torch.engine import perf_ledger as pperf
from pinot_tpu_torch.segment.builder import SegmentBuilder
from pinot_tpu_torch.spi import faults as pfaults
from pinot_tpu_torch.spi import metrics as pmetrics
from pinot_tpu_torch.spi.data_types import Schema

PORT = SimpleNamespace(name="port", cl=pcl, auth=pauth, periodic=pperiodic,
                       rebalance=prebalance, recommender=precommender,
                       rest=prest, faults=pfaults, metrics=pmetrics,
                       perf=pperf, server_kw={"device": "cpu"})
JAX = SimpleNamespace(name="jax", cl=jcl, auth=jauth, periodic=jperiodic,
                      rebalance=jrebalance, recommender=jrecommender,
                      rest=jrest, faults=jfaults, metrics=jmetrics,
                      perf=jperf, server_kw={"backend": "host"})
BOTH = (PORT, JAX)

TEAMS = ["BOS", "NYA", "SFN", "LAN"]
SCHEMA = Schema.build("ops", dimensions=[("team", "STRING"), ("year", "INT")],
                      metrics=[("runs", "INT")])
ROWS = 2000
NOCACHE = "SET resultCache = false; SET segmentCache = false; "
GROUP_SQL = NOCACHE + "SELECT team, SUM(runs), COUNT(*) FROM ops " \
    "GROUP BY team ORDER BY team LIMIT 10"

# record fields that differ between any two runs: ids, wall clocks, timings
_VOLATILE = {"jobId", "queryId", "requestId", "nonce", "alertId",
             "lineageId", "cursorId", "brokerId", "tsMs", "error", "detail",
             "fromPushMs"}


def build_segment(root, name: str, seed: int, rows: int = ROWS,
                  schema: Schema = SCHEMA) -> str:
    rng = np.random.default_rng(seed)
    cols = {"team": np.asarray(TEAMS, dtype=object)[rng.integers(0, 4, rows)],
            "year": rng.integers(2000, 2010, rows).astype(np.int32),
            "runs": rng.integers(0, 100, rows).astype(np.int32)}
    path = str(root / name)
    SegmentBuilder(schema, None, name).build(cols, path)
    return path


def build_segments(root, n: int = 4, prefix: str = "s",
                   rows: int = ROWS) -> list:
    """[(name, path)] of n segments, seeded by their index."""
    return [(f"{prefix}{i}", build_segment(root, f"{prefix}{i}", seed=i,
                                           rows=rows)) for i in range(n)]


class Cluster:
    """One package's store, controller, servers and broker."""

    def __init__(self, pkg, n_servers: int = 2, controller_id=None,
                 server_prefix: str = "S", **server_kw):
        self.pkg = pkg
        self.store = pkg.cl.PropertyStore()
        self.controller = pkg.cl.ClusterController(
            self.store, instance_id=controller_id)
        self.servers = []
        for i in range(n_servers):
            self.add_server(f"{server_prefix}{i}", **server_kw)
        self.controller.add_schema(SCHEMA.to_json())
        self.broker = pkg.cl.Broker(self.store, adaptive_selection=False)
        self.extra = []  # other controllers, REST servers, schedulers

    def add_server(self, name: str, **kw):
        s = self.pkg.cl.ServerInstance(self.store, name,
                                       **dict(self.pkg.server_kw, **kw))
        s.start()
        self.servers.append(s)
        return s

    def server(self, name: str):
        return next(s for s in self.servers if s.instance_id == name)

    def kill(self, name: str) -> None:
        """Stop a server for good (its live-instance entry goes)."""
        s = self.server(name)
        self.servers.remove(s)
        s.stop()

    def table(self, segments, replication: int = 1, **cfg) -> str:
        table = self.controller.create_table(
            dict({"tableName": "ops", "replication": replication}, **cfg))
        for name, path in segments:
            self.controller.add_segment(table, name,
                                        {"location": path, "numDocs": ROWS})
        return table

    def rows(self, sql: str = GROUP_SQL) -> list:
        resp = self.broker.execute_sql(sql)
        assert not resp.exceptions, resp.exceptions
        return norm_rows(resp.result_table.rows)

    def close(self) -> None:
        for x in reversed(self.extra):
            (getattr(x, "close", None) or x.stop)()
        if hasattr(self.broker, "close"):
            self.broker.close()
        for s in self.servers:
            s.stop()
        self.controller.stop()


def norm_rows(rows) -> list:
    return [[float(v) if isinstance(v, (int, float, np.number))
             and not isinstance(v, bool) else v for v in r] for r in rows]


def strip(x):
    """Drop ids, timestamps and ms fields, recursively."""
    if isinstance(x, dict):
        return {k: strip(v) for k, v in x.items()
                if not (k in _VOLATILE or k.endswith("Ms")
                        or k.endswith("_ms"))}
    if isinstance(x, (list, tuple)):
        return [strip(v) for v in x]
    return x


def ideal_sets(store, table: str) -> dict:
    return {s: sorted(m) for s, m in
            (store.get(f"/IDEALSTATES/{table}") or {}).items()}


def wait_for(pred, timeout_s: float = 10.0, step_s: float = 0.02):
    deadline = time.monotonic() + timeout_s
    while True:
        got = pred()
        if got or time.monotonic() >= deadline:
            return got
        time.sleep(step_s)


def http(url: str, body=None, method=None, headers=None, raw=False):
    """(status, JSON body, or text when the reply is not JSON)."""
    data = None if body is None else json.dumps(body).encode()
    hdrs = dict(headers or {})
    if data is not None:
        hdrs["Content-Type"] = "application/json"
    req = urllib.request.Request(url, data=data, method=method, headers=hdrs)
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            code, payload, ctype = r.status, r.read(), \
                r.headers.get("Content-Type", "")
    except urllib.error.HTTPError as e:
        code, payload, ctype = e.code, e.read(), \
            e.headers.get("Content-Type", "")
    text = payload.decode("utf-8")
    if raw or "json" not in ctype:
        return code, text
    return code, json.loads(text)


def basic(user: str, password: str) -> dict:
    token = base64.b64encode(f"{user}:{password}".encode()).decode()
    return {"Authorization": f"Basic {token}"}


def reset_process_state() -> None:
    """Empty both packages' perf ledgers and alert books and disarm both
    fault registries: a periodic thread or an alert left in an xdist
    worker must not reach the next file."""
    for pkg in BOTH:
        pkg.perf.PERF_LEDGER.clear()
        pkg.perf.ALERTS.clear()
        pkg.faults.FAULTS.reset()
