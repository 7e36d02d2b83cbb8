"""HTTP REST layer for broker, controller and server roles.

The port's copy of pinot_tpu/cluster/rest.py. The REST servers serve
whatever broker, controller and ServerInstance they are given (a server
on its card by default). Where the JAX package reads its process-wide
device cache, the port reads each server's own cache: the broker's
/debug/cache and /debug/compiles list every live device cache in the
process, a server's routes its own. The broker's
/timeseries/api/v1/query_range runs the timeseries engine it is given
(timeseries/engine.py), and answers 501 without one.

Reference analogue: the broker's Jersey resources
(pinot-broker/.../api/resources/PinotClientRequest.java — POST /query/sql)
and the controller's 62 JAX-RS resources (pinot-controller/.../api/
resources/: tables, schemas, segments, rebalance). stdlib http.server keeps
the surface dependency-free; handlers delegate to the same objects the
in-proc tests drive.
"""

from __future__ import annotations

import json
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from urllib.parse import parse_qs, urlparse

from ..cache.partial import GLOBAL_PARTIAL_CACHE
from ..engine import aot_cache
from ..engine.compile_registry import COMPILE_REGISTRY
from ..engine.perf_ledger import ALERTS, PERF_LEDGER
from ..mse.ast import JoinRel, SetOpStmt, SubqueryRef, TableRef
from ..mse.parser import parse_relational
from ..query.parser.sql import SqlParseError, parse_sql
from ..segment.device_cache import live_caches
from ..spi.data_types import Schema
from ..spi.metrics import (BROKER_METRICS, CONTROLLER_METRICS,
                           PROMETHEUS_CONTENT_TYPE, SERVER_METRICS,
                           render_prometheus)
from ..spi.traceexport import to_chrome_trace
from ..timeseries.engine import parse_m3ql
from .auth import READ, AllowAllAccessControl
from .broker import Broker
from .controller import ClusterController, raw_table_name, \
    table_name_with_type
from .leader import LEADER_PATH
from .periodic import HEALTH_REPORT_PATH
from .rebalance import RebalanceInProgress, SegmentRebalancer
from .recommender import recommend
from .sentinel import SENTINEL_REPORT_PATH


def _referenced_tables(sql: str):
    """Raw table names a query reads, via the real parsers; None when the
    SQL cannot be parsed (callers deny for table-scoped principals)."""
    try:
        return {raw_table_name(parse_sql(sql).table_name)}
    except SqlParseError:
        pass
    try:
        tables = set()

        def walk_rel(rel):
            if rel is None:
                return
            if isinstance(rel, TableRef):
                tables.add(rel.name)
            elif isinstance(rel, SubqueryRef):
                walk_stmt(rel.query)
            elif isinstance(rel, JoinRel):
                walk_rel(rel.left)
                walk_rel(rel.right)

        def walk_stmt(stmt):
            if isinstance(stmt, SetOpStmt):
                walk_stmt(stmt.left)
                walk_stmt(stmt.right)
                return
            walk_rel(getattr(stmt, "from_rel", None))

        walk_stmt(parse_relational(sql).statement)
        return tables
    except Exception:
        return None


class RawHtml(str):
    """Marker: a handler returning this gets text/html instead of JSON."""


class RawText(str):
    """Marker: a handler returning this gets Prometheus text exposition
    content-type instead of JSON (the /metrics routes)."""


class _JsonHandler(BaseHTTPRequestHandler):
    routes_get: list = []
    routes_post: list = []
    routes_delete: list = []

    def log_message(self, fmt, *args):  # quiet
        pass

    def _reply(self, code: int, payload) -> None:
        if isinstance(payload, RawHtml):
            body = str(payload).encode("utf-8")
            ctype = "text/html; charset=utf-8"
        elif isinstance(payload, RawText):
            body = str(payload).encode("utf-8")
            ctype = PROMETHEUS_CONTENT_TYPE
        else:
            body = json.dumps(payload).encode("utf-8")
            ctype = "application/json"
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _body(self):
        n = int(self.headers.get("Content-Length", 0))
        if n == 0:
            return {}
        return json.loads(self.rfile.read(n).decode("utf-8"))

    # set by the owning _RestServer; None → AllowAll (no auth layer)
    access_control = None

    def _dispatch(self, routes, access_type: str = "READ") -> None:
        parsed = urlparse(self.path)
        ac = self.access_control
        self.principal = None
        routes = [r if len(r) == 3 else (r[0], r[1], access_type)
                  for r in routes]
        # health + metrics endpoints (incl. /health/liveness, /health/
        # readiness) are auth-exempt: orchestrator probes and Prometheus
        # scrapers carry no credentials (reference: health resources sit
        # outside the auth filter)
        if ac is not None and not isinstance(ac, AllowAllAccessControl) \
                and parsed.path not in ("/health", "/metrics") \
                and not parsed.path.startswith("/health/"):
            self.principal = ac.authenticate(self.headers)
            if self.principal is None:
                self.send_response(401)
                self.send_header("WWW-Authenticate", "Basic realm=\"pinot\"")
                self.end_headers()
                return
            # per-table refinement happens in the endpoints; here the
            # principal must hold the access TYPE at all (reference:
            # AccessControlUtils.validatePermission)
            for pattern, _fn, atype in routes:
                m = re.fullmatch(pattern, parsed.path)
                if m:
                    if atype not in self.principal.permissions:
                        self._reply(403,
                                    {"error": f"{atype} not permitted"})
                        return
                    # table-resource routes: first group is the table name
                    table = m.group(1) if m.groups() and pattern.startswith(
                        (r"/tables/", r"/segments/", r"/schemas/")) else None
                    if table and not self.principal.allows(table, atype):
                        self._reply(403, {
                            "error": f"{atype} on {table} not permitted"})
                        return
                    break
        for pattern, fn, _atype in routes:
            m = re.fullmatch(pattern, parsed.path)
            if m:
                try:
                    code, payload = fn(self, m, parse_qs(parsed.query))
                except Exception as e:  # surface as HTTP 500 JSON
                    code, payload = 500, {"error": f"{type(e).__name__}: {e}"}
                self._reply(code, payload)
                return
        self._reply(404, {"error": f"no route for {parsed.path}"})

    def do_GET(self):
        self._dispatch(self.routes_get, "READ")

    def do_POST(self):
        self._dispatch(self.routes_post, "WRITE")

    def do_DELETE(self):
        self._dispatch(self.routes_delete, "WRITE")


class _RestServer:
    def __init__(self, handler_cls, host: str = "127.0.0.1", port: int = 0):
        self._httpd = ThreadingHTTPServer((host, port), handler_cls)
        self.host = host
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()


def _device_caches(fn) -> list:
    """``fn(cache)`` for every device cache alive in this process (one per
    server executor), in a stable order."""
    return [fn(c) for c in sorted(live_caches(),
                                  key=lambda c: (str(c.device), id(c)))]


def _cache_telemetry(cache) -> dict:
    """A device cache's residency by kind, its budget, high-water mark and
    counters (the `hbm` section of GET /debug/compiles)."""
    return dict(cache.stats(), device=str(cache.device),
                budgetBytes=cache.budget_bytes,
                highWaterBytes=cache.high_water_bytes())


class BrokerRestServer(_RestServer):
    """POST /query/sql {"sql": ...} → BrokerResponse JSON (429 when
    admission control shed it); POST /timeseries/api/v1/query_range for
    the timeseries engine (501 without one); GET /health."""

    def __init__(self, broker: Broker, host: str = "127.0.0.1", port: int = 0,
                 timeseries_engine=None, access_control=None):
        srv = self

        class Handler(_JsonHandler):
            routes_get = [
                (r"/health/liveness",
                 lambda h, m, q: (200, {"status": "OK"})),
                (r"/health(/readiness)?", lambda h, m, q: srv._readiness()),
                (r"/metrics", lambda h, m, q: srv._metrics()),
                (r"/debug/queries", lambda h, m, q: srv._debug_queries()),
                (r"/debug/cache", lambda h, m, q: srv._debug_cache()),
                (r"/debug/servers", lambda h, m, q: srv._debug_servers()),
                (r"/debug/workload", lambda h, m, q: srv._debug_workload()),
                (r"/debug/traces", lambda h, m, q: srv._debug_traces()),
                (r"/debug/traces/([^/]+)",
                 lambda h, m, q: srv._debug_trace(m.group(1), q)),
                (r"/debug/compiles", lambda h, m, q: srv._debug_compiles()),
                (r"/debug/ledger", lambda h, m, q: srv._debug_ledger()),
                (r"/debug/alerts", lambda h, m, q: srv._debug_alerts()),
                (r"/debug/alerts/([^/]+)",
                 lambda h, m, q: srv._debug_alert(m.group(1))),
                # cursor ids are not table names: no group-based table check
                (r"/resultStore/([^/]+)", lambda h, m, q: srv._cursor_fetch(
                    m.group(1), int(q.get("offset", ["0"])[0]),
                    int(q.get("numRows", ["1000"])[0]), h.principal), "READ"),
            ]
            routes_post = [
                # queries are READs even though they POST
                (r"/query/sql",
                 lambda h, m, q: srv._query(h._body(), h.principal), "READ"),
                (r"/timeseries/api/v1/query_range",
                 lambda h, m, q: srv._timeseries(h._body(), h.principal),
                 "READ"),
            ]
            routes_delete = [
                (r"/resultStore/([^/]+)",
                 lambda h, m, q: srv._cursor_delete(m.group(1), h.principal),
                 "READ"),
                (r"/cache", lambda h, m, q: srv._cache_clear(), "WRITE"),
            ]

        Handler.access_control = access_control
        self.broker = broker
        self.timeseries_engine = timeseries_engine
        # cursor id → owning principal name (reference: response store
        # entries are owner-scoped); only the creator may fetch/delete
        self._cursor_owners = {}
        super().__init__(Handler, host, port)

    def _metrics(self):
        return 200, RawText(render_prometheus(BROKER_METRICS, role="broker"))

    def _readiness(self):
        """A broker is ready once it has materialized at least one routing
        snapshot — before that every query would fail routing anyway
        (reference: BrokerResourceOnlineOfflineStateModel readiness)."""
        ok = self.broker.is_ready()
        return (200 if ok else 503), {"status": "OK" if ok else "STARTING"}

    def _debug_workload(self):
        """Per-table/per-client decaying cost rollups + recent cost
        reports (cluster/workload.py) — the recommender-input section is
        POST /recommender body-compatible."""
        return 200, self.broker.workload.snapshot()

    def _debug_queries(self):
        """Slow-query ring buffer (worst traced queries over the
        threshold), fed by QueryLogger on every broker return path."""
        ql = self.broker.query_logger
        return 200, {"slowThresholdMs": ql.slow_threshold_ms,
                     "slowQueries": ql.slow_queries()}

    def _debug_cache(self):
        """All three cache tiers' live stats: the broker result cache plus
        (same process) the server-side segment partial cache and each
        live device cache's residency, device partials included."""
        return 200, {"resultCache": self.broker.result_cache.stats(),
                     "segmentPartialCache": GLOBAL_PARTIAL_CACHE.stats(),
                     "devicePartials": _device_caches(
                         lambda c: c.hbm_stats())}

    def _debug_servers(self):
        """Per-server circuit-breaker + adaptive-selection state (the
        broker's routing health table)."""
        return 200, {"servers": self.broker.server_health(),
                     "unhealthy": self.broker.breakers.down_count()}

    def _debug_traces(self):
        """Flight-recorder inventory: retention stats + newest-first
        summaries of every retained trace (cluster/tracestore.py)."""
        ts = self.broker.trace_store
        return 200, {"stats": ts.stats(), "traces": ts.summaries()}

    def _debug_trace(self, query_id: str, q: dict):
        """One retained trace — the raw merged span list, or Chrome Trace
        Event JSON via ``?format=chrome`` (open in ui.perfetto.dev or
        chrome://tracing; spi/traceexport.py)."""
        ent = self.broker.trace_store.get(query_id)
        if ent is None:
            return 404, {"error": f"no retained trace for {query_id}"}
        fmt = (q.get("format", ["json"])[0] or "json").lower()
        if fmt == "chrome":
            return 200, to_chrome_trace(ent["spans"], query_id=query_id)
        return 200, ent

    def _debug_ledger(self):
        """Per-plan performance ledger (engine/perf_ledger.py): rolling
        short/reference window summaries per fingerprint, global fallback
        events, per-table SLO burn rates, and the sentinel's last report
        when one has been published to the store."""
        out = PERF_LEDGER.snapshot()
        out["burnRates"] = {t: PERF_LEDGER.burn_rates(t)
                            for t in PERF_LEDGER.tables()}
        try:
            out["sentinel"] = self.broker.store.get(SENTINEL_REPORT_PATH)
        except Exception:
            out["sentinel"] = None
        return 200, out

    def _debug_alerts(self):
        """Regression-sentinel alert book: firing + recently cleared
        alerts, newest-first, each carrying its exemplar trace ids."""
        return 200, ALERTS.snapshot()

    def _debug_alert(self, alert_id: str):
        """One alert record; ``exemplarTraceIds`` resolve against
        GET /debug/traces/{id} (``?format=chrome`` for Perfetto)."""
        rec = ALERTS.get(alert_id)
        if rec is None:
            return 404, {"error": f"no alert {alert_id}"}
        return 200, rec

    def _debug_compiles(self):
        """Compile & device-memory telemetry (engine/compile_registry.py +
        segment/device_cache.py): families ranked by cumulative cold cost
        — the AOT-persist priority list — plus each live device cache's
        residency, high-water mark and evictions. Served from the broker
        because broker and servers share the process; the server REST
        serves the same payload for its own cache."""
        out = COMPILE_REGISTRY.snapshot()
        out["hbm"] = _device_caches(_cache_telemetry)
        out["aot"] = aot_cache.stats()
        return 200, out

    def _cache_clear(self):
        """DELETE /cache — drop every tier (operator hammer for debugging
        staleness or reclaiming memory; lineage invalidation is automatic)."""
        dropped = self.broker.result_cache.clear()
        GLOBAL_PARTIAL_CACHE.clear()
        device_dropped = sum(_device_caches(lambda c: c.drop_partials()))
        return 200, {"resultEntriesDropped": dropped,
                     "devicePartialsDropped": device_dropped,
                     "status": "cleared"}

    def _query(self, body: dict, principal=None):
        sql = body.get("sql")
        if not sql:
            return 400, {"error": "missing 'sql'"}
        if principal is not None:
            # table-level READ authorization on every referenced table,
            # resolved by the real parsers — a regex grammar would miss
            # quoted identifiers (reference:
            # BasicAuthBrokerRequestHandler table checks)
            tables = _referenced_tables(sql)
            if tables is None and "*" not in principal.tables:
                return 403, {"error": "cannot resolve tables for "
                                      "table-scoped principal"}
            for t in tables or ():
                if not principal.allows(t, READ):
                    return 403, {"error": f"READ on {t} not permitted"}
        if body.get("getCursor"):
            out = self.broker.execute_sql_cursor(
                sql, int(body.get("numRows", 1000)))
            if principal is not None and out.get("cursorId"):
                self._cursor_owners[out["cursorId"]] = principal.name
            return (200 if not out.get("exceptions") else 500), out
        resp = self.broker.execute_sql(sql)
        if getattr(resp, "query_rejected", False):
            # admission control shed the query — 429, not a server error
            return 429, resp.to_json()
        return (200 if not resp.exceptions else 500), resp.to_json()

    def _cursor_owned(self, cursor_id: str, principal) -> bool:
        if principal is None:
            return True  # no auth layer configured
        owner = self._cursor_owners.get(cursor_id)
        return owner is None or owner == principal.name

    def _cursor_fetch(self, cursor_id: str, offset: int, num_rows: int,
                      principal=None):
        if not self._cursor_owned(cursor_id, principal):
            return 403, {"error": "cursor belongs to another principal"}
        try:
            return 200, self.broker.fetch_cursor(cursor_id, offset, num_rows)
        except KeyError as e:
            return 404, {"error": str(e)}

    def _cursor_delete(self, cursor_id: str, principal=None):
        if not self._cursor_owned(cursor_id, principal):
            return 403, {"error": "cursor belongs to another principal"}
        self._cursor_owners.pop(cursor_id, None)
        return 200, {"deleted": self.broker.response_store.delete(cursor_id)}

    def _timeseries(self, body: dict, principal=None):
        """The timeseries engine's block as JSON; a table-scoped principal
        reads only the table its fetch names. A failing query (a
        TimeSeriesQueryError included) answers 500, as in the reference."""
        if self.timeseries_engine is None:
            return 501, {"error": "timeseries engine not configured"}
        if principal is not None:
            try:
                table = parse_m3ql(body.get("query", "")).fetch.table
            except Exception:
                table = None
            if table is None and "*" not in principal.tables:
                return 403, {"error": "cannot resolve table for "
                                      "table-scoped principal"}
            if table and not principal.allows(table, READ):
                return 403, {"error": f"READ on {table} not permitted"}
        block = self.timeseries_engine.execute(
            body["query"], int(body["start"]), int(body["end"]),
            int(body["step"]), body.get("language", "m3ql"))
        return 200, block.to_json()


class ControllerRestServer(_RestServer):
    """Table/schema/segment lifecycle endpoints (reference:
    PinotTableRestletResource, PinotSchemaRestletResource,
    PinotSegmentUploadDownloadRestletResource, rebalance endpoints)."""

    def __init__(self, controller: ClusterController,
                 host: str = "127.0.0.1", port: int = 0,
                 access_control=None):
        srv = self

        class Handler(_JsonHandler):
            routes_get = [
                (r"/health/liveness",
                 lambda h, m, q: (200, {"status": "OK"})),
                (r"/health/readiness", lambda h, m, q: srv._health()),
                # bare /health keeps the minimal LB-probe payload;
                # readiness above adds the seat (leader|standby)
                (r"/health", lambda h, m, q: (200, {"status": "OK"})),
                (r"/metrics", lambda h, m, q: srv._metrics()),
                (r"/tables", lambda h, m, q: srv._list_tables()),
                (r"/debug/cluster", lambda h, m, q: srv._debug_cluster()),
                (r"/tables/([^/]+)", lambda h, m, q: srv._get_table(m.group(1))),
                (r"/schemas/([^/]+)", lambda h, m, q: srv._get_schema(m.group(1))),
                (r"/segments/([^/]+)", lambda h, m, q: srv._list_segments(m.group(1))),
                (r"/instances", lambda h, m, q: (200, {
                    "instances": srv.controller.list_instances(),
                    "live": srv.controller.live_instances()})),
                (r"/cluster/summary", lambda h, m, q: srv._summary()),
                (r"/debug/store", lambda h, m, q: srv._debug_store()),
                (r"/tables/([^/]+)/rebalanceStatus",
                 lambda h, m, q: srv._rebalance_status(m.group(1))),
                (r"/debug/rebalance", lambda h, m, q: srv._debug_rebalance()),
                (r"/tables/([^/]+)/instancePartitions",
                 lambda h, m, q: srv._instance_partitions(m.group(1))),
                (r"/", lambda h, m, q: srv._home_page()),
            ]
            routes_post = [
                (r"/schemas", lambda h, m, q: srv._add_schema(h._body())),
                (r"/recommender", lambda h, m, q: srv._recommend(h._body()),
                 "READ"),
                (r"/tables", lambda h, m, q: srv._create_table(h._body())),
                (r"/segments/([^/]+)/([^/]+)",
                 lambda h, m, q: srv._add_segment(m.group(1), m.group(2), h._body())),
                (r"/tables/([^/]+)/rebalance",
                 lambda h, m, q: srv._rebalance(
                     m.group(1),
                     dry_run=q.get("dryRun", ["false"])[0] == "true")),
                (r"/tables/([^/]+)/rebalance/abort",
                 lambda h, m, q: srv._rebalance_abort(m.group(1))),
                (r"/tables/([^/]+)/relocate",
                 lambda h, m, q: (200, srv.controller.relocate_tiers(
                     table_name_with_type(m.group(1)),
                     dry_run=q.get("dryRun", ["false"])[0] == "true"))),
                (r"/tables/([^/]+)/instancePartitions",
                 lambda h, m, q: srv._assign_instances(m.group(1), h._body())),
            ]
            routes_delete = [
                (r"/tables/([^/]+)",
                 lambda h, m, q: srv._drop_table(m.group(1))),
                (r"/segments/([^/]+)/([^/]+)",
                 lambda h, m, q: srv._drop_segment(m.group(1), m.group(2))),
            ]

        Handler.access_control = access_control
        self.controller = controller
        super().__init__(Handler, host, port)

    def _metrics(self):
        return 200, RawText(
            render_prometheus(CONTROLLER_METRICS, role="controller"))

    def _health(self):
        """Controller health names its seat: the leader serves writes, a
        standby is healthy but deliberately idle (leader-gated periodic
        tasks do not run there)."""
        is_leader = self.controller.is_leader() \
            if hasattr(self.controller, "is_leader") else True
        return 200, {"status": "OK",
                     "role": "leader" if is_leader else "standby"}

    def _debug_cluster(self):
        """Fleet health rollup materialized by the leader's
        ClusterHealthChecker periodic task (cluster/periodic.py); a
        standby serves the leader-written snapshot from the store."""
        snap = self.controller.store.get(HEALTH_REPORT_PATH)
        if snap is None:
            return 503, {"error": "no health snapshot yet "
                                  "(leader scrape has not run)"}
        return 200, snap

    def _list_tables(self):
        return 200, {"tables": self.controller.store.children("/CONFIGS/TABLE")}

    def _get_table(self, name: str):
        cfg = self.controller.table_config(table_name_with_type(name))
        if cfg is None:
            cfg = self.controller.table_config(table_name_with_type(name, "REALTIME"))
        return (200, cfg) if cfg else (404, {"error": f"table {name} not found"})

    def _get_schema(self, name: str):
        s = self.controller.store.get(f"/SCHEMAS/{name}")
        return (200, s) if s else (404, {"error": f"schema {name} not found"})

    def _add_schema(self, body: dict):
        self.controller.add_schema(body)
        return 200, {"status": f"schema {body.get('schemaName')} added"}

    def _create_table(self, body: dict):
        name = self.controller.create_table(body)
        return 200, {"status": f"table {name} created", "tableName": name}

    def _list_segments(self, table: str):
        t = table_name_with_type(table)
        return 200, {"segments": self.controller.store.children(f"/SEGMENTS/{t}")}

    def _add_segment(self, table: str, segment: str, body: dict):
        assigned = self.controller.add_segment(
            table_name_with_type(table), segment, body)
        return 200, {"status": "added", "assigned": assigned}

    def _drop_table(self, table: str):
        self.controller.drop_table(table_name_with_type(table))
        return 200, {"status": f"table {table} dropped"}

    def _drop_segment(self, table: str, segment: str):
        self.controller.drop_segment(table_name_with_type(table), segment)
        return 200, {"status": f"segment {segment} dropped"}

    def _debug_store(self):
        """Control-plane durability introspection: journal/snapshot/recovery
        state of the property store plus the current leader seat."""
        store = self.controller.store
        out = dict(store.durability_stats())
        leader = store.get(LEADER_PATH)
        out["leaderInstance"] = (leader or {}).get("instance")
        out["thisInstance"] = getattr(self.controller, "instance_id", None)
        out["isLeader"] = self.controller.is_leader() \
            if hasattr(self.controller, "is_leader") else True
        return 200, out

    def _rebalance_status(self, table: str):
        st = self.controller.rebalance_status(table_name_with_type(table))
        return (200, st) if st else (404, {"error": "no rebalance recorded"})

    @property
    def rebalancer(self):
        """Lazily-built durable rebalance engine (cluster/rebalance.py);
        shared with the periodic actuator when one is registered."""
        if getattr(self, "_rebalancer", None) is None:
            self._rebalancer = SegmentRebalancer(self.controller)
        return self._rebalancer

    def _rebalance(self, table: str, dry_run: bool = False):
        """POST /tables/{t}/rebalance — journal a durable, make-before-break
        move plan and drive it to a terminal status inline (the journal at
        /REBALANCE/{t} means a crash mid-drive is resumed by any leader's
        RebalanceActuator rather than lost)."""
        nwt = table_name_with_type(table)
        try:
            if dry_run:
                return 200, self.rebalancer.plan(nwt, dry_run=True)
            return 200, self.rebalancer.run(nwt)
        except RebalanceInProgress as e:
            return 409, {"error": str(e)}
        except KeyError:
            return 404, {"error": f"table {table} not found"}
        except TimeoutError as e:
            return 200, {"status": "IN_PROGRESS", "detail": str(e),
                         "job": self.rebalancer.job(nwt)}
        except RuntimeError as e:
            return 409, {"error": str(e)}

    def _rebalance_abort(self, table: str):
        nwt = table_name_with_type(table)
        job = self.rebalancer.job(nwt)
        if not job:
            return 404, {"error": "no rebalance recorded"}
        return 200, self.rebalancer.abort(nwt)

    def _debug_rebalance(self):
        return 200, self.rebalancer.debug()

    def _instance_partitions(self, table: str):
        ip = self.controller.instance_partitions(table_name_with_type(table))
        return (200, ip) if ip else (404, {"error": "no instance partitions"})

    def _assign_instances(self, table: str, body: dict):
        ip = self.controller.configure_instance_partitions(
            table_name_with_type(table),
            int(body["numReplicaGroups"]),
            instances_per_group=body.get("instancesPerReplicaGroup"),
            num_partitions=body.get("numPartitions"))
        return 200, ip

    # -- cluster summary / minimal UI (reference: controller UI's cluster
    # manager pages, served as data here) ----------------------------------
    def _summary(self):
        store = self.controller.store
        tables = {}
        for nwt in store.children("/CONFIGS/TABLE"):
            segs = store.children(f"/SEGMENTS/{nwt}")
            view = store.get(f"/EXTERNALVIEW/{nwt}") or {}
            online = sum(1 for s in segs if view.get(s))
            tables[nwt] = {"segments": len(segs), "online": online,
                           "totalDocs": sum(
                               (store.get(f"/SEGMENTS/{nwt}/{s}") or {})
                               .get("numDocs", 0) for s in segs)}
        return 200, {
            "tables": tables,
            "instances": self.controller.list_instances(),
            "liveInstances": self.controller.live_instances(),
            "schemas": store.children("/SCHEMAS"),
        }

    def _home_page(self):
        _code, s = self._summary()
        rows = "".join(
            f"<tr><td>{t}</td><td>{v['segments']}</td><td>{v['online']}</td>"
            f"<td>{v['totalDocs']}</td></tr>" for t, v in s["tables"].items())
        live = set(s["liveInstances"])
        insts = "".join(
            f"<li>{i} {'&#9679; live' if i in live else '&#9675; down'}</li>"
            for i in s["instances"])
        html = (
            "<html><head><title>pinot-tpu cluster</title></head><body>"
            "<h1>Cluster</h1>"
            f"<h2>Tables ({len(s['tables'])})</h2>"
            "<table border=1><tr><th>table</th><th>segments</th>"
            f"<th>online</th><th>docs</th></tr>{rows}</table>"
            f"<h2>Instances</h2><ul>{insts}</ul>"
            "</body></html>")
        return 200, RawHtml(html)

    def _recommend(self, body: dict):
        """POST /recommender {schema, queries|queryStats, cardinalities,
        numRows, qps} (reference: PinotConfigRecommenderRestletResource)."""
        schema_json = body.get("schema")
        if schema_json is None:
            name = body.get("schemaName")
            schema_json = self.controller.store.get(f"/SCHEMAS/{name}")
            if schema_json is None:
                return 400, {"error": "missing 'schema' or known 'schemaName'"}
        rec = recommend(
            Schema.from_json(schema_json),
            queries=body.get("queries"),
            query_stats=body.get("queryStats"),
            cardinalities=body.get("cardinalities"),
            num_rows=int(body.get("numRows", 1_000_000)),
            qps=float(body.get("qps", 10.0)))
        return 200, rec.to_json()


class ServerRestServer(_RestServer):
    """Server-role admin/debug REST (reference: pinot-server/.../api/
    resources — TablesResource /tables + /tables/{t}/segments,
    /segments/{t}/{s}/metadata, DebugResource, HealthCheckResource
    /health/liveness + /health/readiness). Read-only introspection of one
    server's hosted state plus query-kill; cluster mutations stay on the
    controller REST."""

    def __init__(self, server, host: str = "127.0.0.1", port: int = 0,
                 access_control=None):
        srv = self

        class Handler(_JsonHandler):
            routes_get = [
                (r"/health/liveness", lambda h, m, q: (200, {"status": "OK"})),
                (r"/health(/readiness)?", lambda h, m, q: srv._readiness()),
                (r"/metrics", lambda h, m, q: srv._metrics()),
                (r"/instance", lambda h, m, q: srv._instance()),
                (r"/tables", lambda h, m, q: (200, {
                    "tables": sorted(srv.server.segments)})),
                (r"/tables/([^/]+)/segments",
                 lambda h, m, q: srv._table_segments(m.group(1))),
                (r"/tables/([^/]+)/size",
                 lambda h, m, q: srv._table_size(m.group(1))),
                (r"/segments/([^/]+)/([^/]+)/metadata",
                 lambda h, m, q: srv._segment_metadata(m.group(1), m.group(2))),
                (r"/debug/tables/([^/]+)",
                 lambda h, m, q: srv._debug_table(m.group(1))),
                (r"/debug/segments", lambda h, m, q: srv._debug_segments()),
                (r"/debug/queries", lambda h, m, q: srv._debug_queries()),
                (r"/debug/compiles", lambda h, m, q: srv._debug_compiles()),
                (r"/debug/status",
                 lambda h, m, q: (200, srv.server.health_status())),
                (r"/debug/storage",
                 lambda h, m, q: (200, srv.server.debug_storage())),
            ]
            routes_post = [
                (r"/queries/([^/]+)/kill",
                 lambda h, m, q: srv._kill_query(m.group(1)), "WRITE"),
            ]
            routes_delete = []

        Handler.access_control = access_control
        self.server = server
        super().__init__(Handler, host, port)

    def _metrics(self):
        return 200, RawText(render_prometheus(SERVER_METRICS, role="server"))

    def _readiness(self):
        """Readiness gates on Helix join + the FIRST converge pass having
        completed (reference: ServiceStatus ideal-state checkers) — a
        joined-but-unconverged server would serve missing-segment errors."""
        ok = bool(getattr(self.server, "_started", False)) \
            and bool(getattr(self.server, "_converged", True))
        return (200 if ok else 503), {"status": "OK" if ok else "STARTING"}

    def _instance(self):
        host, port = self.server.address
        return 200, {"instanceId": self.server.instance_id,
                     "host": host, "port": port,
                     "tags": self.server.tags,
                     "device": str(self.server.device),
                     "backend": self.server.backend}

    def _table_segments(self, table: str):
        segs = self.server.segments.get(table)
        if segs is None:
            return 404, {"error": f"table {table} not hosted"}
        return 200, {"segments": [
            {"name": name, "numDocs": seg.num_docs,
             "mutable": bool(getattr(seg, "is_mutable", False))}
            for name, seg in sorted(segs.items())]}

    def _table_size(self, table: str):
        segs = self.server.segments.get(table)
        if segs is None:
            return 404, {"error": f"table {table} not hosted"}
        per_seg = {}
        for name, seg in segs.items():
            loc = getattr(seg, "directory", None)
            nbytes = 0
            if loc:
                nbytes = sum(f.stat().st_size
                             for f in Path(loc).rglob("*") if f.is_file())
            per_seg[name] = {"diskSizeBytes": nbytes,
                             "numDocs": seg.num_docs}
        return 200, {"tableName": table, "segments": per_seg,
                     "totalDiskSizeBytes": sum(
                         v["diskSizeBytes"] for v in per_seg.values())}

    def _segment_metadata(self, table: str, segment: str):
        segs = self.server.segments.get(table) or {}
        seg = segs.get(segment)
        if seg is None:
            return 404, {"error": f"{table}/{segment} not hosted"}
        meta = {"segmentName": segment, "numDocs": seg.num_docs,
                "mutable": bool(getattr(seg, "is_mutable", False))}
        cols = {}
        for c in getattr(seg, "columns", lambda: [])() \
                if callable(getattr(seg, "columns", None)) \
                else getattr(seg, "columns", []):
            m = seg.column_metadata(c) if hasattr(seg, "column_metadata") \
                else None
            if m is not None:
                cols[c] = {"cardinality": getattr(m, "cardinality", None),
                           "dataType": str(getattr(m, "data_type", "")),
                           "singleValue": getattr(m, "single_value", True),
                           "minValue": _json_safe(getattr(m, "min_value", None)),
                           "maxValue": _json_safe(getattr(m, "max_value", None))}
        if cols:
            meta["columns"] = cols
        return 200, meta

    def _debug_table(self, table: str):
        """Hosted vs ideal comparison for one table (reference:
        DebugResource.getTableDebugInfo segment-error surface)."""
        hosted = set(self.server.segments.get(table) or {})
        ideal = self.server.store.get(f"/IDEALSTATES/{table}") or {}
        want = {s for s, inst_map in ideal.items()
                if self.server.instance_id in inst_map}
        return 200, {"tableName": table,
                     "hostedSegments": sorted(hosted),
                     "idealSegments": sorted(want),
                     "missing": sorted(want - hosted),
                     "unexpected": sorted(hosted - want)}

    def _debug_segments(self):
        """Served vs quarantined inventory across every hosted table —
        quarantine entries carry the verify-failure reason, damaged
        columns, and repair-attempt count (reference:
        DebugResource.getSegmentsDebugInfo error surface)."""
        return 200, {"tables": self.server.debug_segments()}

    def _debug_queries(self):
        accountant = self.server.scheduler.accountant
        return 200, {"inflight": accountant.inflight(),
                     "allocatedBytes": accountant.total_allocated()}

    def _debug_compiles(self):
        """Per-instance compile & device-memory telemetry — the broker's
        GET /debug/compiles payload with this server's device cache (the
        registries are process-wide)."""
        out = COMPILE_REGISTRY.snapshot()
        out["hbm"] = [_cache_telemetry(self.server.executor.executor.cache)]
        out["aot"] = aot_cache.stats()
        coalescer = getattr(getattr(self.server, "executor", None),
                            "coalescer", None)
        out["coalesce"] = coalescer.snapshot() if coalescer else {}
        return 200, out

    def _kill_query(self, query_id: str):
        ok = self.server.scheduler.accountant.kill_query(query_id)
        return (200 if ok else 404), {
            "queryId": query_id, "killed": ok}


def _json_safe(v):
    if hasattr(v, "item"):  # numpy scalar → native number, not a string
        try:
            return v.item()
        except (TypeError, ValueError):
            pass
    try:
        json.dumps(v)
        return v
    except (TypeError, ValueError):
        return str(v)
