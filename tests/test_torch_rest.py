"""The port's REST servers (broker, controller, server) and access control
against the JAX package's.

Cases from `tests/test_rest_client.py` (REST parts), `test_auth_dbapi.py`
(auth parts), `test_quota_cursors_config.py` (the 429, cursors over
REST), `test_self_healing.py` (`/debug/servers`, the 429) and
`test_sentinel_rest.py` (the `/debug/*` routes of the flight recorder). A
port cluster and a JAX cluster (2 servers, replication 2, both brokers
round-robin) serve the same 4 segments of 2,000 rows, built once by the
port's builder from a numpy seed. Each case sends the same requests to
both and compares the status codes and the JSON bodies, with ids,
timestamps and ms fields taken out; bodies that describe one package's
own caches or devices are compared by their keys. Tolerance: exact.
"""

from __future__ import annotations

import re

import pytest

from _torch_ops import (BOTH, GROUP_SQL, PORT, ROWS, Cluster, basic,
                        build_segments, http, norm_rows, reset_process_state,
                        strip)

AUTH = [
    {"username": "admin", "password": "verysecret"},
    {"username": "reader", "password": "readonly", "permissions": ["READ"]},
    {"username": "scoped", "password": "pw", "tables": ["otherTable"]},
    {"token": "tok-123", "username": "svc", "permissions": ["READ"]},
]
COUNT_SQL = "SELECT COUNT(*) FROM ops"


@pytest.fixture(scope="module", autouse=True)
def _module_hygiene():
    reset_process_state()
    yield
    reset_process_state()


@pytest.fixture(scope="module")
def clusters(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    mp.setenv("PINOT_TPU_SEGMENT_CACHE", "0")
    mp.setenv("PINOT_TPU_RESULT_CACHE", "0")
    root = tmp_path_factory.mktemp("rest_segs")
    segs = build_segments(root)
    out = {}
    for pkg in BOTH:
        c = Cluster(pkg)
        c.table(segs, replication=2)
        c.rows()
        c.segs = segs
        c.root = root
        out[pkg.name] = c
    yield out
    for c in out.values():
        c.close()
    mp.undo()


@pytest.fixture(autouse=True)
def _reset_faults():
    yield
    for pkg in BOTH:
        pkg.faults.FAULTS.reset()


def _rest(c, kind, **kw):
    target = {"broker": c.broker, "controller": c.controller}.get(
        kind, c.servers[0])
    cls = {"broker": c.pkg.rest.BrokerRestServer,
           "controller": c.pkg.rest.ControllerRestServer,
           "server": c.pkg.rest.ServerRestServer}[kind]
    return cls(target, **kw)


def _each(clusters, fn, kind="broker", **kw):
    """``fn(pkg, cluster, rest_url)`` against a fresh REST server of each
    package; the server is closed afterwards."""
    out = {}
    for pkg in BOTH:
        c = clusters[pkg.name]
        rest = _rest(c, kind, **kw)
        try:
            out[pkg.name] = fn(pkg, c, rest.url)
        finally:
            rest.close()
    return out


def _rows(body) -> list:
    return norm_rows(body["resultTable"]["rows"])


def test_query_over_http(clusters):
    def run(pkg, c, url):
        code, body = http(url + "/query/sql", {"sql": GROUP_SQL})
        bad = http(url + "/query/sql", {"sql": "SELECT nope FROM ops"})
        missing = http(url + "/query/sql", {})
        return (code, _rows(body), bad[0], bool(bad[1]["exceptions"]),
                missing, http(url + "/nowhere")[0])

    got = _each(clusters, run)
    assert got["port"] == got["jax"]
    assert got["port"][0] == 200 and got["port"][2] == 500
    assert sum(r[2] for r in got["port"][1]) == 4 * ROWS


def test_rest_p50_path_serves_the_two_kernel_statements(clusters):
    """q2_family's shape (the segment batch) and q2's (segmentBatch off)
    answer the same rows over REST as through execute_sql."""
    sqls = [GROUP_SQL, "SET segmentBatch = false; " + GROUP_SQL]

    def run(pkg, c, url):
        return [(_rows(http(url + "/query/sql", {"sql": s})[1]), c.rows(s))
                for s in sqls]

    got = _each(clusters, run)
    assert got["port"] == got["jax"]
    assert all(a == b for a, b in got["port"])


def test_broker_debug_routes_answer_json(clusters):
    routes = ["/debug/queries", "/debug/cache", "/debug/servers",
              "/debug/workload", "/debug/traces", "/debug/compiles",
              "/debug/ledger", "/debug/alerts"]

    def run(pkg, c, url):
        out = {}
        for r in routes:
            code, body = http(url + r)
            out[r] = (code, sorted(body))
        out["missing_trace"] = http(url + "/debug/traces/nope")
        out["missing_alert"] = http(url + "/debug/alerts/nope")
        code, text = http(url + "/metrics")
        out["metrics"] = (code, all(
            re.fullmatch(r"(#.*|[A-Za-z_:][A-Za-z0-9_:]*(\{[^}]*\})? "
                         r"[-+0-9.eEinfNa]+)", line)
            for line in text.splitlines() if line))
        code, body = http(url + "/cache", method="DELETE")
        out["delete_cache"] = (code, sorted(body))
        out["timeseries"] = http(url + "/timeseries/api/v1/query_range",
                                 {"query": "fetch{table=ops}"})
        return out

    got = _each(clusters, run)
    assert got["port"] == got["jax"]
    assert all(v[0] == 200 for k, v in got["port"].items()
               if k.startswith("/"))
    assert got["port"]["metrics"] == (200, True)
    assert got["port"]["timeseries"] == (
        501, {"error": "timeseries engine not configured"})


def test_broker_debug_bodies(clusters):
    def run(pkg, c, url):
        c.broker.query_logger.slow_threshold_ms = 0.0
        c.rows()
        _, queries = http(url + "/debug/queries")
        _, servers = http(url + "/debug/servers")
        _, workload = http(url + "/debug/workload")
        _, cache = http(url + "/debug/cache")
        return {"slow": strip(queries["slowQueries"][0])["table"],
                "servers": sorted(servers["servers"]),
                "unhealthy": servers["unhealthy"],
                "workload": sorted(workload),
                "tables": sorted(workload["tables"]),
                "cache": sorted(cache),
                "resultCache": sorted(cache["resultCache"])}

    got = _each(clusters, run)
    assert got["port"] == got["jax"]
    assert got["port"]["servers"] == ["S0", "S1"]


def test_a_shed_query_answers_429_and_the_breaker_shows(clusters):
    def run(pkg, c, url):
        broker = c.broker
        saved = broker.admission
        broker.admission = pkg.cl.quota.AdmissionController(
            max_inflight=1, max_queued=0)
        broker.breakers.record_failure("S0")
        try:
            held = broker.admission.admit(timeout_s=5.0)
            held.__enter__()
            try:
                code, body = http(url + "/query/sql", {"sql": GROUP_SQL})
                _, dbg = http(url + "/debug/servers")
            finally:
                held.__exit__(None, None, None)
            after = http(url + "/query/sql", {"sql": GROUP_SQL})
            _, text = http(url + "/metrics")
        finally:
            broker.admission = saved
            broker.breakers.record_success("S0")
        return (code, body["queryRejected"], strip(dbg["servers"]["S0"]),
                after[0], "circuitBreakerState_S0" in text)

    got = _each(clusters, run)
    assert got["port"] == got["jax"]
    assert got["port"][0] == 429 and got["port"][1] is True
    assert got["port"][2]["consecutiveFailures"] == 1


def test_a_one_qps_quota_rejects_the_second_query(clusters):
    """A quota rejection is a failed query (500 with
    QueryQuotaExceededError), as in the JAX REST: only a query the
    admission gate shed answers 429."""
    def run(pkg, c, url):
        c.broker.quota.set_qps_limit("ops", 1)
        try:
            first = http(url + "/query/sql", {"sql": COUNT_SQL})
            second = http(url + "/query/sql", {"sql": COUNT_SQL})
        finally:
            c.broker.quota.set_qps_limit("ops", None)
        return (first[0], second[0], second[1].get("queryRejected"),
                any("QueryQuotaExceededError" in e
                    for e in second[1]["exceptions"]))

    got = _each(clusters, run)
    assert got["port"] == got["jax"]
    assert got["port"] == (200, 500, None, True)


def test_cursor_pages_over_http(clusters):
    def run(pkg, c, url):
        sql = "SELECT team, runs FROM ops ORDER BY runs, team LIMIT 50"
        code, page = http(url + "/query/sql",
                          {"sql": sql, "getCursor": True, "numRows": 20})
        cid = page["cursorId"]
        page2 = http(url + f"/resultStore/{cid}?offset=20&numRows=20")[1]
        deleted = http(url + f"/resultStore/{cid}", method="DELETE")
        gone = http(url + f"/resultStore/{cid}?offset=0&numRows=5")[0]
        return (code, page["numRows"], page["totalRows"],
                norm_rows(page2["resultTable"]["rows"]), deleted, gone)

    got = _each(clusters, run)
    assert got["port"] == got["jax"]
    assert got["port"][:3] == (200, 20, 50) and got["port"][5] == 404


def _auth_case(pkg, c, url):
    out = [http(url + "/query/sql", {"sql": COUNT_SQL})[0]]
    for user, pw in (("admin", "verysecret"), ("admin", "wrong"),
                     ("scoped", "pw"), ("reader", "readonly")):
        out.append(http(url + "/query/sql", {"sql": COUNT_SQL},
                        headers=basic(user, pw))[0])
    out.append(http(url + "/query/sql", {"sql": COUNT_SQL},
                    headers={"Authorization": "Bearer tok-123"}))
    # quoted identifiers and unparseable SQL cannot bypass a table grant
    for sql in ('SELECT COUNT(*) FROM "ops"', "???"):
        out.append(http(url + "/query/sql", {"sql": sql},
                        headers=basic("scoped", "pw"))[0])
    out.append(http(url + "/health")[0])
    out.append(http(url + "/metrics", raw=True)[0])
    out.append(http(url + "/debug/queries")[0])
    return out


def test_basic_auth_answers_401_and_403(clusters):
    def run(pkg, c, url):
        return _auth_case(pkg, c, url)

    got = {}
    for pkg in BOTH:
        c = clusters[pkg.name]
        rest = _rest(c, "broker",
                     access_control=pkg.auth.BasicAuthAccessControl(AUTH))
        ctl = _rest(c, "controller",
                    access_control=pkg.auth.BasicAuthAccessControl(AUTH))
        try:
            out = _auth_case(pkg, c, rest.url)
            out.append(http(ctl.url + "/tables", {"tableName": "x"},
                            headers=basic("reader", "readonly"))[0])
            out.append(http(ctl.url + "/tables/ops",
                            headers=basic("scoped", "pw"))[0])
            out.append(http(ctl.url + "/tables/otherTable",
                            headers=basic("scoped", "pw"))[0])
            got[pkg.name] = out
        finally:
            rest.close()
            ctl.close()
    bearer = [got[k].pop(5) for k in ("port", "jax")]
    assert got["port"] == got["jax"]
    assert [(b[0], _rows(b[1])) for b in bearer] == [
        (200, [[float(4 * ROWS)]])] * 2
    # no credentials, admin, a wrong password, a table outside the grant,
    # a reader; quoted and unparseable SQL of the scoped principal; the
    # open /health and /metrics, a guarded debug route; the controller:
    # a reader's write, a table outside the grant, a granted (absent) one
    assert got["port"] == [401, 200, 401, 403, 200, 403, 403, 200, 200, 401,
                           403, 403, 404]


def test_allow_all_access_control_is_the_default(clusters):
    def run(pkg, c, url):
        return http(url + "/query/sql", {"sql": COUNT_SQL})[1][
            "resultTable"]["rows"]

    got = {}
    for pkg in BOTH:
        rest = _rest(clusters[pkg.name], "broker",
                     access_control=pkg.auth.AllowAllAccessControl())
        try:
            got[pkg.name] = norm_rows(run(pkg, None, rest.url))
        finally:
            rest.close()
    assert got["port"] == got["jax"] == [[float(4 * ROWS)]]


def test_access_control_unit():
    out = {}
    for pkg in BOTH:
        ac = pkg.auth.BasicAuthAccessControl(AUTH)
        READ, WRITE = pkg.auth.READ, pkg.auth.WRITE
        admin = ac.authenticate(basic("admin", "verysecret"))
        svc = ac.authenticate({"authorization": "Bearer tok-123"})
        reader = ac.authenticate(basic("reader", "readonly"))
        scoped = ac.authenticate(basic("scoped", "pw"))
        out[pkg.name] = [
            admin.name, svc.name,
            ac.authenticate({"Authorization": "Bearer wrong"}),
            ac.authenticate({}), ac.authenticate(basic("admin", "bad")),
            ac.authenticate({"Authorization": "Basic !!!"}),
            reader.allows("ops", READ), reader.allows("ops", WRITE),
            scoped.allows("otherTable", READ), scoped.allows("ops", READ),
            scoped.allows("otherTable_OFFLINE", READ),
            ac.has_access(None, "ops", READ),
            ac.has_access(admin, "ops", WRITE),
            pkg.auth.AllowAllAccessControl().has_access(None, "x", WRITE)]
    assert out["port"] == out["jax"]
    assert out["port"][:2] == ["admin", "svc"]


def test_controller_routes(clusters):
    def run(pkg, c, url):
        out = {}
        for r in ("/tables", "/tables/ops", "/tables/nope", "/schemas/ops",
                  "/schemas/nope", "/segments/ops", "/instances",
                  "/cluster/summary", "/tables/ops/instancePartitions",
                  "/debug/rebalance", "/tables/ops/rebalanceStatus"):
            out[r] = strip(http(url + r))
        code, html = http(url + "/")
        out["/"] = (code, "<h1>Cluster</h1>" in html, "ops_OFFLINE" in html)
        code, store = http(url + "/debug/store")
        out["/debug/store"] = (code, store["isLeader"])
        out["recommender"] = http(url + "/recommender", {
            "schemaName": "ops",
            "queries": [{"sql": "SELECT COUNT(*) FROM ops WHERE "
                                "team = 'BOS'", "freq": 3},
                        {"sql": "SELECT year, SUM(runs) FROM ops "
                                "GROUP BY year", "freq": 1}],
            "cardinalities": {"team": 4, "year": 10}, "numRows": 8000})
        out["recommender_missing"] = http(url + "/recommender", {})[0]
        return out

    got = _each(clusters, run, kind="controller")
    assert got["port"] == got["jax"]
    port = got["port"]
    assert port["/tables"] == [200, {"tables": ["ops_OFFLINE"]}]
    assert port["/tables/nope"][0] == 404
    assert port["/"] == (200, True, True)
    assert port["recommender"][1]["tableIndexConfig"]["sortedColumn"] == \
        "team"


def test_controller_lifecycle_and_rebalance_over_rest(clusters, tmp_path):
    """Schema, table and segment lifecycle, then a rebalance onto a new
    server, its status, abort with nothing active, and instance
    partitions, over HTTP on a fresh cluster of each package."""
    from _torch_ops import SCHEMA, build_segment

    paths = [(f"r{i}", build_segment(tmp_path, f"r{i}", seed=10 + i))
             for i in range(2)]
    out = {}
    for pkg in BOTH:
        c = Cluster(pkg, n_servers=1)
        rest = pkg.rest.ControllerRestServer(c.controller)
        url = rest.url
        try:
            steps = [
                http(url + "/schemas", dict(SCHEMA.to_json(),
                                            schemaName="life")),
                http(url + "/tables", {"tableName": "life",
                                       "replication": 1})]
            for name, path in paths:
                steps.append(http(url + f"/segments/life/{name}",
                                  {"location": path, "numDocs": ROWS}))
            steps.append(http(url + "/segments/life"))
            c.add_server("S1")
            steps.append(strip(http(url + "/tables/life/rebalance"
                                          "?dryRun=true", {})))
            steps.append(strip(http(url + "/tables/life/rebalance", {})))
            steps.append(strip(http(url + "/tables/life/rebalanceStatus")))
            steps.append(strip(http(url + "/tables/life/rebalance/abort",
                                    {})))
            steps.append(strip(http(url + "/tables/life/relocate", {})))
            steps.append(http(url + "/tables/life/instancePartitions",
                              {"numReplicaGroups": 1}))
            steps.append(http(url + "/segments/life/r0", method="DELETE"))
            steps.append(http(url + "/tables/life", method="DELETE"))
            steps.append(http(url + "/tables"))
            out[pkg.name] = steps
        finally:
            rest.close()
            c.close()
    assert out["port"] == out["jax"]
    steps = out["port"]
    assert steps[5][0] == 200 and steps[5][1]["segmentsTotal"] == 1
    assert steps[6][1]["status"] == "DONE"


def test_server_routes(clusters):
    def run(pkg, c, url):
        out = {}
        for r in ("/tables", "/tables/ops_OFFLINE/segments",
                  "/tables/nope/segments", "/tables/ops_OFFLINE/size",
                  "/segments/ops_OFFLINE/s0/metadata",
                  "/segments/ops_OFFLINE/nope/metadata",
                  "/debug/tables/ops_OFFLINE", "/debug/segments",
                  "/debug/queries"):
            out[r] = strip(http(url + r))
        for r in ("/debug/compiles", "/debug/status", "/debug/storage",
                  "/instance"):
            code, body = http(url + r)
            out[r] = (code, sorted(body))
        out["kill"] = http(url + "/queries/nope/kill", {})
        return out

    got = _each(clusters, run, kind="server")
    port, jax = got["port"], got["jax"]
    # the port names its device beside its backend, and its status
    # carries its device listing and device cache
    assert port["/instance"][1] == sorted(
        set(jax["/instance"][1]) | {"device"})
    assert set(port["/debug/status"][1]) == set(jax["/debug/status"][1]) | {
        "device", "deviceCache"}
    for key in ("/instance", "/debug/status"):
        port.pop(key), jax.pop(key)
    assert port == jax
    assert port["/tables/nope/segments"][0] == 404
    assert port["kill"] == (404, {"queryId": "nope", "killed": False})
    assert port["/segments/ops_OFFLINE/s0/metadata"][1]["numDocs"] == ROWS


def test_server_readiness_and_metrics(clusters):
    def run(pkg, c, url):
        code, text = http(url + "/metrics")
        return http(url + "/health/readiness"), code, "# TYPE" in text

    got = _each(clusters, run, kind="server")
    assert got["port"] == got["jax"]
    assert got["port"] == ((200, {"status": "OK"}), 200, True)


def test_rest_servers_serve_the_port_on_its_configured_device(clusters):
    """Port only: the server REST reports the device its server runs on
    (the tests run it on the CPU; a server built without `device` runs on
    the card)."""
    c = clusters["port"]
    rest = PORT.rest.ServerRestServer(c.servers[0])
    try:
        code, body = http(rest.url + "/instance")
    finally:
        rest.close()
    assert (code, body["device"]) == (200, "cpu")
