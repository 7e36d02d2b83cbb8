"""The port's DB-API (PEP 249) module against the JAX package's.

`test_dbapi_surface` and `test_quoted_identifier_cannot_bypass_table_acl`
of `tests/test_auth_dbapi.py`, each run through both packages: a cluster
of each package (the port's server on the CPU, the JAX package's on its
host backend) over the same segment, built once by the port's builder
from a numpy seed, behind each package's REST broker, driven by each
package's `dbapi` and client. Every description, row, rowcount, fetch
result and raised exception class must equal the JAX package's, and the
rows the numpy oracle's. Tolerance: exact.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest

import pinot_tpu.client as jclient
import pinot_tpu.dbapi as jdbapi
import pinot_tpu_torch.client as pclient
import pinot_tpu_torch.dbapi as pdbapi
from _torch_ops import JAX, PORT
from pinot_tpu_torch.segment.builder import SegmentBuilder
from pinot_tpu_torch.spi.data_types import Schema

SCHEMA = Schema.build(
    "stats", dimensions=[("team", "STRING")], metrics=[("runs", "INT")])
AUTH = [
    {"username": "admin", "password": "verysecret"},
    {"username": "reader", "password": "readonly", "permissions": ["READ"]},
    {"username": "scoped", "password": "pw", "tables": ["otherTable"]},
    {"token": "tok-123", "username": "svc", "permissions": ["READ"]},
]
PKGS = {"port": SimpleNamespace(ops=PORT, dbapi=pdbapi, client=pclient),
        "jax": SimpleNamespace(ops=JAX, dbapi=jdbapi, client=jclient)}


@pytest.fixture(scope="module")
def clusters(tmp_path_factory):
    rng = np.random.default_rng(5)
    cols = {"team": np.asarray(["BOS", "NYA"], dtype=object)[
        rng.integers(0, 2, 300)],
        "runs": rng.integers(0, 100, 300).astype(np.int32)}
    path = str(tmp_path_factory.mktemp("torch_dbapi") / "s0")
    SegmentBuilder(SCHEMA, None, "s0").build(cols, path)
    out = {}
    for name, pkg in PKGS.items():
        cl = pkg.ops.cl
        store = cl.PropertyStore()
        controller = cl.ClusterController(store)
        server = cl.ServerInstance(store, "S0", **pkg.ops.server_kw)
        server.start()
        broker = cl.Broker(store)
        controller.add_schema(SCHEMA.to_json())
        controller.create_table({"tableName": "stats", "replication": 1})
        controller.add_segment("stats_OFFLINE", "s0",
                               {"location": path, "numDocs": 300})
        out[name] = SimpleNamespace(pkg=pkg, broker=broker, server=server,
                                    controller=controller)
    yield out, cols
    for c in out.values():
        if hasattr(c.broker, "close"):
            c.broker.close()
        c.server.stop()
        c.controller.stop()


def _each(clusters, fn, **rest_kw):
    """fn(pkg, rest url) on each package behind a fresh REST broker; the
    port's result after holding it equal to the JAX package's."""
    out = {}
    for name, c in clusters.items():
        kw = dict(rest_kw)
        if "access_control" in kw:
            kw["access_control"] = c.pkg.ops.auth.BasicAuthAccessControl(AUTH)
        rest = c.pkg.ops.rest.BrokerRestServer(c.broker, **kw)
        try:
            out[name] = fn(c.pkg, rest.url)
        finally:
            rest.close()
    assert out["port"] == out["jax"]
    return out["port"]


def _raises(fn, exc):
    with pytest.raises(exc) as e:
        fn()
    return type(e.value).__name__


def test_dbapi_surface(clusters):
    clusters, cols = clusters

    def run(pkg, url):
        dbapi = pkg.dbapi
        out = {"module": (dbapi.apilevel, dbapi.paramstyle,
                          dbapi.threadsafety)}
        with dbapi.connect(url) as conn:
            cur = conn.cursor()
            cur.execute("SELECT team, SUM(runs) FROM stats GROUP BY team "
                        "ORDER BY team LIMIT 10")
            out["description"] = [(d[0], d[1] is dbapi.STRING,
                                   d[1] is dbapi.NUMBER)
                                  for d in cur.description]
            out["rows"] = [list(r) for r in cur.fetchall()]
            # parameter binding with escaping
            cur.execute("SELECT COUNT(*) FROM stats WHERE team = ? "
                        "AND runs >= ?", ("BOS", 0))
            out["bound"] = [cur.fetchone()[0], cur.fetchone()]
            # fetchone / fetchmany pagination
            cur.execute("SELECT team, runs FROM stats LIMIT 25")
            out["paged"] = [cur.rowcount, len(cur.fetchmany(10)),
                            len(cur.fetchall())]
            # the iteration protocol
            cur.execute("SELECT team FROM stats LIMIT 5")
            out["iterated"] = len(list(cur))
            # an injection attempt stays a literal
            cur.execute("SELECT COUNT(*) FROM stats WHERE team = ?",
                        ("BOS' OR '1'='1",))
            out["injection"] = cur.fetchone()[0]
            # errors map to the PEP 249 hierarchy
            out["errors"] = [
                _raises(lambda: cur.execute("SELECT FROM nothing"),
                        dbapi.OperationalError),
                _raises(lambda: cur.execute(
                    "SELECT 1 FROM stats WHERE team = ?", ()),
                    dbapi.ProgrammingError),
                _raises(conn.rollback, dbapi.NotSupportedError)]
            conn.commit()  # no-op
        out["closed"] = _raises(conn.cursor, dbapi.InterfaceError)
        return out

    got = _each(clusters, run)
    assert got["module"][:2] == ("2.0", "qmark")
    assert got["description"] == [("team", True, False),
                                  ("sum(runs)", False, True)]
    expected = {t: 0 for t in ("BOS", "NYA")}
    for t, r in zip(cols["team"], cols["runs"]):
        expected[t] += int(r)
    assert {r[0]: r[1] for r in got["rows"]} == expected
    assert [r[0] for r in got["rows"]] == ["BOS", "NYA"]
    assert got["bound"] == [int((cols["team"] == "BOS").sum()), None]
    assert got["paged"] == [25, 10, 15] and got["iterated"] == 5
    assert got["injection"] == 0


def test_quoted_identifier_cannot_bypass_table_acl(clusters):
    clusters, _ = clusters

    def run(pkg, url):
        err = pkg.client.PinotClientError
        out = []
        for sql in ('SELECT COUNT(*) FROM "stats"',
                    "???"):  # unparseable SQL + a table-scoped principal
            with pytest.raises(err, match="403") as e:
                pkg.client.connect(url, auth=("scoped", "pw")).execute(sql)
            out.append(str(e.value))
        return out

    got = _each(clusters, run, access_control=True)
    assert all("403" in m for m in got)
