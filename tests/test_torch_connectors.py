"""The port's connectors and HTTP client against the JAX package's.

The cases of tests/test_arrow_reader.py, the dataframe cases of
tests/test_evolution_leader_connector.py and the client cases of
tests/test_rest_client.py, each run on a port cluster (servers with
device="cpu") and a JAX cluster (backend="host") over the same segment
directories:

  * `scan_arrow`: both servers' `segment_ipc_bytes` of the same segment are
    equal bytes; `read_table`, `plan_scan`, `read_split` (with its replica
    failover and its fail-fast on an unknown column) and `scan_table` give
    the same rows as the JAX package's and as the data;
  * `client.connect(url).execute(sql)` against each package's
    BrokerRestServer gives the same result set; a failed query raises
    PinotClientError in both; `read_sql` / `read_sql_pandas` over the port's
    client give the JAX package's tables;
  * `infer_schema` and `write_dataframe` build the same schema and
    byte-equal segments, and epoch millis from datetime64 columns;
  * `StreamingSegmentWriter` cuts the same segments (bytes, names and
    pushed metadata) from the same rows, and a port cluster serves them.

The tolerance is exact: element-equal rows and bytes.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest

pa = pytest.importorskip("pyarrow")

import pinot_tpu.client as jclient  # noqa: E402
import pinot_tpu.connectors as jconn  # noqa: E402
import pinot_tpu.connectors.arrow_reader as jarrow  # noqa: E402
import pinot_tpu.connectors.dataframe as jdf  # noqa: E402
import pinot_tpu_torch.client as pclient  # noqa: E402
import pinot_tpu_torch.connectors as pconn  # noqa: E402
import pinot_tpu_torch.connectors.arrow_reader as parrow  # noqa: E402
import pinot_tpu_torch.connectors.dataframe as pdf  # noqa: E402
from pinot_tpu.cluster import Broker as JBroker  # noqa: E402
from pinot_tpu.cluster import ClusterController as JController  # noqa: E402
from pinot_tpu.cluster import PropertyStore as JStore  # noqa: E402
from pinot_tpu.cluster import ServerInstance as JServer  # noqa: E402
from pinot_tpu.cluster.rest import BrokerRestServer as JRest  # noqa: E402
from pinot_tpu.segment.loader import load_segment as jload  # noqa: E402
from pinot_tpu.spi.data_types import Schema as JSchema  # noqa: E402
from pinot_tpu_torch.cluster import (Broker, ClusterController,  # noqa: E402
                                     PropertyStore, ServerInstance)
from pinot_tpu_torch.cluster.rest import BrokerRestServer  # noqa: E402
from pinot_tpu_torch.segment.builder import SegmentBuilder  # noqa: E402
from pinot_tpu_torch.segment.loader import load_segment  # noqa: E402
from pinot_tpu_torch.spi.data_types import Schema  # noqa: E402

DIMS = [("name", "STRING"), ("code", "INT"), ("tags", "INT", False)]
METRICS = [("v", "INT"), ("score", "DOUBLE")]
SEGMENTS = 4


def _cols(rng, n=250):
    return {
        "name": np.asarray(["ann", "bob", "cat", "dan"], dtype=object)[
            rng.integers(0, 4, n)],
        "code": rng.integers(0, 50, n).astype(np.int32),
        "tags": [rng.integers(0, 9, rng.integers(0, 4)).astype(np.int32)
                 for _ in range(n)],
        "v": rng.integers(-500, 500, n).astype(np.int32),
        "score": np.round(rng.random(n) * 100, 3),
    }


def _start(pkg, tmp_path, replication=2, servers=3):
    """A cluster of `pkg` over the shared segment directories."""
    if pkg == "port":
        store_cls, ctl_cls, brk, schema_cls = (PropertyStore,
                                               ClusterController, Broker,
                                               Schema)

        def srv(st, i):
            return ServerInstance(st, f"Server_{i}", device="cpu")
    else:
        store_cls, ctl_cls, brk, schema_cls = JStore, JController, JBroker, \
            JSchema

        def srv(st, i):
            return JServer(st, f"Server_{i}", backend="host")
    store = store_cls()
    ctl = ctl_cls(store)
    insts = [srv(store, i) for i in range(servers)]
    for s in insts:
        s.start()
    broker = brk(store)
    ctl.add_schema(schema_cls.build("ar", dimensions=DIMS,
                                    metrics=METRICS).to_json())
    table = ctl.create_table({"tableName": "ar",
                              "replication": replication})
    for i in range(SEGMENTS):
        ctl.add_segment(table, f"ar{i}", {"location": str(tmp_path / f"ar{i}"),
                                          "numDocs": 250})
    return {"store": store, "controller": ctl, "servers": insts,
            "broker": broker, "table": table}


def _stop(c):
    for s in c["servers"]:
        if getattr(s, "_started", True):
            try:
                s.stop()
            except Exception:  # a server a test stopped already
                pass
    if hasattr(c["broker"], "close"):
        c["broker"].close()


@pytest.fixture(scope="module")
def clusters(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("connectors")
    rng = np.random.default_rng(11)
    schema = Schema.build("ar", dimensions=DIMS, metrics=METRICS)
    data = []
    for i in range(SEGMENTS):
        cols = _cols(rng)
        SegmentBuilder(schema, segment_name=f"ar{i}").build(cols,
                                                            tmp / f"ar{i}")
        data.append(cols)
    both = {pkg: _start(pkg, tmp) for pkg in ("port", "jax")}
    yield tmp, both, data
    for c in both.values():
        _stop(c)


def _expected_rows(data, cols):
    rows = []
    for d in data:
        for i in range(len(d["v"])):
            rows.append(tuple(
                [int(v) for v in d[c][i]] if c == "tags" else
                (d[c][i].item() if isinstance(d[c][i], np.generic)
                 else d[c][i])
                for c in cols))
    return sorted(rows, key=repr)


def _table_rows(t, cols):
    pydict = t.to_pydict()
    return sorted((tuple(pydict[c][i] for c in cols)
                   for i in range(t.num_rows)), key=repr)


# -- scan_arrow and the Arrow reader ------------------------------------------


def test_segment_ipc_bytes_equal_jax(clusters):
    tmp, _both, _data = clusters
    for i in range(SEGMENTS):
        for cols in (None, ["code", "tags"], ["score", "name"]):
            got = parrow.segment_ipc_bytes(load_segment(tmp / f"ar{i}"), cols)
            want = jarrow.segment_ipc_bytes(jload(tmp / f"ar{i}"), cols)
            assert got == want


def test_scan_arrow_request_equal_jax(clusters):
    from pinot_tpu.cluster.transport import RpcClient as JRpc
    from pinot_tpu_torch.cluster.transport import RpcClient

    _tmp, both, _data = clusters
    out = {}
    for pkg, rpc in (("port", RpcClient), ("jax", JRpc)):
        c = both[pkg]
        srv = c["servers"][0]
        host, port = srv.address
        hosted = sorted(srv.segments[c["table"]])
        client = rpc(host, port)
        try:
            out[pkg] = [client.call({"type": "scan_arrow",
                                     "table": c["table"], "segment": seg,
                                     "columns": None}) for seg in hosted]
        finally:
            client.close()
    assert [o["numRows"] for o in out["port"]] == \
        [o["numRows"] for o in out["jax"]]
    assert [o["ipc"] for o in out["port"]] == [o["ipc"] for o in out["jax"]]


def test_read_table_and_scan_table_equal_jax_and_data(clusters):
    _tmp, both, data = clusters
    cols = ["name", "code", "v", "score"]
    got = {}
    for pkg, arrow, df in (("port", parrow, pdf), ("jax", jarrow, jdf)):
        c = both[pkg]
        t = arrow.read_table(c["broker"], c["table"], columns=cols,
                             num_readers=4)
        sql_rows = []
        for _seg, batch in df.scan_table(c["broker"], c["table"], cols):
            d = batch.to_pydict()
            sql_rows.extend(tuple(d[k][i] for k in cols)
                            for i in range(batch.num_rows))
        got[pkg] = (_table_rows(t, cols), sorted(sql_rows, key=repr))
    assert got["port"] == got["jax"]
    assert got["port"][0] == got["port"][1] == _expected_rows(data, cols)


def test_mv_and_default_columns_equal_jax(clusters):
    _tmp, both, data = clusters
    got = {}
    for pkg, arrow in (("port", parrow), ("jax", jarrow)):
        c = both[pkg]
        t = arrow.read_table(c["broker"], c["table"], columns=["code", "tags"])
        assert pa.types.is_list(t.schema.field("tags").type)
        full = arrow.read_table(c["broker"], c["table"])
        got[pkg] = (_table_rows(t, ["code", "tags"]), full.schema.names,
                    full.num_rows)
    assert got["port"] == got["jax"]
    assert got["port"][0] == _expected_rows(data, ["code", "tags"])
    assert set(got["port"][1]) == {"name", "code", "tags", "v", "score"}
    assert got["port"][2] == 1000


def test_plan_scan_and_unknown_column_equal_jax(clusters):
    _tmp, both, _data = clusters
    for pkg, arrow in (("port", parrow), ("jax", jarrow)):
        c = both[pkg]
        splits = arrow.plan_scan(c["broker"], c["table"])
        assert [s.segment for s in splits] == ["ar0", "ar1", "ar2", "ar3"]
        assert all(len(s.addresses) == 2 for s in splits)  # replication 2
        with pytest.raises(Exception, match="unknown column"):
            arrow.read_split(splits[0], columns=["nope"])
    with pytest.raises(RuntimeError, match="no routable segments"):
        parrow.read_table(both["port"]["broker"], "nosuch_OFFLINE")


def test_read_split_fails_over_as_jax(tmp_path):
    rng = np.random.default_rng(3)
    schema = Schema.build("ar", dimensions=DIMS, metrics=METRICS)
    for i in range(SEGMENTS):
        SegmentBuilder(schema, segment_name=f"ar{i}").build(
            _cols(rng), tmp_path / f"ar{i}")
    got = {}
    for pkg, arrow in (("port", parrow), ("jax", jarrow)):
        c = _start(pkg, tmp_path)
        try:
            splits = arrow.plan_scan(c["broker"], c["table"])
            # the first-listed replica dies AFTER planning: the reader
            # fails over to the surviving address
            victim = splits[0].addresses[0]
            for s in c["servers"]:
                if s.address == victim:
                    s.stop()
                    break
            batch = arrow.read_split(splits[0], columns=["code", "v"])
            got[pkg] = batch.to_pydict()
        finally:
            _stop(c)
    assert got["port"] == got["jax"]
    assert len(got["port"]["v"]) == 250


# -- the HTTP client --------------------------------------------------------------


@pytest.fixture(scope="module")
def rests(clusters):
    _tmp, both, _data = clusters
    servers = {"port": BrokerRestServer(both["port"]["broker"]),
               "jax": JRest(both["jax"]["broker"])}
    yield servers
    for s in servers.values():
        s.close()


def _result(rs):
    return rs.column_names, rs.column_types, rs.rows, len(rs)


def test_client_result_sets_equal_jax(rests):
    sqls = ("SELECT name, SUM(v), COUNT(*) FROM ar GROUP BY name "
            "ORDER BY name",
            "SELECT code, MAX(score) FROM ar WHERE v > 0 GROUP BY code "
            "ORDER BY code LIMIT 5",
            "SELECT COUNT(*) FROM ar")
    for sql in sqls:
        got = pclient.connect(rests["port"].url).execute(sql)
        want = jclient.connect(rests["jax"].url).execute(sql)
        assert _result(got) == _result(want)
        # the port's client reads the JAX broker's answer the same way
        cross = pclient.connect(rests["jax"].url).execute(sql)
        assert _result(cross) == _result(want)
    assert got.rows == [[1000]] and got.get(0, "count(*)") == 1000
    assert got.execution_stats["numDocsScanned"] == \
        want.execution_stats["numDocsScanned"] == 1000
    assert list(got) == got.rows


def test_client_errors_equal_jax(rests):
    for client, url in ((pclient, rests["port"].url),
                        (jclient, rests["jax"].url)):
        with pytest.raises(client.PinotClientError, match="not found"):
            client.connect(url).execute("SELECT * FROM nosuch")
        with pytest.raises(client.PinotClientError, match="cannot reach"):
            client.connect("http://127.0.0.1:9", timeout_s=2).execute(
                "SELECT 1")


def test_read_sql_over_the_client_equals_jax(rests):
    sql = ("SELECT name, code, v, score FROM ar "
           "ORDER BY v, code, score, name LIMIT 2000")
    got = pdf.read_sql(sql, broker_url=rests["port"].url)
    want = jdf.read_sql(sql, broker_url=rests["jax"].url)
    assert got.schema == want.schema
    assert _table_rows(got, got.schema.names) == \
        _table_rows(want, want.schema.names)
    assert got.num_rows == 1000
    agg = "SELECT name, SUM(v) FROM ar GROUP BY name ORDER BY name LIMIT 10"
    pytest.importorskip("pandas")
    conn = pclient.connect(rests["port"].url)
    gdf = pdf.read_sql_pandas(agg, connection=conn)
    wdf = jdf.read_sql_pandas(agg, broker_url=rests["jax"].url)
    assert gdf.equals(wdf)
    with pytest.raises(ValueError, match="broker_url or connection"):
        pdf.read_sql(sql)


# -- the dataframe writer -------------------------------------------------------


def _same_segment(a, b):
    a, b = Path(a), Path(b)
    assert (a / "data.bin").read_bytes() == (b / "data.bin").read_bytes()
    ma = json.loads((a / "metadata.json").read_text())
    mb = json.loads((b / "metadata.json").read_text())
    ma.pop("creationTimeMs")
    mb.pop("creationTimeMs")
    assert ma == mb


def test_write_dataframe_then_read_equals_jax(tmp_path, rests):
    pd = pytest.importorskip("pandas")
    rng = np.random.default_rng(21)
    df = pd.DataFrame({
        "team": np.asarray(["BOS", "NYA", "SFN"], dtype=object)[
            rng.integers(0, 3, 500)],
        "runs": rng.integers(0, 100, 500).astype(np.int64),
        "ts": (1_600_000_000_000 + np.arange(500)).astype(np.int64),
    })
    schema = pdf.infer_schema(df, "stats", time_column="ts")
    jschema = jdf.infer_schema(df, "stats", time_column="ts")
    assert schema.to_json() == jschema.to_json()
    assert set(schema.dimension_names()) == {"team"}
    rows = {}
    for pkg, df_mod, start, sch in (
            ("port", pdf, (PropertyStore, ClusterController, Broker),
             schema),
            ("jax", jdf, (JStore, JController, JBroker), jschema)):
        store = start[0]()
        ctl = start[1](store)
        server = (ServerInstance(store, "S0", device="cpu") if pkg == "port"
                  else JServer(store, "S0", backend="host"))
        server.start()
        broker = start[2](store)
        try:
            ctl.add_schema(sch.to_json())
            ctl.create_table({"tableName": "stats", "replication": 1,
                              "timeColumn": "ts"})
            paths = df_mod.write_dataframe(
                df, "stats", tmp_path / pkg, schema=sch, controller=ctl,
                time_column="ts", rows_per_segment=200)
            assert len(paths) == 3  # 500 rows / 200 per segment
            meta = [store.get(f"/SEGMENTS/stats_OFFLINE/stats_{i}")
                    for i in range(3)]
            resp = broker.execute_sql(
                "SELECT team, SUM(runs), COUNT(*) FROM stats GROUP BY team "
                "ORDER BY team LIMIT 10")
            assert not resp.exceptions, resp.exceptions
            rows[pkg] = ([list(r) for r in resp.result_table.rows],
                         [{k: v for k, v in m.items()
                           if k not in ("location", "pushTimeMs")}
                          for m in meta], paths)
        finally:
            server.stop()
            if hasattr(broker, "close"):
                broker.close()
    assert rows["port"][:2] == rows["jax"][:2]
    assert rows["port"][1][0]["startTimeMs"] == 1_600_000_000_000
    for a, b in zip(rows["port"][2], rows["jax"][2]):
        _same_segment(a, b)
    want = df.groupby("team")["runs"].sum()
    assert {r[0]: r[1] for r in rows["port"][0]} == \
        {k: float(v) for k, v in want.items()}


def test_datetime64_columns_become_epoch_millis_as_jax(tmp_path):
    pd = pytest.importorskip("pandas")
    df = pd.DataFrame({
        "k": ["a", "b"],
        "when": pd.to_datetime(["2021-01-01 00:00:00",
                                "2021-01-02 00:00:00"]),
    })
    schema = pdf.infer_schema(df, "t", time_column="when")
    assert schema.to_json() == jdf.infer_schema(
        df, "t", time_column="when").to_json()
    paths = pdf.write_dataframe(df, "t", tmp_path / "port", schema=schema,
                                time_column="when")
    jpaths = jdf.write_dataframe(df, "t", tmp_path / "jax",
                                 schema=jdf.infer_schema(
                                     df, "t", time_column="when"),
                                 time_column="when")
    _same_segment(paths[0], jpaths[0])
    vals = load_segment(paths[0]).get_values("when")
    assert int(vals[0]) == 1609459200000  # epoch MILLIS, not nanos
    assert int(vals[1]) - int(vals[0]) == 86_400_000


# -- the streaming segment writer -------------------------------------------------


def _sink_rows(n, seed):
    rng = np.random.default_rng(seed)
    return [{"city": ["sf", "ny", "la"][int(rng.integers(0, 3))],
             "fare": float(np.round(rng.random() * 50, 2)),
             "day": int(rng.integers(0, 9)),
             "ts": 1_700_000_000_000 + i}
            for i in range(n)]


def test_sink_cuts_the_jax_segments_and_serves_the_jax_rows(tmp_path):
    from pinot_tpu.spi.table_config import IngestionConfig as JIngestion
    from pinot_tpu.spi.table_config import TableConfig as JTableConfig
    from pinot_tpu_torch.spi.table_config import (IngestionConfig,
                                                  TableConfig)

    dims, mets = [("city", "STRING"), ("day", "INT")], [("fare", "DOUBLE")]
    dts = [("ts", "LONG")]
    rows = _sink_rows(700, 4)
    out = {}
    for pkg in ("port", "jax"):
        sch_cls, cfg_cls, ing_cls, conn = (
            (Schema, TableConfig, IngestionConfig, pconn) if pkg == "port"
            else (JSchema, JTableConfig, JIngestion, jconn))
        schema = sch_cls.build("rides", dimensions=dims, metrics=mets,
                               date_times=dts)
        cfg = cfg_cls(table_name="rides", ingestion=ing_cls(
            filter_function="fare < 5"))
        store = PropertyStore() if pkg == "port" else JStore()
        ctl = ClusterController(store) if pkg == "port" else JController(
            store)
        server = (ServerInstance(store, "Server_0", device="cpu")
                  if pkg == "port" else JServer(store, "Server_0",
                                                backend="host"))
        server.start()
        ctl.add_schema(schema.to_json())
        table = ctl.create_table({"tableName": "rides", "replication": 1})
        with conn.StreamingSegmentWriter(
                schema, str(tmp_path / pkg), cfg, controller=ctl,
                table_name_with_type=table, partition_id=3,
                flush_max_rows=250, time_column="ts") as w:
            for r in rows:
                w.collect(r)
            assert w.flush() is not None  # an explicit flush of the tail
        assert w.close() == w.segments
        with pytest.raises(RuntimeError, match="closed"):
            w.collect(rows[0])
        # a restarted writer re-seeds its sequence past what is registered
        again = conn.StreamingSegmentWriter(
            schema, str(tmp_path / pkg), cfg, controller=ctl,
            table_name_with_type=table, partition_id=3)
        meta = {seg: {k: v for k, v in store.get(
                    f"/SEGMENTS/{table}/{seg}").items()
                      if k not in ("location", "pushTimeMs")}
                for seg in store.children(f"/SEGMENTS/{table}")}
        # the sink's segments, served by the package's own server
        broker = Broker(store) if pkg == "port" else JBroker(store)
        try:
            resp = broker.execute_sql(
                "SELECT city, COUNT(*), SUM(fare), MAX(ts) FROM rides "
                "GROUP BY city ORDER BY city")
            assert not resp.exceptions, resp.exceptions
            served = [list(r) for r in resp.result_table.rows]
        finally:
            server.stop()
            if hasattr(broker, "close"):
                broker.close()
        out[pkg] = (w.segments, w.rows_filtered, again._seq, meta, served)
    port, jax = out["port"], out["jax"]
    assert [Path(u).name for u in port[0]] == [Path(u).name for u in jax[0]]
    assert port[1:] == jax[1:]
    assert port[2] == len(port[0]) == 3 and port[1] > 0
    assert sum(r[1] for r in port[4]) == 700 - port[1]
    for a, b in zip(port[0], jax[0]):
        _same_segment(a, b)
