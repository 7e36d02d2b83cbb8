"""The port's cluster multi-stage engine against the JAX package's.

A port cluster (`PropertyStore`, `ClusterController`, two
`ServerInstance(device="cpu")` tagged `tenant0` / `tenant1` and a `Broker`,
over loopback TCP) and a JAX cluster (`ServerInstance(backend="host")`)
serve the same segment directories, built once by the port's builder from
a numpy seed:

  * `orders` (2 segments of 400 rows, on tenant0) and `customers` (6 rows,
    on tenant1): the JAX package's tests/test_mse_distributed.py tables, so
    a join's two sides live on different servers;
  * `facts` (2 x 2,000 rows, LONG key and DOUBLE value, on tenant0) and
    `dims` (1,000 rows, on tenant1): numeric exchange blocks, the PTDP
    path's (`DEVICE_PACK_MIN_BYTES` monkeypatched to 4096 in both
    packages).

Rows (sorted where the statement has no ORDER BY) equal the JAX cluster's
for joins, IN / NOT IN subqueries, set operations, windows and `SET
useMultistageEngine = true` aggregates; the cases of the JAX package's
test_mse_distributed.py are ported (serde round trip, join across servers,
the broker's auto-route, no double count at replication 2, a join across
two OS processes through `RemoteStore`, the colocated join's placement, an
unreachable worker failing loudly, recovery after a restart). Beside
them: the PTDP meter equal to the JAX cluster's, a `mailbox.deliver`
failure whose re-sent chunk is dropped as a duplicate, a `timeoutMs`
expiry that cleans every store, EXPLAIN rows equal to the JAX package's,
EXPLAIN ANALYZE with worker spans namespaced by instance, the MSE meters'
deltas equal to the JAX package's in-process, and the three ways the port
refuses to hide the card (a pack failure fails the query, the worker's
joins run on the server's device, a routed segment a worker does not host
raises). Tolerance: exact (integer sums, float sums of integers).
"""

from __future__ import annotations

import json
import multiprocessing
import time

import numpy as np
import pytest
import torch

import pinot_tpu.cluster as jcl
import pinot_tpu.mse.distributed as jdist
from pinot_tpu.engine import perf_ledger as _jax_perf_ledger
from pinot_tpu.engine.query_executor import QueryExecutor as JaxQueryExecutor
from pinot_tpu.segment.builder import SegmentBuilder as JaxSegmentBuilder
from pinot_tpu.segment.format import partition_push_metadata
from pinot_tpu.segment.loader import load_segment as jax_load
from pinot_tpu.spi import metrics as jmetrics
from pinot_tpu.spi.data_types import Schema as JaxSchema
from pinot_tpu.spi.partition import get_partition_function
from pinot_tpu.spi.table_config import IndexingConfig as JaxIndexing
from pinot_tpu.spi.table_config import TableConfig as JaxTableConfig
from pinot_tpu_torch import cluster as pcl
from pinot_tpu_torch.cluster.remote_store import (PropertyStoreServer,
                                                  serve_server_process)
from pinot_tpu_torch.engine import perf_ledger as _port_perf_ledger
from pinot_tpu_torch.engine.query_executor import QueryExecutor
from pinot_tpu_torch.mse import device_join
from pinot_tpu_torch.mse import distributed as pdist
from pinot_tpu_torch.mse.fragmenter import explain_stages, fragment
from pinot_tpu_torch.mse.logical import LogicalPlanner, prune_columns
from pinot_tpu_torch.mse.parser import parse_relational
from pinot_tpu_torch.mse.plan_serde import stage_from_json, stage_to_json
from pinot_tpu_torch.ops import _cuda
from pinot_tpu_torch.segment.builder import SegmentBuilder
from pinot_tpu_torch.segment.loader import load_segment
from pinot_tpu_torch.spi import faults
from pinot_tpu_torch.spi.data_types import Schema
from pinot_tpu_torch.spi.metrics import SERVER_METRICS, ServerMeter

ORDERS = Schema.build(
    "orders", dimensions=[("cust", "STRING"), ("item", "STRING")],
    metrics=[("amount", "INT")])
CUSTOMERS = Schema.build(
    "customers", dimensions=[("name", "STRING"), ("region", "STRING")],
    metrics=[("credit", "INT")])
FACTS = Schema.build("facts", dimensions=[("k", "LONG")],
                     metrics=[("v", "DOUBLE")])
DIMS = Schema.build("dims", dimensions=[("k", "LONG")],
                    metrics=[("w", "LONG")])
CUSTS = ["alice", "bob", "carol", "dan", "erin", "frank"]
REGIONS = ["east", "west", "north"]
ORDER_ROWS, FACT_ROWS, DIM_ROWS = 400, 2000, 1000

JOIN_SQL = ("SELECT customers.region, SUM(orders.amount) "
            "FROM orders JOIN customers ON orders.cust = customers.name "
            "GROUP BY customers.region ORDER BY customers.region")
FACTS_SQL = "SELECT f.k, f.v, d.w FROM facts f JOIN dims d ON f.k = d.k"
STATEMENTS = {
    "join": JOIN_SQL,
    "left_join": "SELECT o.item, c.region FROM orders o LEFT JOIN customers c "
                 "ON o.cust = c.name AND c.credit > 102",
    "in_subquery": "SELECT item, COUNT(*) FROM orders WHERE cust IN "
                   "(SELECT name FROM customers WHERE region = 'east') "
                   "GROUP BY item",
    "not_in_subquery": "SELECT cust, SUM(amount) FROM orders WHERE cust NOT IN "
                       "(SELECT name FROM customers WHERE credit < 103) "
                       "GROUP BY cust",
    "union": "SELECT name FROM customers UNION SELECT cust FROM orders",
    "intersect": "SELECT name FROM customers WHERE region <> 'west' "
                 "INTERSECT SELECT cust FROM orders WHERE amount > 90",
    "except_all": "SELECT cust FROM orders WHERE amount > 95 EXCEPT ALL "
                  "SELECT name FROM customers WHERE region = 'north'",
    "window": "SELECT cust, amount, RANK() OVER (PARTITION BY cust "
              "ORDER BY amount DESC) FROM orders WHERE amount > 80",
    "mse_agg": "SET useMultistageEngine = true; SELECT cust, COUNT(*), "
               "SUM(amount), MAX(amount) FROM orders WHERE item <> 'item_3' "
               "GROUP BY cust ORDER BY cust",
    "numeric_join": "SELECT d.w, COUNT(*), SUM(f.v) FROM facts f JOIN dims d "
                    "ON f.k = d.k WHERE f.v < 500 GROUP BY d.w",
}
ORDERED = ("join", "mse_agg")


@pytest.fixture(scope="module", autouse=True)
def _no_ledger_left_behind():
    """Both packages' brokers record every query, failures included, in
    their process-wide perf ledgers: leave the ledgers and alert books
    empty, so a later module's sentinel does not judge this module's
    queries (an SLO burn it fires arms exemplars that outlive it)."""
    yield
    for mod in (_jax_perf_ledger, _port_perf_ledger):
        mod.PERF_LEDGER.clear()
        mod.ALERTS.clear()


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("PINOT_TPU_SEGMENT_CACHE", "0")
    monkeypatch.setenv("PINOT_TPU_RESULT_CACHE", "0")
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)
    faults.FAULTS.reset()


@pytest.fixture(scope="module")
def segments(tmp_path_factory):
    """Segment directories per table: [(name, path, numDocs)]."""
    rng = np.random.default_rng(20261018)
    root = tmp_path_factory.mktemp("mse_cluster_segs")
    out = {}

    def build(schema, name, cols):
        SegmentBuilder(schema, None, name).build(cols, root / name)
        out.setdefault(schema.schema_name, []).append(
            (name, str(root / name), len(next(iter(cols.values())))))

    for i in range(2):
        build(ORDERS, f"orders_{i}", {
            "cust": np.asarray(CUSTS, dtype=object)[
                rng.integers(0, len(CUSTS), ORDER_ROWS)],
            "item": np.asarray([f"item_{j}" for j in range(20)], dtype=object)[
                rng.integers(0, 20, ORDER_ROWS)],
            "amount": rng.integers(1, 100, ORDER_ROWS).astype(np.int32)})
    build(CUSTOMERS, "customers_0", {
        "name": np.asarray(CUSTS, dtype=object),
        "region": np.asarray([REGIONS[i % 3] for i in range(len(CUSTS))],
                             dtype=object),
        "credit": np.arange(100, 100 + len(CUSTS), dtype=np.int32)})
    for i in range(2):
        build(FACTS, f"facts_{i}", {
            "k": rng.integers(0, 1500, FACT_ROWS).astype(np.int64),
            "v": rng.integers(0, 1000, FACT_ROWS).astype(np.float64)})
    build(DIMS, "dims_0", {"k": np.arange(DIM_ROWS, dtype=np.int64),
                           "w": (np.arange(DIM_ROWS) % 7).astype(np.int64)})
    return out


TABLE_TAGS = {"orders": "tenant0", "customers": "tenant1",
              "facts": "tenant0", "dims": "tenant1"}


def _start(pkg, segs, servers: int = 2, replication: int = 1,
           tags=TABLE_TAGS, store=None):
    """A started cluster of `pkg` (the port's or the JAX package's):
    (store, controller, servers, broker)."""
    store = store if store is not None else pkg.PropertyStore()
    ctl = pkg.ClusterController(store)
    srv = []
    for i in range(servers):
        t = [f"tenant{i}", "DefaultTenant"]
        srv.append(pkg.ServerInstance(store, f"Server_{i}", device="cpu",
                                      tags=t) if pkg is pcl else
                   pkg.ServerInstance(store, f"Server_{i}", backend="host",
                                      tags=t))
    for s in srv:
        s.start()
    schemas = {"orders": ORDERS, "customers": CUSTOMERS, "facts": FACTS,
               "dims": DIMS}
    for name, entries in segs.items():
        ctl.add_schema(schemas[name].to_json())
        cfg = {"tableName": name, "replication": replication}
        if tags is not None:
            cfg["serverTag"] = tags[name]
        t = ctl.create_table(cfg)
        for seg, path, n in entries:
            ctl.add_segment(t, seg, {"location": path, "numDocs": n})
    broker = pkg.Broker(store, scatter_backoff_ms=5) if pkg is pcl \
        else pkg.Broker(store)
    return store, ctl, srv, broker


def _stop(cluster) -> None:
    for s in cluster[2]:
        try:
            if getattr(s, "_started", True):
                s.stop()
        except Exception:
            pass
    broker = cluster[3]
    if hasattr(broker, "_mse_dispatcher"):
        broker._mse_dispatcher.close()
    if isinstance(broker, pcl.Broker):
        broker.close()


@pytest.fixture(scope="module")
def clusters(segments):
    port = _start(pcl, segments)
    ref = _start(jcl, segments)
    yield port, ref
    _stop(port)
    _stop(ref)


def _rows(resp, ordered: bool = True) -> list:
    assert not resp.exceptions, resp.exceptions
    rows = [list(r) for r in resp.result_table.rows]
    return rows if ordered else sorted(rows, key=repr)


def _region_sums(segs) -> dict:
    region = {c: REGIONS[i % 3] for i, c in enumerate(CUSTS)}
    sums: dict = {}
    for _, path, _ in segs["orders"]:
        seg = load_segment(path)
        for c, a in zip(seg.get_values("cust"), seg.get_values("amount")):
            sums[region[c]] = sums.get(region[c], 0) + int(a)
    return sums


def _catalog():
    return {s.schema_name: s.column_names()
            for s in (ORDERS, CUSTOMERS, FACTS, DIMS)}


# -- plan serde ---------------------------------------------------------------


def test_stage_serde_roundtrip():
    for sql in [JOIN_SQL, STATEMENTS["union"], STATEMENTS["window"],
                "SELECT cust, COUNT(*) FROM orders WHERE amount > 10 "
                "GROUP BY cust"]:
        plan = LogicalPlanner(parse_relational(sql), _catalog()).plan()
        prune_columns(plan)
        stages = fragment(plan)
        rebuilt = [stage_from_json(json.loads(json.dumps(stage_to_json(s))))
                   for s in stages]
        assert explain_stages(rebuilt) == explain_stages(stages)


# -- one process, TCP between roles -------------------------------------------


def test_distributed_join_across_servers(clusters, segments):
    (store, _, _, port), (_, _, _, ref) = clusters
    assert "Server_0" in (store.get("/EXTERNALVIEW/orders_OFFLINE") or {})[
        "orders_0"]
    assert "Server_1" in (store.get("/EXTERNALVIEW/customers_OFFLINE") or {})[
        "customers_0"]
    resp = port.execute_sql_mse(JOIN_SQL)
    assert _rows(resp) == _rows(ref.execute_sql_mse(JOIN_SQL))
    assert {r[0]: r[1] for r in resp.result_table.rows} == \
        _region_sums(segments)
    # both servers ran stage workers, on their device
    assert set(resp.mse_exchange["workers"]) == {"Server_0", "Server_1"}
    assert set(resp.mse_exchange["devices"].values()) == {"cpu"}


def test_broker_auto_routes_join_to_mse(clusters):
    (_, _, _, port), (_, _, _, ref) = clusters
    got, want = port.execute_sql(JOIN_SQL), ref.execute_sql(JOIN_SQL)
    assert _rows(got) == _rows(want)
    assert got.mse_stage_stats and got.query_id


def test_new_broker_over_running_servers_gets_fresh_query_ids(clusters,
                                                              monkeypatch):
    """The servers' stores remember cleaned-up query ids; a broker built
    after another was closed, over the same running servers, must not
    reuse one of them (its queries would read as cancelled), even when its
    dispatcher lands at the address of the one just freed (`id` pinned)."""
    (store, _, servers, _), (_, _, _, ref) = clusters
    monkeypatch.setattr(pdist, "id", lambda obj: 0, raising=False)
    want = _rows(ref.execute_sql_mse(JOIN_SQL))
    seen = set(servers[0].mse_worker.boxes._closed)
    for _ in range(3):
        broker = pcl.Broker(store, scatter_backoff_ms=5)
        try:
            assert _rows(broker.execute_sql_mse(JOIN_SQL)) == want
        finally:
            broker.close()
        closed = set(servers[0].mse_worker.boxes._closed)
        assert len(closed - seen) == 1
        seen |= closed


@pytest.mark.parametrize("name", sorted(STATEMENTS))
def test_statements_equal_jax_cluster(clusters, name):
    (_, _, _, port), (_, _, _, ref) = clusters
    sql = STATEMENTS[name]
    got, want = port.execute_sql(sql), ref.execute_sql(sql)
    assert _rows(got, name in ORDERED) == _rows(want, name in ORDERED)
    assert got.num_docs_scanned == want.num_docs_scanned


def test_syntax_error_is_the_v1_parse_error(clusters):
    (_, _, _, port), (_, _, _, ref) = clusters
    got, want = port.execute_sql("SELEC nonsense"), \
        ref.execute_sql("SELEC nonsense")
    assert got.result_table is None and want.result_table is None
    assert got.exceptions[0].startswith("SqlParseError")
    assert want.exceptions[0].startswith("SqlParseError")


def test_distributed_agg_no_double_count_with_replication(segments):
    """Leaf stages follow the broker's replica selector: replication 2 must
    not double-count rows."""
    segs = {"orders": segments["orders"][:1]}
    port = _start(pcl, segs, replication=2, tags=None)
    ref = _start(jcl, segs, replication=2, tags=None)
    try:
        sql = "SELECT COUNT(*), SUM(amount) FROM orders"
        got = port[3].execute_sql_mse(sql)
        assert _rows(got) == _rows(ref[3].execute_sql_mse(sql))
        seg = load_segment(segments["orders"][0][1])
        assert _rows(got) == [[ORDER_ROWS,
                               float(seg.get_values("amount").sum())]]
    finally:
        _stop(port)
        _stop(ref)


# -- two OS processes ---------------------------------------------------------


def _wait_for(predicate, timeout_s=60.0, what="condition"):
    deadline = time.time() + timeout_s
    while time.time() < deadline:
        if predicate():
            return
        time.sleep(0.05)
    raise TimeoutError(f"timed out waiting for {what}")


def test_join_across_two_os_processes(segments, clusters):
    (_, _, _, _), (_, _, _, ref) = clusters
    server_store = PropertyStoreServer()
    store = server_store.store
    ctl = pcl.ClusterController(store)
    local = pcl.ServerInstance(store, "Local_0", device="cpu",
                               tags=["tenantA", "DefaultTenant"])
    local.start()
    broker = pcl.Broker(store)
    ctx = multiprocessing.get_context("spawn")
    host, port = server_store.address
    child = ctx.Process(target=serve_server_process,
                        args=(host, port, "Remote_0", "cpu",
                              ["tenantB", "DefaultTenant"]), daemon=True)
    child.start()
    try:
        _wait_for(lambda: "Remote_0" in store.children("/LIVEINSTANCES"),
                  what="remote server liveness")
        for schema, tag in ((ORDERS, "tenantA"), (CUSTOMERS, "tenantB")):
            ctl.add_schema(schema.to_json())
            t = ctl.create_table({"tableName": schema.schema_name,
                                  "replication": 1, "serverTag": tag})
            for seg, path, n in segments[schema.schema_name]:
                ctl.add_segment(t, seg, {"location": path, "numDocs": n})
        # the child process converges customers_0 ONLINE through its watch
        _wait_for(lambda: "Remote_0" in (
            store.get("/EXTERNALVIEW/customers_OFFLINE") or {}).get(
                "customers_0", {}), what="remote segment convergence")
        resp = broker.execute_sql(JOIN_SQL)
        assert _rows(resp) == _rows(ref.execute_sql_mse(JOIN_SQL))
        assert set(resp.mse_exchange["workers"]) == {"Local_0", "Remote_0"}
    finally:
        store.set("/CONTROL/STOP/Remote_0", True)
        child.join(timeout=20)
        if child.is_alive():
            child.terminate()
            child.join(timeout=5)
        local.stop()
        broker.close()
        server_store.close()
    assert child.exitcode == 0


# -- colocated join -----------------------------------------------------------


def test_distributed_colocated_join(tmp_path):
    """Both tables declare segmentPartitionConfig on the join key: the
    dispatcher plans a partitioned exchange and places every join worker
    on the server whose segments carry that partition (orders' segments,
    stamped by the JAX builder, live on Server_0)."""
    rng = np.random.default_rng(31)
    nparts = 2
    pconf_o = {"columnPartitionMap": {
        "cust": {"functionName": "murmur", "numPartitions": nparts}}}
    pconf_c = {"columnPartitionMap": {
        "name": {"functionName": "murmur", "numPartitions": nparts}}}
    fn = get_partition_function("murmur", nparts)
    cust = np.asarray(CUSTS, dtype=object)[rng.integers(0, 6, ORDER_ROWS)]
    cols = {"cust": cust,
            "item": np.asarray([f"item_{j}" for j in range(20)], dtype=object)[
                rng.integers(0, 20, ORDER_ROWS)],
            "amount": rng.integers(1, 100, ORDER_ROWS).astype(np.int32)}
    part = fn.partitions_of(cols["cust"])
    jax_orders = JaxSchema.from_json(ORDERS.to_json())
    jax_custs = JaxSchema.from_json(CUSTOMERS.to_json())
    built = []
    for p in range(nparts):
        idx = np.nonzero(part == p)[0]
        sub = {c: v[idx] for c, v in cols.items()}
        tc = JaxTableConfig(table_name="orders", indexing=JaxIndexing(
            segment_partition_config=pconf_o["columnPartitionMap"]))
        path = str(tmp_path / f"orders_{p}")
        JaxSegmentBuilder(jax_orders, table_config=tc,
                          segment_name=f"orders_{p}").build(sub, path)
        meta = {"location": path, "numDocs": len(idx)}
        meta.update(partition_push_metadata(path))
        built.append((f"orders_{p}", meta))
    cpath = str(tmp_path / "customers_0")
    JaxSegmentBuilder(jax_custs, segment_name="customers_0").build(
        {"name": np.asarray(CUSTS, dtype=object),
         "region": np.asarray([REGIONS[i % 3] for i in range(6)],
                              dtype=object),
         "credit": np.arange(100, 106, dtype=np.int32)}, cpath)

    def start(pkg):
        store, ctl, srv, broker = _start(pkg, {})
        ctl.add_schema(ORDERS.to_json())
        ctl.add_schema(CUSTOMERS.to_json())
        ctl.create_table({"tableName": "orders", "replication": 1,
                          "serverTag": "tenant0", "tableIndexConfig": {
                              "segmentPartitionConfig": pconf_o}})
        ctl.create_table({"tableName": "customers", "replication": 1,
                          "serverTag": "tenant1",
                          "segmentPartitionConfig": pconf_c})
        for name, meta in built:
            ctl.add_segment("orders_OFFLINE", name, dict(meta))
        ctl.add_segment("customers_OFFLINE", "customers_0",
                        {"location": cpath, "numDocs": 6})
        return store, ctl, srv, broker

    port, ref = start(pcl), start(jcl)
    try:
        plan = port[3].execute_sql_mse("EXPLAIN PLAN FOR " + JOIN_SQL)
        assert _rows(plan) == _rows(
            ref[3].execute_sql_mse("EXPLAIN PLAN FOR " + JOIN_SQL))
        assert "partitioned" in "\n".join(r[0] for r in _rows(plan))
        disp = port[3].mse_dispatcher
        placements = {}
        orig = disp._partition_worker_placement

        def spy(stage, stages, workers, n):
            out = orig(stage, stages, workers, n)
            placements.update(out)
            return out

        disp._partition_worker_placement = spy
        got = port[3].execute_sql_mse(JOIN_SQL)
        assert _rows(got) == _rows(ref[3].execute_sql_mse(JOIN_SQL))
        assert placements and set(placements.values()) == {"Server_0"}
    finally:
        _stop(port)
        _stop(ref)


# -- failures -----------------------------------------------------------------


def test_distributed_join_worker_unreachable_fails_loudly(segments):
    """A worker whose endpoint dies while its live-instance entry persists
    (a hard crash) fails the query within bounded time, as in the JAX
    package, and the surviving stores are cleaned up."""
    port = _start(pcl, segments)
    ref = _start(jcl, segments)
    try:
        for cl in (port, ref):
            cl[2][1]._rpc.close()
        t0 = time.time()
        got = port[3].execute_sql_mse(JOIN_SQL)
        elapsed = time.time() - t0
        assert got.exceptions and got.result_table is None
        assert ref[3].execute_sql_mse(JOIN_SQL).exceptions
        assert elapsed < 30, f"the dispatcher hung {elapsed:.0f}s"
        assert port[3].mse_dispatcher.boxes.open_queries() == set()
        assert port[2][0].mse_worker.boxes.open_queries() == set()
    finally:
        _stop(port)
        _stop(ref)


def test_distributed_join_recovers_after_worker_restart(segments, clusters):
    """A cleanly stopped worker's table is unhosted (the query fails); a
    server restarted under its instance id replays the ideal state and the
    same query answers the JAX cluster's rows."""
    (_, _, _, _), (_, _, _, ref) = clusters
    store, ctl, srv, broker = port = _start(pcl, segments)
    try:
        srv[1].stop()
        assert broker.execute_sql_mse(JOIN_SQL).exceptions
        again = pcl.ServerInstance(store, "Server_1", device="cpu",
                                   tags=["tenant1", "DefaultTenant"])
        again.start()
        srv.append(again)
        _wait_for(lambda: "Server_1" in (store.get(
            "/EXTERNALVIEW/customers_OFFLINE") or {}).get("customers_0", {}),
                  timeout_s=10, what="the restarted server's view")
        assert _rows(broker.execute_sql_mse(JOIN_SQL)) == \
            _rows(ref.execute_sql_mse(JOIN_SQL))
    finally:
        _stop(port)


def test_mailbox_deliver_failure_is_resent_and_deduplicated(clusters):
    (_, _, servers, port), (_, _, _, ref) = clusters
    faults.FAULTS.arm("mailbox.deliver", kind="error", times=1,
                      match=lambda c: c.get("chunk"))
    got = port.execute_sql_mse(JOIN_SQL)
    assert faults.FAULTS.fired("mailbox.deliver") == 1
    faults.FAULTS.reset()
    assert _rows(got) == _rows(ref.execute_sql_mse(JOIN_SQL))
    assert got.mse_exchange["mailbox_duplicates_dropped"] == 1
    # always failing: the one re-send fails too, and the query fails
    faults.FAULTS.arm("mailbox.deliver", kind="error", times=None)
    bad = port.execute_sql_mse("SET timeoutMs = 5000; " + JOIN_SQL)
    faults.FAULTS.reset()
    assert bad.exceptions and bad.result_table is None
    for s in servers:
        assert s.mse_worker.boxes.open_queries() == set()


def test_timeout_expiry_cleans_every_store(clusters):
    (_, _, servers, port), _ = clusters
    faults.FAULTS.arm("mailbox.deliver", kind="delay", delay_s=1.5, times=1,
                      match=lambda c: c.get("chunk"))
    t0 = time.time()
    resp = port.execute_sql_mse("SET timeoutMs = 300; " + JOIN_SQL)
    elapsed = time.time() - t0
    faults.FAULTS.reset()
    assert resp.result_table is None
    assert any("Timeout" in e for e in resp.exceptions), resp.exceptions
    assert elapsed < 10, elapsed
    assert port.mse_dispatcher.boxes.open_queries() == set()
    for s in servers:
        assert s.mse_worker.boxes.open_queries() == set()


# -- the PTDP exchange --------------------------------------------------------


def test_ptdp_exchange_bytes_equal_jax(clusters, monkeypatch):
    """Numeric exchange blocks above the threshold cross servers as PTDP
    blobs: the port's meter delta equals the JAX cluster's (the encoders
    are byte-identical), and the rows are equal."""
    (_, _, _, port), (_, _, _, ref) = clusters
    monkeypatch.setattr(pdist, "DEVICE_PACK_MIN_BYTES", 4096)
    monkeypatch.setattr(jdist, "DEVICE_PACK_MIN_BYTES", 4096)
    name = ServerMeter.DEVICE_PACKED_EXCHANGE_BYTES
    p0 = SERVER_METRICS.meter_count(name)
    j0 = jmetrics.SERVER_METRICS.meter_count(name)
    got, want = port.execute_sql(FACTS_SQL), ref.execute_sql(FACTS_SQL)
    packed = SERVER_METRICS.meter_count(name) - p0
    assert _rows(got, False) == _rows(want, False)
    assert packed > 0
    assert packed == jmetrics.SERVER_METRICS.meter_count(name) - j0
    assert got.mse_exchange["packed_bytes"] == packed
    assert got.mse_exchange["packed_blocks"] >= 3


def test_pack_failure_fails_the_query(clusters, monkeypatch):
    """A worker configured for the card whose pack fails fails the query;
    the block is not shipped raw."""
    (_, _, servers, port), _ = clusters
    monkeypatch.setattr(pdist, "DEVICE_PACK_MIN_BYTES", 4096)

    def no_card(device=None):
        raise RuntimeError("no usable card for the pack")

    monkeypatch.setattr(_cuda, "require_cuda", no_card)
    for s in servers:
        monkeypatch.setattr(s, "device", torch.device("cuda"))
    sent = []
    real = pdist.MseWorkerService._send_rpc

    def spy(self, addr, request):
        block = request.get("block")
        if block is not None and pdist._wire_packable(block):
            sent.append(request)
        return real(self, addr, request)

    monkeypatch.setattr(pdist.MseWorkerService, "_send_rpc", spy)
    resp = port.execute_sql_mse(FACTS_SQL)
    assert resp.result_table is None
    assert any("no usable card for the pack" in e for e in resp.exceptions)
    assert not sent


# -- plans and traces ---------------------------------------------------------


def test_explain_rows_equal_jax(clusters):
    (_, _, _, port), (_, _, _, ref) = clusters
    for sql in (JOIN_SQL, STATEMENTS["in_subquery"], STATEMENTS["union"]):
        ex = "EXPLAIN PLAN FOR " + sql
        assert _rows(port.execute_sql(ex)) == _rows(ref.execute_sql(ex))


def test_explain_analyze_namespaces_worker_spans(clusters):
    (_, _, _, port), _ = clusters
    resp = port.execute_sql_mse("EXPLAIN ANALYZE " + JOIN_SQL)
    ops = [r[0] for r in _rows(resp)]
    assert ops[0].startswith("EXPLAIN_ANALYZE(rows:3")
    assert any(o.startswith("Server_0/mse_stage:") for o in ops)
    assert any(o.startswith("Server_1/mse_stage:") for o in ops)
    ids = [s["spanId"] for s in resp.trace_info]
    assert len(ids) == len(set(ids))
    workers = [s for s in resp.trace_info if s.get("server")]
    assert workers and all(
        s["spanId"].split(":")[0].split("#")[0] == s["server"]
        for s in workers)


# -- the device ---------------------------------------------------------------


def test_worker_runner_gets_the_server_device(clusters, monkeypatch):
    (_, _, servers, port), (_, _, _, ref) = clusters
    devices, pair_devices = [], []

    class Recording(pdist.StageRunner):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            if self.leaf_engine is not None:  # not the broker's topology
                devices.append(self.device)

    real = device_join.device_join_indices

    def spy(lcodes, rcodes, limit, device):
        pair_devices.append(device)
        return real(lcodes, rcodes, limit, device)

    monkeypatch.setattr(pdist, "StageRunner", Recording)
    monkeypatch.setattr(device_join, "device_join_indices", spy)
    monkeypatch.setenv("PINOT_TPU_DEVICE_JOIN", "1")
    got = port.execute_sql_mse(JOIN_SQL)
    assert _rows(got) == _rows(ref.execute_sql_mse(JOIN_SQL))
    assert devices and all(d == servers[0].device for d in devices)
    # the join workers' pair join ran on the server's device
    assert pair_devices and all(
        torch.device(d) == torch.device("cpu") for d in pair_devices)


def test_routed_segment_not_hosted_raises(clusters, monkeypatch):
    (_, _, servers, port), _ = clusters
    hosted = dict(servers[0].segments["orders_OFFLINE"])
    monkeypatch.setitem(servers[0].segments, "orders_OFFLINE",
                        {k: v for k, v in hosted.items() if k != "orders_1"})
    resp = port.execute_sql_mse(JOIN_SQL)
    assert resp.result_table is None
    assert any("SegmentNotHostedError" in e and "orders_1" in e
               for e in resp.exceptions), resp.exceptions


MSE = "SET useMultistageEngine = true; SET resultCache = false; "
METERS = (ServerMeter.MSE_DEVICE_JOINS, ServerMeter.MSE_FUSED_STAGES,
          ServerMeter.MSE_HOST_CROSSINGS,
          ServerMeter.MSE_DEVICE_JOIN_FALLBACKS)


def test_mse_meters_equal_jax_in_process(segments):
    """The fused stage's meters under `SET deviceJoin = true`, in-process:
    a fused join counts a device join, its fused stages and one host
    crossing; a join whose side is empty (run_fused's gate) counts a
    fallback; each delta equals the JAX package's."""
    port = QueryExecutor(device="cpu")
    ref = JaxQueryExecutor(backend="tpu")
    for schema in (FACTS, DIMS):
        paths = [p for _, p, _ in segments[schema.schema_name]]
        port.add_table(schema, [load_segment(p) for p in paths])
        ref.add_table(JaxSchema.from_json(schema.to_json()),
                      [jax_load(p) for p in paths])
    for sql in ("SELECT d.w, COUNT(*), SUM(f.v) FROM facts f JOIN dims d "
                "ON f.k = d.k GROUP BY d.w",
                "SELECT d.w, COUNT(*), SUM(f.v) FROM facts f JOIN dims d "
                "ON f.k = d.k WHERE f.v < 0 GROUP BY d.w"):
        sql = MSE + "SET deviceJoin = true; " + sql
        before = ([SERVER_METRICS.meter_count(m) for m in METERS],
                  [jmetrics.SERVER_METRICS.meter_count(m) for m in METERS])
        got, want = port.execute_sql(sql), ref.execute_sql(sql)
        assert _rows(got, False) == _rows(want, False)
        deltas = ([SERVER_METRICS.meter_count(m) - b
                   for m, b in zip(METERS, before[0])],
                  [jmetrics.SERVER_METRICS.meter_count(m) - b
                   for m, b in zip(METERS, before[1])])
        assert deltas[0] == deltas[1] and any(deltas[0])
