"""The multi-stage engine of the port against the JAX package's and sqlite.

Small tables (an orders / customers pair of 2 + 1 segments, an SSB-shaped
table of 2 x 2500 rows, and partitioned tables for a colocated join) are
built from seeded numpy columns and loaded by both packages. Statements go
through the port's `QueryExecutor(device="cpu")` (the join pipeline's
torch ops on CPU tensors, the kernels' plain versions) and the JAX
package's `QueryExecutor(backend="tpu")` on its CPU backend with `SET
resultCache = false`; `SET deviceJoin = true` forces the device join path
of both, `false` their host path. Rows must be equal: every aggregate on
the device path is integer-gated, and the host operators are the same
numpy code, so there is no float tolerance anywhere here.
"""

from __future__ import annotations

import math
import re
import sqlite3
import sys
import threading

import numpy as np
import pytest

from pinot_tpu.engine.query_executor import QueryExecutor as JaxQueryExecutor
from pinot_tpu.mse.parser import parse_relational as jax_parse_relational
from pinot_tpu.segment.builder import SegmentBuilder as JaxSegmentBuilder
from pinot_tpu.segment.loader import load_segment as jax_load
from pinot_tpu.spi.data_types import Schema as JaxSchema
from pinot_tpu.spi.partition import get_partition_function
from pinot_tpu.spi.table_config import IndexingConfig as JaxIndexing
from pinot_tpu.spi.table_config import TableConfig as JaxTableConfig
from pinot_tpu_torch.engine.aggregation import UnsupportedQueryError
from pinot_tpu_torch.engine.query_executor import QueryExecutor
from pinot_tpu_torch.mse import operators as ops
from pinot_tpu_torch.mse.mailbox import block_len
from pinot_tpu_torch.mse.operators import JoinCtx, op_join, pop_join_overflow
from pinot_tpu_torch.mse.parser import parse_relational
from pinot_tpu_torch.mse.runtime import StageRunner
from pinot_tpu_torch.ops import join_pipeline
from pinot_tpu_torch.query.parser.sql import parse_sql
from pinot_tpu_torch.query.expressions import ExpressionContext as EC
from pinot_tpu_torch.segment.builder import SegmentBuilder
from pinot_tpu_torch.segment.loader import load_segment
from pinot_tpu_torch.spi.data_types import Schema

ORDERS = {
    "oid": np.arange(1, 21, dtype=np.int32),
    "cust_id": np.array([1, 2, 3, 1, 2, 9, 4, 1, 3, 2,
                         5, 1, 4, 2, 3, 1, 9, 5, 2, 1], dtype=np.int32),
    "amount": np.array([10, 40, 25, 5, 60, 100, 35, 15, 45, 20,
                        55, 30, 65, 50, 70, 80, 90, 22, 33, 44],
                       dtype=np.int32),
    "status": np.array(["open", "done", "done", "open", "done", "open",
                        "done", "done", "open", "done", "done", "open",
                        "done", "done", "open", "done", "done", "open",
                        "done", "open"], dtype=object),
}
CUSTOMERS = {
    "cid": np.array([1, 2, 3, 4, 5, 6], dtype=np.int32),
    "name": np.array(["alice", "bob", "carol", "dave", "erin", "frank"],
                     dtype=object),
    "region": np.array(["west", "east", "west", "north", "east", "south"],
                       dtype=object),
}
ORDERS_DIMS = [("oid", "INT"), ("cust_id", "INT"), ("status", "STRING")]
CUST_DIMS = [("cid", "INT"), ("name", "STRING"), ("region", "STRING")]
SSB_DIMS = [("lo_orderkey", "INT"), ("lo_quantity", "INT"),
            ("lo_discount", "INT"), ("d_year", "INT")]
SSB_ROWS = 2500
COLO_PARTS = 4

MSE = "SET useMultistageEngine = true; SET resultCache = false; "
FUSED = MSE + "SET deviceJoin = true; "
HOST = MSE + "SET deviceJoin = false; "

# the device-residency shapes of tests/test_device_residency.py
SHAPES = {
    "left_build_residual": (
        "SELECT a.d_year, COUNT(*), SUM(b.lo_revenue) FROM ssb a "
        "LEFT JOIN ssb b ON a.lo_orderkey = b.lo_orderkey "
        "AND b.lo_discount = 0 WHERE a.lo_quantity < 4 "
        "GROUP BY a.d_year ORDER BY a.d_year LIMIT 100"),
    "left_probe_residual": (
        "SELECT a.d_year, COUNT(*), SUM(b.lo_revenue) FROM ssb a "
        "LEFT JOIN ssb b ON a.lo_orderkey = b.lo_orderkey "
        "AND a.lo_quantity < 3 WHERE a.lo_discount = 0 "
        "GROUP BY a.d_year ORDER BY a.d_year LIMIT 100"),
    "semi": (
        "SELECT d_year, COUNT(*), SUM(lo_revenue) FROM ssb "
        "WHERE lo_quantity < 4 AND lo_orderkey IN "
        "(SELECT lo_orderkey FROM ssb WHERE lo_discount = 0) "
        "GROUP BY d_year ORDER BY d_year LIMIT 100"),
    "anti": (
        "SELECT d_year, COUNT(*), SUM(lo_revenue) FROM ssb "
        "WHERE lo_quantity < 4 AND lo_orderkey NOT IN "
        "(SELECT lo_orderkey FROM ssb WHERE lo_discount = 0 "
        "AND lo_quantity > 7) "
        "GROUP BY d_year ORDER BY d_year LIMIT 100"),
    "chain2": (
        "SELECT a.d_year, COUNT(*), SUM(c.lo_revenue) FROM ssb a "
        "JOIN ssb b ON a.lo_orderkey = b.lo_orderkey "
        "JOIN ssb c ON b.lo_orderkey = c.lo_orderkey "
        "WHERE a.lo_quantity < 3 AND b.lo_discount = 0 "
        "AND c.lo_quantity < 2 "
        "GROUP BY a.d_year ORDER BY a.d_year LIMIT 100"),
    "chain3": (
        "SELECT a.d_year, COUNT(*), SUM(d.lo_revenue) FROM ssb a "
        "JOIN ssb b ON a.lo_orderkey = b.lo_orderkey "
        "JOIN ssb c ON b.lo_orderkey = c.lo_orderkey "
        "JOIN ssb d ON c.lo_orderkey = d.lo_orderkey "
        "WHERE a.lo_quantity < 2 AND b.lo_discount = 0 "
        "AND c.lo_quantity < 2 AND d.lo_discount = 1 "
        "GROUP BY a.d_year ORDER BY a.d_year LIMIT 100"),
}

# (statement, ordered): joins, subqueries, derived tables, CTEs, set
# operations, windows, sorts; each against the JAX package's rows and, with
# an oracle, sqlite's
STATEMENTS = [
    ("SELECT o.oid, c.name FROM orders o JOIN customers c "
     "ON o.cust_id = c.cid", False),
    ("SELECT o.oid, c.name, o.amount FROM orders o JOIN customers c "
     "ON o.cust_id = c.cid WHERE o.amount > 30 AND c.region = 'west'", False),
    ("SELECT o.oid, c.name FROM orders o LEFT JOIN customers c "
     "ON o.cust_id = c.cid", False),
    ("SELECT c.name, o.oid FROM orders o RIGHT JOIN customers c "
     "ON o.cust_id = c.cid", False),
    ("SELECT o.oid, c.cid FROM orders o FULL JOIN customers c "
     "ON o.cust_id = c.cid", False),
    ("SELECT a.oid FROM orders a JOIN orders b USING (oid) LIMIT 100", False),
    ("SELECT o.oid, c.cid FROM orders o CROSS JOIN customers c "
     "WHERE o.oid < 4", False),
    ("SELECT o.oid, c.cid FROM orders o JOIN customers c "
     "ON o.cust_id < c.cid WHERE o.oid < 5", False),
    ("SELECT c.region, SUM(o.amount), COUNT(*) FROM orders o "
     "JOIN customers c ON o.cust_id = c.cid GROUP BY c.region", False),
    ("SELECT c.name, SUM(o.amount) AS total FROM orders o "
     "JOIN customers c ON o.cust_id = c.cid GROUP BY c.name "
     "HAVING SUM(o.amount) > 100", False),
    ("SELECT oid FROM orders WHERE cust_id IN "
     "(SELECT cid FROM customers WHERE region = 'west') LIMIT 100", False),
    ("SELECT oid FROM orders WHERE cust_id NOT IN "
     "(SELECT cid FROM customers) LIMIT 100", False),
    ("SELECT t.cust_id, t.total FROM (SELECT cust_id, SUM(amount) AS total "
     "FROM orders GROUP BY cust_id) t WHERE t.total > 50", False),
    ("WITH big AS (SELECT cust_id, SUM(amount) AS total FROM orders "
     "GROUP BY cust_id) SELECT c.name, b.total FROM big b JOIN customers c "
     "ON b.cust_id = c.cid WHERE b.total > 60", False),
    ("SELECT cust_id FROM orders UNION ALL SELECT cid FROM customers "
     "LIMIT 100", False),
    ("SELECT cust_id FROM orders UNION SELECT cid FROM customers LIMIT 100",
     False),
    ("SELECT cust_id FROM orders INTERSECT SELECT cid FROM customers "
     "LIMIT 100", False),
    ("SELECT cid FROM customers EXCEPT SELECT cust_id FROM orders LIMIT 100",
     False),
    ("SELECT oid, ROW_NUMBER() OVER (PARTITION BY cust_id ORDER BY amount) "
     "FROM orders LIMIT 100", False),
    ("SELECT oid, RANK() OVER (PARTITION BY status ORDER BY amount DESC), "
     "DENSE_RANK() OVER (PARTITION BY status ORDER BY amount DESC) "
     "FROM orders LIMIT 100", False),
    ("SELECT oid, SUM(amount) OVER (PARTITION BY cust_id) FROM orders "
     "LIMIT 100", False),
    ("SELECT oid, SUM(amount) OVER (PARTITION BY cust_id ORDER BY oid) "
     "FROM orders LIMIT 100", False),
    ("SELECT oid, LAG(amount) OVER (PARTITION BY cust_id ORDER BY oid), "
     "LEAD(amount) OVER (PARTITION BY cust_id ORDER BY oid) FROM orders "
     "LIMIT 100", False),
    ("SELECT oid, SUM(amount) OVER (ORDER BY oid ROWS BETWEEN 1 PRECEDING "
     "AND 1 FOLLOWING) FROM orders LIMIT 100", False),
    ("SELECT oid, amount FROM orders ORDER BY amount DESC, oid LIMIT 5", True),
    ("SELECT COUNT(*), SUM(amount), MIN(amount), MAX(amount), AVG(amount) "
     "FROM orders", False),
    ("SELECT DISTINCT status FROM orders LIMIT 10", False),
    ("SELECT cust_id FROM orders GROUP BY cust_id ORDER BY SUM(amount) DESC "
     "LIMIT 3", True),
    ("SELECT c.name, MIN(o.amount), MAX(o.amount), SUM(o.amount) "
     "FROM customers c LEFT JOIN orders o ON c.cid = o.cust_id "
     "GROUP BY c.name", False),
]

# the same statements as sqlite spells them, where it differs
SQLITE = {
    "SELECT c.name, o.oid FROM orders o RIGHT JOIN customers c "
    "ON o.cust_id = c.cid": "SELECT c.name, o.oid FROM customers c "
    "LEFT JOIN orders o ON o.cust_id = c.cid",
    "SELECT o.oid, c.cid FROM orders o FULL JOIN customers c "
    "ON o.cust_id = c.cid": "SELECT o.oid, c.cid FROM orders o LEFT JOIN "
    "customers c ON o.cust_id = c.cid UNION ALL SELECT NULL, c.cid FROM "
    "customers c WHERE c.cid NOT IN (SELECT cust_id FROM orders)",
    "SELECT a.oid FROM orders a JOIN orders b USING (oid) LIMIT 100":
    "SELECT a.oid FROM orders a JOIN orders b ON a.oid = b.oid",
}


@pytest.fixture(autouse=True)
def _jax_dispatches_every_query(monkeypatch):
    # both packages' result caches off too: a repeated statement (a fault
    # injected into a statement run before) must run its stages
    monkeypatch.setenv("PINOT_TPU_SEGMENT_CACHE", "0")
    monkeypatch.setenv("PINOT_TPU_RESULT_CACHE", "0")
    monkeypatch.setenv("PINOT_TPU_MESH_DEVICES", "1")
    monkeypatch.setenv("PINOT_TPU_FUSED", "interpret")


def _ssb_cols(rng, n):
    return {
        "lo_orderkey": rng.integers(0, 500, n).astype(np.int32),
        "lo_quantity": rng.integers(1, 10, n).astype(np.int32),
        "lo_discount": rng.integers(0, 4, n).astype(np.int32),
        "lo_revenue": rng.integers(100, 9000, n).astype(np.int32),
        "d_year": (1992 + rng.integers(0, 7, n)).astype(np.int32),
    }


def _colo_cols(rng, n=400):
    orders = {"cust": rng.integers(0, 60, n).astype(np.int32),
              "item": np.asarray([f"i{x}" for x in rng.integers(0, 9, n)],
                                 object),
              "qty": rng.integers(1, 10, n).astype(np.int32)}
    custs = {"cid": np.arange(50, dtype=np.int32),
             "city": np.asarray([f"c{x % 7}" for x in range(50)], object)}
    return orders, custs


def _build_partitioned(root, tag, dims, metrics, cols, pcol):
    """One segment per murmur partition of `pcol`, built with the JAX
    builder (the port's writes no partition stamps); both packages load
    the same files."""
    part = get_partition_function("murmur", COLO_PARTS).partitions_of(
        np.asarray(cols[pcol]))
    schema = JaxSchema.build(tag, dimensions=dims, metrics=metrics)
    cfg = JaxTableConfig(table_name=tag, indexing=JaxIndexing(
        segment_partition_config={pcol: {"functionName": "murmur",
                                         "numPartitions": COLO_PARTS}}))
    paths = []
    for p in range(COLO_PARTS):
        idx = np.nonzero(part == p)[0]
        JaxSegmentBuilder(schema, table_config=cfg,
                          segment_name=f"{tag}_{p}").build(
            {c: np.asarray(v)[idx] for c, v in cols.items()},
            root / f"{tag}_{p}")
        paths.append(root / f"{tag}_{p}")
    return paths


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    """(port, jax, sqlite connection) over orders, customers, ssb, corders
    and ccusts."""
    root = tmp_path_factory.mktemp("torch_mse")
    tables = {}  # name -> (dims, metrics, [paths])

    def build(name, dims, metrics, parts):
        schema = Schema.build(name, dimensions=dims, metrics=metrics)
        paths = []
        for i, cols in enumerate(parts):
            SegmentBuilder(schema, None, f"{name}_{i}").build(
                cols, root / f"{name}_{i}")
            paths.append(root / f"{name}_{i}")
        tables[name] = (dims, metrics, paths)

    build("orders", ORDERS_DIMS, [("amount", "INT")],
          [{k: v[:10] for k, v in ORDERS.items()},
           {k: v[10:] for k, v in ORDERS.items()}])
    build("customers", CUST_DIMS, [], [CUSTOMERS])
    rng = np.random.default_rng(29)
    ssb = _ssb_cols(rng, 2 * SSB_ROWS)
    build("ssb", SSB_DIMS, [("lo_revenue", "INT")],
          [{k: v[:SSB_ROWS] for k, v in ssb.items()},
           {k: v[SSB_ROWS:] for k, v in ssb.items()}])
    corders, ccusts = _colo_cols(np.random.default_rng(9))
    tables["corders"] = ([("cust", "INT"), ("item", "STRING")],
                         [("qty", "INT")], None)
    tables["corders"] = tables["corders"][:2] + (_build_partitioned(
        root, "corders", *tables["corders"][:2], corders, "cust"),)
    tables["ccusts"] = ([("cid", "INT"), ("city", "STRING")], [], None)
    tables["ccusts"] = tables["ccusts"][:2] + (_build_partitioned(
        root, "ccusts", *tables["ccusts"][:2], ccusts, "cid"),)

    port = QueryExecutor(device="cpu")
    jax = JaxQueryExecutor(backend="tpu")
    for name, (dims, metrics, paths) in tables.items():
        port.add_table(Schema.build(name, dimensions=dims, metrics=metrics),
                       [load_segment(p) for p in paths])
        jax.add_table(JaxSchema.build(name, dimensions=dims, metrics=metrics),
                      [jax_load(p) for p in paths])
    conn = sqlite3.connect(":memory:", check_same_thread=False)
    for name, cols in (("orders", ORDERS), ("customers", CUSTOMERS),
                       ("ssb", ssb), ("corders", corders),
                       ("ccusts", ccusts)):
        names = list(cols)
        conn.execute(f"CREATE TABLE {name} ({', '.join(names)})")
        conn.executemany(
            f"INSERT INTO {name} VALUES ({', '.join('?' * len(names))})",
            zip(*([x.item() if isinstance(x, np.generic) else x for x in v]
                  for v in (cols[c] for c in names))))
    yield port, jax, conn
    conn.close()


def _norm(v):
    if v is None:
        return None
    if isinstance(v, float):
        if math.isnan(v):
            return None
        return int(v) if v.is_integer() else v
    return v


def _rows(resp, ordered):
    assert not resp.exceptions, resp.exceptions
    rows = [tuple(_norm(v) for v in r) for r in resp.result_table.rows]
    return rows if ordered else sorted(rows, key=repr)


def _sqlite_rows(conn, sql, ordered):
    rows = [tuple(_norm(v) for v in r) for r in conn.execute(sql).fetchall()]
    return rows if ordered else sorted(rows, key=repr)


@pytest.fixture
def captured_runner(monkeypatch):
    captured = {}
    orig = StageRunner.run

    def run(self):
        captured["runner"] = self
        return orig(self)

    monkeypatch.setattr(StageRunner, "run", run)
    return captured


# -- parse, plan, EXPLAIN ----------------------------------------------------


@pytest.mark.parametrize("sql", [s for s, _ in STATEMENTS]
                         + list(SHAPES.values()))
def test_parse_and_explain_equal_jax(engines, sql):
    port, jax, _ = engines
    assert repr(parse_relational(sql)) == repr(jax_parse_relational(sql))
    explain = MSE + "EXPLAIN PLAN FOR " + sql
    got, want = port.execute_sql(explain), jax.execute_sql(explain)
    assert not got.exceptions and not want.exceptions
    assert got.result_table.rows == want.result_table.rows


# EXPLAIN ANALYZE labels: the timings are masked, and the attributes that
# differ by design (tests/test_torch_explain.py `_masked`): the port's
# dispatch spans name their device, the JAX package counts jit compiles
_ANALYZE_TIMINGS = re.compile(
    r"\b(ms|timeMs|deviceExecMs|compileMs|device_partition_ms):[^,)]*")


def _analyze_tree(resp) -> list:
    assert not resp.exceptions, resp.exceptions
    out = []
    for op, oid, parent in resp.result_table.rows:
        op = _ANALYZE_TIMINGS.sub(lambda m: m.group(1) + ":*", op)
        op = re.sub(r"device:(cpu|cuda), ", "", op)
        out.append([re.sub(r"compiles:\d+", "compiles:*", op), oid, parent])
    return out


def _leaf_spans_nest_under_stages(trace_info) -> int:
    """Every family_dispatch span's parent is an mse_stage span; returns
    how many there are."""
    by_id = {s["spanId"]: s for s in trace_info}
    leaves = [s for s in trace_info if s["operator"] == "family_dispatch"]
    for s in leaves:
        assert by_id[s["parentId"]]["operator"].startswith("mse_stage:")
    return len(leaves)


@pytest.mark.parametrize("shape", ["semi", "chain2"])
def test_explain_analyze_fused_join_equals_jax(engines, shape):
    """ANALYZE of a statement whose join runs as the fused device stage:
    the stage spans, their stats and the leaves' dispatch spans equal the
    JAX package's tree; the root's rows equal a plain run's."""
    port, jax, _ = engines
    sql = FUSED + "EXPLAIN ANALYZE " + SHAPES[shape]
    plain = port.execute_sql(FUSED + SHAPES[shape])
    jax.execute_sql(FUSED + SHAPES[shape])
    got, want = port.execute_sql(sql), jax.execute_sql(sql)
    assert _analyze_tree(got) == _analyze_tree(want)
    assert f"rows:{len(plain.result_table.rows)}," in got.result_table.rows[0][0]
    assert "join_impl:device-fused" in "\n".join(
        r[0] for r in got.result_table.rows)
    assert _leaf_spans_nest_under_stages(got.trace_info) > 0


def test_explain_analyze_pair_join_equals_jax(engines, monkeypatch):
    """ANALYZE of a join returning rows, through the pair join on the
    device (two join workers adopt the stage's trace)."""
    from pinot_tpu_torch.mse import device_join

    calls = []
    real = device_join.device_join_indices

    def counting(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(device_join, "device_join_indices", counting)
    monkeypatch.setenv("PINOT_TPU_DEVICE_JOIN", "1")
    port, jax, _ = engines
    stmt = ("SELECT o.oid, c.name, o.amount FROM orders o JOIN customers c "
            "ON o.cust_id = c.cid WHERE o.amount > 20 ORDER BY o.oid")
    plain = port.execute_sql(MSE + stmt)
    jax.execute_sql(MSE + stmt)
    got = port.execute_sql(MSE + "EXPLAIN ANALYZE " + stmt)
    want = jax.execute_sql(MSE + "EXPLAIN ANALYZE " + stmt)
    assert calls, "the pair join did not run"
    assert _analyze_tree(got) == _analyze_tree(want)
    assert f"rows:{len(plain.result_table.rows)}," in got.result_table.rows[0][0]
    assert _leaf_spans_nest_under_stages(got.trace_info) > 0


def test_traced_statement_attaches_its_spans(engines):
    port = engines[0]
    resp = port.execute_sql(MSE + "SET trace = true; " + SHAPES["semi"])
    ops = [s["operator"] for s in resp.trace_info]
    assert any(op.startswith("mse_stage:") for op in ops), ops
    assert "traceInfo" in resp.to_json()
    assert port.execute_sql(MSE + SHAPES["semi"]).trace_info is None


# -- op_join against sqlite ----------------------------------------------------

JOIN_SCHEMA = ["k", "v", "k2", "w"]
RESIDUAL = EC.for_function("lessthan", EC.for_identifier("v"),
                           EC.for_identifier("w"))


def _join_blocks(null_mode: str):
    rng = np.random.default_rng(7)
    ln, rn = 83, 67
    lk = rng.integers(0, 12, ln)
    rk = rng.integers(0, 12, rn)
    lv = rng.integers(0, 50, ln).astype(np.int64)
    rw = rng.integers(0, 50, rn).astype(np.int64)
    lkeys = [int(x) for x in lk]
    rkeys = [int(x) for x in rk]
    if null_mode == "none":
        left = {"k": lk.astype(np.int64), "v": lv}
        right = {"k2": rk.astype(np.int64), "w": rw}
    else:
        lkeys = [None if i % 7 == 0 else x for i, x in enumerate(lkeys)]
        rkeys = [None if i % 5 == 0 else x for i, x in enumerate(rkeys)]
        if null_mode == "object":
            left = {"k": np.asarray(lkeys, dtype=object), "v": lv}
            right = {"k2": np.asarray(rkeys, dtype=object), "w": rw}
        else:  # float NaN keys
            left = {"k": np.asarray([np.nan if x is None else float(x)
                                     for x in lkeys]), "v": lv}
            right = {"k2": np.asarray([np.nan if x is None else float(x)
                                       for x in rkeys]), "w": rw}
    return (left, right, [(lkeys[i], int(lv[i])) for i in range(ln)],
            [(rkeys[i], int(rw[i])) for i in range(rn)])


def _join_oracle(lrows, rrows, join_type, residual):
    conn = sqlite3.connect(":memory:")
    conn.execute("CREATE TABLE L (k INT, v INT)")
    conn.execute("CREATE TABLE R (k2 INT, w INT)")
    conn.executemany("INSERT INTO L VALUES (?,?)", lrows)
    conn.executemany("INSERT INTO R VALUES (?,?)", rrows)
    on = "L.k = R.k2" + (" AND L.v < R.w" if residual else "")
    corr = "R.k2 = L.k" + (" AND L.v < R.w" if residual else "")
    q = {
        "INNER": f"SELECT L.k, L.v, R.k2, R.w FROM L JOIN R ON {on}",
        "LEFT": f"SELECT L.k, L.v, R.k2, R.w FROM L LEFT JOIN R ON {on}",
        "RIGHT": f"SELECT L.k, L.v, R.k2, R.w FROM R LEFT JOIN L ON {on}",
        "FULL": (f"SELECT L.k, L.v, R.k2, R.w FROM L LEFT JOIN R ON {on} "
                 f"UNION ALL SELECT NULL, NULL, R.k2, R.w FROM R "
                 f"WHERE NOT EXISTS (SELECT 1 FROM L WHERE {corr})"),
        "SEMI": (f"SELECT L.k, L.v FROM L "
                 f"WHERE EXISTS (SELECT 1 FROM R WHERE {corr})"),
        "ANTI": (f"SELECT L.k, L.v FROM L "
                 f"WHERE NOT EXISTS (SELECT 1 FROM R WHERE {corr})"),
    }[join_type]
    rows = conn.execute(q).fetchall()
    conn.close()
    return sorted((tuple(_norm(x) for x in r) for r in rows), key=repr)


def _join_rowset(block, columns):
    cols = [np.asarray(block[c]) for c in columns]
    return sorted((tuple(_norm(c[i].item() if isinstance(c[i], np.generic)
                               else c[i]) for c in cols)
                   for i in range(block_len(block))), key=repr)


@pytest.fixture(params=["host", "device"])
def join_ctx(request, monkeypatch):
    """The host join (no device), or the pair join on the CPU device
    (device_join_indices and gather_payload as torch ops)."""
    if request.param == "host":
        return None
    monkeypatch.setenv("PINOT_TPU_DEVICE_JOIN", "1")
    return JoinCtx(device="cpu").for_stage(1)


@pytest.mark.parametrize("null_mode", ["none", "object", "float"])
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("join_type",
                         ["INNER", "LEFT", "RIGHT", "FULL", "SEMI", "ANTI"])
def test_join_matrix_vs_sqlite(join_ctx, join_type, residual, null_mode):
    left, right, lrows, rrows = _join_blocks(null_mode)
    schema = ["k", "v"] if join_type in ("SEMI", "ANTI") else JOIN_SCHEMA
    out = op_join(dict(left), dict(right), join_type, ["k"], ["k2"],
                  RESIDUAL if residual else None, list(schema), join_ctx)
    assert _join_rowset(out, schema) == _join_oracle(lrows, rrows, join_type,
                                                     residual)


def test_join_overflow_throw_and_break(join_ctx, monkeypatch):
    left, right, _, _ = _join_blocks("none")
    monkeypatch.setattr(ops, "MAX_ROWS_IN_JOIN", 50)
    monkeypatch.setattr(ops, "JOIN_OVERFLOW_MODE", "THROW")
    for jt in ("INNER", "LEFT", "RIGHT", "FULL", "ANTI"):
        with pytest.raises(ops.JoinRowLimitExceeded):
            op_join(dict(left), dict(right), jt, ["k"], ["k2"], None,
                    list(JOIN_SCHEMA), join_ctx)
    monkeypatch.setattr(ops, "JOIN_OVERFLOW_MODE", "BREAK")
    pop_join_overflow()
    out = op_join(dict(left), dict(right), "INNER", ["k"], ["k2"], None,
                  list(JOIN_SCHEMA), join_ctx)
    assert 0 < block_len(out) <= 50
    assert pop_join_overflow() is True
    for jt in ("ANTI", "RIGHT", "FULL"):
        with pytest.raises(ops.JoinRowLimitExceeded):
            op_join(dict(left), dict(right), jt, ["k"], ["k2"], None,
                    list(JOIN_SCHEMA), join_ctx)
    assert pop_join_overflow() is False


def test_join_rows_equal_whatever_the_code_order():
    """Group and join codes are dense either way (the reference's native
    factorizer numbers keys by first occurrence, numpy's unique in sorted
    order): reversing the input rows reorders codes, never the rowset."""
    left, right, _, _ = _join_blocks("object")
    codes, num, first = ops.group_codes([np.asarray(left["k"])])
    rev = {c: v[::-1] for c, v in left.items()}
    rcodes, rnum, rfirst = ops.group_codes([np.asarray(rev["k"])])
    assert num == rnum
    assert sorted(map(repr, np.asarray(left["k"])[first])) == \
        sorted(map(repr, np.asarray(rev["k"])[rfirst]))
    a = op_join(dict(left), dict(right), "LEFT", ["k"], ["k2"], RESIDUAL,
                list(JOIN_SCHEMA))
    b = op_join(rev, dict(right), "LEFT", ["k"], ["k2"], RESIDUAL,
                list(JOIN_SCHEMA))
    assert _join_rowset(a, JOIN_SCHEMA) == _join_rowset(b, JOIN_SCHEMA)


# -- end to end --------------------------------------------------------------


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_shape_fused_matches_jax_host_and_sqlite(engines, captured_runner,
                                                 monkeypatch, shape):
    port, jax, conn = engines
    sql = SHAPES[shape]
    fetches = []
    real_fetch = join_pipeline.fetch_packed

    def counting_fetch(packed):
        fetches.append(packed.shape)
        return real_fetch(packed)

    monkeypatch.setattr(join_pipeline, "fetch_packed", counting_fetch)
    fused = port.execute_sql(FUSED + sql)
    runner = captured_runner["runner"]
    stats = runner.stage_stats.values()
    assert {st["join_impl"] for st in stats if st["join_impl"]} \
        == {"device-fused"}, shape
    assert sum(st["host_crossings"] for st in stats) == 1, shape
    assert [st["host_crossings"] for st in stats
            if st["workers"] == 1 and st["join_impl"]
            and not st["leaf_pushdown"] and st["rows_in"]] == [1]
    assert len(fetches) == 1
    want = jax.execute_sql(FUSED + sql)
    assert _rows(fused, True) == _rows(want, True)
    assert fused.num_device_dispatches == want.num_device_dispatches
    host = port.execute_sql(HOST + sql)
    assert {st["join_impl"] for st in captured_runner["runner"]
            .stage_stats.values() if st["join_impl"]} <= {"host"}
    assert _rows(fused, True) == _rows(host, True)
    assert _rows(fused, True) == _sqlite_rows(conn, sql, True)


@pytest.mark.parametrize("sql,ordered", STATEMENTS)
def test_statement_rows_equal_jax_and_sqlite(engines, sql, ordered):
    port, jax, conn = engines
    got = port.execute_sql(sql)
    assert _rows(got, ordered) == _rows(jax.execute_sql(MSE + sql), ordered)
    if "LIMIT" not in sql or ordered or sql in SQLITE:
        oracle = SQLITE.get(sql, sql)
        assert _rows(got, ordered) == _sqlite_rows(conn, oracle, ordered)


@pytest.mark.parametrize("device_join", ["true", "false"])
def test_colocated_join_matches_jax(engines, captured_runner, device_join):
    port, jax, conn = engines
    sql = ("SELECT c.city, COUNT(*), SUM(o.qty) FROM corders o "
           "JOIN ccusts c ON o.cust = c.cid GROUP BY c.city")
    got = port.execute_sql(f"{MSE}SET deviceJoin = {device_join}; {sql}")
    dists = {n.dist for st in captured_runner["runner"].stages[1:]
             for n in _receives(st.root)}
    assert "partitioned" in dists
    want = jax.execute_sql(f"{MSE}SET deviceJoin = {device_join}; {sql}")
    assert _rows(got, False) == _rows(want, False)
    assert _rows(got, False) == _sqlite_rows(conn, sql, False)


def _receives(node):
    from pinot_tpu_torch.mse.fragmenter import receive_nodes

    return receive_nodes(node)


@pytest.mark.parametrize("sql", [
    "SELECT d_year, COUNT(*), SUM(lo_revenue), MIN(lo_quantity) FROM ssb "
    "WHERE lo_discount < 3 GROUP BY d_year",
    "SELECT d_year, lo_discount, AVG(lo_revenue) FROM ssb "
    "GROUP BY d_year, lo_discount ORDER BY d_year, lo_discount LIMIT 40",
])
def test_mse_group_by_leaf_runs_the_single_stage_path(engines,
                                                      captured_runner, sql):
    port, jax, conn = engines
    got = port.execute_sql(MSE + sql)
    runner = captured_runner["runner"]
    assert runner.stats["leaf_ssqe_pushdowns"] == 1
    want = jax.execute_sql(MSE + sql)
    ordered = "ORDER BY" in sql
    assert _rows(got, ordered) == _rows(want, ordered)
    assert got.num_device_dispatches == want.num_device_dispatches > 0
    assert got.num_docs_scanned == want.num_docs_scanned


def test_engine_selection(engines):
    """A JOIN, an IN subquery and `SET useMultistageEngine = true` are
    answered by the multi-stage engine; a single-table statement stays on
    the single-stage path."""
    port, jax, _ = engines
    for sql in ("SELECT o.oid FROM orders o JOIN customers c "
                "ON o.cust_id = c.cid",
                "SELECT oid FROM orders WHERE cust_id IN "
                "(SELECT cid FROM customers WHERE region = 'east')",
                "SET useMultistageEngine = true; SELECT status, COUNT(*) "
                "FROM orders GROUP BY status"):
        got = port.execute_sql(sql)
        assert got.mse_stage_stats, sql
        assert _rows(got, False) == _rows(jax.execute_sql(sql), False)
    single = port.execute_sql("SELECT status, COUNT(*) FROM orders "
                              "GROUP BY status")
    assert single.mse_stage_stats is None
    bad = port.execute_sql("SELECT FROM WHERE")
    assert bad.result_table is None and bad.exceptions


def test_device_fault_reaches_the_response(engines, monkeypatch):
    """An error in the fused join's device stage fails the query with that
    error; the host join does not answer in its place."""
    port = engines[0]

    def broken(*args, **kwargs):
        raise RuntimeError("injected device fault")

    monkeypatch.setattr(join_pipeline, "fused_join_agg", broken)
    resp = port.execute_sql(FUSED + SHAPES["semi"])
    assert resp.result_table is None
    assert resp.exceptions == ["RuntimeError: injected device fault"]


def test_pair_join_device_fault_reaches_the_response(engines, monkeypatch):
    from pinot_tpu_torch.mse import device_join

    def broken(*args, **kwargs):
        raise RuntimeError("injected pair join fault")

    monkeypatch.setattr(device_join, "device_join_indices", broken)
    monkeypatch.setenv("PINOT_TPU_DEVICE_JOIN", "1")
    resp = engines[0].execute_sql(
        MSE + "SELECT o.oid, c.name FROM orders o JOIN customers c "
        "ON o.cust_id = c.cid")
    assert resp.exceptions == ["RuntimeError: injected pair join fault"]


@pytest.mark.parametrize("error", [UnsupportedQueryError, KeyError])
@pytest.mark.parametrize("entry,sql", [
    ("run_planned", "SELECT d_year, COUNT(*) FROM ssb GROUP BY d_year"),
    ("run_selection_columnar", "SELECT o.oid, c.name FROM orders o "
     "JOIN customers c ON o.cust_id = c.cid"),
])
def test_leaf_error_after_planning_reaches_the_response(engines, monkeypatch,
                                                        entry, sql, error):
    """Only the leaf's planning may refuse it to the generic scan: a
    refusal or KeyError raised once the single-stage engine runs the leaf
    fails the query."""
    def broken(self, planned):
        raise error("injected leaf fault")

    monkeypatch.setattr(QueryExecutor, entry, broken)
    resp = engines[0].execute_sql(MSE + sql)
    assert resp.result_table is None
    assert len(resp.exceptions) == 1
    assert resp.exceptions[0].startswith(error.__name__)
    assert "injected leaf fault" in resp.exceptions[0]


def test_host_crossings_are_measured(engines, captured_runner, monkeypatch):
    """A fused stage's host_crossings counts the device->host fetches its
    thread made, not the path it took."""
    from pinot_tpu_torch.ops import kernels

    real_fetch = join_pipeline.fetch_packed

    def fetch_twice(packed):
        kernels.count_host_fetch()
        return real_fetch(packed)

    monkeypatch.setattr(join_pipeline, "fetch_packed", fetch_twice)
    resp = engines[0].execute_sql(FUSED + SHAPES["semi"])
    assert not resp.exceptions
    fused = [st for st in captured_runner["runner"].stage_stats.values()
             if st["join_impl"] == "device-fused"]
    assert [st["host_crossings"] for st in fused] == [2]


def test_concurrent_leaves_on_one_table(engines):
    """Two threads run multi-stage statements over the same table at once,
    on a fresh executor (so their leaves upload planes and fill the device
    cache concurrently): every answer equals the serial one."""
    _, jax, _ = engines
    port = QueryExecutor(device="cpu")
    dims, metrics = SSB_DIMS, [("lo_revenue", "INT")]
    port.add_table(Schema.build("ssb", dimensions=dims, metrics=metrics),
                   engines[0].tables["ssb"].segments)
    sqls = [FUSED + SHAPES["chain2"],
            MSE + "SELECT d_year, COUNT(*), SUM(lo_revenue) FROM ssb "
            "WHERE lo_quantity < 5 GROUP BY d_year",
            FUSED + SHAPES["left_build_residual"],
            MSE + "SELECT a.d_year, b.lo_discount FROM ssb a JOIN ssb b "
            "ON a.lo_orderkey = b.lo_orderkey WHERE a.lo_quantity = 1 "
            "AND b.lo_quantity = 2"]
    want = {s: _rows(jax.execute_sql(s), False) for s in sqls}
    errors, results = [], []

    def worker(offset):
        try:
            for i in range(6):
                s = sqls[(i + offset) % len(sqls)]
                results.append((s, _rows(port.execute_sql(s), False)))
        except Exception as e:  # surfaced by the assertion below
            errors.append(e)

    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(k,))
                   for k in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(prev)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert len(results) == 18
    for s, rows in results:
        assert rows == want[s], s


@pytest.mark.parametrize("sql", [
    "SELECT status, COUNT(*) FROM orders GROUP BY status "
    "HAVING status IS NOT NULL",
    "SELECT status, SUM(amount) FROM orders GROUP BY status "
    "HAVING REGEXP_LIKE(status, 'o.*')"])
def test_reduce_refusal_is_answered_by_the_multistage_engine(engines, sql):
    """A HAVING predicate the single-stage broker reduce does not evaluate:
    both packages answer the statement through the multi-stage engine."""
    port, jax, _ = engines
    got, want = port.execute_sql(sql), jax.execute_sql(sql)
    assert got.mse_stage_stats and want.mse_stage_stats
    assert _rows(got, False) == _rows(want, False)


def test_refusal_of_both_engines_raises(engines):
    port, jax, _ = engines
    sql = "SELECT cust_id, COUNT(*) FROM orders GROUP BY cust_id ORDER BY amount"
    assert jax.execute_sql(sql).exceptions
    with pytest.raises(UnsupportedQueryError, match="group-by result"):
        port.execute_sql(sql)


def test_consuming_segment_joins_through_its_snapshot(engines):
    """A realtime table (an immutable segment and a consuming one fed a row
    at a time, in both packages) joined to customers: the scan leaf pins
    the consuming segment's snapshot, as the reference's does."""
    from pinot_tpu.segment.mutable import MutableSegment as JaxMutable
    from pinot_tpu_torch.segment.mutable import MutableSegment

    port, jax, _ = engines
    dims, metrics = ORDERS_DIMS, [("amount", "INT")]
    live = MutableSegment(Schema.build("live", dimensions=dims,
                                       metrics=metrics), "live_0")
    jlive = JaxMutable(JaxSchema.build("live", dimensions=dims,
                                       metrics=metrics), "live_0")
    rng = np.random.default_rng(3)
    for i in range(300):
        row = {"oid": 100 + i, "cust_id": int(rng.integers(0, 8)),
               "status": ["open", "done"][i % 2],
               "amount": int(rng.integers(1, 90))}
        live.index(row)
        jlive.index(row)
    port.add_table(Schema.build("live", dimensions=dims, metrics=metrics),
                   [port.tables["orders"].segments[0], live])
    jax.add_table(JaxSchema.build("live", dimensions=dims, metrics=metrics),
                  [jax.tables["orders"].segments[0], jlive])
    sql = ("SELECT c.region, COUNT(*), SUM(o.amount) FROM live o "
           "JOIN customers c ON o.cust_id = c.cid WHERE o.amount > 20 "
           "GROUP BY c.region")
    for prefix in (HOST, FUSED):
        assert _rows(port.execute_sql(prefix + sql), False) == \
            _rows(jax.execute_sql(prefix + sql), False)
    # a generic scan leaf (a projection) reads the snapshot's host columns
    proj = MSE + "SELECT oid * 2, status FROM live WHERE cust_id = 3"
    assert _rows(port.execute_sql(proj), False) == \
        _rows(jax.execute_sql(proj), False)


@pytest.mark.parametrize("sql", [
    "SELECT c.region, EXPRMIN(o.oid, o.amount), EXPRMAX(o.status, o.amount) "
    "FROM orders o JOIN customers c ON o.cust_id = c.cid GROUP BY c.region",
    "SELECT status, SUMPRECISION(amount) FROM orders GROUP BY status",
    "SELECT LASTWITHTIME(status, oid, 'STRING'), "
    "FIRSTWITHTIME(amount, oid, 'INT') FROM orders",
    "SELECT cust_id, LISTAGG(status), ARRAYAGG(amount, 'INT') FROM orders "
    "WHERE oid < 8 GROUP BY cust_id"])
def test_host_only_aggregations_equal_jax(engines, sql):
    """Aggregations with no device form (object-valued, exact decimal,
    arrays): the multi-stage engine's host aggregate answers them as the
    reference's does; the single-stage planner refuses them, and
    execute_sql without the option retries them on the multi-stage engine,
    as the JAX package does under backend="tpu"."""
    port, jax, _ = engines
    got, want = port.execute_sql(MSE + sql), jax.execute_sql(MSE + sql)
    assert sorted(map(repr, _rows(got, False))) == \
        sorted(map(repr, _rows(want, False)))
    if "JOIN" not in sql:
        with pytest.raises(UnsupportedQueryError, match="no device form"):
            port.execute(parse_sql(sql))
        assert sorted(map(repr, _rows(port.execute_sql(sql), False))) == \
            sorted(map(repr, _rows(jax.execute_sql(sql), False)))
