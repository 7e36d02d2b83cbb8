"""pinot-admin CLI.

The port's copy of pinot_tpu/tools/admin.py. Reference: pinot-tools
PinotAdministrator (pinot-tools/.../admin/PinotAdministrator.java:93) and
its subcommands (QuickStart, LaunchDataIngestionJob, PostQuery,
.../admin/command/).

Usage:
    python -m pinot_tpu_torch.tools.admin quickstart [--rows N]
        [--servers K] [--once] [--device cuda|cpu]
    python -m pinot_tpu_torch.tools.admin query --broker URL --sql "SELECT ..."
    python -m pinot_tpu_torch.tools.admin ingest --spec job.yaml \\
        --schema schema.json [--table-config table.json]
    python -m pinot_tpu_torch.tools.admin tables --controller URL

`quickstart` boots an in-process cluster (a controller, K servers on
`--device`, "cuda" by default, with the default query backend, and a
broker, each behind its REST server), loads a seeded baseballStats table
of N rows in 4 segments, runs three demo queries through the HTTP client
and prints each one's columns, its first rows and, on a `json:` line, all
its rows. With `--once` it then stops everything and removes its segment
directory; without, it serves until interrupted.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import time
import urllib.request
from pathlib import Path

import numpy as np

TEAMS = ["ANA", "BOS", "CHA", "DET", "LAN", "NYA", "SFN", "SLN"]
DEMO_SQL = [
    "SELECT COUNT(*) FROM baseballStats",
    "SELECT teamID, SUM(runs) FROM baseballStats GROUP BY teamID "
    "ORDER BY SUM(runs) DESC LIMIT 5",
    "SELECT yearID, MAX(homeRuns) FROM baseballStats "
    "WHERE yearID >= 2015 GROUP BY yearID ORDER BY yearID LIMIT 10",
]


def quickstart_segments(n: int) -> list[dict]:
    """The quickstart's columns, segment by segment: n rows in 4 segments
    from numpy's generator at seed 0 (the JAX package's quickstart data)."""
    rng = np.random.default_rng(0)
    per_seg = max(1, n // 4)
    out = []
    for i in range(4):
        rows = min(per_seg, n - i * per_seg)
        if rows <= 0:
            break
        out.append({
            "playerName": np.asarray(
                [f"player{j}" for j in
                 rng.integers(0, max(rows // 3, 1), rows)], dtype=object),
            "teamID": np.asarray(TEAMS, dtype=object)[
                rng.integers(0, 8, rows)],
            "yearID": rng.integers(1990, 2024, rows).astype(np.int32),
            "runs": rng.integers(0, 150, rows).astype(np.int32),
            "hits": rng.integers(0, 200, rows).astype(np.int32),
            "homeRuns": rng.integers(0, 60, rows).astype(np.int32),
        })
    return out


def cmd_quickstart(args) -> int:
    """Boot an in-process cluster with sample data and serve HTTP
    (reference: the Quickstart command's batch flavor)."""
    from ..client import connect
    from ..cluster import (Broker, BrokerRestServer, ClusterController,
                           ControllerRestServer, PropertyStore,
                           ServerInstance, ServerRestServer)
    from ..segment.builder import SegmentBuilder
    from ..spi.data_types import Schema

    store = PropertyStore()
    controller = ClusterController(store)
    servers = [ServerInstance(store, f"Server_{i}", device=args.device)
               for i in range(args.servers)]
    for s in servers:
        s.start()
    broker = Broker(store)

    schema = Schema.build(
        "baseballStats",
        dimensions=[("playerName", "STRING"), ("teamID", "STRING"),
                    ("yearID", "INT")],
        metrics=[("runs", "INT"), ("hits", "INT"), ("homeRuns", "INT")])
    controller.add_schema(schema.to_json())
    table = controller.create_table(
        {"tableName": "baseballStats", "replication": min(args.servers, 2)})
    work = Path(tempfile.mkdtemp(prefix="pinot_quickstart_"))
    for i, cols in enumerate(quickstart_segments(args.rows)):
        name = f"baseballStats_{i}"
        SegmentBuilder(schema, segment_name=name).build(cols, work / name)
        controller.add_segment(table, name, {
            "location": str(work / name), "numDocs": len(cols["runs"])})

    broker_rest = BrokerRestServer(broker, port=args.broker_port)
    controller_rest = ControllerRestServer(controller,
                                           port=args.controller_port)
    server_rests = [ServerRestServer(s) for s in servers]
    print(f"broker:     {broker_rest.url}")
    print(f"controller: {controller_rest.url}")
    for s_inst, sr in zip(servers, server_rests):
        print(f"server {s_inst.instance_id}: {sr.url} ({s_inst.device})")

    def stop():
        broker_rest.close()
        controller_rest.close()
        for sr in server_rests:
            sr.close()
        for s in servers:
            s.stop()
        broker.close()
        shutil.rmtree(work, ignore_errors=True)

    try:
        conn = connect(broker_rest.url)
        for sql in DEMO_SQL:
            rs = conn.execute(sql)
            rows = list(rs)
            print(f"\n> {sql}")
            print(f"  columns: {rs.column_names}")
            for row in rows[:5]:
                print(f"  {row}")
            print("  json: " + json.dumps([list(r) for r in rows],
                                          default=str))
        if args.once:
            return 0
        print("\nserving; ^C to stop")
        try:
            while True:
                time.sleep(1)
        except KeyboardInterrupt:
            return 0
    finally:
        stop()


def cmd_query(args) -> int:
    from ..client import connect

    rs = connect(args.broker).execute(args.sql)
    print(json.dumps({"columns": rs.column_names, "rows": rs.rows,
                      "stats": rs.execution_stats}, indent=2, default=str))
    return 0


def cmd_ingest(args) -> int:
    """Reference: LaunchDataIngestionJobCommand."""
    from ..ingestion.batch import (IngestionJobLauncher,
                                   SegmentGenerationJobSpec)
    from ..spi.data_types import Schema
    from ..spi.table_config import TableConfig

    schema = Schema.from_json(json.loads(Path(args.schema).read_text()))
    if args.table_config:
        table_config = TableConfig.from_json(
            json.loads(Path(args.table_config).read_text()))
    else:
        table_config = TableConfig(table_name=schema.schema_name)
    spec = SegmentGenerationJobSpec.from_yaml(args.spec, schema, table_config)
    for r in IngestionJobLauncher(spec).run():
        print(f"built {r.segment_name}: {r.num_docs} docs -> {r.output_uri}")
    return 0


def cmd_tables(args) -> int:
    with urllib.request.urlopen(args.controller.rstrip("/") + "/tables") as r:
        print(r.read().decode())
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="pinot-admin",
                                description="pinot_tpu_torch administration")
    sub = p.add_subparsers(dest="command", required=True)

    q = sub.add_parser("quickstart", help="boot an in-process demo cluster")
    q.add_argument("--rows", type=int, default=100_000)
    q.add_argument("--servers", type=int, default=2)
    q.add_argument("--broker-port", type=int, default=0)
    q.add_argument("--controller-port", type=int, default=0)
    q.add_argument("--device", default="cuda",
                   help="the servers' device: cuda (default) or cpu")
    q.add_argument("--once", action="store_true",
                   help="run the demo queries and exit")
    q.set_defaults(fn=cmd_quickstart)

    qq = sub.add_parser("query", help="POST sql to a broker")
    qq.add_argument("--broker", required=True)
    qq.add_argument("--sql", required=True)
    qq.set_defaults(fn=cmd_query)

    ing = sub.add_parser("ingest", help="run a batch ingestion job spec")
    ing.add_argument("--spec", required=True, help="job spec YAML")
    ing.add_argument("--schema", required=True, help="schema JSON file")
    ing.add_argument("--table-config", help="table config JSON file")
    ing.set_defaults(fn=cmd_ingest)

    t = sub.add_parser("tables", help="list tables via controller REST")
    t.add_argument("--controller", required=True)
    t.set_defaults(fn=cmd_tables)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
