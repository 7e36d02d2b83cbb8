"""The port's admin CLI (`python -m pinot_tpu_torch.tools.admin`) against
the JAX package's.

`quickstart --once --device cpu` boots the port's in-process cluster on
the CPU and prints the demo queries' rows: they equal the rows the JAX
package's `quickstart --once` prints over the same seeded data, and a
numpy oracle over `quickstart_segments`. `query` posts SQL to a port
broker's REST server and prints the broker's rows; `tables` lists the
controller's tables; `ingest` runs a job spec and builds the JAX
package's segment bytes. Small sizes (2,000 quickstart rows). Tolerance:
exact.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from pinot_tpu.tools import admin as jax_admin
from pinot_tpu_torch import cluster as pcl
from pinot_tpu_torch.segment.builder import SegmentBuilder
from pinot_tpu_torch.spi.data_types import Schema
from pinot_tpu_torch.tools import admin

REPO = Path(__file__).resolve().parents[1]
ROWS = 2000


def _demo_rows(out: str) -> list:
    """The `json:` lines of a port quickstart's output."""
    return [json.loads(line.split("json: ", 1)[1])
            for line in out.splitlines() if line.startswith("  json: ")]


def _printed_rows(out: str) -> list:
    """Each demo query's printed rows (the first five), per query."""
    blocks, cur = [], None
    for line in out.splitlines():
        if line.startswith("> "):
            cur = []
            blocks.append(cur)
        elif cur is not None and line.startswith("  ["):
            cur.append(line.strip())
    return blocks


def _oracle() -> list:
    segs = admin.quickstart_segments(ROWS)
    cols = {k: np.concatenate([s[k] for s in segs]) for k in segs[0]}
    by_team = {t: float(cols["runs"][cols["teamID"] == t].sum())
               for t in set(cols["teamID"].tolist())}
    top = sorted(by_team.items(), key=lambda kv: -kv[1])[:5]
    years = sorted({int(y) for y in cols["yearID"] if y >= 2015})
    return [[[len(cols["runs"])]],
            [[t, v] for t, v in top],
            [[y, float(cols["homeRuns"][cols["yearID"] == y].max())]
             for y in years][:10]]


def test_quickstart_once_on_the_cpu_as_jax(capsys, monkeypatch):
    assert admin.main(["quickstart", "--rows", str(ROWS), "--once",
                       "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "(cpu)" in out
    assert _demo_rows(out) == _oracle()
    monkeypatch.setenv("PINOT_TPU_SEGMENT_CACHE", "0")
    monkeypatch.setenv("PINOT_TPU_RESULT_CACHE", "0")
    assert jax_admin.main(["quickstart", "--rows", str(ROWS), "--once"]) == 0
    jax_out = capsys.readouterr().out
    assert _printed_rows(out) == _printed_rows(jax_out)
    assert [len(b) for b in _printed_rows(out)] == [1, 5, 5]


def test_quickstart_as_a_module(tmp_path):
    """`python -m pinot_tpu_torch.tools.admin`, as a user runs it."""
    env = {"PYTHONPATH": str(REPO), "PATH": "/usr/bin:/bin",
           "HOME": str(tmp_path), "TMPDIR": str(tmp_path)}
    p = subprocess.run(
        [sys.executable, "-m", "pinot_tpu_torch.tools.admin", "quickstart",
         "--rows", "400", "--servers", "1", "--once", "--device", "cpu"],
        capture_output=True, text=True, timeout=300, env=env, cwd=tmp_path)
    assert p.returncode == 0, p.stderr
    assert _demo_rows(p.stdout)[0] == [[400]]
    # the segment directory went with the cluster
    assert not list(tmp_path.glob("pinot_quickstart_*"))


@pytest.fixture()
def cluster(tmp_path):
    schema = Schema.build("t", dimensions=[("d", "STRING")],
                          metrics=[("m", "INT")])
    store = pcl.PropertyStore()
    controller = pcl.ClusterController(store)
    server = pcl.ServerInstance(store, "Server_0", device="cpu")
    server.start()
    broker = pcl.Broker(store)
    controller.add_schema(schema.to_json())
    table = controller.create_table({"tableName": "t", "replication": 1})
    SegmentBuilder(schema, segment_name="s0").build(
        {"d": np.asarray(["a", "b", "a"], dtype=object),
         "m": np.asarray([1, 2, 3], dtype=np.int32)}, tmp_path / "s0")
    controller.add_segment(table, "s0", {"location": str(tmp_path / "s0"),
                                         "numDocs": 3})
    rest = pcl.BrokerRestServer(broker)
    crest = pcl.ControllerRestServer(controller)
    yield rest.url, crest.url
    rest.close()
    crest.close()
    server.stop()
    broker.close()


def test_query_prints_the_brokers_rows(cluster, capsys):
    broker_url, _ = cluster
    assert admin.main(["query", "--broker", broker_url, "--sql",
                       "SELECT d, SUM(m) FROM t GROUP BY d ORDER BY d"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["columns"] == ["d", "sum(m)"]
    assert out["rows"] == [["a", 4.0], ["b", 2.0]]
    assert out["stats"]["numDocsScanned"] == 3


def test_tables_lists_the_controllers_tables(cluster, capsys):
    _, controller_url = cluster
    assert admin.main(["tables", "--controller", controller_url]) == 0
    assert "t_OFFLINE" in capsys.readouterr().out


def test_ingest_builds_the_jax_segments(tmp_path, capsys):
    schema = {"schemaName": "t",
              "dimensionFieldSpecs": [{"name": "d", "dataType": "STRING"}],
              "metricFieldSpecs": [{"name": "m", "dataType": "INT"}]}
    (tmp_path / "schema.json").write_text(json.dumps(schema))
    (tmp_path / "in").mkdir()
    for i in range(2):
        (tmp_path / "in" / f"part{i}.csv").write_text(
            "d,m\n" + "".join(f"k{(i + j) % 3},{j * 7 + i}\n"
                              for j in range(50)))
    for pkg, mod in (("port", admin), ("jax", jax_admin)):
        spec = tmp_path / f"{pkg}.yaml"
        spec.write_text(f"inputDirURI: {tmp_path / 'in'}\n"
                        f"outputDirURI: {tmp_path / pkg}\n"
                        "includeFileNamePattern: '*.csv'\n")
        assert mod.main(["ingest", "--spec", str(spec), "--schema",
                         str(tmp_path / "schema.json")]) == 0
    out = capsys.readouterr().out
    assert out.count("built ") == 4 and "50 docs" in out
    port_bins = sorted((tmp_path / "port").rglob("data.bin"))
    jax_bins = sorted((tmp_path / "jax").rglob("data.bin"))
    assert len(port_bins) == len(jax_bins) == 2
    for a, b in zip(port_bins, jax_bins):
        assert a.read_bytes() == b.read_bytes()
