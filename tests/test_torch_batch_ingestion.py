"""The port's offline data path against the JAX package's: record readers,
the batch ingestion job spec and runners, the tar push, and the servers
that load what was pushed.

The cases of tests/test_batch_ingestion.py but its Confluent decoder (the
stream plugins are not ported yet), each run through both packages over
input files written once, by one writer:

  * every reader yields the same records in both packages: CSV (header
    config, multi-value delimiter, gzip), JSON lines and array, Avro with
    the null and deflate codecs, Thrift, Protobuf, Parquet, ORC and the
    CLP log reader; the two Avro writers and the two Thrift encoders write
    the same bytes;
  * the job spec reads the same YAML into the same fields;
  * both packages' standalone launchers build byte-equal segments from the
    same mixed-format input directory (data.bin, and metadata.json but its
    creation time: columns, dictionaries, partition stamps), and the port's
    multiprocess runner builds the same bytes in 2 spawned workers that
    import only pinot_tpu_torch; queries over them give the same rows;
  * the same tarred segments pushed to a port cluster (device="cpu") and a
    JAX cluster (backend="host") answer the same rows.

The tolerance is exact: element-equal records, bytes and rows.
"""

from __future__ import annotations

import concurrent.futures as cf
import csv
import gzip
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import pinot_tpu.ingestion.batch as jbatch
import pinot_tpu.plugins.inputformat as jreaders
import pinot_tpu.plugins.inputformat.avro as javro
import pinot_tpu.plugins.inputformat.clplog as jclp
import pinot_tpu.plugins.inputformat.protobuf as jproto
import pinot_tpu.plugins.inputformat.thrift as jthrift
import pinot_tpu_torch.ingestion.batch as pbatch
import pinot_tpu_torch.plugins.inputformat as preaders
import pinot_tpu_torch.plugins.inputformat.avro as pavro
import pinot_tpu_torch.plugins.inputformat.clplog as pclp
import pinot_tpu_torch.plugins.inputformat.protobuf as pproto
import pinot_tpu_torch.plugins.inputformat.thrift as pthrift
from pinot_tpu.spi.data_types import Schema as JSchema
from pinot_tpu.spi.table_config import IndexingConfig as JIndexing
from pinot_tpu.spi.table_config import TableConfig as JTableConfig
from pinot_tpu_torch.spi.data_types import Schema
from pinot_tpu_torch.spi.table_config import IndexingConfig, TableConfig

ROOT = Path(__file__).resolve().parent.parent
DIMS = [("city", "STRING"), ("day", "INT"), ("tags", "INT", False)]
METRICS = [("fare", "DOUBLE"), ("ts", "LONG")]
CITIES = ["sf", "ny", "la", "chi", None]
THRIFT_IDS = {"1": "city", "2": "day", "3": "fare", "4": "tags", "5": "ts"}
AVRO_SCHEMA = {
    "type": "record", "name": "Trip",
    "fields": [
        {"name": "city", "type": ["null", "string"]},
        {"name": "day", "type": "int"},
        {"name": "fare", "type": "double"},
        {"name": "tags", "type": {"type": "array", "items": "long"}},
        {"name": "ts", "type": "long"},
        {"name": "props", "type": {"type": "map", "values": "long"}},
    ]}


def _schemas():
    return (Schema.build("trips", dimensions=DIMS, metrics=METRICS),
            JSchema.build("trips", dimensions=DIMS, metrics=METRICS))


def _configs(partitioned=True):
    part = {"day": {"functionName": "Modulo", "numPartitions": 4}} \
        if partitioned else {}
    return (TableConfig(table_name="trips", indexing=IndexingConfig(
                segment_partition_config=part)),
            JTableConfig(table_name="trips", indexing=JIndexing(
                segment_partition_config=part)))


def _rows(seed: int, n: int) -> list[dict]:
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        rows.append({
            "city": CITIES[int(rng.integers(0, len(CITIES)))],
            "day": int(rng.integers(0, 31)),
            "fare": float(np.round(rng.random() * 100, 2)),
            "tags": [int(x) for x in rng.integers(0, 9, int(rng.integers(
                1, 4)))],
            "ts": 1_600_000_000_000 + i * 1000,
        })
    return rows


# -- the input files, written once --------------------------------------------


def _write_csv(path, rows, gz=False):
    opener = (lambda: gzip.open(path, "wt", newline="")) if gz else \
        (lambda: open(path, "w", newline=""))
    with opener() as f:
        w = csv.writer(f)
        w.writerow(["city", "day", "fare", "tags", "ts"])
        for r in rows:
            w.writerow(["" if r["city"] is None else r["city"], r["day"],
                        r["fare"], ";".join(map(str, r["tags"])), r["ts"]])


def _thrift_bytes(thrift_mod, rows) -> bytes:
    buf = bytearray()
    for r in rows:
        fields = {1: r["city"], 2: r["day"], 3: r["fare"], 4: r["tags"],
                  5: r["ts"]}
        thrift_mod.write_struct(buf, {k: v for k, v in fields.items()
                                      if v is not None})
    return bytes(buf)


def _write_avro(avro_mod, path, rows, codec):
    with open(path, "wb") as f:
        avro_mod.write_avro_file(f, AVRO_SCHEMA,
                                 [dict(r, props={"k": r["day"]})
                                  for r in rows], codec=codec)


def _proto_class():
    from google.protobuf import descriptor_pb2

    fds = descriptor_pb2.FileDescriptorSet()
    fd = fds.file.add()
    fd.name, fd.package, fd.syntax = "trip.proto", "trips", "proto3"
    msg = fd.message_type.add()
    msg.name = "Trip"
    for num, (name, typ, label) in enumerate(
            (("city", 9, 1), ("day", 5, 1), ("fare", 1, 1), ("tags", 3, 3),
             ("ts", 3, 1)), start=1):
        f = msg.field.add()
        f.name, f.number, f.type, f.label = name, num, typ, label
    raw = fds.SerializeToString()
    return raw, pproto.load_message_class(raw, "trips.Trip")


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """One directory of input files, one format a file, and the reader
    config that reads them all."""
    d = tmp_path_factory.mktemp("batch_inputs")
    ind = d / "in"
    ind.mkdir()
    rows = {k: _rows(seed, 240) for seed, k in enumerate(
        ("csv", "csvgz", "jsonl", "jsona", "avro", "avrod", "thrift",
         "proto", "parquet", "orc"))}
    _write_csv(ind / "a.csv", rows["csv"])
    _write_csv(ind / "b.csv.gz", rows["csvgz"], gz=True)
    (ind / "c.json").write_text(
        "\n".join(json.dumps(r) for r in rows["jsonl"]))
    (ind / "d.json").write_text(json.dumps(rows["jsona"]))
    _write_avro(javro, ind / "e.avro", rows["avro"], "null")
    _write_avro(javro, ind / "f.avro", rows["avrod"], "deflate")
    (ind / "g.thrift").write_bytes(_thrift_bytes(jthrift, rows["thrift"]))
    pytest.importorskip("google.protobuf")
    raw, cls = _proto_class()
    (d / "trip.desc").write_bytes(raw)
    with open(ind / "h.protobuf", "wb") as f:
        jproto.write_delimited(f, [cls(**{k: v for k, v in r.items()
                                          if v is not None})
                                   for r in rows["proto"]])
    pa = pytest.importorskip("pyarrow")
    import pyarrow.parquet as pq
    from pyarrow import orc

    pq.write_table(pa.Table.from_pylist(rows["parquet"]), ind / "i.parquet")
    orc.write_table(pa.Table.from_pylist(rows["orc"]), ind / "j.orc")
    config = {"multiValueDelimiter": ";", "fieldIdToName": THRIFT_IDS,
              "descriptorFile": str(d / "trip.desc"),
              "protoClassName": "trips.Trip"}
    return d, ind, config, rows


# -- record readers ----------------------------------------------------------


def test_every_reader_yields_the_jax_records(inputs):
    _d, ind, config, rows = inputs
    files = sorted(ind.iterdir())
    assert len(files) == 10
    for path in files:
        got = list(preaders.create_record_reader(str(path), config=config))
        want = list(jreaders.create_record_reader(str(path), config=config))
        assert got == want, path.name
        assert len(got) == 240
    # the typed formats give back what was written
    first = {p.name: next(iter(preaders.create_record_reader(
        str(p), config=config))) for p in files}
    assert first["e.avro"] == dict(rows["avro"][0],
                                   props={"k": rows["avro"][0]["day"]})
    assert first["c.json"] == rows["jsonl"][0]
    assert first["i.parquet"] == rows["parquet"][0]


def test_csv_cases_equal_jax(tmp_path):
    """tests/test_batch_ingestion.py's CSV cases: nulls, a header from the
    config, a multi-value cell and gzip."""
    (tmp_path / "a.csv").write_text("city,day,fare\nsf,1,10.5\nny,1,20.0\n,2,\n")
    (tmp_path / "h.csv").write_text("sf|1|2.5\nny|2|x\n")
    with gzip.open(tmp_path / "b.csv.gz", "wt") as f:
        f.write("name,tags\nx,a;b;c\ny,solo\n")
    cases = [("a.csv", None), ("h.csv", {"delimiter": "|",
                                         "header": "city, day, fare"}),
             ("b.csv.gz", {"multiValueDelimiter": ";"})]
    for name, cfg in cases:
        path = str(tmp_path / name)
        assert list(preaders.create_record_reader(path, config=cfg)) == \
            list(jreaders.create_record_reader(path, config=cfg))
    rows = list(preaders.create_record_reader(str(tmp_path / "a.csv")))
    assert rows[0] == {"city": "sf", "day": 1, "fare": 10.5}
    assert rows[2]["city"] is None and rows[2]["fare"] is None
    mv = list(preaders.create_record_reader(str(tmp_path / "b.csv.gz"),
                                            config=cases[2][1]))
    assert mv[0]["tags"] == ["a", "b", "c"] and mv[1]["tags"] == "solo"


@pytest.mark.parametrize("codec", ["null", "deflate"])
def test_avro_writers_write_the_same_bytes(tmp_path, codec):
    records = [
        {"city": "sf", "day": 1, "fare": 10.5, "tags": [1, 2], "ts": 3,
         "props": {"k": 1}},
        {"city": None, "day": -2, "fare": -0.5, "tags": [], "ts": -4,
         "props": {}},
        {"city": "日本", "day": 12345678, "fare": 1e9, "tags": [7],
         "ts": 1 << 40, "props": {"x": -9}},
    ]
    for mod in (pavro, javro):
        _write_avro(mod, tmp_path / f"{mod.__name__}.avro",
                    [{k: v for k, v in r.items() if k != "props"}
                     for r in records], codec)
    pbytes = (tmp_path / f"{pavro.__name__}.avro").read_bytes()
    assert pbytes == (tmp_path / f"{javro.__name__}.avro").read_bytes()
    with open(tmp_path / f"{javro.__name__}.avro", "rb") as f:
        back = list(pavro.read_avro_file(f))
    assert back == [dict(r, props={"k": r["day"]}) for r in records]
    # a damaged container fails the same way in both
    bad = tmp_path / "bad.avro"
    bad.write_bytes(pbytes[:-3] + b"xyz")
    errors = []
    for mod in (pavro, javro):
        with open(bad, "rb") as f:
            with pytest.raises(Exception) as e:
                list(mod.read_avro_file(f))
        errors.append((type(e.value).__name__, str(e.value)))
    assert errors[0] == errors[1] == ("AvroError", "sync marker mismatch")


def test_thrift_encoders_and_readers_equal_jax(tmp_path):
    rows = [{1: "widget", 2: 42, 3: 9.5, 4: True, 5: [1, 2, 3],
             6: {1: "nested"}}, {1: "gadget", 2: -7}]
    bufs = []
    for mod in (pthrift, jthrift):
        buf = bytearray()
        for r in rows:
            mod.write_struct(buf, r)
        bufs.append(bytes(buf))
    assert bufs[0] == bufs[1]
    p = tmp_path / "rows.thrift"
    p.write_bytes(bufs[0])
    cfg = {"fieldIdToName": {"1": "name", "2": "qty", "3": "price",
                             "4": "ok", "5": "tags"}}
    got = list(preaders.create_record_reader(str(p), config=cfg))
    assert got == list(jreaders.create_record_reader(str(p), config=cfg))
    assert got == [{"name": "widget", "qty": 42, "price": 9.5, "ok": True,
                    "tags": [1, 2, 3], "6": {"1": "nested"}},
                   {"name": "gadget", "qty": -7}]
    p.write_bytes(bufs[0][:-5])  # truncated: EOFError in both
    for readers in (preaders, jreaders):
        with pytest.raises(EOFError):
            list(readers.create_record_reader(str(p), config=cfg))


def test_protobuf_reader_equal_jax(inputs):
    pytest.importorskip("google.protobuf")
    d, ind, config, rows = inputs
    got = list(preaders.create_record_reader(str(ind / "h.protobuf"),
                                             config=config))
    assert got == list(jreaders.create_record_reader(
        str(ind / "h.protobuf"), config=config))
    r = rows["proto"][0]
    assert got[0]["ts"] == str(r["ts"]) and got[0]["day"] == r["day"]
    for readers in (preaders, jreaders):  # the config names both or fails
        with pytest.raises(ValueError, match="descriptorFile"):
            list(readers.create_record_reader(str(ind / "h.protobuf")))


def test_clp_log_reader_equal_jax(tmp_path):
    rng = np.random.default_rng(5)
    lines = []
    for i in range(200):
        lines.append(json.dumps({
            "ts": i, "level": "INFO",
            "message": (f"order {int(rng.integers(0, 10**6))} shipped "
                        f"qty={int(rng.integers(1, 50))} "
                        f"price={rng.random() * 100:.3f} user=u{i % 7}x "
                        f"code=00{i % 3}")}))
    lines.append(json.dumps({"ts": 200, "level": "WARN", "message": None}))
    p = tmp_path / "app.clplog"
    p.write_text("\n".join(lines))
    cfg = {"fieldsForClpEncoding": ["message"]}
    got = list(preaders.create_record_reader(str(p), config=cfg))
    assert got == list(jreaders.create_record_reader(str(p), config=cfg))
    assert set(got[0]) == {"ts", "level", "message_logtype",
                           "message_dictionaryVars", "message_encodedVars"}
    for rec, line in zip(got, lines):
        msg = json.loads(line)["message"]
        assert pclp.decode_field(rec["message_logtype"],
                                 rec["message_dictionaryVars"],
                                 rec["message_encodedVars"]) == (msg or "")
    for lit in ("12", "-7", "007", "3.25", "-0.50", "+3", "1e5"):
        kind = "f" if "." in lit else "i"
        assert pclp.encode_var_to_long(kind, lit) == \
            jclp.encode_var_to_long(kind, lit)


def test_unknown_format_raises_as_jax(tmp_path):
    p = tmp_path / "x.weird"
    p.write_text("")
    for readers in (preaders, jreaders):
        with pytest.raises(ValueError, match="no record reader"):
            readers.create_record_reader(str(p))


def test_registered_reader_resolves_in_both(tmp_path):
    class Upper(preaders.RecordReader):
        def _iter(self):
            yield {"city": "SF"}

    from pinot_tpu_torch.plugins.inputformat import readers as pmod

    preaders.register_record_reader("upper", Upper)
    try:
        p = tmp_path / "a.upper"
        p.write_text("")
        assert list(preaders.create_record_reader(str(p))) == [{"city": "SF"}]
        from pinot_tpu_torch.spi.plugins import resolve

        assert resolve("inputformat", "UPPER") is Upper
    finally:
        pmod._READERS.pop("upper")


# -- job spec ----------------------------------------------------------------


def test_yaml_spec_equal_jax(tmp_path):
    yml = tmp_path / "job.yaml"
    yml.write_text(f"""
executionFrameworkSpec:
  name: standalone
jobType: SegmentCreationAndTarPush
inputDirURI: "file://{tmp_path}/in"
outputDirURI: "file://{tmp_path}/out"
includeFileNamePattern: "*.csv"
recordReaderSpec:
  dataFormat: csv
  configs:
    multiValueDelimiter: ";"
segmentNameGeneratorSpec:
  configs:
    segment.name.prefix: "trips_batch"
pinotFSSpecs:
  - scheme: file
""")
    (p_schema, j_schema), (p_cfg, j_cfg) = _schemas(), _configs()
    got = pbatch.SegmentGenerationJobSpec.from_yaml(str(yml), p_schema, p_cfg)
    want = jbatch.SegmentGenerationJobSpec.from_yaml(str(yml), j_schema, j_cfg)
    fields = [f for f in vars(want) if f not in ("schema", "table_config")]
    assert {f: getattr(got, f) for f in fields} == \
        {f: getattr(want, f) for f in fields}
    assert got.segment_name_prefix == "trips_batch"
    assert got.record_reader_config == {"multiValueDelimiter": ";"}


def test_unknown_execution_framework_rejected_as_jax(tmp_path):
    (tmp_path / "a.csv").write_text("city,day,fare,tags,ts\nsf,1,2.0,1,5\n")
    for batch, (schema, cfg) in ((pbatch, (_schemas()[0], _configs()[0])),
                                 (jbatch, (_schemas()[1], _configs()[1]))):
        spec = batch.SegmentGenerationJobSpec(
            input_dir_uri=str(tmp_path), output_dir_uri=str(tmp_path / "out"),
            schema=schema, table_config=cfg, execution_framework="flink")
        with pytest.raises(ValueError, match="executionFramework"):
            batch.IngestionJobLauncher(spec).run()
        spec.input_dir_uri = str(tmp_path / "empty")
        with pytest.raises(FileNotFoundError):
            batch.IngestionJobLauncher(spec).run()


@pytest.mark.parametrize("layout", ["lines", "array"])
def test_null_json_record_fails_the_job_as_jax(tmp_path, layout):
    """A JSON `null` record in the middle of a file: the JSON reader yields
    None for it, and the job fails on it in both packages, with no segment
    built from the records before it."""
    recs = [{"city": "sf", "day": 1, "fare": 2.0, "tags": [1], "ts": 5},
            None,
            {"city": "ny", "day": 2, "fare": 3.0, "tags": [2], "ts": 6}]
    ind = tmp_path / "in"
    ind.mkdir()
    (ind / "a.json").write_text(
        "\n".join(json.dumps(r) for r in recs) + "\n" if layout == "lines"
        else json.dumps(recs))
    errors = {}
    for name, batch, (schema, cfg) in (
            ("port", pbatch, (_schemas()[0], _configs()[0])),
            ("jax", jbatch, (_schemas()[1], _configs()[1]))):
        out = tmp_path / name
        spec = _spec(batch, schema, cfg, ind, out, config={})
        with pytest.raises(Exception) as err:
            batch.IngestionJobLauncher(spec).run()
        errors[name] = (type(err.value), str(err.value))
        assert not out.exists() or not any(out.iterdir())
    assert errors["port"] == errors["jax"]
    assert errors["port"][0] is TypeError


# -- the job: both packages' segments ------------------------------------------


def _spec(batch, schema, cfg, ind, out, **kw):
    return batch.SegmentGenerationJobSpec(
        input_dir_uri=f"file://{ind}", output_dir_uri=f"file://{out}",
        schema=schema, table_config=cfg, record_reader_config=dict(kw.pop(
            "config")), **kw)


def _same_segment(a: str, b: str) -> None:
    a, b = Path(a), Path(b)
    assert (a / "data.bin").read_bytes() == (b / "data.bin").read_bytes()
    ma = json.loads((a / "metadata.json").read_text())
    mb = json.loads((b / "metadata.json").read_text())
    ma.pop("creationTimeMs")
    mb.pop("creationTimeMs")
    assert ma == mb


@pytest.fixture(scope="module")
def jobs(inputs):
    d, ind, config, _rows_ = inputs
    (p_schema, j_schema), (p_cfg, j_cfg) = _schemas(), _configs()
    port = pbatch.IngestionJobLauncher(_spec(
        pbatch, p_schema, p_cfg, ind, d / "port", config=config)).run()
    jax = jbatch.IngestionJobLauncher(_spec(
        jbatch, j_schema, j_cfg, ind, d / "jax", config=config)).run()
    return port, jax


def test_standalone_segments_equal_jax(jobs):
    port, jax = jobs
    assert len(port) == len(jax) == 10
    for p, j in zip(port, jax):
        assert (p.segment_name, p.num_docs, p.rows_filtered, p.partitions) \
            == (j.segment_name, j.num_docs, j.rows_filtered, j.partitions)
        assert p.partitions["day"]["numPartitions"] == 4
        _same_segment(p.output_uri[len("file://"):],
                      j.output_uri[len("file://"):])
        assert set(p.timings_ms) == {"read", "transform", "build", "upload"}


def test_job_segments_load_and_query_as_jax(jobs, inputs):
    from pinot_tpu.engine.query_executor import \
        QueryExecutor as JQueryExecutor
    from pinot_tpu.segment.loader import load_segment as jload
    from pinot_tpu_torch.engine.query_executor import QueryExecutor
    from pinot_tpu_torch.segment.loader import load_segment

    port, jax = jobs
    psegs = [load_segment(r.output_uri[len("file://"):]) for r in port]
    jsegs = [jload(r.output_uri[len("file://"):]) for r in jax]
    for p, j in zip(psegs, jsegs):
        assert p.num_docs == j.num_docs == 240
        for c in ("city", "day", "fare", "ts"):
            assert p.get_values(c).tolist() == j.get_values(c).tolist()
        assert [x.tolist() for x in p.get_mv_values("tags")] == \
            [x.tolist() for x in j.get_mv_values("tags")]
    (p_schema, j_schema) = _schemas()
    qp, qj = QueryExecutor(device="cpu"), JQueryExecutor(backend="host")
    qp.add_table(p_schema, psegs)
    qj.add_table(j_schema, jsegs)
    for sql in ("SELECT city, SUM(fare), COUNT(*) FROM trips GROUP BY city "
                "ORDER BY city LIMIT 10",
                "SELECT day, MAX(ts), MIN(fare) FROM trips WHERE day < 10 "
                "GROUP BY day ORDER BY day LIMIT 40",
                "SELECT COUNT(*) FROM trips"):
        got = [list(r) for r in qp.execute_sql(sql).result_table.rows]
        assert got == [list(r) for r in qj.execute_sql(sql).result_table.rows]
    assert got == [[2400]]


def test_multiprocess_runner_equals_standalone(jobs, inputs, tmp_path):
    """2 spawned workers, a bounded wait: the same bytes as the standalone
    runner (the spec pickles into the pool)."""
    d, ind, config, _rows_ = inputs
    port, _ = jobs
    spec = _spec(pbatch, _schemas()[0], _configs()[0], ind, tmp_path / "mp",
                 config=config, execution_framework="multiprocess",
                 parallelism=2)
    with cf.ThreadPoolExecutor(1) as ex:
        results = ex.submit(pbatch.IngestionJobLauncher(spec).run).result(
            timeout=240)
    assert [r.segment_name for r in results] == \
        [r.segment_name for r in port]
    for mp, st in zip(results, port):
        assert mp.num_docs == st.num_docs and mp.partitions == st.partitions
        _same_segment(mp.output_uri[len("file://"):],
                      st.output_uri[len("file://"):])


def test_a_worker_imports_only_the_port(inputs, tmp_path):
    """What a spawned worker runs (`_generate_one_job` over a file), in a
    fresh interpreter: nothing of jax or of the JAX package is imported."""
    _d, ind, config, _rows_ = inputs
    code = f"""
import sys
from pinot_tpu_torch.ingestion.batch import (SegmentGenerationJobSpec,
                                             _generate_one_job)
from pinot_tpu_torch.spi.data_types import Schema
from pinot_tpu_torch.spi.table_config import TableConfig
schema = Schema.build("trips", dimensions={DIMS!r}, metrics={METRICS!r})
spec = SegmentGenerationJobSpec(
    input_dir_uri="file://{ind}", output_dir_uri="file://{tmp_path}/w",
    schema=schema, table_config=TableConfig(table_name="trips"),
    record_reader_config={config!r}, create_tar=True)
for name in ("a.csv", "c.json", "e.avro", "g.thrift"):
    r = _generate_one_job(spec, "{ind}/" + name, 0)
    assert r.num_docs == 240, r
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "pinot_tpu"))
print("FORBIDDEN", bad)
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FORBIDDEN []" in out.stdout, out.stdout


# -- the push: the same tarballs on a port and a JAX cluster ------------------


def test_tar_push_serves_the_jax_rows(inputs, tmp_path):
    from pinot_tpu.cluster import Broker as JBroker
    from pinot_tpu.cluster import ClusterController as JController
    from pinot_tpu.cluster import PropertyStore as JStore
    from pinot_tpu.cluster import ServerInstance as JServer
    from pinot_tpu_torch.cluster import (Broker, ClusterController,
                                         PropertyStore, ServerInstance)

    _d, ind, config, _rows_ = inputs
    p_schema, j_schema = _schemas()
    p_cfg, _ = _configs(partitioned=False)
    spec = _spec(pbatch, p_schema, p_cfg, ind, tmp_path / "deep",
                 config=config, create_tar=True,
                 include_file_name_pattern="*.*s*")  # the CSV and JSON files
    results = pbatch.IngestionJobLauncher(spec).run()
    assert len(results) == 4
    assert all(r.output_uri.endswith(".tar.gz") for r in results)
    sqls = ("SELECT COUNT(*), SUM(fare), MAX(ts) FROM trips",
            "SELECT city, COUNT(*), SUM(day) FROM trips GROUP BY city "
            "ORDER BY city LIMIT 10")
    rows = {}
    for pkg, (store_cls, ctl_cls, srv, brk, schema, push) in {
            "port": (PropertyStore, ClusterController,
                     lambda st, i: ServerInstance(st, f"Server_{i}",
                                                  device="cpu"),
                     Broker, p_schema, pbatch.push_segments_to_cluster),
            "jax": (JStore, JController,
                    lambda st, i: JServer(st, f"Server_{i}", backend="host"),
                    JBroker, j_schema, jbatch.push_segments_to_cluster)
    }.items():
        store = store_cls()
        ctl = ctl_cls(store)
        servers = [srv(store, i) for i in range(2)]
        for s in servers:
            s.start()
        broker = brk(store)
        try:
            ctl.add_schema(schema.to_json())
            table = ctl.create_table({"tableName": "trips", "replication": 1})
            push(results, ctl, table)
            rows[pkg] = []
            for sql in sqls:
                resp = broker.execute_sql(sql)
                assert not resp.exceptions, (pkg, resp.exceptions)
                rows[pkg].append([list(r) for r in resp.result_table.rows])
        finally:
            for s in servers:
                s.stop()
            if hasattr(broker, "close"):
                broker.close()
    assert rows["port"] == rows["jax"]
    assert rows["port"][0][0][0] == 4 * 240
