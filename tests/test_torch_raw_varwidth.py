"""Raw var-width and CLP columns in the port (fault F11), against the JAX
package.

A STRING, BYTES or JSON column listed in `noDictionaryColumns` is stored as
a value stream with u64 offsets; `compressionConfigs: {col: "CLP"}` on a
raw STRING column stores CLP's templates and variables (segment/clp.py).
Both packages read the values on the host only: their planners refuse
them in a filter, key or value, so a query selects them beside a filter
that runs on the device.

Segments are built once by each package's builder from the same columns
and loaded by both packages. The port's `QueryExecutor(device="cpu")` and
the JAX package's `QueryExecutor(backend="tpu")`
(`PINOT_TPU_FUSED=interpret`, both caches off, one mesh device) agree on
rows, dispatches and segment counts; the port's builder writes the JAX
builder's bytes; values decode to the same Python objects (str, or bytes
for BYTES). A realtime table with `no_dictionary_columns=["site",
"clicks"]`, flush threshold 40 and 50 rows commits one segment in each
package's `RealtimeTableDataManager` (tests/test_torch_realtime_manager.py's
pair), with equal values and answers. Tolerance: exact.
"""

from __future__ import annotations

import json

import numpy as np
import pytest

from pinot_tpu.engine.query_executor import QueryExecutor as JaxQueryExecutor
from pinot_tpu.realtime.converter import \
    RealtimeSegmentConverter as JaxConverter
from pinot_tpu.segment.builder import SegmentBuilder as JaxBuilder
from pinot_tpu.segment.loader import load_segment as jax_load
from pinot_tpu.segment.mutable import MutableSegment as JaxMutable
from pinot_tpu.spi import stream as jax_stream
from pinot_tpu.spi import table_config as jax_tc
from pinot_tpu.spi.data_types import Schema as JaxSchema
from pinot_tpu.spi.table_config import IndexingConfig as JaxIndexing
from pinot_tpu.spi.table_config import TableConfig as JaxTableConfig
from pinot_tpu_torch.engine.aggregation import UnsupportedQueryError
from pinot_tpu_torch.engine.query_executor import QueryExecutor
from pinot_tpu_torch.query.parser.sql import parse_sql
from pinot_tpu_torch.realtime.converter import RealtimeSegmentConverter
from pinot_tpu_torch.segment import clp
from pinot_tpu_torch.segment.builder import SegmentBuilder
from pinot_tpu_torch.segment.loader import load_segment
from pinot_tpu_torch.segment.mutable import MutableSegment
from pinot_tpu_torch.spi import stream
from pinot_tpu_torch.spi import table_config as tc
from pinot_tpu_torch.spi.data_types import Schema
from pinot_tpu_torch.spi.table_config import IndexingConfig, TableConfig
from test_torch_realtime_manager import (GROUP_SQL, SUM_SQL, Pair, Topics,
                                         rows, schemas)

DIMS = [("d_year", "INT"), ("note", "STRING"), ("log", "STRING"),
        ("blob", "BYTES"), ("attrs", "JSON")]
METRICS = [("rev", "INT")]
RAW = ["note", "log", "blob", "attrs", "rev"]
ROWS = 1200
LOG_TEMPLATES = [
    "Task task_{a} failed after {b}.{c}s",
    "GET /api/v{a}/users/{b} 200 in {c} ms",
    "connection reset by peer {a} retry={b}",
    "user=u{a} logged in from 10.0.{b}.{c}",
]
QUERIES = [
    "SELECT note, rev FROM t WHERE d_year = 1995 LIMIT 3",
    "SELECT log, note, rev FROM t WHERE d_year = 1995 AND rev > 500 "
    "LIMIT 7",
    "SELECT d_year, log FROM t WHERE rev BETWEEN 100 AND 120 "
    "ORDER BY rev DESC, d_year LIMIT 6",
    "SELECT attrs, blob, note FROM t WHERE d_year IN (1992, 1998) LIMIT 4",
    "SELECT * FROM t WHERE rev < 20 ORDER BY rev, d_year LIMIT 5",
    "SELECT d_year, SUM(rev), COUNT(*) FROM t GROUP BY d_year",
]


@pytest.fixture(autouse=True)
def _jax_dispatches_every_query(monkeypatch):
    monkeypatch.setenv("PINOT_TPU_SEGMENT_CACHE", "0")
    monkeypatch.setenv("PINOT_TPU_RESULT_CACHE", "0")
    monkeypatch.setenv("PINOT_TPU_MESH_DEVICES", "1")
    monkeypatch.setenv("PINOT_TPU_FUSED", "interpret")


def _cols(rng, n):
    notes = [f"n{i}" for i in rng.integers(0, 300, n)]
    notes[3] = "naïve café ☕"  # non-ASCII: the stream decodes per value
    notes[5] = ""
    notes[8] = None  # the default null value
    logs = [LOG_TEMPLATES[t].format(a=a, b=b, c=c) for t, a, b, c in zip(
        rng.integers(0, 4, n), rng.integers(0, 50, n), rng.integers(0, 999, n),
        rng.integers(0, 99, n))]
    logs[2] = "literal \x11 and \x12 bytes 7"  # placeholder bytes escaped
    return {
        "d_year": rng.integers(1992, 1999, n).astype(np.int32),
        "note": np.asarray(notes, dtype=object),
        "log": np.asarray(logs, dtype=object),
        "blob": np.asarray([bytes([i % 256, (i * 7) % 256]) * (i % 4)
                            for i in range(n)], dtype=object),
        "attrs": np.asarray([json.dumps({"k": int(i % 9), "tags": ["a", "b"]})
                             for i in range(n)], dtype=object),
        "rev": rng.integers(1, 1000, n).astype(np.int32),
    }


def _indexing(mod, codec=None):
    comp = {"log": "CLP"}
    if codec:
        comp.update(note=codec, blob=codec, attrs=codec)
    return mod(no_dictionary_columns=RAW, compression_configs=comp)


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_raw_varwidth")
    rng = np.random.default_rng(11)
    cols = [_cols(rng, ROWS) for _ in range(2)]
    jschema = JaxSchema.build("t", dimensions=DIMS, metrics=METRICS)
    schema = Schema.build("t", dimensions=DIMS, metrics=METRICS)
    out = {}
    for codec in (None, "LZ4"):
        jcfg = JaxTableConfig("t", indexing=_indexing(JaxIndexing, codec))
        cfg = TableConfig("t", indexing=_indexing(IndexingConfig, codec))
        for k in range(2):
            d = root / f"{codec}_jax_{k}"
            JaxBuilder(jschema, jcfg, f"s{k}").build(cols[k], d)
            out.setdefault((codec, "jax"), []).append(d)
            d = root / f"{codec}_port_{k}"
            SegmentBuilder(schema, cfg, f"s{k}").build(cols[k], d)
            out.setdefault((codec, "port"), []).append(d)
    return out, cols


def _engines(dirs):
    port = QueryExecutor(device="cpu")
    port.add_table(Schema.build("t", dimensions=DIMS, metrics=METRICS),
                   [load_segment(d) for d in dirs])
    jax = JaxQueryExecutor(backend="tpu")
    jax.add_table(JaxSchema.build("t", dimensions=DIMS, metrics=METRICS),
                  [jax_load(d) for d in dirs])
    return port, jax


@pytest.mark.parametrize("sql", QUERIES)
@pytest.mark.parametrize("who", ["jax", "port"])
@pytest.mark.parametrize("codec", [None, "LZ4"])
def test_selections_match_jax(built, codec, who, sql):
    dirs, _ = built
    port, jax = _engines(dirs[codec, who])
    got, want = port.execute_sql(sql), jax.execute_sql(sql)
    assert not want.exceptions, want.exceptions
    assert got.result_table.rows == want.result_table.rows
    assert got.result_table.schema.to_json() == \
        want.result_table.schema.to_json()
    assert got.num_device_dispatches == want.num_device_dispatches
    assert got.num_segments_processed == want.num_segments_processed
    assert got.num_docs_scanned == want.num_docs_scanned


def test_note_selection_one_dispatch_reads_only_its_rows(built):
    dirs, cols = built
    port, _ = _engines(dirs[None, "jax"])
    got = port.execute_sql(QUERIES[0])
    assert got.num_device_dispatches == 1
    first = np.nonzero(cols[0]["d_year"] == 1995)[0][:3]
    note = ["null" if v is None else v for v in cols[0]["note"]]
    assert got.result_table.rows == [
        [note[i], int(cols[0]["rev"][i])] for i in first]
    # a LIMIT selection decodes its rows, not the var-width column
    assert all("note" not in seg._raw for seg in port.tables["t"].segments)


@pytest.mark.parametrize("who", ["jax", "port"])
def test_values_are_the_jax_objects(built, who):
    dirs, cols = built
    seg, jseg = load_segment(dirs[None, who][0]), jax_load(dirs[None, who][0])
    for c in ("note", "log", "blob", "attrs"):
        got, want = seg.get_values(c), jseg.get_values(c)
        assert got.dtype == want.dtype == object
        assert got.tolist() == want.tolist()
        assert [type(v) for v in got] == [type(v) for v in want]
        ids = np.asarray([7, 3, 0, ROWS - 1, 3])
        assert seg.get_values_at(c, ids).tolist() == want[ids].tolist()
        assert seg.read_cell(c, 3) == want[3]
    assert seg.get_values("note")[8] == "null"
    assert seg.get_values("note")[3] == "naïve café ☕"
    assert seg.get_values("log").tolist() == \
        [str(v) for v in cols[0]["log"]]
    assert seg.column_metadata("log").encoding == "CLP"
    for c in ("note", "blob", "attrs"):
        m, jm = seg.column_metadata(c), jseg.column_metadata(c)
        assert (m.encoding, m.min_value, m.max_value, m.is_sorted) == \
            (jm.encoding, jm.min_value, jm.max_value, jm.is_sorted)


@pytest.mark.parametrize("codec", [None, "LZ4"])
def test_port_builder_writes_jax_bytes(built, codec):
    dirs, _ = built
    for k in range(2):
        pseg = load_segment(dirs[codec, "port"][k])
        jseg = jax_load(dirs[codec, "jax"][k])
        for name, entry in jseg.metadata.buffers.items():
            got, want = pseg._buffer(name), jseg._buffer(name)
            assert bytes(got) == bytes(want), name
            assert pseg.metadata.buffers[name][2:] == entry[2:]
        if codec is None:
            assert (dirs[codec, "port"][k] / "data.bin").read_bytes() == \
                (dirs[codec, "jax"][k] / "data.bin").read_bytes()


@pytest.mark.parametrize("sql", [
    "SELECT COUNT(*) FROM t WHERE note = 'n3'",
    "SELECT note, COUNT(*) FROM t GROUP BY note",
    "SELECT COUNT(*) FROM t WHERE log = 'x'",
])
def test_var_width_filters_and_keys_are_refused(built, sql):
    """Both single-stage planners refuse a filter or key over a raw
    var-width column; under backend="tpu" the JAX package answers it on
    its multi-stage engine, with no device dispatch, and so does the
    port's execute_sql: the same rows, docs scanned and dispatches."""
    dirs, _ = built
    port, jax = _engines(dirs[None, "jax"])
    want = jax.execute_sql(sql)
    assert not want.exceptions and want.num_device_dispatches == 0
    with pytest.raises(UnsupportedQueryError):
        port.execute(parse_sql(sql))
    got = port.execute_sql(sql)
    assert sorted(map(repr, got.result_table.rows)) == \
        sorted(map(repr, want.result_table.rows))
    assert got.num_docs_scanned == want.num_docs_scanned
    assert got.num_device_dispatches == want.num_device_dispatches


@pytest.mark.parametrize("column,spec", [("d_year", "INT"),
                                         ("note", "STRING")])
def test_clp_needs_a_raw_string_column(tmp_path, column, spec):
    schema = Schema.build("t", dimensions=[(column, spec)])
    cfg = TableConfig("t", indexing=IndexingConfig(
        compression_configs={column: "CLP"}))
    jcfg = JaxTableConfig("t", indexing=JaxIndexing(
        compression_configs={column: "CLP"}))
    vals = {column: np.asarray([1, 2], dtype=np.int32) if spec == "INT"
            else np.asarray(["a1", "b2"], dtype=object)}
    with pytest.raises(ValueError, match="CLP encoding requires"):
        SegmentBuilder(schema, cfg, "s").build(vals, tmp_path / "p")
    with pytest.raises(ValueError, match="CLP encoding requires"):
        JaxBuilder(JaxSchema.build("t", dimensions=[(column, spec)]), jcfg,
                   "s").build(vals, tmp_path / "j")


def test_clp_column_encoding_equals_jax():
    from pinot_tpu.segment import clp as jax_clp

    rng = np.random.default_rng(2)
    vals = list(_cols(rng, 400)["log"]) + [None, "", "no vars here"]
    got, want = clp.encode_column(vals), jax_clp.encode_column(vals)
    assert clp.serialize_clp(got) == jax_clp.serialize_clp(want)
    back = clp.deserialize_clp(clp.serialize_clp(got))
    assert back.decode_all().tolist() == want.decode_all().tolist()
    assert back.decode_docs([402, 0, 2]).tolist() == \
        [want.decode_all()[i] for i in (402, 0, 2)]


# -- a realtime commit with raw var-width columns -----------------------------


def test_converter_builds_raw_var_width_columns(tmp_path):
    """The commit build of a consuming segment whose table lists a STRING
    column in noDictionaryColumns (it raised in the port's builder)."""
    schema, jschema = schemas()
    seg = MutableSegment(schema, "c__0__0")
    jseg = JaxMutable(jschema, "c__0__0")
    data = rows(40, seed=1)
    for r in data:
        seg.index(dict(r))
        jseg.index(dict(r))
    RealtimeSegmentConverter(schema, TableConfig(
        "clicks", indexing=IndexingConfig(
            no_dictionary_columns=["site", "clicks"]))).convert(
        seg, tmp_path / "port")
    JaxConverter(jschema, JaxTableConfig(
        "clicks", indexing=JaxIndexing(
            no_dictionary_columns=["site", "clicks"]))).convert(
        jseg, tmp_path / "jax")
    assert (tmp_path / "port" / "data.bin").read_bytes() == \
        (tmp_path / "jax" / "data.bin").read_bytes()
    got = load_segment(tmp_path / "port")
    assert got.column_metadata("site").encoding == "RAW"
    assert got.get_values("site").tolist() == [r["site"] for r in data]


@pytest.fixture()
def topics(monkeypatch):
    t = Topics(stream.InMemoryStreamRegistry(),
               jax_stream.InMemoryStreamRegistry())
    monkeypatch.setattr(stream, "GLOBAL_STREAM_REGISTRY", t.port)
    monkeypatch.setattr(jax_stream, "GLOBAL_STREAM_REGISTRY", t.jax)
    return t


@pytest.fixture()
def started():
    out: list = []
    yield out
    for m in reversed(out):
        m.stop()


def test_manager_commits_raw_var_width_columns(topics, tmp_path, started):
    """50 rows at a flush threshold of 40 commit one segment in each
    package (the port committed none: its build raised), and the answers
    over the committed and the consuming segment agree."""
    topics.create("vw")
    topics.publish("vw", rows(50, seed=12))
    cfgs = [m.TableConfig(
        table_name="clicks", table_type=m.TableType.REALTIME,
        indexing=m.IndexingConfig(no_dictionary_columns=["site", "clicks"]),
        validation=m.SegmentsValidationConfig(time_column_name="ts"),
        ingestion=m.IngestionConfig(stream_configs={
            "streamType": "inmemory", "stream.inmemory.topic.name": "vw",
            "realtime.segment.flush.threshold.rows": 40}))
        for m in (tc, jax_tc)]
    p = Pair(started, tmp_path, schemas(), cfgs)
    p.settle(50, 1)
    p.same_commits()
    seg = p.port._committed[0]
    assert seg.column_metadata("site").encoding == "RAW"
    assert seg.column_metadata("clicks").encoding == "RAW"
    p.query(SUM_SQL)
    p.query("SELECT site, clicks, user FROM clicks WHERE user = 'u1' "
            "ORDER BY ts LIMIT 8")
    p.query(GROUP_SQL)
