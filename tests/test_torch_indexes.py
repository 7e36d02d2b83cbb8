"""The port's segment indexes against the JAX package's.

On the CPU, over seeded columns built by both packages' builders:

  * the JSON, text, vector, map and star-tree buffers (and every other
    buffer of the segment) are byte-equal, with equal metadata;
  * the index readers answer element-equal masks over JSON_MATCH
    expressions (EQ, NOT_EQ, IN, NOT_IN, IS [NOT] NULL, AND/OR/NOT, `[*]`
    paths), TEXT_MATCH queries (terms, phrases, prefixes, regexes, AND/OR)
    with equal BM25 scores, vector top-K, and `mapValue` EQ/NOT_EQ/IN/RANGE
    predicates over keys absent from some rows;
  * the port's loader reads the indexes of a segment the JAX builder wrote
    as the JAX loader does, and builds the same transient indexes of a
    column that has none;
  * the text tokenizer and the table config's JSON form agree.
"""

from __future__ import annotations

import json

import numpy as np
import pytest

from pinot_tpu.engine.host_executor import \
    eval_map_index_predicate as jax_eval_map
from pinot_tpu.query.parser.sql import parse_sql as jax_parse
from pinot_tpu.query.parser.sql import \
    parse_filter_expression as jax_parse_filter
from pinot_tpu.segment import indexes as jax_indexes
from pinot_tpu.segment.builder import SegmentBuilder as JaxBuilder
from pinot_tpu.segment.loader import load_segment as jax_load
from pinot_tpu.spi.data_types import Schema as JaxSchema
from pinot_tpu.spi.table_config import IndexingConfig as JaxIndexing
from pinot_tpu.spi.table_config import TableConfig as JaxTableConfig
from pinot_tpu_torch.engine.host_masks import eval_map_index_predicate
from pinot_tpu_torch.query.parser.sql import parse_filter_expression, parse_sql
from pinot_tpu_torch.segment import indexes
from pinot_tpu_torch.segment.builder import MultiValues, SegmentBuilder
from pinot_tpu_torch.segment.index_spi import (IndexType, get_index_type,
                                               register_index_type)
from pinot_tpu_torch.segment.loader import load_segment
from pinot_tpu_torch.spi.data_types import Schema
from pinot_tpu_torch.spi.table_config import IndexingConfig, TableConfig

TABLE = "ev"
ROWS = 1800
DIM = 12
DIMS = [("d_year", "INT"), ("s_region", "STRING"), ("attrs", "JSON"),
        ("msg", "STRING"), ("props", "STRING"), ("emb", "FLOAT", False)]
METRICS = [("lo_revenue", "INT"), ("lo_tax", "DOUBLE")]
WORDS = (["connection", "reset", "time", "timeout", "Timestamp", "error",
          "errors", "err42", "Straße", "naïve"] + [f"w{i}" for i in range(60)])
INDEXING = dict(
    no_dictionary_columns=["lo_revenue", "lo_tax"],
    star_tree_index_configs=[{
        "dimensionsSplitOrder": ["d_year", "s_region"],
        "functionColumnPairs": ["COUNT__*", "SUM__lo_revenue", "SUM__lo_tax",
                                "MIN__lo_revenue", "MAX__lo_tax"],
        "maxLeafRecords": 100}],
    json_index_columns=["attrs"], text_index_columns=["msg"],
    vector_index_columns=["emb"],
    custom_index_configs={"props": {"type": "map", "maxKeys": 8}})
JSON_EXPRS = [
    '"$.device.os" = \'ios\'',
    '"$.device.os" <> \'ios\'',
    '"$.country" IN (\'c1\', \'c3\', \'zz\')',
    '"$.country" NOT IN (\'c1\', \'c3\')',
    '"$.tags[*]" = \'t7\'',
    '"$.device.os" = \'ios\' AND "$.tags[*]" = \'t7\'',
    '"$.device.os" = \'linux\' OR NOT "$.device.ver" = 3',
    '"$.device.ver" = 3',
    '"$.device.ver" = 3.0',
    '"$.flag" = true',
    '"$.note" IS NULL',
    '"$.note" IS NOT NULL',
    '"$.tags" IS NOT NULL AND NOT "$.tags[*]" IN (\'t1\', \'t2\')',
    'country = \'c2\'',
]
TEXT_QUERIES = [
    "connection", '"connection reset"', "time*", '"connection reset" OR time*',
    "connection AND reset", "error OR timeout", "/err.*/", "/ERR[0-9]+/",
    "errors?", '(w1 OR w2) AND w3', "w4 w5", "Straße", "naïve", '"w1 w2 w3"',
    "nothing_here", "connection-reset",
]
MAP_PREDICATES = [
    "mapValue(props, 'clicks') = 7", "mapValue(props, 'clicks') <> 7",
    "mapValue(props, 'clicks') IN (1, 2, 40)",
    "mapValue(props, 'clicks') NOT IN (1, 2)",
    "mapValue(props, 'clicks') > 40", "mapValue(props, 'clicks') <= 3",
    "mapValue(props, 'clicks') BETWEEN 10 AND 20",
    "mapValue(props, 'dwell') < 12.5", "mapValue(props, 'flag') = 1",
    "mapValue(props, 'missing') = 1", "mapValue(props, 'clicks', 0) = 7",
    "mapValue(props, 'clicks') = 'x'",
]


def _columns(rng, rows):
    """Seeded columns with every index's hard cases: unparseable and null
    JSON, booleans and floats, None and empty and non-ASCII text, map rows
    without a key, non-numeric map values."""
    os_names = ["ios", "android", "linux"]
    attrs = []
    for i in range(rows):
        doc = {"country": f"c{rng.integers(0, 6)}",
               "device": {"os": os_names[rng.integers(0, 3)],
                          "ver": int(rng.integers(1, 5))},
               "tags": [f"t{t}" for t in rng.integers(0, 10,
                                                      rng.integers(0, 4))]}
        if i % 7 == 0:
            doc["flag"] = bool(rng.integers(0, 2))
        if i % 5 == 0:
            doc["note"] = None if i % 10 else "n"
        attrs.append(json.dumps(doc))
    attrs[3] = "not json"
    attrs[4] = "[1, {\"a\": 2.0}]"
    words = np.asarray(WORDS, dtype=object)
    msg = [" ".join(words[rng.integers(0, len(WORDS), rng.integers(0, 9))])
           for _ in range(rows)]
    msg[5] = "Connection RESET!!\x00time's up — naïve"
    msg[6] = ""
    props = []
    for i in range(rows):
        m = {"dwell": float(np.round(rng.random() * 30, 2))}
        if i % 11:
            m["clicks"] = int(rng.integers(0, 51))
        if i % 13 == 0:
            m["flag"] = bool(i % 2)
        if i % 17 == 0:
            m["clicks"] = "many"
        props.append(json.dumps(m))
    props[7] = "nope"
    emb = rng.normal(size=(rows, DIM)).astype(np.float32)
    emb[8] = 0.0
    return {
        "d_year": rng.integers(1992, 1999, rows).astype(np.int32),
        "s_region": np.asarray(["ASIA", "EUROPE", "AMERICA"], dtype=object)[
            rng.integers(0, 3, rows)],
        "attrs": attrs, "msg": msg, "props": props,
        "emb": [list(v) for v in emb],
        "lo_revenue": rng.integers(1, 600_000, rows).astype(np.int32),
        "lo_tax": np.round(rng.gamma(3.0, 9.0, rows), 2),
    }


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """(port dir, JAX dir, columns) of one segment built by each builder
    from the same columns, and a third built by the JAX builder with no
    index (the transient indexes)."""
    cols = _columns(np.random.default_rng(11), ROWS)
    root = tmp_path_factory.mktemp("torch_indexes")
    SegmentBuilder(Schema.build(TABLE, dimensions=DIMS, metrics=METRICS),
                   TableConfig(table_name=TABLE,
                               indexing=IndexingConfig(**INDEXING)),
                   "s0").build(cols, root / "port")
    JaxBuilder(JaxSchema.build(TABLE, dimensions=DIMS, metrics=METRICS),
               JaxTableConfig(table_name=TABLE,
                              indexing=JaxIndexing(**INDEXING)),
               "s0").build(cols, root / "jax")
    JaxBuilder(JaxSchema.build(TABLE, dimensions=DIMS, metrics=METRICS),
               JaxTableConfig(table_name=TABLE), "s1").build(
        cols, root / "plain")
    return root / "port", root / "jax", root / "plain", cols


def _metadata(path):
    meta = json.loads((path / "metadata.json").read_text())
    meta.pop("creationTimeMs", None)
    return meta


def test_builders_write_equal_bytes(built):
    port, jax, _, _ = built
    assert (port / "data.bin").read_bytes() == (jax / "data.bin").read_bytes()
    mp, mj = _metadata(port), _metadata(jax)
    assert list(mp["buffers"]) == list(mj["buffers"])
    assert mp == mj
    names = set(mp["buffers"])
    for want in ("attrs.json.keys.names", "msg.text.pos", "emb.vec.data",
                 "props.x_map.meta", "st0.s_region.ids", "st0.agg4"):
        assert want in names


@pytest.mark.parametrize("kind", ["json", "text", "vector", "map",
                                  "star_tree"])
def test_index_buffers_equal_the_jax_builder(built, kind):
    """Each index's buffers on their own, from the index classes too."""
    port, jax, _, cols = built
    if kind == "json":
        a = indexes.serialize_json_index(indexes.JsonIndex.build(cols["attrs"]))
        b = jax_indexes.serialize_json_index(
            jax_indexes.JsonIndex.build(cols["attrs"]))
    elif kind == "text":
        a = indexes.serialize_text_index(indexes.TextIndex.build(cols["msg"]))
        b = jax_indexes.serialize_text_index(
            jax_indexes.TextIndex.build(cols["msg"]))
    elif kind == "vector":
        v = np.asarray(cols["emb"], dtype=np.float32)
        a = indexes.serialize_vector_index(indexes.VectorIndex.build(v, 16))
        b = jax_indexes.serialize_vector_index(
            jax_indexes.VectorIndex.build(v, 16))
    else:
        prefix = "props.x_map." if kind == "map" else "st0."
        sp, sj = load_segment(port), jax_load(jax)
        a = [(n, sp.buffer_array(n)) for n in sp.metadata.buffers
             if n.startswith(prefix)]
        b = [(n, sj.buffer_array(n)) for n in sj.metadata.buffers
             if n.startswith(prefix)]
        assert a
    assert [n for n, _ in a] == [n for n, _ in b]
    for (n, x), (_, y) in zip(a, b):
        assert np.asarray(x).dtype == np.asarray(y).dtype, n
        assert np.asarray(x).tobytes() == np.asarray(y).tobytes(), n


def test_vector_builder_takes_multivalues(tmp_path):
    """The flat MultiValues form builds the bytes of per-document lists."""
    rng = np.random.default_rng(3)
    emb = rng.normal(size=(300, 8)).astype(np.float32)
    schema = Schema.build("v", dimensions=[("emb", "FLOAT", False)],
                          metrics=[("m", "INT")])
    cfg = TableConfig(table_name="v", indexing=IndexingConfig(
        vector_index_columns=["emb"], no_dictionary_columns=["m"]))
    m = np.arange(300, dtype=np.int32)
    SegmentBuilder(schema, cfg, "a").build(
        {"emb": [list(r) for r in emb], "m": m}, tmp_path / "a")
    SegmentBuilder(schema, cfg, "a").build(
        {"emb": MultiValues(emb.reshape(-1), np.full(300, 8)), "m": m},
        tmp_path / "b")
    assert (tmp_path / "a" / "data.bin").read_bytes() == \
        (tmp_path / "b" / "data.bin").read_bytes()
    with pytest.raises(ValueError):
        SegmentBuilder(schema, cfg, "c").build(
            {"emb": MultiValues(emb.reshape(-1)[:-1],
                                np.r_[np.full(299, 8), 7]), "m": m},
            tmp_path / "c")


@pytest.mark.parametrize("expr", JSON_EXPRS)
def test_json_match_masks_equal(built, expr):
    port, jax, _, _ = built
    got = load_segment(port).get_json_index("attrs").mask_match(expr, ROWS)
    want = jax_load(jax).get_json_index("attrs").mask_match(expr, ROWS)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert str(parse_filter_expression(expr)) == str(jax_parse_filter(expr))


@pytest.mark.parametrize("query", TEXT_QUERIES)
def test_text_match_masks_and_scores_equal(built, query):
    port, jax, _, _ = built
    ti, tj = (load_segment(port).get_text_index("msg"),
              jax_load(jax).get_text_index("msg"))
    assert np.array_equal(ti.mask_match(query, ROWS),
                          tj.mask_match(query, ROWS))
    assert np.array_equal(ti.bm25_scores(query, ROWS),
                          tj.bm25_scores(query, ROWS))


@pytest.mark.parametrize("strings", [
    ["", None, "  ", "\x00", "a\x00b", "İstanbul K", "ǅemal Σίσυφος",
     "x" * 300, "12 34 a1b2 Ünïcödé — end", "tab\tand\nnewline", "😀 ok"],
    [None, None],
    [],
    [b"bytes value", 17, 2.5, True],
], ids=["unicode", "nulls", "empty", "non_strings"])
def test_text_index_edge_cases_equal(strings):
    a = indexes.serialize_text_index(indexes.TextIndex.build(strings))
    b = jax_indexes.serialize_text_index(jax_indexes.TextIndex.build(strings))
    assert [(n, x.dtype, x.tobytes()) for n, x in a] == \
        [(n, x.dtype, x.tobytes()) for n, x in b]
    for s in strings:
        if s is not None:
            assert indexes.tokenize_text(s) == jax_indexes.tokenize_text(s)


@pytest.mark.parametrize("k", [1, 10, 200, ROWS + 5])
def test_vector_top_k_equal(built, k):
    port, jax, _, _ = built
    q = np.random.default_rng(k).normal(size=DIM).astype(np.float32)
    vi, vj = (load_segment(port).get_vector_index("emb"),
              jax_load(jax).get_vector_index("emb"))
    (d1, s1), (d2, s2) = vi.top_k(q, k), vj.top_k(q, k)
    assert np.array_equal(d1, d2) and np.array_equal(s1, s2)
    assert np.array_equal(vi.mask_top_k(q, k, ROWS), vj.mask_top_k(q, k, ROWS))


@pytest.mark.parametrize("pred", MAP_PREDICATES)
def test_map_index_predicates_equal(built, pred):
    """mapValue predicates over the map index's dense planes: the port's
    mask is the JAX package's, None where that package's is None (no
    index, key or numeric literal: the row-wise transform answers)."""
    port, jax, _, _ = built
    sql = f"SELECT COUNT(*) FROM ev WHERE {pred}"
    got = eval_map_index_predicate(parse_sql(sql).filter.predicate,
                                   load_segment(port))
    want = jax_eval_map(jax_parse(sql).filter.predicate, jax_load(jax))
    assert (got is None) == (want is None)
    if got is not None:
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_loader_reads_jax_built_indexes(built):
    """The data carried across: the JAX builder's segment through the
    port's loader, index by index."""
    _, jax, _, _ = built
    sp, sj = load_segment(jax), jax_load(jax)
    a, b = sp.get_json_index("attrs"), sj.get_json_index("attrs")
    for t1, t2 in ((a.keys, b.keys), (a.paths, b.paths)):
        assert list(t1) == list(t2)
        assert all(np.array_equal(t1[k], t2[k]) for k in t1)
    a, b = sp.get_text_index("msg"), sj.get_text_index("msg")
    assert a.terms == b.terms
    for x, y in zip(a.pos_postings, b.pos_postings):
        assert np.array_equal(x[0], y[0]) and np.array_equal(x[1], y[1])
    assert all(np.array_equal(x, y)
               for x, y in zip(a.doc_postings, b.doc_postings))
    a, b = sp.get_vector_index("emb"), sj.get_vector_index("emb")
    assert np.array_equal(a.vectors, b.vectors)
    assert np.array_equal(a.centroids, b.centroids)
    assert np.array_equal(a.assignments, b.assignments)
    a, b = sp.get_map_index("props"), sj.get_map_index("props")
    assert a.dense_keys == b.dense_keys
    for k in a.dense_keys:
        assert np.array_equal(a.values[k], b.values[k])
        assert np.array_equal(a.present[k], b.present[k])
    assert sp.get_custom_index("attrs", "map") is None
    assert sp.get_json_index("msg") is None
    assert [v.tree_meta for v in sp.star_trees()] == \
        [v.tree_meta for v in sj.star_trees()]
    for vp, vj in zip(sp.star_trees(), sj.star_trees()):
        assert vp.name == vj.name and vp.num_docs == vj.num_docs
        for c in vp.columns():
            assert np.array_equal(vp.get_values(c), vj.get_values(c))


def test_transient_indexes_equal(built):
    """A column without a persisted index: or_build builds (and caches)
    the JAX loader's transient index."""
    _, _, plain, _ = built
    sp, sj = load_segment(plain), jax_load(plain)
    assert sp.get_json_index("attrs") is None
    a, b = (sp.get_json_index("attrs", or_build=True),
            sj.get_json_index("attrs", or_build=True))
    assert a is sp.get_json_index("attrs")
    expr = '"$.tags[*]" = \'t3\' OR "$.device.ver" = 2'
    assert np.array_equal(a.mask_match(expr, ROWS), b.mask_match(expr, ROWS))
    a, b = (sp.get_text_index("msg", or_build=True),
            sj.get_text_index("msg", or_build=True))
    assert a.terms == b.terms
    q = '"connection reset" OR /w1[0-9]/'
    assert np.array_equal(a.mask_match(q, ROWS), b.mask_match(q, ROWS))
    a, b = (sp.get_vector_index("emb", or_build=True),
            sj.get_vector_index("emb", or_build=True))
    assert np.array_equal(a.vectors, b.vectors)
    assert sp.get_map_index("props") is None and sp.star_trees() == []


def test_table_config_json_crosses_packages():
    """A config written by either package reads back in the other."""
    cfg = TableConfig(table_name=TABLE, indexing=IndexingConfig(**INDEXING))
    jax_cfg = JaxTableConfig.from_json(cfg.to_json())
    for f in ("no_dictionary_columns", "star_tree_index_configs",
              "json_index_columns", "text_index_columns",
              "vector_index_columns"):
        assert getattr(jax_cfg.indexing, f) == INDEXING[f]
    back = TableConfig.from_json(JaxTableConfig(
        table_name=TABLE, indexing=JaxIndexing(**INDEXING)).to_json())
    for f in ("no_dictionary_columns", "star_tree_index_configs",
              "json_index_columns", "text_index_columns",
              "vector_index_columns"):
        assert getattr(back.indexing, f) == INDEXING[f]
    # neither package writes custom index configs into the JSON form
    assert back.indexing.custom_index_configs == {}


def test_index_type_registry():
    assert get_index_type("map").name == "map"
    with pytest.raises(ValueError):
        get_index_type("no_such_index")
    with pytest.raises(ValueError):
        register_index_type(IndexType("not an identifier", None, None, None))
