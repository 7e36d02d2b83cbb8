"""The port's transform registry against the JAX package's.

(a) Every name the JAX package registers (pinot_tpu/query/transforms.py
`TRANSFORMS`, 122 names) is registered by the port with the same flags,
and its numpy form gives what the reference's gives on seeded inputs:
millis from 1900 to 2100 (negatives, leap days, the turns of 1900, 2000
and 2100), unicode and empty strings, JSON blobs, number edges, array
rows. Equality is exact: the same dtype, the same values (NaN equal to
NaN), or the same exception type.

(b) Every transform with a device lowering (47 names), over a raw and a
dictionary-encoded column: the port's SegmentPlanner makes the same
`program`, slots and `params` as the JAX planner on the same segment, in
a GROUP BY with MIN/MAX/SUM of the transform and in a filter on it; the
port's CPU rows then equal the JAX `QueryExecutor(backend="tpu")` rows
(its Pallas kernels interpreted, its segment cache off), integers exactly,
float sums (added in another order) to a relative 1e-12.

Besides: the registry's fallbacks (eval_expr_np, np_evaluable,
eval_scalar), post-aggregation functions and selection transforms.
"""

from __future__ import annotations

import base64
import datetime as dt
import math

import numpy as np
import pytest

from pinot_tpu.engine import dim_tables as jax_dim_tables
from pinot_tpu.engine.plan import SegmentPlanner as JaxPlanner
from pinot_tpu.engine.query_executor import QueryExecutor as JaxQueryExecutor
from pinot_tpu.query import transforms as jax_transforms
from pinot_tpu.query.parser.sql import parse_sql as jax_parse
from pinot_tpu.segment.loader import load_segment as jax_load
from pinot_tpu.spi.data_types import Schema as JaxSchema
from pinot_tpu_torch.engine import dim_tables
from pinot_tpu_torch.engine.aggregation import UnsupportedQueryError
from pinot_tpu_torch.engine.plan import SegmentPlanner
from pinot_tpu_torch.engine.query_executor import QueryExecutor
from pinot_tpu_torch.query import transforms
from pinot_tpu_torch.query.parser.sql import parse_sql
from pinot_tpu_torch.segment.builder import SegmentBuilder
from pinot_tpu_torch.segment.loader import load_segment
from pinot_tpu_torch.spi.data_types import Schema
from pinot_tpu_torch.spi.table_config import IndexingConfig, TableConfig


def _ms(*parts) -> int:
    return int((dt.datetime(*parts) - dt.datetime(1970, 1, 1))
               .total_seconds() * 1000)


# leap days, century turns (1900 and 2100 are not leap years, 2000 is),
# the epoch and the millisecond before it
EDGE_MS = [_ms(1900, 1, 1), _ms(1900, 2, 28), _ms(1900, 3, 1),
           _ms(1904, 2, 29, 13), _ms(1969, 12, 31, 23, 59, 59, 999000), 0,
           -1, 1, _ms(1999, 12, 31, 23, 59, 59, 999000), _ms(2000, 1, 1),
           _ms(2000, 2, 29, 12), _ms(2000, 3, 1), _ms(2000, 1, 31),
           _ms(2096, 2, 29), _ms(2099, 12, 31, 23, 59, 59, 999000),
           _ms(2100, 1, 1), _ms(2100, 2, 28, 6), _ms(2100, 3, 1),
           _ms(2100, 12, 31, 23, 59, 59, 999000)]
MS_LO, MS_HI = _ms(1900, 1, 1), _ms(2101, 1, 1)

STRINGS = ["", "a", "ASIA", "  padded  ", "Ünïcødé ☃", "MIDDLE EAST",
           "x,y,z", "AbC dEf gH", "日本語テキスト", "a%b_c", "aaa",
           "http://x.y/?q=1 2&r=ü", "A", "tab\tand\nnewline"]
JSON_BLOBS = ['{"a": {"b": 3}, "c": [1, 2, {"d": "x"}], "k": 2.5}',
              '{"a": {"b": "7"}, "k": "9", "m": "v"}', "{}", "not json",
              "[1, 2]", '{"a": null, "k": null}', '{"m": {"n": 1}}',
              '{"a": {"b": -12}, "c": []}']


def _obj(values) -> np.ndarray:
    values = list(values)
    out = np.empty(len(values), dtype=object)
    out[:] = values
    return out


def _millis(r, n=48):
    return np.concatenate([np.asarray(EDGE_MS, np.int64),
                           r.integers(MS_LO, MS_HI, n)]).astype(np.int64)


def _days(r, n=32):
    return np.concatenate([[-25567, -1, 0, 1, 10957, 47482],
                           r.integers(-25567, 47482, n)]).astype(np.int64)


def _strings(r, n=10):
    rnd = ["".join(chr(c) for c in r.integers(32, 127, r.integers(0, 9)))
           for _ in range(n)]
    return _obj(STRINGS + rnd)


def _floats(r, n=24):
    edges = [0.0, -0.0, 0.5, -0.5, 1.5, 2.5, -2.5, 0.045, 1e-300, -1e300,
             123456.789, -98.765, np.inf, -np.inf, np.nan]
    return np.concatenate([edges, r.normal(0, 100, n)])


def _unit(r, n=16):
    return np.concatenate([[-1.0, 0.0, 1.0, 1.5, -2.0], r.uniform(-1, 1, n)])


def _arrays(r, n=12):
    rows = [[], [3], [1, 1, 2], [-5, 7, 7, 0]]
    rows += [list(r.integers(-50, 50, r.integers(1, 6))) for _ in range(n)]
    return _obj(rows)


def _date_strings(r, pattern):
    return _obj(transforms._ms_to_str(int(m), pattern) for m in _millis(r, 12))


# -- (a) per-name input families -----------------------------------------------

_UNARY_MS = ["year", "month", "monthofyear", "quarter", "day", "dayofmonth",
             "dayofweek", "dow", "dayofyear", "doy", "hour", "minute",
             "second", "millisecond", "week", "weekofyear", "yearofweek",
             "yow", "toepochseconds", "toepochminutes", "toepochhours",
             "toepochdays"]
_UNARY_DAYS = ["fromepochseconds", "fromepochminutes", "fromepochhours",
               "fromepochdays"]
_ROUNDED = [f"toepoch{u}{k}" for u in ("seconds", "minutes", "hours", "days")
            for k in ("rounded", "bucket")]
_FROM_BUCKET = [f"fromepoch{u}bucket"
                for u in ("seconds", "minutes", "hours", "days")]
_UNARY_FLOAT = ["cbrt", "sin", "cos", "tan", "atan", "sinh", "cosh", "tanh",
                "degrees", "radians"]
_UNARY_STR = ["upper", "lower", "reverse", "trim", "ltrim", "rtrim", "length",
              "codepoint", "ascii", "toutf8", "urlencode", "urldecode",
              "tobase64", "md5", "sha", "sha256", "sha512", "crc32"]
_ARRAY = ["arraylength", "cardinality", "arraymin", "arraymax", "arraysum",
          "arrayaverage", "arraydistinctcount", "vectordims"]
_CAL_UNITS = ["MILLISECOND", "SECOND", "MINUTE", "HOUR", "DAY", "WEEK",
              "MONTH", "QUARTER", "YEAR"]


def _cases(name: str, r) -> list:
    """Argument tuples for one registered name, drawn from `r`."""
    ms = _millis(r)
    if name in _UNARY_MS:
        return [(ms,), (ms[4],), (int(ms[-1]),)]
    if name in _UNARY_DAYS:
        return [(_days(r),), (7,)]
    if name in _ROUNDED:
        return [(ms, 15), (ms, 1)]
    if name in _FROM_BUCKET:
        return [(_days(r), 7)]
    if name in _UNARY_FLOAT:
        return [(_floats(r),), (2.0,)]
    if name in ("asin", "acos"):
        return [(_unit(r),)]
    if name == "atan2":
        return [(_floats(r), _floats(r)[::-1].copy())]
    if name == "log":
        return [(np.abs(_floats(r)),)]
    if name == "round":
        return [(_floats(r),), (ms, 1000), (ms, 7)]
    if name in ("rounddecimal", "truncate"):
        return [(_floats(r),), (_floats(r), 2), (_floats(r), -1), (2.345, 1)]
    if name == "datetrunc":
        return ([(u, ms) for u in _CAL_UNITS]
                + [("day", ms // 1000, "SECONDS"),
                   ("MONTH", _days(r), "DAYS"), ("FORTNIGHT", ms)])
    if name == "timeconvert":
        return [(ms, "MILLISECONDS", "HOURS"), (_days(r), "DAYS", "SECONDS"),
                (ms, "MILLISECONDS", "FORTNIGHTS")]
    if name == "datetimeconvert":
        return [(ms, "1:MILLISECONDS:EPOCH", "1:HOURS:EPOCH", "15:MINUTES"),
                (ms, "1:MILLISECONDS:EPOCH",
                 "1:DAYS:SIMPLE_DATE_FORMAT:yyyy-MM-dd", "1:DAYS"),
                (_date_strings(r, "yyyy-MM-dd HH:mm"),
                 "1:MINUTES:SIMPLE_DATE_FORMAT:yyyy-MM-dd HH:mm",
                 "1:SECONDS:EPOCH", "1:HOURS")]
    if name in ("gapfill", "fill"):
        return [(ms, "FILL_PREVIOUS_VALUE"), (ms,)]
    if name in ("timestampadd", "dateadd"):
        return ([(u, r.integers(-30, 30, len(ms)), ms) for u in
                 ("SECOND", "DAY", "WEEK", "MONTH", "QUARTER", "YEAR")]
                + [("MONTH", 1, _obj([_ms(2000, 1, 31), _ms(1900, 1, 29),
                                      _ms(2100, 12, 31)]).astype(np.int64)),
                   ("YEARS", -4, ms), ("FORTNIGHT", 1, ms)])
    if name in ("timestampdiff", "datediff"):
        other = ms[::-1].copy()
        return [(u, ms, other) for u in
                ("MILLISECOND", "MINUTE", "DAY", "WEEK", "MONTH", "QUARTER",
                 "YEARS")] + [("FORTNIGHT", ms, other)]
    if name == "todatetime":
        return [(ms, p) for p in ("yyyy-MM-dd HH:mm:ss.SSS", "yyyy-MM",
                                  "yy/M/d H:m:s", "EEE hh:mm a")]
    if name == "fromdatetime":
        p = "yyyy-MM-dd HH:mm:ss"
        return [(_date_strings(r, p), p), (_obj(["2000-02-30 00:00:00"]), p)]
    s = _strings(r)
    if name in _UNARY_STR:
        return [(s,), ("scalar",)]
    if name == "frombase64":
        return [(_obj(base64.b64encode(x.encode()).decode() for x in s),),
                (_obj(["%%%"]),)]
    if name in ("substr", "substring"):
        return [(s, 0, 2), (s, 1), (s, 2, -1), (s, 3, 1)]
    if name == "concat":
        return [(s, s[::-1].copy(), "-"), (s, "x"), (s, 12)]
    if name == "strpos":
        return [(s, "a"), (s, "a", 2), (s, "")]
    if name in ("startswith", "endswith", "contains"):
        return [(s, "A"), (s, "")]
    if name == "replace":
        return [(s, "a", "xy"), (s, "", "-")]
    if name == "remove":
        return [(s, "a")]
    if name in ("lpad", "rpad"):
        return [(s, 8, "*"), (s, 0, "#")]
    if name == "chr":
        return [(r.integers(32, 0x2FFF, 20),)]
    if name == "repeat":
        return [(s, 3, ","), (s, 2), (s, 0)]
    if name == "splitpart":
        return [(s, " ", 0), (s, " ", 1), (s, ",", 5)]
    if name == "regexpextract":
        return [(s, "([A-Z]+)", 1, "none"), (s, "[a-z]+"), (s, "(x)(y)?", 2)]
    if name == "regexpreplace":
        return [(s, "[aeiou]", "_")]
    if name == "isjson":
        return [(_obj(JSON_BLOBS + STRINGS),)]
    if name in ("jsonformat", "json_format"):
        return [(_obj(b for b in JSON_BLOBS if transforms._try_json(b)),),
                (_obj([{"k": [1, 2]}, 3, None]),), (_obj(["not json"]),)]
    if name == "strcmp":
        return [(s, s[::-1].copy()), (s, "ASIA")]
    if name == "jsonextractscalar":
        blobs = _obj(JSON_BLOBS)
        return [(blobs, "$.a.b", "INT"), (blobs, "$.c[2].d", "STRING"),
                (blobs, "$.k", "DOUBLE", 0.0), (blobs, "$.a.b", "LONG"),
                (blobs, "$.k", "FLOAT"), (blobs, "$.m", "STRING", "dflt")]
    if name == "jsonextractkey":
        return [(_obj(JSON_BLOBS), "$")]
    if name in ("mapvalue", "map_value", "item"):
        blobs = _obj(JSON_BLOBS + [{"k": 5, "m": "w"}])
        return [(blobs, "k", "dflt"), (blobs, "m")]
    if name in ("stdistance", "distance"):
        return [(r.uniform(-90, 90, 12), r.uniform(-180, 180, 12), 37.77, -122.4),
                (0.0, 0.0, 0.0, 180.0)]
    if name == "cosinedistance":
        vecs = _obj([r.normal(0, 1, 4) for _ in range(8)] + [np.zeros(4)])
        return [(vecs, r.normal(0, 1, 4))]
    if name in _ARRAY:
        return [(_arrays(r),)]
    if name == "lookup":
        keys = np.asarray([0, 1, 7, 499, 500, -3, 250], np.int32)
        return [("tx_dim", "region", "cid", keys),
                ("tx_dim", "credit", "cid", keys),
                ("tx_dim", "credit", "nope", keys),
                ("tx_missing", "credit", "cid", keys)]
    raise KeyError(name)


def _outcome(fn, args):
    try:
        with np.errstate(all="ignore"):
            return ("value", fn(*args))
    except Exception as e:  # the reference's exception type is compared
        return ("raise", type(e).__name__)


def _same_cell(a, b) -> bool:
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a):
        return math.isnan(b)
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return _same_value(a, b)
    return type(a) is type(b) and a == b


def _same_value(a, b) -> bool:
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        if a.dtype != b.dtype or a.shape != b.shape:
            return False
        if a.dtype.kind == "f":
            return np.array_equal(a, b, equal_nan=True)
        if a.dtype.kind == "O":
            return all(_same_cell(x, y) for x, y in zip(a.ravel(), b.ravel()))
        return np.array_equal(a, b)
    return _same_cell(a, b)


@pytest.fixture
def dim_in_both():
    """The same dimension table in both packages' registries (each its
    own), removed again after the test."""
    cols = {"cid": np.arange(500, dtype=np.int32),
            "region": _obj(["AMERICA", "ASIA", "EUROPE", "AFRICA"][i % 4]
                           for i in range(500)),
            "credit": (np.arange(500, dtype=np.int32) * 3) % 1000}
    dim_tables.register_dimension_table("tx_dim", "cid", cols)
    jax_dim_tables.register_dimension_table("tx_dim", "cid", cols)
    yield
    dim_tables.unregister_dimension_table("tx_dim")
    jax_dim_tables.unregister_dimension_table("tx_dim")


def test_registry_names_and_flags_equal_jax():
    assert sorted(transforms.TRANSFORMS) == sorted(jax_transforms.TRANSFORMS)
    assert len(transforms.TRANSFORMS) == 122
    for name, jd in jax_transforms.TRANSFORMS.items():
        pd = transforms.TRANSFORMS[name]
        assert pd.mv_arg == jd.mv_arg, name
        assert (pd.lower is None) == (jd.lower is None), name
    assert sum(d.lower is not None for d in transforms.TRANSFORMS.values()) == 47
    assert transforms.MILLIS == jax_transforms.MILLIS
    assert transforms._JODA == jax_transforms._JODA


@pytest.mark.parametrize("name", sorted(jax_transforms.TRANSFORMS))
def test_numpy_form_equals_jax(name, dim_in_both):
    r = np.random.default_rng(sum(map(ord, name)) * 7919)
    cases = _cases(name, r)
    assert cases
    for args in cases:
        want = _outcome(jax_transforms.TRANSFORMS[name].eval_np, args)
        got = _outcome(transforms.TRANSFORMS[name].eval_np, args)
        assert got[0] == want[0], (name, args, got, want)
        if got[0] == "raise":
            assert got[1] == want[1], (name, args, got, want)
        else:
            assert _same_value(got[1], want[1]), (name, args, got, want)


def test_civil_date_core_equals_python_calendar():
    """The int64 civil-date arithmetic against Python's calendar over every
    day from 1900 to 2100 (and the reference's arithmetic on the same)."""
    days = np.arange(-25567, 47482, dtype=np.int64)
    y, m, d, _ = transforms._np_civil(days)
    dates = [dt.date(1970, 1, 1) + dt.timedelta(days=int(x)) for x in days[::97]]
    assert [(int(a), int(b), int(c)) for a, b, c in
            zip(y[::97], m[::97], d[::97])] == [(t.year, t.month, t.day)
                                                 for t in dates]
    np.testing.assert_array_equal(
        transforms._np_days_from_civil(y, m, d), days)
    for a, b in zip((y, m, d), jax_transforms._np_civil(days)[:3]):
        np.testing.assert_array_equal(a, b)


def test_eval_expr_np_refusals_and_fallback():
    def first(sql):
        return parse_sql(sql).select_expressions[0]

    vals = {"s": _obj(["ab", "cd"]), "x": np.asarray([1.25, -2.5])}
    e = first("SELECT concat(upper(s), 'z', '-') FROM t")
    assert list(transforms.eval_expr_np(e, vals.__getitem__)) == ["AB-z", "CD-z"]
    with pytest.raises(UnsupportedQueryError):
        transforms.eval_expr_np(first("SELECT coalesce(x, 0) FROM t"),
                                vals.__getitem__)
    with pytest.raises(UnsupportedQueryError):
        transforms.eval_expr_np(first("SELECT nosuchfn(x) FROM t"),
                                vals.__getitem__)
    assert transforms.np_evaluable(first("SELECT rounddecimal(x, 1) FROM t"))
    assert transforms.np_evaluable(first("SELECT lookup('a', 'b', 'c', x) FROM t"))
    assert not transforms.np_evaluable(first("SELECT coalesce(x, 0) FROM t"))
    assert not transforms.np_evaluable(first("SELECT abs(nosuchfn(x)) FROM t"))
    assert transforms.eval_scalar("rounddecimal", [2.345, 1]) == 2.3
    assert transforms.eval_scalar("upper", ["ab"]) == "AB"
    assert transforms.eval_scalar("year", [_ms(2000, 2, 29)]) == 2000
    assert type(transforms.eval_scalar("year", [0])) is int
    with pytest.raises(UnsupportedQueryError):
        transforms.eval_scalar("nosuchfn", [1])


# -- (b) device lowerings: plans and rows against the JAX package --------------

TABLE = "tx"
DIMS = [("ts", "TIMESTAMP"), ("tsr", "TIMESTAMP"), ("dy", "INT"),
        ("dyr", "INT"), ("x", "DOUBLE"), ("xr", "DOUBLE"), ("region", "STRING")]
METRICS = [("rev", "INT")]
RAW = ["tsr", "dyr", "xr", "rev"]
SIZES = [1500, 900]

# (name, expression) with {t} a TIMESTAMP column, {d} an INT day count and
# {x} a DOUBLE column, each raw or dictionary-encoded
LOWERED = [(n, f"{n}({{t}})") for n in _UNARY_MS if n not in (
    "week", "weekofyear", "yearofweek", "yow")]
LOWERED += [(n, f"{n}({{d}})") for n in _UNARY_DAYS]
LOWERED += [(n, f"{n}({{t}}, 15)") for n in _ROUNDED]
LOWERED += [(n, f"{n}({{d}}, 7)") for n in _FROM_BUCKET]
LOWERED += [("datetrunc", f"datetrunc('{u}', {{t}})") for u in _CAL_UNITS]
LOWERED += [("datetrunc", "datetrunc('WEEK', {d}, 'DAYS')"),
            ("timeconvert", "timeconvert({t}, 'MILLISECONDS', 'HOURS')"),
            ("datetimeconvert", "datetimeconvert({t}, '1:MILLISECONDS:EPOCH', "
                                "'1:HOURS:EPOCH', '15:MINUTES')"),
            ("gapfill", "gapfill({t})"), ("fill", "fill({d})"),
            ("timestampadd", "timestampadd('DAY', 3, {t})"),
            ("dateadd", "dateadd('HOURS', {d}, {t})"),
            ("timestampdiff", "timestampdiff('MINUTE', {t}, tsr)"),
            ("datediff", "datediff('WEEK', ts, {t})"),
            ("round", "round({t}, 1000)"), ("round", "round({x})"),
            ("rounddecimal", "rounddecimal({x}, 2)"),
            ("rounddecimal", "rounddecimal({x})"),
            ("truncate", "truncate({x}, 1)"), ("cbrt", "cbrt({x})")]
KINDS = {"raw": {"t": "tsr", "d": "dyr", "x": "xr"},
         "dict": {"t": "ts", "d": "dy", "x": "x"}}


def _columns(r, rows):
    return {"ts": r.choice(_millis(r, 600), rows),
            "tsr": _millis(r, rows)[:rows],
            "dy": r.integers(-25567, 47482, rows).astype(np.int32),
            "dyr": r.integers(-25567, 47482, rows).astype(np.int32),
            "x": np.round(r.normal(0, 50, rows), 3),
            "xr": r.normal(0, 50, rows),
            "region": _obj(r.choice(["ASIA", "EUROPE", "AFRICA"], rows)),
            "rev": r.integers(-100, 1000, rows).astype(np.int32)}


@pytest.fixture(autouse=True)
def _jax_dispatches_every_query(monkeypatch):
    monkeypatch.setenv("PINOT_TPU_SEGMENT_CACHE", "0")
    monkeypatch.setenv("PINOT_TPU_MESH_DEVICES", "1")
    monkeypatch.setenv("PINOT_TPU_FUSED", "interpret")


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    r = np.random.default_rng(1900)
    schema = Schema.build(TABLE, dimensions=DIMS, metrics=METRICS)
    cfg = TableConfig(table_name=TABLE,
                      indexing=IndexingConfig(no_dictionary_columns=RAW))
    root = tmp_path_factory.mktemp("torch_transforms")
    paths = []
    for i, rows in enumerate(SIZES):
        SegmentBuilder(schema, cfg, f"s{i}").build(_columns(r, rows),
                                                   root / f"s{i}")
        paths.append(root / f"s{i}")
    port = QueryExecutor(device="cpu")
    port.add_table(schema, [load_segment(p) for p in paths])
    jax = JaxQueryExecutor(backend="tpu")
    jax.add_table(JaxSchema.build(TABLE, dimensions=DIMS, metrics=METRICS),
                  [jax_load(p) for p in paths])
    return port, jax, paths


def _group_sql(exprs):
    aggs = ", ".join(f"MIN({e}), MAX({e}), SUM({e})" for e in exprs)
    return f"SELECT region, {aggs} FROM {TABLE} GROUP BY region"


def _rows_sql(exprs):
    """Each transform once: SUM of an integer one (exact), MIN and MAX of
    a float one."""
    aggs = ", ".join(f"MIN({e}), MAX({e})" if "{x}" in t else f"SUM({e})"
                     for t, e in exprs)
    return f"SELECT region, {aggs} FROM {TABLE} GROUP BY region"


def _filter_sql(e, threshold):
    return (f"SELECT COUNT(*), SUM(rev) FROM {TABLE} WHERE {e} >= {threshold}")


def _threshold(e, path):
    """A literal that splits the segment's rows: the median of the
    transform over them (numpy form)."""
    seg = load_segment(path)
    expr = parse_sql(f"SELECT {e} FROM {TABLE}").select_expressions[0]
    vals = transforms.eval_expr_np(expr, lambda c: seg.get_values_at(
        c, np.arange(seg.num_docs)))
    v = float(np.median(np.asarray(vals, dtype=np.float64)))
    return int(v) if float(v).is_integer() else v


def _assert_plans_equal(sql, path):
    jplan = JaxPlanner(jax_parse(sql), jax_load(path)).plan()
    pplan = SegmentPlanner(parse_sql(sql), load_segment(path)).plan()
    assert repr(pplan.program) == repr(jplan.program)
    assert pplan.slots == jplan.slots
    assert len(pplan.params) == len(jplan.params)
    for a, b in zip(pplan.params, jplan.params):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    return pplan


def _cell_equal(a, b):
    if isinstance(a, float) or isinstance(b, float):
        a, b = float(a), float(b)
        if math.isnan(a) or math.isnan(b):
            return math.isnan(a) and math.isnan(b)
        return math.isclose(a, b, rel_tol=1e-12)
    return a == b


def _assert_rows_equal(port, jax, sql, ordered=False):
    want = jax.execute_sql(sql)
    assert not want.exceptions, want.exceptions
    got = port.execute_sql(sql)
    g, w = got.result_table.rows, want.result_table.rows
    if not ordered:
        g, w = sorted(g, key=repr), sorted(w, key=repr)
    assert len(g) == len(w)
    for rg, rw in zip(g, w):
        assert len(rg) == len(rw)
        assert all(_cell_equal(a, b) for a, b in zip(rg, rw)), (rg, rw)
    assert got.result_table.schema.to_json() == \
        want.result_table.schema.to_json()
    assert got.num_docs_scanned == want.num_docs_scanned
    assert got.num_device_dispatches == want.num_device_dispatches


def _lowered_params():
    out = []
    for name, tmpl in LOWERED:
        for kind in KINDS:
            out.append(pytest.param(name, tmpl, kind, id=f"{kind}-{tmpl}"))
    return out


@pytest.mark.parametrize("name,tmpl,kind", _lowered_params())
def test_lowered_plan_equals_jax(tables, name, tmpl, kind):
    """Plan parity on both segments, in value context (MIN/MAX/SUM by
    group) and in a filter; the port lowered to the device chain, not to a
    dictionary table."""
    _, _, paths = tables
    e = tmpl.format(**KINDS[kind])
    for path in paths:
        plan = _assert_plans_equal(_group_sql([e]), path)
        assert plan.program.mode == "group_by"
        _assert_plans_equal(_filter_sql(e, _threshold(e, path)), path)
        q = parse_sql(f"SELECT {e} FROM {TABLE}")
        ve = SegmentPlanner(q, load_segment(path)).value_expr(
            q.select_expressions[0])
        assert type(ve).__name__ != "ParamGather"
    assert transforms.TRANSFORMS[name].lower is not None


# the reference traces its expression trees without sharing: the
# civil-date chains back to a date (DATETRUNC to MONTH, QUARTER, YEAR;
# DAYOFYEAR) are thousands of ops each, 10 to 30 s of compile a query. So
# MONTH and DAYOFYEAR run against the JAX package over the raw column, and
# all of them, over both columns, against the reference's numpy form
# (test_heavy_chains_equal_numpy_form)
_HEAVY = ("datetrunc('MONTH', {t})", "dayofyear({t})", "doy({t})")
_PLAN_ONLY = ("datetrunc('QUARTER', {t})", "datetrunc('YEAR', {t})")


def _grouped_lowered():
    """Every lowered name over each column kind, in a few queries (one
    JAX compile each)."""
    out = []
    for kind, cols in KINDS.items():
        light = [(t, t.format(**cols)) for _, t in LOWERED
                 if t not in _HEAVY + _PLAN_ONLY]
        for i in range(0, len(light), 16):
            out.append(pytest.param(light[i:i + 16], id=f"{kind}-{i // 16}"))
        if kind == "raw":
            out += [pytest.param([(t, t.format(**cols))], id=f"{kind}-{t}")
                    for t in _HEAVY[:2]]
    return out


@pytest.mark.parametrize("exprs", _grouped_lowered())
def test_lowered_rows_equal_jax(tables, exprs):
    port, jax, _ = tables
    _assert_rows_equal(port, jax, _rows_sql(exprs))


@pytest.mark.parametrize("tmpl", _HEAVY + _PLAN_ONLY)
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_heavy_chains_equal_numpy_form(tables, tmpl, kind):
    """The long chains on the port's CPU interpreter, exact against the
    reference's numpy form of the same transform, group by group."""
    port, _, paths = tables
    e = tmpl.format(**KINDS[kind])
    got = port.execute_sql(_rows_sql([(tmpl, e)])).result_table.rows
    expr = parse_sql(f"SELECT {e} FROM {TABLE}").select_expressions[0]
    want: dict = {}
    for path in paths:
        seg = jax_load(path)
        vals = jax_transforms.eval_expr_np(expr, seg.get_values)
        for region, v in zip(seg.get_values("region"), vals):
            want[region] = want.get(region, 0) + int(v)
    assert {r: int(v) for r, v in got} == want


def test_every_lowered_name_is_covered():
    """Plan parity covers all 47 lowered names; the rows, all but doy
    (dayofyear's lowering under another name)."""
    lowered = {n for n, d in transforms.TRANSFORMS.items()
               if d.lower is not None}
    assert {n for n, _ in LOWERED} == lowered
    ran = {n for n, t in LOWERED if t not in _PLAN_ONLY + _HEAVY[2:]}
    assert ran == lowered - {"doy"}
    assert transforms.TRANSFORMS["doy"].lower is not None


@pytest.mark.parametrize("tmpl", ["month({t})", "datetrunc('WEEK', {t})",
                                  "dayofweek({t})", "toepochhoursbucket({t}, 15)",
                                  "rounddecimal({x}, 1)"])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_lowered_filter_rows_equal_jax(tables, tmpl, kind):
    port, jax, paths = tables
    e = tmpl.format(**KINDS[kind])
    _assert_rows_equal(port, jax, _filter_sql(e, _threshold(e, paths[0])))


@pytest.mark.parametrize("sql,ordered", [
    # dictionary-evaluated GROUP BY keys (derived dimensions) over ts
    ("SELECT datetrunc('MONTH', ts), COUNT(*), SUM(rev) FROM tx "
     "WHERE region = 'ASIA' GROUP BY datetrunc('MONTH', ts) LIMIT 100000",
     False),
    ("SELECT todatetime(ts, 'yyyy-MM'), lower(region), COUNT(*), SUM(rev) "
     "FROM tx WHERE substr(region, 0, 1) = 'A' "
     "GROUP BY todatetime(ts, 'yyyy-MM'), lower(region) LIMIT 100000", False),
    ("SELECT week(ts), COUNT(*) FROM tx GROUP BY week(ts) LIMIT 100", False),
    # the int64 chain on the raw column and a dictionary operand
    ("SELECT region, COUNT(*), SUM(toepochdays(tsr) - toepochdays(ts)) "
     "FROM tx WHERE month(tsr) = 12 GROUP BY region", False),
    # post-aggregation and HAVING scalars
    ("SELECT region, rounddecimal(SUM(rev) / COUNT(*), 1) FROM tx "
     "GROUP BY region ORDER BY region", True),
    ("SELECT region, upper(region), COUNT(*) FROM tx GROUP BY region "
     "HAVING round(SUM(rev) / 1000) > 100 ORDER BY region", True),
    ("SELECT truncate(AVG(x), 1), todatetime(MAX(ts), 'yyyy-MM-dd') FROM tx",
     True),
    # selection transform items, ORDER BY on one
    ("SELECT tsr, todatetime(tsr, 'yyyy-MM-dd HH:mm'), concat(region, 'x', '-') "
     "FROM tx WHERE year(tsr) < 1950 ORDER BY tsr LIMIT 25", True),
    ("SELECT region, dayofweek(ts) FROM tx ORDER BY datetrunc('YEAR', ts), "
     "region LIMIT 30", True),
])
def test_transform_queries_equal_jax(tables, sql, ordered):
    port, jax, _ = tables
    _assert_rows_equal(port, jax, sql, ordered)


@pytest.mark.parametrize("sql", [
    # a GROUP BY on a transform of a raw column: the JAX package's host
    # engine answers it
    "SELECT year(tsr), COUNT(*) FROM tx GROUP BY year(tsr)",
    # string-valued transform as an aggregation input
    "SELECT SUM(upper(region)) FROM tx",
    # calendar timestampAdd over a raw column has no device form
    "SELECT MAX(timestampadd('MONTH', 1, tsr)) FROM tx",
])
def test_refused_where_jax_planner_refuses(tables, sql):
    """Both single-stage planners refuse these; both packages retry on
    their multi-stage engine, and the port answers what the JAX package
    answers there, or raises where that fails too."""
    port, jax, paths = tables
    from pinot_tpu.engine.aggregation import \
        UnsupportedQueryError as JaxUnsupported

    with pytest.raises(JaxUnsupported):
        JaxPlanner(jax_parse(sql), jax_load(paths[0])).plan()
    if jax.execute_sql(sql).exceptions:
        with pytest.raises(UnsupportedQueryError):
            port.execute_sql(sql)
    else:
        _assert_rows_equal(port, jax, sql)
