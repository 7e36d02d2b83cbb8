"""The transform function registry: 122 names, each with a numpy form and,
for 47 of them, a device lowering to kernel IR.

The port of pinot_tpu/query/transforms.py, name for name (reference:
pinot-core/.../operator/transform/function/ behind
TransformFunctionFactory, and the scalar functions of
pinot-common/.../common/function/scalar/). A transform has up to three
forms, defined here together so they cannot diverge:

1. **Device lowering** to engine/ir.py nodes (`TransformDef.lower`, built
   through `IRBuilder`): calendar extraction, epoch conversions and
   bucketing, DATETRUNC, timeConvert, dateTimeConvert between epoch
   formats, timestampAdd/Diff in fixed units and rounding lower to chains
   of int64 multiply, add and floor division (Howard Hinnant's civil-date
   algorithms) that ops/kernels.py runs as torch ops over the whole
   segment. `IRBuilder.c` de-duplicates constants per builder in the
   reference's order, so the planner's `params` match the JAX package's.
2. **Numpy form** (`TransformDef.eval_np`): the planner evaluates it over a
   column's DICTIONARY (engine/plan.py `_dict_transform_values`), so
   string, JSON, date-format and LOOKUP transforms become a gather of a
   cardinality-sized table on the device; the selection path evaluates it
   over the matching docs (engine/selection.py `eval_at`).
3. **Scalar form** (`eval_scalar`) for post-aggregation and HAVING
   expressions (engine/reduce.py): the numpy form on Python scalars.
"""

from __future__ import annotations

import base64
import datetime as _dt
import hashlib
import json
import math
import re
import urllib.parse
import zlib
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np

from ..engine import ir
from ..engine.aggregation import UnsupportedQueryError
from ..engine.dim_tables import get_dimension_table

# ---------------------------------------------------------------------------
# millis-per-unit table (reference TimeUnit conversions)
# ---------------------------------------------------------------------------

MILLIS = {
    "MILLISECONDS": 1,
    "SECONDS": 1000,
    "MINUTES": 60_000,
    "HOURS": 3_600_000,
    "DAYS": 86_400_000,
    "WEEKS": 604_800_000,
}

# epoch day 0 (1970-01-01) is a Thursday; ISO Monday=1 → offset 3
_DOW_OFFSET = 3


# ---------------------------------------------------------------------------
# civil-date integer arithmetic (numpy form)
# ---------------------------------------------------------------------------


def _np_days(millis):
    return np.floor_divide(np.asarray(millis).astype(np.int64), 86_400_000)


def _np_civil(days):
    """days-since-epoch → (year, month, day, civil-doy) via pure int ops."""
    z = np.asarray(days).astype(np.int64) + 719_468
    era = z // 146_097
    doe = z - era * 146_097
    yoe = (doe - doe // 1460 + doe // 36_524 - doe // 146_096) // 365
    y = yoe + era * 400
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)
    mp = (5 * doy + 2) // 153
    d = doy - (153 * mp + 2) // 5 + 1
    m = np.where(mp < 10, mp + 3, mp - 9)
    y = y + (m <= 2)
    return y, m, d, doy


def _np_days_from_civil(y, m, d):
    y = np.asarray(y).astype(np.int64) - (np.asarray(m) <= 2)
    era = y // 400
    yoe = y - era * 400
    mp = np.where(np.asarray(m) > 2, np.asarray(m) - 3, np.asarray(m) + 9)
    doy = (153 * mp + 2) // 5 + np.asarray(d) - 1
    doe = yoe * 365 + yoe // 4 - yoe // 100 + doy
    return era * 146_097 + doe - 719_468


def _np_year(ms):
    return _np_civil(_np_days(ms))[0]


def _np_month(ms):
    return _np_civil(_np_days(ms))[1]


def _np_day(ms):
    return _np_civil(_np_days(ms))[2]


def _np_quarter(ms):
    return (_np_month(ms) - 1) // 3 + 1


def _np_dayofweek(ms):
    return (_np_days(ms) + _DOW_OFFSET) % 7 + 1


def _np_dayofyear(ms):
    d = _np_days(ms)
    y, _, _, _ = _np_civil(d)
    return d - _np_days_from_civil(y, 1, 1) + 1


def _np_week(ms):
    """ISO week of year (reference weekOfYear → Joda ISO chronology)."""
    arr = np.atleast_1d(_np_days(ms))
    out = np.empty(arr.shape, dtype=np.int64)
    flat, oflat = arr.ravel(), out.ravel()
    for i, dd in enumerate(flat):
        oflat[i] = (_dt.date(1970, 1, 1) + _dt.timedelta(days=int(dd))).isocalendar()[1]
    return out.reshape(arr.shape) if np.ndim(ms) else out[0]


def _np_yearofweek(ms):
    arr = np.atleast_1d(_np_days(ms))
    out = np.empty(arr.shape, dtype=np.int64)
    flat, oflat = arr.ravel(), out.ravel()
    for i, dd in enumerate(flat):
        oflat[i] = (_dt.date(1970, 1, 1) + _dt.timedelta(days=int(dd))).isocalendar()[0]
    return out.reshape(arr.shape) if np.ndim(ms) else out[0]


def _np_datetrunc(unit, ms):
    unit = str(unit).upper()
    ms = np.asarray(ms).astype(np.int64)
    simple = {"MILLISECOND": 1, "SECOND": 1000, "MINUTE": 60_000, "HOUR": 3_600_000,
              "DAY": 86_400_000}
    if unit in simple:
        f = simple[unit]
        return (ms // f) * f
    days = _np_days(ms)
    if unit == "WEEK":
        # truncate to Monday (ISO)
        monday = days - (days + _DOW_OFFSET) % 7
        return monday * 86_400_000
    y, m, _, _ = _np_civil(days)
    if unit == "MONTH":
        return _np_days_from_civil(y, m, 1) * 86_400_000
    if unit == "QUARTER":
        qm = ((m - 1) // 3) * 3 + 1
        return _np_days_from_civil(y, qm, 1) * 86_400_000
    if unit == "YEAR":
        return _np_days_from_civil(y, 1, 1) * 86_400_000
    raise ValueError(f"dateTrunc unit {unit}")


def _np_timestampadd(unit, amount, ms):
    unit = str(unit).upper().rstrip("S")
    ms = np.asarray(ms).astype(np.int64)
    amount = np.asarray(amount).astype(np.int64)
    simple = {"MILLISECOND": 1, "SECOND": 1000, "MINUTE": 60_000, "HOUR": 3_600_000,
              "DAY": 86_400_000, "WEEK": 604_800_000}
    if unit in simple:
        return ms + amount * simple[unit]
    days = _np_days(ms)
    tod = ms - days * 86_400_000
    y, m, d, _ = _np_civil(days)
    if unit == "MONTH":
        t = (y * 12 + (m - 1)) + amount
        y2, m2 = t // 12, t % 12 + 1
    elif unit in ("YEAR", "QUARTER"):
        step = amount * (3 if unit == "QUARTER" else 12)
        t = (y * 12 + (m - 1)) + step
        y2, m2 = t // 12, t % 12 + 1
    else:
        raise ValueError(f"timestampAdd unit {unit}")
    # clamp day to target month length
    nxt = _np_days_from_civil(y2 + (m2 == 12), np.where(m2 == 12, 1, m2 + 1), 1)
    cur = _np_days_from_civil(y2, m2, 1)
    d2 = np.minimum(d, nxt - cur)
    return (_np_days_from_civil(y2, m2, d2)) * 86_400_000 + tod


def _np_timestampdiff(unit, a, b):
    """timestampDiff(unit, a, b) = (b - a) in unit (reference semantics)."""
    unit = str(unit).upper().rstrip("S")
    a = np.asarray(a).astype(np.int64)
    b = np.asarray(b).astype(np.int64)
    simple = {"MILLISECOND": 1, "SECOND": 1000, "MINUTE": 60_000, "HOUR": 3_600_000,
              "DAY": 86_400_000, "WEEK": 604_800_000}
    if unit in simple:
        return (b - a) // simple[unit]
    ya, ma, da, _ = _np_civil(_np_days(a))
    yb, mb, db, _ = _np_civil(_np_days(b))
    months = (yb * 12 + mb) - (ya * 12 + ma) - (db < da)
    if unit == "MONTH":
        return months
    if unit == "QUARTER":
        return months // 3
    if unit == "YEAR":
        return months // 12
    raise ValueError(f"timestampDiff unit {unit}")


# joda-style pattern → strftime (subset: y M d H h m s S E a)
_JODA = [("yyyy", "%Y"), ("yy", "%y"), ("MM", "%m"), ("dd", "%d"), ("HH", "%H"),
         ("hh", "%I"), ("mm", "%M"), ("ss", "%S"), ("SSS", "%f"), ("EEE", "%a"),
         ("a", "%p"), ("M", "%m"), ("d", "%d"), ("H", "%H"), ("m", "%M"), ("s", "%S")]


def joda_to_strftime(pattern: str) -> str:
    out, i = [], 0
    p = str(pattern)
    while i < len(p):
        for j, (src, dst) in enumerate(_JODA):
            if p.startswith(src, i):
                out.append(dst)
                i += len(src)
                break
        else:
            out.append(p[i])
            i += 1
    return "".join(out)


def _ms_to_str(ms, pattern):
    fmt = joda_to_strftime(pattern)
    t = _dt.datetime(1970, 1, 1) + _dt.timedelta(milliseconds=int(ms))
    s = t.strftime(fmt)
    if "%f" in fmt:  # strftime %f is micros; joda SSS is millis
        s = s.replace(t.strftime("%f"), f"{t.microsecond // 1000:03d}")
    return s


def _str_to_ms(s, pattern):
    fmt = joda_to_strftime(pattern)
    t = _dt.datetime.strptime(str(s), fmt)
    return int((t - _dt.datetime(1970, 1, 1)).total_seconds() * 1000)


# ---------------------------------------------------------------------------
# row-wise vectorization helper (string/json functions)
# ---------------------------------------------------------------------------


def rowfn(f):
    """Wrap a scalar python function into one broadcasting over ndarray args.

    Dictionary transforms call these over cardinality-sized arrays, and
    selections over the matching rows only; the device path never runs
    them per row.
    """

    def wrapped(*args):
        arrs = [a for a in args if isinstance(a, np.ndarray) and a.ndim > 0]
        if not arrs:
            return f(*args)
        n = len(arrs[0])
        out = [f(*[(a[i] if (isinstance(a, np.ndarray) and a.ndim > 0) else a)
                   for a in args]) for i in range(n)]
        return np.asarray(out)

    return wrapped


def _sstr(v):
    return v if isinstance(v, str) else str(v)


# ---------------------------------------------------------------------------
# IR builder combinators (device lowering)
# ---------------------------------------------------------------------------


class IRBuilder:
    """Tiny DSL over engine/ir.py used by device lowerings. ``planner`` is
    engine/plan.py SegmentPlanner (value_expr + param slots)."""

    def __init__(self, planner):
        self.p = planner
        self._consts: dict = {}

    def v(self, expr) -> ir.ValueExpr:
        return self.p.value_expr(expr)

    def c(self, value) -> ir.ValueExpr:
        key = (type(value).__name__, value)
        if key not in self._consts:
            v = np.int64(value) if isinstance(value, (int, np.integer)) else np.float64(value)
            self._consts[key] = ir.ConstParam(self.p.param(v))
        return self._consts[key]

    @staticmethod
    def lit(arg):
        if not arg.is_literal:
            raise UnsupportedQueryError("argument must be a literal")
        return arg.literal

    # arithmetic
    def add(self, a, b):
        return ir.Bin("add", a, b)

    def sub(self, a, b):
        return ir.Bin("sub", a, b)

    def mul(self, a, b):
        return ir.Bin("mul", a, b)

    def fdiv(self, a, b):
        return ir.Bin("fdiv", a, b)

    def mod(self, a, b):
        return ir.Bin("mod", a, b)

    def where(self, c, a, b):
        return ir.Where(c, a, b)

    def le(self, a, b):
        return ir.Bin("le", a, b)

    def lt(self, a, b):
        return ir.Bin("lt", a, b)

    def long(self, a):
        return ir.Cast(a, "LONG")

    # civil-date chains (device twin of _np_civil / _np_days_from_civil)
    def days(self, ms):
        return self.fdiv(self.long(ms), self.c(86_400_000))

    def civil(self, days):
        z = self.add(days, self.c(719_468))
        era = self.fdiv(z, self.c(146_097))
        doe = self.sub(z, self.mul(era, self.c(146_097)))
        # yoe = (doe - doe//1460 + doe//36524 - doe//146096) // 365
        yoe = self.fdiv(
            self.sub(self.add(self.sub(doe, self.fdiv(doe, self.c(1460))),
                              self.fdiv(doe, self.c(36_524))),
                     self.fdiv(doe, self.c(146_096))),
            self.c(365))
        y = self.add(yoe, self.mul(era, self.c(400)))
        # doy = doe - (365*yoe + yoe//4 - yoe//100)
        doy = self.sub(doe, self.sub(self.add(self.mul(self.c(365), yoe),
                                              self.fdiv(yoe, self.c(4))),
                                     self.fdiv(yoe, self.c(100))))
        mp = self.fdiv(self.add(self.mul(self.c(5), doy), self.c(2)), self.c(153))
        d = self.add(self.sub(doy, self.fdiv(self.add(self.mul(self.c(153), mp),
                                                      self.c(2)), self.c(5))),
                     self.c(1))
        m = self.where(self.lt(mp, self.c(10)), self.add(mp, self.c(3)),
                       self.sub(mp, self.c(9)))
        y = self.add(y, self.long(self.le(m, self.c(2))))
        return y, m, d, doy

    def days_from_civil(self, y, m, d):
        y = self.sub(y, self.long(self.le(m, self.c(2))))
        era = self.fdiv(y, self.c(400))
        yoe = self.sub(y, self.mul(era, self.c(400)))
        mp = self.where(self.lt(self.c(2), m), self.sub(m, self.c(3)),
                        self.add(m, self.c(9)))
        doy = self.add(self.fdiv(self.add(self.mul(self.c(153), mp), self.c(2)),
                                 self.c(5)),
                       self.sub(d, self.c(1)))
        doe = self.add(self.sub(self.add(self.mul(yoe, self.c(365)),
                                         self.fdiv(yoe, self.c(4))),
                                self.fdiv(yoe, self.c(100))),
                       doy)
        return self.sub(self.add(self.mul(era, self.c(146_097)), doe), self.c(719_468))


# ---------------------------------------------------------------------------
# device lowerings
# ---------------------------------------------------------------------------


def _lower_extract(part: str):
    def lower(B: IRBuilder, args):
        ms = B.long(B.v(args[0]))
        if part == "hour":
            return B.mod(B.fdiv(ms, B.c(3_600_000)), B.c(24))
        if part == "minute":
            return B.mod(B.fdiv(ms, B.c(60_000)), B.c(60))
        if part == "second":
            return B.mod(B.fdiv(ms, B.c(1000)), B.c(60))
        if part == "millisecond":
            return B.mod(ms, B.c(1000))
        days = B.days(ms)
        if part == "dayofweek":
            return B.add(B.mod(B.add(days, B.c(_DOW_OFFSET)), B.c(7)), B.c(1))
        y, m, d, _ = B.civil(days)
        if part == "year":
            return y
        if part == "month":
            return m
        if part == "quarter":
            return B.add(B.fdiv(B.sub(m, B.c(1)), B.c(3)), B.c(1))
        if part == "day":
            return d
        if part == "dayofyear":
            return B.add(B.sub(days, B.days_from_civil(y, B.c(1), B.c(1))), B.c(1))
        raise ValueError(part)

    return lower


def _lower_scale(factor: int, to_millis: bool):
    def lower(B: IRBuilder, args):
        v = B.long(B.v(args[0]))
        if to_millis:
            return B.mul(v, B.c(factor))
        return B.fdiv(v, B.c(factor))

    return lower


def _lower_epoch_rounded(factor: int, bucket_only: bool):
    def lower(B: IRBuilder, args):
        v = B.fdiv(B.long(B.v(args[0])), B.c(factor))
        n = int(IRBuilder.lit(args[1]))
        if bucket_only:
            return B.fdiv(v, B.c(n))
        return B.mul(B.fdiv(v, B.c(n)), B.c(n))

    return lower


def _lower_from_epoch_bucket(factor: int):
    def lower(B: IRBuilder, args):
        n = int(IRBuilder.lit(args[1]))
        return B.mul(B.long(B.v(args[0])), B.c(factor * n))

    return lower


def _lower_datetrunc(B: IRBuilder, args):
    unit = str(IRBuilder.lit(args[0])).upper()
    ms = B.long(B.v(args[1]))
    if len(args) > 2:
        u = str(IRBuilder.lit(args[2])).upper()
        ms = B.mul(ms, B.c(MILLIS[u]))  # normalize input to millis
    simple = {"MILLISECOND": 1, "SECOND": 1000, "MINUTE": 60_000, "HOUR": 3_600_000,
              "DAY": 86_400_000}
    if unit in simple:
        f = simple[unit]
        out = B.mul(B.fdiv(ms, B.c(f)), B.c(f))
    elif unit == "WEEK":
        days = B.days(ms)
        monday = B.sub(days, B.mod(B.add(days, B.c(_DOW_OFFSET)), B.c(7)))
        out = B.mul(monday, B.c(86_400_000))
    elif unit in ("MONTH", "QUARTER", "YEAR"):
        days = B.days(ms)
        y, m, _, _ = B.civil(days)
        if unit == "MONTH":
            first = B.days_from_civil(y, m, B.c(1))
        elif unit == "QUARTER":
            qm = B.add(B.mul(B.fdiv(B.sub(m, B.c(1)), B.c(3)), B.c(3)), B.c(1))
            first = B.days_from_civil(y, qm, B.c(1))
        else:
            first = B.days_from_civil(y, B.c(1), B.c(1))
        out = B.mul(first, B.c(86_400_000))
    else:
        raise ValueError(f"dateTrunc unit {unit}")
    if len(args) > 2:
        u = str(IRBuilder.lit(args[2])).upper()
        out = B.fdiv(out, B.c(MILLIS[u]))  # back to the caller's unit
    return out


def _lower_timeconvert(B: IRBuilder, args):
    src = MILLIS[str(IRBuilder.lit(args[1])).upper()]
    dst = MILLIS[str(IRBuilder.lit(args[2])).upper()]
    return B.fdiv(B.mul(B.long(B.v(args[0])), B.c(src)), B.c(dst))


def parse_datetime_format(spec: str):
    """'1:MILLISECONDS:EPOCH' / '1:DAYS:SIMPLE_DATE_FORMAT:yyyy-MM-dd' →
    (size, unit, kind, pattern)."""
    parts = str(spec).split(":", 3)
    size = int(parts[0])
    unit = parts[1].upper()
    kind = parts[2].upper()
    pattern = parts[3] if len(parts) > 3 else None
    return size, unit, kind, pattern


def _lower_datetimeconvert(B: IRBuilder, args):
    isz, iu, ik, _ = parse_datetime_format(IRBuilder.lit(args[1]))
    osz, ou, ok, _ = parse_datetime_format(IRBuilder.lit(args[2]))
    if ik != "EPOCH" or ok != "EPOCH":
        raise UnsupportedQueryError("SIMPLE_DATE_FORMAT stays on host")
    gsz, gu = str(IRBuilder.lit(args[3])).split(":")
    ms = B.mul(B.long(B.v(args[0])), B.c(MILLIS[iu] * isz))
    gran = MILLIS[gu.upper()] * int(gsz)
    ms = B.mul(B.fdiv(ms, B.c(gran)), B.c(gran))
    return B.fdiv(ms, B.c(MILLIS[ou] * osz))


def _lower_timestampadd(B: IRBuilder, args):
    unit = str(IRBuilder.lit(args[0])).upper().rstrip("S")
    simple = {"MILLISECOND": 1, "SECOND": 1000, "MINUTE": 60_000, "HOUR": 3_600_000,
              "DAY": 86_400_000, "WEEK": 604_800_000}
    if unit not in simple:
        raise UnsupportedQueryError("calendar timestampAdd stays on host")
    return B.add(B.long(B.v(args[2])),
                 B.mul(B.long(B.v(args[1])), B.c(simple[unit])))


def _lower_timestampdiff(B: IRBuilder, args):
    unit = str(IRBuilder.lit(args[0])).upper().rstrip("S")
    simple = {"MILLISECOND": 1, "SECOND": 1000, "MINUTE": 60_000, "HOUR": 3_600_000,
              "DAY": 86_400_000, "WEEK": 604_800_000}
    if unit not in simple:
        raise UnsupportedQueryError("calendar timestampDiff stays on host")
    return B.fdiv(B.sub(B.long(B.v(args[2])), B.long(B.v(args[1]))), B.c(simple[unit]))


def _lower_round(B: IRBuilder, args):
    if len(args) == 1:
        return ir.Un("floor", B.add(B.v(args[0]), B.c(0.5)))
    # round(timeValue, n) = (v // n) * n  (reference DateTimeFunctions.round)
    n = int(IRBuilder.lit(args[1]))
    return B.mul(B.fdiv(B.long(B.v(args[0])), B.c(n)), B.c(n))


def _lower_rounddecimal(B: IRBuilder, args):
    scale = int(IRBuilder.lit(args[1])) if len(args) > 1 else 0
    f = B.c(float(10 ** scale))
    return ir.Bin("div", ir.Un("floor", B.add(B.mul(B.v(args[0]), f), B.c(0.5))), f)


def _lower_truncate(B: IRBuilder, args):
    scale = int(IRBuilder.lit(args[1])) if len(args) > 1 else 0
    f = B.c(float(10 ** scale))
    v = B.mul(B.v(args[0]), f)
    return ir.Bin("div", B.where(ir.Bin("ge", v, B.c(0.0)), ir.Un("floor", v),
                                 ir.Un("ceil", v)), f)


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------


@dataclass
class TransformDef:
    eval_np: Callable
    lower: Optional[Callable] = None  # (IRBuilder, args) -> ir.ValueExpr
    mv_arg: bool = False  # first arg is a multi-value column (array fns)


def _np_round(x, n=None):
    if n is None:
        return np.floor(np.asarray(x, dtype=np.float64) + 0.5)
    return (np.asarray(x).astype(np.int64) // int(n)) * int(n)


def _np_rounddecimal(x, scale=0):
    f = 10.0 ** int(scale)
    return np.floor(np.asarray(x, dtype=np.float64) * f + 0.5) / f


def _np_truncate(x, scale=0):
    f = 10.0 ** int(scale)
    return np.trunc(np.asarray(x, dtype=np.float64) * f) / f


def _np_datetimeconvert(v, infmt, outfmt, gran):
    isz, iu, ik, ipat = parse_datetime_format(infmt)
    osz, ou, ok, opat = parse_datetime_format(outfmt)
    if ik == "EPOCH":
        ms = np.asarray(v).astype(np.int64) * (MILLIS[iu] * isz)
    else:
        ms = rowfn(lambda s: _str_to_ms(s, ipat))(v)
        ms = np.asarray(ms).astype(np.int64)
    gsz, gu = str(gran).split(":")
    g = MILLIS[gu.upper()] * int(gsz)
    ms = (ms // g) * g
    if ok == "EPOCH":
        return ms // (MILLIS[ou] * osz)
    return rowfn(lambda m: _ms_to_str(int(m), opat))(ms)


def _np_substr(s, start, end=None):
    def f(x, st=start, en=end):
        x = _sstr(x)
        st_i = int(st)
        if en is None or int(en) == -1:
            return x[st_i:]
        return x[st_i:int(en)]  # end exclusive (reference substr(col,start,end))

    return rowfn(f)(s)


def _np_strpos(s, sub, instance=1):
    def f(x, sb=None, inst=None):
        x = _sstr(x)
        sb = _sstr(sub if np.ndim(sub) == 0 else sb)
        k = int(instance if np.ndim(instance) == 0 else inst)
        pos = -1
        for _ in range(max(1, k)):
            pos = x.find(sb, pos + 1)
            if pos < 0:
                return -1
        return pos

    return rowfn(f)(s)


def _np_jsonextractscalar(blob, path, rtype="STRING", default=None):
    rtype = str(rtype).upper()

    def f(x):
        try:
            doc = json.loads(x) if isinstance(x, (str, bytes)) else x
            cur = doc
            p = str(path)
            if p.startswith("$"):
                p = p[1:]
            for tok in re.findall(r"\.([^.\[\]]+)|\[(\d+)\]", p):
                key, idx = tok
                cur = cur[int(idx)] if idx else cur[key]
            if cur is None:
                raise KeyError
            if rtype in ("INT", "LONG"):
                return int(cur)
            if rtype in ("FLOAT", "DOUBLE"):
                return float(cur)
            return str(cur)
        except Exception:
            if default is not None:
                return default
            return {"INT": -2147483648, "LONG": -9223372036854775808,
                    "FLOAT": math.inf, "DOUBLE": math.inf}.get(rtype, "null")

    return rowfn(f)(blob)


def _np_mapvalue(blob, key, default=None):
    """mapCol['key'] / mapValue(col, 'key'[, default]) — row-wise parse of
    the JSON/dict map column (reference: MapItemTransformFunction +
    MapFunctions.mapValue). Segments carrying a map index answer indexed
    predicates from dense planes instead (pinot_tpu/segment/map_index.py;
    the port has no map index, so its planner evaluates this over a
    dictionary or raises)."""
    k = str(key)

    def f(x):
        m = _parse_map(x)
        if m is None or k not in m:
            return default
        return m[k]

    return rowfn(f)(blob)


def _np_lookup(table, attr, pk, keys):
    """LOOKUP('dimTable', 'valueColumn', 'pkColumn', factKeyExpr) — the
    dimension-table join UDF (reference: LookupTransformFunction backed by
    DimensionTableDataManager). On the device path this never runs per
    row: the planner evaluates it over the fact column's DICTIONARY grid,
    so the join becomes a gather of a cardinality-sized table by dict id
    (a broadcast join)."""
    t = get_dimension_table(str(table))
    if t is None:
        raise ValueError(f"dimension table {table!r} not registered")
    if str(pk) != t.pk_column:
        raise ValueError(
            f"dim table {table!r} joins on {t.pk_column!r}, not {pk!r}")
    vals, _found = t.lookup(str(attr), np.asarray(keys))
    return vals


def _np_jsonextractkey(blob, path):
    def f(x):
        try:
            doc = json.loads(x) if isinstance(x, (str, bytes)) else x
            return json.dumps(sorted(doc.keys()))
        except Exception:
            return "[]"

    return rowfn(f)(blob)


_H = {"md5": hashlib.md5, "sha": hashlib.sha1, "sha256": hashlib.sha256,
      "sha512": hashlib.sha512}


def _hashfn(name):
    def f(x):
        b = x if isinstance(x, bytes) else _sstr(x).encode()
        return _H[name](b).hexdigest()

    return rowfn(f)


def _parse_map(x):
    """A map column's value as a dict (a dict, or a JSON object string),
    else None: the port's copy of pinot_tpu/segment/map_index.py
    `_parse_map`."""
    if isinstance(x, dict):
        return x
    if isinstance(x, (str, bytes)):
        try:
            obj = json.loads(x)
            return obj if isinstance(obj, dict) else None
        except (json.JSONDecodeError, TypeError):
            return None
    return None


_EARTH_RADIUS_M = 6371008.8


def _np_stdistance(lat1, lng1, lat2, lng2):
    """Great-circle distance in meters, the port's copy of
    pinot_tpu/segment/indexes.py `haversine_m`."""
    lat1, lng1, lat2, lng2 = (np.radians(np.asarray(x, dtype=np.float64))
                              for x in (lat1, lng1, lat2, lng2))
    dlat = lat2 - lat1
    dlng = lng2 - lng1
    a = np.sin(dlat / 2) ** 2 + np.cos(lat1) * np.cos(lat2) * np.sin(dlng / 2) ** 2
    return 2 * _EARTH_RADIUS_M * np.arcsin(np.sqrt(np.clip(a, 0, 1)))


def _np_arraylength(v):
    return rowfn(lambda x: len(x) if isinstance(x, (list, tuple, np.ndarray)) else 1)(v)


def _np_cosinedistance(a, b):
    def f(x):
        x = np.asarray(x, dtype=np.float64)
        y = np.asarray(b, dtype=np.float64)
        denom = np.linalg.norm(x) * np.linalg.norm(y)
        return 1.0 - float(x @ y) / denom if denom else 1.0

    return rowfn(f)(a)


TRANSFORMS: dict[str, TransformDef] = {
    # -- geo (reference: pinot-core/.../geospatial/transform/; the point
    # type is a (lat, lng) column pair here, not WKB bytes) ----------------
    "stdistance": TransformDef(_np_stdistance),
    "distance": TransformDef(_np_stdistance),
    # -- vector scalar fns (reference VectorFunctions) ----------------------
    "cosinedistance": TransformDef(_np_cosinedistance),
    # "arraylength" is the array (MV) function registered below
    "vectordims": TransformDef(_np_arraylength),
    # -- math ---------------------------------------------------------------
    "round": TransformDef(_np_round, _lower_round),
    "rounddecimal": TransformDef(_np_rounddecimal, _lower_rounddecimal),
    "truncate": TransformDef(_np_truncate, _lower_truncate),
    "cbrt": TransformDef(lambda x: np.cbrt(np.asarray(x, dtype=np.float64)),
                         lambda B, a: ir.Bin("pow", B.v(a[0]), B.c(1.0 / 3.0))),
    "sin": TransformDef(np.sin), "cos": TransformDef(np.cos), "tan": TransformDef(np.tan),
    "asin": TransformDef(np.arcsin), "acos": TransformDef(np.arccos),
    "atan": TransformDef(np.arctan),
    "atan2": TransformDef(np.arctan2),
    "sinh": TransformDef(np.sinh), "cosh": TransformDef(np.cosh),
    "tanh": TransformDef(np.tanh),
    "degrees": TransformDef(np.degrees), "radians": TransformDef(np.radians),
    "log": TransformDef(np.log),
    # -- datetime extraction (device = civil-date int arithmetic) -----------
    "year": TransformDef(_np_year, _lower_extract("year")),
    "month": TransformDef(_np_month, _lower_extract("month")),
    "monthofyear": TransformDef(_np_month, _lower_extract("month")),
    "quarter": TransformDef(_np_quarter, _lower_extract("quarter")),
    "day": TransformDef(_np_day, _lower_extract("day")),
    "dayofmonth": TransformDef(_np_day, _lower_extract("day")),
    "dayofweek": TransformDef(_np_dayofweek, _lower_extract("dayofweek")),
    "dow": TransformDef(_np_dayofweek, _lower_extract("dayofweek")),
    "dayofyear": TransformDef(_np_dayofyear, _lower_extract("dayofyear")),
    "doy": TransformDef(_np_dayofyear, _lower_extract("dayofyear")),
    "hour": TransformDef(lambda ms: (np.asarray(ms).astype(np.int64) // 3_600_000) % 24,
                         _lower_extract("hour")),
    "minute": TransformDef(lambda ms: (np.asarray(ms).astype(np.int64) // 60_000) % 60,
                           _lower_extract("minute")),
    "second": TransformDef(lambda ms: (np.asarray(ms).astype(np.int64) // 1000) % 60,
                           _lower_extract("second")),
    "millisecond": TransformDef(lambda ms: np.asarray(ms).astype(np.int64) % 1000,
                                _lower_extract("millisecond")),
    "week": TransformDef(_np_week),
    "weekofyear": TransformDef(_np_week),
    "yearofweek": TransformDef(_np_yearofweek),
    "yow": TransformDef(_np_yearofweek),
    # -- epoch conversions --------------------------------------------------
    "toepochseconds": TransformDef(
        lambda v: np.asarray(v).astype(np.int64) // 1000, _lower_scale(1000, False)),
    "toepochminutes": TransformDef(
        lambda v: np.asarray(v).astype(np.int64) // 60_000, _lower_scale(60_000, False)),
    "toepochhours": TransformDef(
        lambda v: np.asarray(v).astype(np.int64) // 3_600_000, _lower_scale(3_600_000, False)),
    "toepochdays": TransformDef(
        lambda v: np.asarray(v).astype(np.int64) // 86_400_000, _lower_scale(86_400_000, False)),
    "fromepochseconds": TransformDef(
        lambda v: np.asarray(v).astype(np.int64) * 1000, _lower_scale(1000, True)),
    "fromepochminutes": TransformDef(
        lambda v: np.asarray(v).astype(np.int64) * 60_000, _lower_scale(60_000, True)),
    "fromepochhours": TransformDef(
        lambda v: np.asarray(v).astype(np.int64) * 3_600_000, _lower_scale(3_600_000, True)),
    "fromepochdays": TransformDef(
        lambda v: np.asarray(v).astype(np.int64) * 86_400_000, _lower_scale(86_400_000, True)),
    "toepochsecondsrounded": TransformDef(
        lambda v, n: (np.asarray(v).astype(np.int64) // 1000 // int(n)) * int(n),
        _lower_epoch_rounded(1000, False)),
    "toepochminutesrounded": TransformDef(
        lambda v, n: (np.asarray(v).astype(np.int64) // 60_000 // int(n)) * int(n),
        _lower_epoch_rounded(60_000, False)),
    "toepochhoursrounded": TransformDef(
        lambda v, n: (np.asarray(v).astype(np.int64) // 3_600_000 // int(n)) * int(n),
        _lower_epoch_rounded(3_600_000, False)),
    "toepochdaysrounded": TransformDef(
        lambda v, n: (np.asarray(v).astype(np.int64) // 86_400_000 // int(n)) * int(n),
        _lower_epoch_rounded(86_400_000, False)),
    "toepochsecondsbucket": TransformDef(
        lambda v, n: np.asarray(v).astype(np.int64) // 1000 // int(n),
        _lower_epoch_rounded(1000, True)),
    "toepochminutesbucket": TransformDef(
        lambda v, n: np.asarray(v).astype(np.int64) // 60_000 // int(n),
        _lower_epoch_rounded(60_000, True)),
    "toepochhoursbucket": TransformDef(
        lambda v, n: np.asarray(v).astype(np.int64) // 3_600_000 // int(n),
        _lower_epoch_rounded(3_600_000, True)),
    "toepochdaysbucket": TransformDef(
        lambda v, n: np.asarray(v).astype(np.int64) // 86_400_000 // int(n),
        _lower_epoch_rounded(86_400_000, True)),
    "fromepochsecondsbucket": TransformDef(
        lambda v, n: np.asarray(v).astype(np.int64) * 1000 * int(n),
        _lower_from_epoch_bucket(1000)),
    "fromepochminutesbucket": TransformDef(
        lambda v, n: np.asarray(v).astype(np.int64) * 60_000 * int(n),
        _lower_from_epoch_bucket(60_000)),
    "fromepochhoursbucket": TransformDef(
        lambda v, n: np.asarray(v).astype(np.int64) * 3_600_000 * int(n),
        _lower_from_epoch_bucket(3_600_000)),
    "fromepochdaysbucket": TransformDef(
        lambda v, n: np.asarray(v).astype(np.int64) * 86_400_000 * int(n),
        _lower_from_epoch_bucket(86_400_000)),
    "datetrunc": TransformDef(
        lambda unit, v, *rest: (
            _np_datetrunc(unit, np.asarray(v).astype(np.int64)
                          * MILLIS[str(rest[0]).upper()])
            // MILLIS[str(rest[0]).upper()]
        ) if rest else _np_datetrunc(unit, v),
        _lower_datetrunc),
    "timeconvert": TransformDef(
        lambda v, a, b: np.asarray(v).astype(np.int64) * MILLIS[str(a).upper()]
        // MILLIS[str(b).upper()],
        _lower_timeconvert),
    "datetimeconvert": TransformDef(_np_datetimeconvert, _lower_datetimeconvert),
    # gapfill markers: identity of arg0 during execution; the broker
    # reduce reads the other literals (engine/gapfill.py)
    "gapfill": TransformDef(lambda x, *rest: x, lambda B, a: B.v(a[0])),
    "fill": TransformDef(lambda x, *rest: x, lambda B, a: B.v(a[0])),
    "timestampadd": TransformDef(_np_timestampadd, _lower_timestampadd),
    "dateadd": TransformDef(_np_timestampadd, _lower_timestampadd),
    "timestampdiff": TransformDef(_np_timestampdiff, _lower_timestampdiff),
    "datediff": TransformDef(_np_timestampdiff, _lower_timestampdiff),
    "todatetime": TransformDef(rowfn(lambda ms, p: _ms_to_str(int(ms), p))),
    "fromdatetime": TransformDef(rowfn(lambda s, p: _str_to_ms(s, p))),
    # -- string -------------------------------------------------------------
    "upper": TransformDef(rowfn(lambda s: _sstr(s).upper())),
    "lower": TransformDef(rowfn(lambda s: _sstr(s).lower())),
    "reverse": TransformDef(rowfn(lambda s: _sstr(s)[::-1])),
    "substr": TransformDef(_np_substr),
    "substring": TransformDef(_np_substr),
    "concat": TransformDef(rowfn(
        lambda a, b, sep="": f"{_sstr(a)}{_sstr(sep)}{_sstr(b)}")),
    "trim": TransformDef(rowfn(lambda s: _sstr(s).strip())),
    "ltrim": TransformDef(rowfn(lambda s: _sstr(s).lstrip())),
    "rtrim": TransformDef(rowfn(lambda s: _sstr(s).rstrip())),
    "length": TransformDef(rowfn(lambda s: len(_sstr(s)))),
    "strpos": TransformDef(_np_strpos),
    "startswith": TransformDef(rowfn(lambda s, p: _sstr(s).startswith(_sstr(p)))),
    "endswith": TransformDef(rowfn(lambda s, p: _sstr(s).endswith(_sstr(p)))),
    "contains": TransformDef(rowfn(lambda s, p: _sstr(p) in _sstr(s))),
    "replace": TransformDef(rowfn(lambda s, a, b: _sstr(s).replace(_sstr(a), _sstr(b)))),
    "lpad": TransformDef(rowfn(lambda s, n, p: _sstr(s).rjust(int(n), _sstr(p)))),
    "rpad": TransformDef(rowfn(lambda s, n, p: _sstr(s).ljust(int(n), _sstr(p)))),
    "codepoint": TransformDef(rowfn(lambda s: ord(_sstr(s)[0]) if _sstr(s) else 0)),
    "chr": TransformDef(rowfn(lambda c: chr(int(c)))),
    "ascii": TransformDef(rowfn(lambda s: ord(_sstr(s)[0]) if _sstr(s) else 0)),
    "repeat": TransformDef(rowfn(
        lambda s, n, sep="": _sstr(sep).join([_sstr(s)] * int(n)))),
    "remove": TransformDef(rowfn(lambda s, r: _sstr(s).replace(_sstr(r), ""))),
    "splitpart": TransformDef(rowfn(
        lambda s, sep, i: (_sstr(s).split(_sstr(sep)) + ["null"])[int(i)]
        if int(i) < len(_sstr(s).split(_sstr(sep))) else "null")),
    "regexpextract": TransformDef(rowfn(
        lambda s, pat, group=0, default="": (
            (lambda m: m.group(int(group)) if m else _sstr(default))
            (re.search(str(pat), _sstr(s)))))),
    "regexpreplace": TransformDef(rowfn(
        lambda s, pat, rep: re.sub(str(pat), _sstr(rep), _sstr(s)))),
    "urlencode": TransformDef(rowfn(lambda s: urllib.parse.quote_plus(_sstr(s)))),
    "urldecode": TransformDef(rowfn(lambda s: urllib.parse.unquote_plus(_sstr(s)))),
    "tobase64": TransformDef(rowfn(
        lambda s: base64.b64encode(s if isinstance(s, bytes) else _sstr(s).encode()).decode())),
    "frombase64": TransformDef(rowfn(lambda s: base64.b64decode(_sstr(s)).decode()))
    ,
    "toutf8": TransformDef(rowfn(lambda s: _sstr(s).encode().hex())),
    "isjson": TransformDef(rowfn(
        lambda s: (lambda: (json.loads(s), True)[1])() if _try_json(s) else False)),
    "strcmp": TransformDef(rowfn(
        lambda a, b: (_sstr(a) > _sstr(b)) - (_sstr(a) < _sstr(b)))),
    "md5": TransformDef(_hashfn("md5")),
    "sha": TransformDef(_hashfn("sha")),
    "sha256": TransformDef(_hashfn("sha256")),
    "sha512": TransformDef(_hashfn("sha512")),
    "crc32": TransformDef(rowfn(
        lambda s: zlib.crc32(s if isinstance(s, bytes) else _sstr(s).encode()))),
    # -- lookup join --------------------------------------------------------
    "lookup": TransformDef(_np_lookup),
    # -- map ----------------------------------------------------------------
    "mapvalue": TransformDef(_np_mapvalue),
    "map_value": TransformDef(_np_mapvalue),
    "item": TransformDef(_np_mapvalue),
    # -- json ---------------------------------------------------------------
    "jsonextractscalar": TransformDef(_np_jsonextractscalar),
    "jsonextractkey": TransformDef(_np_jsonextractkey),
    "jsonformat": TransformDef(rowfn(
        lambda x: json.dumps(x) if not isinstance(x, str) else json.dumps(json.loads(x)))),
    "json_format": TransformDef(rowfn(
        lambda x: json.dumps(x) if not isinstance(x, str) else json.dumps(json.loads(x)))),
    # -- array (MV) ---------------------------------------------------------
    "arraylength": TransformDef(rowfn(lambda a: len(a)), mv_arg=True),
    "cardinality": TransformDef(rowfn(lambda a: len(a)), mv_arg=True),
    "arraymin": TransformDef(rowfn(lambda a: min(a) if len(a) else math.inf), mv_arg=True),
    "arraymax": TransformDef(rowfn(lambda a: max(a) if len(a) else -math.inf), mv_arg=True),
    "arraysum": TransformDef(rowfn(lambda a: sum(a)), mv_arg=True),
    "arrayaverage": TransformDef(rowfn(
        lambda a: sum(a) / len(a) if len(a) else math.nan), mv_arg=True),
    "arraydistinctcount": TransformDef(rowfn(lambda a: len(set(a))), mv_arg=True),
}


def _try_json(s):
    try:
        json.loads(s)
        return True
    except Exception:
        return False


def get_transform(name: str) -> Optional[TransformDef]:
    return TRANSFORMS.get(name)


# ---------------------------------------------------------------------------
# generic numpy expression evaluator (dictionary transforms, selections)
# ---------------------------------------------------------------------------

NP_BIN = {
    "plus": np.add, "minus": np.subtract, "times": np.multiply,
    "divide": lambda a, b: np.true_divide(a, b, where=np.asarray(b) != 0,
                                          out=np.full(np.broadcast(a, b).shape, np.nan)),
    "mod": np.mod, "pow": np.power, "power": np.power,
    "equals": lambda a, b: a == b, "notequals": lambda a, b: a != b,
    "lessthan": lambda a, b: a < b, "lessthanorequal": lambda a, b: a <= b,
    "greaterthan": lambda a, b: a > b, "greaterthanorequal": lambda a, b: a >= b,
    "and": np.logical_and, "or": np.logical_or,
    "least": np.minimum, "greatest": np.maximum,
}

NP_UN = {
    "neg": np.negative, "abs": np.abs, "not": np.logical_not, "exp": np.exp,
    "ln": np.log, "log10": np.log10, "log2": np.log2, "sqrt": np.sqrt,
    "ceiling": np.ceil, "ceil": np.ceil, "floor": np.floor, "sign": np.sign,
}


def np_cast(v, to: str):
    to = to.upper()
    v = np.asarray(v)
    if to == "INT":
        return v.astype(np.float64).astype(np.int32) if v.dtype.kind == "f" else v.astype(np.int32)
    if to in ("LONG", "TIMESTAMP"):
        return v.astype(np.float64).astype(np.int64) if v.dtype.kind == "f" else v.astype(np.int64)
    if to == "FLOAT":
        return v.astype(np.float32)
    if to == "DOUBLE":
        return v.astype(np.float64)
    if to == "BOOLEAN":
        return v.astype(bool)
    if to == "STRING":
        return rowfn(lambda x: _fmt_str(x))(v)
    return v


def _fmt_str(x):
    if isinstance(x, (float, np.floating)):
        return repr(float(x))
    if isinstance(x, (bool, np.bool_)):
        return "true" if x else "false"
    if isinstance(x, np.generic):
        return str(x.item())
    return str(x)


def eval_expr_np(e, resolve: Callable[[str], object]):
    """Evaluate an ExpressionContext with numpy semantics. ``resolve(name)``
    returns the values for an identifier (ndarray or scalar). Literals stay
    python scalars so string functions receive clean arguments."""
    if e.is_literal:
        v = e.literal
        return int(v) if isinstance(v, bool) else v
    if e.is_identifier:
        return resolve(e.identifier)
    fn = e.function
    name, args = fn.name, fn.arguments
    if name in NP_BIN:
        return NP_BIN[name](eval_expr_np(args[0], resolve), eval_expr_np(args[1], resolve))
    if name in NP_UN:
        return NP_UN[name](eval_expr_np(args[0], resolve))
    if name == "cast":
        return np_cast(eval_expr_np(args[0], resolve), str(args[1].literal))
    if name == "case":
        out = eval_expr_np(args[-1], resolve)
        for i in range(len(args) - 3, -1, -2):
            cond = np.asarray(eval_expr_np(args[i], resolve)).astype(bool)
            out = np.where(cond, eval_expr_np(args[i + 1], resolve), out)
        return out
    if name == "coalesce":
        # per-doc nullness is not representable in dictionary-value space;
        # callers with null planes (plan.value_expr / host eval_value) handle
        # coalesce themselves — refuse here so they fall back correctly
        raise UnsupportedQueryError("coalesce needs null planes")
    td = get_transform(name)
    if td is not None:
        return td.eval_np(*[eval_expr_np(a, resolve) for a in args])
    raise UnsupportedQueryError(f"transform function {name}")


def eval_scalar(name: str, args: list):
    """Scalar form for post-aggregation/HAVING (engine/reduce.py)."""
    td = get_transform(name)
    if td is None:
        raise UnsupportedQueryError(f"post-aggregation function {name}")
    out = td.eval_np(*args)
    if isinstance(out, np.generic):
        return out.item()
    return out


def np_evaluable(e) -> bool:
    """Whether eval_expr_np evaluates `e`: every function in it is
    arithmetic, a comparison, unary math, CAST, CASE or a registered
    transform (COALESCE needs null planes, so it is not)."""
    if not e.is_function:
        return True
    name = e.function.name
    if name not in NP_BIN and name not in NP_UN \
            and name not in ("cast", "case") and name not in TRANSFORMS:
        return False
    return all(np_evaluable(a) for a in e.function.arguments)
