"""Row-level ingestion transform pipeline (the port of
pinot_tpu/ingestion/transform.py).

Reference: pinot-segment-local/.../recordtransformer/ (CompositeTransformer
ordering: complex-type flatten -> filter -> expression -> data-type coercion ->
null handling -> sanitization -> time validation) and the scalar-function
registry those expressions call (pinot-common/.../function/). Expressions
evaluate through the shared transform registry (query/transforms.py) so
ingestion-time and query-time semantics are one implementation.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..query.expressions import ExpressionContext
from ..query.parser.sql import parse_expression_str
from ..query.transforms import eval_expr_np
from ..spi.data_types import DataType, Schema, coerce_value


def eval_row_expression(e: ExpressionContext, row: dict):
    """Evaluate an expression against one row dict (scalars in/out)."""

    def resolve(name: str):
        if name not in row:
            raise KeyError(name)
        return row[name]

    out = eval_expr_np(e, resolve)
    if isinstance(out, np.generic):
        return out.item()
    if isinstance(out, np.ndarray):
        return out.tolist()
    return out


class RecordTransformer:
    """transform(row) -> row (possibly mutated) or None to drop it."""

    def transform(self, row: dict) -> Optional[dict]:
        raise NotImplementedError


class ComplexTypeTransformer(RecordTransformer):
    """Flatten nested dicts into dotted column names (reference
    ComplexTypeTransformer default '.' delimiter); lists of scalars pass
    through as MV values."""

    def __init__(self, delimiter: str = "."):
        self.delimiter = delimiter

    def transform(self, row: dict) -> Optional[dict]:
        if not any(isinstance(v, dict) for v in row.values()):
            return row
        out: dict = {}
        for k, v in row.items():
            if isinstance(v, dict):
                for ik, iv in self._flatten(v).items():
                    out[f"{k}{self.delimiter}{ik}"] = iv
            else:
                out[k] = v
        return out

    def _flatten(self, d: dict) -> dict:
        out = {}
        for k, v in d.items():
            if isinstance(v, dict):
                for ik, iv in self._flatten(v).items():
                    out[f"{k}{self.delimiter}{ik}"] = iv
            else:
                out[k] = v
        return out


class FilterTransformer(RecordTransformer):
    """Drops rows where the filter function evaluates true (reference
    FilterTransformer - note the inverted semantics: true = filtered OUT)."""

    def __init__(self, filter_function: str):
        self.expr = parse_expression_str(filter_function)

    def transform(self, row: dict) -> Optional[dict]:
        try:
            drop = bool(eval_row_expression(self.expr, row))
        except Exception:
            drop = False
        return None if drop else row


class ExpressionTransformer(RecordTransformer):
    """Derives columns from transform expressions; skips when the source
    value is already present (reference ExpressionTransformer)."""

    def __init__(self, transform_configs: list[dict]):
        self.derived: list[tuple[str, ExpressionContext]] = [
            (c["columnName"], parse_expression_str(c["transformFunction"]))
            for c in transform_configs or []
        ]

    def transform(self, row: dict) -> Optional[dict]:
        for column, expr in self.derived:
            if row.get(column) is None:
                try:
                    row[column] = eval_row_expression(expr, row)
                except Exception:
                    row[column] = None
        return row


class DataTypeTransformer(RecordTransformer):
    """Coerces values to the schema's declared types; unparseable values
    become None (-> null handling downstream)."""

    def __init__(self, schema: Schema):
        self.schema = schema

    def transform(self, row: dict) -> Optional[dict]:
        for name, spec in self.schema.fields.items():
            v = row.get(name)
            if v is None:
                continue
            try:
                if spec.single_value:
                    row[name] = _coerce(v, DataType(spec.data_type))
                else:
                    vals = v if isinstance(v, (list, tuple)) else [v]
                    row[name] = [_coerce(x, DataType(spec.data_type)) for x in vals]
            except (TypeError, ValueError):
                row[name] = None
        return row


class NullValueTransformer(RecordTransformer):
    """Missing schema columns become explicit None so the segment writer
    records them in the null vector (reference NullValueTransformer)."""

    def __init__(self, schema: Schema):
        self.schema = schema

    def transform(self, row: dict) -> Optional[dict]:
        for name in self.schema.fields:
            if name not in row:
                row[name] = None
        return row


class TimeValidationTransformer(RecordTransformer):
    """Rejects rows whose time value is outside a sane epoch window
    (reference TimeValidationTransformer / TimeUtils.timeValueInValidRange:
    1971-01-01 .. 2071-01-01 millis)."""

    _MIN_MS = 31_536_000_000
    _MAX_MS = 3_187_296_000_000

    def __init__(self, time_column: Optional[str]):
        self.time_column = time_column

    def transform(self, row: dict) -> Optional[dict]:
        if not self.time_column:
            return row
        v = row.get(self.time_column)
        if v is None:
            return row
        try:
            t = int(v)
        except (TypeError, ValueError):
            return None
        return row if self._MIN_MS <= t <= self._MAX_MS else None


class SpecialValueTransformer(RecordTransformer):
    """NaN/Inf float values -> None (reference SpecialValueTransformer)."""

    def __init__(self, schema: Schema):
        self.float_cols = [n for n, s in schema.fields.items()
                           if DataType(s.data_type) in (DataType.FLOAT, DataType.DOUBLE)]

    def transform(self, row: dict) -> Optional[dict]:
        for name in self.float_cols:
            v = row.get(name)
            if isinstance(v, float) and (v != v or v in (float("inf"), float("-inf"))):
                row[name] = None
        return row


class CompositeTransformer(RecordTransformer):
    def __init__(self, transformers: list[RecordTransformer]):
        self.transformers = transformers

    def transform(self, row: dict) -> Optional[dict]:
        for t in self.transformers:
            row = t.transform(row)
            if row is None:
                return None
        return row


_coerce = coerce_value


def build_transform_pipeline(schema: Schema, table_config=None) -> CompositeTransformer:
    """Standard ordering (reference CompositeTransformer.getDefaultTransformers)."""
    ing = getattr(table_config, "ingestion", None)
    val = getattr(table_config, "validation", None)
    ts: list[RecordTransformer] = [ComplexTypeTransformer()]
    if ing is not None and ing.filter_function:
        ts.append(FilterTransformer(ing.filter_function))
    if ing is not None and ing.transform_configs:
        ts.append(ExpressionTransformer(ing.transform_configs))
    ts.append(DataTypeTransformer(schema))
    ts.append(SpecialValueTransformer(schema))
    ts.append(TimeValidationTransformer(val.time_column_name if val else None))
    ts.append(NullValueTransformer(schema))
    return CompositeTransformer(ts)
