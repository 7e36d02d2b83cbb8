"""Column data types and field specs.

TPU-native rethink of the reference's field model
(pinot-spi/.../spi/data/FieldSpec.java, Schema.java:65): every stored column
must lower to a fixed-width dense array for XLA, so the type system is split
into a *logical* type (what SQL sees) and a *stored* dtype (what lands in HBM).
Variable-width logical types (STRING/BYTES/JSON) are always dictionary-encoded
so their device representation is an int32 dict-id plane.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np


class DataType(enum.Enum):
    """Logical column types (reference: pinot-spi/.../spi/data/FieldSpec.java DataType)."""

    INT = "INT"
    LONG = "LONG"
    FLOAT = "FLOAT"
    DOUBLE = "DOUBLE"
    BOOLEAN = "BOOLEAN"
    TIMESTAMP = "TIMESTAMP"  # millis since epoch, stored as LONG
    STRING = "STRING"
    BYTES = "BYTES"
    BIG_DECIMAL = "BIG_DECIMAL"  # stored as STRING-like dictionary for now
    JSON = "JSON"

    @property
    def is_numeric(self) -> bool:
        return self in _NUMERIC

    @property
    def is_integral(self) -> bool:
        return self in (DataType.INT, DataType.LONG, DataType.BOOLEAN, DataType.TIMESTAMP)

    @property
    def numpy_dtype(self) -> np.dtype:
        """The dtype used for host-side storage of raw values of this type."""
        return _NP_DTYPES[self]

    @property
    def is_fixed_width(self) -> bool:
        return self not in (DataType.STRING, DataType.BYTES, DataType.JSON, DataType.BIG_DECIMAL)


_NUMERIC = frozenset(
    {DataType.INT, DataType.LONG, DataType.FLOAT, DataType.DOUBLE, DataType.BOOLEAN, DataType.TIMESTAMP}
)

_NP_DTYPES = {
    DataType.INT: np.dtype(np.int32),
    DataType.LONG: np.dtype(np.int64),
    DataType.FLOAT: np.dtype(np.float32),
    DataType.DOUBLE: np.dtype(np.float64),
    DataType.BOOLEAN: np.dtype(np.int32),  # 0/1; device-friendly
    DataType.TIMESTAMP: np.dtype(np.int64),
    DataType.STRING: np.dtype(object),
    DataType.BYTES: np.dtype(object),
    DataType.BIG_DECIMAL: np.dtype(object),
    DataType.JSON: np.dtype(object),
}

# Default null-replacement values, mirroring FieldSpec.getDefaultNullValue
# (pinot-spi/.../spi/data/FieldSpec.java): metrics default to 0, dimensions to
# type-specific sentinel ("null" for strings, Integer.MIN_VALUE for ints, ...).
DEFAULT_DIMENSION_NULL = {
    DataType.INT: np.int32(np.iinfo(np.int32).min),
    DataType.LONG: np.int64(np.iinfo(np.int64).min),
    DataType.FLOAT: np.float32(np.finfo(np.float32).min),
    DataType.DOUBLE: np.float64(np.finfo(np.float64).min),
    DataType.BOOLEAN: np.int32(0),
    DataType.TIMESTAMP: np.int64(0),
    DataType.STRING: "null",
    DataType.BYTES: b"",
    DataType.BIG_DECIMAL: "0",
    DataType.JSON: "null",
}

DEFAULT_METRIC_NULL = {
    DataType.INT: np.int32(0),
    DataType.LONG: np.int64(0),
    DataType.FLOAT: np.float32(0),
    DataType.DOUBLE: np.float64(0),
    DataType.BOOLEAN: np.int32(0),
    DataType.TIMESTAMP: np.int64(0),
    DataType.STRING: "null",
    DataType.BYTES: b"",
    DataType.BIG_DECIMAL: "0",
    DataType.JSON: "null",
}


class FieldType(enum.Enum):
    DIMENSION = "DIMENSION"
    METRIC = "METRIC"
    DATE_TIME = "DATE_TIME"


@dataclass
class FieldSpec:
    """One column's declaration (reference FieldSpec.java).

    single_value=False marks multi-value (MV) columns; MV device layout is a
    padded 2-D dict-id plane (see segment/builder.py).
    """

    name: str
    data_type: DataType
    field_type: FieldType = FieldType.DIMENSION
    single_value: bool = True
    default_null_value: Any = None
    # DATE_TIME metadata (reference DateTimeFieldSpec): format + granularity.
    format: Optional[str] = None
    granularity: Optional[str] = None
    max_length: int = 512

    def __post_init__(self):
        if isinstance(self.data_type, str):
            self.data_type = DataType(self.data_type)
        if isinstance(self.field_type, str):
            self.field_type = FieldType(self.field_type)
        if self.default_null_value is None:
            table = DEFAULT_METRIC_NULL if self.field_type == FieldType.METRIC else DEFAULT_DIMENSION_NULL
            self.default_null_value = table[self.data_type]

    def to_json(self) -> dict:
        d = {
            "name": self.name,
            "dataType": self.data_type.value,
            "singleValue": self.single_value,
        }
        if self.format:
            d["format"] = self.format
        if self.granularity:
            d["granularity"] = self.granularity
        return d


@dataclass
class Schema:
    """Table schema (reference pinot-spi/.../spi/data/Schema.java:65)."""

    schema_name: str
    fields: dict[str, FieldSpec] = field(default_factory=dict)
    primary_key_columns: list[str] = field(default_factory=list)

    @classmethod
    def build(
        cls,
        name: str,
        dimensions: Optional[list[tuple]] = None,
        metrics: Optional[list[tuple]] = None,
        date_times: Optional[list[tuple]] = None,
        primary_key_columns: Optional[list[str]] = None,
    ) -> "Schema":
        s = cls(schema_name=name, primary_key_columns=primary_key_columns or [])
        for col, dt, *rest in dimensions or []:
            sv = rest[0] if rest else True
            s.add_field(FieldSpec(col, DataType(dt), FieldType.DIMENSION, single_value=sv))
        for col, dt in metrics or []:
            s.add_field(FieldSpec(col, DataType(dt), FieldType.METRIC))
        for col, dt, *rest in date_times or []:
            fmt = rest[0] if rest else "1:MILLISECONDS:EPOCH"
            gran = rest[1] if len(rest) > 1 else "1:MILLISECONDS"
            s.add_field(FieldSpec(col, DataType(dt), FieldType.DATE_TIME, format=fmt, granularity=gran))
        return s

    def add_field(self, spec: FieldSpec) -> None:
        self.fields[spec.name] = spec

    def column_names(self) -> list[str]:
        return list(self.fields)

    def field_spec(self, column: str) -> FieldSpec:
        return self.fields[column]

    def has_column(self, column: str) -> bool:
        return column in self.fields

    def dimension_names(self) -> list[str]:
        return [n for n, f in self.fields.items()
                if f.field_type == FieldType.DIMENSION]

    def metric_names(self) -> list[str]:
        return [n for n, f in self.fields.items()
                if f.field_type == FieldType.METRIC]

    def to_json(self) -> dict:
        return {
            "schemaName": self.schema_name,
            "dimensionFieldSpecs": [f.to_json() for f in self.fields.values() if f.field_type == FieldType.DIMENSION],
            "metricFieldSpecs": [f.to_json() for f in self.fields.values() if f.field_type == FieldType.METRIC],
            "dateTimeFieldSpecs": [f.to_json() for f in self.fields.values() if f.field_type == FieldType.DATE_TIME],
            "primaryKeyColumns": self.primary_key_columns,
        }

    @classmethod
    def from_json(cls, d: dict) -> "Schema":
        s = cls(schema_name=d.get("schemaName", ""), primary_key_columns=d.get("primaryKeyColumns") or [])
        for f in d.get("dimensionFieldSpecs", []):
            s.add_field(
                FieldSpec(f["name"], DataType(f["dataType"]), FieldType.DIMENSION,
                          single_value=f.get("singleValue", True)))
        for f in d.get("metricFieldSpecs", []):
            s.add_field(FieldSpec(f["name"], DataType(f["dataType"]), FieldType.METRIC))
        for f in d.get("dateTimeFieldSpecs", []):
            s.add_field(
                FieldSpec(f["name"], DataType(f["dataType"]), FieldType.DATE_TIME,
                          format=f.get("format"), granularity=f.get("granularity")))
        return s


def coerce_value(v, dt: DataType):
    """Canonical value -> declared-type coercion (the JAX package's
    `spi/data_types.py` `coerce_value`), used by the mutable segment.
    Raises TypeError/ValueError on unparseable input."""
    if dt in (DataType.INT, DataType.LONG, DataType.TIMESTAMP):
        return int(float(v)) if isinstance(v, str) else int(v)
    if dt in (DataType.FLOAT, DataType.DOUBLE):
        return float(v)
    if dt == DataType.BOOLEAN:
        if isinstance(v, str):
            return int(v.strip().lower() in ("true", "1", "yes"))
        return int(bool(v))
    if dt == DataType.STRING:
        return v if isinstance(v, str) else str(v)
    if dt == DataType.BYTES:
        return v if isinstance(v, bytes) else bytes(str(v), "utf-8")
    return v
