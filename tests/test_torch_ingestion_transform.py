"""The row transform pipeline of the port (pinot_tpu_torch/ingestion/
transform.py) against the JAX package's, transformer by transformer and as
the pipeline `build_transform_pipeline` assembles.

Seeded rows carry what a stream delivers: nested objects (flattened to
dotted columns), numbers as strings, unparseable values (to null), NaN and
infinities in float columns (to null), epoch times outside 1971 to 2071
(the row dropped), missing columns (explicit null), multi-value lists, and
rows the filter function drops or whose derived column fails to evaluate.
Each package transforms its own copy of every row; the outputs (or the
drop) are equal. Tolerance: exact (NaN compared as NaN).
"""

from __future__ import annotations

import copy
import math

import numpy as np
import pytest

from pinot_tpu.ingestion import transform as jax_transform
from pinot_tpu.spi.data_types import Schema as JaxSchema
from pinot_tpu.spi.table_config import IngestionConfig as JaxIngestion
from pinot_tpu.spi.table_config import \
    SegmentsValidationConfig as JaxValidation
from pinot_tpu.spi.table_config import TableConfig as JaxTableConfig
from pinot_tpu_torch.ingestion import transform
from pinot_tpu_torch.spi.data_types import Schema
from pinot_tpu_torch.spi.table_config import (IngestionConfig,
                                              SegmentsValidationConfig,
                                              TableConfig)

DIMS = [("name", "STRING"), ("code", "INT"), ("tags", "INT", False),
        ("geo.city", "STRING"), ("geo.zip.code", "STRING"),
        ("day", "LONG"), ("label", "STRING")]
METRICS = [("clicks", "INT"), ("price", "DOUBLE"), ("ratio", "FLOAT")]
DATE_TIMES = [("ts", "LONG")]
TRANSFORMS = [
    {"columnName": "day", "transformFunction": "toEpochDays(ts)"},
    {"columnName": "label", "transformFunction": "concat(name, 'x', '-')"},
]
FILTER = "clicks > 90"


def _schemas():
    kw = dict(dimensions=DIMS, metrics=METRICS, date_times=DATE_TIMES)
    return Schema.build("t", **kw), JaxSchema.build("t", **kw)


def _configs(time_column="ts", transforms=TRANSFORMS, filter_fn=FILTER):
    port = TableConfig(
        table_name="t",
        ingestion=IngestionConfig(transform_configs=transforms,
                                  filter_function=filter_fn),
        validation=SegmentsValidationConfig(time_column_name=time_column))
    jax = JaxTableConfig(
        table_name="t",
        ingestion=JaxIngestion(transform_configs=transforms,
                               filter_function=filter_fn),
        validation=JaxValidation(time_column_name=time_column))
    return port, jax


def _rows(n, seed):
    """Stream rows with every case the transformers handle."""
    rng = np.random.default_rng(seed)
    names = ["ann", "bo", "cy", 7, None]
    out = []
    for i in range(n):
        r = {"name": names[int(rng.integers(len(names)))],
             "code": [int(rng.integers(0, 99)), str(int(rng.integers(0, 99))),
                      "12.0", "oops", None][int(rng.integers(5))],
             "clicks": int(rng.integers(0, 100)),
             "price": [float(rng.normal()), "3.5", float("nan"),
                       float("inf"), float("-inf"), "bad"][
                           int(rng.integers(6))],
             "ratio": float(rng.random()),
             "ts": [1_600_000_000_000 + i * 1000, "1600000000123", 123,
                    4_000_000_000_000, "late", None][int(rng.integers(6))],
             "tags": [[1, 2, 3], 5, ["4", "5"], [], None][
                 int(rng.integers(5))]}
        if rng.random() < 0.5:
            r["geo"] = {"city": f"c{int(rng.integers(5))}",
                        "zip": {"code": str(int(rng.integers(1000)))}}
        if rng.random() < 0.2:
            r["day"] = int(rng.integers(0, 20_000))  # present: not derived
        for k in ("ratio", "tags"):
            if rng.random() < 0.1:
                r.pop(k)  # missing: becomes an explicit null
        out.append(r)
    return out


def _norm(row):
    """A row with NaN replaced by a marker (NaN != NaN)."""
    if row is None:
        return None
    return {k: ("NaN" if isinstance(v, float) and math.isnan(v) else v)
            for k, v in row.items()}


def _run(port_t, jax_t, rows):
    got = [_norm(port_t.transform(copy.deepcopy(r))) for r in rows]
    want = [_norm(jax_t.transform(copy.deepcopy(r))) for r in rows]
    return got, want


def _transformer_pairs():
    schema, jschema = _schemas()
    port_cfg, jax_cfg = _configs()
    T, J = transform, jax_transform
    return {
        "complex_type": (T.ComplexTypeTransformer(),
                         J.ComplexTypeTransformer()),
        "complex_type_delim": (T.ComplexTypeTransformer("_"),
                               J.ComplexTypeTransformer("_")),
        "filter": (T.FilterTransformer(FILTER), J.FilterTransformer(FILTER)),
        "filter_string": (T.FilterTransformer("name = 'bo'"),
                          J.FilterTransformer("name = 'bo'")),
        "expression": (T.ExpressionTransformer(TRANSFORMS),
                       J.ExpressionTransformer(TRANSFORMS)),
        "data_type": (T.DataTypeTransformer(schema),
                      J.DataTypeTransformer(jschema)),
        "null_value": (T.NullValueTransformer(schema),
                       J.NullValueTransformer(jschema)),
        "time_validation": (T.TimeValidationTransformer("ts"),
                            J.TimeValidationTransformer("ts")),
        "time_validation_off": (T.TimeValidationTransformer(None),
                                J.TimeValidationTransformer(None)),
        "special_value": (T.SpecialValueTransformer(schema),
                          J.SpecialValueTransformer(jschema)),
        "pipeline": (T.build_transform_pipeline(schema, port_cfg),
                     J.build_transform_pipeline(jschema, jax_cfg)),
        "pipeline_no_config": (T.build_transform_pipeline(schema),
                               J.build_transform_pipeline(jschema)),
    }


@pytest.mark.parametrize("which", list(_transformer_pairs()))
def test_transformer_equals_jax(which):
    port_t, jax_t = _transformer_pairs()[which]
    rows = _rows(400, seed=11)
    got, want = _run(port_t, jax_t, rows)
    assert got == want


def test_pipeline_keeps_drops_and_derives_like_jax():
    """The pipeline's outcomes on the seeded rows cover every case: rows
    kept and dropped (by the filter and by time validation), derived
    columns evaluated, skipped (already present) and failed (null), values
    coerced and nulled."""
    schema, jschema = _schemas()
    port_cfg, jax_cfg = _configs()
    rows = _rows(400, seed=12)
    got, want = _run(transform.build_transform_pipeline(schema, port_cfg),
                     jax_transform.build_transform_pipeline(jschema,
                                                            jax_cfg), rows)
    assert got == want
    kept = [r for r in got if r is not None]
    assert 0 < len(kept) < len(rows)
    assert any(r["clicks"] > 90 for r in rows)
    assert not any(r["clicks"] > 90 for r in kept)
    assert any(r["day"] is None for r in kept)  # ts missing: derive fails
    assert any(r["label"] == "ann-x" for r in kept)  # derived
    assert any(r["price"] is None for r in kept)  # NaN / inf / "bad"
    assert any(r["geo.city"] is not None for r in kept)
    assert all(set(r) >= {n for n, *_ in DIMS + METRICS + DATE_TIMES}
               for r in kept)


def test_eval_row_expression_equals_jax():
    from pinot_tpu.query.parser.sql import parse_expression_str as jparse
    from pinot_tpu_torch.query.parser.sql import parse_expression_str

    rows = _rows(50, seed=13)
    for text in ("toEpochDays(ts)", "clicks * 2 + 1", "upper(name)"):
        e, je = parse_expression_str(text), jparse(text)
        for r in rows:
            try:
                want = jax_transform.eval_row_expression(je, dict(r))
            except Exception as exc:  # noqa: BLE001 - compare the failure
                with pytest.raises(type(exc)):
                    transform.eval_row_expression(e, dict(r))
                continue
            assert transform.eval_row_expression(e, dict(r)) == want
