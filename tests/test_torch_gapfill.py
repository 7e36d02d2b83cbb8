"""GAPFILL in the port's broker reduce, against the JAX package.

The cases of tests/test_gapfill.py (reference: the GapfillProcessor tests
of pinot-core/src/test/.../query/reduce/) on one seeded segment: the
port's `QueryExecutor(device="cpu")` against the JAX package's
`QueryExecutor(backend="tpu")` (its Pallas kernels interpreted, its caches
on). Rows, in order, equal the reference's: the filled buckets of every
series with FILL_PREVIOUS_VALUE, FILL_DEFAULT_VALUE and null fills,
OFFSET/LIMIT after filling, and a query without gapfill untouched.
"""

from __future__ import annotations

import numpy as np
import pytest

from pinot_tpu.cache.partial import GLOBAL_PARTIAL_CACHE as JAX_PARTIALS
from pinot_tpu.engine.query_executor import QueryExecutor as JaxQueryExecutor
from pinot_tpu.segment.loader import load_segment as jax_load
from pinot_tpu.spi.data_types import Schema as JaxSchema
from pinot_tpu_torch.engine.gapfill import apply_gapfill, extract_gapfill
from pinot_tpu_torch.engine.query_executor import QueryExecutor
from pinot_tpu_torch.engine.results import DataSchema, ResultTable
from pinot_tpu_torch.query.parser.sql import parse_sql
from pinot_tpu_torch.segment.builder import SegmentBuilder
from pinot_tpu_torch.segment.loader import load_segment
from pinot_tpu_torch.spi.data_types import Schema

T0 = 1_600_002_000_000  # a multiple of HOUR: round(ts, HOUR) is on the grid
HOUR = 3_600_000
DIMS = [("device", "STRING"), ("ts", "LONG")]
METRICS = [("v", "INT")]
BUCKET = f"round(ts, {HOUR})"


def _gapfill(hours):
    return f"gapfill({BUCKET}, '{T0}', '{T0 + hours * HOUR}', '{HOUR}')"


SQL = (f"SELECT {_gapfill(5)}, device, fill(SUM(v), 'FILL_PREVIOUS_VALUE') "
       f"FROM metrics GROUP BY {_gapfill(5)}, device LIMIT 100")
DEFAULT_SQL = (f"SELECT {_gapfill(3)}, device, fill(SUM(v), "
               f"'FILL_DEFAULT_VALUE'), COUNT(*) FROM metrics "
               f"GROUP BY {_gapfill(3)}, device LIMIT 100")
PLAIN_SQL = (f"SELECT {BUCKET}, device, SUM(v) FROM metrics "
             f"GROUP BY {BUCKET}, device LIMIT 100")


@pytest.fixture(autouse=True)
def _reference_caches_on(monkeypatch):
    monkeypatch.setenv("PINOT_TPU_SEGMENT_CACHE", "1")
    monkeypatch.setenv("PINOT_TPU_MESH_DEVICES", "1")
    monkeypatch.setenv("PINOT_TPU_FUSED", "interpret")
    JAX_PARTIALS.clear()
    yield
    JAX_PARTIALS.clear()


@pytest.fixture(scope="module")
def table(tmp_path_factory):
    """Device A has rows in hours 0, 1 and 3, device B in hours 0 and 2:
    over hours 0 to 4, gaps at A 2, 4 and B 1, 3, 4."""
    rows = [("A", h, v) for h, v in [(0, 10), (1, 11), (3, 13)]]
    rows += [("B", h, v) for h, v in [(0, 20), (2, 22)]]
    cols = {"device": np.asarray([r[0] for r in rows], dtype=object),
            "ts": np.asarray([T0 + h * HOUR + (60_000 if d == "A" else
                                               120_000)
                              for d, h, _ in rows], dtype=np.int64),
            "v": np.asarray([r[2] for r in rows], dtype=np.int32)}
    path = tmp_path_factory.mktemp("torch_gapfill") / "s0"
    SegmentBuilder(Schema.build("metrics", dimensions=DIMS, metrics=METRICS),
                   segment_name="s0").build(cols, path)
    port = QueryExecutor(device="cpu")
    port.add_table(Schema.build("metrics", dimensions=DIMS, metrics=METRICS),
                   [load_segment(path)])
    jax = JaxQueryExecutor(backend="tpu")
    jax.add_table(JaxSchema.build("metrics", dimensions=DIMS,
                                  metrics=METRICS), [jax_load(path)])
    return port, jax


def _both(table, sql):
    port, jax = table
    want = jax.execute_sql(sql)
    assert not want.exceptions, want.exceptions
    got = port.execute_sql(sql)
    assert got.result_table.rows == want.result_table.rows
    assert got.result_table.schema.to_json() == \
        want.result_table.schema.to_json()
    return got.result_table.rows


def test_gapfill_previous_value(table):
    rows = _both(table, SQL)
    assert len(rows) == 10  # 2 series x 5 buckets
    got = {(r[1], int(r[0])): r[2] for r in rows}
    assert [got[("A", T0 + h * HOUR)] for h in range(5)] == \
        [10, 11, 11, 13, 13]
    assert [got[("B", T0 + h * HOUR)] for h in range(5)] == \
        [20, 20, 22, 22, 22]
    times = [int(r[0]) for r in rows]
    assert times == sorted(times)


def test_gapfill_default_and_null_fill(table):
    rows = _both(table, DEFAULT_SQL)
    assert len(rows) == 6
    got = {(r[1], int(r[0])): (r[2], r[3]) for r in rows}
    assert got[("A", T0 + 2 * HOUR)] == (0, None)
    assert got[("B", T0 + HOUR)][0] == 0


@pytest.mark.parametrize("page", ["LIMIT 4", "LIMIT 3, 4"])
def test_gapfill_paginates_after_filling(table, page):
    rows = _both(table, SQL.replace("LIMIT 100", page))
    assert len(rows) == 4
    skip = 3 if "," in page else 0
    want = [T0, T0, T0 + HOUR, T0 + HOUR, T0 + 2 * HOUR, T0 + 2 * HOUR, T0
            + 3 * HOUR][skip: skip + 4]
    assert [int(r[0]) for r in rows] == want


def test_no_gapfill_function_is_untouched(table):
    assert len(_both(table, PLAIN_SQL)) == 5  # only the observed buckets


def test_extract_and_apply_without_executor():
    """The spec the reduce reads, and the fill over a hand-made table: a
    time finer than the bucket snaps to the grid, two rows in one bucket
    raise."""
    spec = extract_gapfill(parse_sql(SQL))
    assert (spec.time_idx, spec.start, spec.end, spec.bucket) == \
        (0, T0, T0 + 5 * HOUR, HOUR)
    assert spec.series_idxs == [1] and spec.value_idxs == [2]
    assert spec.fill_modes == {2: "FILL_PREVIOUS_VALUE"}
    assert extract_gapfill(parse_sql(PLAIN_SQL)) is None
    schema = DataSchema(["t", "device", "s"], ["LONG", "STRING", "LONG"])
    out = apply_gapfill(ResultTable(schema, [[T0 + 5, "A", 7]]), spec)
    assert out.rows[:2] == [[T0, "A", 7], [T0 + HOUR, "A", 7]]
    with pytest.raises(ValueError, match="multiple rows per bucket"):
        apply_gapfill(ResultTable(schema, [[T0, "A", 1], [T0 + 9, "A", 2]]),
                      spec)
