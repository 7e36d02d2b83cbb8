"""The port's compile registry and family fingerprints against the JAX
package's.

  * Registry parity: both packages' `CompileRegistry` take the same calls
    (cold then warm, unknown keys, preloads, an LRU purge of the key map,
    clock advances that decay the AOT ranking) on one frozen wall clock,
    and their snapshots, totals and `aot_priority` must be equal. The
    port's own entries, `note_first_dispatch` then `note_cold_cost`,
    register a family with no compile and its cold cost in compileMsLast /
    compileMsTotal.
  * `family_fingerprint`: the Program each package's planner makes for
    the same query over the same segment gives the JAX package's digest
    at every padded size, fused variant, LUT metadata and batch size.
  * End to end: the same queries through the port's
    `QueryExecutor(device="cpu")` and the JAX `QueryExecutor(backend=
    "tpu")` under PINOT_TPU_FUSED=interpret, both caches off, give the
    same families (mode, padded, fused, batchSize) with the same
    dispatches each, and `totalDispatches` equals the summed
    numDeviceDispatches. By design the port counts no compile
    (`totalCompiles` 0), and its fused families carry the fused kernel's
    form, "plain" on the CPU, where the JAX package's say "interpret": the
    `fused` axis is the one difference between their fingerprints.
Tolerance: exact.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest

from pinot_tpu.cache.keys import family_fingerprint as jax_family_fp
from pinot_tpu.engine import compile_registry as jreg
from pinot_tpu.engine import executor as jexecutor
from pinot_tpu.engine.plan import SegmentPlanner as JaxPlanner
from pinot_tpu.engine.query_executor import QueryExecutor as JaxQueryExecutor
from pinot_tpu.query.parser.sql import parse_sql as jax_parse
from pinot_tpu.segment.loader import load_segment as jax_load
from pinot_tpu.spi.data_types import Schema as JaxSchema
from pinot_tpu_torch.cache.keys import family_fingerprint
from pinot_tpu_torch.engine import compile_registry as preg
from pinot_tpu_torch.engine import executor as pexecutor
from pinot_tpu_torch.engine.plan import SegmentPlanner
from pinot_tpu_torch.engine.query_executor import QueryExecutor
from pinot_tpu_torch.query.parser.sql import parse_sql
from pinot_tpu_torch.segment.builder import SegmentBuilder
from pinot_tpu_torch.segment.loader import load_segment
from pinot_tpu_torch.spi.data_types import Schema
from pinot_tpu_torch.spi.table_config import IndexingConfig, TableConfig


class _Clock:
    def __init__(self):
        self.t = 1_000_000.0

    def __call__(self):
        return self.t


@pytest.fixture
def clock(monkeypatch):
    c = _Clock()
    for mod in (preg, jreg):
        monkeypatch.setattr(mod, "time", SimpleNamespace(time=c))
    return c


def _both(max_entries: int):
    return (preg.CompileRegistry(max_entries=max_entries),
            jreg.CompileRegistry(max_entries=max_entries))


def _same(port, ref) -> dict:
    assert port.snapshot() == ref.snapshot()
    assert port.totals() == ref.totals()
    assert port.aot_priority() == ref.aot_priority()
    return port.snapshot()


def test_cold_then_warm_equals_jax(clock):
    port, ref = _both(16)
    for reg in (port, ref):
        reg.note_compile(("k1",), 12.0, "fp-1", {"mode": "group_by"})
        reg.note_dispatch(("k1",))
        reg.note_dispatch(("k1",))
    snap = _same(port, ref)
    assert snap["totalDispatches"] == 3 and snap["totalCompiles"] == 1
    assert snap["compiles"][0]["compileMsLast"] == 12.0


def test_unknown_key_is_a_noop_and_unfingerprintable_counts(clock):
    port, ref = _both(16)
    for reg in (port, ref):
        reg.note_dispatch(("never-dispatched",))
        reg.note_compile(("k",), 5.0, None, {})
    snap = _same(port, ref)
    assert snap["compiles"][0]["fingerprint"].startswith(
        "unfingerprintable:")
    assert port.aot_priority() == []


def test_lru_purge_of_the_key_map_equals_jax(clock):
    port, ref = _both(2)
    for reg in (port, ref):
        for k in "abc":
            reg.note_compile((k,), 1.0, f"fp-{k}", {})
            clock.t += 1.0
        reg.note_dispatch(("a",))  # purged key: no resurrection
        reg.note_preloaded(("d",), "fp-d", {"mode": "aggregation"})
        reg.note_dispatch(("d",))
        clock.t -= 3.0
    clock.t += 3.0
    snap = _same(port, ref)
    assert {e["fingerprint"] for e in snap["compiles"]} == \
        {"fp-b", "fp-c", "fp-d"}


def test_ranking_decay_equals_jax(clock):
    """The AOT priority tracks current traffic: a family whose dispatches
    are windows old decays to its bare cost, and a cheaper hot one
    overtakes it, in both packages alike."""
    port, ref = _both(16)
    t0 = clock.t
    for reg in (port, ref):
        clock.t = t0
        reg.note_compile(("old",), 100.0, "fp-old", {})
        for _ in range(50):
            reg.note_dispatch(("old",))
        clock.t += 3 * preg._RECENT_WINDOW_S
        reg.note_compile(("hot",), 10.0, "fp-hot", {})
        for k in range(30):
            clock.t += 1.0
            reg.note_dispatch(("hot",))
    snap = _same(port, ref)
    assert [fp for fp, _, _ in port.aot_priority()] == ["fp-hot", "fp-old"]
    assert dict((fp, s) for fp, s, _ in port.aot_priority())["fp-old"] \
        == 100.0
    assert snap["compiles"][0]["aotScore"] > 100.0
    assert preg._RECENT_WINDOW_S == jreg._RECENT_WINDOW_S


def test_first_dispatch_registers_a_cold_cost_and_no_compile(clock):
    reg = preg.CompileRegistry(max_entries=16)
    reg.note_first_dispatch(("k",), "fp-k", {"mode": "group_by"})
    reg.note_dispatch(("k",))  # a concurrent dispatch before the cost
    reg.note_cold_cost(("k",), 7.5)
    reg.note_cold_cost(("unknown",), 3.0)  # no entry: a no-op
    snap = reg.snapshot()
    ent = snap["compiles"][0]
    assert snap["totalCompiles"] == 0 and ent["compiles"] == 0
    assert ent["compileMsLast"] == ent["compileMsTotal"] == 7.5
    assert snap["totalDispatches"] == 2
    assert reg.aot_priority()[0][:2] == ("fp-k", 7.5 * (1.0 + 2))


def test_describe_family_equals_jax():
    prog = SimpleNamespace(mode="group_by")
    for args in ((8192,), (8192, "interpret", ((1, 2, 3),), 4),
                 (1 << 23, "", (), 2)):
        assert preg.describe_family(prog, *args) == \
            jreg.describe_family(prog, *args)


# -- family fingerprints and the end-to-end family set ------------------------

SCHEMA = Schema.build(
    "crt", dimensions=[("d_year", "INT"), ("p_brand", "INT"),
                       ("s_region", "STRING"), ("lo_orderkey", "INT")],
    metrics=[("lo_revenue", "INT"), ("lo_quantity", "INT")])
ROWS = 3000
QUERIES = [
    "SELECT d_year, p_brand, SUM(lo_revenue), COUNT(*) FROM crt "
    "WHERE lo_quantity < 30 GROUP BY d_year, p_brand LIMIT 50",
    "SET segmentBatch = false; SELECT s_region, SUM(lo_quantity) FROM crt "
    "WHERE d_year < 1996 GROUP BY s_region",
    "SET segmentBatch = false; SELECT p_brand, COUNT(*) FROM crt "
    "WHERE s_region IN ('ASIA', 'EUROPE') GROUP BY p_brand LIMIT 50",
    "SELECT COUNT(*), SUM(lo_revenue), MAX(lo_quantity) FROM crt "
    "WHERE s_region = 'ASIA'",
    "SET sparseGroupBy = true; SELECT lo_orderkey, SUM(lo_revenue) FROM crt "
    "GROUP BY lo_orderkey ORDER BY lo_orderkey LIMIT 20",
    "SELECT d_year, lo_revenue FROM crt WHERE lo_quantity > 45 "
    "ORDER BY lo_revenue DESC LIMIT 5",
    "SELECT s_region, DISTINCTCOUNT(p_brand) FROM crt GROUP BY s_region",
]


@pytest.fixture(scope="module")
def segment_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("crt_segs")
    rng = np.random.default_rng(20261018)
    cfg = TableConfig(table_name="crt", indexing=IndexingConfig(
        no_dictionary_columns=["lo_revenue"]))
    out = []
    for i in range(3):
        n = ROWS + 500 * i
        cols = {"d_year": rng.integers(1992, 1999, n).astype(np.int32),
                "p_brand": rng.integers(0, 40, n).astype(np.int32),
                "s_region": np.asarray(["AMERICA", "ASIA", "EUROPE"],
                                       dtype=object)[rng.integers(0, 3, n)],
                "lo_orderkey": rng.integers(0, 4000, n).astype(np.int32),
                "lo_revenue": rng.integers(1, 600_000, n).astype(np.int32),
                "lo_quantity": rng.integers(1, 51, n).astype(np.int32)}
        SegmentBuilder(SCHEMA, cfg, f"crt_{i}").build(cols, root / f"crt_{i}")
        out.append(str(root / f"crt_{i}"))
    return out


@pytest.fixture
def _env(monkeypatch):
    monkeypatch.setenv("PINOT_TPU_SEGMENT_CACHE", "0")
    monkeypatch.setenv("PINOT_TPU_RESULT_CACHE", "0")
    monkeypatch.setenv("PINOT_TPU_FUSED", "interpret")
    monkeypatch.setenv("PINOT_TPU_MESH_DEVICES", "1")
    monkeypatch.delenv("PINOT_TPU_AOT_CACHE_DIR", raising=False)


@pytest.mark.parametrize("sql", QUERIES)
def test_family_fingerprint_equals_jax(segment_dirs, sql):
    port = SegmentPlanner(parse_sql(sql), load_segment(segment_dirs[0]))
    ref = JaxPlanner(jax_parse(sql), jax_load(segment_dirs[0]))
    pprog, jprog = port.plan().program, ref.plan().program
    assert repr(pprog) == repr(jprog)
    for args in ((4096,), (1 << 23, "interpret", (), 0),
                 (8192, "", ((3, 4, 2),), 0), (8192, "", (), 3)):
        got = family_fingerprint(pprog, *args)
        assert got is not None and got == jax_family_fp(jprog, *args)
    # equal families agree, different ones differ
    assert family_fingerprint(pprog, 4096) != family_fingerprint(pprog, 8192)
    assert family_fingerprint(pprog, 4096, "", (), 2) != \
        family_fingerprint(pprog, 4096, "", (), 3)


def _families(snap: dict, fused_as: dict) -> dict:
    out = {}
    for e in snap["compiles"]:
        f = e["family"]
        key = (f["mode"], f["padded"], fused_as.get(f["fused"], f["fused"]),
               f["batchSize"], f["lutRuns"])
        out[key] = out.get(key, 0) + e["dispatches"]
    return out


def test_family_sets_and_dispatches_equal_jax(segment_dirs, _env):
    port = QueryExecutor(device="cpu")
    port.add_table(SCHEMA, [load_segment(d) for d in segment_dirs])
    ref = JaxQueryExecutor(backend="tpu")
    ref.add_table(JaxSchema.from_json(SCHEMA.to_json()),
                  [jax_load(d) for d in segment_dirs])
    # a fresh process's view in both: no family dispatched yet
    preg.COMPILE_REGISTRY.reset()
    pexecutor._FAMILIES.clear()
    jreg.COMPILE_REGISTRY.reset()
    jexecutor._GUARD._seen.clear()
    summed = {"port": 0, "ref": 0}
    for _ in range(2):
        for sql in QUERIES:
            got, want = port.execute_sql(sql), ref.execute_sql(sql)
            assert got.num_device_dispatches == want.num_device_dispatches
            assert got.num_compiles == 0
            summed["port"] += got.num_device_dispatches
            summed["ref"] += want.num_device_dispatches
    psnap = preg.COMPILE_REGISTRY.snapshot()
    jsnap = jreg.COMPILE_REGISTRY.snapshot()
    assert _families(psnap, {"plain": "interpret"}) == _families(jsnap, {})
    assert psnap["totalDispatches"] == summed["port"] == summed["ref"] \
        == jsnap["totalDispatches"]
    assert psnap["families"] == jsnap["families"]
    assert psnap["totalCompiles"] == 0 and jsnap["totalCompiles"] >= 1
    # every family registered its first dispatch's cold cost, and no other
    assert all(e["compiles"] == 0 and e["compileMsTotal"] ==
               e["compileMsLast"] > 0 for e in psnap["compiles"])
    # the fingerprints agree wherever the fused axis is empty
    plain = lambda s: {e["fingerprint"] for e in s["compiles"]  # noqa: E731
                       if not e["family"]["fused"]}
    assert plain(psnap) == plain(jsnap) != set()
    assert any(e["family"]["fused"] == "plain" for e in psnap["compiles"])


def test_warm_dispatch_walks_no_fingerprint(segment_dirs, _env,
                                            monkeypatch):
    """A family's later dispatches pay a lookup and counter bumps: no
    fingerprint walk (cache/keys.py `canonical_bytes`)."""
    from pinot_tpu_torch.cache import keys

    port = QueryExecutor(device="cpu")
    port.add_table(SCHEMA, [load_segment(d) for d in segment_dirs])
    sql = QUERIES[0]
    port.execute_sql(sql)
    walks = []
    real = keys.canonical_bytes
    monkeypatch.setattr(keys, "canonical_bytes",
                        lambda obj: walks.append(1) or real(obj))
    before = preg.COMPILE_REGISTRY.snapshot()["totalDispatches"]
    resp = port.execute_sql(sql)
    assert walks == []
    assert preg.COMPILE_REGISTRY.snapshot()["totalDispatches"] == \
        before + resp.num_device_dispatches
