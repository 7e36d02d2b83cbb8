"""The port's soak sql suite (pinot_tpu_torch/tools/soak.py) against the
JAX package's (pinot_tpu/tools/soak.py), on the CPU.

The seeded generator makes the JAX generator's SQL and oracle SQL step for
step; the port's host engine (QueryExecutor backend "host") gives the JAX
host engine's rows on the generated statements; soak_sql passes with and
without device parity (backend "auto" against the host engine); and an
error the port's engine raises (the reference returns it in the
response) surfaces as the SoakFailure that names the SQL.
"""

from __future__ import annotations

import pytest
import torch

from pinot_tpu.tools import soak as jax_soak
from pinot_tpu_torch.tools import soak

ROWS = 400


@pytest.fixture(autouse=True)
def _caches_off(monkeypatch):
    # both packages' segment partial caches are process-wide: a repeat
    # would serve partials instead of running the engines compared here
    monkeypatch.setenv("PINOT_TPU_SEGMENT_CACHE", "0")
    monkeypatch.setenv("PINOT_TPU_RESULT_CACHE", "0")


def _pair(seed: int):
    port = soak._SqlSoak(seed, rows=ROWS, device_parity=False, device="cpu")
    ref = jax_soak._SqlSoak(seed, rows=ROWS, device_parity=False)
    return port, ref


@pytest.mark.parametrize("seed", [0, 7, 20260731])
def test_generator_matches_jax_step_for_step(seed):
    port, ref = _pair(seed)
    try:
        for step in range(200):
            assert port._gen() == ref._gen(), f"seed {seed}, step {step}"
    finally:
        port.close()
        ref.close()


def test_generator_limit_never_truncates_a_large_table():
    """Past 4,500 rows a row-returning shape's LIMIT follows the table's
    rows (the oracle's SQL has none); below, it is the reference's."""
    small = soak._SqlSoak(1, rows=ROWS, device_parity=False, device="cpu")
    big = soak._SqlSoak(1, rows=6000, device_parity=False, device="cpu")
    try:
        assert (small.limit, small.set_limit) == (" LIMIT 5000", " LIMIT 9000")
        assert (big.limit, big.set_limit) == (" LIMIT 6000", " LIMIT 12000")
    finally:
        small.close()
        big.close()


def test_host_engine_rows_equal_jax_host_engine():
    port, ref = _pair(3)
    try:
        for step in range(60):
            sql, oracle_sql, _ = port._gen()
            ref._gen()  # keep the two generators in step
            got = soak._canon(port.qe.execute_sql(sql).result_table.rows)
            resp = ref.qe.execute_sql(sql)
            assert not resp.exceptions, (sql, resp.exceptions)
            want = soak._canon(resp.result_table.rows)
            assert got == want, (step, sql, got[:4], want[:4])
            oracle = soak._canon(port.oracle.execute(oracle_sql).fetchall())
            assert soak._rows_equal(got, oracle), (step, sql)
    finally:
        port.close()
        ref.close()


def test_canon_orders_rows_that_tie_on_the_rounded_key():
    """Rows that differ only past the second decimal of a float sort by
    their exact values, whatever order each side returned them in."""
    a = [("x", 1, 99.998), ("x", 1, 99.999)]
    assert soak._canon(a) == soak._canon(a[::-1])
    assert soak._rows_equal(soak._canon(a), soak._canon(a[::-1]))


@pytest.mark.parametrize("device_parity", [False, True])
def test_soak_sql_passes(device_parity):
    out = soak.soak_sql(seconds=60.0, seed=11, rows=ROWS,
                        device_parity=device_parity, max_checks=40,
                        device="cpu")
    ref = jax_soak.soak_sql(seconds=60.0, seed=11, rows=ROWS,
                            device_parity=False, max_checks=2)
    assert out["checks"] >= 40, out
    # the reference's keys plus the device side's dispatches and latency
    assert set(out) - set(ref) == {"device_dispatches", "device_p50_ms",
                                   "device_p99_ms"}
    assert set(ref) <= set(out)
    if device_parity:
        assert out["device_dispatches"] > 0
        assert 0 < out["device_p50_ms"] <= out["device_p99_ms"]
    else:
        assert out["device_dispatches"] == 0 and out["device_p50_ms"] is None


def test_soak_sql_defaults_to_the_card():
    """device defaults to "cuda"; without a card construction raises, no
    suite falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default does not raise")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        soak.soak_sql(seconds=1.0, rows=100, max_checks=1)


@pytest.mark.parametrize("side", ["engine", "device"])
def test_raised_error_surfaces_as_soak_failure(monkeypatch, side):
    """The port's single-stage engine raises where the reference returns
    the response's exceptions; the step names the SQL either way."""
    s = soak._SqlSoak(5, rows=ROWS, device_parity=True, device="cpu")
    sql = "SELECT SUM(nosuch) FROM fz"
    try:
        if side == "engine":
            # the port raises; the reference answers with the exception
            with pytest.raises(KeyError):
                s.qe.execute_sql(sql)
            ref = jax_soak._SqlSoak(5, rows=ROWS, device_parity=False)
            try:
                assert ref.qe.execute_sql(sql).exceptions
            finally:
                ref.close()
            monkeypatch.setattr(s, "_gen", lambda: (sql, sql, True))
        else:
            # the host side answers; the device side's engine raises
            good = "SELECT COUNT(*) FROM fz"
            monkeypatch.setattr(s, "_gen", lambda: (good, good, True))

            def boom(q):
                raise RuntimeError(f"kernel failed on {q}")

            monkeypatch.setattr(s.qe_dev, "execute_sql", boom)
            sql = good
        with pytest.raises(soak.SoakFailure) as err:
            s.step()
        assert f"{side} error" in str(err.value)
        assert sql in str(err.value)
    finally:
        s.close()
