"""Short profiles of the port's cluster soak suites on the CPU
(pinot_tpu_torch/tools/soak.py): qps under backend "device" (family
rotation, a fault schedule, a corrupt schedule), chaos, failover,
rebalance, tiered and sentinel.

Each suite's summary has the JAX suite's key set (pinot_tpu/tools/soak.py,
run beside it at a tiny profile), with the deliberate differences listed
in SUMMARY_DIFF. The time-budgeted suites assert counts at most a third of
what the slowest of 5 runs reached here under the tier-1 run's load (six
pytest-xdist workers), so a loaded host does not turn them into a lottery.
"""

from __future__ import annotations

import pytest

from pinot_tpu.tools import soak as jax_soak
from pinot_tpu_torch.tools import soak

# the port's summary keys beyond the reference's, per suite
SUMMARY_DIFF = {"qps": {"device_dispatches"}}


@pytest.fixture(autouse=True)
def _caches_off(monkeypatch):
    # the segment partial cache is process-wide and content-addressed: an
    # earlier run over the same seeded segments would answer every query
    # without a dispatch (the soak's statements turn the result cache off)
    monkeypatch.setenv("PINOT_TPU_SEGMENT_CACHE", "0")


@pytest.fixture(autouse=True)
def _quiet_faults():
    yield
    from pinot_tpu.spi import faults as jax_faults
    from pinot_tpu_torch.spi import faults

    faults.FAULTS.reset()
    jax_faults.FAULTS.reset()


def _same_keys(suite: str, out: dict, ref: dict) -> None:
    assert out["suite"] == ref["suite"] == suite
    assert set(ref) <= set(out), set(ref) - set(out)
    assert set(out) - set(ref) == SUMMARY_DIFF.get(suite, set())


QPS_PROFILES = {
    "families": dict(families=5),
    "faults": dict(fault_rate=0.02),
    "corrupt": dict(corrupt_rate=0.05, families=5),
}


@pytest.fixture
def double_strikes(monkeypatch):
    """Counts the wire corruptions that strike a response whose DataTable
    a datatable.encode corruption already damaged (two strikes, one
    detection)."""
    from pinot_tpu_torch.cluster import datatable, transport

    hits, orig = [0], transport._corrupt_payload

    def wrapper(payload, c):
        if isinstance(payload, dict) and "datatable" in payload:
            try:
                datatable.decode(payload["datatable"])
            except datatable.DataTableError:
                hits[0] += 1
        return orig(payload, c)

    monkeypatch.setattr(transport, "_corrupt_payload", wrapper)
    return hits


@pytest.mark.parametrize("profile", sorted(QPS_PROFILES))
def test_soak_qps_device_backend(profile, double_strikes):
    """Open-loop load over an embedded cluster whose servers run the
    device engine (the reference's "tpu") on the CPU: every full answer
    exact (soak_qps raises otherwise), 0 compiles, every family's answers
    checked; under the corrupt schedule every corrupted response
    detected."""
    knobs = QPS_PROFILES[profile]
    out = soak.soak_qps(seconds=3.0, seed=7, qps=20.0, concurrency=3,
                        n_servers=2, n_segments=3, rows_per_segment=80,
                        backend="device", device="cpu", **knobs)
    ref = jax_soak.soak_qps(seconds=0.5, seed=7, qps=20.0, concurrency=2,
                            n_servers=2, n_segments=3, rows_per_segment=40,
                            **knobs)
    _same_keys("qps", out, ref)
    assert out["backend"] == "device"
    assert out["families"] == knobs.get("families", 1)
    assert out["num_compiles"] == 0
    assert out["queries_ok"] >= 10, out
    assert out["device_dispatches"] > 0, out
    assert out["p50_ms"] is not None and out["p99_ms"] >= out["p50_ms"]
    if "corrupt_rate" in knobs:
        cor = out["corruptions"]
        assert cor["injected"] >= 1
        assert cor["detected"] == cor["injected"] - double_strikes[0], cor


def test_soak_qps_rejects_overload_with_admission():
    out = soak.soak_qps(seconds=2.0, seed=3, qps=60.0, concurrency=6,
                        n_servers=2, n_segments=3, rows_per_segment=60,
                        max_inflight=1, backend="host", device="cpu")
    assert out["queries_ok"] >= 5, out
    assert out["queries_rejected"] == out["rejected_meter"]


def test_soak_chaos():
    out = soak.soak_chaos(seconds=4.0, seed=5, n_servers=3, replication=2,
                          n_segments=4, rows_per_segment=200, device="cpu")
    ref = jax_soak.soak_chaos(seconds=0.5, seed=5, n_servers=3,
                              replication=2, n_segments=2,
                              rows_per_segment=50)
    _same_keys("chaos", out, ref)
    assert out["queries"] >= 10, out
    assert out["kills"] + out["rebalances"] + out["compactions"] >= 1, out


def test_soak_chaos_under_faults_and_corruption():
    knobs = dict(fault_rate=0.05, corrupt_rate=0.05)
    out = soak.soak_chaos(seconds=3.0, seed=5, n_segments=4,
                          rows_per_segment=200, device="cpu", **knobs)
    ref = jax_soak.soak_chaos(seconds=0.5, seed=5, n_segments=2,
                              rows_per_segment=50, **knobs)
    _same_keys("chaos", out, ref)
    assert out["queries"] >= 10, out
    assert out["injected_faults"] >= 1
    assert out["corruptions"]["injected"] >= 1


def test_soak_failover():
    out = soak.soak_failover(seconds=3.0, seed=3, device="cpu")
    ref = jax_soak.soak_failover(seconds=0.5, seed=3)
    _same_keys("failover", out, ref)
    assert out["queries"] >= 5, out
    assert out["published_rows"] >= 50, out
    assert out["store"]["durable"] is True


@pytest.mark.rebalance
def test_soak_rebalance():
    """Server kill/add churn drives the durable actuation loop through at
    least one completed job, faults armed on rebalance.move, while live
    queries stay exact-or-degraded and the end state holds full
    replication (soak_rebalance raises otherwise)."""
    out = soak.soak_rebalance(seconds=4.0, seed=13, n_segments=6,
                              rows_per_segment=150, fault_rate=0.05,
                              device="cpu")
    ref = jax_soak.soak_rebalance(seconds=1.0, seed=13, n_segments=4,
                                  rows_per_segment=50, fault_rate=0.05)
    _same_keys("rebalance", out, ref)
    assert out["queries"] >= 10, out
    assert out["jobs_done"] >= 1, out
    assert out["server_kills"] + out["server_adds"] >= 1, out
    assert out["moves_completed"] >= 1, out


def test_soak_tiered():
    out = soak.soak_tiered(seconds=0.5, seed=1, n_tables=4,
                           segments_per_table=2, rows_per_segment=120,
                           device="cpu")
    ref = jax_soak.soak_tiered(seconds=0.0, seed=1, n_tables=4,
                               segments_per_table=2, rows_per_segment=120)
    _same_keys("tiered", out, ref)
    assert out["exact"] > 0
    assert out["cold_loads"] > 0 and out["evictions"] > 0
    assert out["final_checks"] == 16
    assert out["max_tier_bytes_used"] > 0


def test_soak_sentinel():
    """detect -> pin -> recover on a card-backend server (the CPU here),
    the recovery judged on recovery queries alone."""
    out = soak.soak_sentinel(seconds=20.0, seed=1, device="cpu")
    ref = jax_soak.soak_sentinel(seconds=20.0, seed=1)
    _same_keys("sentinel", out, ref)
    assert out["alerts_fired"] == 1
    assert out["exemplars_pinned"] >= 1
    assert 1 <= out["rounds_to_fire"] <= 12
    assert 1 <= out["rounds_to_clear"] <= 12
