"""The port's realtime soak suite and the soak CLI on the CPU
(pinot_tpu_torch/tools/soak.py), beside the JAX package's.

One committer-crash round commits every row; the device churn keeps every
settle point exact against the host engine and the running aggregate. A
realtime.upload fault fails the port's query with RealtimeUploadError
(the reference answers it on its host engine): the churn counts each
such query in device_faulted_uploads and every settle point stays exact.
The CLI runs with --device cpu, and its --report artifact has the JAX
artifact's top-level keys.
"""

from __future__ import annotations

import json

import pytest

from pinot_tpu.tools import soak as jax_soak
from pinot_tpu_torch.tools import soak


@pytest.fixture(autouse=True)
def _quiet_faults():
    yield
    from pinot_tpu_torch.spi import faults

    faults.FAULTS.reset()


def test_soak_realtime_one_round():
    out = soak.soak_realtime(rounds=1, seed=3, rows_per_round=40,
                             seconds=2.0, device="cpu")
    ref = jax_soak.soak_realtime(rounds=1, seed=3, rows_per_round=40,
                                 seconds=0.5)
    assert set(out) == set(ref)
    assert out["rounds"] == 1
    assert out["device_settles"] >= 1 and out["device_dispatches"] >= 1
    assert out["device_rows"] > 0 and out["device_delta_uploads"] > 0


def test_device_churn_counts_upload_faults():
    """Under a realtime.upload schedule (error, then corrupt) each query
    that fails with RealtimeUploadError counts as a faulted upload, and
    every settle point is still exact against the host engine and the
    running aggregate (_soak_realtime_device raises otherwise)."""
    out = soak._soak_realtime_device(seconds=2.0, seed=9, fault_rate=0.1,
                                     device="cpu")
    ref = jax_soak._soak_realtime_device(seconds=0.5, seed=9, fault_rate=0.1)
    assert set(out) == set(ref)
    assert out["device_faulted_uploads"] >= 1, out
    assert out["device_settles"] >= 1, out


def test_upload_error_without_a_schedule_fails_the_churn():
    """With no fault rate an upload error is a failure, not a faulted
    query."""
    from pinot_tpu_torch.spi import faults

    faults.FAULTS.arm("realtime.upload", kind="error", times=None)
    with pytest.raises(soak.SoakFailure, match="RealtimeUploadError"):
        soak._soak_realtime_device(seconds=1.0, seed=9, device="cpu")


def test_cli_realtime_on_the_cpu(capsys):
    rc = soak.main(["--suite", "realtime", "--rounds", "1", "--seconds",
                    "1", "--quiet", "--device", "cpu"])
    assert rc == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["ok"] is True
    assert summary["results"][0]["suite"] == "realtime"


def test_cli_report_artifact(tmp_path, capsys):
    """--report writes the run artifact with the JAX artifact's top-level
    keys: per-suite results, the per-role metrics snapshots, the broker's
    cost reports and the closing anomaly list."""
    port_path, jax_path = tmp_path / "port.json", tmp_path / "jax.json"
    rc = soak.main(["--suite", "chaos", "--seconds", "2", "--quiet",
                    "--device", "cpu", "--report", str(port_path)])
    jax_rc = jax_soak.main(["--suite", "chaos", "--seconds", "0.5",
                            "--quiet", "--report", str(jax_path)])
    capsys.readouterr()
    assert rc == jax_rc == 0
    report = json.loads(port_path.read_text())
    ref = json.loads(jax_path.read_text())
    assert set(report) == set(ref)
    assert report["ok"] is True and report["schemaVersion"] == 1
    assert set(report["metrics"]) == {"server", "broker", "controller"}
    assert report["metrics"]["broker"]["timers"][
        "queryProcessingTimeMs"]["count"] > 0
    assert "stats" in report["costReports"]["chaos"]["tables"]
    assert isinstance(report["anomalies"], list)
    assert report["results"][0]["fleet"]["serversReachable"] >= 1
    # the port's config adds its device to the reference's
    assert set(report["config"]) - set(ref["config"]) == {"device"}
    assert report["config"]["device"] == "cpu"


def test_cli_backend_choices():
    with pytest.raises(SystemExit):
        soak.main(["--suite", "qps", "--backend", "tpu", "--device", "cpu"])
