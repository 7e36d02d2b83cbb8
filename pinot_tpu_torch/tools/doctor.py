"""GPU doctor: a supervised probe of the card with root-cause triage.

The port of pinot_tpu/tools/doctor.py for the CUDA path. The probe runs in
a child process that arms ``faulthandler.dump_traceback_later`` BEFORE
importing torch or touching ``torch.cuda``: a probe that wedges in driver
initialisation, the kernel build or a launch still leaves a stack dump on
stderr, because the watchdog thread fires from outside the stuck thread
and exits the child. The child checks the card (present, compute
capability 9.0), builds both hand-written kernels from the checkout's
sources (nvcc, ops/_cuda.py), launches kernel A once and holds it against
its plain PyTorch version. Its stderr is reduced to one of

    ok | no-gpu | wrong-capability | no-nvcc | kernel-build-failure |
    device-hang | import-error | unknown-error

each with a remedy line.

Usage::

    python -m pinot_tpu_torch.tools.doctor [--timeout 300] [--report out.json]

Exit codes: 0 probe ok, 3 probe failed or hung (the report is still
printed and written), 2 usage error.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

# the package root the child imports pinot_tpu_torch from
_ROOT = str(Path(__file__).resolve().parents[2])

# the child arms the watchdog FIRST; the markers it prints name the
# failures the classifier cannot read from an exception's text
PROBE_CODE = """\
import faulthandler, json, sys
faulthandler.dump_traceback_later({timeout}, exit=True, file=sys.stderr)
sys.path.insert(0, {root!r})
import torch
if not torch.cuda.is_available():
    print("DOCTOR: no CUDA device is available", file=sys.stderr)
    sys.exit(1)
cap = torch.cuda.get_device_capability(0)
if cap != (9, 0):
    print(f"DOCTOR: compute capability {{cap}}, the kernels need (9, 0)",
          file=sys.stderr)
    sys.exit(1)
from pinot_tpu_torch.ops import _cuda, mxu_groupby
_cuda.library()
g = torch.Generator().manual_seed(7)
planes = torch.randint(0, 128, (2, 3, 1 << 16), generator=g,
                       dtype=torch.int8).cuda()
gid = torch.randint(0, 64, (2, 1 << 16), generator=g,
                    dtype=torch.int32).cuda()
got = mxu_groupby.limb_sums(planes, gid, 64)
want = mxu_groupby.limb_sums_plain(planes, gid, 64)
torch.cuda.synchronize()
err = int((got - want).abs().max())
if err:
    print(f"DOCTOR: kernel A disagrees with its plain version "
          f"(max abs err {{err}})", file=sys.stderr)
    sys.exit(1)
print(json.dumps({{"name": torch.cuda.get_device_name(0),
                  "capability": list(cap), "count": torch.cuda.device_count(),
                  "limbSumsLaunches": _cuda.LAUNCHES["limb_sums"],
                  "maxAbsErr": err}}))
faulthandler.cancel_dump_traceback_later()
"""

# signature → (classification, remedy); scanned in order, first hit wins
_SIGNATURES = [
    (("DOCTOR: no CUDA device", "CUDA is not available",
      "no CUDA GPUs are available", "Found no NVIDIA driver",
      "CUDA driver initialization failed"),
     ("no-gpu",
      "no usable CUDA device: run on the H100 host, check that the driver "
      "is loaded (nvidia-smi) and that CUDA_VISIBLE_DEVICES names a card")),
    (("DOCTOR: compute capability",),
     ("wrong-capability",
      "the kernels are built for sm_90a: run on an H100 (compute "
      "capability 9.0)")),
    (("nvcc not found",),
     ("no-nvcc",
      "nvcc is not on PATH nor at /usr/local/cuda/bin: install the CUDA "
      "toolkit or put its bin directory on PATH")),
    (("nvcc failed on", "nvcc link failed", "setup failed",
      "DOCTOR: kernel A disagrees", "CUDA kernel limb_sums failed"),
     ("kernel-build-failure",
      "a kernel did not build, load or agree with its plain version: read "
      "stderrTail for the nvcc or ptxas output")),
    (("ModuleNotFoundError", "ImportError"),
     ("import-error",
      "the probe could not import torch or pinot_tpu_torch: check the "
      "active environment and the checkout")),
]

# faulthandler's dump header: its presence in stderr IS the hang proof
_HANG_MARKERS = ("Timeout (0:", "dump_traceback_later")


def classify(status: str, stderr: str) -> tuple:
    """(classification, remedy) from a probe status + collected stderr."""
    if status == "ok":
        return "ok", ""
    text = stderr or ""
    if status == "hung" or any(m in text for m in _HANG_MARKERS):
        return ("device-hang",
                "the probe never returned: the card or its driver is "
                "wedged (the stack dump in stderrTail names the frame); "
                "reset the card or move to another host")
    for sigs, (cls, remedy) in _SIGNATURES:
        if any(s in text for s in sigs):
            return cls, remedy
    return ("unknown-error",
            "probe failed with an unrecognized error; read stderrTail")


def run_probe(timeout_s: float = 300.0, probe_code: str = None,
              env: dict = None) -> dict:
    """Run the supervised probe child; returns the machine-readable
    report. ``probe_code`` overrides the child script (tests fake hangs
    and failures through it); ``{timeout}`` and ``{root}`` are
    substituted."""
    code = (probe_code or PROBE_CODE).format(timeout=timeout_s, root=_ROOT)
    child_env = dict(os.environ if env is None else env)
    t0 = time.monotonic()
    with tempfile.TemporaryFile() as ef, tempfile.TemporaryFile() as of:
        proc = subprocess.Popen([sys.executable, "-c", code],
                                stdout=of, stderr=ef, env=child_env,
                                start_new_session=True)
        try:
            # grace past the watchdog so the child's own dump-and-exit
            # fires first; the parent kill is the backstop for a child
            # too wedged to run its watchdog
            rc = proc.wait(timeout=timeout_s + 10.0)
            status = "ok" if rc == 0 else "errored"
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            rc = None
            status = "hung"
        elapsed = time.monotonic() - t0
        ef.seek(0)
        stderr = ef.read().decode(errors="replace")
        of.seek(0)
        stdout = of.read().decode(errors="replace")
    if status == "errored" and any(m in stderr for m in _HANG_MARKERS):
        status = "hung"  # the watchdog exit(1): a hang, not an error
    cls, remedy = classify(status, stderr)
    device = None
    if status == "ok":
        try:
            device = json.loads(stdout.strip().splitlines()[-1])
        except (IndexError, ValueError):
            device = None
    return {
        "status": status,
        "classification": cls,
        "remedy": remedy,
        "rc": rc,
        "elapsedS": round(elapsed, 3),
        "timeoutS": timeout_s,
        "env": {"CUDA_VISIBLE_DEVICES":
                child_env.get("CUDA_VISIBLE_DEVICES")},
        "device": device,
        "stderrTail": stderr[-4000:],
        "source": "supervised-probe",
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="doctor",
        description="probe the GPU under supervision and name the failure "
                    "mode")
    ap.add_argument("--timeout", type=float, default=300.0,
                    help="watchdog seconds before the stack dump fires "
                         "(the kernel build takes most of them)")
    ap.add_argument("--report", help="also write the JSON report here")
    args = ap.parse_args(argv)
    report = run_probe(timeout_s=args.timeout)
    if args.report:
        try:
            Path(args.report).write_text(json.dumps(report, indent=2))
        except OSError as e:
            print(f"doctor: cannot write report: {e}", file=sys.stderr)
    print(json.dumps(report, indent=2))
    return 0 if report["classification"] == "ok" else 3


if __name__ == "__main__":
    sys.exit(main())
