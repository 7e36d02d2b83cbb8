"""Operator tools of the port: tools/doctor.py (the GPU probe),
tools/admin.py (the pinot-admin CLI), tools/soak.py (the soak and chaos
harness) and tools/bench_gate.py (the bench-round regression gate)."""
