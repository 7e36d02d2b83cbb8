"""Operator tools of the port (tools/doctor.py: the GPU probe)."""
