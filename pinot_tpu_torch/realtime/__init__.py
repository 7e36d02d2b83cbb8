"""Realtime tables: consuming segments on the device (device_plane.py) and
their conversion to immutable segments on commit (converter.py)."""
