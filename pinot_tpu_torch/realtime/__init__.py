"""Realtime tables: stream consumption and the commit protocol
(manager.py, completion.py), consuming segments on the device
(device_plane.py) and their conversion to immutable segments on commit
(converter.py)."""

from .manager import RealtimeTableDataManager  # noqa: F401
