"""Tiered storage: a byte-budgeted local segment cache beneath the device
plane cache, so a server can advertise ONLINE for more segments than it
holds on local disk (the port of pinot_tpu/storage/).

`SegmentTierManager` (tier.py) owns every locally materialized segment
directory: converge loads, cold lazy loads and repair re-fetches all draw
from one byte budget. `StoragePrefetcher` (prefetch.py) turns the brokers'
workload beacons into nudges that warm hot tables before traffic lands.
"""

from .prefetch import PREFETCH_PREFIX, StoragePrefetcher  # noqa: F401
from .tier import TIER_PROBES, SegmentTierManager  # noqa: F401
