"""Upsert & dedup: primary-key semantics over append-only segments (the
port of pinot_tpu/upsert).

Reference analogue: pinot-segment-local/.../upsert/ (4.2K LoC —
ConcurrentMapPartitionUpsertMetadataManager.java:48, PartialUpsertHandler)
and .../dedup/ (ConcurrentMapPartitionDedupMetadataManager).
"""

from .manager import (
    PartialUpsertHandler,
    TableDedupManager,
    TableUpsertMetadataManager,
    ValidDocIds,
)

__all__ = ["TableUpsertMetadataManager", "TableDedupManager",
           "PartialUpsertHandler", "ValidDocIds"]
