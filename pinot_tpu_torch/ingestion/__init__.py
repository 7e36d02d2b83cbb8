"""Ingestion: the row transform pipeline a realtime consumer runs
(transform.py)."""

from .transform import CompositeTransformer, build_transform_pipeline  # noqa: F401
