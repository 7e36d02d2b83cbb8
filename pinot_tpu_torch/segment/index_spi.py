"""Custom index SPI: pluggable index types registered by name.

The port's own copy of pinot_tpu/segment/index_spi.py: the same registry,
buffer names and lifecycle, so a custom index either builder wrote loads
in both. Reference analogue: the IndexType<C, R, Creator> registration surface
(pinot-segment-spi/.../index/StandardIndexes.java:89-146 and IndexService
— plugins register index types that the segment creator invokes per
column and the loader materializes into readers). Here an index type is a
(build, serialize, deserialize) triple keyed by name:

    register_index_type(IndexType(
        name="suffix",                     # config key
        build=lambda values, cfg: ...,     # column values → index object
        serialize=lambda idx: [(suffix, np.ndarray), ...],
        deserialize=lambda bufs: idx,      # {suffix: np.ndarray} → object
    ))

A table config requests instances per column through
``IndexingConfig.custom_index_configs``:

    {"colA": {"type": "suffix", ...per-index config...}}

The segment builder stores each buffer as ``{col}.x_{name}.{suffix}`` so
custom buffers never collide with built-ins; the loader exposes
``segment.get_custom_index(col)`` which deserializes lazily and caches —
the same lifecycle the built-in indexes get. Query integration is up to
the index's owner (the map index answers `mapvalue` predicates through
engine/host_masks.py), matching the reference where a custom IndexType
ships its own operator integration.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

_BUF_PREFIX = "x_"


@dataclass(frozen=True)
class IndexType:
    name: str
    build: Callable  # (values, config: dict) -> index object
    serialize: Callable  # (index object) -> list[(suffix, np.ndarray)]
    deserialize: Callable  # ({suffix: np.ndarray}) -> index object


_REGISTRY: dict[str, IndexType] = {}


def register_index_type(index_type: IndexType) -> None:
    if not index_type.name.isidentifier():
        raise ValueError(f"index type name {index_type.name!r} must be an "
                         "identifier (it becomes a buffer-name component)")
    _REGISTRY[index_type.name] = index_type


def get_index_type(name: str) -> IndexType:
    if name not in _REGISTRY:
        _load_builtin_types()
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown index type {name!r}; registered: "
            f"{sorted(_REGISTRY)}") from None


def _load_builtin_types() -> None:
    """Import modules that register the built-in custom index types (the
    reference's ServiceLoader pass over IndexPlugin implementations)."""
    from . import map_index  # noqa: F401  (registers "map")


def registered_index_types() -> list[str]:
    return sorted(_REGISTRY)


def buffer_name(column: str, type_name: str, suffix: str) -> str:
    return f"{column}.{_BUF_PREFIX}{type_name}.{suffix}"


def build_custom_indexes(columns, custom_configs: dict) -> list[tuple[str, object]]:
    """(buffer_name, array) pairs for every configured custom index."""
    out = []
    for col, cfg in custom_configs.items():
        if col not in columns:
            continue
        it = get_index_type(cfg.get("type", ""))
        idx = it.build(columns[col], cfg)
        for suffix, arr in it.serialize(idx):
            out.append((buffer_name(col, it.name, suffix), arr))
    return out


def load_custom_index(segment, column: str, type_name: str):
    """Deserialize a custom index from a loaded segment's buffers, or None
    when the segment carries none for (column, type)."""
    it = get_index_type(type_name)
    prefix = f"{column}.{_BUF_PREFIX}{type_name}."
    bufs = {name[len(prefix):]: segment.buffer_array(name)
            for name in segment.metadata.buffers if name.startswith(prefix)}
    if not bufs:
        return None
    return it.deserialize(bufs)
