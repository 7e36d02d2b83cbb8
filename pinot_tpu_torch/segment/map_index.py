"""Map index: dense per-key planes for MAP-typed columns.

The port's own copy of pinot_tpu/segment/map_index.py (the same planes and
buffers). Reference analogue: the map index
(pinot-segment-spi/.../index/StandardIndexes.java:89-146 MAP_ID;
pinot-segment-local/.../segment/index/map/MapIndexType.java and
ImmutableMapIndexReader) — a MAP column's frequent keys are stored as
dense per-key forward columns so ``mapCol['key']`` never walks per-row
map entries.

As in the JAX package, each dense key becomes a flat float64 value plane
plus a presence plane, the whole-segment column layout every other plane
uses: a predicate on an indexed key is one vector compare on the host
(engine/host_masks.py eval_map_index_predicate), shipped to the device as a
mask plane. Non-numeric or rare keys take the row-wise ``mapvalue``
transform (query/transforms.py), matching the reference's dynamically-typed
fallback reader.

The column itself stores maps as JSON strings (or dict objects on the
mutable path) — the same object-column representation the JSON index uses.
"""

from __future__ import annotations

import json
from collections import Counter
from dataclasses import dataclass

import numpy as np

from .index_spi import IndexType, register_index_type

DEFAULT_MAX_KEYS = 64


def _parse_map(x):
    if isinstance(x, dict):
        return x
    if isinstance(x, (str, bytes)):
        try:
            obj = json.loads(x)
            return obj if isinstance(obj, dict) else None
        except (json.JSONDecodeError, TypeError):
            return None
    return None


@dataclass
class MapIndex:
    """Dense planes for the indexed keys of one MAP column."""

    dense_keys: list[str]
    values: dict[str, np.ndarray]  # key → (n,) float64 (0 where absent)
    present: dict[str, np.ndarray]  # key → (n,) bool

    @staticmethod
    def build(col_values, config: dict | None = None) -> "MapIndex":
        config = config or {}
        n = len(col_values)
        maps = [_parse_map(x) for x in col_values]
        wanted = config.get("denseKeys")
        if wanted is None:
            freq: Counter = Counter()
            for m in maps:
                if m:
                    freq.update(m.keys())
            max_keys = int(config.get("maxKeys", DEFAULT_MAX_KEYS))
            # deterministic: by descending frequency then name
            wanted = [k for k, _ in sorted(
                freq.items(), key=lambda kv: (-kv[1], kv[0]))[:max_keys]]
        values: dict[str, np.ndarray] = {}
        present: dict[str, np.ndarray] = {}
        for key in wanted:
            v = np.zeros(n, dtype=np.float64)
            pr = np.zeros(n, dtype=bool)
            for i, m in enumerate(maps):
                if not m or key not in m:
                    continue
                x = m[key]
                if isinstance(x, bool):
                    v[i] = float(x)
                elif isinstance(x, (int, float)) and np.isfinite(x):
                    v[i] = float(x)
                else:
                    continue  # non-numeric value: not densifiable
                pr[i] = True
            values[key] = v
            present[key] = pr
        return MapIndex(list(wanted), values, present)

    def has_key(self, key: str) -> bool:
        return key in self.values

    def value_plane(self, key: str):
        """(values float64, present bool) — absent rows carry 0/False."""
        return self.values[key], self.present[key]

    # -- persistence (index SPI buffers) ----------------------------------
    def serialize(self):
        out = [("meta", np.frombuffer(
            json.dumps(self.dense_keys).encode("utf-8"), dtype=np.uint8))]
        for i, key in enumerate(self.dense_keys):
            out.append((f"v{i}", self.values[key]))
            out.append((f"p{i}", self.present[key].astype(np.uint8)))
        return out

    @staticmethod
    def deserialize(bufs: dict) -> "MapIndex":
        keys = json.loads(bytes(bufs["meta"]).decode("utf-8"))
        # stored buffers surface as raw uint8 (index SPI contract): view
        # the value planes back as float64, presence as one byte per doc
        values = {k: np.frombuffer(np.asarray(bufs[f"v{i}"]).tobytes(),
                                   dtype=np.float64)
                  for i, k in enumerate(keys)}
        present = {k: np.asarray(bufs[f"p{i}"]).astype(bool)
                   for i, k in enumerate(keys)}
        return MapIndex(keys, values, present)


register_index_type(IndexType(
    name="map",
    build=lambda values, cfg: MapIndex.build(values, cfg),
    serialize=lambda idx: idx.serialize(),
    deserialize=MapIndex.deserialize,
))


def map_value_args(expr):
    """(column, key, default|None) when ``expr`` is mapvalue(col, 'key') /
    item(col, 'key') with literal key — else None (the planner's map-index
    predicate path)."""
    if not getattr(expr, "is_function", False):
        return None
    fn = expr.function
    if fn.name not in ("mapvalue", "item", "map_value"):
        return None
    args = fn.arguments
    if len(args) < 2 or not args[0].is_identifier or not args[1].is_literal:
        return None
    default = None
    if len(args) > 2 and args[2].is_literal:
        default = args[2].literal
    return args[0].identifier, str(args[1].literal), default
