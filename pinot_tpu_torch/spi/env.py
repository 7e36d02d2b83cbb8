"""Layered configuration (reference: PinotConfiguration).

The port's copy of pinot_tpu/spi/env.py. It is the one module of the
port's operations layer that reads the environment: the cluster modules
take their knobs as keyword arguments, and `build_default_scheduler` may
take them from a PinotConfiguration the caller passes in.

Reference analogue: pinot-spi/.../spi/env/PinotConfiguration.java:92 —
merges -config properties files, environment variables (PINOT_*), and
system properties with dotted-key namespacing; components subscope with
`subset(prefix)` (reference CommonConstants namespaces).
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any, Optional


class PinotConfiguration:
    """Priority (highest wins): explicit overrides > env vars > properties
    files (later files win) > defaults."""

    ENV_PREFIX = "PINOT_TPU_"

    def __init__(self, properties: Optional[dict] = None,
                 config_paths: Optional[list] = None,
                 use_env: bool = True):
        merged: dict[str, Any] = {}
        for path in config_paths or []:
            merged.update(self._load_properties(path))
        if use_env:
            for k, v in os.environ.items():
                if k.startswith(self.ENV_PREFIX):
                    # PINOT_TPU_SERVER_QUERY_TIMEOUT → server.query.timeout
                    key = k[len(self.ENV_PREFIX):].lower().replace("_", ".")
                    merged[key] = v
        merged.update(properties or {})
        self._props = merged

    @staticmethod
    def _load_properties(path) -> dict:
        out: dict[str, str] = {}
        for line in Path(path).read_text().splitlines():
            line = line.strip()
            if not line or line.startswith(("#", "!")):
                continue
            if "=" in line:
                k, v = line.split("=", 1)
                out[k.strip()] = v.strip()
        return out

    # -- typed getters (reference getProperty overloads) --------------------
    def get(self, key: str, default: Any = None) -> Any:
        return self._props.get(key, default)

    def get_int(self, key: str, default: int = 0) -> int:
        v = self._props.get(key)
        return default if v is None else int(v)

    def get_float(self, key: str, default: float = 0.0) -> float:
        v = self._props.get(key)
        return default if v is None else float(v)

    def get_bool(self, key: str, default: bool = False) -> bool:
        v = self._props.get(key)
        if v is None:
            return default
        if isinstance(v, bool):
            return v
        return str(v).strip().lower() in ("true", "1", "yes")

    def subset(self, prefix: str) -> "PinotConfiguration":
        prefix = prefix.rstrip(".") + "."
        return PinotConfiguration(
            {k[len(prefix):]: v for k, v in self._props.items()
             if k.startswith(prefix)}, use_env=False)

    def keys(self) -> list[str]:
        return sorted(self._props)

    def to_dict(self) -> dict:
        return dict(self._props)
