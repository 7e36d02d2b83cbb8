"""Plugin loader: config-driven discovery and resolution of extensions
(the port of pinot_tpu/spi/plugins.py).

Reference analogue: pinot-spi/.../plugin/PluginManager.java — the reference
scans plugin directories, isolates classloaders, and instantiates factories
named in configs (``createInstance(className)``). Python needs no
classloader isolation; what carries over is the CONTRACT: a config names an
extension, the loader resolves it without hardwired imports.

Two resolution paths:

1. **Convention**: ``resolve(kind, name)`` imports
   ``pinot_tpu_torch.plugins.<kind>.<name>`` — the module registers itself with
   its SPI registry on import (stream types, FS schemes, input formats,
   metrics backends).
   Every module path built here is under ``pinot_tpu_torch.``: the port
   never resolves a plugin into the JAX package.
2. **Class path**: ``load_class("pkg.module:ClassName")`` (or dotted form)
   for user-supplied extensions living outside the tree — the analogue of
   naming a factory class in a table/controller config.
"""

from __future__ import annotations

import importlib
from typing import Any, Callable, Optional

# kind → registry-lookup callable (returns the registered object or None);
# SPI modules install their lookups at import time via register_kind
_KINDS: dict[str, Callable[[str], Optional[Any]]] = {}

# each kind's SPI home module — imported lazily so resolve() works before
# the caller has touched that SPI
_KIND_PROVIDERS = {
    "stream": "pinot_tpu_torch.spi.stream",
    "filesystem": "pinot_tpu_torch.spi.filesystem",
    "inputformat": "pinot_tpu_torch.plugins.inputformat.readers",
}


def register_kind(kind: str, lookup: Callable[[str], Optional[Any]]) -> None:
    _KINDS[kind] = lookup


def resolve(kind: str, name: str) -> Any:
    """Resolve a named extension of a kind, auto-importing
    ``pinot_tpu_torch.plugins.<kind>.<name>`` on first use."""
    if kind not in _KINDS and kind in _KIND_PROVIDERS:
        importlib.import_module(_KIND_PROVIDERS[kind])
    lookup = _KINDS.get(kind)
    if lookup is None:
        raise ValueError(f"unknown plugin kind {kind!r}; "
                         f"registered kinds: {sorted(_KINDS)}")
    found = lookup(name)
    if found is not None:
        return found
    module = f"pinot_tpu_torch.plugins.{kind}.{name}"
    try:
        importlib.import_module(module)
    except ModuleNotFoundError as e:
        if e.name != module:
            raise  # the plugin exists but its own imports are broken
    found = lookup(name)
    if found is None:
        raise ValueError(
            f"no {kind} plugin named {name!r} (module {module} not found "
            f"and nothing registered under that name)")
    return found


def load_class(class_path: str) -> type:
    """``pkg.module:ClassName`` or ``pkg.module.ClassName`` → class object
    (reference: PluginManager.createInstance)."""
    if ":" in class_path:
        mod_name, cls_name = class_path.split(":", 1)
    else:
        mod_name, _, cls_name = class_path.rpartition(".")
        if not mod_name:
            raise ValueError(f"not a class path: {class_path!r}")
    mod = importlib.import_module(mod_name)
    try:
        return getattr(mod, cls_name)
    except AttributeError:
        raise ValueError(
            f"module {mod_name} has no class {cls_name!r}") from None


def create_instance(class_path: str, *args, **kwargs) -> Any:
    return load_class(class_path)(*args, **kwargs)
