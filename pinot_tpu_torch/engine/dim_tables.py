"""Dimension-table registry for LOOKUP joins.

The port of pinot_tpu/engine/dim_tables.py, with its own per-process
registry (it never reads the JAX package's). Reference: dimension tables
(TableConfig.isDimTable) are replicated to every server and queried
through the LOOKUP transform (pinot-core/.../operator/transform/function/
LookupTransformFunction.java: LOOKUP('dimTable', 'valueColumn',
'pkColumn', factKeyExpr)), backed by DimensionTableDataManager's in-memory
pk -> row map.

The registry holds plain column arrays with a SORTED primary-key view. The
device never sees the table: at plan time the fact column's dictionary
(segment-local, small) is translated pk -> value into a cardinality-sized
table that rides the program as an ir.ParamGather (engine/plan.py), so the
join costs one gather per row inside whatever uses it (filter, GROUP BY
key, aggregation input). Tables are registered through
QueryExecutor.add_dimension_table and stay until unregistered.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


class DimensionTable:
    def __init__(self, name: str, pk_column: str,
                 columns: dict[str, np.ndarray]):
        if pk_column not in columns:
            raise ValueError(f"pk column {pk_column} missing")
        self.name = name
        self.pk_column = pk_column
        self.columns = {c: np.asarray(v) for c, v in columns.items()}
        pk = self.columns[pk_column]
        order = np.argsort(pk, kind="stable")
        self._sorted_pk = pk[order]
        # the table is immutable after registration: pre-sort every column
        # once so lookup() is a pure searchsorted + gather
        self._sorted_cols = {c: v[order] for c, v in self.columns.items()}
        if len(self._sorted_pk) > 1 and \
                (self._sorted_pk[1:] == self._sorted_pk[:-1]).any():
            raise ValueError(f"duplicate primary keys in dim table {name}")

    def lookup(self, attr: str, keys: np.ndarray):
        """(values, found_mask) for an array of join keys. Missing keys get
        the attr dtype's null stand-in (0 / empty string) with found=False
        — LOOKUP's null result under basic null handling."""
        vals = self._sorted_cols[attr]
        keys = np.asarray(keys)
        if len(self._sorted_pk) == 0:
            empty = (np.zeros(len(keys)) if vals.dtype.kind in "iuf"
                     else np.full(len(keys), "", dtype=object))
            return empty, np.zeros(len(keys), dtype=bool)
        idx = np.clip(np.searchsorted(self._sorted_pk, keys), 0,
                      len(self._sorted_pk) - 1)
        found = self._sorted_pk[idx] == keys
        out = vals[idx]
        if out.dtype.kind in "iuf":
            out = np.where(found, out, 0)
        else:
            out = np.where(found, out, "")
        return out, found


_REGISTRY: dict[str, DimensionTable] = {}


def register_dimension_table(name: str, pk_column: str,
                             columns: dict[str, np.ndarray]) -> DimensionTable:
    t = DimensionTable(name, pk_column, columns)
    _REGISTRY[name] = t
    return t


def get_dimension_table(name: str) -> Optional[DimensionTable]:
    return _REGISTRY.get(name)


def alias_dimension_table(alias: str, name: str) -> None:
    """Expose a registered table under a second name (cluster tables
    register with their _OFFLINE suffix; LOOKUP callers use the raw name)."""
    if name in _REGISTRY:
        _REGISTRY[alias] = _REGISTRY[name]


def unregister_dimension_table(name: str) -> None:
    _REGISTRY.pop(name, None)
