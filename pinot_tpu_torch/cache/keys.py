"""Canonical plan fingerprints and segment identity tokens (cache tier 1).

The port of pinot_tpu/cache/keys.py. A per-segment partial result is a
pure function of (compiled plan, segment content), so the cache key must be
process-stable: two fresh planners compiling the same SQL produce
byte-identical fingerprints, and any change that can alter the partial (a
filter literal, an aggregation, a SET option that affects results, an
upsert validity plane) changes them.

The encoder is closed-world: it walks frozen IR dataclasses, containers,
numpy values and primitives, and raises on anything else. There is no
repr() / id() fallback, which would leak object identity into keys. It
raises on a torch.Tensor too: plan params are host numpy, and a device
tensor reaching a key would cost a device-to-host copy a query. A plan
that fingerprints nothing bypasses the cache.

Both packages encode a type by its `__qualname__`, and the port's IR
dataclasses have the JAX package's names and fields, so a family
fingerprint (`family_fingerprint`) equals the JAX package's for the same
Program and variant. For the other keys only stability across planners
and sensitivity to literals and options are held.
"""

from __future__ import annotations

import dataclasses
import enum
import hashlib
import struct
import threading
from typing import Optional

import numpy as np

# SET options that change HOW a query executes but never WHAT it returns.
# Everything else folds into the fingerprint (numGroupsLimit,
# enableNullHandling, trims, ...). Compared lowercase.
EXECUTION_ONLY_OPTIONS = frozenset({
    "segmentbatch", "devicecombine", "segmentcache", "resultcache",
    "trace", "timeoutms", "usemultistageengine", "meshexecution",
    "devicejoin", "coalesce", "realtimedeviceplanes",
})

# Fingerprints computed in this process: `SET segmentCache = false` must
# compute none (tests/test_torch_cache.py).
_FP_COUNT = [0]
_FP_LOCK = threading.Lock()


def fingerprint_computations() -> int:
    return _FP_COUNT[0]


def _count() -> None:
    with _FP_LOCK:
        _FP_COUNT[0] += 1


class UnfingerprintableError(TypeError):
    """A value with no canonical byte encoding reached the key encoder."""


def _enc(obj, out: list) -> None:
    """Append a canonical, type-tagged byte encoding of ``obj``. Tags keep
    distinct types with equal payloads apart (1 vs 1.0 vs "1" vs True)."""
    if obj is None:
        out.append(b"N")
    elif obj is True:
        out.append(b"T")
    elif obj is False:
        out.append(b"F")
    elif isinstance(obj, enum.Enum):
        out.append(b"E")
        _enc(type(obj).__qualname__, out)
        _enc(obj.name, out)
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        out.append(b"s%d:" % len(b))
        out.append(b)
    elif isinstance(obj, bytes):
        out.append(b"b%d:" % len(obj))
        out.append(obj)
    elif isinstance(obj, int):
        out.append(b"i%d;" % obj)
    elif isinstance(obj, float):
        out.append(b"f")
        out.append(struct.pack("<d", obj))
    elif isinstance(obj, (np.generic, np.ndarray)):
        a = np.asarray(obj)
        if a.dtype.kind == "O":
            raise UnfingerprintableError("object arrays have no encoding")
        out.append(b"a")
        _enc(a.dtype.str, out)
        _enc(tuple(int(d) for d in a.shape), out)
        out.append(np.ascontiguousarray(a).tobytes())
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        # frozen IR nodes: qualname + every field in declaration order
        out.append(b"D")
        _enc(type(obj).__qualname__, out)
        for f in dataclasses.fields(obj):
            _enc(f.name, out)
            _enc(getattr(obj, f.name), out)
    elif isinstance(obj, (tuple, list)):
        out.append(b"l%d:" % len(obj))
        for item in obj:
            _enc(item, out)
    elif isinstance(obj, dict):
        items = []
        for k, v in obj.items():
            kb: list = []
            _enc(k, kb)
            items.append((b"".join(kb), v))
        items.sort(key=lambda kv: kv[0])
        out.append(b"d%d:" % len(items))
        for kb, v in items:
            out.append(kb)
            _enc(v, out)
    else:
        # torch.Tensor lands here: no device value may reach a key
        raise UnfingerprintableError(
            f"no canonical encoding for {type(obj).__qualname__}")


def canonical_bytes(obj) -> bytes:
    buf: list = []
    _enc(obj, buf)
    return b"".join(buf)


def _result_options(options) -> dict:
    return {str(k): str(v) for k, v in (options or {}).items()
            if str(k).lower() not in EXECUTION_ONLY_OPTIONS}


def _digest(payload) -> Optional[str]:
    try:
        digest = hashlib.sha256(canonical_bytes(payload)).hexdigest()
    except UnfingerprintableError:
        return None
    _count()
    return digest


def program_fingerprint(plan, query) -> Optional[str]:
    """Fingerprint of a compiled per-segment plan: the Program IR, the
    param VALUES (the literals, a host mask's and an upsert validity
    plane's bytes), the slot layout, the fused switch and the canonical
    query text (AVG and SUM + COUNT can share a Program and decode
    differently). None when any part has no canonical encoding."""
    return _digest(("pfp1", plan.program, tuple(plan.slots),
                    bool(plan.fused_ok), tuple(plan.params), str(query),
                    _result_options(query.query_options)))


def query_fingerprint(query) -> Optional[str]:
    """Broker-tier fingerprint: canonical SQL text + result-affecting SET
    options (two parses of one request collide by construction)."""
    return _digest(("qfp1", str(query), _result_options(query.query_options)))


def mse_plan_fingerprint(stages, query_options,
                         parallelism: int) -> Optional[str]:
    """Fingerprint of a fragmented multi-stage DAG: every Stage dataclass
    (operator trees, exchanges, pruned schemas), the result-affecting SET
    options and the stage parallelism (it shapes where an overflowing join
    truncates). A foreign node makes the plan uncacheable (None)."""
    return _digest(("msefp1", tuple(stages), _result_options(query_options),
                    int(parallelism)))


def family_fingerprint(program, padded: int, fused: str = "",
                       lut_meta: tuple = (),
                       batch_size: int = 0,
                       mesh: tuple = ()) -> Optional[str]:
    """Fingerprint of one executable FAMILY: the Program IR plus the
    shape and variant axes a dispatch specializes on (padded bucket,
    fused variant, LUT run metadata, batch size) and nothing that is a
    runtime argument (param values, literals, query text). The compile
    registry keys on it and the AOT cache persists under it
    (engine/compile_registry.py, engine/aot_cache.py). It is telemetry,
    not a result-cache key, so it does not count in
    `fingerprint_computations()`, and it is computed on a family's first
    dispatch only. A mesh-sharded family (`mesh` its shape) is another
    artifact: its payload is tagged ffp2 and carries the mesh axis, as in
    the JAX package; solo families keep the ffp1 digest."""
    try:
        payload = ("ffp1", canonical_bytes(program), int(padded), str(fused),
                   tuple(lut_meta), int(batch_size))
        if mesh:
            payload = ("ffp2",) + payload[1:] + (
                tuple(int(x) for x in mesh),)
        return hashlib.sha256(canonical_bytes(payload)).hexdigest()
    except UnfingerprintableError:
        return None


def segment_token(segment) -> Optional[tuple]:
    """Content identity of a segment: (name, crc) for an immutable one, so
    a rebuilt segment under the same name never serves stale partials;
    ("rt", name, snapshot_generation) for a consuming segment's pinned
    snapshot (rows and upsert generation), so a new row or an upsert flip
    mints a new key. A mutable object without a pinned generation, or a
    segment without a crc, gives None and bypasses the cache."""
    if getattr(segment, "is_mutable", False):
        gen = getattr(segment, "snapshot_generation", None)
        name = getattr(segment, "name", None)
        if gen is None or not name:
            return None
        return ("rt", str(name), tuple(gen))
    meta = getattr(segment, "metadata", None)
    name = getattr(segment, "name", None) or getattr(meta, "segment_name", None)
    crc = getattr(meta, "crc", None)
    if not name or not crc:
        return None
    return (str(name), str(crc))
