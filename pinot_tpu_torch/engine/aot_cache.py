"""AOT family cache: cold starts without the one-time costs, across restarts.

The port of pinot_tpu/engine/aot_cache.py. Reference analogue: none in
Pinot. There the first query of every executable family after a restart
pays a full XLA compile, and the cache persists the compiled executables
(jax.export) to prewarm them off the serving path.

Eager PyTorch compiles no program, so there is no executable to export:
what a family costs the first time in a process is the lazy load of the
CUDA kernels' module, the first launch's geometry planning (the card's
cluster occupancy queries) and the first allocations. What the port
persists is therefore the FAMILY RECORD: its fingerprint
(cache/keys.py `family_fingerprint`), `describe_family`, the table, its
score (the first dispatch's cold cost in ms), the family key, and what it
takes to replay the family's kernel launches at a tiny size (which
kernel, members, planes, groups, the fused plan and slot types, and the
geometry mode the host plans for them). The record is written on the
family's first dispatch, under a checksum, into a byte-budgeted on-disk
cache keyed by the fingerprint plus an environment tag (torch version,
CUDA version, device name and compute capability, and a sha256 over the
port's csrc/ sources).

`prewarm_table` runs at table registration, off the serving path: it
admits the table's best families (ranked by live cost x recency, within
a cold-cost budget), launches each one's kernels once at the tiny size on
the executor's device (on the CPU, their plain versions), and installs
it: the compile registry learns the family (`note_preloaded`, cold cost
0) and the executor counts its first dispatch as a warm one, and every
dispatch of an installed family counts `aotCacheHits`.

Safety contract: a persisted record is refused, counting
`aotCacheMisses`, on any mismatch (environment tag, format version,
record checksum), an unreadable or garbage file, an `aot.load` fault, or
a replay that raises. The checksum covers every field the loader reads
(the payload, the fingerprint, the tag, the family, the table and the
score), so a damaged byte anywhere in a record refuses it. A refused family is dispatched as usual: never a
wrong answer, never a crash.

Knobs (the JAX package's): PINOT_TPU_AOT_CACHE_DIR (unset = disabled),
PINOT_TPU_AOT_CACHE_MB (byte budget, default 256),
PINOT_TPU_AOT_PREWARM_BUDGET_MS (summed cold-cost budget of a prewarm,
default 5000), PINOT_TPU_AOT_PREWARM_TOP_K (a flat count instead).
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import pickle
import threading
import time
from functools import lru_cache
from pathlib import Path

import numpy as np
import torch

from ..spi import faults

log = logging.getLogger(__name__)

_FORMAT_VERSION = 2

# the fields of a record its checksum covers, in this order
_SUMMED = ("version", "fingerprint", "envTag", "payload", "family", "table",
           "score")


def _record_sha(blob: dict) -> str:
    """sha256 over a record's checksummed fields (pickled as one tuple:
    pickle keeps every value's type, so a reloaded record sums the same)."""
    return hashlib.sha256(pickle.dumps(
        tuple(blob[k] for k in _SUMMED), protocol=4)).hexdigest()

# family key -> fingerprint of every family the prewarm installed. A plain
# dict: reads are atomic under the GIL, writes happen under _LOCK. The
# executor tests `if AOT_READY:` first, so an empty cache costs a falsy
# truth test.
AOT_READY: dict = {}

_LOCK = threading.Lock()
_WARN_ONCE: set = set()

# the rows of a replayed launch: a multiple of 16 (kernel A's family rows)
REPLAY_ROWS = 4096

# thread-local table attribution: serve_planned stamps the current table
# so persisted records can be prewarmed per table later
_TLS = threading.local()

# kernel-call recording of a family's first dispatch: the wrappers read
# RECORDING[0] (the recorders armed in the process) before anything else,
# so with none armed a kernel call pays one list read
RECORDING = [0]
_REC = threading.local()


def set_current_table(table) -> None:
    _TLS.table = table


def current_table():
    return getattr(_TLS, "table", None)


def enabled() -> bool:
    return bool(os.environ.get("PINOT_TPU_AOT_CACHE_DIR"))


def cache_dir():
    return os.environ.get("PINOT_TPU_AOT_CACHE_DIR")


def _budget_bytes() -> int:
    return int(float(os.environ.get("PINOT_TPU_AOT_CACHE_MB", 256))
               * 1024 * 1024)


@lru_cache(maxsize=1)
def _csrc_digest() -> str:
    """sha256 over the kernel sources, read once a process."""
    csrc = Path(__file__).resolve().parents[1] / "csrc"
    h = hashlib.sha256()
    for path in sorted(csrc.iterdir()):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()


def env_tag(device="cuda") -> dict:
    """The environment a record is valid in: a persisted record is only
    replayed under the exact torch and CUDA versions, device name and
    compute capability, local mesh shape and kernel sources it was written
    under."""
    device = torch.device(device)
    if device.type == "cuda":
        index = device.index if device.index is not None \
            else torch.cuda.current_device()
        name = torch.cuda.get_device_name(index)
        capability = list(torch.cuda.get_device_capability(index))
    else:
        name, capability = device.type, []
    from ..parallel.mesh import local_devices, mesh_device_count

    return {"torch": torch.__version__, "cuda": torch.version.cuda,
            "deviceName": name, "capability": capability,
            "meshShape": [mesh_device_count(local_devices(device))],
            "csrc": _csrc_digest()}


def _env_hash(tag: dict) -> str:
    return hashlib.sha256(
        json.dumps(tag, sort_keys=True).encode()).hexdigest()


def _artifact_name(fingerprint: str, tag: dict) -> str:
    return f"{fingerprint[:24]}-{_env_hash(tag)[:8]}.aot"


# -- manifest -----------------------------------------------------------------


def _manifest_path(d: str) -> str:
    return os.path.join(d, "manifest.json")


def _load_manifest(d: str) -> dict:
    try:
        with open(_manifest_path(d)) as f:
            m = json.load(f)
        if isinstance(m, dict) and isinstance(m.get("files"), dict):
            return m
    except (OSError, ValueError):
        pass
    return {"files": {}}


def _save_manifest(d: str, manifest: dict) -> None:
    tmp = _manifest_path(d) + ".tmp"
    with open(tmp, "w") as f:
        json.dump(manifest, f)
    os.replace(tmp, _manifest_path(d))


# -- recording a first dispatch's kernel calls --------------------------------


def start_recording():
    """Arm this thread's recorder for a family's first dispatch: the list
    the kernel wrappers append their calls to, or None when the cache is
    off (nothing to persist)."""
    if not enabled():
        return None
    calls: list = []
    _REC.calls = calls
    with _LOCK:
        RECORDING[0] += 1
    return calls


def stop_recording(calls) -> None:
    if calls is None:
        return
    _REC.calls = None
    with _LOCK:
        RECORDING[0] -= 1


def note_kernel_call(spec: dict) -> None:
    """A kernel wrapper's call (ops/mxu_groupby.py, ops/fused_groupby.py),
    kept when this thread records a first dispatch."""
    calls = getattr(_REC, "calls", None)
    if calls is not None:
        calls.append(spec)


# -- persist (a family's first dispatch) --------------------------------------


def on_first_dispatch(gkey, fingerprint: str, cold_ms: float, family: dict,
                      calls: list, device) -> bool:
    """Persist the family record of a first dispatch if its score (the
    cold cost) wins the byte budget. Returns True when a record was
    written. Never raises."""
    if not enabled():
        return False
    d = cache_dir()
    try:
        tag = env_tag(device)
        name = _artifact_name(fingerprint, tag)
        path = os.path.join(d, name)
        with _LOCK:
            manifest = _load_manifest(d)
            if name in manifest["files"] and os.path.exists(path):
                return False  # already persisted under this environment
        payload = pickle.dumps({"gkey": gkey,
                                "launches": [_with_mode(c) for c in calls]})
        record = {
            "version": _FORMAT_VERSION,
            "fingerprint": fingerprint,
            "envTag": tag,
            "payload": payload,
            "family": family,
            "table": current_table(),
            "score": round(float(cold_ms), 3),
        }
        record["recordSha"] = _record_sha(record)
        blob = pickle.dumps(record)
        with _LOCK:
            manifest = _load_manifest(d)
            if not _make_room(d, manifest, len(blob), float(cold_ms)):
                return False
            os.makedirs(d, exist_ok=True)
            tmp = path + ".tmp"
            with open(tmp, "wb") as f:
                f.write(blob)
            os.replace(tmp, path)
            manifest["files"][name] = {
                "bytes": len(blob),
                "table": current_table(),
                "fingerprint": fingerprint,
                "score": round(float(cold_ms), 3),
                "savedAtMs": int(time.time() * 1000),
            }
            _save_manifest(d, manifest)
        return True
    except Exception as e:
        _warn_once("persist", "AOT persist failed (%s: %s); the family is "
                   "not persisted", type(e).__name__, e)
        return False


def _with_mode(spec: dict) -> dict:
    """A recorded kernel call with the table mode and warp aggregation
    the host plans for it at its rows on an H100 (ops/geometry.py): the
    record says which kernel variant the family ran."""
    from ..ops import geometry

    if spec["kernel"] == "limb_sums":
        widths, segments = (4,) + (1,) * spec["planes"], spec["segments"]
    else:
        widths = tuple(torch.empty(0, dtype=getattr(torch, t)).element_size()
                       for t in spec["slotTypes"])
        segments = 1
    try:
        geo = geometry.plan(max(16, spec["rows"]), spec["planes"],
                            spec["groups"], widths, segments=segments)
    except ValueError:
        return spec
    return dict(spec, mode=geo.mode, warpAgg=bool(geo.warp_agg))


def _make_room(d: str, manifest: dict, need: int, score: float) -> bool:
    """Evict lowest-score records until ``need`` bytes fit the budget.
    Only records scoring BELOW the incoming family are evictable — the
    CompileRegistry ranking decides what persists. Caller holds _LOCK."""
    budget = _budget_bytes()
    if need > budget:
        return False
    files = manifest["files"]
    total = sum(int(m.get("bytes", 0)) for m in files.values())
    if total + need <= budget:
        return True
    evictable = sorted(
        ((m.get("score", 0.0), name) for name, m in files.items()
         if float(m.get("score", 0.0)) < score))
    for _, name in evictable:
        try:
            os.unlink(os.path.join(d, name))
        except OSError:
            pass
        total -= int(files.pop(name).get("bytes", 0))
        if total + need <= budget:
            return True
    return total + need <= budget


# -- replay, load and prewarm (off the serving path) --------------------------


def _group_cards(groups: tuple, num_segments: int) -> dict:
    """slot -> how many ids a group-key slot may hold so that the key
    Σ id·stride stays below the trash slot num_segments - 1."""
    cards, bound = {}, num_segments - 1
    for slot, stride in sorted(groups, key=lambda g: -g[1]):
        cards[slot] = max(1, min(bound // stride, 1 << 15))
        bound = stride
    return cards


def replay_inputs(spec: dict, device, seed: int = 0):
    """(wrapper name, arguments) of one recorded kernel call at
    REPLAY_ROWS rows on `device`, from a numpy seed: kernel A's limb
    planes and group ids, or kernel B's raw slot planes (group-key slots
    within their dimensions) and its scalar vector (every row valid, each
    filter term's bounds around the middle of the values)."""
    rng = np.random.default_rng(seed)
    n, G = REPLAY_ROWS, spec["groups"]
    if spec["kernel"] == "limb_sums":
        S, P = spec["segments"], spec["planes"]
        planes = rng.integers(0, 128, (S, P, n), dtype=np.int8)
        gid = rng.integers(0, G, (S, n), dtype=np.int32)
        return "limb_sums", (torch.from_numpy(planes).to(device),
                             torch.from_numpy(gid).to(device), G)
    fp = spec["plan"]
    cards = _group_cards(fp.groups, G)
    planes_in = []
    for slot, name in zip(fp.slots, spec["slotTypes"]):
        dtype = getattr(torch, name)
        hi = min(cards.get(slot, 100), torch.iinfo(dtype).max + 1)
        a = rng.integers(0, hi, n).astype(np.int32)
        planes_in.append(torch.from_numpy(a).to(dtype).to(device))
    scalars = [n, 0]
    for term in fp.terms:
        for _ in range(term[3] if term[0] == "runs" else 1):
            scalars += [0, 50]
    return "fused_limb_sums", (
        fp, tuple(planes_in),
        torch.tensor(scalars, dtype=torch.int32, device=device), G, n)


def replay(launches: list, device) -> list:
    """Launch each recorded kernel call once at the replay size on
    `device`; returns [(wrapper name, arguments, output)]."""
    from ..ops import fused_groupby, mxu_groupby

    fns = {"limb_sums": mxu_groupby.limb_sums,
           "fused_limb_sums": fused_groupby.fused_limb_sums}
    out = []
    for spec in launches:
        name, args = replay_inputs(spec, device)
        out.append((name, args, fns[name](*args)))
    return out


def _refuse(reason: str, name: str):
    from ..spi.metrics import SERVER_METRICS, ServerMeter

    SERVER_METRICS.add_meter(ServerMeter.AOT_CACHE_MISSES)
    _warn_once(("refuse", reason), "AOT record %s refused (%s); the family "
               "dispatches as usual", name, reason)
    return None


def load_artifact(path: str, expect_tag: dict = None, device="cuda"):
    """Check one record, replay its kernel launches on `device` and
    install the family. Returns the family key, or None on any refusal
    (unreadable or garbage file, format version, record checksum,
    environment mismatch, a replay that raises). Never raises."""
    name = os.path.basename(path)
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        return _refuse("unreadable", name)
    if faults.ACTIVE:
        data = faults.corrupt_at("aot.load", data, path=name)
    try:
        blob = pickle.loads(data)
        if blob.get("version") != _FORMAT_VERSION:
            return _refuse("format version", name)
        if _record_sha(blob) != blob["recordSha"]:
            return _refuse("record checksum", name)
        payload = blob["payload"]
        tag = expect_tag if expect_tag is not None else env_tag(device)
        if blob["envTag"] != tag:
            mism = [k for k in tag if blob["envTag"].get(k) != tag[k]]
            return _refuse(f"env mismatch ({','.join(mism) or '?'})", name)
        record = pickle.loads(payload)
        replay(record["launches"], device)
        gkey = record["gkey"]
    except Exception as e:
        return _refuse(f"{type(e).__name__}: {e}", name)
    _install(gkey, blob["fingerprint"], blob.get("family") or {})
    return gkey


def _install(gkey, fingerprint: str, family: dict) -> None:
    """Mark the family ready: the executor counts its first dispatch as a
    warm one (and every dispatch as an AOT hit), and the compile registry
    learns the key→fingerprint edge, so its dispatches register with no
    IR walk."""
    from . import executor
    from .compile_registry import COMPILE_REGISTRY

    with _LOCK:
        AOT_READY[gkey] = fingerprint
    executor._FAMILIES.note(gkey)
    COMPILE_REGISTRY.note_preloaded(gkey, fingerprint, family)


def _raw_table(name) -> str:
    """Normalize a type-suffixed internal name (``events_OFFLINE``) to the
    raw broker-facing name records are stamped with, so a table-load
    prewarm (internal name) finds records persisted at query time (raw
    name), and the other way round."""
    s = str(name)
    for suffix in ("_OFFLINE", "_REALTIME"):
        if s.endswith(suffix):
            return s[: -len(suffix)]
    return s


def _budget_candidates(items: list) -> list:
    """Cost-budgeted prewarm order: rank families by the LIVE registry
    score when the fingerprint is tracked in this process (cold cost ×
    dispatch recency — a family hot NOW outranks one that was merely
    expensive once), falling back to the persisted manifest score, then
    admit best-first while the summed expected cold cost stays within
    PINOT_TPU_AOT_PREWARM_BUDGET_MS (greedy fill: a family too costly for
    the remaining budget is skipped, cheaper ones behind it may still fit).
    Always admits at least one family so a cold process warms its most
    valuable one."""
    budget_ms = float(os.environ.get(
        "PINOT_TPU_AOT_PREWARM_BUDGET_MS", 5000.0))
    from .compile_registry import COMPILE_REGISTRY

    live = {fp: score for fp, score, _fam in COMPILE_REGISTRY.aot_priority()}
    ranked = sorted(
        ((live.get(m.get("fingerprint"), float(m.get("score", 0.0))),
          float(m.get("score", 0.0)), name) for name, m in items),
        reverse=True)
    out, spent = [], 0.0
    for _rank, cost_ms, name in ranked:
        if out and spent + cost_ms > budget_ms:
            continue
        out.append(name)
        spent += cost_ms
    return out


def prewarm_table(table, top_k: int = None, device="cuda") -> dict:
    """Replay and install the table's best persisted families on `device`
    (the table-load hook). All replay cost lands HERE, off the serving
    path, timed as aotPrewarmMs. Admission is budgeted by cold cost
    (PINOT_TPU_AOT_PREWARM_BUDGET_MS) unless a flat count is forced via
    the top_k arg or PINOT_TPU_AOT_PREWARM_TOP_K."""
    if not enabled():
        return {"loaded": 0, "refused": 0}
    d = cache_dir()
    env_k = os.environ.get("PINOT_TPU_AOT_PREWARM_TOP_K")
    t0 = time.perf_counter()
    want = None if table is None else _raw_table(table)
    with _LOCK:
        manifest = _load_manifest(d)
        items = [(name, m) for name, m in manifest["files"].items()
                 if want is None or _raw_table(m.get("table")) == want]
    if top_k is not None or env_k:
        k = int(top_k if top_k is not None else env_k)
        cand = [name for _, name in sorted(
            ((float(m.get("score", 0.0)), name) for name, m in items),
            reverse=True)[:k]]
    else:
        cand = _budget_candidates(items)
    with _LOCK:
        ready = set(AOT_READY.values())
    # a table registered again (a server loading its next segment) does
    # not replay the families it installed already
    cand = [name for name in cand
            if manifest["files"][name].get("fingerprint") not in ready]
    loaded = refused = 0
    tag = env_tag(device)
    for name in cand:
        if load_artifact(os.path.join(d, name), expect_tag=tag,
                         device=device) is not None:
            loaded += 1
        else:
            refused += 1
    if loaded and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    ms = round((time.perf_counter() - t0) * 1000, 3)
    if loaded or refused:
        from ..spi.metrics import SERVER_METRICS, ServerTimer

        SERVER_METRICS.update_timer(ServerTimer.AOT_PREWARM_MS, ms)
    return {"loaded": loaded, "refused": refused, "prewarmMs": ms}


def stats() -> dict:
    """A rollup of the cache (the JAX broker's /debug/compiles part)."""
    if not enabled():
        return {"enabled": False, "ready": len(AOT_READY)}
    d = cache_dir()
    with _LOCK:
        manifest = _load_manifest(d)
    files = manifest["files"]
    return {
        "enabled": True,
        "dir": d,
        "ready": len(AOT_READY),
        "artifacts": len(files),
        "bytes": sum(int(m.get("bytes", 0)) for m in files.values()),
        "budgetBytes": _budget_bytes(),
    }


def reset() -> None:
    """Drop the in-memory ready state (the records on disk stay)."""
    with _LOCK:
        AOT_READY.clear()
        _WARN_ONCE.clear()


def _warn_once(key, msg, *args) -> None:
    if key in _WARN_ONCE:
        return
    _WARN_ONCE.add(key)
    log.warning(msg, *args)
