"""Device-memory pressure: one relief and one retry, then a clean failure.

The port of pinot_tpu/engine/oom.py (reference analogue:
pinot-core/.../transport/DirectOOMHandler.java, which sheds load on a
direct-memory OOM rather than letting the process die). The scarce
resource is the card's memory: a `torch.cuda.OutOfMemoryError` while
planes upload, a program dispatches or outputs are fetched triggers ONE
relief (every cached partial, stack and view of the device cache but the
executing segment's, then the realtime planes, then the allocator's cached
blocks) and one retry; a second OOM fails the QUERY with
HbmExhaustedError, never the process.

Torch raises OOM at the allocation, synchronously, so unlike XLA no output
buffer is left poisoned. `retry_fn` stays all the same: a fetch's inputs
may be the stacks relief freed, so its retry re-dispatches.

The server meters are the JAX package's: `hbmOomEvents` a relief,
`hbmOomEvictions` the device cache's victims, `hbmOomQueryFailures` a
query failed with HbmExhaustedError; `oom_stats()` adds the bytes freed
and the relief's host ms.
"""

from __future__ import annotations

import gc
import threading
import time
from typing import Callable, Optional

import torch

from ..spi.metrics import SERVER_METRICS, ServerMeter

# process counters: reliefs run, bytes they freed, their host ms, and
# queries failed with HbmExhaustedError
_STATS_LOCK = threading.Lock()
_STATS = {"reliefs": 0, "freedBytes": 0, "reliefMs": 0.0, "failures": 0}


def oom_stats() -> dict:
    with _STATS_LOCK:
        return dict(_STATS)


def reset_oom_stats() -> None:
    with _STATS_LOCK:
        _STATS.update(reliefs=0, freedBytes=0, reliefMs=0.0, failures=0)


def _note(**add) -> None:
    with _STATS_LOCK:
        for k, v in add.items():
            _STATS[k] += v


class HbmExhaustedError(Exception):
    """Device memory exhausted even after relief; the query fails alone
    (reference: a QueryException on OOM)."""


def is_hbm_oom(exc: BaseException) -> bool:
    """`torch.cuda.OutOfMemoryError` and MemoryError; another RuntimeError
    only with the unambiguous RESOURCE_EXHAUSTED tag (a host-side failure
    must not evict the device)."""
    if isinstance(exc, (torch.cuda.OutOfMemoryError, MemoryError)):
        return True
    return isinstance(exc, RuntimeError) \
        and "resource_exhausted" in str(exc).lower()


def relieve_pressure(keep_segment=None, cache=None) -> int:
    """Evict every cached partial, stack and view of `cache` (an
    executor's DeviceSegmentCache) but `keep_segment`'s, then every
    realtime plane set but the one under `keep_segment` (a snapshot's
    underlying segment: its planes back the retry), then release the
    allocator's cached blocks. Returns the bytes freed (of the caches'
    accounting)."""
    from ..realtime.device_plane import REALTIME_PLANES

    freed = 0
    if cache is not None:
        freed, victims = cache.evict_all_except(keep_segment)
        if victims:
            SERVER_METRICS.add_meter(ServerMeter.HBM_OOM_EVICTIONS, victims)
    freed += REALTIME_PLANES.clear(keep=getattr(keep_segment, "_seg",
                                                keep_segment))
    gc.collect()  # drop tensors only reference cycles still hold
    if torch.cuda.is_initialized():
        torch.cuda.empty_cache()
    return freed


def with_oom_retry(fn: Callable, keep_segment=None, cache=None,
                   retry_fn: Optional[Callable] = None,
                   on_relief: Optional[Callable[[int], None]] = None):
    """Run `fn`; on a device OOM relieve pressure once and run `retry_fn`
    (default `fn`); on a second OOM raise HbmExhaustedError. Any other
    exception passes through untouched."""
    try:
        return fn()
    except Exception as e:  # noqa: BLE001 - classified, re-raised if not OOM
        if not is_hbm_oom(e):
            raise
    SERVER_METRICS.add_meter(ServerMeter.HBM_OOM_EVENTS)
    t0 = time.perf_counter()
    freed = relieve_pressure(keep_segment, cache)
    _note(reliefs=1, freedBytes=freed,
          reliefMs=(time.perf_counter() - t0) * 1e3)
    if on_relief is not None:
        on_relief(freed)
    try:
        return (retry_fn or fn)()
    except Exception as e:  # noqa: BLE001
        if not is_hbm_oom(e):
            raise
        SERVER_METRICS.add_meter(ServerMeter.HBM_OOM_QUERY_FAILURES)
        _note(failures=1)
        raise HbmExhaustedError(
            f"device memory exhausted after relieving {freed} cached bytes "
            f"and retrying: {e}") from e
