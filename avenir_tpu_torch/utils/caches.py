"""Bounded LRU caches for compiled/jitted functions.

Every engine keeps a small dict of jitted functions keyed by
(mesh, shapes, constants).  Python 3.7+ dicts preserve insertion order,
so eviction pops the first key; a plain get() would make that FIFO —
a workload alternating among more than ``cap`` distinct configurations
would evict and recompile its hottest function on every call.  These
helpers make hits refresh recency (move-to-end), turning the bound
into a true LRU (advisor finding, round 4).

Thread safety: the serving subsystem (``avenir_tpu.serve``) hits these
caches from its per-model batcher threads while a concurrent warmup or
hot-swap reload populates them, so get/put run under one module-level
lock.  The pop+reinsert and evict-while-over-cap sequences are each a
handful of dict ops — a single shared lock is cheaper than per-cache
locks and cannot deadlock (no callback runs under it).  Compilation
itself happens OUTSIDE the lock (callers build the value first, then
put), so a slow scorer build never serializes unrelated cache traffic.
"""

from __future__ import annotations

import threading
from typing import Any, Optional

_DEFAULT_CAP = 4

_LOCK = threading.Lock()


def bounded_cache_get(cache: dict, key) -> Optional[Any]:
    """Return ``cache[key]`` (refreshing its recency) or None."""
    with _LOCK:
        val = cache.pop(key, None)
        if val is not None:
            cache[key] = val        # re-insert: now most recently used
        return val


def bounded_cache_put(cache: dict, key, value,
                      cap: int = _DEFAULT_CAP) -> None:
    """Insert ``key -> value``, evicting the least recently used entry
    once the cache holds ``cap`` items."""
    with _LOCK:
        cache.pop(key, None)
        while len(cache) >= cap:
            cache.pop(next(iter(cache)))
        cache[key] = value


def bounded_cache_clear(cache: dict) -> None:
    """Drop every entry (under the same lock the readers use)."""
    with _LOCK:
        cache.clear()
