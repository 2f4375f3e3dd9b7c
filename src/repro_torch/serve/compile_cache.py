"""The process-wide, counted cache registry: the port's one counted cache.

The port's counterpart of ``repro.serve.compile_cache``.  What a
simulation service must pay for once and share is, in the port, the CUDA
graphs of a run's step loop (with the static buffers they read and
write) and the built backends (the connectome's device tables).  A
server that multiplexes many sessions over one network must capture each
graph set once and build each backend once.

:class:`ExecutableCache`
    A thread-safe, optionally LRU-bounded mapping with hit / miss /
    eviction counters.  Every backend's graph cache is one
    (``repro_torch.api.graph_cache.GraphCache`` is this class), and
    ``repro_torch.serve.session.BackendPool`` keeps its built backends in
    a bounded one.

:func:`cache_stats`
    Counters summed over every live cache in the process: the
    ``GET /stats`` payload of the HTTP front end, and what the tests of
    shared captures read ("the same scenario twice -> no new capture").

Keys are two-level: a backend is keyed on what its ``build`` depends on
(:func:`fingerprint` of the model, stimulus, plasticity and backend
name), each backend's graph sets on ``(n_steps, probes, graph_steps)``.

The builder of an entry runs under the cache's build lock, which
serialises builds; the counters and entries have a lock of their own,
held only briefly, so ``stats`` answers while a build (a capture, or a
backend's connectome) runs on another thread.  Stdlib only:
``repro_torch.api`` imports this module.
"""
from __future__ import annotations

import hashlib
import json
import threading
import weakref
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional

# every live ExecutableCache, for cache_stats(); weak, so that a dropped
# backend (an evicted BackendPool entry no session holds) takes its
# counters with it
_CACHES: "weakref.WeakSet[ExecutableCache]" = weakref.WeakSet()
_LOCK = threading.Lock()


class ExecutableCache:
    """A named, counted, thread-safe cache of expensive build artifacts.

    ``get_or_build(key, builder)`` is the only way an entry is made, so
    ``misses`` is the number of builder calls: for a backend's graph
    cache the number of graph-set captures, for the backend pool the
    number of backends built.  ``peek`` looks up without building (a found
    entry counts a hit, a missing one nothing).

    ``capacity=None`` is unbounded (a backend's graph cache); a bounded
    cache evicts the least recently used entry and counts ``evictions``
    (the backend pool bounds device memory so).
    """

    def __init__(self, name: str, capacity: Optional[int] = None):
        if capacity is not None and capacity < 1:
            raise ValueError(f"capacity must be >= 1 or None, got {capacity}")
        self.name = name
        self.capacity = capacity
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self._entries: "OrderedDict[Any, Any]" = OrderedDict()
        self._lock = threading.RLock()
        self._build_lock = threading.RLock()
        self._evict_hooks: List[Callable[[Any, Any], None]] = []
        with _LOCK:
            _CACHES.add(self)

    # -- the one creation path ---------------------------------------------

    def get_or_build(self, key, builder: Callable[[], Any]):
        """The entry for ``key``, built (and a miss counted) at most once.
        Builds are serialised: two threads never build one key twice."""
        with self._build_lock:
            with self._lock:
                if key in self._entries:
                    self.hits += 1
                    self._entries.move_to_end(key)
                    return self._entries[key]
                self.misses += 1
            value = builder()
            with self._lock:
                self._entries[key] = value
                self._maybe_evict()
            return value

    def peek(self, key, default=None):
        """Lookup without building: a found entry counts a hit, a missing
        one counts nothing."""
        with self._lock:
            if key in self._entries:
                self.hits += 1
                self._entries.move_to_end(key)
                return self._entries[key]
            return default

    # -- mapping conveniences (no counter side effects) ---------------------

    def __contains__(self, key) -> bool:
        with self._lock:
            return key in self._entries

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def keys(self):
        with self._lock:
            return list(self._entries.keys())

    def clear(self) -> None:
        """Drop every entry (each counted as an eviction; the hit and miss
        counters are history and stay)."""
        with self._lock:
            for key in list(self._entries):
                self._evict(key)

    def on_evict(self, hook: Callable[[Any, Any], None]) -> None:
        """Register ``hook(key, value)``, run when an entry is evicted (LRU
        or ``clear``)."""
        self._evict_hooks.append(hook)

    def _maybe_evict(self) -> None:
        if self.capacity is None:
            return
        while len(self._entries) > self.capacity:
            self._evict(next(iter(self._entries)))

    def _evict(self, key) -> None:
        value = self._entries.pop(key)
        self.evictions += 1
        for hook in self._evict_hooks:
            hook(key, value)

    # -- introspection ------------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "name": self.name,
                "entries": len(self._entries),
                "capacity": self.capacity,
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
            }

    def entry_keys(self) -> List[str]:
        """Human-readable entry keys (for the flat /stats view)."""
        with self._lock:
            return [_describe_key(k) for k in self._entries]

    def __repr__(self) -> str:
        s = self.stats()
        return (f"ExecutableCache({self.name!r}, entries={s['entries']}, "
                f"hits={s['hits']}, misses={s['misses']}, "
                f"evictions={s['evictions']})")


def _describe_key(key) -> str:
    """Render a cache key compactly; probe instances show their names."""
    if isinstance(key, tuple):
        return "(" + ", ".join(_describe_key(k) for k in key) + ")"
    name = getattr(key, "name", None)
    if name is not None and not isinstance(key, (str, bytes)):
        return str(name)
    return repr(key)


# ---------------------------------------------------------------------------
# Process-wide aggregation
# ---------------------------------------------------------------------------

def iter_caches() -> List[ExecutableCache]:
    with _LOCK:
        return sorted(_CACHES, key=lambda c: c.name)


def cache_stats(include_keys: bool = False) -> Dict[str, Any]:
    """Counters summed over every live cache in the process.

    ``compiles`` (the reference's name, kept for its JSON protocol) is the
    misses summed over every cache: in the port, the CUDA graph sets
    captured plus the backends the pool built.  On CPU tensors the fused
    backend captures nothing, so there it counts the pool's builds.  Host
    only: nothing here touches the device.
    """
    caches = []
    totals = {"entries": 0, "hits": 0, "misses": 0, "evictions": 0}
    for c in iter_caches():
        s = c.stats()
        if include_keys:
            s["keys"] = c.entry_keys()
        caches.append(s)
        for k in totals:
            totals[k] += s[k]
    return {"caches": caches, "totals": totals,
            "compiles": totals["misses"]}


def reset_cache_counters() -> None:
    """Zero every cache's counters (entries are kept): test isolation."""
    for c in iter_caches():
        with c._lock:
            c.hits = c.misses = c.evictions = 0


# ---------------------------------------------------------------------------
# Config fingerprinting
# ---------------------------------------------------------------------------

def fingerprint(obj: Any) -> str:
    """Stable hex digest of a JSON-able config structure (the reference's
    digest: the same dict gives the same key in both packages).

    Keys backend sharing: two sessions whose build-relevant spec (model,
    stimulus, plasticity, backend) canonicalises to the same JSON share
    one built backend and therefore its captured graphs.  A spec that is
    not JSON-able raises ``TypeError``; callers then build a private
    backend.
    """
    blob = json.dumps(obj, sort_keys=True, separators=(",", ":"),
                      default=_json_default)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def _json_default(o):
    # numpy scalars and arrays appear in config dicts (e.g. seeds):
    # normalise the common ones, refuse the rest loudly
    if hasattr(o, "item") and not hasattr(o, "__len__"):
        return o.item()
    if hasattr(o, "tolist"):
        return o.tolist()
    raise TypeError(f"not fingerprintable: {type(o).__name__}")
