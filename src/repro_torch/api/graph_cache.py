"""A counted cache of captured CUDA graphs.

The port's counterpart of ``repro.serve.compile_cache.ExecutableCache``
(``:49-166``).  The reference caches compiled XLA executables per
``(n_steps, probes)``; the port caches what replaces them, the CUDA graphs
of a run's step loop and the static buffers they read and write, per key.
``get_or_build(key, builder)`` is the only way an entry is made, so
``misses`` counts the captures: ``Simulator.run_chunked`` reads it to show
that chunks 2..N of one length capture nothing new.  Thread-safe.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Callable, Dict


class GraphCache:
    """A named, counted, thread-safe cache of captured graphs."""

    def __init__(self, name: str):
        self.name = name
        self.hits = 0
        self.misses = 0
        self._entries: "OrderedDict[Any, Any]" = OrderedDict()
        self._lock = threading.RLock()

    def get_or_build(self, key, builder: Callable[[], Any]):
        """The entry for ``key``, built (and a miss counted) at most once;
        the builder runs under the lock, so two threads never capture the
        same key twice."""
        with self._lock:
            if key in self._entries:
                self.hits += 1
                return self._entries[key]
            self.misses += 1
            value = builder()
            self._entries[key] = value
            return value

    def peek(self, key, default=None):
        """Lookup without building: a found entry counts a hit, a missing
        one counts nothing."""
        with self._lock:
            if key in self._entries:
                self.hits += 1
                return self._entries[key]
            return default

    def __contains__(self, key) -> bool:
        with self._lock:
            return key in self._entries

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def clear(self) -> None:
        """Drop every entry (the counters are history and stay)."""
        with self._lock:
            self._entries.clear()

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {"name": self.name, "entries": len(self._entries),
                    "hits": self.hits, "misses": self.misses}
