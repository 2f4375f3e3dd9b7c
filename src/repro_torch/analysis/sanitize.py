"""The capture guard: a budget of graph captures over a block of code.

The port's counterpart of ``repro.analysis.sanitize.RecompileGuard``.  It
reads the :class:`~repro_torch.serve.compile_cache.ExecutableCache`
counters: a miss is one builder call, which for a backend's graph cache
is one capture of a run's CUDA graphs (and for the backend pool one
backend built).  The paths that must capture nothing once warm
(``run_chunked`` chunks 2..N of a length already run, a batch's trials
after the first, ``Session.resume``) run under a zero budget, so a new
capture (a probe tuple rebuilt, a length drifting by one step) raises at
the call that caused it instead of showing as a slow run later.

The reference's ``sanitize()`` flips JAX's strict modes and has no
counterpart here.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple


class RecompileBudgetError(RuntimeError):
    """A guarded block captured (or built) more than its budget allows."""


def _cache_universe(caches=None):
    from repro_torch.serve.compile_cache import iter_caches
    return list(caches) if caches is not None else iter_caches()


class RecompileGuard:
    """Fail a block if its cache misses (captures) exceed ``budget``.

    ``caches=None`` guards every live cache in the process, those made
    inside the block included (a new cache starts at zero misses, so its
    captures count in full); a sequence scopes the guard to those caches,
    e.g. one backend's ``caches()``::

        with RecompileGuard(0, caches=backend.caches(), what="chunk 3"):
            backend.run(state, n_steps, probes)      # must replay only

    Each instance snapshots on its own, so guards nest; a guard costs two
    sweeps of host counters and touches no device.  ``compiles`` holds the
    block's misses after it.
    """

    def __init__(self, budget: int = 0, caches=None,
                 what: str = "guarded block"):
        if budget < 0:
            raise ValueError(f"budget must be >= 0, got {budget}")
        self.budget = int(budget)
        self.what = what
        self._caches = caches
        self._before: Dict[int, Tuple[str, int, frozenset]] = {}
        self.compiles: Optional[int] = None     # set on exit

    def __enter__(self) -> "RecompileGuard":
        self._before = {
            id(c): (c.name, c.misses, frozenset(map(str, c.keys())))
            for c in _cache_universe(self._caches)
        }
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        total = 0
        detail = []
        for c in _cache_universe(self._caches):
            name, before_misses, before_keys = self._before.get(
                id(c), (c.name, 0, frozenset()))
            delta = c.misses - before_misses
            if delta <= 0:
                continue
            total += delta
            new_keys = sorted(set(map(str, c.keys())) - before_keys)
            detail.append(f"{name}: +{delta} capture(s)"
                          + (f" (new keys: {', '.join(new_keys)})"
                             if new_keys else ""))
        self.compiles = total
        if exc_type is not None:        # don't mask the original error
            return
        if total > self.budget:
            raise RecompileBudgetError(
                f"{self.what}: captured {total} graph set(s), budget "
                f"{self.budget} -- " + "; ".join(detail))


def guard_compiles(budget: int = 0, caches=None,
                   what: str = "guarded block") -> RecompileGuard:
    """``with guard_compiles(0, what="resume"): ...``"""
    return RecompileGuard(budget=budget, caches=caches, what=what)
