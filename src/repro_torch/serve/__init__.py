"""Simulation as a service: many sessions over shared, warm backends.

The port's counterpart of ``repro.serve``, the deployment the paper
motivates with robotics and closed-loop work: long-lived sessions, each
with its own state, over shared built backends whose CUDA graphs are
captured once.

* :mod:`repro_torch.serve.compile_cache` -- the process-wide counted
  cache registry; every backend's graph cache and the backend pool are
  ``ExecutableCache`` instances, and ``cache_stats()["compiles"]`` counts
  the graph sets captured plus the backends built;
* :mod:`repro_torch.serve.session` -- ``SessionManager`` / ``Session``:
  create / run / suspend / resume / destroy, same-config sessions sharing
  one built backend, suspended sessions parked on checkpoints;
* :mod:`repro_torch.serve.batching` -- groups same-config run requests
  through the backend's ``run_batch`` (bitwise the sequential runs);
* :mod:`repro_torch.serve.http` -- a stdlib HTTP/JSON front end with the
  reference's protocol, streaming per-chunk snapshots
  (``python -m repro_torch.serve``).

``repro_torch.api.backends`` imports ``compile_cache`` from this package,
so everything else here resolves lazily (PEP 562) to stay cycle-free.
"""
from __future__ import annotations

from repro_torch.serve.compile_cache import (ExecutableCache, cache_stats,
                                             fingerprint,
                                             reset_cache_counters)

__all__ = [
    "ExecutableCache", "cache_stats", "fingerprint", "reset_cache_counters",
    "Session", "SessionManager", "BackendPool",
    "run_coalesced", "SimServer", "ServeClient",
]

_LAZY = {
    "Session": "repro_torch.serve.session",
    "SessionManager": "repro_torch.serve.session",
    "BackendPool": "repro_torch.serve.session",
    "run_coalesced": "repro_torch.serve.batching",
    "SimServer": "repro_torch.serve.http",
    "ServeClient": "repro_torch.serve.http",
}


def __getattr__(name):
    if name in _LAZY:
        import importlib
        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
