"""The counted cache of captured CUDA graphs.

``GraphCache`` is :class:`repro_torch.serve.compile_cache.ExecutableCache`,
unbounded: every backend's graph cache registers in that module's
process-wide registry, so ``cache_stats()`` counts its captures.  A
backend caches per ``(n_steps, probes, graph_steps)`` what replaces the
reference's compiled XLA executables: the CUDA graphs of a run's step loop
and the static buffers they read and write.  ``misses`` counts the
captures: ``Simulator.run_chunked`` and ``run_batch`` and
``Session.resume`` guard on it (``repro_torch.analysis.sanitize``).
"""
from repro_torch.serve.compile_cache import ExecutableCache as GraphCache

__all__ = ["GraphCache"]
