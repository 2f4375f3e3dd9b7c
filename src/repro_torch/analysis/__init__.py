"""Static analysis and runtime checks guarding the port's hot path.

Four layers, one subsystem (``python -m repro_torch.analysis --help``),
the counterparts of ``repro.analysis``'s:

* :mod:`repro_torch.analysis.lint` -- AST rules RL001-RL005 (host syncs,
  branches on tensors, plugin conformance, dtype discipline, unlocked
  shared state);
* :mod:`repro_torch.analysis.sanitize` -- at run time: :func:`sanitize`
  (the non-finite check, strict dtypes, CUDA's sync-debug mode) and
  :class:`RecompileGuard` (capture budgets over the graph caches);
* :mod:`repro_torch.analysis.graph_contract` -- GC001-GC004 on what the
  captured step dispatches;
* :mod:`repro_torch.analysis.report` -- the ``repro.analysis_report/v1``
  JSON schema and the baseline's grandfathering diff.

Only the runtime pieces import eagerly (the backends import the guard and
the sanitizer's hook); the analysis passes load at first use.
"""
from repro_torch.analysis.report import (BASELINE_SCHEMA,  # noqa: F401
                                         REPORT_SCHEMA, BaselineEntry, Diff,
                                         Finding, diff_findings,
                                         load_baseline, make_report,
                                         write_report)
from repro_torch.analysis.sanitize import (RecompileBudgetError,  # noqa: F401
                                           RecompileGuard, guard_compiles,
                                           sanitize)

__all__ = [
    "Finding", "BaselineEntry", "Diff", "diff_findings", "load_baseline",
    "make_report", "write_report", "REPORT_SCHEMA", "BASELINE_SCHEMA",
    "sanitize", "RecompileGuard", "RecompileBudgetError", "guard_compiles",
    "lint", "graph_contract",
]


def __getattr__(name):
    # the lint and graph passes are CLI and test tools, not hot-path imports
    if name in ("lint", "graph_contract"):
        import importlib
        return importlib.import_module(f"repro_torch.analysis.{name}")
    raise AttributeError(
        f"module 'repro_torch.analysis' has no attribute {name!r}")
