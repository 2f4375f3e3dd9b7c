"""Runtime checks of the port: ``sanitize()`` and the capture guard.

The counterparts of ``repro.analysis.sanitize``'s two guards, for what
the static linter cannot see:

:func:`sanitize`
    A context manager for debugging a run, the counterpart of the
    reference's JAX strict modes (``jax_debug_nans``,
    ``jax_numpy_dtype_promotion="strict"``), in three checks:

    * ``nan_check``: after each backend run, the neuron state (V, the
      currents; and the plastic weights and traces) must be finite.  If it
      is not, the run is stepped again eagerly from a copy of the state it
      started from (and of its generator), and the first step that leaves
      a non-finite value raises ``FloatingPointError`` naming the step and
      the tensor.  The ring holds arrivals in flight and is not checked: a
      non-finite arrival is caught at the step it reaches a current.  Each
      run copies its starting state once (2.1 GB at full scale with pair
      STDP), so this is for debugging, not for timing;
    * ``strict_dtypes``: a dispatch mode over the block raises
      :class:`StrictDtypeError` on an op that mixes floating dtypes
      without an explicit cast (``.to``, ``copy_``), or that makes a
      float64 tensor;
      ops captured in a CUDA graph are checked at capture, which is where
      their dtypes are fixed;
    * ``sync_check``: on the card, the backend's steps (its graph replays,
      or its eager loop) run under ``torch.cuda.set_sync_debug_mode(
      "error")``, so a host sync inside a step raises.  The session's
      once-per-run reads (the overflow count) lie outside.

    Every flag and mode is restored on exit, also after an exception.

:class:`RecompileGuard`
    A budget of graph captures over a block of code.  It reads the
    :class:`~repro_torch.serve.compile_cache.ExecutableCache` counters: a
    miss is one builder call, which for a backend's graph cache is one
    capture of a run's CUDA graphs (and for the backend pool one backend
    built).  The paths that must capture nothing once warm (``run_chunked``
    chunks 2..N of a length already run, a batch's trials after the first,
    ``Session.resume``) run under a zero budget, so a new capture (a probe
    tuple rebuilt, a length drifting by one step) raises at the call that
    caused it instead of showing as a slow run later.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Dict, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode


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


# ---------------------------------------------------------------------------
# sanitize(): the non-finite check, strict dtypes, the sync check
# ---------------------------------------------------------------------------

#: the checks of the innermost ``sanitize()`` open in this context
_ACTIVE: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_sanitize", default=None)

#: ops that cast on purpose: a dtype change through them is explicit
_EXPLICIT_CASTS = frozenset({"aten._to_copy", "aten.copy_", "aten.copy"})
_ALIASES = frozenset({"aten.detach", "aten.lift_fresh", "aten.alias"})


class StrictDtypeError(ValueError):
    """An op under ``sanitize(strict_dtypes=True)`` mixed floating dtypes
    or made a float64 tensor.  (Not a ``TypeError``: PyTorch turns one
    raised inside a binary operator into ``NotImplemented``.)"""


class _Checks:
    def __init__(self, nan_check: bool, sync_check: bool):
        self.nan_check = nan_check
        self.sync_check = sync_check


def active_checks() -> Optional[_Checks]:
    """The checks of the innermost open ``sanitize()``, or None."""
    return _ACTIVE.get()


def _tensors(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    return []


class _StrictDtypes(TorchDispatchMode):
    """Raises on an op that mixes floating dtypes without an explicit cast,
    or that makes a float64 tensor."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = str(func.overloadpacket)
        if name not in _EXPLICIT_CASTS:
            floats = {t.dtype for t in _tensors((args, kwargs))
                      if t.is_floating_point()}
            if len(floats) > 1:
                raise StrictDtypeError(
                    f"sanitize(strict_dtypes): {name} mixes "
                    f"{sorted(map(str, floats))} without an explicit cast")
        out = func(*args, **kwargs)
        if name not in _ALIASES and not getattr(func, "is_view", False) \
                and any(t.dtype == torch.float64 for t in _tensors(out)):
            raise StrictDtypeError(
                f"sanitize(strict_dtypes): {name} makes a float64 tensor; "
                f"the engine is float32/bf16")
        return out


@contextlib.contextmanager
def sanitize(nan_check: bool = True, strict_dtypes: bool = True,
             sync_check: bool = True):
    """Run a block under the port's strict checks (the module's
    docstring), restoring every flag and mode on exit."""
    token = _ACTIVE.set(_Checks(nan_check, sync_check))
    try:
        with (_StrictDtypes() if strict_dtypes
              else contextlib.nullcontext()):
            yield
    finally:
        _ACTIVE.reset(token)


@contextlib.contextmanager
def _sync_errors(device: torch.device):
    """``torch.cuda.set_sync_debug_mode("error")`` on a card, restored
    after (the mode is process-wide)."""
    if device.type != "cuda":
        yield
        return
    before = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(before)


def _checked_leaves(state) -> list:
    """(name, tensor) of the state's neuron tensors, and of a plastic
    state's weights and traces; the ring (arrivals in flight) is not."""
    out = []
    for part in (state if isinstance(state, tuple)
                 and not hasattr(state, "_fields") else (state,)):
        if part is None:
            continue
        src = getattr(part, "neuron", part)
        for name in ("V", "I_ex", "I_in", "weights", "x_pre", "x_post"):
            x = getattr(src, name, None)
            if isinstance(x, torch.Tensor):
                out.append((name, x))
    return out


def _first_non_finite(state) -> Optional[Tuple[str, int]]:
    for name, x in _checked_leaves(state):
        bad = int((~torch.isfinite(x)).sum())
        if bad:
            return name, bad
    return None


def checked_run(backend, run, state, n_steps: int, probes, stream):
    """``run(backend, state, n_steps, probes, stream)`` under the checks of
    the innermost open ``sanitize()`` (just the run when none is open)."""
    checks = _ACTIVE.get()
    if checks is None:
        return run(backend, state, n_steps, probes, stream)
    start = None
    if checks.nan_check:
        from repro_torch.api.backends import _clone_generator, tree_map
        sim, ps = backend._split_state(state)
        start = (tree_map(torch.clone, sim)._replace(
            generator=_clone_generator(sim.generator)),
            None if ps is None else tree_map(torch.clone, ps))
    sync = _sync_errors(backend.device) if checks.sync_check \
        else contextlib.nullcontext()
    with sync:
        out = run(backend, state, n_steps, probes, stream)
    if start is not None and _first_non_finite(out[0]) is not None:
        _locate_non_finite(backend, start, n_steps)
    return out


def _locate_non_finite(backend, start, n_steps: int) -> None:
    """Step a copy of the run's starting state eagerly, one step at a
    time, and raise at the first step that leaves a non-finite value."""
    sim, ps = start
    t0 = int(sim.t)
    carry = backend._carry(sim if ps is None else (sim, ps), (), None)
    world = getattr(backend, "world", None)
    for i in range(n_steps if world is None or world.size == 1 else 0):
        carry, _ = backend._step(carry, min(i, backend.head))
        bad = _first_non_finite(backend._state_of(carry))
        if bad is not None:
            raise FloatingPointError(
                f"sanitize(nan_check): step {i} of this run (step counter "
                f"t = {t0 + i}) left {bad[0]} non-finite ({bad[1]} "
                f"element(s))")
    name, count = _first_non_finite(
        backend._state_of(backend._epilogue(carry, n_steps))) \
        or ("the state", 0)
    raise FloatingPointError(
        f"sanitize(nan_check): the run of {n_steps} steps from t = {t0} "
        f"left {name} non-finite ({count} element(s)) at its end")
