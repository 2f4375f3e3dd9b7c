"""Stimulus protocols: the declarative external drive.

The port's counterpart of ``repro.core.stimulus``, with the pieces the main
path needs: the :class:`Stimulus` registry, :class:`CompiledStimulus` in
its separable ``basis x gate`` form and its general ``fn`` form, the
:class:`Drive` the engine evaluates once per step, and the paper's
``poisson_background``.  The other kinds (``dc``, ``step_current``,
``thalamic_pulses``) wait for a later slice.

Randomness: ``jax.random`` keys become one ``torch.Generator`` per session,
living on the session's device.  Each stochastic stimulus draws from it in
timeline order, so the counts differ from the reference's (the tests inject
the same counts into both packages through an ``fn`` stimulus instead).
No draw reads anything back to the host.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

REGISTRY: Dict[str, type] = {}


def register(kind: str):
    """Class decorator: register a :class:`Stimulus` subclass under ``kind``."""
    def deco(cls):
        if not (isinstance(cls, type) and issubclass(cls, Stimulus)):
            raise TypeError(f"@register({kind!r}) needs a Stimulus subclass, "
                            f"got {cls!r}")
        if kind in REGISTRY:
            raise ValueError(f"stimulus kind {kind!r} already registered")
        cls.kind = kind
        REGISTRY[kind] = cls
        return cls
    return deco


def available_stimuli() -> Tuple[str, ...]:
    return tuple(sorted(REGISTRY))


@dataclasses.dataclass(frozen=True, eq=False)
class CompiledStimulus:
    """One stimulus lowered against a connectome.

    Separable form: ``basis`` is a per-neuron ``[N]`` float32 array
    (expected spike count per step for ``"spikes"``, pA for
    ``"current"``) and ``gate`` an optional scalar function of the step
    counter (``None`` = always on).  General form: ``fn(generator,
    t_step, state) -> (I_ext | None, ext_in | None)`` on the session's
    device.
    """
    channel: str                                  # "spikes" | "current"
    basis: Optional[np.ndarray] = None            # [N] float32
    gate: Optional[Callable] = None               # t_step -> float
    fn: Optional[Callable] = None                 # general escape hatch
    stochastic: bool = False                      # draws from the generator

    def __post_init__(self):
        if (self.basis is None) == (self.fn is None):
            raise ValueError("CompiledStimulus needs exactly one of "
                             "basis= (separable) or fn= (general)")
        if self.channel not in ("spikes", "current"):
            raise ValueError(f"channel must be 'spikes' or 'current', "
                             f"got {self.channel!r}")


@dataclasses.dataclass(eq=False)
class Drive:
    """A compiled stimulus timeline: the engine-facing per-step drive.

    ``bases`` holds each separable stimulus's basis on the session's
    device (``None`` for ``fn`` stimuli), moved there once at compile time.
    """
    compiled: Tuple[CompiledStimulus, ...]
    bases: Tuple[Optional[torch.Tensor], ...] = ()

    def __call__(self, generator: Optional[torch.Generator], t_step: int,
                 state):
        """Evaluate every stimulus at ``t_step``; sums per channel.

        Returns ``(I_ext, ext_in)`` with ``None`` for a channel no stimulus
        feeds.  ``ext_in`` is an int32 spike count, as in the reference
        (``torch.poisson`` draws floats; the cast is exact).
        """
        I_ext, ext_in = None, None
        for s, basis in zip(self.compiled, self.bases):
            gen = generator if s.stochastic else None
            if s.fn is not None:
                i_c, e_c = s.fn(gen, t_step, state)
            else:
                val = basis if s.gate is None else basis * s.gate(t_step)
                if s.channel == "spikes":
                    i_c = None
                    e_c = torch.poisson(val, generator=gen).to(torch.int32)
                else:
                    i_c, e_c = val, None
            if i_c is not None:
                I_ext = i_c if I_ext is None else I_ext + i_c
            if e_c is not None:
                ext_in = e_c if ext_in is None else ext_in + e_c
        return I_ext, ext_in


@dataclasses.dataclass(frozen=True)
class Stimulus:
    """Base class: a declarative, hashable stimulus (a frozen dataclass
    registered via :func:`register`) that compiles against a connectome."""

    kind = "abstract"

    def compile(self, c, cfg, neuron) -> CompiledStimulus:
        raise NotImplementedError


def resolve_timeline(spec) -> Tuple[Stimulus, ...]:
    """Normalise a timeline: kind names and instances mix freely."""
    if isinstance(spec, (Stimulus, str)):
        spec = (spec,)
    out = []
    for s in spec:
        if isinstance(s, str):
            if s not in REGISTRY:
                raise ValueError(f"unknown stimulus kind {s!r}; "
                                 f"registered: {list(available_stimuli())}")
            s = REGISTRY[s]()
        elif not isinstance(s, Stimulus):
            raise TypeError(f"stimulus must be a kind name or Stimulus, "
                            f"got {type(s)}")
        out.append(s)
    return tuple(out)


def compile_drive(stimuli, c, cfg, neuron, device) -> Drive:
    """Lower a timeline against a connectome into a :class:`Drive` whose
    bases live on ``device``."""
    compiled = tuple(s.compile(c, cfg, neuron)
                     for s in resolve_timeline(stimuli))
    bases = tuple(None if s.basis is None
                  else torch.as_tensor(s.basis, device=device)
                  for s in compiled)
    return Drive(compiled=compiled, bases=bases)


def _window_gate(t_start_ms: float, t_stop_ms: Optional[float], dt: float):
    """Scalar 0/1 gate over [t_start, t_stop); ``None`` when always on (the
    always-on background then costs no extra op)."""
    start = int(round(t_start_ms / dt))
    stop = None if t_stop_ms is None else int(round(t_stop_ms / dt))
    if start <= 0 and stop is None:
        return None

    def gate(t_step: int) -> float:
        on = t_step >= start and (stop is None or t_step < stop)
        return 1.0 if on else 0.0
    return gate


@register("poisson_background")
@dataclasses.dataclass(frozen=True)
class PoissonBackground(Stimulus):
    """The paper's drive: ``k_ext`` independent Poisson sources per neuron
    at ``rate_hz``, delivered with the external weight ``w_ext``.  The
    basis is the reference's float32 rate product, bit for bit."""
    rate_hz: float = 8.0
    t_start_ms: float = 0.0
    t_stop_ms: Optional[float] = None

    def compile(self, c, cfg, neuron) -> CompiledStimulus:
        basis = (np.asarray(c.k_ext, np.float32)
                 * np.float32(self.rate_hz * cfg.dt * 1e-3))
        return CompiledStimulus(
            channel="spikes", basis=basis,
            gate=_window_gate(self.t_start_ms, self.t_stop_ms, cfg.dt),
            stochastic=True)
