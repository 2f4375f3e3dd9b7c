"""Stimulus protocols: the declarative external drive.

The port's counterpart of ``repro.core.stimulus``: the :class:`Stimulus`
registry (each kind a frozen dataclass, ``to_dict`` / ``from_dict`` for
JSON), :class:`CompiledStimulus` in its separable ``basis x gate`` form and
its general ``fn`` form, the :class:`Drive` the engine evaluates once per
step, and the four built-ins::

    poisson_background(rate_hz=8.0)   the paper's drive: k_ext Poisson
                                      sources per neuron at rate_hz
    dc(amplitude_pa=None)             DC current; None derives the mean
                                      current of the background it replaces
    step_current(amplitude_pa=...)    a current step into chosen
                                      populations over a window
    thalamic_pulses(...)              the PD-2014 thalamic pulses into L4/L6

``Drive.plan`` and ``padded_bases`` give a separable timeline's structure
over a world padded to ``n_pad`` neurons, as the reference's sharded engine
takes it; ``Drive.shard`` is the drive of one rank's slice of that world
(``repro_torch.core.distributed``), which draws over the slice exactly as
the whole drive draws over all neurons.

A gate is a tensor function of the step counter ``t`` (the engine's 0-d
int32 tensor on the session's device), as the reference's are functions of
its traced counter: a window is ``((t >= start) & (t < stop))`` as float32.
So a run captured in a CUDA graph evaluates every gate on the device, at
the counter of its replay.  An always-on stimulus has ``gate=None`` and
pays no gate op (the paper's background among them).  Windows are in
absolute session model time (``t * dt``), which includes the presim.

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

from repro_torch.core import params as P

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
    ``"current"``) and ``gate`` an optional float32 tensor function of the
    step counter (``None`` = always on).  General form: ``fn(generator,
    t, state) -> (I_ext | None, ext_in | None)`` on the session's device,
    ``t`` the counter tensor.
    """
    channel: str                                  # "spikes" | "current"
    basis: Optional[np.ndarray] = None            # [N] float32
    gate: Optional[Callable] = None               # t -> 0-d float32 tensor
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

    def __call__(self, generator: Optional[torch.Generator], t_step, state):
        """Evaluate every stimulus at step ``t_step`` (the counter tensor);
        sums per channel.

        Returns ``(I_ext, ext_cnt)`` with ``None`` for a channel no
        stimulus feeds.  ``ext_cnt`` is the spike counts in float32, as
        every loop takes them: ``torch.poisson``'s draws as they come, an
        ``fn`` stimulus's counts cast once and not truncated (the
        reference allows scaled counts and uses them as they are).  The
        draws are whole numbers and their sums stay below 2**24, so
        ``w_ext`` times them is the reference's product of its int32
        counts, bit for bit."""
        I_ext, ext_cnt = None, None
        for s, basis in zip(self.compiled, self.bases):
            gen = generator if s.stochastic else None
            if s.fn is not None:
                i_c, e_c = s.fn(gen, t_step, state)
                if e_c is not None:
                    e_c = e_c.to(torch.float32)
            else:
                val = basis if s.gate is None else basis * s.gate(t_step)
                if s.channel == "spikes":
                    i_c, e_c = None, torch.poisson(val, generator=gen)
                else:
                    i_c, e_c = val, None
            if i_c is not None:
                I_ext = i_c if I_ext is None else I_ext + i_c
            if e_c is not None:
                ext_cnt = e_c if ext_cnt is None else ext_cnt + e_c
        return I_ext, ext_cnt

    @property
    def separable(self) -> bool:
        """True when every stimulus is in ``basis x gate`` form (all the
        built-ins are)."""
        return all(s.fn is None for s in self.compiled)

    def plan(self):
        """(spike, current) lists of ``(basis [N] f32, gate)`` pairs -- the
        structure the sharded engine shards over ranks.  Raises for
        non-separable timelines."""
        if not self.separable:
            bad = [s for s in self.compiled if s.fn is not None]
            raise NotImplementedError(
                f"{len(bad)} stimulus(es) compile to a general fn (not a "
                f"basis x gate form); the sharded engine supports "
                f"separable stimuli only -- run them on the fused or "
                f"instrumented backend")
        spk = [(s.basis, s.gate) for s in self.compiled
               if s.channel == "spikes"]
        cur = [(s.basis, s.gate) for s in self.compiled
               if s.channel == "current"]
        return spk, cur

    def padded_bases(self, n_pad: int):
        """Stacked basis arrays zero-padded to ``n_pad`` neurons:
        ``(spike_bases [Ks, n_pad], cur_bases [Kc, n_pad])`` float32 numpy
        (padding neurons receive no drive)."""
        spk, cur = self.plan()

        def stack(rows):
            out = np.zeros((len(rows), n_pad), np.float32)
            for i, (basis, _) in enumerate(rows):
                out[i, :basis.shape[0]] = basis
            return out
        return stack(spk), stack(cur)

    def shard(self, n_pad: int, lo: int, hi: int, device) -> "Drive":
        """The drive of neurons ``[lo, hi)`` of the world padded to
        ``n_pad``: every stimulus in timeline order with its gate, its basis
        zero-padded and sliced, on ``device``.  Called with a generator it
        draws ``torch.poisson`` over the slice, stimulus by stimulus, as
        the whole drive does over all neurons.  Raises for non-separable
        timelines."""
        self.plan()
        bases = []
        for s in self.compiled:
            padded = np.zeros(n_pad, np.float32)
            padded[:s.basis.shape[0]] = s.basis
            bases.append(torch.as_tensor(padded[lo:hi].copy(),
                                         device=device))
        return Drive(compiled=self.compiled, bases=tuple(bases))


@dataclasses.dataclass(frozen=True)
class Stimulus:
    """Base class: a declarative, hashable, JSON-serializable stimulus (a
    frozen dataclass registered via :func:`register`) that compiles against
    a connectome."""

    kind = "abstract"

    def compile(self, c, cfg, neuron) -> CompiledStimulus:
        raise NotImplementedError

    def to_dict(self) -> dict:
        d = {"kind": self.kind}
        d.update(dataclasses.asdict(self))
        return d

    @staticmethod
    def from_dict(d: dict) -> "Stimulus":
        d = dict(d)
        kind = d.pop("kind", None)
        if kind not in REGISTRY:
            raise ValueError(f"unknown stimulus kind {kind!r}; "
                             f"registered: {list(available_stimuli())}")
        cls = REGISTRY[kind]
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown field(s) {sorted(unknown)} for "
                             f"stimulus {kind!r} (known: {sorted(known)})")
        return cls(**d)


def resolve_timeline(spec) -> Tuple[Stimulus, ...]:
    """Normalise a timeline: kind names, dicts (through
    :meth:`Stimulus.from_dict`) and instances mix freely."""
    if isinstance(spec, (Stimulus, str, dict)):
        spec = (spec,)
    out = []
    for s in spec:
        if isinstance(s, str):
            if s not in REGISTRY:
                raise ValueError(f"unknown stimulus kind {s!r}; "
                                 f"registered: {list(available_stimuli())}")
            s = REGISTRY[s]()
        elif isinstance(s, dict):
            s = Stimulus.from_dict(s)
        elif not isinstance(s, Stimulus):
            raise TypeError(f"stimulus must be a kind name, dict or "
                            f"Stimulus, got {type(s)}")
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


# ---------------------------------------------------------------------------
# Shared helpers for the built-ins
# ---------------------------------------------------------------------------

def _window_gate(t_start_ms: float, t_stop_ms: Optional[float], dt: float):
    """0/1 float32 gate over [t_start, t_stop); ``None`` when always on (the
    always-on background then costs no extra op)."""
    start = int(round(t_start_ms / dt))
    stop = None if t_stop_ms is None else int(round(t_stop_ms / dt))
    if start <= 0 and stop is None:
        return None

    def gate(t):
        on = t >= start
        if stop is not None:
            on = on & (t < stop)
        return on.to(torch.float32)
    return gate


def _population_mask(c, populations) -> np.ndarray:
    """[N] float32 membership mask; ``None`` selects every population."""
    if populations is None:
        return np.ones(c.n_total, np.float32)
    names = tuple(populations)
    unknown = set(names) - set(P.POPULATIONS)
    if unknown:
        raise ValueError(f"unknown population(s) {sorted(unknown)}; "
                         f"model has {list(P.POPULATIONS)}")
    sel = np.array([P.POPULATIONS.index(p) for p in names])
    return np.isin(np.asarray(c.pop_of), sel).astype(np.float32)


def _tupled(value):
    return value if value is None else tuple(value)


# ---------------------------------------------------------------------------
# Built-in registry entries
# ---------------------------------------------------------------------------

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


@register("dc")
@dataclasses.dataclass(frozen=True)
class DCInput(Stimulus):
    """DC current drive (pA per neuron).

    ``amplitude_pa=None`` derives the mean current of the Poisson
    background it replaces (NEST microcircuit ``poisson_input=False``):
    ``I = 1e-3 * tau_syn_ex * rate_hz * k_ext * w_ext``.  An explicit
    amplitude applies uniformly over the selected ``populations``.
    """
    amplitude_pa: Optional[float] = None
    rate_hz: float = 8.0            # used only when amplitude_pa is None
    populations: Optional[Tuple[str, ...]] = None
    t_start_ms: float = 0.0
    t_stop_ms: Optional[float] = None

    def __post_init__(self):
        object.__setattr__(self, "populations", _tupled(self.populations))

    def compile(self, c, cfg, neuron) -> CompiledStimulus:
        mask = _population_mask(c, self.populations)
        if self.amplitude_pa is None:
            amp = (1e-3 * neuron.tau_syn_ex * self.rate_hz
                   * np.asarray(c.k_ext, np.float64) * float(c.w_ext))
        else:
            amp = float(self.amplitude_pa)
        basis = (mask * amp).astype(np.float32)
        return CompiledStimulus(
            channel="current", basis=basis,
            gate=_window_gate(self.t_start_ms, self.t_stop_ms, cfg.dt),
            stochastic=False)


@register("step_current")
@dataclasses.dataclass(frozen=True)
class StepCurrent(Stimulus):
    """Constant current step into selected populations over a window."""
    amplitude_pa: float = 0.0
    populations: Optional[Tuple[str, ...]] = None
    t_start_ms: float = 0.0
    t_stop_ms: Optional[float] = None

    def __post_init__(self):
        object.__setattr__(self, "populations", _tupled(self.populations))

    def compile(self, c, cfg, neuron) -> CompiledStimulus:
        basis = (_population_mask(c, self.populations)
                 * np.float32(self.amplitude_pa)).astype(np.float32)
        return CompiledStimulus(
            channel="current", basis=basis,
            gate=_window_gate(self.t_start_ms, self.t_stop_ms, cfg.dt),
            stochastic=False)


@register("thalamic_pulses")
@dataclasses.dataclass(frozen=True)
class ThalamicPulses(Stimulus):
    """PD-2014 thalamic stimulation: ``n_thal=902`` relay neurons firing at
    ``rate_hz`` during ``duration_ms`` pulses every ``interval_ms``, into
    L4E/L4I/L6E/L6I through ``params.THAL_CONN_PROBS``; the in-degrees
    scale with the connectome's ``k_scaling``, and deliveries use the
    external weight ``w_ext``."""
    rate_hz: float = 120.0
    start_ms: float = 700.0
    interval_ms: float = 1000.0
    duration_ms: float = 10.0
    n_pulses: Optional[int] = None   # None: pulse until the run ends

    def compile(self, c, cfg, neuron) -> CompiledStimulus:
        k_th = P.thalamic_indegrees(getattr(c, "k_scaling", 1.0))
        basis = (k_th[np.asarray(c.pop_of)]
                 * np.float64(self.rate_hz * cfg.dt * 1e-3)
                 ).astype(np.float32)
        start = int(round(self.start_ms / cfg.dt))
        interval = max(1, int(round(self.interval_ms / cfg.dt)))
        duration = int(round(self.duration_ms / cfg.dt))
        n_pulses = self.n_pulses

        def gate(t):
            since = t - start
            in_pulse = (since >= 0) & (torch.remainder(since, interval)
                                       < duration)
            if n_pulses is not None:
                in_pulse = in_pulse & (torch.div(
                    since, interval, rounding_mode="floor") < n_pulses)
            return in_pulse.to(torch.float32)

        return CompiledStimulus(channel="spikes", basis=basis, gate=gate,
                                stochastic=True)
