"""The port's simulation session API.

    from repro_torch.api import Simulator
    from repro_torch.configs.microcircuit import MicrocircuitConfig

    sim = Simulator(MicrocircuitConfig(scale=1.0, strategy="ell"))
    sim.warmup()
    res = sim.run(1000.0)            # 100 ms presim (untimed), then 1 s
    print(res.rtf, res.summary()["rates_hz"])

    plastic = Simulator(MicrocircuitConfig(scale=1.0, strategy="ell"),
                        plasticity="pair_stdp")   # E->E pair STDP
    sim_state, plastic_state = plastic.state

The session runs on ``cuda`` unless the caller passes ``device="cpu"``; on
a machine without CUDA, ``Simulator(...)`` with no device raises instead of
carrying on on the CPU.  ``run_chunked``, ``run_batch``, checkpoints and
the instrumented and sharded backends wait for later slices.
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Optional, Sequence

import torch

from repro_torch.api import probes as probes_mod
from repro_torch.api.backends import FusedBackend
from repro_torch.api.results import RunResult
from repro_torch.core.connectivity import Connectome, build_connectome
from repro_torch.core.engine import SimConfig, SimState
from repro_torch.core.plasticity import PlasticState


def session_device(device=None) -> torch.device:
    """``device``, or ``cuda`` when None -- which raises without CUDA.  A
    card is named with its index, as the session's tensors report it."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA card by default and none is "
                "available; pass device='cpu' to run the plain PyTorch "
                "versions of the kernels on the CPU")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


class Simulator:
    """A simulation session: one network, one backend, many runs.

    ``config`` is a model config (``MicrocircuitConfig``); ``connectome``
    skips the build.  ``plasticity`` is a rule (a registry kind name such
    as ``"pair_stdp"``, a spec dict or a ``PlasticityRule``); the session's
    state is then the pair ``(SimState, PlasticState)``.  ``kernels=`` (a
    mode string), ``stimulus=`` (a timeline) and other ``SimConfig`` fields
    go in ``**overrides``.  ``config.seed`` seeds both the connectome and
    the session's ``torch.Generator``.
    """

    def __init__(self, config, *, connectome: Optional[Connectome] = None,
                 probes: Sequence = ("pop_counts",), device=None,
                 plasticity=None, **overrides):
        self.device = session_device(device)
        self.config = config
        self.seed = int(config.seed)
        if connectome is None:
            connectome = build_connectome(
                scale=config.scale, n_scaling=config.n_scaling,
                k_scaling=config.k_scaling, seed=self.seed, dt=config.dt)
        self.connectome = connectome
        sim_config = SimConfig(
            dt=config.dt, strategy=config.strategy,
            spike_budget=config.spike_budget,
            strict_delivery=config.strict_delivery,
            stimulus=config.stimulus, kernels=config.kernels)
        if overrides:
            sim_config = dataclasses.replace(sim_config, **overrides)
        self.t_presim = float(config.t_presim)
        self.backend = FusedBackend(plasticity=plasticity)
        self.plasticity = self.backend.plasticity
        self.backend.build(connectome, sim_config, self.device)
        self.sim_config = self.backend.cfg          # resolved
        self.probes = probes_mod.resolve(probes)
        self.reset()

    # -- session state ------------------------------------------------------

    def reset(self) -> None:
        """Fresh dynamical state (the presim transient applies again)."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.seed)
        self._state = self.backend.init(gen)
        self._presim_done = False
        self._overflow_seen = 0

    @property
    def state(self):
        """The ``SimState``, or ``(SimState, PlasticState)`` in a plastic
        session."""
        return self._state

    @state.setter
    def state(self, value) -> None:
        """Carry a state in (e.g. from ``repro_torch.convert``): a
        ``SimState``, or in a plastic session the pair.  The session's
        counters stay, so a pending presim runs from it."""
        if self.plasticity is not None:
            if not (isinstance(value, tuple) and len(value) == 2
                    and isinstance(value[1], PlasticState)):
                raise TypeError("a plastic session's state is the pair "
                                "(SimState, PlasticState)")
            sim, ps = value
            table = self.backend.net.tables.weights
            if ps.weights.shape != table.shape \
                    or ps.weights.device != table.device:
                raise ValueError(
                    f"plastic weights {tuple(ps.weights.shape)} on "
                    f"{ps.weights.device}; the session's table is "
                    f"{tuple(table.shape)} on {table.device}")
        else:
            sim, ps = value, None
        if sim.ring.device != self.device:
            raise ValueError(f"state lies on {sim.ring.device}, the "
                             f"session on {self.device}")
        if sim.generator is None:
            sim = sim._replace(generator=self._sim_state().generator)
        self._state = sim if ps is None else (sim, ps)
        self._overflow_seen = int(sim.overflow.item())

    def _sim_state(self) -> SimState:
        return self._state if self.plasticity is None else self._state[0]

    def _steps(self, t_ms: float) -> int:
        return int(round(t_ms / self.sim_config.dt))

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- warmup / presim ----------------------------------------------------

    def warmup(self) -> None:
        """Build and load every kernel the run will launch, and run one
        step on a copy of the state (device allocations, library loading),
        so that a following ``run`` measures execution only.  The session
        state is untouched: the ring and the plastic weights, which the
        kernels update in place, are copied."""
        st = self._sim_state()
        gen = torch.Generator(device=self.device)
        gen.set_state(st.generator.get_state())
        scratch = SimState(st.neuron, st.ring.clone(), st.t, gen,
                           st.overflow.clone())
        if self.plasticity is not None:
            scratch = (scratch, self._state[1]._replace(
                weights=self._state[1].weights.clone()))
        self.backend.run(scratch, 1, self.probes)
        self._sync()

    def _maybe_presim(self) -> None:
        if self._presim_done or self.t_presim <= 0:
            return
        self._state, _ = self.backend.run(self._state,
                                          self._steps(self.t_presim), ())
        self._sync()
        self._presim_done = True
        self._check_overflow()

    # -- runs ---------------------------------------------------------------

    def run(self, t_ms: float) -> RunResult:
        """Simulate ``t_ms`` of model time.  The presim transient
        (``config.t_presim``) runs untimed and unrecorded once per session
        first, as in the paper's protocol."""
        self._maybe_presim()
        n_steps = self._steps(t_ms)
        self._sync()
        t0 = time.perf_counter()
        self._state, data = self.backend.run(self._state, n_steps,
                                             self.probes)
        self._sync()
        wall = time.perf_counter() - t0
        overflow = self._check_overflow()
        data = {k: v.cpu().numpy() for k, v in data.items()}
        return RunResult(
            data=data, t_model_ms=n_steps * self.sim_config.dt,
            n_steps=n_steps, dt=self.sim_config.dt, wall_s=wall,
            overflow=overflow, device=self._device_name(),
            _connectome=self.connectome)

    def _device_name(self) -> str:
        if self.device.type == "cuda":
            return torch.cuda.get_device_name(self.device)
        return str(self.device)

    def _check_overflow(self) -> int:
        """Read the device overflow counter once; warn on any new overflow,
        raise under ``SimConfig.strict_delivery``."""
        overflow = self.backend.overflow(self._state)
        if overflow > self._overflow_seen:
            msg = (f"spike delivery dropped {overflow - self._overflow_seen}"
                   f" spike(s) this run ({overflow} cumulative): the "
                   f"per-step spike_budget={self.sim_config.spike_budget} "
                   f"of strategy {self.sim_config.strategy!r} was exceeded "
                   f"-- raise spike_budget (or leave it None for the "
                   f"rate-derived auto value)")
            self._overflow_seen = overflow
            if self.sim_config.strict_delivery:
                from repro_torch.core.delivery import DeliveryOverflowError
                raise DeliveryOverflowError(msg)
            warnings.warn(msg, stacklevel=3)
        return overflow
