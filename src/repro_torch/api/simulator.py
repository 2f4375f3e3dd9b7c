"""The port's simulation session API.

    from repro_torch.api import Simulator
    from repro_torch.configs.microcircuit import MicrocircuitConfig

    sim = Simulator(MicrocircuitConfig(scale=1.0, strategy="ell"))
    sim.warmup()
    res = sim.run(1000.0)            # 100 ms presim (untimed), then 1 s
    print(res.rtf, res.summary()["rates_hz"])

The session runs on ``cuda`` unless the caller passes ``device="cpu"``; on
a machine without CUDA, ``Simulator(...)`` with no device raises instead of
carrying on on the CPU.  ``run_chunked``, ``run_batch``, checkpoints, the
instrumented and sharded backends and plasticity wait for later slices.
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
    skips the build.  ``kernels=`` (a mode string),
    ``stimulus=`` (a timeline) and other ``SimConfig`` fields go in
    ``**overrides``.  ``config.seed`` seeds both the connectome and the
    session's ``torch.Generator``.
    """

    def __init__(self, config, *, connectome: Optional[Connectome] = None,
                 probes: Sequence = ("pop_counts",), device=None,
                 **overrides):
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
        self.backend = FusedBackend()
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
    def state(self) -> SimState:
        return self._state

    @state.setter
    def state(self, value: SimState) -> None:
        """Carry a state in (e.g. from ``repro_torch.convert``); the
        session's counters stay, so a pending presim runs from it."""
        if value.ring.device != self.device:
            raise ValueError(f"state lies on {value.ring.device}, the "
                             f"session on {self.device}")
        if value.generator is None:
            value = value._replace(generator=self._state.generator)
        self._state = value
        self._overflow_seen = int(value.overflow.item())

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
        state is untouched."""
        st = self._state
        gen = torch.Generator(device=self.device)
        gen.set_state(st.generator.get_state())
        scratch = SimState(st.neuron, st.ring.clone(), st.t, gen,
                           st.overflow.clone())
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
