"""Simulation engine: the update -> deliver cycle, one step at a time.

The port's counterpart of ``repro.core.engine``.  ``update_phase`` reads
the current ring slot, adds the external drive, integrates and consumes the
slot; ``deliver_phase`` scatters the step's spikes through the registered
delivery strategy; ``fused_update_phase`` is one rotated step of the fused
path (kernel K3).  The per-step loop lives in ``repro_torch.api.backends``
(the reference's ``lax.scan``); PyTorch runs eagerly, so there is no jit.

Differences from the reference, all deliberate:

* the ring is updated in place (one 28 MB ring per session at full scale);
* ``jax.random`` keys become one ``torch.Generator`` on the device.

As in the reference, the step counter ``t`` is a 0-d int32 tensor on the
session's device, like the overflow counter: the kernels read it there, the
stimulus gates are tensor functions of it, and each step advances it, the
split step with an op of its own, the fused step inside K3 or K4.  The
drive is one: every loop takes its float32 spike counts as drawn.  The
split step adds ``w_ext`` times them to the slot's arrivals; K3 and K4
take the counts and ``w_ext`` and form the same product, so the fused
step launches no cast, product or counter op around its kernel.
Nothing on a step's path reads a device value back to the host, so a run
of steps can be captured in a CUDA graph (``repro_torch.api.backends``).

The reference's functional entry points are here too, deprecated as they
are there: ``make_step`` (the split update + deliver step), ``simulate``
(a loop of it) and ``PhaseRunner`` (over the instrumented backend).  New
code drives ``repro_torch.api.Simulator``.
"""
from __future__ import annotations

import dataclasses
import types
import warnings
from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.core import delivery as dlv
from repro_torch.core import kernel_policy as kpol
from repro_torch.core import stimulus as stim
from repro_torch.core.connectivity import Connectome
from repro_torch.core.device import session_device
from repro_torch.core.neuron import NeuronState, Propagators, lif_step
from repro_torch.core.params import NeuronParams
from repro_torch.kernels.lif_deliver import slot_index
from repro_torch.perf.trace import span


@dataclasses.dataclass(frozen=True)
class SimConfig:
    dt: float = 0.1
    strategy: str = "event"            # "event" | "ell" | "dense"
                                       # (delivery registry)
    spike_budget: Optional[int] = None # max spikes delivered per step;
                                       # None -> rate-derived auto
    strict_delivery: bool = False      # raise DeliveryOverflowError instead
                                       # of warning when spikes were dropped
    state_dtype: torch.dtype = torch.float32
    stimulus: Optional[tuple] = None   # None -> poisson_background (8 Hz)
    kernels: Optional[Any] = None      # mode string | resolved KernelPolicy
    record: str = "pop_counts"         # make_step / simulate only:
                                       # "spikes" | "pop_counts" | "none"


def force_split_step(cfg: SimConfig) -> SimConfig:
    """Pin a resolved policy's step to the phase-split loop (its other
    choices untouched): for the per-step-dispatch loops, which have no
    one-kernel path."""
    pol = kpol.policy_of(cfg)
    if pol is not None and pol.step == "fused":
        cfg = dataclasses.replace(
            cfg, kernels=dataclasses.replace(pol, step="split"))
    return cfg


def resolve_sim_config(cfg: SimConfig, c: Connectome, device,
                       plastic: Optional[str] = None) -> SimConfig:
    """Fill connectome- and device-dependent defaults once: the strategy
    name, the auto spike budget, the kernel policy (against ``device`` and
    the plasticity rule's kind ``plastic``), and the stimulus timeline."""
    dlv.get_strategy(cfg.strategy)
    if cfg.spike_budget is None:
        cfg = dataclasses.replace(
            cfg, spike_budget=dlv.auto_spike_budget(c, cfg.dt))
    if kpol.policy_of(cfg) is None:
        cfg = dataclasses.replace(cfg, kernels=kpol.resolve(
            cfg.kernels, strategy=cfg.strategy, state_dtype=cfg.state_dtype,
            device=device, plastic=plastic))
    stimulus = (stim.PoissonBackground(),) if cfg.stimulus is None \
        else stim.resolve_timeline(cfg.stimulus)
    return dataclasses.replace(cfg, stimulus=stimulus)


class Network(NamedTuple):
    """Device-resident network tables."""
    tables: Any                       # the strategy's prepare() output
    k_ext: torch.Tensor               # [N]
    i_dc: torch.Tensor                # [N]
    pop_of: torch.Tensor              # [N] int32, sorted
    v0_mean: Optional[torch.Tensor] = None
    v0_sd: Optional[torch.Tensor] = None


class SimState(NamedTuple):
    neuron: NeuronState
    ring: torch.Tensor                # [D, 2, N+1], updated in place
    t: torch.Tensor                   # 0-d int32 step counter, on device
    generator: Optional[torch.Generator]
    overflow: torch.Tensor            # 0-d int32, cumulative, on device


def prepare_network(c: Connectome, cfg: SimConfig, device,
                    dense_dtype=torch.float32) -> Network:
    """Build the tables of the strategy named by ``cfg.strategy``.
    ``dense_dtype`` (float32 or bfloat16) is honoured only for the stock
    dense strategy's table, and passed only when not the default."""
    strategy = dlv.get_strategy(cfg.strategy)
    if dense_dtype != torch.float32 and type(strategy) is dlv.DenseDelivery:
        tables = strategy.prepare(c, cfg, device, dtype=dense_dtype)
    else:
        tables = strategy.prepare(c, cfg, device)
    as_t = lambda a: torch.as_tensor(a, device=device)
    return Network(tables=tables, k_ext=as_t(c.k_ext), i_dc=as_t(c.i_dc),
                   pop_of=as_t(c.pop_of), v0_mean=as_t(c.v0_mean),
                   v0_sd=as_t(c.v0_sd))


def init_state(net: Network, d_max_bins: int, generator: torch.Generator,
               state_dtype=torch.float32) -> SimState:
    """Optimized initial conditions (Rhodes et al. 2019): V drawn per
    neuron from its population's normal; currents, ring and counters 0.
    The draw comes from ``generator``, which then drives the session."""
    n = net.k_ext.shape[0]
    dev = net.k_ext.device
    V = net.v0_mean + net.v0_sd * torch.randn(
        n, generator=generator, device=dev, dtype=torch.float32)
    neuron = NeuronState(
        V=V.to(state_dtype),
        I_ex=torch.zeros(n, dtype=state_dtype, device=dev),
        I_in=torch.zeros(n, dtype=state_dtype, device=dev),
        refrac=torch.zeros(n, dtype=torch.int32, device=dev))
    ring = torch.zeros((d_max_bins, 2, n + 1), dtype=state_dtype, device=dev)
    return SimState(neuron=neuron, ring=ring,
                    t=torch.zeros((), dtype=torch.int32, device=dev),
                    generator=generator,
                    overflow=torch.zeros((), dtype=torch.int32, device=dev))


def _evaluate_drive(state: SimState, net: Network, drive: stim.Drive):
    """Evaluate the drive: ``(ext_cnt, i_dc)``, the float32 spike counts as
    drawn (None when no stimulus feeds spikes) and the effective DC term.
    Every loop takes these: the split step adds ``w_ext`` times the counts
    to the slot's arrivals, as the reference does with its int32 counts;
    K3 and K4 take the counts and ``w_ext`` and form the same product."""
    I_ext, ext_cnt = drive(state.generator, state.t, state)
    return ext_cnt, net.i_dc if I_ext is None else net.i_dc + I_ext


def update_phase(state: SimState, net: Network, prop: Propagators,
                 cfg: SimConfig, w_ext: float, n: int, drive: stim.Drive):
    """Read the ring slot, add the external drive, integrate, detect
    spikes, and consume the slot.  Returns ``(state, spiked)``."""
    slot = slot_index(state.t, state.ring.shape[0])
    arrivals = state.ring.index_select(0, slot)[0]           # [2, N+1]
    in_ex = arrivals[0, :n]
    in_in = arrivals[1, :n]
    with span("step.drive"):
        ext_cnt, i_dc = _evaluate_drive(state, net, drive)
    if ext_cnt is not None:
        in_ex = in_ex + w_ext * ext_cnt.to(in_ex.dtype)
    pol = kpol.policy_of(cfg)
    if pol is not None and pol.kernels:
        from repro_torch.kernels import ops as kops
        neuron, spiked = kops.lif_update(state.neuron, prop, in_ex, in_in,
                                         i_dc)
    else:
        neuron, spiked = lif_step(state.neuron, prop, in_ex, in_in, i_dc)
    state.ring.index_fill_(0, slot, 0.0)      # consume the slot
    return state._replace(neuron=neuron), spiked


def fused_update_phase(state: SimState, net: Network, prop: Propagators,
                       cfg: SimConfig, w_ext: float, n: int, n_exc: int,
                       spiked_prev: torch.Tensor, drive: stim.Drive):
    """One rotated step of the fused path: deliver ``spiked_prev`` at phase
    ``t - 1``, then integrate step ``t`` -- the op sequence of
    ``deliver_phase`` + ``update_phase`` interleaved.  The caller seeds
    ``spiked_prev`` with zeros and delivers the last step's spikes after
    the loop.  Returns ``(state, spiked)`` with ``t`` advanced by one."""
    from repro_torch.kernels import ops as kops
    with span("step.drive"):
        ext_cnt, i_dc = _evaluate_drive(state, net, drive)
    with span("step.deliver"):
        neuron, ring, spiked, t, overflow = kops.lif_deliver(
            state.neuron, state.ring, state.t, spiked_prev, net.tables,
            prop, ext_cnt, i_dc.expand(n).to(state.ring.dtype), n_exc=n_exc,
            spike_budget=cfg.spike_budget, w_ext=w_ext,
            overflow=state.overflow)
    return SimState(neuron, ring, t, state.generator, overflow), spiked


def fused_plastic_update_phase(state: SimState, ps, net: Network,
                               prop: Propagators, cfg: SimConfig,
                               w_ext: float, n: int, n_exc: int,
                               spiked_prev: torch.Tensor, drive: stim.Drive,
                               bound, trace: bool):
    """One rotated step of the fused plastic path (kernel K4): deliver
    ``spiked_prev`` at phase ``t - 1`` through the live table ``ps.weights``
    and depress its rows in place, decay and bump the traces (unless
    ``trace`` is False: the loop's first step delivers nothing), then
    integrate step ``t``.  The potentiation and the clip of the delivered
    ids are the caller's (``plasticity.stdp_pot_clip``).  Returns
    ``(state, ps', spiked, ids)``; ``ps'`` holds the new traces."""
    from repro_torch.kernels import ops as kops
    with span("step.drive"):
        ext_cnt, i_dc = _evaluate_drive(state, net, drive)
    with span("step.deliver"):
        neuron, ring, spiked, ps, ids, t, overflow = kops.lif_deliver_plastic(
            state.neuron, state.ring, state.t, spiked_prev, net.tables,
            bound.tables.plastic_out, ps, prop, ext_cnt,
            i_dc.expand(n).to(state.ring.dtype), n_exc=n_exc,
            spike_budget=cfg.spike_budget, w_ext=w_ext,
            overflow=state.overflow, coef=bound.coef, trace=trace)
    return (SimState(neuron, ring, t, state.generator, overflow), ps, spiked,
            ids)


def deliver_phase(state: SimState, net: Network, cfg: SimConfig,
                  spiked: torch.Tensor, n_exc: int) -> SimState:
    """Scatter one step's spikes through the registered strategy."""
    ring, ovf = dlv.get_strategy(cfg.strategy).deliver(
        state.ring, net.tables, spiked, state.t, n_exc, cfg)
    return SimState(state.neuron, ring, state.t + 1, state.generator,
                    state.overflow + ovf)


# ---------------------------------------------------------------------------
# The reference's functional entry points (deprecated there and here)
# ---------------------------------------------------------------------------

def _background_drive(net: Network, cfg: SimConfig) -> stim.Drive:
    """The default timeline, ``PoissonBackground()``, compiled against the
    network's ``k_ext`` (all the stimulus reads of a connectome): the
    reference's inline drive (``drive=None``)."""
    sources = types.SimpleNamespace(k_ext=net.k_ext.cpu().numpy())
    return stim.compile_drive((stim.PoissonBackground(),), sources, cfg,
                              None, net.k_ext.device)


def make_step(net: Network, prop: Propagators, cfg: SimConfig,
              w_ext: float, n: int, n_exc: int, n_pops: int = 8,
              record_fn: Optional[Callable] = None,
              drive: Optional[stim.Drive] = None):
    """The split update + deliver step (``repro/core/engine.py:330-361``):
    ``step(state, _) -> (state', out)``, the ring updated in place.

    ``out`` is ``record_fn(state', spiked)`` when given, else by
    ``cfg.record``: the spike vector, the population counts (a segment sum
    over ``net.pop_of``, ``n_pops`` long) or a 0-d zero.  ``drive`` is a
    compiled stimulus timeline; None draws the default background from
    ``net.k_ext``.  ``cfg`` must be resolved (``resolve_sim_config``): an
    unresolved kernel policy raises rather than run the plain versions on
    the card.
    """
    if kpol.policy_of(cfg) is None:
        raise ValueError(
            f"make_step needs a resolved SimConfig (its kernels are "
            f"{cfg.kernels!r}); call repro_torch.core.engine."
            f"resolve_sim_config(cfg, connectome, device) first")
    if drive is None:
        drive = _background_drive(net, cfg)
    pop_of = net.pop_of.to(torch.int64)

    def step(state: SimState, _=None):
        state, spiked = update_phase(state, net, prop, cfg, w_ext, n, drive)
        state = deliver_phase(state, net, cfg, spiked, n_exc)
        if record_fn is not None:
            out = record_fn(state, spiked)
        elif cfg.record == "spikes":
            out = spiked
        elif cfg.record == "pop_counts":
            out = torch.zeros(n_pops, dtype=torch.int32,
                              device=spiked.device).index_add_(
                0, pop_of, spiked.to(torch.int32))
        else:
            out = torch.zeros((), dtype=torch.int32, device=spiked.device)
        return state, out
    return step


def _generator(key, device) -> torch.Generator:
    """``key`` as the session's generator: a ``torch.Generator`` as it is,
    an int seed (0 when None) in a new one on ``device``."""
    if isinstance(key, torch.Generator):
        return key
    return torch.Generator(device=device).manual_seed(
        0 if key is None else int(key))


def simulate(c: Connectome, t_sim_ms: float, cfg: SimConfig,
             neuron: Optional[NeuronParams] = None, key=None,
             net: Optional[Network] = None,
             state: Optional[SimState] = None, device=None):
    """Build (unless ``net`` and ``state`` are given), run ``t_sim_ms`` of
    model time through :func:`make_step`, and return ``(final_state,
    recorded [n_steps, ...], net)`` (``repro/core/engine.py:370-403``).

    The policy's step is pinned to the split loop (K1 and K2 on the card
    for ``ell``).  The timeline is compiled; the default one
    (``cfg.stimulus`` None) is ``poisson_background``, which draws what the
    reference's inline background draws.  ``key`` is an int seed or a ``torch.Generator``; a
    given ``state`` keeps its own generator, and its ring is updated in
    place.  ``device`` is the card unless the caller asks for the CPU.

    .. deprecated:: use ``repro_torch.api.Simulator``.
    """
    warnings.warn(
        "repro_torch.core.engine.simulate is deprecated; use "
        "repro_torch.api.Simulator", DeprecationWarning, stacklevel=2)
    device = session_device(device)
    neuron = neuron or NeuronParams()
    cfg = force_split_step(resolve_sim_config(cfg, c, device))
    drive = stim.compile_drive(cfg.stimulus, c, cfg, neuron, device)
    prop = Propagators.make(neuron, cfg.dt)
    if net is None:
        net = prepare_network(c, cfg, device)
    if state is None:
        state = init_state(net, c.d_max_bins, _generator(key, device),
                           cfg.state_dtype)
    step = make_step(net, prop, cfg, c.w_ext, c.n_total, c.n_exc,
                     n_pops=len(c.pop_sizes), drive=drive)
    recorded = []
    for _ in range(int(round(t_sim_ms / cfg.dt))):
        state, out = step(state)
        recorded.append(out)
    recorded = torch.stack(recorded) if recorded \
        else torch.empty((0,), dtype=torch.int32, device=device)
    return state, recorded, net


class PhaseRunner:
    """The cycle with each phase synchronised and timed.

    .. deprecated:: a shim over ``repro_torch.api.backends.
       InstrumentedBackend`` (``repro/core/engine.py:410-436``); use
       ``Simulator(cfg, backend="instrumented")``, whose
       ``RunResult.timers`` carry the same per-phase seconds.
    """

    def __init__(self, c: Connectome, cfg: SimConfig,
                 neuron: Optional[NeuronParams] = None, key=None,
                 device=None):
        warnings.warn(
            "PhaseRunner is deprecated; use repro_torch.api.Simulator with "
            "backend='instrumented'", DeprecationWarning, stacklevel=2)
        from repro_torch.api.backends import InstrumentedBackend
        device = session_device(device)
        self._backend = InstrumentedBackend()
        self._backend.build(c, cfg, device, neuron=neuron)
        self.cfg = cfg
        self.prop = self._backend.prop
        self.net = self._backend.net
        self.state = self._backend.init(_generator(key, device))
        self.n, self.n_exc = c.n_total, c.n_exc
        self.w_ext = c.w_ext

    def step_timed(self, timers: dict) -> torch.Tensor:
        """One update + deliver cycle; each phase's seconds are added to
        ``timers["update"]`` and ``timers["deliver"]``.  Returns the step's
        spike vector."""
        self.state, spiked = self._backend.step_timed(self.state, timers)
        return spiked
