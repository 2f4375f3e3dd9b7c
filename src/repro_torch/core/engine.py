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
stimulus gates are tensor functions of it, and each step advances it with
an op of its own.  Nothing on a step's path reads a device value back to
the host, so a run of steps can be captured in a CUDA graph
(``repro_torch.api.backends``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import torch

from repro_torch.core import delivery as dlv
from repro_torch.core import kernel_policy as kpol
from repro_torch.core import stimulus as stim
from repro_torch.core.connectivity import Connectome
from repro_torch.core.neuron import NeuronState, Propagators, lif_step
from repro_torch.kernels.lif_deliver import slot_index


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


def _external_drive(state: SimState, net: Network, w_ext: float, dtype,
                    drive: stim.Drive):
    """Evaluate the drive: ``(ext_ex, i_dc)`` where ``ext_ex`` is the
    external excitatory current (``w_ext`` times the int32 counts, as in
    the reference; None when no stimulus feeds spikes) and ``i_dc`` the
    effective DC term."""
    i_dc = net.i_dc
    I_ext, ext_in = drive(state.generator, state.t, state)
    ext_ex = None if ext_in is None else w_ext * ext_in.to(dtype)
    if I_ext is not None:
        i_dc = i_dc + I_ext
    return ext_ex, i_dc


def update_phase(state: SimState, net: Network, prop: Propagators,
                 cfg: SimConfig, w_ext: float, n: int, drive: stim.Drive):
    """Read the ring slot, add the external drive, integrate, detect
    spikes, and consume the slot.  Returns ``(state, spiked)``."""
    slot = slot_index(state.t, state.ring.shape[0])
    arrivals = state.ring.index_select(0, slot)[0]           # [2, N+1]
    in_ex = arrivals[0, :n]
    in_in = arrivals[1, :n]
    ext_ex, i_dc = _external_drive(state, net, w_ext, in_ex.dtype, drive)
    if ext_ex is not None:
        in_ex = in_ex + ext_ex
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
    ext_ex, i_dc = _fused_drive(state, net, w_ext, n, drive)
    neuron, ring, spiked, ovf = kops.lif_deliver(
        state.neuron, state.ring, state.t, spiked_prev, net.tables, prop,
        ext_ex, i_dc, n_exc=n_exc, spike_budget=cfg.spike_budget)
    return SimState(neuron, ring, state.t + 1, state.generator,
                    state.overflow + ovf), spiked


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
    ext_ex, i_dc = _fused_drive(state, net, w_ext, n, drive)
    neuron, ring, spiked, ps, ids, ovf = kops.lif_deliver_plastic(
        state.neuron, state.ring, state.t, spiked_prev, net.tables,
        bound.tables.plastic_out, ps, prop, ext_ex, i_dc, n_exc=n_exc,
        spike_budget=cfg.spike_budget, coef=bound.coef, trace=trace)
    return (SimState(neuron, ring, state.t + 1, state.generator,
                     state.overflow + ovf), ps, spiked, ids)


def _fused_drive(state: SimState, net: Network, w_ext: float, n: int,
                 drive: stim.Drive):
    """The external drive as the fused kernels take it: two [N] tensors."""
    dtype = state.ring.dtype
    ext_ex, i_dc = _external_drive(state, net, w_ext, dtype, drive)
    if ext_ex is None:
        ext_ex = torch.zeros(n, dtype=dtype, device=state.ring.device)
    return ext_ex, i_dc.expand(n).to(dtype)


def deliver_phase(state: SimState, net: Network, cfg: SimConfig,
                  spiked: torch.Tensor, n_exc: int) -> SimState:
    """Scatter one step's spikes through the registered strategy."""
    ring, ovf = dlv.get_strategy(cfg.strategy).deliver(
        state.ring, net.tables, spiked, state.t, n_exc, cfg)
    return SimState(state.neuron, ring, state.t + 1, state.generator,
                    state.overflow + ovf)
