"""The engine backend behind the port's ``Simulator``.

``FusedBackend`` is the counterpart of ``repro.api.backends.FusedBackend``::

    build(connectome, sim_config, device)          # host tables -> device
    init(generator) -> state                       # fresh dynamical state
    run(state, n_steps, probes) -> (state', {probe: [n_steps, ...]})

The reference runs the steps in one ``lax.scan``; here a Python loop drives
them, and nothing in it reads the device back to the host (the overflow
counter and the probe outputs stay on the device until the run ends).  With
a resolved policy whose ``step == "fused"`` each iteration is one launch of
kernel K3 in the rotated order, and an epilogue delivers the last step's
spikes (``repro/api/backends.py:381-404``); otherwise each iteration is
``update_phase`` + ``deliver_phase`` (``:405-417``).  Both leave the same
state.  ``run`` advances ``state`` in place where the ring is concerned.

With ``plasticity=`` (a rule, bound in ``build``) the state is the pair
``(SimState, PlasticState)`` and the plastic weights are updated in place
too.  The fused plastic loop (``pair_stdp`` only, ``:426-482``) is K4 then
``stdp_update``'s potentiation and clip per step, and an epilogue that
delivers the last spikes through the live table and runs a whole STDP
step; the split plastic loop (``:483-500``) is update, delivery through
the live table and a whole STDP step.  Each STDP update works on the ids
its step's delivery compacted (K4's, K2's, or the plain version's on the
CPU), never on a second compaction.  Each run clips the whole table once,
in its first STDP update, and then only what a step touched.  Two points
where the reference's fused loop differs from its split loop are kept to
the split loop here: the first iteration of a run delivers no spikes, so
it leaves the traces as they are (the reference decays them once more
there), and the whole-table clip follows the first spikes' depression and
potentiation (the reference clips before them).
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

from repro_torch.api.probes import Probe, ProbeContext
from repro_torch.core import delivery as dlv
from repro_torch.core import plasticity as PL
from repro_torch.core import stimulus as stim
from repro_torch.core.connectivity import Connectome
from repro_torch.core.engine import (SimConfig, SimState, deliver_phase,
                                     fused_plastic_update_phase,
                                     fused_update_phase, init_state,
                                     prepare_network, resolve_sim_config,
                                     update_phase)
from repro_torch.core.neuron import Propagators
from repro_torch.core.params import NeuronParams


class FusedBackend:
    """The production loop, static or with a plasticity rule."""

    name = "fused"

    def __init__(self, plasticity=None):
        self.plasticity = None if plasticity is None \
            else PL.resolve_rule(plasticity)

    def build(self, c: Connectome, cfg: SimConfig, device) -> None:
        self.device = torch.device(device)
        kind = None if self.plasticity is None else self.plasticity.kind
        cfg = resolve_sim_config(cfg, c, self.device, plastic=kind)
        # checked before the tables are built (the dense one is O(N^2))
        if self.plasticity is not None \
                and not dlv.get_strategy(cfg.strategy).supports_live_weights:
            raise ValueError(
                f"plasticity needs a delivery strategy with a live-weight "
                f"path (live_tables); {cfg.strategy!r} has none -- use "
                f"'event' or 'ell'")
        self.c, self.cfg = c, cfg
        neuron = NeuronParams()
        self.prop = Propagators.make(neuron, cfg.dt)
        self.net = prepare_network(c, cfg, self.device)
        self.n_pops = len(c.pop_sizes)
        self.drive = stim.compile_drive(cfg.stimulus, c, cfg, neuron,
                                        self.device)
        self.bound = None
        if self.plasticity is not None:
            self.bound = self.plasticity.bind(c, cfg, self.net.tables)

    @property
    def fused(self) -> bool:
        return self.cfg.kernels.step == "fused"

    def init(self, generator: torch.Generator):
        """A fresh ``SimState``, paired with a fresh ``PlasticState`` (the
        connectome's weights, cloned) in a plastic session."""
        sim = init_state(self.net, self.c.d_max_bins, generator,
                         self.cfg.state_dtype)
        return sim if self.bound is None else (sim, self.bound.init())

    def run(self, state, n_steps: int, probes: Sequence[Probe]
            ) -> Tuple[object, Dict[str, torch.Tensor]]:
        """Advance ``n_steps``; returns (state', {probe name: [n_steps,
        ...] tensor on the device})."""
        outs = [[] for _ in probes]

        def record(sim, spiked, ps=None):
            ctx = ProbeContext(sim, spiked, self.net, self.n_pops, ps,
                               None if ps is None
                               else self.bound.plastic_mask)
            for buf, p in zip(outs, probes):
                buf.append(p(ctx))

        if self.bound is None:
            state = self._run_static(state, n_steps, record)
        else:
            state = self._run_plastic(state, n_steps, record)
        data = {p.name: (torch.stack(buf) if buf else
                         torch.empty((0,), device=self.device))
                for p, buf in zip(probes, outs)}
        return state, data

    def _run_static(self, state: SimState, n_steps: int, record):
        c, cfg, prop, drive, net = self.c, self.cfg, self.prop, self.drive, \
            self.net
        n, n_exc = c.n_total, c.n_exc
        if self.fused:
            spk_prev = torch.zeros(n, dtype=torch.bool, device=self.device)
            for _ in range(n_steps):
                state, spk_prev = fused_update_phase(
                    state, net, prop, cfg, c.w_ext, n, n_exc, spk_prev,
                    drive)
                record(state, spk_prev)
            if n_steps:
                # epilogue: the rotated loop leaves the last step's spikes
                # undelivered -- land them at their true phase t - 1
                ring, ovf = dlv.get_strategy(cfg.strategy).deliver(
                    state.ring, net.tables, spk_prev, state.t - 1, n_exc,
                    cfg)
                state = state._replace(ring=ring,
                                       overflow=state.overflow + ovf)
        else:
            for _ in range(n_steps):
                state, spiked = update_phase(state, net, prop, cfg,
                                             c.w_ext, n, drive)
                state = deliver_phase(state, net, cfg, spiked, n_exc)
                record(state, spiked)
        return state

    def _run_plastic(self, state, n_steps: int, record):
        c, cfg, prop, drive, net = self.c, self.cfg, self.prop, self.drive, \
            self.net
        n, n_exc, bound = c.n_total, c.n_exc, self.bound
        strategy = dlv.get_strategy(cfg.strategy)
        sim, ps = state

        def deliver_live(sim, ps, spiked, t):
            """Deliver through the live table; returns (sim', ids), the
            delivery's compacted ids being the STDP update's rows."""
            live = strategy.live_tables(net.tables, ps.weights)
            ring, ids, ovf = strategy.deliver_ids(sim.ring, live, spiked, t,
                                                  n_exc, cfg)
            return sim._replace(ring=ring, overflow=sim.overflow + ovf), ids

        if self.fused:
            spk_prev = torch.zeros(n, dtype=torch.bool, device=self.device)
            for i in range(n_steps):
                x_pre = ps.x_pre                # before the bump K4 makes
                sim, ps, spiked, ids = fused_plastic_update_phase(
                    sim, ps, net, prop, cfg, c.w_ext, n, n_exc, spk_prev,
                    drive, bound, trace=i > 0)
                if i > 0:                       # step i - 1's spikes
                    PL.stdp_pot_clip(ps.weights, x_pre, ids, bound.tables,
                                     bound.coef, clip_all=i == 1,
                                     kernel=bound.kernel)
                spk_prev = spiked
                record(sim, spiked, ps)
            if n_steps:
                # epilogue: deliver the last spikes through the live table
                # and run their whole STDP step
                sim, ids = deliver_live(sim, ps, spk_prev, sim.t - 1)
                ps = bound.step(ps, spk_prev, ids, clip_all=n_steps == 1)
        else:
            for i in range(n_steps):
                sim, spiked = update_phase(sim, net, prop, cfg, c.w_ext, n,
                                           drive)
                sim, ids = deliver_live(sim, ps, spiked, sim.t)
                sim = sim._replace(t=sim.t + 1)
                ps = bound.step(ps, spiked, ids, clip_all=i == 0)
                record(sim, spiked, ps)
        return sim, ps

    def overflow(self, state) -> int:
        """Cumulative spike-budget overflow (one host read)."""
        sim = state if self.bound is None else state[0]
        return int(sim.overflow.item())
