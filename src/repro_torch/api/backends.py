"""The engine backend behind the port's ``Simulator``.

``FusedBackend`` is the counterpart of ``repro.api.backends.FusedBackend``
for static synapses::

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
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

from repro_torch.api.probes import Probe, ProbeContext
from repro_torch.core import delivery as dlv
from repro_torch.core import stimulus as stim
from repro_torch.core.connectivity import Connectome
from repro_torch.core.engine import (SimConfig, SimState, deliver_phase,
                                     fused_update_phase, init_state,
                                     prepare_network, resolve_sim_config,
                                     update_phase)
from repro_torch.core.neuron import Propagators
from repro_torch.core.params import NeuronParams


class FusedBackend:
    """The production loop (static synapses)."""

    name = "fused"

    def build(self, c: Connectome, cfg: SimConfig, device) -> None:
        self.device = torch.device(device)
        cfg = resolve_sim_config(cfg, c, self.device)
        self.c, self.cfg = c, cfg
        neuron = NeuronParams()
        self.prop = Propagators.make(neuron, cfg.dt)
        self.net = prepare_network(c, cfg, self.device)
        self.n_pops = len(c.pop_sizes)
        self.drive = stim.compile_drive(cfg.stimulus, c, cfg, neuron,
                                        self.device)

    @property
    def fused(self) -> bool:
        return self.cfg.kernels.step == "fused"

    def init(self, generator: torch.Generator) -> SimState:
        return init_state(self.net, self.c.d_max_bins, generator,
                          self.cfg.state_dtype)

    def run(self, state: SimState, n_steps: int, probes: Sequence[Probe]
            ) -> Tuple[SimState, Dict[str, torch.Tensor]]:
        """Advance ``n_steps``; returns (state', {probe name: [n_steps,
        ...] tensor on the device})."""
        c, cfg, prop, drive, net = self.c, self.cfg, self.prop, self.drive, \
            self.net
        n, n_exc = c.n_total, c.n_exc
        outs = [[] for _ in probes]

        def record(sim, spiked):
            ctx = ProbeContext(sim, spiked, net, self.n_pops)
            for buf, p in zip(outs, probes):
                buf.append(p(ctx))

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
        data = {p.name: (torch.stack(buf) if buf else
                         torch.empty((0,), device=self.device))
                for p, buf in zip(probes, outs)}
        return state, data

    def overflow(self, state: SimState) -> int:
        """Cumulative spike-budget overflow (one host read)."""
        return int(state.overflow.item())
