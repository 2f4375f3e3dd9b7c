"""The Potjans-Diesmann (2014) microcircuit, as the harness runs it.

A configuration names its network (``"network": "pd14"``), and the harness
loads ``perfbench/networks/<network>.py`` by its path
(``bench.load_network``), so a second network is a second file beside
this one.  A network module provides:

* ``draw(config, seed, device)``: the network drawn on ``device`` from
  ``seed``, a ``netgen.NetDraw`` (its ``[N, K]`` ELL tables, ``pop_sizes``,
  ``k_per_proj``, ``n_exc`` and the degree stats the rooflines read);
* ``connectome(net)``: the port's ``Connectome`` of a draw;
* ``simulator(config, traffic, c, key, device)``: the port's ``Simulator``
  on the connectome ``c``, its generator seeded with ``key``;
* ``NEURON_LEAVES`` and ``PLASTIC_LEAVES``: the fields of the session's
  neuron state and plastic state that the reference follows (beside the
  ring and the step ``t``, which every session of the port has; the
  plastic table is ``weights``);
* ``fresh(c, key, device, dtype, plastic)``: what each of those leaves but
  the weights holds in a fresh session under ``key``, and the generator's
  state after the session's own draws, in the reference's keys;
* ``reference(c, config, traffic, device, dtype)``: the plain reference,
  with ``follow``, ``advance`` and ``change_sq``
  (``perfbench/reference/lif_net.py`` for this network).  A reference
  lives under ``perfbench/reference/`` and imports nothing of the port.

Here: the connectome of ``perfbench/netgen.py`` (PD-2014's rules and
frozen tables, ``perfbench/reference/pd14.py``), ``iaf_psc_exp`` neurons
whose V starts from each population's normal, and pair STDP on E->E where
the configuration states it.
"""
from __future__ import annotations

import torch

from perfbench import netgen
from perfbench.reference.lif_net import Reference

NEURON_LEAVES = ("V", "I_ex", "I_in", "refrac")
PLASTIC_LEAVES = ("weights", "x_pre", "x_post")


def draw(config: dict, seed: int, device) -> netgen.NetDraw:
    return netgen.draw(config["scale"], seed, device, dt=config["dt_ms"])


connectome = netgen.connectome


def simulator(config: dict, traffic: dict, c, key: int, device):
    from repro_torch.api import Simulator
    from repro_torch.configs.microcircuit import MicrocircuitConfig
    model = MicrocircuitConfig(
        scale=config["scale"], dt=config["dt_ms"], strategy=config["strategy"],
        t_presim=config["t_presim_ms"], seed=0, kernels=config["kernels"])
    return Simulator(model, connectome=c, key=key, device=device,
                     probes=tuple(traffic["probes"]),
                     stimulus=traffic["stimulus"],
                     plasticity=config.get("plasticity"))


def fresh(c, key: int, device, dtype=torch.float32,
          plastic: bool = False) -> dict:
    """A fresh session's leaves (but the weights) in ``dtype``: V drawn
    from each population's normal by the session's generator seeded with
    ``key``, the currents, refractory counts, ring, step and traces zero.
    The zeros are expanded views of one element, so that the start's
    check adds no ring to the run's memory peak; the reference clones
    what it follows."""
    dev = torch.device(device)
    n = c.n_total
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(key))
    v0 = torch.as_tensor(c.v0_mean, device=dev) + torch.as_tensor(
        c.v0_sd, device=dev) * torch.randn(n, generator=gen, device=dev,
                                           dtype=torch.float32)

    def zeros(*shape, dtype=dtype):
        return torch.zeros((), dtype=dtype, device=dev).expand(shape)
    out = {"V": v0.to(dtype), "I_ex": zeros(n), "I_in": zeros(n),
           "refrac": zeros(n, dtype=torch.int32),
           "ring": zeros(c.d_max_bins, 2, n + 1),
           "t": zeros(dtype=torch.int32),
           "generator_state": gen.get_state()}
    if plastic:
        out.update(x_pre=zeros(n, dtype=torch.float32),
                   x_post=zeros(n, dtype=torch.float32))
    return out


def reference(c, config: dict, traffic: dict, device,
              dtype=torch.float32) -> Reference:
    """The plain reference of the network, its rule and its drive."""
    stim = traffic["stimulus"]
    if [s["kind"] for s in stim] != ["poisson_background"]:
        raise ValueError(f"the reference drives the Poisson background "
                         f"only, not {stim}")
    return Reference(c, device, dt=config["dt_ms"],
                     rate_hz=stim[0].get("rate_hz", 8.0),
                     stdp=config.get("plasticity"), dtype=dtype)
