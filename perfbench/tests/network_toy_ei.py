"""A two-population E/I network on the port's ``iaf_psc_exp``: a test
fixture that ``test_perfbench_networks.py`` copies to
``perfbench/networks/toy_ei.py`` of a scratch root, to add a second
network as files alone.  It is no configuration of the benchmark.

800 excitatory and 200 inhibitory neurons, each with a fixed in-degree of
80 excitatory and 20 inhibitory sources (drawn with multapses), weights
``J`` and ``-G * J``, one delay of 1.5 ms, and a Poisson drive of
``K_EXT`` sources a neuron; PD-2014's neuron parameters, so the plain
reference is ``perfbench/reference/lif_net.py``'s.
"""
from __future__ import annotations

import numpy as np
import torch

from perfbench import netgen
from perfbench.reference import pd14
from perfbench.reference.lif_net import Reference

POP_SIZES = np.array([800, 200], dtype=np.int64)
IN_DEGREE = np.array([80, 20], dtype=np.int64)      # from E, from I
G, DELAY_MS, K_EXT = 4.0, 1.5, 950.0
V0_MEAN, V0_SD = -58.0, 5.0
NEURON_LEAVES = ("V", "I_ex", "I_in", "refrac")
PLASTIC_LEAVES = ("weights", "x_pre", "x_post")


def draw(config: dict, seed: int, device) -> netgen.NetDraw:
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed) % (2 ** 63))
    n, n_exc = int(POP_SIZES.sum()), int(POP_SIZES[0])
    tgt = torch.arange(n, device=dev).repeat_interleave(int(IN_DEGREE.sum()))
    col = torch.arange(int(IN_DEGREE.sum()), device=dev).repeat(n)
    from_e = col < int(IN_DEGREE[0])
    u = torch.randint(0, 2 ** 62, (tgt.numel(),), generator=gen, device=dev)
    src = torch.where(from_e, u % n_exc, n_exc + u % int(POP_SIZES[1]))
    j = pd14.w_exc()
    w = torch.where(from_e, j, -G * j).to(torch.float32)
    d_bins = int(round(DELAY_MS / config["dt_ms"]))
    stats = netgen.degree_stats(src, tgt, POP_SIZES, n_exc)
    # the ELL layout: a row per source, target n in the padding
    order = torch.sort(src, stable=True).indices
    src, tgt, w = src[order], tgt[order], w[order]
    out_deg = torch.bincount(src, minlength=n)
    k = int(out_deg.max())
    slot = torch.arange(src.numel(), device=dev) - (
        torch.cumsum(out_deg, 0) - out_deg)[src]
    targets = torch.full((n, k), n, dtype=torch.int32, device=dev)
    weights = torch.zeros((n, k), dtype=torch.float32, device=dev)
    targets[src, slot] = tgt.to(torch.int32)
    weights[src, slot] = w
    k_proj = np.outer(POP_SIZES, IN_DEGREE)              # [t, s]
    return netgen.NetDraw(
        targets=targets, weights=weights,
        dbins=torch.full((n, k), d_bins, dtype=torch.int32, device=dev),
        out_degree=out_deg.to(torch.int32), pop_sizes=POP_SIZES,
        k_per_proj=k_proj, d_max_bins=d_bins + 1, w_ext=j, k_scaling=1.0,
        dt=float(config["dt_ms"]), stats=stats)


def connectome(net: netgen.NetDraw):
    from repro_torch.core.connectivity import Connectome
    pop_of = np.repeat(np.arange(2, dtype=np.int32), POP_SIZES)
    n = net.n_total
    full = lambda x: np.full(n, x, dtype=np.float32)
    return Connectome(
        n_total=n, n_exc=net.n_exc, pop_sizes=POP_SIZES,
        pop_offsets=np.concatenate([[0], np.cumsum(POP_SIZES)]),
        targets=net.targets.numpy(), weights=net.weights.numpy(),
        dbins=net.dbins.numpy(), out_degree=net.out_degree.numpy(),
        n_synapses=int(net.k_per_proj.sum()), d_max_bins=net.d_max_bins,
        k_ext=full(K_EXT), i_dc=full(0.0), w_ext=net.w_ext,
        v0_mean=full(V0_MEAN), v0_sd=full(V0_SD), pop_of=pop_of,
        k_scaling=1.0)


def simulator(config: dict, traffic: dict, c, key: int, device):
    from repro_torch.api import Simulator
    from repro_torch.configs.microcircuit import MicrocircuitConfig
    model = MicrocircuitConfig(
        dt=config["dt_ms"], strategy=config["strategy"],
        t_presim=config["t_presim_ms"], seed=0, kernels=config["kernels"])
    return Simulator(model, connectome=c, key=key, device=device,
                     probes=tuple(traffic["probes"]),
                     stimulus=traffic["stimulus"],
                     plasticity=config.get("plasticity"))


def fresh(c, key: int, device, dtype=torch.float32,
          plastic: bool = False) -> dict:
    dev = torch.device(device)
    n = c.n_total
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(key))
    v0 = torch.as_tensor(c.v0_mean, device=dev) + torch.as_tensor(
        c.v0_sd, device=dev) * torch.randn(n, generator=gen, device=dev,
                                           dtype=torch.float32)
    zeros = lambda *shape: torch.zeros(shape, dtype=dtype, device=dev)
    out = {"V": v0.to(dtype), "I_ex": zeros(n), "I_in": zeros(n),
           "refrac": torch.zeros(n, dtype=torch.int32, device=dev),
           "ring": zeros(c.d_max_bins, 2, n + 1),
           "t": torch.zeros((), dtype=torch.int32, device=dev),
           "generator_state": gen.get_state()}
    if plastic:
        out.update(x_pre=torch.zeros(n, device=dev),
                   x_post=torch.zeros(n, device=dev))
    return out


def reference(c, config: dict, traffic: dict, device, dtype=torch.float32):
    stim = traffic["stimulus"]
    return Reference(c, device, dt=config["dt_ms"],
                     rate_hz=stim[0].get("rate_hz", 8.0),
                     stdp=config.get("plasticity"), dtype=dtype)
