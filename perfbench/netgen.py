"""The microcircuit's connectome, drawn on the device from a seed.

PD-2014's rules, as the port's ``core/connectivity.py`` encodes them:
``K[t, s]`` synapses per projection (NEST's ``fixed_total_number``, with
multapses and autapses), each with a source and a target drawn uniformly
from their populations; weights normal about the excitatory weight (times
``g`` for inhibitory sources, doubled for L4E -> L23E) with a relative
spread of 0.1, clipped at 0 on their sign's side; delays normal about 1.5
ms (excitatory) or 0.75 ms (inhibitory) with a relative spread of 0.5,
clipped to ``[dt, mean + 4 sd]`` and rounded to bins of ``dt`` (at least
one).  The synapses are laid out as the padded per-source ELL table the
port takes: a row per source, target ``N`` (the ring's dump column) in the
padding.  A cut in-degree (``k_scaling < 1``) scales the weights by
``1 / sqrt(k_scaling)`` and adds the DC that replaces the lost mean input.

The draw is a few large calls on one ``torch.Generator`` of the device, so
the same seed gives the same network on the same device.  The result is a
``repro_torch.core.connectivity.Connectome`` of host arrays, which
``Simulator(config, connectome=...)`` takes as it takes the port's own
build.  ``NetDraw`` keeps the device tensors for the caller that wants
them before they are freed.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from perfbench.reference import pd14


@dataclasses.dataclass
class NetDraw:
    """A drawn network on the device: the ELL tables ``[N, K]`` (targets
    int32 with the sentinel ``N``, weights float32, delay bins int32) and
    the per-neuron and per-population numbers the connectome holds."""
    targets: torch.Tensor
    weights: torch.Tensor
    dbins: torch.Tensor
    out_degree: torch.Tensor
    pop_sizes: np.ndarray
    k_per_proj: np.ndarray         # [t, s] synapses drawn
    d_max_bins: int
    w_ext: float
    k_scaling: float
    dt: float
    stats: dict                    # per population: mean degrees

    @property
    def n_total(self) -> int:
        return int(self.pop_sizes.sum())

    @property
    def n_exc(self) -> int:
        return int(self.stats["n_exc"])


def draw(scale: float, seed: int, device, dt: float = 0.1) -> NetDraw:
    """Draw the network at ``scale`` (neurons and in-degrees both) from
    ``seed`` on ``device``."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    n_pop = pd14.scaled_counts(scale)
    offsets = np.concatenate([[0], np.cumsum(n_pop)])
    n = int(offsets[-1])
    k_proj = pd14.synapse_numbers(n_pop, scale)            # [t, s]
    syn = pd14.SYNAPSE
    w_e = pd14.w_exc()
    d_bins = pd14.d_max_bins(dt)

    # one row per projection with synapses: its sizes and moments
    rows = [(t, s) for t in range(len(n_pop)) for s in range(len(n_pop))
            if k_proj[t, s]]
    ks = np.array([k_proj[t, s] for t, s in rows], dtype=np.int64)
    exc = np.array([s < pd14.N_EXC_POPS for _, s in rows])
    w_mean = np.where(exc, w_e, syn["g"] * w_e)
    l4e, l23e = pd14.POPULATIONS.index("L4E"), pd14.POPULATIONS.index("L23E")
    for i, (t, s) in enumerate(rows):
        if (t, s) == (l23e, l4e):
            w_mean[i] *= syn["PSP_23e_4e_factor"]
    d_mean = np.where(exc, syn["delay_e"], syn["delay_i"])
    d_sd = d_mean * syn["delay_rel_sd"]
    d_hi = d_mean + syn["d_clip_sigmas"] * d_sd
    per = lambda a, dtype=torch.float32: torch.as_tensor(
        np.asarray(a), dtype=dtype, device=device).repeat_interleave(
        torch.as_tensor(ks, device=device))

    s_lo = per([offsets[s] for _, s in rows], torch.int64)
    s_n = per([n_pop[s] for _, s in rows], torch.int64)
    t_lo = per([offsets[t] for t, _ in rows], torch.int64)
    t_n = per([n_pop[t] for t, _ in rows], torch.int64)
    n_syn = int(ks.sum())

    def uniform_int(lo, size):
        u = torch.randint(0, 2 ** 62, (n_syn,), generator=gen,
                          device=device)
        return (lo + torch.remainder(u, size)).to(torch.int32)
    src = uniform_int(s_lo, s_n)
    del s_lo, s_n
    tgt = uniform_int(t_lo, t_n)
    del t_lo, t_n

    mean = per(w_mean, torch.float64)
    w = mean + mean.abs() * syn["PSP_rel_sd"] * torch.randn(
        n_syn, generator=gen, device=device, dtype=torch.float64)
    exc_t = per(exc, torch.bool)
    w = torch.where(exc_t, w.clamp(min=0.0), w.clamp(max=0.0))
    w = w.to(torch.float32)
    del mean, exc_t
    d = per(d_mean, torch.float64) + per(d_sd, torch.float64) * torch.randn(
        n_syn, generator=gen, device=device, dtype=torch.float64)
    d = torch.minimum(d.clamp(min=dt), per(d_hi, torch.float64))
    db = torch.round(d / dt).clamp(min=1).to(torch.int32)
    del d

    stats = degree_stats(src, tgt, n_pop, int(offsets[pd14.N_EXC_POPS]))
    # the ELL layout: synapses grouped by source, in draw order within one
    order = torch.sort(src, stable=True).indices
    src, tgt, w, db = src[order], tgt[order], w[order], db[order]
    del order
    out_deg = torch.bincount(src, minlength=n)
    k_max = int(out_deg.max()) if n_syn else 1
    start = torch.cumsum(out_deg, 0) - out_deg
    flat = src.to(torch.int64) * k_max + (
        torch.arange(n_syn, device=device) - start[src.to(torch.int64)])
    del start, src
    targets = torch.full((n * k_max,), n, dtype=torch.int32, device=device)
    weights = torch.zeros(n * k_max, dtype=torch.float32, device=device)
    dbins = torch.ones(n * k_max, dtype=torch.int32, device=device)
    targets[flat] = tgt
    del tgt
    weights[flat] = w
    del w
    dbins[flat] = db
    del db, flat

    w_scale = 1.0 / np.sqrt(scale)
    if scale != 1.0:
        weights *= np.float32(w_scale)
    return NetDraw(targets=targets.view(n, k_max),
                   weights=weights.view(n, k_max),
                   dbins=dbins.view(n, k_max),
                   out_degree=out_deg.to(torch.int32), pop_sizes=n_pop,
                   k_per_proj=k_proj, d_max_bins=d_bins,
                   w_ext=float(w_e * w_scale), k_scaling=float(scale),
                   dt=float(dt), stats=stats)


def degree_stats(src, tgt, n_pop, n_exc: int) -> dict:
    """Per population, the mean out- and in-degree of its neurons, and
    the mean of their plastic (E->E) ones: what the rooflines count a
    spike of the population as touching."""
    n, n_pops = int(n_pop.sum()), len(n_pop)
    pop = torch.repeat_interleave(
        torch.arange(n_pops, device=src.device),
        torch.as_tensor(n_pop, device=src.device))
    plastic = (src < n_exc) & (tgt < n_exc)

    def per_pop(ids):
        deg = torch.bincount(ids.to(torch.int64), minlength=n)
        by = torch.zeros(n_pops, dtype=torch.float64, device=src.device)
        by.index_add_(0, pop, deg.to(torch.float64))
        return (by.cpu().numpy() / n_pop).tolist()
    return {"out": per_pop(src), "in": per_pop(tgt),
            "out_plastic": per_pop(src[plastic]),
            "in_plastic": per_pop(tgt[plastic]),
            "n": n, "n_exc": n_exc}


def to_host(a: torch.Tensor) -> np.ndarray:
    """``a`` as a numpy array, through pinned memory when on a card."""
    if a.device.type != "cuda":
        return a.numpy()
    host = torch.empty(a.shape, dtype=a.dtype, pin_memory=True)
    host.copy_(a)
    return host.numpy()


def connectome(net: NetDraw):
    """The port's ``Connectome`` of host arrays for ``net``."""
    from repro_torch.core.connectivity import Connectome
    n_pop = net.pop_sizes
    offsets = np.concatenate([[0], np.cumsum(n_pop)])
    pop_of = np.repeat(np.arange(len(n_pop), dtype=np.int32), n_pop)
    i_dc = pd14.dc_compensation(net.k_scaling)
    k_ext = pd14.K_EXT.astype(np.float64) * net.k_scaling
    return Connectome(
        n_total=net.n_total, n_exc=int(offsets[pd14.N_EXC_POPS]),
        pop_sizes=n_pop, pop_offsets=offsets,
        targets=to_host(net.targets), weights=to_host(net.weights),
        dbins=to_host(net.dbins), out_degree=to_host(net.out_degree),
        n_synapses=int(net.k_per_proj.sum()), d_max_bins=net.d_max_bins,
        k_ext=k_ext[pop_of].astype(np.float32),
        i_dc=i_dc[pop_of].astype(np.float32), w_ext=net.w_ext,
        v0_mean=pd14.V0_MEAN[pop_of].astype(np.float32),
        v0_sd=pd14.V0_SD[pop_of].astype(np.float32), pop_of=pop_of,
        k_scaling=net.k_scaling)
