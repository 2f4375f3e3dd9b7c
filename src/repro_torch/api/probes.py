"""Probe-based recording for the port's ``Simulator``.

A probe is a named per-step reducer evaluated inside the step loop on the
device; a run's result maps probe name -> ``[n_steps, ...]``.  Built-ins,
as in ``repro.api.probes``::

    pop_counts()       [T, n_pops] int32 spike counts per population
    spikes()           [T, N] bool raster (memory-heavy at scale)
    total_counts()     [T] int32 network-wide spike count
    voltage(ids=None)  [T, len(ids)] membrane potentials (all N if None)
    mean_plastic_weight()  [T] mean plastic weight (needs plasticity=...;
                       it reads the whole weight table, 2.6 GB a step at
                       full scale)

Stream probes (in-loop accumulators, ``weight_stats`` among them) wait for
a later slice.  No probe reads anything back to the host inside the loop.
On the fused path the plastic state a probe sees lags one step, as in the
reference: step i's context carries the update of step i - 1's spikes.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Sequence

import torch

from repro_torch.core import plasticity


class ProbeContext(NamedTuple):
    """What a probe may read each step."""
    state: object               # post-step engine state (SimState)
    spiked: torch.Tensor        # [N] bool, this step's spikes
    net: object                 # device tables (Network)
    n_pops: int                 # population count
    plastic: object = None      # PlasticState, plastic runs only
    plastic_mask: Optional[torch.Tensor] = None  # [N+1, K] bool


@dataclasses.dataclass(frozen=True)
class Probe:
    """A named per-step reducer. ``fn(ctx) -> torch.Tensor`` (fixed shape)."""
    name: str
    fn: Callable[[ProbeContext], torch.Tensor]

    def __call__(self, ctx: ProbeContext) -> torch.Tensor:
        return self.fn(ctx)


def pop_counts() -> Probe:
    """Per-population spike counts (``pop_of`` is sorted, so each
    population is one contiguous segment; the sum is a segment sum).

    On the card the ``index_add_`` serialises N atomic adds into 8
    counters (58 us of device time per step at full scale on an H100), but
    a membership-matrix product, at 4 us, cost the step more host time,
    and the host sets the step time while the loop is Python.
    """
    def fn(ctx: ProbeContext) -> torch.Tensor:
        out = torch.zeros(ctx.n_pops, dtype=torch.int32,
                          device=ctx.spiked.device)
        return out.index_add_(0, ctx.net.pop_of,
                              ctx.spiked.to(torch.int32))
    return Probe("pop_counts", fn)


def spikes() -> Probe:
    """Full boolean spike raster (small nets / short horizons)."""
    return Probe("spikes", lambda ctx: ctx.spiked)


def total_counts() -> Probe:
    """Network-wide spike count per step."""
    return Probe("total_counts",
                 lambda ctx: ctx.spiked.sum(dtype=torch.int32))


def voltage(ids: Optional[Sequence[int]] = None) -> Probe:
    """Membrane-potential traces for ``ids`` (all neurons when None)."""
    idx = None if ids is None else torch.as_tensor(ids, dtype=torch.int64)

    def fn(ctx: ProbeContext) -> torch.Tensor:
        V = ctx.state.neuron.V
        return V.clone() if idx is None else V[idx.to(V.device)]
    return Probe("voltage", fn)


def mean_plastic_weight() -> Probe:
    """Mean weight over the plastic synapses; needs ``plasticity=``."""
    def fn(ctx: ProbeContext) -> torch.Tensor:
        if ctx.plastic is None:
            raise ValueError(
                "mean_plastic_weight probe requires a plasticity-enabled "
                "run (pass plasticity=... to Simulator)")
        return plasticity.mean_plastic_weight(ctx.plastic.weights,
                                              ctx.plastic_mask)
    return Probe("mean_plastic_weight", fn)


_BUILTIN = {
    "pop_counts": pop_counts,
    "spikes": spikes,
    "total_counts": total_counts,
    "voltage": voltage,
    "mean_plastic_weight": mean_plastic_weight,
}


def resolve(probes: Sequence) -> tuple:
    """Normalise a mixed list of names / Probe objects; reject duplicates."""
    out = []
    for p in probes:
        if isinstance(p, str):
            if p not in _BUILTIN:
                raise ValueError(
                    f"unknown probe {p!r}; built-ins: {sorted(_BUILTIN)}")
            p = _BUILTIN[p]()
        elif not isinstance(p, Probe):
            raise TypeError(f"probe must be a name or Probe, got {type(p)}")
        out.append(p)
    names = [p.name for p in out]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate probe names: {names}")
    return tuple(out)
