"""Probe-based recording for the port's ``Simulator``.

A probe is a named per-step reducer evaluated inside the step loop on the
device; a run's result maps probe name -> ``[n_steps, ...]``.  Built-ins,
as in ``repro.api.probes``::

    pop_counts()          [T, n_pops] int32 spike counts per population
    spikes()              [T, N] bool raster (memory-heavy at scale)
    total_counts()        [T] int32 network-wide spike count
    voltage(ids=None)     [T, len(ids)] membrane potentials (all N if None)
    mean_plastic_weight() [T] mean plastic weight (needs plasticity=...;
                          it reads the whole weight table, 2.6 GB a step
                          at full scale)
    weight_stats()        streamed mean/std/min/max of the plastic weights
                          (a StreamProbe; needs plasticity=...)
    spike_stats(ids)      streamed spike moments of sampled neurons (a
                          StreamProbe; ``repro_torch.validate.stats``)
    custom(name, fn)      any reducer ``fn(ctx) -> tensor``

No probe reads anything back to the host inside the loop, so a probe runs
inside a captured CUDA graph as well as eagerly.  A probe may build a
device tensor it needs once (``voltage``'s ids, ``pop_counts``' population
bounds) at its first, eager evaluation: the backend evaluates every probe
once before it captures a graph.  On the fused path the plastic state a
probe sees lags one step, as in the reference: step i's context carries
the update of step i - 1's spikes.

Probes are interned (``resolve`` gives one instance per built-in name, and
``spike_stats`` one per sample and bin width), because the backend's graph
cache keys on probe instances: resolving the same name twice must not
capture a second graph.  ``ProbeLike`` is what ``resolve`` takes: a name,
a ``Probe`` or a ``StreamProbe``.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Callable, NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.core import plasticity
from repro_torch.kernels import pop_counts as pop_counts_kernel


class ProbeContext(NamedTuple):
    """What a probe may read each step."""
    state: object               # post-step engine state (SimState)
    spiked: torch.Tensor        # [N] bool, this step's spikes
    net: object                 # device tables (Network)
    n_pops: int                 # population count
    plastic: object = None      # PlasticState, plastic runs only
    plastic_mask: Optional[torch.Tensor] = None  # [N+1, K] bool
    kernels: bool = True        # the session's policy: the hand-written
                                # kernels, else the plain versions


@dataclasses.dataclass(frozen=True)
class Probe:
    """A named per-step reducer. ``fn(ctx) -> torch.Tensor`` (fixed shape)."""
    name: str
    fn: Callable[[ProbeContext], torch.Tensor]

    def __call__(self, ctx: ProbeContext) -> torch.Tensor:
        return self.fn(ctx)


def _on_device(cache: dict, device: torch.device, key,
               make: Callable[[], torch.Tensor]) -> torch.Tensor:
    """``make()``, kept in ``cache`` under ``key`` -- unless a CUDA graph is
    being captured on ``device``, where a new tensor would hold its value
    only in the graph's replays."""
    value = cache.get(key)
    if value is None:
        value = make()
        if not (device.type == "cuda"
                and torch.cuda.is_current_stream_capturing()):
            cache[key] = value
    return value


def pop_counts() -> Probe:
    """Per-population spike counts.  ``pop_of`` is sorted, so population
    p is the segment ``[at[p], at[p + 1])`` of the spike vector, and its
    count is that segment's: the reference's sorted ``segment_sum``
    (``repro/api/probes.py:59-65``), bit for bit.  On the card one launch
    of ``kernels/pop_counts.py`` a step; on the CPU, and under the
    ``reference`` policy, its plain version (the int32 running count
    differenced at the bounds).  The int32 bounds are built once, at the
    probe's first eager evaluation.
    """
    bounds_cache: dict = {}

    def fn(ctx: ProbeContext) -> torch.Tensor:
        pop_of = ctx.net.pop_of

        def bounds():
            ends = torch.searchsorted(
                pop_of, torch.arange(ctx.n_pops, dtype=pop_of.dtype,
                                     device=pop_of.device), right=True,
                out_int32=True)
            return torch.cat([ends.new_zeros(1), ends])
        at = _on_device(bounds_cache, pop_of.device,
                        (pop_of.data_ptr(), pop_of.device, pop_of.shape[0],
                         ctx.n_pops), bounds)
        return pop_counts_kernel.pop_counts(ctx.spiked, at,
                                            kernel=ctx.kernels)
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
    on_dev: dict = {}

    def fn(ctx: ProbeContext) -> torch.Tensor:
        V = ctx.state.neuron.V
        if idx is None:
            return V.clone()
        return V.index_select(0, _on_device(on_dev, V.device, V.device,
                                            lambda: idx.to(V.device)))
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


def custom(name: str, fn: Callable[[ProbeContext], torch.Tensor]) -> Probe:
    """Any reducer; it must return a fixed-shape tensor each step and read
    nothing back to the host."""
    return Probe(name, fn)


# ---------------------------------------------------------------------------
# Stream probes: stateful accumulators, one value per run instead of per step
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class StreamProbe:
    """A stateful per-step accumulator (vs. the per-step-output ``Probe``).

    ``init(device)`` builds the carry (a tensor, or a NamedTuple, tuple or
    dict of them), ``update(carry, x)`` absorbs one step and returns the
    new carry.  The carry threads through the backend's loop and, via the
    ``Simulator`` session, across ``run`` / ``run_chunked`` chunks, so the
    memory cost is the carry's, whatever the horizon.  Each run's result
    holds its snapshot in ``RunResult.streams`` as ``{"carry": ...,
    "meta": ...}``.

    Equality is identity (``eq=False``): the graph cache keys on probe
    instances, so reuse one instance across runs of a session.

    ``needs`` is what ``update`` consumes: ``"spiked"`` (the default) the
    step's spike vector, on every backend; ``"ctx"`` the whole
    :class:`ProbeContext` (the plastic state included), on the fused
    backend only.
    """
    name: str
    init: Callable[..., object]
    update: Callable[[object, object], object]
    meta: dict = dataclasses.field(default_factory=dict)
    needs: str = "spiked"          # "spiked" | "ctx"


def spike_stats(ids, bin_steps: int = 20,
                name: str = "spike_stats") -> StreamProbe:
    """Streamed spike statistics over the sampled neuron ``ids``: the
    moments behind per-population mean rate, CV-ISI and pairwise spike-count
    correlation (``repro_torch.validate.stats``), accumulated on the device
    inside the loop.  ``bin_steps`` is the correlation count-bin width in
    steps (20 = 2 ms at dt=0.1).  The carry is ``O(Ns^2)`` for ``Ns``
    sampled neurons."""
    from repro_torch.validate import stats as VS

    ids = np.asarray(ids, np.int32)
    if ids.ndim != 1 or ids.size == 0:
        raise ValueError(f"ids must be a non-empty 1-D id array, "
                         f"got shape {ids.shape}")
    bin_steps = int(bin_steps)
    if bin_steps < 1:
        raise ValueError(f"bin_steps must be >= 1, got {bin_steps}")
    key = (name, bin_steps, ids.tobytes())
    with _INTERN_LOCK:
        cached = _STREAM_INTERNED.get(key)
        if cached is not None:
            return cached
        host_ids = torch.from_numpy(ids.astype(np.int64))
        on_dev: dict = {}

        def update(carry, spiked):
            at = _on_device(on_dev, spiked.device, spiked.device,
                            lambda: host_ids.to(spiked.device))
            return VS.update_carry(carry, spiked.index_select(0, at),
                                   bin_steps=bin_steps)

        probe = StreamProbe(
            name=name, init=lambda device=None: VS.init_carry(ids.size,
                                                              device),
            update=update, meta={"ids": ids, "bin_steps": bin_steps})
        _STREAM_INTERNED[key] = probe
        return probe


def weight_stats(name: str = "weight_stats") -> StreamProbe:
    """Streamed mean/std/min/max of the plastic weights, in the loop: the
    carry holds the statistics of the last completed step and the step
    count.  Needs a plastic session on the fused backend.  Each step reads
    the whole table four times (2.6 GB each at full scale)."""
    def init(device=None):
        z = lambda: torch.zeros((), dtype=torch.float32, device=device)
        return {"steps": torch.zeros((), dtype=torch.int32, device=device),
                "mean": z(), "std": z(), "min": z(), "max": z()}

    def update(carry, ctx):
        if not isinstance(ctx, ProbeContext) or ctx.plastic is None:
            raise ValueError(
                "weight_stats probe requires a plasticity-enabled run "
                "(pass plasticity=... to Simulator, fused backend)")
        mask = ctx.plastic_mask
        w = ctx.plastic.weights.to(torch.float32)
        n_p = torch.clamp(mask.sum(), min=1).to(torch.float32)
        mean = torch.where(mask, w, 0.0).sum() / n_p
        var = torch.where(mask, (w - mean) ** 2, 0.0).sum() / n_p
        return {"steps": carry["steps"] + 1, "mean": mean,
                "std": torch.sqrt(var),
                "min": torch.where(mask, w, float("inf")).min(),
                "max": torch.where(mask, w, float("-inf")).max()}

    return StreamProbe(name=name, init=init, update=update,
                       meta={"kind": "weight_stats"}, needs="ctx")


def split_probes(probes: Sequence) -> tuple:
    """(per-step Probes, StreamProbes) partition, order-preserving."""
    step = tuple(p for p in probes if isinstance(p, Probe))
    stream = tuple(p for p in probes if isinstance(p, StreamProbe))
    return step, stream


ProbeLike = Union[str, Probe, StreamProbe]

_BUILTIN = {
    "pop_counts": pop_counts,
    "spikes": spikes,
    "total_counts": total_counts,
    "voltage": voltage,
    "mean_plastic_weight": mean_plastic_weight,
    "weight_stats": weight_stats,
}

# name -> interned instance of a built-in, and content key -> spike_stats
# instance; the lock keeps two threads from interning two instances
_INTERNED: dict = {}
_STREAM_INTERNED: dict = {}
_INTERN_LOCK = threading.Lock()


def resolve(probes: Sequence) -> tuple:
    """Normalise a mixed list of names / Probe / StreamProbe objects (names
    give their interned built-in); reject duplicates."""
    out = []
    for p in probes:
        if isinstance(p, str):
            if p not in _BUILTIN:
                raise ValueError(
                    f"unknown probe {p!r}; built-ins: {sorted(_BUILTIN)}")
            with _INTERN_LOCK:
                if p not in _INTERNED:
                    _INTERNED[p] = _BUILTIN[p]()
                p = _INTERNED[p]
        elif not isinstance(p, (Probe, StreamProbe)):
            raise TypeError(f"probe must be a name, Probe or StreamProbe, "
                            f"got {type(p)}")
        out.append(p)
    names = [p.name for p in out]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate probe names: {names}")
    return tuple(out)
