"""Streaming spike statistics: rates, CV of ISI, pairwise correlation.

The port's counterpart of ``repro/validate/stats.py``.  The statistics of
the validation (per-population firing rate, irregularity and pairwise
spike-count correlation) keep moments instead of a raster: per sampled
neuron the spike count, the last spike's step and the ISI count, sum and
sum of squares; per closed count bin the binned count vector's running sum
and outer product.  Memory is ``O(Ns^2)`` for ``Ns`` sampled neurons,
whatever the horizon.

``init_carry`` / ``update_carry`` are tensor functions that run inside the
step loop (and inside a captured CUDA graph: nothing reads back to the
host).  :class:`RasterAccumulator` is their host mirror over recorded
``[T, Ns]`` rasters, :func:`pool_carries` pools independent trials, and
:func:`finalize` reduces a carry (host numpy, as ``RunResult.streams``
holds it) to per-population :class:`SpikeStatistics`.  All follow the
reference's float32 arithmetic in the reference's order, so a carry or a
raster gives the JAX package's values bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch


class SpikeStatsCarry(NamedTuple):
    """Moment accumulator over ``Ns`` sampled neurons, on the device."""
    steps: torch.Tensor       # [] int32   updates consumed so far
    last_spike: torch.Tensor  # [Ns] int32 step of last spike, -1 = never
    n_spikes: torch.Tensor    # [Ns] int32
    isi_count: torch.Tensor   # [Ns] int32 completed inter-spike intervals
    isi_sum: torch.Tensor     # [Ns] f32   sum of ISIs (in steps)
    isi_sumsq: torch.Tensor   # [Ns] f32   sum of squared ISIs
    bin_acc: torch.Tensor     # [Ns] int32 open (partial) count bin
    n_bins: torch.Tensor      # [] int32   closed bins
    bin_sum: torch.Tensor     # [Ns] f32   sum of closed-bin count vectors
    bin_outer: torch.Tensor   # [Ns, Ns] f32 sum of their outer products


def init_carry(n_sample: int, device=None) -> SpikeStatsCarry:
    i32 = lambda *s: torch.zeros(s, dtype=torch.int32, device=device)
    f32 = lambda *s: torch.zeros(s, dtype=torch.float32, device=device)
    return SpikeStatsCarry(
        steps=i32(), last_spike=torch.full((n_sample,), -1,
                                           dtype=torch.int32, device=device),
        n_spikes=i32(n_sample), isi_count=i32(n_sample),
        isi_sum=f32(n_sample), isi_sumsq=f32(n_sample),
        bin_acc=i32(n_sample), n_bins=i32(), bin_sum=f32(n_sample),
        bin_outer=f32(n_sample, n_sample))


def update_carry(carry: SpikeStatsCarry, spiked: torch.Tensor,
                 bin_steps: int) -> SpikeStatsCarry:
    """Absorb one step's sampled spike vector (``[Ns]`` bool).  A count bin
    closes every ``bin_steps`` updates; the trailing partial bin stays
    open.  The outer product is computed every step and kept only on a
    closing one (the reference's ``lax.cond``; a graph has no branch)."""
    t = carry.steps
    spk = spiked.to(torch.bool)
    spk_i = spk.to(torch.int32)

    new_isi = spk & (carry.last_spike >= 0)
    isi = (t - carry.last_spike).to(torch.float32)
    isi_add = torch.where(new_isi, isi, 0.0)

    steps = t + 1
    close = torch.remainder(steps, bin_steps) == 0
    bin_acc = carry.bin_acc + spk_i
    x = bin_acc.to(torch.float32)
    bin_outer = torch.where(close, carry.bin_outer + torch.outer(x, x),
                            carry.bin_outer)

    return SpikeStatsCarry(
        steps=steps,
        last_spike=torch.where(spk, t, carry.last_spike),
        n_spikes=carry.n_spikes + spk_i,
        isi_count=carry.isi_count + new_isi.to(torch.int32),
        isi_sum=carry.isi_sum + isi_add,
        isi_sumsq=carry.isi_sumsq + isi_add * isi,
        bin_acc=torch.where(close, torch.zeros_like(bin_acc), bin_acc),
        n_bins=carry.n_bins + close.to(torch.int32),
        bin_sum=torch.where(close, carry.bin_sum + x, carry.bin_sum),
        bin_outer=bin_outer)


def _host(carry) -> SpikeStatsCarry:
    """A carry's fields as numpy (tensors moved to the host)."""
    return SpikeStatsCarry(*(np.asarray(x.cpu()) if isinstance(
        x, torch.Tensor) else np.asarray(x) for x in carry))


class RasterAccumulator:
    """The host mirror of the in-loop accumulator, fed ``[T, Ns]`` rasters.

    Feeding chunks one after the other equals one call on their
    concatenation, and both equal the device carry at test horizons (the
    same float32 moments, bins aligned from step 0).  Where partial sums
    leave float32's exact range the two can drift by ulps: the host sums
    each chunk's ISIs pairwise, the device adds per step.
    ``correlation=False`` skips the ``[Ns, Ns]`` outer-product accumulator
    (``recording.cv_isi`` over many neurons).
    """

    def __init__(self, n_sample: int, bin_steps: int,
                 correlation: bool = True):
        self.bin_steps = int(bin_steps)
        self.correlation = bool(correlation)
        carry = _host(init_carry(n_sample))
        if not self.correlation:
            carry = carry._replace(bin_outer=np.zeros((0, 0), np.float32))
        self.carry = carry

    def update(self, raster: np.ndarray) -> None:
        """Absorb a ``[T, Ns]`` bool/int chunk."""
        raster = np.asarray(raster)
        if raster.ndim != 2 or raster.shape[1] != self.carry.n_spikes.shape[0]:
            raise ValueError(
                f"raster must be [T, {self.carry.n_spikes.shape[0]}], "
                f"got {raster.shape}")
        spk = raster.astype(bool)
        c = self.carry
        t0 = int(c.steps)
        T, ns = spk.shape

        # ISI moments and counts, per neuron over its train
        last_spike = np.asarray(c.last_spike).copy()
        n_spikes = np.asarray(c.n_spikes) + spk.sum(axis=0).astype(np.int32)
        isi_count = np.asarray(c.isi_count).copy()
        isi_sum = np.asarray(c.isi_sum).copy()
        isi_sumsq = np.asarray(c.isi_sumsq).copy()
        t_idx, nrn = np.nonzero(spk)
        order = np.argsort(nrn, kind="stable")
        t_idx, nrn = t_idx[order] + t0, nrn[order]
        splits = np.searchsorted(nrn, np.arange(1, ns))
        for j, train in enumerate(np.split(t_idx, splits)):
            if train.size == 0:
                continue
            prev = last_spike[j]
            times = train if prev < 0 else np.concatenate([[prev], train])
            isis = np.diff(times).astype(np.float64)
            isi_count[j] += isis.size
            isi_sum[j] += np.float32(isis.astype(np.float32).sum())
            isi_sumsq[j] += np.float32(
                (isis.astype(np.float32) ** 2).sum())
            last_spike[j] = train[-1]

        # count bins, closed at absolute steps that are multiples of
        # bin_steps, so chunking never shifts the bin grid
        bin_acc = np.asarray(c.bin_acc).copy()
        n_bins = int(c.n_bins)
        bin_sum = np.asarray(c.bin_sum).copy()
        bin_outer = np.asarray(c.bin_outer).copy()
        counts = spk.astype(np.int32)
        pos = 0
        while pos < T:
            fill = self.bin_steps - ((t0 + pos) % self.bin_steps)
            take = min(fill, T - pos)
            bin_acc = bin_acc + counts[pos:pos + take].sum(axis=0)
            pos += take
            if take == fill:                      # bin closed
                x = bin_acc.astype(np.float32)
                bin_sum = (bin_sum + x).astype(np.float32)
                if self.correlation:
                    bin_outer = (bin_outer
                                 + np.outer(x, x)).astype(np.float32)
                n_bins += 1
                bin_acc = np.zeros_like(bin_acc)

        self.carry = SpikeStatsCarry(
            steps=np.int32(t0 + T), last_spike=last_spike.astype(np.int32),
            n_spikes=n_spikes.astype(np.int32),
            isi_count=isi_count.astype(np.int32),
            isi_sum=isi_sum.astype(np.float32),
            isi_sumsq=isi_sumsq.astype(np.float32),
            bin_acc=bin_acc.astype(np.int32), n_bins=np.int32(n_bins),
            bin_sum=bin_sum.astype(np.float32),
            bin_outer=bin_outer.astype(np.float32))


def pool_carries(carries) -> SpikeStatsCarry:
    """Pool independent trials' carries into one: the closed moments
    (spike counts, ISI moments, closed count bins) and the step totals
    add up; the open tails (``last_spike``, ``bin_acc``) are reset, since
    an ISI or a count bin never spans two trials."""
    carries = [_host(c) for c in carries]
    if not carries:
        raise ValueError("no carries to pool")
    ns = carries[0].n_spikes.shape[0]
    if any(c.n_spikes.shape[0] != ns for c in carries):
        raise ValueError("carries sample different neuron counts")

    def tot(field, dtype):
        return sum(getattr(c, field) for c in carries).astype(dtype)

    return SpikeStatsCarry(
        steps=np.int32(sum(int(c.steps) for c in carries)),
        last_spike=np.full((ns,), -1, np.int32),
        n_spikes=tot("n_spikes", np.int32),
        isi_count=tot("isi_count", np.int32),
        isi_sum=tot("isi_sum", np.float32),
        isi_sumsq=tot("isi_sumsq", np.float32),
        bin_acc=np.zeros((ns,), np.int32),
        n_bins=np.int32(sum(int(c.n_bins) for c in carries)),
        bin_sum=tot("bin_sum", np.float32),
        bin_outer=tot("bin_outer", np.float32))


@dataclasses.dataclass
class SpikeStatistics:
    """Per-population statistics finalized from a moment carry."""
    rate_hz: np.ndarray          # [n_pops] sample-mean firing rate
    cv_isi: np.ndarray           # [n_pops] mean CV ISI (nan: no qualifying)
    correlation: np.ndarray      # [n_pops] mean pairwise count correlation
    n_sampled: np.ndarray        # [n_pops] neurons sampled
    n_cv_valid: np.ndarray       # [n_pops] neurons with >= min_spikes spikes
    n_corr_valid: np.ndarray     # [n_pops] neurons with count variance > 0
    t_model_ms: float            # statistics window (model time)
    n_bins: int                  # closed correlation bins
    bin_ms: float


def _cv_per_neuron(carry, min_spikes: int) -> np.ndarray:
    """CV = std/mean of each neuron's ISIs (ddof=0); nan with fewer than
    ``min_spikes`` spikes."""
    count = np.asarray(carry.isi_count, np.float64)
    valid = count >= max(min_spikes - 1, 1)
    with np.errstate(divide="ignore", invalid="ignore"):
        mean = np.asarray(carry.isi_sum, np.float64) / count
        var = np.asarray(carry.isi_sumsq, np.float64) / count - mean ** 2
        cv = np.sqrt(np.maximum(var, 0.0)) / mean
    cv[~valid | ~(mean > 0)] = np.nan
    return cv


def _corr_matrix(carry) -> Optional[np.ndarray]:
    """Pairwise Pearson correlation of the closed-bin counts (nan rows for
    zero-variance neurons); None with fewer than 2 closed bins."""
    nb = int(carry.n_bins)
    if nb < 2:
        return None
    mean = np.asarray(carry.bin_sum, np.float64) / nb
    cov = np.asarray(carry.bin_outer, np.float64) / nb - np.outer(mean, mean)
    sd = np.sqrt(np.maximum(np.diag(cov), 0.0))
    with np.errstate(divide="ignore", invalid="ignore"):
        corr = cov / np.outer(sd, sd)
    corr[sd == 0, :] = np.nan
    corr[:, sd == 0] = np.nan
    return corr


def finalize(carry, ids: np.ndarray, pop_of: np.ndarray, n_pops: int,
             dt: float, bin_steps: int, min_spikes: int = 3
             ) -> SpikeStatistics:
    """Reduce a moment carry to per-population statistics.  ``ids`` are the
    sampled neurons' global ids, ``pop_of`` the ``[N]`` population index,
    ``dt`` the step in ms; a neuron enters the CV average with at least
    ``min_spikes`` spikes (``recording.cv_isi``'s rule)."""
    carry = _host(carry)
    ids = np.asarray(ids)
    pops = np.asarray(pop_of)[ids]
    steps = int(carry.steps)
    t_s = steps * dt * 1e-3
    if steps == 0:
        raise ValueError("cannot finalize an empty statistics carry "
                         "(0 steps accumulated)")

    rate_per_neuron = np.asarray(carry.n_spikes, np.float64) / t_s
    cv = _cv_per_neuron(carry, min_spikes)
    corr = _corr_matrix(carry)

    rate_hz = np.full(n_pops, np.nan)
    cv_pop = np.full(n_pops, np.nan)
    corr_pop = np.full(n_pops, np.nan)
    n_sampled = np.zeros(n_pops, np.int64)
    n_cv = np.zeros(n_pops, np.int64)
    n_corr = np.zeros(n_pops, np.int64)
    for p in range(n_pops):
        sel = pops == p
        n_sampled[p] = sel.sum()
        if not sel.any():
            continue
        rate_hz[p] = rate_per_neuron[sel].mean()
        cv_sel = cv[sel]
        n_cv[p] = np.isfinite(cv_sel).sum()
        if n_cv[p]:
            cv_pop[p] = np.nanmean(cv_sel)
        if corr is not None:
            sub = corr[np.ix_(sel, sel)]
            finite_rows = np.isfinite(np.diag(sub))
            n_corr[p] = finite_rows.sum()
            sub = sub[np.ix_(finite_rows, finite_rows)]
            if sub.shape[0] >= 2:
                iu = np.triu_indices(sub.shape[0], k=1)
                vals = sub[iu]
                vals = vals[np.isfinite(vals)]
                if vals.size:
                    corr_pop[p] = vals.mean()
    return SpikeStatistics(
        rate_hz=rate_hz, cv_isi=cv_pop, correlation=corr_pop,
        n_sampled=n_sampled, n_cv_valid=n_cv, n_corr_valid=n_corr,
        t_model_ms=steps * dt, n_bins=int(carry.n_bins),
        bin_ms=bin_steps * dt)


def sample_ids(pop_sizes: Sequence[int], per_pop: int = 100,
               seed: int = 0) -> np.ndarray:
    """Up to ``per_pop`` sorted neuron ids per population, drawn with
    numpy's generator from ``seed`` (the reference's draw): sampling keeps
    the ``O(Ns^2)`` correlation accumulator small at natural density."""
    rng = np.random.default_rng(seed)
    offsets = np.concatenate([[0], np.cumsum(pop_sizes)])
    out = []
    for p, size in enumerate(pop_sizes):
        k = min(per_pop, int(size))
        out.append(np.sort(rng.choice(int(size), size=k, replace=False))
                   + offsets[p])
    return np.concatenate(out).astype(np.int32)
