"""Analysis of recorded activity (numpy only): rates, irregularity and
synchrony, as in ``repro.core.recording``.

``cv_isi`` and ``pairwise_correlation`` compute the moments the reference
gets from its raster accumulator (``repro/validate/stats.py``), with the
same float32 sums in the same order, and finalize them as it does, so both
packages give the same numbers for the same raster."""
from __future__ import annotations

from typing import Dict

import numpy as np

from repro_torch.core import params as P


def population_rates(pop_counts: np.ndarray, c, dt: float) -> np.ndarray:
    """Mean firing rate (Hz) per population from [T, 8] spike counts."""
    t_total_s = pop_counts.shape[0] * dt * 1e-3
    return pop_counts.sum(axis=0) / (c.pop_sizes * t_total_s)


def spike_trains(spikes: np.ndarray):
    """[T, N] bool -> list of spike-step arrays per neuron."""
    t_idx, n_idx = np.nonzero(spikes)
    order = np.argsort(n_idx, kind="stable")
    t_idx, n_idx = t_idx[order], n_idx[order]
    splits = np.searchsorted(n_idx, np.arange(1, spikes.shape[1]))
    return np.split(t_idx, splits)


def cv_isi(spikes: np.ndarray, min_spikes: int = 3) -> float:
    """Mean coefficient of variation of the inter-spike intervals (about 1
    for Poisson-like firing) over the neurons with at least
    ``min_spikes`` spikes; nan when none has."""
    spikes = np.asarray(spikes)
    n = spikes.shape[1]
    count = np.zeros(n, np.float64)
    isi_sum = np.zeros(n, np.float32)
    isi_sumsq = np.zeros(n, np.float32)
    for j, train in enumerate(spike_trains(spikes)):
        if train.size == 0:
            continue
        isis = np.diff(train).astype(np.float32)
        count[j] = isis.size
        isi_sum[j] += np.float32(isis.sum())
        isi_sumsq[j] += np.float32((isis ** 2).sum())
    valid = count >= max(min_spikes - 1, 1)
    with np.errstate(divide="ignore", invalid="ignore"):
        mean = np.asarray(isi_sum, np.float64) / count
        var = np.asarray(isi_sumsq, np.float64) / count - mean ** 2
        cv = np.sqrt(np.maximum(var, 0.0)) / mean
    cv[~valid | ~(mean > 0)] = np.nan
    return float(np.nanmean(cv)) if np.isfinite(cv).any() else float("nan")


def pairwise_correlation(spikes: np.ndarray, bin_steps: int = 20) -> float:
    """Mean pairwise Pearson correlation of ``bin_steps``-binned spike
    counts (near 0 in the asynchronous-irregular state); the trailing
    partial bin is left out, and nan with fewer than 2 bins."""
    spikes = np.asarray(spikes)
    n_bins = spikes.shape[0] // bin_steps
    if n_bins < 2:
        return float("nan")
    n = spikes.shape[1]
    bin_sum = np.zeros(n, np.float32)
    bin_outer = np.zeros((n, n), np.float32)
    for b in range(n_bins):
        x = spikes[b * bin_steps:(b + 1) * bin_steps].astype(
            np.int32).sum(axis=0).astype(np.float32)
        bin_sum = (bin_sum + x).astype(np.float32)
        bin_outer = (bin_outer + np.outer(x, x)).astype(np.float32)
    mean = np.asarray(bin_sum, np.float64) / n_bins
    cov = np.asarray(bin_outer, np.float64) / n_bins - np.outer(mean, mean)
    sd = np.sqrt(np.maximum(np.diag(cov), 0.0))
    with np.errstate(divide="ignore", invalid="ignore"):
        corr = cov / np.outer(sd, sd)
    corr[sd == 0, :] = np.nan
    corr[:, sd == 0] = np.nan
    vals = corr[np.triu_indices(n, k=1)]
    vals = vals[np.isfinite(vals)]
    return float(vals.mean()) if vals.size else float("nan")


def synchrony(pop_counts: np.ndarray, bin_steps: int = 10) -> float:
    """Variance/mean of the binned population spike count (~1 when
    asynchronous, >> 1 when synchronous)."""
    t = (pop_counts.shape[0] // bin_steps) * bin_steps
    binned = pop_counts[:t].reshape(-1, bin_steps, pop_counts.shape[1]).sum(1)
    m = binned.mean(axis=0)
    v = binned.var(axis=0)
    return float(np.mean(v[m > 0] / m[m > 0])) if (m > 0).any() \
        else float("nan")


def activity_summary(pop_counts: np.ndarray, c,
                     dt: float) -> Dict[str, np.ndarray]:
    rates = population_rates(np.asarray(pop_counts), c, dt)
    return {
        "rates_hz": rates,
        "target_rates_hz": P.FULL_MEAN_RATES,
        "rate_abs_err": np.abs(rates - P.FULL_MEAN_RATES),
        "synchrony": synchrony(np.asarray(pop_counts)),
    }
