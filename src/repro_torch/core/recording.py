"""Analysis of recorded activity (numpy only): rates and synchrony, as in
``repro.core.recording``."""
from __future__ import annotations

from typing import Dict

import numpy as np

from repro_torch.core import params as P


def population_rates(pop_counts: np.ndarray, c, dt: float) -> np.ndarray:
    """Mean firing rate (Hz) per population from [T, 8] spike counts."""
    t_total_s = pop_counts.shape[0] * dt * 1e-3
    return pop_counts.sum(axis=0) / (c.pop_sizes * t_total_s)


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
