"""Validation of a run: streaming spike statistics against reference bands.

The port's counterpart of ``repro.validate``.  A run is judged on its
per-population firing rates, irregularity (CV of the inter-spike
intervals), pairwise spike-count correlation and synchrony against the
published microcircuit bands, into a machine-readable
:class:`~repro_torch.validate.report.ValidationReport`::

    from repro_torch.api import Simulator, spike_stats
    from repro_torch import validate as V

    ids = V.sample_ids(sim.connectome.pop_sizes, per_pop=100, seed=55)
    res = sim.run_chunked(10_000.0, chunk_ms=1_000.0,
                          probes=("pop_counts", spike_stats(ids)))
    report = V.validate(res)
    print(report.table()); report.to_json("validation.json")

The statistics stream (``validate.stats``): the loop accumulates moments of
``Ns`` sampled neurons on the device, ``O(Ns^2)`` whatever the horizon; a
recorded raster goes through the same math (``RasterAccumulator``).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.validate import stats as stats  # noqa: F401 (submodule)
from repro_torch.validate.reference import (Band, ReferenceSpec,
                                            microcircuit_reference)
from repro_torch.validate.report import CheckResult, ValidationReport
from repro_torch.validate.stats import (RasterAccumulator, SpikeStatistics,
                                        finalize, sample_ids)

__all__ = [
    "Band", "CheckResult", "RasterAccumulator", "ReferenceSpec",
    "SpikeStatistics", "ValidationReport", "finalize",
    "microcircuit_reference", "sample_ids", "validate", "stats",
]


def _find_spike_stats_stream(streams: dict) -> Optional[dict]:
    """The spike-stats snapshot, whatever its probe's name: the default
    name first, else a snapshot whose meta has the finalizer's ``ids`` and
    ``bin_steps``."""
    if "spike_stats" in streams:
        return streams["spike_stats"]
    for snap in streams.values():
        meta = snap.get("meta", {}) if isinstance(snap, dict) else {}
        if "ids" in meta and "bin_steps" in meta:
            return snap
    return None


def validate(result, spec: Optional[ReferenceSpec] = None,
             connectome=None) -> ValidationReport:
    """Judge a ``RunResult`` against a :class:`ReferenceSpec`
    (``repro/validate/__init__.py:61-166``).

    The sources, in order of preference: the ``spike_stats`` stream's
    moment carry (CV-ISI and correlation at any scale); a ``spikes``
    raster, through the same math over 100 sampled neurons a population;
    ``pop_counts`` (exact rates and the synchrony measure).  The rates come
    from ``pop_counts`` where it was recorded.  A check whose statistic is
    missing is a ``skip``: in the report, never failing it.
    """
    spec = spec or microcircuit_reference()
    c = connectome if connectome is not None else result._connectome
    if c is None:
        raise ValueError("validate() needs the connectome; use the "
                         "RunResult returned by Simulator or pass "
                         "connectome=")
    n_pops = len(spec.populations)
    if len(c.pop_sizes) != n_pops:
        raise ValueError(
            f"connectome has {len(c.pop_sizes)} populations, spec "
            f"{n_pops}; build a matching ReferenceSpec")

    sampled: Optional[SpikeStatistics] = None
    stream = _find_spike_stats_stream(getattr(result, "streams", {}))
    if stream is not None:
        sampled = finalize(
            stream["carry"], ids=stream["meta"]["ids"], pop_of=c.pop_of,
            n_pops=n_pops, dt=result.dt,
            bin_steps=stream["meta"]["bin_steps"],
            min_spikes=spec.min_spikes)
    elif "spikes" in result.data:
        raster = np.asarray(result.data["spikes"])
        bin_steps = 20                      # 2 ms at the model's dt=0.1
        ids = sample_ids(c.pop_sizes, per_pop=100, seed=0)
        acc = RasterAccumulator(len(ids), bin_steps=bin_steps)
        acc.update(raster[:, ids])
        sampled = finalize(
            acc.carry, ids=ids, pop_of=c.pop_of, n_pops=n_pops,
            dt=result.dt, bin_steps=bin_steps, min_spikes=spec.min_spikes)

    from repro_torch.core import recording
    checks = []
    pop_counts = result.data.get("pop_counts")
    if pop_counts is not None:
        pop_counts = np.asarray(pop_counts)
        rates = recording.population_rates(pop_counts, c, result.dt)
        rate_src = "pop_counts"
    elif sampled is not None:
        rates = sampled.rate_hz
        rate_src = f"sampled ({int(sampled.n_sampled.sum())} neurons)"
    else:
        raise ValueError(
            "validate() needs at least one of: the 'spike_stats' stream "
            "probe, a 'spikes' raster, or the 'pop_counts' probe")

    for p, name in enumerate(spec.populations):
        checks.append(CheckResult.judge(
            "rate", name, float(rates[p]), spec.rate_hz[p],
            detail=f"mean rate (Hz), from {rate_src}"))
    for p, name in enumerate(spec.populations):
        value = float(sampled.cv_isi[p]) if sampled is not None else None
        detail = ("" if sampled is None else
                  f"{int(sampled.n_cv_valid[p])}/{int(sampled.n_sampled[p])}"
                  f" sampled neurons with >= {spec.min_spikes} spikes")
        checks.append(CheckResult.judge(
            "cv_isi", name, value, spec.cv_isi, detail=detail))
    for p, name in enumerate(spec.populations):
        value = (float(sampled.correlation[p])
                 if sampled is not None else None)
        detail = ("" if sampled is None else
                  f"{int(sampled.n_corr_valid[p])} neurons x "
                  f"{sampled.n_bins} bins of {sampled.bin_ms:g} ms")
        checks.append(CheckResult.judge(
            "correlation", name, value, spec.correlation, detail=detail))

    sync = None
    if pop_counts is not None and pop_counts.shape[0] >= 20:
        sync = float(recording.synchrony(pop_counts))
    checks.append(CheckResult.judge(
        "synchrony", "all", sync, spec.synchrony,
        detail="variance/mean of 1 ms-binned population counts"))

    meta = {
        "t_model_ms": result.t_model_ms,
        "n_steps": result.n_steps,
        "dt": result.dt,
        "n_neurons": int(c.n_total),
        "overflow": int(getattr(result, "overflow", 0)),
        "rate_source": rate_src,
    }
    if sampled is not None:
        meta["n_sampled"] = int(sampled.n_sampled.sum())
        meta["n_bins"] = sampled.n_bins
        meta["stats_t_model_ms"] = sampled.t_model_ms
    return ValidationReport(checks=checks, meta=meta)
