"""Run results: probe data + wall-clock / realtime-factor accounting.

RTF = T_wall / T_model, the paper's yardstick (< 1 is sub-realtime; at
dt = 0.1 ms that is at most 100 us of wall time per simulation step).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np


@dataclasses.dataclass
class RunResult:
    """Outcome of one ``Simulator.run``.

    ``data`` maps probe name -> host numpy array with leading axis
    ``n_steps``.  ``wall_s`` covers the timed run only (presim and warmup
    excluded), ending in a device synchronisation.  ``overflow`` is the
    session-cumulative count of spikes the delivery budget dropped; any
    increase is also surfaced as a warning (or ``DeliveryOverflowError``
    under ``strict_delivery``).  ``device`` names where it ran.
    ``timers`` holds the run's seconds per phase (the instrumented backend
    only); ``streams`` each stream probe's snapshot, ``{"carry": host
    numpy tree, "meta": ...}``, whose carry covers the session so far.
    """
    data: Dict[str, np.ndarray]
    t_model_ms: float
    n_steps: int
    dt: float
    wall_s: float
    overflow: int = 0
    device: str = ""
    timers: Dict[str, float] = dataclasses.field(default_factory=dict)
    streams: Dict[str, dict] = dataclasses.field(default_factory=dict)
    _connectome: Optional[object] = dataclasses.field(default=None,
                                                      repr=False)

    @property
    def rtf(self) -> float:
        """Wall seconds per second of model time."""
        return self.wall_s / (self.t_model_ms * 1e-3)

    def __getitem__(self, name: str) -> np.ndarray:
        return self.data[name]

    def summary(self) -> Dict[str, np.ndarray]:
        """Rates and synchrony from the ``pop_counts`` probe."""
        from repro_torch.core import recording
        if "pop_counts" not in self.data:
            raise KeyError("summary() needs the 'pop_counts' probe")
        if self._connectome is None:
            raise ValueError("summary() needs the connectome; use the "
                             "RunResult returned by Simulator")
        return recording.activity_summary(self["pop_counts"],
                                          self._connectome, self.dt)

    def validate(self, spec=None):
        """Judge this run against the reference bands
        (``repro_torch.validate``)."""
        from repro_torch import validate as V
        return V.validate(self, spec=spec)


@dataclasses.dataclass
class BatchResult:
    """Outcome of ``Simulator.run_batch``: independent trials.

    The trials ran one after the other over one set of graphs
    (``vmapped`` is False, kept for the reference's field), so each
    trial's ``wall_s`` and RTF is its own latency; ``wall_s`` is the whole
    batch's."""
    trials: List[RunResult]
    wall_s: float
    vmapped: bool = False
    seeds: List[int] = dataclasses.field(default_factory=list)

    def __len__(self) -> int:
        return len(self.trials)

    def __iter__(self):
        return iter(self.trials)

    def __getitem__(self, i: int) -> RunResult:
        return self.trials[i]

    @property
    def rtf_trials(self) -> np.ndarray:
        return np.array([r.rtf for r in self.trials])

    @property
    def rtf_mean(self) -> float:
        return float(self.rtf_trials.mean())

    @property
    def rtf_std(self) -> float:
        return float(self.rtf_trials.std())

    def pooled(self) -> RunResult:
        """One result pooling the trials: the per-step data concatenated
        along the step axis, the overflows summed, and each spike-stats
        carry pooled across trials (``stats.pool_carries``; another
        stream keeps the last trial's snapshot)."""
        from repro_torch.validate.stats import SpikeStatsCarry, pool_carries
        res = concat(self.trials)
        res.wall_s = self.wall_s
        res.overflow = sum(r.overflow for r in self.trials)
        streams = {}
        for name, snap in self.trials[0].streams.items():
            snaps = [r.streams[name] for r in self.trials]
            carry = pool_carries([s["carry"] for s in snaps]) \
                if isinstance(snap["carry"], SpikeStatsCarry) \
                else snaps[-1]["carry"]
            streams[name] = {"carry": carry, "meta": dict(snap["meta"])}
        res.streams = streams
        return res

    def validate(self, spec=None):
        """The across-trial validation report (see :meth:`pooled`)."""
        return self.pooled().validate(spec=spec)


def concat(results: List[RunResult]) -> RunResult:
    """Concatenate chunk results along the step axis (``run_chunked``):
    the timers add up, and the last chunk's stream snapshots, which cover
    the whole horizon, are kept."""
    if not results:
        raise ValueError("no chunks to concatenate")
    head = results[0]
    data = {name: np.concatenate([np.asarray(r.data[name]) for r in results],
                                 axis=0) for name in head.data}
    timers: Dict[str, float] = {}
    for r in results:
        for k, v in r.timers.items():
            timers[k] = timers.get(k, 0.0) + v
    return RunResult(
        data=data, t_model_ms=sum(r.t_model_ms for r in results),
        n_steps=sum(r.n_steps for r in results), dt=head.dt,
        wall_s=sum(r.wall_s for r in results),
        overflow=results[-1].overflow, device=head.device, timers=timers,
        streams=results[-1].streams, _connectome=head._connectome)
