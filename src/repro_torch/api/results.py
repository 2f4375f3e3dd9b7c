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
