"""Run results: probe data + wall-clock / realtime-factor accounting.

RTF = T_wall / T_model, the paper's yardstick (< 1 is sub-realtime; at
dt = 0.1 ms that is at most 100 us of wall time per simulation step).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

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
    """
    data: Dict[str, np.ndarray]
    t_model_ms: float
    n_steps: int
    dt: float
    wall_s: float
    overflow: int = 0
    device: str = ""
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
