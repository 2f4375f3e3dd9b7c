"""Published microcircuit target bands for statistical validation.

The port's own copy of ``repro/validate/reference.py``, over
``repro_torch.core.params``.

The microcircuit's asynchronous-irregular (AI) ground state is the
acceptance bar shared by every reproduction of the model (NEST reference:
Potjans & Diesmann 2014; GPU ports: Golosio et al. 2020, Knight & Nowotny
2018; the paper under reproduction simulates the same state):

* cell-type specific mean rates close to the full-scale reference
  (``params.FULL_MEAN_RATES``, the values NEST converges to),
* irregular spiking — CV of the inter-spike intervals around 1
  (Poisson-like; the reference populations sit in ~[0.7, 1.2], and
  down-scaled nets drift lower because DC replaces input fluctuations),
* asynchrony — pairwise spike-count correlations near zero and a low
  variance-to-mean ratio of the binned population count.

Bands are deliberately wide: they catch the qualitative failure modes
(silent / epileptic / clock-like / synchronized networks, broken delivery
or RNG) without flagging the expected down-scaling drift.  Tighten them
per-study via the factory arguments.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

from repro_torch.core import params as P


@dataclasses.dataclass(frozen=True)
class Band:
    """Closed interval; ``contains`` is the pass predicate."""
    lo: float
    hi: float

    def contains(self, value: float) -> bool:
        return self.lo <= value <= self.hi

    def as_tuple(self) -> Tuple[float, float]:
        return (self.lo, self.hi)


@dataclasses.dataclass(frozen=True)
class ReferenceSpec:
    """Target bands for one validation run (all rates in Hz, times in ms)."""
    populations: Tuple[str, ...]
    rate_hz: Tuple[Band, ...]        # one band per population
    cv_isi: Band                     # shared irregularity band
    correlation: Band                # shared pairwise-correlation band
    synchrony: Band                  # variance/mean of binned pop counts
    min_spikes: int = 3              # spikes needed to enter the CV average

    def __post_init__(self):
        if len(self.rate_hz) != len(self.populations):
            raise ValueError(
                f"need one rate band per population: "
                f"{len(self.rate_hz)} bands, "
                f"{len(self.populations)} populations")


def microcircuit_reference(rate_rel_tol: float = 0.5,
                           rate_abs_tol: float = 1.0,
                           cv_band: Tuple[float, float] = (0.3, 1.5),
                           corr_band: Tuple[float, float] = (-0.05, 0.1),
                           sync_band: Tuple[float, float] = (0.0, 8.0),
                           ) -> ReferenceSpec:
    """The default spec: full-scale reference rates with generous tolerance.

    Per population the accepted rate band is
    ``ref * (1 -+ rate_rel_tol) -+ rate_abs_tol`` — wide enough for the
    van-Albada down-scaling drift at small scales, narrow enough that a
    silent or runaway population fails.  The CV band's low edge (0.3)
    admits the regularisation that DC compensation introduces at small
    scales (the full-scale AI band is ~[0.7, 1.2]).
    """
    bands = tuple(
        Band(max(0.0, r * (1 - rate_rel_tol) - rate_abs_tol),
             r * (1 + rate_rel_tol) + rate_abs_tol)
        for r in P.FULL_MEAN_RATES)
    return ReferenceSpec(
        populations=P.POPULATIONS,
        rate_hz=bands,
        cv_isi=Band(*cv_band),
        correlation=Band(*corr_band),
        synchrony=Band(*sync_band))
