"""The paper's own model: full-density cortical microcircuit (PD 2014).

Field for field the reference's ``repro.configs.microcircuit``, so a
config means the same network in both packages.
"""
import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MicrocircuitConfig:
    name: str = "microcircuit"
    family: str = "snn"
    scale: Optional[float] = None   # sets n_scaling = k_scaling at once
    n_scaling: float = 1.0
    k_scaling: float = 1.0
    dt: float = 0.1              # ms
    t_sim: float = 10000.0       # ms, the paper's strong-scaling task (10 s)
    t_presim: float = 100.0      # ms discarded transient
    strategy: str = "event"      # delivery registry: event | ell | dense
    spike_budget: Optional[int] = None   # None -> rate-derived auto
    strict_delivery: bool = False        # raise on dropped spikes
    seed: int = 55
    stimulus: Optional[tuple] = None     # stimulus timeline; None -> the
                                         # paper's 8 Hz poisson_background
    kernels: Optional[str] = None        # kernel mode ("auto"/"fused"/
                                         # "split"/"reference");
                                         # None -> "auto"


CONFIG = MicrocircuitConfig()
SMOKE = MicrocircuitConfig(n_scaling=0.02, k_scaling=0.02, t_sim=100.0,
                           spike_budget=128)
