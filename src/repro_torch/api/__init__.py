"""The port's session API: ``Simulator``, backends, probes, results and
declarative experiments."""
from repro_torch.api.backends import (Backend, FusedBackend,
                                      InstrumentedBackend, make_backend)
from repro_torch.api.experiment import Experiment, ExperimentResult
from repro_torch.api.probes import (Probe, ProbeContext, StreamProbe, custom,
                                    mean_plastic_weight, pop_counts,
                                    spike_stats, spikes, total_counts,
                                    voltage, weight_stats)
from repro_torch.api.results import BatchResult, RunResult, concat
from repro_torch.api.simulator import Simulator
from repro_torch.core.delivery import DeliveryOverflowError
from repro_torch.core.plasticity import PairSTDP, PlasticityRule
from repro_torch.core.stimulus import (DCInput, PoissonBackground,
                                       StepCurrent, Stimulus, ThalamicPulses)

__all__ = ["Simulator", "RunResult", "BatchResult", "concat",
           "DeliveryOverflowError", "Experiment", "ExperimentResult",
           "Backend", "FusedBackend", "InstrumentedBackend", "make_backend",
           "Probe", "ProbeContext", "StreamProbe", "custom",
           "mean_plastic_weight", "pop_counts", "spike_stats", "spikes",
           "total_counts", "voltage", "weight_stats",
           "Stimulus", "PoissonBackground", "DCInput", "StepCurrent",
           "ThalamicPulses", "PlasticityRule", "PairSTDP"]
