"""The port's session API: ``Simulator``, probes and results."""
from repro_torch.api.probes import (Probe, ProbeContext, pop_counts, spikes,
                                    total_counts, voltage)
from repro_torch.api.results import RunResult
from repro_torch.api.simulator import Simulator
from repro_torch.core.delivery import DeliveryOverflowError

__all__ = ["Simulator", "RunResult", "DeliveryOverflowError", "Probe",
           "ProbeContext", "pop_counts", "spikes", "total_counts", "voltage"]
