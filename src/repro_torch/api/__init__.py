"""The port's session API: ``Simulator``, backends, probes and results."""
from repro_torch.api.backends import (Backend, FusedBackend,
                                      InstrumentedBackend, make_backend)
from repro_torch.api.probes import (Probe, ProbeContext, StreamProbe, custom,
                                    pop_counts, spike_stats, spikes,
                                    total_counts, voltage, weight_stats)
from repro_torch.api.results import RunResult, concat
from repro_torch.api.simulator import Simulator
from repro_torch.core.delivery import DeliveryOverflowError

__all__ = ["Simulator", "RunResult", "concat", "DeliveryOverflowError",
           "Backend", "FusedBackend", "InstrumentedBackend", "make_backend",
           "Probe", "ProbeContext", "StreamProbe", "custom", "pop_counts",
           "spike_stats", "spikes", "total_counts", "voltage",
           "weight_stats"]
