"""Quickstart of the PyTorch/CUDA port: declare and run a microcircuit
experiment, the counterpart of ``examples/quickstart.py``.

    PYTHONPATH=src python examples/quickstart_torch.py               # card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu  # CPU
"""
import argparse

from repro_torch.api import Experiment
from repro_torch.configs.microcircuit import MicrocircuitConfig

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", default=None,
                help="'cpu' runs the kernels' plain PyTorch versions; the "
                     "default is the CUDA card")
args = ap.parse_args()

# 5 % of the full network (77k neurons / 300M synapses at scale 1.0),
# with van-Albada DC compensation so firing rates stay realistic.
exp = Experiment(
    model=MicrocircuitConfig(scale=0.05,        # n & k scaling in one knob
                             seed=55,
                             strategy="event",  # delivery: event|dense|ell
                             t_presim=100.0),   # discarded transient
    stimulus=("poisson_background",),           # the paper's default drive
    probes=("pop_counts",),
    duration_ms=500.0,                          # 0.5 s of model time
    validate=True,                              # judge against the bands
    name="quickstart")

result = exp.run(device=args.device, warmup=True)   # -> ExperimentResult
res = result.trials[0]
c = result.connectome
print(f"network: {c.n_total} neurons, {c.n_synapses} synapses, on "
      f"{res.device}")

summary = res.summary()
print(f"RTF = {res.rtf:.3f} (wall {res.wall_s:.3f} s; the graphs captured "
      f"before the timed run)")
print("population rates (Hz):")
for pop, rate, target in zip(
        ("L23E", "L4E", "L5E", "L6E", "L23I", "L4I", "L5I", "L6I"),
        summary["rates_hz"], summary["target_rates_hz"]):
    print(f"  {pop:5s} {rate:6.2f}  (full-scale reference {target:.2f})")
print(f"spike-budget overflows: {res.overflow} (must be 0)")
print(result.report.table())

# the same experiment serializes to a scenario file that either package
# runs verbatim:
#   exp.to_json("my_scenario.json")
#   PYTHONPATH=src python -m repro_torch.api my_scenario.json
