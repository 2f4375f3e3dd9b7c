"""step.probe_us: device microseconds a step of the kernels launched under
the port's ``step.probe`` span (``pop_counts``), from the step census of
``perfbench/program.py``."""
from perfbench import program


def read(record):
    p = program.of(record)
    return None if p is None else p["census"]["us_per_step"].get(
        "step.probe")
