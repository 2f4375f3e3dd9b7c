"""step.drive_us: device microseconds a step of the kernels launched under
the port's ``step.drive`` span (the Poisson draw, its casts, the ``w_ext``
product), from the step census of ``perfbench/program.py``: eager steady
steps under the profiler, each kernel under its innermost step span."""
from perfbench import program


def read(record):
    p = program.of(record)
    return None if p is None else p["census"]["us_per_step"].get(
        "step.drive")
