"""session.readback_us_per_chunk: host microseconds a chunk in the port's
``session.readback`` span (the overflow's read, the probes' and stream
carries' read-backs, the ``RunResult``), over a pass of the mix recorded
with no profiler (``perfbench/program.py``)."""
from perfbench import program


def read(record):
    p = program.of(record)
    if p is None or "session.readback" not in p["per_unit_s"]:
        return None
    return 1e6 * p["per_unit_s"]["session.readback"]
