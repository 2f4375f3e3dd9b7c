"""loop.enqueue_us_per_chunk: host microseconds a chunk in the port's
``loop.load``, ``loop.replay``, ``loop.epilogue`` and ``loop.outputs``
spans (``_run_graphed``: residency and carries in, the graph launches, the
eager epilogue, state and outputs out), over a pass of the mix recorded
with no profiler (``perfbench/program.py``)."""
from perfbench import program

SPANS = ("loop.load", "loop.replay", "loop.epilogue", "loop.outputs")


def read(record):
    p = program.of(record)
    if p is None or not any(s in p["per_unit_s"] for s in SPANS):
        return None
    return 1e6 * sum(p["per_unit_s"].get(s, 0.0) for s in SPANS)
