"""step.small_ops_us: device microseconds a step in operations that are
not the port's hand kernels (the draw and its casts, ``pop_counts``, the
counters, the copies)."""
from perfbench.roofline import kernel_form


def read(record):
    p = record.get("profile")
    if not p or not p["steps"] or not p["busy_s"]:
        return None
    us = sum(k["us"] for name, k in p["kernels"].items()
             if kernel_form(name) is None)
    return us / p["steps"]
