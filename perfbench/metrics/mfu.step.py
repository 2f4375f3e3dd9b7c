"""mfu.step: the whole step's least time on the card (its bytes over the
memory rate or its float32 operations over their rate, whichever is
larger), in % of the measured window's wall time a step.  The work is
counted from the window's own spikes, whichever kernels do it."""
from perfbench import roofline as R


def read(record):
    w, net = record["window"], record["net"]
    p = record.get("profile")
    if not p or not p["busy_s"] or not w["steps"]:
        return None
    n, budget = net["n"], net["budget"]
    s = R.spike_work(w["counts_per_step"], net)
    if net["plastic"]:
        b = R.k4_bytes(n, budget, s) + R.stdp_bytes(s, budget)
        ops = R.k4_ops(n, s) + R.stdp_ops(s)
    else:
        b, ops = R.k3_bytes(n, budget, s["out"]), R.k3_ops(n, s["out"])
    least = R.bound_s(b + R.drive_probe_bytes(n), ops)
    return R.share(least, w["window_s"] / w["steps"])
