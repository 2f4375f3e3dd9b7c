"""stdp_update_roofline: the potentiation-and-clip kernel's least time a
call in % of its profiled device time a call."""
from perfbench import roofline as R


def read(record):
    p = record.get("profile")
    k = p and p["hand"].get("stdp_update")
    if not k or not k["calls"]:
        return None
    net = record["net"]
    w = R.spike_work(p["counts_per_step"], net)
    least = R.bound_s(R.stdp_bytes(w, net["budget"]), R.stdp_ops(w))
    return R.share(least, k["us"] * 1e-6 / k["calls"])
