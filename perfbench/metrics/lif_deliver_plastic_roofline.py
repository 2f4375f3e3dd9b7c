"""lif_deliver_plastic_roofline: K4's least time a call in % of its
profiled device time a call."""
from perfbench import roofline as R


def read(record):
    p = record.get("profile")
    k = p and p["hand"].get("K4")
    if not k or not k["calls"]:
        return None
    net, n = record["net"], record["net"]["n"]
    w = R.spike_work(p["counts_per_step"], net)
    least = R.bound_s(R.k4_bytes(n, net["budget"], w), R.k4_ops(n, w))
    return R.share(least, k["us"] * 1e-6 / k["calls"])
