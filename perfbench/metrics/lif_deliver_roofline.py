"""lif_deliver_roofline: K3's least time a call (its bytes and operations
for the traced steps' spikes) in % of its profiled device time a call."""
from perfbench import roofline as R


def read(record):
    p = record.get("profile")
    k = p and p["hand"].get("K3")
    if not k or not k["calls"]:
        return None
    net, n = record["net"], record["net"]["n"]
    w = R.spike_work(p["counts_per_step"], net)
    least = R.bound_s(R.k3_bytes(n, net["budget"], w["out"]),
                      R.k3_ops(n, w["out"]))
    return R.share(least, k["us"] * 1e-6 / k["calls"])
