"""device.idle_share.loop: the share of a closed-loop chunk in which no
device operation runs, in %: one less the device's busy time a chunk in
the traced sub-window over a chunk's mean wall time in the measured
window.  (The trace's own window is not the base: tracing the device
slows each graph launch on the host several times over.)"""


def read(record):
    p, w = record.get("profile"), record["window"]
    if not p or not p["busy_s"] or not p["units"] or not w["unit_walls_s"]:
        return None
    wall = sum(w["unit_walls_s"]) / len(w["unit_walls_s"])
    return 100.0 * (1.0 - p["busy_s"] / p["units"] / wall)
