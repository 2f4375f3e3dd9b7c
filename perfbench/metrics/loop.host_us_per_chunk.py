"""loop.host_us_per_chunk: a chunk's mean wall time in the measured
window less the device's busy time a chunk in the traced sub-window (the
host's share of a closed-loop chunk), in microseconds."""


def read(record):
    p, w = record.get("profile"), record["window"]
    if not p or not p["busy_s"] or not p["units"] or not w["unit_walls_s"]:
        return None
    wall = sum(w["unit_walls_s"]) / len(w["unit_walls_s"])
    return 1e6 * (wall - p["busy_s"] / p["units"])
