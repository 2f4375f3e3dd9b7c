"""device.idle_share: the share of the traced window in which no device
operation ran, in %."""


def read(record):
    p = record.get("profile")
    if not p or not p["busy_s"] or not p["window_s"]:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
