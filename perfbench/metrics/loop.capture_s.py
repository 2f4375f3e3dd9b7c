"""loop.capture_s: the harness's span around ``Simulator.warmup`` of the
mix's unit and the presim (the fused backend's CUDA graphs captured)."""


def read(record):
    return record["spans"].get("loop.capture_s")
