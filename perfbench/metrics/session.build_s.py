"""session.build_s: the harness's span around ``Simulator(config,
connectome=...)``, the network in hand (the port's tables on the device
and, with plasticity, its plastic tables)."""


def read(record):
    return record["spans"].get("session.build_s")
