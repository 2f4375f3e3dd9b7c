"""RL003 fixture: a registered plugin drifting from its protocol.

Defines a minimal local ``DeliveryStrategy`` (RL003 resolves protocol
bases by simple name, so fixtures carry their own) and a registered
subclass with a renamed positional parameter and a missing required
method.  The ``StreamProbe`` stub exercises the construction checks: the
port's ``init`` takes the device.  One finding per ``RL003`` marker line.
"""


def register(cls):
    return cls


class DeliveryStrategy:
    def prepare(self, c, cfg, device):
        raise NotImplementedError           # required (bare raise)

    def deliver(self, ring, tables, spiked, t, n_exc, cfg):
        raise NotImplementedError           # required (bare raise)

    def localize(self, c, n_dev, device="cpu"):
        raise NotImplementedError("optional capability: no shard form")


@register
class BadDelivery(DeliveryStrategy):        # RL003: required deliver missing
    def prepare(self, c, config, device):   # RL003: positional-name mismatch
        return config

    def localize(self, c, n_dev, device="cpu"):   # optional override: fine
        return c


class StreamProbe:
    """Local stand-in; RL003 matches constructions by simple name."""

    def __init__(self, **kw):
        self.kw = kw


def bad_update(carry):                      # RL003: update takes 2 args
    return carry


def good_init(device):
    return device


def make_probe():
    return StreamProbe(name="x", init=lambda: 0, update=bad_update,  # RL003: init takes the device
                       needs="weird")       # RL003: bad needs value


def make_good_probe():
    return StreamProbe(name="y", init=good_init,
                       update=lambda carry, x: carry, needs="spiked")
