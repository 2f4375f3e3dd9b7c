"""Spike vectors and population layouts for the ``pop_counts`` probe's
tests: the plain version against the JAX package's ``segment_sum`` on the
CPU (``test_torch_probes.py``) and the card's kernel against the plain
version (``test_torch_pop_counts_card.py``), on the same cases.  Imports
neither JAX nor a card.

A case is ``(pop_of, spiked, n_pops, offset)``: the sorted ``[L]`` int32
population index (a padded registry's tail in the sentinel population
``n_pops``, as the sharded backend lays it out), the ``[L]`` bool spikes,
and the byte offset at which the card's test places the vector in a larger
buffer, so that the bounds fall off 16-byte alignment.
"""
import numpy as np

from repro_torch.core import params as P

#: PD14's full-scale population sizes, in the port's order
PD14_SIZES = [P.N_FULL[p] for p in P.POPULATIONS]
#: the sharded registry's padding past N, all spiking
PAD = 45


def _layout(sizes, pad: int = 0) -> np.ndarray:
    n_pops = len(sizes)
    return np.concatenate([np.repeat(np.arange(n_pops, dtype=np.int32),
                                     sizes),
                           np.full(pad, n_pops, np.int32)])


def case(name: str, seed: int = 0):
    """The case ``name`` of :data:`CASES`, drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    if name.startswith("pd14_density_"):
        sizes, density = PD14_SIZES, float(name.rsplit("_", 1)[1])
    else:
        sizes, density = {
            "empty_population": [0, 40, 0, 129, 0, 3, 77, 0],
            "single_population": [1000],
            "unaligned": [17, 33, 5, 1, 249, 3, 7, 11],
            "padded_tail": PD14_SIZES,
        }[name], 0.5
    pad = PAD if name == "padded_tail" else 0
    pop_of = _layout(sizes, pad)
    spiked = rng.random(pop_of.size) < density
    spiked[pop_of.size - pad:] = True
    offset = 1 if name == "unaligned" else 0
    return pop_of, spiked, len(sizes), offset


CASES = ("pd14_density_0", "pd14_density_0.02", "pd14_density_0.5",
         "pd14_density_1", "empty_population", "single_population",
         "unaligned", "padded_tail")
