"""``perfbench/netgen.py`` draws PD-2014's network: the synapse counts of
the frozen tables, the signs and delays of its rules, and a connectome the
port's ``Simulator`` runs."""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from perfbench import netgen  # noqa: E402
from perfbench.reference import pd14  # noqa: E402

SCALE = 0.02


@pytest.fixture(scope="module")
def drawn():
    torch.set_num_threads(1)
    net = netgen.draw(SCALE, 2 ** 40 + 17, "cpu")
    return net, netgen.connectome(net)


def _synapses(c):
    rows = np.repeat(np.arange(c.n_total), c.targets.shape[1])
    tg = c.targets.reshape(-1)
    real = tg < c.n_total
    return rows[real], tg[real], c.weights.reshape(-1)[real], \
        c.dbins.reshape(-1)[real]


def test_projection_counts_are_the_tables(drawn):
    _, c = drawn
    src, tgt, _, _ = _synapses(c)
    k = np.zeros((8, 8), dtype=np.int64)
    np.add.at(k, (c.pop_of[tgt], c.pop_of[src]), 1)
    want = pd14.synapse_numbers(pd14.scaled_counts(SCALE), SCALE)
    np.testing.assert_array_equal(k, want)
    assert c.n_synapses == int(want.sum())
    np.testing.assert_array_equal(c.pop_sizes, pd14.scaled_counts(SCALE))


def test_signs_and_delays(drawn):
    _, c = drawn
    src, _, w, db = _synapses(c)
    exc = src < c.n_exc
    assert (w[exc] >= 0).all() and (w[~exc] <= 0).all()
    assert c.d_max_bins == 46
    assert db.min() >= 1 and db.max() <= c.d_max_bins - 1
    pad = c.targets == c.n_total
    assert (c.weights[pad] == 0).all() and (c.dbins[pad] == 1).all()
    np.testing.assert_array_equal((~pad).sum(axis=1), c.out_degree)


def test_l4e_to_l23e_doubled(drawn):
    _, c = drawn
    src, tgt, w, _ = _synapses(c)
    pops = pd14.POPULATIONS
    l4e = c.pop_of[src] == pops.index("L4E")
    to_l23e = c.pop_of[tgt] == pops.index("L23E")
    to_l4e = c.pop_of[tgt] == pops.index("L4E")
    ratio = w[l4e & to_l23e].mean() / w[l4e & to_l4e].mean()
    assert 1.9 < ratio < 2.1


def test_same_seed_same_network():
    a = netgen.draw(SCALE, 5, "cpu")
    b = netgen.draw(SCALE, 5, "cpu")
    assert torch.equal(a.targets, b.targets)
    assert torch.equal(a.weights, b.weights)
    assert not torch.equal(a.targets, netgen.draw(SCALE, 6, "cpu").targets)


def test_the_port_runs_it(drawn):
    from repro_torch.api import Simulator
    from repro_torch.configs.microcircuit import MicrocircuitConfig
    _, c = drawn
    sim = Simulator(MicrocircuitConfig(scale=SCALE, strategy="ell",
                                       t_presim=0.0),
                    connectome=c, device="cpu", key=3)
    res = sim.run(10.0)
    assert res.n_steps == 100 and res.overflow == 0
    assert res.data["pop_counts"].sum() > 0
