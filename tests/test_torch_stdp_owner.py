"""The owner rule of ``stdp_update``, on the CPU against eager JAX.

The kernel gives every entry the STDP step touches one owner, so that a
step needs no grid barrier: the IN pass owns the plastic IN entries of the
step's ids (a synapse whose target is among the ids), the OUT pass the
plastic OUT entries of the ids' rows whose target is not among them.  The
plain version (``stdp.stdp_update_plain``) is written in that order.

Here, at scale 0.02 and budget 128, with a spike vector that holds both a
plastic OUT entry whose target is a delivered spike and one whose target
spiked but was dropped by the budget:

* the rule as stated in terms of the spike vector (``owner_in_pass``)
  equals the kernel's binary search over the ids (``stdp.among_ids``);
* the OUT pass's and the IN pass's clip sets are disjoint, and their union
  is the touched set of ``stdp_step`` (the plastic entries of the ids' OUT
  rows and IN rows);
* the plain version in that order equals ``JP.stdp_step`` and
  ``JP.stdp_pot_clip`` bit for bit, with and without the depression and
  the whole-table clip, from weights raised above w_max on the entries
  where the two passes meet.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import plasticity as JP
from repro_torch import convert
from repro_torch.core import plasticity as PL
from repro_torch.kernels import stdp as KS
from repro_torch.kernels.ell_deliver import compact_ids_plain
from test_torch_plasticity import (BUDGET, CPU, _assert_plastic_equal,
                                   _jax_plastic_arrays, net)  # noqa: F401


@pytest.fixture(autouse=True)
def _flush_subnormals_like_xla():
    assert torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)


def owner_in_pass(t: np.ndarray, spiked: np.ndarray, ids: np.ndarray,
                  budget: int) -> np.ndarray:
    """Whether the IN pass owns an entry whose target is ``t``: the target
    is among the step's ids, the lowest ``budget`` spikes ascending, i.e.
    it spiked and was not cut by the budget."""
    n = spiked.shape[0]
    n_real = int((ids < n).sum())
    t = np.minimum(t, n - 1)                 # padding's target N
    return spiked[t] & ((n_real < budget) | (t <= ids[budget - 1]))


def _spikes(net, n_spikes, seed):
    """``n_spikes`` excitatory spikes (so that their rows hold plastic
    entries); with more than the budget, the highest ids are dropped."""
    rng = np.random.default_rng(seed)
    spiked = np.zeros(net["c"].n_total, bool)
    spiked[rng.choice(net["c"].n_exc, n_spikes, replace=False)] = True
    ids, _ = compact_ids_plain(torch.from_numpy(spiked), BUDGET)
    return spiked, ids.numpy()


def _sets(net, spiked, ids):
    """The (row, column) entries of the OUT pass, the IN pass, and the
    touched set as ``stdp_step`` reaches it; the delivered-target and the
    dropped-target OUT entries."""
    n = net["c"].n_total
    ptab = net["ptab"]
    k = ptab.out_targets.shape[1]
    real = ids[ids < n]
    pm_out = ptab.plastic_out.numpy()[real]
    tg = ptab.out_targets.numpy()[real]
    rows = np.broadcast_to(real[:, None], tg.shape)
    cols = np.broadcast_to(np.arange(k), tg.shape)
    owned_in = owner_in_pass(tg, spiked, ids, BUDGET)
    out_all = set(zip(rows[pm_out], cols[pm_out]))
    out_pass = set(zip(rows[pm_out & ~owned_in], cols[pm_out & ~owned_in]))
    syn = ptab.in_syn_idx.numpy()[real][ptab.plastic_in.numpy()[real]]
    in_pass = set(zip(syn // k, syn % k))
    delivered = set(zip(rows[pm_out & owned_in], cols[pm_out & owned_in]))
    dropped_t = pm_out & spiked[np.minimum(tg, n - 1)] & ~owned_in
    dropped = set(zip(rows[dropped_t], cols[dropped_t]))
    return out_pass, in_pass, out_all | in_pass, delivered, dropped


@pytest.mark.parametrize("n_spikes", [0, 31, BUDGET, 200])
def test_owner_rule_is_among_ids(net, n_spikes):
    spiked, ids = _spikes(net, n_spikes, seed=n_spikes)
    n = spiked.shape[0]
    every = np.arange(n + 1)
    want = owner_in_pass(every, spiked, ids, BUDGET) & (every < n)
    got = KS.among_ids(torch.from_numpy(every), torch.from_numpy(ids), n)
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(want.sum()) == min(n_spikes, BUDGET)


def test_owner_sets_split_the_touched_set(net):
    spiked, ids = _spikes(net, 200, seed=5)
    out_pass, in_pass, touched, delivered, dropped = _sets(net, spiked, ids)
    assert delivered and dropped              # the case this test is for
    assert out_pass | in_pass == touched
    assert not out_pass & in_pass
    assert delivered <= in_pass and dropped <= out_pass


def _states(net, spiked, ids, raise_at, seed):
    """JAX and port plastic states alike: the connectome's weights with the
    (row, column) entries ``raise_at`` set above w_max, random traces."""
    c, rng = net["c"], np.random.default_rng(seed)
    k_out = net["k_out"]
    w = np.asarray(net["jps0"].weights).copy()
    rows, cols = (np.array(v, np.int64) for v in zip(*raise_at))
    assert (cols < k_out).all()               # real entries, in both layouts
    w[rows * k_out + cols] = np.float32(1.5 * net["coef"].w_max)
    x_pre = rng.uniform(0.0, 3.0, c.n_total).astype(np.float32)
    x_post = rng.uniform(0.0, 3.0, c.n_total).astype(np.float32)
    jps = JP.PlasticState(jnp.asarray(w), jnp.asarray(x_pre),
                          jnp.asarray(x_post))
    _, ps = convert.plastic_to_torch(
        _jax_plastic_arrays(net["jtables"], jps),
        net["tables"].weights.shape[1], CPU)
    return jps, ps


@pytest.mark.parametrize("clip_all", [False, True], ids=["touched", "all"])
@pytest.mark.parametrize("full", [False, True], ids=["pot_clip", "step"])
def test_owner_order_bitwise_vs_jax(net, full, clip_all):
    spiked, ids = _spikes(net, 200, seed=5)
    out_pass, in_pass, touched, delivered, dropped = _sets(net, spiked, ids)
    rng = np.random.default_rng(9)
    pick = lambda s, m: [tuple(e) for e in rng.permutation(sorted(s))[:m]]
    dropped_raised = pick(dropped, 8)
    raise_at = pick(delivered, 8) + dropped_raised + pick(in_pass, 8)
    if clip_all:                   # and untouched plastic entries elsewhere
        plastic = np.argwhere(net["ptab"].plastic_out.numpy())
        raise_at += pick({tuple(e) for e in plastic} - touched, 40)
    jps, ps = _states(net, spiked, ids, raise_at, seed=11)
    w0 = ps.weights.clone()
    jt, jcfg = net["jtables"], net["jstdp"]
    ids_t = torch.from_numpy(ids)
    if full:
        want = JP.stdp_step(jps, jt, jnp.asarray(spiked), jcfg, BUDGET,
                            net["c"].n_exc)
        got = PL.stdp_step(ps, net["ptab"], torch.from_numpy(spiked), ids_t,
                           net["coef"], clip_all=clip_all, kernel=False)
    else:
        want = jps._replace(weights=JP.stdp_pot_clip(
            jps.weights, jps.x_pre, jnp.asarray(ids), jt, jcfg,
            JP._padded_clip_mask(jt, jps.weights.shape[0])))
        got = ps._replace(weights=PL.stdp_pot_clip(
            ps.weights, ps.x_pre, ids_t, net["ptab"], net["coef"],
            clip_all=clip_all, kernel=False))
    _assert_plastic_equal(net, got, want)
    # the dropped-target entries were clipped from above w_max (their
    # target was not potentiated, but the OUT pass clipped them)
    w_max = np.float32(net["coef"].w_max)
    for r, col in dropped_raised:
        assert float(got.weights[r, col]) == w_max
    assert not torch.equal(got.weights, w0)
