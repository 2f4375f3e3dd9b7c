"""K2: the port's spike delivery against the JAX package's.

Scale-0.02 microcircuit tables, spike vectors made with numpy from a seed,
at zero spikes, exactly ``budget`` spikes and an overflowing budget.

* ``event`` and the ``ell`` strategy's kernel path (on CPU tensors: the
  plain version) against JAX's eager ``deliver_event`` on a non-zero ring:
  ring and overflow **bitwise** (both add the gathered rows into the ring
  one entry after the other, s-major and k-minor).
* The same against JAX ``ops.ell_deliver(interpret=True)`` on a zero
  ring, **bitwise**.  The Pallas kernel sums the step's update from zero
  and then adds it onto the ring, so on a non-zero ring two arrivals in
  one cell round differently from ``deliver_event`` -- in the JAX package
  too; from a zero ring the two orders agree.
* The compacted ids (lowest ``budget`` spiking ids ascending, then the
  sentinel N) exactly, since they decide which spikes an overflow drops.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import delivery as jdlv
from repro.core.connectivity import build_connectome as jax_build
from repro.core.engine import SimConfig as JaxSimConfig
from repro.kernels import ops as jops
from repro_torch.core import delivery as tdlv
from repro_torch.core.connectivity import build_connectome as port_build
from repro_torch.core.engine import SimConfig, resolve_sim_config
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ell_deliver import compact_ids_plain, ell_deliver

BUDGET = 128
T_STEP = 1234


@pytest.fixture(scope="module")
def nets():
    c_jax, c_port = jax_build(scale=0.02, seed=55), port_build(scale=0.02,
                                                               seed=55)
    out = {}
    for strategy in ("event", "ell"):
        jt = jdlv.get_strategy(strategy).prepare(
            c_jax, JaxSimConfig(strategy=strategy))
        pt = tdlv.get_strategy(strategy).prepare(
            c_port, SimConfig(strategy=strategy), torch.device("cpu"))
        out[strategy] = (jt, pt)
    return c_port, out


def _spiked(n, k, seed):
    s = np.zeros(n, bool)
    s[np.random.default_rng(seed).choice(n, size=k, replace=False)] = True
    return s


def _ring(c, seed, zero):
    shape = (c.d_max_bins, 2, c.n_total + 1)
    if zero:
        return np.zeros(shape, np.float32)
    rng = np.random.default_rng(seed)
    r = np.zeros(shape, np.float32)
    r[:, 0] = rng.uniform(0, 50, shape[::2])
    r[:, 1] = -rng.uniform(0, 50, shape[::2])
    return r


COUNTS = {"zero": 0, "one": 1, "budget_exact": BUDGET,
          "budget_overflow": BUDGET + 22, "many": 700}


def _port_deliver(c, pt, strategy, ring, spiked, budget):
    cfg = resolve_sim_config(
        SimConfig(strategy=strategy, spike_budget=budget, kernels="split"),
        c, torch.device("cpu"))
    r = torch.from_numpy(ring.copy())
    out, ovf = tdlv.get_strategy(strategy).deliver(
        r, pt, torch.from_numpy(spiked), T_STEP, c.n_exc, cfg)
    assert out is r                    # updated in place
    return out.numpy(), int(ovf)


@pytest.mark.parametrize("strategy", ["event", "ell"])
@pytest.mark.parametrize("case", list(COUNTS))
def test_deliver_bitwise_vs_jax_deliver_event(nets, strategy, case):
    c, tabs = nets
    jt, pt = tabs[strategy]
    spiked = _spiked(c.n_total, COUNTS[case], seed=len(case))
    ring = _ring(c, seed=11, zero=False)
    want_ring, want_ovf = jdlv.deliver_event(
        jnp.asarray(ring), jt, jnp.asarray(spiked), jnp.int32(T_STEP),
        c.n_exc, BUDGET)
    got_ring, got_ovf = _port_deliver(c, pt, strategy, ring, spiked, BUDGET)
    np.testing.assert_array_equal(got_ring, np.asarray(want_ring))
    assert got_ovf == int(want_ovf) == max(COUNTS[case] - BUDGET, 0)


@pytest.mark.parametrize("strategy", ["event", "ell"])
@pytest.mark.parametrize("case", list(COUNTS))
def test_deliver_ids_are_jax_nonzero(nets, strategy, case):
    """``deliver_ids`` returns the ids the plastic path hands to the STDP
    update: JAX's ``nonzero(size=budget, fill_value=N)``, beside the same
    ring and overflow as ``deliver``."""
    c, tabs = nets
    _, pt = tabs[strategy]
    spiked = _spiked(c.n_total, COUNTS[case], seed=len(case))
    ring = _ring(c, seed=11, zero=False)
    cfg = resolve_sim_config(
        SimConfig(strategy=strategy, spike_budget=BUDGET, kernels="split"),
        c, torch.device("cpu"))
    r = torch.from_numpy(ring.copy())
    out, ids, ovf = tdlv.get_strategy(strategy).deliver_ids(
        r, pt, torch.from_numpy(spiked), T_STEP, c.n_exc, cfg)
    (want_ids,) = jnp.nonzero(jnp.asarray(spiked), size=BUDGET,
                              fill_value=c.n_total)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids))
    got_ring, got_ovf = _port_deliver(c, pt, strategy, ring, spiked, BUDGET)
    np.testing.assert_array_equal(out.numpy(), got_ring)
    assert int(ovf) == got_ovf


def test_live_tables_rewrap_and_gate(nets):
    """``live_tables`` swaps the weights in without a copy, and a strategy
    without a live-weight path refuses."""
    _, tabs = nets
    _, pt = tabs["ell"]
    w = pt.weights.clone()
    for name in ("event", "ell"):
        live = tdlv.get_strategy(name).live_tables(pt, w)
        assert live.weights is w and live.targets is pt.targets

    class _Static(tdlv.DeliveryStrategy):
        name = "static"
    with pytest.raises(NotImplementedError, match="live-weight"):
        _Static().live_tables(pt, w)


@pytest.mark.parametrize("case", list(COUNTS))
def test_ell_bitwise_vs_pallas_interpret(nets, case):
    c, tabs = nets
    jt, pt = tabs["ell"]
    spiked = _spiked(c.n_total, COUNTS[case], seed=len(case))
    ring = _ring(c, seed=0, zero=True)
    want_ring, want_ovf = jops.ell_deliver(
        jnp.asarray(ring), jt, jnp.asarray(spiked), jnp.int32(T_STEP),
        c.n_exc, BUDGET, interpret=True)
    got_ring, got_ovf = _port_deliver(c, pt, "ell", ring, spiked, BUDGET)
    np.testing.assert_array_equal(got_ring, np.asarray(want_ring))
    assert got_ovf == int(want_ovf)
    # the ops-level wrapper, with the reference's signature, agrees too
    r = torch.from_numpy(ring.copy())
    r2, ovf2 = kops.ell_deliver(r, pt, torch.from_numpy(spiked), T_STEP,
                                c.n_exc, BUDGET)
    np.testing.assert_array_equal(r2.numpy(), got_ring)
    assert int(ovf2) == got_ovf


@pytest.mark.parametrize("n,k,budget", [(1544, 0, 128), (1544, 128, 128),
                                        (1544, 150, 128), (10, 10, 16),
                                        (1, 1, 1), (5000, 4999, 256)])
def test_compaction_keeps_lowest_ids(n, k, budget):
    spiked = _spiked(n, k, seed=n + k)
    ids, ovf = compact_ids_plain(torch.from_numpy(spiked), budget)
    want = np.full(budget, n, np.int32)
    hits = np.flatnonzero(spiked)[:budget]
    want[:hits.size] = hits
    np.testing.assert_array_equal(ids.numpy(), want)
    assert ids.dtype == torch.int32 and ovf.dtype == torch.int32
    assert int(ovf) == max(k - budget, 0)


def test_ell_wrapper_returns_ids_and_counts_no_launch(nets):
    from repro_torch.kernels import _build
    c, tabs = nets
    _, pt = tabs["ell"]
    spiked = _spiked(c.n_total, BUDGET + 5, seed=3)
    before = dict(_build.launches)
    _, ids, ovf = ell_deliver(torch.from_numpy(_ring(c, 0, True)),
                              pt.targets, pt.weights, pt.dbins,
                              torch.from_numpy(spiked), T_STEP, c.n_exc,
                              BUDGET)
    np.testing.assert_array_equal(ids.numpy(),
                                  np.flatnonzero(spiked)[:BUDGET])
    assert int(ovf) == 5
    assert _build.launches == before
