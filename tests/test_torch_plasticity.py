"""The plastic slice: pair STDP in the port against the JAX package.

Inputs are made with numpy from a seed at scale 0.02 (0.05 where the JAX
package's own test uses it) and handed to both packages; the port's
functions run on CPU tensors, where every kernel wrapper runs its plain
version (the kernels themselves are held to those on the card by
``chip_smoke.py``).  The JAX side is **eager** (jitted JAX contracts
multiply-adds into FMAs on the CPU).

Tolerance: none, except ``mean_plastic_weight`` (rtol 1e-6: the two
packages sum the weights in another order).  The port's layout differs
from the reference's on purpose: its plastic weights are the delivery
strategy's ``[N+1, K]`` table and its IN view indexes that table, so the
comparisons go through ``repro_torch.convert.plastic_to_numpy``.
"""
import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api.probes import ProbeContext as JaxProbeContext
from repro.api.probes import mean_plastic_weight as jax_mean_probe
from repro.api.simulator import Simulator as JaxSimulator
from repro.configs.microcircuit import MicrocircuitConfig as JaxConfig
from repro.core import delivery as jax_dlv
from repro.core import plasticity as JP
from repro.core.connectivity import build_connectome as jax_build
from repro.core.engine import SimConfig as JaxSimConfig
from repro.core.engine import SimState as JaxSimState
from repro.core.engine import prepare_network as jax_prepare_network
from repro.core.engine import resolve_sim_config as jax_resolve
from repro.core.engine import update_phase as jax_update_phase
from repro.core.neuron import NeuronParams as JaxNeuronParams
from repro.core.neuron import NeuronState as JaxNeuronState
from repro.core.neuron import Propagators as JaxPropagators
from repro_torch import convert
from repro_torch.api import Simulator
from repro_torch.configs.microcircuit import MicrocircuitConfig
from repro_torch.core import plasticity as PL
from repro_torch.core import stimulus as tstim
from repro_torch.core.connectivity import build_connectome as port_build
from repro_torch.core.delivery import REGISTRY as STRATEGIES
from repro_torch.core.engine import SimConfig
from repro_torch.core.neuron import NeuronState, Propagators
from repro_torch.core.params import NeuronParams
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ell_deliver import compact_ids_plain
from repro_torch.kernels.lif_deliver import lif_deliver_plastic
from repro_torch.kernels.stdp import clip_plain
from test_torch_fused_step import EDGE_CASES, edge_spikes

SCALE, SEED, BUDGET, DT = 0.02, 55, 128, 0.1
CPU = torch.device("cpu")
SPIKE_CASES = {"zero": 0, "some": 31, "budget": BUDGET,
               "overflow": BUDGET + 40}


def _step(ps, ptab, spiked, coef, budget, **kw):
    """The port's ``stdp_step`` on ``spiked``, its ids compacted as the
    step's delivery compacts them."""
    spiked = torch.from_numpy(spiked)
    return PL.stdp_step(ps, ptab, spiked, compact_ids_plain(spiked, budget)[0],
                        coef, **kw)


@pytest.fixture(autouse=True)
def _flush_subnormals_like_xla():
    assert torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)


@pytest.fixture(scope="module")
def net():
    """Both packages' connectome, ``ell`` tables and plastic tables."""
    c_jax = jax_build(scale=SCALE, seed=SEED)
    c = port_build(scale=SCALE, seed=SEED)
    jcfg = jax_resolve(JaxSimConfig(strategy="ell", spike_budget=BUDGET,
                                    kernels="reference"), c_jax)
    jtables, jps0 = JP.build_plastic_tables(c_jax)
    tables = STRATEGIES["ell"].prepare(c, None, CPU)
    ptab = PL.build_plastic_tables(tables, c.n_exc)
    jstdp = JP.STDPConfig(w_ref=float(c_jax.w_ext), dt=DT)
    coef = PL.stdp_coefficients(PL.STDPConfig(w_ref=float(c.w_ext), dt=DT))
    return dict(c_jax=c_jax, c=c, jcfg=jcfg, jnet=jax_prepare_network(
        c_jax, jcfg), jtables=jtables, jps0=jps0, tables=tables, ptab=ptab,
        jstdp=jstdp, coef=coef, k_out=c.targets.shape[1])


def _jax_plastic_arrays(tables, ps):
    return {"weights": np.asarray(ps.weights),
            "x_pre": np.asarray(ps.x_pre), "x_post": np.asarray(ps.x_post),
            **{name: np.asarray(getattr(tables, name)) for name in (
                "out_targets", "out_dbins", "in_syn_idx", "plastic_out",
                "plastic_in")}}


def _random_plastic(net, seed, n_spikes, n_above=40, spiked=None):
    """JAX and port plastic states alike: the connectome's weights with
    ``n_above`` plastic weights raised above w_max, random traces, and a
    spike vector with ``n_spikes`` spikes (or ``spiked`` as given)."""
    c, rng = net["c"], np.random.default_rng(seed)
    n = c.n_total
    w = np.asarray(net["jps0"].weights).copy()
    plastic = np.flatnonzero(np.asarray(net["jtables"].plastic_out)
                             .reshape(-1))
    w_max = net["coef"].w_max
    w[rng.choice(plastic, n_above, replace=False)] = np.float32(1.5 * w_max)
    x_pre = rng.uniform(0.0, 3.0, n).astype(np.float32)
    x_post = rng.uniform(0.0, 3.0, n).astype(np.float32)
    if spiked is None:
        spiked = np.zeros(n, bool)
        spiked[rng.choice(n, size=n_spikes, replace=False)] = True
    jps = JP.PlasticState(jnp.asarray(w), jnp.asarray(x_pre),
                          jnp.asarray(x_post))
    arrays = _jax_plastic_arrays(net["jtables"], jps)
    _, ps = convert.plastic_to_torch(arrays, net["tables"].weights.shape[1],
                                     CPU)
    return jps, ps, spiked


def _assert_plastic_equal(net, ps, jps):
    got = convert.plastic_to_numpy(net["ptab"], ps, net["k_out"])
    for name in ("weights", "x_pre", "x_post"):
        np.testing.assert_array_equal(got[name], np.asarray(
            getattr(jps, name)), err_msg=name)


# ---------------------------------------------------------------------------
# The tables
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("strategy", ["event", "ell"])
def test_plastic_tables_equal_jax(net, strategy):
    """The port's device build (run on the CPU) gives JAX's numpy tables
    after the re-index to the strategy's K columns; the derived
    ``in_sources`` equals JAX's stored one."""
    c, jt = net["c"], net["jtables"]
    tables = STRATEGIES[strategy].prepare(c, None, CPU)
    ptab = PL.build_plastic_tables(tables, c.n_exc)
    k, k_out = tables.targets.shape[1], net["k_out"]
    assert k == (k_out if strategy == "event" else -(-k_out // 128) * 128)
    assert ptab.out_targets is tables.targets      # shared, not copied
    got = convert.plastic_to_numpy(ptab, PL.PlasticState(
        tables.weights, torch.zeros(c.n_total), torch.zeros(c.n_total)),
        k_out)
    for name in ("out_targets", "out_dbins", "in_syn_idx", "plastic_out",
                 "plastic_in"):
        np.testing.assert_array_equal(got[name], np.asarray(
            getattr(jt, name)), err_msg=name)
    np.testing.assert_array_equal(ptab.in_sources.numpy(),
                                  np.asarray(jt.in_sources))
    np.testing.assert_array_equal(got["weights"],
                                  np.asarray(net["jps0"].weights))
    # padded columns are never plastic
    assert not ptab.plastic_out[:, k_out:].any()


def test_plastic_convert_round_trip(net):
    jps, ps, _ = _random_plastic(net, seed=3, n_spikes=0)
    arrays = _jax_plastic_arrays(net["jtables"], jps)
    tables, ps2 = convert.plastic_to_torch(arrays, 256, CPU)
    assert ps2.weights.shape == (net["c"].n_total + 1, 256)
    assert not ps2.weights[:, net["k_out"]:].any()
    back = convert.plastic_to_numpy(tables, ps2, net["k_out"])
    assert set(back) == set(convert.PLASTIC_KEYS)
    for name in convert.PLASTIC_KEYS:
        np.testing.assert_array_equal(back[name], arrays[name],
                                      err_msg=name)
    with pytest.raises(KeyError, match="x_pre"):
        convert.plastic_to_torch(
            {k: v for k, v in arrays.items() if k != "x_pre"}, 256, CPU)


# ---------------------------------------------------------------------------
# The STDP update, bitwise against eager JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", list(SPIKE_CASES))
def test_stdp_step_bitwise_vs_jax(net, case):
    jps, ps, spiked = _random_plastic(net, seed=len(case),
                                      n_spikes=SPIKE_CASES[case])
    want = JP.stdp_step(jps, net["jtables"], jnp.asarray(spiked),
                        net["jstdp"], BUDGET, net["c"].n_exc)
    got = _step(ps, net["ptab"], spiked, net["coef"], BUDGET)
    _assert_plastic_equal(net, got, want)


@pytest.mark.parametrize("case", list(SPIKE_CASES))
def test_stdp_pot_clip_bitwise_vs_jax(net, case):
    jps, ps, spiked = _random_plastic(net, seed=10 + len(case),
                                      n_spikes=SPIKE_CASES[case])
    (ids,) = jnp.nonzero(jnp.asarray(spiked), size=BUDGET,
                         fill_value=net["c"].n_total)
    jt = net["jtables"]
    want = JP.stdp_pot_clip(jps.weights, jps.x_pre, ids, jt, net["jstdp"],
                            JP._padded_clip_mask(jt, jps.weights.shape[0]))
    w = PL.stdp_pot_clip(ps.weights, ps.x_pre, torch.from_numpy(
        np.array(ids)), net["ptab"], net["coef"])
    assert w is ps.weights                         # in place
    _assert_plastic_equal(net, ps, jps._replace(weights=want))


def test_touched_clip_equals_whole_clip(net):
    """From a table with E->E weights above w_max: the port's whole-table
    clip in the first step, then touched entries only, equals JAX's clip
    of the whole table in every step -- and clipping before the first
    step's depression would not (the order matters)."""
    c = net["c"]
    jps, ps, _ = _random_plastic(net, seed=21, n_spikes=0, n_above=400)
    rng = np.random.default_rng(22)
    for step in range(6):
        spiked = np.zeros(c.n_total, bool)
        spiked[rng.choice(c.n_exc, 60, replace=False)] = True
        if step == 0:       # the first spikes touch raised weights
            raised = np.asarray(jps.weights) > net["coef"].w_max
            rows = np.flatnonzero(raised[:-1].reshape(c.n_total + 1, -1)
                                  .any(1))[:20]
            spiked[rows] = True
            # the other order: clip the whole table, then the step
            pre = ps._replace(weights=ps.weights.clone())
            clip_plain(pre.weights, net["ptab"].plastic_out,
                       net["coef"].w_max)
            pre = _step(pre, net["ptab"], spiked, net["coef"], BUDGET)
        jps = JP.stdp_step(jps, net["jtables"], jnp.asarray(spiked),
                           net["jstdp"], BUDGET, c.n_exc)
        ps = _step(ps, net["ptab"], spiked, net["coef"], BUDGET,
                   clip_all=step == 0)
        _assert_plastic_equal(net, ps, jps)
        if step == 0:
            assert not torch.equal(pre.weights, ps.weights)
    assert float(ps.weights[net["ptab"].plastic_out].max()) \
        <= np.float32(net["coef"].w_max)


def test_static_weights_survive_aggressive_clip(net):
    """The JAX package's regression, held in the port: with w_max below the
    static weight scale, only the plastic (E->E) synapses are clipped, and
    the port equals JAX bitwise."""
    c = net["c"]
    jcfg = dataclasses.replace(net["jstdp"], w_max_factor=0.4)
    coef = PL.stdp_coefficients(PL.STDPConfig(w_ref=float(c.w_ext), dt=DT,
                                              w_max_factor=0.4))
    jps, ps, _ = _random_plastic(net, seed=4, n_spikes=0, n_above=0)
    w0 = ps.weights.clone()
    all_exc = np.zeros(c.n_total, bool)
    all_exc[:c.n_exc] = True
    for step in range(5):
        jps = JP.stdp_step(jps, net["jtables"], jnp.asarray(all_exc), jcfg,
                           512, c.n_exc)
        ps = _step(ps, net["ptab"], all_exc, coef, 512, clip_all=step == 0)
    frozen = ~net["ptab"].plastic_out
    assert torch.equal(ps.weights[frozen], w0[frozen])
    assert float(ps.weights[~frozen].max()) <= np.float32(coef.w_max)
    got = convert.plastic_to_numpy(net["ptab"], ps, net["k_out"])
    np.testing.assert_array_equal(got["weights"], np.asarray(jps.weights))


# ---------------------------------------------------------------------------
# K4's plain version, held to JAX's split step
# ---------------------------------------------------------------------------

class _JaxReplay:
    """A JAX ``Drive`` replaying fixed external counts (no PRNG key)."""
    n_keys = 0

    def __init__(self, counts, t0=None):
        self.counts, self.t0 = counts, t0

    def __call__(self, subkeys, t_step, state):
        if self.t0 is None:
            return None, jnp.asarray(self.counts)
        return None, jnp.asarray(self.counts[int(t_step) - self.t0])


@pytest.mark.parametrize("case", list(SPIKE_CASES))
def test_lif_deliver_plastic_bitwise_vs_jax_split(net, case):
    """One call of K4 (plain) then ``stdp_pot_clip`` equals JAX's eager
    ``deliver`` (live weights) + ``stdp_step`` at phase ``t - 1`` and
    ``update_phase`` at ``t``: ring, state, spikes, weights, traces,
    ids and overflow."""
    _assert_k4_equals_jax(net, len(case), *_random_plastic(
        net, seed=200 + len(case), n_spikes=SPIKE_CASES[case]))


@pytest.mark.parametrize("case", EDGE_CASES)
def test_lif_deliver_plastic_compaction_edges_vs_jax_split(net, case):
    """K4 at the compaction's edges (``test_torch_fused_step.edge_spikes``:
    the last neuron, the tiles' first and last neurons, a budget cut in
    the middle of the spiking ids), as above."""
    spiked = edge_spikes(net["c"].n_total, case, BUDGET)
    _assert_k4_equals_jax(net, 7 + len(case), *_random_plastic(
        net, seed=300 + len(case), n_spikes=0, spiked=spiked))


def _assert_k4_equals_jax(net, seed, jps, ps, spiked_prev):
    c, jt = net["c"], net["jtables"]
    n, rng = c.n_total, np.random.default_rng(100 + seed)
    ring = np.zeros((c.d_max_bins, 2, n + 1), np.float32)
    ring[:, 0, :n] = rng.uniform(0, 60, (c.d_max_bins, n))
    ring[:, 1, :n] = -rng.uniform(0, 60, (c.d_max_bins, n))
    x = dict(V=rng.uniform(-75.0, -49.0, n).astype(np.float32),
             I_ex=np.abs(rng.normal(scale=200.0, size=n)).astype(np.float32),
             I_in=-np.abs(rng.normal(scale=200.0, size=n)).astype(
                 np.float32),
             refrac=rng.integers(0, 3, n).astype(np.int32))
    counts = rng.poisson(np.asarray(c.k_ext) * 8e-4).astype(np.int32)
    t = 321

    # JAX, eager: deliver + stdp_step at t - 1, then update at t
    jcfg, jnet = net["jcfg"], net["jnet"]
    st = JaxSimState(JaxNeuronState(*(jnp.asarray(x[k]) for k in (
        "V", "I_ex", "I_in", "refrac"))), jnp.asarray(ring), jnp.int32(t - 1),
        jax.random.PRNGKey(0), jnp.int32(0))
    ell = jax_dlv.get_strategy("ell")
    live = ell.live_tables(jnet.tables, JP.plastic_weight_view(
        jps, n, net["k_out"]))
    jring, jovf = ell.deliver(st.ring, live, jnp.asarray(spiked_prev),
                              st.t, c.n_exc, jcfg)
    st = JaxSimState(st.neuron, jring, st.t + 1, st.key, st.overflow + jovf)
    jps = JP.stdp_step(jps, jt, jnp.asarray(spiked_prev), net["jstdp"],
                       BUDGET, c.n_exc)
    st, jspiked = jax_update_phase(
        st, jnet, JaxPropagators.make(JaxNeuronParams(), DT), jcfg,
        c.w_ext, n, _JaxReplay(counts))

    # the port: K4 (plain on the CPU), then the potentiation and clip
    tb = net["tables"]
    x_pre0 = ps.x_pre
    ext_cnt = torch.from_numpy(counts).to(torch.float32)
    (pring, w, V, I_ex, I_in, refrac, spiked, x_pre, x_post, ids, ovf,
     t_next) = lif_deliver_plastic(
        torch.from_numpy(ring), tb.targets, ps.weights, tb.dbins,
        net["ptab"].plastic_out, torch.from_numpy(spiked_prev),
        *(torch.from_numpy(x[k]) for k in ("V", "I_ex", "I_in", "refrac")),
        ext_cnt, torch.as_tensor(c.i_dc), ps.x_pre, ps.x_post,
        torch.tensor(t, dtype=torch.int32),
        torch.zeros((), dtype=torch.int32), n_exc=c.n_exc, budget=BUDGET,
        prop=Propagators.make(NeuronParams(), DT), w_ext=c.w_ext,
        coef=net["coef"])
    assert int(t_next) == t + 1
    assert w is ps.weights
    PL.stdp_pot_clip(w, x_pre0, ids, net["ptab"], net["coef"])
    for name, a, b in zip(("ring", "V", "I_ex", "I_in", "refrac", "spiked",
                           "overflow"),
                          (pring, V, I_ex, I_in, refrac, spiked, ovf),
                          (st.ring, *st.neuron, jspiked, st.overflow)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                      err_msg=name)
    _assert_plastic_equal(net, PL.PlasticState(w, x_pre, x_post), jps)
    hits = np.flatnonzero(spiked_prev)[:BUDGET]
    np.testing.assert_array_equal(ids.numpy()[:hits.size], hits)
    assert (ids.numpy()[hits.size:] == n).all()


def test_first_rotated_step_keeps_traces(net):
    """``trace=False`` (the rotated loop's first step, which delivers no
    spikes): the traces pass through as they are."""
    c = net["c"]
    _, ps, _ = _random_plastic(net, seed=8, n_spikes=0)
    n = c.n_total
    out = kops.lif_deliver_plastic(
        NeuronState(torch.full((n,), -60.0), torch.zeros(n),
                         torch.zeros(n), torch.zeros(n, dtype=torch.int32)),
        torch.zeros((c.d_max_bins, 2, n + 1)),
        torch.tensor(7, dtype=torch.int32),
        torch.zeros(n, dtype=torch.bool), net["tables"],
        net["ptab"].plastic_out, ps, Propagators.make(NeuronParams(), DT),
        torch.zeros(n), torch.as_tensor(c.i_dc), n_exc=c.n_exc,
        spike_budget=BUDGET, w_ext=c.w_ext,
        overflow=torch.zeros((), dtype=torch.int32), coef=net["coef"],
        trace=False)
    assert out[3].x_pre is ps.x_pre and out[3].x_post is ps.x_post
    assert (out[4] == n).all()


# ---------------------------------------------------------------------------
# The whole slice: the port's plastic Simulator against the eager JAX loop
# ---------------------------------------------------------------------------

PRESIM_MS, RUN_MS = 2.0, 10.0
N_PRESIM, N_RUN = int(PRESIM_MS / DT), int(RUN_MS / DT)


@dataclasses.dataclass(frozen=True, eq=False)
class _Replay(tstim.Stimulus):
    """Port stimulus replaying fixed counts: ``counts[t - t0]`` at step t."""
    counts: torch.Tensor = None
    t0: int = 0

    def compile(self, c, cfg, neuron):
        return tstim.CompiledStimulus(
            channel="spikes",
            fn=lambda gen, t, state: (None, self.counts[t - self.t0]))


def _jax_sim_arrays(net, st):
    return {
        "targets": np.asarray(net.tables.targets),
        "weights": np.asarray(net.tables.weights),
        "dbins": np.asarray(net.tables.dbins),
        "k_ext": np.asarray(net.k_ext), "i_dc": np.asarray(net.i_dc),
        "pop_of": np.asarray(net.pop_of),
        "V": np.asarray(st.neuron.V), "I_ex": np.asarray(st.neuron.I_ex),
        "I_in": np.asarray(st.neuron.I_in),
        "refrac": np.asarray(st.neuron.refrac),
        "ring": np.asarray(st.ring), "t": np.asarray(st.t),
        "overflow": np.asarray(st.overflow)}


@pytest.fixture(scope="module")
def plastic_reference():
    """A jitted JAX plastic run of 100 ms, its state made harder (E neurons
    forced to fire in the first replayed step, and the plastic weights of
    their rows raised above w_max), and the eager JAX loop from there."""
    sim = JaxSimulator(JaxConfig(scale=SCALE, strategy="ell", t_presim=0.0),
                       kernels="reference", plasticity="pair_stdp")
    sim.run(100.0)
    b, (st, jps) = sim.backend, sim.state
    bound, c = b._bound, b.c
    n, k_out = c.n_total, c.targets.shape[1]
    V, refrac = np.asarray(st.neuron.V).copy(), np.asarray(
        st.neuron.refrac).copy()
    forced = np.flatnonzero(refrac[:c.n_exc] == 0)[:6]
    V[forced], refrac[forced] = -45.0, 0
    st = st._replace(neuron=st.neuron._replace(V=jnp.asarray(V),
                                               refrac=jnp.asarray(refrac)))
    w = np.asarray(jps.weights).copy()
    plastic = np.asarray(bound.tables.plastic_out)
    w_max = bound.cfg.w_max_factor * bound.cfg.w_ref
    rows = w[:-1].reshape(n + 1, k_out)
    rows[forced] = np.where(plastic[forced], np.float32(1.5 * w_max),
                            rows[forced])
    jps = jps._replace(weights=jnp.asarray(w))
    start = _jax_sim_arrays(b.net, st)
    plastic_start = _jax_plastic_arrays(bound.tables, jps)
    t0 = int(st.t)
    basis = np.asarray(c.k_ext, np.float32) * np.float32(8.0 * DT * 1e-3)
    counts = np.random.default_rng(2025).poisson(
        basis, size=(N_PRESIM + N_RUN, n)).astype(np.int32)
    drive = _JaxReplay(counts, t0)
    ell = jax_dlv.get_strategy("ell")
    spikes, means = [], []
    for _ in range(N_PRESIM + N_RUN):
        st, spk = jax_update_phase(st, b.net, b.prop, b.cfg, c.w_ext, n,
                                   drive)
        live = ell.live_tables(b.net.tables, bound.weight_view(
            jps, bound.tables))
        ring, ovf = ell.deliver(st.ring, live, spk, st.t, c.n_exc, b.cfg)
        st = JaxSimState(st.neuron, ring, st.t + 1, st.key,
                         st.overflow + ovf)
        jps = bound.step(jps, bound.tables, spk)
        spikes.append(np.asarray(spk))
        means.append(np.asarray(jax_mean_probe()(JaxProbeContext(
            st, spk, b.net, 8, plastic=jps,
            plastic_mask=bound.plastic_mask))))
    return dict(start=start, plastic_start=plastic_start, counts=counts,
                t0=t0, forced=forced, spikes=np.stack(spikes)[N_PRESIM:],
                means=np.stack(means)[N_PRESIM:], final=_jax_sim_arrays(
                    b.net, st), plastic_final=_jax_plastic_arrays(
                    bound.tables, jps), budget=b.cfg.spike_budget,
                k_out=k_out, w_max=w_max)


def test_plastic_reference_is_not_trivial(plastic_reference):
    ref = plastic_reference
    assert ref["forced"].size == 6 and ref["spikes"].sum() > 20
    assert ref["plastic_start"]["x_pre"].max() > 0
    assert ref["plastic_start"]["weights"].max() > ref["w_max"]
    assert not np.array_equal(ref["plastic_start"]["weights"],
                              ref["plastic_final"]["weights"])


@pytest.mark.parametrize("mode", ["fused", "split", "reference"])
def test_plastic_simulator_bitwise_vs_jax_eager(plastic_reference, mode):
    ref = plastic_reference
    net, state = convert.to_torch(ref["start"], "cpu")
    stim = _Replay(counts=torch.from_numpy(ref["counts"]), t0=ref["t0"])
    sim = Simulator(MicrocircuitConfig(scale=SCALE, strategy="ell",
                                       t_presim=PRESIM_MS),
                    kernels=mode, stimulus=(stim,), plasticity="pair_stdp",
                    probes=("spikes", "mean_plastic_weight"), device="cpu")
    pol = sim.sim_config.kernels
    assert pol.step == ("fused" if mode == "fused" else "split")
    assert pol.describe().endswith(
        f"plastic=pair_stdp:{'plain' if mode == 'reference' else 'kernel'}]")
    assert sim.sim_config.spike_budget == ref["budget"]
    k = sim.backend.net.tables.weights.shape[1]
    tables, ps = convert.plastic_to_torch(ref["plastic_start"], k, "cpu")
    for name in ("in_syn_idx", "plastic_out", "plastic_in", "out_targets"):
        assert torch.equal(getattr(sim.backend.bound.tables, name),
                           getattr(tables, name)), name
    sim.state = (state, ps)
    w_start = ps.weights.clone()
    sim.warmup(RUN_MS)                            # leaves the state alone
    assert torch.equal(sim.state[1].weights, w_start)
    res = sim.run(RUN_MS)
    assert res.n_steps == N_RUN and res.overflow == 0
    np.testing.assert_array_equal(res["spikes"], ref["spikes"])
    sim_state, ps = sim.state
    got = convert.to_numpy(sim.backend.net, sim_state)
    for key in ("V", "I_ex", "I_in", "refrac", "ring", "t", "overflow"):
        np.testing.assert_array_equal(got[key], ref["final"][key],
                                      err_msg=key)
    got = convert.plastic_to_numpy(sim.backend.bound.tables, ps,
                                   ref["k_out"])
    for key in ("weights", "x_pre", "x_post"):
        np.testing.assert_array_equal(got[key], ref["plastic_final"][key],
                                      err_msg=key)
    # the probe: the fused path's plastic state lags one step
    mw = res["mean_plastic_weight"]
    if mode == "fused":
        np.testing.assert_allclose(mw[1:], ref["means"][:-1], rtol=1e-6)
    else:
        np.testing.assert_allclose(mw, ref["means"], rtol=1e-6)


def test_plastic_state_setter_checks_the_pair():
    sim = Simulator(MicrocircuitConfig(scale=SCALE, strategy="ell",
                                       t_presim=0.0),
                    plasticity="pair_stdp", device="cpu")
    sim_state, ps = sim.state
    with pytest.raises(TypeError, match="pair"):
        sim.state = sim_state
    with pytest.raises(ValueError, match="plastic weights"):
        sim.state = (sim_state, ps._replace(weights=ps.weights[:, :128]))
    sim.reset()                         # a fresh init clones the table again
    assert sim.state[1].weights is not ps.weights
    assert torch.equal(sim.state[1].weights, sim.backend.net.tables.weights)


@pytest.mark.parametrize("mode", ["fused", "split"])
def test_stdp_update_reuses_the_delivery_ids(monkeypatch, mode):
    """The STDP update works on the ids its step's delivery compacted: a
    plastic run compacts once per delivery (K4's each step, and in the
    fused loop the epilogue's), never again for the update."""
    calls = []

    def counted(spiked, budget):
        calls.append(budget)
        return compact_ids_plain(spiked, budget)
    for mod in list(sys.modules.values()):       # every module holding it
        if mod.__name__.startswith("repro_torch") and getattr(
                mod, "compact_ids_plain", None) is compact_ids_plain:
            monkeypatch.setattr(mod, "compact_ids_plain", counted)
    sim = Simulator(MicrocircuitConfig(scale=SCALE, strategy="ell",
                                       t_presim=0.0), kernels=mode,
                    plasticity="pair_stdp", device="cpu")
    n_steps = sim.run(2.0).n_steps
    assert len(calls) == n_steps + (mode == "fused")


@pytest.mark.parametrize("strategy", ["event", "ell"])
def test_static_weights_pinned_over_plastic_run(strategy):
    """After a plastic session run every non-plastic weight is bitwise the
    connectome's, and the plastic ones moved."""
    sim = Simulator(MicrocircuitConfig(scale=SCALE, strategy=strategy,
                                       t_presim=0.0, seed=7),
                    plasticity="pair_stdp", device="cpu")
    sim.run(30.0)
    w0 = sim.backend.net.tables.weights
    w1 = sim.state[1].weights
    mask = sim.backend.bound.plastic_mask
    assert torch.equal(w1[~mask], w0[~mask])
    assert not torch.equal(w1[mask], w0[mask])


def test_event_vs_ell_plastic_equivalence():
    """At scale 0.05 the live-weight path is bitwise the same under the
    ``event`` and ``ell`` strategies: spike trains, final plastic weights
    and traces (tests/test_plasticity.py:289 in the port)."""
    c = port_build(n_scaling=0.05, k_scaling=0.05, seed=42)
    res, states = {}, {}
    for strategy in ("event", "ell"):
        sim = Simulator(MicrocircuitConfig(n_scaling=0.05, k_scaling=0.05,
                                           strategy=strategy, t_presim=0.0,
                                           spike_budget=256, seed=42),
                        connectome=c, plasticity="pair_stdp",
                        probes=("spikes",), device="cpu")
        res[strategy] = sim.run(20.0)["spikes"]
        states[strategy] = sim.state[1]
    assert res["event"].sum() > 0
    np.testing.assert_array_equal(res["event"], res["ell"])
    k_out = states["event"].weights.shape[1]
    assert torch.equal(states["ell"].weights[:, :k_out],
                       states["event"].weights)
    assert not states["ell"].weights[:, k_out:].any()
    assert torch.equal(states["ell"].x_pre, states["event"].x_pre)
    assert torch.equal(states["ell"].x_post, states["event"].x_post)


def test_network_stable_under_stdp():
    """A plastic run of 200 ms keeps firing, drops no spike, keeps its
    weights finite and its mean plastic weight within 20 % of where it
    began (tests/test_plasticity.py:97 in the port)."""
    sim = Simulator(MicrocircuitConfig(n_scaling=0.02, k_scaling=0.02,
                                       seed=7, strategy="event",
                                       spike_budget=256, t_presim=0.0),
                    plasticity="pair_stdp",
                    probes=("pop_counts", "mean_plastic_weight"),
                    device="cpu")
    res = sim.run(200.0)
    assert res.overflow == 0
    assert torch.isfinite(sim.state[1].weights).all()
    assert res["pop_counts"].sum() > 50
    mw = res["mean_plastic_weight"]
    assert np.isfinite(mw).all()
    assert abs(mw[-1] - mw[0]) < 0.2 * abs(mw[0])


# ---------------------------------------------------------------------------
# The rule registry
# ---------------------------------------------------------------------------

def test_registry_and_serialization():
    assert "pair_stdp" in PL.available_rules()
    rule = PL.resolve_rule("pair_stdp")
    assert isinstance(rule, PL.PairSTDP)
    d = rule.to_dict()
    assert d["kind"] == "pair_stdp"
    assert PL.PlasticityRule.from_dict(d) == rule
    assert PL.resolve_rule({"kind": "pair_stdp", "A_plus": 0.02}) == \
        PL.PairSTDP(A_plus=0.02)
    assert PL.resolve_rule(True) == PL.PairSTDP()
    with pytest.raises(ValueError, match="unknown plasticity rule"):
        PL.resolve_rule("nope")
    with pytest.raises(ValueError, match="unknown field"):
        PL.PlasticityRule.from_dict({"kind": "pair_stdp", "bogus": 1})
    with pytest.raises(TypeError, match="plasticity"):
        PL.resolve_rule(3.14)
    # the same dict means the same rule in both packages
    assert JP.PairSTDP(**{k: v for k, v in d.items() if k != "kind"}) \
        .to_dict() == d


def test_coefficients_and_scaling_match_jax():
    c_jax, c = jax_build(scale=SCALE, seed=SEED), port_build(scale=SCALE,
                                                             seed=SEED)
    cfg = SimConfig(dt=DT, spike_budget=BUDGET)
    jbound = JP.PairSTDP().bind(c_jax, JaxSimConfig(dt=DT,
                                                    spike_budget=BUDGET))
    scaled = PL.PairSTDP().scaled(c, cfg.dt)
    assert dataclasses.asdict(scaled) == dataclasses.asdict(jbound.cfg)
    coef = PL.stdp_coefficients(scaled)
    assert tuple(coef[:4]) == JP.stdp_coefficients(jbound.cfg)
    assert coef.w_max == jbound.cfg.w_max_factor * jbound.cfg.w_ref
