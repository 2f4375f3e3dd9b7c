"""K3: the port's fused step against the JAX package's phase-split step,
and the port's kernel policy.

One call of the port's ``lif_deliver`` (on CPU tensors: its plain
version) delivers the previous step's spikes at phase ``t - 1`` and
integrates step ``t``.  It must equal JAX's eager ``deliver_phase(t - 1)``
followed by ``update_phase(t)`` under ``kernels="reference"`` **bitwise**:
ring, V, currents, refractory counters, spikes, overflow and the next
``t``.  (The JAX
package's own fused kernel cannot serve: ``pl.load`` is gone from jax
0.9.0.)  Inputs: the scale-0.02 microcircuit's ``ell`` tables and a random
state made with numpy from a seed; the external drive is a fixed array of
spike counts handed to both packages.

The drive as K3 and K4 take it: 50 fused steps, the drive's float counts,
``w_ext`` and the running overflow handed to the plain K3 or K4, against
the same steps formed as before (int32 counts cast back and weighted
outside, the counters advanced by ops of their own), bitwise, for five
timelines; ``Drive.counts`` against ``Drive.__call__``; the
``drive.float_counts`` counter and a graph replay's share of it.
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.connectivity import build_connectome as jax_build
from repro.core.engine import SimConfig as JaxSimConfig
from repro.core.engine import SimState as JaxSimState
from repro.core.engine import deliver_phase as jax_deliver_phase
from repro.core.engine import prepare_network as jax_prepare_network
from repro.core.engine import resolve_sim_config as jax_resolve
from repro.core.engine import update_phase as jax_update_phase
from repro.core.neuron import NeuronParams as JaxNeuronParams
from repro.core.neuron import NeuronState as JaxNeuronState
from repro.core.neuron import Propagators as JaxPropagators
from repro_torch.api import Simulator
from repro_torch.api import backends as B
from repro_torch.api.backends import _clone_generator, tree_map
from repro_torch.configs.microcircuit import MicrocircuitConfig
from repro_torch.core import kernel_policy as kpol
from repro_torch.core import plasticity as PL
from repro_torch.core import stimulus as tstim
from repro_torch.core.connectivity import build_connectome as port_build
from repro_torch.core.engine import (SimConfig, SimState,
                                     fused_plastic_update_phase,
                                     fused_update_phase)
from repro_torch.core.engine import prepare_network, resolve_sim_config
from repro_torch.core.neuron import NeuronState, Propagators
from repro_torch.core.params import NeuronParams
from repro_torch.kernels import lif_deliver as K3
from repro_torch.kernels import ops as kops
from repro_torch.kernels.lif_deliver import lif_deliver
from repro_torch.kernels.lif_update import lif_update_plain
from repro_torch.kernels.stdp import depress_plain, traces_plain
from repro_torch.perf import trace

BUDGET = 128
CPU = torch.device("cpu")


class _JaxReplay:
    """A JAX ``Drive`` that replays fixed external spike counts (no key)."""
    n_keys = 0

    def __init__(self, counts):
        self.counts = counts

    def __call__(self, subkeys, t_step, state):
        return None, jnp.asarray(self.counts)


@pytest.fixture(scope="module")
def net():
    c_jax, c_port = jax_build(scale=0.02, seed=55), port_build(scale=0.02,
                                                               seed=55)
    jcfg = jax_resolve(JaxSimConfig(strategy="ell", spike_budget=BUDGET,
                                    kernels="reference"), c_jax)
    pcfg = resolve_sim_config(SimConfig(strategy="ell", spike_budget=BUDGET,
                                        kernels="fused"), c_port, CPU)
    return (c_jax, jcfg, jax_prepare_network(c_jax, jcfg), c_port, pcfg,
            prepare_network(c_port, pcfg, CPU))


def _state(c, seed, n_spikes, refrac_max=2):
    n, rng = c.n_total, np.random.default_rng(seed)
    ring = np.zeros((c.d_max_bins, 2, n + 1), np.float32)
    ring[:, 0, :n] = rng.uniform(0, 60, (c.d_max_bins, n))
    ring[:, 1, :n] = -rng.uniform(0, 60, (c.d_max_bins, n))
    spiked = np.zeros(n, bool)
    spiked[rng.choice(n, size=n_spikes, replace=False)] = True
    return dict(
        V=rng.uniform(-75.0, -49.0, n).astype(np.float32),
        I_ex=np.abs(rng.normal(scale=200.0, size=n)).astype(np.float32),
        I_in=-np.abs(rng.normal(scale=200.0, size=n)).astype(np.float32),
        refrac=rng.integers(0, refrac_max + 1, n).astype(np.int32),
        ring=ring, spiked_prev=spiked,
        counts=rng.poisson(np.asarray(c.k_ext) * 8e-4).astype(np.int32))


def _jax_split(c, cfg, jnet, x, t):
    """JAX eager deliver_phase(t - 1) then update_phase(t)."""
    st = JaxSimState(
        neuron=JaxNeuronState(*(jnp.asarray(x[k])
                                for k in ("V", "I_ex", "I_in", "refrac"))),
        ring=jnp.asarray(x["ring"]), t=jnp.int32(t - 1),
        key=jax.random.PRNGKey(0), overflow=jnp.int32(0))
    st = jax_deliver_phase(st, jnet, cfg, jnp.asarray(x["spiked_prev"]),
                           c.n_exc)
    st, spiked = jax_update_phase(
        st, jnet, JaxPropagators.make(JaxNeuronParams(), cfg.dt), cfg,
        c.w_ext, c.n_total, _JaxReplay(x["counts"]))
    return [np.asarray(a) for a in (st.ring, *st.neuron, spiked,
                                    st.overflow)]


def _port_inputs(c, x):
    """The state as tensors, and the counts as the fused step hands them
    to K3: float32, weighted by ``w_ext`` inside."""
    t = {k: torch.from_numpy(np.array(v, copy=True)) for k, v in x.items()}
    return t, t["counts"].to(torch.float32)


def _zero():
    return torch.zeros((), dtype=torch.int32)


CASES = {"zero_spikes": 0, "one_spike": 1, "budget_exact": BUDGET,
         "budget_overflow": BUDGET + 40, "refractory_mix": 60}


def edge_spikes(n: int, case: str, budget: int = BUDGET) -> np.ndarray:
    """Spike vectors at the compaction's edges: the last neuron; every
    multiple of 512 and of ceil(n / 132) (the tiles of a 512-thread block
    and of one tile per H100 SM), and the last neuron of each of the latter
    tiles; ``2 * budget`` random spikes, so that the budget cuts the
    spiking ids in the middle."""
    tile = -(-n // 132)
    at = {"last_neuron": [n - 1],
          "every_512": range(0, n, 512),
          "every_ceil_n_132": range(0, n, tile),
          "tile_edges_132": [i for b in range(0, n, tile)
                             for i in (b, min(b + tile, n) - 1)],
          "budget_cut_mid": np.random.default_rng(3).choice(
              n, size=2 * budget, replace=False)}[case]
    spiked = np.zeros(n, bool)
    spiked[np.asarray(list(at), dtype=np.int64)] = True
    return spiked


EDGE_CASES = ("last_neuron", "every_512", "every_ceil_n_132",
              "tile_edges_132", "budget_cut_mid")


def _assert_lif_deliver_equals_jax(net, x, t):
    """The port's ``lif_deliver`` (plain on the CPU) against JAX's split
    step, bitwise, and its ids: the lowest BUDGET spiking ids, then N."""
    c_jax, jcfg, jnet, c, pcfg, pnet = net
    want = _jax_split(c_jax, jcfg, jnet, x, t)
    p, ext_cnt = _port_inputs(c, x)
    tb = pnet.tables
    out = lif_deliver(p["ring"], tb.targets, tb.weights, tb.dbins,
                      p["spiked_prev"], p["V"], p["I_ex"], p["I_in"],
                      p["refrac"], ext_cnt, pnet.i_dc,
                      torch.tensor(t, dtype=torch.int32), _zero(),
                      n_exc=c.n_exc, budget=BUDGET,
                      prop=Propagators.make(NeuronParams(), 0.1),
                      w_ext=c.w_ext)
    ring, V, I_ex, I_in, refrac, spiked, ids, ovf, t_next = out
    got = [a.numpy() for a in (ring, V, I_ex, I_in, refrac, spiked, ovf)]
    for name, a, b in zip(("ring", "V", "I_ex", "I_in", "refrac",
                           "spiked", "overflow"), got, want):
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert t_next.dtype == torch.int32 and int(t_next) == t + 1
    n_spikes = int(x["spiked_prev"].sum())
    assert int(ovf) == max(n_spikes - BUDGET, 0)
    hits = np.flatnonzero(x["spiked_prev"])[:BUDGET]
    np.testing.assert_array_equal(ids.numpy()[:hits.size], hits)
    assert (ids.numpy()[hits.size:] == c.n_total).all()


@pytest.mark.parametrize("case", list(CASES))
def test_lif_deliver_bitwise_vs_jax_split(net, case):
    x = _state(net[3], seed=len(case), n_spikes=CASES[case],
               refrac_max=20 if case == "refractory_mix" else 2)
    _assert_lif_deliver_equals_jax(net, x, t=777)


@pytest.mark.parametrize("case", EDGE_CASES)
def test_lif_deliver_compaction_edges_vs_jax_split(net, case):
    """The contract the card's compaction keeps at its tiles' edges: which
    ids are delivered, in which order, and the overflow."""
    c = net[3]
    x = _state(c, seed=11 + len(case), n_spikes=0)
    x["spiked_prev"] = edge_spikes(c.n_total, case)
    _assert_lif_deliver_equals_jax(net, x, t=901)


def test_fused_update_phase_bitwise_vs_jax_split(net):
    """The engine's rotated step (the ops-level wrapper and the drive) is
    the same step."""
    c_jax, jcfg, jnet, c, pcfg, pnet = net
    x = _state(c, seed=99, n_spikes=40)
    t = 5
    want = _jax_split(c_jax, jcfg, jnet, x, t)
    p, _ = _port_inputs(c, x)
    counts = p["counts"]
    replay = tstim.Drive(compiled=(tstim.CompiledStimulus(
        channel="spikes", fn=lambda gen, t_step, state: (None, counts)),),
        bases=(None,))
    st = SimState(NeuronState(p["V"], p["I_ex"], p["I_in"], p["refrac"]),
                  p["ring"], torch.tensor(t, dtype=torch.int32), None,
                  torch.zeros((), dtype=torch.int32))
    st, spiked = fused_update_phase(
        st, pnet, Propagators.make(NeuronParams(), 0.1), pcfg, c.w_ext,
        c.n_total, c.n_exc, p["spiked_prev"], replay)
    got = [a.numpy() for a in (st.ring, *st.neuron, spiked, st.overflow)]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert st.t.dtype == torch.int32 and int(st.t) == t + 1


def test_ops_lif_deliver_signature(net):
    """``kernels.ops.lif_deliver`` takes the reference's arguments (the
    step counter ``t``, the step it integrates, as the kernel-level wrapper
    takes it too: both deliver at ``t - 1``), but the drive as drawn (the
    float counts and ``w_ext``) and the running overflow, and returns
    ``(neuron', ring, spiked, t + 1, overflow')``."""
    c_jax, jcfg, jnet, c, pcfg, pnet = net
    x = _state(c, seed=5, n_spikes=10)
    p, ext_cnt = _port_inputs(c, x)
    prop = Propagators.make(NeuronParams(), 0.1)
    t = torch.tensor(41, dtype=torch.int32)
    ovf = torch.tensor(3, dtype=torch.int32)
    a = kops.lif_deliver(
        NeuronState(p["V"], p["I_ex"], p["I_in"], p["refrac"]),
        p["ring"].clone(), t, p["spiked_prev"], pnet.tables, prop, ext_cnt,
        pnet.i_dc, n_exc=c.n_exc, spike_budget=BUDGET, w_ext=c.w_ext,
        overflow=ovf)
    b = lif_deliver(p["ring"].clone(), *pnet.tables, p["spiked_prev"],
                    p["V"], p["I_ex"], p["I_in"], p["refrac"], ext_cnt,
                    pnet.i_dc, t, ovf, n_exc=c.n_exc, budget=BUDGET,
                    prop=prop, w_ext=c.w_ext)
    for u, v in zip((*a[0], a[1], a[2], a[3], a[4]),
                    (b[1], b[2], b[3], b[4], b[0], b[5], b[8], b[7])):
        assert torch.equal(u, v)
    assert int(a[3]) == 42 and int(a[4]) == 3


# ---------------------------------------------------------------------------
# The kernel policy, resolved against the session's device
# ---------------------------------------------------------------------------

def _resolve(kernels, strategy="ell", device="cuda", dtype=torch.float32):
    return kpol.resolve(kernels, strategy=strategy, state_dtype=dtype,
                        device=torch.device(device))


@pytest.mark.parametrize("device,strategy,want", [
    ("cuda", "ell", ("fused", True, "kernel")),
    ("cuda", "event", ("split", True, "index_add")),
    ("cpu", "ell", ("split", False, "index_add")),
    ("cpu", "event", ("split", False, "index_add")),
])
def test_policy_auto(device, strategy, want):
    p = _resolve(None, strategy=strategy, device=device)
    assert (p.mode, p.step, p.kernels, p.deliver) == ("auto", *want)
    assert kpol.resolve(p, strategy=strategy, state_dtype=torch.float32,
                        device=torch.device(device)) == p      # idempotent


def test_policy_auto_needs_float32_for_fused():
    assert _resolve(None, dtype=torch.bfloat16).step == "split"


@pytest.mark.parametrize("device", ["cuda", "cpu"])
def test_policy_named_modes(device):
    ref = _resolve("reference", device=device)
    assert (ref.step, ref.kernels, ref.deliver) == ("split", False,
                                                    "index_add")
    split = _resolve("split", device=device)
    assert (split.step, split.kernels, split.deliver) == ("split", True,
                                                          "kernel")
    assert _resolve("fused", device=device).step == "fused"


def test_policy_rejects():
    with pytest.raises(ValueError, match="ell"):
        _resolve("fused", strategy="event")
    with pytest.raises(ValueError, match="float32"):
        _resolve("fused", dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        _resolve("warp")
    with pytest.raises(TypeError):
        _resolve(42)


@pytest.mark.parametrize("mode,strategy,want", [
    (None, "ell", "auto[step=fused,lif=kernel,deliver=kernel]"),
    (None, "event", "auto[step=split,lif=kernel,deliver=index_add]"),
    ("split", "event", "split[step=split,lif=kernel,deliver=index_add]"),
    ("reference", "ell",
     "reference[step=split,lif=plain,deliver=index_add]"),
])
def test_policy_describe(mode, strategy, want):
    """describe() names what runs: the event strategy has no delivery
    kernel, so it reports index_add_ whatever the mode."""
    assert _resolve(mode, strategy=strategy).describe() == want


@pytest.mark.parametrize("mode,plastic,want", [
    (None, "pair_stdp",
     "auto[step=fused,lif=kernel,deliver=kernel,plastic=pair_stdp:kernel]"),
    (None, "other_rule",
     "auto[step=split,lif=kernel,deliver=kernel,plastic=other_rule:kernel]"),
    ("reference", "pair_stdp",
     "reference[step=split,lif=plain,deliver=index_add,"
     "plastic=pair_stdp:plain]"),
])
def test_policy_plastic(mode, plastic, want):
    """The fused step takes a plastic run only for pair STDP (K4 is its
    kernel); describe() names the rule and how its update runs."""
    p = kpol.resolve(mode, strategy="ell", state_dtype=torch.float32,
                     device=torch.device("cuda"), plastic=plastic)
    assert p.describe() == want


def test_policy_fused_rejects_other_rules():
    with pytest.raises(ValueError, match="pair STDP"):
        kpol.resolve("fused", strategy="ell", state_dtype=torch.float32,
                     device=torch.device("cuda"), plastic="other_rule")


# ---------------------------------------------------------------------------
# The drive as K3 and K4 take it: the float counts, ``w_ext`` and the
# counters inside the kernel, against the step as it was formed before
# ---------------------------------------------------------------------------

DRIVE_STEPS = 50


@dataclasses.dataclass(frozen=True)
class _IntCounts(tstim.Stimulus):
    """A stimulus in the general ``fn`` form whose spike counts come as
    int32: the background's draws from the session's generator, cast."""

    def compile(self, c, cfg, neuron):
        mean = torch.as_tensor(np.asarray(c.k_ext, np.float32)
                               * np.float32(8.0 * cfg.dt * 1e-3))
        return tstim.CompiledStimulus(
            channel="spikes", stochastic=True,
            fn=lambda gen, t, state: (None, torch.poisson(
                mean, generator=gen).to(torch.int32)))


#: timelines, each with the spike budget of its case
DRIVES = {
    "background": ((tstim.PoissonBackground(),), BUDGET),
    "background_thalamic": ((tstim.PoissonBackground(),
                             tstim.ThalamicPulses(start_ms=0.5,
                                                  interval_ms=2.0,
                                                  duration_ms=0.8)), BUDGET),
    "step_current_no_spikes": ((tstim.StepCurrent(
        amplitude_pa=400.0, populations=("L4E", "L5E"), t_start_ms=0.5,
        t_stop_ms=3.5),), BUDGET),
    "fn_int32_counts": ((_IntCounts(),), BUDGET),
    "overflowing_budget": ((tstim.PoissonBackground(),), 16),
}


@pytest.fixture(scope="module")
def drive_net():
    return port_build(scale=0.02, seed=55)


def _drive_session(c, name, plastic):
    timeline, budget = DRIVES[name]
    return Simulator(
        MicrocircuitConfig(scale=0.02, strategy="ell", t_presim=0.0,
                           seed=55),
        connectome=c, device="cpu", kernels="fused", stimulus=timeline,
        spike_budget=budget, plasticity="pair_stdp" if plastic else None)


def _todays_drive(drive, gen, t, state):
    """``Drive.__call__`` as it was before the counts stayed float: each
    draw cast to int32, the counts summed in int32."""
    I_ext, ext_in = None, None
    for s, basis in zip(drive.compiled, drive.bases):
        g = gen if s.stochastic else None
        if s.fn is not None:
            i_c, e_c = s.fn(g, t, state)
        else:
            val = basis if s.gate is None else basis * s.gate(t)
            i_c, e_c = ((None, torch.poisson(val, generator=g).to(
                torch.int32)) if s.channel == "spikes" else (val, None))
        if i_c is not None:
            I_ext = i_c if I_ext is None else I_ext + i_c
        if e_c is not None:
            ext_in = e_c if ext_in is None else ext_in + e_c
    return I_ext, ext_in


def _todays_step(b, st, ps, spiked_prev, trace):
    """One fused step as it was formed before K3 and K4 took the drive: the
    int32 counts cast back and weighted by a PyTorch product (zeros with
    no spike drive), the former plain K3 or K4, and the counters advanced
    by two ops of their own."""
    c, net, n = b.c, b.net, b.c.n_total
    I_ext, ext_in = _todays_drive(b.drive, st.generator, st.t, st)
    ext_ex = torch.zeros(n) if ext_in is None \
        else c.w_ext * ext_in.to(torch.float32)
    i_dc = net.i_dc if I_ext is None else net.i_dc + I_ext
    tb = net.tables
    ring, ids, ovf = K3.ell_deliver_plain(
        st.ring, tb.targets, tb.weights if ps is None else ps.weights,
        tb.dbins, spiked_prev, st.t - 1, c.n_exc, b.cfg.spike_budget)
    slot = K3.slot_index(st.t, ring.shape[0])
    arrivals = ring.index_select(0, slot)[0]
    nr = st.neuron
    V, I_ex, I_in, refrac, spiked = lif_update_plain(
        nr.V, nr.I_ex, nr.I_in, nr.refrac, arrivals[0, :n] + ext_ex,
        arrivals[1, :n], i_dc, prop=b.prop)
    ring.index_fill_(0, slot, 0.0)
    if ps is not None:
        coef = b.bound.coef
        depress_plain(ps.weights, tb.targets, b.bound.tables.plastic_out,
                      ps.x_post, ids, coef.dep)
        if trace:
            x_pre, x_post = traces_plain(ps.x_pre, ps.x_post, spiked_prev,
                                         coef.decay_p, coef.decay_m)
            ps = ps._replace(x_pre=x_pre, x_post=x_post)
    return (SimState(NeuronState(V, I_ex, I_in, refrac), ring, st.t + 1,
                     st.generator, st.overflow + ovf), ps, spiked, ids)


def _todays_steps(b, st, ps, n_steps):
    spiked = torch.zeros(b.c.n_total, dtype=torch.bool)
    for i in range(n_steps):
        x_pre = None if ps is None else ps.x_pre
        st, ps, spiked, ids = _todays_step(b, st, ps, spiked, trace=i > 0)
        if ps is not None and i > 0:
            PL.stdp_pot_clip(ps.weights, x_pre, ids, b.bound.tables,
                             b.bound.coef, clip_all=i == 1,
                             kernel=b.bound.kernel)
    return st, ps


def _fused_steps(b, st, ps, n_steps):
    spiked = torch.zeros(b.c.n_total, dtype=torch.bool)
    c = b.c
    for i in range(n_steps):
        if ps is None:
            st, spiked = fused_update_phase(
                st, b.net, b.prop, b.cfg, c.w_ext, c.n_total, c.n_exc,
                spiked, b.drive)
            continue
        x_pre = ps.x_pre
        st, ps, spiked, ids = fused_plastic_update_phase(
            st, ps, b.net, b.prop, b.cfg, c.w_ext, c.n_total, c.n_exc,
            spiked, b.drive, b.bound, trace=i > 0)
        if i > 0:
            PL.stdp_pot_clip(ps.weights, x_pre, ids, b.bound.tables,
                             b.bound.coef, clip_all=i == 1,
                             kernel=b.bound.kernel)
    return st, ps


def _start(sim, overflowing):
    """Two copies of the session's state, each with its own twin of the
    generator; in the overflowing case every third neuron starts above
    threshold, so that the small budget cuts the first delivery."""
    out = []
    for _ in range(2):
        st, ps = sim.backend._split_state(tree_map(torch.clone, sim.state))
        st = st._replace(generator=_clone_generator(st.generator))
        if overflowing:
            st.neuron.V[::3] = float(sim.backend.prop.V_th) + 1.0
        out.append((st, ps))
    return out


@pytest.mark.parametrize("plastic", [False, True], ids=["K3", "K4"])
@pytest.mark.parametrize("name", list(DRIVES))
def test_float_counts_step_equals_todays_step(drive_net, name, plastic):
    """50 fused steps with the drive's float counts, ``w_ext`` and the
    running overflow handed to the plain K3 or K4, against the same steps
    formed as before (int32 counts, the product and the counters' adds
    outside): every leaf bitwise, ``t``, the overflow and the generator's
    state included."""
    sim = _drive_session(drive_net, name, plastic)
    b = sim.backend
    (a_st, a_ps), (w_st, w_ps) = _start(sim, name == "overflowing_budget")
    got_st, got_ps = _fused_steps(b, a_st, a_ps, DRIVE_STEPS)
    want_st, want_ps = _todays_steps(b, w_st, w_ps, DRIVE_STEPS)
    for leaf in ("V", "I_ex", "I_in", "refrac"):
        assert torch.equal(getattr(got_st.neuron, leaf),
                           getattr(want_st.neuron, leaf)), leaf
    assert torch.equal(got_st.ring, want_st.ring)
    assert got_st.t.dtype == torch.int32 and got_st.t.dim() == 0
    assert int(got_st.t) == int(want_st.t) == DRIVE_STEPS
    assert got_st.overflow.dtype == torch.int32
    assert int(got_st.overflow) == int(want_st.overflow)
    assert (int(got_st.overflow) > 0) == (name == "overflowing_budget")
    assert torch.equal(got_st.generator.get_state(),
                       want_st.generator.get_state())
    if plastic:
        for leaf in ("weights", "x_pre", "x_post"):
            assert torch.equal(getattr(got_ps, leaf),
                               getattr(want_ps, leaf)), leaf
    assert (b.drive.counts(None, got_st.t, got_st)[1] is None) \
        == (name == "step_current_no_spikes")


@pytest.mark.parametrize("name", list(DRIVES))
def test_drive_counts_cast_equal_its_call(drive_net, name):
    """``Drive.counts`` cast to int32 is ``Drive.__call__``, and the
    int32 counts as they were summed before, from one generator state;
    the counts are float32 and the current the same tensor values."""
    b = _drive_session(drive_net, name, False).backend
    st = b.init(torch.Generator().manual_seed(7))
    gens = [_clone_generator(st.generator) for _ in range(3)]
    for t in (0, 4, 5, 9, 12, 30):
        tt = torch.tensor(t, dtype=torch.int32)
        I_f, cnt = b.drive.counts(gens[0], tt, st)
        I_i, ext_in = b.drive(gens[1], tt, st)
        I_o, ext_old = _todays_drive(b.drive, gens[2], tt, st)
        for cur in (I_i, I_o):
            assert (cur is None) == (I_f is None)
            assert cur is None or torch.equal(cur, I_f)
        if cnt is None:
            assert ext_in is None and ext_old is None
            continue
        assert cnt.dtype == torch.float32 and ext_in.dtype == torch.int32
        assert torch.equal(cnt.to(torch.int32), ext_in)
        assert torch.equal(ext_in, ext_old)
        assert torch.equal(cnt, ext_old.to(torch.float32))
    assert all(torch.equal(g.get_state(), gens[0].get_state())
               for g in gens[1:])


@pytest.mark.parametrize("name,kernels,counted", [
    ("background", "fused", True), ("background_thalamic", "fused", True),
    ("step_current_no_spikes", "fused", True),
    ("fn_int32_counts", "fused", False), ("background", "split", False)])
def test_float_counts_counter(drive_net, name, kernels, counted):
    """``drive.float_counts`` counts each fused step whose separable drive
    reached the kernel as drawn; a general ``fn`` drive (which may cast)
    and the split loop count none."""
    timeline, budget = DRIVES[name]
    sim = Simulator(MicrocircuitConfig(scale=0.02, strategy="ell",
                                       t_presim=0.0, seed=55),
                    connectome=drive_net, device="cpu", kernels=kernels,
                    stimulus=timeline, spike_budget=budget)
    before = trace.tally().get("drive.float_counts", 0)
    res = sim.run(1.0)
    after = trace.tally().get("drive.float_counts", 0)
    assert res.n_steps == 10
    assert after - before == (10 if counted else 0)


class _RecordedGraph:
    """``torch.cuda.CUDAGraph``'s stand-in: a replay runs nothing."""

    def register_generator_state(self, generator):
        pass

    def replay(self):
        pass


def test_graph_replays_credit_the_captured_counts(monkeypatch):
    """What a capture counts is taken back, and each replay adds it, as
    the replay of the captured steps would have counted it."""
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _RecordedGraph)
    monkeypatch.setattr(torch.cuda, "graph",
                        lambda graph, pool=None: contextlib.nullcontext())
    key = "test.captured_count"

    def segment():
        trace.count(key, 3)
    before = trace.tally().get(key, 0)
    g = B._Graph(segment, None, None)
    assert trace.tally().get(key, 0) == before
    assert g.counts == {key: 3}
    g.replay(4)
    assert trace.tally()[key] == before + 12
