"""The core's functional entry points of the port against the reference's,
on the CPU at scale 0.02 (N = 1,544), ``ell``.

Under the deterministic ``dc()`` drive (a 400 pA current into every
neuron, no Poisson draw), from the JAX state of
``tests/test_torch_distributed.py``'s fixture (spikes in flight), each of
``simulate``, ``make_step``, ``PhaseRunner`` and ``simulate_plastic`` is
held bitwise to the reference's function of the same name run under
``jax.disable_jit()`` (jitted XLA contracts FMAs on the CPU, so the
jitted reference is not the yardstick).  ``simulate_plastic``'s initial V
is the reference's (the two packages' generators cannot agree), and its
mean plastic weight is held within rtol 1e-6 (the two sum the table in
another order, as ``tests/test_torch_plasticity.py`` states).  Each warns
``DeprecationWarning`` where the reference does.

``deliver_event`` bitwise against the reference's, at the spike counts and
overflow cut of ``tests/test_torch_delivery.py``; ``as_policy``,
``SimParams``, ``ProbeLike``, ``BoundPlasticity`` and ``core.__all__``
against the reference's names and defaults.
"""
import dataclasses
import typing
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.core import delivery as jdlv
from repro.core import engine as JE
from repro.core import kernel_policy as jkpol
from repro.core import params as jparams
from repro.core import plasticity as JPL
from repro.core import stimulus as JS
from repro.core.connectivity import build_connectome as jax_build
from repro.core.neuron import NeuronParams as JaxNeuronParams
from repro.core.neuron import NeuronState as JaxNeuronState
from repro.core.neuron import Propagators as JaxPropagators
import repro_torch.core as tcore
from repro_torch.api import probes as tprobes
from repro_torch.core import delivery as tdlv
from repro_torch.core import engine as TE
from repro_torch.core import kernel_policy as tkpol
from repro_torch.core import params as tparams
from repro_torch.core import plasticity as TPL
from repro_torch.core import stimulus as TS
from repro_torch.core.connectivity import build_connectome
from repro_torch.core.neuron import NeuronState, Propagators
from test_torch_delivery import BUDGET, COUNTS, T_STEP, _ring, _spiked
from test_torch_distributed import DC, jax_dc_reference  # noqa: F401

SCALE, SEED, N_STEPS = 0.02, 55, 100


@pytest.fixture(autouse=True)
def _one_thread_and_flushed_subnormals():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    assert torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def connectome():
    return build_connectome(scale=SCALE, seed=SEED)


def _jax_state(start, key):
    return JE.SimState(
        neuron=JaxNeuronState(*(jnp.asarray(start[k]) for k in (
            "V", "I_ex", "I_in", "refrac"))),
        ring=jnp.asarray(start["ring"]), t=jnp.asarray(start["t"]),
        key=key, overflow=jnp.asarray(start["overflow"]))


def _port_state(start, generator=None):
    on = lambda k: torch.from_numpy(np.array(start[k], copy=True))
    return TE.SimState(
        neuron=NeuronState(*(on(k) for k in ("V", "I_ex", "I_in",
                                              "refrac"))),
        ring=on("ring"), t=on("t").reshape(()), generator=generator,
        overflow=on("overflow").reshape(()))


def _assert_states_equal(port, ref):
    for name in ("V", "I_ex", "I_in", "refrac"):
        np.testing.assert_array_equal(getattr(port.neuron, name).numpy(),
                                      np.asarray(getattr(ref.neuron, name)),
                                      err_msg=name)
    for name in ("ring", "t", "overflow"):
        np.testing.assert_array_equal(getattr(port, name).numpy(),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)


def _configs(ref, record="pop_counts"):
    """The two packages' ``SimConfig`` of the reference fixture's run:
    ``ell``, its spike budget, the ``dc()`` timeline."""
    return (JE.SimConfig(strategy="ell", spike_budget=ref["budget"],
                         stimulus=DC, record=record),
            TE.SimConfig(strategy="ell", spike_budget=ref["budget"],
                         stimulus=DC, record=record))


# ---------------------------------------------------------------------------
# (f) simulate, make_step, PhaseRunner, simulate_plastic
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("record", ["pop_counts", "spikes", "none"])
def test_simulate_bitwise_vs_eager_reference(jax_dc_reference, connectome,
                                             record):
    ref = jax_dc_reference
    jcfg, tcfg = _configs(ref, record)
    with jax.disable_jit(), pytest.warns(DeprecationWarning,
                                         match="simulate is deprecated"):
        jfinal, jrec, _ = JE.simulate(
            ref["c"], N_STEPS * 0.1, jcfg,
            state=_jax_state(ref["start"], jax.random.PRNGKey(0)))
    with pytest.warns(DeprecationWarning, match="simulate is deprecated"):
        final, rec, net = TE.simulate(connectome, N_STEPS * 0.1, tcfg,
                                      state=_port_state(ref["start"]),
                                      device="cpu")
    assert rec.shape[0] == N_STEPS
    np.testing.assert_array_equal(rec.numpy(), np.asarray(jrec))
    if record == "spikes":
        np.testing.assert_array_equal(rec.numpy(), ref["spikes"])
        assert ref["spikes"].sum() > 20
    _assert_states_equal(final, jfinal)
    _assert_states_equal(final, _jax_state(ref["final"], None))
    assert net.tables.targets.shape[0] == connectome.n_total + 1


def test_simulate_default_timeline_draws_as_the_session(connectome):
    """``cfg.stimulus`` None: the inline background draws what the
    session's ``poisson_background`` draws from one seed."""
    from repro_torch.api import Simulator
    from repro_torch.configs.microcircuit import MicrocircuitConfig
    with pytest.warns(DeprecationWarning):
        final, rec, _ = TE.simulate(connectome, 30.0,
                                    TE.SimConfig(strategy="ell"), key=7,
                                    device="cpu")
    sim = Simulator(MicrocircuitConfig(scale=SCALE, strategy="ell",
                                       t_presim=0.0),
                    connectome=connectome, key=7, device="cpu")
    res = sim.run(30.0)
    np.testing.assert_array_equal(rec.numpy(), res["pop_counts"])
    assert rec.numpy().sum() > 0
    np.testing.assert_array_equal(final.neuron.V.numpy(),
                                  sim.state.neuron.V.numpy())


@pytest.mark.parametrize("record", ["pop_counts", "spikes", "none",
                                    "record_fn"])
def test_make_step_bitwise_vs_eager_reference(jax_dc_reference, connectome,
                                              record):
    ref = jax_dc_reference
    c, jc = connectome, ref["c"]
    jcfg, tcfg = _configs(ref, "pop_counts" if record == "record_fn"
                          else record)
    jcfg = JE.resolve_sim_config(jcfg, jc)
    tcfg = TE.resolve_sim_config(tcfg, c, "cpu")
    jfn = (lambda st, spk: (st.neuron.V[:64], spk.sum())) \
        if record == "record_fn" else None
    tfn = (lambda st, spk: torch.stack([st.neuron.V[:64],
                                        spk.sum().expand(64).float()])) \
        if record == "record_fn" else None
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        jstep = JE.make_step(
            JE.prepare_network(jc, jcfg), JaxPropagators.make(
                JaxNeuronParams(), 0.1), jcfg, jc.w_ext, jc.n_total,
            jc.n_exc, n_pops=8, record_fn=jfn,
            drive=JS.compile_drive(jcfg.stimulus, jc, jcfg,
                                   JaxNeuronParams()))
        tstep = TE.make_step(
            TE.prepare_network(c, tcfg, "cpu"), Propagators.make(
                tparams.NeuronParams(), 0.1), tcfg, c.w_ext, c.n_total,
            c.n_exc, n_pops=8, record_fn=tfn,
            drive=TS.compile_drive(tcfg.stimulus, c, tcfg,
                                   tparams.NeuronParams(), "cpu"))
    jst = _jax_state(ref["start"], jax.random.PRNGKey(0))
    tst = _port_state(ref["start"])
    with jax.disable_jit():
        for _ in range(N_STEPS):
            jst, jout = jstep(jst, None)
            tst, tout = tstep(tst, None)
            if record == "record_fn":
                np.testing.assert_array_equal(tout[0].numpy(),
                                              np.asarray(jout[0]))
                assert int(tout[1, 0]) == int(jout[1])
            else:
                np.testing.assert_array_equal(tout.numpy(),
                                              np.asarray(jout))
    _assert_states_equal(tst, jst)


def test_make_step_inline_background_is_the_stimulus(connectome):
    """``drive=None`` draws the ``poisson_background`` stimulus's counts
    from the same generator state, bitwise."""
    c = connectome
    cfg = TE.resolve_sim_config(TE.SimConfig(strategy="ell"), c, "cpu")
    net = TE.prepare_network(c, cfg, "cpu")
    prop = Propagators.make(tparams.NeuronParams(), 0.1)
    drive = TS.compile_drive(cfg.stimulus, c, cfg, tparams.NeuronParams(),
                             "cpu")
    runs = []
    for d in (None, drive):
        gen = torch.Generator().manual_seed(3)
        st = TE.init_state(net, c.d_max_bins, gen)
        step = TE.make_step(net, prop, cfg, c.w_ext, c.n_total, c.n_exc,
                            drive=d)
        outs = []
        for _ in range(200):
            st, out = step(st)
            outs.append(out)
        runs.append((torch.stack(outs), st.neuron.V, gen.get_state()))
    (a, va, ga), (b, vb, gb) = runs
    assert a.sum() > 0
    assert torch.equal(a, b) and torch.equal(va, vb)
    assert torch.equal(ga, gb)


@pytest.mark.parametrize("kernels", [None, "split",
                                     tkpol.KernelPolicy(mode="split")],
                         ids=["none", "mode", "hand_made_policy"])
def test_make_step_refuses_an_unresolved_policy(connectome, kernels):
    """An unresolved kernel policy would run the plain versions on the
    card: ``make_step`` raises before it builds the step."""
    c = connectome
    resolved = TE.resolve_sim_config(TE.SimConfig(strategy="ell"), c, "cpu")
    net = TE.prepare_network(c, resolved, "cpu")
    cfg = dataclasses.replace(resolved, kernels=kernels)
    with pytest.raises(ValueError, match="resolve_sim_config"):
        TE.make_step(net, Propagators.make(tparams.NeuronParams(), 0.1),
                     cfg, c.w_ext, c.n_total, c.n_exc)


def test_phase_runner_bitwise_vs_eager_reference(jax_dc_reference,
                                                 connectome):
    ref = jax_dc_reference
    jcfg, tcfg = _configs(ref)
    with pytest.warns(DeprecationWarning, match="PhaseRunner"):
        jr = JE.PhaseRunner(ref["c"], jcfg)
    with pytest.warns(DeprecationWarning, match="PhaseRunner"):
        tr = TE.PhaseRunner(connectome, tcfg, device="cpu")
    jr.state = _jax_state(ref["start"], jr.state.key)
    tr.state = _port_state(ref["start"], tr.state.generator)
    jt, tt = {}, {}
    with jax.disable_jit():
        for i in range(N_STEPS):
            jspk, tspk = jr.step_timed(jt), tr.step_timed(tt)
            np.testing.assert_array_equal(tspk.numpy(), np.asarray(jspk))
            np.testing.assert_array_equal(tspk.numpy(), ref["spikes"][i])
    _assert_states_equal(tr.state, jr.state)
    assert set(tt) == set(jt) == {"update", "deliver"}
    assert all(v > 0 for v in tt.values())
    assert (tr.n, tr.n_exc, tr.w_ext) == (jr.n, jr.n_exc, jr.w_ext)


def test_simulate_plastic_bitwise_vs_eager_reference(connectome,
                                                     monkeypatch):
    c, jc = connectome, jax_build(scale=SCALE, seed=SEED)
    jcfg = JE.SimConfig(strategy="ell", stimulus=DC)
    tcfg = TE.SimConfig(strategy="ell", stimulus=DC)
    t_ms = 10.0
    # the reference's initial V (from its key) given to the port's init
    from repro.api.simulator import Simulator as JaxSimulator
    v0 = np.array(JaxSimulator(
        connectome=jc, sim_config=jcfg, plasticity="pair_stdp",
        probes=("pop_counts",)).state[0].neuron.V)
    from repro_torch.api import backends as TB
    real_init = TB.init_state

    def init_with_reference_v(*args, **kwargs):
        st = real_init(*args, **kwargs)
        st.neuron.V.copy_(torch.from_numpy(v0))
        return st
    monkeypatch.setattr(TB, "init_state", init_with_reference_v)
    with jax.disable_jit(), pytest.warns(DeprecationWarning,
                                         match="simulate_plastic"):
        jsim, jps, (jcounts, jmw) = JPL.simulate_plastic(
            jc, t_ms, jcfg, JPL.STDPConfig())
    with pytest.warns(DeprecationWarning, match="simulate_plastic"):
        tsim, tps, (tcounts, tmw) = TPL.simulate_plastic(
            c, t_ms, tcfg, TPL.STDPConfig(), device="cpu")
    assert tcounts.shape == (100, 8) and tcounts.sum() > 20
    np.testing.assert_array_equal(tcounts, np.asarray(jcounts))
    np.testing.assert_allclose(tmw, np.asarray(jmw), rtol=1e-6)
    _assert_states_equal(tsim, jsim)
    k_out = jc.targets.shape[1]
    np.testing.assert_array_equal(
        TPL.plastic_weight_view(tps, c.n_total, k_out).numpy(),
        np.asarray(JPL.plastic_weight_view(jps, jc.n_total, k_out)))
    np.testing.assert_array_equal(tps.x_pre.numpy(), np.asarray(jps.x_pre))
    np.testing.assert_array_equal(tps.x_post.numpy(), np.asarray(jps.x_post))


# ---------------------------------------------------------------------------
# (g) deliver_event and the names
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("count", list(COUNTS))
@pytest.mark.parametrize("zero_ring", [False, True], ids=["ring", "zero"])
def test_deliver_event_bitwise(connectome, count, zero_ring):
    c, jc = connectome, jax_build(scale=SCALE, seed=SEED)
    jt = jdlv.get_strategy("event").prepare(jc, JE.SimConfig())
    tt = tdlv.get_strategy("event").prepare(c, TE.SimConfig(), "cpu")
    spiked = _spiked(c.n_total, COUNTS[count], seed=11)
    ring = _ring(c, 12, zero_ring)
    j_ring, j_ovf = jdlv.deliver_event(jnp.asarray(ring), jt,
                                       jnp.asarray(spiked), T_STEP,
                                       c.n_exc, BUDGET)
    r = torch.from_numpy(ring.copy())
    t_ring, t_ovf = tdlv.deliver_event(r, tt, torch.from_numpy(spiked),
                                       T_STEP, c.n_exc, BUDGET)
    assert t_ring is r                  # in place
    np.testing.assert_array_equal(t_ring.numpy(), np.asarray(j_ring))
    assert int(t_ovf) == int(j_ovf) == max(COUNTS[count] - BUDGET, 0)


def test_core_exports_the_reference_names():
    assert tcore.__all__ == jcore.__all__
    for name in tcore.__all__:
        assert getattr(tcore, name) is not None, name
    assert tcore.simulate is TE.simulate
    assert tcore.PhaseRunner is TE.PhaseRunner
    assert tcore.register_stimulus is TS.register
    assert tcore.params is tparams


def test_sim_params_and_as_policy_match_the_reference():
    fields = lambda cls: [(f.name, f.default)
                          for f in dataclasses.fields(cls)]
    assert fields(tparams.SimParams) == fields(jparams.SimParams)
    for mode in (None, "auto", "fused", "split", "reference"):
        t, j = tkpol.as_policy(mode), jkpol.as_policy(mode)
        assert (t.mode, t.resolved) == (j.mode, j.resolved), mode
    pol = tkpol.as_policy("split")
    assert tkpol.as_policy(pol) is pol
    for fn in (tkpol.as_policy, jkpol.as_policy):
        with pytest.raises(TypeError, match="kernels="):
            fn(3)
        with pytest.raises(ValueError, match="bogus"):
            fn("bogus")
    resolved = tkpol.resolve(pol, strategy="ell", state_dtype=torch.float32,
                             device="cpu")
    assert resolved.resolved and resolved.step == "split"
    assert resolved.kernels and resolved.deliver == "kernel"
    assert tkpol.policy_of(TE.SimConfig(kernels=pol)) is None
    assert tkpol.policy_of(TE.SimConfig(kernels=resolved)) is resolved


def test_probe_like_and_bound_plasticity(connectome):
    assert typing.get_args(tprobes.ProbeLike) == (
        str, tprobes.Probe, tprobes.StreamProbe)
    cfg = TE.resolve_sim_config(TE.SimConfig(strategy="ell"), connectome,
                                "cpu", plastic="pair_stdp")
    tables = tdlv.get_strategy("ell").prepare(connectome, cfg, "cpu")
    bound = TPL.PairSTDP().bind(connectome, cfg, tables)
    assert isinstance(bound, TPL.BoundPlasticity)
    assert TPL.resolve_rule(TPL.STDPConfig(lr=2.0)) == \
        TPL.PairSTDP.from_stdp_config(TPL.STDPConfig(lr=2.0))
    assert TPL.PairSTDP.from_stdp_config(TPL.STDPConfig()).to_dict() == \
        JPL.PairSTDP.from_stdp_config(JPL.STDPConfig()).to_dict()
