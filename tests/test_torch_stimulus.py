"""The port's stimuli against the JAX package's, on the CPU.

Scale 0.02, dt = 0.1 ms.  For ``dc`` (the background's equivalent current
and an explicit amplitude into two populations), ``step_current``,
``thalamic_pulses`` (with and without ``n_pulses``) and a windowed
``poisson_background``, bitwise:

* the compiled basis;
* the gate and the drive's value (the current, or the Poisson mean
  ``basis * gate``) at every step of the first 6 ms and at each window's
  edges (the step before the start, the start, the last step on, the stop,
  each pulse's first and last step, and the step after the last pulse);
* the drive's draws: zero wherever the gate is off.

``to_dict`` equals the reference's dict for each kind, and ``from_dict``
round-trips it in both packages.  And the whole loop: a session driven by
the DC and step-current stimuli alone (no randomness), from a state the
JAX package left at step 30 (spikes in flight) carried through
``repro_torch.convert`` (the step counter a 0-d int32 tensor), 100 steps,
against the eager JAX loop: the raster and the final state bitwise.

The sharded engine's view of a timeline: ``Drive.plan`` and
``padded_bases`` equal the JAX package's for the background beside each
built-in (bases, gates, the padding zero), ``Drive.shard`` holds a rank's
slice of them, and a stimulus in the general ``fn`` form is refused by
both packages.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import stimulus as JS
from repro.core.connectivity import build_connectome as jax_build_connectome
from repro.core.engine import SimConfig as JaxSimConfig
from repro.core.engine import deliver_phase as jax_deliver_phase
from repro.core.engine import init_state as jax_init_state
from repro.core.engine import prepare_network as jax_prepare_network
from repro.core.engine import resolve_sim_config as jax_resolve
from repro.core.engine import update_phase as jax_update_phase
from repro.core.neuron import NeuronParams as JaxNeuronParams
from repro.core.neuron import Propagators as JaxPropagators
from repro_torch import convert
from repro_torch.api import Simulator
from repro_torch.configs.microcircuit import MicrocircuitConfig
from repro_torch.core import stimulus as S
from repro_torch.core.connectivity import build_connectome
from repro_torch.core.engine import SimConfig
from repro_torch.core.params import NeuronParams, thalamic_indegrees

SCALE, DT, SEED = 0.02, 0.1, 55

SPECS = {
    "dc_equivalent": {"kind": "dc", "t_start_ms": 1.0},
    "dc_explicit": {"kind": "dc", "amplitude_pa": 35.5,
                    "populations": ["L4E", "L6I"], "t_start_ms": 0.5,
                    "t_stop_ms": 2.5},
    "step_current": {"kind": "step_current", "amplitude_pa": -12.5,
                     "populations": ["L23I"], "t_start_ms": 0.3,
                     "t_stop_ms": 0.8},
    "thalamic_n_pulses": {"kind": "thalamic_pulses", "start_ms": 0.5,
                          "interval_ms": 1.0, "duration_ms": 0.3,
                          "n_pulses": 2},
    "thalamic_unbounded": {"kind": "thalamic_pulses", "rate_hz": 90.0,
                           "start_ms": 0.2, "interval_ms": 0.7,
                           "duration_ms": 0.2},
    "poisson_window": {"kind": "poisson_background", "rate_hz": 12.0,
                       "t_start_ms": 0.4, "t_stop_ms": 1.1},
}
#: each spec's window edges, in steps
EDGES = {
    "dc_equivalent": (9, 10, 11),
    "dc_explicit": (4, 5, 24, 25),
    "step_current": (2, 3, 7, 8),
    "thalamic_n_pulses": (4, 5, 7, 8, 14, 15, 17, 18, 24, 25, 27, 28),
    "thalamic_unbounded": (1, 2, 3, 4, 8, 9, 10, 11, 16, 23),
    "poisson_window": (3, 4, 10, 11),
}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the suite runs several workers on a
    few cores, and each op's thread pool would fight the others' (a test
    of 0.8 s alone took minutes so)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def nets():
    return (jax_build_connectome(scale=SCALE, seed=SEED),
            build_connectome(scale=SCALE, seed=SEED))


def _compiled(spec, nets):
    c_jax, c = nets
    js = JS.Stimulus.from_dict(spec)
    ps = S.Stimulus.from_dict(spec)
    jcomp = js.compile(c_jax, JaxSimConfig(dt=DT), JaxNeuronParams())
    pcomp = ps.compile(c, SimConfig(dt=DT), NeuronParams())
    return jcomp, pcomp


@pytest.mark.parametrize("name", list(SPECS))
def test_drive_values_step_by_step(nets, name):
    jcomp, pcomp = _compiled(SPECS[name], nets)
    assert jcomp.channel == pcomp.channel
    assert jcomp.stochastic == pcomp.stochastic
    np.testing.assert_array_equal(pcomp.basis, jcomp.basis)
    assert pcomp.basis.dtype == np.float32
    steps = sorted(set(range(60)) | set(EDGES[name]))
    basis = torch.from_numpy(pcomp.basis)
    on_steps = []
    for t in steps:
        jg = np.asarray(jcomp.gate(jnp.int32(t)))
        pg = pcomp.gate(torch.tensor(t, dtype=torch.int32))
        assert pg.dtype == torch.float32 and pg.dim() == 0
        np.testing.assert_array_equal(pg.numpy(), jg, err_msg=f"t={t}")
        np.testing.assert_array_equal(
            (basis * pg).numpy(), np.asarray(jnp.asarray(jcomp.basis) * jg),
            err_msg=f"t={t}")
        if float(pg):
            on_steps.append(t)
    assert on_steps and len(on_steps) < len(steps)
    if name == "thalamic_n_pulses":       # two pulses of 3 steps
        assert on_steps == [5, 6, 7, 15, 16, 17]


@pytest.mark.parametrize("name", list(SPECS))
def test_drive_call_bitwise(nets, name):
    """``Drive`` at each step: the current bitwise; the draws whole numbers
    in float32, zero wherever the gate is off, and some nonzero where it is
    on."""
    c_jax, c = nets
    spec = SPECS[name]
    jdrive = JS.compile_drive((JS.Stimulus.from_dict(spec),), c_jax,
                              JaxSimConfig(dt=DT), JaxNeuronParams())
    pdrive = S.compile_drive((S.Stimulus.from_dict(spec),), c,
                             SimConfig(dt=DT), NeuronParams(), "cpu")
    gen = torch.Generator().manual_seed(3)
    _, pcomp = _compiled(spec, nets)
    drew = 0
    for t in sorted(set(range(40)) | set(EDGES[name])):
        keys = tuple(jax.random.split(jax.random.PRNGKey(t),
                                      jdrive.n_keys))
        j_cur, j_spk = jdrive(keys, jnp.int32(t), None)
        p_cur, p_spk = pdrive(gen, torch.tensor(t, dtype=torch.int32), None)
        assert (j_cur is None) == (p_cur is None)
        assert (j_spk is None) == (p_spk is None)
        if p_cur is not None:
            np.testing.assert_array_equal(p_cur.numpy(), np.asarray(j_cur),
                                          err_msg=f"t={t}")
        if p_spk is not None:
            assert p_spk.dtype == torch.float32
            assert torch.equal(p_spk, p_spk.round()), f"t={t}"
            if not float(pcomp.gate(torch.tensor(t, dtype=torch.int32))):
                assert not p_spk.any(), f"t={t}"
            drew += int(p_spk.sum())
    assert pcomp.channel == "current" or drew > 0


@pytest.mark.parametrize("name", list(SPECS))
def test_to_dict_from_dict(name):
    spec = SPECS[name]
    ps, js = S.Stimulus.from_dict(spec), JS.Stimulus.from_dict(spec)
    assert ps.to_dict() == js.to_dict()
    assert S.Stimulus.from_dict(ps.to_dict()) == ps
    assert JS.Stimulus.from_dict(ps.to_dict()) == js
    assert S.resolve_timeline(ps.to_dict()) == (ps,)


def test_registry_and_errors():
    assert S.available_stimuli() == JS.available_stimuli()
    tl = S.resolve_timeline(["poisson_background",
                             {"kind": "dc", "amplitude_pa": 10.0},
                             S.StepCurrent(amplitude_pa=1.0)])
    assert [type(s) for s in tl] == [S.PoissonBackground, S.DCInput,
                                     S.StepCurrent]
    with pytest.raises(ValueError, match="unknown stimulus kind"):
        S.resolve_timeline("nope")
    with pytest.raises(ValueError, match="unknown field"):
        S.resolve_timeline({"kind": "dc", "bogus": 1})
    with pytest.raises(ValueError, match="unknown population"):
        S.DCInput(amplitude_pa=1.0, populations=("L9E",)).compile(
            build_connectome(scale=0.01, seed=1), SimConfig(dt=DT),
            NeuronParams())
    with pytest.raises(TypeError):
        S.resolve_timeline([42])


def test_thalamic_indegrees_match():
    from repro.core.params import thalamic_indegrees as jax_indegrees
    for k in (1.0, 0.02, 0.3):
        np.testing.assert_array_equal(thalamic_indegrees(k),
                                      jax_indegrees(k))


# ---------------------------------------------------------------------------
# The whole loop under a deterministic drive
# ---------------------------------------------------------------------------

N_CARRY, N_STEPS = 30, 100
TIMELINE = ({"kind": "dc", "rate_hz": 8.0},
            {"kind": "step_current", "amplitude_pa": 300.0,
             "populations": ["L4E", "L4I", "L5E"], "t_start_ms": 1.0,
             "t_stop_ms": 8.0})


@pytest.fixture(autouse=True)
def _flush_subnormals_like_xla():
    assert torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)


def _arrays(net, st):
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


@pytest.mark.parametrize("mode", ["fused", "split"])
def test_deterministic_drive_loop_bitwise_vs_jax_eager(nets, mode):
    c_jax, _ = nets
    jtl = JS.resolve_timeline(TIMELINE)
    jcfg = jax_resolve(JaxSimConfig(strategy="ell", kernels="reference",
                                    stimulus=jtl), c_jax)
    jnet = jax_prepare_network(c_jax, jcfg)
    prop = JaxPropagators.make(JaxNeuronParams(), DT)
    drive = JS.compile_drive(jtl, c_jax, jcfg, JaxNeuronParams())
    st = jax_init_state(c_jax, jax.random.PRNGKey(9))
    spikes = []
    for i in range(N_CARRY + N_STEPS):
        if i == N_CARRY:
            start = _arrays(jnet, st)
        st, spk = jax_update_phase(st, jnet, prop, jcfg, c_jax.w_ext,
                                   c_jax.n_total, drive)
        st = jax_deliver_phase(st, jnet, jcfg, spk, c_jax.n_exc)
        spikes.append(np.asarray(spk))
    spikes = np.stack(spikes[N_CARRY:])
    assert spikes.sum() > 20 and np.abs(start["ring"]).sum() > 0

    # the counter crosses as a 0-d int32 tensor, and back as a 0-d array
    _, state = convert.to_torch(start, "cpu")
    assert state.t.dtype == torch.int32 and state.t.dim() == 0
    assert int(state.t) == N_CARRY
    back = convert.to_numpy(*convert.to_torch(start, "cpu"))["t"]
    assert back.dtype == np.int32 and back.shape == () and back == N_CARRY
    sim = Simulator(MicrocircuitConfig(scale=SCALE, strategy="ell",
                                       t_presim=0.0, seed=SEED),
                    kernels=mode, stimulus=TIMELINE,
                    spike_budget=jcfg.spike_budget,
                    probes=("spikes",), device="cpu")
    sim.state = state
    res = sim.run(N_STEPS * DT)
    np.testing.assert_array_equal(res["spikes"], spikes)
    got = convert.to_numpy(sim.backend.net, sim.state)
    want = _arrays(jnet, st)
    for key in ("V", "I_ex", "I_in", "refrac", "ring", "t", "overflow"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


# ---------------------------------------------------------------------------
# The sharded engine's view of a timeline: plan, padded bases, a rank's drive
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(SPECS))
def test_plan_and_padded_bases(nets, name):
    """``Drive.plan`` and ``padded_bases`` against the JAX package's, on the
    background followed by each built-in: the channels' bases in timeline
    order, bitwise; the gates off and on at the same steps; the padding
    zero; and a rank's ``Drive.shard`` holds the padded bases' slice in
    timeline order, with the same gates."""
    c_jax, c = nets
    timeline = ("poisson_background", SPECS[name])
    jdrive = JS.compile_drive(JS.resolve_timeline(timeline), c_jax,
                              JaxSimConfig(dt=DT), JaxNeuronParams())
    pdrive = S.compile_drive(timeline, c, SimConfig(dt=DT), NeuronParams(),
                             "cpu")
    assert pdrive.separable and jdrive.separable
    steps = sorted(set(range(30)) | set(EDGES[name]))
    for jrows, prows in zip(jdrive.plan(), pdrive.plan(), strict=True):
        assert len(jrows) == len(prows)
        for (jb, jg), (pb, pg) in zip(jrows, prows):
            np.testing.assert_array_equal(pb, jb)
            assert (jg is None) == (pg is None)
            for t in steps if pg is not None else ():
                np.testing.assert_array_equal(
                    pg(torch.tensor(t, dtype=torch.int32)).numpy(),
                    np.asarray(jg(jnp.int32(t))), err_msg=f"t={t}")
    n = c.n_total
    n_pad = n + 4
    for jb, pb in zip(jdrive.padded_bases(n_pad), pdrive.padded_bases(n_pad),
                      strict=True):
        assert pb.dtype == np.float32 and pb.shape == jb.shape
        assert pb.shape[1] == n_pad and not pb[:, n:].any()
        np.testing.assert_array_equal(pb, jb)
    rows = {ch: iter(b) for ch, b in zip(("spikes", "current"),
                                         pdrive.padded_bases(n_pad))}
    lo, hi = n_pad // 2, n_pad
    local = pdrive.shard(n_pad, lo, hi, "cpu")
    for s, basis, s_local in zip(pdrive.compiled, local.bases,
                                 local.compiled, strict=True):
        assert s_local is s
        np.testing.assert_array_equal(basis.numpy(),
                                      next(rows[s.channel])[lo:hi])


def test_plan_refuses_a_general_fn(nets):
    """A stimulus in the general ``fn`` form: both packages' ``plan`` (and
    the port's ``padded_bases`` and ``shard``) refuse it."""
    c_jax, c = nets

    @dataclasses.dataclass(frozen=True)
    class JaxKick(JS.Stimulus):
        def compile(self, c, cfg, neuron):
            return JS.CompiledStimulus(
                channel="current", fn=lambda key, t, state: (None, None))

    @dataclasses.dataclass(frozen=True)
    class Kick(S.Stimulus):
        def compile(self, c, cfg, neuron):
            return S.CompiledStimulus(
                channel="current", fn=lambda gen, t, state: (None, None))

    jdrive = JS.compile_drive((JS.PoissonBackground(), JaxKick()), c_jax,
                              JaxSimConfig(dt=DT), JaxNeuronParams())
    pdrive = S.compile_drive((S.PoissonBackground(), Kick()), c,
                             SimConfig(dt=DT), NeuronParams(), "cpu")
    assert not pdrive.separable and not jdrive.separable
    for call in (jdrive.plan, pdrive.plan,
                 lambda: pdrive.padded_bases(c.n_total),
                 lambda: pdrive.shard(c.n_total, 0, c.n_total, "cpu")):
        with pytest.raises(NotImplementedError,
                           match="separable stimuli only"):
            call()
