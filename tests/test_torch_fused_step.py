"""K3: the port's fused step against the JAX package's phase-split step,
and the port's kernel policy.

One call of the port's ``lif_deliver`` (on CPU tensors: its plain
version) delivers the previous step's spikes at phase ``t - 1`` and
integrates step ``t``.  It must equal JAX's eager ``deliver_phase(t - 1)``
followed by ``update_phase(t)`` under ``kernels="reference"`` **bitwise**:
ring, V, currents, refractory counters, spikes and overflow.  (The JAX
package's own fused kernel cannot serve: ``pl.load`` is gone from jax
0.9.0.)  Inputs: the scale-0.02 microcircuit's ``ell`` tables and a random
state made with numpy from a seed; the external drive is a fixed array of
spike counts handed to both packages.
"""
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
from repro_torch.core import kernel_policy as kpol
from repro_torch.core import stimulus as tstim
from repro_torch.core.connectivity import build_connectome as port_build
from repro_torch.core.engine import SimConfig, SimState, fused_update_phase
from repro_torch.core.engine import prepare_network, resolve_sim_config
from repro_torch.core.neuron import NeuronState, Propagators
from repro_torch.core.params import NeuronParams
from repro_torch.kernels import ops as kops
from repro_torch.kernels.lif_deliver import lif_deliver

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
    t = {k: torch.from_numpy(np.array(v, copy=True)) for k, v in x.items()}
    ext_ex = c.w_ext * t["counts"].to(torch.float32)   # engine's op order
    return t, ext_ex


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
    p, ext_ex = _port_inputs(c, x)
    tb = pnet.tables
    out = lif_deliver(p["ring"], tb.targets, tb.weights, tb.dbins,
                      p["spiked_prev"], p["V"], p["I_ex"], p["I_in"],
                      p["refrac"], ext_ex, pnet.i_dc,
                      torch.tensor(t, dtype=torch.int32), n_exc=c.n_exc,
                      budget=BUDGET, prop=Propagators.make(NeuronParams(),
                                                           0.1))
    ring, V, I_ex, I_in, refrac, spiked, ids, ovf = out
    got = [a.numpy() for a in (ring, V, I_ex, I_in, refrac, spiked, ovf)]
    for name, a, b in zip(("ring", "V", "I_ex", "I_in", "refrac",
                           "spiked", "overflow"), got, want):
        np.testing.assert_array_equal(a, b, err_msg=name)
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
    takes it too: both deliver at ``t - 1``) and returns ``(neuron', ring,
    spiked, overflow)``."""
    c_jax, jcfg, jnet, c, pcfg, pnet = net
    x = _state(c, seed=5, n_spikes=10)
    p, ext_ex = _port_inputs(c, x)
    prop = Propagators.make(NeuronParams(), 0.1)
    t = torch.tensor(41, dtype=torch.int32)
    a = kops.lif_deliver(
        NeuronState(p["V"], p["I_ex"], p["I_in"], p["refrac"]),
        p["ring"].clone(), t, p["spiked_prev"], pnet.tables, prop, ext_ex,
        pnet.i_dc, n_exc=c.n_exc, spike_budget=BUDGET)
    b = lif_deliver(p["ring"].clone(), *pnet.tables, p["spiked_prev"],
                    p["V"], p["I_ex"], p["I_in"], p["refrac"], ext_ex,
                    pnet.i_dc, t, n_exc=c.n_exc, budget=BUDGET, prop=prop)
    for u, v in zip((*a[0], a[1], a[2], a[3]),
                    (b[1], b[2], b[3], b[4], b[0], b[5], b[7])):
        assert torch.equal(u, v)


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
