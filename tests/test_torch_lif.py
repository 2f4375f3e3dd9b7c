"""K1: the port's LIF update against the JAX package's.

Inputs are made with numpy from a seed and fed to both packages.  The
port's ``lif_step`` and the ``lif_update`` wrapper (on CPU tensors: its
plain version) must equal JAX's eager ``lif_step`` **bitwise**: both round
every product and sum on its own.  JAX's ``lif_update_pallas`` in
interpret mode is compiled by XLA, which contracts ``a * b + c`` into a
fused multiply-add on the CPU; against it the float outputs are held to
1 ulp (``assert_array_max_ulp``) and the discrete outputs (refractory
counter, spikes) exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.neuron import NeuronParams as JaxNeuronParams
from repro.core.neuron import NeuronState as JaxNeuronState
from repro.core.neuron import Propagators as JaxPropagators
from repro.core.neuron import lif_step as jax_lif_step
from repro.kernels.lif_update import lif_update_pallas
from repro_torch.core.neuron import NeuronState, Propagators, lif_step
from repro_torch.core.params import NeuronParams
from repro_torch.kernels import ops as kops
from repro_torch.kernels.lif_update import lif_update


def _inputs(seed, n, refrac_max, v_offset):
    rng = np.random.default_rng(seed)
    return dict(
        V=(rng.uniform(-80.0, -45.0, n) + v_offset).astype(np.float32),
        I_ex=(rng.uniform(0, 1, n) * 400).astype(np.float32),
        I_in=(-rng.uniform(0, 1, n) * 400).astype(np.float32),
        refrac=rng.integers(0, refrac_max + 1, n).astype(np.int32),
        in_ex=(rng.uniform(0, 1, n) * 100).astype(np.float32),
        in_in=(-rng.uniform(0, 1, n) * 100).astype(np.float32),
        i_dc=rng.uniform(-20.0, 20.0, n).astype(np.float32))


def _port(x, dt=0.1):
    prop = Propagators.make(NeuronParams(), dt)
    t = {k: torch.from_numpy(v.copy()) for k, v in x.items()}
    st, spk = lif_step(NeuronState(t["V"], t["I_ex"], t["I_in"],
                                   t["refrac"]),
                       prop, t["in_ex"], t["in_in"], t["i_dc"])
    return [a.numpy() for a in (*st, spk)]


def _jax_eager(x, dt=0.1):
    prop = JaxPropagators.make(JaxNeuronParams(), dt)
    j = {k: jnp.asarray(v) for k, v in x.items()}
    st, spk = jax_lif_step(JaxNeuronState(j["V"], j["I_ex"], j["I_in"],
                                          j["refrac"]),
                           prop, j["in_ex"], j["in_in"], j["i_dc"])
    return [np.asarray(a) for a in (*st, spk)]


CASES = [(0, 1, 0, 0.0), (1, 255, 2, 10.0), (2, 257, 1, 25.0),
         (3, 640, 20, 10.0), (4, 5003, 2, 10.0)]


@pytest.mark.parametrize("seed,n,refrac_max,v_offset", CASES)
def test_lif_step_bitwise_vs_jax_eager(seed, n, refrac_max, v_offset):
    x = _inputs(seed, n, refrac_max, v_offset)
    for a, b in zip(_port(x), _jax_eager(x)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed,n,refrac_max,v_offset", CASES)
def test_lif_step_vs_pallas_interpret(seed, n, refrac_max, v_offset):
    x = _inputs(seed, n, refrac_max, v_offset)
    want = lif_update_pallas(*(jnp.asarray(v) for v in x.values()),
                             prop=JaxPropagators.make(JaxNeuronParams(),
                                                      0.1),
                             interpret=True)
    got = _port(x)
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_array_max_ulp(a, np.asarray(b), maxulp=1)
    np.testing.assert_array_equal(got[3], np.asarray(want[3]))
    np.testing.assert_array_equal(got[4], np.asarray(want[4]))


@pytest.mark.parametrize("dt", [0.05, 0.1, 0.25])
def test_propagators_equal(dt):
    assert Propagators.make(NeuronParams(), dt).__dict__ == \
        JaxPropagators.make(JaxNeuronParams(), dt).__dict__


def test_refractory_edges():
    """refrac in {0, 1, 2} at and past threshold, as tests/test_kernels.py
    pins the Pallas kernel: refrac == 0 spikes and re-enters with the full
    period, refrac >= 1 never spikes and counts down."""
    x = dict(V=np.array([-49.0, -49.0, -49.0, -80.0], np.float32),
             I_ex=np.zeros(4, np.float32), I_in=np.zeros(4, np.float32),
             refrac=np.array([0, 1, 2, 0], np.int32),
             in_ex=np.full(4, 1e4, np.float32),
             in_in=np.zeros(4, np.float32), i_dc=np.zeros(4, np.float32))
    got, want = _port(x), _jax_eager(x)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    ref_steps = Propagators.make(NeuronParams(), 0.1).ref_steps
    np.testing.assert_array_equal(got[4], [True, False, False, False])
    np.testing.assert_array_equal(got[3], [ref_steps, 0, 1, 0])
    np.testing.assert_array_equal(got[0][:3], [-65.0, -65.0, -65.0])


def test_wrappers_take_plain_version_on_cpu():
    """On CPU tensors the K1 wrappers run the plain version (bitwise the
    same as ``lif_step``) and count no launch."""
    from repro_torch.kernels import _build
    x = _inputs(5, 300, 2, 10.0)
    t = {k: torch.from_numpy(v.copy()) for k, v in x.items()}
    prop = Propagators.make(NeuronParams(), 0.1)
    before = dict(_build.launches)
    raw = lif_update(*t.values(), prop=prop)
    st, spk = kops.lif_update(NeuronState(t["V"], t["I_ex"], t["I_in"],
                                          t["refrac"]),
                              prop, t["in_ex"], t["in_in"], t["i_dc"])
    want = _port(x)
    for a, b, c in zip(raw, (*st, spk), want):
        np.testing.assert_array_equal(a.numpy(), c)
        np.testing.assert_array_equal(b.numpy(), c)
    assert _build.launches == before
