"""The whole slice: the port's ``Simulator`` against the JAX package.

Scale 0.02, ``ell`` strategy, a 2 ms presim and a 10 ms run (120 steps).

1. A jitted JAX ``Simulator(kernels="reference")`` runs 100 ms from a
   fresh state, which leaves spikes in flight in the ring (from a fresh
   state 120 steps hold too few spikes to exercise delivery).
2. Its tables and ``SimState`` are carried through ``repro_torch.convert``
   into the port's ``Simulator(device="cpu")``, whose presim then runs
   from the carried state.
3. Both packages get the same per-step external spike counts, made with
   numpy from a seed: the port through a general-``fn`` stimulus, JAX
   through a replay object with ``n_keys = 0`` given as ``drive``.
4. JAX loops **eagerly** over ``update_phase`` + ``deliver_phase`` (jitted
   JAX contracts multiply-adds into FMAs on the CPU and differs in about
   2 % of V; eager JAX rounds every op, as the port does).

Tolerance: none.  The ``spikes`` and ``pop_counts`` rasters and the final
state are compared bitwise, for the port in ``fused``, ``split`` and
``reference`` modes.  XLA's CPU backend flushes subnormal floats to zero
and PyTorch's does not, so a synaptic current decaying below 1.2e-38 pA
would differ by a subnormal; the port's runs here flush them too
(``torch.set_flush_denormal``), restored after each test.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api.simulator import Simulator as JaxSimulator
from repro.configs.microcircuit import MicrocircuitConfig as JaxConfig
from repro.core.engine import deliver_phase as jax_deliver_phase
from repro.core.engine import update_phase as jax_update_phase
from repro_torch import convert
from repro_torch.api import Simulator
from repro_torch.configs.microcircuit import SMOKE, MicrocircuitConfig
from repro_torch.core import stimulus as tstim

SCALE, PRESIM_MS, RUN_MS, DT = 0.02, 2.0, 10.0, 0.1
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


class _JaxReplay:
    """The JAX ``Drive`` protocol over the same counts (no PRNG key)."""
    n_keys = 0

    def __init__(self, counts, t0):
        self.counts, self.t0 = counts, t0

    def __call__(self, subkeys, t_step, state):
        return None, jnp.asarray(self.counts[int(t_step) - self.t0])


@pytest.fixture(autouse=True)
def _flush_subnormals_like_xla():
    assert torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)


def _jax_arrays(net, st):
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
def reference():
    """The carried JAX state, the counts, and the eager JAX trajectory."""
    sim = JaxSimulator(JaxConfig(scale=SCALE, strategy="ell", t_presim=0.0),
                       kernels="reference")
    sim.run(100.0)
    b, st = sim.backend, sim.state
    start = _jax_arrays(b.net, st)
    c, t0 = b.c, int(st.t)
    basis = np.asarray(c.k_ext, np.float32) * np.float32(8.0 * DT * 1e-3)
    counts = np.random.default_rng(2024).poisson(
        basis, size=(N_PRESIM + N_RUN, c.n_total)).astype(np.int32)
    drive = _JaxReplay(counts, t0)
    spikes = []
    for _ in range(N_PRESIM + N_RUN):
        st, spk = jax_update_phase(st, b.net, b.prop, b.cfg, c.w_ext,
                                   c.n_total, drive)
        st = jax_deliver_phase(st, b.net, b.cfg, spk, c.n_exc)
        spikes.append(np.asarray(spk))
    spikes = np.stack(spikes)[N_PRESIM:]
    return dict(start=start, counts=counts, t0=t0, spikes=spikes,
                pop_of=np.asarray(c.pop_of), budget=b.cfg.spike_budget,
                final=_jax_arrays(b.net, st))


def test_carried_state_has_spikes_in_flight(reference):
    assert np.abs(reference["start"]["ring"]).sum() > 0
    assert reference["spikes"].sum() > 20


@pytest.mark.parametrize("mode", ["fused", "split", "reference"])
def test_simulator_bitwise_vs_jax_eager(reference, mode):
    ref = reference
    net, state = convert.to_torch(ref["start"], "cpu")
    stim = _Replay(counts=torch.from_numpy(ref["counts"]), t0=ref["t0"])
    sim = Simulator(MicrocircuitConfig(scale=SCALE, strategy="ell",
                                       t_presim=PRESIM_MS),
                    kernels=mode, stimulus=(stim,),
                    probes=("pop_counts", "spikes"), device="cpu")
    assert sim.sim_config.kernels.step == ("fused" if mode == "fused"
                                           else "split")
    assert sim.sim_config.spike_budget == ref["budget"]
    for name in ("targets", "weights", "dbins"):
        assert torch.equal(getattr(sim.backend.net.tables, name),
                           getattr(net.tables, name)), name
    assert torch.equal(sim.backend.net.pop_of, net.pop_of)
    sim.state = state
    sim.warmup(RUN_MS)                            # leaves the state alone
    res = sim.run(RUN_MS)
    assert res.n_steps == N_RUN and res.overflow == 0
    np.testing.assert_array_equal(res["spikes"], ref["spikes"])
    want_counts = np.zeros((N_RUN, 8), np.int32)
    for p in range(8):
        want_counts[:, p] = ref["spikes"][:, ref["pop_of"] == p].sum(1)
    np.testing.assert_array_equal(res["pop_counts"], want_counts)
    got = convert.to_numpy(sim.backend.net, sim.state)
    for key in ("V", "I_ex", "I_in", "refrac", "ring", "t", "overflow"):
        np.testing.assert_array_equal(got[key], ref["final"][key],
                                      err_msg=key)


def test_convert_round_trip(reference):
    start = reference["start"]
    back = convert.to_numpy(*convert.to_torch(start, "cpu"))
    assert set(back) == set(convert.KEYS)
    for key in convert.KEYS:
        np.testing.assert_array_equal(back[key], start[key], err_msg=key)
    with pytest.raises(KeyError, match="ring"):
        convert.to_torch({k: v for k, v in start.items() if k != "ring"},
                         "cpu")


def test_default_drive_runs_on_cpu_and_modes_agree():
    """The paper's Poisson drive from the session's generator: the fused
    and reference paths draw the same counts and give the same raster."""
    out = {}
    for mode in ("fused", "reference"):
        sim = Simulator(dataclasses.replace(SMOKE, strategy="ell",
                                            t_presim=5.0),
                        kernels=mode, probes=("spikes", "pop_counts",
                                              "total_counts"),
                        device="cpu")
        res = sim.run(10.0)
        assert res.device == "cpu" and res.rtf > 0 and res.overflow == 0
        rates = res.summary()["rates_hz"]
        assert rates.shape == (8,) and np.isfinite(rates).all()
        np.testing.assert_array_equal(res["total_counts"],
                                      res["spikes"].sum(1))
        out[mode] = (res["spikes"], sim.state.neuron.V.numpy())
    np.testing.assert_array_equal(out["fused"][0], out["reference"][0])
    np.testing.assert_array_equal(out["fused"][1], out["reference"][1])


def test_simulator_without_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Simulator(SMOKE)
