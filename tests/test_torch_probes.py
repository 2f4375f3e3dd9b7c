"""The port's probes, stream carries and raster statistics against the JAX
package's, on the CPU, from the same seeded numpy inputs.

* ``pop_counts`` (a running count differenced at the populations' bounds)
  against the reference's sorted ``segment_sum``, on the scale-0.02
  network's ``pop_of``, on ``pop_counts_cases``' layouts (PD14's
  full-scale sizes at four densities, empty and single populations,
  bounds off 16-byte alignment, a sharded registry's spiking tail) and on
  one with an empty population: bitwise.  The card's kernel is held to the
  plain version on the same cases (``test_torch_pop_counts_card.py``).
  On the CPU the probe takes the plain version and launches nothing; the
  kernel's wrapper raises before a launch on a wrong input, and the
  ``reference`` policy takes the plain version on any device.
* The ``spike_stats`` carry (``validate.stats.update_carry``) after 137
  steps of a random raster (bins of 5 closing, neurons that never spike):
  every field bitwise.
* The ``weight_stats`` carry after 6 steps of changing weights: the step
  count, min and max exact; mean and std within rtol 1e-6 (both sum
  float32 in their own order).
* ``recording.spike_trains``, ``cv_isi`` and ``pairwise_correlation`` on
  a raster: equal to the reference's.
"""
import sys
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import probes as JPR
from repro.core import recording as JREC
from repro.core.connectivity import build_connectome as jax_build_connectome
from repro.core.plasticity import PlasticState as JaxPlasticState
from repro.validate import stats as JVS
from repro_torch.api import probes as PR
from repro_torch.core import recording as REC
from repro_torch.core.plasticity import PlasticState
from repro_torch.kernels import _build
from repro_torch.kernels import pop_counts as KP
from repro_torch.perf import trace
from repro_torch.validate import stats as VS

sys.path.insert(0, str(Path(__file__).resolve().parent))
import pop_counts_cases  # noqa: E402


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the suite runs several workers on a
    few cores, and each op's thread pool would fight the others' (a test
    of 0.8 s alone took minutes so)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Net:
    def __init__(self, pop_of):
        self.pop_of = pop_of


def _pop_counts_pair(pop_of: np.ndarray, spiked: np.ndarray, n_pops: int):
    jctx = JPR.ProbeContext(None, jnp.asarray(spiked),
                            _Net(jnp.asarray(pop_of)), n_pops)
    pctx = PR.ProbeContext(None, torch.from_numpy(spiked),
                           _Net(torch.from_numpy(pop_of)), n_pops)
    return (np.asarray(JPR.pop_counts()(jctx)),
            PR.pop_counts()(pctx).numpy())


@pytest.mark.parametrize("density", [
    *(pytest.param(d, id=str(d)) for d in (0.0, 0.01, 0.3, 1.0)),
    *pop_counts_cases.CASES])
def test_pop_counts_segment_sum_bitwise(density):
    """A density on the scale-0.02 network, or a case of
    ``pop_counts_cases`` by name."""
    if isinstance(density, str):
        before = _build.launches["pop_counts"]
        for seed in range(3):
            pop_of, spiked, n_pops, _ = pop_counts_cases.case(density, seed)
            want, got = _pop_counts_pair(pop_of, spiked, n_pops)
            assert got.dtype == np.int32 and got.shape == (n_pops,)
            np.testing.assert_array_equal(got, want)
        assert _build.launches["pop_counts"] == before
        return
    c = jax_build_connectome(scale=0.02, seed=55)
    pop_of = np.asarray(c.pop_of, np.int32)
    rng = np.random.default_rng(int(density * 100))
    for _ in range(5):
        spiked = rng.random(pop_of.size) < density
        want, got = _pop_counts_pair(pop_of, spiked, 8)
        assert got.dtype == np.int32 and got.shape == (8,)
        np.testing.assert_array_equal(got, want)


def test_pop_counts_with_an_empty_population():
    pop_of = np.repeat(np.array([1, 2, 2, 4, 7], np.int32), [3, 5, 1, 4, 2])
    rng = np.random.default_rng(7)
    probe = PR.pop_counts()
    for _ in range(4):
        spiked = rng.random(pop_of.size) < 0.5
        want, got = _pop_counts_pair(pop_of, spiked, 8)
        np.testing.assert_array_equal(got, want)
        assert got[0] == got[3] == got[5] == got[6] == 0
    # the bounds are kept by the probe instance, per pop_of
    ctx = PR.ProbeContext(None, torch.ones(pop_of.size, dtype=torch.bool),
                          _Net(torch.from_numpy(pop_of)), 8)
    assert probe(ctx).tolist() == [0, 3, 6, 0, 4, 0, 0, 2]


def test_pop_counts_on_the_cpu_launches_nothing():
    """A CPU spike vector takes the plain version, whatever the policy,
    and adds no ``launches.pop_counts``."""
    pop_of, spiked, n_pops, _ = pop_counts_cases.case("pd14_density_0.02")
    net = _Net(torch.from_numpy(pop_of))
    probe = PR.pop_counts()
    before = trace.counters()["launches.pop_counts"]
    got = [probe(PR.ProbeContext(None, torch.from_numpy(spiked), net,
                                 n_pops, kernels=k)) for k in (True, False)]
    assert trace.counters()["launches.pop_counts"] == before
    assert torch.equal(got[0], got[1]) and got[0].dtype == torch.int32


def test_pop_counts_kernel_is_counted():
    """``KERNELS`` lists the kernel in its own library, and
    ``trace.counters()`` reports its launches."""
    assert _build.KERNELS["pop_counts"] == ("pop_counts",)
    assert _build.SOURCES["pop_counts"] == "pop_counts.cu"
    assert (_build.CSRC / "pop_counts.cu").exists()
    _build.launches["pop_counts"] += 2
    try:
        assert trace.counters()["launches.pop_counts"] \
            == _build.launches["pop_counts"]
    finally:
        _build.launches["pop_counts"] -= 2


@pytest.fixture
def kernel_on_meta(monkeypatch):
    """``meta`` tensors stand for CUDA ones: the wrapper takes them as on
    the card, and a stub library records each launch's arguments."""
    calls = []

    def launch(*args):
        calls.append(args)
        return 0

    monkeypatch.setattr(KP, "DEVICE_TYPE", "meta")
    monkeypatch.setattr(_build, "library", lambda name: types.SimpleNamespace(
        pop_counts_launch=launch, kernel_error_string=lambda code: b"stub"))
    monkeypatch.setattr(_build, "stream_of", lambda t: None)
    return calls


def _meta(n, dtype):
    return torch.empty(n, dtype=dtype, device="meta")


def test_pop_counts_probe_launches_once_a_step(kernel_on_meta):
    """Off the CPU the probe is one launch a step, with int32 bounds and
    ``n_pops`` blocks, into an int32 ``[n_pops]`` output; under the
    ``reference`` policy (``kernels=False``) it launches nothing."""
    net = _Net(_meta(100, torch.int32))
    probe = PR.pop_counts()
    before = _build.launches["pop_counts"]
    for step in range(3):
        out = probe(PR.ProbeContext(None, _meta(100, torch.bool), net, 8))
        assert out.shape == (8,) and out.dtype == torch.int32
        assert _build.launches["pop_counts"] == before + step + 1
    assert [a[3].value for a in kernel_on_meta] == [8] * 3
    out = probe(PR.ProbeContext(None, _meta(100, torch.bool), net, 8,
                                kernels=False))
    assert out.shape == (8,) and out.dtype == torch.int32
    assert _build.launches["pop_counts"] == before + 3
    assert len(kernel_on_meta) == 3


@pytest.mark.parametrize("case,exc,match", [
    ("uint8_spikes", TypeError, "bool spike vector"),
    ("int64_bounds", TypeError, "int32 bounds"),
    ("strided_spikes", ValueError, "contiguous"),
    ("strided_bounds", ValueError, "contiguous"),
    ("cpu_bounds", ValueError, "CUDA device"),
    ("no_bounds", ValueError, r"\[n_pops \+ 1\] bounds"),
])
def test_pop_counts_wrapper_guards(kernel_on_meta, case, exc, match):
    """The wrapper raises before any launch on a wrong input."""
    spiked = _meta(100 if case != "strided_spikes" else 200,
                   torch.uint8 if case == "uint8_spikes" else torch.bool)
    at = {"int64_bounds": _meta(9, torch.int64),
          "strided_bounds": _meta(18, torch.int32)[::2],
          "cpu_bounds": torch.zeros(9, dtype=torch.int32),
          "no_bounds": _meta(0, torch.int32)}.get(
              case, _meta(9, torch.int32))
    if case == "strided_spikes":
        spiked = spiked[::2]
    before = _build.launches["pop_counts"]
    with pytest.raises(exc, match=match):
        KP.pop_counts(spiked, at)
    assert _build.launches["pop_counts"] == before and not kernel_on_meta


def test_spike_stats_carry_bitwise():
    ns, bin_steps, steps = 23, 5, 137
    rng = np.random.default_rng(11)
    rates = rng.uniform(0.0, 0.3, ns)
    rates[[0, 7]] = 0.0                       # never spike
    raster = rng.random((steps, ns)) < rates
    jc, pc = JVS.init_carry(ns), VS.init_carry(ns)
    for row in raster:
        jc = JVS.update_carry(jc, jnp.asarray(row), bin_steps=bin_steps)
        pc = VS.update_carry(pc, torch.from_numpy(row), bin_steps=bin_steps)
    assert pc._fields == jc._fields
    for name, a, b in zip(pc._fields, pc, jc):
        assert a.numpy().dtype == np.asarray(b).dtype, name
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                      err_msg=name)
    assert int(pc.n_bins) == steps // bin_steps


def test_spike_stats_probe_samples_its_ids():
    ids = np.array([3, 0, 9, 4])
    probe = PR.spike_stats(ids, bin_steps=2)
    assert PR.spike_stats(ids, bin_steps=2) is probe        # interned
    assert PR.spike_stats(ids, bin_steps=3) is not probe
    spiked = torch.zeros(12, dtype=torch.bool)
    spiked[[0, 4, 5]] = True
    carry = probe.update(probe.init(), spiked)
    assert carry.n_spikes.tolist() == [0, 1, 0, 1]
    assert probe.meta["bin_steps"] == 2


def test_weight_stats_carry():
    rows, k, steps = 40, 16, 6
    rng = np.random.default_rng(5)
    mask = rng.random((rows, k)) < 0.4
    jprobe, pprobe = JPR.weight_stats(), PR.weight_stats()
    jc, pc = jprobe.init(), pprobe.init()
    for _ in range(steps):
        w = rng.uniform(0.0, 90.0, (rows, k)).astype(np.float32)
        jflat = np.concatenate([w.reshape(-1), np.zeros(1, np.float32)])
        jctx = JPR.ProbeContext(None, None, None, 8,
                                plastic=JaxPlasticState(jnp.asarray(jflat),
                                                        None, None),
                                plastic_mask=jnp.asarray(mask.reshape(-1)))
        pctx = PR.ProbeContext(None, None, None, 8,
                               plastic=PlasticState(torch.from_numpy(w),
                                                    None, None),
                               plastic_mask=torch.from_numpy(mask))
        jc, pc = jprobe.update(jc, jctx), pprobe.update(pc, pctx)
    assert set(pc) == set(jc) and int(pc["steps"]) == steps
    for name in ("steps", "min", "max"):
        np.testing.assert_array_equal(pc[name].numpy(), np.asarray(jc[name]),
                                      err_msg=name)
    for name in ("mean", "std"):
        np.testing.assert_allclose(pc[name].numpy(), np.asarray(jc[name]),
                                   rtol=1e-6, err_msg=name)
    with pytest.raises(ValueError, match="plasticity"):
        pprobe.update(pc, torch.zeros(3, dtype=torch.bool))


def test_probe_interning_and_split():
    a, b = PR.resolve(("pop_counts", "spikes")), PR.resolve(("pop_counts",))
    assert a[0] is b[0]
    s = PR.spike_stats(np.arange(4))
    step, stream = PR.split_probes((*a, s))
    assert step == a and stream == (s,)
    with pytest.raises(ValueError, match="duplicate"):
        PR.resolve(("spikes", "spikes"))
    probe = PR.custom("v0", lambda ctx: ctx.spiked[:1])
    assert probe(PR.ProbeContext(None, torch.ones(3, dtype=torch.bool),
                                 None, 8)).tolist() == [True]


@pytest.fixture(scope="module")
def raster():
    rng = np.random.default_rng(2024)
    rates = rng.uniform(0.0, 0.08, 60)
    rates[:3] = 0.0
    rates[3] = 0.002                          # fewer than 3 spikes
    shared = rng.random((400, 1)) < 0.03      # some correlation
    return (rng.random((400, 60)) < rates) | (shared & (rates > 0.04))


def test_spike_trains(raster):
    for got, want in zip(REC.spike_trains(raster), JREC.spike_trains(raster),
                         strict=True):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("min_spikes", [2, 3, 10])
def test_cv_isi_equals_reference(raster, min_spikes):
    got = REC.cv_isi(raster, min_spikes=min_spikes)
    assert got == JREC.cv_isi(raster, min_spikes=min_spikes)
    assert np.isfinite(got)
    assert np.isnan(REC.cv_isi(np.zeros((50, 4), bool)))


@pytest.mark.parametrize("bin_steps", [1, 7, 20, 250])
def test_pairwise_correlation_equals_reference(raster, bin_steps):
    got = REC.pairwise_correlation(raster, bin_steps=bin_steps)
    want = JREC.pairwise_correlation(raster, bin_steps=bin_steps)
    if np.isnan(want):
        assert np.isnan(got) and bin_steps > 200
    else:
        assert got == want
