"""K5 and the dense strategy: the port against the JAX package.

Inputs are made with numpy from a seed and handed to both packages.

* The tables: the port's numpy ``dense_delay_binned`` and its PyTorch
  ``dense_table`` (both layouts) ``array_equal`` to the reference's
  ``dense_delay_binned`` on a scale-0.01 connectome with a cell of three
  multapses (their sum depends on the order), and the strategy's
  ``prepare`` to JAX's ``DenseDelivery.prepare`` in each layout.
* K5's plain version (what the wrapper runs on CPU tensors) against JAX's
  ``gated_spike_matvec_pallas(interpret=True)`` and
  ``gated_spike_matvec_ref`` at the shapes of ``tests/test_kernels.py``:
  float32 within 1e-5, bfloat16 within 2e-2 (that test's tolerances: the
  Pallas kernel sums in another order).
* One-step rings of both layouts against JAX's dense delivery within
  ``rtol=1e-6, atol=1e-4`` (``tests/test_delivery.py``: the einsum, the
  GEMM and the sequential sum order the adds differently).
* The guards (the byte cap, the layout mismatch, ``fused`` and plasticity
  with ``dense``) and the policy table.
* The whole ``Simulator`` at scale 0.02 for 100 steps from a carried
  state, with the same Poisson counts, against JAX's eager dense loop:
  bitwise.  Each spike vector is 0/1, so every product is exact, and the
  sums agree whatever their order unless three or more spikes meet in
  one cell; at this size none do.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api.simulator import Simulator as JaxSimulator
from repro.configs.microcircuit import MicrocircuitConfig as JaxConfig
from repro.core import delivery as jdlv
from repro.core.connectivity import build_connectome as jax_build
from repro.core.connectivity import dense_delay_binned as jax_dense
from repro.core.engine import SimConfig as JaxSimConfig
from repro.core.engine import deliver_phase as jax_deliver_phase
from repro.core.engine import resolve_sim_config as jax_resolve
from repro.core.engine import update_phase as jax_update_phase
from repro.core.kernel_policy import KernelPolicy
from repro.kernels import ref as jref
from repro.kernels.spike_deliver import gated_spike_matvec_pallas
from repro_torch import convert
from repro_torch.api import Simulator
from repro_torch.configs.microcircuit import MicrocircuitConfig
from repro_torch.core import connectivity as tconn
from repro_torch.core import delivery as tdlv
from repro_torch.core import kernel_policy as tpol
from repro_torch.core.engine import (SimConfig, prepare_network,
                                     resolve_sim_config)
from repro_torch.kernels import ops as kops

from test_torch_simulator import _JaxReplay, _Replay, _jax_arrays

CPU = torch.device("cpu")
BUDGET = 128
T_STEP = 1234


def _cell_counts(c):
    """Multapses per (delay bin, pre, post) cell of the real entries."""
    n = c.n_total
    rows = np.broadcast_to(np.arange(n)[:, None], c.targets.shape)
    real = c.targets < n
    key = (c.dbins[real].astype(np.int64) * n + rows[real]) * n \
        + c.targets[real]
    return np.unique(key, return_counts=True)[1]


def _with_triple(c):
    """``c``, or ``c`` with three entries of its fullest row moved into one
    cell when no cell holds three multapses."""
    if _cell_counts(c).max() >= 3:
        return c
    row = int(np.argmax(c.out_degree))
    tg, db = c.targets.copy(), c.dbins.copy()
    tg[row, 1:3], db[row, 1:3] = tg[row, 0], db[row, 0]
    return dataclasses.replace(c, targets=tg, dbins=db)


@pytest.fixture(scope="module")
def conn():
    cp = _with_triple(tconn.build_connectome(scale=0.01, seed=55))
    cj = _with_triple(jax_build(scale=0.01, seed=55))
    assert _cell_counts(cp).max() >= 3
    np.testing.assert_array_equal(cp.targets, cj.targets)
    return cp, cj


def _jax_cfg(c, bin_major):
    kernels = KernelPolicy(deliver="pallas") if bin_major else None
    return jax_resolve(JaxSimConfig(strategy="dense", spike_budget=BUDGET,
                                    kernels=kernels), c)


def _port_cfg(c, mode):
    return resolve_sim_config(
        SimConfig(strategy="dense", spike_budget=BUDGET, kernels=mode), c,
        CPU)


@pytest.fixture(scope="module")
def tables(conn):
    """{layout: (JAX tables, JAX cfg, port tables, port cfg)}."""
    cp, cj = conn
    out = {}
    for layout, mode in (("bin", "split"), ("source", "reference")):
        jcfg, pcfg = _jax_cfg(cj, layout == "bin"), _port_cfg(cp, mode)
        out[layout] = (jdlv.get_strategy("dense").prepare(cj, jcfg), jcfg,
                       tdlv.get_strategy("dense").prepare(cp, pcfg, CPU),
                       pcfg)
    return out


def test_dense_tables_equal_the_reference(conn):
    cp, cj = conn
    want = jax_dense(cj)
    n = cp.n_total
    np.testing.assert_array_equal(tconn.dense_delay_binned(cp), want)
    np.testing.assert_array_equal(tconn.dense_table(cp, CPU).numpy(), want)
    np.testing.assert_array_equal(
        tconn.dense_table(cp, CPU, source_major=True).numpy(),
        want.transpose(1, 0, 2).reshape(n, -1))


@pytest.mark.parametrize("layout", ["bin", "source"])
def test_prepare_equals_jax_prepare(conn, tables, layout):
    cp, _ = conn
    jt, _, pt, _ = tables[layout]
    assert tdlv.get_strategy("dense").memory_bytes(cp) == sum(
        x.numel() * x.element_size() for x in pt if x is not None)
    if layout == "bin":
        assert pt.W_ex is None and pt.W_in is None
        np.testing.assert_array_equal(pt.W.numpy(), np.asarray(jt.W))
    else:
        assert pt.W is None
        assert pt.W_ex.shape == (cp.n_exc, cp.d_max_bins * cp.n_total)
        np.testing.assert_array_equal(pt.W_ex.numpy(), np.asarray(jt.W_ex))
        np.testing.assert_array_equal(pt.W_in.numpy(), np.asarray(jt.W_in))


def test_prepare_network_dense_dtype(conn):
    """``dense_dtype`` reaches the dense table (as the reference's
    ``jnp.asarray(W, dtype)``: the float32 table rounded) and nothing
    else."""
    cp, _ = conn
    cfg = _port_cfg(cp, "split")
    net = prepare_network(cp, cfg, CPU, dense_dtype=torch.bfloat16)
    want = tconn.dense_table(cp, CPU).to(torch.bfloat16)
    assert net.tables.W.dtype == torch.bfloat16
    assert torch.equal(net.tables.W, want)
    ell = prepare_network(cp, SimConfig(strategy="ell"), CPU,
                          dense_dtype=torch.bfloat16)
    assert ell.tables.weights.dtype == torch.float32


# ------------------------------------------------------------ K5 itself
SHAPES = [(1, 64, 64), (3, 500, 700), (5, 1024, 513), (2, 2000, 256)]


def _both(W, dtype):
    """``W`` as the port's and JAX's tensor of ``dtype``; both round the
    float32 values to bfloat16 to nearest even, so the bits agree."""
    wt, wj = torch.from_numpy(W), jnp.asarray(W)
    if dtype == "bfloat16":
        wt, wj = wt.to(torch.bfloat16), wj.astype(jnp.bfloat16)
        np.testing.assert_array_equal(wt.float().numpy(),
                                      np.asarray(wj.astype(jnp.float32)))
    return wt, wj


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gated_spike_matvec_vs_jax(shape, dtype):
    rng = np.random.default_rng(sum(shape))
    W = rng.normal(size=shape).astype(np.float32)
    s = (rng.uniform(size=shape[1]) < 0.02).astype(np.float32)
    wt, wj = _both(W, dtype)
    got = kops.gated_spike_matvec(torch.from_numpy(s), wt)
    assert got.dtype == torch.float32 and got.shape == (shape[0], shape[2])
    tol = 1e-5 if dtype == "float32" else 2e-2
    for want in (gated_spike_matvec_pallas(jnp.asarray(s), wj,
                                           interpret=True),
                 jref.gated_spike_matvec_ref(jnp.asarray(s), wj)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                                   atol=tol)


@pytest.mark.parametrize("fill", [0.0, 1.0], ids=["all_zero", "all_one"])
def test_gated_spike_matvec_extremes(fill):
    W = np.random.default_rng(2).normal(size=(2, 512, 256)).astype(
        np.float32)
    s = np.full(512, fill, np.float32)
    got = kops.gated_spike_matvec(torch.from_numpy(s),
                                  torch.from_numpy(W)).numpy()
    if fill == 0.0:
        np.testing.assert_array_equal(got, 0.0)
    for want in (gated_spike_matvec_pallas(jnp.asarray(s), jnp.asarray(W),
                                           interpret=True),
                 jref.gated_spike_matvec_ref(jnp.asarray(s),
                                             jnp.asarray(W))):
        np.testing.assert_allclose(got, np.asarray(want), rtol=2e-5,
                                   atol=2e-5)


# ------------------------------------------------------- one-step rings
COUNTS = {"zero": 0, "one": 1, "over_budget": BUDGET + 72}


def _spiked(n, k, seed):
    s = np.zeros(n, bool)
    s[np.random.default_rng(seed).choice(n, size=k, replace=False)] = True
    return s


def _ring(c, seed):
    shape = (c.d_max_bins, 2, c.n_total + 1)
    rng = np.random.default_rng(seed)
    r = np.zeros(shape, np.float32)
    r[:, 0] = rng.uniform(0, 50, shape[::2])
    r[:, 1] = -rng.uniform(0, 50, shape[::2])
    return r


@pytest.mark.parametrize("layout", ["bin", "source"])
@pytest.mark.parametrize("case", list(COUNTS))
def test_one_step_ring_vs_jax(conn, tables, layout, case):
    """The bin-major layout against JAX's K5 path (Pallas in interpret
    mode), the source-major one against JAX's GEMM path; more spikes than
    ``spike_budget`` are all delivered, with overflow 0."""
    cp, cj = conn
    jt, jcfg, pt, pcfg = tables[layout]
    spiked = _spiked(cp.n_total, COUNTS[case], seed=len(case))
    ring = _ring(cp, seed=11)
    want, want_ovf = jdlv.get_strategy("dense").deliver(
        jnp.asarray(ring), jt, jnp.asarray(spiked), jnp.int32(T_STEP),
        cj.n_exc, jcfg)
    r = torch.from_numpy(ring.copy())
    got, ovf = tdlv.get_strategy("dense").deliver(
        r, pt, torch.from_numpy(spiked), T_STEP, cp.n_exc, pcfg)
    assert got is r                               # updated in place
    assert int(ovf) == int(want_ovf) == 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-4)
    if case == "zero":
        np.testing.assert_array_equal(got.numpy(), ring)
    else:
        assert not np.array_equal(got.numpy(), ring)


def test_both_layouts_deliver_alike(conn, tables):
    """The sequential sum (K5's order) and the GEMM agree on one step."""
    cp, _ = conn
    spiked = torch.from_numpy(_spiked(cp.n_total, 40, seed=5))
    rings = {}
    for layout in ("bin", "source"):
        _, _, pt, pcfg = tables[layout]
        r = torch.from_numpy(_ring(cp, seed=3))
        rings[layout] = tdlv.get_strategy("dense").deliver(
            r, pt, spiked, 7, cp.n_exc, pcfg)[0]
    np.testing.assert_allclose(rings["bin"].numpy(), rings["source"].numpy(),
                               rtol=1e-6, atol=1e-4)


# --------------------------------------------------------------- guards
def test_byte_cap_raises_before_allocating(conn, monkeypatch):
    cp, _ = conn
    cfg = _port_cfg(cp, "split")
    full = dataclasses.replace(cp, n_total=77_169)      # ~1.1 TB if built
    assert tconn.dense_bytes_estimate(full) > 1e12
    with pytest.raises(ValueError, match="strategy='ell'"):
        tdlv.get_strategy("dense").prepare(full, cfg, CPU)
    monkeypatch.setattr(tconn, "DENSE_MAX_BYTES",
                        tconn.dense_bytes_estimate(cp) - 1)
    for build in (lambda: tconn.dense_delay_binned(cp),
                  lambda: tconn.dense_table(cp, CPU),
                  lambda: tdlv.get_strategy("dense").prepare(cp, cfg, CPU)):
        with pytest.raises(ValueError, match="DENSE_MAX_BYTES"):
            build()
    assert tconn.dense_table(cp, CPU, max_bytes=tconn.dense_bytes_estimate(
        cp)).shape == (cp.d_max_bins, cp.n_total, cp.n_total)


def test_kernel_on_the_gemm_layout_raises(conn, tables):
    cp, _ = conn
    _, _, pt, _ = tables["source"]
    ring = torch.from_numpy(_ring(cp, seed=0))
    with pytest.raises(ValueError, match="KernelPolicy"):
        tdlv.deliver_dense(ring, pt, torch.zeros(cp.n_total, dtype=torch.bool),
                           0, cp.n_exc, kernel=True)


def test_dense_rejects_fused_and_plasticity(conn):
    cp, _ = conn
    cfg = MicrocircuitConfig(scale=0.01, strategy="dense")
    with pytest.raises(ValueError, match="requires the 'ell' delivery"):
        Simulator(cfg, connectome=cp, kernels="fused", device="cpu")
    with pytest.raises(ValueError, match="live-weight"):
        Simulator(cfg, connectome=cp, plasticity="pair_stdp", device="cpu")


@pytest.mark.parametrize("mode,device,kernels,deliver", [
    ("auto", "cuda", True, "kernel"),
    ("split", "cuda", True, "kernel"),
    ("split", "cpu", True, "kernel"),
    ("reference", "cuda", False, "matmul"),
    ("reference", "cpu", False, "matmul"),
    ("auto", "cpu", False, "matmul"),
])
def test_dense_policy(mode, device, kernels, deliver):
    """The port's rule: K5 on the bin-major table where the kernels run,
    the GEMM on the source-major one where they do not; never fused.
    Resolving touches no card."""
    pol = tpol.resolve(mode, strategy="dense", state_dtype=torch.float32,
                       device=device)
    assert (pol.step, pol.kernels, pol.deliver) == ("split", kernels,
                                                    deliver)
    assert f"deliver={deliver}" in pol.describe()


# ----------------------------------------------------- the whole slice
SCALE, N_RUN = 0.02, 100


@pytest.fixture(autouse=True)
def _flush_subnormals_like_xla():
    assert torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)


@pytest.fixture(scope="module")
def reference_dense():
    """A JAX state with spikes in flight (100 ms of the jitted ``ell``
    path), its counts, and JAX's eager dense loop from it."""
    warm = JaxSimulator(JaxConfig(scale=SCALE, strategy="ell",
                                  t_presim=0.0), kernels="reference")
    warm.run(100.0)
    st = warm.state
    start = _jax_arrays(warm.backend.net, st)
    sim = JaxSimulator(JaxConfig(scale=SCALE, strategy="dense",
                                 t_presim=0.0), kernels="reference")
    b = sim.backend
    assert b.net.tables.W is None                # the GEMM layout
    c, t0 = b.c, int(st.t)
    basis = np.asarray(c.k_ext, np.float32) * np.float32(8.0 * 0.1 * 1e-3)
    counts = np.random.default_rng(2025).poisson(
        basis, size=(N_RUN, c.n_total)).astype(np.int32)
    drive = _JaxReplay(counts, t0)
    spikes = []
    for _ in range(N_RUN):
        st, spk = jax_update_phase(st, b.net, b.prop, b.cfg, c.w_ext,
                                   c.n_total, drive)
        st = jax_deliver_phase(st, b.net, b.cfg, spk, c.n_exc)
        spikes.append(np.asarray(spk))
    final = {k: np.asarray(v) for k, v in (
        ("V", st.neuron.V), ("I_ex", st.neuron.I_ex),
        ("I_in", st.neuron.I_in), ("refrac", st.neuron.refrac),
        ("ring", st.ring), ("t", st.t), ("overflow", st.overflow))}
    return dict(start=start, counts=counts, t0=t0, spikes=np.stack(spikes),
                final=final)


@pytest.mark.parametrize("mode", ["split", "reference"])
def test_simulator_dense_bitwise_vs_jax_eager(reference_dense, mode):
    ref = reference_dense
    _, state = convert.to_torch(ref["start"], "cpu")
    stim = _Replay(counts=torch.from_numpy(ref["counts"]), t0=ref["t0"])
    sim = Simulator(MicrocircuitConfig(scale=SCALE, strategy="dense",
                                       t_presim=0.0),
                    kernels=mode, stimulus=(stim,),
                    probes=("pop_counts", "spikes"), device="cpu")
    tables = sim.backend.net.tables
    assert (tables.W is not None) == (mode == "split")
    sim.state = state
    res = sim.run(N_RUN * 0.1)
    assert res.n_steps == N_RUN and res.overflow == 0
    assert ref["spikes"].sum() > 20
    np.testing.assert_array_equal(res["spikes"], ref["spikes"])
    st = sim.state
    got = dict(V=st.neuron.V, I_ex=st.neuron.I_ex, I_in=st.neuron.I_in,
               refrac=st.neuron.refrac, ring=st.ring, t=st.t,
               overflow=st.overflow)
    for key, want in ref["final"].items():
        np.testing.assert_array_equal(np.asarray(got[key]), want,
                                      err_msg=key)
