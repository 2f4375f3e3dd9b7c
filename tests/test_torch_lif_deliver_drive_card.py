"""K3 and K4 (``csrc/lif_deliver.cu``) given the step's drive as drawn, on
the card: the float32 spike counts (or none), the weight ``w_ext`` and the
running overflow, with ``t + 1`` and the new overflow written by the
kernel.

* At PD14's full size (N = 77,169, ELL rows 6,784 wide, D = 46), each
  kernel equals its plain version run on the same inputs copied to the
  CPU, bit for bit in every output: the ring, the neurons, the spikes, the
  ids, the overflow and ``t + 1`` (K4: the depressed table and the traces
  too).  The tables' weights and the ring are multiples of 1/4 small
  enough that their float sums are exact in any order, so the scatter's
  atomics cannot part the two.
* The kernel's ``__fmul_rn(w_ext, count)`` equals PyTorch's product of
  the Python float ``w_ext`` and the float32 counts on the card (the
  product the step launched before), bit for bit: read off ``I_ex'``
  from a zero ring and zero currents.
* A graphed static session's replayed step holds three kernels (the
  Poisson draw, K3, ``pop_counts``) and no cast, product or counter op.

Marked ``card``: each test skips without a CUDA card.  The file imports no
JAX, so it runs on a machine without it::

    python -m pytest -q --noconftest -m card \\
        tests/test_torch_lif_deliver_drive_card.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import params as P
from repro_torch.core.neuron import Propagators
from repro_torch.core.params import NeuronParams
from repro_torch.kernels import lif_deliver as K3
from repro_torch.kernels.stdp import StdpCoef

pytestmark = pytest.mark.card

#: PD14 at full scale: neurons, an ELL row's width, delay bins, excitatory
N, K_PAD, D, N_EXC = 77_169, 6_784, 46, 61_843
BUDGET, T = 256, 1234
#: the external weight (pA) as the connectome derives it at full scale
W_EXT = P.psc_from_psp(P.SynapseParams().PSP_e, NeuronParams())
PROP = Propagators.make(NeuronParams(), 0.1)
COEF = StdpCoef(1.05, 0.88, 0.995, 0.995, 263.4)
#: what the step launched around K3 before it took the drive
GONE = ("direct_copy_kernel", "AUnaryFunctor", "add_int")


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU form")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def tables(dev):
    """Full-size ELL tables on the card and their CPU copies: rows of
    3,000-4,600 real entries, the rest padding (target N, weight 0);
    weights in quarters."""
    gen = torch.Generator(device=dev).manual_seed(31)
    pad = (torch.arange(K_PAD, device=dev)[None, :]
           >= torch.randint(3000, 4600, (N + 1, 1), device=dev,
                            generator=gen))
    pad[N] = True
    targets = torch.randint(0, N, (N + 1, K_PAD), device=dev, generator=gen,
                            dtype=torch.int32).masked_fill_(pad, N)
    dbins = torch.randint(1, D, (N + 1, K_PAD), device=dev, generator=gen,
                          dtype=torch.int32).masked_fill_(pad, 1)
    weights = torch.randint(1, 400, (N + 1, K_PAD), device=dev,
                            generator=gen).to(torch.float32) / 4
    weights[N_EXC:] *= -4
    weights.masked_fill_(pad, 0.0)
    pmask = (torch.rand(N + 1, K_PAD, device=dev, generator=gen) < 0.5) \
        & ~pad
    del pad
    card = (targets, weights, dbins, pmask)
    return card, tuple(x.cpu() for x in card)


def _inputs(seed, n_spikes, counts, overflow=7):
    """One step's inputs on the CPU: a ring in quarters, the neurons, the
    delivered spikes, the float32 counts (or None), the DC term, ``t`` and
    the running overflow."""
    rng = np.random.default_rng(seed)
    ring = np.zeros((D, 2, N + 1), np.float32)
    ring[:, 0, :N] = rng.integers(0, 200, (D, N)) / 4
    ring[:, 1, :N] = -rng.integers(0, 200, (D, N)) / 4
    spiked = np.zeros(N, bool)
    spiked[rng.choice(N, size=n_spikes, replace=False)] = True
    k_ext = np.repeat(P.K_EXT, P.scaled_counts(1.0)).astype(np.float32)
    cnt = None if not counts else torch.from_numpy(
        rng.poisson(k_ext * np.float32(8e-4)).astype(np.float32))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    return dict(
        ring=t(ring), spiked=t(spiked),
        V=t(rng.uniform(-80, -45, N).astype(np.float32)),
        I_ex=t((rng.uniform(0, 1, N) * 400).astype(np.float32)),
        I_in=t((-rng.uniform(0, 1, N) * 400).astype(np.float32)),
        refrac=t(rng.integers(0, 21, N).astype(np.int32)), cnt=cnt,
        i_dc=t(rng.uniform(0, 100, N).astype(np.float32)),
        x_pre=t(rng.uniform(0, 3, N).astype(np.float32)),
        x_post=t(rng.uniform(0, 3, N).astype(np.float32)),
        t=torch.tensor(T, dtype=torch.int32),
        overflow=torch.tensor(overflow, dtype=torch.int32))


def _on(x, dev):
    return {k: None if v is None else v.to(dev) for k, v in x.items()}


CASES = {"counts_25": (25, True), "counts_300_cut": (300, True),
         "no_spike_drive": (25, False)}


def _assert_bitwise(names, got, want):
    assert len(got) == len(want) == len(names)
    for name, a, b in zip(names, got, want):
        assert a.dtype == b.dtype, name
        assert torch.equal(a.cpu(), b), name


@pytest.mark.parametrize("case", list(CASES))
def test_k3_equals_plain(dev, tables, case):
    n_spikes, counts = CASES[case]
    (tg, w, db, _), (tg_c, w_c, db_c, _) = tables
    x = _inputs(3, n_spikes, counts)
    y = _on(x, dev)
    step = lambda z, tbl: (z["ring"],) + tbl + tuple(z[k] for k in (
        "spiked", "V", "I_ex", "I_in", "refrac", "cnt", "i_dc", "t",
        "overflow"))
    kw = dict(n_exc=N_EXC, budget=BUDGET, prop=PROP, w_ext=W_EXT)
    got = K3.lif_deliver(*step(y, (tg, w, db)), **kw)
    want = K3.lif_deliver_plain(*step(x, (tg_c, w_c, db_c)), **kw)
    torch.cuda.synchronize()
    _assert_bitwise(("ring", "V", "I_ex", "I_in", "refrac", "spiked", "ids",
                     "overflow", "t"), got, want)
    assert int(got[7]) == 7 + max(n_spikes - BUDGET, 0)
    assert int(got[8]) == T + 1 and int(y["t"]) == T
    assert int(y["overflow"]) == 7


@pytest.mark.parametrize("case", list(CASES))
def test_k4_equals_plain(dev, tables, case):
    n_spikes, counts = CASES[case]
    (tg, w, db, pm), (tg_c, w_c, db_c, pm_c) = tables
    x = _inputs(4, n_spikes, counts)
    y = _on(x, dev)
    w_k, w_p = w.clone(), w_c.clone()
    step = lambda z, tbl: (z["ring"],) + tbl + tuple(z[k] for k in (
        "spiked", "V", "I_ex", "I_in", "refrac", "cnt", "i_dc", "x_pre",
        "x_post", "t", "overflow"))
    kw = dict(n_exc=N_EXC, budget=BUDGET, prop=PROP, w_ext=W_EXT, coef=COEF)
    got = K3.lif_deliver_plastic(*step(y, (tg, w_k, db, pm)), **kw)
    want = K3.lif_deliver_plastic_plain(*step(x, (tg_c, w_p, db_c, pm_c)),
                                        **kw)
    torch.cuda.synchronize()
    _assert_bitwise(("ring", "weights", "V", "I_ex", "I_in", "refrac",
                     "spiked", "x_pre", "x_post", "ids", "overflow", "t"),
                    got, want)
    assert int(got[10]) == 7 + max(n_spikes - BUDGET, 0)
    assert int(got[11]) == T + 1
    assert not torch.equal(w_p, w_c)              # the depression ran


def test_kernel_product_equals_pytorchs(dev, tables):
    """``I_ex'`` from a zero ring and zero currents is the kernel's
    ``__fmul_rn(w_ext, count)``; PyTorch's ``w_ext * counts`` on the card
    is what the step computed before."""
    (tg, w, db, _), _ = tables
    x = _on(_inputs(5, 0, True), dev)
    rng = np.random.default_rng(6)
    cnt = torch.from_numpy(rng.poisson(rng.uniform(0, 60, N))
                           .astype(np.float32)).to(dev)
    zero = torch.zeros(N, device=dev)
    out = K3.lif_deliver(torch.zeros(D, 2, N + 1, device=dev), tg, w, db,
                         x["spiked"], x["V"], zero, zero, x["refrac"], cnt,
                         x["i_dc"], x["t"], x["overflow"], n_exc=N_EXC,
                         budget=BUDGET, prop=PROP, w_ext=W_EXT)
    torch.cuda.synchronize()
    assert torch.equal(out[2], W_EXT * cnt)
    assert torch.equal(out[2].cpu(), W_EXT * cnt.cpu())


def test_graphed_static_step_launches_three_kernels(dev):
    """A graphed static session's replayed step: the draw, K3 and the
    probe, and none of the ops K3 took over."""
    from repro_torch.api import Simulator
    from repro_torch.configs.microcircuit import MicrocircuitConfig
    from repro_torch.perf.step_analysis import kernel_census
    sim = Simulator(MicrocircuitConfig(scale=0.05, strategy="ell",
                                       t_presim=0.0, seed=55), device=dev)
    assert sim.backend.graphed and sim.sim_config.kernels.step == "fused"
    n_steps = 300
    sim.warmup(n_steps * 0.1)
    res = sim.run(n_steps * 0.1)
    torch.cuda.synchronize()
    assert res.n_steps == n_steps
    backend = sim.backend
    entry = backend.graphs.peek(backend._key(n_steps, tuple(sim.probes)))
    body = max(entry.graphs, key=lambda gt: gt[1])[0]

    def replay():
        entry.row.zero_()
        body.replay(1)
    census = kernel_census(replay, backend.graph_steps)
    per_step = {k: v["launches_per_step"]
                for k, v in census["kernels"].items()
                if v["launches_per_step"] >= 0.5}
    assert len(per_step) == 3, per_step
    assert round(sum(per_step.values())) == 3, per_step
    assert any("lif_deliver_kernel" in k for k in per_step)
    assert any("pop_counts" in k for k in per_step)
    assert any("poisson" in k for k in per_step)
    assert not [k for k in census["kernels"] if any(g in k for g in GONE)]
