"""The dense sharded step's inputs and loop for ``test_torch_dryrun.py``,
in a module of their own (no JAX) so that the gloo ranks' subprocesses
import them quickly."""
import numpy as np
import torch

from repro_torch.core import distributed as DD
from repro_torch.core.connectivity import build_connectome
from repro_torch.core.neuron import Propagators
from repro_torch.core.params import NeuronParams

#: the scale-0.01 network, 100 steps, no background (so no random stream
#: enters), a seeded initial V and a DC drive per neuron
SCALE, SEED, STEPS = 0.01, 55, 100


def dense_inputs(n_pad=None):
    """The scale-0.01 network as ``W[D, N, N]`` float32 (one signed
    channel), a seeded initial V and DC drive; padded with silent neurons
    to ``n_pad`` when given."""
    c = build_connectome(scale=SCALE, seed=SEED)
    n, d = c.n_total, c.d_max_bins
    n_pad = n_pad or n
    W = np.zeros((d, n_pad, n_pad), np.float32)
    src = np.repeat(np.arange(n), c.targets.shape[1])
    tgt = c.targets.reshape(-1)
    ok = tgt < n
    np.add.at(W, (c.dbins.reshape(-1)[ok], src[ok], tgt[ok]),
              c.weights.reshape(-1)[ok])
    rng = np.random.default_rng(SEED)
    V0 = np.full(n_pad, -65.0, np.float32)
    V0[:n] = rng.uniform(-65.0, -48.0, n)
    i_dc = np.zeros(n_pad, np.float32)
    i_dc[:n] = rng.uniform(380.0, 460.0, n)
    k_ext = np.zeros(n_pad, np.float32)
    k_ext[:n] = c.k_ext
    return c, W, V0, i_dc, k_ext


def run_dense(world, W, V0, i_dc, k_ext, c, steps=STEPS):
    """The port's dense step, one call a step: each step's refractory
    counters (``== ref_steps`` marks the step's spikes), the last V and
    ring."""
    prop = Propagators.make(NeuronParams(), 0.1)
    n = W.shape[1]
    sim = DD.make_dense_step(world, prop, n=n, n_exc=c.n_exc, w_ext=c.w_ext,
                             bg_rate=0.0, dt=0.1, n_steps=1)
    st = DD.dense_state(torch.from_numpy(V0), W.shape[0])
    blk = DD.dense_block(torch.from_numpy(W), world)
    aux = {"k_ext": torch.from_numpy(k_ext), "i_dc": torch.from_numpy(i_dc)}
    refrac, counts = [], []
    for _ in range(steps):
        st, cnt = sim(st, blk, aux)
        refrac.append(st.refrac.numpy().copy())
        counts.append(int(cnt[0]))
    return np.stack(refrac), np.array(counts), st.V.numpy(), \
        st.ring.numpy()
