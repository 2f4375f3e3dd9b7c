"""K3's and K4's phases and times on one card, for A/B runs of two trees.

Builds ELL tables of the full-scale microcircuit's shape on the card
(N = 77,169 neurons, 61,843 excitatory, k_pad = 6,784, D = 46 delay bins;
each row 3,000-4,599 real entries with random targets and delay bins,
weights signed by Dale's law, half the entries plastic), then, for K3 and
for K4 at ``--spikes`` random spikes a step (budget 256): the phase table of
64 stamped launches (``chip_smoke.phase_table``), the device time a launch
(``torch.profiler``), the back-to-back time a call (CUDA events: the
host's rate) and the time a launch of 64 launches replayed in one CUDA
graph.  Prints the card's name and power limit, then one JSON line.  The
tree under test comes from ``PYTHONPATH``, so two trees are compared with
one copy of this script, alternating the trees within one machine call::

    for t in parent change change parent; do
        PYTHONPATH=build/ab/$t/src python3 tools/k3_phases.py --tag $t
    done
"""
import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from chip_smoke import call_ms, card_line, device_ms, phase_table  # noqa


def stamps_buffer(K3, dev, n_cols):
    if hasattr(K3, "stamps_buffer"):
        return K3.stamps_buffer(dev, n_cols)
    return K3.stamped_launch(K3.cooperative_grid(dev, n_cols), dev)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--spikes", type=int, default=25)
    ap.add_argument("--seed", type=int, default=55)
    ap.add_argument("--tag", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("k3_phases.py times the card: no CUDA device")
    import repro_torch
    from repro_torch.core.neuron import Propagators
    from repro_torch.core.params import NeuronParams
    from repro_torch.kernels import lif_deliver as K3
    from repro_torch.kernels.stdp import StdpCoef

    print(card_line(), flush=True)
    dev = torch.device("cuda", torch.cuda.current_device())
    n, k_pad, d, n_exc = 77_169, 6_784, 46, 61_843
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    pad = (torch.arange(k_pad, device=dev)[None, :]
           >= torch.randint(3000, 4600, (n + 1, 1), device=dev,
                            generator=gen))
    pad[n] = True
    targets = torch.randint(0, n, (n + 1, k_pad), device=dev, generator=gen,
                            dtype=torch.int32).masked_fill_(pad, n)
    dbins = torch.randint(1, d, (n + 1, k_pad), device=dev, generator=gen,
                          dtype=torch.int32).masked_fill_(pad, 1)
    weights = torch.rand(n + 1, k_pad, device=dev, generator=gen) * 90
    weights[n_exc:] *= -4
    weights.masked_fill_(pad, 0.0)
    pmask = (torch.rand(n + 1, k_pad, device=dev, generator=gen) < 0.5) & ~pad
    del pad
    rng = np.random.default_rng(args.seed)
    on = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    ring = np.zeros((d, 2, n + 1), np.float32)
    ring[:, 0, :n] = rng.uniform(0, 50, (d, n))
    ring[:, 1, :n] = -rng.uniform(0, 50, (d, n))
    ring = on(ring)
    state = (on(rng.uniform(-80, -45, n).astype(np.float32)),
             on((rng.uniform(0, 1, n) * 400).astype(np.float32)),
             on((-rng.uniform(0, 1, n) * 400).astype(np.float32)),
             on(rng.integers(0, 21, n).astype(np.int32)),
             on(rng.uniform(0, 100, n).astype(np.float32)),
             on(np.full(n, 10.0, np.float32)))
    x_pre, x_post = (on(rng.uniform(0, 3, n).astype(np.float32))
                     for _ in range(2))
    spks = []
    for _ in range(64):
        s = np.zeros(n, bool)
        s[rng.choice(n, size=args.spikes, replace=False)] = True
        spks.append(on(s))
    prop = Propagators.make(NeuronParams(), 0.1)
    coef = StdpCoef(1.05, 0.88, 0.995, 0.995, 263.4)
    launches = {
        "K3": lambda i, **kw: K3.lif_deliver(
            ring, targets, weights, dbins, spks[i % 64], *state, 1234,
            n_exc=n_exc, budget=256, prop=prop, **kw),
        "K4": lambda i, **kw: K3.lif_deliver_plastic(
            ring, targets, weights, dbins, pmask, spks[i % 64], *state,
            x_pre, x_post, 1234, n_exc=n_exc, budget=256, prop=prop,
            coef=coef, **kw)}
    out = {"tag": args.tag, "tree": repro_torch.__file__,
           "spikes": args.spikes}
    for name, launch in launches.items():
        for i in range(3):
            launch(i, stamps=stamps_buffer(K3, dev, n + 1))
        bufs = [stamps_buffer(K3, dev, n + 1) for _ in range(64)]
        for i, b in enumerate(bufs):
            launch(i, stamps=b)
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for i in range(64):
                launch(i)
        g.replay()
        torch.cuda.synchronize()
        graph_ms = call_ms(lambda i: g.replay(), iters=16) / 64
        out[name] = {"phases_us_median_mean_max": phase_table(
                         torch.stack(bufs), K3.PHASES),
                     "ms": device_ms(launch), "call_ms": call_ms(launch),
                     "graph_ms": graph_ms,
                     "grid": int(bufs[0].shape[0])}
        del g
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
