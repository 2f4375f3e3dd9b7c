"""The fused step's and the delivery's kernels on one card, for A/B runs
of two trees: K3, K4, K2 and ``stdp_update``'s two per-step forms.

Builds ELL tables of the full-scale microcircuit's shape on the card
(N = 77,169 neurons, 61,843 excitatory, k_pad = 6,784, D = 46 delay bins;
each row 3,000-4,599 real entries with random targets and delay bins,
weights signed by Dale's law, half the entries plastic for K4), and for
``stdp_update`` the plastic tables of those (the E->E entries and their IN
view, ``plasticity.build_plastic_tables``), then, for each ``--kernel`` at
``--spikes`` random spikes a step (budget 256): the phase table of 64
stamped launches (``chip_smoke.phase_table``; none for a tree whose kernel
has no stamped instantiation), the device time a launch
(``torch.profiler``), the back-to-back time a call (CUDA events: the
host's rate), the host's µs a call (``host_us``: the median of 20 batches
of 50 calls on the host's clock; not for the whole-table clip) and the
time a launch of 64 launches replayed in one CUDA graph.  ``stdp`` is the
potentiation and clip after K4 (``full=False``), ``stdp_full`` the whole
step, ``stdp_clip`` the form with the whole-table clip (a run's first
update).  K2 and ``stdp`` also get their bound, as ``chip_smoke.py``'s
``kernels`` line counts it for these spikes.  Prints the card's name and
power limit, then one JSON line.  The tree under test comes from
``PYTHONPATH``, so two trees are compared with one copy of this script,
alternating the trees within one machine call::

    for t in parent change change parent; do
        PYTHONPATH=build/ab/$t/src python3 tools/k3_phases.py --tag $t
    done
"""
import argparse
import inspect
import json
import statistics
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from chip_smoke import (ENTRY_OPS, bound, call_ms, card_line,  # noqa: E402
                        device_ms, k2_bytes, phase_table, stdp_bytes,
                        stdp_counts)


KERNELS = ("k3", "k4", "k2", "stdp")
#: the microcircuit's external weight at full scale (pA)
W_EXT = 87.80849352920845


def host_us(launch, batches: int = 20, calls: int = 50) -> float:
    """The host's µs a call through the wrapper: ``calls`` calls issued
    back to back and timed on the host's clock, the card drained between
    batches; the median over ``batches``."""
    per = []
    for _ in range(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(calls):
            launch(i)
        per.append((time.perf_counter() - t0) / calls * 1e6)
    torch.cuda.synchronize()
    return statistics.median(per)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--spikes", type=int, default=25)
    ap.add_argument("--seed", type=int, default=55)
    ap.add_argument("--tag", default="")
    ap.add_argument("--kernel", nargs="+", choices=KERNELS,
                    default=list(KERNELS))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("k3_phases.py times the card: no CUDA device")
    import repro_torch
    from repro_torch.core import plasticity as PL
    from repro_torch.core.neuron import Propagators
    from repro_torch.core.params import NeuronParams
    from repro_torch.kernels import ell_deliver as K2
    from repro_torch.kernels import lif_deliver as K3
    from repro_torch.kernels import stdp as KS
    from repro_torch.kernels.ell_deliver import compact_ids_plain
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
    neurons = (on(rng.uniform(-80, -45, n).astype(np.float32)),
               on((rng.uniform(0, 1, n) * 400).astype(np.float32)),
               on((-rng.uniform(0, 1, n) * 400).astype(np.float32)),
               on(rng.integers(0, 21, n).astype(np.int32)))
    counts = on(rng.poisson(1.6, n).astype(np.float32))
    i_dc = on(np.full(n, 10.0, np.float32))
    x_pre, x_post = (on(rng.uniform(0, 3, n).astype(np.float32))
                     for _ in range(2))
    spks = []
    for _ in range(64):
        s = np.zeros(n, bool)
        s[rng.choice(n, size=args.spikes, replace=False)] = True
        spks.append(on(s))
    prop = Propagators.make(NeuronParams(), 0.1)
    coef = StdpCoef(1.05, 0.88, 0.995, 0.995, 263.4)
    # the step counter: a 0-d int32 tensor on the card in a tree whose
    # kernels read it there (``lif_deliver.step_counter``), an int before
    t_step = (torch.tensor(1234, dtype=torch.int32, device=dev)
              if hasattr(K3, "step_counter") else 1234)
    # the drive: the float counts with w_ext and the running overflow in a
    # tree whose K3 and K4 take them, the weighted input before
    if "w_ext" in inspect.signature(K3.lif_deliver).parameters:
        state, tail = (*neurons, counts, i_dc), (
            t_step, torch.zeros((), dtype=torch.int32, device=dev))
        drive_kw = {"w_ext": W_EXT}
    else:
        state, tail, drive_kw = (*neurons, W_EXT * counts, i_dc), (t_step,), {}
    # (launch, stamps buffer or None, phase names)
    k3_stamps = lambda: K3.stamps_buffer(dev, n + 1)
    launches = {}
    if "k3" in args.kernel:
        launches["K3"] = (lambda i, **kw: K3.lif_deliver(
            ring, targets, weights, dbins, spks[i % 64], *state, *tail,
            n_exc=n_exc, budget=256, prop=prop, **drive_kw, **kw),
            k3_stamps, K3.PHASES)
    if "k4" in args.kernel:
        launches["K4"] = (lambda i, **kw: K3.lif_deliver_plastic(
            ring, targets, weights, dbins, pmask, spks[i % 64], *state,
            x_pre, x_post, *tail, n_exc=n_exc, budget=256, prop=prop,
            coef=coef, **drive_kw, **kw), k3_stamps, K3.PHASES)
    bounds = {}
    if "k2" in args.kernel:
        # the real entries of the spiking rows (all delivered: 25 < 256)
        n_entries = sum(float((targets[x.nonzero()[:, 0]] < n).sum())
                        for x in spks) / 64
        bounds["K2"] = bound(k2_bytes(n, 256, n_entries),
                             ENTRY_OPS * n_entries)
        stamped = hasattr(K2, "PHASES")
        launches["K2"] = (lambda i, **kw: K2.ell_deliver(
            ring, targets, weights, dbins, spks[i % 64], t_step, n_exc, 256,
            **kw), k3_stamps if stamped else None,
            K2.PHASES if stamped else None)
    if "stdp" in args.kernel:
        ptab = PL.build_plastic_tables(
            SimpleNamespace(targets=targets, weights=weights, dbins=dbins),
            n_exc)
        ids = [compact_ids_plain(x, 256)[0] for x in spks]
        cnt = stdp_counts(targets, ptab.plastic_out, ptab.in_syn_idx,
                          ptab.plastic_in, ids)
        bounds["stdp"] = bound(stdp_bytes(cnt, 256), 2 * cnt["in_plastic"])
        w_live = weights.clone()
        stamped = hasattr(KS, "stamps_buffer")
        for name, full, clip_all in (("stdp", False, False),
                                     ("stdp_full", True, False),
                                     ("stdp_clip", False, True)):
            launches[name] = (
                lambda i, full=full, clip_all=clip_all, **kw: KS.stdp_update(
                    w_live, targets, ptab.plastic_out, ptab.in_syn_idx,
                    ptab.plastic_in, ids[i % 64], x_pre, x_post,
                    spks[i % 64], coef, full=full, clip_all=clip_all, **kw),
                (lambda: KS.stamps_buffer(dev)) if stamped else None,
                KS.PHASES if stamped else None)
        out_k_in = int(ptab.in_syn_idx.shape[1])
    out = {"tag": args.tag, "tree": repro_torch.__file__,
           "spikes": args.spikes, "kernels": args.kernel}
    if "stdp" in args.kernel:
        out["k_in"] = out_k_in
    for name, (launch, new_stamps, names) in launches.items():
        row = {}
        if new_stamps is not None:
            for i in range(3):
                launch(i, stamps=new_stamps())
            bufs = [new_stamps() for _ in range(64)]
            for i, b in enumerate(bufs):
                launch(i, stamps=b)
            torch.cuda.synchronize()
            row["phases_us_median_mean_max"] = phase_table(
                torch.stack(bufs)[..., :len(names) + 1], names)
            row["grid"] = int(bufs[0].shape[0])
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for i in range(64):
                launch(i)
        g.replay()
        torch.cuda.synchronize()
        row["graph_ms"] = call_ms(lambda i: g.replay(), iters=16) / 64
        row["ms"] = device_ms(launch)
        row["call_ms"] = call_ms(launch)
        if name != "stdp_clip":       # its 0.5 ms a launch would fill the queue
            row["host_us"] = host_us(launch)
        if name in bounds:
            row["bound_ms"], row["bound_by"] = bounds[name]
        out[name] = row
        del g
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
