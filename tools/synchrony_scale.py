"""The validation's synchrony measure against the network's size.

The report's ``synchrony`` check is the mean over the populations of the
variance over the mean of the 1 ms-binned population spike count (all of
a population's neurons).  For N neurons whose pairwise count correlation
is c, that ratio is about ``1 + (N - 1) * c``: it grows with the
population, so an asynchronous network (c near 0) crosses a fixed band
as it grows.  For each ``--scales`` value this builds the microcircuit,
runs a validated ``Experiment`` of ``--t-ms`` (100 ms presim, 100 sampled
neurons a population) and prints one JSON line: the report's synchrony
and verdicts, and per population its size N, the ratio over all its
neurons (1 ms bins), the mean pairwise correlation of the sample (2 ms
bins, the report's ``correlation``) and the ratio of the sample's summed
count (2 ms bins), which does not grow with N.

``--paths`` picks the loops that run each network: ``kernels`` is the
production session (the fused backend: K3 in CUDA graphs on a card, the
kernels' plain versions on the CPU), ``plain`` the instrumented backend's
eager loop with ``kernels="reference"`` (plain PyTorch, no hand-written
kernel and no graph, on either device): the witness that a statistic of
the kernel path is the network's and not the kernels'.  ``--seeds`` runs
each path once per seed (the session's draws and the validation's sample;
the network is the first seed's)::

    python3 tools/synchrony_scale.py --scales 0.02 0.05 0.1 --device cpu
    python3 tools/synchrony_scale.py --scales 0.5 1.0 --paths kernels plain \
        --seeds 55 56 57                                          # the card
"""
import argparse
import json
import subprocess

import numpy as np


def sample_ratio(carry, ids, pop_of, n_pops: int) -> list:
    """Per population, the variance over the mean of the sampled neurons'
    summed count per closed bin, from the moment carry."""
    nb = int(carry.n_bins)
    mean = np.asarray(carry.bin_sum, np.float64) / nb
    cov = np.asarray(carry.bin_outer, np.float64) / nb - np.outer(mean, mean)
    pops = np.asarray(pop_of)[np.asarray(ids)]
    out = []
    for p in range(n_pops):
        sel = pops == p
        m = mean[sel].sum()
        out.append(float(cov[np.ix_(sel, sel)].sum() / m) if m > 0
                   else None)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scales", type=float, nargs="+",
                    default=[0.02, 0.05, 0.1])
    ap.add_argument("--t-ms", type=float, default=1000.0)
    ap.add_argument("--seeds", type=int, nargs="+", default=[55])
    ap.add_argument("--paths", nargs="+", choices=sorted(PATHS),
                    default=["kernels"])
    ap.add_argument("--device", default=None,
                    help="'cpu' for the CPU; the default is the CUDA card")
    args = ap.parse_args()
    import dataclasses

    from repro_torch.api import Experiment
    from repro_torch.api.simulator import session_device
    from repro_torch.configs.microcircuit import MicrocircuitConfig
    from repro_torch.core.connectivity import build_connectome

    device = session_device(args.device)
    if device.type == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip(), flush=True)
    for scale in args.scales:
        base = MicrocircuitConfig(scale=scale, strategy="ell",
                                  seed=args.seeds[0])
        c = build_connectome(scale=base.scale, n_scaling=base.n_scaling,
                             k_scaling=base.k_scaling, seed=base.seed,
                             dt=base.dt)
        for seed in args.seeds:
            for path in args.paths:
                backend, kernels = PATHS[path]
                model = dataclasses.replace(base, seed=seed, kernels=kernels)
                exp = Experiment(model=model, validate=True,
                                 duration_ms=args.t_ms, backend=backend)
                result = exp.run(connectome=c, device=device, warmup=True)
                print(json.dumps(dict(scale=scale, seed=seed, path=path,
                                      **_stats(result, c))), flush=True)


#: path -> (backend, kernel mode)
PATHS = {"kernels": ("fused", None), "plain": ("instrumented", "reference")}


def _stats(result, c) -> dict:
    res, report = result.trials[0], result.report
    counts = res["pop_counts"]
    binned = counts[:counts.shape[0] // 10 * 10].reshape(
        -1, 10, counts.shape[1]).sum(1)
    m, v = binned.mean(0), binned.var(0)
    by_metric = {}
    for ck in report.checks:
        by_metric.setdefault(ck.metric, []).append(ck.value)
    snap = res.streams["spike_stats"]
    return {
        "device": res.device, "t_ms": res.t_model_ms, "rtf": res.rtf,
        "overflow": res.overflow,
        "synchrony": by_metric["synchrony"][0],
        "synchrony_status": [ck.status for ck in report.checks
                             if ck.metric == "synchrony"][0],
        "other_checks_passed": all(ck.status == "pass"
                                   for ck in report.checks
                                   if ck.metric != "synchrony"),
        "n": [int(x) for x in c.pop_sizes],
        "rate_hz": by_metric["rate"], "cv_isi": by_metric["cv_isi"],
        "correlation_sample_2ms": by_metric["correlation"],
        "ratio_all_neurons_1ms": [float(x) for x in
                                  np.where(m > 0, v / np.maximum(m, 1e-30),
                                           np.nan)],
        "ratio_sample_2ms": sample_ratio(snap["carry"], snap["meta"]["ids"],
                                         c.pop_of, len(c.pop_sizes)),
    }


if __name__ == "__main__":
    main()
