"""Wall milliseconds per step of the port's step loops, for A/B runs.

Builds one connectome at ``--scale`` and times the static and the plastic
(``pair_stdp``) session under the ``split`` and the ``fused`` policy on the
card, each with the graphed ``fused`` backend (its loop in CUDA graphs of
``--graph-steps`` steps; one line per value) and the eager
``instrumented`` backend, in turns: one warm-up (the graphs' capture),
then ``--repeats`` timed ``run`` calls of ``--t-ms`` each.  Prints the
card's name and power limit, then one JSON line per (path, policy,
backend, graph steps) with every repeat's ms per step and their median.
The tree under test comes from ``PYTHONPATH``, so two trees are compared
with one copy of this script, alternating the trees within one machine
call (a tree whose ``Simulator`` has no ``backend`` argument runs its one
loop, as before)::

    for t in parent change change parent; do
        PYTHONPATH=$t/src python3 tools/step_times.py --tag $t
    done
"""
import argparse
import inspect
import json
import statistics
import subprocess

import torch


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=float, default=0.25)
    ap.add_argument("--t-ms", type=float, default=200.0)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--seed", type=int, default=55)
    ap.add_argument("--graph-steps", type=int, nargs="+", default=None,
                    help="body graph lengths to time (default: the "
                         "backend's own)")
    ap.add_argument("--paths", nargs="+", default=["static", "plastic"],
                    choices=["static", "plastic"])
    ap.add_argument("--policies", nargs="+", default=["split", "fused"],
                    choices=["split", "fused"])
    ap.add_argument("--tag", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("step_times.py times the card: no CUDA device")
    import repro_torch
    from repro_torch.api import Simulator
    from repro_torch.configs.microcircuit import MicrocircuitConfig
    from repro_torch.core.connectivity import build_connectome

    sessions = "backend" in inspect.signature(Simulator).parameters
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    c = build_connectome(scale=args.scale, seed=args.seed)
    backends = [("fused", None)]
    if sessions:
        from repro_torch.api.backends import FusedBackend
        backends = [("fused", g) for g in (args.graph_steps or [None])] \
            + [("instrumented", None)]
    for path in args.paths:
        plasticity = "pair_stdp" if path == "plastic" else None
        for mode in args.policies:
            for backend, graph_steps in backends:
                cfg = MicrocircuitConfig(scale=args.scale, strategy="ell",
                                         seed=args.seed, t_presim=0.0,
                                         kernels=mode)
                kw = {}
                if sessions:
                    kw["backend"] = backend if graph_steps is None else \
                        FusedBackend(plasticity=plasticity,
                                     graph_steps=graph_steps)
                sim = Simulator(cfg, connectome=c, plasticity=plasticity,
                                device="cuda", **kw)
                if sessions:
                    sim.warmup(args.t_ms)
                else:
                    sim.warmup()
                ms = []
                for _ in range(args.repeats):
                    res = sim.run(args.t_ms)
                    ms.append(res.wall_s / res.n_steps * 1e3)
                print(json.dumps({
                    "tag": args.tag, "tree": repro_torch.__file__,
                    "path": path, "policy": sim.sim_config.kernels.describe(),
                    "backend": backend,
                    "graph_steps": getattr(sim.backend, "graph_steps", None),
                    "scale": args.scale, "steps": res.n_steps,
                    "overflow": res.overflow, "ms_per_step": ms,
                    "median_ms_per_step": statistics.median(ms)}),
                    flush=True)
                del sim
                torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
