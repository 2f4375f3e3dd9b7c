"""End-to-end driver for the paper's experiment on the PyTorch/CUDA port,
the counterpart of ``examples/microcircuit_sim.py`` with the same flags:
simulate the microcircuit for a span of biological time and report the
realtime factor and the activity statistics (0.1 s discarded transient,
then the timed phase), declared through ``repro_torch.api.Experiment``.

    PYTHONPATH=src python examples/microcircuit_sim_torch.py --scale 1.0 \\
        --t-sim 1000 --strategy ell

Long runs can be chunked and checkpointed; a sharded session saves the
world's global state (``--backend sharded``, a world of one on one card):

    ... --backend sharded --t-sim 60000 --chunk 10000 --checkpoint-dir ckpt

One card a rank, over NCCL (every rank runs the script; rank 0 prints):

    torchrun --nproc-per-node=4 examples/microcircuit_sim_torch.py \\
        --backend sharded --scale 1.0 --chunk 1000 --checkpoint-dir ckpt

``--device cpu`` runs the kernels' plain PyTorch versions on the CPU (the
default is the card, and no card is an error).  ``--trials`` runs its
trials one after the other over one set of graphs (the reference vmaps
them).
"""
import argparse
import dataclasses
import os
import time

import numpy as np
import torch.distributed as dist

from repro_torch.api import Experiment
from repro_torch.configs.microcircuit import MicrocircuitConfig


def build_experiment(args) -> Experiment:
    if args.scenario:
        exp = Experiment.from_json(args.scenario)
        overrides = {}
        if args.trials > 1:
            overrides["trials"] = args.trials
        if args.validate or args.validate_json:
            overrides["validate"] = True
        return dataclasses.replace(exp, **overrides) if overrides else exp

    stimulus = [{"kind": "dc"} if args.dc else "poisson_background"]
    if args.thalamic:
        stimulus.append({"kind": "thalamic_pulses",
                         "start_ms": args.thalamic_start,
                         "interval_ms": args.thalamic_interval})
    return Experiment(
        model=MicrocircuitConfig(
            n_scaling=args.scale, k_scaling=args.scale, t_sim=args.t_sim,
            t_presim=args.t_presim, strategy=args.strategy, seed=args.seed),
        stimulus=stimulus,
        plasticity="pair_stdp" if args.stdp else None,
        duration_ms=args.t_sim,
        trials=args.trials,
        validate=bool(args.validate or args.validate_json),
        sample_per_pop=args.sample_per_pop,
        backend=args.backend,
        name="microcircuit-cli")


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scenario", default=None, metavar="PATH",
                    help="run a scenario JSON (CLI model/stimulus flags are "
                         "ignored)")
    ap.add_argument("--scale", type=float, default=0.05)
    ap.add_argument("--t-sim", type=float, default=1000.0,
                    help="model time (ms); the paper uses 10000")
    ap.add_argument("--t-presim", type=float, default=100.0)
    ap.add_argument("--strategy", default="event",
                    choices=["event", "dense", "ell"])
    ap.add_argument("--backend", default="fused",
                    choices=["fused", "instrumented", "sharded"])
    ap.add_argument("--trials", type=int, default=1,
                    help="independent trials via run_batch, one after the "
                         "other; statistics pool across trials")
    ap.add_argument("--dc", action="store_true",
                    help="replace the Poisson background with its "
                         "equivalent-mean DC current")
    ap.add_argument("--thalamic", action="store_true",
                    help="add the PD-2014 thalamic pulse protocol")
    ap.add_argument("--thalamic-start", type=float, default=700.0)
    ap.add_argument("--thalamic-interval", type=float, default=1000.0)
    ap.add_argument("--chunk", type=float, default=0.0,
                    help="chunk size (ms); 0 = one run (single-trial only)")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="save the session after every chunk")
    ap.add_argument("--kernels", default=None,
                    choices=["auto", "fused", "split", "reference"],
                    help="kernel mode (default auto: on the card the fused "
                         "one-kernel step for 'ell', the split kernels "
                         "otherwise; the plain versions on the CPU)")
    ap.add_argument("--use-kernels", action="store_true",
                    help="deprecated: same as --kernels split")
    ap.add_argument("--stdp", action="store_true",
                    help="compose the pair_stdp plasticity rule (E->E "
                         "pair STDP) into the loop")
    ap.add_argument("--validate", action="store_true",
                    help="stream spike statistics during the run and judge "
                         "them against the published microcircuit bands")
    ap.add_argument("--validate-json", default=None, metavar="PATH",
                    help="write the ValidationReport JSON here")
    ap.add_argument("--sample-per-pop", type=int, default=100,
                    help="neurons sampled per population for --validate")
    ap.add_argument("--seed", type=int, default=55)
    ap.add_argument("--device", default=None,
                    help="'cpu' runs the kernels' plain PyTorch versions on "
                         "the CPU; the default is the CUDA card")
    return ap.parse_args(argv)


def main(argv=None):
    """Run the experiment; returns the (first trial's or pooled)
    ``RunResult``.  Exits 4 when a validation fails."""
    args = parse(argv)
    if int(os.environ.get("WORLD_SIZE", "1")) > 1 \
            and not dist.is_initialized():
        # under torchrun: one rank a card (its address from the launcher)
        dist.init_process_group("gloo" if args.device == "cpu" else "nccl")
    say = print if not dist.is_initialized() or dist.get_rank() == 0 \
        else (lambda *a, **k: None)
    exp = build_experiment(args)
    sim_kwargs = {"device": args.device}
    if args.kernels is not None:
        sim_kwargs.update(kernels=args.kernels)
    elif args.use_kernels:
        sim_kwargs.update(kernels="split")

    t0 = time.perf_counter()
    if args.chunk > 0:
        # the chunked long run drives the experiment's session directly
        # (run_chunked and checkpoints are session features)
        if exp.trials > 1:
            raise SystemExit("--chunk runs a single chunked session; "
                             "drop --trials")
        sim = exp.make_simulator(**sim_kwargs)
        c = sim.connectome
        say(f"instantiation: {time.perf_counter() - t0:.1f}s "
            f"({c.n_total} neurons, {c.n_synapses:,} synapses)")
        sim.warmup(args.chunk)
        res = sim.run_chunked(exp.duration_ms, chunk_ms=args.chunk,
                              checkpoint_dir=args.checkpoint_dir)
        report = res.validate() if exp.validate else None
    else:
        result = exp.run(warmup=True, **sim_kwargs)
        c = result.connectome
        say(f"instantiation+run: {time.perf_counter() - t0:.1f}s "
            f"({c.n_total} neurons, {c.n_synapses:,} synapses, "
            f"{len(result.trials)} trial(s))")
        res = (result.trials[0] if exp.trials == 1
               else result.batch.pooled())
        report = result.report
        if exp.trials > 1:
            say(f"per-trial RTF: mean={result.batch.rtf_mean:.2f} "
                f"std={result.batch.rtf_std:.2f}")

    summ = res.summary()
    say(f"T_model={res.t_model_ms / 1e3:.1f}s  T_wall={res.wall_s:.1f}s  "
        f"RTF={res.rtf:.2f}  ({'sub' if res.rtf < 1 else 'super'}-realtime)")
    say("rates (Hz):", np.round(summ["rates_hz"], 2))
    say("synchrony:", round(summ["synchrony"], 2), " overflow:",
        res.overflow)
    if report is not None:
        say(report.table())
        if args.validate_json:
            report.to_json(args.validate_json)
            say("report written:", args.validate_json)
        if not report.passed:
            raise SystemExit(4)
    return res


if __name__ == "__main__":
    main()
