"""Faults planted in the program, to show that ``correct`` catches them.

    python3 perfbench/faults.py --workload pd14_stdp.free_bg \
        --fault stdp_noop --seeds 11 12 13 --seconds 8

Each fault is ``fault(sim, setattr)``: it breaks the session ``sim`` once
its start has been checked and before its graphs are captured, so that the
timed path runs broken from the presim on (``setattr`` is the caller's,
so that a test can undo what the fault patched).  The command runs the
cell on the card with the fault, one seed after another in one process,
and prints one JSON line a seed: the numbers compared with their limits
and whether the run came out correct (it must not).  The benchmark's own
runs never plant a fault.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if __name__ == "__main__":
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402


def _device(sim):
    st = sim.state
    return (st if hasattr(st, "ring") else st[0]).ring.device


def step_unchanged(sim, setattr=setattr):
    """Every step hands its carry on as it got it, and nobody spikes."""
    n = sim.connectome.n_total
    dev = _device(sim)
    setattr(sim.backend, "_step", lambda carry, i, tick=None: (
        carry, torch.zeros(n, dtype=torch.bool, device=dev)))


def count_altered(sim, setattr=setattr):
    """The probe's answer altered where it is made: one more spike in the
    second population (PD14's L4E) at every step."""
    from repro_torch.api.probes import Probe
    orig = sim.probes[0].fn
    bump = torch.zeros(len(sim.connectome.pop_sizes), dtype=torch.int32,
                       device=_device(sim))
    bump[1] = 1
    setattr(sim, "probes", (Probe("pop_counts",
                                  lambda ctx: orig(ctx) + bump),))


def stdp_noop(sim, setattr=setattr):
    """``stdp_update`` (potentiation and clip) does nothing: K4's
    depression and the traces go on."""
    from repro_torch.kernels import stdp

    def noop(weights, targets, pmask, in_syn, pmask_in, ids, x_pre, x_post,
             spiked, coef, *, full, clip_all):
        return weights, x_pre, x_post
    setattr(stdp, "stdp_update", noop)
    setattr(stdp, "stdp_update_plain", noop)


def depression_flipped(sim, setattr=setattr):
    """K4's depression with its sign flipped: a pre spike raises its
    outgoing plastic weights by as much as it should lower them."""
    bound = sim.backend.bound
    setattr(bound, "coef", bound.coef._replace(dep=-bound.coef.dep))


def delay_off(sim, setattr=setattr, every: int = 100):
    """Every ``every``-th source's synapses delivered one delay bin late
    (at most the ring's last bin): a moderate fault of delivery."""
    tables = sim.backend.net.tables
    d_max = sim.connectome.d_max_bins
    rows = torch.arange(0, sim.connectome.n_total, every,
                        device=tables.dbins.device)
    tables.dbins[rows] = (tables.dbins[rows] + 1).clamp(max=d_max - 1)


def drive_dropped(sim, setattr=setattr, population: int = 5):
    """One population's Poisson drive dropped (PD14's L4I): a moderate
    fault of the drive."""
    c = sim.connectome
    lo, hi = int(c.pop_offsets[population]), int(c.pop_offsets[population + 1])
    for basis in sim.backend.drive.bases:
        if basis is not None:
            basis[lo:hi] = 0


FAULTS = {f.__name__: f for f in (step_unchanged, count_altered, stdp_noop,
                                  depression_flipped, delay_off,
                                  drive_dropped)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--fault", required=True, choices=sorted(FAULTS))
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("perfbench faults: no CUDA card", file=sys.stderr)
        return 2
    from perfbench import bench
    fault = FAULTS[args.fault]
    for seed in args.seeds:
        out = bench.run_cell(args.workload, seed, args.seconds, False,
                             root=ROOT, fault=lambda sim: fault(sim))
        print(json.dumps({"workload": args.workload, "fault": args.fault,
                          "seed": seed, "correct": out["correct"],
                          "attempted": out["attempted"],
                          "checks": out["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
