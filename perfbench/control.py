"""The check's control: the plain reference in bfloat16, in the program's
place, held to the float32 reference by the cell's own numbers.

    python3 perfbench/control.py --workload pd14_static.free_bg \
        --seeds 11 12 13

The configuration states float32 state and weights, and the nearest lower
precision is bfloat16.  For each seed the control draws the cell's network
and its initial state from the seed as the benchmark does, runs the
presim, then the mix's segments (each from the state saved after the
presim where the mix restores one), and the float32 reference follows the
control's state at each segment's start (in a plastic cell the first
``weight_runs`` segments are whole runs, and the weights' change over each
is compared as well).  One JSON line a seed gives the
numbers that ``perfbench/check.py`` compares and whether the cell's limits
judge them correct (they must not).  The benchmark's own runs never run
this.  On the card it runs at the cell's own size; the tests run it small
on the CPU.
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

from perfbench import bench  # noqa: E402
from perfbench import check as check_mod  # noqa: E402


def control_numbers(workload: str, seed: int, *, root: Path = ROOT,
                    device=None, overrides=None,
                    dtype=torch.bfloat16) -> dict:
    """The cell's numbers with the reference in ``dtype`` in the
    program's place."""
    files = bench.cell_files(root, workload)
    config, traffic = dict(files["config"]), dict(files["traffic"])
    if overrides:
        config.update(overrides.get("config", {}))
        traffic.update(overrides.get("traffic", {}))
    network = bench.load_network(config, root)
    dev = torch.device("cuda" if device is None else device)
    seeds = bench._seeds(seed)
    net = network.draw(config, seeds["net"], dev)
    sums = check_mod.table_sums(net.targets, net.weights, net.dbins)
    c = network.connectome(net)
    del net
    plastic = bool(config.get("plasticity"))
    ctl = network.reference(c, config, traffic, dev, dtype=dtype)
    ref = network.reference(c, config, traffic, dev)
    state = network.fresh(c, seeds["key"], dev, dtype, plastic=plastic)
    as_t = lambda a: torch.as_tensor(a, device=dev)
    weights = as_t(c.weights).to(dtype)
    if plastic:
        state["weights"] = weights
    v0_bad = check_mod.fresh_mismatch(
        state, network.fresh(c, seeds["key"], dev, plastic=plastic))
    tables_bad = check_mod._sums_differ(
        check_mod.table_sums(as_t(c.targets), weights, as_t(c.dbins)), sums)
    presim = int(round(config["t_presim_ms"] / config["dt_ms"]))
    _, state = ctl.advance(state, presim)
    saved = state if traffic.get("restore") == "after_presim" else None
    steps = int(traffic["check"]["steps"])
    whole = check_mod.run_steps(config, traffic)
    weight_runs = int(traffic["check"].get("weight_runs", 0)) \
        if plastic and traffic["pattern"] == "free" else 0
    pairs, wpairs = [], []
    for i in range(int(traffic["check"]["segments"])):
        start = state if saved is None else {
            **saved, "generator_state": state["generator_state"]}
        if i < weight_runs:
            got, state = ctl.advance(start, whole)
            ref_counts, ref_end = ref.advance(start, whole)
            pairs.append((got[:steps], ref_counts[:steps]))
            wpairs.append(tuple(
                r.change_sq(e["weights"], start["weights"]).cpu().numpy()
                for r, e in ((ctl, state), (ref, ref_end))))
            continue
        got, state = ctl.advance(start, steps)
        pairs.append((got, ref.follow(start, steps)))
    numbers = {"v0_mismatch": v0_bad, "tables_mismatch": tables_bad,
               "counts_gap": check_mod.counts_gap(pairs),
               "segments": len(pairs)}
    if plastic:
        numbers["weights_gap"] = check_mod.weights_gap(
            wpairs, len(c.pop_sizes)) if wpairs else None
    correct, compared = check_mod.judge(numbers, files["limits"])
    return {"workload": workload, "seed": seed, "dtype": str(dtype),
            "numbers": numbers, "correct": bool(correct),
            "checks": compared}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("perfbench control: no CUDA card", file=sys.stderr)
        return 2
    for seed in args.seeds:
        print(json.dumps(control_numbers(args.workload, seed)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
