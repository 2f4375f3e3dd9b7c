"""Run one benchmark cell once and print its result as the last line.

    python3 perfbench/run.py --workload pd14_static.free_bg --seed 7 \
        --seconds 51 --trace 0

Run from the root of a checkout that holds ``BENCHMARK.json``,
``perfbench/`` and the port (``src/repro_torch``).  The cell runs on the
CUDA card; without one (or with fewer cards than the cell asks for) the
run exits with code 2 and prints no result, and so it does when the port
is missing or, once the window has closed, JAX or the JAX package is
loaded in this process.  The port's kernels build once into
``build/kernels/`` of the checkout.
"""
from __future__ import annotations

import os
import time


def _process_age_s() -> float:
    """Seconds since this process started (Linux's ``/proc``), so that
    ``setup_s`` counts the interpreter's start and the imports."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


T_PROCESS = time.perf_counter() - _process_age_s()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    import torch
    from perfbench import bench
    try:
        files = bench.cell_files(ROOT, args.workload)
        if not (ROOT / "src" / "repro_torch").is_dir():
            raise bench.RunError("the port (src/repro_torch) is not in "
                                 "this checkout")
        chips = int(files["cell"]["chips"])
        cards = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        if cards < chips:
            raise bench.RunError(f"the cell needs {chips} CUDA card(s); "
                                 f"{cards} available")
        out = bench.run_cell(args.workload, args.seed, args.seconds,
                             bool(args.trace), root=ROOT,
                             t_process=T_PROCESS)
        found = bench.forbidden_modules()
        if found:
            raise bench.RunError(f"JAX or the JAX package is loaded: "
                                 f"{found}")
    except bench.RunError as e:
        print(f"perfbench: {e}", file=sys.stderr)
        return 2
    sys.stdout.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
