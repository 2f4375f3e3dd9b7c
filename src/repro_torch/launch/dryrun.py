"""Multi-pod dry run: the full-scale sharded microcircuit step laid out on
``meta`` tensors, nothing allocated.  The counterpart of
``repro.launch.dryrun``.

For each cell (a delivery strategy on a production mesh,
``launch.mesh.make_production_mesh``) one rank's step is run on ``meta``
tensors (shapes and dtypes, no storage, no card) at the full scale of
the reference's ``lower_microcircuit`` (``dryrun.py:93-139``):
N = 77,169 neurons padded to 77,312, D = 46 delay bins, the 8 Hz
background, and it reports per rank:

* the argument bytes (the rank's tables and state; for ``dense`` its
  bfloat16 ``W`` block);
* the largest tensors a step makes, and their sum over a step (an upper
  bound of what the step holds at once);
* the collective bytes a step (``perf.step_analysis.analyze_step``; an
  all-reduce counted twice) and the FLOPs a step (the dispatched ops', and
  the kernels' as their ``meta`` forms report them);
* whether the rank fits in the card's memory (``launch.mesh.HBM_BYTES``).

Shapes are the delivery strategies: ``event`` is NEST's scheme
(``core/distributed.sharded_step``: K1 over the rank's slice, the spike
registry all-gathered, K2's local-ring form over the rank's
``[N_pad+1, k_loc]`` block, ``k_loc = λ + 8√λ + 4`` with λ the mean
synapses per source and rank); ``dense`` the delay-binned ``W[D, N, N]``
sharded 2-D (``core/distributed.make_dense_step``: K5 over the rank's
block, an all-reduce over ``data``, an all-gather over ``model``).
Results land in ``artifacts/dryrun_torch/<arch>__<shape>__<mesh>.json``.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --shape event \\
        --mesh pod1
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
"""
from __future__ import annotations

import argparse
import json
import time
import traceback
import types
from pathlib import Path

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS
from repro_torch.launch import mesh as M

ART_DIR = Path(__file__).resolve().parents[3] / "artifacts" / "dryrun_torch"

#: the reference's full-scale cut: N padded to a multiple of 512 (which
#: divides 256 and 512 ranks), D delay bins, 100 steps a chunk
PAD = 512
D_RING = 46
SPIKE_BUDGET = 512
STRATEGIES = ("event", "dense")


def _nbytes(tree) -> int:
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(_nbytes(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return sum(_nbytes(v) for v in tree)
    if isinstance(tree, torch.Generator):
        return tree.get_state().numel()
    return 0


def full_scale() -> dict:
    """The full-scale model's sizes (the reference's)."""
    from repro_torch.core import params as MP
    from repro_torch.core.params import NeuronParams
    n_full = np.array([MP.N_FULL[p] for p in MP.POPULATIONS])
    return {
        "n": int(n_full.sum()),                                # 77,169
        "n_syn": int(MP.synapse_numbers(n_full, MP.CONN_PROBS, n_full,
                                        1.0).sum()),
        "n_exc": int(n_full[:MP.N_EXC_POPS].sum()),
        "w_ext": MP.psc_from_psp(0.15, NeuronParams()),
        "k_ext": np.repeat(MP.K_EXT, n_full).astype(np.float32),
    }


def event_k_loc(n_syn: int, n: int, n_dev: int) -> int:
    """The reference's per-rank ELL width: λ + 8√λ + 4, λ the mean
    synapses a source has on one rank."""
    lam = n_syn / n / n_dev
    return int(lam + 8 * lam ** 0.5 + 4)


def event_rank_args(n_pad: int, n_dev: int, k_loc: int, d_ring: int):
    """One rank's ``(state, tables)`` of the event step on ``meta``: its
    ``ShardedSimState`` (``[n_loc]`` slices, the ring ``[D, 2, n_loc + 1]``,
    its generator's state) and its ``[N_pad + 1, k_loc]`` block."""
    from repro_torch.core import distributed as DD
    n_loc = n_pad // n_dev
    meta = lambda shape, dtype: torch.empty(shape, dtype=dtype,
                                            device="meta")
    state = DD.ShardedSimState(
        V=meta((n_loc,), torch.float32), I_ex=meta((n_loc,), torch.float32),
        I_in=meta((n_loc,), torch.float32),
        refrac=meta((n_loc,), torch.int32),
        ring=meta((d_ring, 2, n_loc + 1), torch.float32),
        t=meta((), torch.int32),
        generator=meta((DD.GENERATOR_STATE_BYTES,), torch.uint8),
        overflow=meta((), torch.int32))
    tables = DD.ShardedTables(
        targets=meta((n_pad + 1, k_loc), torch.int32),
        weights=meta((n_pad + 1, k_loc), torch.float32),
        dbins=meta((n_pad + 1, k_loc), torch.int32),
        k_ext=meta((n_loc,), torch.float32),
        i_dc=meta((n_loc,), torch.float32))
    return state, tables


def rank_argument_bytes(n: int, n_dev: int, k_loc: int,
                        d_ring: int = D_RING) -> int:
    """The event step's argument bytes on one rank of ``n_dev`` (``N``
    padded to a multiple of ``n_dev`` only, as the sharded backend pads):
    what a rank's tables and state hold."""
    n_pad = -(-n // n_dev) * n_dev
    return _nbytes(event_rank_args(n_pad, n_dev, k_loc, d_ring))


def lay_out_event(layout, model: dict):
    """``(step, run_args, args, info)`` of one rank's event step on
    ``layout``: the step, what it is called with, the rank's arguments
    (its tables and state, the generator's state a tensor) and sizes."""
    from repro_torch.core import distributed as DD
    from repro_torch.core import kernel_policy as kpol
    from repro_torch.core import stimulus as stim
    from repro_torch.core.engine import SimConfig
    from repro_torch.core.neuron import Propagators
    from repro_torch.core.params import NeuronParams

    n, n_dev = model["n"], layout.size()
    n_pad = -(-n // PAD) * PAD
    k_loc = event_k_loc(model["n_syn"], n, n_dev)
    state, tables = event_rank_args(n_pad, n_dev, k_loc, D_RING)
    n_loc = n_pad // n_dev
    cfg = SimConfig(dt=0.1, strategy="ell", spike_budget=SPIKE_BUDGET,
                    kernels=kpol.resolve("split", strategy="ell",
                                         state_dtype=torch.float32,
                                         device="cuda"),
                    stimulus=(stim.PoissonBackground(),))
    neuron = NeuronParams()
    drive = stim.compile_drive(cfg.stimulus,
                               types.SimpleNamespace(k_ext=model["k_ext"]),
                               cfg, neuron, "cpu").shard(n_pad, 0, n_loc,
                                                         "meta")
    net = DD.shard_network(tables, torch.empty(n_pad, dtype=torch.int32,
                                               device="meta"))
    prop = Propagators.make(neuron, cfg.dt)
    world = M.World(rank=0, size=n_dev, group=None)

    def step(st):
        return DD.sharded_step(st, net, prop, cfg, w_ext=model["w_ext"],
                               n_exc=model["n_exc"], drive=drive,
                               gather=world.gather)
    info = {"n_pad": n_pad, "n_loc": n_loc, "k_loc": k_loc,
            "spike_budget": SPIKE_BUDGET}
    # the step draws without a generator (meta tensors have none)
    return step, (state._replace(generator=None),), (state, tables), info


def lay_out_dense(layout, model: dict):
    """``(step, run_args, args, info)`` of one rank's dense step on
    ``layout``: its bfloat16 ``W`` block by ``dense_shardings``, the
    replicated state."""
    from repro_torch.core import distributed as DD
    from repro_torch.core.neuron import Propagators
    from repro_torch.core.params import NeuronParams
    from repro_torch.sharding.rules import local_shape

    n_pad = -(-model["n"] // PAD) * PAD
    state, W, aux = DD.abstract_dense(n_pad, D_RING)
    _, w_sh, _ = DD.dense_shardings(layout, state, W, aux)
    W_blk = torch.empty(local_shape(W.shape, w_sh, layout),
                        dtype=W.dtype, device="meta")
    world = M.layout_world(layout)
    prop = Propagators.make(NeuronParams(), 0.1)
    sim = DD.make_dense_step(world, prop, n=n_pad, n_exc=model["n_exc"],
                             w_ext=model["w_ext"], bg_rate=8.0, dt=0.1,
                             n_steps=1)
    run_state = state._replace(generator=None)
    info = {"n_pad": n_pad, "w_block": list(W_blk.shape),
            "w_dtype": str(W_blk.dtype)}
    return sim.step, (run_state, W_blk, aux), (state, W_blk, aux), info


def run_cell(arch: str, shape_name: str, mesh_name: str,
             out_dir: Path = ART_DIR, force: bool = False) -> dict:
    """Lay out one cell and write its JSON (read back if it exists and
    ``force`` is not set)."""
    from repro_torch.perf.step_analysis import analyze_step
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    key = f"{arch}__{shape_name}__{mesh_name}"
    path = out_dir / f"{key}.json"
    if path.exists() and not force:
        return json.loads(path.read_text())
    if arch not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; known: {list(ARCH_IDS)}")
    if shape_name not in STRATEGIES:
        raise KeyError(f"unknown shape {shape_name!r}; known: {STRATEGIES}")
    layout = M.make_production_mesh(multi_pod=mesh_name == "pod2")
    model = full_scale()
    t0 = time.perf_counter()
    lay_out = lay_out_event if shape_name == "event" else lay_out_dense
    step, run_args, args, info = lay_out(layout, model)
    cost = analyze_step(step, *run_args)
    arg_bytes = _nbytes(args)
    temp = cost["intermediate_bytes_per_step"]
    result = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "mesh_shape": list(layout.shape),
        "mesh_axes": list(layout.axis_names),
        "n_devices": layout.size(), "n": model["n"],
        "params": model["n_syn"], "d_ring": D_RING, **info,
        "flops_per_device": cost["elementwise_flops_per_step"]
        + cost["matmul_flops_per_step"] + cost["kernel_flops_per_step"],
        "kernel_flops_per_device": cost["kernel_flops_per_step"],
        "bytes_accessed_per_device": cost["bytes_per_step"],
        "memory": {
            "argument_bytes": arg_bytes,
            "temp_bytes_upper_bound": temp,
            "largest_intermediates": cost["largest_intermediates"],
            "device_bytes": M.HBM_BYTES,
            "fits": arg_bytes + temp <= M.HBM_BYTES,
        },
        "kernels": cost["kernels"],
        "collectives": cost["collectives"],
        "collective_wire_bytes_per_device":
            cost["collective_wire_bytes_per_step"],
        "device": M.DEVICE_NAME,
        "layout_s": round(time.perf_counter() - t0, 3),
    }
    path.write_text(json.dumps(result, indent=1) + "\n")
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.dryrun",
        description="lay out the full-scale sharded microcircuit step on "
                    "meta tensors")
    ap.add_argument("--arch", default=None, choices=list(ARCH_IDS))
    ap.add_argument("--shape", default=None, choices=list(STRATEGIES))
    ap.add_argument("--mesh", default=None, choices=("pod1", "pod2"))
    ap.add_argument("--all", action="store_true",
                   help="every arch x shape x mesh cell")
    ap.add_argument("--force", action="store_true",
                    help="lay out again a cell whose JSON exists")
    ap.add_argument("--out-dir", default=str(ART_DIR))
    args = ap.parse_args(argv)
    if not args.all and args.shape is None:
        ap.error("give --shape (and --mesh), or --all")

    archs = [args.arch] if args.arch else list(ARCH_IDS)
    shapes = [args.shape] if args.shape else list(STRATEGIES)
    meshes = [args.mesh] if args.mesh else ["pod1", "pod2"]
    n_ok = n_fail = 0
    for arch in archs:
        for shape in shapes:
            for mesh_name in meshes:
                key = f"{arch}__{shape}__{mesh_name}"
                try:
                    r = run_cell(arch, shape, mesh_name,
                                 out_dir=Path(args.out_dir), force=args.force)
                    mem = r["memory"]
                    gb = (mem["argument_bytes"]
                          + mem["temp_bytes_upper_bound"]) / 1e9
                    print(f"OK   {key:40s} flops/dev="
                          f"{r['flops_per_device']:.3e} "
                          f"args/dev={mem['argument_bytes'] / 1e9:.3f}GB "
                          f"mem/dev<={gb:.3f}GB fits={mem['fits']} "
                          f"coll={r['collective_wire_bytes_per_device']:.3e}B",
                          flush=True)
                    n_ok += 1
                except Exception:  # noqa: BLE001 (one cell's failure)
                    print(f"FAIL {key}", flush=True)
                    traceback.print_exc()
                    n_fail += 1
    print(f"\ndry-run: {n_ok} ok, {n_fail} failed")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
