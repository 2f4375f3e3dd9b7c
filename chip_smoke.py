#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py                 # full scale (the default)
    python3 chip_smoke.py --scale 0.1 --t-sim 100 --scale-dense 0.05
                                          # a quicker look

Phases, each on its own line; any failed check exits non-zero:

1. the card (``nvidia-smi`` name and power limit) and the kernels' build
   from ``src/repro_torch/csrc`` (one ``nvcc`` per source, all at once);
   the bfloat16 K6's ``ptxas`` registers and spills (none allowed), its
   shared memory, and its ``HGMMA`` and ``UTMALDG`` instructions (by
   ``cuobjdump -sass``; each of its three instantiations must have both);
2. K1 ``lif_update`` on N = 77,169 random neurons, bitwise against its
   plain PyTorch version;
3. K2 ``ell_deliver`` (the delivery-only form of K3's kernel), K3
   ``lif_deliver`` and K4 ``lif_deliver_plastic``
   on the connectome's ELL tables with budget 256, at 0, 31, 256 and 300
   random spikes, and at the edges of K3's compaction tiles: one spike at
   N - 1; the first and last neuron of every tile (budget 512); 200 spikes
   in one tile; an overflow cut inside a tile that is not the first; a
   burst of 5,000 with budget 8,192: ids, overflow, spikes, V and refrac
   exact (K4 also its traces and the written-back weights), the ring (and
   the currents fed from it) within rtol = atol = 1e-5 (float atomics add
   in no fixed order); 2,000 launches of K3 back to back on one workspace
   at changing spike counts, each launch's ids and overflow exact against
   ``compact_ids_plain`` and the workspace's launch count advanced 2,000;
   400 launches of K2 and K3 in turns on that workspace, the same checks
   (``[K2_K3_interleaved]``);
   then ``stdp_update`` at the four random spike counts and the burst
   (budget 8,192, the most ids the kernel keeps in shared memory), and at
   10,000 spikes with budget 9,000 (the ids read from global memory, 1,000
   spiking targets cut), with and without the depression and the
   whole-table clip, bitwise (weights and traces) from a table with E->E
   weights above w_max; and the plastic tables' build time and bytes;
4. the port against its plain reference on the card at scale 0.02: the
   fused and split paths give the reference's spike raster, static and
   with pair STDP (and then the reference's final weights, bitwise);
5. the main path at ``--scale`` (default 1.0) through
   ``Simulator(MicrocircuitConfig(scale, strategy="ell"))``, its loop in
   CUDA graphs: the ``auto`` policy must resolve to ``fused``; warmup
   (the graphs' capture), 100 ms presim, a ``--t-sim`` ms run; RTF,
   overflow (must be 0), population rates (must lie in
   ``ref*(1 -+ 0.5) -+ 1`` Hz) and launch counts (K3 once per step, a
   graph replay counting the launches it holds);
   then 200 more steps under ``torch.profiler``: device time per step by
   kernel, the host's time by op, and the device's idle share of the
   unprofiled step; then ``[graph_draws]`` (two replays of one graph of
   the drive draw different Poisson counts, each the eager draw from the
   same generator state), ``[graph_static]`` (the graphed loop against
   ``backend="instrumented"``, the eager loop, 300 steps from one state
   and generator state: ``t``, overflow, refrac, the spike raster, the
   population counts and the generator's state exact; V, the currents
   and the ring within rtol = atol = 1e-5, since K3's float atomics add
   in no fixed order, with the elements whose bits differ counted),
   ``[main_path_eager]`` (the eager loop's ms a step beside the graphed
   one's) and ``[run_chunked]`` (5 chunks of 10 ms: the graph cache's
   misses the same after each, the population counts equal to one
   50 ms run's from the same state, the state as in ``[graph_static]``);
   then the ``[analysis]`` lines of the main path's session:
   ``[graph_contract] path=static`` (GC001-GC004 of
   ``repro_torch.analysis.graph_contract.check_graphed``: warm runs of
   150 and 300 steps are graph replays only, as many as the cache key
   implies, with the same eager work around them, under
   ``torch.cuda.set_sync_debug_mode("error")``; the census of one eager
   step within the cast budget, with no host sync and no float64 tensor;
   K3 and ``pop_counts`` once a step; no device-to-host copy and no
   float64 kernel in one
   replayed body), ``[step_census]`` (the profiler's table of that body:
   each kernel's launches and device µs a step, their sum against the
   body replay's event time and the run's graphed ms a step) and
   ``[sanitize]`` (a warm 100-step run under ``sanitize()`` raises
   nothing; the same run with a NaN arrival in the ring slot that step 37
   reads raises ``FloatingPointError`` at step 37, in ``I_ex``);
6. a 100 ms run of the split path, which launches K1 and K2, and
   ``[graph_split]``, as ``[graph_static]``;
7. the plastic path at ``--scale`` with ``plasticity="pair_stdp"``: the
   ``auto`` policy must resolve to ``fused``; warmup (which must leave the
   weights alone), 100 ms presim, a ``--t-sim-plastic`` ms run; RTF,
   overflow 0, rates in the same bands, launches (K4 and ``stdp_update``
   once per step), every weight finite, the plastic ones in
   ``[0, w_max]``, every other one bitwise the connectome's; the mean
   plastic weight before and after (outside the timed window); 200
   profiled steps, as in 5; ``[graph_plastic]`` (as ``[graph_static]``,
   against the eager split plastic loop, the run's head steps and
   whole-table clip included; the weights and traces exact),
   ``[plastic_path_eager]`` and ``[graph_contract] path=plastic`` (as
   for the static path; K4, ``stdp_update`` and ``pop_counts`` once a
   step);
8. the kernels' times at the main paths' shapes beside their bounds:
   device time per call from ``torch.profiler`` (``ms``) and the
   back-to-back call time from CUDA events (``call_ms``); for K3 and K4
   also the phase table of 64 stamped launches (``[K3_phases]``,
   ``[K4_phases]``: per phase of ``lif_deliver.PHASES``, the median, mean
   and largest microseconds over blocks and launches by ``%globaltimer``),
   and 64 launches captured in one ``torch.cuda.CUDAGraph``, replayed,
   each launch's outputs held to the same launches run eagerly (exact, the
   ring and currents within 1e-5), and timed (``graph_ms`` a launch,
   ``[K3_graph]``, ``[K4_graph]``); the same for K2 (``[K2_phases]`` over
   the first five phases, ``[K2_graph]``: ids and overflow exact, the ring
   within 1e-5) and for ``stdp_update``'s two per-step forms
   (``[stdp_phases]`` over ``stdp.PHASES``, ``[stdp_graph]``: weights and
   traces bitwise); ``[pop_counts_probe]``, the probe's kernel against its
   plain version and an ``index_add_`` on 64 spike vectors (equal counts),
   each one's time;
9. the session API on the full-scale connectome, each sub-phase's
   launches counted from 0 (the kernels of its path must have launched):
   ``[shared_backend]``, two static sessions on one ``FusedBackend``
   (no presim), run in turns (a, b, a, b, 150 steps each), against one
   lone session that runs a's seed and then b's: the second session's
   construction builds and captures nothing, and neither do its runs;
   spikes, population counts, ``t``, overflow, refrac and the generator
   exact, V, the currents and the ring within rtol = atol = 1e-5 (K3's
   float atomics); ``[experiment_full]``, ``Experiment(model=
   MicrocircuitConfig(scale, strategy="ell"), validate=True,
   duration_ms=1000)`` with the built connectome (warmup first, 100
   sampled neurons a population), the table printed with the RTF and the
   graph cache's counters, and its witness: the same experiment on the
   instrumented backend's eager loop with ``kernels="reference"`` (plain
   PyTorch, no kernel launched, no graph).  Every check of the report must
   pass, or else fail on the witness too, with values within
   ``WITNESS_RTOL`` of each other (at natural density the synchrony
   statistic lies above the reference's band on both: 13.6-17.1 at full
   scale against [0, 8], ``tools/synchrony_scale.py``);
   ``[run_batch]``, 3 trials of 200 ms, each with its presim, over the
   experiment's backend (shared), after ``warmup_batch``: each trial's
   RTF and rates (in band), trial 0's spikes and population counts over
   its first 300 steps exactly a fresh session's with its seed, the
   session's own state bitwise unchanged, no capture in the batch (and
   none after trial 0 in any batch: ``run_batch`` raises);
   ``[checkpoint]`` (static) and ``[checkpoint_plastic]`` (pair STDP):
   100 ms presim, 100 ms, ``save``
   into a temporary directory (removed after), 30 ms (A), ``restore``,
   30 ms (B): no capture, A and B exact (the weights and traces too) but
   V, the currents and the ring (within 1e-5), the checkpoint's bytes, the
   save and restore seconds; ``torch.cuda.memory_allocated`` before and
   after a ``suspend``, then ``resume`` and the next 30 ms held to an
   untouched twin's; ``[scenarios]``, each of ``examples/scenarios/*.json``
   at its own scale and duration through ``Experiment.run``: every one
   that validates must pass;
9b. the sharded backend (``sharded_phase``) on the full-scale connectome
   (``ell``), each sub-phase's launches counted from 0:
   ``[sharded_localize]``, ``distributed.localize_ell`` on the card for 1
   and 4 ranks (seconds, peak device bytes, ``k_loc``), and the shards
   hold every real (source, global target, weight, delay bin) entry of
   the connectome once (per-source counts and two hash sums);
   ``[K2_local]``, K2's local-ring form on rank 2 of 4's block against its
   plain version at 0, 31, 256 and 300 random global spikes (budget 256)
   and a burst of 5,000 (budget 8,192): ids and overflow exact, the ring
   within rtol = atol = 1e-5; ``[timing_K2_local]``, its device time at
   the main path's mean spike count beside its bound (bytes as
   ``k2_bytes`` counts them), its plain version's and one ``index_add_``'s;
   ``[sharded_four_dc]``, four shards stepped in one process (the gather a
   concatenation) from a world of one's state after its 100 ms presim
   under ``dc()``, 300 steps against the world of one: the registry and
   the population counts exact, V within 1e-5; ``[sharded_four]``, four
   shards under the 8 Hz background (each rank's generator seeded by
   ``distributed.rank_seed``), 100 ms presim and 1,000 ms: overflow 0,
   rates in band, K1 and K2's local-ring form 4 times a step, ms a step
   (an eager loop); ``[sharded_one]``, ``Simulator(MicrocircuitConfig(
   scale, strategy="ell"), backend="sharded")`` without a process group,
   graphed: warmup, 100 ms presim, a ``--t-sim`` ms run, RTF (beside the
   main path's from the same call), overflow 0, rates in band, K1 and
   K2's local-ring form once a step, ``pop_counts`` once a recorded step
   and nothing else; then
   ``[sharded_one_hold]``, 300 steps from one state and generator state
   against a fused session with ``kernels="split"``: the registry against
   its spikes, the population counts, ``t``, overflow, refrac and the
   generator exact, V, the currents and the ring within 1e-5;
   ``[sharded_nccl]`` and ``[sharded_nccl_hold]``, the same over an NCCL
   process group of one (``launch/mesh.init_single_process_group``), the
   all-gather captured in the graphs, the group destroyed after;
9c. sharded sessions that checkpoint and serve, and the core's functional
   entry points (``sharded_sessions_phase``), on the full-scale connectome
   (``ell``), each sub-phase's launches counted from 0:
   ``[sharded_checkpoint]``, a graphed world of one (``backend=
   "sharded"``): 100 ms presim, 150 steps, ``save`` (the reference's
   global layout), 150 steps (A); a new session on the same backend with
   another seed ``restore``s and runs 150 steps (B): the registry, the
   population counts, ``t``, overflow, refrac and the generator exact, V,
   the currents and the ring within 1e-5 (elements with other bits
   counted), the graph cache's misses unmoved by the restore and B's run;
   the checkpoint's bytes, the save and restore seconds; then the
   resident session (B) and the other (A) suspended, the device bytes
   each suspend frees, both resumed and run 150 steps against each other
   (the same checks, no capture); K1, K2's local-ring form and
   ``pop_counts`` only;
   ``[sharded_checkpoint_nccl]``, the same over an NCCL group of one, the
   save's gather through the collective; ``[serve_sharded]``, a
   ``SessionManager`` on ``backend="sharded"`` at scale
   ``SERVE_SHARDED_SCALE`` (its pool builds its own connectome): a second
   create that builds and captures nothing, 30 ms in 4 chunks exact
   against a twin's one run, 200 ms in 4 chunks (RTF), the resident and a
   non-resident session suspended (bytes freed) and resumed, each 20 ms
   against a twin carried from its state, and two coalesced sessions
   against two run one by one (spikes and counts exact, the state within
   1e-5), K1, K2's local-ring form and ``pop_counts`` only;
   ``[core_simulate]``, ``repro_torch.core.simulate`` with
   ``kernels="split"``: 100 ms from a fresh state, then 100 ms timed (ms a
   step; K1 and K2 once a step and nothing else, overflow 0, rates in
   band) and 300 steps recording spikes, held exact against the
   instrumented session from the same state and generator state;
   ``[core_simulate_plastic]``, ``simulate_plastic`` for 300 steps (K4 and
   ``stdp_update`` once a step), its counts and mean plastic weight
   bitwise ``Simulator(plasticity=...)``'s from the same seed (the shim
   is that session, so this checks its wiring and that a seed determines
   the run, not the plastic path itself: phase 7 holds that);
   ``[phase_runner]``, ``PhaseRunner.step_timed`` for 100 steps: the
   reference's timer keys, K1 and K2 once a step and once in the
   backend's warm-up and nothing else, the spikes exact against the
   instrumented session's;
10. the dense strategy, once the full-scale sessions are freed:
   (b) at scale 0.02 its split path (K1 + K5, bin-major table) against its
   reference path (two ``torch.matmul`` GEMVs on the source-major table)
   over 1,000 steps: the rasters equal, or the JAX package's own
   dense-versus-event bar (``tests/test_delivery.py``: at least 99 % of the
   per-step population counts equal, each population's sum within 2 %,
   ``atol`` 3); (c) the dense path at ``--scale-dense`` (default 0.2, the
   widest whose 43.8 GB table fits the card with room for the checks):
   ``auto`` must resolve to the split step with K5; warmup, 100 ms presim,
   a ``--t-sim-dense`` ms run; K1 and K5 once per step, overflow 0, rates
   in band; the session's build time (the table's, on the card), the
   table's bytes and the peak allocation; 200 profiled steps, as in 5;
   (a) K5 on the session's table against its plain version at 0, 1, 5,
   64 and more spikes than ``spike_budget``, bitwise (one fixed sum order,
   no atomics), with a float32 and a bfloat16 table; (d) K5's times at
   the dense path's mean spike count, and one batched ``torch.matmul`` of
   the spikes against the whole table (TF32 off) as the library call;
   (e) ``[graph_dense]``: the graphed dense loop against the eager one,
   300 steps from one state, every tensor bitwise (K1 and K5 add in a
   fixed order; the eager session is built once the graphed one is
   freed, two tables not fitting the card), and ``[dense_path_eager]``;
   and, before (e), ``[dense_sharded]``: ``distributed.make_dense_step``
   as a world of one over an NCCL group of one (a ``(1, 1)`` host mesh)
   on the dense path's table, 300 steps under the 8 Hz background: K5
   launched exactly once a step and nothing else, every tensor and count
   bitwise the same steps' with K5's plain version from the same state
   and generator state, ms a step;
11. K6 ``flash_attention`` and the LM layers at Qwen3-32B widths
   (``d_model`` 5120, 64 query and 8 KV heads of 128, ``d_ff`` 25600,
   qk-norm, rope theta 1e6; the Hugging Face model card Qwen/Qwen3-32B),
   once the dense session is freed, with random weights from ``--seed``:
   (a) K6 against its float32 plain version on the same values at B = 1,
   Hq = 64, Hkv = 8, D = 128: causal T = S = 4096, causal T = S = 4000
   (ragged), full T = 4096, S = 1500, and a 512-token prefill at
   ``q_offset`` 3584 into 4096 keys; and at ``tests/test_kernels.py``'s
   four shapes (D = 32 and 64, B = 2, ragged T, cross-shaped); each in
   float32 (the CUDA-core kernel, within 2e-5, that test's tolerance),
   in bfloat16 (the tensor-core kernel, within
   ``flash_attention.bf16_bar``: it rounds P to bfloat16 as the JAX
   layers do) and in bfloat16 with q = 0, where every live p is exactly 1
   (within one rounding of the output: rtol 2**-7, atol 1e-4); each
   launch prints its largest error, the error's and the reference's RMS
   and its largest error over its bar; (b) one layer in bfloat16, B = 1,
   T = 4096: ``rms_norm``,
   ``attention`` (qk-norm, rope, K6), residual, ``rms_norm``, ``mlp``,
   residual, then the cache path: prefills of 2048 and 2047 tokens into a
   4096-slot cache (K6 with ``q_offset`` 0 and 2048 on the cache's filled
   prefix) and one decode step; K6 launched exactly once by the layer and
   three times in all, each launch (on the layer's strided views) held to
   its plain version as in (a); finite, and each element within 2**-7 of
   the value plus 2**-4 of the RMS: the layer's output and attention
   output against the same layer with ``mha`` on K6's plain version, the
   prefills' and the decode step's against the layer's attention rows;
   the layer's attention once more in
   float32, K6's launch and the attention output within 2e-5 of the
   plain version's; (c) one K6 call at T = S = 32768 (the reference's
   ``prefill_32k`` length, its batch cut from 32 to 1), timed with CUDA
   events, its last 512 rows against the plain version over all keys
   (the whole score matrix would take 275 GB); (d) K6's time at (a)'s
   causal shape in bfloat16 (the tensor-core kernel) and float32 (the
   CUDA-core one; the bfloat16 one must be at least 5 times faster) by
   CUDA events over 16 calls, beside its bound (the operations at the
   bf16 tensor-core rate), its plain version's and one
   ``scaled_dot_product_attention`` call's as the library call, with
   that call's own error over ``bf16_bar`` (information, not a gate).
   Every compared tensor's RMS is printed beside its error;
12. the session server (``repro_torch.serve``) over the graphed session,
   its backend pool building its own connectome at ``--scale``, each
   sub-phase's launches counted from 0 and summed under ``serve`` in the
   ``kernels`` line: ``[serve_http]``, a ``SimServer`` on an ephemeral
   port, two ``ServeClient.create`` of ``Experiment(model=
   MicrocircuitConfig(scale, strategy="ell"), probes=("pop_counts",
   "spikes"))`` with seeds 55 and 56 (``auto`` must resolve to the graphed
   fused loop; each create's wall seconds; the second captures and builds
   nothing), then session A's first 30 ms streamed in 4 chunks, each
   chunk's population totals exactly a lone in-process session's
   ``run_chunked`` from the same seed (300 steps after the presim, the
   horizon at which ``[shared_backend]`` holds spikes exact), and its
   next 200 ms streamed in 4 chunks: each chunk's RTF, the overall RTF,
   the request's wall and its time beyond the chunks' walls (the front
   end's cost), rates in band, the chunks' equality to the lone session's
   printed; a second thread polls ``/healthz`` and ``/stats`` throughout
   the creates and runs, and every reply must be 200;
   ``[serve_coalesced]``, four sessions (seeds 57-60) run 20 ms through
   ``run_many(coalesce=True)``, four twins through ``coalesce=False``:
   spikes and population counts exact, V, the currents and the ring
   within 1e-5, no capture after the group's first session, each mode's
   wall seconds; ``[serve_suspend]``, the resident session and a
   non-resident one suspended (``torch.cuda.memory_allocated`` before
   and after each), resumed under the zero-capture guard, and their next
   20 ms held to a twin carried from their state (the same tolerances),
   with the save and resume seconds and the checkpoint's bytes; the same
   for a plastic session of ``examples/scenarios/stdp_ee.json`` at its
   own scale (0.02, ``event``: K1 and ``stdp_update``), its weights and
   traces exact; ``[serve_smoke]``, ``python -m repro_torch.serve
   --smoke examples/scenarios/smoke_background.json`` in a process of its
   own on the card, which must exit 0 (its output printed);
13. ``[dryrun]``: ``repro_torch.launch.dryrun``'s four cells (``event``
   and ``dense`` on the ``pod1`` and ``pod2`` layouts, on ``meta``
   tensors), and ``[dryrun_world_of_one]``: the argument bytes the dry run
   reckons for a world of one at the real ``k_loc`` must equal what phase
   9b's world of one holds (its tables, state and generator);
   ``[analysis]`` sums the seconds of the analysis lines.

The line before the last is ``{"kernels": [...]}``, the last
``{"ok": true, "device": {...}}``.  The script imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import gc
import json
import re
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

from perfbench.roofline import (ENTRY_OPS, FP32_OPS_PER_S, HBM_BYTES_PER_S,
                                LIF_OPS, bound_s, k2_bytes, stdp_bytes)

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

#: dense bfloat16 tensor-core rate of the H100 SXM (NVIDIA data sheet,
#: 700 W), for K6; the other peaks and the kernels' bytes and operations
#: are the benchmark's (perfbench/roofline.py)
BF16_TC_OPS_PER_S = 989e12
RATE_REL_TOL, RATE_ABS_TOL = 0.5, 1.0      # validate/reference.py:60-78
RING_RTOL = RING_ATOL = 1e-5
#: a check that [experiment_full] fails is held to the plain witness's
#: value within this relative tolerance: at full scale the synchrony
#: statistic spreads over 13.6-17.1 across seeds 55-57, so two independent
#: runs differ by up to 26 % (tools/synchrony_scale.py, PERF.md section 6)
WITNESS_RTOL = 0.3
#: Qwen3-32B's attention and MLP widths (the Hugging Face model card
#: Qwen/Qwen3-32B: rms_norm_eps 1e-6, rope_theta 1e6)
QWEN3_32B = dict(name="qwen3-32b", n_layers=64, d_model=5120, n_heads=64,
                 n_kv_heads=8, d_ff=25600, head_dim=128, qk_norm=True,
                 rope_theta=1e6, norm_eps=1e-6)
#: phase 11: (T, S, causal, q_offset) of K6 against its plain version (the
#: last is a 512-token prefill into a 4096-slot cache at index 3584); the
#: layer's and the timing's T; the long call's T = S and the rows it checks
ATTN_SHAPES = ((4096, 4096, True, 0), (4000, 4000, True, 0),
               (4096, 1500, False, 0), (512, 4096, True, 3584))
#: phase 11 (a) also at tests/test_kernels.py's flash-attention shapes,
#: (B, Hq, Hkv, T, S, D, causal): D = 32 and 64, B = 2, ragged T, cross
ATTN_TEST_SHAPES = ((1, 2, 2, 64, 64, 32, True), (2, 4, 2, 128, 128, 64, True),
                    (1, 8, 1, 100, 100, 64, True),
                    (2, 4, 4, 128, 256, 32, False))
ATTN_T, ATTN_T_LONG, ATTN_BAND = 4096, 32768, 512
#: K6 against its float32 plain version on the same values, (rtol, atol)
#: by the output's type: float32 within 2e-5 (tests/test_kernels.py);
#: bfloat16 within one rounding of the output (a bfloat16 ulp is at most
#: 2**-7 of the value, atol 1e-4 for outputs near 0) only in the exact-P
#: cases (q = 0, every live p exactly 1).  Every other bfloat16 launch is
#: held to ``flash_attention.bf16_bar``: the tensor-core kernel rounds P
#: to bfloat16 before P.V, as src/repro/models/layers.py:187 does.
ATTN_TOL = {"torch.float32": (2e-5, 2e-5), "torch.bfloat16": (2 ** -7, 1e-4)}
#: the layer's bfloat16 outputs against the same layer with K6's plain
#: version, whose outputs differ from K6's by a rounding and then pass
#: through bfloat16 products: each element within 2**-7 of its value plus
#: a sixteenth of the reference's RMS
LAYER_RTOL, LAYER_RMS_TOL = 2 ** -7, 2 ** -4
POPS = ("L23E", "L4E", "L5E", "L6E", "L23I", "L4I", "L5I", "L6I")


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def say(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def call_ms(fn, iters: int = 64, warm: int = 3) -> float:
    """Mean milliseconds per call, back to back on the card (CUDA events);
    for launches this small it is the host's launch rate."""
    import torch
    for i in range(warm):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


def device_ms(fn, iters: int = 64):
    """Mean milliseconds of device activity per call: every kernel and
    memset that ``torch.profiler`` records over ``iters`` calls.  None when
    the profiler records no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fn(i)
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == cuda)
    return us / iters / 1e3 if us > 0 else None


def timed(fn, iters: int = 64) -> dict:
    """``ms`` is the device time per call where the profiler sees it, else
    the back-to-back call time; both are kept."""
    dev, call = device_ms(fn, iters), call_ms(fn, iters)
    return {"ms": call if dev is None else dev, "call_ms": call,
            "timing": "events" if dev is None else "profiler"}


def phase_table(stamps, names) -> dict:
    """Per phase of K3's or K4's stamped launches: the median, mean and
    largest microseconds over every block of every launch; ``span``, the
    launch's first stamp to its last over all blocks; ``start_skew``, its
    blocks' first stamps apart; ``tick_ns``, the least nonzero step
    between two stamps of a block (the timer's resolution, or above it).
    ``stamps`` is ``[launches, grid, len(names) + 1]`` int64 ns."""
    import torch
    st = stamps.to(torch.float64) / 1e3
    stats = lambda v: [float(v.median()), float(v.mean()), float(v.max())]
    out = {name: stats(st[:, :, k + 1] - st[:, :, k])
           for k, name in enumerate(names)}
    out["span"] = stats(st[:, :, -1].amax(1) - st[:, :, 0].amin(1))
    out["start_skew"] = stats(st[:, :, 0].amax(1) - st[:, :, 0].amin(1))
    steps = (stamps[:, :, 1:] - stamps[:, :, :-1]).flatten()
    out["tick_ns"] = int(steps[steps > 0].min()) if bool((steps > 0).any()) \
        else None
    return out


def graph_replay(launch, eager, compare, n: int = 64, replays: int = 16):
    """Captures ``launch(0..n-1)`` into one CUDA graph, replays it once and
    holds each launch's outputs to ``eager(i)``'s (the same launches run
    eagerly on copies of the in-place state) with ``compare``; returns the
    milliseconds per launch over ``replays`` more replays (CUDA events)."""
    import torch
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        outs = [launch(i) for i in range(n)]
    g.replay()
    want = [eager(i) for i in range(n)]
    torch.cuda.synchronize()
    for i in range(n):
        compare(i, outs[i], want[i])
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        g.replay()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / (replays * n)


def bitwise(a, b) -> bool:
    """Same shape and the same bits (float tensors compared as int32)."""
    import torch
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and torch.equal(a, b)


def check_rates(rates, what: str) -> None:
    from repro_torch.core.params import FULL_MEAN_RATES
    for p, r, ref in zip(POPS, rates, FULL_MEAN_RATES):
        lo = max(0.0, ref * (1 - RATE_REL_TOL) - RATE_ABS_TOL)
        hi = ref * (1 + RATE_REL_TOL) + RATE_ABS_TOL
        if not lo <= r <= hi:
            fail(f"{what}: population {p} rate {r:.3f} Hz outside "
                 f"[{lo:.3f}, {hi:.3f}]")


def profile_window(sim, t_ms: float, ms_step: float) -> dict:
    """Run ``t_ms`` more under ``torch.profiler``: device time per step by
    kernel, the host's time by op, and the device's idle share of the
    unprofiled step (``ms_step``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        res = sim.run(t_ms)
    by_kernel = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_kernel[e.name] = by_kernel.get(e.name, 0.0) \
                + e.time_range.elapsed_us() / 1e3
    dev_ms_step = sum(by_kernel.values()) / res.n_steps
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    # the host's side: self time of each PyTorch op the profiler records
    # (the Python between the ops, ctypes included, is not in it)
    host = sorted(((a.key, a.self_cpu_time_total / 1e3 / res.n_steps)
                   for a in prof.key_averages()
                   if a.self_cpu_time_total > 0), key=lambda kv: -kv[1])
    return dict(steps=res.n_steps, device_ms_per_step=dev_ms_step,
                wall_ms_per_step=ms_step,
                device_idle_share=1.0 - dev_ms_step / ms_step,
                kernels_ms_per_step=json.dumps(
                    {name[:60]: ms / res.n_steps for name, ms in top}),
                host_op_ms_per_step=sum(ms for _, ms in host),
                host_ops_ms_per_step=json.dumps(dict(host[:10])))


def state_tensors(state) -> dict:
    """A session state's tensors by name, the plastic ones included (a
    sharded session's: its rank's)."""
    if hasattr(state, "V"):
        return {name: getattr(state, name) for name in (
            "V", "I_ex", "I_in", "refrac", "ring", "t", "overflow")}
    sim, ps = (state, None) if hasattr(state, "neuron") else state
    out = {"V": sim.neuron.V, "I_ex": sim.neuron.I_ex,
           "I_in": sim.neuron.I_in, "refrac": sim.neuron.refrac,
           "ring": sim.ring, "t": sim.t, "overflow": sim.overflow}
    if ps is not None:
        out.update(weights=ps.weights, x_pre=ps.x_pre, x_post=ps.x_post)
    return out


def clone_state(state):
    """The state's tensors copied; its generator kept (a session that is
    handed the copy takes that generator's state)."""
    import torch
    from repro_torch.api.backends import tree_map
    return tree_map(torch.clone, state)


#: tensors a scatter with float atomics (K2, K3, K4) feeds: the order of
#: its adds is not fixed, so two runs may differ in their last bits
ATOMIC_FED = ("V", "I_ex", "I_in", "ring")


def compare_states(phase: str, a, b, atomics: bool = True) -> dict:
    """Two sessions' states held to each other: every tensor exact, but
    with ``atomics`` (a path through K2, K3 or K4, whose float atomics add
    in no fixed order) those ``ATOMIC_FED`` within RING_RTOL / ATOL;
    returns the elements whose bits differ, by name."""
    import torch
    bits = {}
    sa, sb = state_tensors(a), state_tensors(b)
    for name, x in sa.items():
        y = sb[name]
        bits[name] = int((x.view(torch.int32) != y.view(torch.int32)).sum()) \
            if x.dtype == torch.float32 else int((x != y).sum())
        if atomics and name in ATOMIC_FED:
            if not torch.allclose(x, y, rtol=RING_RTOL, atol=RING_ATOL):
                fail(f"{phase}: {name} beyond rtol = atol = {RING_RTOL}: "
                     f"max |diff| {float((x - y).abs().max())}")
        elif bits[name]:
            fail(f"{phase}: {name} differs in {bits[name]} elements")
    return bits


def same_runs(phase: str, a, b, steps=None) -> None:
    """Two runs' per-step probes exact (over their first ``steps``)."""
    import numpy as np
    for name in a.data:
        if not np.array_equal(a[name][:steps], b[name][:steps]):
            fail(f"{phase}: {name} differs")



def hold_to_eager(phase: str, graphed, eager, t_ms: float,
                  atomics: bool, probes=("pop_counts", "spikes")) -> dict:
    """``[graph_*]``: the graphed session (``FusedBackend``, CUDA graphs)
    and the eager one (``backend="instrumented"``) run ``t_ms`` from one
    state and generator state, the graphed session's (copied into the eager
    one).  Exact: ``t``, overflow, refrac, the probes' outputs (the spike
    raster and the population counts), the generator's state after the run
    and, in a plastic session, the weights and traces.  V, the currents and
    the ring too, unless ``atomics`` (a path through K2, K3 or K4, whose
    float atomics add in no fixed order): then within RING_RTOL / ATOL,
    and the elements whose bits differ are counted."""
    import torch
    eager.state = clone_state(graphed.state)
    for s in (graphed, eager):
        s.warmup(t_ms, probes=probes, include_presim=False)
    res_g = graphed.run(t_ms, presim_ms=0, probes=probes)
    res_e = eager.run(t_ms, presim_ms=0, probes=probes)
    torch.cuda.synchronize()
    if res_g.n_steps < 200:
        fail(f"{phase}: {res_g.n_steps} steps, fewer than 200")
    out = {"steps": res_g.n_steps, "spikes": int(res_g["spikes"].sum()),
           "graphs_captured": graphed.backend.graphs.misses}
    same_runs(f"{phase} (graphed against eager)", res_g, res_e)
    if not torch.equal(graphed._generator.get_state(),
                       eager._generator.get_state()):
        fail(f"{phase}: the generators' states differ after the run")
    bits = compare_states(f"{phase} (graphed against eager)", graphed.state,
                          eager.state, atomics)
    out.update(exact=json.dumps(sorted(n for n in bits if not atomics
                                       or n not in ATOMIC_FED)
                                + sorted(res_g.data) + ["generator"]),
               elements_with_other_bits=json.dumps(bits),
               graphed_ms_per_step=res_g.wall_s / res_g.n_steps * 1e3,
               eager_ms_per_step=res_e.wall_s / res_e.n_steps * 1e3,
               eager_timers_s=json.dumps(res_e.timers))
    return out


def graph_draws(backend, seed: int) -> dict:
    """The session's drive captured in one graph (the backend's own graph
    type) with a generator registered: two replays draw different Poisson
    counts, and each equals the eager draw from the same generator state."""
    import torch
    dev = backend.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    twin = torch.Generator(device=dev)
    twin.set_state(gen.get_state())
    t = torch.zeros((), dtype=torch.int32, device=dev)
    buf = torch.zeros(backend.c.n_total, dtype=torch.float32, device=dev)
    backend.drive(torch.Generator(device=dev), t, None)     # warm-up
    graph = backend.graph_type(
        lambda: buf.copy_(backend.drive(gen, t, None)[1]), gen,
        backend.graph_type.new_pool())
    got = []
    for _ in range(2):
        graph.replay()
        got.append(buf.clone())
    want = [backend.drive(twin, t, None)[1] for _ in range(2)]
    torch.cuda.synchronize()
    if torch.equal(got[0], got[1]):
        fail("two replays of one graph drew the same Poisson counts")
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        fail("a replay's Poisson counts differ from the eager draws")
    return {"replays": 2, "draws_differ": True, "equal_to_eager": True,
            "counts": json.dumps([int(x.sum()) for x in got])}


def stdp_counts(targets, pmask, in_syn, pmask_in, ids_list) -> dict:
    """What ``stdp_update`` needs for each of ``ids_list`` (the step's
    padded ids), averaged: the real and the plastic entries of the ids'
    OUT rows and IN rows, and the distinct sources of the plastic IN
    entries."""
    import torch
    n, k = targets.shape[0] - 1, targets.shape[1]
    cnt = {key: 0.0 for key in ("out", "out_plastic", "in", "in_plastic",
                                "sources")}
    for ids in ids_list:
        rows = ids[ids < n].long()
        syn, pin = in_syn[rows], pmask_in[rows]
        for key, v in (("out", (targets[rows] < n).sum()),
                       ("out_plastic", pmask[rows].sum()),
                       ("in", (syn != n * k).sum()), ("in_plastic", pin.sum()),
                       ("sources", torch.unique(syn[pin] // k).numel())):
            cnt[key] += float(v) / len(ids_list)
    return cnt


def bound(n_bytes: float, n_ops: float, ops_per_s: float = FP32_OPS_PER_S):
    """(ms, "bytes" | "operations"): ``roofline.bound_s`` in ms, and which
    of the two bounds it, the bytes over the memory rate or the operations
    over the rate of their type (float32 by default)."""
    t = bound_s(n_bytes, n_ops, ops_per_s)
    return t * 1e3, ("bytes" if n_bytes / HBM_BYTES_PER_S >= t
                     else "operations")


def sm90_build(_build) -> None:
    """The tensor-core K6's build: ``ptxas``'s registers and spills, its
    shared memory a block, and the ``HGMMA`` (wgmma) and ``UTMALDG`` (TMA
    load) instructions in each instantiation's SASS (``cuobjdump``).
    Fails where an instantiation has none of either, or spills."""
    name = "flash_attention_sm90"
    lib = _build.library(name)
    ptxas = [ln.strip() for ln in _build.ptxas_report.get(name, "")
             .splitlines() if "registers" in ln or "spill" in ln]
    sass = subprocess.run(
        [_build.cuda_tool("cuobjdump"), "-sass",
         str(_build.library_path(name))], capture_output=True, text=True,
        check=True, timeout=300).stdout
    ops = {}
    for fn in sass.split("Function : ")[1:]:
        d = re.search(r"flash_sm90_kernelILi(\d+)E", fn.split("\n", 1)[0])
        if d:
            ops[f"D={d.group(1)}"] = {op: len(re.findall(op, fn))
                                     for op in ("HGMMA", "UTMALDG")}
    smem = {d: lib.flash_attention_sm90_smem_bytes(d) for d in (32, 64, 128)}
    say("sm90_build", ptxas=json.dumps(ptxas), smem_bytes=json.dumps(smem),
        sass=json.dumps(ops))
    if len(ops) != 3 or not all(c["HGMMA"] and c["UTMALDG"]
                                for c in ops.values()):
        fail(f"the bf16 K6 is not on the tensor cores and TMA in all three "
             f"instantiations: {ops}")
    if any("spill" in ln and "0 bytes spill stores, 0 bytes spill loads"
           not in ln for ln in ptxas):
        fail(f"the bf16 K6 spills: {ptxas}")


def attention_phase(seed: int) -> dict:
    """Phase 11 (the module's docstring).  Returns the attention path's
    launch counts, K6's largest error against its plain version, and K6's
    times, bytes and operations for the ``kernels`` line."""
    import unittest.mock

    import torch
    import torch.nn.functional as F
    from repro_torch.configs.base import ModelConfig
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as K6
    from repro_torch.models import layers as L

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    qwen = ModelConfig(**QWEN3_32B)
    hq, hkv, hd = qwen.n_heads, qwen.n_kv_heads, qwen.head_dim_
    gen = torch.Generator(device=dev).manual_seed(seed)
    max_err = max_over_bar = 0.0

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def rms(x) -> float:
        return float(x.float().pow(2).mean().sqrt())

    def against_plain(got, q, k, v, what: str, exact_p=False, **kw) -> dict:
        """K6's output ``got`` against its float32 plain version on the
        same values (``kw``: the call's causal, scale and q_offset):
        bfloat16 within ``K6.bf16_bar``, or within ``ATTN_TOL`` where
        ``exact_p`` (q = 0); float32 within ``ATTN_TOL``."""
        nonlocal max_err, max_over_bar
        want = K6.flash_attention_plain(q.float(), k.float(), v.float(),
                                        **kw)
        if got.dtype == torch.bfloat16 and not exact_p:
            bar, kind = K6.bf16_bar(q, k, v, **kw), "bf16_bar"
        else:
            rtol, atol = ATTN_TOL[str(got.dtype)]
            bar, kind = atol + rtol * want.abs(), f"rtol={rtol},atol={atol}"
        diff = (got.float() - want).abs()
        res = {"max_abs_err": float(diff.max()), "err_rms": rms(diff),
               "ref_rms": rms(want), "err_over_bar": float((diff / bar).max()),
               "bar": kind}
        if not (bool(torch.isfinite(got).all()) and res["err_over_bar"] <= 1):
            fail(f"{what}: {res} beyond its bar against the plain version, "
                 f"or not finite")
        max_err = max(max_err, res["max_abs_err"])
        if kind == "bf16_bar":
            max_over_bar = max(max_over_bar, res["err_over_bar"])
        return res

    def near(got, want, what: str) -> dict:
        """One of the layer's outputs against its plain-K6 twin: finite,
        and each element within ``LAYER_RTOL`` of the reference's value
        plus ``LAYER_RMS_TOL`` of its RMS."""
        got, want = got.float(), want.float()
        diff, ref = (got - want).abs(), rms(want)
        bar = LAYER_RTOL * want.abs() + LAYER_RMS_TOL * ref
        res = {"max_abs_err": float(diff.max()), "err_rms": rms(diff),
               "ref_rms": ref, "beyond_rtol_over_rms": float(
                   (diff - LAYER_RTOL * want.abs()).max()) / ref}
        if not (bool(torch.isfinite(got).all()) and bool((diff <= bar).all())):
            fail(f"{what}: {res} beyond {LAYER_RTOL}*|ref| + "
                 f"{LAYER_RMS_TOL}*RMS(ref), or not finite")
        return res

    # (a) K6 against its plain version at the attention shapes and the
    # tests' shapes; each bfloat16 shape once more with q = 0 (exact P)
    shapes = [(1, hq, hkv, t, s, hd, causal, q_off)
              for t, s, causal, q_off in ATTN_SHAPES]
    shapes += [cfg + (0,) for cfg in ATTN_TEST_SHAPES]
    for b, n_q, n_kv, t_len, s_len, d, causal, q_off in shapes:
        for dtype, exact_p in ((torch.bfloat16, False),
                               (torch.bfloat16, True),
                               (torch.float32, False)):
            qkv = (randn(b, n_q, t_len, d, dtype=dtype),
                   randn(b, n_kv, s_len, d, dtype=dtype),
                   randn(b, n_kv, s_len, d, dtype=dtype))
            if exact_p:
                qkv[0].zero_()
            kw = dict(causal=causal, q_offset=q_off)
            got = K6.flash_attention(*qkv, **kw)
            res = against_plain(got, *qkv, f"K6 at B={b}, Hq={n_q}, "
                                f"Hkv={n_kv}, T={t_len}, S={s_len}, D={d}, "
                                f"causal={causal}, q_offset={q_off}, "
                                f"{dtype}, exact_p={exact_p}",
                                exact_p=exact_p, **kw)
            say("K6", b=b, hq=n_q, hkv=n_kv, d=d, t=t_len, s=s_len,
                causal=causal, q_offset=q_off, dtype=str(dtype),
                exact_p=exact_p, **res)
            del qkv, got
    torch.cuda.empty_cache()

    # (b) one attention + SwiGLU layer at Qwen3-32B widths, bf16, T = 4096,
    # then the cache path; every K6 launch of the two is recorded with its
    # inputs (the views the layer hands it) and held to the plain version
    d_model, t_len = qwen.d_model, ATTN_T
    p_gen = torch.Generator(device=dev).manual_seed(seed)
    params, _ = L.split_tree({
        "ln1": L.init_rms(p_gen, d_model, torch.float32),
        "attn": L.init_attention(p_gen, qwen),
        "ln2": L.init_rms(p_gen, d_model, torch.float32),
        "mlp": L.init_mlp(p_gen, d_model, qwen.d_ff, qwen.n_layers)})
    n_params = sum(w.numel() for part in params.values()
                   for w in part.values())
    x = randn(1, t_len, d_model, dtype=qwen.activation_dtype)
    positions = torch.arange(t_len, device=dev)[None]
    calls = []

    def recorded(q, k, v, **kw):
        out = K6.flash_attention(q, k, v, **kw)
        calls.append((q, k, v, kw, out))
        return out

    def layer(x):
        h = L.rms_norm(x, params["ln1"]["scale"], qwen.norm_eps)
        a, _ = L.attention(params["attn"], h, qwen, positions)
        x = x + a
        h = L.rms_norm(x, params["ln2"]["scale"], qwen.norm_eps)
        return x + L.mlp(params["mlp"], h), a

    def cache_path(x):
        """Prefill the first T/2 tokens into a T-slot cache at index 0,
        the next T/2 - 1 at index T/2 (K6 on the cache's first T - 1 slots
        with q_offset T/2), then one decode step at index T - 1."""
        h = L.rms_norm(x, params["ln1"]["scale"], qwen.norm_eps)
        cache = {"k": torch.zeros(1, t_len, hkv, hd, dtype=x.dtype,
                                  device=dev),
                 "v": torch.zeros(1, t_len, hkv, hd, dtype=x.dtype,
                                  device=dev)}
        outs, half = [], t_len // 2
        for lo, hi in ((0, half), (half, t_len - 1), (t_len - 1, t_len)):
            out, cache = L.attention(params["attn"], h[:, lo:hi], qwen,
                                     positions[:, lo:hi], cache=cache,
                                     cache_index=lo)
            outs.append(out)
        return torch.cat(outs[:2], dim=1), outs[2]

    torch.cuda.synchronize()
    _build.reset_launches()
    with unittest.mock.patch.object(L.ops, "flash_attention", recorded):
        y, a = layer(x)
        torch.cuda.synchronize()
        layer_launches = dict(_build.launches)
        a_pre, a_dec = cache_path(x)
        torch.cuda.synchronize()
    launches = dict(_build.launches)
    say("launches", path="attention", **launches)
    if layer_launches["flash_attention"] != 1 or sum(
            layer_launches.values()) != 1:
        fail(f"the Qwen3-32B layer launched {layer_launches}, not K6 "
             f"exactly once")
    if launches["flash_attention"] != 3 or sum(launches.values()) != 3:
        fail(f"the layer and its cache path launched {launches}, not K6 "
             f"three times (the layer, two prefills into the cache)")
    for i, (q, k, v, kw, out) in enumerate(calls):
        res = against_plain(out, q, k, v, f"the attention path's K6 launch "
                            f"{i}", **kw)
        say("K6_on_path", launch=i, t=q.shape[2], s=k.shape[2],
            q_offset=kw["q_offset"], strided_views=not q.is_contiguous(),
            dtype=str(q.dtype), **res)
    calls.clear()
    layer_ms = call_ms(lambda i: layer(x), iters=2, warm=1)
    with unittest.mock.patch.object(L.ops, "flash_attention",
                                    K6.flash_attention_plain):
        y_ref, a_ref = layer(x)
    res_y = near(y, y_ref, "the Qwen3-32B layer against its plain-K6 twin")
    res_a = near(a, a_ref, "the layer's attention against the plain K6")
    res_pre = near(a_pre, a[:, :-1], "the two prefills into the cache")
    res_dec = near(a_dec, a[:, -1:], "the decode step")
    say("qwen3_layer", b=1, t=t_len, d_model=d_model, heads=f"{hq}/{hkv}",
        head_dim=hd, d_ff=qwen.d_ff, params=n_params, dtype=str(x.dtype),
        layer_ms=layer_ms, out=json.dumps(res_y), attn=json.dumps(res_a),
        cache_prefill=json.dumps(res_pre), decode=json.dumps(res_dec),
        rtol=LAYER_RTOL, rms_tol=LAYER_RMS_TOL)
    del y, a, y_ref, a_ref, a_pre, a_dec
    # the layer's attention once in float32, through the same views
    h32 = L.rms_norm(x.float(), params["ln1"]["scale"], qwen.norm_eps)
    with unittest.mock.patch.object(L.ops, "flash_attention", recorded):
        a32, _ = L.attention(params["attn"], h32, qwen, positions)
    (q, k, v, kw, out), = calls
    res32 = against_plain(out, q, k, v, "the layer's float32 K6 launch",
                          **kw)
    calls.clear()
    del q, k, v, out
    with unittest.mock.patch.object(L.ops, "flash_attention",
                                    K6.flash_attention_plain):
        a32_ref, _ = L.attention(params["attn"], h32, qwen, positions)
    rtol, atol = ATTN_TOL["torch.float32"]
    err_a32 = float((a32 - a32_ref).abs().max())
    if not torch.allclose(a32, a32_ref, rtol=rtol, atol=atol):
        fail(f"the layer's float32 attention: max |diff| {err_a32} against "
             f"its plain-K6 twin (rtol {rtol}, atol {atol})")
    say("qwen3_attention_f32", t=t_len, strided_views=True,
        K6=json.dumps(res32), attn_max_abs_err=err_a32,
        attn_ref_rms=rms(a32_ref), rtol=rtol, atol=atol)
    del params, x, h32, a32, a32_ref
    torch.cuda.empty_cache()

    # (c) one K6 call at T = S = 32768; its last 512 rows against the plain
    # version over all keys
    t32, band = ATTN_T_LONG, ATTN_BAND
    qkv = (randn(1, hq, t32, hd), randn(1, hkv, t32, hd),
           randn(1, hkv, t32, hd))
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    out32 = K6.flash_attention(*qkv, causal=True)
    stop.record()
    stop.synchronize()
    ms_32k = start.elapsed_time(stop)
    if not bool(torch.isfinite(out32).all()):
        fail("K6 at T = S = 32768 is not finite")
    res = against_plain(out32[:, :, -band:], qkv[0][:, :, -band:], *qkv[1:],
                        "K6 at T = S = 32768", causal=True,
                        q_offset=t32 - band)
    say("K6_32k", t=t32, s=t32, causal=True, dtype="torch.bfloat16",
        ms=ms_32k, rows_checked=band, **res,
        tflops=4 * hq * hd * t32 * (t32 + 1) / 2 / ms_32k / 1e9)
    del qkv, out32
    torch.cuda.empty_cache()

    # (d) K6's times at (a)'s causal shape: bf16 (the tensor-core kernel)
    # and float32 (the CUDA-core one); the library call is one
    # scaled_dot_product_attention (the port never calls it)
    t_len = ATTN_T
    qkv = (randn(1, hq, t_len, hd), randn(1, hkv, t_len, hd),
           randn(1, hkv, t_len, hd))
    qkv_f32 = tuple(t.float() for t in qkv)
    k6 = timed(lambda i: K6.flash_attention(*qkv, causal=True), iters=16)
    k6_f32 = timed(lambda i: K6.flash_attention(*qkv_f32, causal=True),
                   iters=16)
    k6_plain = timed(lambda i: K6.flash_attention_plain(*qkv, causal=True),
                     iters=4)
    # All three run for milliseconds a call, so their back-to-back event
    # time is their device time.  The profiler's is kept beside it: on an
    # H100 80GB HBM3 it recorded 14 or 15 of K6's 16 calls (its figure
    # exactly that share short of the event time), so the event time is
    # the one that counts.
    k6, k6_f32, k6_plain = ({**t, "ms": t["call_ms"], "profiler_ms": t["ms"],
                             "timing": "events"}
                            for t in (k6, k6_f32, k6_plain))
    sdpa = lambda i: F.scaled_dot_product_attention(*qkv, is_causal=True,
                                                    enable_gqa=True)
    sdpa_ms = call_ms(sdpa, iters=16)
    k6_lib = {"ms": sdpa_ms, "call_ms": sdpa_ms, "timing": "events"}
    # SDPA rounds P to bf16 too: its own err / bar against the plain
    # version, for information only
    sdpa_out = sdpa(0).float()
    sdpa_err = float((sdpa_out - K6.flash_attention(*qkv).float())
                     .abs().max())
    sdpa_over_bar = float(((sdpa_out - K6.flash_attention_plain(
        *(t.float() for t in qkv))).abs() / K6.bf16_bar(*qkv)).max())
    del sdpa_out
    # q, k, v read once and the output written once; the two products over
    # the live (causal) query-key pairs
    k6_bytes = 2 * (2 * hq * t_len * hd + 2 * hkv * t_len * hd)
    k6_ops = 4 * hq * hd * t_len * (t_len + 1) / 2
    say("timing_attention", shape=f"1x{hq}x{t_len}x{hd}/{hkv}",
        K6=json.dumps(k6), K6_f32=json.dumps(k6_f32),
        K6_plain=json.dumps(k6_plain), library_sdpa=json.dumps(k6_lib),
        sdpa_vs_K6_max_abs_diff=sdpa_err, sdpa_err_over_bar=sdpa_over_bar,
        K6_tflops=k6_ops / k6["ms"] / 1e9,
        K6_f32_tflops=k6_ops / k6_f32["ms"] / 1e9,
        K6_over_K6_f32=k6_f32["ms"] / k6["ms"],
        phase_s=f"{time.perf_counter() - t_phase:.1f}")
    if k6_f32["ms"] < 5 * k6["ms"]:
        fail(f"the bf16 tensor-core K6 ({k6['ms']} ms) is not 5 times "
             f"faster than the float32 one ({k6_f32['ms']} ms)")
    del qkv, qkv_f32
    torch.cuda.empty_cache()
    return dict(launches=launches, max_err=max_err,
                max_over_bar=max_over_bar, k6=k6, k6_f32=k6_f32,
                k6_plain=k6_plain, k6_lib=k6_lib, k6_bytes=k6_bytes,
                k6_ops=k6_ops, ms_32k=ms_32k)


def launched(phase: str, want) -> dict:
    """The launch counts since the last reset; every kernel of ``want``
    must have launched."""
    from repro_torch.kernels import _build
    counts = dict(_build.launches)
    for name in want:
        if not counts[name]:
            fail(f"{phase}: {name} was not launched")
    return counts


#: [sharded_four] and [K2_local]: the ranks the full-scale network is cut
#: into, and the rank whose column block K2's local-ring form is held on
SHARD_WORLD, SHARD_RANK = 4, 2
#: [sharded_checkpoint] and [serve_sharded]: the kernels their sharded
#: sessions launch, and no other: K1, K2's local-ring form and the
#: kernel of the pop_counts probe they record
SHARDED_SESSION_KERNELS = ("lif_update", "ell_deliver_local", "pop_counts")
#: rows of the tables hashed at once when [sharded_localize] checks that
#: the shards hold the connectome
DIGEST_ROWS = 4096


def raster_probe(n_steps: int, width: int):
    """A stream probe of the step's spike vector (``width`` long): on the
    sharded backend the gathered registry, as an ``[n_steps, width]``
    raster of a run of ``n_steps`` (the sharded backend records no
    ``spikes`` probe)."""
    import torch
    from repro_torch.api import StreamProbe

    def init(device=None):
        return {"i": torch.zeros((), dtype=torch.int64, device=device),
                "rows": torch.zeros((n_steps, width), dtype=torch.bool,
                                    device=device)}

    def update(carry, spiked):
        at = torch.remainder(carry["i"], n_steps).view(1)
        return {"i": carry["i"] + 1,
                "rows": carry["rows"].index_copy(0, at, spiked.view(1, -1))}
    return StreamProbe(name="raster", init=init, update=update)


def entries_digest(blocks, dev) -> tuple:
    """What a set of ELL tables holds, order aside: the real entries per
    source row, and two int64 sums of a hash of each real (source, global
    target, weight bits, delay bin).  ``blocks`` is ``[(targets, weights,
    dbins, n_real, offset)]``: a target below ``n_real`` is real, and its
    global id is ``target + offset``; tables on the host are hashed on
    ``dev`` ``DIGEST_ROWS`` rows at a time."""
    import torch
    per_src, h1, h2 = None, 0, 0
    for targets, weights, dbins, n_real, offset in blocks:
        rows = targets.shape[0]
        counts = torch.zeros(rows, dtype=torch.int64, device=dev)
        for lo in range(0, rows, DIGEST_ROWS):
            part = [torch.as_tensor(x[lo:lo + DIGEST_ROWS], device=dev)
                    for x in (targets, weights, dbins)]
            tg, w, db = part
            real = tg < n_real
            src = (torch.arange(tg.shape[0], device=dev)[:, None]
                   + lo).expand_as(tg)[real]
            h = (src * 1_000_003 + tg[real].long() + offset) \
                * 6364136223846793005 + w[real].view(torch.int32).long()
            h = (h ^ (h >> 31)) * -7046029254386353131 + db[real].long()
            h = h ^ (h >> 29)
            h1 += int(h.sum())
            h2 += int((h * h + (h >> 7)).sum())
            counts[lo:lo + tg.shape[0]] = real.sum(1)
        per_src = counts if per_src is None \
            else per_src[:rows] + counts[:per_src.shape[0]]
    wrap = lambda v: (v + 2 ** 63) % 2 ** 64 - 2 ** 63
    return per_src, wrap(h1), wrap(h2)


def split_world_of_one(st, meta: dict, n: int, v_reset: float, gens):
    """A world of one's state cut into ``meta``'s ranks, in one process:
    each rank's V and currents slice (the padding at ``v_reset``), its
    ring columns and a zero dump column, the counters copied; rank r gets
    ``gens[r]``."""
    import torch
    from repro_torch.core.distributed import ShardedSimState
    n_pad, n_loc, n_dev = meta["n_pad"], meta["n_loc"], meta["n_dev"]
    pad = lambda x, v: torch.cat([x, torch.full((n_pad - n,), v,
                                                dtype=x.dtype,
                                                device=x.device)])
    V, I_ex, I_in = pad(st.V, v_reset), pad(st.I_ex, 0.0), pad(st.I_in, 0.0)
    refrac = pad(st.refrac, 0)
    d_bins = st.ring.shape[0]
    ring = torch.zeros((d_bins, 2, n_dev, n_loc + 1), dtype=st.ring.dtype,
                       device=st.ring.device)
    cols = torch.zeros((d_bins, 2, n_pad), dtype=st.ring.dtype,
                       device=st.ring.device)
    cols[:, :, :n] = st.ring[:, :, :n]
    ring[..., :n_loc] = cols.view(d_bins, 2, n_dev, n_loc)
    out = []
    for r in range(n_dev):
        own = slice(r * n_loc, (r + 1) * n_loc)
        out.append(ShardedSimState(
            V=V[own].clone(), I_ex=I_ex[own].clone(), I_in=I_in[own].clone(),
            refrac=refrac[own].clone(), ring=ring[:, :, r].contiguous(),
            t=st.t.clone(), generator=gens[r], overflow=st.overflow.clone()))
    return out


def hold_sharded(phase: str, sharded, fused, t_ms: float) -> dict:
    """A sharded world of one against a ``FusedBackend`` session with
    ``kernels="split"``, both graphed, ``t_ms`` from one state and
    generator state (the sharded session's, copied into the fused one).
    Exact: the spike raster (the gathered registry against the ``spikes``
    probe), the population counts, ``t``, overflow, refrac and the
    generator's state; V, the currents and the ring within RING_RTOL /
    ATOL (K2's float atomics add in no fixed order)."""
    import numpy as np
    import torch
    from repro_torch.core.engine import SimState
    from repro_torch.core.neuron import NeuronState
    st = clone_state(sharded.state)
    fused.state = SimState(NeuronState(st.V, st.I_ex, st.I_in, st.refrac),
                           st.ring, st.t, sharded._generator, st.overflow)
    n = sharded._steps(t_ms)
    p_sh = ("pop_counts", raster_probe(n, sharded.backend.n_registry))
    p_fu = ("pop_counts", "spikes")
    sharded.warmup(t_ms, probes=p_sh, include_presim=False)
    fused.warmup(t_ms, probes=p_fu, include_presim=False)
    res_s = sharded.run(t_ms, presim_ms=0, probes=p_sh)
    res_f = fused.run(t_ms, presim_ms=0, probes=p_fu)
    torch.cuda.synchronize()
    rows = res_s.streams["raster"]["carry"]["rows"]
    if not np.array_equal(res_s["pop_counts"], res_f["pop_counts"]):
        fail(f"{phase}: the population counts differ from the fused split "
             f"session's")
    if not np.array_equal(rows[:, :res_f["spikes"].shape[1]],
                          res_f["spikes"]):
        fail(f"{phase}: the gathered registry differs from the fused split "
             f"session's spikes")
    if not torch.equal(sharded._generator.get_state(),
                       fused._generator.get_state()):
        fail(f"{phase}: the generators' states differ after the run")
    fs = fused.state
    bits = compare_states(f"{phase} (sharded against fused split)",
                          sharded.state, fs)
    return dict(steps=res_s.n_steps, spikes=int(res_f["spikes"].sum()),
                exact=json.dumps(["spikes", "pop_counts", "t", "overflow",
                                  "refrac", "generator"]),
                elements_with_other_bits=json.dumps(bits),
                sharded_ms_per_step=res_s.wall_s / res_s.n_steps * 1e3,
                fused_split_ms_per_step=res_f.wall_s / res_f.n_steps * 1e3)


def sharded_run(phase: str, sim, t_ms: float) -> dict:
    """The graphed sharded session's run of ``t_ms`` after its presim,
    after ``warmup``: RTF, overflow 0, rates in band, K1 and K2's
    local-ring form once a step, the ``pop_counts`` probe's kernel once a
    recorded step, and no other kernel.  Returns the line's fields and
    the launches."""
    from repro_torch.kernels import _build
    pol = sim.sim_config.kernels
    if not (pol.step == "split" and pol.kernels and pol.deliver == "kernel"
            and sim.backend.graphed):
        fail(f"{phase}: resolved to {pol.describe()} (graphed: "
             f"{sim.backend.graphed}), not the graphed split kernels")
    t0 = time.perf_counter()
    sim.warmup(t_ms)
    capture_s = time.perf_counter() - t0
    _build.reset_launches()
    res = sim.run(t_ms)
    counts = dict(_build.launches)
    steps = sim._steps(sim.t_presim) + res.n_steps
    want = {"lif_update": steps, "ell_deliver_local": steps,
            "pop_counts": res.n_steps}
    if any(counts[k] != v for k, v in want.items()) \
            or any(v for k, v in counts.items() if k not in want):
        fail(f"{phase}: launched {counts} for {steps} steps, {res.n_steps} "
             f"recorded (K1 and K2's local-ring form once a step, "
             f"pop_counts once a recorded step, nothing else)")
    if res.overflow != 0:
        fail(f"{phase}: overflow {res.overflow}")
    rates = res.summary()["rates_hz"]
    check_rates(rates, phase)
    return dict(policy=pol.describe(), n_dev=sim.backend.n_dev,
                collective=sim.backend.world.group is not None,
                presim_ms=sim.t_presim, run_ms=t_ms, steps=res.n_steps,
                wall_s=res.wall_s, rtf=res.rtf,
                ms_per_step=res.wall_s / res.n_steps * 1e3,
                overflow=res.overflow, capture_s=capture_s,
                spikes_per_step=float(res["pop_counts"].sum()) / res.n_steps,
                rates_hz=json.dumps([round(float(r), 3) for r in rates]),
                launches=json.dumps(counts)), counts


def sharded_phase(c, args, card: str, dev, rtf_fused: float,
                  spikes_main: int, budget_main: int) -> dict:
    """Phase 9b (the module's docstring), on the full-scale connectome
    ``c``.  Returns each sub-phase's launch counts and K2's local-ring
    timings."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.api import Simulator, probes as PR
    from repro_torch.configs.microcircuit import MicrocircuitConfig
    from repro_torch.core import distributed as DD
    from repro_torch.core import recording
    from repro_torch.core.engine import SimConfig, resolve_sim_config
    from repro_torch.core.neuron import Propagators
    from repro_torch.core.params import NeuronParams
    from repro_torch.core import stimulus as S
    from repro_torch.kernels import _build
    from repro_torch.kernels import ell_deliver as K2
    from repro_torch.launch import mesh

    t_phase = time.perf_counter()
    N, D = c.n_total, c.d_max_bins
    rng = np.random.default_rng(args.seed)
    on = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    runs, out = {}, {}

    # [sharded_localize]: 1 and 4 ranks on the card; the shards hold every
    # real entry of the connectome once
    want = entries_digest([(c.targets, c.weights, c.dbins, N, 0)], dev)
    for n_dev in (1, SHARD_WORLD):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        tables, meta = DD.localize_ell(c, n_dev, device=dev)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base
        table_bytes = sum(x.numel() * x.element_size() for x in tables)
        shards = [DD.shard_of(tables, meta, r) for r in range(n_dev)]
        del tables
        n_loc = meta["n_loc"]
        got = entries_digest([(sh.targets, sh.weights, sh.dbins, n_loc,
                               r * n_loc) for r, sh in enumerate(shards)],
                             dev)
        if not (torch.equal(got[0][:N], want[0]) and not got[0][N:].any()
                and got[1:] == want[1:]):
            fail(f"sharded_localize: {n_dev} ranks' tables do not hold the "
                 f"connectome's entries once each")
        say("sharded_localize", n_dev=n_dev, n=N, n_pad=meta["n_pad"],
            n_loc=n_loc, k_loc=meta["k_loc"], seconds=seconds,
            peak_device_bytes=peak, table_bytes=table_bytes,
            real_entries=int(want[0].sum()), preserved=True,
            card=json.dumps(card))
        out[f"localize_{n_dev}"] = dict(seconds=seconds, peak_bytes=peak,
                                        table_bytes=table_bytes,
                                        k_loc=meta["k_loc"])
        if n_dev == 1:
            del shards
    meta4, n_pad, n_loc = meta, meta["n_pad"], meta["n_loc"]
    pop_of4 = DD.padded_pop_of(c.pop_of, n_pad, len(c.pop_sizes), dev)

    # [K2_local]: K2 on rank SHARD_RANK's block against its plain version
    sh = shards[SHARD_RANK]
    tbl = (sh.targets, sh.weights, sh.dbins)
    t_dev = torch.tensor(1234, dtype=torch.int32, device=dev)

    def ring_loc():
        r = np.zeros((D, 2, n_loc + 1), np.float32)
        r[:, 0, :n_loc] = rng.uniform(0, 50, (D, n_loc))
        r[:, 1, :n_loc] = -rng.uniform(0, 50, (D, n_loc))
        return on(r)

    def registry(k):
        s = np.zeros(n_pad, bool)
        s[rng.choice(N, size=k, replace=False)] = True
        return on(s)

    max_err = 0.0
    for k, bud in ((0, 256), (31, 256), (256, 256), (300, 256),
                   (min(5000, N // 2), 8192)):
        spk, r0 = registry(k), ring_loc()
        r_k, ids_k, ovf_k = K2.ell_deliver(r0.clone(), *tbl, spk, t_dev,
                                           c.n_exc, bud, n_tgt=n_loc)
        r_p, ids_p, ovf_p = K2.ell_deliver_plain(r0.clone(), *tbl, spk,
                                                 t_dev, c.n_exc, bud)
        torch.cuda.synchronize()
        if not (torch.equal(ids_k, ids_p) and torch.equal(ovf_k, ovf_p)):
            fail(f"K2_local: ids/overflow differ at {k} spikes")
        err = float((r_k - r_p).abs().max())
        if not torch.allclose(r_k, r_p, rtol=RING_RTOL, atol=RING_ATOL):
            fail(f"K2_local: ring differs at {k} spikes: max |diff| {err}")
        max_err = max(max_err, err)
        say("K2_local", rank=SHARD_RANK, n_dev=SHARD_WORLD, spikes=k,
            budget=bud, overflow=int(ovf_k), ids_exact=True,
            ring_max_abs_err=err, cells_changed=int((r_k != r0).sum()))
    # its time at the main path's mean spike count, 64 registries
    spks = [registry(spikes_main) for _ in range(64)]
    ids_np = [np.flatnonzero(x.cpu().numpy())[:budget_main] for x in spks]
    n_entries = float(np.mean([int((sh.targets[torch.as_tensor(
        i, device=dev)] < n_loc).sum()) for i in ids_np]))
    ring = ring_loc()
    k2l = timed(lambda i: K2.ell_deliver(ring, *tbl, spks[i % 64], t_dev,
                                         c.n_exc, budget_main, n_tgt=n_loc))
    k2l_plain = timed(lambda i: K2.ell_deliver_plain(
        ring, *tbl, spks[i % 64], t_dev, c.n_exc, budget_main))

    def flat_rows(ids):                 # index_add_'s inputs for one call
        ids_t = torch.as_tensor(ids, device=dev)
        lin = (torch.remainder(1234 + sh.dbins[ids_t].long(), D)
               * (2 * (n_loc + 1))
               + (ids_t >= c.n_exc).long()[:, None] * (n_loc + 1)
               + sh.targets[ids_t].long())
        return lin.reshape(-1), sh.weights[ids_t].reshape(-1)
    lib_in = [flat_rows(i) for i in ids_np]
    k2l_lib = timed(lambda i: ring.view(-1).index_add_(
        0, *lib_in[i % len(lib_in)]))
    del lib_in, ring, spks
    out["k2_local"] = dict(t=k2l, plain=k2l_plain, lib=k2l_lib,
                           n_bytes=k2_bytes(n_pad, budget_main, n_entries),
                           n_ops=ENTRY_OPS * n_entries, err=max_err)
    say("timing_K2_local", rank=SHARD_RANK, n_dev=SHARD_WORLD,
        spikes=spikes_main, budget=budget_main, real_entries=n_entries,
        K2_local=json.dumps(k2l), K2_local_plain=json.dumps(k2l_plain),
        index_add=json.dumps(k2l_lib),
        bound_us=1e3 * bound(out["k2_local"]["n_bytes"],
                             out["k2_local"]["n_ops"])[0],
        card=json.dumps(card))

    # [sharded_four]: four shards stepped in one process, the gather a
    # concatenation.  (a) under dc() from a world of one's carried state,
    # 300 steps against the world of one
    cfg = MicrocircuitConfig(scale=args.scale, strategy="ell",
                             seed=args.seed)
    prop = Propagators.make(NeuronParams(), cfg.dt)
    v_reset = float(prop.V_reset)
    n_hold = 300
    one = Simulator(cfg, connectome=c, backend="sharded", device=dev,
                    stimulus=("dc",), probes=("pop_counts",
                                              raster_probe(n_hold, N)))
    # the presim, then one step (unrecorded: the raster's carry must start
    # with the held steps)
    one.run(0.1, probes=("pop_counts",))
    start = one.state
    shard_cfg = one.sim_config
    nets = [DD.shard_network(s, pop_of4) for s in shards]

    def drives(stimulus):
        cfg_s = resolve_sim_config(SimConfig(
            strategy="ell", stimulus=stimulus), c, dev)
        whole = S.compile_drive(cfg_s.stimulus, c, cfg_s, NeuronParams(),
                                "cpu")
        return [whole.shard(n_pad, r * n_loc, (r + 1) * n_loc, dev)
                for r in range(SHARD_WORLD)]
    states = split_world_of_one(start, meta4, N, v_reset,
                                [None] * SHARD_WORLD)
    res_one = one.run(n_hold * 0.1)
    regs = []
    _build.reset_launches()
    dc_drives = drives(("dc",))
    for _ in range(n_hold):
        states, spk = DD.step_shards(states, nets, prop, shard_cfg,
                                     w_ext=c.w_ext, n_exc=c.n_exc,
                                     drives=dc_drives)
        regs.append(spk)
    runs["sharded_four_dc"] = launched("sharded_four_dc",
                                       ("lif_update", "ell_deliver_local"))
    regs = torch.stack(regs)
    rows = torch.as_tensor(res_one.streams["raster"]["carry"]["rows"],
                           device=dev)
    if not (torch.equal(regs[:, :N], rows) and not bool(regs[:, N:].any())):
        fail("sharded_four: the four shards' registry differs from the "
             "world of one's under dc()")
    pc = PR.pop_counts()
    counts4 = torch.stack([pc(PR.ProbeContext(None, x, nets[0], 8))
                           for x in regs]).cpu().numpy()
    if not np.array_equal(counts4, res_one["pop_counts"]):
        fail("sharded_four: the population counts differ from the world "
             "of one's under dc()")
    V4 = torch.cat([st.V for st in states])[:N]
    V1 = one.state.V
    if not torch.allclose(V4, V1, rtol=RING_RTOL, atol=RING_ATOL):
        fail(f"sharded_four: V beyond 1e-5 of the world of one's: "
             f"{float((V4 - V1).abs().max())}")
    ovf = {int(st.overflow) for st in states}
    if ovf != {int(one.state.overflow)}:
        fail(f"sharded_four: overflow {ovf}, the world of one's "
             f"{int(one.state.overflow)}")
    say("sharded_four_dc", n_dev=SHARD_WORLD, steps=n_hold,
        spikes=int(regs.sum()), raster_exact=True, pop_counts_exact=True,
        V_max_abs_err=float((V4 - V1).abs().max()),
        V_elements_with_other_bits=int((V4.view(torch.int32)
                                        != V1.view(torch.int32)).sum()))
    del one, start, states, regs, rows, V4, V1

    # (b) under the 8 Hz background: 100 ms presim, then 1000 ms timed
    gens = [torch.Generator(device=dev).manual_seed(
        DD.rank_seed(args.seed, r)) for r in range(SHARD_WORLD)]
    g0 = torch.Generator(device=dev).manual_seed(args.seed)
    V0 = (torch.as_tensor(c.v0_mean, device=dev)
          + torch.as_tensor(c.v0_sd, device=dev) * torch.randn(
              N, generator=g0, device=dev))
    states = [DD.init_shard(V0, D, meta4, r, gens[r], v_reset)
              for r in range(SHARD_WORLD)]
    bg = drives(None)
    n_pre, n_run = int(round(cfg.t_presim / cfg.dt)), 10_000
    for _ in range(n_pre):
        states, _ = DD.step_shards(states, nets, prop, shard_cfg,
                                   w_ext=c.w_ext, n_exc=c.n_exc, drives=bg)
    counts = torch.zeros((n_run, 8), dtype=torch.int32, device=dev)
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    for i in range(n_run):
        states, spk = DD.step_shards(states, nets, prop, shard_cfg,
                                     w_ext=c.w_ext, n_exc=c.n_exc, drives=bg)
        counts[i] = pc(PR.ProbeContext(None, spk, nets[0], 8))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    runs["sharded_four"] = launched("sharded_four",
                                    ("lif_update", "ell_deliver_local"))
    want_n = SHARD_WORLD * n_run
    if runs["sharded_four"]["lif_update"] != want_n \
            or runs["sharded_four"]["ell_deliver_local"] != want_n:
        fail(f"sharded_four: launched {runs['sharded_four']} for "
             f"{SHARD_WORLD} x {n_run} rank steps")
    overflow = {int(st.overflow) for st in states}
    if overflow != {0}:
        fail(f"sharded_four: overflow {overflow}")
    rates4 = recording.activity_summary(counts.cpu().numpy(), c,
                                        cfg.dt)["rates_hz"]
    check_rates(rates4, "sharded_four")
    out["four_ms_per_step"] = wall / n_run * 1e3
    say("sharded_four", n_dev=SHARD_WORLD, gather="concatenation",
        loop="eager", presim_ms=cfg.t_presim, run_ms=n_run * cfg.dt,
        steps=n_run, wall_s=wall, rtf=wall / (n_run * cfg.dt * 1e-3),
        ms_per_step=out["four_ms_per_step"], overflow=0,
        spikes_per_step=float(counts.sum()) / n_run,
        rates_hz=json.dumps([round(float(r), 3) for r in rates4]),
        card=json.dumps(card))
    del states, shards, nets, sh, tbl, counts, bg, dc_drives
    gc.collect()
    torch.cuda.empty_cache()

    # [sharded_one]: a world of one without a process group, graphed, then
    # held to the fused split session over 300 steps
    t0 = time.perf_counter()
    sim = Simulator(cfg, connectome=c, backend="sharded", device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    line, runs["sharded_one"] = sharded_run("sharded_one", sim, args.t_sim)
    out["one_ms_per_step"] = line["ms_per_step"]
    st1 = sim.state
    out["one_layout"] = {
        "n": N, "d": D, "k_loc": sim.backend.meta["k_loc"],
        "bytes": sum(x.numel() * x.element_size() for x in (
            *sim.backend.net.tables,
            *(v for v in st1 if isinstance(v, torch.Tensor))))
        + st1.generator.get_state().numel()}
    del st1
    fused = Simulator(cfg, connectome=c, device=dev, kernels="split",
                      probes=("pop_counts", "spikes"))
    held = hold_sharded("sharded_one", sim, fused, n_hold * 0.1)
    say("sharded_one", **line, build_s=build_s, fused_rtf_same_call=rtf_fused,
        card=json.dumps(card))
    say("sharded_one_hold", **held)
    del sim
    gc.collect()
    torch.cuda.empty_cache()

    # [sharded_nccl]: the same over an NCCL group of one, its all-gather
    # captured in the graphs
    mesh.init_single_process_group("nccl")
    try:
        sim = Simulator(cfg, connectome=c, backend="sharded", device=dev)
        if sim.backend.world.group is None:
            fail("sharded_nccl: the session's world has no process group")
        line, runs["sharded_nccl"] = sharded_run("sharded_nccl", sim,
                                                 args.t_sim)
        out["nccl_ms_per_step"] = line["ms_per_step"]
        held = hold_sharded("sharded_nccl", sim, fused, n_hold * 0.1)
        say("sharded_nccl", **line, backend=dist.get_backend(),
            fused_rtf_same_call=rtf_fused, card=json.dumps(card))
        say("sharded_nccl_hold", **held)
        del sim
    finally:
        dist.destroy_process_group()
    del fused
    gc.collect()
    torch.cuda.empty_cache()
    say("sharded_phase", seconds=f"{time.perf_counter() - t_phase:.1f}")
    out["launches"] = runs
    return out


#: [serve_sharded]: the scale of its pool's own connectome (a scenario
#: file's; a second full-scale host build would cost about two minutes)
SERVE_SHARDED_SCALE = 0.05
#: [sharded_checkpoint]: steps before and after the save, and after the
#: restore (within the 300 over which [graph_static] holds spikes exact)
CKPT_STEPS = 150


def sharded_checkpoint(phase: str, c, cfg, card: str, dev) -> tuple:
    """``[sharded_checkpoint]`` (the module's docstring): a graphed world
    of one saves after its presim and 150 steps, runs 150 more (A); a new
    session on the same backend restores and runs 150 (B).  Then a
    resident and a non-resident suspend, each resumed and run on 150 steps
    against the other.  Returns the line's fields and the launches."""
    import os
    import tempfile

    import numpy as np
    import torch
    from repro_torch.api import Simulator
    from repro_torch.kernels import _build

    N = c.n_total
    t_ms = CKPT_STEPS * cfg.dt
    probes = ("pop_counts", raster_probe(CKPT_STEPS, N))
    _build.reset_launches()
    a = Simulator(cfg, connectome=c, backend="sharded", device=dev,
                  probes=probes)
    if a.backend.n_dev != 1 or not a.backend.graphed:
        fail(f"{phase}: not a graphed world of one")
    a.warmup(t_ms)
    a.run(t_ms, probes=("pop_counts",))
    out = {"collective": a.backend.world.group is not None}
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = a.save(tmp)
        out["save_s"] = time.perf_counter() - t0
        out["checkpoint_bytes"] = dir_bytes(path)
        with np.load(os.path.join(path, "host_0.npz")) as f:
            out["ring_shape"] = json.dumps(list(f["['state']||.ring"].shape))
        overflow_saved = a.backend.overflow(a.state)
        run_a = a.run(t_ms)
        # another seed: b must take the checkpoint's generator state
        b = Simulator(cfg, connectome=c, backend=a.backend, device=dev,
                      probes=probes, key=int(cfg.seed) + 1000)
        misses = a.backend.graphs.misses
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        b.restore(tmp)
        torch.cuda.synchronize()
        out["restore_s"] = time.perf_counter() - t0
        if b.backend.overflow(b.state) != overflow_saved:
            fail(f"{phase}: the restored overflow differs from the saved")
        run_b = b.run(t_ms)
        torch.cuda.synchronize()
        if a.backend.graphs.misses != misses:
            fail(f"{phase}: the restore or the run after it captured "
                 f"({misses} -> {a.backend.graphs.misses} misses)")
        same_runs(f"{phase} (A against B)", run_a, run_b)
        rows = lambda r: r.streams["raster"]["carry"]["rows"]
        if not np.array_equal(rows(run_a), rows(run_b)):
            fail(f"{phase}: the gathered registry of B differs from A's")
        if not torch.equal(a._generator.get_state(),
                           b._generator.get_state()):
            fail(f"{phase}: the generators' states differ after B")
        out["elements_with_other_bits"] = json.dumps(
            compare_states(f"{phase} (A against B)", a.state, b.state))
        out["spikes"] = int(rows(run_a).sum())
        # b is resident in the backend's buffers, a is not
        freed = {}
        for name, sess in (("resident", b), ("not_resident", a)):
            gc.collect()
            torch.cuda.synchronize()
            mem0 = torch.cuda.memory_allocated()
            sess.suspend(os.path.join(tmp, name))
            gc.collect()
            freed[name] = mem0 - torch.cuda.memory_allocated()
        misses = a.backend.graphs.misses
        for name, sess in (("resident", b), ("not_resident", a)):
            sess.resume(os.path.join(tmp, name))
        run_a, run_b = a.run(t_ms), b.run(t_ms)
        torch.cuda.synchronize()
        if a.backend.graphs.misses != misses:
            fail(f"{phase}: a resume or the run after it captured")
        same_runs(f"{phase} (resumed A against resumed B)", run_a, run_b)
        if not np.array_equal(rows(run_a), rows(run_b)):
            fail(f"{phase}: the resumed sessions' registries differ")
        out["resumed_elements_with_other_bits"] = json.dumps(
            compare_states(f"{phase} (resumed)", a.state, b.state))
    counts = launched(phase, SHARDED_SESSION_KERNELS)
    if any(v for k, v in counts.items()
           if k not in SHARDED_SESSION_KERNELS):
        fail(f"{phase}: launched {counts} (K1, K2's local-ring form and "
             f"pop_counts only)")
    out.update(steps_before_save=CKPT_STEPS, steps_a_b=CKPT_STEPS,
               presim_ms=cfg.t_presim, captures_by_restore=0,
               exact=json.dumps(["spikes", "pop_counts", "t", "overflow",
                                 "refrac", "generator"]),
               resident_suspend_freed_bytes=freed["resident"],
               not_resident_suspend_freed_bytes=freed["not_resident"],
               launches=json.dumps(counts), card=json.dumps(card))
    del a, b
    gc.collect()
    torch.cuda.empty_cache()
    return out, counts


def serve_sharded(args, card: str, dev) -> tuple:
    """``[serve_sharded]`` (the module's docstring).  Returns the line's
    fields and the launches."""
    import torch
    from repro_torch.api import Experiment, concat
    from repro_torch.configs.microcircuit import MicrocircuitConfig
    from repro_torch.kernels import _build
    from repro_torch.serve import SessionManager, cache_stats

    compiles = lambda: cache_stats()["compiles"]
    exp = Experiment(model=MicrocircuitConfig(scale=SERVE_SHARDED_SCALE,
                                              strategy="ell"),
                     backend="sharded", probes=("pop_counts",
                                                "total_counts"),
                     name="serve_sharded")
    _build.reset_launches()
    out = {"scale": SERVE_SHARDED_SCALE}
    with SessionManager(device=dev) as mgr:
        t0 = time.perf_counter()
        a = mgr.create(exp, seed=args.seed)
        out["create_s"] = time.perf_counter() - t0
        before = compiles()
        twin = mgr.create(exp, seed=args.seed)
        if compiles() != before or twin.sim.backend is not a.sim.backend:
            fail("serve_sharded: the second create built or captured")
        if a.sim.backend.name != "sharded" or a.sim.backend.n_dev != 1 \
                or not a.sim.backend.graphed:
            fail("serve_sharded: not a graphed sharded world of one")
        # 30 ms in 4 chunks against the twin's one run (300 steps after the
        # presim), then 200 ms in 4 chunks, timed
        chunks = []
        a.run(30.0, chunk_ms=7.5, callback=lambda i, r: chunks.append(r))
        same_runs("serve_sharded (chunks against the twin)",
                  concat(chunks), twin.run(30.0))
        a.sim.warmup(50.0, include_presim=False)   # the chunks' graphs
        t0 = time.perf_counter()
        long = a.run(200.0, chunk_ms=50.0)
        out.update(request_s=time.perf_counter() - t0, rtf_200ms=long.rtf,
                   overflow=long.overflow,
                   rates_hz=json.dumps([round(float(r), 3) for r in
                                        long.summary()["rates_hz"]]))
        if long.overflow:
            fail(f"serve_sharded: overflow {long.overflow}")
        # suspend and resume, the resident session and one that is not,
        # each held to a twin carried from its state
        twin.run(0.1)                    # twin resident, a not
        a.sim.warmup(20.0, include_presim=False)   # the held runs' graphs
        for name, sess in (("resident", twin), ("not_resident", a)):
            other = mgr.create(exp, seed=0)
            other.sim.state = clone_state(sess.sim.state)
            gc.collect()
            torch.cuda.synchronize()
            mem0 = torch.cuda.memory_allocated()
            path = sess.suspend()
            gc.collect()
            out[f"{name}_suspend_freed_bytes"] = \
                mem0 - torch.cuda.memory_allocated()
            out[f"{name}_checkpoint_bytes"] = dir_bytes(path)
            before = compiles()
            sess.resume()                # under the zero-capture guard
            r_s, r_o = sess.run(20.0), other.sim.run(20.0, presim_ms=0)
            if compiles() != before:
                fail(f"serve_sharded: {name} resume or run captured")
            same_runs(f"serve_sharded ({name} resumed against twin)", r_s,
                      r_o)
            out[f"{name}_resumed_bits"] = json.dumps(compare_states(
                f"serve_sharded ({name} resumed)", sess.sim.state,
                other.sim.state))
            mgr.destroy(other.id)
        # two sessions coalesced, two twins one by one
        seeds = (args.seed + 2, args.seed + 3)
        co = [mgr.create(exp, seed=s) for s in seeds]
        seq = [mgr.create(exp, seed=s) for s in seeds]
        got = mgr.run_many({s.id: 20.0 for s in co}, coalesce=True)
        want = mgr.run_many({s.id: 20.0 for s in seq}, coalesce=False)
        bits = {}
        for x, y in zip(co, seq):
            same_runs(f"serve_sharded (coalesced {x.id} against {y.id})",
                      got[x.id], want[y.id])
            bits[x.id] = compare_states(f"serve_sharded (coalesced "
                                        f"{x.id})", x.sim.state, y.sim.state)
        out["coalesced_bits"] = json.dumps(bits)
    counts = launched("serve_sharded", SHARDED_SESSION_KERNELS)
    if any(v for k, v in counts.items()
           if k not in SHARDED_SESSION_KERNELS):
        fail(f"serve_sharded: launched {counts} (K1, K2's local-ring form "
             f"and pop_counts only)")
    out.update(chunks_equal_to_twin=True, resumed_equal_to_twin=True,
               coalesced_equal_to_sequential=True,
               launches=json.dumps({k: v for k, v in counts.items() if v}),
               card=json.dumps(card))
    gc.collect()
    torch.cuda.empty_cache()
    return out, counts


def core_phase(c, args, card: str, dev) -> dict:
    """``[core_simulate]``, ``[core_simulate_plastic]`` and
    ``[phase_runner]`` (the module's docstring) on the full-scale
    connectome.  Returns each line's launches."""
    import warnings

    import numpy as np
    import torch
    from repro_torch.api import Simulator
    from repro_torch.configs.microcircuit import MicrocircuitConfig
    from repro_torch.core import engine as E
    from repro_torch.core import plasticity as PL
    from repro_torch.core import recording
    from repro_torch.kernels import _build

    runs = {}
    cfg0 = MicrocircuitConfig(scale=args.scale, strategy="ell",
                              t_presim=0.0, seed=args.seed)
    split = E.SimConfig(strategy="ell", kernels="split")
    warnings.simplefilter("ignore", DeprecationWarning)
    pops = np.repeat(np.arange(len(c.pop_sizes)), c.pop_sizes)
    counts_of = lambda raster: np.stack(
        [raster[:, pops == p].sum(1) for p in range(len(c.pop_sizes))], 1)

    # [core_simulate]: 100 ms from a fresh state (the transient), then
    # 100 ms timed from its final state, K1 and K2 once a step
    st, _, net = E.simulate(c, 100.0, split, key=args.seed, device=dev)
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    st, rec, _ = E.simulate(c, 100.0, split, net=net, state=st, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n = rec.shape[0]
    runs["core_simulate"] = launched("core_simulate",
                                     ("lif_update", "ell_deliver"))
    got = {k: v for k, v in runs["core_simulate"].items() if v}
    if got != {"lif_update": n, "ell_deliver": n}:
        fail(f"core_simulate: launched {got} for {n} steps (K1 and K2 once "
             f"a step, nothing else)")
    if int(st.overflow) != 0:
        fail(f"core_simulate: overflow {int(st.overflow)}")
    rates = recording.activity_summary(rec.cpu().numpy(), c,
                                       0.1)["rates_hz"]
    check_rates(rates, "core_simulate")
    # 300 steps from one state and generator state against the
    # instrumented session
    start = clone_state(st)
    gen = st.generator
    twin_gen = torch.Generator(device=dev)
    twin_gen.set_state(gen.get_state())
    with_spikes = E.SimConfig(strategy="ell", kernels="split",
                              record="spikes")
    st2, raster, _ = E.simulate(c, 30.0, with_spikes, net=net,
                                state=st, device=dev)
    inst = Simulator(cfg0, connectome=c, backend="instrumented",
                     kernels="split", device=dev,
                     probes=("pop_counts", "spikes"))
    inst.state = start._replace(generator=twin_gen)
    res = inst.run(30.0)
    raster = raster.cpu().numpy()
    if not np.array_equal(raster, res["spikes"]):
        fail("core_simulate: the spikes differ from the instrumented "
             "session's")
    if not np.array_equal(counts_of(raster), res["pop_counts"]):
        fail("core_simulate: the population counts differ from the "
             "instrumented session's")
    if not torch.equal(st2.generator.get_state(),
                       inst._generator.get_state()):
        fail("core_simulate: the generators' states differ")
    bits = compare_states("core_simulate (against instrumented)", st2,
                          inst.state)
    say("core_simulate", policy="split (K1 + K2)", steps=n,
        ms_per_step=wall / n * 1e3, rtf=wall / (n * 1e-4), overflow=0,
        spikes_per_step=float(rec.sum()) / n,
        rates_hz=json.dumps([round(float(r), 3) for r in rates]),
        held_steps=raster.shape[0], spikes_held=int(raster.sum()),
        exact=json.dumps(["spikes", "pop_counts", "t", "overflow", "refrac",
                          "generator"]),
        elements_with_other_bits=json.dumps(bits),
        launches=json.dumps(got), card=json.dumps(card))
    del st, st2, net, rec, start, inst, res
    gc.collect()
    torch.cuda.empty_cache()

    # [core_simulate_plastic]: 300 steps, K4 and stdp_update once a step,
    # bitwise the session's
    sim_cfg = E.SimConfig(strategy="ell")
    _build.reset_launches()
    t0 = time.perf_counter()
    _, ps, (counts, mean_w) = PL.simulate_plastic(
        c, 30.0, sim_cfg, PL.STDPConfig(), key=args.seed, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    runs["core_simulate_plastic"] = launched(
        "core_simulate_plastic", ("lif_deliver_plastic", "stdp_update"))
    n = counts.shape[0]
    got = runs["core_simulate_plastic"]
    # once a step, and once for each of the steps the new backend runs
    # eagerly on a copy before its first capture (its head and a steady
    # step)
    warm = 3
    if got["lif_deliver_plastic"] != n + warm \
            or got["stdp_update"] != n + warm:
        fail(f"core_simulate_plastic: launched {got} for {n} steps and "
             f"{warm} warm-up steps")
    del ps
    gc.collect()
    sess = Simulator(connectome=c, sim_config=sim_cfg,
                     plasticity=PL.PairSTDP.from_stdp_config(
                         PL.STDPConfig()),
                     probes=("pop_counts", "mean_plastic_weight"),
                     key=args.seed, device=dev)
    res = sess.run(30.0)
    if not (np.array_equal(counts, res["pop_counts"])
            and np.array_equal(mean_w.view(np.int32),
                               res["mean_plastic_weight"].view(np.int32))):
        fail("core_simulate_plastic: the counts or the mean plastic weight "
             "differ from Simulator(plasticity=...)'s from the same seed "
             "(the shim's wiring, or a run a seed does not determine)")
    say("core_simulate_plastic", steps=n, wall_s=wall,
        spikes=int(counts.sum()), mean_weight_first=float(mean_w[0]),
        mean_weight_last=float(mean_w[-1]),
        same_as_session_from_seed=True,
        launches=json.dumps({k: v for k, v in got.items() if v}),
        card=json.dumps(card))
    del sess, res
    gc.collect()
    torch.cuda.empty_cache()

    # [phase_runner]: 100 timed steps against the instrumented session
    _build.reset_launches()
    runner = E.PhaseRunner(c, split, key=args.seed, device=dev)
    twin_gen = torch.Generator(device=dev)
    twin_gen.set_state(runner.state.generator.get_state())
    start = clone_state(runner.state)._replace(generator=twin_gen)
    timers = {}
    spikes = [runner.step_timed(timers) for _ in range(100)]
    runs["phase_runner"] = launched("phase_runner",
                                    ("lif_update", "ell_deliver"))
    # once a step, and once for each step the backend's warm-up runs
    # eagerly on a copy of the state before the timers start
    warm = runner._backend.head + 1
    got = {k: v for k, v in runs["phase_runner"].items() if v}
    if got != {"lif_update": 100 + warm, "ell_deliver": 100 + warm}:
        fail(f"phase_runner: launched {got} for 100 steps and {warm} "
             f"warm-up step(s) (K1 and K2 once a step, nothing else)")
    inst = Simulator(cfg0, connectome=c, backend="instrumented",
                     kernels="split", device=dev, probes=("spikes",))
    inst.state = start
    res = inst.run(10.0)
    raster = torch.stack(spikes).cpu().numpy()
    if sorted(timers) != ["deliver", "update"]:
        fail(f"phase_runner: timers {sorted(timers)}, not the reference's "
             f"['deliver', 'update']")
    if not np.array_equal(raster, res["spikes"]):
        fail("phase_runner: the spikes differ from the instrumented "
             "session's")
    say("phase_runner", steps=100, spikes=int(raster.sum()),
        timers_s=json.dumps(timers), spikes_exact=True,
        launches=json.dumps(got),
        ms_per_step=sum(timers.values()) / 100 * 1e3,
        card=json.dumps(card))
    warnings.simplefilter("default", DeprecationWarning)
    del runner, inst, res
    gc.collect()
    torch.cuda.empty_cache()
    return runs


def sharded_sessions_phase(c, args, card: str, dev) -> dict:
    """Phase 9c (the module's docstring), on the full-scale connectome
    ``c``.  Returns each sub-phase's launch counts."""
    import torch.distributed as dist
    from repro_torch.configs.microcircuit import MicrocircuitConfig
    from repro_torch.launch import mesh

    t_phase = time.perf_counter()
    cfg = MicrocircuitConfig(scale=args.scale, strategy="ell",
                             seed=args.seed)
    runs = {}
    line, runs["sharded_checkpoint"] = sharded_checkpoint(
        "sharded_checkpoint", c, cfg, card, dev)
    say("sharded_checkpoint", **line)
    mesh.init_single_process_group("nccl")
    try:
        line, runs["sharded_checkpoint_nccl"] = sharded_checkpoint(
            "sharded_checkpoint_nccl", c, cfg, card, dev)
        if not line["collective"]:
            fail("sharded_checkpoint_nccl: the world has no process group")
        say("sharded_checkpoint_nccl", backend=dist.get_backend(), **line)
    finally:
        dist.destroy_process_group()
    line, runs["serve_sharded"] = serve_sharded(args, card, dev)
    say("serve_sharded", **line)
    runs.update(core_phase(c, args, card, dev))
    say("sharded_sessions_phase",
        seconds=f"{time.perf_counter() - t_phase:.1f}")
    return runs


def session_api_phase(c, args, card: str, dev) -> dict:
    """Phase 9 (the module's docstring), on the full-scale connectome
    ``c``.  Returns each sub-phase's launch counts."""
    import dataclasses
    import os
    import tempfile

    import numpy as np
    import torch
    from repro_torch.api import Experiment, FusedBackend, Simulator
    from repro_torch.configs.microcircuit import MicrocircuitConfig
    from repro_torch.kernels import _build

    cfg = MicrocircuitConfig(scale=args.scale, strategy="ell",
                             seed=args.seed)
    runs = {}

    # [shared_backend]: sessions a and b on one backend, in turns, against
    # a lone session that runs a's seed and then b's (no presim: each
    # session runs 300 steps, the [graph_static] horizon)
    cfg0 = dataclasses.replace(cfg, t_presim=0.0)
    probes = ("pop_counts", "spikes")
    shared = FusedBackend()
    _build.reset_launches()
    a = Simulator(cfg0, connectome=c, backend=shared, device=dev,
                  probes=probes, key=args.seed)
    a.warmup(15.0)
    misses = shared.graphs.misses
    tables = shared.net
    b = Simulator(cfg0, connectome=c, backend=shared, device=dev,
                  probes=probes, key=args.seed + 1)
    if shared.net is not tables or shared.graphs.misses != misses:
        fail("shared_backend: the second session rebuilt or captured")
    got = {"a": [], "b": []}
    for who, sess in (("a", a), ("b", b), ("a", a), ("b", b)):
        got[who].append(sess.run(15.0))
    runs["shared_backend"] = launched("shared_backend", ("lif_deliver",))
    if shared.graphs.misses != misses:
        fail(f"shared_backend: session b's runs captured "
             f"({shared.graphs.misses} misses, {misses} before)")
    lone = Simulator(cfg0, connectome=c, device=dev, probes=probes,
                     key=args.seed)
    bits = {}
    for who, sess, key in (("a", a, args.seed), ("b", b, args.seed + 1)):
        lone.reset(key)
        for i in range(2):
            same_runs(f"shared_backend ({who}, run {i})", got[who][i],
                      lone.run(15.0))
        bits[who] = compare_states(f"shared_backend ({who})", sess.state,
                                   lone.state)
        if not torch.equal(sess._generator.get_state(),
                           lone._generator.get_state()):
            fail(f"shared_backend: session {who}'s generator differs")
    say("shared_backend", sessions=2, steps_each=2 * got["a"][0].n_steps,
        spikes=json.dumps({w: int(sum(r["spikes"].sum() for r in got[w]))
                           for w in got}),
        captures_by_second_session=0, graphs=json.dumps(shared.graphs.stats()),
        exact=json.dumps(["spikes", "pop_counts", "t", "overflow", "refrac",
                          "generator"]),
        elements_with_other_bits=json.dumps(bits))
    del a, b, lone, got, shared, tables
    gc.collect()
    torch.cuda.empty_cache()

    # [experiment_full]: a validated second of the full-scale model, and
    # its witness: the same experiment (network, seed, sample) on the
    # instrumented backend's eager loop with the plain PyTorch versions
    # (no kernel, no graph)
    backend = FusedBackend()
    exp = Experiment(model=cfg, validate=True, duration_ms=1000.0,
                     name="experiment_full")
    _build.reset_launches()
    result = exp.run(connectome=c, warmup=True, device=dev, backend=backend)
    runs["experiment_full"] = launched("experiment_full", ("lif_deliver",))
    for line in result.report.table().splitlines():
        print(f"[experiment_full_report] {line}", flush=True)
    res = result.trials[0]
    plain = Experiment(model=dataclasses.replace(cfg, kernels="reference"),
                       validate=True, duration_ms=1000.0,
                       backend="instrumented", name="experiment_full_plain")
    _build.reset_launches()
    t0 = time.perf_counter()
    witness = plain.run(connectome=c, device=dev)
    plain_s = time.perf_counter() - t0
    if any(_build.launches.values()):
        fail(f"experiment_full: the plain witness launched kernels "
             f"{dict(_build.launches)}")
    for line in witness.report.table().splitlines():
        print(f"[experiment_full_plain_report] {line}", flush=True)
    # a check that the kernel path fails, the plain witness fails too, and
    # the two values agree within WITNESS_RTOL (the statistics' spread over
    # seeds at full scale, tools/synchrony_scale.py)
    held, wrong = {}, []
    for ck, wk in zip(result.report.checks, witness.report.checks,
                      strict=True):
        if (ck.metric, ck.population) != (wk.metric, wk.population):
            fail(f"experiment_full: the reports' checks differ "
                 f"({ck.metric}/{ck.population}, "
                 f"{wk.metric}/{wk.population})")
        if ck.status == "pass":
            continue
        name = f"{ck.metric}/{ck.population}"
        held[name] = [ck.value, wk.value, wk.status]
        if wk.status == "pass" \
                or abs(ck.value - wk.value) > WITNESS_RTOL * abs(wk.value):
            wrong.append(name)
    wres = witness.trials[0]
    say("experiment_full", t_model_ms=res.t_model_ms, wall_s=res.wall_s,
        rtf=res.rtf, ms_per_step=res.wall_s / res.n_steps * 1e3,
        overflow=res.overflow, passed=result.report.passed,
        statuses=json.dumps(result.report.by_population()),
        plain_passed=witness.report.passed, plain_overflow=wres.overflow,
        plain_ms_per_step=wres.wall_s / wres.n_steps * 1e3,
        plain_s=plain_s, witness_rtol=WITNESS_RTOL,
        pop_counts_equal_to_plain=bool(np.array_equal(res["pop_counts"],
                                                      wres["pop_counts"])),
        held_to_witness=json.dumps(held),
        graphs=json.dumps(backend.graphs.stats()), card=json.dumps(card))
    if wrong or res.overflow or wres.overflow:
        fail(f"experiment_full: checks failed and not held by the plain "
             f"witness {wrong}, overflow {res.overflow} (plain "
             f"{wres.overflow})")
    del exp, result, res, plain, witness, wres

    # [run_batch]: 3 trials of 200 ms, each with its presim, over the
    # backend the experiment built (the same network and config: shared)
    sim = Simulator(cfg, connectome=c, backend=backend, device=dev,
                    probes=probes)
    before = clone_state(sim.state)
    gen_before = sim._generator.get_state()
    misses_warmup = backend.graphs.misses
    sim.warmup_batch(200.0, 3)          # the trials' graphs, before timing
    misses = backend.graphs.misses
    _build.reset_launches()
    batch = sim.run_batch(200.0, n_trials=3)
    runs["run_batch"] = launched("run_batch", ("lif_deliver",))
    misses_after = backend.graphs.misses
    for i, (seed, tr) in enumerate(zip(batch.seeds, batch.trials)):
        rates = tr.summary()["rates_hz"]
        say("run_batch_trial", trial=i, seed=seed, rtf=tr.rtf,
            ms_per_step=tr.wall_s / tr.n_steps * 1e3, overflow=tr.overflow,
            rates_hz=json.dumps([round(float(r), 3) for r in rates]))
        check_rates(rates, f"run_batch trial {i}")
        if tr.overflow:
            fail(f"run_batch: trial {i} overflowed {tr.overflow}")
    twin = Simulator(cfg, connectome=c, backend=backend, device=dev,
                     probes=probes, key=batch.seeds[0])
    twin_res = twin.run(30.0)
    same_runs("run_batch (trial 0 against reset(seed0); run)",
              batch.trials[0], twin_res, steps=twin_res.n_steps)
    untouched = all(bitwise(x, y) for x, y in zip(
        state_tensors(sim.state).values(), state_tensors(before).values()))
    if not untouched or not torch.equal(gen_before,
                                        sim._generator.get_state()):
        fail("run_batch changed the session's own state")
    if misses_after != misses:
        fail(f"run_batch captured after warmup_batch ({misses} misses "
             f"before, {misses_after} after)")
    say("run_batch", trials=len(batch), seeds=json.dumps(batch.seeds),
        t_ms=200.0, rtf_trials=json.dumps(batch.rtf_trials.tolist()),
        rtf_mean=batch.rtf_mean, rtf_std=batch.rtf_std,
        vmapped=batch.vmapped, trial0_steps_checked=twin_res.n_steps,
        session_state_bitwise_unchanged=True,
        graph_misses_before_warmup=misses_warmup,
        graph_misses_before=misses, graph_misses_after=misses_after,
        card=json.dumps(card))
    del sim, twin, twin_res, batch, before

    # [checkpoint], [checkpoint_plastic]
    for phase, plastic in (("checkpoint", None),
                           ("checkpoint_plastic", "pair_stdp")):
        be = backend if plastic is None else FusedBackend(
            plasticity=plastic)
        _build.reset_launches()
        sim = Simulator(cfg, connectome=c, backend=be, device=dev,
                        probes=probes, plasticity=plastic)
        sim.warmup(100.0)
        sim.warmup(30.0, include_presim=False)
        sim.run(100.0)
        with tempfile.TemporaryDirectory() as tmp:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            path = sim.save(tmp)
            save_s = time.perf_counter() - t0
            n_bytes = sum(os.path.getsize(os.path.join(path, f))
                          for f in os.listdir(path))
            run_a = sim.run(30.0)
            state_a = clone_state(sim.state)
            gen_a = sim._generator.get_state()
            misses = be.graphs.misses
            t0 = time.perf_counter()
            sim.restore(tmp)
            torch.cuda.synchronize()
            restore_s = time.perf_counter() - t0
            run_b = sim.run(30.0)
            if be.graphs.misses != misses:
                fail(f"{phase}: restore and the run after it captured")
            same_runs(f"{phase} (A against B)", run_a, run_b)
            bits = compare_states(f"{phase} (A against B)", state_a,
                                  sim.state)
            if not torch.equal(gen_a, sim._generator.get_state()):
                fail(f"{phase}: the generator's state differs after B")
            # suspend, then resume and hold the next run to a twin
            twin = Simulator(cfg, connectome=c, backend=be, device=dev,
                             probes=probes, plasticity=plastic)
            twin.state = clone_state(sim.state)
            torch.cuda.synchronize()
            mem_before = torch.cuda.memory_allocated()
            sim.suspend(tmp)
            gc.collect()
            mem_after = torch.cuda.memory_allocated()
            sim.resume(tmp)
            run_c, run_t = sim.run(30.0), twin.run(30.0, presim_ms=0)
            same_runs(f"{phase} (resumed against twin)", run_c, run_t)
            bits_resume = compare_states(f"{phase} (resumed against twin)",
                                         sim.state, twin.state)
        runs[phase] = launched(
            phase, ("lif_deliver",) if plastic is None
            else ("lif_deliver_plastic", "stdp_update"))
        say(phase, plasticity=plastic, step=sim._steps_done,
            checkpoint_bytes=n_bytes, save_s=save_s, restore_s=restore_s,
            steps_a_b=run_a.n_steps, captures_by_restore=0,
            exact=json.dumps(["spikes", "pop_counts", "t", "overflow",
                              "refrac", "generator"]
                             + (["weights", "x_pre", "x_post"]
                                if plastic else [])),
            elements_with_other_bits=json.dumps(bits),
            allocated_before_suspend=mem_before,
            allocated_after_suspend=mem_after,
            resumed_vs_twin_bits=json.dumps(bits_resume),
            card=json.dumps(card))
        del sim, twin, state_a, run_a, run_b, run_c, run_t, be
        gc.collect()
        torch.cuda.empty_cache()
    del backend
    gc.collect()
    torch.cuda.empty_cache()

    # [scenarios]: the four committed scenario files, each at its own
    # scale and duration
    for path in sorted((ROOT / "examples" / "scenarios").glob("*.json")):
        exp = Experiment.from_json(str(path))
        _build.reset_launches()
        result = exp.run(warmup=True, device=dev)
        name = f"scenario:{path.stem}"
        runs[name] = launched(name, ("lif_update",) + (
            () if exp.plasticity is None else ("stdp_update",)))
        res = result.trials[0]
        say("scenarios", file=path.name, scale=exp.model.scale,
            strategy=exp.model.strategy,
            plasticity=None if exp.plasticity is None
            else exp.plasticity.kind,
            duration_ms=exp.duration_ms, rtf=res.rtf, overflow=res.overflow,
            validate=exp.validate,
            passed=None if result.report is None else result.report.passed,
            rates_hz=json.dumps([round(float(r), 3) for r in
                                 res.summary()["rates_hz"]]),
            launches=json.dumps({k: v for k, v in runs[name].items() if v}))
        if result.report is not None:
            for line in result.report.table().splitlines():
                print(f"[scenario_report] {path.stem}: {line}", flush=True)
            if not result.report.passed:
                fail(f"scenario {path.name}: validation failed")
        del exp, result, res
        gc.collect()
        torch.cuda.empty_cache()
    return runs


def dir_bytes(path) -> int:
    import os
    return sum(os.path.getsize(os.path.join(path, f))
               for f in os.listdir(path))


def serve_phase(args, card: str, dev) -> dict:
    """Phase 12 (the module's docstring): the session server over the
    graphed session, its pool building its own connectome at ``--scale``.
    Returns each sub-phase's launch counts."""
    import os
    import threading
    import urllib.error
    import urllib.request

    import numpy as np
    import torch
    from repro_torch.api import Experiment
    from repro_torch.configs.microcircuit import MicrocircuitConfig
    from repro_torch.kernels import _build
    from repro_torch.serve import (ServeClient, SessionManager, SimServer,
                                   cache_stats)

    runs = {}
    compiles = lambda: cache_stats()["compiles"]
    exp = Experiment(model=MicrocircuitConfig(scale=args.scale,
                                              strategy="ell"),
                     probes=("pop_counts", "spikes"), name="serve_full")
    mgr = SessionManager(device=dev)
    server = SimServer(mgr, port=0).start()
    client = ServeClient(server.url, timeout=1200.0)

    # [serve_http]: two creates, a chunked run, while a second thread
    # polls /healthz and /stats (host only: they must answer throughout)
    codes, stop = [], threading.Event()

    def poll():
        while not stop.is_set():
            for path in ("/healthz", "/stats"):
                try:
                    with urllib.request.urlopen(server.url + path,
                                                timeout=60) as r:
                        r.read()
                        codes.append(r.status)
                except (urllib.error.URLError, OSError) as e:
                    codes.append(repr(e))
            stop.wait(0.2)

    poller = threading.Thread(target=poll, daemon=True)
    poller.start()
    _build.reset_launches()
    create_s = []
    for seed in (args.seed, args.seed + 1):
        before = compiles()
        t0 = time.perf_counter()
        sid = client.create(experiment=exp.to_dict(), seed=seed)["id"]
        create_s.append(time.perf_counter() - t0)
        if seed == args.seed:
            sid_a, compiles_a = sid, compiles()
        elif compiles() != before:
            fail(f"serve_http: the second create captured or built "
                 f"({before} -> {compiles()})")
    sess_a = mgr.get(sid_a)
    pol = sess_a.sim.sim_config.kernels
    if pol.step != "fused" or not sess_a.sim.backend.graphed:
        fail(f"serve_http: auto resolved to {pol.describe()}, not the "
             f"graphed fused loop")
    # the exact check, over the first 300 steps after the presim (where
    # [shared_backend] holds spikes exact: K3's float atomics add in no
    # fixed order), in 4 chunks; then the timed 200 ms in 4 chunks
    check = client.run(sid_a, t_ms=30.0, chunk_ms=7.5)
    t0 = time.perf_counter()
    records = client.run(sid_a, t_ms=200.0, chunk_ms=50.0)
    request_s = time.perf_counter() - t0
    stop.set()
    poller.join(120)
    runs["serve_http"] = launched("serve_http", ("lif_deliver",))
    bad = [c for c in codes if c != 200]
    if poller.is_alive() or bad or len(codes) < 4:
        fail(f"serve_http: the poller saw {len(codes)} replies, not all "
             f"200: {bad[:5]}")
    chunks = [r for r in records if "chunk" in r]
    final = records[-1]
    if len(chunks) != 4 or not final.get("done"):
        fail(f"serve_http: {len(chunks)} chunks, final {final}")
    lone = exp.make_simulator(sess_a.sim.connectome, device=dev,
                              key=args.seed)
    lone_check = []
    lone.run_chunked(30.0, 7.5, callback=lambda i, r: lone_check.append(
        r["pop_counts"].sum(0).astype(int).tolist()))
    lone_chunks = []
    lone.run_chunked(200.0, 50.0, callback=lambda i, r: lone_chunks.append(
        (r["pop_counts"].sum(0).astype(int).tolist(), r.rtf)))
    got_check = [r["pop_spikes"] for r in check if "chunk" in r]
    if got_check != lone_check:
        fail(f"serve_http: the streamed chunks' population totals over the "
             f"first 300 steps differ from a lone session's: {got_check} "
             f"against {lone_check}")
    chunk_wall = sum(r["rtf"] * r["t_model_ms"] / 1e3 for r in chunks)
    rates = np.array([r["pop_spikes"] for r in chunks]).sum(0) / (
        np.asarray(lone.connectome.pop_sizes) * 0.2)
    check_rates(rates, "serve_http")
    say("serve_http", scale=args.scale, policy=pol.describe(),
        create_s=json.dumps(create_s), compiles_after_creates=compiles_a,
        captures_by_second_create=0,
        pool=json.dumps(mgr.pool.stats()),
        check_chunks_equal_to_lone=True, check_steps=300,
        chunk_rtf=json.dumps([r["rtf"] for r in chunks]),
        rtf=final["rtf"], request_s=request_s, chunk_wall_s=chunk_wall,
        front_end_s=request_s - chunk_wall,
        lone_chunk_rtf=json.dumps([r for _, r in lone_chunks]),
        chunks_equal_to_lone_200ms=json.dumps(
            [r["pop_spikes"] == p for r, (p, _) in zip(chunks,
                                                        lone_chunks)]),
        rates_hz=json.dumps([round(float(r), 3) for r in rates]),
        polls=len(codes), polls_200=len(codes) - len(bad),
        card=json.dumps(card))
    del lone, lone_check, lone_chunks
    gc.collect()

    # [serve_coalesced]: four sessions run as one group, four twins one by
    # one (each with its presim first); <= 300 steps after the presim
    _build.reset_launches()
    seeds = list(range(args.seed + 2, args.seed + 6))
    co = [mgr.create(exp, seed=s) for s in seeds]
    seq = [mgr.create(exp, seed=s) for s in seeds]
    walls, results = {}, {}
    before = compiles()
    for mode, group in (("coalesced", co), ("sequential", seq)):
        t0 = time.perf_counter()
        out = mgr.run_many({s.id: 20.0 for s in group},
                           coalesce=mode == "coalesced")
        torch.cuda.synchronize()
        walls[mode] = (time.perf_counter() - t0,
                       sum(out[s.id].wall_s for s in group))
        results[mode] = [out[s.id] for s in group]
        if mode == "coalesced":
            after_group = compiles()
    if after_group - before > 1 or compiles() != after_group:
        fail(f"serve_coalesced: captured after the group's first session "
             f"({before} -> {after_group} -> {compiles()})")
    runs["serve_coalesced"] = launched("serve_coalesced", ("lif_deliver",))
    bits = {}
    for a, b, ra, rb in zip(co, seq, results["coalesced"],
                            results["sequential"]):
        same_runs(f"serve_coalesced ({a.id} against {b.id})", ra, rb)
        bits[a.id] = compare_states(f"serve_coalesced ({a.id} against "
                                    f"{b.id})", a.sim.state, b.sim.state)
    say("serve_coalesced", sessions=len(co), seeds=json.dumps(seeds),
        t_ms=20.0, captures_in_group=after_group - before,
        captures_by_twins=compiles() - after_group,
        coalesced_wall_s=walls["coalesced"][0],
        coalesced_run_wall_s=walls["coalesced"][1],
        sequential_wall_s=walls["sequential"][0],
        sequential_run_wall_s=walls["sequential"][1],
        exact=json.dumps(["spikes", "pop_counts", "t", "overflow",
                          "refrac"]),
        elements_with_other_bits=json.dumps(bits), card=json.dumps(card))

    # [serve_suspend]: the resident session (the last twin run) and a
    # non-resident one, each held to a twin carried from its state
    def suspend_resume(phase, sess, atomics=True):
        twin = mgr.create(sess.experiment, seed=0)
        twin.sim.state = clone_state(sess.sim.state)
        torch.cuda.synchronize()
        gc.collect()
        mem0 = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        path = sess.suspend()
        save_s = time.perf_counter() - t0
        gc.collect()
        mem1 = torch.cuda.memory_allocated()
        before = compiles()
        t0 = time.perf_counter()
        sess.resume()                   # under the zero-capture guard
        torch.cuda.synchronize()
        resume_s = time.perf_counter() - t0
        run_s = sess.run(20.0)
        run_t = twin.sim.run(20.0, presim_ms=0)
        if compiles() != before:
            fail(f"{phase}: the resume or the run after it captured")
        same_runs(f"{phase} (resumed against twin)", run_s, run_t)
        bits = compare_states(f"{phase} (resumed against twin)",
                              sess.sim.state, twin.sim.state, atomics)
        mgr.destroy(twin.id)
        return dict(checkpoint_bytes=dir_bytes(path), save_s=save_s,
                    resume_s=resume_s, allocated_before_suspend=mem0,
                    allocated_after_suspend=mem1,
                    freed_bytes=mem0 - mem1,
                    resumed_vs_twin_bits=json.dumps(bits))

    _build.reset_launches()
    resident = seq[-1]
    if resident.sim.state.ring.data_ptr() != \
            resident.sim.backend._io.sim.ring.data_ptr():
        fail("serve_suspend: the last session run is not the resident one")
    for name, sess in (("resident", resident), ("not_resident", co[0])):
        say("serve_suspend", session=name, id=sess.id,
            **suspend_resume(f"serve_suspend ({name})", sess),
            card=json.dumps(card))
    runs["serve_suspend"] = launched("serve_suspend", ("lif_deliver",))
    for s in co + seq:
        mgr.destroy(s.id)
    gc.collect()
    _build.reset_launches()
    plastic = mgr.create(str(ROOT / "examples" / "scenarios" /
                             "stdp_ee.json"), seed=args.seed)
    plastic.run(20.0)
    fields = suspend_resume("serve_suspend (plastic)", plastic)
    runs["serve_suspend_plastic"] = launched(
        "serve_suspend_plastic", ("lif_update", "stdp_update"))
    say("serve_suspend", session="plastic", id=plastic.id,
        scale=plastic.experiment.model.scale,
        strategy=plastic.experiment.model.strategy,
        policy=plastic.sim.sim_config.kernels.describe(),
        exact=json.dumps(["spikes", "pop_counts", "t", "overflow", "refrac",
                          "weights", "x_pre", "x_post"]),
        **fields, card=json.dumps(card))
    client.shutdown()
    server.stop()                       # closes the manager
    del mgr, server, client, sess_a, co, seq, resident, plastic, results
    gc.collect()
    torch.cuda.empty_cache()

    # [serve_smoke]: the CLI's lifecycle check, in a process of its own
    t0 = time.perf_counter()
    smoke = subprocess.run(
        [sys.executable, "-m", "repro_torch.serve", "--smoke",
         "examples/scenarios/smoke_background.json"], cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(SRC)},
        capture_output=True, text=True, timeout=600)
    for line in (smoke.stdout + smoke.stderr).splitlines():
        print(f"[serve_smoke_out] {line}", flush=True)
    say("serve_smoke", rc=smoke.returncode,
        seconds=time.perf_counter() - t0)
    if smoke.returncode != 0:
        fail(f"serve_smoke: exit code {smoke.returncode}")
    return runs


# ---------------------------------------------------------------------------
# [analysis]: the hot-path guards and the launch tooling on the card
# ---------------------------------------------------------------------------

#: ``[graph_contract]``'s warm run (check_graphed's longer one): three body
#: graphs long, so that its body graph is told apart by its replay count
CONTRACT_STEPS = 300


def body_graph(sim, n_steps: int):
    """``(entry, graph)``: the graph cache's entry of a warm run of
    ``n_steps`` with the session's probes, and its body graph (the one
    replayed most)."""
    backend = sim.backend
    entry = backend.graphs.peek(backend._key(n_steps, tuple(sim.probes)))
    return entry, max(entry.graphs, key=lambda gt: gt[1])[0]


def replay_body(entry, graph) -> None:
    """One replay of a body graph (``graph_steps`` steps), its probes'
    rows written from row 0."""
    entry.row.zero_()
    graph.replay(1)


def graph_contract_line(label: str, sim, card: str, kernels) -> dict:
    """``[graph_contract]``: GC001-GC004 on the warm graphed session
    ``sim`` (``graph_contract.check_graphed``: two warm runs under the sync
    debug mode "error", their replays and eager work, the census of an
    eager step), the step's kernels launched per step over a warm run of
    ``CONTRACT_STEPS``, the device-to-host copies and float64 kernels in
    one replayed body (the profiler's census, 0 each).  Returns the body's
    kernel census and its replay's ms a step."""
    import torch
    from repro_torch.analysis import graph_contract as GC
    from repro_torch.kernels import _build
    from repro_torch.perf.step_analysis import kernel_census
    t0 = time.perf_counter()
    out = GC.check_graphed(sim, symbol=label)
    if out["findings"]:
        fail(f"graph_contract {label}: "
             + "; ".join(f.format() for f in out["findings"]))
    probes = tuple(sim.probes)
    _build.reset_launches()
    sim.backend.run(sim.state, CONTRACT_STEPS, probes)
    torch.cuda.synchronize()
    per_step = {k: _build.launches[k] / CONTRACT_STEPS for k in kernels}
    if any(v != 1.0 for v in per_step.values()):
        fail(f"graph_contract {label}: kernels a step {per_step}, not 1")
    entry, body = body_graph(sim, CONTRACT_STEPS)
    census = kernel_census(lambda: replay_body(entry, body),
                           sim.backend.graph_steps)
    d2h = sum(v["launches_per_step"] for k, v in census["kernels"].items()
              if "DtoH" in k or "Device -> Host" in k)
    f64 = [k for k in census["kernels"] if "double" in k or "float64" in k]
    if d2h or f64 or out["census"]["f64_tensors"]:
        fail(f"graph_contract {label}: {d2h} device-to-host copies a step "
             f"in a replayed body, float64 kernels {f64}")
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    replay_body(entry, body)
    start.record()
    for _ in range(10):
        replay_body(entry, body)
    stop.record()
    stop.synchronize()
    body_ms = start.elapsed_time(stop) / (10 * sim.backend.graph_steps)
    c = out["census"]
    say("graph_contract", path=label, rules="GC001-GC004", findings=0,
        warm_runs=json.dumps(out["runs"]),
        kernels_per_step=json.dumps(per_step), casts_per_step=c["casts"],
        cast_kinds=json.dumps(c["cast_kinds"]),
        eager_ops_per_step=c["ops_per_step"][0],
        host_syncs_per_step=c["host_syncs"],
        d2h_copies_in_replay=d2h, float64_kernels=len(f64),
        float64_tensors=c["f64_tensors"], seconds=time.perf_counter() - t0,
        card=json.dumps(card))
    return {"census": census, "body_ms_per_step": body_ms,
            "eager_ops": c["ops"]}


def step_census_line(label: str, contract: dict, ms_step: float,
                     card: str) -> None:
    """``[step_census]``: the profiler's table of one replayed body (each
    kernel's launches and device µs a step), its sum against the body
    replay's event time a step and the run's graphed ms a step."""
    census = contract["census"]
    say("step_census", path=label, kernels=json.dumps({
        k: {"launches_per_step": round(v["launches_per_step"], 3),
            "us_per_step": round(v["us_per_step"], 3)}
        for k, v in census["kernels"].items()}),
        device_us_per_step=census["us_per_step"],
        launches_per_step=census["launches_per_step"],
        body_replay_ms_per_step=contract["body_ms_per_step"],
        graphed_run_ms_per_step=ms_step,
        busy_share_of_body=census["us_per_step"] / 1e3
        / contract["body_ms_per_step"],
        eager_aten_ops_per_step=json.dumps(contract["eager_ops"]),
        card=json.dumps(card))


#: the step of the next run into whose ring slot ``[sanitize]`` puts a NaN
NAN_STEP = 37


def sanitize_line(sim, card: str) -> None:
    """``[sanitize]``: a warm 100-step run of ``sim`` under ``sanitize()``
    raises nothing; the same run with a NaN arrival in the ring slot that
    step ``NAN_STEP`` reads raises there, naming ``I_ex``.  Leaves ``sim``'s
    state with the NaN (the caller drops it)."""
    from repro_torch.analysis.sanitize import sanitize
    sim.warmup(10.0, include_presim=False)
    t0 = time.perf_counter()
    with sanitize():
        res = sim.run(10.0)
    clean_s = time.perf_counter() - t0
    st = sim.state
    t = int(st.t)
    st.ring[(t + NAN_STEP) % st.ring.shape[0], 0,
            st.ring.shape[2] // 3] = float("nan")
    t0 = time.perf_counter()
    try:
        with sanitize():
            sim.run(10.0)
    except FloatingPointError as e:
        said = str(e)
    else:
        fail("sanitize: a NaN in the ring raised nothing")
    want = f"step {NAN_STEP} of this run (step counter t = {t + NAN_STEP})"
    if want not in said or "I_ex" not in said:
        fail(f"sanitize: raised {said!r}, not at {want} in I_ex")
    say("sanitize", clean_steps=res.n_steps, clean_rtf=res.rtf,
        clean_s=clean_s, nan_step=NAN_STEP, raised=json.dumps(said),
        locate_s=time.perf_counter() - t0, card=json.dumps(card))


#: [dense_sharded]'s steps (each run K5 once a step)
DENSE_SHARDED_STEPS = 300


def dense_sharded_line(W, c_d, args, card: str, dev) -> dict:
    """``[dense_sharded]``: ``distributed.make_dense_step`` as a world of
    one over an NCCL group of one (``launch.mesh.make_host_mesh``), on the
    dense path's bin-major table ``W`` (its connectome ``c_d``) with the
    8 Hz background: K5 launched exactly once a step; the same steps from
    the same state and generator state with K5's plain version, every
    tensor and count bitwise; ms a step.  Returns the K5 run's launches."""
    import torch
    import torch.distributed as dist
    from repro_torch.core import distributed as DD
    from repro_torch.core.neuron import Propagators
    from repro_torch.core.params import NeuronParams
    from repro_torch.kernels import _build
    from repro_torch.kernels import spike_deliver as K5
    from repro_torch.launch import mesh as M
    n, d = c_d.n_total, c_d.d_max_bins
    prop = Propagators.make(NeuronParams(), 0.1)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    V0 = torch.as_tensor(c_d.v0_mean, device=dev) + torch.as_tensor(
        c_d.v0_sd, device=dev) * torch.randn(n, generator=gen, device=dev)
    aux = {"k_ext": torch.as_tensor(c_d.k_ext, device=dev),
           "i_dc": torch.as_tensor(c_d.i_dc, device=dev)}
    gen0 = gen.get_state()
    M.init_single_process_group("nccl")
    try:
        world = M.world2d(M.make_host_mesh())
        runs = {}
        for name, matvec in (("kernel", None),
                             ("plain", K5.gated_spike_matvec_plain)):
            gen.set_state(gen0)
            sim = DD.make_dense_step(
                world, prop, n=n, n_exc=c_d.n_exc, w_ext=c_d.w_ext,
                bg_rate=8.0, dt=0.1, n_steps=DENSE_SHARDED_STEPS,
                matvec=matvec)
            st = DD.dense_state(V0, d, gen)
            sim.step(st, W, aux)             # NCCL's communicator, built
            st = DD.dense_state(V0, d, gen)
            gen.set_state(gen0)
            torch.cuda.synchronize()
            _build.reset_launches()
            t0 = time.perf_counter()
            st, counts = sim(st, W, aux)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            runs[name] = (st, counts, dict(_build.launches), wall)
        collective = dist.get_backend()
    finally:
        dist.destroy_process_group()
    (sk, ck, lk, wk), (sp, cp, lp, wp) = runs["kernel"], runs["plain"]
    want = {"gated_spike_matvec": DENSE_SHARDED_STEPS}
    if any(lk[k] != v for k, v in want.items()) \
            or any(v for k, v in lk.items() if k not in want) \
            or any(lp.values()):
        fail(f"dense_sharded: K5 launched {lk} (and the plain run {lp}) "
             f"for {DENSE_SHARDED_STEPS} steps")
    same = {name: bitwise(getattr(sk, name), getattr(sp, name))
            for name in ("V", "I_ex", "I_in", "refrac", "ring", "t")}
    same["counts"] = bitwise(ck, cp)
    if not all(same.values()):
        fail(f"dense_sharded: K5's run departs from the plain version's "
             f"{same}")
    if int(ck.sum()) == 0:
        fail("dense_sharded: no spike in the run")
    say("dense_sharded", world="1x1", collective=collective, n=n, d_bins=d,
        table=json.dumps([list(W.shape), str(W.dtype)]),
        steps=DENSE_SHARDED_STEPS, spikes=int(ck.sum()),
        launches=json.dumps(lk), bitwise_to_plain=json.dumps(same),
        ms_per_step=wk / DENSE_SHARDED_STEPS * 1e3,
        plain_ms_per_step=wp / DENSE_SHARDED_STEPS * 1e3,
        card=json.dumps(card))
    return lk


def dryrun_line(one: dict, card: str) -> None:
    """``[dryrun]``: ``launch.dryrun``'s four cells (event and dense on
    pod1 and pod2; meta tensors, nothing allocated), and the reckoned
    argument bytes of a world of one at the real ``k_loc`` against the
    bytes phase 9b's world of one holds (``one``), which must be equal."""
    from repro_torch.launch import dryrun
    t0 = time.perf_counter()
    for shape in dryrun.STRATEGIES:
        for mesh_name in ("pod1", "pod2"):
            r = dryrun.run_cell("microcircuit", shape, mesh_name, force=True)
            say("dryrun", cell=f"{shape}__{mesh_name}",
                n_devices=r["n_devices"],
                argument_bytes=r["memory"]["argument_bytes"],
                temp_bytes_upper_bound=r["memory"]["temp_bytes_upper_bound"],
                fits=r["memory"]["fits"],
                flops_per_device=r["flops_per_device"],
                bytes_accessed_per_device=r["bytes_accessed_per_device"],
                collective_wire_bytes_per_device=r[
                    "collective_wire_bytes_per_device"],
                collectives=json.dumps(r["collectives"]),
                k_loc=r.get("k_loc"), w_block=json.dumps(r.get("w_block")))
    reckoned = dryrun.rank_argument_bytes(one["n"], 1, one["k_loc"],
                                          one["d"])
    if reckoned != one["bytes"]:
        fail(f"dryrun: a world of one reckons {reckoned} argument bytes, "
             f"its tables and state hold {one['bytes']}")
    say("dryrun_world_of_one", k_loc=one["k_loc"], reckoned_bytes=reckoned,
        real_bytes=one["bytes"], equal=True,
        seconds=time.perf_counter() - t0, card=json.dumps(card))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--t-sim", type=float, default=1000.0)
    ap.add_argument("--t-sim-plastic", type=float, default=300.0)
    ap.add_argument("--scale-dense", type=float, default=0.2)
    ap.add_argument("--t-sim-dense", type=float, default=1000.0)
    ap.add_argument("--seed", type=int, default=55)
    args = ap.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA card: torch.cuda.is_available() is false")
    if not (SRC / "repro_torch" / "csrc").is_dir():
        fail(f"the port's sources are not beside this script "
             f"({SRC / 'repro_torch'} missing)")
    sys.path.insert(0, str(SRC))
    from repro_torch.api import Simulator
    from repro_torch.configs.microcircuit import MicrocircuitConfig
    from repro_torch.core import connectivity as CONN
    from repro_torch.core import plasticity as PL
    from repro_torch.core.connectivity import build_connectome
    from repro_torch.core.delivery import REGISTRY as STRATEGIES
    from repro_torch.core.engine import SimConfig
    from repro_torch.core.neuron import Propagators
    from repro_torch.core.params import NeuronParams
    from repro_torch.kernels import _build
    from repro_torch.kernels import ell_deliver as K2
    from repro_torch.kernels import lif_deliver as K3
    from repro_torch.kernels import lif_update as K1
    from repro_torch.kernels import spike_deliver as K5
    from repro_torch.kernels import stdp as KS
    from repro_torch.kernels.ell_deliver import compact_ids_plain

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    card = card_line()

    # -- 1. card and build ---------------------------------------------------
    say("card", nvidia_smi=json.dumps(card), torch=torch.__version__,
        cuda=torch.version.cuda)
    build_s = _build.build_all()
    for name in _build.SOURCES:
        _build.library(name)
        regs = [ln.strip() for ln in _build.ptxas_report.get(name, "")
                .splitlines() if "registers" in ln or "spill" in ln]
        say("ptxas", kernel=name, report=json.dumps(regs))
    sm90_build(_build)
    say("build", seconds=f"{build_s:.2f}",
        K3_K4_grid=K3.cooperative_grid(dev, 77_170),
        stdp_update_grid=KS.launch_grid(dev))

    prop = Propagators.make(NeuronParams(), 0.1)
    rng = np.random.default_rng(args.seed)
    on = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    # -- 2. K1 bitwise at N = 77,169 -----------------------------------------
    n1 = 77_169
    k1_in = (on(rng.uniform(-80, -45, n1).astype(np.float32)),
             on((rng.uniform(0, 1, n1) * 400).astype(np.float32)),
             on((-rng.uniform(0, 1, n1) * 400).astype(np.float32)),
             on(rng.integers(0, 21, n1).astype(np.int32)),
             on((rng.uniform(0, 1, n1) * 100).astype(np.float32)),
             on((-rng.uniform(0, 1, n1) * 100).astype(np.float32)),
             on(rng.uniform(-20, 20, n1).astype(np.float32)))
    got = K1.lif_update(*k1_in, prop=prop)
    want = K1.lif_update_plain(*k1_in, prop=prop)
    torch.cuda.synchronize()
    for name, a, b in zip(("V", "I_ex", "I_in", "refrac", "spiked"),
                          got, want):
        if not torch.equal(a, b):
            fail(f"K1 lif_update {name} differs from the plain version in "
                 f"{int((a != b).sum())} of {n1} neurons")
    say("K1", n=n1, bitwise=True, spikes=int(got[4].sum()))

    # -- 3. K2 / K3 on the connectome's ELL tables ---------------------------
    t0 = time.perf_counter()
    c = build_connectome(scale=args.scale, seed=args.seed)
    build_conn_s = time.perf_counter() - t0
    ell = STRATEGIES["ell"]
    t0 = time.perf_counter()
    tables = ell.prepare(c, SimConfig(strategy="ell"), dev)
    torch.cuda.synchronize()
    prep_s = time.perf_counter() - t0
    table_bytes = sum(t.numel() * t.element_size() for t in tables)
    N, D, budget = c.n_total, c.d_max_bins, 256
    k_pad = tables.targets.shape[1]
    grid = K3.cooperative_grid(dev, N + 1)
    say("connectome", scale=args.scale, n=N, synapses=c.n_synapses,
        k_max=c.targets.shape[1], k_pad=k_pad, d_bins=D,
        build_s=f"{build_conn_s:.1f}", tables_to_device_s=f"{prep_s:.1f}",
        table_bytes=table_bytes)

    def ring0(d=D, n=N):
        r = np.zeros((d, 2, n + 1), np.float32)
        r[:, 0, :n] = rng.uniform(0, 50, (d, n))      # channel signs as by
        r[:, 1, :n] = -rng.uniform(0, 50, (d, n))     # Dale's law
        return on(r)

    def spiked_with(k, n=N):
        s = np.zeros(n, bool)
        s[rng.choice(n, size=k, replace=False)] = True
        return on(s)

    state_in = (on(rng.uniform(-80, -45, N).astype(np.float32)),
                on((rng.uniform(0, 1, N) * 400).astype(np.float32)),
                on((-rng.uniform(0, 1, N) * 400).astype(np.float32)),
                on(rng.integers(0, 21, N).astype(np.int32)))
    # the drive as the step hands it to K3 and K4: float32 spike counts,
    # weighted by w_ext inside; the running overflow the kernels add to
    ext_cnt = on(rng.poisson(10.0, N).astype(np.float32))
    ovf0 = torch.zeros((), dtype=torch.int32, device=dev)
    k3_kw = dict(n_exc=c.n_exc, prop=prop, w_ext=c.w_ext)
    i_dc = torch.as_tensor(c.i_dc, device=dev)
    tbl = (tables.targets, tables.weights, tables.dbins)
    max_err = {name: 0.0 for name in _build.KERNELS}
    # the step counter the kernels read on the card (K3 and K4 integrate
    # step t and deliver at t - 1, K2 and K5 deliver at t); t_seq[i] is
    # step t_step + i
    t_step = 1234
    t_seq = torch.arange(t_step, t_step + 2000, dtype=torch.int32,
                         device=dev)
    t_dev = t_seq[0]
    # random spikes, then the compaction's edges: one spike at N - 1; the
    # first and last neuron of every tile (budget 512, so that all are
    # delivered); 200 spikes in one tile; an overflow cut inside a tile
    # that is not the first; a burst of 5,000 (N / 2 in a smaller network)
    # with budget 8,192
    tiles = K3.compaction_tiles(N, grid)
    spiked_at = lambda idx: on(np.isin(np.arange(N), idx))
    in_tile = lambda b, k: rng.choice(np.arange(*tiles[b]), replace=False,
                                      size=min(k, tiles[b][1] - tiles[b][0]))
    b_cut = max(1, grid // 2)
    cases = [(f"random_{k}", spiked_with(k), budget) for k in (0, 31, 256,
                                                                 300)] + [
        ("one_at_N-1", spiked_at([N - 1]), budget),
        ("tile_edges", spiked_at([i for lo, hi in tiles if hi > lo
                                  for i in (lo, hi - 1)]), 512),
        ("200_in_one_tile", spiked_at(in_tile(min(7, grid - 1), 200)),
         budget),
        ("cut_inside_tile", spiked_at(np.concatenate([
            rng.choice(tiles[b_cut][0], size=min(150, tiles[b_cut][0]),
                       replace=False), in_tile(b_cut, 200)])), budget),
        ("burst_5000", spiked_with(min(5000, N // 2)), 8192)]
    for case, spk, bud in cases:
        k = int(spk.sum())
        ring = ring0()
        r_k, ids_k, ovf_k = K2.ell_deliver(ring.clone(), *tbl, spk, t_dev,
                                           c.n_exc, bud)
        r_p, ids_p, ovf_p = K2.ell_deliver_plain(ring.clone(), *tbl, spk,
                                                 t_dev, c.n_exc, bud)
        torch.cuda.synchronize()
        if not (torch.equal(ids_k, ids_p) and torch.equal(ovf_k, ovf_p)):
            fail(f"K2 ids/overflow differ in case {case}")
        err = float((r_k - r_p).abs().max())
        if not torch.allclose(r_k, r_p, rtol=RING_RTOL, atol=RING_ATOL):
            fail(f"K2 ring differs in case {case}: max |diff| {err}")
        max_err["ell_deliver"] = max(max_err["ell_deliver"], err)
        del r_k, r_p

        out_k = K3.lif_deliver(ring.clone(), *tbl, spk, *state_in, ext_cnt,
                               i_dc, t_dev, ovf0, budget=bud, **k3_kw)
        out_p = K3.lif_deliver_plain(ring.clone(), *tbl, spk, *state_in,
                                     ext_cnt, i_dc, t_dev, ovf0, budget=bud,
                                     **k3_kw)
        torch.cuda.synchronize()
        names = ("ring", "V", "I_ex", "I_in", "refrac", "spiked", "ids",
                 "overflow", "t")
        errs = {}
        for name, a, b in zip(names, out_k, out_p):
            if name in ("ring", "I_ex", "I_in"):
                errs[name] = float((a - b).abs().max())
                if not torch.allclose(a, b, rtol=RING_RTOL, atol=RING_ATOL):
                    fail(f"K3 {name} differs in case {case}: max |diff| "
                         f"{errs[name]}")
            elif not torch.equal(a, b):
                fail(f"K3 {name} differs from the plain version in case "
                     f"{case}")
        max_err["lif_deliver"] = max(max_err["lif_deliver"], *errs.values())
        say("K2+K3", case=case, spikes=k, budget=bud, overflow=int(ovf_k),
            ids_exact=True, K2_ring_max_abs_err=err,
            K3_max_abs_err=json.dumps(errs))
        del out_k, out_p

    # 2,000 launches of K3 back to back on one workspace, at spike counts
    # that change from launch to launch: each launch's ids and overflow
    # against compact_ids_plain, and the workspace's launch count advanced
    # by the kernel alone
    pool = [spiked_with(k) for k in (0, 1, 3, 25, 31, 100, 255, 256, 257,
                                     300, 600, 2)]
    want_ids = [compact_ids_plain(x, budget) for x in pool]
    ws = K3.workspace(dev, grid)
    ws0 = int(ws[0])
    ring = ring0()
    got = [K3.lif_deliver(ring, *tbl, pool[i % len(pool)], *state_in,
                          ext_cnt, i_dc, t_seq[i], ovf0, budget=budget,
                          **k3_kw)[6:8] for i in range(2000)]
    torch.cuda.synchronize()
    for i, (ids_k, ovf_k) in enumerate(got):
        ids_p, ovf_p = want_ids[i % len(pool)]
        if not (torch.equal(ids_k, ids_p) and torch.equal(ovf_k, ovf_p)):
            fail(f"K3's launch {i} of 2,000 back to back: ids or overflow "
                 f"differ from compact_ids_plain")
    advanced = int(ws[0]) - ws0
    if advanced != 2000:
        fail(f"K3's launch count advanced by {advanced} over 2,000 "
             f"launches")
    say("K3_sequence", launches=2000, ids_overflow_exact=True,
        spike_counts=json.dumps([int(x.sum()) for x in pool]),
        launch_count_advanced=advanced)

    # K2 and K3 in turns on the one workspace, each at every spike count:
    # each launch's ids and overflow exact, the launch count advanced by
    # the kernel alone
    ws0 = int(ws[0])
    got = []
    for i in range(400):
        spk = pool[(i // 2) % len(pool)]
        got.append(K2.ell_deliver(ring, *tbl, spk, t_seq[i], c.n_exc,
                                  budget)[1:] if i % 2 else
                   K3.lif_deliver(ring, *tbl, spk, *state_in, ext_cnt, i_dc,
                                  t_seq[i], ovf0, budget=budget,
                                  **k3_kw)[6:8])
    torch.cuda.synchronize()
    for i, (ids_k, ovf_k) in enumerate(got):
        ids_p, ovf_p = want_ids[(i // 2) % len(pool)]
        if not (torch.equal(ids_k, ids_p) and torch.equal(ovf_k, ovf_p)):
            fail(f"{'K2' if i % 2 else 'K3'}'s launch {i} of 400 in turns: "
                 f"ids or overflow differ from compact_ids_plain")
    advanced = int(ws[0]) - ws0
    if advanced != 400:
        fail(f"K2 and K3 in turns advanced the launch count by {advanced} "
             f"over 400 launches")
    say("K2_K3_interleaved", launches=400, ids_overflow_exact=True,
        launch_count_advanced=advanced)
    del got, pool, want_ids

    # -- 3b. K4 and stdp_update on the same tables ---------------------------
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ptab = PL.build_plastic_tables(tables, c.n_exc)
    torch.cuda.synchronize()
    ptab_s = time.perf_counter() - t0
    pmask = ptab.plastic_out
    ptab_bytes = sum(t.numel() * t.element_size() for t in (
        ptab.in_syn_idx, ptab.plastic_out, ptab.plastic_in))
    coef = PL.stdp_coefficients(PL.PairSTDP().scaled(c, 0.1))
    # a handful of E->E weights beyond w_max, so that the clip has work
    w_base = tables.weights.clone()
    plastic_idx = torch.nonzero(pmask.view(-1)).view(-1)
    n_plastic_syn = int(plastic_idx.numel())
    pick = plastic_idx[torch.randperm(n_plastic_syn, device=dev)[:1000]]
    w_base.view(-1)[pick] = 1.5 * coef.w_max
    w_over = int((w_base[pmask] > coef.w_max).sum())
    del plastic_idx, pick
    say("plastic_tables", build_s=f"{ptab_s:.3f}", bytes=ptab_bytes,
        k_in=ptab.in_syn_idx.shape[1], plastic_synapses=n_plastic_syn,
        weights_above_w_max=w_over, coef=json.dumps(coef._asdict()))
    traces = lambda: on(rng.uniform(0, 3, N).astype(np.float32))

    def stdp_bitwise(ids, spk, x_pre, x_post):
        """``stdp_update`` in its four forms against its plain version."""
        k = int(spk.sum())
        for full in (False, True):
            for clip_all in (False, True):
                w_k, w_p = w_base.clone(), w_base.clone()
                stdp_in = (tables.targets, pmask, ptab.in_syn_idx,
                           ptab.plastic_in, ids, x_pre, x_post, spk, coef)
                got = KS.stdp_update(w_k, *stdp_in, full=full,
                                     clip_all=clip_all)
                want = KS.stdp_update_plain(w_p, *stdp_in, full=full,
                                            clip_all=clip_all)
                torch.cuda.synchronize()
                for name, a, b in zip(("weights", "x_pre", "x_post"), got,
                                      want):
                    max_err["stdp_update"] = max(
                        max_err["stdp_update"], float((a - b).abs().max()))
                    if not bitwise(a, b):
                        fail(f"stdp_update {name} differs from the plain "
                             f"version at {k} spikes, budget {len(ids)} "
                             f"(full={full}, clip_all={clip_all})")
                changed = int((w_k != w_base).sum())
                say("stdp_update", spikes=k, budget=len(ids), full=full,
                    clip_all=clip_all, bitwise=True, weights_changed=changed)

    for case, spk, bud in cases:
        k = int(spk.sum())
        ring = ring0()
        x_pre, x_post = traces(), traces()
        w_k, w_p = w_base.clone(), w_base.clone()
        k4_in = (spk, *state_in, ext_cnt, i_dc, x_pre, x_post, t_dev, ovf0)
        k4_kw = dict(budget=bud, coef=coef, **k3_kw)
        out_k = K3.lif_deliver_plastic(ring.clone(), tables.targets, w_k,
                                       tables.dbins, pmask, *k4_in, **k4_kw)
        out_p = K3.lif_deliver_plastic_plain(
            ring.clone(), tables.targets, w_p, tables.dbins, pmask, *k4_in,
            **k4_kw)
        torch.cuda.synchronize()
        names = ("ring", "weights", "V", "I_ex", "I_in", "refrac", "spiked",
                 "x_pre", "x_post", "ids", "overflow", "t")
        errs = {}
        for name, a, b in zip(names, out_k, out_p):
            if name in ("ring", "I_ex", "I_in"):
                errs[name] = float((a - b).abs().max())
                if not torch.allclose(a, b, rtol=RING_RTOL, atol=RING_ATOL):
                    fail(f"K4 {name} differs in case {case}: max |diff| "
                         f"{errs[name]}")
            elif not bitwise(a, b):
                fail(f"K4 {name} differs from the plain version in case "
                     f"{case}")
        max_err["lif_deliver_plastic"] = max(
            max_err["lif_deliver_plastic"], *errs.values())
        ids = out_k[9]
        n_depressed = int((w_k != w_base).sum())
        say("K4", case=case, spikes=k, budget=bud, overflow=int(out_k[10]),
            exact=json.dumps([m for m in names if m not in errs]),
            weights_depressed=n_depressed, max_abs_err=json.dumps(errs))
        # the burst's budget is the most ids the kernel keeps in shared
        # memory
        if case.startswith("random_") or case == "burst_5000":
            stdp_bitwise(ids, spk, x_pre, x_post)
    # a budget past the kernel's shared copy of the ids (8,192) that cuts
    # 1,000 spiking targets (in a smaller network N / 2 spikes, half cut)
    spk = spiked_with(min(10_000, N // 2))
    n_spk = int(spk.sum())
    stdp_bitwise(compact_ids_plain(spk, n_spk - min(1000, n_spk // 2))[0],
                 spk, traces(), traces())
    del tables, tbl, ring, out_k, out_p, w_k, w_p, w_base, ptab, pmask
    torch.cuda.empty_cache()

    # -- 4. the port against its plain reference on the card -----------------
    small = MicrocircuitConfig(scale=0.02, strategy="ell", t_presim=0.0)
    rasters = {}
    for mode in ("reference", "fused", "split"):
        s = Simulator(small, kernels=mode, probes=("spikes",), device=dev)
        r = s.run(20.0)
        V = s.state.neuron.V
        if not bool(torch.isfinite(V).all()):
            fail(f"non-finite V in the {mode} path at scale 0.02")
        rasters[mode] = (r["spikes"], V.cpu().numpy())
    for mode in ("fused", "split"):
        same = np.array_equal(rasters[mode][0], rasters["reference"][0])
        dv = float(np.abs(rasters[mode][1] - rasters["reference"][1]).max())
        if not same:
            fail(f"{mode} path's spike raster differs from the plain "
                 f"reference at scale 0.02")
        say("vs_reference", mode=mode, steps=rasters[mode][0].shape[0],
            spikes=int(rasters[mode][0].sum()), raster_equal=True,
            max_abs_dV_mV=dv)
    plastic_runs = {}
    for mode in ("reference", "fused", "split"):
        s = Simulator(small, kernels=mode, probes=("spikes",),
                      plasticity="pair_stdp", device=dev)
        r = s.run(50.0)
        plastic_runs[mode] = (r["spikes"], s.state[1].weights)
    for mode in ("fused", "split"):
        spikes, w = plastic_runs[mode]
        if not np.array_equal(spikes, plastic_runs["reference"][0]):
            fail(f"{mode} plastic path's spike raster differs from the "
                 f"plain reference at scale 0.02")
        if not bitwise(w, plastic_runs["reference"][1]):
            fail(f"{mode} plastic path's final weights differ from the "
                 f"plain reference at scale 0.02")
        say("vs_reference_plastic", mode=mode, steps=spikes.shape[0],
            spikes=int(spikes.sum()), raster_equal=True,
            weights_bitwise=True)
    del plastic_runs

    # -- 5. the main path -----------------------------------------------------
    cfg = MicrocircuitConfig(scale=args.scale, strategy="ell",
                             seed=args.seed)
    t0 = time.perf_counter()
    sim = Simulator(cfg, connectome=c, device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    pol = sim.sim_config.kernels
    if pol.step != "fused":
        fail(f"auto policy resolved to {pol.describe()}, not fused")
    if not sim.backend.graphed:
        fail("the main path's session is not the graphed loop")
    t0 = time.perf_counter()
    sim.warmup(args.t_sim)              # the run's graphs and the presim's
    sim.warmup(20.0, include_presim=False)      # the profiled window's
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    _build.reset_launches()
    res = sim.run(args.t_sim)
    fused_launches = dict(_build.launches)
    steps_total = sim._steps(sim.t_presim) + res.n_steps
    rates = res.summary()["rates_hz"]
    ms_step = res.wall_s / res.n_steps * 1e3
    say("main_path", policy=pol.describe(), budget=sim.sim_config.spike_budget,
        tables_to_device_s=f"{setup_s:.1f}", presim_ms=sim.t_presim,
        run_ms=args.t_sim, steps=res.n_steps, wall_s=res.wall_s,
        rtf=res.rtf, ms_per_step=ms_step, overflow=res.overflow,
        spikes_per_step=float(res["pop_counts"].sum()) / res.n_steps,
        graph_steps=sim.backend.graph_steps, capture_s=capture_s,
        graphs=json.dumps(sim.backend.graphs.stats()), card=json.dumps(card))
    say("rates_hz", **{p: f"{r:.3f}" for p, r in zip(POPS, rates)})
    say("launches", path="fused", **fused_launches,
        steps_incl_presim=steps_total)
    if res.overflow != 0:
        fail(f"overflow {res.overflow} on the main path")
    if fused_launches["lif_deliver"] != steps_total:
        fail(f"K3 launched {fused_launches['lif_deliver']} times for "
             f"{steps_total} steps")
    check_rates(rates, "main path")
    spikes_per_step = max(1, round(float(res["pop_counts"].sum())
                                   / res.n_steps))
    budget_main = sim.sim_config.spike_budget
    rtf_main = res.rtf

    # where a step's time goes: device time by kernel over 200 more steps,
    # against the unprofiled wall time per step
    say("main_path_profile", **profile_window(sim, 20.0, ms_step))

    # the graphed loop against the eager one, from one state; the eager
    # loop's own time a step (the same connectome, the same card)
    eager = Simulator(cfg, connectome=c, device=dev, backend="instrumented")
    say("graph_draws", **graph_draws(sim.backend, args.seed))
    say("graph_static", policy=pol.describe(),
        **hold_to_eager("graph_static", sim, eager, 30.0, atomics=True))
    eager_res = eager.run(100.0)
    say("main_path_eager", backend="instrumented",
        policy=eager.sim_config.kernels.describe(), steps=eager_res.n_steps,
        rtf=eager_res.rtf,
        ms_per_step=eager_res.wall_s / eager_res.n_steps * 1e3,
        timers_s=json.dumps(eager_res.timers), graphed_ms_per_step=ms_step,
        card=json.dumps(card))
    del eager

    # run_chunked on the main path: chunks 2..N capture nothing, and the
    # result is the one run's from the same state and generator state
    start, gen0 = clone_state(sim.state), sim._generator.get_state()
    t_chunk, n_chunks = 10.0, 5
    sim.warmup(t_chunk * n_chunks, include_presim=False)
    one = sim.run(t_chunk * n_chunks)
    one_state = clone_state(sim.state)
    sim.state = clone_state(start)
    sim._generator.set_state(gen0)
    misses = []
    chunked = sim.run_chunked(t_chunk * n_chunks, t_chunk,
                              callback=lambda i, r: misses.append(
                                  sim.backend.graphs.misses))
    if len(set(misses)) != 1:
        fail(f"run_chunked: chunks 2..{n_chunks} captured new graphs "
             f"(graph-cache misses after each chunk: {misses})")
    same_runs("run_chunked against run", chunked, one)
    bits = compare_states("run_chunked against run", sim.state, one_state)
    say("run_chunked", chunks=n_chunks, steps=chunked.n_steps,
        graph_misses_after_each_chunk=json.dumps(misses),
        pop_counts_equal=True, elements_with_other_bits=json.dumps(bits))
    del start, one, one_state, chunked

    # [analysis] on the main path's session: the graph contracts, the
    # replayed body's kernels, sanitize() (which leaves a NaN in the state)
    t0 = time.perf_counter()
    contract = graph_contract_line("static", sim, card,
                                   ("lif_deliver", "pop_counts"))
    step_census_line("static", contract, ms_step, card)
    sanitize_line(sim, card)
    analysis_s = {"static": time.perf_counter() - t0}
    del sim, contract
    torch.cuda.empty_cache()

    # -- 6. the split path ----------------------------------------------------
    split_cfg = MicrocircuitConfig(scale=args.scale, strategy="ell",
                                   seed=args.seed, t_presim=0.0,
                                   kernels="split")
    sim = Simulator(split_cfg, connectome=c, device=dev)
    sim.warmup(100.0)
    _build.reset_launches()
    res_s = sim.run(100.0)
    split_launches = dict(_build.launches)
    say("split_path", policy=sim.sim_config.kernels.describe(),
        steps=res_s.n_steps, rtf=res_s.rtf,
        ms_per_step=res_s.wall_s / res_s.n_steps * 1e3,
        overflow=res_s.overflow)
    say("launches", path="split", **split_launches)
    if split_launches["lif_update"] != res_s.n_steps \
            or split_launches["ell_deliver"] != res_s.n_steps:
        fail(f"split path launched K1/K2 {split_launches} for "
             f"{res_s.n_steps} steps")
    eager = Simulator(split_cfg, connectome=c, device=dev,
                      backend="instrumented")
    say("graph_split", policy=sim.sim_config.kernels.describe(),
        **hold_to_eager("graph_split", sim, eager, 30.0, atomics=True))
    del sim, eager
    torch.cuda.empty_cache()

    # -- 7. the plastic path --------------------------------------------------
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sim = Simulator(cfg, connectome=c, plasticity="pair_stdp", device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    pol = sim.sim_config.kernels
    if pol.step != "fused":
        fail(f"auto policy of the plastic path resolved to "
             f"{pol.describe()}, not fused")
    rule = sim.backend.bound
    pmask, w_static = rule.plastic_mask, sim.backend.net.tables.weights
    w_max = float(np.float32(rule.coef.w_max))
    sim.warmup(args.t_sim_plastic)
    sim.warmup(20.0, include_presim=False)
    if not bitwise(sim.state[1].weights, w_static):
        fail("warmup changed the session's plastic weights")
    mean_before = float(PL.mean_plastic_weight(sim.state[1].weights, pmask))
    _build.reset_launches()
    res_pl = sim.run(args.t_sim_plastic)
    plastic_launches = dict(_build.launches)
    steps_pl = sim._steps(sim.t_presim) + res_pl.n_steps
    w = sim.state[1].weights
    mean_after = float(PL.mean_plastic_weight(w, pmask))
    plastic_w = w[pmask]
    finite = bool(torch.isfinite(w).all())
    w_lo, w_hi = float(plastic_w.min()), float(plastic_w.max())
    static_same = bitwise(torch.where(pmask, 0.0, w),
                          torch.where(pmask, 0.0, w_static))
    moved = int((w != w_static).sum())
    del plastic_w
    table_bytes_pl = sum(
        t.numel() * t.element_size() for t in (
            *sim.backend.net.tables, w, rule.tables.in_syn_idx,
            rule.tables.plastic_out, rule.tables.plastic_in))
    rates_pl = res_pl.summary()["rates_hz"]
    ms_step_pl = res_pl.wall_s / res_pl.n_steps * 1e3
    say("plastic_path", policy=pol.describe(),
        budget=sim.sim_config.spike_budget,
        setup_s=f"{setup_s:.1f}", presim_ms=sim.t_presim,
        run_ms=args.t_sim_plastic, steps=res_pl.n_steps,
        wall_s=res_pl.wall_s, rtf=res_pl.rtf, ms_per_step=ms_step_pl,
        overflow=res_pl.overflow,
        spikes_per_step=float(res_pl["pop_counts"].sum()) / res_pl.n_steps,
        table_bytes_on_card=table_bytes_pl,
        peak_allocated_bytes=torch.cuda.max_memory_allocated())
    say("rates_hz_plastic", **{p: f"{r:.3f}" for p, r in zip(POPS,
                                                                rates_pl)})
    say("plastic_weights", finite=finite, plastic_min=w_lo,
        plastic_max=w_hi, w_max=w_max, static_bitwise=static_same,
        entries_changed=moved, mean_before=mean_before,
        mean_after=mean_after)
    say("launches", path="plastic", **plastic_launches,
        steps_incl_presim=steps_pl)
    if res_pl.overflow != 0:
        fail(f"overflow {res_pl.overflow} on the plastic path")
    check_rates(rates_pl, "plastic path")
    if not (finite and 0.0 <= w_lo and w_hi <= w_max and static_same):
        fail("plastic weights out of [0, w_max], not finite, or a static "
             "weight changed")
    # K4 every step; the STDP update after K4 from the second step of a
    # run on, plus the epilogue's whole step: once per step too
    if plastic_launches["lif_deliver_plastic"] != steps_pl \
            or plastic_launches["stdp_update"] != steps_pl:
        fail(f"plastic path launched {plastic_launches} for {steps_pl} "
             f"steps")
    say("plastic_path_profile", **profile_window(sim, 20.0, ms_step_pl))
    # the graphed plastic loop (its head steps and whole-table clip at the
    # start of the run) against the eager split plastic loop, from one state
    eager = Simulator(cfg, connectome=c, plasticity="pair_stdp", device=dev,
                      backend="instrumented")
    say("graph_plastic", policy=pol.describe(),
        **hold_to_eager("graph_plastic", sim, eager, 30.0, atomics=True))
    eager_res = eager.run(30.0)
    say("plastic_path_eager", backend="instrumented",
        policy=eager.sim_config.kernels.describe(), steps=eager_res.n_steps,
        rtf=eager_res.rtf,
        ms_per_step=eager_res.wall_s / eager_res.n_steps * 1e3,
        timers_s=json.dumps(eager_res.timers), graphed_ms_per_step=ms_step_pl,
        card=json.dumps(card))
    del eager, eager_res
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    graph_contract_line("plastic", sim, card,
                        ("lif_deliver_plastic", "stdp_update", "pop_counts"))
    analysis_s["plastic"] = time.perf_counter() - t0
    spikes_pl = max(1, round(float(res_pl["pop_counts"].sum())
                             / res_pl.n_steps))
    tables = sim.backend.net.tables
    tbl = (tables.targets, tables.weights, tables.dbins)

    # -- 8. kernel times at the main paths' shapes ---------------------------
    # Each call gets one of 64 spike vectors of the path's mean count, so
    # the gathered ELL rows (about 2 MB a call) come from device memory
    # rather than from the L2 copy the previous call left.
    k1_bytes = N * (7 * 4 + 4 * 4 + 1)             # 7 in, 4 out, spikes
    k1_args = tuple(x[:N] for x in k1_in)
    k1 = timed(lambda i: K1.lif_update(*k1_args, prop=prop))
    k1_plain = timed(lambda i: K1.lif_update_plain(*k1_args, prop=prop))

    spks = [spiked_with(spikes_per_step) for _ in range(64)]
    spk_of = lambda i: spks[i % len(spks)]
    ids_np = [np.flatnonzero(s.cpu().numpy())[:budget_main] for s in spks]
    # entries with a real target (padding is skipped), per call on average
    n_entries = float(np.mean([(c.targets[i] < N).sum() for i in ids_np]))
    ring = ring0()
    k2 = timed(lambda i: K2.ell_deliver(ring, *tbl, spk_of(i), t_dev,
                                        c.n_exc, budget_main))
    k2_plain = timed(lambda i: K2.ell_deliver_plain(
        ring, *tbl, spk_of(i), t_dev, c.n_exc, budget_main))

    def flat_rows(ids):                 # index_add_'s inputs for one call
        ids_t = torch.as_tensor(ids, device=dev)
        lin = (torch.remainder(t_step + tables.dbins[ids_t].long(), D)
               * (2 * (N + 1))
               + (ids_t >= c.n_exc).long()[:, None] * (N + 1)
               + tables.targets[ids_t].long())
        return lin.reshape(-1), tables.weights[ids_t].reshape(-1)
    lib_in = [flat_rows(i) for i in ids_np]
    k2_lib = timed(lambda i: ring.view(-1).index_add_(
        0, *lib_in[i % len(lib_in)]))

    k3_bytes = (N * (6 * 4 + 4 * 4 + 1) + N          # state, drive, spikes
                + 2 * 2 * (N + 1) * 4                # slot read + zeroed
                + 4 * budget_main + 4 + n_entries * (12 + 8))
    k3_state = (*state_in, ext_cnt, i_dc, t_dev, ovf0)
    k3 = timed(lambda i: K3.lif_deliver(
        ring, *tbl, spk_of(i), *k3_state, budget=budget_main, **k3_kw))
    k3_plain = timed(lambda i: K3.lif_deliver_plain(
        ring, *tbl, spk_of(i), *k3_state, budget=budget_main, **k3_kw))
    say("timing", spikes=spikes_per_step, real_entries=n_entries,
        K1=json.dumps(k1), K2=json.dumps(k2), K3=json.dumps(k3),
        K2_index_add=json.dumps(k2_lib))

    # the pop_counts probe: its kernel (one launch) against its plain
    # version (the running count differenced at the population bounds) and
    # the index_add_ into 8 counters that the plain version replaced, on
    # the same spike vectors: equal counts, and each one's device time
    from repro_torch.api import probes as PR
    pop_of = torch.as_tensor(c.pop_of, device=dev)
    pc_probe = PR.pop_counts()
    pc_ctx = [PR.ProbeContext(None, x, SimpleNamespace(pop_of=pop_of), 8)
              for x in spks]
    pc_plain_ctx = [x._replace(kernels=False) for x in pc_ctx]
    old_counts = lambda i: torch.zeros(8, dtype=torch.int32, device=dev) \
        .index_add_(0, pop_of, spk_of(i).to(torch.int32))
    for i in range(len(spks)):
        got = pc_probe(pc_ctx[i])
        if not (torch.equal(got, pc_probe(pc_plain_ctx[i]))
                and torch.equal(got, old_counts(i))):
            fail("the pop_counts kernel differs from its plain version's "
                 "or index_add_'s counts")
    pc = timed(lambda i: pc_probe(pc_ctx[i % len(pc_ctx)]))
    pc_plain = timed(lambda i: pc_probe(pc_plain_ctx[i % len(pc_ctx)]))
    # the spikes and the 9 bounds read, the 8 counts written
    pc_bytes = N + 4 * (9 + 8)
    say("pop_counts_probe", spikes=spikes_per_step, counts_equal=True,
        kernel=json.dumps(pc), running_count=json.dumps(pc_plain),
        index_add=json.dumps(timed(old_counts)))

    def k3_on(r):
        return lambda i, **kw: K3.lif_deliver(
            r, *tbl, spk_of(i), *k3_state, budget=budget_main, **k3_kw, **kw)

    def stamps_of(launch, buffer=lambda: K3.stamps_buffer(dev, N + 1),
                  names=K3.PHASES):
        for i in range(3):
            launch(i, stamps=buffer())
        bufs = [buffer() for _ in range(64)]
        for i, b in enumerate(bufs):
            launch(i, stamps=b)
        torch.cuda.synchronize()
        return phase_table(torch.stack(bufs)[..., :len(names) + 1], names)

    def same_outputs(what, names, tol):
        def compare(i, got, want):
            for name, a, b in zip(names, got, want):
                ok = (torch.allclose(a, b, rtol=RING_RTOL, atol=RING_ATOL)
                      if name in tol else bitwise(a, b))
                if not ok:
                    fail(f"{what} in a CUDA graph: launch {i}'s {name} "
                         f"differs from the same launch run eagerly")
        return compare

    say("K3_phases", spikes=spikes_per_step, launches=64,
        us_median_mean_max=json.dumps(stamps_of(k3_on(ring))))
    ring_g = ring0()
    ring_e = ring_g.clone()
    k3_on(ring_e.clone())(0)             # warm-up outside the capture
    k3["graph_ms"] = graph_replay(
        k3_on(ring_g), k3_on(ring_e), same_outputs(
            "K3", ("ring", "V", "I_ex", "I_in", "refrac", "spiked", "ids",
                   "overflow", "t"), ("ring", "I_ex", "I_in")))
    del ring_g, ring_e
    say("K3_graph", launches_captured=64, replay_equal_to_eager=True,
        graph_ms=k3["graph_ms"], ms=k3["ms"], call_ms=k3["call_ms"])

    def k2_on(r):
        return lambda i, **kw: K2.ell_deliver(r, *tbl, spk_of(i), t_dev,
                                              c.n_exc, budget_main, **kw)

    say("K2_phases", spikes=spikes_per_step, launches=64,
        us_median_mean_max=json.dumps(stamps_of(k2_on(ring),
                                                names=K2.PHASES)))
    ring_g = ring0()
    ring_e = ring_g.clone()
    k2_on(ring_e.clone())(0)             # warm-up outside the capture
    k2["graph_ms"] = graph_replay(
        k2_on(ring_g), k2_on(ring_e), same_outputs(
            "K2", ("ring", "ids", "overflow"), ("ring",)))
    del ring_g, ring_e
    say("K2_graph", launches_captured=64, replay_equal_to_eager=True,
        graph_ms=k2["graph_ms"], ms=k2["ms"], call_ms=k2["call_ms"])

    # K4 and stdp_update at the plastic path's shapes: its mean spike count,
    # the session's weights (a copy), random traces
    ptables = rule.tables
    w_t = w.clone()
    x_pre_t, x_post_t = traces(), traces()
    spks_pl = [spiked_with(spikes_pl) for _ in range(64)]
    ids_pl = [compact_ids_plain(x, budget_main)[0] for x in spks_pl]
    k4_state = (*state_in, ext_cnt, i_dc, x_pre_t, x_post_t, t_dev, ovf0)
    k4_kw = dict(budget=budget_main, coef=rule.coef, **k3_kw)
    k4 = timed(lambda i: K3.lif_deliver_plastic(
        ring, tables.targets, w_t, tables.dbins, pmask, spks_pl[i % 64],
        *k4_state, **k4_kw))
    k4_plain = timed(lambda i: K3.lif_deliver_plastic_plain(
        ring, tables.targets, w_t, tables.dbins, pmask, spks_pl[i % 64],
        *k4_state, **k4_kw))

    def k4_on(r, w_live):
        return lambda i, **kw: K3.lif_deliver_plastic(
            r, tables.targets, w_live, tables.dbins, pmask, spks_pl[i % 64],
            *k4_state, **k4_kw, **kw)

    say("K4_phases", spikes=spikes_pl, launches=64,
        us_median_mean_max=json.dumps(stamps_of(k4_on(ring, w_t))))
    ring_g, w_g = ring0(), w_t.clone()
    ring_e, w_e = ring_g.clone(), w_t.clone()
    k4_on(ring_e.clone(), w_t)(0)        # warm-up outside the capture
    k4["graph_ms"] = graph_replay(
        k4_on(ring_g, w_g), k4_on(ring_e, w_e), same_outputs(
            "K4", ("ring", "weights", "V", "I_ex", "I_in", "refrac",
                   "spiked", "x_pre", "x_post", "ids", "overflow", "t"),
            ("ring", "I_ex", "I_in")))
    del ring_g, ring_e, w_g, w_e
    say("K4_graph", launches_captured=64, replay_equal_to_eager=True,
        graph_ms=k4["graph_ms"], ms=k4["ms"], call_ms=k4["call_ms"])
    stdp_args = lambda i: (tables.targets, pmask, ptables.in_syn_idx,
                           ptables.plastic_in, ids_pl[i % 64], x_pre_t,
                           x_post_t, spks_pl[i % 64], rule.coef)
    k5 = timed(lambda i: KS.stdp_update(w_t, *stdp_args(i), full=False,
                                        clip_all=False))
    k5_plain = timed(lambda i: KS.stdp_update_plain(
        w_t, *stdp_args(i), full=False, clip_all=False))
    k5_full = timed(lambda i: KS.stdp_update(w_t, *stdp_args(i), full=True,
                                             clip_all=False))
    k5_clip = timed(lambda i: KS.stdp_update(w_t, *stdp_args(i), full=False,
                                             clip_all=True), iters=8)

    def stdp_on(w_live, full):
        return lambda i, **kw: KS.stdp_update(
            w_live, *stdp_args(i), full=full, clip_all=False, **kw)

    for full, t in ((False, k5), (True, k5_full)):
        say("stdp_phases", full=full, spikes=spikes_pl, launches=64,
            us_median_mean_max=json.dumps(stamps_of(
                stdp_on(w_t, full), lambda: KS.stamps_buffer(dev),
                KS.PHASES)))
        w_g, w_e = w_t.clone(), w_t.clone()
        stdp_on(w_e.clone(), full)(0)    # warm-up outside the capture
        t["graph_ms"] = graph_replay(
            stdp_on(w_g, full), stdp_on(w_e, full), same_outputs(
                "stdp_update", ("weights", "x_pre", "x_post"), ()))
        del w_g, w_e
        say("stdp_graph", full=full, launches_captured=64,
            replay_equal_to_eager=True, graph_ms=t["graph_ms"], ms=t["ms"],
            call_ms=t["call_ms"])
    cnt = stdp_counts(tables.targets, pmask, ptables.in_syn_idx,
                      ptables.plastic_in, ids_pl)
    k4_bytes = (N * (6 * 4 + 4 * 4 + 1) + N + 2 * 2 * (N + 1) * 4
                + 4 * budget_main + 4 + cnt["out"] * (12 + 8)
                + cnt["out"] + 4 * cnt["out_plastic"] + 16 * N)
    k4_ops = (LIF_OPS * N + ENTRY_OPS * cnt["out"]
              + 2 * cnt["out_plastic"] + 4 * N)
    k5_bytes = stdp_bytes(cnt, budget_main)
    say("timing_plastic", spikes=spikes_pl, entries=json.dumps(cnt),
        K4=json.dumps(k4), stdp_update=json.dumps(k5),
        stdp_update_full_step=json.dumps(k5_full),
        stdp_update_whole_table_clip=json.dumps(k5_clip))

    # -- 9. the session API at full scale -------------------------------------
    del sim, rule, tables, tbl, ptables, pmask, w_static, w, w_t, lib_in
    gc.collect()
    torch.cuda.empty_cache()
    api_runs = session_api_phase(c, args, card, dev)

    # -- 9b. the sharded backend at full scale --------------------------------
    gc.collect()
    torch.cuda.empty_cache()
    sharded = sharded_phase(c, args, card, dev, rtf_main, spikes_per_step,
                            budget_main)

    # -- 9c. sharded checkpoints, the sharded server, the core's shims -------
    gc.collect()
    torch.cuda.empty_cache()
    sessions9c = sharded_sessions_phase(c, args, card, dev)

    # -- 10. the dense strategy -----------------------------------------------
    del c
    gc.collect()
    torch.cuda.empty_cache()
    say("freed", allocated_bytes=torch.cuda.memory_allocated(),
        reserved_bytes=torch.cuda.memory_reserved())

    # (b) the split path (K5) against the reference path (GEMM) at 0.02
    small_d = MicrocircuitConfig(scale=0.02, strategy="dense", t_presim=0.0,
                                 seed=args.seed)
    runs = {}
    for mode in ("reference", "split"):
        s = Simulator(small_d, kernels=mode, probes=("spikes", "pop_counts"),
                      device=dev)
        s.warmup(100.0)
        _build.reset_launches()
        r = s.run(100.0)
        k5_n = _build.launches["gated_spike_matvec"]
        want_k5 = r.n_steps if mode == "split" else 0
        if k5_n != want_k5 or r.overflow != 0:
            fail(f"dense {mode} path at 0.02: K5 launched {k5_n} times for "
                 f"{r.n_steps} steps, overflow {r.overflow}")
        runs[mode] = (r["spikes"], r["pop_counts"],
                      s.sim_config.kernels.describe())
        del s
    (sp_ref, pc_ref, pol_ref), (sp_k5, pc_k5, pol_k5) = (runs["reference"],
                                                        runs["split"])
    raster_equal = np.array_equal(sp_k5, sp_ref)
    counts_equal = float((pc_k5 == pc_ref).mean())
    sums_ok = bool(np.all(np.abs(pc_k5.sum(0) - pc_ref.sum(0))
                          <= 3.0 + 0.02 * np.abs(pc_ref.sum(0))))
    if not (raster_equal or (counts_equal > 0.99 and sums_ok)):
        fail(f"dense split path (K5) departs from the GEMM path at 0.02: "
             f"{counts_equal:.4f} of the population counts equal, sums "
             f"within 2 %: {sums_ok}")
    say("dense_vs_reference", scale=0.02, steps=sp_k5.shape[0],
        split=pol_k5, reference=pol_ref, spikes=int(sp_k5.sum()),
        held="raster_equal" if raster_equal else "jax_dense_bar",
        raster_equal=raster_equal, pop_counts_equal_share=counts_equal,
        sums_within_2pct=sums_ok)
    del runs

    # (c) the dense path at --scale-dense: the table is built on the card
    CONN.DENSE_MAX_BYTES = int(
        0.6 * torch.cuda.get_device_properties(dev).total_memory)
    t0 = time.perf_counter()
    c_d = build_connectome(scale=args.scale_dense, seed=args.seed)
    conn_d_s = time.perf_counter() - t0
    cfg_d = MicrocircuitConfig(scale=args.scale_dense, strategy="dense",
                               seed=args.seed)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sim = Simulator(cfg_d, connectome=c_d, device=dev)
    torch.cuda.synchronize()
    build_d_s = time.perf_counter() - t0
    pol = sim.sim_config.kernels
    W = sim.backend.net.tables.W
    if not (pol.step == "split" and pol.kernels and pol.deliver == "kernel"
            and W is not None):
        fail(f"auto policy of the dense path resolved to {pol.describe()}, "
             f"not split with K5 on the bin-major table")
    Nd, Dd = c_d.n_total, c_d.d_max_bins
    sim.warmup(args.t_sim_dense)
    sim.warmup(20.0, include_presim=False)
    _build.reset_launches()
    res_d = sim.run(args.t_sim_dense)
    dense_launches = dict(_build.launches)
    steps_d = sim._steps(sim.t_presim) + res_d.n_steps
    rates_d = res_d.summary()["rates_hz"]
    ms_step_d = res_d.wall_s / res_d.n_steps * 1e3
    budget_d = sim.sim_config.spike_budget
    say("dense_path", policy=pol.describe(), scale=args.scale_dense, n=Nd,
        d_bins=Dd, synapses=c_d.n_synapses, table_shape=list(W.shape),
        table_bytes=W.numel() * W.element_size(),
        connectome_build_s=f"{conn_d_s:.1f}",
        table_build_s=f"{build_d_s:.3f}", presim_ms=sim.t_presim,
        run_ms=args.t_sim_dense, steps=res_d.n_steps, wall_s=res_d.wall_s,
        rtf=res_d.rtf, ms_per_step=ms_step_d, overflow=res_d.overflow,
        spike_budget=budget_d,
        spikes_per_step=float(res_d["pop_counts"].sum()) / res_d.n_steps,
        peak_allocated_bytes=torch.cuda.max_memory_allocated())
    say("rates_hz_dense", **{p: f"{r:.3f}" for p, r in zip(POPS, rates_d)})
    say("launches", path="dense", **dense_launches,
        steps_incl_presim=steps_d)
    if res_d.overflow != 0:
        fail(f"overflow {res_d.overflow} on the dense path")
    if dense_launches["lif_update"] != steps_d \
            or dense_launches["gated_spike_matvec"] != steps_d:
        fail(f"dense path launched {dense_launches} for {steps_d} steps")
    check_rates(rates_d, "dense path")
    say("dense_path_profile", **profile_window(sim, 20.0, ms_step_d))
    spikes_d = max(1, round(float(res_d["pop_counts"].sum())
                            / res_d.n_steps))

    # (a) K5 on the session's table against its plain version, bitwise
    ring_d = lambda: ring0(Dd, Nd)
    spiked_d = lambda k: spiked_with(k, Nd)
    over = budget_d + 172
    W_bf = W.to(torch.bfloat16)
    for table, counts in ((W, (0, 1, 5, 64, over)), (W_bf, (5, over))):
        for k in counts:
            spk, r0 = spiked_d(k), ring_d()
            got = K5.dense_deliver(r0.clone(), table, spk, t_dev, c_d.n_exc)
            want = K5.dense_deliver_plain(r0.clone(), table, spk, t_dev,
                                          c_d.n_exc)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            max_err["gated_spike_matvec"] = max(
                max_err["gated_spike_matvec"], err)
            if not bitwise(got, want):
                fail(f"K5 ring differs from the plain version at {k} spikes "
                     f"({table.dtype}): max |diff| {err}")
            say("K5", spikes=k, budget=budget_d, table=str(table.dtype),
                bitwise=True, max_abs_err=err,
                cells_changed=int((got != r0).sum()))
    del W_bf, got, want
    s_k = spiked_d(spikes_d).float()
    if not bitwise(K5.gated_spike_matvec(s_k, W),
                   K5.gated_spike_matvec_plain(s_k, W)):
        fail("K5's gated_spike_matvec differs from its plain version")
    say("K5_matvec", spikes=spikes_d, shape=list(W.shape), bitwise=True)

    # (d) K5's times at the dense path's mean spike count.  The library
    # call streams the whole table: one cuBLAS kernel of about 17 ms on an
    # H100, timed with CUDA events over 4 calls (its launch time is
    # negligible beside it, and the profiler, after this script's earlier
    # windows, recorded only 2 of its 4 kernels in one run)
    spks_d = [spiked_d(spikes_d) for _ in range(64)]
    ring = ring_d()
    k5d = timed(lambda i: K5.dense_deliver(ring, W, spks_d[i], t_dev,
                                           c_d.n_exc))
    k5d_plain = timed(lambda i: K5.dense_deliver_plain(
        ring, W, spks_d[i], t_dev, c_d.n_exc))
    s_lib = [x.float() for x in spks_d[:4]]
    lib_ms = call_ms(lambda i: torch.matmul(s_lib[i % 4], W), iters=4,
                     warm=1)
    k5d_lib = {"ms": lib_ms, "call_ms": lib_ms, "timing": "events"}
    # the spiking rows, the ring's read and write, the spike vector, ids
    k5d_bytes = (spikes_d * Dd * Nd * 4 + 2 * Dd * 2 * Nd * 4 + Nd
                 + 4 * spikes_d + 4)
    say("timing_dense", spikes=spikes_d, K5=json.dumps(k5d),
        K5_plain=json.dumps(k5d_plain),
        library_batched_matmul_tf32_off=json.dumps(k5d_lib))
    del ring, spks_d, s_lib
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    dense_sharded_launches = dense_sharded_line(W, c_d, args, card, dev)
    analysis_s["dense_sharded"] = time.perf_counter() - t0
    del W

    # (e) the graphed dense loop against the eager one, from one state.
    # Two 43.8 GB tables do not fit the card at once, so the graphed
    # session runs first, its results go to the host, and the eager
    # session is built once the graphed one is freed.  K1 and K5 add in a
    # fixed order: every tensor is held bitwise.
    start, gen0 = clone_state(sim.state), sim._generator.get_state()
    n_hold = 300
    sim.warmup(n_hold * 0.1, probes=("pop_counts", "spikes"),
               include_presim=False)
    res_g = sim.run(n_hold * 0.1, probes=("pop_counts", "spikes"))
    graphed = {k: v.cpu() for k, v in state_tensors(sim.state).items()}
    gen_g = sim._generator.get_state()
    del sim
    gc.collect()
    torch.cuda.empty_cache()
    eager = Simulator(cfg_d, connectome=c_d, device=dev,
                      backend="instrumented")
    eager.state = start
    eager._generator.set_state(gen0)
    res_e = eager.run(n_hold * 0.1, presim_ms=0,
                      probes=("pop_counts", "spikes"))
    for name in res_g.data:
        if not np.array_equal(res_g[name], res_e[name]):
            fail(f"graph_dense: the graphed loop's {name} differs from the "
                 f"eager loop's")
    if not torch.equal(gen_g, eager._generator.get_state()):
        fail("graph_dense: the generators' states differ after the run")
    for name, x in state_tensors(eager.state).items():
        if not bitwise(x.cpu(), graphed[name]):
            fail(f"graph_dense: {name} differs from the eager loop's")
    eager_res = eager.run(30.0)
    say("graph_dense", scale=args.scale_dense, steps=res_g.n_steps,
        spikes=int(res_g["spikes"].sum()),
        exact=json.dumps(sorted(graphed) + sorted(res_g.data)
                         + ["generator"]),
        graphed_ms_per_step=res_g.wall_s / res_g.n_steps * 1e3,
        eager_ms_per_step=res_e.wall_s / res_e.n_steps * 1e3)
    say("dense_path_eager", backend="instrumented",
        policy=eager.sim_config.kernels.describe(), steps=eager_res.n_steps,
        rtf=eager_res.rtf,
        ms_per_step=eager_res.wall_s / eager_res.n_steps * 1e3,
        timers_s=json.dumps(eager_res.timers), graphed_ms_per_step=ms_step_d,
        card=json.dumps(card))
    del eager, start, graphed
    gc.collect()
    torch.cuda.empty_cache()

    # -- 11. K6 and the LM layers at Qwen3-32B widths -------------------------
    att = attention_phase(args.seed)
    max_err["flash_attention"] = att["max_err"]

    # -- 12. the session server -----------------------------------------------
    serve_runs = serve_phase(args, card, dev)

    # -- 13. [analysis]: the dry run; the phase's other lines ran above ------
    t0 = time.perf_counter()
    dryrun_line(sharded["one_layout"], card)
    analysis_s["dryrun"] = time.perf_counter() - t0
    say("analysis", seconds=sum(analysis_s.values()),
        by_part=json.dumps(analysis_s), card=json.dumps(card))

    k2l = sharded["k2_local"]

    def row(name, source, replaces, t, plain, n_bytes, n_ops, lib, err,
            ops_per_s=FP32_OPS_PER_S):
        b_ms, b_by = bound(n_bytes, n_ops, ops_per_s)
        by_path = {"fused": fused_launches[name],
                   "split": split_launches[name],
                   "plastic": plastic_launches[name],
                   "dense": dense_launches[name],
                   "dense_sharded": dense_sharded_launches[name],
                   "attention": att["launches"][name],
                   "serve": sum(counts[name]
                                for counts in serve_runs.values()),
                   **{path: counts[name]
                      for path, counts in api_runs.items()},
                   **{path: counts[name] for path, counts
                      in sharded["launches"].items()},
                   **{path: counts[name] for path, counts
                      in sessions9c.items()}}
        return {"name": name, "route": "cuda",
                "source": f"src/repro_torch/csrc/{source}",
                "replaces": replaces,
                "launches": sum(by_path.values()),
                "launches_by_path": by_path,
                "max_abs_err": err, "ms": t["ms"], "plain_ms": plain["ms"],
                "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": None if lib is None else lib["ms"],
                "call_ms": t["call_ms"], "plain_call_ms": plain["call_ms"],
                "timing": t["timing"]} | (
                    {"graph_ms": t["graph_ms"]} if "graph_ms" in t else {})

    kernels = [
        row("lif_update", "lif_update.cu",
            "src/repro/kernels/lif_update.py:58", k1, k1_plain, k1_bytes,
            LIF_OPS * N, None, max_err["lif_update"]),
        row("ell_deliver", "lif_deliver.cu",
            "src/repro/kernels/ell_deliver.py:75", k2, k2_plain,
            k2_bytes(N, budget_main, n_entries),
            ENTRY_OPS * n_entries, k2_lib, max_err["ell_deliver"]),
        row("ell_deliver_local", "lif_deliver.cu",
            "src/repro/kernels/ell_deliver.py:75", k2l["t"], k2l["plain"],
            k2l["n_bytes"], k2l["n_ops"], k2l["lib"], k2l["err"])
        | {"form": f"local ring: rank {SHARD_RANK} of {SHARD_WORLD}'s "
                   f"block of the full-scale tables"},
        row("lif_deliver", "lif_deliver.cu",
            "src/repro/kernels/lif_deliver.py:199", k3, k3_plain,
            k3_bytes, LIF_OPS * N + ENTRY_OPS * n_entries, None,
            max_err["lif_deliver"]),
        row("lif_deliver_plastic", "lif_deliver.cu",
            "src/repro/kernels/lif_deliver.py:268", k4, k4_plain,
            k4_bytes, k4_ops, None, max_err["lif_deliver_plastic"]),
        row("stdp_update", "stdp_update.cu",
            "src/repro/core/plasticity.py:206 (XLA, no Pallas kernel)", k5,
            k5_plain, k5_bytes, 2 * cnt["in_plastic"], None,
            max_err["stdp_update"])
        | {"ms_full_step": k5_full["ms"],
           "graph_ms_full_step": k5_full["graph_ms"],
           "ms_whole_table_clip": k5_clip["ms"]},
        row("gated_spike_matvec", "spike_deliver.cu",
            "src/repro/kernels/spike_deliver.py:51", k5d, k5d_plain,
            k5d_bytes, spikes_d * Dd * Nd, k5d_lib,
            max_err["gated_spike_matvec"]),
        row("flash_attention", "flash_attention_sm90.cu",
            "src/repro/kernels/flash_attention.py:70", att["k6"],
            att["k6_plain"], att["k6_bytes"], att["k6_ops"], att["k6_lib"],
            max_err["flash_attention"], ops_per_s=BF16_TC_OPS_PER_S)
        | {"ms_f32": att["k6_f32"]["ms"],
           "source_f32": "src/repro_torch/csrc/flash_attention.cu",
           "ms_32k": att["ms_32k"], "max_err_over_bar": att["max_over_bar"]},
        row("pop_counts", "pop_counts.cu",
            "src/repro/api/probes.py:59 (XLA segment_sum, no Pallas kernel)",
            pc, pc_plain, pc_bytes, N, None, max_err["pop_counts"]),
    ]
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
