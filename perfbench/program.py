"""What the port records of itself in a ``--trace 1`` run: its spans and
counters (``repro_torch.perf.trace``), for the per-layer readers of
``perfbench/metrics/`` that read them.

The run's own session is gone when the readers run (``bench.run_cell``
frees it for the check), and it was built before any recording was open.
So :func:`of` builds a second session like it, by the run's own network
module on its drawn connectome, configuration, mix, generator seed and
device (``run_cell``'s, found by the record it made), and takes:

1. the build's spans, under ``trace.recording()``: ``build_s``, the
   seconds of each ``session.build*`` span;
2. after the graphs' capture, the presim and one warm unit, ``units`` units
   of the mix (its ``profile.units``, and more until ``PASS_SECONDS`` have
   passed) under ``trace.recording()`` and no profiler, so that the
   host's times are not the profiler's, each followed by one unit with
   nothing recording: ``per_unit_s``, each span's seconds a recorded
   unit; ``counts_per_unit``, each counter's change a unit;
   ``unit_walls_s`` and ``unit_walls_off_s``, the walls of the units
   recorded and not (what the spans cost when on); and
   ``off_over_window``, the median unrecorded unit's wall over the
   window's median unit wall, as this pass runs after the window, the
   profiler and the check, at the speed the machine has then;
3. ``Simulator.step_census(CENSUS_STEPS)`` under ``torch.profiler``:
   ``census``, the device µs a step of the kernels launched under each
   innermost step span (:func:`census_us`), and beside it
   ``graphed_us_per_step``, the traced graphed pass's device µs a step.

The readers share the result through ``record["program"]``.  Where the
port has no ``repro_torch.perf.trace`` or no ``Simulator.step_census`` (a
checkout older than them), :func:`of` builds nothing and gives None, and
so do the readers; so it does on the CPU for a record no ``run_cell``
made.  On the card, a record whose ``run_cell`` locals are not found
raises.  The frame lookup and the second build stand in for passes that
``bench.run_cell`` does not make yet: once it records its own build and
runs these passes into ``record["program"]``, they go.
"""
from __future__ import annotations

import bisect
import contextlib
import gc
import importlib.util
import json
import statistics
import sys
import time
from collections import defaultdict
from typing import Optional

import torch

#: steady steps of the census
CENSUS_STEPS = 200
#: the spans a census kernel is put under: the innermost of these that
#: encloses the host op which launched it
STEP_SPANS = frozenset({"step", "step.drive", "step.deliver", "step.stdp",
                        "step.probe", "step.update"})
#: the least seconds of pass 3: a closed loop's speed wanders by a tenth
#: from one half second to the next, so a shorter pass reads whichever
#: speed holds then
PASS_SECONDS = 5.0
#: what ``measure`` takes from the run that made the record
RUN_LOCALS = ("network", "c", "config", "traffic", "seeds", "dev")


def of(record: dict) -> Optional[dict]:
    """The program's own numbers for the run of ``record`` (measured once
    and kept in ``record["program"]``), or None."""
    if "program" not in record:
        record["program"] = _measure(record)
    return record["program"]


def _run_locals(record: dict) -> Optional[dict]:
    """The locals of the ``run_cell`` call that made ``record``."""
    f = sys._getframe(1)
    while f is not None:
        loc = f.f_locals
        if f.f_code.co_name == "run_cell" and loc.get("record") is record:
            return loc if all(k in loc for k in RUN_LOCALS) else None
        f = f.f_back
    return None


def _measure(record: dict) -> Optional[dict]:
    if importlib.util.find_spec("repro_torch.perf.trace") is None:
        return None
    from repro_torch.api import Simulator
    if not hasattr(Simulator, "step_census"):
        return None
    run = _run_locals(record)
    if run is None:
        if torch.cuda.is_available():
            raise RuntimeError(
                "perfbench.program: no run_cell call holds this record "
                f"with its locals {RUN_LOCALS}; the program metrics "
                "cannot be measured")
        return None
    out = measure(run["network"], run["c"], run["config"], run["traffic"],
                  run["seeds"]["key"], run["dev"])
    p = record.get("profile")
    if p and p["steps"]:        # the graphed pass's, beside the census's
        out["graphed_us_per_step"] = sum(
            k["us"] for k in p["kernels"].values()) / p["steps"]
    # how fast this session's units ran against the window's
    window = record["window"]["unit_walls_s"]
    if window and out["unit_walls_off_s"]:
        out["off_over_window"] = (statistics.median(out["unit_walls_off_s"])
                                  / statistics.median(window))
    print(f"perfbench: program {json.dumps(out)}", file=sys.stderr,
          flush=True)
    return out


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def span_seconds(spans) -> dict:
    """Seconds by span name over ``spans`` (``trace.Span``)."""
    out: dict = defaultdict(float)
    for s in spans:
        out[s.name] += s.seconds
    return dict(out)


def measure(network, c, config: dict, traffic: dict, key: int, dev
            ) -> dict:
    """The build's spans, a pass of the mix under recording and the step
    census, of a session built like the run's (the module's docstring) by
    ``network``, the run's network module."""
    from perfbench import bench
    from repro_torch.perf import trace
    trace.take()                       # what the traced passes left
    with trace.recording():
        sim = network.simulator(config, traffic, c, key, dev)
        _sync(dev)
    build = span_seconds(trace.take())
    pattern = bench.Pattern.of(traffic, sim, network)
    sim.warmup(pattern.unit_ms, include_presim=True)
    sim.run(config["t_presim_ms"], presim_ms=0, probes=())
    pattern.after_presim()
    pattern.warm()
    _sync(dev)
    trace.take()
    least, units = int(traffic["profile"]["units"]), 0
    before, walls, walls_off = trace.counters(), [], []
    t_pass = time.perf_counter()
    while units < least or time.perf_counter() - t_pass < PASS_SECONDS:
        for rec, into in ((trace.recording(), walls),
                          (contextlib.nullcontext(), walls_off)):
            with rec:
                t0 = time.perf_counter()
                pattern.unit()
                into.append(time.perf_counter() - t0)
        units += 1
    spans = trace.take()
    after = trace.counters()
    census = step_census(sim, dev, CENSUS_STEPS)
    del sim, pattern
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return {"build_s": build, "units": units,
            "per_unit_s": {k: v / units
                           for k, v in span_seconds(spans).items()},
            "counts_per_unit": {k: (v - before.get(k, 0)) / (2 * units)
                                for k, v in after.items()
                                if v != before.get(k, 0)},
            "unit_walls_s": walls, "unit_walls_off_s": walls_off,
            "census": census}


def step_census(sim, dev, n_steps: int) -> dict:
    """``sim.step_census(n_steps)`` under ``torch.profiler`` (the card's
    kernels with the host's ops and spans), reduced by :func:`census_us`."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    with profile(activities=acts) as prof:
        sim.step_census(n_steps)
    return census_us(prof.events(), n_steps)


def census_us(events, n_steps: int) -> dict:
    """Each device kernel (and memory copy) of a profile put under the
    innermost step span open on the host when it was launched: the
    profiler gives a device operation and the runtime call that launched
    it one correlation id, and the step spans are host ranges (a
    hand-written kernel's launch, a ``ctypes`` call, has no op of its own
    to link it to).  Returns ``us_per_step`` by span, their sum
    ``total_us``, and ``outside_us``, the device µs launched under no step
    span (the census's copy of the state), in all."""
    cpu = torch.autograd.DeviceType.CPU
    spans, launched = [], {}
    for e in events:
        if e.device_type != cpu:
            continue
        if e.name in STEP_SPANS:
            spans.append((e.time_range.start, e.time_range.end, e.name))
        elif e.name.startswith("cu"):          # cudaLaunchKernel, ...
            launched[e.id] = e.time_range.start
    spans.sort()
    starts = [a for a, _, _ in spans]
    us: dict = defaultdict(float)
    for e in events:
        # a span's own range on the device's timeline is no operation
        if e.device_type == cpu or e.name in STEP_SPANS \
                or e.id not in launched:
            continue
        at = launched[e.id]
        i = bisect.bisect_right(starts, at) - 1
        while i >= 0 and spans[i][1] < at:    # closed before the launch
            i -= 1
        us[spans[i][2] if i >= 0 else None] += \
            e.time_range.end - e.time_range.start
    per = {name: v / n_steps for name, v in us.items() if name is not None}
    return {"steps": n_steps, "us_per_step": per,
            "total_us": sum(per.values()), "outside_us": us.get(None, 0.0)}
