"""One run of one benchmark cell: set-up, the measured window, the check.

A cell of ``BENCHMARK.json`` names a configuration and a traffic mix; the
harness reads them from ``perfbench/configs/<config>.json`` and
``perfbench/traffic/<traffic>.json``, the network the configuration names
from ``perfbench/networks/<network>.py`` (its draw, session, followed
state and reference: ``perfbench/networks/pd14.py`` says what a network
module provides), the check's limits from
``perfbench/limits/<workload>.json``, and each metric from its reader,
``perfbench/metrics/<metric>.py``.  So a cell, a configuration, a network,
a mix or a metric is added as files, with no code edited.

The run (``run_cell``):

1. set-up: the network drawn on the device from the seed (the network
   module's ``draw``), the port's ``Simulator`` built on its connectome
   (``session.build_s``), the graphs of the mix's run length and of the
   presim captured (``loop.capture_s``), the presim, one warm unit of the
   mix; the program's initial state and tables checked against the seed
   and the draw;
2. the window: the mix's pattern for ``seconds`` of wall time (``free``:
   runs back to back, each run's counts on the host; ``loop``: chunks,
   each asked for once the last one's counts are on the host); a seeded
   sample of the segments' start states is kept;
3. with ``trace``, a steady sub-window under ``torch.profiler``;
4. the check, once the program is freed: the plain reference follows each
   sampled start state and its population counts are compared with the
   program's (``perfbench/check.py``).

The result is the run's last line of output (``run.py`` prints it).
Nothing here imports JAX.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import random
import re
import sys
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from perfbench import check as check_mod
from perfbench import trace as trace_mod

HERE = Path(__file__).resolve().parent
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")


class RunError(RuntimeError):
    """A run that cannot give a result (exit code 2, nothing printed)."""


# -- the cell's files ---------------------------------------------------------

def forbidden_modules() -> list:
    """The loaded modules whose top-level name is JAX's, Flax's or the
    JAX package's (``repro``; ``repro_torch`` is the port)."""
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in FORBIDDEN_MODULES)


def manifest(root: Path) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell_files(root: Path, workload: str) -> dict:
    """The cell ``workload`` of ``root``'s manifest with its configuration,
    traffic mix, limits and metric entries."""
    m = manifest(root)
    cells = {c["name"]: c for c in m["workloads"]}
    if workload not in cells:
        raise RunError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    cell = cells[workload]
    configs = {c["name"]: c for c in m["configs"]}
    base = root / "perfbench"
    config = json.loads((root / configs[cell["config"]]["file"]).read_text())
    traffic = json.loads((base / "traffic" / f"{cell['traffic']}.json")
                         .read_text())
    limits_path = base / "limits" / f"{workload}.json"
    limits = json.loads(limits_path.read_text()) if limits_path.exists() \
        else {}

    def mine(metric):
        return workload in metric.get("workloads", [workload])
    return {"cell": cell, "config": config, "traffic": traffic,
            "limits": limits,
            "end_to_end": [x for x in m["end_to_end"] if mine(x)],
            "per_layer": [x for x in m["per_layer"] if mine(x)]}


def _load(path: Path, module: str):
    spec = importlib.util.spec_from_file_location(module, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(name: str, root: Path = HERE.parent):
    """The ``read(record)`` function of metric ``name`` of ``root``."""
    path = root / "perfbench" / "metrics" / f"{name}.py"
    return _load(path, f"perfbench_metric_{name.replace('.', '_')}").read


def load_network(config: dict, root: Path = HERE.parent):
    """The module of the network that ``config`` names,
    ``perfbench/networks/<network>.py`` of ``root``."""
    name = config.get("network")
    if not isinstance(name, str) or not NAME.fullmatch(name):
        raise RunError(f"configuration {config.get('name')!r} names no "
                       f"network (its \"network\" is {name!r})")
    path = root / "perfbench" / "networks" / f"{name}.py"
    if not path.is_file():
        raise RunError(f"no network module perfbench/networks/{name}.py "
                       f"for configuration {config.get('name')!r}")
    return _load(path, f"perfbench_network_{name.replace('.', '_')}")


# -- set-up -------------------------------------------------------------------

def _seeds(seed: int) -> dict:
    """The streams one ``--seed`` drives: the network's draw, the
    session's generator and the check's sample."""
    rng = random.Random(int(seed))
    return {name: rng.getrandbits(62) for name in ("net", "key", "sample")}


def _state_tensors(network, state) -> dict:
    """The leaves of a session's state the reference follows, cloned, and
    its generator's state."""
    out = {k: v.clone() for k, v in check_mod.leaves(network, state).items()}
    out["generator_state"] = check_mod.sim_state(state).generator.get_state()
    return out


def _copy_state(network, dst, src: dict) -> None:
    """Copy a kept state back into the session's own tensors (in place;
    the generator goes on)."""
    for key, tensor in check_mod.leaves(network, dst).items():
        tensor.copy_(src[key])


class Reservoir:
    """A uniform sample of ``k`` items of a stream of unknown length, drawn
    from ``seed`` (each item decided when it starts)."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng, self.seen = k, random.Random(seed), 0

    def offer(self) -> Optional[int]:
        """The slot the next item takes, or None when it is not kept."""
        i = self.seen
        self.seen += 1
        if i < self.k:
            return i
        j = self.rng.randrange(i + 1)
        return j if j < self.k else None


# -- the run ------------------------------------------------------------------

def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             root: Path, device=None, overrides: Optional[dict] = None,
             t_process: Optional[float] = None, fault=None) -> dict:
    """Run ``workload`` once; returns the result line's object.

    ``device`` None is the card (the CLI's case).  ``overrides`` replaces
    keys of the configuration and the traffic mix (``{"config": {...},
    "traffic": {...}}``, for the CPU tests' small sizes); ``fault(sim)``,
    when given, breaks the program once its start has been checked and
    before its graphs are captured (``perfbench/faults.py``)."""
    t_start = time.perf_counter() if t_process is None else t_process
    files = cell_files(root, workload)
    config, traffic = dict(files["config"]), dict(files["traffic"])
    if overrides:
        config.update(overrides.get("config", {}))
        traffic.update(overrides.get("traffic", {}))
    network = load_network(config, root)
    dev = torch.device("cuda" if device is None else device)
    on_card = dev.type == "cuda"
    seeds = _seeds(seed)
    spans = {}
    _say("imports done", t_start)

    # 1. set-up
    net = network.draw(config, seeds["net"], dev)
    sums = check_mod.table_sums(net.targets, net.weights, net.dbins)
    keys = None
    if config.get("plasticity"):
        pop_of = torch.repeat_interleave(
            torch.arange(len(net.pop_sizes), device=dev),
            torch.as_tensor(net.pop_sizes, device=dev))
        keys = check_mod.projection_keys(net.targets, pop_of,
                                         len(net.pop_sizes))
        del pop_of
    degrees = net.stats
    _say(f"drawn {net.n_total} neurons, {int(net.k_per_proj.sum())} "
         f"synapses, K {net.targets.shape[1]}", t_start)
    c = network.connectome(net)
    del net
    _say("connectome on the host", t_start)
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    sim = network.simulator(config, traffic, c, seeds["key"], dev)
    _sync(dev)
    spans["session.build_s"] = time.perf_counter() - t0
    _say(f"session built in {spans['session.build_s']:.3f} s", t_start)
    start = check_mod.start_check(network, sim, sums, c, seeds["key"])
    if fault is not None:
        fault(sim)
    pattern = Pattern.of(traffic, sim, network, keys)
    t0 = time.perf_counter()
    sim.warmup(pattern.unit_ms, include_presim=True)
    spans["loop.capture_s"] = time.perf_counter() - t0
    sim.run(config["t_presim_ms"], presim_ms=0, probes=())
    pattern.after_presim()
    _say(f"captured in {spans['loop.capture_s']:.3f} s, presim run",
         t_start)
    pattern.warm()
    _sync(dev)
    # 2. the window
    t_window = time.perf_counter()
    setup_s = t_window - t_start
    sample = Reservoir(int(traffic["check"]["segments"]), seeds["sample"])
    pattern.window(seconds, sample)
    memory_peak = int(torch.cuda.max_memory_allocated(dev)) if on_card \
        else 0
    w = pattern.stats()
    spikes = sum(w["counts_per_step"])
    walls = np.quantile(w["unit_walls_s"], [0.0, 0.5, 1.0])
    _say(f"window: {w['attempted']} units in {w['window_s']:.3f} s, "
         f"{spikes:.3f} spikes a step, unit walls min/median/max "
         f"{walls[0]:.5f}/{walls[1]:.5f}/{walls[2]:.5f} s", t_window)
    # 3. the traced sub-window
    profile = None
    if trace:
        profile = trace_mod.profile(pattern, dev, on_card)
    record = {"setup_s": setup_s, "spans": spans, "window": w,
              "profile": profile, "memory_peak_bytes": memory_peak,
              "net": {**degrees, "budget": int(sim.sim_config.spike_budget),
                      "plastic": sim.plasticity is not None}}
    # 4. the check, once the program is freed
    segments = pattern.segments()
    del sim, pattern, keys
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    numbers = check_mod.check(network, c, config, traffic, segments, start,
                              dev)
    _say(f"checked {numbers['segments']} segments", t0)
    metrics = files["per_layer"] if trace else files["end_to_end"]
    values = {}
    for m in metrics:
        v = reader(m["name"], root)(record)
        if v is not None:
            values[m["name"]] = {"value": float(v), "unit": m["unit"]}
    correct, compared = check_mod.judge(numbers, files["limits"])
    failed = record["window"]["failed"]
    out = {"correct": bool(correct and failed == 0),
           "attempted": record["window"]["attempted"], "failed": failed,
           "metrics": values,
           "device": _device(dev, memory_peak, profile)}
    if trace and profile is not None:
        out["breakdown"] = profile["breakdown"]
    out["unit_walls_s"] = dict(zip(("min", "median", "max"),
                                   map(float, walls)))
    out["checks"] = compared
    return out


def _device(dev, memory_peak: int, profile) -> dict:
    on_card = dev.type == "cuda"
    d = {"platform": "gpu" if on_card else "cpu",
         "kind": torch.cuda.get_device_name(dev) if on_card else "cpu",
         "count": 1, "memory_peak_bytes": memory_peak}
    if profile is not None:
        d["busy_s"] = profile["busy_s"]
        d["window_s"] = profile["window_s"]
    return d


def _say(what: str, since: float) -> None:
    """A progress line on standard error, with the seconds since
    ``since``."""
    print(f"perfbench: {time.perf_counter() - since:9.3f} s  {what}",
          file=sys.stderr, flush=True)


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


# -- the traffic patterns -----------------------------------------------------

class Pattern:
    """How a mix drives the session: a unit (a run or a chunk) repeated
    over the window."""

    def __init__(self, traffic: dict, sim, network, keys=None):
        self.traffic, self.sim, self.keys = traffic, sim, keys
        self.network = network
        self.n_pops = len(sim.connectome.pop_sizes)
        self.weight_runs = int(traffic["check"].get("weight_runs", 0)) \
            if keys is not None else 0
        self.kept: dict = {}          # slot -> (item, start, weights_sq)
        self.counts: list = []        # per unit, [steps, n_pops] on the host
        self.walls: list = []         # per unit, host seconds
        self.failed = 0
        self.window_s = 0.0
        self.saved = None             # the state each unit starts from
        self.dt = sim.sim_config.dt

    @staticmethod
    def of(traffic: dict, sim, network, keys=None) -> "Pattern":
        """The mix's pattern of the session ``sim`` of ``network`` (its
        module); ``keys`` (``check.projection_keys`` of the drawn network)
        weigh the plastic weights' change in the sample's first
        ``weight_runs`` slots."""
        kind = traffic["pattern"]
        return {"free": FreeRuns, "loop": ClosedLoop}[kind](
            traffic, sim, network, keys)

    def after_presim(self) -> None:
        """The state the runs go back to, when the mix restores one."""
        self.saved = _state_tensors(self.network, self.sim.state) \
            if self.traffic.get("restore") == "after_presim" else None

    def unit(self):
        """One unit: the session's ``RunResult`` (counts on the host)."""
        if self.saved is not None:
            _copy_state(self.network, self.sim.state, self.saved)
        return self.sim.run(self.unit_ms, presim_ms=0)

    def warm(self) -> None:
        """One unit in set-up: every shape of the window used once."""
        res = self.unit()
        self.overflow = res.overflow

    def _one(self, keep_slot, item) -> None:
        if keep_slot is not None:
            start = self._start()
            self.kept[keep_slot] = (item, start, None)
        t0 = time.perf_counter()
        res = self.unit()
        self.walls.append(time.perf_counter() - t0)
        if keep_slot is not None and keep_slot < self.weight_runs:
            # the run's change of the live table, before the next restore
            w_sq = check_mod.change_sq(self.sim.state[1].weights,
                                       start["weights"], self.keys,
                                       self.n_pops)
            self.kept[keep_slot] = (item, start, w_sq.cpu().numpy())
        if res.overflow > self.overflow:
            self.failed += 1
            self.overflow = res.overflow
        self.counts.append(np.asarray(res.data["pop_counts"]))

    def _start(self) -> dict:
        if self.saved is not None:
            return {**self.saved, "generator_state":
                    check_mod.sim_state(self.sim.state).generator.get_state()}
        return _state_tensors(self.network, self.sim.state)

    def window(self, seconds: float, sample: Reservoir) -> None:
        """Units back to back until ``seconds`` have passed; a segment
        starts at every ``block``-th unit, and the sample keeps some."""
        t0 = time.perf_counter()
        i = 0
        while True:
            self._one(sample.offer() if i % self.block == 0 else None, i)
            i += 1
            if time.perf_counter() - t0 >= seconds:
                break
        self.window_s = time.perf_counter() - t0

    def segments(self) -> list:
        """The kept segments that the window finished: each start state
        and the program's counts of the check's first steps from it."""
        steps = int(self.traffic["check"]["steps"])
        out = []
        for item, start, w_sq in sorted(self.kept.values(),
                                        key=lambda x: x[0]):
            if item + self.block > len(self.counts):
                continue                  # the window closed inside it
            out.append({"item": item, "start": start, "weights_sq": w_sq,
                        "counts": np.concatenate(
                            self.counts[item:item + self.block])[:steps]})
        return out

    def stats(self) -> dict:
        """What the window did: its units, their walls and the spikes a
        step of each population."""
        steps = sum(len(x) for x in self.counts)
        total = np.sum([x.sum(axis=0) for x in self.counts], axis=0) \
            if self.counts else np.zeros(self.n_pops)
        return {"attempted": len(self.walls),
                "failed": self.failed, "window_s": self.window_s,
                "model_s": steps * self.dt * 1e-3,
                "unit_walls_s": list(self.walls), "steps": steps,
                "counts_per_step": (total / max(1, steps)).tolist()}


class FreeRuns(Pattern):
    """Runs of ``run_ms`` back to back; a segment is a run's first
    steps."""

    def __init__(self, traffic, sim, network, keys=None):
        super().__init__(traffic, sim, network, keys)
        self.unit_ms = float(traffic["run_ms"])
        self.block = 1


class ClosedLoop(Pattern):
    """Chunks of ``chunk_ms``, each asked for once the last one's counts
    are on the host; a segment is a block of consecutive chunks."""

    def __init__(self, traffic, sim, network, keys=None):
        super().__init__(traffic, sim, network, keys)
        self.unit_ms = float(traffic["chunk_ms"])
        self.weight_runs = 0     # the reference follows whole runs only
        per_chunk = int(round(self.unit_ms / self.dt))
        self.block = max(1, int(traffic["check"]["steps"]) // per_chunk)
