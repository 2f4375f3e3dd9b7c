"""Graph contracts: what the step that ``Simulator.run`` captures is made
of.  The counterpart of ``repro.analysis.hlo_contract``.

The static linter (``repro_torch.analysis.lint``) guards the source; this
module guards the step itself, through the op census of
:mod:`repro_torch.perf.step_analysis`:

GC001  (HLO001) the step's op sequence does not depend on the data.  On
       the CPU: the census of two steps, from states with different spike
       counts, is the same op for op (a CUDA graph replays the ops its
       capture recorded, whatever the data).  On the card
       (:func:`check_graphed`): a warm run is graph replays only, as many
       as the cache key implies, and the eager work around them is the
       run's once-per-call work (the same for two lengths);
GC002  (HLO002) no host sync inside a step: on the CPU by census
       (``_local_scalar_dense``, device-to-host copies); on the card a warm
       run under ``torch.cuda.set_sync_debug_mode("error")``;
GC003  (HLO003) the dtype casts a step dispatches stay within a budget
       (:data:`DEFAULT_MAX_CASTS`): a jump means an implicit-promotion
       surface opened up inside the step;
GC004  (HLO004) no float64 tensor in a step.

``python -m repro_torch.analysis graph`` pins these for every committed
scenario (``examples/scenarios/*.json``) at a reduced scale (the contracts
are structural: which ops a step dispatches, not how large they are), on
the scenario's own backend when fused, else on a fused stand-in of the
same model, and with ``--kernels fused`` also on the one-kernel step.
"""
from __future__ import annotations

import glob as glob_mod
import os
from typing import List, Optional, Sequence

import torch

from repro_torch.analysis.report import Finding
from repro_torch.perf.step_analysis import op_census

#: casts a step may dispatch: today's largest count over the committed
#: scenarios, 21 (``stdp_ee.json`` on the one-kernel step, on the CPU,
#: where the plain versions run op by op; 20 on the phase-split step, which
#: takes the drive's float counts as the one-kernel step does).  The
#: static main path's step (``ell``, ``pop_counts``, the 8 Hz background)
#: dispatches 7 on the one-kernel step there, in 87 ops, and none on the
#: card, in 11 ops around the draw, K3 and the probe's kernel: K3 takes
#: the drive's float counts as drawn (``chip_smoke.py``'s
#: ``[graph_contract]``, PERF.md).
DEFAULT_MAX_CASTS = 21


def _clone_state(state):
    from repro_torch.api.backends import _clone_generator, tree_map
    if isinstance(state, tuple) and not hasattr(state, "_fields"):
        sim, ps = state
        return (_clone_state(sim), tree_map(torch.clone, ps))
    return tree_map(torch.clone, state)._replace(
        generator=_clone_generator(state.generator))


def session_step(sim, state=None):
    """One steady step of ``sim``'s loop with its probes, as a body graph
    captures it (``_segment`` of one step past the head), as a callable
    that carries its own copy of ``state`` (the session's when None)."""
    from repro_torch.api.probes import split_probes
    backend = sim.backend
    step_probes, stream_probes = split_probes(tuple(sim.probes))
    carry = [backend._carry(_clone_state(sim.state if state is None
                                         else state),
                            stream_probes, None)]

    def step():
        carry[0], _ = backend._segment(carry[0], backend.head, 1,
                                       step_probes, stream_probes)
    step.carry = carry
    return step


def _spiking_state(sim):
    """A copy of the session's state in which every other neuron is 1 mV
    above threshold, so that its steps spike (and deliver) far more."""
    state = _clone_state(sim.state)
    sim_state = state[0] if isinstance(state, tuple) \
        and not hasattr(state, "_fields") else state
    neuron = getattr(sim_state, "neuron", sim_state)
    V_th = float(sim.backend.prop.V_th)
    neuron.V[::2] = V_th + 1.0
    neuron.refrac.zero_()
    return state


def check_census(census: dict, *, symbol: str, path: str = "",
                 max_casts: int = DEFAULT_MAX_CASTS,
                 other: Optional[dict] = None) -> List[Finding]:
    """GC001-GC004 on a census (``other``: the census of the same step from
    another state, for GC001)."""
    out: List[Finding] = []
    if not census["same_sequence"] or (
            other is not None
            and other["sequence_digests"] != census["sequence_digests"]):
        out.append(Finding(
            "GC001", path, 0, symbol,
            f"the step's op sequence depends on the data "
            f"(ops per step {census['ops_per_step']}"
            + ("" if other is None else
               f" against {other['ops_per_step']} from another state")
            + ") -- a CUDA graph replays the sequence of its capture"))
    if census["host_syncs"] or census["d2h_copies"]:
        out.append(Finding(
            "GC002", path, 0, symbol,
            f"{census['host_syncs']} host sync(s) and "
            f"{census['d2h_copies']} device-to-host cop(ies) a step -- "
            f"each stalls the step, and a capture refuses them"))
    if census["casts"] > max_casts:
        out.append(Finding(
            "GC003", path, 0, symbol,
            f"{census['casts']} dtype casts a step (budget {max_casts}: "
            f"{census['cast_kinds']}) -- an implicit-promotion surface "
            f"opened inside the step"))
    if census["f64_tensors"]:
        out.append(Finding(
            "GC004", path, 0, symbol,
            f"{census['f64_tensors']} float64 tensor(s) a step -- the "
            f"engine contract is float32/bf16 end to end"))
    return out


def check_session(sim, *, symbol: str, path: str = "", n_steps: int = 16,
                  max_casts: int = DEFAULT_MAX_CASTS) -> List[Finding]:
    """GC001-GC004 on ``sim``'s step by census: ``n_steps`` steps from the
    session's state and ``n_steps`` from a copy in which half the neurons
    spike at once.  The first is stepped once before, uncounted, as the
    backend steps and records once before its first capture (what a probe
    builds at its first call is built there)."""
    quiet = session_step(sim)
    quiet()
    quiet = op_census(quiet, n_steps=n_steps)
    busy = op_census(session_step(sim, _spiking_state(sim)),
                     n_steps=n_steps)
    return check_census(quiet, symbol=symbol, path=path,
                        max_casts=max_casts, other=busy)


def check_scenario(path: str, *, n_steps: int = 16,
                   max_casts: int = DEFAULT_MAX_CASTS, scale: float = 0.02,
                   kernels: Optional[str] = None,
                   device="cpu") -> List[Finding]:
    """Contract-check one committed scenario JSON at a scale of at most
    ``scale``, on the fused backend (a stand-in of the scenario's model
    when it names another); ``kernels`` forces a kernel mode (``"fused"``
    re-points a scenario at the ``ell`` strategy, which the one-kernel
    step needs)."""
    import dataclasses as dc

    from repro_torch.api.experiment import Experiment

    exp = Experiment.from_json(path)
    model = exp.model
    if getattr(model, "scale", None) is not None and model.scale > scale:
        model = dc.replace(model, scale=scale)
    exp = dc.replace(exp, backend="fused", model=model)
    sim_kwargs = {"device": device}
    if kernels is not None:
        sim_kwargs["kernels"] = kernels
        if kernels == "fused" and getattr(model, "strategy", None) != "ell":
            sim_kwargs["strategy"] = "ell"
    sim = exp.make_simulator(**sim_kwargs)
    symbol = exp.name or os.path.basename(path)
    if kernels is not None:
        symbol = f"{symbol}[kernels={kernels}]"
    return check_session(sim, symbol=symbol, path=_relpath(path),
                         n_steps=n_steps, max_casts=max_casts)


def _relpath(path: str) -> str:
    rel = os.path.relpath(path)
    return rel.replace(os.sep, "/") if not rel.startswith("..") \
        else path.replace(os.sep, "/")


def check_scenarios(paths: Optional[Sequence[str]] = None, *,
                    n_steps: int = 16,
                    max_casts: int = DEFAULT_MAX_CASTS,
                    kernels: Optional[str] = None,
                    device="cpu") -> List[Finding]:
    """Contract-check many scenarios (default: examples/scenarios/*.json)."""
    if not paths:
        paths = sorted(glob_mod.glob(
            os.path.join("examples", "scenarios", "*.json")))
    findings: List[Finding] = []
    for p in paths:
        findings.extend(check_scenario(p, n_steps=n_steps,
                                       max_casts=max_casts,
                                       kernels=kernels, device=device))
    return findings


# ---------------------------------------------------------------------------
# On the card: the graphed loop itself
# ---------------------------------------------------------------------------

def _count_replays(entry) -> List[int]:
    """Wrap each graph of a cache entry so that its replays are counted
    and run outside any dispatch mode (a replay's own prologue, which sets
    the registered generator's seed and offset, two scalar fills a replay,
    belongs to the replay, not to the eager work around it); returns the
    counter (one cell)."""
    from torch.utils._python_dispatch import _disable_current_modes
    count = [0]
    for graph, _ in entry.graphs:
        replay = graph.replay

        def counted(times: int = 1, replay=replay):
            count[0] += times
            with _disable_current_modes():
                replay(times)
        graph.replay = counted
    return count


def _uncount(entry) -> None:
    for graph, _ in entry.graphs:
        graph.__dict__.pop("replay", None)


def warm_run_census(sim, n_steps: int) -> dict:
    """One warm run of ``n_steps`` through ``sim``'s graphed backend: the
    graph replays it made against those its cache key implies, and the
    eager ops dispatched around them (a census over the whole run: the
    replays dispatch none)."""
    backend = sim.backend
    probes = tuple(sim.probes)
    backend.warmup(sim.state, n_steps, probes)
    entry = backend.graphs.peek(backend._key(n_steps, probes))
    expected = sum(times for _, times in entry.graphs)
    count = _count_replays(entry)
    try:
        census = op_census(lambda: backend.run(sim.state, n_steps, probes))
    finally:
        _uncount(entry)
    return {"replays": count[0], "replays_expected": expected,
            "eager_ops": census["ops_per_step"][0],
            "eager_casts": census["casts"],
            "eager_f64": census["f64_tensors"]}


def check_graphed(sim, *, symbol: str, lengths=(150, 300),
                  max_casts: int = DEFAULT_MAX_CASTS) -> dict:
    """GC001-GC004 on the card for a graphed session: warm runs of two
    ``lengths`` (GC001: replays as the key implies, the same eager work
    for both; GC002: the runs under the sync debug mode "error"), and the
    census of one eager step (GC003, GC004, GC002's census).  Returns
    ``{"findings": [...], "runs": [...], "census": {...}}``."""
    from repro_torch.analysis.sanitize import _sync_errors
    findings: List[Finding] = []
    runs = []
    for n in lengths:
        sim.backend.warmup(sim.state, n, tuple(sim.probes))
        try:
            with _sync_errors(sim.device):
                runs.append(warm_run_census(sim, n) | {"n_steps": n})
        except RuntimeError as e:
            findings.append(Finding(
                "GC002", "", 0, symbol,
                f"a warm run of {n} steps synchronised with the host: {e}"))
            return {"findings": findings, "runs": runs, "census": None}
    if any(r["replays"] != r["replays_expected"] for r in runs) \
            or len({r["eager_ops"] for r in runs}) != 1:
        findings.append(Finding(
            "GC001", "", 0, symbol,
            f"a warm run is not graph replays plus its once-per-call "
            f"work: {runs}"))
    census = op_census(session_step(sim), n_steps=2)
    findings.extend(f for f in check_census(census, symbol=symbol,
                                            max_casts=max_casts)
                    if f.rule != "GC001")
    return {"findings": findings, "runs": runs, "census": census}
