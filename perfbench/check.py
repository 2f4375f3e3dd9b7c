"""The comparison that decides ``correct``.

Three numbers, each with its limit in ``perfbench/limits/<workload>.json``
(the readings each was set from are there too, and in PERF.md):

* ``v0_mismatch``: entries of the followed leaves (``leaves``) whose
  initial value differs from the network module's ``fresh`` state (PD14:
  V from each population's normal, from the session's seed; currents,
  refractory counts, ring, step and traces zero).  Exact.
* ``tables_mismatch``: checksums of the program's device tables (and, with
  plasticity, of its live weight table at the start) that differ from the
  drawn network's.  Exact.
* ``counts_gap``: the plain reference (the network module's
  ``reference``) follows each sampled segment from
  the program's own state at the segment's start (the window's runs are
  too long to follow whole: K3's float atomics add in no fixed order, and
  the network's chaos turns one rounding into another spike within some
  hundreds of steps); the sum over the segments' steps and populations of
  ``|program - reference|`` spike counts, over the reference's spikes.
* ``weights_gap`` (plastic cells): for the sampled runs in the sample's
  first ``weight_runs`` slots, the change of the live weight table over
  the whole run, as the norm of each projection's change (source
  population by target population, 64 leaves for PD14's 8 populations);
  the reference follows the same runs whole from
  the same start.  Past some hundreds of steps the two spike trains part
  (as above), so the two changes are two draws of one process: the number
  is the worst leaf's gap of norms, over the reference's norm of that leaf
  or of the median moved leaf, whichever is larger.  A leaf the reference
  leaves unchanged (a static projection) is held to the median too, so a
  program that moves a static weight fails.
"""
from __future__ import annotations

import sys

import numpy as np
import torch


def table_sums(targets, weights, dbins, rows: int = 2048) -> list:
    """Position-weighted checksums of ``[N, K]`` tables, on their device,
    a block of ``rows`` rows at a time: exact for the integer tables,
    float64 sums for the weights."""
    n, k = targets.shape
    dev = targets.device
    col = (torch.arange(k, device=dev) % 97 + 1)[None, :]
    out = [0, 0, 0, 0, 0.0, 0.0, 0.0]
    for lo in range(0, n, rows):
        hi = min(n, lo + rows)
        row = (torch.arange(lo, hi, device=dev) % 89 + 1)[:, None]
        for i, a in enumerate((targets[lo:hi], dbins[lo:hi])):
            a = a.to(torch.int64)
            out[2 * i] += int((a * col).sum())
            out[2 * i + 1] += int((a * row).sum())
        w = weights[lo:hi].to(torch.float64)
        out[4] += float(w.sum())
        out[5] += float((w * col).sum())
        out[6] += float((w * row).sum())
    return out


def _sums_differ(a: list, b: list) -> int:
    bad = sum(int(x != y) for x, y in zip(a[:4], b[:4]))
    for x, y in zip(a[4:], b[4:]):
        bad += int(abs(x - y) > 1e-9 * max(1.0, abs(y)))
    return bad


def sim_state(state):
    """The ``SimState`` of a session's state (with plasticity, the first
    of the pair)."""
    return state if hasattr(state, "ring") else state[0]


def leaves(network, state) -> dict:
    """The session's own tensors that the reference follows, by name: the
    network's ``NEURON_LEAVES`` of the neuron state, the ring, the step
    ``t`` and, with plasticity, its ``PLASTIC_LEAVES``."""
    sim = sim_state(state)
    out = {k: getattr(sim.neuron, k) for k in network.NEURON_LEAVES}
    out.update(ring=sim.ring, t=sim.t)
    if sim is not state:
        out.update({k: getattr(state[1], k) for k in network.PLASTIC_LEAVES})
    return out


def fresh_mismatch(have: dict, want: dict) -> int:
    """Entries of the leaves of ``want`` (a network's ``fresh`` state) that
    ``have`` holds otherwise."""
    return sum(int((have[k] != v).sum()) for k, v in want.items()
               if k != "generator_state")


def start_check(network, sim, sums: list, c, key: int) -> dict:
    """The program's fresh state and device tables against the seed's draw
    (``network.fresh``) and the drawn network's checksums ``sums``."""
    have = leaves(network, sim.state)
    want = network.fresh(c, key, have["ring"].device,
                         plastic=sim.plasticity is not None)
    bad = fresh_mismatch(have, want)
    n, k = c.targets.shape
    tables = sim.backend.net.tables
    cut = lambda a: a[:n, :k]
    mism = _sums_differ(table_sums(cut(tables.targets), cut(tables.weights),
                                   cut(tables.dbins)), sums)
    if "weights" in have:
        mism += _sums_differ(table_sums(cut(tables.targets),
                                        cut(have["weights"]),
                                        cut(tables.dbins)), sums)
    return {"v0_mismatch": bad, "tables_mismatch": mism}


#: the most populations whose ``(P + 1) * P`` projection keys fit in uint8
MAX_POPS = 15


def n_leaves(n_pops: int) -> int:
    """Keys of ``projection_keys`` for ``n_pops`` populations, padding's
    included."""
    return n_pops * (n_pops + 1)


def projection_keys(targets: torch.Tensor, pop_of: torch.Tensor,
                    n_pops: int) -> torch.Tensor:
    """``[N, K]`` uint8 keys ``(n_pops + 1) * source population + target
    population`` of an ELL table (target population ``n_pops`` for the
    padding), on the table's device; ``pop_of`` is ``[N]``."""
    if not 0 < n_pops <= MAX_POPS:
        raise ValueError(f"{n_pops} populations: the projection keys are "
                         f"uint8 and hold at most {MAX_POPS}")
    n = targets.shape[0]
    pop = pop_of.to(targets.device, torch.int64)
    ext = torch.cat([pop, torch.full((1,), n_pops, dtype=torch.int64,
                                     device=pop.device)])
    keys = torch.empty(targets.shape, dtype=torch.uint8,
                       device=targets.device)
    for lo in range(0, n, 4096):
        hi = min(n, lo + 4096)
        tg = ext[targets[lo:hi].to(torch.int64).clamp(max=n)]
        keys[lo:hi] = (pop[lo:hi, None] * (n_pops + 1) + tg).to(torch.uint8)
    return keys


def change_sq(w_end: torch.Tensor, w_start: torch.Tensor,
              keys: torch.Tensor, n_pops: int, rows: int = 4096
              ) -> torch.Tensor:
    """Each projection's sum of squared weight changes, ``[n_leaves]``
    float64 on the device: ``w_end - w_start`` over the first ``[N, K]``
    of each table (``keys``' shape), a block of ``rows`` rows at a time."""
    n, k = keys.shape
    out = torch.zeros(n_leaves(n_pops), dtype=torch.float64,
                      device=keys.device)
    for lo in range(0, n, rows):
        hi = min(n, lo + rows)
        d = (w_end[lo:hi, :k].float() - w_start[lo:hi, :k].float()
             ).to(torch.float64)
        out += torch.bincount(keys[lo:hi].reshape(-1),
                              weights=(d * d).reshape(-1),
                              minlength=n_leaves(n_pops))
    return out


def weights_gap(pairs, n_pops: int) -> float:
    """The worst projection's ``|program - reference|`` norm of change,
    over the larger of that leaf's reference norm and the median moved
    leaf's, from ``(program, reference)`` pairs of ``change_sq`` arrays
    summed over the runs.  1.0 when the reference moved nothing."""
    prog = np.sqrt(sum(np.asarray(p, np.float64) for p, _ in pairs))
    ref = np.sqrt(sum(np.asarray(r, np.float64) for _, r in pairs))
    real = np.arange(n_leaves(n_pops)) % (n_pops + 1) < n_pops
    prog, ref = prog[real], ref[real]
    moved = ref[ref > 0]
    if not moved.size:
        return 1.0
    scale = np.maximum(ref, np.median(moved))
    return float(np.max(np.abs(prog - ref) / scale))


def counts_gap(pairs) -> float:
    """``sum |program - reference| / sum reference`` over ``(program,
    reference)`` count arrays; 1.0 when there is nothing to compare."""
    num = sum(float(np.abs(np.asarray(p, np.int64) - r).sum())
              for p, r in pairs)
    den = sum(float(r.sum()) for _, r in pairs)
    return num / den if den else 1.0


def follow_segments(ref, segments: list, run_steps: int):
    """The reference's ``(counts pairs, change_sq pairs)`` of ``segments``:
    a segment with ``weights_sq`` (the program's change over its run) is
    followed for the whole run, the others for their counted steps."""
    pairs, wpairs = [], []
    for s in segments:
        steps = len(s["counts"])
        if s.get("weights_sq") is None:
            pairs.append((s["counts"], ref.follow(s["start"], steps)))
            continue
        counts, end = ref.advance(s["start"], run_steps)
        pairs.append((s["counts"], counts[:steps]))
        wpairs.append((s["weights_sq"], ref.change_sq(end["weights"],
                                                      s["start"]["weights"])
                       .cpu().numpy()))
    return pairs, wpairs


def run_steps(config: dict, traffic: dict) -> int:
    """Steps of one unit of the mix (a run or a chunk)."""
    unit = traffic.get("run_ms", traffic.get("chunk_ms"))
    return int(round(float(unit) / float(config["dt_ms"])))


def check(network, c, config: dict, traffic: dict, segments: list,
          start: dict, device) -> dict:
    """The numbers of a run: ``start``'s, the segments' ``counts_gap`` and,
    in a plastic cell, the weight runs' ``weights_gap``; the reference is
    ``network``'s."""
    ref = network.reference(c, config, traffic, device)
    pairs, wpairs = follow_segments(ref, segments,
                                    run_steps(config, traffic))
    out = {**start, "counts_gap": counts_gap(pairs) if pairs else 1.0,
           "segments": len(pairs)}
    if config.get("plasticity"):
        out["weights_gap"] = weights_gap(wpairs, len(c.pop_sizes)) \
            if wpairs else None
        out["weight_runs"] = len(wpairs)
    return out


def judge(numbers: dict, limits: dict):
    """``(correct, compared)``: each number that has a limit beside it,
    printed to standard error as the run's last lines.  A number without a
    limit, or a limit without a number, is not correct."""
    compared, ok = {}, bool(limits)
    for name, spec in limits.items():
        if name.startswith("_"):
            continue
        value = numbers.get(name)
        limit = float(spec["limit"])
        good = value is not None and value <= limit
        ok &= good
        compared[name] = {"value": value, "limit": limit}
    for name, item in compared.items():
        print(f"perfbench check {name} {item['value']!r} limit "
              f"{item['limit']!r}", file=sys.stderr)
    return ok, compared
