"""The comparison that decides ``correct``.

Three numbers, each with its limit in ``perfbench/limits/<workload>.json``
(the readings each was set from are there too, and in PERF.md):

* ``v0_mismatch``: neurons whose initial state differs from the draw the
  configuration states (V from each population's normal, from the
  session's seed; currents, refractory counts and the ring zero).  Exact.
* ``tables_mismatch``: checksums of the program's device tables (and, with
  plasticity, of its live weight table at the start) that differ from the
  drawn network's.  Exact.
* ``counts_gap``: the plain reference follows each sampled segment from
  the program's own state at the segment's start (the window's runs are
  too long to follow whole: K3's float atomics add in no fixed order, and
  the network's chaos turns one rounding into another spike within some
  hundreds of steps); the sum over the segments' steps and populations of
  ``|program - reference|`` spike counts, over the reference's spikes.
* ``weights_gap`` (plastic cells): for the sampled runs in the sample's
  first ``weight_runs`` slots, the change of the live weight table over the whole run, as the
  norm of each projection's change (source population by target
  population, 64 leaves); the reference follows the same runs whole from
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

from perfbench.reference.lif_net import Reference


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


def start_check(sim, sums: list, c, key: int) -> dict:
    """The program's fresh state and device tables against the seed's draw
    and the drawn network's checksums ``sums``."""
    state = sim.state
    st, ps = (state, None) if hasattr(state, "ring") else state
    dev = st.ring.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(key))
    mean = torch.as_tensor(c.v0_mean, device=dev)
    sd = torch.as_tensor(c.v0_sd, device=dev)
    v0 = mean + sd * torch.randn(c.n_total, generator=gen, device=dev,
                                 dtype=torch.float32)
    nrn = st.neuron
    bad = int((nrn.V != v0).sum()) + int((nrn.I_ex != 0).sum()) \
        + int((nrn.I_in != 0).sum()) + int((nrn.refrac != 0).sum()) \
        + int((st.ring != 0).sum())
    n, k = c.targets.shape
    tables = sim.backend.net.tables
    cut = lambda a: a[:n, :k]
    mism = _sums_differ(table_sums(cut(tables.targets), cut(tables.weights),
                                   cut(tables.dbins)), sums)
    if ps is not None:
        mism += _sums_differ(table_sums(cut(tables.targets),
                                        cut(ps.weights), cut(tables.dbins)),
                             sums)
    return {"v0_mismatch": bad, "tables_mismatch": mism}


N_POPS = 8
N_LEAVES = N_POPS * (N_POPS + 1)       # keys 9 * source + target


def projection_keys(targets: torch.Tensor, pop_of: torch.Tensor
                    ) -> torch.Tensor:
    """``[N, K]`` uint8 keys ``9 * source population + target population``
    of an ELL table (target population 8 for the padding), on the table's
    device; ``pop_of`` is ``[N]``."""
    n = targets.shape[0]
    pop = pop_of.to(targets.device, torch.int64)
    ext = torch.cat([pop, torch.full((1,), N_POPS, dtype=torch.int64,
                                     device=pop.device)])
    keys = torch.empty(targets.shape, dtype=torch.uint8,
                       device=targets.device)
    for lo in range(0, n, 4096):
        hi = min(n, lo + 4096)
        tg = ext[targets[lo:hi].to(torch.int64).clamp(max=n)]
        keys[lo:hi] = (pop[lo:hi, None] * (N_POPS + 1) + tg).to(torch.uint8)
    return keys


def change_sq(w_end: torch.Tensor, w_start: torch.Tensor,
              keys: torch.Tensor, rows: int = 4096) -> torch.Tensor:
    """Each projection's sum of squared weight changes, ``[N_LEAVES]``
    float64 on the device: ``w_end - w_start`` over the first ``[N, K]``
    of each table (``keys``' shape), a block of ``rows`` rows at a time."""
    n, k = keys.shape
    out = torch.zeros(N_LEAVES, dtype=torch.float64, device=keys.device)
    for lo in range(0, n, rows):
        hi = min(n, lo + rows)
        d = (w_end[lo:hi, :k].float() - w_start[lo:hi, :k].float()
             ).to(torch.float64)
        out += torch.bincount(keys[lo:hi].reshape(-1),
                              weights=(d * d).reshape(-1),
                              minlength=N_LEAVES)
    return out


def weights_gap(pairs) -> float:
    """The worst projection's ``|program - reference|`` norm of change,
    over the larger of that leaf's reference norm and the median moved
    leaf's, from ``(program, reference)`` pairs of ``change_sq`` arrays
    summed over the runs.  1.0 when the reference moved nothing."""
    prog = np.sqrt(sum(np.asarray(p, np.float64) for p, _ in pairs))
    ref = np.sqrt(sum(np.asarray(r, np.float64) for _, r in pairs))
    real = np.arange(N_LEAVES) % (N_POPS + 1) < N_POPS
    prog, ref = prog[real], ref[real]
    moved = ref[ref > 0]
    if not moved.size:
        return 1.0
    scale = np.maximum(ref, np.median(moved))
    return float(np.max(np.abs(prog - ref) / scale))


def reference_for(c, config: dict, traffic: dict, device,
                  dtype=torch.float32) -> Reference:
    """The plain reference of a cell's network, rule and drive."""
    stim = traffic["stimulus"]
    if [s["kind"] for s in stim] != ["poisson_background"]:
        raise ValueError(f"the reference drives the Poisson background "
                         f"only, not {stim}")
    return Reference(c, device, dt=config["dt_ms"],
                     rate_hz=stim[0].get("rate_hz", 8.0),
                     stdp=config.get("plasticity"), dtype=dtype)


def counts_gap(pairs) -> float:
    """``sum |program - reference| / sum reference`` over ``(program,
    reference)`` count arrays; 1.0 when there is nothing to compare."""
    num = sum(float(np.abs(np.asarray(p, np.int64) - r).sum())
              for p, r in pairs)
    den = sum(float(r.sum()) for _, r in pairs)
    return num / den if den else 1.0


def follow_segments(ref: Reference, segments: list, run_steps: int):
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


def check(c, config: dict, traffic: dict, segments: list, start: dict,
          device) -> dict:
    """The numbers of a run: ``start``'s, the segments' ``counts_gap`` and,
    in a plastic cell, the weight runs' ``weights_gap``."""
    ref = reference_for(c, config, traffic, device)
    pairs, wpairs = follow_segments(ref, segments,
                                    run_steps(config, traffic))
    out = {**start, "counts_gap": counts_gap(pairs) if pairs else 1.0,
           "segments": len(pairs)}
    if config.get("plasticity"):
        out["weights_gap"] = weights_gap(wpairs) if wpairs else None
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
