"""Request batching: run same-config sessions as one group.

The port's counterpart of ``repro.serve.batching``.  Sessions created
from one scenario share a built backend
(:class:`repro_torch.serve.session.BackendPool`).  :func:`run_coalesced`
groups run requests by ``(backend, probes, n_steps)`` and drives each
group of two or more through the backend's ``run_batch``.

In the port ``run_batch`` steps the states one after the other over the
backend's one graph set (a batch axis inside K3/K4, the reference's
``vmap``, would be a kernel of its own): the group's first session may
capture, the others replay, and a capture after the first raises.  So a
coalesced result is bitwise the session's sequential ``run``, and each
session's ``RunResult.wall_s`` is its own trial's wall, not the
reference's share ``wall / len(group)`` of one vmapped program.

Sessions stay independent: each one's presim, state, generator (riding
in its state), stream carries, step counters and overflow go through the
group as through ``Simulator.run``.  On a graphed backend the states
come back through the backend's residency: the last session of the group
is left resident in the static buffers, and a session that was resident
before the group got storage of its own when the next one was loaded.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

from repro_torch.serve.session import SessionStateError


def _group_key(session) -> tuple:
    sim = session.sim
    # probes are interned per name (api.probes.resolve), so equal probe
    # sets are the same instances and hash and compare by identity
    return (id(sim.backend), sim.probes)


def run_coalesced(requests: Sequence[Tuple[object, float]],
                  coalesce: bool = True) -> Dict[str, object]:
    """Execute ``[(session, t_ms), ...]``; returns ``{session.id:
    RunResult}``.

    Groups of two or more sessions sharing (backend, probes, n_steps) run
    through one ``run_batch``; singletons run through ``Session.run``.
    ``coalesce=False`` runs every session through ``Session.run``.
    """
    results: Dict[str, object] = {}
    groups: Dict[tuple, List[Tuple[object, float]]] = {}
    for session, t_ms in requests:
        if session.status != "running":
            raise SessionStateError(
                f"session {session.id!r} is {session.status}; only "
                f"running sessions can be batched")
        n_steps = session.sim._steps(t_ms)
        key = _group_key(session) + (n_steps,) if coalesce else \
            ("seq", session.id)
        groups.setdefault(key, []).append((session, t_ms))

    for members in groups.values():
        if len(members) < 2:
            for session, t_ms in members:
                results[session.id] = session.run(t_ms)
        else:
            results.update(_run_group(members))
    return results


def _run_group(members: List[Tuple[object, float]]) -> Dict[str, object]:
    """One ``run_batch`` over the group's own states and stream carries."""
    sims = [s.sim for s, _ in members]
    backend, probes = sims[0].backend, sims[0].probes
    n_steps = sims[0]._steps(members[0][1])
    # each session's presim runs first (a fresh session pays it here,
    # once, as in run)
    for sim in sims:
        sim._require_state("run")
        sim._ensure_built()
        sim._maybe_presim(None)
    states, datas, walls = backend.run_batch(
        [sim._state for sim in sims], n_steps, probes,
        stream=[sim._stream_seeds(probes) for sim in sims])
    results: Dict[str, object] = {}
    for (session, _), sim, state, data, wall in zip(members, sims, states,
                                                   datas, walls):
        res = sim._advance(state, data, n_steps, probes, wall)
        session.t_model_ms += res.t_model_ms
        session.n_runs += 1
        results[session.id] = res
    return results
