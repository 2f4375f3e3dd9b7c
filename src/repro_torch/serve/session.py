"""Sessions over shared backends: the port's in-process simulation service.

The port's counterpart of ``repro.serve.session``.  A
:class:`SessionManager` multiplexes many :class:`Session`\\ s -- each a
live :class:`~repro_torch.api.simulator.Simulator` with its own state,
generator and stream-probe carries -- over a bounded pool of *shared
built backends*.  Two sessions created from the same scenario resolve to
one :class:`BackendPool` entry: one connectome, one set of device tables,
one capture of each distinct graph set (``tests/test_torch_serve.py``
holds this with the :mod:`~repro_torch.serve.compile_cache` counters)::

    mgr = SessionManager()                 # on the card; device="cpu" here
    s1 = mgr.create("examples/scenarios/smoke_background.json")
    s2 = mgr.create("examples/scenarios/smoke_background.json", seed=1)
    r = s1.run(200.0)                      # -> RunResult
    mgr.run_many({s1.id: 200.0, s2.id: 200.0})   # coalesced
    s1.suspend()                           # checkpoint, release the state
    s1.resume()                            # bitwise continuation
    mgr.destroy(s1.id)

A scenario on ``backend="sharded"`` is served as a world of one on the
server's card (its pool key names the backend); a server inside a process
group of more than one rank refuses it at create.

What a suspend frees.  A suspended session holds no device tensor of its
own; its checkpoint (``repro_torch.checkpoint``) is on disk.  The
backend's tables, graphs and static buffers stay, warm for every session
on it.  The session whose state was resident in those buffers had its
tensors as aliases of them, so its suspend frees no device memory; a
session that was not resident frees its own copy of the state.

Every operation that touches the device runs under the manager's one
lock (a session driven directly takes it too): a graphed backend has one
set of static buffers, and a CUDA graph's capture must not meet another
thread's device call.  ``stats`` and ``sessions`` read host counters only
and do not wait for that lock.
"""
from __future__ import annotations

import dataclasses
import itertools
import os
import re
import shutil
import tempfile
import threading
import time
from typing import Any, Dict, List, Optional, Union

import torch.distributed as dist

from repro_torch.analysis.sanitize import RecompileGuard
from repro_torch.api.backends import make_backend
from repro_torch.api.experiment import Experiment
from repro_torch.api.simulator import session_device
from repro_torch.core import stimulus as stimulus_mod
from repro_torch.core.connectivity import build_connectome
from repro_torch.core.engine import SimConfig
from repro_torch.launch import mesh
from repro_torch.serve.compile_cache import (ExecutableCache, cache_stats,
                                             fingerprint)

# a session id names its checkpoint directory under the manager's root
_SESSION_ID = re.compile(r"^[A-Za-z0-9_-][A-Za-z0-9_.-]*$")


class SessionStateError(RuntimeError):
    """A request on a suspended or closed session, or on a closed manager:
    the caller's error (HTTP 400), where any other failure is the
    server's (500)."""


def _experiment_from(spec) -> Experiment:
    """Resolve a session spec: Experiment | scenario dict | JSON path."""
    if isinstance(spec, Experiment):
        return spec
    if isinstance(spec, dict):
        return Experiment.from_dict(spec)
    if isinstance(spec, (str, os.PathLike)):
        return Experiment.from_json(os.fspath(spec))
    raise TypeError(f"session spec must be an Experiment, a scenario "
                    f"dict or a JSON path, got {type(spec)}")


def _check_servable(exp) -> None:
    """A sharded scenario is served as a world of one on the server's
    card: inside a process group of more ranks it is refused (every rank
    would have to follow each request)."""
    if exp.backend == "sharded" and mesh.group_initialized() \
            and dist.get_world_size() > 1:
        raise ValueError(
            f"backend 'sharded' is served as a world of one, but this "
            f"server runs in a process group of {dist.get_world_size()} "
            f"ranks, each of which would have to follow every request; "
            f"serve it from a process outside the group")


def build_key(exp) -> str:
    """The backend-sharing fingerprint of an experiment, the reference's.

    Covers what ``Backend.build`` depends on: the model (the connectome
    and the resolved ``SimConfig``), the stimulus timeline, the
    plasticity rule and the backend name.  Probes, duration and trial
    count are left out: they key the graph sets inside the shared backend
    instead.
    """
    d = {
        "model": dataclasses.asdict(exp.model),
        "stimulus": [s.to_dict() for s in exp.stimulus],
        "plasticity": (None if exp.plasticity is None
                       else exp.plasticity.to_dict()),
        "backend": exp.backend,
    }
    return fingerprint(d)


class BackendPool:
    """Bounded LRU pool of built backends on ``device``, keyed on
    :func:`build_key`.

    An entry is ``(connectome, backend)``: the host-side network build,
    the device tables and every graph set its cache collects.  Eviction
    drops the pool's reference; a live session that holds the backend
    keeps it (tables, graphs and buffers) alive and working, and only
    stops sharing it with sessions created later.
    """

    def __init__(self, capacity: int = 8, device=None):
        self.device = session_device(device)
        self._cache = ExecutableCache("serve.backends", capacity=capacity)

    def get(self, exp):
        """The shared ``(connectome, backend)`` for this experiment, built
        at most once per distinct build config."""
        try:
            key = build_key(exp)
        except (TypeError, ValueError):
            # a spec that does not serialise (a callable probe, a custom
            # stimulus object): a private, unshared build
            return self._build(exp)
        return self._cache.get_or_build(key, lambda: self._build(exp))

    def _build(self, exp):
        model = exp.model
        connectome = build_connectome(
            scale=model.scale, n_scaling=model.n_scaling,
            k_scaling=model.k_scaling, seed=int(model.seed), dt=model.dt)
        backend = make_backend(exp.backend, plasticity=exp.plasticity)
        # the config a session of this experiment asks for, so that its
        # Simulator finds the backend built for it (Backend.built_for)
        cfg = SimConfig(
            dt=model.dt, strategy=model.strategy,
            spike_budget=model.spike_budget,
            strict_delivery=model.strict_delivery,
            stimulus=(stimulus_mod.resolve_timeline(exp.stimulus)
                      if exp.stimulus else model.stimulus),
            kernels=model.kernels)
        backend.build(connectome, cfg, self.device)
        return connectome, backend

    def stats(self) -> Dict[str, Any]:
        return self._cache.stats()


class Session:
    """One live simulation session inside a :class:`SessionManager`; its
    operations take the manager's lock."""

    def __init__(self, sid: str, experiment, sim, ckpt_dir: str,
                 lock: threading.RLock):
        self.id = sid
        self.experiment = experiment
        self.sim = sim
        self.ckpt_dir = ckpt_dir
        self.status = "running"           # running | suspended | closed
        self.created_unix = time.time()
        self.t_model_ms = 0.0
        self.n_runs = 0
        self._lock = lock

    # -- operations ---------------------------------------------------------

    def run(self, t_ms: float, *, chunk_ms: Optional[float] = None,
            callback=None):
        """Advance ``t_ms`` of model time; returns the ``RunResult``.

        ``chunk_ms`` runs ``run_chunked``, with ``callback(i,
        chunk_result)`` after each chunk (the HTTP front end streams its
        snapshots from it)."""
        with self._lock:
            self._check_open()
            if self.status == "suspended":
                raise SessionStateError(
                    f"session {self.id!r} is suspended; resume() it first")
            if chunk_ms is not None:
                res = self.sim.run_chunked(t_ms, chunk_ms, callback=callback)
            else:
                res = self.sim.run(t_ms)
                if callback is not None:
                    callback(1, res)
            self.t_model_ms += res.t_model_ms
            self.n_runs += 1
            return res

    def step(self, n_steps: int = 1):
        """Advance whole steps (``n_steps * dt`` of model time)."""
        if int(n_steps) < 1:
            raise ValueError(f"n_steps must be >= 1, got {n_steps}")
        with self._lock:
            self._check_open()
            return self.run(int(n_steps) * self.sim.sim_config.dt)

    def suspend(self) -> str:
        """Checkpoint to the session's directory and release its state
        (what that frees: the module's docstring)."""
        with self._lock:
            self._check_open()
            if self.status == "suspended":
                return self.ckpt_dir
            path = self.sim.suspend(self.ckpt_dir)
            self.status = "suspended"
            return path

    def resume(self) -> None:
        """Bring a suspended session back from its checkpoint.  The shared
        backend's graphs stayed warm, so a resume captures nothing (a
        zero-budget capture guard holds it)."""
        with self._lock:
            self._check_open()
            if self.status != "suspended":
                return
            with RecompileGuard(0, caches=self.sim.backend.caches(),
                                what=f"resume of session {self.id!r}"):
                self.sim.resume(self.ckpt_dir)
            self.status = "running"

    def close(self) -> None:
        with self._lock:
            if self.status == "closed":
                return
            self.status = "closed"
            self.sim = None                   # drop the state
            shutil.rmtree(self.ckpt_dir, ignore_errors=True)

    def _check_open(self) -> None:
        if self.status == "closed":
            raise SessionStateError(f"session {self.id!r} is closed")

    # -- introspection (host only) -----------------------------------------

    def info(self) -> Dict[str, Any]:
        return {
            "id": self.id,
            "status": self.status,
            "scenario": self.experiment.name or "<unnamed>",
            "backend": self.experiment.backend,
            "plastic": self.experiment.plasticity is not None,
            "t_model_ms": self.t_model_ms,
            "n_runs": self.n_runs,
            "created_unix": self.created_unix,
        }


class SessionManager:
    """Create / run / suspend / resume / destroy sessions over the pool.

    ``root`` is where suspended sessions checkpoint (a temporary
    directory, removed on ``close()``, unless given).  ``max_backends``
    bounds the backend pool.  ``warm_ms`` captures each new session's
    graphs for that horizon at create time.  ``device`` is where the
    sessions run: ``None`` is the card, and raises without one; tests
    pass ``"cpu"``.  Every operation that touches the device serialises
    on one lock: requests queue, and batching (:meth:`run_many`) is the
    way to group same-config work.
    """

    def __init__(self, root: Optional[str] = None, max_backends: int = 8,
                 warm_ms: Optional[float] = None, device=None):
        self.device = session_device(device)
        self.pool = BackendPool(capacity=max_backends, device=self.device)
        self._own_root = root is None
        self.root = root or tempfile.mkdtemp(prefix="repro-torch-serve-")
        self.warm_ms = warm_ms
        self._sessions: Dict[str, Session] = {}
        self._ids = itertools.count(1)
        self._lock = threading.RLock()        # the device's
        self._index = threading.Lock()        # the session table's
        self._closed = False

    # -- lifecycle ----------------------------------------------------------

    def create(self, spec, *, session_id: Optional[str] = None,
               seed: Optional[int] = None) -> Session:
        """Create a session from a scenario (Experiment / dict / path).

        ``seed`` sets the session's generator only: the connectome, and
        so the shared backend, stay the scenario's, so seeded replicas of
        one scenario share its graphs, as ``run_batch`` trials do.
        """
        exp = _experiment_from(spec)
        _check_servable(exp)
        key = None if seed is None else int(seed)
        if session_id is not None and (
                not isinstance(session_id, str)
                or not _SESSION_ID.match(session_id)):
            raise ValueError(f"session id {session_id!r}: use letters, "
                             f"digits, '_', '-' and '.' (not first)")
        with self._lock:
            self._check_open()
            sid = session_id or f"s{next(self._ids):04d}"
            with self._index:
                if sid in self._sessions:
                    raise ValueError(f"session id {sid!r} already exists")
            connectome, backend = self.pool.get(exp)
            sim = exp.make_simulator(connectome, backend=backend, key=key,
                                     device=self.device)
            if self.warm_ms is not None:
                sim.warmup(self.warm_ms)
            session = Session(sid, exp, sim, os.path.join(self.root, sid),
                              self._lock)
            with self._index:
                self._sessions[sid] = session
            return session

    def get(self, sid: str) -> Session:
        with self._index:
            if sid not in self._sessions:
                raise KeyError(f"no session {sid!r} (live: "
                               f"{sorted(self._sessions)})")
            return self._sessions[sid]

    def destroy(self, sid: str) -> None:
        with self._lock:
            self.get(sid).close()
            with self._index:
                del self._sessions[sid]

    def close(self) -> None:
        """Close every session and (if owned) remove the checkpoint root."""
        with self._lock:
            for sid in list(self._sessions):
                self.destroy(sid)
            if self._own_root:
                shutil.rmtree(self.root, ignore_errors=True)
            self._closed = True

    def _check_open(self) -> None:
        if self._closed:
            raise SessionStateError("SessionManager is closed")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- operations ---------------------------------------------------------

    def run(self, sid: str, t_ms: float, **kwargs):
        with self._lock:
            return self.get(sid).run(t_ms, **kwargs)

    def step(self, sid: str, n_steps: int = 1):
        with self._lock:
            return self.get(sid).step(n_steps)

    def suspend(self, sid: str) -> str:
        with self._lock:
            return self.get(sid).suspend()

    def resume(self, sid: str) -> None:
        with self._lock:
            self.get(sid).resume()

    def run_many(self, requests: Union[Dict[str, float], List[tuple]],
                 coalesce: bool = True) -> Dict[str, Any]:
        """Run many sessions; sessions on one backend with the same probes
        and horizon run as one group (:mod:`repro_torch.serve.batching`).

        ``requests`` maps session id -> t_ms (or is a list of pairs).
        Returns ``{sid: RunResult}``, each bitwise what running the
        sessions one by one gives."""
        from repro_torch.serve.batching import run_coalesced
        items = (requests.items() if isinstance(requests, dict)
                 else list(requests))
        with self._lock:
            pairs = [(self.get(sid), float(t_ms)) for sid, t_ms in items]
            return run_coalesced(pairs, coalesce=coalesce)

    # -- introspection (host only: no device lock) -------------------------

    def sessions(self) -> List[Dict[str, Any]]:
        with self._index:
            live = list(self._sessions.values())
        return [s.info() for s in live]

    def stats(self) -> Dict[str, Any]:
        """Sessions, the pool, and every counted cache in the process."""
        with self._index:
            live = list(self._sessions.values())
        by_status: Dict[str, int] = {}
        for s in live:
            by_status[s.status] = by_status.get(s.status, 0) + 1
        return {
            "sessions": {"count": len(live), **by_status},
            "backend_pool": self.pool.stats(),
            "compile_caches": cache_stats(),
        }
