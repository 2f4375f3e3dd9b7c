"""The port's simulation session API.

    from repro_torch.api import Simulator
    from repro_torch.configs.microcircuit import MicrocircuitConfig

    sim = Simulator(MicrocircuitConfig(scale=1.0, strategy="ell"))
    sim.warmup(1000.0)               # capture the run's graphs (and presim's)
    res = sim.run(1000.0)            # 100 ms presim (untimed), then 1 s
    print(res.rtf, res.summary()["rates_hz"])

    res = sim.run_chunked(10_000.0, chunk_ms=1000.0)   # 10 chunks, one graph

    plastic = Simulator(MicrocircuitConfig(scale=1.0, strategy="ell"),
                        plasticity="pair_stdp")   # E->E pair STDP
    sim_state, plastic_state = plastic.state

    batch = sim.run_batch(200.0, n_trials=3)    # seeds 55, 56, 57
    print(batch.rtf_mean, batch.validate().passed)

    sim.save("ckpt")                 # ckpt/step_<steps>/host_0.npz, ...
    sim.suspend("ckpt"); sim.resume("ckpt")    # release the state, and back

The session runs on ``cuda`` unless the caller passes ``device="cpu"``; on
a machine without CUDA, ``Simulator(...)`` with no device raises instead of
carrying on on the CPU.  The backend is ``"fused"`` (on a card its loop is
captured in CUDA graphs) or ``"instrumented"`` (the eager phase-split loop
with per-phase timers), or a backend instance, which sessions of one
network share (built once, its graphs captured once; each session's state
stays its own); see ``repro_torch.api.backends``.  ``"sharded"`` is
NEST's distribution scheme over the default ``torch.distributed`` process
group (a world of one without one; ``n_devices=`` must not exceed the
world): the session's state is this rank's shard, and in a group on a CUDA
machine the session runs on the rank's card unless a device is given
(``repro_torch.launch.mesh``).  A sharded session's ``save``, ``restore``,
``suspend`` and ``resume`` are collective: every rank calls them, and the
checkpoint holds the world's global state in the reference's layout.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
import warnings
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.analysis.sanitize import RecompileGuard
from repro_torch.api import probes as probes_mod
from repro_torch.api import results as results_mod
from repro_torch.api.backends import Backend, make_backend, tree_map
from repro_torch.api.results import BatchResult, RunResult
from repro_torch.core import stimulus as stimulus_mod
from repro_torch.core.connectivity import Connectome, build_connectome
from repro_torch.core.device import session_device
from repro_torch.core.engine import SimConfig
from repro_torch.core.plasticity import PlasticState
from repro_torch.perf import trace


class Simulator:
    """A simulation session: one network, one backend, many runs.

    ``config`` is a model config (``MicrocircuitConfig``); ``connectome``
    skips the build, and with it ``config`` may be None (seed 0, no
    presim).  ``sim_config`` replaces the ``SimConfig`` the model config
    gives.  ``backend`` is ``"fused"``, ``"instrumented"``,
    ``"sharded"`` (with ``n_devices``, the world's size when None) or a
    :class:`~repro_torch.api.backends.Backend`.  ``plasticity`` is a rule
    (a registry kind name such as ``"pair_stdp"``, a spec dict or a
    ``PlasticityRule``); the session's state is then the pair
    ``(SimState, PlasticState)``.  ``stimulus`` is a timeline (kind names,
    dicts or ``Stimulus`` instances; it replaces the default 8 Hz
    background, so name the background when stimulation should ride on
    it).  ``kernels=`` (a mode string) and other ``SimConfig`` fields go in
    ``**overrides``.  ``config.seed`` seeds the connectome and, unless
    ``key`` is given, the session's ``torch.Generator``.
    """

    def __init__(self, config=None, *,
                 connectome: Optional[Connectome] = None, backend="fused",
                 probes: Sequence = ("pop_counts",), device=None,
                 plasticity=None, stimulus=None, key: Optional[int] = None,
                 n_devices: Optional[int] = None,
                 sim_config: Optional[SimConfig] = None, **overrides):
        if config is None and connectome is None:
            raise ValueError("pass a model config or a built connectome")
        self.device = session_device(device, sharded=backend == "sharded")
        self.config = config
        seed = int(getattr(config, "seed", 0))
        self._seed = seed
        if connectome is None:
            connectome = build_connectome(
                scale=config.scale, n_scaling=config.n_scaling,
                k_scaling=config.k_scaling, seed=seed, dt=config.dt)
        self.connectome = connectome
        if sim_config is None:
            sim_config = SimConfig(
                dt=config.dt, strategy=config.strategy,
                spike_budget=config.spike_budget,
                strict_delivery=config.strict_delivery,
                stimulus=config.stimulus, kernels=config.kernels)
        if overrides:
            sim_config = dataclasses.replace(sim_config, **overrides)
        if stimulus is not None:
            sim_config = dataclasses.replace(
                sim_config, stimulus=stimulus_mod.resolve_timeline(stimulus))
        self.t_presim = float(getattr(config, "t_presim", 0.0))
        self.backend: Backend = make_backend(backend, plasticity=plasticity,
                                             n_devices=n_devices)
        self.plasticity = self.backend.plasticity
        # a backend handed over already built for this network is shared:
        # its tables and captured graphs serve every session on it
        self._asked = sim_config
        self._build = -1
        self._ensure_built()
        self.sim_config = self.backend.cfg          # resolved
        self.probes = probes_mod.resolve(probes)
        self._check_probes(self.probes)
        self._key = seed if key is None else int(key)
        # one generator for the session's life (a graphed backend copies
        # its state in before each run and out after it)
        self._generator = torch.Generator(device=self.device)
        self.reset()

    def _ensure_built(self) -> None:
        """Build the backend for this session's network and config unless
        it already is.  Checked again only when the backend was built since
        this session last looked: a session built on it for another network
        or config rebuilds it, and this session's next call rebuilds it
        back (both states stay their own)."""
        if self.backend.builds == self._build:
            return
        if not self.backend.built_for(self.connectome, self._asked,
                                      self.device):
            with trace.span("session.build"):
                self.backend.build(self.connectome, self._asked,
                                   self.device)
        self._build = self.backend.builds

    # -- session state ------------------------------------------------------

    def reset(self, key: Optional[int] = None) -> None:
        """Fresh dynamical state (the presim transient applies again).
        ``key`` re-seeds the session's generator (an int seed); without it
        the generator starts again from the session's seed."""
        self._ensure_built()
        if key is not None:
            self._key = int(key)
        self._generator.manual_seed(self._key)
        self._state = self.backend.init(self._generator)
        self._presim_done = False
        self._steps_done = 0
        self._t_model_ms = 0.0
        self._overflow_seen = 0
        # stream probes' carries (name -> device tree), threaded across the
        # session's runs and chunks
        self._stream_state = {}

    @property
    def state(self):
        """The ``SimState``, or ``(SimState, PlasticState)`` in a plastic
        session, or this rank's ``ShardedSimState`` on the sharded
        backend."""
        return self._state

    @state.setter
    def state(self, value) -> None:
        """Carry a state in (e.g. from ``repro_torch.convert``): a
        ``SimState``, or in a plastic session the pair.  The session's
        counters stay, so a pending presim runs from it.  The state's
        generator, if any, hands its state to the session's."""
        self._ensure_built()
        if self.plasticity is not None:
            if not (isinstance(value, tuple) and len(value) == 2
                    and isinstance(value[1], PlasticState)):
                raise TypeError("a plastic session's state is the pair "
                                "(SimState, PlasticState)")
            sim, ps = value
            table = self.backend.net.tables.weights
            if ps.weights.shape != table.shape \
                    or ps.weights.device != table.device:
                raise ValueError(
                    f"plastic weights {tuple(ps.weights.shape)} on "
                    f"{ps.weights.device}; the session's table is "
                    f"{tuple(table.shape)} on {table.device}")
        else:
            sim, ps = value, None
        if sim.ring.device != self.device:
            raise ValueError(f"state lies on {sim.ring.device}, the "
                             f"session on {self.device}")
        if sim.generator is not None \
                and sim.generator is not self._generator:
            self._generator.set_state(sim.generator.get_state())
        sim = sim._replace(generator=self._generator)
        self._state = sim if ps is None else (sim, ps)
        self._overflow_seen = int(sim.overflow.item())

    @property
    def suspended(self) -> bool:
        """True while the state is released (see :meth:`suspend`)."""
        return self._state is None

    def _require_state(self, what: str) -> None:
        if self._state is None:
            raise RuntimeError(
                f"cannot {what}: this session is suspended (its device "
                f"state was released by suspend()); call resume(directory)"
                f" first")

    @property
    def timers(self):
        """Per-phase cumulative seconds (instrumented backend only)."""
        return getattr(self.backend, "timers", {})

    def _steps(self, t_ms: float) -> int:
        return int(round(t_ms / self.sim_config.dt))

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _wait(self) -> None:
        """A run's synchronise: a ``session.wait`` span, counted as
        ``session.syncs``."""
        trace.count("session.syncs")
        with trace.span("session.wait"):
            self._sync()

    @staticmethod
    def _host(x: torch.Tensor) -> np.ndarray:
        """A run's read-back of ``x``, counted as ``session.syncs``."""
        trace.count("session.syncs")
        return x.cpu().numpy()

    def _resolve(self, probes) -> tuple:
        if probes is None:
            return self.probes
        pr = probes_mod.resolve(probes)
        self._check_probes(pr)
        return pr

    def _check_probes(self, probes) -> None:
        for p in probes:
            if not self.backend.supports_probe(p):
                raise NotImplementedError(
                    f"backend {self.backend.name!r} does not support probe "
                    f"{p.name!r}")

    # -- warmup / presim ----------------------------------------------------

    def warmup(self, t_ms: float, probes: Optional[Sequence] = None,
               include_presim: bool = True) -> None:
        """Ready a run of ``t_ms`` (and the pending presim's) so that a
        following ``run`` of that length measures execution only: on a card
        the fused backend captures its graphs, the instrumented one loads
        its kernels.  The session state is untouched."""
        self._require_state("warmup")
        self._ensure_built()
        pr = self._resolve(probes)
        self.backend.warmup(self._state, self._steps(t_ms), pr)
        if include_presim and self.t_presim > 0 and not self._presim_done:
            self.backend.warmup(self._state, self._steps(self.t_presim), ())
        self._sync()

    def step_census(self, n_steps: int = 200) -> None:
        """Run ``n_steps`` steady steps eagerly, with the session's probes,
        on a copy of its state and generator (the backend's
        ``step_census``): each a ``step`` span with its ``step.drive``,
        ``step.deliver``, ``step.stdp`` and ``step.probe`` spans, so that a
        profiler around it splits the step's device time by span.  The
        session's state is not touched."""
        self._require_state("step_census")
        self._ensure_built()
        self.backend.step_census(self._state, n_steps, self.probes)

    def _maybe_presim(self, presim_ms: Optional[float]) -> None:
        t = self.t_presim if presim_ms is None else float(presim_ms)
        if self._presim_done or t <= 0:
            return
        self._state, _ = self.backend.run(self._state, self._steps(t), ())
        self._wait()
        self._presim_done = True
        self._check_overflow()

    # -- runs ---------------------------------------------------------------

    def run(self, t_ms: float, *, presim_ms: Optional[float] = None,
            probes: Optional[Sequence] = None) -> RunResult:
        """Simulate ``t_ms`` of model time.  The presim transient
        (``config.t_presim`` unless ``presim_ms`` is given) runs untimed and
        unrecorded once per session first, as in the paper's protocol.
        The run is a ``session.run`` span (``repro_torch.perf.trace``)."""
        with trace.span("session.run"):
            self._require_state("run")
            self._ensure_built()
            pr = self._resolve(probes)
            self._maybe_presim(presim_ms)
            n_steps = self._steps(t_ms)
            timers0 = dict(self.timers)
            self._wait()
            t0 = time.perf_counter()
            state, data = self.backend.run(self._state, n_steps, pr,
                                           stream=self._stream_seeds(pr))
            self._wait()
            wall = time.perf_counter() - t0
            timers = {k: v - timers0.get(k, 0.0)
                      for k, v in self.timers.items()}
            with trace.span("session.readback"):
                return self._advance(state, data, n_steps, pr, wall, timers)

    def _stream_seeds(self, probes) -> dict:
        """The stream probes' carries this session has threaded so far (a
        backend starts a missing one from ``probe.init``)."""
        _, stream_probes = probes_mod.split_probes(probes)
        return {p.name: self._stream_state.get(p.name)
                for p in stream_probes}

    def _advance(self, state, data: dict, n_steps: int, probes,
                 wall: float, timers: Optional[dict] = None) -> RunResult:
        """Take a run's state and data (``Backend.run``'s) into the
        session: its counters and stream carries advanced, the overflow
        surfaced; returns the run's result."""
        _, stream_probes = probes_mod.split_probes(probes)
        self._state = state
        self._steps_done += n_steps
        self._t_model_ms += n_steps * self.sim_config.dt
        streams = {}
        for p in stream_probes:
            carry = data.pop(p.name)
            self._stream_state[p.name] = carry
            streams[p.name] = {"carry": tree_map(self._host, carry),
                               "meta": dict(p.meta)}
        overflow = self._check_overflow()
        data = {k: self._host(v) for k, v in data.items()}
        return RunResult(
            data=data, t_model_ms=n_steps * self.sim_config.dt,
            n_steps=n_steps, dt=self.sim_config.dt, wall_s=wall,
            overflow=overflow, device=self._device_name(),
            timers=timers or {}, streams=streams,
            _connectome=self.connectome)

    def run_chunked(self, t_ms: float, chunk_ms: float, *,
                    presim_ms: Optional[float] = None,
                    probes: Optional[Sequence] = None,
                    callback: Optional[Callable[[int, RunResult],
                                                None]] = None,
                    checkpoint_dir: Optional[str] = None,
                    checkpoint_every: int = 1) -> RunResult:
        """``run`` split into chunks of ``chunk_ms``: the same result as one
        ``run(t_ms)`` of the session (the state threads through the chunk
        boundaries), with the probes' data on the host after each chunk and
        ``callback(i, chunk_result)`` after chunk ``i``.  Chunks 2..N of a
        length already run must capture nothing: a new capture raises.
        ``checkpoint_dir`` saves the session there every
        ``checkpoint_every`` chunks (:meth:`save`).  A
        ``DeliveryOverflowError`` under ``strict_delivery`` carries the
        completed chunks as its ``partial``."""
        if chunk_ms <= 0:
            raise ValueError("chunk_ms must be positive")
        if checkpoint_every < 1:
            raise ValueError(f"checkpoint_every must be >= 1, got "
                             f"{checkpoint_every}")
        self._require_state("run_chunked")
        self._ensure_built()
        self._maybe_presim(presim_ms)
        total = self._steps(t_ms)
        per_chunk = max(1, self._steps(chunk_ms))
        chunks, seen = [], set()
        done = 0
        while done < total:
            n = min(per_chunk, total - done)
            # chunks 2..N of one length replay the first's graphs
            guard = (RecompileGuard(0, caches=self.backend.caches(),
                                    what=f"run_chunked: chunk "
                                         f"{len(chunks) + 1} ({n} steps, a "
                                         f"length already run)")
                     if n in seen else contextlib.nullcontext())
            try:
                with guard:
                    res = self.run(n * self.sim_config.dt, presim_ms=0,
                                   probes=probes)
            except Exception as e:
                from repro_torch.core.delivery import DeliveryOverflowError
                if isinstance(e, DeliveryOverflowError) and chunks:
                    e.partial = results_mod.concat(chunks)
                raise
            seen.add(n)
            chunks.append(res)
            done += n
            if callback is not None:
                callback(len(chunks), res)
            if checkpoint_dir is not None \
                    and len(chunks) % checkpoint_every == 0:
                self.save(checkpoint_dir)
        return results_mod.concat(chunks)

    def _device_name(self) -> str:
        if self.device.type == "cuda":
            return torch.cuda.get_device_name(self.device)
        return str(self.device)

    def _check_overflow(self) -> int:
        """Read the device overflow counter once; warn on any new overflow,
        raise under ``SimConfig.strict_delivery``."""
        overflow = self.backend.overflow(self._state)
        if overflow > self._overflow_seen:
            dropped = overflow - self._overflow_seen
            self._overflow_seen = overflow
            self._report_overflow(f"{dropped} spike(s) this run ({overflow} "
                                  f"cumulative)")
        return overflow

    def _report_overflow(self, what: str) -> None:
        """Raise under ``strict_delivery``, else warn, that delivery
        dropped ``what``."""
        msg = (f"spike delivery dropped {what}: the per-step spike_budget="
               f"{self.sim_config.spike_budget} of strategy "
               f"{self.sim_config.strategy!r} was exceeded -- raise "
               f"spike_budget (or leave it None for the rate-derived auto "
               f"value)")
        if self.sim_config.strict_delivery:
            from repro_torch.core.delivery import DeliveryOverflowError
            raise DeliveryOverflowError(msg)
        warnings.warn(msg, stacklevel=4)

    # -- multi-trial batches ------------------------------------------------

    def _trial_seeds(self, n_trials: Optional[int], seeds) -> list:
        if seeds is None:
            if n_trials is None:
                raise ValueError("pass n_trials or explicit seeds")
            base = self._seed
            return [base + i for i in range(int(n_trials))]
        seeds = [int(s) for s in seeds]
        if n_trials is not None and len(seeds) != int(n_trials):
            raise ValueError(f"{len(seeds)} seeds for n_trials={n_trials}")
        return seeds

    def warmup_batch(self, t_ms: float, n_trials: int,
                     probes: Optional[Sequence] = None,
                     include_presim: bool = True) -> None:
        """Ready a ``run_batch`` of this shape, so that it measures
        execution only: the trials share one set of graphs, which this
        captures (the session state is untouched)."""
        self._require_state("warmup_batch")
        self._ensure_built()
        pr = self._resolve(probes)
        states = [self._state]
        if include_presim and self.t_presim > 0:
            self.backend.warmup_batch(states, self._steps(self.t_presim), ())
        self.backend.warmup_batch(states, self._steps(t_ms), pr)
        self._sync()

    def run_batch(self, t_ms: float, n_trials: Optional[int] = None, *,
                  seeds: Optional[Sequence[int]] = None,
                  presim_ms: Optional[float] = None,
                  probes: Optional[Sequence] = None) -> BatchResult:
        """``n_trials`` independent trials of ``t_ms`` each
        (``repro/api/simulator.py:312-392``).

        Trial ``i`` starts from a fresh state drawn from ``seeds[i]``
        (default ``config.seed + i``) and equals a fresh ``reset(seeds[i]);
        run(t_ms)``, its presim (untimed) included.  The trials run one
        after the other over the backend's graphs (``vmapped`` is False and
        each trial's wall time is its own); no trial after the first
        captures.  Stream carries are per trial; ``validate()`` pools them.
        Overflow across the batch is surfaced as a run's is.  The session's
        own state is untouched."""
        self._ensure_built()
        seeds = self._trial_seeds(n_trials, seeds)
        pr = self._resolve(probes)
        step_probes, stream_probes = probes_mod.split_probes(pr)
        states = []
        for s in seeds:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(s)
            states.append(self.backend.init(gen))
        t_pre = self.t_presim if presim_ms is None else float(presim_ms)
        if t_pre > 0:
            states, _, _ = self.backend.run_batch(states, self._steps(t_pre),
                                                  ())
        n_steps = self._steps(t_ms)
        # a warm batch that captures is a fault, not a warmup
        guard = (RecompileGuard(0, caches=self.backend.caches(),
                                what=f"run_batch({len(seeds)} trials x "
                                     f"{n_steps} steps) after warmup_batch")
                 if self.backend.is_warm_batch(len(seeds), n_steps, pr)
                 else contextlib.nullcontext())
        self._sync()
        with guard:
            t0 = time.perf_counter()
            states, datas, walls = self.backend.run_batch(states, n_steps,
                                                          pr)
            self._sync()
            wall = time.perf_counter() - t0
        host = lambda x: x.cpu().numpy()
        trials = []
        for state, data, trial_wall in zip(states, datas, walls):
            streams = {p.name: {"carry": tree_map(host, data.pop(p.name)),
                                "meta": dict(p.meta)}
                       for p in stream_probes}
            trials.append(RunResult(
                data={p.name: host(data[p.name]) for p in step_probes},
                t_model_ms=n_steps * self.sim_config.dt, n_steps=n_steps,
                dt=self.sim_config.dt, wall_s=trial_wall,
                overflow=self.backend.overflow(state),
                device=self._device_name(), streams=streams,
                _connectome=self.connectome))
        overflow = sum(r.overflow for r in trials)
        if overflow > 0:
            self._report_overflow(f"{overflow} spike(s) across "
                                  f"{len(trials)} trial(s)")
        return BatchResult(trials=trials, wall_s=wall, vmapped=False,
                           seeds=list(seeds))

    # -- checkpoints --------------------------------------------------------

    def _package(self, state=None) -> dict:
        """What a checkpoint holds: ``state`` (the session's when None) and
        the session's counters."""
        return {
            "state": self._state if state is None else state,
            "presim_done": np.asarray(int(self._presim_done), np.int64),
            "steps_done": np.asarray(self._steps_done, np.int64),
            "t_model_ms": np.asarray(self._t_model_ms, np.float64),
        }

    def save(self, directory: str, keep: int = 3) -> str:
        """Write the session (its state, generator and counters) to
        ``directory/step_<steps done>`` for :meth:`restore`; returns the
        path.  On the sharded backend every rank calls it: the checkpoint
        holds the world's global state, which rank 0 writes."""
        self._require_state("save")
        from repro_torch.checkpoint import checkpointer
        pkg = self._package(self.backend.checkpoint_state(self._state))
        return self.backend.publish(
            lambda: checkpointer.save(pkg, directory, step=self._steps_done,
                                      keep=keep),
            checkpointer.step_path(directory, self._steps_done))

    def suspend(self, directory: str, keep: int = 3) -> str:
        """Save the session, then release its state: a suspended session
        holds no device tensor of its own.  The backend's tables, graphs
        and static buffers stay, warm for every session on it (where the
        session's state was the one resident in the buffers, the buffers
        keep their memory).  :meth:`resume` undoes it exactly.  Returns
        the checkpoint's path."""
        path = self.save(directory, keep=keep)
        self._state = None
        return path

    def resume(self, directory: str, step: Optional[int] = None) -> None:
        """Undo :meth:`suspend`: a fresh state takes the checkpoint's
        values.  On a live session the same as :meth:`restore`."""
        self._ensure_built()
        if self._state is None:
            self._state = self.backend.init(self._generator)
        self.restore(directory, step=step)

    def restore(self, directory: str, step: Optional[int] = None) -> None:
        """Go back to a saved session: its state and generator are copied
        into the session's own tensors (on a graphed backend, into the
        static buffers if the session is resident; nothing is captured),
        its counters and presim flag taken.  The config and backend must
        be the saving session's: a schema, structure or shape that differs
        raises ``CheckpointMismatchError`` naming the leaf.  The stream
        probes' statistics restart empty here (they are not saved): they
        then cover what runs after the restore, never a stale window.  On
        the sharded backend every rank calls it and takes its shard of the
        world's state."""
        self._require_state("restore (use resume() on a suspended session)")
        self._ensure_built()
        from repro_torch.checkpoint import checkpointer
        pkg = checkpointer.restore(
            directory,
            self._package(self.backend.checkpoint_template(self._state)),
            step=step)
        self._generator.set_state(
            self.backend.restore_state(self._state, pkg["state"]))
        self._presim_done = bool(int(pkg["presim_done"]))
        self._steps_done = int(pkg["steps_done"])
        self._t_model_ms = float(pkg["t_model_ms"])
        self._overflow_seen = self.backend.overflow(self._state)
        self._stream_state = {}
