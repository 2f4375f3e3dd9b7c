"""The engine backends behind the port's ``Simulator``.

A backend owns the device tables and speaks the reference's protocol
(``repro/api/backends.py:64-213``)::

    build(connectome, sim_config, device)     # host tables -> device
    init(generator) -> state                  # fresh dynamical state
    warmup(state, n_steps, probes)            # ready a run; state untouched
    run(state, n_steps, probes, stream=None) -> (state', data)

``data`` maps each per-step probe's name to a ``[n_steps, ...]`` tensor
and each stream probe's name to its carry after the run; ``stream`` seeds
the stream carries (``{name: carry}``; missing ones start from
``probe.init``).  ``run_batch`` runs a list of independent trial states
one after the other over the same graphs (``repro/api/backends.py:89-160``;
a batch axis inside K3/K4 would be a kernel of its own).  ``built_for``
tells a ``Simulator`` that a backend it is handed is already built for its
network, so that sessions share the tables and the captured graphs.  Two
engines (``make_backend``):

* ``fused`` -- the production loop, static or with a plasticity rule.  On
  CPU tensors its steps run eagerly, one after the other.  On a card the
  loop is captured into CUDA graphs, the counterpart of the reference's
  jitted ``lax.scan`` (``:216-227``): the host launches one graph per
  ``graph_steps`` steps instead of a dozen ops per step.  There is no
  fallback: a capture that fails raises.
* ``instrumented`` -- the eager phase-split loop with per-phase wall timers
  (``update``, ``deliver``, ``plasticity`` in a plastic session, and
  ``record``), each phase synchronised, as the reference's
  (``:512-637``).  It is the port's eager reference on the card.  Unlike
  the reference's, it also runs a plasticity rule (the split plastic
  loop), so that the graphed plastic loop has an eager twin to be held to.
* ``sharded`` -- NEST's distribution scheme (``core/distributed``): each
  rank of a ``torch.distributed`` world (``launch/mesh``; a world of one
  without a process group) owns a slice of the neurons, their state and
  their incoming synapses, and the step all-gathers the spike registry
  between update and delivery (``:638-776``).  It is ``fused``'s graphed
  loop with that step swapped in: captured in CUDA graphs on a card, the
  group's all-gather inside the graph, eager on the CPU.

The steps.  With a resolved policy whose ``step == "fused"`` a step is one
launch of K3 in the rotated order (deliver step ``t - 1``'s spikes, then
integrate step ``t``), and an epilogue after the last step delivers its
spikes (``:381-404``); otherwise a step is ``update_phase`` +
``deliver_phase`` (``:405-417``).  Both leave the same state.  With a
plasticity rule the state is the pair ``(SimState, PlasticState)``.  The
fused plastic step (``pair_stdp`` only, ``:426-482``) is K4 then
``stdp_update``'s potentiation and clip, and the epilogue delivers the
last spikes through the live table and runs their whole STDP step; the
split plastic step (``:483-500``) is update, delivery through the live
table and a whole STDP step.  Each STDP update works on the ids its
step's delivery compacted.  Each run clips the whole table once, in its
first STDP update, and then only what a step touched.  Two points where
the reference's fused loop differs from its split loop are kept to the
split loop here: a run's first iteration delivers no spikes, so it leaves
the traces as they are, and the whole-table clip follows the first
spikes' depression and potentiation.  So a run's first steps differ from
the rest: the fused plastic loop's first two, the split plastic loop's
first one (``head`` steps).  The ring and the plastic weights are
updated in place.

The graphs (``FusedBackend`` on a card).  Every graph reads and writes one
set of static buffers, the backend's (V, the currents, refrac, ring, ``t``,
overflow, the rotated loop's previous spikes; in a plastic session the
traces and the live table), and draws from the backend's own generator.
The buffers hold one state at a time, the *resident* one, whose tensors
are aliases of the buffers (``Tensor.set_``): a run of the resident state
copies nothing, and replays chain.  A run of another state first gives the
resident state's live tensors storage of their own (a copy, once), then
copies the new state into the buffers and makes its tensors the aliases.
So several sessions share one backend, its tables and its graphs, and
each session's state stays its own; one session pays no copy.  Runs on
one backend must not overlap in time (one thread at a time).  The
session's generator state is copied into the backend's before the
replays and back after them (16 bytes).  Per key
``(n_steps, probes, graph_steps)`` the
:class:`~repro_torch.api.graph_cache.GraphCache` holds a head graph of the
run's first ``head`` steps, a body graph of ``graph_steps`` steady steps,
replayed ``(n_steps - head) // graph_steps`` times, and a remainder graph;
each copies its last step's state back into the static buffers and writes
its probes' rows into the key's ``[n_steps, ...]`` outputs at a row counter
on the device.  Stream carries are static buffers of the key, copied in
before the replays and out after.  The epilogue runs after the last replay.
The backend's generator is registered with every graph, so each replay
draws the Poisson counts the eager loop would draw next.  Before its first
capture the backend runs each kind of step once eagerly on a copy of the
state (building the kernels, their workspaces and argument packs), and
before each capture it evaluates the probes once on the static state, so
that nothing is first built inside a capture.  A replay adds the launches
its graph holds to ``kernels._build.launches``, and the counts its capture
made to ``perf.trace``'s counters, as the captured steps would have.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import time
import weakref
from typing import Any, Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import convert
from repro_torch.analysis.sanitize import RecompileGuard, checked_run
from repro_torch.api.graph_cache import GraphCache
from repro_torch.api.probes import ProbeContext, StreamProbe, split_probes
from repro_torch.core import delivery as dlv
from repro_torch.core import distributed as DD
from repro_torch.core import plasticity as PL
from repro_torch.core import stimulus as stim
from repro_torch.core.connectivity import Connectome
from repro_torch.core.engine import (SimConfig, SimState, deliver_phase,
                                     force_split_step,
                                     fused_plastic_update_phase,
                                     fused_update_phase, init_state,
                                     prepare_network, resolve_sim_config,
                                     update_phase)
from repro_torch.core.neuron import Propagators
from repro_torch.core.params import NeuronParams
from repro_torch.kernels import _build
from repro_torch.launch import mesh
from repro_torch.perf import trace

#: steps in a body graph: replays of fewer steps pay more launches, longer
#: bodies more capture time and memory, for nothing (PERF.md §6)
GRAPH_STEPS = 100

#: the split loop's phases (the instrumented loop's timer keys) and the
#: step spans they open (``repro_torch.perf.trace``)
PHASE_SPANS = {"update": "step.update", "deliver": "step.deliver",
               "plasticity": "step.stdp", "record": "step.probe"}


def _phase_span(phase: str):
    """``phase``'s step span: the loops' ``phase`` unless the instrumented
    loop times its phases."""
    return trace.span(PHASE_SPANS[phase])


class Carry(NamedTuple):
    """What one step hands the next."""
    sim: SimState
    ps: Any                             # PlasticState, plastic runs only
    spk_prev: Optional[torch.Tensor]    # the rotated loop's last spikes
    streams: tuple                      # stream probes' carries


def tree_map(fn, x):
    """``fn`` on every tensor of a NamedTuple / tuple / list / dict tree;
    anything else (None, a generator) kept as it is."""
    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(tree_map(fn, v) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(tree_map(fn, v) for v in x)
    if isinstance(x, dict):
        return {k: tree_map(fn, v) for k, v in x.items()}
    return x


def _leaves(x) -> list:
    out = []
    tree_map(out.append, x)
    return out


def _alias(x: torch.Tensor) -> torch.Tensor:
    """A new tensor object on ``x``'s storage."""
    return x.new_empty(0).set_(x)


def _weak_leaves(x) -> tuple:
    return tuple(weakref.ref(leaf) for leaf in _leaves(x))


def copy_into(dst, src) -> None:
    """Copy every tensor of ``src`` into its place in ``dst`` (the same
    tree), skipping the ones that are the same tensor."""
    for a, b in zip(_leaves(dst), _leaves(src), strict=True):
        if a is not b:
            a.copy_(b)


def _clone_generator(gen: Optional[torch.Generator]):
    if gen is None:
        return None
    twin = torch.Generator(device=gen.device)
    twin.set_state(gen.get_state())
    return twin


def _sanitized(run):
    """A backend's ``run`` under the checks of an open
    ``repro_torch.analysis.sanitize()`` (just the run when none is)."""
    @functools.wraps(run)
    def checked(self, state, n_steps, probes, stream=None):
        return checked_run(self, run, state, n_steps, probes, stream)
    return checked


class Backend:
    """Protocol base; concrete backends override build / init / run."""

    name: str = "abstract"
    #: builds so far: a session that sees another count than at its last
    #: look checks ``built_for`` again (another session may have rebuilt)
    builds: int = 0

    def build(self, c: Connectome, cfg: SimConfig, device) -> None:
        raise NotImplementedError

    def init(self, generator: torch.Generator) -> Any:
        raise NotImplementedError

    def run(self, state: Any, n_steps: int, probes: Sequence,
            stream: Optional[Dict[str, Any]] = None
            ) -> Tuple[Any, Dict[str, Any]]:
        raise NotImplementedError

    def warmup(self, state: Any, n_steps: int, probes: Sequence) -> None:
        """Ready a ``run`` of this length; must not change ``state``."""

    def run_batch(self, states: list, n_steps: int, probes: Sequence,
                  stream: Optional[list] = None
                  ) -> Tuple[list, list, list]:
        """Advance independent trial states, one ``run`` after the other:
        returns the states, each trial's ``data`` and each trial's wall
        seconds (``stream``, when given, holds each trial's stream seeds).
        A trial after the first that captures a graph raises: trials of
        one length share their graphs."""
        probes = tuple(probes)
        out_states, datas, walls = [], [], []
        for i, state in enumerate(states):
            guard = contextlib.nullcontext() if i == 0 else RecompileGuard(
                0, caches=self.caches(),
                what=f"run_batch: trial {i} ({n_steps} steps; trials of "
                     f"one length share the first's graphs)")
            with guard:
                t0 = time.perf_counter()
                state, data = self.run(state, n_steps, probes,
                                       stream=None if stream is None
                                       else stream[i])
                self._sync()
                walls.append(time.perf_counter() - t0)
            out_states.append(state)
            datas.append(data)
        return out_states, datas, walls

    def warmup_batch(self, states: list, n_steps: int,
                     probes: Sequence) -> None:
        """Ready a ``run_batch`` of this length: the trials run one after
        the other, so one trial's warmup readies them all."""
        self.warmup(states[0], n_steps, tuple(probes))

    def is_warm_batch(self, n_trials: int, n_steps: int,
                      probes: Sequence) -> bool:
        """True when a ``run_batch`` of this shape would capture nothing;
        the ``Simulator`` then raises if it does."""
        return False

    def built_for(self, c: Connectome, cfg: SimConfig, device) -> bool:
        """True when ``build(c, cfg, device)`` would give the current build
        (the same connectome object and resolved config): a ``Simulator``
        handed this backend then skips the build and shares its tables and
        graphs (``repro/api/backends.py:172-183``)."""
        if getattr(self, "c", None) is not c \
                or self.device != torch.device(device):
            return False
        kind = None if self.plasticity is None else self.plasticity.kind
        try:
            return self.cfg == self._normalize_cfg(resolve_sim_config(
                cfg, c, self.device, plastic=kind))
        except (ValueError, TypeError, RuntimeError):
            # a config that does not resolve, or a stimulus holding
            # tensors that do not compare: build, which raises or rebuilds
            return False

    def supports_probe(self, probe) -> bool:
        return True

    def _normalize_cfg(self, cfg: SimConfig) -> SimConfig:
        """Backend-specific fixup of the resolved config (identity here)."""
        return cfg

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def caches(self) -> Tuple[GraphCache, ...]:
        """Every :class:`GraphCache` this backend owns: what
        ``Simulator.run_chunked`` watches for captures."""
        return tuple(v for v in vars(self).values()
                     if isinstance(v, GraphCache))

    def overflow(self, state: Any) -> int:
        """Cumulative spike-budget overflow of ``state`` (one host read,
        counted as ``session.syncs``); a plastic session's pair holds it in
        its ``SimState``."""
        sim = state if hasattr(state, "overflow") else state[0]
        trace.count("session.syncs")
        return int(sim.overflow.item())

    # -- checkpoints (``Simulator.save`` / ``restore``) ---------------------

    def checkpoint_state(self, state: Any) -> Any:
        """The tree a checkpoint holds for ``state``: the state itself."""
        return state

    def checkpoint_template(self, state: Any) -> Any:
        """The tree a checkpoint is checked against and read into: the
        state's own structure."""
        return state

    def restore_state(self, state: Any, saved: Any) -> torch.Tensor:
        """Copy ``saved`` (a checkpoint read in ``checkpoint_template``'s
        structure) into ``state``'s tensors, in place; returns the
        generator state the session goes on from."""
        copy_into(state, saved)
        sim = saved if hasattr(saved, "overflow") else saved[0]
        return sim.generator.get_state()

    def publish(self, write: Callable[[], str], path: str) -> str:
        """Run ``write``, a checkpoint's write, which returns ``path``."""
        return write()


class _LoopBackend(Backend):
    """The tables, the steps and the probes' record, shared by both
    engines."""

    def __init__(self, plasticity=None):
        self.plasticity = None if plasticity is None \
            else PL.resolve_rule(plasticity)
        self.timers: Dict[str, float] = {}

    def build(self, c: Connectome, cfg: SimConfig, device,
              neuron: Optional[NeuronParams] = None) -> None:
        """Build the tables on ``device``; ``neuron`` (the default
        parameters when None) only for the deprecated ``PhaseRunner``."""
        self.builds += 1
        self.device = torch.device(device)
        kind = None if self.plasticity is None else self.plasticity.kind
        cfg = self._normalize_cfg(resolve_sim_config(cfg, c, self.device,
                                                     plastic=kind))
        # checked before the tables are built (the dense one is O(N^2))
        if self.plasticity is not None \
                and not dlv.get_strategy(cfg.strategy).supports_live_weights:
            raise ValueError(
                f"plasticity needs a delivery strategy with a live-weight "
                f"path (live_tables); {cfg.strategy!r} has none -- use "
                f"'event' or 'ell'")
        self.c, self.cfg = c, cfg
        neuron = neuron or NeuronParams()
        self.prop = Propagators.make(neuron, cfg.dt)
        with trace.span("session.build.tables"):
            self.net = prepare_network(c, cfg, self.device)
        self.n_pops = len(c.pop_sizes)
        self.drive = stim.compile_drive(cfg.stimulus, c, cfg, neuron,
                                        self.device)
        self.strategy = dlv.get_strategy(cfg.strategy)
        self.bound = None
        if self.plasticity is not None:
            with trace.span("session.build.plastic"):
                self.bound = self.plasticity.bind(c, cfg, self.net.tables)
        self._step = self._fused_step if self.fused else self._split_step
        # the steps that differ from the steady one at the start of a run
        self.head = 0 if self.bound is None else (2 if self.fused else 1)
        self.n_registry = c.n_total        # a step's spike vector

    @property
    def fused(self) -> bool:
        return self.cfg.kernels.step == "fused"

    def init(self, generator: torch.Generator):
        """A fresh ``SimState``, paired with a fresh ``PlasticState`` (the
        connectome's weights, cloned) in a plastic session."""
        sim = init_state(self.net, self.c.d_max_bins, generator,
                         self.cfg.state_dtype)
        return sim if self.bound is None else (sim, self.bound.init())

    # -- the steps ----------------------------------------------------------

    def _deliver_live(self, sim: SimState, ps, spiked, t):
        """Deliver through the live table; returns (sim', ids), the
        delivery's compacted ids being the STDP update's rows."""
        live = self.strategy.live_tables(self.net.tables, ps.weights)
        ring, ids, ovf = self.strategy.deliver_ids(
            sim.ring, live, spiked, t, self.c.n_exc, self.cfg)
        return sim._replace(ring=ring, overflow=sim.overflow + ovf), ids

    def _fused_step(self, carry: Carry, i: int, phase=None):
        """Step ``i`` of a run (any ``i >= head`` is the steady step) of the
        rotated loop: K3, or K4 and the potentiation of step ``i - 1``'s
        spikes (the whole-table clip at ``i == 1``)."""
        c, sim, ps = self.c, carry.sim, carry.ps
        if ps is None:
            sim, spiked = fused_update_phase(
                sim, self.net, self.prop, self.cfg, c.w_ext, c.n_total,
                c.n_exc, carry.spk_prev, self.drive)
            return carry._replace(sim=sim, spk_prev=spiked), spiked
        x_pre = ps.x_pre                        # before the bump K4 makes
        sim, ps, spiked, ids = fused_plastic_update_phase(
            sim, ps, self.net, self.prop, self.cfg, c.w_ext, c.n_total,
            c.n_exc, carry.spk_prev, self.drive, self.bound, trace=i > 0)
        if i > 0:                               # step i - 1's spikes
            with trace.span("step.stdp"):
                PL.stdp_pot_clip(ps.weights, x_pre, ids, self.bound.tables,
                                 self.bound.coef, clip_all=i == 1,
                                 kernel=self.bound.kernel)
        return carry._replace(sim=sim, ps=ps, spk_prev=spiked), spiked

    def _split_step(self, carry: Carry, i: int, phase=None):
        """Step ``i`` of a run of the split loop: update, delivery and (in
        a plastic session) the whole STDP step, the whole-table clip at
        ``i == 0``.  ``phase(name)`` opens each phase (its step span by
        default)."""
        c, sim, ps = self.c, carry.sim, carry.ps
        phase = phase or _phase_span
        with phase("update"):
            sim, spiked = update_phase(sim, self.net, self.prop, self.cfg,
                                       c.w_ext, c.n_total, self.drive)
        if ps is None:
            with phase("deliver"):
                sim = deliver_phase(sim, self.net, self.cfg, spiked,
                                    c.n_exc)
        else:
            with phase("deliver"):
                sim, ids = self._deliver_live(sim, ps, spiked, sim.t)
                sim = sim._replace(t=sim.t + 1)
            with phase("plasticity"):
                ps = self.bound.step(ps, spiked, ids, clip_all=i == 0)
        return carry._replace(sim=sim, ps=ps), spiked

    def _epilogue(self, carry: Carry, n_steps: int) -> Carry:
        """After the rotated loop: deliver its last spikes at their phase
        ``t - 1`` (and run their whole STDP step)."""
        if not (self.fused and n_steps):
            return carry
        sim, spk = carry.sim, carry.spk_prev
        if carry.ps is None:
            ring, ovf = self.strategy.deliver(sim.ring, self.net.tables, spk,
                                              sim.t - 1, self.c.n_exc,
                                              self.cfg)
            return carry._replace(sim=sim._replace(
                ring=ring, overflow=sim.overflow + ovf))
        sim, ids = self._deliver_live(sim, carry.ps, spk, sim.t - 1)
        ps = self.bound.step(carry.ps, spk, ids, clip_all=n_steps == 1)
        return carry._replace(sim=sim, ps=ps)

    def _record(self, carry: Carry, spiked, step_probes, stream_probes):
        """The probes' values for this step, and the stream carries
        advanced."""
        ctx = ProbeContext(carry.sim, spiked, self.net, self.n_pops,
                           carry.ps, None if carry.ps is None
                           else self.bound.plastic_mask,
                           self.cfg.kernels.kernels)
        streams = tuple(p.update(sc, ctx if p.needs == "ctx" else spiked)
                        for p, sc in zip(stream_probes, carry.streams))
        return carry._replace(streams=streams), tuple(p(ctx)
                                                      for p in step_probes)

    def _segment(self, carry: Carry, first: int, length: int, step_probes,
                 stream_probes, phase=None):
        """Steps ``first .. first + length - 1`` of a run (each past the
        head the steady one), recorded: returns the carry and each step
        probe's list of values.  Each step is a ``step`` span; ``phase``
        opens the split step's phases and the probes' (their step spans by
        default)."""
        phase = phase or _phase_span
        outs = [[] for _ in step_probes]
        for j in range(length):
            with trace.span("step"):
                carry, spiked = self._step(carry, min(first + j, self.head),
                                           phase)
                if step_probes or stream_probes:
                    with phase("record"):
                        carry, vals = self._record(carry, spiked,
                                                   step_probes,
                                                   stream_probes)
                    for buf, v in zip(outs, vals):
                        buf.append(v)
        return carry, outs

    def _data(self, carry: Carry, outs, step_probes, stream_probes) -> dict:
        """``run``'s data from an eager loop's carry and values."""
        data = {p.name: (torch.stack(buf) if buf else
                         torch.empty((0,), device=self.device))
                for p, buf in zip(step_probes, outs)}
        data.update(zip((p.name for p in stream_probes), carry.streams))
        return data

    # -- state in and out ---------------------------------------------------

    def _split_state(self, state):
        return (state, None) if self.bound is None else state

    def _state_of(self, carry: Carry):
        return carry.sim if self.bound is None else (carry.sim, carry.ps)

    def _carry(self, state, stream_probes, stream) -> Carry:
        """A run's first carry: ``state``, the rotated loop's zero spikes,
        the stream carries given or fresh."""
        sim, ps = self._split_state(state)
        spk = torch.zeros(self.c.n_total, dtype=torch.bool,
                          device=self.device) if self.fused else None
        return Carry(sim, ps, spk, self._stream_carries(stream_probes,
                                                        stream))

    def _stream_carries(self, stream_probes, stream) -> tuple:
        stream = stream or {}
        return tuple(stream[p.name] if stream.get(p.name) is not None
                     else p.init(self.device) for p in stream_probes)

    def _warm_eagerly(self, state) -> None:
        """Each kind of step once, then the epilogue, on a copy of ``state``
        and of its generator: builds and loads every kernel and its
        workspace and argument pack; the state is untouched."""
        sim, ps = self._split_state(tree_map(torch.clone, state))
        sim = sim._replace(generator=_clone_generator(sim.generator))
        carry = self._carry(sim if ps is None else (sim, ps), (), None)
        for i in range(self.head + 1):
            carry, _ = self._step(carry, i)
        self._epilogue(carry, self.head + 1)
        self._sync()

    def step_census(self, state, n_steps: int, probes: Sequence) -> None:
        """``n_steps`` steady steps, eagerly, with ``probes``, on a copy of
        ``state`` and of its generator (as ``_warm_eagerly``): each a
        ``step`` span, so that under a profiler every kernel falls under one
        innermost step span (the drive's and the probes' device time apart,
        which no graph replay gives).  The state is untouched."""
        sim, ps = self._split_state(tree_map(torch.clone, state))
        sim = sim._replace(generator=_clone_generator(sim.generator))
        step_probes, stream_probes = split_probes(tuple(probes))
        carry = self._carry(sim if ps is None else (sim, ps), stream_probes,
                            None)
        self._segment(carry, self.head, n_steps, step_probes, stream_probes)
        self._sync()


class _Graph:
    """One captured CUDA graph of ``fn``, which draws from ``generator``:
    the launches it holds by kernel, added to ``_build.launches`` at each
    replay (the capture itself launches nothing), and so the counts of
    ``perf.trace.count`` that its capture made."""

    #: the counts of ``perf.trace.count`` that the capture made, by name
    counts: Dict[str, int] = {}

    def __init__(self, fn: Callable[[], None], generator, pool):
        graph = torch.cuda.CUDAGraph()
        if generator is not None:
            if not hasattr(graph, "register_generator_state"):
                raise RuntimeError(
                    f"torch {torch.__version__} cannot register a "
                    f"generator with a CUDA graph: the graphed loop's "
                    f"Poisson draws would repeat at every replay")
            graph.register_generator_state(generator)
        before, tally = dict(_build.launches), trace.tally()
        # A graph that dies during the capture (a dropped session's, freed
        # by the cycle collector) is destroyed there, which voids the
        # capture: collect first, and not while capturing.
        gc.collect()
        gc_on = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=pool):
                fn()
        finally:
            if gc_on:
                gc.enable()
            captured = {k: _build.launches[k] - before[k] for k in before}
            _build.launches.update(before)
            counted = {k: v - tally.get(k, 0)
                       for k, v in trace.tally().items()
                       if v != tally.get(k, 0)}
            for k, v in counted.items():
                trace.count(k, -v)
        self.graph = graph
        # the function's closure holds tensors the graph reads (the rows'
        # offsets); their memory must not go back to the allocator
        self.fn = fn
        self.launches = {k: v for k, v in captured.items() if v}
        self.counts = counted

    def replay(self, times: int = 1) -> None:
        for _ in range(times):
            self.graph.replay()
        for k, v in self.launches.items():
            _build.launches[k] += v * times
        for k, v in self.counts.items():
            trace.count(k, v * times)

    @staticmethod
    def new_pool():
        """A memory pool for a backend's graphs: they never run at once,
        and none leaves a tensor of its pool alive for another."""
        return torch.cuda.graph_pool_handle()


@dataclasses.dataclass(eq=False)
class GraphSet:
    """What the graph cache holds for one key: the graphs with their
    replay counts, the probes' ``[n_steps, ...]`` outputs, the row counter
    they are written at, and the stream carries."""
    graphs: list                      # [(graph, times)]
    outs: list                        # per step probe, [n_steps, ...]
    row: torch.Tensor                 # 0-d int64: the next row to write
    streams: tuple                    # per stream probe, its carry

    def replay(self) -> None:
        for graph, times in self.graphs:
            graph.replay(times)


class FusedBackend(_LoopBackend):
    """The production loop, static or with a plasticity rule: eager on CPU
    tensors, captured in CUDA graphs on a card (the module's docstring).
    ``graph_steps`` is the body graph's length."""

    name = "fused"
    graph_type = _Graph

    def __init__(self, plasticity=None, graph_steps: int = GRAPH_STEPS):
        super().__init__(plasticity)
        if graph_steps < 1:
            raise ValueError(f"graph_steps must be >= 1, got {graph_steps}")
        self.graph_steps = int(graph_steps)
        self.graphs = GraphCache("fused.graphs")

    def build(self, c, cfg, device, neuron=None) -> None:
        """Build the tables; the graphs and the static buffers of an
        earlier build go (they read the old tables)."""
        super().build(c, cfg, device, neuron)
        self._reset_graphs()

    def _reset_graphs(self) -> None:
        self.graphs.clear()
        self._io: Optional[Carry] = None     # the static buffers
        self._resident: tuple = ()           # weakrefs: the resident state
        self._generator = torch.Generator(device=self.device)
        self._warm = False
        self._pool = None

    @property
    def graphed(self) -> bool:
        return self.device.type == "cuda"

    def _key(self, n_steps: int, probes) -> tuple:
        return (int(n_steps), tuple(probes), self.graph_steps)

    def is_warm_batch(self, n_trials, n_steps, probes) -> bool:
        return self.graphed and self._key(n_steps, probes) in self.graphs

    def warmup(self, state, n_steps, probes) -> None:
        """On a card: capture the graphs of a run of ``n_steps`` with
        ``probes`` (nothing runs on ``state``); on the CPU nothing."""
        if self.graphed:
            probes = tuple(probes)
            self.graphs.get_or_build(
                self._key(n_steps, probes),
                lambda: self._capture(state, n_steps, probes))

    @_sanitized
    def run(self, state, n_steps: int, probes: Sequence,
            stream: Optional[Dict[str, Any]] = None):
        probes = tuple(probes)
        if self.graphed:
            return self._run_graphed(state, n_steps, probes, stream)
        step_probes, stream_probes = split_probes(probes)
        carry, outs = self._segment(
            self._carry(state, stream_probes, stream), 0, n_steps,
            step_probes, stream_probes)
        carry = self._epilogue(carry, n_steps)
        return self._state_of(carry), self._data(carry, outs, step_probes,
                                                 stream_probes)

    # -- the graphs ----------------------------------------------------------

    def _static(self, state) -> Carry:
        """The static buffers.  The first are aliases of the first state
        asked for, which becomes the resident one (nothing is copied)."""
        if self._io is None:
            sim, ps = self._split_state(tree_map(_alias, state))
            spk = torch.zeros(self.c.n_total, dtype=torch.bool,
                              device=self.device) if self.fused else None
            self._io = Carry(sim._replace(generator=self._generator), ps,
                             spk, ())
            self._resident = _weak_leaves(state)
        return self._io

    def _load(self, state) -> Carry:
        """Make ``state`` the resident one (a copy unless it already is)
        and copy its generator's state into the backend's."""
        io = self._static(state)
        leaves = _leaves(state)
        if not (len(leaves) == len(self._resident)
                and all(r() is x for r, x in zip(self._resident, leaves))):
            bufs = _leaves((io.sim, io.ps))
            # the resident state's live tensors keep its values
            for ref, buf in zip(self._resident, bufs):
                x = ref()
                if x is not None and x.data_ptr() == buf.data_ptr():
                    x.set_(x.clone())
            for buf, x in zip(bufs, leaves, strict=True):
                buf.copy_(x)
                x.set_(buf)
            self._resident = _weak_leaves(state)
        gen = self._split_state(state)[0].generator
        if gen is not None:
            self._generator.set_state(gen.get_state())
        return io

    def _capture(self, state, n_steps: int, probes: tuple) -> GraphSet:
        io = self._static(state)
        if not self._warm:
            self._warm_eagerly(self._state_of(io))
            self._pool = self.graph_type.new_pool()
            self._warm = True
        step_probes, stream_probes = split_probes(probes)
        dev = self.device
        # every probe once, eagerly, on the static state: the outputs'
        # shapes, and whatever a probe builds at its first call
        spk0 = torch.zeros(self.n_registry, dtype=torch.bool, device=dev)
        carry0 = Carry(io.sim, io.ps, None,
                       tuple(p.init(dev) for p in stream_probes))
        _, vals = self._record(carry0, spk0, step_probes, stream_probes)
        entry = GraphSet(
            graphs=[], outs=[torch.empty((n_steps, *v.shape), dtype=v.dtype,
                                         device=dev) for v in vals],
            row=torch.zeros((), dtype=torch.int64, device=dev),
            streams=carry0.streams)
        head = min(self.head, n_steps)
        n_body, rem = divmod(n_steps - head, self.graph_steps)
        for first, length, times in ((0, head, 1),
                                     (self.head, self.graph_steps, n_body),
                                     (self.head, rem, 1)):
            if length and times:
                entry.graphs.append((self._graph(io, entry, first, length,
                                                 step_probes,
                                                 stream_probes), times))
        return entry

    def _graph(self, io: Carry, entry: GraphSet, first: int, length: int,
               step_probes, stream_probes) -> _Graph:
        """A graph of ``length`` steps from step ``first`` on: the static
        buffers in and out, the probes' rows at ``entry.row``."""
        rows = torch.arange(length, dtype=torch.int64, device=self.device)

        def segment():
            static = Carry(io.sim, io.ps, io.spk_prev, entry.streams)
            carry, outs = self._segment(static, first, length, step_probes,
                                        stream_probes)
            copy_into(static, carry)
            at = entry.row + rows
            for out, buf in zip(entry.outs, outs):
                out.index_copy_(0, at, torch.stack(buf))
            entry.row.add_(length)
        with trace.span("loop.capture"):
            return self.graph_type(segment, io.sim.generator, self._pool)

    def _run_graphed(self, state, n_steps, probes, stream):
        step_probes, stream_probes = split_probes(probes)
        entry = self.graphs.get_or_build(
            self._key(n_steps, probes),
            lambda: self._capture(state, n_steps, probes))
        with trace.span("loop.load"):
            io = self._load(state)
            copy_into(entry.streams,
                      self._stream_carries(stream_probes, stream))
            entry.row.zero_()
            if io.spk_prev is not None:
                io.spk_prev.zero_()
        with trace.span("loop.replay"):
            entry.replay()
        with trace.span("loop.epilogue"):
            carry = self._epilogue(io._replace(streams=()), n_steps)
        with trace.span("loop.outputs"):
            copy_into((io.sim, io.ps), (carry.sim, carry.ps))
            gen = self._split_state(state)[0].generator
            if gen is not None:
                gen.set_state(self._generator.get_state())
            data = {p.name: out.clone()
                    for p, out in zip(step_probes, entry.outs)}
            data.update((p.name, tree_map(torch.clone, sc))
                        for p, sc in zip(stream_probes, entry.streams))
        return state, data


class InstrumentedBackend(_LoopBackend):
    """The eager phase-split loop, each phase synchronised and timed: the
    paper's per-phase breakdown (Fig. 1b).  Cumulative seconds per phase
    accumulate in ``self.timers``: the sums of the phases' step spans
    (``PHASE_SPANS``), which time themselves here whether or not a trace
    records them."""

    name = "instrumented"

    def __init__(self, plasticity=None):
        super().__init__(plasticity)
        self._warmed = False

    def supports_probe(self, probe) -> bool:
        # the loop feeds stream probes the bare spike vector
        return not (isinstance(probe, StreamProbe)
                    and probe.needs != "spiked")

    def _normalize_cfg(self, cfg):
        return force_split_step(cfg)

    def build(self, c, cfg, device, neuron=None) -> None:
        super().build(c, cfg, device, neuron)
        self._warmed = False

    def warmup(self, state, n_steps, probes) -> None:
        """One step of each kind on a copy of ``state``: the kernels are
        built and loaded before the timers run."""
        if not self._warmed:
            self._warm_eagerly(state)
            self._warmed = True

    def _phases(self, timers: Dict[str, float]):
        """``phase(name)``: the phase's step span, timed, the card
        synchronised before it closes; its seconds are added to
        ``timers[name]``."""
        @contextlib.contextmanager
        def phase(name):
            with trace.span(PHASE_SPANS[name], timed=True) as s:
                yield
                self._sync()
            timers[name] = timers.get(name, 0.0) + s.seconds
        return phase

    @_sanitized
    def run(self, state, n_steps: int, probes: Sequence,
            stream: Optional[Dict[str, Any]] = None):
        step_probes, stream_probes = split_probes(tuple(probes))
        self.warmup(state, n_steps, probes)
        carry, outs = self._segment(
            self._carry(state, stream_probes, stream), 0, n_steps,
            step_probes, stream_probes, self._phases(self.timers))
        return self._state_of(carry), self._data(carry, outs, step_probes,
                                                 stream_probes)

    def step_timed(self, state, timers: Dict[str, float]):
        """One update + deliver cycle (and, in a plastic session, its STDP
        step), each phase's seconds added to ``timers``; returns
        ``(state', spiked)``.  The ``PhaseRunner`` shim's step
        (``repro/api/backends.py:556-570``)."""
        self.warmup(state, 1, ())
        carry, spiked = self._split_step(self._carry(state, (), None), 0,
                                         self._phases(timers))
        return self._state_of(carry), spiked


class ShardedBackend(FusedBackend):
    """NEST's distribution scheme (``repro/api/backends.py:638-776``): this
    rank's shard of the network, stepped by ``distributed.sharded_step``
    in ``FusedBackend``'s loop (graphed on a card, the process group's
    all-gather captured inside the graphs; eager on the CPU).

    The connectome is regrouped by target-owning rank through the
    strategy's ``localize`` (``event`` and ``ell``); a strategy without one
    (``dense``) is refused at build time, and so are a non-separable drive
    and plasticity.  The world is the default process group's
    (``launch/mesh.make_world``), or a world of one without one;
    ``n_devices`` larger than it raises.  The state is this rank's
    ``ShardedSimState``.  Probes: ``pop_counts``, ``total_counts`` and
    stream probes that take the spike vector, all fed the gathered
    registry, so every rank records the same values.

    Generators.  A world of one draws from the session's generator exactly
    as the fused backend's split step does (its initial V, then each step's
    drive), so the two give the same spikes.  In a world of more, every
    rank draws the world's initial V from the session's generator (the
    same V on every rank as in a world of one), then seeds that generator
    with ``distributed.rank_seed(seed, rank)``, ``seed`` being the
    generator's initial seed (the session's), and draws its slice's drive
    from it.

    Checkpoints hold the reference's global ``ShardedSimState``
    (``repro/core/distributed.py:116-124``): the neuron state ``[N_pad]``,
    the ring ``[D, 2, N_pad + n_dev]`` (rank r's block at columns
    ``r * (n_loc + 1)``), ``t``, one overflow per rank (each rank's counter
    is the global one), and, where the reference keeps one key per device,
    each rank's generator state as a row of ``[n_dev, S]`` uint8.  A save
    is collective: every rank all-gathers the shards (a world of one
    without a group copies), rank 0 writes, and every rank returns once
    the write is published.  A restore checks the manifest against the
    global shapes on every rank before any array is read, then each rank
    copies its slice and its generator row into its state.
    """

    name = "sharded"
    _SUPPORTED = frozenset({"pop_counts", "total_counts"})

    def __init__(self, n_devices: Optional[int] = None,
                 graph_steps: int = GRAPH_STEPS):
        super().__init__(plasticity=None, graph_steps=graph_steps)
        self.n_devices = n_devices

    def _normalize_cfg(self, cfg):
        return force_split_step(cfg)

    def supports_probe(self, probe) -> bool:
        if isinstance(probe, StreamProbe):
            # fed the gathered spike vector only; ctx-reading stream probes
            # are the fused backend's
            return probe.needs == "spiked"
        return probe.name in self._SUPPORTED

    def build(self, c, cfg, device) -> None:
        """Localise the tables on ``device`` and keep this rank's block; no
        whole-network table is kept."""
        self.builds += 1
        self.device = torch.device(device)
        cfg = self._normalize_cfg(resolve_sim_config(cfg, c, self.device))
        strategy = dlv.get_strategy(cfg.strategy)
        if not strategy.supports_sharding:
            raise ValueError(
                f"sharded backend needs a delivery strategy with a shard "
                f"transform (ELL layout); {cfg.strategy!r} provides none -- "
                f"use strategy='event' or 'ell'")
        if cfg.state_dtype != torch.float32:
            raise ValueError(f"the sharded backend runs float32 state, got "
                             f"{cfg.state_dtype}")
        neuron = NeuronParams()
        drive = stim.compile_drive(cfg.stimulus, c, cfg, neuron, "cpu")
        if not drive.separable:
            raise NotImplementedError(
                "the sharded backend supports separable stimuli only "
                "(basis x time-gate form, as all built-ins are); run "
                "general custom stimuli on the fused backend")
        self.world = mesh.make_world(self.n_devices)
        self.n_dev, rank = self.world.size, self.world.rank
        tables, self.meta = strategy.localize(c, self.n_dev,
                                              device=self.device)
        shard = DD.shard_of(tables, self.meta, rank)
        del tables
        n_pad, n_loc = self.meta["n_pad"], self.meta["n_loc"]
        self.c, self.cfg = c, cfg
        self.prop = Propagators.make(neuron, cfg.dt)
        self.n_pops = len(c.pop_sizes)
        self.net = DD.shard_network(shard, DD.padded_pop_of(
            c.pop_of, n_pad, self.n_pops, self.device))
        self.drive = drive.shard(n_pad, rank * n_loc, (rank + 1) * n_loc,
                                 self.device)
        as_t = lambda a: torch.as_tensor(a, device=self.device)
        self._v0 = (as_t(c.v0_mean), as_t(c.v0_sd))
        self.strategy, self.bound, self.head = strategy, None, 0
        self.n_registry = n_pad
        self._step = self._sharded_step
        self._reset_graphs()

    def init(self, generator: torch.Generator) -> DD.ShardedSimState:
        """This rank's fresh shard: the world's V drawn as the fused
        backend draws it, padded with the reset potential; then, in a world
        of more than one, ``generator`` seeded for this rank."""
        mean, sd = self._v0
        V = mean + sd * torch.randn(mean.shape[0], generator=generator,
                                    device=self.device, dtype=torch.float32)
        if self.n_dev > 1:
            generator.manual_seed(DD.rank_seed(generator.initial_seed(),
                                               self.world.rank))
        return DD.init_shard(V, self.c.d_max_bins, self.meta,
                             self.world.rank, generator,
                             float(self.prop.V_reset))

    # -- checkpoints ----------------------------------------------------------

    def _rows(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x``, ``[n_dev, *x.shape]`` (one all-gather)."""
        return self.world.gather(x.reshape(-1)).view(self.n_dev, *x.shape)

    def checkpoint_state(self, state: DD.ShardedSimState
                         ) -> DD.ShardedSimState:
        """The world's global state as numpy, on every rank (collective)."""
        rows = {name: self._rows(getattr(state, name)) for name in
                ("V", "I_ex", "I_in", "refrac", "ring", "t", "overflow")}
        gens = self._rows(state.generator.get_state().to(self.device))
        shards = [(None, DD.ShardedSimState(
            generator=None, **{k: v[r] for k, v in rows.items()}))
            for r in range(self.n_dev)]
        arrays = convert.sharded_to_numpy(shards)
        return DD.ShardedSimState(
            generator=gens.cpu().numpy(),
            **{k: arrays[k] for k in rows})

    def checkpoint_template(self, state: DD.ShardedSimState
                            ) -> DD.ShardedSimState:
        """The global state's shapes and dtypes (zero-stride numpy arrays:
        nothing is allocated)."""
        n_pad, n_dev = self.meta["n_pad"], self.n_dev
        like = lambda shape, dtype: np.broadcast_to(np.zeros((), dtype),
                                                    shape)
        f32 = lambda: like((n_pad,), np.float32)
        return DD.ShardedSimState(
            V=f32(), I_ex=f32(), I_in=f32(),
            refrac=like((n_pad,), np.int32),
            ring=like((state.ring.shape[0], 2, n_pad + n_dev), np.float32),
            t=like((), np.int32),
            generator=like((n_dev, state.generator.get_state().numel()),
                           np.uint8),
            overflow=like((n_dev,), np.int32))

    def restore_state(self, state: DD.ShardedSimState,
                      saved: DD.ShardedSimState) -> torch.Tensor:
        rank = self.world.rank
        copy_into(state, convert.sharded_state_to_torch(
            saved._asdict(), rank, self.n_dev, self.device))
        return torch.from_numpy(np.array(saved.generator[rank]))

    def publish(self, write: Callable[[], str], path: str) -> str:
        """Rank 0 writes; every rank returns once it has (a one-word
        all-gather of rank 0's outcome), and raises if it failed."""
        if self.world.group is None:
            return write()
        error = None
        if self.world.rank == 0:
            try:
                write()
            except Exception as e:       # re-raised after the others know
                error = e
        ok = self.world.gather(torch.tensor(
            [error is None], dtype=torch.int32, device=self.device))
        if error is not None:
            raise error
        if not bool(ok[0]):
            raise RuntimeError(f"rank 0 failed to write the checkpoint "
                               f"{path} (its error is on rank 0)")
        return path

    def _sharded_step(self, carry: Carry, i: int, phase=None):
        """One step of this rank: update, gather, delivery.  ``phase``
        opens nothing (the phases are the graph's)."""
        st, spiked = DD.sharded_step(
            carry.sim, self.net, self.prop, self.cfg, w_ext=self.c.w_ext,
            n_exc=self.c.n_exc, drive=self.drive, gather=self.world.gather)
        return carry._replace(sim=st), spiked


REGISTRY = {
    "fused": FusedBackend,
    "instrumented": InstrumentedBackend,
    "sharded": ShardedBackend,
}


def make_backend(spec, *, plasticity=None,
                 n_devices: Optional[int] = None) -> Backend:
    """Resolve a backend name or instance, with its plasticity rule, and
    ``n_devices`` for the sharded backend (the world's size when None)."""
    if isinstance(spec, Backend):
        if plasticity is not None \
                and getattr(spec, "plasticity", None) is None:
            raise ValueError("pass plasticity= to the backend constructor "
                             "when supplying a backend instance")
        return spec
    if spec not in REGISTRY:
        raise ValueError(f"unknown backend {spec!r}; "
                         f"available: {sorted(REGISTRY)}")
    if spec == "sharded":
        if plasticity is not None:
            raise NotImplementedError(f"plasticity (stdp) is only composed "
                                      f"into the fused and instrumented "
                                      f"backends, not {spec!r}")
        return ShardedBackend(n_devices=n_devices)
    return REGISTRY[spec](plasticity=plasticity)
