"""The port's session API over its step loop, on the CPU.

On a card ``FusedBackend`` captures its loop into CUDA graphs; a graph
cannot be captured here.  ``_Reexecuted`` stands in for one: its capture
records the segment function and each replay runs it again.  Every
persistent value of a graph lives in its static buffers (the state, the
probes' outputs and row counter, the stream carries), so re-running the
segment on them is what a replay does, and the graphed backend's
machinery runs here: the static buffers chaining from replay to replay,
the head, body and remainder graphs, the probes' rows at a device-side
counter, the stream carries in and out, the epilogue after the replays,
and the graph cache's counters.  Its results are held bitwise to the eager
loop's, which the other ``test_torch_*`` files hold to the JAX package.

Also here, all bitwise, all at scale 0.02 or below: ``run_chunked`` against
``run``, ``warmup`` leaving the state alone, the instrumented backend
against the fused one, ``reset(key)``, ``concat``, and the launch counts a
replay adds.
"""
import numpy as np
import pytest
import torch

from repro_torch.api import (FusedBackend, InstrumentedBackend, Simulator,
                             concat, spike_stats, weight_stats)
from repro_torch.api.backends import ShardedBackend
from repro_torch.api.graph_cache import GraphCache
from repro_torch.api.results import RunResult
from repro_torch.configs.microcircuit import MicrocircuitConfig
from repro_torch.kernels import _build

SCALE = 0.02
GRAPH_STEPS = 7


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the suite runs several workers on a
    few cores, and each op's thread pool would fight the others' (a test
    of 0.8 s alone took minutes so)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Reexecuted:
    """A CUDA graph's stand-in on the CPU: replay runs the segment again."""

    def __init__(self, fn, generator, pool):
        self.fn = fn

    def replay(self, times=1):
        for _ in range(times):
            self.fn()

    @staticmethod
    def new_pool():
        return None


class _GraphedOnCpu(FusedBackend):
    """``FusedBackend``'s graphed path, on the CPU with ``_Reexecuted``."""
    graph_type = _Reexecuted
    graphed = True


class _ShardedGraphedOnCpu(ShardedBackend):
    """``ShardedBackend``'s graphed path (a world of one), on the CPU."""
    graph_type = _Reexecuted
    graphed = True


PATHS = {
    "static_fused": dict(strategy="ell", kernels="fused", plasticity=None),
    "static_split": dict(strategy="ell", kernels="split", plasticity=None),
    "plastic_fused": dict(strategy="ell", kernels="fused",
                          plasticity="pair_stdp"),
    "plastic_split": dict(strategy="ell", kernels="split",
                          plasticity="pair_stdp"),
    "dense_split": dict(strategy="dense", kernels="split", plasticity=None),
    # the sharded backend (a world of one), which records no raster
    "sharded": dict(strategy="ell", kernels="split", plasticity=None,
                    sharded=True),
}


@pytest.fixture(autouse=True)
def _flush_subnormals():
    assert torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)


def _session(path, backend="fused", t_presim=2.0, probes=None, **kw):
    p = PATHS[path]
    if probes is None:
        probes = ["pop_counts", "spikes", "total_counts",
                  spike_stats(np.arange(0, 600, 7), bin_steps=5)]
        if p["plasticity"]:
            probes += ["mean_plastic_weight", weight_stats()]
        if p.get("sharded"):
            probes.remove("spikes")
    if p.get("sharded"):
        backend = _ShardedGraphedOnCpu(graph_steps=GRAPH_STEPS) \
            if backend == "graphed" else "sharded"
    elif backend == "graphed":
        backend = _GraphedOnCpu(plasticity=p["plasticity"],
                                graph_steps=GRAPH_STEPS)
    cfg = MicrocircuitConfig(scale=SCALE, strategy=p["strategy"],
                             t_presim=t_presim)
    return Simulator(cfg, backend=backend, kernels=p["kernels"],
                     plasticity=p["plasticity"], probes=probes,
                     device="cpu", **kw)


def _state_arrays(state) -> dict:
    if hasattr(state, "V"):                     # a rank's ShardedSimState
        return {k: getattr(state, k).clone().numpy() for k in (
            "V", "I_ex", "I_in", "refrac", "ring", "t", "overflow")}
    sim, ps = (state, None) if hasattr(state, "neuron") else state
    out = {"V": sim.neuron.V, "I_ex": sim.neuron.I_ex,
           "I_in": sim.neuron.I_in, "refrac": sim.neuron.refrac,
           "ring": sim.ring, "t": sim.t, "overflow": sim.overflow}
    if ps is not None:
        out.update(weights=ps.weights, x_pre=ps.x_pre, x_post=ps.x_post)
    return {k: v.clone().numpy() for k, v in out.items()}


def _assert_same_run(a: RunResult, b: RunResult):
    assert a.n_steps == b.n_steps and a.overflow == b.overflow
    assert set(a.data) == set(b.data)
    for name in a.data:
        np.testing.assert_array_equal(a.data[name], b.data[name],
                                      err_msg=name)
    assert set(a.streams) == set(b.streams)
    for name in a.streams:
        _assert_tree_equal(a.streams[name]["carry"], b.streams[name]["carry"])


def _assert_tree_equal(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_tree_equal(a[k], b[k])
    elif isinstance(a, tuple):
        for x, y in zip(a, b, strict=True):
            _assert_tree_equal(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _assert_same_state(a, b):
    sa, sb = _state_arrays(a), _state_arrays(b)
    assert sa.keys() == sb.keys()
    for k in sa:
        np.testing.assert_array_equal(sa[k], sb[k], err_msg=k)


@pytest.mark.parametrize("path", list(PATHS))
def test_graphed_loop_equals_eager_loop(path):
    """Two runs of 33 steps (the head, four bodies of 7, the remainder),
    one of 5 and one of 1 after the presim: the same states, probes,
    stream carries and generator state as the eager loop's."""
    eager, graphed = _session(path), _session(path, backend="graphed")
    _build.reset_launches()
    for t_ms in (3.3, 3.3, 0.5, 0.1):
        a, b = eager.run(t_ms), graphed.run(t_ms)
        _assert_same_run(a, b)
        _assert_same_state(eager.state, graphed.state)
        assert torch.equal(eager._generator.get_state(),
                           graphed._generator.get_state())
    if "spikes" in a.data:
        assert a.data["spikes"].shape[1] == graphed.connectome.n_total
    cache = graphed.backend.graphs
    # presim, 33, 5, 1 steps: four keys, the second 33 a hit
    assert cache.stats()["misses"] == 4 and cache.stats()["hits"] == 1
    streams = a.streams["spike_stats"]["carry"]
    assert int(streams.steps) == 33 + 33 + 5 + 1


@pytest.mark.parametrize("path", ["static_fused", "plastic_fused"])
def test_sessions_sharing_a_backend_are_independent(path):
    """Two sessions on one graphed backend, run in turns (a, b, a, b), are
    bitwise two lone sessions: each keeps its own state and generator.  The
    second session's construction builds nothing, and its runs capture
    nothing new; a session with another config rebuilds, which drops the
    graphs."""
    p = PATHS[path]
    shared = _GraphedOnCpu(plasticity=p["plasticity"],
                           graph_steps=GRAPH_STEPS)
    a = _session(path, backend=shared, key=1)
    lone_a = _session(path, backend="graphed", key=1)
    first = a.run(3.3)
    _assert_same_run(first, lone_a.run(3.3))
    tables, misses = shared.net, shared.graphs.misses
    # the same probe instances: a stream probe is its own graph key
    b = _session(path, backend=shared, key=2, connectome=a.connectome,
                 probes=a.probes)
    lone_b = _session(path, backend="graphed", key=2)
    assert shared.net is tables and shared.graphs.misses == misses
    for sess, lone in ((b, lone_b), (a, lone_a), (b, lone_b)):
        _assert_same_run(sess.run(3.3), lone.run(3.3))
    assert shared.graphs.misses == misses
    for sess, lone in ((a, lone_a), (b, lone_b)):
        _assert_same_state(sess.state, lone.state)
        assert torch.equal(sess._generator.get_state(),
                           lone._generator.get_state())
    sa, sb = _state_arrays(a.state), _state_arrays(b.state)
    assert not np.array_equal(sa["V"], sb["V"])
    ring = (a.state if path.startswith("static") else a.state[0]).ring
    ring_b = (b.state if path.startswith("static") else b.state[0]).ring
    assert ring.data_ptr() != ring_b.data_ptr()
    c = _session(path, backend=shared, connectome=a.connectome,
                 spike_budget=300)
    assert shared.net is not tables and len(shared.graphs) == 0
    _assert_same_state(a.state, lone_a.state)
    # a's next run builds the backend back for a's config, and c's for c's
    lone_c = _session(path, backend="graphed", connectome=a.connectome,
                      spike_budget=300)
    for sess, lone in ((a, lone_a), (c, lone_c), (a, lone_a)):
        _assert_same_run(sess.run(3.3), lone.run(3.3))
        assert shared.cfg == lone.backend.cfg
    for sess, lone in ((a, lone_a), (c, lone_c)):
        _assert_same_state(sess.state, lone.state)


def test_graph_set_holds_head_body_and_remainder():
    sim = _session("plastic_fused", backend="graphed", t_presim=0.0)
    sim.warmup(3.3)
    entry = sim.backend.graphs.peek((33, sim.probes, GRAPH_STEPS))
    # 2 head steps, then 31 = 4 * 7 + 3
    assert [times for _, times in entry.graphs] == [1, 4, 1]
    assert entry.outs[0].shape == (33, 8)


def test_warmup_leaves_state_untouched():
    for backend in ("graphed", "fused", "instrumented"):
        path = "plastic_fused" if backend != "instrumented" \
            else "plastic_split"
        sim = _session(path, backend=backend, probes=("pop_counts",))
        before = _state_arrays(sim.state)
        gen = sim._generator.get_state()
        sim.warmup(3.3)
        after = _state_arrays(sim.state)
        for k in before:
            np.testing.assert_array_equal(before[k], after[k], err_msg=k)
        assert torch.equal(gen, sim._generator.get_state())
    assert len(sim.backend.caches()) == 0      # the instrumented loop


@pytest.mark.parametrize("backend", ["fused", "graphed", "sharded"])
def test_run_chunked_equals_run(backend):
    """``run_chunked(4.7, 1.0)`` (chunks of 10, 10, 10, 10, 7 steps) equals
    ``run(4.7)`` of a twin session, and chunks 2..4 capture nothing
    (``sharded``: the sharded backend's graphed path)."""
    path = "sharded" if backend == "sharded" else "static_fused"
    if backend == "sharded":
        backend = "graphed"
    one, chunked = _session(path, backend=backend), \
        _session(path, backend=backend)
    captures = []
    res = chunked.run_chunked(4.7, 1.0, callback=lambda i, r: captures.append(
        sum(c.misses for c in chunked.backend.caches())))
    want = one.run(4.7)
    _assert_same_run(res, want)
    _assert_same_state(chunked.state, one.state)
    assert res.n_steps == 47 and len(captures) == 5
    if backend == "graphed":
        # the presim's key before, then 10 steps once, then 7 steps
        assert captures == [2, 2, 2, 2, 3]
    else:
        assert captures == [0] * 5


def test_run_chunked_refuses_checkpoints(tmp_path):
    """``run_chunked`` checkpoints (``tests/test_torch_checkpoint.py``), but
    refuses a ``checkpoint_every`` below 1, before it runs or writes
    anything, and a suspended session."""
    sim = _session("static_fused")
    with pytest.raises(ValueError, match="checkpoint_every"):
        sim.run_chunked(1.0, 0.5, checkpoint_dir=str(tmp_path),
                        checkpoint_every=0)
    assert sim._steps_done == 0 and not any(tmp_path.iterdir())
    sim.suspend(str(tmp_path))
    with pytest.raises(RuntimeError, match="suspended"):
        sim.run_chunked(1.0, 0.5, checkpoint_dir=str(tmp_path))


@pytest.mark.parametrize("plastic", [False, True])
def test_instrumented_equals_fused(plastic):
    """The instrumented (eager, split, timed) loop against the fused one:
    the same rasters, state and weights; the timers name every phase."""
    path = "plastic_fused" if plastic else "static_fused"
    probes = ("pop_counts", "spikes", spike_stats(np.arange(0, 600, 7),
                                                 bin_steps=5))
    fused = _session(path, probes=probes)
    instr = _session(path, backend="instrumented", probes=probes)
    assert instr.sim_config.kernels.step == "split"
    for t_ms in (3.3, 1.0):
        _assert_same_run(fused.run(t_ms), res := instr.run(t_ms))
        _assert_same_state(fused.state, instr.state)
    phases = {"update", "deliver", "record"} | ({"plasticity"} if plastic
                                                else set())
    assert set(res.timers) == phases and set(instr.timers) == phases
    assert all(v > 0 for v in res.timers.values())
    with pytest.raises(NotImplementedError, match="weight_stats"):
        _session("plastic_split", backend="instrumented",
                 probes=("pop_counts", weight_stats()))


def test_reset_key():
    """``reset(key)`` re-seeds the session's generator: the run equals a
    fresh session made with that key, and differs from the first seed's."""
    sim = _session("static_fused", backend="graphed", t_presim=0.0)
    first = sim.run(2.0)
    sim.reset(key=7)
    again = sim.run(2.0)
    fresh = _session("static_fused", t_presim=0.0, key=7).run(2.0)
    _assert_same_run(again, fresh)
    assert not np.array_equal(first["spikes"], again["spikes"])
    sim.reset()                        # the session's key is now 7
    _assert_same_run(sim.run(2.0), fresh)


def test_concat():
    parts = [RunResult(data={"x": np.full((n, 2), n)}, t_model_ms=n * 0.1,
                       n_steps=n, dt=0.1, wall_s=0.5, overflow=i,
                       device="cpu", timers={"update": 1.0},
                       streams={"s": {"carry": i, "meta": {}}})
             for i, n in enumerate((3, 4))]
    res = concat(parts)
    assert res.n_steps == 7 and res.data["x"].shape == (7, 2)
    np.testing.assert_array_equal(res.data["x"][:3], 3)
    assert res.t_model_ms == pytest.approx(0.7) and res.wall_s == 1.0
    assert res.overflow == 1 and res.timers == {"update": 2.0}
    assert res.streams["s"]["carry"] == 1 and res.device == "cpu"
    with pytest.raises(ValueError):
        concat([])


def test_replays_count_their_launches():
    """A replay adds the launches its graph holds; the capture adds none."""
    from repro_torch.api.backends import _Graph
    calls = []

    class _Fake(_Graph):
        def __init__(self, fn, generator, pool):
            before = dict(_build.launches)
            fn()
            self.launches = {k: _build.launches[k] - before[k]
                             for k in before if _build.launches[k] != before[k]}
            _build.launches.update(before)
            self.graph = type("G", (), {"replay": lambda s: calls.append(1)})()

    _build.reset_launches()

    def fn():
        _build.launches["lif_deliver"] += 3
    g = _Fake(fn, None, None)
    assert _build.launches["lif_deliver"] == 0
    g.replay(5)
    assert _build.launches["lif_deliver"] == 15 and len(calls) == 5


def test_graph_cache_counters():
    cache = GraphCache("test")
    built = []
    assert cache.peek("a") is None and cache.misses == 0
    assert cache.get_or_build("a", lambda: built.append(1) or "A") == "A"
    assert cache.get_or_build("a", lambda: built.append(1) or "B") == "A"
    assert cache.peek("a") == "A" and "a" in cache and len(cache) == 1
    assert built == [1]
    assert cache.stats() == {"name": "test", "entries": 1, "capacity": None,
                             "hits": 2, "misses": 1, "evictions": 0}
    cache.clear()
    assert len(cache) == 0 and cache.misses == 1 and cache.evictions == 1


def test_graphed_run_needs_the_card():
    """On the CPU the fused backend runs its steps eagerly; the graphs are
    the card's."""
    sim = _session("static_fused")
    assert not sim.backend.graphed
    sim.warmup(1.0)
    assert len(sim.backend.graphs) == 0
    assert isinstance(sim.backend, FusedBackend) \
        and not isinstance(sim.backend, InstrumentedBackend)


def test_state_setter_hands_over_the_generator():
    """A state carried in with its own generator: the session's generator
    takes that generator's state, and the run draws what it would."""
    a = _session("static_fused", t_presim=0.0)
    b = _session("static_fused", t_presim=0.0, key=3)
    st = a.state
    twin = torch.Generator()
    twin.set_state(a._generator.get_state())
    b.state = st._replace(generator=twin)
    assert b.state.generator is b._generator
    _assert_same_run(a.run(1.0), b.run(1.0))
