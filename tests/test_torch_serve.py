"""The port's session server (``repro_torch.serve``), on the CPU, at scale
0.02.

Each case of ``tests/test_serve.py`` has its counterpart here.  On CPU
tensors ``FusedBackend`` runs eagerly and captures nothing, so the cases
that count captures run the backend pool on ``_GraphedOnCpu`` (the graphed
path with a re-executing stand-in for a CUDA graph), put in place of the
pool's backend factory by ``monkeypatch``:

* the counted cache's counters and LRU, ``fingerprint``, ``build_key``
  leaving probes and duration out;
* one capture set for two sessions of one scenario, the backend built
  once; a new probe set a new capture on the same backend; distinct
  backends for distinct strategy or scale;
* coalesced runs bitwise the sequential ones, a follow-up run too, and no
  capture after the group's first session; ``run_many`` refusing a
  suspended session;
* suspend / resume bitwise an untouched twin, static and plastic, with no
  capture on resume; ``step``; ``destroy``;
* the HTTP lifecycle with streaming, a server-side failure as a 500, and
  ``/stats`` answering while another request holds the device (a capture
  held open);
* ``python -m repro_torch.serve --smoke`` on the CPU, and raising without
  a card unless given ``--device cpu``.

Against the JAX package, on the same inputs: (a) ``build_key`` of each
committed scenario and ``fingerprint`` of the same dicts equal the JAX
package's; (b) the JAX package's ``ServeClient`` drives the port's
``SimServer``; (c) the slice as a whole: a session under the deterministic
``dc`` + ``step_current`` drive, carried from an eager JAX state at step 30
(``repro_torch.convert``), run through ``SessionManager.run``, through
``run_many`` beside a second session, and over HTTP in chunks: the spike
raster and the final state bitwise the eager JAX loop's, each streamed
chunk's population totals the JAX loop's over that chunk's steps.
"""
import dataclasses
import gc
import json
import threading
import urllib.error
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.core import stimulus as JS
from repro.core.connectivity import build_connectome as jax_build_connectome
from repro.core.engine import SimConfig as JaxSimConfig
from repro.core.engine import deliver_phase as jax_deliver_phase
from repro.core.engine import init_state as jax_init_state
from repro.core.engine import prepare_network as jax_prepare_network
from repro.core.engine import resolve_sim_config as jax_resolve
from repro.core.engine import update_phase as jax_update_phase
from repro.core.neuron import NeuronParams as JaxNeuronParams
from repro.core.neuron import Propagators as JaxPropagators
from repro.serve import ServeClient as JaxServeClient
from repro.serve import fingerprint as jax_fingerprint
from repro.serve.session import build_key as jax_build_key
from repro_torch import convert
from repro_torch.analysis.sanitize import (RecompileBudgetError,
                                          RecompileGuard, guard_compiles)
from repro_torch.api import Experiment
from repro_torch.configs.microcircuit import MicrocircuitConfig
from repro_torch.serve import (ExecutableCache, ServeClient, SessionManager,
                               SimServer, cache_stats, fingerprint)
from repro_torch.serve import __main__ as SERVE_CLI
from repro_torch.serve import session as SS
from repro_torch.serve.session import SessionStateError, build_key
from test_torch_graph_loop import (_GraphedOnCpu, _Reexecuted,
                                   _state_arrays)

ROOT = Path(__file__).resolve().parent.parent
SCENARIOS = sorted((ROOT / "examples" / "scenarios").glob("*.json"))
GRAPH_STEPS = 7


@pytest.fixture(autouse=True)
def _one_torch_thread_and_flushed_subnormals():
    """One intra-op thread per test (the suite runs several workers);
    subnormals flushed, as the other session tests run; the caches of
    earlier tests collected, so that none leaves the registry mid-test."""
    gc.collect()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    assert torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)
    torch.set_num_threads(n)


@pytest.fixture
def graphed(monkeypatch):
    """The pool builds ``_GraphedOnCpu`` backends; returns the list of
    backends it built."""
    built = []

    def factory(spec, *, plasticity=None):
        assert spec == "fused"
        backend = _GraphedOnCpu(plasticity=plasticity,
                                graph_steps=GRAPH_STEPS)
        built.append(backend)
        return backend

    monkeypatch.setattr(SS, "make_backend", factory)
    return built


def _experiment(**model_overrides) -> Experiment:
    probes = model_overrides.pop("probes", ("pop_counts",))
    fields = dict(n_scaling=0.02, k_scaling=0.02, t_presim=10.0, seed=7)
    fields.update(model_overrides)
    return Experiment(model=MicrocircuitConfig(**fields), probes=probes,
                      duration_ms=20.0, name="serve-test")


def _compiles() -> int:
    return cache_stats()["compiles"]


def _manager(**kw) -> SessionManager:
    return SessionManager(device="cpu", **kw)


def _assert_same_state(a, b):
    sa, sb = _state_arrays(a), _state_arrays(b)
    assert sa.keys() == sb.keys()
    for k in sa:
        np.testing.assert_array_equal(sa[k], sb[k], err_msg=k)


# ---------------------------------------------------------------------------
# The counted cache, fingerprints and build keys
# ---------------------------------------------------------------------------

def test_executable_cache_counters_and_lru():
    cache = ExecutableCache("unit.test", capacity=2)
    builds = []

    def builder(v):
        return lambda: builds.append(v) or v

    assert cache.get_or_build("a", builder(1)) == 1
    assert cache.get_or_build("a", builder(99)) == 1   # hit: no rebuild
    assert cache.get_or_build("b", builder(2)) == 2
    assert cache.stats()["hits"] == 1
    assert cache.stats()["misses"] == 2
    assert builds == [1, 2]

    evicted = []
    cache.on_evict(lambda k, v: evicted.append(k))
    cache.get_or_build("c", builder(3))                # evicts LRU "a"
    assert evicted == ["a"]
    assert cache.stats()["evictions"] == 1
    assert cache.peek("a") is None
    assert cache.peek("b") == 2                        # peek counts a hit
    assert cache.stats()["hits"] == 2
    assert cache.keys() == ["c", "b"] and cache.entry_keys() == ["'c'",
                                                                 "'b'"]

    cache.clear()
    assert cache.stats()["entries"] == 0
    # counters survive clear (they count builds, not residency)
    assert cache.stats()["misses"] == 3
    assert any(c["name"] == "unit.test" for c in cache_stats()["caches"])
    with pytest.raises(ValueError):
        ExecutableCache("unit.bad", capacity=0)


def test_stats_answer_while_a_build_runs():
    """A build holds the build lock, not the counters': ``stats`` and
    ``peek`` answer meanwhile, and a second build of the key waits and
    finds the entry (one build)."""
    cache = ExecutableCache("unit.slow")
    started, release = threading.Event(), threading.Event()
    builds = []

    def slow():
        started.set()
        assert release.wait(30)
        builds.append(1)
        return "v"

    t1 = threading.Thread(target=cache.get_or_build, args=("k", slow))
    t2 = threading.Thread(target=cache.get_or_build, args=("k", slow))
    t1.start()
    assert started.wait(30)
    t2.start()
    assert cache.stats()["misses"] == 1 and cache.peek("k") is None
    release.set()
    for t in (t1, t2):
        t.join(30)
        assert not t.is_alive()
    assert builds == [1] and cache.stats()["hits"] == 1


def test_recompile_guard_budget():
    cache = ExecutableCache("unit.guard")
    with RecompileGuard(1, caches=[cache]) as g:
        cache.get_or_build("a", lambda: 1)
    assert g.compiles == 1
    with pytest.raises(RecompileBudgetError, match="new keys: b"):
        with RecompileGuard(0, caches=[cache], what="unit"):
            cache.get_or_build("b", lambda: 2)
    with guard_compiles(0, caches=[cache]) as g:
        cache.get_or_build("a", lambda: 3)            # a hit
    assert g.compiles == 0
    assert issubclass(RecompileBudgetError, RuntimeError)
    with pytest.raises(ValueError):
        RecompileGuard(-1)


def test_fingerprint_is_stable_and_order_insensitive():
    a = fingerprint({"x": 1, "y": [1, 2], "z": {"k": np.float32(0.5)}})
    b = fingerprint({"z": {"k": 0.5}, "y": [1, 2], "x": 1})
    assert a == b
    assert a != fingerprint({"x": 1, "y": [2, 1], "z": {"k": 0.5}})
    for d in ({"x": 1, "y": [1, 2], "z": {"k": np.float32(0.5)}},
              {"model": {"scale": None, "seed": np.int64(55)}}):
        assert fingerprint(d) == jax_fingerprint(d)
    with pytest.raises(TypeError):
        fingerprint({"f": object()})


def test_build_key_excludes_probes_and_duration():
    base = _experiment()
    assert build_key(base) == build_key(
        dataclasses.replace(base, probes=("pop_counts", "total_counts"),
                            duration_ms=500.0))
    assert build_key(base) != build_key(
        dataclasses.replace(base, model=dataclasses.replace(
            base.model, strategy="dense")))


@pytest.mark.parametrize("path", SCENARIOS, ids=lambda p: p.stem)
def test_build_key_matches_the_reference(path):
    """(a) The same scenario file keys the same backend in both packages:
    ``build_key`` equal, and ``fingerprint`` of the same dicts equal."""
    from repro.api.experiment import Experiment as JaxExperiment
    exp, jexp = Experiment.from_json(str(path)), \
        JaxExperiment.from_json(str(path))
    assert build_key(exp) == jax_build_key(jexp)
    d = {"model": dataclasses.asdict(exp.model),
         "stimulus": [s.to_dict() for s in exp.stimulus],
         "plasticity": None if exp.plasticity is None
         else exp.plasticity.to_dict(), "backend": exp.backend}
    assert fingerprint(d) == jax_fingerprint(d) == build_key(exp)


# ---------------------------------------------------------------------------
# Captures shared across sessions
# ---------------------------------------------------------------------------

def test_same_scenario_sessions_capture_once(graphed):
    exp = _experiment()
    with _manager() as mgr:
        before = _compiles()
        s1 = mgr.create(exp, seed=5)
        r1 = s1.run(20.0)
        after_first = _compiles()
        # the pool's build and the presim's and the run's graph sets
        assert after_first == before + 3

        s2 = mgr.create(exp, seed=5)
        r2 = s2.run(20.0)
        # the second session builds nothing and captures nothing
        assert _compiles() == after_first
        assert mgr.pool.stats()["hits"] == 1
        assert mgr.pool.stats()["misses"] == 1
        assert s1.sim.backend is s2.sim.backend and len(graphed) == 1
        assert graphed[0].builds == 1
        # same seed on a shared backend: bitwise the same dynamics
        np.testing.assert_array_equal(r1.data["pop_counts"],
                                      r2.data["pop_counts"])
        assert mgr.stats()["compile_caches"]["compiles"] == _compiles()


def test_distinct_probe_sets_share_backend_not_graphs(graphed):
    exp = _experiment()
    with _manager() as mgr:
        s1 = mgr.create(exp)
        s1.run(20.0)
        pool_misses = mgr.pool.stats()["misses"]
        before = _compiles()

        exp2 = dataclasses.replace(exp,
                                   probes=("pop_counts", "total_counts"))
        s2 = mgr.create(exp2)
        s2.run(20.0)
        # the same backend (no pool miss), a new graph set (its presim's
        # graphs are the first session's)
        assert mgr.pool.stats()["misses"] == pool_misses
        assert s2.sim.backend is s1.sim.backend
        assert _compiles() == before + 1


def test_distinct_strategy_and_scale_get_distinct_backends():
    exp = _experiment()
    with _manager() as mgr:
        mgr.create(exp)
        assert mgr.pool.stats()["misses"] == 1
        mgr.create(dataclasses.replace(exp, model=dataclasses.replace(
            exp.model, strategy="ell")))
        assert mgr.pool.stats()["misses"] == 2
        mgr.create(dataclasses.replace(exp, model=dataclasses.replace(
            exp.model, n_scaling=0.03, k_scaling=0.03)))
        assert mgr.pool.stats()["misses"] == 3
        assert mgr.pool.stats()["entries"] == 3
        backends = {id(s.sim.backend) for s in mgr._sessions.values()}
        assert len(backends) == 3


def test_pool_evicts_least_recently_used_backend():
    """An evicted backend stays alive and working for its session."""
    exp = _experiment()
    with _manager(max_backends=1) as mgr:
        s1 = mgr.create(exp)
        mgr.create(dataclasses.replace(exp, model=dataclasses.replace(
            exp.model, strategy="ell")))
        assert mgr.pool.stats()["evictions"] == 1
        assert s1.run(2.0).n_steps == 20
        mgr.create(exp)
        assert mgr.pool.stats()["misses"] == 3


# ---------------------------------------------------------------------------
# Batching: coalesced == sequential, bitwise
# ---------------------------------------------------------------------------

def test_coalesced_run_matches_sequential_bitwise(graphed):
    exp = _experiment(probes=("pop_counts", "spikes"))
    with _manager() as mgr:
        seeds = [11, 22, 33]
        co = [mgr.create(exp, seed=s) for s in seeds]
        seq = [mgr.create(exp, seed=s) for s in seeds]
        backend = graphed[0]
        mgr.run_many({co[0].id: 20.0}, coalesce=False)   # warm the graphs
        mgr.run_many({co[0].id: 20.0}, coalesce=False)
        mgr.run_many({seq[0].id: 20.0}, coalesce=False)
        mgr.run_many({seq[0].id: 20.0}, coalesce=False)

        before = _compiles()
        walls = []
        run_batch = backend.run_batch

        def recorded(*args, **kw):
            out = run_batch(*args, **kw)
            walls.append(out[2])
            return out
        backend.run_batch = recorded
        r_co = mgr.run_many({s.id: 20.0 for s in co}, coalesce=True)
        assert _compiles() == before
        # each session's wall is its own trial's, not a share of the group
        assert [r_co[s.id].wall_s for s in co] == walls[0]
        r_seq = mgr.run_many({s.id: 20.0 for s in seq}, coalesce=False)

        for a, b in zip(co, seq):
            for name in ("pop_counts", "spikes"):
                np.testing.assert_array_equal(r_co[a.id].data[name],
                                              r_seq[b.id].data[name])
            assert a.t_model_ms == b.t_model_ms
            _assert_same_state(a.sim.state, b.sim.state)
            assert torch.equal(a.sim._generator.get_state(),
                               b.sim._generator.get_state())
        # the group's last session is resident; the others own storage
        ptrs = {s.sim.state.ring.data_ptr() for s in co + seq}
        assert len(ptrs) == 6
        assert seq[-1].sim.state.ring.data_ptr() == \
            backend._io.sim.ring.data_ptr()
        # the session state advanced identically: a follow-up run agrees
        f_co = mgr.run_many({co[0].id: 10.0, co[1].id: 10.0})
        f_seq = mgr.run_many({seq[0].id: 10.0, seq[1].id: 10.0},
                             coalesce=False)
        for a, b in ((co[0], seq[0]), (co[1], seq[1])):
            np.testing.assert_array_equal(f_co[a.id].data["pop_counts"],
                                          f_seq[b.id].data["pop_counts"])


def test_coalesced_group_captures_only_in_its_first_session(graphed):
    """A fresh group: its presims and its first session capture, the rest
    replay; a group whose second session would capture raises."""
    exp = _experiment()
    with _manager() as mgr:
        sessions = [mgr.create(exp, seed=s) for s in (1, 2, 3)]
        before = _compiles()
        mgr.run_many({s.id: 5.0 for s in sessions})
        assert _compiles() == before + 2          # presim's, the run's
        backend = graphed[0]
        # a second session that would capture breaks the batch's contract
        real = backend.run

        def run_capturing(state, n_steps, probes, stream=None):
            backend.graphs.get_or_build(object(), lambda: None)
            return real(state, n_steps, probes, stream=stream)
        backend.run = run_capturing
        with pytest.raises(RecompileBudgetError, match="trial 1"):
            mgr.run_many({s.id: 5.0 for s in sessions})


def test_run_many_rejects_suspended_sessions():
    exp = _experiment()
    with _manager() as mgr:
        s1 = mgr.create(exp)
        s1.run(10.0)
        mgr.suspend(s1.id)
        with pytest.raises(RuntimeError, match="suspended"):
            mgr.run_many({s1.id: 10.0})


# ---------------------------------------------------------------------------
# Suspend / resume
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("plastic", [False, True], ids=["static", "plastic"])
def test_suspend_and_resume_are_bitwise(graphed, plastic):
    """Suspend releases the state, resume captures nothing, and the next
    run is bitwise an untouched twin's (the weights and traces too)."""
    exp = _experiment()
    if plastic:
        exp = dataclasses.replace(exp, plasticity="pair_stdp",
                                  model=dataclasses.replace(
                                      exp.model, strategy="ell"))
    with _manager() as mgr:
        a = mgr.create(exp, seed=3)
        b = mgr.create(exp, seed=3)          # the untouched twin
        assert a.sim.backend is b.sim.backend
        a.run(10.0)
        b.run(10.0)

        mgr.suspend(a.id)
        assert a.status == "suspended"
        assert a.sim.suspended and a.sim._state is None
        with pytest.raises(SessionStateError, match="suspended"):
            a.run(10.0)
        mgr.suspend(a.id)                    # idempotent

        before = _compiles()
        mgr.resume(a.id)
        assert _compiles() == before and a.status == "running"
        ra = a.run(10.0)
        rb = b.run(10.0)
        np.testing.assert_array_equal(ra.data["pop_counts"],
                                      rb.data["pop_counts"])
        _assert_same_state(a.sim.state, b.sim.state)


def test_step_advances_whole_engine_steps():
    exp = _experiment()
    with _manager() as mgr:
        s = mgr.create(exp)
        res = mgr.step(s.id, 5)
        assert res.n_steps == 5
        # presim is untimed and uncounted; the session advanced 5 steps
        assert s.sim._steps_done == 5
        assert s.t_model_ms == pytest.approx(5 * exp.model.dt)
        with pytest.raises(ValueError):
            s.step(0)


def test_destroyed_session_is_gone():
    exp = _experiment()
    with _manager() as mgr:
        s = mgr.create(exp)
        ckpt = s.ckpt_dir
        mgr.suspend(s.id)
        assert Path(ckpt).is_dir()
        mgr.destroy(s.id)
        assert not Path(ckpt).exists()
        with pytest.raises(KeyError):
            mgr.get(s.id)
        with pytest.raises(RuntimeError, match="closed"):
            s.run(10.0)
        for bad in ("..", "a/b", ".hidden", ""):
            with pytest.raises(ValueError, match="session id"):
                mgr.create(exp, session_id=bad)
    with pytest.raises(SessionStateError, match="closed"):
        mgr.create(exp)


def test_manager_needs_the_card_unless_told():
    real = torch.cuda.is_available
    torch.cuda.is_available = lambda: False
    try:
        with pytest.raises(RuntimeError, match="none is available"):
            SessionManager()
        with pytest.raises(RuntimeError, match="none is available"):
            SERVE_CLI.main(["--smoke", str(SCENARIOS[1])])
    finally:
        torch.cuda.is_available = real


def test_smoke_cli_on_the_cpu(capsys):
    assert SERVE_CLI.main(["--smoke", str(ROOT / "examples" / "scenarios" /
                                          "smoke_background.json"),
                           "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "smoke: ok" in out and "streamed 2 chunks" in out


# ---------------------------------------------------------------------------
# HTTP front end
# ---------------------------------------------------------------------------

def test_http_lifecycle_and_streaming():
    exp = _experiment()
    server = SimServer(_manager(), port=0).start()
    try:
        client = ServeClient(server.url)
        assert client.healthz()["ok"]

        created = client.create(experiment=exp.to_dict(), seed=9)
        sid = created["id"]
        assert created["status"] == "running"

        records = client.run(sid, t_ms=20.0, chunk_ms=10.0)
        chunks = [r for r in records if "chunk" in r]
        assert len(chunks) == 2
        assert all("pop_spikes" in c for c in chunks)
        assert records[-1]["done"] and \
            records[-1]["session_t_model_ms"] == 20.0

        client.suspend(sid)
        assert client.sessions()[0]["status"] == "suspended"
        with pytest.raises(RuntimeError, match="suspended"):
            client.run(sid, t_ms=5.0)          # in-band, after the headers
        client.resume(sid)
        out = client.run_many({sid: 10.0})
        assert out[sid]["t_model_ms"] == 10.0

        stats = client.stats()
        assert stats["sessions"]["count"] == 1
        assert stats["compile_caches"]["compiles"] >= 1

        client.destroy(sid)
        assert client.sessions() == []

        with pytest.raises(urllib.error.HTTPError) as e:       # 404
            client.suspend("nope")
        assert e.value.code == 404
        with pytest.raises(urllib.error.HTTPError) as e:       # 400
            client.create(experiment={"schema": "nope"})
        assert e.value.code == 400
        client.shutdown()
    finally:
        server.stop()


def test_http_reports_a_server_fault_as_500(monkeypatch):
    def broken(spec, *, plasticity=None):
        raise RuntimeError("lif_deliver: CUDA error 700 (illegal address)")

    monkeypatch.setattr(SS, "make_backend", broken)
    server = SimServer(_manager(), port=0).start()
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            ServeClient(server.url).create(experiment=_experiment().to_dict())
        assert e.value.code == 500
        assert "CUDA error 700" in json.loads(e.value.read())["error"]
    finally:
        server.stop()


class _HeldCapture(_Reexecuted):
    """A graph whose capture waits until the test lets it go."""
    capturing = threading.Event()
    release = threading.Event()

    def __init__(self, fn, generator, pool):
        _HeldCapture.capturing.set()
        assert _HeldCapture.release.wait(30)
        super().__init__(fn, generator, pool)


class _HeldGraphed(_GraphedOnCpu):
    graph_type = _HeldCapture


def test_stats_answer_while_a_capture_holds_the_device(monkeypatch):
    """``/healthz``, ``/stats`` and ``/sessions`` answer while another
    request is inside a capture (they read host state only); a device
    request waits for it."""
    monkeypatch.setattr(
        SS, "make_backend", lambda spec, *, plasticity=None:
        _HeldGraphed(plasticity=plasticity, graph_steps=GRAPH_STEPS))
    _HeldCapture.capturing.clear()
    _HeldCapture.release.clear()
    server = SimServer(_manager(), port=0).start()
    try:
        client = ServeClient(server.url, timeout=60)
        sid = client.create(experiment=_experiment().to_dict())["id"]
        got = {}
        runner = threading.Thread(
            target=lambda: got.update(run=client.run(sid, t_ms=2.0)))
        runner.start()
        assert _HeldCapture.capturing.wait(30)
        for _ in range(5):
            assert client.healthz()["ok"]
            stats = client.stats()
            assert stats["sessions"]["count"] == 1
            assert client.sessions()[0]["id"] == sid
        assert runner.is_alive()                  # still capturing
        _HeldCapture.release.set()
        runner.join(60)
        assert not runner.is_alive() and got["run"][-1]["done"]
        client.shutdown()
    finally:
        _HeldCapture.release.set()
        server.stop()


def test_reference_client_drives_the_port_server():
    """(b) The JAX package's ``ServeClient``, unchanged, through create,
    a chunked run, suspend, resume, ``run_many``, ``stats`` and destroy."""
    exp = _experiment()
    server = SimServer(_manager(), port=0).start()
    try:
        client = JaxServeClient(server.url)
        assert client.healthz()["ok"]
        sid = client.create(experiment=exp.to_dict(), seed=9)["id"]
        sid2 = client.create(experiment=exp.to_dict(), seed=10,
                             session_id="twin")["id"]
        assert sid2 == "twin"
        records = client.run(sid, t_ms=20.0, chunk_ms=10.0)
        chunks = [r for r in records if "chunk" in r]
        assert [c["chunk"] for c in chunks] == [1, 2]
        assert all(len(c["pop_spikes"]) == 8 for c in chunks)
        assert records[-1]["done"] and records[-1]["t_model_ms"] == 20.0
        client.suspend(sid)
        assert {s["id"]: s["status"] for s in client.sessions()} == {
            sid: "suspended", "twin": "running"}
        client.resume(sid)
        out = client.run_many({sid: 10.0, "twin": 10.0})
        assert set(out) == {sid, "twin"}
        assert all(r["t_model_ms"] == 10.0 for r in out.values())
        stats = client.stats()
        assert stats["sessions"] == {"count": 2, "running": 2}
        assert stats["backend_pool"]["misses"] == 1
        client.destroy(sid)
        client.destroy("twin")
        assert client.sessions() == []
        with pytest.raises(urllib.error.HTTPError):
            client.destroy("twin")
        client.shutdown()
    finally:
        server.stop()


# ---------------------------------------------------------------------------
# (c) The slice as a whole, bitwise the eager JAX loop
# ---------------------------------------------------------------------------

SCALE, DT, SEED = 0.02, 0.1, 55
N_CARRY, N_STEPS, N_CHUNK = 30, 100, 25
TIMELINE = ({"kind": "dc", "rate_hz": 8.0},
            {"kind": "step_current", "amplitude_pa": 300.0,
             "populations": ["L4E", "L4I", "L5E"], "t_start_ms": 1.0,
             "t_stop_ms": 8.0})


@pytest.fixture(scope="module")
def jax_drive():
    """The eager JAX loop under the deterministic drive: the state at step
    30 (spikes in flight), the next 100 steps' raster, the final state,
    the population bounds and the resolved spike budget."""
    c_jax = jax_build_connectome(scale=SCALE, seed=SEED)
    jtl = JS.resolve_timeline(TIMELINE)
    jcfg = jax_resolve(JaxSimConfig(strategy="ell", kernels="reference",
                                    stimulus=jtl), c_jax)
    jnet = jax_prepare_network(c_jax, jcfg)
    prop = JaxPropagators.make(JaxNeuronParams(), DT)
    drive = JS.compile_drive(jtl, c_jax, jcfg, JaxNeuronParams())
    st = jax_init_state(c_jax, jax.random.PRNGKey(9))
    spikes = []
    for i in range(N_CARRY + N_STEPS):
        if i == N_CARRY:
            start = _jax_arrays(jnet, st)
        st, spk = jax_update_phase(st, jnet, prop, jcfg, c_jax.w_ext,
                                   c_jax.n_total, drive)
        st = jax_deliver_phase(st, jnet, jcfg, spk, c_jax.n_exc)
        spikes.append(np.asarray(spk))
    raster = np.stack(spikes[N_CARRY:])
    assert raster.sum() > 20 and np.abs(start["ring"]).sum() > 0
    bounds = np.concatenate([[0], np.cumsum(c_jax.pop_sizes)])
    return dict(start=start, raster=raster, final=_jax_arrays(jnet, st),
                bounds=bounds, spike_budget=jcfg.spike_budget)


def _jax_arrays(net, st):
    return {
        "targets": np.asarray(net.tables.targets),
        "weights": np.asarray(net.tables.weights),
        "dbins": np.asarray(net.tables.dbins),
        "k_ext": np.asarray(net.k_ext), "i_dc": np.asarray(net.i_dc),
        "pop_of": np.asarray(net.pop_of),
        "V": np.asarray(st.neuron.V), "I_ex": np.asarray(st.neuron.I_ex),
        "I_in": np.asarray(st.neuron.I_in),
        "refrac": np.asarray(st.neuron.refrac),
        "ring": np.asarray(st.ring), "t": np.asarray(st.t),
        "overflow": np.asarray(st.overflow)}


def _pop_totals(raster, bounds):
    return [int(raster[:, lo:hi].sum()) for lo, hi in zip(bounds[:-1],
                                                           bounds[1:])]


@pytest.mark.parametrize("mode", ["fused", "split"])
def test_deterministic_drive_session_bitwise_vs_jax_eager(graphed, jax_drive,
                                                          mode):
    d = jax_drive
    exp = Experiment(
        model=MicrocircuitConfig(scale=SCALE, strategy="ell", t_presim=0.0,
                                 seed=SEED, kernels=mode,
                                 spike_budget=d["spike_budget"]),
        stimulus=TIMELINE, probes=("spikes", "pop_counts"), name="drive")

    def carried(session):
        _, state = convert.to_torch(d["start"], "cpu")
        session.sim.state = state
        return session

    def assert_final(session):
        got = convert.to_numpy(session.sim.backend.net, session.sim.state)
        for key in ("V", "I_ex", "I_in", "refrac", "ring", "t", "overflow"):
            np.testing.assert_array_equal(got[key], d["final"][key],
                                          err_msg=key)

    with _manager() as mgr:
        # SessionManager.run
        alone = carried(mgr.create(exp))
        res = mgr.run(alone.id, N_STEPS * DT)
        np.testing.assert_array_equal(res["spikes"], d["raster"])
        assert_final(alone)
        # run_many, beside a second session of the scenario
        grouped, other = carried(mgr.create(exp)), mgr.create(exp, seed=3)
        before = _compiles()
        out = mgr.run_many({grouped.id: N_STEPS * DT,
                            other.id: N_STEPS * DT})
        assert _compiles() == before
        np.testing.assert_array_equal(out[grouped.id]["spikes"],
                                      d["raster"])
        assert_final(grouped)
        assert not np.array_equal(out[other.id]["spikes"], d["raster"])
        # over HTTP, in chunks
        streamed = carried(mgr.create(exp))
        server = SimServer(mgr, port=0).start()
        try:
            records = ServeClient(server.url).run(
                streamed.id, t_ms=N_STEPS * DT, chunk_ms=N_CHUNK * DT)
        finally:
            server.httpd.shutdown()
            server.httpd.server_close()
        chunks = [r for r in records if "chunk" in r]
        assert len(chunks) == N_STEPS // N_CHUNK
        for i, rec in enumerate(chunks):
            assert rec["pop_spikes"] == _pop_totals(
                d["raster"][i * N_CHUNK:(i + 1) * N_CHUNK], d["bounds"])
        assert_final(streamed)
    assert len(graphed) == 1 and graphed[0].builds == 1
