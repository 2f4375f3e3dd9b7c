"""Checkpoints of the port's sharded sessions, and the session server over
the sharded backend, on the CPU at scale 0.02 (N = 1,544), ``ell``.

Tolerance: none; subnormals are flushed as XLA flushes them.

(a) A world of one (no process group), eager and graphed (``_Reexecuted``,
    a CUDA graph's stand-in that re-runs the captured segment): ``save``
    then ``restore`` into the session and into a fresh one,
    ``run_chunked(checkpoint_dir=)`` and ``suspend`` / ``resume``, each
    continuing bitwise (the population counts, the gathered registry, V,
    the currents, the ring, refrac, ``t``, overflow and the generator);
    no capture after a restore.
(b) Gloo worlds of 2 and 4 ranks, one subprocess each: the same
    continuation on every rank, and the file rank 0 writes equal to
    ``convert.sharded_to_numpy`` of the ranks' shards, its generator rows
    each rank's generator state.
(c) The checkpoint's leaves but the generator rows against the
    reference's: names, shapes and dtypes against what the reference's
    ``Simulator(..., backend="sharded").save`` writes over a mesh of 4 CPU
    devices (a subprocess), and values against the reference's checkpoint
    of the eager JAX state of ``tests/test_torch_distributed.py``, which 4
    gloo ranks load through ``convert.sharded_to_torch`` and save.
(d) ``CheckpointMismatchError`` naming the leaf, before any array is read:
    a 4-rank checkpoint into a world of one, a fused one into a sharded
    session, a sharded one into a fused session.
(e) A ``SessionManager`` session on ``backend="sharded"``: suspend/resume
    and a coalesced run, each exact against its twin; a server in a gloo
    group of 2 refuses a sharded scenario.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.analysis.sanitize import RecompileGuard
from repro_torch.api import Experiment, Simulator
from repro_torch.checkpoint import checkpointer as CK
from repro_torch.configs.microcircuit import MicrocircuitConfig
from repro_torch.core import distributed as DD
from repro_torch.core.connectivity import build_connectome
from test_torch_distributed import (  # noqa: F401 (a fixture)
    RASTER, RENDEZVOUS_TIMEOUT_S, SUBPROCESS_TIMEOUT_S,
    _global_sharded_arrays, jax_dc_reference, raster)
from test_torch_graph_loop import (_assert_same_run, _assert_same_state,
                                   _ShardedGraphedOnCpu)

SCALE, SEED = 0.02, 55
ROOT = Path(__file__).resolve().parent.parent
CFG = MicrocircuitConfig(scale=SCALE, strategy="ell", t_presim=2.0,
                         seed=SEED)
GRAPH_STEPS = 7
STEPS = 33                      # a run after the save: 3.3 ms


@pytest.fixture(autouse=True)
def _one_thread_and_flushed_subnormals():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    assert torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def connectome():
    return build_connectome(scale=SCALE, seed=SEED)


def _sharded(c, backend="eager", key=None):
    be = _ShardedGraphedOnCpu(graph_steps=GRAPH_STEPS) \
        if backend == "graphed" else "sharded"
    return Simulator(CFG, connectome=c, backend=be, device="cpu", key=key,
                     probes=("pop_counts", "total_counts",
                             raster(STEPS, c.n_total)))


def _captures(sim) -> int:
    return sum(cache.misses for cache in sim.backend.caches())


def _snapshot(sim) -> tuple:
    return ({k: v.copy() for k, v in CK._flatten(sim.state).items()},
            sim._generator.get_state(), sim.backend.overflow(sim.state))


def _assert_snapshot(sim, snap) -> None:
    arrays, gen, overflow = snap
    for name, x in CK._flatten(sim.state).items():
        np.testing.assert_array_equal(x, arrays[name], err_msg=name)
    assert torch.equal(sim._generator.get_state(), gen)
    assert sim.backend.overflow(sim.state) == overflow


# ---------------------------------------------------------------------------
# (a) a world of one
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["eager", "graphed"])
@pytest.mark.parametrize("how", ["save_restore", "run_chunked",
                                 "suspend_resume"])
def test_world_of_one_continues_bitwise(connectome, tmp_path, backend, how):
    """The checkpoint holds the reference's global layout (n_dev = 1); the
    session restored from it runs on as the uninterrupted one, bitwise,
    and a restore captures nothing."""
    c, ck = connectome, str(tmp_path)
    sim = _sharded(c, backend)
    twin = _sharded(c, backend)
    if how == "run_chunked":
        chunks = []
        sim.run_chunked(4 * STEPS * 0.1, STEPS * 0.1, checkpoint_dir=ck,
                        checkpoint_every=2,
                        callback=lambda i, r: chunks.append(r))
        assert sorted(os.listdir(ck)) == ["step_00000066", "step_00000132"]
        twin.restore(ck, step=66)
        for want in chunks[2:]:
            # the chunks' raster carries count on from the run's start
            got = twin.run(STEPS * 0.1)
            for name in want.data:
                np.testing.assert_array_equal(got[name], want[name])
            np.testing.assert_array_equal(
                got.streams["raster"]["carry"]["rows"],
                want.streams["raster"]["carry"]["rows"])
        _assert_same_state(twin.state, sim.state)
        assert torch.equal(twin._generator.get_state(),
                           sim._generator.get_state())
        return
    for s in (sim, twin):
        # the raster's carry starts with the compared runs (a restore
        # restarts the stream probes' carries)
        s.run(1.5, probes=("pop_counts",))
    assert sim.state.overflow.item() == 0 and sim._presim_done
    if how == "suspend_resume":
        path = sim.suspend(ck)
        assert sim.suspended and os.path.isdir(path)
        with RecompileGuard(0, caches=sim.backend.caches(), what="resume"):
            sim.resume(ck)
        _assert_same_state(sim.state, twin.state)
        _assert_same_run(twin.run(STEPS * 0.1), sim.run(STEPS * 0.1))
        _assert_same_state(sim.state, twin.state)
        return
    path = sim.save(ck)
    assert os.path.basename(path) == "step_00000015"
    with np.load(os.path.join(path, "host_0.npz")) as f:
        saved = dict(f)
    assert saved["['state']||.ring"].shape == (c.d_max_bins, 2,
                                               c.n_total + 1)
    assert saved["['state']||.overflow"].shape == (1,)
    np.testing.assert_array_equal(saved["['state']||.generator"],
                                  sim._generator.get_state().numpy()[None])
    a = sim.run(STEPS * 0.1)
    snap = _snapshot(sim)
    captures = _captures(sim)
    sim.restore(ck)
    assert (sim._steps_done, sim._presim_done) == (15, True)
    _assert_same_run(a, sim.run(STEPS * 0.1))
    assert _captures(sim) == captures
    _assert_snapshot(sim, snap)
    fresh = _sharded(c, backend, key=9)
    fresh.restore(ck)
    _assert_same_run(a, fresh.run(STEPS * 0.1))
    _assert_snapshot(fresh, snap)


def test_resident_suspend_frees_only_the_session(connectome, tmp_path):
    """On the graphed backend the resident session's tensors alias the
    static buffers: its suspend drops its references, and the buffers, the
    graphs and the tables stay."""
    sim = _sharded(connectome, "graphed")
    sim.run(1.5)
    io = sim.backend._io
    assert sim.state.ring.data_ptr() == io.sim.ring.data_ptr()
    sim.suspend(str(tmp_path))
    assert sim.backend._io is io and sim.backend.graphs.misses > 0
    sim.resume(str(tmp_path))
    sim.run(1.5)
    assert sim.state.ring.data_ptr() == io.sim.ring.data_ptr()


# ---------------------------------------------------------------------------
# (b), (c) gloo worlds, and the reference's own sharded checkpoint
# ---------------------------------------------------------------------------

WORKER = """
    import datetime, os, sys
    import numpy as np, torch, torch.distributed as dist
    torch.set_num_threads(1)
    torch.set_flush_denormal(True)
    rank, size, store_path, out, ck, loaded = (
        int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
        sys.argv[5], sys.argv[6])
    dist.init_process_group(
        "gloo", store=dist.FileStore(store_path, size), rank=rank,
        world_size=size, timeout=datetime.timedelta(seconds={rendezvous}))
    from repro_torch import convert
    from repro_torch.api import Simulator, StreamProbe
    from repro_torch.checkpoint import checkpointer as CK
    from repro_torch.configs.microcircuit import MicrocircuitConfig
    from repro_torch.core.connectivity import build_connectome
    from repro_torch.core.distributed import world_layout
    CFG = MicrocircuitConfig(scale={scale}, strategy="ell",
                             t_presim={presim}, seed={seed})
    STEPS = {steps}
    {raster}
    c = build_connectome(scale=CFG.scale, seed=CFG.seed)
    n_pad, _ = world_layout(c.n_total, size)
    session = lambda key=None: Simulator(
        CFG, connectome=c, backend="sharded", device="cpu", key=key,
        probes=("pop_counts", raster(STEPS, n_pad)))
    state_of = lambda sim: {{k: getattr(sim.state, k).numpy().copy()
                            for k in ("V", "I_ex", "I_in", "refrac",
                                      "ring", "t", "overflow")}}
    res = {{}}

    def keep(tag, sim, r):
        res[tag + "_counts"] = r["pop_counts"]
        res[tag + "_raster"] = r.streams["raster"]["carry"]["rows"]
        for k, v in state_of(sim).items():
            res[tag + "_" + k] = v
        res[tag + "_generator"] = sim._generator.get_state().numpy()

    a = session()
    a.run(1.5, probes=("pop_counts",))
    path = a.save(os.path.join(ck, "a"))
    res["path"] = np.asarray(path)
    for k, v in state_of(a).items():
        res["saved_" + k] = v
    res["saved_generator"] = a._generator.get_state().numpy()
    keep("a", a, a.run(STEPS * 0.1))
    b = session(key=9)
    b.restore(os.path.join(ck, "a"))
    keep("b", b, b.run(STEPS * 0.1))
    a.suspend(os.path.join(ck, "s"))
    a.resume(os.path.join(ck, "s"))
    keep("resumed", a, a.run(STEPS * 0.1))
    keep("b2", b, b.run(STEPS * 0.1))
    # the reference's eager state, loaded through convert and saved
    arrays = dict(np.load(loaded))
    j = session()
    j.state = convert.sharded_to_torch(arrays, rank, size, "cpu")[1]
    j.save(os.path.join(ck, "jax"))
    np.savez(out, **res)
    dist.destroy_process_group()
"""


def _run_world(code: str, size: int, tmp: Path, extra=()) -> list:
    """``size`` ranks of ``code`` over gloo, one subprocess each (``rank
    size store out *extra``); returns each rank's npz.  A rank that fails
    or outlives its timeout fails the test, and every rank is ended."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(r), str(size), str(tmp / "store"),
         str(tmp / f"rank{r}.npz"), *map(str, extra)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for r in range(size)]
    errors = []
    try:
        for r, p in enumerate(procs):
            try:
                _, err = p.communicate(timeout=SUBPROCESS_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                errors.append(f"rank {r} outlived {SUBPROCESS_TIMEOUT_S} s")
                continue
            if p.returncode != 0:
                errors.append(f"rank {r} exited {p.returncode}: "
                              f"{err[-2000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if errors:
        pytest.fail("; ".join(errors))
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(size)
            if (tmp / f"rank{r}.npz").exists()]


@pytest.fixture(scope="module", params=[2, 4])
def gloo_ckpt_world(request, tmp_path_factory, jax_dc_reference):
    size = request.param
    tmp = tmp_path_factory.mktemp(f"gloo_ckpt_{size}")
    arrays, _ = _global_sharded_arrays(jax_dc_reference["c"],
                                       jax_dc_reference["start"], size)
    np.savez(tmp / "loaded.npz", **arrays)
    code = textwrap.dedent(WORKER).format(
        rendezvous=RENDEZVOUS_TIMEOUT_S, scale=SCALE, seed=SEED,
        presim=CFG.t_presim, steps=STEPS, raster=RASTER)
    ranks = _run_world(code, size, tmp, (tmp / "ck", tmp / "loaded.npz"))
    return size, ranks, tmp / "ck", arrays


def _read(path) -> tuple:
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(path, "host_0.npz")) as f:
        return manifest, dict(f)


def test_gloo_ranks_continue_bitwise(gloo_ckpt_world):
    """On every rank: the restored session's run is the uninterrupted
    one's, and the resumed session's is its twin's (counts, registry,
    shard, generator)."""
    size, ranks, _, _ = gloo_ckpt_world
    assert ranks[0]["a_counts"].sum() > 0
    for got in ranks:
        for tag, want in (("b", "a"), ("resumed", "b2")):
            for k in ("counts", "raster", "V", "I_ex", "I_in", "refrac",
                      "ring", "t", "overflow", "generator"):
                np.testing.assert_array_equal(got[f"{tag}_{k}"],
                                              got[f"{want}_{k}"],
                                              err_msg=f"{tag} {k}")
        np.testing.assert_array_equal(got["a_counts"], ranks[0]["a_counts"])
        assert str(got["path"]) == str(ranks[0]["path"])


def test_gloo_file_is_the_shards_in_the_reference_layout(gloo_ckpt_world):
    """Rank 0's file is ``convert.sharded_to_numpy`` of the ranks' shards
    at the save, and row r of its generator leaf rank r's generator."""
    size, ranks, _, _ = gloo_ckpt_world
    manifest, saved = _read(str(ranks[0]["path"]))
    shards = [(None, DD.ShardedSimState(
        generator=None, **{k: torch.from_numpy(got["saved_" + k])
                           for k in ("V", "I_ex", "I_in", "refrac", "ring",
                                     "t", "overflow")})) for got in ranks]
    want = convert.sharded_to_numpy(shards)
    for k, v in want.items():
        np.testing.assert_array_equal(saved[f"['state']||.{k}"], v,
                                      err_msg=k)
        assert manifest["leaves"][f"['state']||.{k}"]["shape"] == \
            list(v.shape)
    np.testing.assert_array_equal(
        saved["['state']||.generator"],
        np.stack([got["saved_generator"] for got in ranks]))
    assert saved["['state']||.ring"].shape[2] == ranks[0]["saved_V"].shape[
        0] * size + size
    assert int(saved["['steps_done']"]) == 15


JAX_WORKER = """
    import sys
    import numpy as np
    import jax.numpy as jnp
    from repro.api.simulator import Simulator
    from repro.configs.microcircuit import MicrocircuitConfig
    from repro.core.distributed import ShardedSimState
    out, loaded = sys.argv[1], sys.argv[2]
    sim = Simulator(MicrocircuitConfig(scale={scale}, strategy="ell",
                                       t_presim=0.0, seed={seed}),
                    backend="sharded", n_devices=4)
    sim.save(out + "/fresh")
    a = np.load(loaded)
    sim._state = ShardedSimState(
        V=jnp.asarray(a["V"]), I_ex=jnp.asarray(a["I_ex"]),
        I_in=jnp.asarray(a["I_in"]), refrac=jnp.asarray(a["refrac"]),
        ring=jnp.asarray(a["ring"]), t=jnp.asarray(a["t"]),
        key=sim._state.key, overflow=jnp.asarray(a["overflow"]))
    sim.save(out + "/loaded")
"""


@pytest.fixture(scope="module")
def jax_sharded_checkpoints(tmp_path_factory, jax_dc_reference):
    """The reference's sharded checkpoints over a mesh of 4 CPU devices:
    a fresh session's, and one holding the eager JAX state."""
    tmp = tmp_path_factory.mktemp("jax_sharded_ckpt")
    arrays, _ = _global_sharded_arrays(jax_dc_reference["c"],
                                       jax_dc_reference["start"], 4)
    np.savez(tmp / "loaded.npz", **arrays)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    proc = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(JAX_WORKER).format(
            scale=SCALE, seed=SEED), str(tmp), str(tmp / "loaded.npz")],
        capture_output=True, text=True, env=env,
        timeout=SUBPROCESS_TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return {name: _read(os.path.join(tmp, name, "step_00000000"))
            for name in ("fresh", "loaded")}


GENERATOR_LEAVES = ("['state']||.generator", "['state']||.key")


def test_leaves_equal_the_reference_checkpoint(gloo_ckpt_world,
                                               jax_sharded_checkpoints):
    """Names, shapes and dtypes of every leaf but the generator rows equal
    the reference's; the values too, for one state in both packages."""
    size, _, ck, arrays = gloo_ckpt_world
    manifest, saved = _read(os.path.join(ck, "jax", "step_00000000"))
    ours = {k: v for k, v in manifest["leaves"].items()
            if k not in GENERATOR_LEAVES}
    for k in ours:
        if k.startswith("['state']||."):
            np.testing.assert_array_equal(saved[k], arrays[k[12:]],
                                          err_msg=k)
    assert manifest["leaves"]["['state']||.generator"]["shape"][0] == size
    if size != 4:
        return
    for name in ("fresh", "loaded"):
        ref_manifest, ref = jax_sharded_checkpoints[name]
        theirs = {k: v for k, v in ref_manifest["leaves"].items()
                  if k not in GENERATOR_LEAVES}
        assert ours == theirs
        assert ref_manifest["leaves"]["['state']||.key"]["shape"] == [4, 2]
    _, ref = jax_sharded_checkpoints["loaded"]
    for k in ours:
        assert saved[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(saved[k], ref[k], err_msg=k)


# ---------------------------------------------------------------------------
# (d) mismatches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("gloo_ckpt_world", [4], indirect=True)
@pytest.mark.parametrize("case", ["four_ranks_into_one", "fused_into_sharded",
                                  "sharded_into_fused"])
def test_restore_mismatch_names_the_leaf(gloo_ckpt_world, connectome,
                                         tmp_path, monkeypatch, case):
    _, _, ck, _ = gloo_ckpt_world
    c = connectome
    fused = Simulator(CFG, connectome=c, device="cpu")
    sharded = Simulator(CFG, connectome=c, backend="sharded", device="cpu")
    if case == "four_ranks_into_one":
        src, dst, words = os.path.join(ck, "a"), sharded, r"\.ring"
    elif case == "fused_into_sharded":
        src, dst = str(tmp_path), sharded
        fused.save(src)
        words = r"\['state'\]\|\|\.V"
    else:
        src, dst = str(tmp_path), fused
        sharded.save(src)
        words = r"\['state'\]\|\|\.neuron\|\|\.V"

    def no_read(*args, **kwargs):
        raise AssertionError("an array was read before the check")
    monkeypatch.setattr(CK.np, "load", no_read)
    with pytest.raises(CK.CheckpointMismatchError, match=words):
        dst.restore(src)


# ---------------------------------------------------------------------------
# (e) the session server
# ---------------------------------------------------------------------------

SERVE_EXP = Experiment(model=CFG, backend="sharded",
                       probes=("pop_counts", "total_counts"), name="sharded")


def test_served_sharded_session_suspends_and_coalesces(tmp_path):
    """Sessions of one sharded scenario share one world-of-one backend;
    a suspended and resumed session runs on as its twin, and a coalesced
    group as the sessions run one by one."""
    from repro_torch.serve import SessionManager
    with SessionManager(root=str(tmp_path), device="cpu") as mgr:
        a, twin = mgr.create(SERVE_EXP, seed=3), mgr.create(SERVE_EXP,
                                                            seed=3)
        assert a.sim.backend is twin.sim.backend
        assert a.sim.backend.name == "sharded" and a.sim.backend.n_dev == 1
        for s in (a, twin):
            s.run(1.5, chunk_ms=0.5)
        a.suspend()
        assert a.status == "suspended" and a.sim.suspended
        a.resume()
        _assert_same_run(a.run(2.0), twin.run(2.0))
        _assert_same_state(a.sim.state, twin.sim.state)
        co = [mgr.create(SERVE_EXP, seed=s) for s in (4, 5)]
        seq = [mgr.create(SERVE_EXP, seed=s) for s in (4, 5)]
        got = mgr.run_many({s.id: 10.0 for s in co}, coalesce=True)
        want = mgr.run_many({s.id: 10.0 for s in seq}, coalesce=False)
        for x, y in zip(co, seq):
            _assert_same_run(got[x.id], want[y.id])
            _assert_same_state(x.sim.state, y.sim.state)
        assert got[co[0].id]["pop_counts"].sum() > 0
        assert not np.array_equal(got[co[0].id]["pop_counts"],
                                  got[co[1].id]["pop_counts"])


SERVE_WORKER = """
    import datetime, sys
    import torch.distributed as dist
    rank, size, store_path = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    dist.init_process_group(
        "gloo", store=dist.FileStore(store_path, size), rank=rank,
        world_size=size, timeout=datetime.timedelta(seconds={rendezvous}))
    from repro_torch.api import Experiment
    from repro_torch.configs.microcircuit import MicrocircuitConfig
    from repro_torch.serve import SessionManager
    exp = Experiment(model=MicrocircuitConfig(scale={scale},
                                              strategy="ell"),
                     backend="sharded")
    with SessionManager(device="cpu") as mgr:
        try:
            mgr.create(exp)
        except ValueError as e:
            assert "world of one" in str(e) and "2 ranks" in str(e), e
        else:
            raise SystemExit("a sharded scenario was served in a group")
        assert mgr.pool.stats()["misses"] == 0
    dist.destroy_process_group()
"""


def test_server_in_a_group_refuses_a_sharded_scenario(tmp_path):
    code = textwrap.dedent(SERVE_WORKER).format(
        rendezvous=RENDEZVOUS_TIMEOUT_S, scale=SCALE)
    _run_world(code, 2, tmp_path)
