"""The port's sharded backend against the JAX package and its fused backend,
on the CPU.

Scale 0.02 (N = 1,544), ``ell``.  Tolerance: none; subnormals are flushed
as XLA flushes them (``tests/test_torch_simulator.py``).

1. ``localize_ell`` equals the reference's bit for bit (tables, ``k_ext``,
   ``i_dc``, meta) for 1, 2, 3, 4 and 8 ranks and a ``k_loc`` above the
   largest cell; below it both raise ``ValueError``.
2. A world of one (no process group) is the fused session under the
   Poisson background: population counts, the raster (a stream probe of
   the gathered registry), ``spike_stats``' carry, the final shard and the
   generator, all bitwise (``tests/test_api.py:40``,
   ``tests/test_fused_step.py:281``, ``tests/test_validate.py:106``).
3. 2 and 4 ranks held in one process against the eager JAX loop, from a
   carried JAX state with spikes in flight, under a deterministic ``dc()``
   drive: the registry, the population counts and the final state,
   reassembled in the reference's layout.
4. 2 and 4 ranks over gloo, each a subprocess (a ``FileStore`` in
   ``tmp_path``, every subprocess under a timeout of 120 s, the
   rendezvous under 60 s, so that a hung world fails its own tests):
   under ``dc()`` the world of one's registry and counts, bitwise; under
   the background, two runs from one seed agree and every rank records
   the same counts.
5. The refusals, with the reference's exception types and words.  (A
   sharded session's checkpoints: ``tests/test_torch_sharded_checkpoint.py``.)
"""
import dataclasses
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.api.simulator import Simulator as JaxSimulator
from repro.configs.microcircuit import MicrocircuitConfig as JaxConfig
from repro.core import stimulus as JS
from repro.core.connectivity import build_connectome as jax_build_connectome
from repro.core.distributed import localize_ell as jax_localize_ell
from repro.core.engine import deliver_phase as jax_deliver_phase
from repro.core.engine import update_phase as jax_update_phase
from repro.core.neuron import NeuronParams as JaxNeuronParams
from repro_torch import convert
from repro_torch.api import Simulator, StreamProbe, probes, spike_stats
from repro_torch.configs.microcircuit import MicrocircuitConfig
from repro_torch.core import delivery as dlv
from repro_torch.core import distributed as DD
from repro_torch.core import stimulus as S
from repro_torch.core.connectivity import build_connectome
from repro_torch.core.engine import SimConfig, resolve_sim_config
from repro_torch.core.neuron import Propagators
from repro_torch.core.params import NeuronParams

SCALE, SEED, DT = 0.02, 55, 0.1
ROOT = Path(__file__).resolve().parent.parent
CFG = MicrocircuitConfig(scale=SCALE, strategy="ell", t_presim=20.0,
                         seed=SEED)
#: the deterministic drive: a DC current into every neuron (the background's
#: DC equivalent leaves a network of this size silent)
DC = ({"kind": "dc", "amplitude_pa": 400.0},)
#: the gloo worlds' timeouts: each subprocess, and its rendezvous
SUBPROCESS_TIMEOUT_S, RENDEZVOUS_TIMEOUT_S = 120, 60


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _flush_subnormals_like_xla():
    assert torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)


@pytest.fixture(scope="module")
def connectome():
    return build_connectome(scale=SCALE, seed=SEED)


@pytest.fixture(scope="module")
def jax_connectome():
    return jax_build_connectome(scale=SCALE, seed=SEED)


#: a stream probe of the step's spike vector (``width`` long; on the
#: sharded backend the gathered registry): the ``[n_steps, width]`` raster
#: of a run of
#: ``n_steps`` (a session's next run overwrites it); its source also runs
#: in the gloo ranks' subprocesses
RASTER = """
def raster(n_steps, width):
    def init(device=None):
        return {"i": torch.zeros((), dtype=torch.int64, device=device),
                "rows": torch.zeros((n_steps, width), dtype=torch.bool,
                                    device=device)}

    def update(carry, spiked):
        at = torch.remainder(carry["i"], n_steps).view(1)
        return {"i": carry["i"] + 1,
                "rows": carry["rows"].index_copy(0, at, spiked.view(1, -1))}
    return StreamProbe(name="raster", init=init, update=update)
"""
exec(RASTER)


# ---------------------------------------------------------------------------
# 1. localize_ell
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_dev,k_loc", [(1, None), (2, None), (3, None),
                                         (4, None), (8, None), (2, "wider"),
                                         (4, "below_max")])
def test_localize_ell_bitwise(connectome, jax_connectome, n_dev, k_loc):
    c_jax = jax_connectome
    want, meta = jax_localize_ell(c_jax, n_dev)
    if k_loc == "below_max":
        for fn in (jax_localize_ell, DD.localize_ell):
            with pytest.raises(ValueError, match="k_loc"):
                fn(c_jax if fn is jax_localize_ell else connectome, n_dev,
                   meta["k_loc"] - 1)
        return
    if k_loc == "wider":
        want, meta = jax_localize_ell(c_jax, n_dev, meta["k_loc"] + 3)
        got, got_meta = DD.localize_ell(connectome, n_dev, meta["k_loc"])
    else:
        got, got_meta = DD.localize_ell(connectome, n_dev)
    assert got_meta == meta
    assert meta["n_pad"] % n_dev == 0 and meta["n_pad"] >= connectome.n_total
    for name in want._fields:
        a, b = np.asarray(getattr(want, name)), getattr(got, name).numpy()
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(b, a, err_msg=name)


def test_localized_shards_hold_the_connectome_once(connectome):
    """Every real (source, global target, weight, delay bin) entry lies in
    exactly one rank's block, once."""
    c = connectome
    tables, meta = DD.localize_ell(c, 3)
    n_loc = meta["n_loc"]
    got = []
    for r in range(3):
        sh = DD.shard_of(tables, meta, r)
        assert sh.targets.shape == (meta["n_pad"] + 1, meta["k_loc"])
        assert sh.targets.is_contiguous()
        src, col = np.nonzero(sh.targets.numpy() < n_loc)
        got.append(np.stack([src, sh.targets.numpy()[src, col] + r * n_loc,
                             sh.weights.numpy()[src, col].view(np.int32),
                             sh.dbins.numpy()[src, col]], 1))
    src, col = np.nonzero(c.targets < c.n_total)
    want = np.stack([src, c.targets[src, col],
                     c.weights[src, col].view(np.int32),
                     c.dbins[src, col]], 1)
    key = lambda a: a[np.lexsort(a.T[::-1])]
    np.testing.assert_array_equal(key(np.concatenate(got)), key(want))


# ---------------------------------------------------------------------------
# 2. A world of one against the fused session
# ---------------------------------------------------------------------------

def _shard_equals_fused(shard, fused):
    for name in ("V", "I_ex", "I_in", "refrac"):
        assert torch.equal(getattr(shard, name),
                           getattr(fused.neuron, name)), name
    for name in ("ring", "t", "overflow"):
        assert torch.equal(getattr(shard, name), getattr(fused, name)), name


def test_world_of_one_equals_fused(connectome):
    """Two runs after the presim: population and total counts, the raster
    and the final state bitwise, the generator where the fused one is."""
    n_steps = 80
    out = {}
    for backend in ("fused", "sharded"):
        sim = Simulator(CFG, connectome=connectome, backend=backend,
                        device="cpu", probes=("pop_counts", "total_counts",
                                              raster(n_steps,
                                                     connectome.n_total)))
        runs = [sim.run(n_steps * DT) for _ in range(2)]
        out[backend] = sim, runs
    (fused, f_runs), (sharded, s_runs) = out["fused"], out["sharded"]
    assert sharded.sim_config.kernels.step == "split"
    assert sharded.backend.meta == {"n_pad": connectome.n_total,
                                    "n_loc": connectome.n_total,
                                    "k_loc": sharded.backend.meta["k_loc"],
                                    "n_dev": 1}
    assert sum(int(r["pop_counts"].sum()) for r in f_runs) > 20
    for a, b in zip(f_runs, s_runs):
        for name in ("pop_counts", "total_counts"):
            np.testing.assert_array_equal(b[name], a[name], err_msg=name)
        np.testing.assert_array_equal(b.streams["raster"]["carry"]["rows"],
                                      a.streams["raster"]["carry"]["rows"])
        assert a.overflow == b.overflow == 0
    _shard_equals_fused(sharded.state, fused.state)
    assert torch.equal(sharded._generator.get_state(),
                       fused._generator.get_state())


def test_world_of_one_spike_stats_carry(connectome):
    """The chunk-streaming probe on the sharded backend gives the fused
    backend's carry bitwise (mirrors ``tests/test_validate.py:106``)."""
    from repro_torch.validate import sample_ids
    probe = spike_stats(sample_ids(connectome.pop_sizes, per_pop=10, seed=3),
                        bin_steps=10)
    carries = []
    for backend in ("fused", "sharded"):
        sim = Simulator(CFG, connectome=connectome, backend=backend,
                        device="cpu", probes=("pop_counts", probe))
        carries.append(sim.run(20.0).streams["spike_stats"]["carry"])
    want, got = carries
    assert int(want.steps) == 200
    for f in want._fields:
        np.testing.assert_array_equal(np.asarray(getattr(got, f)),
                                      np.asarray(getattr(want, f)), f)


def test_experiment_reaches_the_sharded_backend(connectome):
    """``Experiment(backend="sharded")`` runs a world of one, its two
    trials through ``run_batch``: the fused experiment's counts, bitwise,
    trial by trial."""
    from repro_torch.api import Experiment
    counts = {}
    for backend in ("fused", "sharded"):
        exp = Experiment(model=CFG, backend=backend, duration_ms=10.0,
                         trials=2)
        res = exp.run(connectome=connectome, device="cpu")
        counts[backend] = [r["pop_counts"] for r in res.trials]
    assert counts["fused"][0].sum() > 0
    assert not np.array_equal(*counts["fused"])
    for got, want in zip(counts["sharded"], counts["fused"], strict=True):
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# 3. Ranks in one process against the eager JAX loop
# ---------------------------------------------------------------------------

N_STEPS = 100


@pytest.fixture(scope="module")
def jax_dc_reference():
    """The JAX state of ``tests/test_torch_simulator.py``'s fixture (100 ms
    of the jitted reference path), then 100 eager steps under ``dc()``."""
    sim = JaxSimulator(JaxConfig(scale=SCALE, strategy="ell", t_presim=0.0),
                       kernels="reference")
    sim.run(100.0)
    b, st = sim.backend, sim.state
    c = b.c
    start = {"V": np.asarray(st.neuron.V), "I_ex": np.asarray(st.neuron.I_ex),
             "I_in": np.asarray(st.neuron.I_in),
             "refrac": np.asarray(st.neuron.refrac),
             "ring": np.asarray(st.ring), "t": np.asarray(st.t),
             "overflow": np.asarray(st.overflow)}
    drive = JS.compile_drive(JS.resolve_timeline(DC), c, b.cfg,
                             JaxNeuronParams())
    spikes = []
    for _ in range(N_STEPS):
        st, spk = jax_update_phase(st, b.net, b.prop, b.cfg, c.w_ext,
                                   c.n_total, drive)
        st = jax_deliver_phase(st, b.net, b.cfg, spk, c.n_exc)
        spikes.append(np.asarray(spk))
    final = {"V": np.asarray(st.neuron.V), "I_ex": np.asarray(st.neuron.I_ex),
             "I_in": np.asarray(st.neuron.I_in),
             "refrac": np.asarray(st.neuron.refrac),
             "ring": np.asarray(st.ring), "t": np.asarray(st.t),
             "overflow": np.asarray(st.overflow)}
    return dict(c=c, start=start, spikes=np.stack(spikes), final=final,
                budget=b.cfg.spike_budget, pop_of=np.asarray(c.pop_of))


def _global_sharded_arrays(c_jax, start, n_dev):
    """The reference's global sharded layout of a fused JAX state: its
    tables by ``localize_ell``, the neuron state padded (V with V_reset),
    the ring's columns cut into each rank's ``n_loc`` and a dump column."""
    tables, meta = jax_localize_ell(c_jax, n_dev)
    n, n_pad, n_loc = c_jax.n_total, meta["n_pad"], meta["n_loc"]
    pad = lambda a, v=0: np.concatenate(
        [a, np.full(n_pad - n, v, a.dtype)])
    ring = start["ring"]
    blocks = np.zeros((ring.shape[0], 2, n_pad + n_dev), np.float32)
    for r in range(n_dev):
        lo, hi = r * n_loc, min((r + 1) * n_loc, n)
        blocks[:, :, r * (n_loc + 1):r * (n_loc + 1) + hi - lo] = \
            ring[:, :, lo:hi]
    arrays = {name: np.asarray(getattr(tables, name))
              for name in tables._fields}
    arrays.update(V=pad(start["V"], np.float32(-65.0)),
                  I_ex=pad(start["I_ex"]), I_in=pad(start["I_in"]),
                  refrac=pad(start["refrac"]), ring=blocks, t=start["t"],
                  overflow=np.full(n_dev, start["overflow"], np.int32))
    return arrays, meta


@pytest.mark.parametrize("n_dev", [2, 4])
def test_ranks_in_one_process_bitwise_vs_jax_eager(jax_dc_reference,
                                                  connectome, n_dev):
    """Each rank delivers the gathered registry through its own block, in
    the order ``index_add_`` takes the block's entries: source by source,
    and within a source's cell by local target, multapses to one target in
    their column order (``localize_ell``'s stable sort keeps it).  A ring
    cell therefore receives the same weights in the same order as the
    reference's ``deliver_event`` adds them through the whole row (source
    by source, column by column), so every float sum is the reference's,
    bit for bit; the update is elementwise over the rank's slice."""
    ref = jax_dc_reference
    c = connectome
    arrays, meta = _global_sharded_arrays(ref["c"], ref["start"], n_dev)
    n, n_pad, n_loc = c.n_total, meta["n_pad"], meta["n_loc"]
    cfg = resolve_sim_config(SimConfig(strategy="ell", kernels="split",
                                       spike_budget=ref["budget"],
                                       stimulus=DC), c, "cpu")
    prop = Propagators.make(NeuronParams(), DT)
    drive = S.compile_drive(cfg.stimulus, c, cfg, NeuronParams(), "cpu")
    pop_of = DD.padded_pop_of(c.pop_of, n_pad, 8, "cpu")
    shards = [convert.sharded_to_torch(arrays, r, n_dev, "cpu")
              for r in range(n_dev)]
    nets = [DD.shard_network(tb, pop_of) for tb, _ in shards]
    drives = [drive.shard(n_pad, r * n_loc, (r + 1) * n_loc, "cpu")
              for r in range(n_dev)]
    states = [st for _, st in shards]
    count = probes.pop_counts()
    registry, counts = [], []
    for _ in range(N_STEPS):
        states, spk = DD.step_shards(states, nets, prop, cfg, w_ext=c.w_ext,
                                     n_exc=c.n_exc, drives=drives)
        registry.append(spk.numpy().copy())
        counts.append(count(probes.ProbeContext(None, spk, nets[0], 8))
                      .numpy())
    registry = np.stack(registry)
    assert ref["spikes"].sum() > 20
    np.testing.assert_array_equal(registry[:, :n], ref["spikes"])
    assert not registry[:, n:].any()
    want_counts = np.stack([ref["spikes"][:, ref["pop_of"] == p].sum(1)
                            for p in range(8)], 1)
    np.testing.assert_array_equal(np.stack(counts), want_counts)
    got = convert.sharded_to_numpy([(tb, st) for (tb, _), st
                                    in zip(shards, states)])
    for name in ("targets", "weights", "dbins", "k_ext", "i_dc"):
        np.testing.assert_array_equal(got[name], arrays[name], err_msg=name)
    want = ref["final"]
    for name in ("V", "I_ex", "I_in", "refrac"):
        np.testing.assert_array_equal(got[name][:n], want[name],
                                      err_msg=name)
    ring = np.concatenate([got["ring"][:, :, r * (n_loc + 1):
                                       r * (n_loc + 1) + n_loc]
                           for r in range(n_dev)], 2)
    np.testing.assert_array_equal(ring[:, :, :n], want["ring"][:, :, :n])
    assert not ring[:, :, n:].any()
    assert got["t"] == want["t"]
    np.testing.assert_array_equal(got["overflow"],
                                  np.full(n_dev, want["overflow"]))


def test_sharded_convert_round_trip(jax_dc_reference):
    arrays, _ = _global_sharded_arrays(jax_dc_reference["c"],
                                       jax_dc_reference["start"], 4)
    back = convert.sharded_to_numpy([convert.sharded_to_torch(
        arrays, r, 4, "cpu") for r in range(4)])
    assert set(back) == set(convert.SHARDED_KEYS)
    for name in convert.SHARDED_KEYS:
        np.testing.assert_array_equal(back[name], arrays[name], err_msg=name)
    with pytest.raises(KeyError, match="ring"):
        convert.sharded_to_torch({k: v for k, v in arrays.items()
                                  if k != "ring"}, 0, 4, "cpu")
    with pytest.raises(ValueError, match="split evenly"):
        convert.sharded_to_torch(arrays, 0, 3, "cpu")


# ---------------------------------------------------------------------------
# 4. Ranks over gloo, one subprocess each
# ---------------------------------------------------------------------------

GLOO_STEPS = 150
WORKER = """
    import datetime, sys
    import numpy as np, torch, torch.distributed as dist
    torch.set_num_threads(1)
    torch.set_flush_denormal(True)
    rank, size, store_path, out = (int(sys.argv[1]), int(sys.argv[2]),
                                   sys.argv[3], sys.argv[4])
    dist.init_process_group(
        "gloo", store=dist.FileStore(store_path, size), rank=rank,
        world_size=size, timeout=datetime.timedelta(seconds={rendezvous}))
    from repro_torch.api import Simulator, StreamProbe
    from repro_torch.configs.microcircuit import MicrocircuitConfig
    from repro_torch.core.connectivity import build_connectome
    from repro_torch.core.distributed import world_layout
    CFG = MicrocircuitConfig(scale={scale}, strategy="ell",
                             t_presim={presim}, seed={seed})
    DC = {dc!r}
    GLOO_STEPS = {steps}
    {raster}
    c = build_connectome(scale=CFG.scale, seed=CFG.seed)
    n_pad, _ = world_layout(c.n_total, size)
    res = {{}}
    for name, stimulus in (("dc", DC), ("bg_a", None), ("bg_b", None)):
        sim = Simulator(CFG, connectome=c, backend="sharded", device="cpu",
                        stimulus=stimulus,
                        probes=("pop_counts", raster(GLOO_STEPS, n_pad)))
        assert sim.backend.n_dev == size and sim.backend.world.rank == rank
        r = sim.run(GLOO_STEPS * 0.1)
        res[name + "_counts"] = r["pop_counts"]
        res[name + "_raster"] = r.streams["raster"]["carry"]["rows"]
        res[name + "_overflow"] = np.asarray(r.overflow)
    res["V"] = sim.state.V.numpy()
    np.savez(out, **res)
    dist.destroy_process_group()
"""


@pytest.fixture(scope="module", params=[2, 4])
def gloo_world(request, tmp_path_factory):
    """Run a world of ``P`` gloo ranks, one subprocess each; returns each
    rank's results.  Any rank that fails or outlives its timeout fails the
    fixture, and every rank is ended."""
    size = request.param
    tmp = tmp_path_factory.mktemp(f"gloo_{size}")
    code = textwrap.dedent(WORKER).format(
        rendezvous=RENDEZVOUS_TIMEOUT_S, scale=SCALE, seed=SEED,
        presim=CFG.t_presim, dc=DC,
        steps=GLOO_STEPS, raster=RASTER)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(r), str(size),
         str(tmp / "store"), str(tmp / f"rank{r}.npz")],
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
    return size, [dict(np.load(tmp / f"rank{r}.npz")) for r in range(size)]


@pytest.fixture(scope="module")
def world_of_one_dc(connectome):
    sim = Simulator(CFG, connectome=connectome, backend="sharded",
                    device="cpu", stimulus=DC,
                    probes=("pop_counts", raster(GLOO_STEPS,
                                                 connectome.n_total)))
    r = sim.run(GLOO_STEPS * DT)
    return r["pop_counts"], r.streams["raster"]["carry"]["rows"]


def test_gloo_ranks_equal_world_of_one_under_dc(gloo_world,
                                                world_of_one_dc, connectome):
    size, ranks = gloo_world
    counts, rows = world_of_one_dc
    n = connectome.n_total
    assert counts.sum() > 20
    for got in ranks:
        np.testing.assert_array_equal(got["dc_counts"], counts)
        np.testing.assert_array_equal(got["dc_raster"][:, :n], rows)
        assert not got["dc_raster"][:, n:].any()
        assert got["dc_raster"].shape[1] % size == 0
        assert int(got["dc_overflow"]) == 0


def test_gloo_ranks_repeat_under_the_background(gloo_world):
    """Two sessions of one seed give the same run; every rank records the
    same counts and registry; each rank's V is its own slice."""
    size, ranks = gloo_world
    for got in ranks:
        np.testing.assert_array_equal(got["bg_a_counts"], got["bg_b_counts"])
        np.testing.assert_array_equal(got["bg_a_raster"], got["bg_b_raster"])
        np.testing.assert_array_equal(got["bg_a_counts"],
                                      ranks[0]["bg_a_counts"])
        np.testing.assert_array_equal(got["bg_a_raster"],
                                      ranks[0]["bg_a_raster"])
    assert ranks[0]["bg_a_counts"].sum() > 0
    assert not np.array_equal(ranks[0]["bg_a_counts"], ranks[0]["dc_counts"])
    assert sum(g["V"].shape[0] for g in ranks) == \
        ranks[0]["bg_a_raster"].shape[1]


# ---------------------------------------------------------------------------
# 5. Refusals
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _Kick(S.Stimulus):
    """A stimulus in the general ``fn`` form (reads the state)."""

    def compile(self, c, cfg, neuron):
        return S.CompiledStimulus(
            channel="current",
            fn=lambda gen, t, state: (
                (state.neuron.V.mean() < 0).to(torch.float32), None))


REFUSALS = {
    "dense": (ValueError, "shard transform",
              dict(strategy="dense")),
    "fn_stimulus": (NotImplementedError, "separable",
                    dict(stimulus=(S.PoissonBackground(), _Kick()))),
    "plasticity": (NotImplementedError, "sharded",
                   dict(plasticity="pair_stdp")),
    "voltage_probe": (NotImplementedError, "sharded",
                      dict(probes=("voltage",))),
    "n_devices": (ValueError, "n_devices=2 > available 1",
                  dict(n_devices=2)),
    "localize_dense": (NotImplementedError, "'dense' has no shard",
                       "localize"),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_refusals(connectome, case):
    exc, words, how = REFUSALS[case]
    if how == "localize":
        with pytest.raises(exc, match=words):
            dlv.get_strategy("dense").localize(connectome, 2)
        assert not dlv.get_strategy("dense").supports_sharding
        assert dlv.get_strategy("event").supports_sharding
        return
    how = dict(how)
    cfg = dataclasses.replace(CFG, strategy=how.pop("strategy", "ell"))
    with pytest.raises(exc, match=words):
        Simulator(cfg, connectome=connectome, backend="sharded",
                  device="cpu", **how)
