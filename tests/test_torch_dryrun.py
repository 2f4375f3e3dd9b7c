"""repro_torch.launch.dryrun and the rest of ``core/distributed``: the
``meta`` layouts against the reference's abstract layouts and shardings,
the dry run's ``--all`` on the CPU with nothing allocated, and
``make_dense_step`` held to the reference's (scale 0.01) and across gloo
worlds of 2 and 4 ranks."""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding, PartitionSpec as P

from repro.core import distributed as JDD
from repro.core.neuron import NeuronParams as JaxNeuronParams
from repro.core.neuron import Propagators as JaxPropagators
from repro_torch.core import distributed as DD
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as M
from repro_torch.sharding.rules import local_shape, spec_of

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_dense_world import STEPS, dense_inputs, run_dense  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
N_PAD, D_RING = 77312, 46
LAYOUTS = {"pod1": ((16, 16), ("data", "model")),
           "pod2": ((2, 16, 16), ("pod", "data", "model"))}

#: V within 1e-4 mV and the ring within 1e-5 of its values (plus 1e-3 pA):
#: XLA contracts multiply-adds into FMAs and sums the einsum in its own
#: order, and an all-reduce sums the ranks' partial sums in another one
V_ATOL, RING_RTOL, RING_ATOL = 1e-4, 1e-5, 1e-3
SUBPROCESS_TIMEOUT_S, RENDEZVOUS_TIMEOUT_S = 180, 60


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _shape_dtype(x):
    return tuple(x.shape), str(x.dtype).replace("torch.", "")


def _jax_shape_dtype(x):
    return tuple(x.shape), str(jnp.dtype(x.dtype))


# ---------------------------------------------------------------------------
# The meta layouts against the reference's abstract ones
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh_name", sorted(LAYOUTS))
def test_event_layout_equals_the_reference(mesh_name):
    """The global tables and state: the reference's shapes and dtypes, but
    the generators' states where it holds keys.  One rank's: the global
    ones divided by the reference's ``shard_map`` specs
    (``repro/core/distributed.py:187-192``), but a 0-d overflow per rank
    (the reference's per-device slice is ``[1]``)."""
    shape, names = LAYOUTS[mesh_name]
    n_dev = int(np.prod(shape))
    k_loc = dryrun.event_k_loc(dryrun.full_scale()["n_syn"], 77169, n_dev)
    ref_t = JDD.abstract_sharded_tables({}, n_dev, k_loc, N_PAD)
    ref_s = JDD.abstract_state(N_PAD, n_dev, D_RING)
    tab = DD.abstract_sharded_tables({}, n_dev, k_loc, N_PAD)
    st = DD.abstract_state(N_PAD, n_dev, D_RING)
    assert all(x.device.type == "meta" for x in (*tab, *st))
    for f in DD.ShardedTables._fields:
        assert _shape_dtype(getattr(tab, f)) \
            == _jax_shape_dtype(getattr(ref_t, f)), f
    for f in ("V", "I_ex", "I_in", "refrac", "ring", "t", "overflow"):
        assert _shape_dtype(getattr(st, f)) \
            == _jax_shape_dtype(getattr(ref_s, f)), f
    assert _shape_dtype(st.generator) == ((n_dev, 16), "uint8")
    assert ref_s.key.shape == (n_dev, 2)

    mesh = AbstractMesh(shape, names)
    flat = names
    specs = {"V": P(flat), "I_ex": P(flat), "I_in": P(flat),
             "refrac": P(flat), "ring": P(None, None, flat), "t": P(),
             "targets": P(None, flat), "weights": P(None, flat),
             "dbins": P(None, flat), "k_ext": P(flat), "i_dc": P(flat)}
    rank_st, rank_tab = dryrun.event_rank_args(N_PAD, n_dev, k_loc, D_RING)
    for f, spec in specs.items():
        src = ref_t if f in DD.ShardedTables._fields else ref_s
        want = NamedSharding(mesh, spec).shard_shape(getattr(src, f).shape)
        got = getattr(rank_tab if f in DD.ShardedTables._fields
                      else rank_st, f)
        assert tuple(got.shape) == want, f
    assert rank_st.overflow.shape == () and rank_st.generator.shape == (16,)


@pytest.mark.parametrize("mesh_name", sorted(LAYOUTS))
def test_dense_layout_equals_the_reference(mesh_name):
    shape, names = LAYOUTS[mesh_name]
    ref_s, ref_W, ref_aux = JDD.abstract_dense(N_PAD, D_RING)
    st, W, aux = DD.abstract_dense(N_PAD, D_RING)
    for f in ("V", "I_ex", "I_in", "refrac", "ring", "t", "overflow"):
        assert _shape_dtype(getattr(st, f)) \
            == _jax_shape_dtype(getattr(ref_s, f)), f
    assert _shape_dtype(W) == _jax_shape_dtype(ref_W) \
        == ((D_RING, N_PAD, N_PAD), "bfloat16")
    assert {k: _shape_dtype(v) for k, v in aux.items()} \
        == {k: _jax_shape_dtype(v) for k, v in ref_aux.items()}

    mesh = AbstractMesh(shape, names)
    layout = M.make_production_mesh(multi_pod=mesh_name == "pod2")
    ref_st_sh, ref_w_sh, ref_aux_sh = JDD.dense_shardings(mesh, ref_s,
                                                          ref_W, ref_aux)
    st_sh, w_sh, aux_sh = DD.dense_shardings(layout, st, W, aux)
    assert spec_of(w_sh, layout) == tuple(ref_w_sh.spec)
    assert local_shape(W.shape, w_sh, layout) \
        == ref_w_sh.shard_shape(ref_W.shape)
    for p, r in zip(st_sh, ref_st_sh):
        assert spec_of(p, layout) == tuple(r.spec) == ()
    assert all(spec_of(aux_sh[k], layout) == tuple(ref_aux_sh[k].spec)
               for k in aux)


def test_dry_run_all_allocates_nothing(tmp_path):
    """``--all`` lays out the four cells on the CPU: a dense rank's bf16
    block alone would take 2.15 GB; the process stays far below that."""
    # VmHWM, the peak resident set of this process image (getrusage's
    # maxrss carries the forking parent's over the exec)
    code = textwrap.dedent("""
        import re, sys
        from repro_torch.launch import dryrun
        rc = dryrun.main(["--all", "--force", "--out-dir", sys.argv[1]])
        status = open("/proc/self/status").read()
        print(re.search(r"VmHWM:\\s+(\\d+) kB", status).group(1))
        sys.exit(rc)
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    p = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                       capture_output=True, text=True, env=env, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    maxrss_kb = int(p.stdout.strip().splitlines()[-1])
    assert maxrss_kb < 1_000_000, maxrss_kb
    cells = {f.name: json.loads(f.read_text())
             for f in tmp_path.glob("*.json")}
    assert sorted(cells) == sorted(
        f"microcircuit__{s}__{m}.json" for s in ("event", "dense")
        for m in ("pod1", "pod2"))
    d1 = cells["microcircuit__dense__pod1.json"]
    assert d1["w_block"] == [D_RING, 4832, 4832] and d1["memory"]["fits"]
    # the [D, N/16] partial all-reduced (twice), the [D, N] gathered
    assert d1["collective_wire_bytes_per_device"] \
        == 2 * 4 * D_RING * 4832 + 4 * D_RING * N_PAD
    assert d1["kernels"]["gated_spike_matvec"]["count"] == 1
    e2 = cells["microcircuit__event__pod2.json"]
    assert e2["n_loc"] == N_PAD // 512
    # the registry's all-gather: one byte a neuron
    assert e2["collectives"] == {"all-gather": {"count": 1, "bytes": N_PAD}}
    assert e2["kernels"]["lif_update"]["count"] == 1
    assert e2["kernels"]["ell_deliver_local"]["count"] == 1


def test_reckoned_argument_bytes_equal_a_world_of_one(tmp_path):
    """A world of one's real tables and state (the sharded backend at
    scale 0.02 on the CPU) hold exactly the bytes the dry run reckons for
    its ``k_loc``, but the generator, whose CPU state is not a card's."""
    from repro_torch.api import Simulator
    from repro_torch.configs.microcircuit import MicrocircuitConfig
    sim = Simulator(MicrocircuitConfig(scale=0.02, strategy="ell",
                                       t_presim=0.0), backend="sharded",
                    device="cpu")
    meta = sim.backend.meta
    real = sum(x.numel() * x.element_size()
               for x in (*sim.backend.net.tables, *[
                   v for v in sim.state if isinstance(v, torch.Tensor)]))
    want = dryrun.rank_argument_bytes(sim.connectome.n_total, 1,
                                      meta["k_loc"],
                                      sim.connectome.d_max_bins)
    assert real + DD.GENERATOR_STATE_BYTES == want


# ---------------------------------------------------------------------------
# make_dense_step against the reference, and across gloo worlds
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def world_of_one():
    torch.set_flush_denormal(True)
    try:
        c, W, V0, i_dc, k_ext = dense_inputs()
        return (c, W, V0, i_dc, k_ext), run_dense(M.World2d(), W, V0, i_dc,
                                                  k_ext, c)
    finally:
        torch.set_flush_denormal(False)


def test_dense_step_equals_the_reference(world_of_one):
    """The reference's ``make_dense_step``, jitted on a (1, 1) host mesh:
    the same spikes every step for 100 steps; V and the ring within the
    stated tolerances."""
    (c, W, V0, i_dc, k_ext), (refrac, counts, V, ring) = world_of_one
    n, d = W.shape[1], W.shape[0]
    from repro.launch.mesh import make_host_mesh
    mesh = make_host_mesh()
    prop = JaxPropagators.make(JaxNeuronParams(), 0.1)
    sim = JDD.make_dense_step(mesh, prop, n=n, n_exc=c.n_exc, w_ext=c.w_ext,
                              bg_rate=0.0, dt=0.1, n_steps=1)
    st = JDD.DenseSimState(
        jnp.asarray(V0), jnp.zeros(n), jnp.zeros(n), jnp.zeros(n, jnp.int32),
        jnp.zeros((d, 2, n)), jnp.int32(0), jax.random.PRNGKey(0),
        jnp.int32(0))
    aux = {"k_ext": jnp.asarray(k_ext), "i_dc": jnp.asarray(i_dc)}
    with mesh:
        step = jax.jit(sim)
        jW = jnp.asarray(W)
        for i in range(STEPS):
            st, cnt = step(st, jW, aux)
            np.testing.assert_array_equal(np.asarray(st.refrac), refrac[i],
                                          err_msg=f"step {i}")
            assert int(cnt[0]) == counts[i]
    assert counts.sum() > 100                # the network does spike
    np.testing.assert_allclose(V, np.asarray(st.V), rtol=0, atol=V_ATOL)
    np.testing.assert_allclose(ring, np.asarray(st.ring), rtol=RING_RTOL,
                               atol=RING_ATOL)


WORKER = """
    import datetime, sys
    import numpy as np, torch, torch.distributed as dist
    torch.set_num_threads(1)
    torch.set_flush_denormal(True)
    rank, size, store_path, out = (int(sys.argv[1]), int(sys.argv[2]),
                                   sys.argv[3], sys.argv[4])
    shape = tuple(int(x) for x in sys.argv[5].split("x"))
    dist.init_process_group(
        "gloo", store=dist.FileStore(store_path, size), rank=rank,
        world_size=size, timeout=datetime.timedelta(seconds={rendezvous}))
    sys.path.insert(0, {tests!r})
    from torch_dense_world import dense_inputs, run_dense
    from repro_torch.launch import mesh as M
    c, W, V0, i_dc, k_ext = dense_inputs({n_pad})
    world = M.world2d(M.make_mesh(shape))
    refrac, counts, V, ring = run_dense(world, W, V0, i_dc, k_ext, c)
    if rank == 0:
        np.savez(out, refrac=refrac, counts=counts, V=V, ring=ring)
    dist.destroy_process_group()
"""


def gloo_dense(tmp_path, shape, n_pad):
    size = int(np.prod(shape))
    code = textwrap.dedent(WORKER).format(
        rendezvous=RENDEZVOUS_TIMEOUT_S, tests=str(ROOT / "tests"),
        n_pad=n_pad)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
               JAX_PLATFORMS="cpu")
    out = tmp_path / "rank0.npz"
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(r), str(size),
         str(tmp_path / "store"), str(out), "x".join(map(str, shape))],
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
    return dict(np.load(out))


@pytest.fixture(scope="module")
def padded_world_of_one():
    """The world of one on the network padded to 772 neurons (771 splits
    over neither 2 nor 4 ranks): one silent neuron more."""
    torch.set_flush_denormal(True)
    try:
        c, W, V0, i_dc, k_ext = dense_inputs(772)
        return run_dense(M.World2d(), W, V0, i_dc, k_ext, c)
    finally:
        torch.set_flush_denormal(False)


@pytest.mark.parametrize("shape", [(1, 2), (2, 1), (2, 2)],
                         ids=["1x2", "2x1", "2x2"])
def test_gloo_worlds_equal_the_world_of_one(tmp_path, shape, world_of_one,
                                            padded_world_of_one):
    refrac, counts, V, ring = padded_world_of_one
    # the padding neuron changes nothing of the others
    one = world_of_one[1]
    np.testing.assert_array_equal(refrac[:, :-1], one[0])
    got = gloo_dense(tmp_path, shape, 772)
    np.testing.assert_array_equal(got["refrac"], refrac)
    np.testing.assert_array_equal(got["counts"], counts)
    np.testing.assert_allclose(got["V"], V, rtol=0, atol=V_ATOL)
    np.testing.assert_allclose(got["ring"], ring, rtol=RING_RTOL,
                               atol=RING_ATOL)
