"""Checkpoints of the port's sessions (``repro_torch.checkpoint``), on the
CPU, at scale 0.02.

* save, run on, restore, run again: the second run bitwise the first (the
  probes' data, the state, the generator), static and plastic, on the
  eager loop and on the graphed one (``_GraphedOnCpu``, a CUDA graph's
  stand-in that re-runs the captured segment), where the restore captures
  nothing; ``run_chunked(checkpoint_dir=)`` saving every other chunk, and
  a run restored from its middle checkpoint continuing bitwise;
  ``suspend`` and ``resume`` against a twin that was never suspended.
* the on-disk layout: ``step_%08d/host_0.npz`` and ``manifest.json``
  (schema ``repro.checkpoint/v1``), ``keep`` dropping the oldest,
  ``latest_step``, the asynchronous save.
* ``CheckpointMismatchError`` naming the schema (an unknown one, none, or
  no manifest at all), the leaves missing and extra, and the leaf whose
  shape or dtype differs.
* a static session's checkpoint bitwise the JAX package's of the same
  state (carried across by ``convert``), leaf for leaf under the same
  names, but the JAX ``key``, whose place the port's generator takes.
"""
import json
import os

import numpy as np
import pytest
import torch

from repro.api.simulator import Simulator as JaxSimulator
from repro.configs.microcircuit import MicrocircuitConfig as JaxConfig
from repro_torch import convert
from repro_torch.api import Simulator
from repro_torch.checkpoint import checkpointer as CK
from repro_torch.configs.microcircuit import MicrocircuitConfig
from test_torch_graph_loop import (_GraphedOnCpu, _assert_same_run,
                                   _assert_same_state)

SCALE = 0.02
GRAPH_STEPS = 7
PROBES = ("pop_counts", "spikes", "total_counts")


@pytest.fixture(autouse=True)
def _one_torch_thread_and_flushed_subnormals():
    """One intra-op thread per test (the suite runs several workers);
    subnormals flushed, as the other session tests run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    assert torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)
    torch.set_num_threads(n)


def _session(plastic=False, backend="fused", scale=SCALE, key=None,
             connectome=None):
    rule = "pair_stdp" if plastic else None
    if backend == "graphed":
        backend = _GraphedOnCpu(plasticity=rule, graph_steps=GRAPH_STEPS)
    cfg = MicrocircuitConfig(scale=scale, strategy="ell", t_presim=2.0)
    return Simulator(cfg, backend=backend, plasticity=rule, probes=PROBES,
                     device="cpu", key=key, connectome=connectome)


def _captures(sim) -> int:
    return sum(cache.misses for cache in sim.backend.caches())


@pytest.mark.parametrize("plastic", [False, True],
                         ids=["static", "plastic"])
@pytest.mark.parametrize("backend", ["fused", "graphed"])
def test_restore_continues_bitwise(tmp_path, backend, plastic):
    """save at step 15, run 3.3 ms (A); restore, run 3.3 ms (B): B is A
    bitwise.  A second session restored from the file runs A too."""
    sim = _session(plastic, backend)
    sim.run(1.5)
    path = sim.save(str(tmp_path))
    assert os.path.basename(path) == "step_00000015"
    a = sim.run(3.3)
    state_a = [x.copy() for x in CK._flatten(sim.state).values()]
    gen_a = sim._generator.get_state()
    captures = _captures(sim)
    sim.restore(str(tmp_path))
    assert (sim._steps_done, sim._presim_done) == (15, True)
    b = sim.run(3.3)
    assert _captures(sim) == captures
    _assert_same_run(a, b)
    for x, y in zip(state_a, CK._flatten(sim.state).values(), strict=True):
        np.testing.assert_array_equal(x, y)
    assert torch.equal(gen_a, sim._generator.get_state())
    other = _session(plastic, backend, key=9)
    other.restore(str(tmp_path))
    _assert_same_run(a, other.run(3.3))
    _assert_same_state(sim.state, other.state)


@pytest.mark.parametrize("plastic", [False, True],
                         ids=["static", "plastic"])
def test_run_chunked_checkpoints(tmp_path, plastic):
    """``run_chunked(4.0, 1.0, checkpoint_every=2)`` on the graphed loop
    saves after chunks 2 and 4; the run restored from chunk 2's checkpoint
    continues bitwise as the chunked run's last two chunks."""
    sim = _session(plastic, "graphed")
    chunks = []
    res = sim.run_chunked(4.0, 1.0, checkpoint_dir=str(tmp_path),
                          checkpoint_every=2,
                          callback=lambda i, r: chunks.append(r))
    # steps_done counts the timed steps (the presim's are not)
    assert sorted(os.listdir(tmp_path)) == ["step_00000020",
                                            "step_00000040"]
    assert CK.latest_step(str(tmp_path)) == sim._steps_done == 40
    twin = _session(plastic, "graphed")
    twin.restore(str(tmp_path), step=20)
    tail = twin.run(2.0)
    for name in tail.data:
        np.testing.assert_array_equal(
            tail.data[name],
            np.concatenate([chunks[2].data[name], chunks[3].data[name]]))
    _assert_same_state(twin.state, sim.state)
    assert res.n_steps == 40
    with pytest.raises(ValueError, match="checkpoint_every"):
        sim.run_chunked(1.0, 0.5, checkpoint_dir=str(tmp_path),
                        checkpoint_every=0)


@pytest.mark.parametrize("plastic", [False, True],
                         ids=["static", "plastic"])
def test_suspend_and_resume_against_a_twin(tmp_path, plastic):
    sim = _session(plastic, "graphed")
    sim.run(1.0)
    twin = _session(plastic, "graphed", connectome=sim.connectome)
    twin.run(1.0)
    path = sim.suspend(str(tmp_path))
    assert sim.suspended and sim.state is None and os.path.isdir(path)
    for call in (lambda: sim.run(1.0), lambda: sim.warmup(1.0),
                 lambda: sim.save(str(tmp_path)),
                 lambda: sim.restore(str(tmp_path))):
        with pytest.raises(RuntimeError, match="suspended"):
            call()
    sim.resume(str(tmp_path))
    assert not sim.suspended
    for t_ms in (2.1, 0.7):
        _assert_same_run(sim.run(t_ms), twin.run(t_ms))
        _assert_same_state(sim.state, twin.state)


def test_layout_keep_and_the_asynchronous_save(tmp_path):
    sim = _session()
    for _ in range(4):
        sim.run(0.5)
        sim.save(str(tmp_path), keep=2)
    steps = sorted(os.listdir(tmp_path))
    assert steps == ["step_00000015", "step_00000020"]
    with open(tmp_path / steps[-1] / "manifest.json") as f:
        manifest = json.load(f)
    assert manifest["schema"] == CK.CKPT_SCHEMA == "repro.checkpoint/v1"
    assert manifest["step"] == 20
    leaves = manifest["leaves"]
    assert leaves["['state']||.neuron||.V"] == {
        "shape": [sim.connectome.n_total], "dtype": "float32"}
    assert leaves["['state']||.generator"]["dtype"] == "uint8"
    assert leaves["['steps_done']"] == {"shape": [], "dtype": "int64"}

    saver = CK.AsyncCheckpointer(str(tmp_path / "async"), keep=1)
    saver.save(sim._package(), step=20)
    sim.run(0.5)                         # the state moves on meanwhile
    saver.save(sim._package(), step=25)
    saver.wait()
    assert os.listdir(tmp_path / "async") == ["step_00000025"]
    got = CK.restore(str(tmp_path / "async"), sim._package())
    for name, x in CK._flatten(got).items():
        np.testing.assert_array_equal(x, CK._flatten(sim._package())[name])
    assert CK.latest_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        CK.restore(str(tmp_path / "none"), sim._package())


def test_mismatch_errors_name_the_schema_and_the_leaf(tmp_path):
    static, plastic = _session(), _session(plastic=True)
    static.save(str(tmp_path / "static"))
    plastic.save(str(tmp_path / "plastic"))
    with pytest.raises(CK.CheckpointMismatchError,
                       match=r"leaves missing from checkpoint: \["
                             r"\"\['state'\]\|\|\[0\]\|\|\.generator\""):
        plastic.restore(str(tmp_path / "static"))
    with pytest.raises(CK.CheckpointMismatchError,
                       match=r"leaves only in checkpoint: \[.*"
                             r"\['state'\]\|\|\[1\]\|\|\.weights"):
        static.restore(str(tmp_path / "plastic"))
    smaller = _session(scale=0.01)
    with pytest.raises(CK.CheckpointMismatchError,
                       match=r"leaf \"\['state'\]\|\|\.neuron\|\|\.V\" "
                             r"has shape"):
        smaller.restore(str(tmp_path / "static"))
    half = Simulator(MicrocircuitConfig(scale=SCALE, strategy="ell",
                                        t_presim=2.0),
                     probes=PROBES, device="cpu", state_dtype=torch.bfloat16)
    with pytest.raises(CK.CheckpointMismatchError,
                       match=r"leaf \"\['state'\]\|\|\.neuron\|\|\.V\" "
                             r"is float32 in the checkpoint but bfloat16"):
        half.restore(str(tmp_path / "static"))
    manifest = tmp_path / "static" / "step_00000000" / "manifest.json"
    doc = json.loads(manifest.read_text())
    doc["schema"] = "repro.checkpoint/v9"
    manifest.write_text(json.dumps(doc))
    with pytest.raises(CK.CheckpointMismatchError,
                       match="unknown checkpoint schema "
                             "'repro.checkpoint/v9'"):
        static.restore(str(tmp_path / "static"))
    del doc["schema"]
    manifest.write_text(json.dumps(doc))
    with pytest.raises(CK.CheckpointMismatchError,
                       match="unknown checkpoint schema None"):
        static.restore(str(tmp_path / "static"))
    manifest.unlink()
    with pytest.raises(CK.CheckpointMismatchError, match="no manifest.json"):
        static.restore(str(tmp_path / "static"))


def test_static_leaves_equal_the_jax_checkpoint(tmp_path):
    """The JAX session's state after 3 ms, carried into a port session
    that ran 3 ms too (the same counters): both checkpoints hold the same
    leaves under the same names, bitwise, but the JAX ``key`` and the
    port's generator."""
    jsim = JaxSimulator(JaxConfig(scale=SCALE, strategy="ell",
                                  t_presim=0.0), kernels="reference")
    jsim.run(3.0)
    jsim.save(str(tmp_path / "jax"))
    net, st = jsim.backend.net, jsim.state
    arrays = {
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
    assert np.abs(arrays["ring"]).sum() > 0
    sim = Simulator(MicrocircuitConfig(scale=SCALE, strategy="ell",
                                       t_presim=0.0), device="cpu")
    sim.run(3.0)
    sim.state = convert.to_torch(arrays, "cpu")[1]
    sim.save(str(tmp_path / "port"))
    step = "step_00000030"
    jax_npz = np.load(tmp_path / "jax" / step / "host_0.npz")
    port_npz = np.load(tmp_path / "port" / step / "host_0.npz")
    names = set(jax_npz.files) - {"['state']||.key"}
    assert names == set(port_npz.files) - {"['state']||.generator"}
    assert "['state']||.neuron||.V" in names and len(names) == 10
    for name in names:
        assert port_npz[name].dtype == jax_npz[name].dtype, name
        np.testing.assert_array_equal(port_npz[name], jax_npz[name],
                                      err_msg=name)
