"""The port's declarative experiments and multi-trial batches, on the
CPU, at scale 0.02 or below.

* Each committed scenario (``examples/scenarios/*.json``) loads verbatim:
  its ``to_dict`` equals the JAX package's ``to_dict`` of the same file and
  the file itself; the schema rules (v1 read, v1 with plasticity refused,
  unknown schemas and fields refused) are the reference's.
* ``run_batch``: trial ``i`` bitwise a fresh ``reset(seeds[i]); run``,
  presim included, on the eager loop and on the graphed one (where no
  trial after the first captures), static and plastic; the session's own
  state bitwise untouched; overflow surfaced as a run's.
* ``make_simulator(backend=)`` with a built backend shares it; the CLI
  (``python -m repro_torch.api``) exits 4 on a failing report and raises
  without a card unless given ``--device cpu``.
"""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.api.experiment import Experiment as JaxExperiment
from repro_torch.api import (BatchResult, DeliveryOverflowError, Experiment,
                             Simulator)
from repro_torch.api import experiment as EXP
from repro_torch.configs.microcircuit import MicrocircuitConfig
from test_torch_graph_loop import (_GraphedOnCpu, _assert_same_run,
                                   _state_arrays)

ROOT = Path(__file__).resolve().parent.parent
SCENARIOS = sorted((ROOT / "examples" / "scenarios").glob("*.json"))
GRAPH_STEPS = 7


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


def test_all_four_scenarios_are_found():
    assert [p.stem for p in SCENARIOS] == [
        "dc_control", "smoke_background", "stdp_ee", "thalamic_pulses"]


@pytest.mark.parametrize("path", SCENARIOS, ids=lambda p: p.stem)
def test_scenario_round_trips_to_the_reference(path):
    exp = Experiment.from_json(str(path))
    got = exp.to_dict()
    assert got == JaxExperiment.from_json(str(path)).to_dict()
    assert got == json.loads(path.read_text())
    assert Experiment.from_dict(got) == exp
    assert json.loads(exp.to_json()) == got


def test_schema_rules_are_the_reference():
    doc = json.loads((ROOT / "examples" / "scenarios" /
                      "stdp_ee.json").read_text())
    v1 = dict(doc, schema="repro.experiment/v1", plasticity=None)
    assert Experiment.from_dict(v1).to_dict() == \
        JaxExperiment.from_dict(v1).to_dict()
    for bad, match in ((dict(doc, schema="repro.experiment/v1"),
                        "plasticity field"),
                       (dict(doc, schema="repro.experiment/v9"),
                        "unknown experiment schema"),
                       (dict(doc, colour="red"), "unknown experiment field"),
                       (dict(doc, model=dict(doc["model"], width=3)),
                        "unknown model field")):
        with pytest.raises(ValueError, match=match):
            Experiment.from_dict(bad)
        with pytest.raises(ValueError, match=match):
            JaxExperiment.from_dict(bad)
    with pytest.raises(ValueError, match="trials"):
        Experiment(trials=0)
    with pytest.raises(ValueError, match="named probes"):
        Experiment(probes=(object(),)).to_dict()


def _session(plastic, backend, probes=("pop_counts", "spikes"), key=None,
             **cfg):
    rule = "pair_stdp" if plastic else None
    if backend == "graphed":
        backend = _GraphedOnCpu(plasticity=rule, graph_steps=GRAPH_STEPS)
    model = MicrocircuitConfig(**{"scale": 0.02, "strategy": "ell",
                                  "t_presim": 1.0, **cfg})
    return Simulator(model, backend=backend, plasticity=rule, probes=probes,
                     device="cpu", key=key)


@pytest.mark.parametrize("plastic", [False, True],
                         ids=["static", "plastic"])
@pytest.mark.parametrize("backend", ["fused", "graphed"])
def test_run_batch_equals_sequential_seeded_runs(backend, plastic):
    from repro_torch.api import spike_stats
    probes = ("pop_counts", "spikes",
              spike_stats(np.arange(0, 700, 9), bin_steps=5))
    sim = _session(plastic, backend, probes)
    sim.run(0.5)
    before = _state_arrays(sim.state)
    gen = sim._generator.get_state()
    batch = sim.run_batch(2.3, seeds=[3, 11, 3])
    assert isinstance(batch, BatchResult) and batch.seeds == [3, 11, 3]
    assert not batch.vmapped and len(batch) == 3
    for seed, trial in zip(batch.seeds, batch):
        fresh = _session(plastic, "fused", probes, key=seed)
        _assert_same_run(trial, fresh.run(2.3))
        assert trial.wall_s > 0 and trial.device == "cpu"
    _assert_same_run(batch[0], batch[2])
    after = _state_arrays(sim.state)
    for k in before:
        np.testing.assert_array_equal(before[k], after[k], err_msg=k)
    assert torch.equal(gen, sim._generator.get_state())
    if backend == "graphed":
        # the session's presim and 5-step keys, then the trials' 23-step
        # key, captured once, by trial 0 (the presim's is shared)
        assert sim.backend.graphs.misses == 3
    report = batch.validate()
    assert report.meta["n_steps"] == 3 * 23
    assert report.to_dict() == batch.pooled().validate().to_dict()


def test_run_batch_seeds_warmup_and_overflow():
    sim = _session(False, "graphed")
    assert sim._trial_seeds(3, None) == [55, 56, 57]
    with pytest.raises(ValueError, match="n_trials"):
        sim.run_batch(1.0)
    with pytest.raises(ValueError, match="2 seeds for n_trials=3"):
        sim.run_batch(1.0, 3, seeds=[1, 2])
    sim.warmup_batch(1.2, 2)
    misses = sim.backend.graphs.misses
    assert sim.backend.is_warm_batch(2, 12, sim.probes)
    batch = sim.run_batch(1.2, 2, presim_ms=1.0)
    assert sim.backend.graphs.misses == misses
    np.testing.assert_allclose(batch.rtf_trials, [r.rtf for r in batch])
    tight = _session(False, "fused", spike_budget=1, t_presim=0.0)
    with pytest.warns(UserWarning, match="dropped"):
        assert sum(r.overflow for r in tight.run_batch(1.0, 2)) > 0
    strict = _session(False, "fused", spike_budget=1, t_presim=0.0,
                      strict_delivery=True)
    with pytest.raises(DeliveryOverflowError):
        strict.run_batch(1.0, 2)


def test_experiment_runs_trials_and_shares_a_built_backend():
    """``Experiment.run`` with two trials goes through ``run_batch`` and
    validates across them; ``make_simulator`` handed a built backend shares
    its tables and graphs."""
    exp = Experiment(model=MicrocircuitConfig(scale=0.02, strategy="ell",
                                              t_presim=1.0),
                     duration_ms=2.0, trials=2, validate=True, name="two")
    shared = _GraphedOnCpu(graph_steps=GRAPH_STEPS)
    first = exp.make_simulator(device="cpu", backend=shared)
    first.run(2.0)
    tables, misses = shared.net, shared.graphs.misses
    result = exp.run(connectome=first.connectome, device="cpu",
                     backend=shared, warmup=True)
    assert shared.net is tables and shared.graphs.misses == misses
    assert result.batch.seeds == [55, 56] and len(result.trials) == 2
    assert result.report is not None and "spike_stats" in \
        result.trials[0].streams
    summary = result.summary()
    assert summary["n_trials"] == 2 and summary["device"] == "cpu"
    assert summary["validation_passed"] == result.passed
    with pytest.raises(RuntimeError, match="no CUDA|none is available"):
        _without_cuda(lambda: exp.make_simulator())


def _without_cuda(fn):
    """``fn()`` as on a machine without a card."""
    real = torch.cuda.is_available
    torch.cuda.is_available = lambda: False
    try:
        return fn()
    finally:
        torch.cuda.is_available = real


def _scenario(tmp_path, **fields) -> str:
    doc = json.loads((ROOT / "examples" / "scenarios" /
                      "dc_control.json").read_text())
    doc["model"].update(scale=0.01, t_presim=1.0)
    doc.update(duration_ms=5.0, **fields)
    path = tmp_path / "scenario.json"
    path.write_text(json.dumps(doc))
    return str(path)


def test_cli_exit_codes(tmp_path, capsys):
    """A DC-only drive leaves the network silent, so its validation fails:
    exit code 4, the report written.  Without validation: 0.  Without a
    card and without ``--device cpu``: an error, before any build."""
    report = tmp_path / "report.json"
    path = _scenario(tmp_path, validate=True)
    assert EXP.main([path, "--device", "cpu", "--report-json",
                     str(report)]) == 4
    assert json.loads(report.read_text())["passed"] is False
    out = capsys.readouterr().out
    assert "validation FAILED" in out and "device: cpu" in out
    assert EXP.main([_scenario(tmp_path, validate=False), "--device",
                     "cpu", "--duration-ms", "2", "--trials", "2"]) == 0
    assert "n_trials: 2" in capsys.readouterr().out
    with pytest.raises(RuntimeError, match="none is available"):
        _without_cuda(lambda: EXP.main([path]))
