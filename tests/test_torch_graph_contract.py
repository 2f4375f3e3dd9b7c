"""repro_torch.analysis.graph_contract and perf.step_analysis: GC001-GC004
on the committed scenarios, a seeded violation of each rule, the census
counted exactly on a synthetic step, and the card's form of GC001 (a warm
run is replays only) on a stand-in for CUDA graphs."""
import glob
import json

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import _disable_current_modes

from repro_torch.analysis import __main__ as cli
from repro_torch.analysis import graph_contract as GC
from repro_torch.api import Simulator, probes
from repro_torch.api.backends import FusedBackend
from repro_torch.configs.microcircuit import MicrocircuitConfig
from repro_torch.core import stimulus as S
from repro_torch.perf.step_analysis import analyze_step, op_census

SCENARIOS = sorted(glob.glob("examples/scenarios/*.json"))
CFG = MicrocircuitConfig(scale=0.02, strategy="ell", t_presim=0.0, seed=55)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_the_four_scenarios_are_committed():
    assert len(SCENARIOS) == 4


@pytest.mark.parametrize("kernels", [None, "fused"])
@pytest.mark.parametrize("path", SCENARIOS)
def test_scenarios_hold_the_contracts(path, kernels):
    assert GC.check_scenario(path, kernels=kernels, device="cpu") == []


def test_cli_graph_exits_0_and_writes_the_report(tmp_path):
    out = tmp_path / "graph.json"
    assert cli.main(["graph", SCENARIOS[0], "--device", "cpu",
                     "--kernels", "fused", "--json", str(out)]) == 0
    doc = json.loads(out.read_text())
    assert doc["schema"] == "repro.analysis_report/v1"
    assert doc["tool"] == "repro_torch.analysis.graph"
    assert doc["summary"]["total"] == 0


@pytest.fixture(scope="module")
def connectome():
    from repro_torch.core.connectivity import build_connectome
    return build_connectome(scale=CFG.scale, seed=CFG.seed)


def _rules(sim, **kw):
    return sorted({f.rule for f in GC.check_session(sim, symbol="seeded",
                                                    n_steps=4, **kw)})


def test_clean_session_holds_the_contracts(connectome):
    sim = Simulator(CFG, connectome=connectome, device="cpu")
    assert _rules(sim) == []


def test_a_probe_that_reads_to_the_host_trips_gc002(connectome):
    probe = probes.custom(
        "host", lambda ctx: torch.tensor(ctx.spiked.sum().item()))
    sim = Simulator(CFG, connectome=connectome, device="cpu",
                    probes=("pop_counts", probe))
    assert _rules(sim) == ["GC002"]


def test_a_data_dependent_op_sequence_trips_gc001(connectome):
    def per_spike(ctx):
        acc = torch.zeros((), dtype=torch.int32)
        for _ in range(torch.nonzero(ctx.spiked).shape[0]):
            acc = acc + 1
        return acc
    sim = Simulator(CFG, connectome=connectome, device="cpu",
                    probes=("pop_counts", probes.custom("loop", per_spike)))
    assert _rules(sim) == ["GC001"]


def test_casts_above_the_budget_trip_gc003(connectome):
    def casts(ctx):
        x = ctx.spiked
        for _ in range(GC.DEFAULT_MAX_CASTS):
            x = x.to(torch.int32).to(torch.bool)
        return x.sum(dtype=torch.int32)
    sim = Simulator(CFG, connectome=connectome, device="cpu",
                    probes=("pop_counts", probes.custom("casts", casts)))
    assert _rules(sim) == ["GC003"]
    assert _rules(sim, max_casts=10 ** 6) == []


class _WideDrive(S.Stimulus):
    """A current drive computed in float64 (then cast to float32)."""

    def compile(self, c, cfg, neuron):
        n = c.n_total

        def fn(gen, t, state):
            wide = torch.full((n,), 1.0, dtype=torch.float64)
            return wide.to(torch.float32), None
        return S.CompiledStimulus(channel="current", fn=fn)


def test_a_float64_in_the_drive_trips_gc004(connectome):
    sim = Simulator(CFG, connectome=connectome, device="cpu",
                    stimulus=(S.PoissonBackground(), _WideDrive()))
    assert _rules(sim) == ["GC004"]


def test_census_counts_a_synthetic_step_exactly():
    x = torch.arange(8, dtype=torch.float32)

    def step():
        y = x.to(torch.int32)                    # _to_copy (a cast)
        z = (x * 2.0 + 1.0).sum()                # mul, add, sum
        x.view(2, 4)                             # view
        torch.zeros(3, dtype=torch.float64)      # zeros (a float64)
        y.to(torch.int32)                        # same dtype: no op
        return float(z)                          # _local_scalar_dense
    c = op_census(step, n_steps=3)
    assert c["ops"] == {"aten._local_scalar_dense": 1, "aten._to_copy": 1,
                        "aten.add": 1, "aten.mul": 1, "aten.sum": 1,
                        "aten.view": 1, "aten.zeros": 1}
    assert c["ops_per_step"] == [7, 7, 7]
    assert c["casts"] == 1 and c["cast_kinds"] == {
        "torch.float32->torch.int32": 1}
    assert c["f64_tensors"] == 1 and c["host_syncs"] == 1
    assert c["d2h_copies"] == 0 and c["same_sequence"]
    a = analyze_step(step)
    # mul, add: 8 elements each; bytes: _to_copy 32+32, mul 32+32, add
    # 32+32, sum 32+4, zeros 24, the read of z 4 (the view moves nothing)
    assert a["elementwise_flops_per_step"] == 16
    assert a["bytes_per_step"] == 64 * 3 + 36 + 24 + 4
    assert a["matmul_flops_per_step"] == 0 and a["collectives"] == {}


def test_analyze_step_counts_matmul_flops_and_noted_collectives():
    from repro_torch.perf.step_analysis import note_collective
    a_, b_ = torch.ones(4, 6), torch.ones(6, 5)

    def step():
        note_collective("all-reduce", 80)
        note_collective("all-gather", 40)
        return a_ @ b_
    r = analyze_step(step, n_steps=2)
    assert r["matmul_flops_per_step"] == 2 * 4 * 6 * 5
    assert r["collectives"] == {"all-reduce": {"count": 1, "bytes": 80},
                                "all-gather": {"count": 1, "bytes": 40}}
    assert r["collective_wire_bytes_per_step"] == 2 * 80 + 40
    note_collective("all-reduce", 10 ** 9)      # no analysis open: nothing


class _Silent:
    """A CUDA graph's stand-in on the CPU whose replay, like a graph's,
    dispatches no op that a mode could see: it runs the segment with the
    dispatch modes set aside."""

    def __init__(self, fn, generator, pool):
        self.fn = fn

    def replay(self, times=1):
        with _disable_current_modes():
            for _ in range(times):
                self.fn()

    @staticmethod
    def new_pool():
        return None


class _SilentGraphs(FusedBackend):
    graph_type = _Silent
    graphed = True


def test_a_warm_graphed_run_is_replays_and_once_per_call_work(connectome):
    backend = _SilentGraphs()
    sim = Simulator(CFG, connectome=connectome, device="cpu",
                    backend=backend)
    out = GC.check_graphed(sim, symbol="static", lengths=(130, 250))
    assert out["findings"] == []
    r130, r250 = out["runs"]
    # the head (none here), a body of 100 replayed 1 and 2 times, the rest
    assert (r130["replays"], r250["replays"]) == (2, 3)
    assert r130["replays_expected"] == 2 and r250["replays_expected"] == 3
    assert r130["eager_ops"] == r250["eager_ops"] > 0
    assert out["census"]["casts"] <= GC.DEFAULT_MAX_CASTS


def test_eager_work_that_grows_with_the_run_trips_gc001(connectome,
                                                        monkeypatch):
    backend = _SilentGraphs()
    sim = Simulator(CFG, connectome=connectome, device="cpu",
                    backend=backend)
    run = FusedBackend._run_graphed

    def leaky(self, state, n_steps, probes, stream):
        for _ in range(n_steps // 100):       # per-step work, out of graph
            torch.zeros(1) + 1
        return run(self, state, n_steps, probes, stream)
    monkeypatch.setattr(FusedBackend, "_run_graphed", leaky)
    out = GC.check_graphed(sim, symbol="leaky", lengths=(130, 250))
    assert [f.rule for f in out["findings"]] == ["GC001"]
    np.testing.assert_array_less([r["eager_ops"] for r in out["runs"][:1]],
                                 [r["eager_ops"] for r in out["runs"][1:]])
