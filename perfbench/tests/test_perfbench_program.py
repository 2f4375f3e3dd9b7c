"""The readers of the port's own spans and counters (``perfbench/program.py``
and its six metrics): on a recorded fixture, with nothing to read, the
census's split of device time by span, and a traced closed-loop run on the
CPU, whose loop runs the graphed path on a re-executing stand-in."""
import importlib.util
import json
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src"), str(ROOT / "tests")]

from perfbench import bench, program  # noqa: E402

FIXTURE = json.loads(Path(__file__).with_name("program_fixture.json")
                     .read_text())
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NEW = {"session.tables_s": 3.9, "step.drive_us": 11.5, "step.probe_us": 8.0,
       "loop.enqueue_us_per_chunk": 75.0,
       "session.readback_us_per_chunk": 35.0,
       "session.syncs_per_chunk": 4.0}
SMALL = {"config": {"scale": 0.02, "kernels": "fused"},
         "traffic": {"run_ms": 20.0, "check": {"segments": 3, "steps": 60,
                                               "weight_runs": 2},
                     "profile": {"units": 2}}}


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_the_six_metrics_are_declared_and_read_the_fixture():
    declared = {m["name"]: m for m in BENCH["per_layer"]}
    for name, value in NEW.items():
        assert declared[name]["source"] in ("program_span",
                                            "program_counter")
        got = bench.reader(name, ROOT)({"program": FIXTURE})
        assert got == pytest.approx(value), name


@pytest.mark.parametrize("name", sorted(NEW))
def test_a_reader_gives_none_with_nothing_to_read(name, monkeypatch):
    read = bench.reader(name, ROOT)
    assert read({"program": None}) is None
    # the loop's and census's spans missing (a run on the CPU)
    empty = dict(FIXTURE, build_s={}, per_unit_s={}, counts_per_unit={},
                 census=dict(FIXTURE["census"], us_per_step={}))
    assert read({"program": empty}) is None
    # a record no run_cell made: nothing measured
    record = {}
    assert read(record) is None and record["program"] is None
    # a checkout whose port has no spans: nothing measured either
    find = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec", lambda n, *a: None
                        if n == "repro_torch.perf.trace" else find(n, *a))
    assert program.of({}) is None


def test_on_the_card_a_record_no_run_made_raises(monkeypatch):
    """On the card the metrics are due in every traced line, so a record
    whose run_cell locals cannot be found fails the run loudly."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(RuntimeError, match="no run_cell call"):
        program.of({})


CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


def _event(name, a, b, device=CPU, id=0):
    return SimpleNamespace(name=name, device_type=device, id=id,
                           time_range=SimpleNamespace(start=a, end=b))


def test_census_puts_each_kernel_under_its_innermost_step_span():
    """Host ranges (two steps) and, for each device operation, the runtime
    call that launched it under the same correlation id."""
    events = [
        _event("step", 0, 100), _event("step.drive", 5, 30),
        _event("aten::poisson", 6, 10), _event("cudaLaunchKernel", 7, 8,
                                              id=1),
        _event("cudaLaunchKernel", 20, 21, id=2),
        _event("step.deliver", 35, 60),
        _event("cudaLaunchKernelExC", 40, 41, id=3),    # a ctypes launch
        _event("step.probe", 65, 90), _event("cudaMemcpyAsync", 70, 71,
                                             id=4),
        _event("cudaLaunchKernel", 95, 96, id=5),       # the step's own
        _event("step", 100, 200), _event("step.drive", 105, 130),
        _event("cudaLaunchKernel", 110, 111, id=6),
        _event("cudaLaunchKernel", 300, 301, id=7),     # outside any step
        # the device's side: kernels by correlation id, and a span's own
        # range on the device's timeline, which is no operation
        _event("poisson", 10, 13, CUDA, 1), _event("copy", 21, 23, CUDA, 2),
        _event("lif_deliver_kernel", 45, 55, CUDA, 3),
        _event("Memcpy DtoD", 72, 76, CUDA, 4),
        _event("add", 97, 97.5, CUDA, 5), _event("poisson", 112, 115,
                                                 CUDA, 6),
        _event("clone", 302, 309, CUDA, 7),
        _event("step.drive", 10, 23, CUDA, 1)]
    out = program.census_us(events, n_steps=2)
    assert out["us_per_step"] == {"step.drive": 4.0, "step.deliver": 5.0,
                                  "step.probe": 2.0, "step": 0.25}
    assert out["total_us"] == pytest.approx(11.25)
    assert out["outside_us"] == 7.0


def test_traced_loop_reports_the_loop_and_session_metrics(monkeypatch):
    from repro_torch.api.backends import FusedBackend
    from test_torch_graph_loop import _Reexecuted
    monkeypatch.setattr(FusedBackend, "graph_type", _Reexecuted)
    monkeypatch.setattr(FusedBackend, "graphed", property(lambda s: True))
    out = bench.run_cell("pd14_static.loop_1ms", 2 ** 33 + 5, 0.5, True,
                         root=ROOT, device="cpu", overrides=SMALL)
    assert out["correct"], out["checks"]
    m = {k: v["value"] for k, v in out["metrics"].items()}
    assert m["session.syncs_per_chunk"] == 4.0
    assert m["session.tables_s"] > 0
    assert m["loop.enqueue_us_per_chunk"] > 0
    assert 0 < m["session.readback_us_per_chunk"] < \
        m["loop.enqueue_us_per_chunk"] + 1e6 * max(out["unit_walls_s"]
                                                    .values())
