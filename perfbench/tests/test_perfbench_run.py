"""The harness end to end on the CPU at a small size: each cell's run is
correct, the check's control and the planted faults are not, and the
command refuses to run without a card or without the port."""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from perfbench import bench, check, control, faults  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
PLASTIC = [w["name"] for w in BENCH["workloads"] if json.loads(
    (ROOT / {c["name"]: c for c in BENCH["configs"]}[w["config"]]["file"])
    .read_text()).get("plasticity")]
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


def run(cell, seed=2 ** 33 + 5, trace=False, fault=None, seconds=0.5):
    return bench.run_cell(cell, seed, seconds, trace, root=ROOT,
                          device="cpu", overrides=SMALL, fault=fault)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_is_correct(cell):
    out = run(cell)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert list(out)[-1] == "checks"
    assert set(out["checks"]) == {"v0_mismatch", "tables_mismatch",
                                  "counts_gap"} | (
        {"weights_gap"} if cell in PLASTIC else set())
    assert "setup_s" in out["metrics"]
    walls = out["unit_walls_s"]
    assert 0 < walls["min"] <= walls["median"] <= walls["max"]


def test_traced_run_reports_its_spans():
    out = run("pd14_static.loop_1ms", trace=True)
    assert out["correct"]
    assert {"session.build_s", "loop.capture_s"} <= set(out["metrics"])
    assert out["device"]["window_s"] > 0
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


def _planted(name, monkeypatch):
    return lambda sim: faults.FAULTS[name](sim, monkeypatch.setattr)


@pytest.mark.parametrize("fault", ["step_unchanged", "count_altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_program_is_not_correct(cell, fault, monkeypatch):
    out = run(cell, fault=_planted(fault, monkeypatch))
    assert not out["correct"]
    assert out["checks"]["counts_gap"]["value"] > \
        out["checks"]["counts_gap"]["limit"]


@pytest.mark.parametrize("fault", ["stdp_noop", "depression_flipped"])
@pytest.mark.parametrize("cell", PLASTIC)
def test_broken_plasticity_is_not_correct(cell, fault, monkeypatch):
    """Faults of the plastic weights that shape too few spikes in a
    segment for ``counts_gap``: ``weights_gap`` catches them."""
    out = run(cell, fault=_planted(fault, monkeypatch))
    assert not out["correct"]
    gap = out["checks"]["weights_gap"]
    assert gap["value"] > gap["limit"]


@pytest.mark.parametrize("fault", ["delay_off", "drive_dropped"])
@pytest.mark.parametrize("cell", CELLS)
def test_moderate_faults_are_not_correct(cell, fault, monkeypatch):
    """The faults read at full size on the card, here at the small size:
    every source's delays one bin late (at full size one in a hundred),
    and one population's drive dropped."""
    sizes = {"delay_off": {"every": 1}}.get(fault, {})
    out = run(cell, fault=lambda sim: faults.FAULTS[fault](
        sim, monkeypatch.setattr, **sizes))
    assert not out["correct"]
    assert out["checks"]["counts_gap"]["value"] > \
        out["checks"]["counts_gap"]["limit"]


def test_weights_gap_is_the_worst_projection():
    """Keys by source and target population, each leaf's change, and the
    gap of the worst leaf against its own norm or the median moved one."""
    targets = torch.tensor([[1, 2, 3], [0, 3, 3], [1, 3, 3]],
                           dtype=torch.int32)          # N = 3, sentinel 3
    pop_of = torch.tensor([0, 0, 1])
    keys = check.projection_keys(targets, pop_of, 8)
    assert keys.tolist() == [[0, 1, 8], [0, 8, 8], [9, 17, 17]]
    w0 = torch.zeros(3, 3)
    w1 = torch.tensor([[3.0, 1.0, 5.0], [4.0, 0.0, 0.0], [2.0, 0.0, 0.0]])
    sq = check.change_sq(w1, w0, keys, 8).numpy()
    assert (sq[0], sq[1], sq[8], sq[9]) == (25.0, 1.0, 25.0, 4.0)
    ref = sq.copy()
    assert check.weights_gap([(sq, ref)], 8) == 0.0
    prog = ref.copy()
    prog[0] = 36.0                     # leaf (0, 0): 6 against 5
    assert check.weights_gap([(prog, ref)], 8) == pytest.approx(1 / 5)
    prog = ref.copy()
    prog[10] = 4.0                     # a leaf the reference leaves be
    # median moved leaf: of 5, 1 and 2 (the padding's key 8 is no leaf)
    assert check.weights_gap([(prog, ref)], 8) == pytest.approx(2 / 2)


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_and_float32_in_its_place_does_not(cell):
    small = {"config": {"scale": 0.02}, "traffic": SMALL["traffic"]}
    low = control.control_numbers(cell, 11, root=ROOT, device="cpu",
                                  overrides=small)
    assert not low["correct"]
    assert low["numbers"]["counts_gap"] > 0.1
    same = control.control_numbers(cell, 11, root=ROOT, device="cpu",
                                   overrides=small, dtype=torch.float32)
    assert same["correct"], same["numbers"]


def test_sample_is_drawn_from_the_seed():
    def kept(seed, n=200):
        r = bench.Reservoir(6, seed)
        slots = {}
        for i in range(n):
            s = r.offer()
            if s is not None:
                slots[s] = i
        return sorted(slots.values())
    assert kept(5) == kept(5)
    assert kept(5) != kept(6)
    assert len(kept(5)) == 6 and max(kept(5)) < 200


def _cli(cwd, env_extra=None):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(CUDA_VISIBLE_DEVICES="", **(env_extra or {}))
    return subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "pd14_static.free_bg", "--seed", str(2 ** 31 + 9), "--seconds", "1",
         "--trace", "0"], cwd=cwd, capture_output=True, text=True,
        timeout=120, env=env)


def test_cli_refuses_without_a_card():
    out = _cli(ROOT)
    assert out.returncode == 2 and out.stdout == ""
    assert "CUDA" in out.stderr


def test_cli_refuses_without_the_port(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _cli(tmp_path)
    assert out.returncode != 0 and out.stdout == ""
