"""A configuration names its network, and the harness reaches the network
only through its module, ``perfbench/networks/<network>.py``.

* PD14 through its module draws, starts and checks exactly as the harness
  did before the modules (``pd14_pin.json``, recorded then).
* A second network, a two-population E/I toy (``network_toy_ei.py``),
  added to a scratch root as files alone, runs through ``run_cell``:
  correct, with counts of two populations, six keys of weight change with
  pair STDP, and not correct with a planted fault.
* A configuration whose network is missing is a ``RunError``."""
import json
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from perfbench import bench, check, faults  # noqa: E402
from test_perfbench_isolation import FORBIDDEN, reached  # noqa: E402

HERE = Path(__file__).resolve().parent
PIN = json.loads((HERE / "pd14_pin.json").read_text())
SEEDS = (2 ** 33 + 5, 3_300_000_071)
CELLS = ("pd14_static.free_bg", "pd14_stdp.free_bg", "pd14_static.loop_1ms")
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


def _fixed_window(self, seconds, sample):
    """Six segments' units, whatever the clock says."""
    for i in range(6 * self.block):
        self._one(sample.offer() if i % self.block == 0 else None, i)
    self.window_s = 1.0


def _run(cell, seed, monkeypatch, root=ROOT, overrides=SMALL, fault=None):
    """``run_cell`` on the CPU with a fixed window, and what its check
    was handed: the segments' counts and the kept runs' weight change."""
    seen = {}
    real = check.check

    def spy(network, c, config, traffic, segments, start, device):
        seen["counts"] = [s["counts"] for s in segments]
        seen["weights_sq"] = [s["weights_sq"] for s in segments
                              if s.get("weights_sq") is not None]
        return real(network, c, config, traffic, segments, start, device)
    monkeypatch.setattr(bench.Pattern, "window", _fixed_window)
    monkeypatch.setattr(check, "check", spy)
    out = bench.run_cell(cell, seed, 0.0, False, root=root, device="cpu",
                         overrides=overrides, fault=fault)
    return out, seen


def _same(got, want):
    """Integers exactly, floats to ``_sums_differ``'s 1e-9 relative."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    if want.dtype.kind in "iub":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-9, atol=0)


@pytest.mark.parametrize("seed", SEEDS)
def test_pd14_draw_is_pinned(seed):
    files = bench.cell_files(ROOT, "pd14_static.free_bg")
    config = {**files["config"], **SMALL["config"]}
    network = bench.load_network(config, ROOT)
    net = network.draw(config, bench._seeds(seed)["net"], "cpu")
    sums = check.table_sums(net.targets, net.weights, net.dbins)
    want = PIN[f"sums/{seed}"]
    _same(sums[:4], want[:4])
    _same(sums[4:], want[4:])
    assert check._sums_differ(sums, want) == 0
    for key, value in PIN[f"stats/{seed}"].items():
        _same(net.stats[key], value)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell", CELLS)
def test_pd14_start_and_check_are_pinned(cell, seed, monkeypatch):
    out, seen = _run(cell, seed, monkeypatch)
    want = PIN[f"{cell}/{seed}"]
    assert out["correct"]
    assert out["attempted"] == want["attempted"]
    for name, item in out["checks"].items():
        _same(item["value"], want[name])
    assert set(out["checks"]) == set(want) - {
        "attempted", "counts_by_pop", "segments", "weights_sq"}
    assert len(seen["counts"]) == want["segments"]
    _same(np.sum([c.sum(axis=0) for c in seen["counts"]], axis=0),
          want["counts_by_pop"])
    if "weights_sq" in want:
        _same(np.sum(seen["weights_sq"], axis=0), want["weights_sq"])
    else:
        assert not seen["weights_sq"]


# -- a second network, added as files --------------------------------------

TOY_STDP = json.loads((ROOT / "perfbench" / "configs" / "pd14_stdp.json")
                      .read_text())["plasticity"]
TOY_CELLS = {"toy_ei.free_bg": ("toy_ei", "free_bg", None,
                                "pd14_static.free_bg"),
             "toy_ei_stdp.free_bg": ("toy_ei_stdp", "free_bg_segments",
                                     TOY_STDP, "pd14_stdp.free_bg")}


@pytest.fixture(scope="module")
def toy_root(tmp_path_factory):
    """A copy of the benchmark with the toy network, its two
    configurations, their cells and limits added as files."""
    root = tmp_path_factory.mktemp("toy")
    shutil.copytree(ROOT / "perfbench", root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    pb = root / "perfbench"
    shutil.copy(HERE / "network_toy_ei.py", pb / "networks" / "toy_ei.py")
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    for cell, (config, traffic, stdp, limits) in TOY_CELLS.items():
        (pb / "configs" / f"{config}.json").write_text(json.dumps(
            {"name": config, "network": "toy_ei", "scale": 1.0,
             "dt_ms": 0.1, "t_presim_ms": 20.0, "strategy": "ell",
             "kernels": "fused", "plasticity": stdp}))
        shutil.copy(pb / "limits" / f"{limits}.json",
                    pb / "limits" / f"{cell}.json")
        manifest["configs"].append(
            {"name": config, "source": "a test fixture",
             "file": f"perfbench/configs/{config}.json", "reduced": [],
             "why": "test"})
        manifest["workloads"].append(
            {"name": cell, "config": config, "traffic": traffic, "chips": 1,
             "why": "test"})
    (pb / "configs" / "toy_nowhere.json").write_text(json.dumps(
        {"name": "toy_nowhere", "network": "nowhere", "scale": 1.0}))
    (pb / "configs" / "toy_unnamed.json").write_text(json.dumps(
        {"name": "toy_unnamed", "scale": 1.0}))
    for config in ("toy_nowhere", "toy_unnamed"):
        manifest["configs"].append(
            {"name": config, "source": "a test fixture",
             "file": f"perfbench/configs/{config}.json", "reduced": [],
             "why": "test"})
        manifest["workloads"].append(
            {"name": f"{config}.free_bg", "config": config,
             "traffic": "free_bg", "chips": 1, "why": "test"})
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    return root


TOY_SMALL = {"traffic": SMALL["traffic"]}


@pytest.mark.parametrize("cell", sorted(TOY_CELLS))
def test_second_network_runs_from_files_alone(cell, toy_root, monkeypatch):
    out, seen = _run(cell, 2 ** 35 + 3, monkeypatch, root=toy_root,
                     overrides=TOY_SMALL)
    assert out["correct"], out["checks"]
    kept = SMALL["traffic"]["check"]
    assert [c.shape for c in seen["counts"]] == \
        [(kept["steps"], 2)] * kept["segments"]
    assert sum(int(c.sum()) for c in seen["counts"]) > 0
    if TOY_CELLS[cell][2] is None:
        assert "weights_gap" not in out["checks"] and not seen["weights_sq"]
    else:
        # 2 x 2 projections and each source's padding key
        assert [w.shape for w in seen["weights_sq"]] == [(6,), (6,)]
        moved = np.sum(seen["weights_sq"], axis=0)
        assert moved[0] > 0 and not moved[1:].any()     # E->E alone
        assert out["checks"]["weights_gap"]["value"] <= 1e-12


@pytest.mark.parametrize("fault", ["step_unchanged", "count_altered"])
def test_second_network_catches_a_fault(fault, toy_root, monkeypatch):
    out, _ = _run("toy_ei.free_bg", 2 ** 35 + 3, monkeypatch, root=toy_root,
                  overrides=TOY_SMALL,
                  fault=lambda sim: faults.FAULTS[fault](
                      sim, monkeypatch.setattr))
    assert not out["correct"]
    gap = out["checks"]["counts_gap"]
    assert gap["value"] > gap["limit"]


@pytest.mark.parametrize("config,match", [("toy_nowhere", "no network "
                                           "module"),
                                          ("toy_unnamed", "names no network")])
def test_a_missing_network_is_a_run_error(config, match, toy_root):
    with pytest.raises(bench.RunError, match=match):
        bench.run_cell(f"{config}.free_bg", 5, 0.0, False, root=toy_root,
                       device="cpu")


def test_the_toy_network_reaches_no_jax(toy_root):
    names = reached(toy_root / "perfbench" / "networks" / "toy_ei.py")
    assert "perfbench.reference.lif_net" in names
    assert not {n.split(".")[0] for n in names} & FORBIDDEN


def test_too_many_populations_for_the_keys():
    """15 populations' keys fit in uint8 (the last source's padding key is
    the largest); 16 raise."""
    targets = torch.full((15, 1), 15, dtype=torch.int32)     # all padding
    keys = check.projection_keys(targets, torch.arange(15), 15)
    assert int(keys.max()) == 14 * 16 + 15 == check.n_leaves(15) - 1
    with pytest.raises(ValueError, match="at most 15"):
        check.projection_keys(torch.zeros((16, 1), dtype=torch.int32),
                              torch.arange(16), 16)
