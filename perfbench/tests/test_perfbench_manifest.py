"""BENCHMARK.json keeps to the format its runs rely on, and the harness finds
a cell, a configuration, a traffic mix and a metric by name alone."""
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
KEYS = {"top": {"command", "paths", "run_seconds", "configs", "workloads",
                "end_to_end", "per_layer"},
        "configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source"},
        "per_layer": {"name", "unit", "better", "source", "layer",
                      "moves"}}


def test_keys_and_names():
    assert set(BENCH) == KEYS["top"]
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[section]]
        assert len(names) == len(set(names)), section
        for e in BENCH[section]:
            extra = set(e) - KEYS[section]
            assert extra <= ({"workloads"} if section in (
                "end_to_end", "per_layer") else set()), (section, extra)
            assert KEYS[section] <= set(e), (section, e["name"])
            assert NAME.match(e["name"]), e["name"]
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and 0 < len(w["why"]) <= 200


def test_paths_and_command():
    assert BENCH["paths"] == ["perfbench"]
    assert all(not w.startswith("/") and ".." not in w
               for w in BENCH["command"])
    assert (ROOT / BENCH["command"][1]).is_file()
    assert 1 <= BENCH["run_seconds"] <= 51


def test_bounds():
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25, m["name"]
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" and "workloads" not in m
               for m in BENCH["end_to_end"])


def _reports(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_reports_enough(cell):
    e2e = [m["name"] for m in BENCH["end_to_end"] if _reports(m, cell)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert any(_reports(m, cell) for m in BENCH["per_layer"])


@pytest.mark.parametrize("metric", BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_moves_is_reported_where_the_metric_is(metric):
    moved = {m["name"]: m for m in BENCH["end_to_end"]}[metric["moves"]]
    cells = metric.get("workloads", [w["name"] for w in BENCH["workloads"]])
    for cell in cells:
        assert _reports(moved, cell), (metric["name"], cell)


def test_every_name_has_its_files():
    configs = {c["name"]: c for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        assert c["file"].startswith("perfbench/") and (ROOT / c["file"]) \
            .is_file()
        assert json.loads((ROOT / c["file"]).read_text())["name"] \
            == c["name"]
    for w in BENCH["workloads"]:
        assert w["config"] in configs
        assert (ROOT / "perfbench" / "traffic" / f"{w['traffic']}.json") \
            .is_file()
        assert (ROOT / "perfbench" / "limits" / f"{w['name']}.json") \
            .is_file()
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert (ROOT / "perfbench" / "metrics" / f"{m['name']}.py") \
            .is_file(), m["name"]


NEW_METRIC = '''"""throwaway.count: units in the window."""


def read(record):
    return record["window"]["attempted"]
'''


def test_new_cell_resolves_from_files_alone(tmp_path):
    """A cell, a configuration, a mix and a metric added as files to a
    copy resolve with no code edited."""
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    pb = tmp_path / "perfbench"
    cfg = json.loads((pb / "configs" / "pd14_static.json").read_text())
    cfg.update(name="pd14_half", scale=0.5, reduced=["scale"])
    (pb / "configs" / "pd14_half.json").write_text(json.dumps(cfg))
    mix = json.loads((pb / "traffic" / "free_bg.json").read_text())
    mix.update(run_ms=500.0)
    (pb / "traffic" / "half_runs.json").write_text(json.dumps(mix))
    (pb / "limits" / "pd14_half.half_runs.json").write_text(
        (pb / "limits" / "pd14_static.free_bg.json").read_text())
    (pb / "metrics" / "throwaway.count.py").write_text(NEW_METRIC)
    bench["configs"].append({"name": "pd14_half", "source": "x",
                             "file": "perfbench/configs/pd14_half.json",
                             "reduced": ["scale"], "why": "test"})
    bench["workloads"].append({"name": "pd14_half.half_runs",
                               "config": "pd14_half",
                               "traffic": "half_runs", "chips": 1,
                               "why": "test"})
    bench["per_layer"].append({"name": "throwaway.count", "unit": "1",
                               "better": "higher",
                               "source": "program_counter", "layer": "x",
                               "moves": "rtf",
                               "workloads": ["pd14_half.half_runs"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    probe = (
        "import json, sys\n"
        "from pathlib import Path\n"
        "from perfbench import bench\n"
        "f = bench.cell_files(Path('.').resolve(), 'pd14_half.half_runs')\n"
        "r = bench.reader('throwaway.count')({'window': {'attempted': 7}})\n"
        "print(json.dumps([f['config']['scale'], f['traffic']['run_ms'],"
        " sorted(m['name'] for m in f['per_layer']), r,"
        " bench.__file__]))\n")
    out = subprocess.run([sys.executable, "-c", probe], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120,
                         env={"PYTHONPATH": str(tmp_path),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    scale, run_ms, per_layer, value, where = json.loads(out.stdout)
    assert (scale, run_ms, value) == (0.5, 500.0, 7)
    assert "throwaway.count" in per_layer
    assert where.startswith(str(tmp_path))
