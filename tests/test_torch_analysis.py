"""repro_torch.analysis: the lint rules on their fixtures, the baseline's
lifecycle, the report schema against the reference's, the lint of the
port's own tree, and ``sanitize()``.

The fixture files under ``tests/fixtures/analysis_torch/`` each break one
rule in torch spellings; a ``# RL00x:`` marker comment sits on every line
the linter must flag, so the tests hold rule id and line number.
``clean.py`` writes the same shapes correctly and gives no finding.  The
reference's framework-neutral fixtures (``tests/fixtures/analysis/``,
RL003 and RL005) go through both linters.
"""
import dataclasses
import datetime
import importlib
import re

import pytest
import torch

from repro.analysis import lint as ref_lint
from repro.analysis import report as ref_report
from repro_torch.analysis import __main__ as cli
from repro_torch.analysis.lint import LintConfig, lint_paths
from repro_torch.analysis.report import (BaselineEntry, Finding,
                                         baseline_from_findings,
                                         diff_findings, load_baseline,
                                         make_report)
from repro_torch.analysis.sanitize import sanitize

# the module (the package's ``sanitize`` is the function of that name)
SZ = importlib.import_module("repro_torch.analysis.sanitize")
FIXTURES = "tests/fixtures/analysis_torch"
REF_FIXTURES = "tests/fixtures/analysis"

# roots and scopes aimed at the fixture directory instead of src/repro_torch
FIXTURE_CONFIG = LintConfig(
    roots=("rl001_host_sync.hot_step", "rl001_host_sync.hot_caller",
           "rl002_tensor_branch.hot_branch", "clean.hot_step"),
    dtype_scopes=("fixtures/analysis_torch/",),
    shared_state_scopes=("fixtures/analysis_torch/",),
)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def marked_lines(path: str, rule: str) -> set:
    """Line numbers carrying an ``# <rule>:`` marker comment."""
    pat = re.compile(rf"#\s*{rule}:")
    with open(path) as f:
        return {i for i, line in enumerate(f, 1) if pat.search(line)}


def lint_fixture(name: str):
    path = f"{FIXTURES}/{name}.py"
    return path, lint_paths([path], FIXTURE_CONFIG)


@pytest.mark.parametrize("fixture,rule,expected", [
    ("rl001_host_sync", "RL001", 11),
    ("rl002_tensor_branch", "RL002", 2),
    ("rl003_bad_plugin", "RL003", 5),
    ("rl004_float64", "RL004", 4),
    ("rl005_unlocked", "RL005", 2),
])
def test_rule_fires_on_marked_lines(fixture, rule, expected):
    path, findings = lint_fixture(fixture)
    assert {f.rule for f in findings} == {rule}
    assert {f.line for f in findings} == marked_lines(path, rule)
    assert len(findings) == expected


def test_clean_fixture_has_zero_findings():
    _, findings = lint_fixture("clean")
    assert findings == []


def test_rl001_unreachable_function_not_flagged():
    """Host syncs outside the hot call graph are legitimate."""
    _, findings = lint_fixture("rl001_host_sync")
    assert all("cold_helper" not in f.symbol for f in findings)


def test_rl001_names_each_torch_sync():
    _, findings = lint_fixture("rl001_host_sync")
    said = " ".join(f.message for f in findings)
    for what in (".item()", ".tolist()", ".cpu()", ".numpy()", "float()",
                 "int()", "bool()", "torch.cuda.synchronize()", "print()",
                 "np.asarray()"):
        assert what in said


def test_rl003_reports_symbols():
    _, findings = lint_fixture("rl003_bad_plugin")
    symbols = {f.symbol for f in findings}
    assert "rl003_bad_plugin.BadDelivery" in symbols          # missing method
    assert "rl003_bad_plugin.BadDelivery.prepare" in symbols  # param drift


def _keyed(findings):
    return sorted((f.rule, f.path, f.line, f.symbol, f.message)
                  for f in findings)


@pytest.mark.parametrize("name", ["rl003_bad_plugin", "rl005_unlocked"])
def test_framework_neutral_rules_match_the_reference(name):
    """RL003 and RL005 on the reference's own fixtures: the reference's
    findings, word for word, and one more for RL003: the port's
    ``StreamProbe.init`` takes the device, so the fixture's ``init=lambda:
    0`` does not conform here."""
    path = f"{REF_FIXTURES}/{name}.py"
    scopes = dict(dtype_scopes=("fixtures/analysis/",),
                  shared_state_scopes=("fixtures/analysis/",),
                  rules=("RL003", "RL005"))
    ref = ref_lint.lint_paths([path], ref_lint.LintConfig(**scopes))
    port = lint_paths([path], LintConfig(**scopes))
    assert ref
    extra = [f for f in port if "init= callable" in f.message]
    assert len(extra) == (1 if name == "rl003_bad_plugin" else 0)
    assert _keyed(f for f in port if f not in extra) == _keyed(ref)


# ---------------------------------------------------------------------------
# Baseline lifecycle: suppress, count budget, expiry, staleness
# ---------------------------------------------------------------------------

F = Finding("RL004", "src/x.py", 10, "x.fn", "float64 in device code")
TODAY = datetime.date(2026, 8, 1)


def entry(**kw):
    base = dict(rule=F.rule, path=F.path, symbol=F.symbol, message=F.message)
    base.update(kw)
    return BaselineEntry(**base)


def test_baseline_suppresses_matching_finding():
    diff = diff_findings([F], [entry()], TODAY)
    assert diff.ok
    assert diff.grandfathered == [F] and not diff.new and not diff.stale


def test_baseline_match_ignores_line_drift():
    moved = dataclasses.replace(F, line=99)
    diff = diff_findings([moved], [entry()], TODAY)
    assert diff.ok and diff.grandfathered == [moved]


def test_baseline_count_budget_is_exact():
    diff = diff_findings([F, F], [entry(count=1)], TODAY)
    assert not diff.ok
    assert len(diff.grandfathered) == 1 and len(diff.new) == 1


def test_expired_entry_stops_suppressing():
    diff = diff_findings([F], [entry(expires="2026-07-31")], TODAY)
    assert not diff.ok
    assert diff.expired == [F] and not diff.grandfathered


def test_unexpired_entry_still_suppresses():
    diff = diff_findings([F], [entry(expires="2026-08-01")], TODAY)
    assert diff.ok and diff.grandfathered == [F]


def test_stale_entry_reported_but_passes():
    other = entry(message="a finding that was fixed")
    diff = diff_findings([F], [entry(), other], TODAY)
    assert diff.ok
    assert diff.stale == [other]


def test_new_finding_fails():
    diff = diff_findings([F], [], TODAY)
    assert not diff.ok and diff.new == [F]


def test_baseline_roundtrip_from_findings():
    doc = baseline_from_findings([F, F], reason="why")
    assert doc["schema"] == "repro.analysis_baseline/v1"
    (e,) = doc["entries"]
    assert e["count"] == 2 and e["reason"] == "why"
    diff = diff_findings([F, F], [BaselineEntry(**doc["entries"][0])], TODAY)
    assert diff.ok and len(diff.grandfathered) == 2


def test_report_equals_the_reference_field_by_field():
    """The same findings and baseline give the reference's document, key
    for key (the schema strings included), and the same baseline doc."""
    g = Finding("RL001", "src/y.py", 3, "y.step", "print()")
    stale = entry(message="fixed")
    diff = diff_findings([F, g], [entry(), stale], TODAY)
    rf = [ref_report.Finding(**x.to_dict()) for x in (F, g)]
    rdiff = ref_report.diff_findings(
        rf, [ref_report.BaselineEntry(**dataclasses.asdict(e))
             for e in (entry(), stale)], TODAY)
    tool = "repro_torch.analysis.lint"
    assert make_report([F, g], diff, tool=tool) \
        == ref_report.make_report(rf, rdiff, tool=tool)
    assert baseline_from_findings([F, F, g], reason="r") \
        == ref_report.baseline_from_findings(rf + rf[:1], reason="r")


def test_the_port_lints_clean_against_its_baseline():
    """The port's tree: every finding is grandfathered with a reason, no
    entry is stale, and the CLI exits 0 (5 without the baseline)."""
    findings = lint_paths(["src/repro_torch"], LintConfig())
    baseline = load_baseline(cli.DEFAULT_BASELINE)
    diff = diff_findings(findings, baseline)
    assert diff.ok, [f.format() for f in diff.new]
    assert not diff.stale
    assert all(e.reason and e.reason != "grandfathered at introduction"
               for e in baseline)
    # no host sync and no branch on a tensor in a step: what the baseline
    # keeps of RL001 is make_step's builder, swept in by the walk
    assert {f.symbol for f in findings if f.rule in ("RL001", "RL002")} \
        == {"repro_torch.core.engine._background_drive"}
    assert cli.main(["lint"]) == 0


def test_cli_lint_exits_5_on_new_findings(tmp_path):
    out = tmp_path / "report.json"
    assert cli.main(["lint", "--baseline", str(tmp_path / "none.json"),
                     "--json", str(out)]) == cli.EXIT_FINDINGS
    import json
    doc = json.loads(out.read_text())
    assert doc["schema"] == "repro.analysis_report/v1"
    assert doc["summary"]["new"] == doc["summary"]["total"] > 0


def test_cli_modules_reports_no_unreachable_module(capsys):
    assert cli.main(["modules"]) == 0
    assert "0 module(s) unreachable" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# sanitize()
# ---------------------------------------------------------------------------

def test_sanitize_sets_and_restores_every_flag():
    before = SZ.active_checks()
    assert before is None
    with sanitize():
        checks = SZ.active_checks()
        assert checks.nan_check and checks.sync_check
        with pytest.raises(SZ.StrictDtypeError, match="float64"):
            torch.zeros(3, dtype=torch.float64)
    assert SZ.active_checks() is None
    torch.zeros(3, dtype=torch.float64)          # allowed again
    with sanitize(nan_check=False, strict_dtypes=False, sync_check=False):
        checks = SZ.active_checks()
        assert not checks.nan_check and not checks.sync_check
        torch.zeros(3, dtype=torch.float64)
    with pytest.raises(ValueError, match="inner"):
        with sanitize():
            raise ValueError("inner")
    assert SZ.active_checks() is None
    torch.zeros(3, dtype=torch.float64)


def test_sanitize_strict_dtypes_refuses_mixing():
    a, b = torch.ones(4), torch.ones(4, dtype=torch.bfloat16)
    with sanitize():
        with pytest.raises(SZ.StrictDtypeError, match="mixes"):
            a + b
        c = a + b.to(torch.float32)              # an explicit cast is fine
        d = a * 2 + torch.arange(4)              # int promotion is fine
    assert torch.equal(c, torch.full((4,), 2.0)) and d.dtype == a.dtype


def test_sync_errors_sets_and_restores_the_mode(monkeypatch):
    """On a card the steps run under the sync debug mode "error", and the
    mode before is restored, also after an exception."""
    modes = ["warn"]
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode",
                        lambda: modes[-1])
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", modes.append)
    with SZ._sync_errors(torch.device("cuda")):
        assert modes[-1] == "error"
    assert modes[-1] == "warn"
    with pytest.raises(RuntimeError):
        with SZ._sync_errors(torch.device("cuda")):
            raise RuntimeError("a sync")
    assert modes == ["warn", "error", "warn", "error", "warn"]
    with SZ._sync_errors(torch.device("cpu")):
        pass
    assert len(modes) == 5


@pytest.fixture(scope="module")
def session():
    from repro_torch.api import Simulator
    from repro_torch.configs.microcircuit import MicrocircuitConfig
    return Simulator(MicrocircuitConfig(scale=0.02, strategy="ell",
                                        t_presim=0.0, seed=55),
                     device="cpu")


def test_sanitized_run_equals_the_plain_run(session):
    from repro_torch.api.backends import tree_map
    start = tree_map(torch.clone, session.state)
    gen = session._generator.get_state()
    with sanitize():
        a = session.run(3.0)
    session.state = tree_map(torch.clone, start)
    session._generator.set_state(gen)
    b = session.run(3.0)
    assert (a["pop_counts"] == b["pop_counts"]).all()


@pytest.mark.parametrize("where", ["V", "ring"])
def test_sanitize_names_the_step_and_tensor_of_a_nan(session, where):
    """A NaN in V shows at the run's first step; a NaN arrival in the ring
    slot that step 7 reads, at step 7 in ``I_ex``."""
    state = session.state
    t = int(state.t)
    if where == "V":
        state.neuron.V[3] = float("nan")
        want = rf"step 0 of this run \(step counter t = {t}\) left V"
    else:
        state.ring[(t + 7) % state.ring.shape[0], 0, 11] = float("nan")
        want = rf"step 7 of this run \(step counter t = {t + 7}\) left I_ex"
    with pytest.raises(FloatingPointError, match=want):
        with sanitize():
            session.run(2.0)
    session.reset()
