"""repro_torch.perf.trace: the span tree with its parent and run ids, the
off path (nothing recorded, no op dispatched), no span while a graph is
captured, the spans against the CPU profiler's ranges, the counters, the
bounded buffer under many threads, what a span costs off and on, the
instrumented timers as the sums of their spans, the step census, and the
lint's reach into the module."""
import contextlib
import glob
import statistics
import sys
import threading
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.analysis import graph_contract as GC
from repro_torch.analysis.lint import (DEFAULT_ROOTS, LintConfig,
                                       hot_functions, index_module,
                                       lint_paths)
from repro_torch.api import Simulator
from repro_torch.api import backends as B
from repro_torch.configs.microcircuit import MicrocircuitConfig
from repro_torch.core import engine
from repro_torch.perf import trace
from repro_torch.perf.step_analysis import op_census

from test_torch_graph_contract import _SilentGraphs

CFG = MicrocircuitConfig(scale=0.02, strategy="ell", t_presim=0.0, seed=55)
FUSED = MicrocircuitConfig(scale=0.02, strategy="ell", t_presim=0.0,
                           seed=55, kernels="fused")
STEP_SPANS = {"step", "step.drive", "step.deliver", "step.stdp",
              "step.probe", "step.update"}


@pytest.fixture(autouse=True)
def _one_torch_thread_and_an_empty_buffer():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    trace.take()
    yield
    trace.take()
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def connectome():
    from repro_torch.core.connectivity import build_connectome
    return build_connectome(scale=CFG.scale, seed=CFG.seed)


def _by_name(spans) -> dict:
    out = {}
    for s in spans:
        out.setdefault(s.name, []).append(s)
    return out


def _innermost(event):
    while event is not None:
        if event.name in STEP_SPANS:
            return event.name
        event = event.cpu_parent
    return None


def test_span_tree_parents_and_run_ids():
    with trace.recording():
        with trace.span("outer") as outer:
            with trace.span("session.run") as run:
                with trace.span("b") as b:
                    with trace.span("c"):
                        pass
            with trace.span("d"):
                pass
    spans = trace.take()
    assert [s.name for s in spans] == ["c", "b", "session.run", "d",
                                       "outer"]
    s = {x.name: x for x in spans}
    assert len({x.id for x in spans}) == 5
    assert (s["outer"].parent, s["outer"].run) == (None, None)
    assert (s["session.run"].parent, s["session.run"].run) == (outer.id,
                                                               run.id)
    assert (s["b"].parent, s["b"].run) == (run.id, run.id)
    assert (s["c"].parent, s["c"].run) == (b.id, run.id)
    assert (s["d"].parent, s["d"].run) == (outer.id, None)
    for x in spans:
        assert x.start_ns <= x.end_ns and x.seconds >= 0
        if x.parent is not None:
            p = next(y for y in spans if y.id == x.parent)
            assert p.start_ns <= x.start_ns and x.end_ns <= p.end_ns


def test_a_run_is_one_tree_and_counts_its_syncs(connectome):
    sim = Simulator(FUSED, connectome=connectome, device="cpu")
    before = trace.counters()["session.syncs"] if "session.syncs" in \
        trace.counters() else 0
    with trace.recording():
        sim.run(1.0)                                    # 10 steps
    spans = trace.take()
    names = _by_name(spans)
    (run,) = names["session.run"]
    assert all(x.run == run.id for x in spans)
    assert len(names["step"]) == 10
    assert all(x.parent == run.id for x in names["step"])
    steps = {x.id for x in names["step"]}
    for name in ("step.drive", "step.deliver", "step.probe"):
        assert len(names[name]) == 10
        assert all(x.parent in steps for x in names[name])
    assert len(names["session.wait"]) == 2
    assert len(names["session.readback"]) == 1
    # two waits, the overflow's read, the counts' read-back
    assert trace.counters()["session.syncs"] - before == 4


def _no_spans(monkeypatch):
    off = lambda name, timed=False: contextlib.nullcontext()  # noqa: E731
    monkeypatch.setattr(trace, "span", off)
    monkeypatch.setattr(engine, "span", off)


def test_the_off_path_records_nothing_and_dispatches_no_op(connectome,
                                                           monkeypatch):
    assert trace.span("a") is trace.span("b")          # one shared no-op
    sim = Simulator(FUSED, connectome=connectome, device="cpu")
    sim.run(1.0)
    assert trace.take() == []
    off = op_census(GC.session_step(sim), n_steps=2)
    with trace.recording():                  # on, with no profiler
        on = op_census(GC.session_step(sim), n_steps=2)
    assert len(trace.take()) > 0
    graphed = Simulator(CFG, connectome=connectome, device="cpu",
                        backend=_SilentGraphs())
    runs = GC.check_graphed(graphed, symbol="spans", lengths=(130, 250))
    _no_spans(monkeypatch)
    bare = op_census(GC.session_step(sim), n_steps=2)
    graphed = Simulator(CFG, connectome=connectome, device="cpu",
                        backend=_SilentGraphs())
    bare_runs = GC.check_graphed(graphed, symbol="bare",
                                 lengths=(130, 250))
    for census in (off, on):
        assert census["ops_per_step"] == bare["ops_per_step"]
        assert census["sequence_digests"] == bare["sequence_digests"]
    assert [r["eager_ops"] for r in runs["runs"]] == \
        [r["eager_ops"] for r in bare_runs["runs"]]
    assert runs["census"]["ops_per_step"] == \
        bare_runs["census"]["ops_per_step"]


def test_no_span_is_recorded_while_capturing(connectome, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    sim = Simulator(FUSED, connectome=connectome, device="cpu")
    with trace.recording():
        assert trace.span("a") is trace.span("b", timed=True)
        with trace.span("a"):
            pass
        sim.run(0.5)
    assert trace.take() == []


def test_spans_lie_on_the_profilers_clock(connectome):
    """Each span holds its profiler range (its clock starts before the
    range opens and stops after it closes), within 50 µs at both ends for
    nine in ten spans: the first range a profiler session opens costs it
    some tens of microseconds before its timestamp, and a busy host delays
    some more."""
    sim = Simulator(FUSED, connectome=connectome, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]):
        sim.run(0.3)
    trace.take()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        sim.run(1.0)
    spans = sorted(trace.take(), key=lambda s: s.start_ns)
    names = {s.name for s in spans}
    ranges = sorted((e for e in prof.events() if e.name in names),
                    key=lambda e: e.time_range.start)
    assert [e.name for e in ranges] == [s.name for s in spans]
    assert len(spans) >= 40
    offset = statistics.median(1e3 * e.time_range.start - s.start_ns
                               for e, s in zip(ranges, spans))
    close = 0
    for e, s in zip(ranges, spans):
        late_start = 1e3 * e.time_range.start - offset - s.start_ns
        early_end = s.end_ns - (1e3 * e.time_range.end - offset)
        assert late_start > -10e3 and early_end > -10e3       # it holds it
        close += late_start < 50e3 and early_end < 50e3
    assert close >= 0.9 * len(spans)


def test_counters_read_launches_and_captures_where_they_live():
    from repro_torch.kernels import _build
    before = trace.counters()
    trace.count("test.things")
    trace.count("test.things", 3)
    now = trace.counters()
    assert now["test.things"] - before.get("test.things", 0) == 4
    assert {f"launches.{k}" for k in _build.launches} <= set(now)
    assert now["launches.lif_deliver"] == _build.launches["lif_deliver"]
    assert isinstance(now["graphs.captures"], int)


def test_a_full_buffer_drops_and_counts(monkeypatch):
    monkeypatch.setattr(trace, "MAX_SPANS", 3)
    dropped = trace.counters().get("trace.dropped", 0)
    with trace.recording():
        for i in range(5):
            with trace.span(f"s{i}"):
                pass
    assert [s.name for s in trace.take()] == ["s0", "s1", "s2"]
    assert trace.counters()["trace.dropped"] - dropped == 2


def _us_a_call(fn, n: int = 20_000) -> float:
    """Host µs of one ``fn()``, the best of five loops of ``n``."""
    best = float("inf")
    for _ in range(5):
        t0 = time.perf_counter_ns()
        for _ in range(n):
            fn()
        best = min(best, (time.perf_counter_ns() - t0) / n / 1e3)
    return best


def _one_span():
    with trace.span("cost"):
        pass


def test_what_a_span_costs_off_and_on():
    """A span off is one shared no-op context (a flag read and the
    profiler's query); on, it is a recorded ``Span``.  The loose bounds
    hold on a loaded host; the card's host reads 0.35-0.65 µs off and
    5-6 µs on."""
    off = _us_a_call(_one_span)
    counted = _us_a_call(lambda: trace.count("cost"))
    with trace.recording():
        on = _us_a_call(_one_span, 2_000)
    assert len(trace.take()) == 5 * 2_000
    assert off < 10 and counted < 10
    assert off < on < 500


def test_many_threads_lose_no_span_and_no_count():
    n_threads, n_spans = 16, 200
    before = trace.counters().get("test.stress", 0)

    def work():
        for _ in range(n_spans):
            with trace.span("outer"):
                with trace.span("inner"):
                    trace.count("test.stress")
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with trace.recording():
            threads = [threading.Thread(target=work)
                       for _ in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
                assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    spans = trace.take()
    names = _by_name(spans)
    assert len(names["outer"]) == len(names["inner"]) == n_threads * n_spans
    assert len({s.id for s in spans}) == len(spans)
    outer = {s.id for s in names["outer"]}
    assert all(s.parent in outer for s in names["inner"])
    assert all(s.parent is None for s in names["outer"])
    assert trace.counters()["test.stress"] - before == n_threads * n_spans


@pytest.mark.parametrize("plasticity", [None, "pair_stdp"])
def test_instrumented_timers_are_the_sums_of_their_spans(connectome,
                                                         plasticity):
    sim = Simulator(CFG, connectome=connectome, device="cpu",
                    backend="instrumented", plasticity=plasticity)
    sim.run(0.2)                  # its kernels loaded, its warm steps run
    with trace.recording():
        res = sim.run(0.5)
    sums = {}
    for s in trace.take():
        sums[s.name] = sums.get(s.name, 0.0) + s.seconds
    phases = {"update", "deliver", "record"} | (
        {"plasticity"} if plasticity else set())
    assert set(res.timers) == phases
    for key in phases:
        assert res.timers[key] == pytest.approx(sums[B.PHASE_SPANS[key]],
                                                rel=1e-9)
        assert res.timers[key] > 0
    # off, the phases still time themselves and record nothing
    assert set(sim.run(0.2).timers) == phases
    assert trace.take() == []


@pytest.mark.parametrize("plasticity", [None, "pair_stdp"])
def test_the_census_splits_the_step_and_leaves_the_session_be(
        connectome, plasticity):
    sim = Simulator(FUSED, connectome=connectome, device="cpu",
                    plasticity=plasticity)
    sim.run(0.3)
    leaves = B._leaves(sim.state)
    kept = [x.clone() for x in leaves]
    gen = sim._generator.get_state().clone()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        sim.step_census(3)
    assert all(torch.equal(a, b) for a, b in zip(B._leaves(sim.state),
                                                 kept))
    assert torch.equal(sim._generator.get_state(), gen)
    under = {}
    for e in prof.events():
        if e.name.startswith("aten::"):
            under.setdefault(_innermost(e), set()).add(e.name)
    assert "aten::poisson" in under["step.drive"]
    assert "aten::poisson" not in set().union(
        *(v for k, v in under.items() if k != "step.drive"))
    assert under["step.probe"] and under["step.deliver"]
    if plasticity:
        assert under["step.stdp"]
    spans = _by_name(trace.take())
    assert len(spans["step"]) == 3 and len(spans["step.probe"]) == 3


def test_the_lint_walks_into_the_spans(tmp_path):
    mods = [index_module(p) for p in glob.glob("src/repro_torch/**/*.py",
                                               recursive=True)]
    hot = hot_functions(mods, DEFAULT_ROOTS)
    assert {"repro_torch.perf.trace.span",
            "repro_torch.perf.trace._Live.__enter__",
            "repro_torch.perf.trace._Live.__exit__"} <= set(hot)
    assert "repro_torch.api.backends._LoopBackend._segment" in hot
    assert lint_paths(["src/repro_torch/perf/trace.py"], LintConfig()) == []
    # the buffer mutated outside its lock is RL005's
    src = open("src/repro_torch/perf/trace.py").read()
    unlocked = src.replace("""    with _lock:
        _counts[name] = _counts.get(name, 0) + n""",
                           """    _counts[name] = _counts.get(name, 0) + n""")
    assert unlocked != src
    bad = tmp_path / "trace.py"
    bad.write_text(unlocked)
    found = lint_paths([str(bad)], LintConfig(
        rules=("RL005",), shared_state_scopes=(str(tmp_path),)))
    assert [f.rule for f in found] == ["RL005"]
