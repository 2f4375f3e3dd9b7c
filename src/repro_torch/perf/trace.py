"""The port's spans and counters, on the device trace's clock.

    from repro_torch.perf import trace

    with trace.recording():             # the one switch
        sim.run(1.0)
    spans = trace.take()                # [Span(id, parent, run, name, ...)]
    trace.counters()                    # {"session.syncs": 4, ...}

:func:`span` is live while :func:`recording` is open or a
``torch.profiler`` runs; otherwise it returns one shared no-op context, at
the cost of a flag read and the profiler's "enabled" query.  A live span
records its name and id, its parent (the enclosing span on this thread),
its run id (the id of the enclosing ``session.run``, so that one run's
spans share one identifier) and its start and end on
``time.perf_counter_ns()``.  Under a running profiler it is also a range
of the profiler's (``torch._C._profiler._RecordFunctionFast``, what
``record_function`` records, at an op's scope and a tenth of its cost): it
stands among the trace's host events, on the trace's clock, so an idle gap
of the device falls inside a named span.  It leaves no range on the
device's timeline, as a ``record_function`` range does, which would count
as device work in a trace's union of device operations.  While the current stream captures a CUDA graph a span records
nothing: a range recorded at capture would not follow the replays.  The
buffer is bounded (:data:`MAX_SPANS`; what a full buffer drops counts as
``trace.dropped``) and shared by every thread, under one lock.

:func:`count` is always on: plain integers, as ``kernels._build.launches``
is.  No counter is counted inside a CUDA graph's capture (a sync cannot be
captured, and a capture records no span), so a replay adds none; it adds
only the launches its graph holds (``api.backends._Graph``).
:func:`counters` is one snapshot of them, of ``_build.launches``
(``launches.<kernel>``) and of the graph caches' captures
(``graphs.captures``), read where they live.

The spans and counters, by layer (each read by a per-layer metric of
``perfbench/``, or by ``RunResult.timers``):

=========  ==========================================  =====================
layer      span or counter                             covers
=========  ==========================================  =====================
session    ``session.build`` >                         ``backend.build``; the
           ``session.build.tables``,                   strategy's tables;
           ``session.build.plastic``                   the rule's ``bind``
session    ``session.run`` > ``session.wait``,         one ``Simulator.run``;
           ``session.readback``                        its syncs; the reads
session    ``session.syncs`` (counter)                 syncs, ``.item()``,
                                                       ``.cpu()`` of a run
loop       ``loop.capture``                            one graph captured
loop       ``loop.load``, ``loop.replay``,             ``_run_graphed``, in
           ``loop.epilogue``, ``loop.outputs``         order
step       ``step`` > ``step.drive``,                  one eager step; the
           ``step.deliver``, ``step.stdp``,            drive, K3/K4 (or the
           ``step.probe`` (``step.update`` in the      delivery), STDP, the
           split loop, around its update phase)        probes
=========  ==========================================  =====================
"""
from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import Dict, Iterator, List, NamedTuple, Optional

import torch

#: the most spans the buffer holds until :func:`take` drains it
MAX_SPANS = 1 << 20
#: the span whose id the spans inside it carry as their run id
RUN = "session.run"


class Span(NamedTuple):
    """One closed span."""
    id: int
    parent: Optional[int]        # the enclosing span's id on its thread
    run: Optional[int]           # the enclosing ``session.run``'s id
    name: str
    start_ns: int                # time.perf_counter_ns()
    end_ns: int

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9


_lock = threading.Lock()
_spans: List[tuple] = []         # Span's fields, made into Spans by take()
_counts: Dict[str, int] = {}
_recording = 0                   # open recording() contexts
_ids = itertools.count(1)
_local = threading.local()       # this thread's open spans
_profiling = torch._C._autograd._profiler_enabled
_Range = torch._C._profiler._RecordFunctionFast


def _capturing() -> bool:
    """True while the current stream captures a CUDA graph."""
    return torch.cuda.is_initialized() \
        and torch.cuda.is_current_stream_capturing()


def _open_spans() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Off:
    """The span that records nothing."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


class _Live:
    """A span that times itself; it keeps its record in the buffer when
    ``keep`` and is a profiler range when ``profiled``.  Its clock starts
    before the range opens and stops after it closes."""
    __slots__ = ("name", "keep", "range", "stack", "id", "parent", "run",
                 "start_ns", "end_ns")

    def __init__(self, name: str, keep: bool, profiled: bool):
        self.name, self.keep = name, keep
        self.range = _Range(name) if profiled else None

    def __enter__(self):
        stack = self.stack = _open_spans()
        if stack:
            top = stack[-1]
            self.parent, run = top.id, top.run
        else:
            self.parent = run = None
        self.id = next(_ids)
        self.run = self.id if self.name == RUN else run
        stack.append(self)
        self.start_ns = time.perf_counter_ns()
        if self.range is not None:
            self.range.__enter__()
        return self

    def __exit__(self, *exc) -> bool:
        if self.range is not None:
            self.range.__exit__(*exc)
        self.end_ns = time.perf_counter_ns()
        self.stack.pop()
        if self.keep:
            _keep((self.id, self.parent, self.run, self.name, self.start_ns,
                   self.end_ns))
        return False

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9


def _keep(fields: tuple) -> None:
    with _lock:
        if len(_spans) < MAX_SPANS:
            _spans.append(fields)
        else:
            _counts["trace.dropped"] = _counts.get("trace.dropped", 0) + 1


def span(name: str, timed: bool = False):
    """A context for the work named ``name``: live while :func:`recording`
    is open or a profiler runs (or, with ``timed``, always: the
    instrumented loop's phases read their ``seconds``), a shared no-op
    otherwise and while a CUDA graph is captured."""
    profiled = _profiling()
    if not (_recording or profiled or timed) or _capturing():
        return _OFF
    return _Live(name, bool(_recording or profiled), profiled)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` (always on)."""
    with _lock:
        _counts[name] = _counts.get(name, 0) + n


@contextlib.contextmanager
def recording() -> Iterator[None]:
    """Record every span opened inside (on any thread) until closed."""
    global _recording
    with _lock:
        _recording += 1
    try:
        yield
    finally:
        with _lock:
            _recording -= 1


def take() -> List[Span]:
    """The recorded spans, oldest first; the buffer is emptied."""
    with _lock:
        out = list(_spans)
        _spans.clear()
    return [Span._make(f) for f in out]


def tally() -> Dict[str, int]:
    """One snapshot of the counters that :func:`count` keeps."""
    with _lock:
        return dict(_counts)


def counters() -> Dict[str, int]:
    """One snapshot of the counters, of the kernels' launches
    (``launches.<kernel>``) and of the graph captures
    (``graphs.captures``: the misses of every backend's graph cache)."""
    from repro_torch.kernels import _build
    from repro_torch.serve import compile_cache
    out = tally()
    out.update((f"launches.{k}", v) for k, v in _build.launches.items())
    out["graphs.captures"] = sum(c.misses for c in compile_cache.iter_caches()
                                 if c.name.endswith(".graphs"))
    return out
