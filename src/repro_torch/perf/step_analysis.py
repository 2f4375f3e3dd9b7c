"""What one step of the port dispatches, and what it costs: the
counterpart of ``repro.perf.hlo_analysis``.

The reference reads the compiled HLO of its scan: a trip-count-aware cost
model (``analyze_hlo``: FLOPs, HBM bytes, collective bytes) and a census
of what the module is made of (``op_census``).  The port has no compiled
module: PyTorch dispatches one op at a time, so both are read off the ops
themselves, under a :class:`~torch.utils._python_dispatch.TorchDispatchMode`
wrapped around the step:

* :func:`op_census` -- each aten op a step dispatches, by name; dtype
  casts (``_to_copy`` / ``copy_`` that change the dtype: HLO's
  ``convert``); float64 tensors made; host syncs (``_local_scalar_dense``,
  copies from the card to the host); and whether every step dispatches
  the same op sequence;
* :func:`analyze_step` -- per step and per rank, the operand and result
  bytes of each dispatched op (eager ops are unfused, so this is memory
  traffic, not a fusion estimate), elementwise FLOPs (one an output
  element of a pointwise op), matmul FLOPs (``torch.utils.flop_counter``),
  and collective bytes (an all-reduce counted twice, reduce-scatter plus
  all-gather, as the reference counts it).

The hand-written kernels are ``ctypes`` calls, invisible to a dispatch
mode.  On CPU tensors their plain versions run and are counted op by op.
On ``meta`` tensors (``launch.dryrun``) a kernel wrapper gives its
outputs' shapes and reports its work through :func:`note_kernel`; the
collectives of a world report theirs through :func:`note_collective`.  On
the card, what a replayed body launches comes from ``torch.profiler``
instead: :func:`kernel_census`.
"""
from __future__ import annotations

import contextvars
import hashlib
from collections import Counter, defaultdict
from typing import Callable, Dict, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode

#: the analyses open in this context (innermost last); the world's
#: collectives and the kernels' meta forms report into them
_OPEN: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_step_analysis", default=())

_CAST_OPS = frozenset({"aten._to_copy", "aten.copy_", "aten.copy"})
#: the op a tensor's read to a host scalar dispatches (``.item()``,
#: ``float()``, ``bool()``)
_SYNC_OP = "aten._local_scalar_dense"
#: the largest tensors of a step ``analyze_step`` lists
TOP_INTERMEDIATES = 8
#: ops that make no new tensor (another handle on the same one; autograd
#: issues them as the Python side needs, not as the step asks): not
#: recorded
_ALIASES = frozenset({"aten.detach", "aten.lift_fresh", "aten.alias"})
#: ops that move no data (allocation, metadata); skipped by the byte count
_NO_TRAFFIC = frozenset({"aten.empty", "aten.empty_like", "aten.new_empty",
                         "aten.empty_strided", "aten.sym_size",
                         "aten.sym_stride", "aten.sym_numel", "aten.set_",
                         "aten.resize_"})


def note_collective(kind: str, nbytes: int) -> None:
    """Record a collective's result bytes (``all-gather``, ``all-reduce``,
    ...) in every analysis open in this context; free when none is."""
    for a in _OPEN.get():
        a.collectives[kind]["count"] += 1
        a.collectives[kind]["bytes"] += int(nbytes)


def note_kernel(name: str, nbytes: int, flops: int) -> None:
    """Record a kernel's call with the bytes and operations it stands for
    (a kernel wrapper's ``meta`` form reports what a launch would move)."""
    for a in _OPEN.get():
        k = a.kernels[name]
        k["count"] += 1
        k["bytes"] += int(nbytes)
        k["flops"] += int(flops)


def _tensors(tree) -> List[torch.Tensor]:
    out = []

    def walk(x):
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
    walk(tree)
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _StepRecord:
    """What one step dispatched."""

    def __init__(self):
        self.mm_flops = 0
        self.sequence: List[str] = []
        self.casts: Counter = Counter()
        self.f64 = 0
        self.syncs = 0
        self.d2h = 0
        self.bytes = 0
        self.ew_flops = 0
        self.outputs: List[tuple] = []          # (bytes, op, shape, dtype)
        self.collectives = defaultdict(lambda: {"count": 0, "bytes": 0})
        self.kernels = defaultdict(lambda: {"count": 0, "bytes": 0,
                                            "flops": 0})


class _Recorder(TorchDispatchMode):
    """Records each dispatched op into ``record``."""

    def __init__(self, record: _StepRecord):
        super().__init__()
        self.record = record

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = str(func.overloadpacket)
        if name in _ALIASES:            # another handle, no op on the card
            return out
        rec = self.record
        rec.sequence.append(name)
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        if name in _CAST_OPS and ins and outs:
            src = ins[-1] if name in ("aten.copy_", "aten.copy") else ins[0]
            dst = ins[0] if name == "aten.copy_" else outs[0]
            if src.dtype != dst.dtype:
                rec.casts[f"{src.dtype}->{dst.dtype}"] += 1
            if src.device.type == "cuda" and dst.device.type == "cpu":
                rec.d2h += 1
        if name == _SYNC_OP:
            rec.syncs += 1
        view = getattr(func, "is_view", False)
        if not view:
            rec.f64 += sum(1 for t in outs if t.dtype == torch.float64)
        if not view and name not in _NO_TRAFFIC:
            rec.bytes += sum(_nbytes(t) for t in ins) \
                + sum(_nbytes(t) for t in outs)
        if not view and not name.endswith("_"):     # a new tensor
            for t in outs:
                rec.outputs.append((_nbytes(t), name, tuple(t.shape),
                                    str(t.dtype)))
        if torch.Tag.pointwise in getattr(func, "tags", ()):
            rec.ew_flops += sum(t.numel() for t in outs)
        return out


def _record_step(fn: Callable, args, flops: bool = False):
    """Run ``fn(*args)`` once under a recorder (and a FLOP counter)."""
    rec = _StepRecord()
    token = _OPEN.set(_OPEN.get() + (rec,))
    try:
        if flops:
            from torch.utils.flop_counter import FlopCounterMode
            counter = FlopCounterMode(display=False)
            with counter, _Recorder(rec):
                fn(*args)
            rec.mm_flops = counter.get_total_flops()
        else:
            with _Recorder(rec):
                fn(*args)
    finally:
        _OPEN.reset(token)
    return rec


def op_census(fn: Callable, *args, n_steps: int = 1) -> dict:
    """Run ``fn(*args)`` ``n_steps`` times (each call one step: ``fn``
    carries its own state) and count what each dispatched.

    Returns ``ops`` (aten op -> count in the first step), the per-step
    lists ``ops_per_step``, ``casts_per_step``, ``f64_per_step``,
    ``syncs_per_step`` and ``d2h_per_step``, their largest values
    (``casts``, ``f64_tensors``, ``host_syncs``, ``d2h_copies``),
    ``cast_kinds`` (``"torch.float32->torch.int32"`` -> count in the first
    step), ``same_sequence``: True when every step dispatched the same op
    sequence, and ``sequence_digests``, a digest of each step's sequence
    (to compare the steps of two runs).
    """
    if n_steps < 1:
        raise ValueError(f"n_steps must be >= 1, got {n_steps}")
    recs = [_record_step(fn, args) for _ in range(n_steps)]
    first = recs[0]
    per = {
        "ops_per_step": [len(r.sequence) for r in recs],
        "casts_per_step": [sum(r.casts.values()) for r in recs],
        "f64_per_step": [r.f64 for r in recs],
        "syncs_per_step": [r.syncs for r in recs],
        "d2h_per_step": [r.d2h for r in recs],
    }
    return {
        "n_steps": n_steps,
        "ops": dict(sorted(Counter(first.sequence).items())),
        **per,
        "casts": max(per["casts_per_step"]),
        "f64_tensors": max(per["f64_per_step"]),
        "host_syncs": max(per["syncs_per_step"]),
        "d2h_copies": max(per["d2h_per_step"]),
        "cast_kinds": dict(sorted(first.casts.items())),
        "same_sequence": all(r.sequence == first.sequence for r in recs),
        "sequence_digests": [hashlib.sha1("\n".join(r.sequence).encode())
                             .hexdigest()[:16] for r in recs],
    }


def wire_bytes(collectives: Dict[str, dict]) -> float:
    """Bytes a step puts on the links: an all-reduce twice (its
    reduce-scatter and all-gather phases), any other collective its result
    bytes (the reference's ``dryrun.wire_bytes``)."""
    return float(sum((2.0 if kind == "all-reduce" else 1.0) * c["bytes"]
                     for kind, c in collectives.items()))


def analyze_step(fn: Callable, *args, n_steps: int = 1) -> dict:
    """The cost of ``fn(*args)`` per step, on this rank, averaged over
    ``n_steps`` calls: ``bytes_per_step`` (operand and result bytes of the
    dispatched ops, plus the bytes the reporting kernels stand for),
    ``elementwise_flops_per_step``, ``matmul_flops_per_step``,
    ``kernel_flops_per_step``, ``collectives`` (kind -> count and result
    bytes a step), ``collective_wire_bytes_per_step`` (:func:`wire_bytes`),
    ``kernels`` (name -> calls, bytes and FLOPs a step), the bytes of the
    new tensors a step makes (``intermediate_bytes_per_step``: an upper
    bound of what it holds at once) and the largest of them in the first
    step (``largest_intermediates``)."""
    if n_steps < 1:
        raise ValueError(f"n_steps must be >= 1, got {n_steps}")
    recs = [_record_step(fn, args, flops=True) for _ in range(n_steps)]
    per = lambda total: total / n_steps
    colls: Dict[str, dict] = defaultdict(lambda: {"count": 0, "bytes": 0})
    kerns: Dict[str, dict] = defaultdict(lambda: {"count": 0, "bytes": 0,
                                                  "flops": 0})
    for r in recs:
        for kind, c in r.collectives.items():
            for f in c:
                colls[kind][f] += c[f]
        for name, k in r.kernels.items():
            for f in k:
                kerns[name][f] += k[f]
    colls = {k: {f: per(v) for f, v in c.items()} for k, c in colls.items()}
    kerns = {k: {f: per(v) for f, v in c.items()} for k, c in kerns.items()}
    largest = sorted((o for r in recs[:1] for o in r.outputs), reverse=True)
    return {
        "n_steps": n_steps,
        "bytes_per_step": per(sum(r.bytes for r in recs))
        + sum(k["bytes"] for k in kerns.values()),
        "elementwise_flops_per_step": per(sum(r.ew_flops for r in recs)),
        "matmul_flops_per_step": per(sum(r.mm_flops for r in recs)),
        "kernel_flops_per_step": sum(k["flops"] for k in kerns.values()),
        "collectives": colls,
        "collective_wire_bytes_per_step": wire_bytes(colls),
        "kernels": kerns,
        "intermediate_bytes_per_step": per(sum(o[0] for r in recs
                                               for o in r.outputs)),
        "largest_intermediates": [
            {"bytes": b, "op": op, "shape": list(shape), "dtype": dtype}
            for b, op, shape, dtype in largest[:TOP_INTERMEDIATES]],
    }


def kernel_census(replay: Callable[[], None], n_steps: int) -> dict:
    """What ``replay()`` (``n_steps`` steps, e.g. one replay of a body
    graph) runs on the card, from ``torch.profiler``: each kernel's (and
    memory copy's) launches and device µs a step, and their sum.  On the
    card only."""
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        raise RuntimeError("kernel_census reads the card's profiler: no "
                           "CUDA card")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        replay()
        torch.cuda.synchronize()
    steps = n_steps
    table: Dict[str, dict] = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = ev.cuda_time_total
        if not us:
            continue
        table[ev.key] = {"launches_per_step": ev.count / steps,
                         "us_per_step": us / steps}
    table = dict(sorted(table.items(), key=lambda kv: -kv[1]["us_per_step"]))
    return {"kernels": table,
            "us_per_step": sum(v["us_per_step"] for v in table.values()),
            "launches_per_step": sum(v["launches_per_step"]
                                     for v in table.values())}
