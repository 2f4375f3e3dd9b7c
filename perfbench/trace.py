"""The traced sub-window: ``torch.profiler`` over a few steady units.

``profile`` runs the mix's unit ``traffic["profile"]["units"]`` times
after the measured window and reduces the profiler's events to what the
per-layer readers take: each device operation's time and calls, the
device's busy time (the union of its operations' intervals) over the
traced window, and the longest idle gaps with what the host was doing in
them (from a second, shorter pass that traces the host too).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from perfbench import roofline

WINDOW = "perfbench.window"


def _merge(intervals: list) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out


def reduce(device_ops: list, host_ops: list, window: tuple) -> dict:
    """What the readers take, from ``device_ops`` and ``host_ops`` (lists
    of ``(name, start_us, end_us)``) over ``window`` (µs)."""
    lo, hi = window
    kernels: dict = {}
    for name, a, b in device_ops:
        k = kernels.setdefault(name, {"us": 0.0, "calls": 0})
        k["us"] += b - a
        k["calls"] += 1
    merged = _merge([(max(a, lo), min(b, hi)) for _, a, b in device_ops
                     if b > lo and a < hi])
    busy = sum(b - a for a, b in merged)
    gaps = []
    edges = [lo] + [x for ab in merged for x in ab] + [hi]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            gaps.append((b - a, a, b))
    gaps.sort(reverse=True)
    idle = [[_host_doing(host_ops, (a + b) / 2), g * 1e-6]
            for g, a, b in gaps[:10]]
    top = sorted(kernels.items(), key=lambda kv: -kv[1]["us"])[:10]
    return {"kernels": kernels, "busy_s": busy * 1e-6,
            "window_s": (hi - lo) * 1e-6,
            "breakdown": {"device_ops": [[roofline.short_name(k),
                                          v["us"] * 1e-6] for k, v in top],
                          "idle_gaps": idle}}


def _host_doing(host_ops: list, at: float) -> str:
    """The innermost host operation running at ``at`` (the harness's own
    spans only where nothing else was)."""
    best, best_len = "host: nothing traced", float("inf")
    for name, a, b in host_ops:
        if a <= at <= b:
            length = b - a + (1e12 if name.startswith("perfbench.") else 0)
            if length < best_len:
                best, best_len = name, length
    return best


def _events(prof) -> tuple:
    """The profile's device operations and host operations, and the
    harness's window span, each as ``(name, start_us, end_us)``."""
    device_ops, host_ops, window = [], [], None
    for e in prof.events():
        a, b = float(e.time_range.start), float(e.time_range.end)
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if not e.name.startswith("perfbench."):
                device_ops.append((e.name, a, b))
        elif e.name == WINDOW:
            window = (a, b)
        else:
            host_ops.append((e.name, a, b))
    return device_ops, host_ops, window


def _units(pattern, n: int, dev, on_card: bool) -> tuple:
    """``n`` units of ``pattern``: their counts and the seconds they took
    together."""
    counts = []
    t0 = time.perf_counter()
    for _ in range(n):
        counts.append(np.asarray(pattern.unit().data["pop_counts"]))
    if on_card:
        torch.cuda.synchronize(dev)
    return counts, time.perf_counter() - t0


def profile(pattern, dev, on_card: bool) -> dict:
    """The traced sub-window of ``pattern``'s session, in two passes.  The
    first traces the device alone (tracing the host too would slow the
    host side of each unit): the device operations and their busy time
    over the pass's wall time.  The second, of ``labelled_units`` units,
    traces the host too, to name what the host was doing in each long
    idle gap."""
    from torch.profiler import ProfilerActivity, record_function
    cfg = pattern.traffic["profile"]
    cuda = [ProfilerActivity.CUDA] if on_card else []
    with torch.profiler.profile(activities=cuda or [ProfilerActivity.CPU]
                                ) as prof:
        counts, wall = _units(pattern, int(cfg["units"]), dev, on_card)
    device_ops = _events(prof)[0]
    lo = min((a for _, a, _ in device_ops), default=0.0)
    out = reduce(device_ops, [], (lo, lo + wall * 1e6))
    with torch.profiler.profile(activities=[ProfilerActivity.CPU] + cuda
                                ) as prof:
        with record_function(WINDOW):
            _units(pattern, int(cfg.get("labelled_units", 1)), dev, on_card)
    dev_ops, host_ops, window = _events(prof)
    if window is not None:
        out["breakdown"]["idle_gaps"] = reduce(
            dev_ops, host_ops, window)["breakdown"]["idle_gaps"]
    return finish(out, counts)


def finish(out: dict, counts: list) -> dict:
    """``reduce``'s result with the traced units' count, steps and spikes
    a step of each population, and the hand kernels' time and calls
    summed by form."""
    hand: dict = {}
    for name, k in out["kernels"].items():
        form = roofline.kernel_form(name)
        if form:
            h = hand.setdefault(form, {"us": 0.0, "calls": 0})
            h["us"] += k["us"]
            h["calls"] += k["calls"]
    allc = np.concatenate(counts)
    out.update(units=len(counts), steps=int(allc.shape[0]), hand=hand,
               counts_per_step=(allc.sum(axis=0) / max(1, allc.shape[0]))
               .tolist())
    return out
