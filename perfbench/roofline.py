"""The yardstick of the rooflines: the card's peaks and each kernel's bytes
and operations.

Copied from ``chip_smoke.py`` (``bound``, ``k2_bytes``, K3's, K4's and
``stdp_update``'s bytes, ``LIF_OPS``, ``ENTRY_OPS``): each input byte read
and each output byte written once, for the run's own spikes.  The spikes'
work is counted from the window's population counts and the drawn
network's mean degrees per population (``netgen.degree_stats``), so it is
a computed count, the same whatever kernel does the work.
"""
from __future__ import annotations

import math
import re
from typing import Optional

#: H100 SXM memory rate and float32 rate outside the tensor cores (NVIDIA
#: data sheet, 700 W)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
#: float32 products and sums per neuron of one LIF step
LIF_OPS = 13
#: operations per delivered ELL entry: the slot's add and modulo, and the
#: atomic add
ENTRY_OPS = 3


def bound_s(n_bytes: float, n_ops: float,
            ops_per_s: float = FP32_OPS_PER_S) -> float:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over the operations' rate."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / ops_per_s)


def spike_work(counts_per_step, net: dict) -> dict:
    """Per step, on average: the real ELL entries the spikes' rows hold
    (``out``), their plastic ones (``out_plastic``), the entries of the
    spiking neurons' incoming rows (``in``) and the plastic ones
    (``in_plastic``), and the distinct sources those plastic ones name
    (``sources``, their expected count under uniform sources)."""
    w = {key: sum(c * d for c, d in zip(counts_per_step, net[key]))
         for key in ("out", "out_plastic", "in", "in_plastic")}
    e = net["n_exc"]
    w["sources"] = e * (1.0 - math.exp(-w["in_plastic"] / e)) if e else 0.0
    return w


def k2_bytes(n: int, budget: int, n_entries: float) -> float:
    """K2's bytes: the spike vector, the ids, the overflow, the real rows'
    (target, weight, dbin) entries and a read-modify-write of the ring
    cell each real entry adds into."""
    return n + 4 * budget + 4 + n_entries * (12 + 8)


def k3_bytes(n: int, budget: int, n_entries: float) -> float:
    """K3's bytes: the neurons' state in and out, the drive, the spikes;
    the ring slot read and zeroed; K2's ids, overflow and entries."""
    return (n * (6 * 4 + 4 * 4 + 1) + n + 2 * 2 * (n + 1) * 4
            + 4 * budget + 4 + n_entries * (12 + 8))


def k3_ops(n: int, n_entries: float) -> float:
    return LIF_OPS * n + ENTRY_OPS * n_entries


def k4_bytes(n: int, budget: int, w: dict) -> float:
    """K4's bytes: K3's, the depression's plastic mask and weights of the
    delivered rows, and the traces in and out."""
    return (n * (6 * 4 + 4 * 4 + 1) + n + 2 * 2 * (n + 1) * 4
            + 4 * budget + 4 + w["out"] * (12 + 8)
            + w["out"] + 4 * w["out_plastic"] + 16 * n)


def k4_ops(n: int, w: dict) -> float:
    return (LIF_OPS * n + ENTRY_OPS * w["out"] + 2 * w["out_plastic"]
            + 4 * n)


def stdp_bytes(w: dict, budget: int) -> float:
    """``stdp_update``'s bytes (the potentiation and clip): the ids; the
    IN rows' masks, and the plastic entries' index and weight (read and
    written); each distinct source's trace once; the OUT rows' masks and
    plastic weights, read for the clip."""
    return (4 * budget + w["in"] + 12 * w["in_plastic"]
            + 4 * w["sources"] + w["out"] + 4 * w["out_plastic"])


def stdp_ops(w: dict) -> float:
    return 2 * w["in_plastic"]


def drive_probe_bytes(n: int) -> float:
    """The rest of a step: the background's rates read and its currents
    written, the spike vector read by the probe."""
    return 8 * n + n


def kernel_form(name: str) -> Optional[str]:
    """Which hand kernel a profiler name is: ``"K3"``, ``"K4"``, ``"K2"``
    (the three forms of ``lif_deliver_kernel``), ``"stdp_update"``,
    another hand kernel's name, or None for everything else."""
    if "lif_deliver_kernel" in name:
        form = re.search(r"Form\)\s*(\d)|Form::(k\w+)", name)
        tag = form and (form.group(1) or form.group(2))
        return {"1": "K4", "kPlasticStep": "K4", "2": "K2",
                "kDeliver": "K2"}.get(tag, "K3")
    for k in ("stdp_update_kernel", "lif_update", "gated_spike",
              "flash_attention"):
        if k in name:
            return "stdp_update" if k == "stdp_update_kernel" else k
    return None


def share(bound: float, measured: float) -> Optional[float]:
    """A roofline share in %, or None when nothing was measured."""
    if not measured or measured <= 0:
        return None
    return 100.0 * bound / measured


def short_name(name: str, limit: int = 160) -> str:
    """A device operation's name without its namespaces' noise, cut to
    ``limit`` characters (the breakdown's entries)."""
    for noise in ("(anonymous namespace)::", "at::native::", "at::cuda::",
                  "at_cuda_detail::", "void "):
        name = name.replace(noise, "")
    return name if len(name) <= limit else name[:limit - 3] + "..."
