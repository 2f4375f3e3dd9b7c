"""The per-population spike count (``csrc/pop_counts.cu``) and its plain
version.

Replaces no Pallas kernel: the reference counts a step's spikes per
population with a sorted ``segment_sum`` (``repro/api/probes.py:59-65``),
which the JAX package leaves to XLA.  ``spiked`` is the step's ``[L]``
bool spike vector and ``at`` the populations' ``[n_pops + 1]`` int32
bounds (``pop_of`` is sorted, so population p is ``[at[p], at[p + 1])``;
``L >= at[n_pops]``, and nothing past ``at[n_pops]`` is counted).  The
wrapper runs the plain version for CPU tensors and launches the CUDA kernel
for CUDA tensors, or raises; it never falls back.  The counts are
integers, so the kernel equals the plain version bit for bit.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_I, _P = ctypes.c_int, ctypes.c_void_p

#: the device type the kernel takes (the tests stand ``meta`` in for it)
DEVICE_TYPE = "cuda"


def pop_counts_plain(spiked: torch.Tensor, at: torch.Tensor) -> torch.Tensor:
    """``[n_pops]`` int32: the int32 running spike count, differenced at
    the bounds ``at``."""
    running = torch.cumsum(spiked, 0, dtype=torch.int32)
    v = torch.nn.functional.pad(running, (1, 0)).index_select(0, at)
    return v[1:] - v[:-1]


def _lib():
    lib = _build.library("pop_counts")
    if not getattr(lib, "_typed", False):
        lib.pop_counts_launch.restype = ctypes.c_int
        lib.pop_counts_launch.argtypes = [_P, _P, _P, _I, _P]
        lib._typed = True
    return lib


def _check(spiked: torch.Tensor, at: torch.Tensor) -> None:
    """A 1-D contiguous bool ``spiked`` and a 1-D contiguous int32 ``at``
    of at least one bound, on one CUDA device, or raise."""
    if spiked.dtype != torch.bool:
        raise TypeError(f"pop_counts takes a bool spike vector, got "
                        f"{spiked.dtype}")
    if at.dtype != torch.int32:
        raise TypeError(f"pop_counts takes int32 bounds, got {at.dtype}")
    if spiked.dim() != 1 or at.dim() != 1 or at.shape[0] < 1:
        raise ValueError(f"pop_counts takes a [L] spike vector and "
                         f"[n_pops + 1] bounds, got {tuple(spiked.shape)} "
                         f"and {tuple(at.shape)}")
    for t in (spiked, at):
        if not t.is_contiguous():
            raise ValueError("pop_counts: tensors must be contiguous")
        if t.device != spiked.device or t.device.type != DEVICE_TYPE:
            raise ValueError(f"pop_counts: tensors must both lie on one "
                             f"CUDA device (got {spiked.device} and "
                             f"{at.device})")


def pop_counts(spiked: torch.Tensor, at: torch.Tensor, *,
               kernel: bool = True) -> torch.Tensor:
    """``[n_pops]`` int32 spike counts of the segments ``[at[p],
    at[p + 1])`` of ``spiked``; one launch, no host sync.  ``kernel=False``
    (a session under the ``reference`` policy) takes the plain version on
    any device."""
    if spiked.device.type == "cpu" or not kernel:
        return pop_counts_plain(spiked, at)
    _check(spiked, at)
    n_pops = at.shape[0] - 1
    out = torch.empty(n_pops, dtype=torch.int32, device=spiked.device)
    lib = _lib()
    code = lib.pop_counts_launch(_build.ptr(spiked), _build.ptr(at),
                                 _build.ptr(out), _I(n_pops),
                                 _build.stream_of(spiked))
    _build.launches["pop_counts"] += 1
    _build.check(lib, code, "pop_counts")
    return out
