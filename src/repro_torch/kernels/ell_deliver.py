"""K2: sparse-ELL spike delivery (``csrc/ell_deliver.cu``) and its plain
version.

Replaces ``repro/kernels/ell_deliver.py:ell_deliver_pallas`` together with
the id compaction of ``repro/kernels/ops.py:ell_deliver``.  The step's
spiking ids are compacted in order (the lowest ``budget`` ids ascending,
then the sentinel row N), their ELL rows gathered, and every (target,
weight, delay-bin) triple added into ``ring[(t + dbin) % D, ch, target]``
with ``ch = sid >= n_exc`` (Dale's law).

The ring is updated **in place** (the port keeps one 28 MB ring per
session instead of a new one per step).  The plain version adds in the
reference's ``deliver_event`` order (s-major, k-minor) through
``index_add_``; the CUDA kernel adds with float atomics in no fixed order,
so on the card the ring agrees with the plain version to a tolerance,
while ids and overflow are exact.  Neither reads anything back to the host.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_I, _P = ctypes.c_int, ctypes.c_void_p


def compact_ids_plain(spiked: torch.Tensor, budget: int):
    """``nonzero(spiked, size=budget, fill_value=N)`` without a host sync.

    Returns ``(ids [budget] int32, overflow 0-d int32)``: the lowest
    ``budget`` spiking ids in ascending order, then N; the overflow is
    ``max(n_spikes - budget, 0)``.
    """
    n = spiked.shape[0]
    rank = torch.cumsum(spiked.to(torch.int32), 0, dtype=torch.int32) - 1
    keep = spiked & (rank < budget)
    dest = torch.where(keep, rank, budget).to(torch.int64)
    ids = torch.full((budget + 1,), n, dtype=torch.int32,
                     device=spiked.device)
    ids.scatter_(0, dest, torch.arange(n, dtype=torch.int32,
                                       device=spiked.device))
    n_spikes = rank[-1] + 1 if n else torch.zeros(
        (), dtype=torch.int32, device=spiked.device)
    overflow = torch.clamp(n_spikes - budget, min=0).to(torch.int32)
    return ids[:budget], overflow


def scatter_rows_plain(ring, targets, weights, dbins, ids, t, n_exc):
    """Add the ELL rows of ``ids`` into ``ring`` [D, 2, n_cols] in place,
    at phase ``t``, in s-major / k-minor order."""
    D, _, n_cols = ring.shape
    idx = ids.to(torch.int64)
    tg = targets[idx].to(torch.int64)                  # [S, K]
    slot = torch.remainder(t + dbins[idx].to(torch.int64), D)
    ch = (idx >= n_exc).to(torch.int64)
    lin = slot * (2 * n_cols) + ch[:, None] * n_cols + tg
    ring.view(-1).index_add_(0, lin.reshape(-1), weights[idx].reshape(-1))
    return ring


def ell_deliver_plain(ring, targets, weights, dbins, spiked, t: int,
                      n_exc: int, budget: int):
    """Returns ``(ring, ids, overflow)``; ``ring`` updated in place."""
    ids, overflow = compact_ids_plain(spiked, budget)
    scatter_rows_plain(ring, targets, weights, dbins, ids, t, n_exc)
    return ring, ids, overflow


def _lib():
    lib = _build.library("ell_deliver")
    if not getattr(lib, "_typed", False):
        lib.ell_compact_tile.restype = ctypes.c_int
        lib.ell_deliver_launch.restype = ctypes.c_int
        lib.ell_deliver_launch.argtypes = (
            [_P, _I, _P, _P, _I, _P, _P, _P, _P, _I, _P, _I, _I, _I, _P])
        lib._typed = True
    return lib


def ell_deliver(ring, targets, weights, dbins, spiked, t: int, n_exc: int,
                budget: int):
    """Returns ``(ring, ids, overflow)``; ``ring`` [D, 2, N+1] f32 is
    updated in place, tables are ``[N+1, K_pad]`` with sentinel row N."""
    if ring.device.type == "cpu":
        return ell_deliver_plain(ring, targets, weights, dbins, spiked, t,
                                 n_exc, budget)
    _check_inputs("ell_deliver", ring, targets, weights, dbins, spiked)
    n = spiked.shape[0]
    lib = _lib()
    tile = lib.ell_compact_tile()
    counts = torch.empty(max(1, -(-n // tile)), dtype=torch.int32,
                         device=ring.device)
    ids = torch.empty(budget, dtype=torch.int32, device=ring.device)
    overflow = torch.empty((), dtype=torch.int32, device=ring.device)
    D = ring.shape[0]
    code = lib.ell_deliver_launch(
        _build.ptr(spiked), _I(n), _build.ptr(counts), _build.ptr(ids),
        _I(budget), _build.ptr(overflow), _build.ptr(targets),
        _build.ptr(weights), _build.ptr(dbins), _I(targets.shape[1]),
        _build.ptr(ring), _I(int(t)), _I(D), _I(n_exc),
        _build.stream_of(ring))
    _build.launches["ell_deliver"] += 1
    _build.check(lib, code, "ell_deliver")
    return ring, ids, overflow


def _check_inputs(what, ring, targets, weights, dbins, spiked):
    _build.require_cuda(what, ring, targets, weights, dbins, spiked)
    n = spiked.shape[0]
    if ring.dtype != torch.float32 or weights.dtype != torch.float32:
        raise TypeError(f"{what}: ring and weights must be float32")
    if targets.dtype != torch.int32 or dbins.dtype != torch.int32:
        raise TypeError(f"{what}: targets and dbins must be int32")
    if spiked.dtype != torch.bool:
        raise TypeError(f"{what}: spiked must be bool")
    if ring.dim() != 3 or ring.shape[1:] != (2, n + 1):
        raise ValueError(f"{what}: ring must be [D, 2, N+1], got "
                         f"{tuple(ring.shape)} for N={n}")
    if targets.shape[0] != n + 1 or weights.shape != targets.shape \
            or dbins.shape != targets.shape:
        raise ValueError(f"{what}: tables must be [N+1, K] alike")
