"""K3: the fused one-kernel step (``csrc/lif_deliver.cu``) and its plain
version.

Replaces ``repro/kernels/lif_deliver.py:lif_deliver_pallas`` (static
synapses).  One call delivers the previous step's spikes at ring phase
``t_prev`` and integrates step ``t_prev + 1`` against slot
``(t_prev + 1) % D``, which it then zeroes.  The plain version is exactly
``deliver_phase(t_prev)`` followed by ``update_phase(t_prev + 1)``, so the
rotated fused loop is bitwise the split loop on the CPU.

On the card the step is one cooperative launch with grid-wide barriers
between compaction, scatter and LIF update (see the source).  The grid is
the card's co-resident block count, asked once per device and network
size at the first call; a card without cooperative launch makes the
wrapper raise -- it never falls back to K2 + K1.  The ring is updated in
place.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.neuron import Propagators
from repro_torch.kernels import _build
from repro_torch.kernels.ell_deliver import (_check_inputs,
                                             ell_deliver_plain)
from repro_torch.kernels.lif_update import lif_update_plain, prop_args

_I, _F, _P = ctypes.c_int, ctypes.c_float, ctypes.c_void_p

_grid: dict = {}


def lif_deliver_plain(ring, targets, weights, dbins, spiked_prev, V, I_ex,
                      I_in, refrac, ext_ex, i_dc, t_prev: int, *,
                      n_exc: int, budget: int, prop: Propagators):
    """Returns ``(ring, V', I_ex', I_in', refrac', spiked, ids, overflow)``.

    ``ring`` [D, 2, N+1] is updated in place; ``overflow`` is the budget
    excess of ``spiked_prev`` (the delivered step).
    """
    n = V.shape[0]
    ring, ids, overflow = ell_deliver_plain(
        ring, targets, weights, dbins, spiked_prev, t_prev, n_exc, budget)
    slot = (t_prev + 1) % ring.shape[0]
    arrivals = ring[slot]
    in_ex = arrivals[0, :n] + ext_ex
    V, I_ex, I_in, refrac, spiked = lif_update_plain(
        V, I_ex, I_in, refrac, in_ex, arrivals[1, :n], i_dc, prop=prop)
    arrivals.zero_()
    return ring, V, I_ex, I_in, refrac, spiked, ids, overflow


def _lib():
    lib = _build.library("lif_deliver")
    if not getattr(lib, "_typed", False):
        lib.lif_deliver_grid.restype = ctypes.c_int
        lib.lif_deliver_grid.argtypes = [_I, _P]
        lib.lif_deliver_launch.restype = ctypes.c_int
        lib.lif_deliver_launch.argtypes = (
            [_P] * 4 + [_I] + [_P] * 15 + [_I] * 5 + [_F] * 9 + [_I, _I, _P])
        lib._typed = True
    return lib


def cooperative_grid(device: torch.device, n_cols: int) -> int:
    """Blocks of the cooperative launch on ``device`` for ``n_cols``."""
    key = (device.index, n_cols)
    if key not in _grid:
        lib = _lib()
        out = ctypes.c_int(0)
        with torch.cuda.device(device):
            code = lib.lif_deliver_grid(_I(n_cols), ctypes.byref(out))
        if code == -1:
            raise RuntimeError(
                f"{torch.cuda.get_device_name(device)} has no cooperative "
                f"launch (cudaDevAttrCooperativeLaunch == 0): the fused "
                f"lif_deliver step cannot run; use kernels='split'")
        _build.check(lib, code, "lif_deliver_grid")
        if out.value < 1:
            raise RuntimeError("lif_deliver: no block of the kernel fits "
                               "on an SM")
        _grid[key] = out.value
    return _grid[key]


def lif_deliver(ring, targets, weights, dbins, spiked_prev, V, I_ex, I_in,
                refrac, ext_ex, i_dc, t_prev: int, *, n_exc: int,
                budget: int, prop: Propagators):
    """Returns ``(ring, V', I_ex', I_in', refrac', spiked, ids, overflow)``;
    see :func:`lif_deliver_plain`."""
    args = (ring, targets, weights, dbins, spiked_prev, V, I_ex, I_in,
            refrac, ext_ex, i_dc, t_prev)
    if ring.device.type == "cpu":
        return lif_deliver_plain(*args, n_exc=n_exc, budget=budget,
                                 prop=prop)
    _check_inputs("lif_deliver", ring, targets, weights, dbins, spiked_prev)
    _build.require_cuda("lif_deliver", ring, V, I_ex, I_in, refrac, ext_ex,
                        i_dc)
    if budget < 1:
        raise ValueError("the fused step needs spike_budget >= 1")
    n = V.shape[0]
    dev = ring.device
    grid = cooperative_grid(dev, n + 1)
    Vo, Iexo, Iino = (torch.empty_like(V) for _ in range(3))
    refo = torch.empty_like(refrac)
    spk = torch.empty(n, dtype=torch.bool, device=dev)
    counts = torch.empty(grid, dtype=torch.int32, device=dev)
    ids = torch.empty(budget, dtype=torch.int32, device=dev)
    overflow = torch.empty((), dtype=torch.int32, device=dev)
    lib = _lib()
    code = lib.lif_deliver_launch(
        *(_build.ptr(t) for t in (spiked_prev, targets, weights, dbins)),
        _I(targets.shape[1]),
        *(_build.ptr(t) for t in (ring, V, I_ex, I_in, refrac, ext_ex, i_dc,
                                  Vo, Iexo, Iino, refo, spk, counts, ids,
                                  overflow)),
        _I(n), _I(n_exc), _I(ring.shape[0]), _I(budget), _I(int(t_prev)),
        *prop_args(prop), _I(grid), _build.stream_of(ring))
    _build.launches["lif_deliver"] += 1
    _build.check(lib, code, "lif_deliver (cooperative launch)")
    return ring, Vo, Iexo, Iino, refo, spk, ids, overflow
