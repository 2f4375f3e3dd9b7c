"""K3 and K4: the fused one-kernel step (``csrc/lif_deliver.cu``), static
and plastic, and their plain versions.

K3 replaces ``repro/kernels/lif_deliver.py:lif_deliver_pallas`` (static
synapses).  One call delivers the previous step's spikes at ring phase
``t_prev`` and integrates step ``t_prev + 1`` against slot
``(t_prev + 1) % D``, which it then zeroes.  The plain version is exactly
``deliver_phase(t_prev)`` followed by ``update_phase(t_prev + 1)``, so the
rotated fused loop is bitwise the split loop on the CPU.

K4 replaces ``lif_deliver_plastic_pallas``: K3 on the live plastic table,
plus the pair-STDP depression of the delivered rows' plastic entries,
written back into the table in place, and the traces' decay and bump with
the delivered spikes, into new tensors.  It returns the delivered ids for
the potentiation and clip that follow (``kernels/stdp.py``).  Its plain
version is K3's followed by ``stdp.depress_plain`` and the trace update.
With ``trace=False`` (the rotated loop's first step, which delivers no
spikes) the traces pass through: the reference's fused loop decays them one
extra step there.

On the card each step is one cooperative launch with grid-wide barriers
between compaction, scatter and LIF update (see the source).  The grid is
the card's co-resident block count, asked once per device, network size
and kernel at the first call; a card without cooperative launch makes the
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
from repro_torch.kernels.stdp import StdpCoef, depress_plain, traces_plain

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


def lif_deliver_plastic_plain(ring, targets, weights, dbins, pmask,
                              spiked_prev, V, I_ex, I_in, refrac, ext_ex,
                              i_dc, x_pre, x_post, t_prev: int, *,
                              n_exc: int, budget: int, prop: Propagators,
                              coef: StdpCoef, trace: bool = True):
    """Returns ``(ring, weights, V', I_ex', I_in', refrac', spiked,
    x_pre', x_post', ids, overflow)``; ``ring`` and ``weights`` (the live
    table, ``pmask`` its plastic entries) are updated in place."""
    (ring, V, I_ex, I_in, refrac, spiked, ids,
     overflow) = lif_deliver_plain(
        ring, targets, weights, dbins, spiked_prev, V, I_ex, I_in, refrac,
        ext_ex, i_dc, t_prev, n_exc=n_exc, budget=budget, prop=prop)
    depress_plain(weights, targets, pmask, x_post, ids, coef.dep)
    if trace:
        x_pre, x_post = traces_plain(x_pre, x_post, spiked_prev,
                                     coef.decay_p, coef.decay_m)
    return (ring, weights, V, I_ex, I_in, refrac, spiked, x_pre, x_post, ids,
            overflow)


_STEP_ARGTYPES = [_P] * 4 + [_I] + [_P] * 15 + [_I] * 5 + [_F] * 9 + [_I, _I]


def _lib():
    lib = _build.library("lif_deliver")
    if not getattr(lib, "_typed", False):
        lib.lif_deliver_grid.restype = ctypes.c_int
        lib.lif_deliver_grid.argtypes = [_I, _I, _P]
        lib.lif_deliver_launch.restype = ctypes.c_int
        lib.lif_deliver_launch.argtypes = _STEP_ARGTYPES + [_P]
        lib.lif_deliver_plastic_launch.restype = ctypes.c_int
        lib.lif_deliver_plastic_launch.argtypes = (
            _STEP_ARGTYPES + [_P] * 5 + [_F] * 3 + [_I, _P])
        lib._typed = True
    return lib


def cooperative_grid(device: torch.device, n_cols: int,
                     plastic: bool = False) -> int:
    """Blocks of the cooperative launch of K3 (or K4 with ``plastic``) on
    ``device`` for ``n_cols``."""
    key = (device.index, n_cols, plastic)
    if key not in _grid:
        lib = _lib()
        out = ctypes.c_int(0)
        with torch.cuda.device(device):
            code = lib.lif_deliver_grid(_I(n_cols), _I(int(plastic)),
                                        ctypes.byref(out))
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


def _step_args(what, ring, targets, weights, dbins, spiked_prev, V, I_ex,
               I_in, refrac, ext_ex, i_dc, t_prev, n_exc, budget, prop,
               plastic):
    """Checks K3's or K4's inputs, allocates the outputs and returns them
    with the C arguments they share."""
    _check_inputs(what, ring, targets, weights, dbins, spiked_prev)
    _build.require_cuda(what, ring, V, I_ex, I_in, refrac, ext_ex, i_dc)
    if budget < 1:
        raise ValueError("the fused step needs spike_budget >= 1")
    n = V.shape[0]
    dev = ring.device
    grid = cooperative_grid(dev, n + 1, plastic)
    Vo, Iexo, Iino = (torch.empty_like(V) for _ in range(3))
    refo = torch.empty_like(refrac)
    spk = torch.empty(n, dtype=torch.bool, device=dev)
    counts = torch.empty(grid, dtype=torch.int32, device=dev)
    ids = torch.empty(budget, dtype=torch.int32, device=dev)
    overflow = torch.empty((), dtype=torch.int32, device=dev)
    c_args = (
        *(_build.ptr(t) for t in (spiked_prev, targets, weights, dbins)),
        _I(targets.shape[1]),
        *(_build.ptr(t) for t in (ring, V, I_ex, I_in, refrac, ext_ex, i_dc,
                                  Vo, Iexo, Iino, refo, spk, counts, ids,
                                  overflow)),
        _I(n), _I(n_exc), _I(ring.shape[0]), _I(budget), _I(int(t_prev)),
        *prop_args(prop), _I(grid))
    return (Vo, Iexo, Iino, refo, spk, ids, overflow), c_args


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
    (Vo, Iexo, Iino, refo, spk, ids, overflow), c_args = _step_args(
        "lif_deliver", *args, n_exc, budget, prop, False)
    lib = _lib()
    code = lib.lif_deliver_launch(*c_args, _build.stream_of(ring))
    _build.launches["lif_deliver"] += 1
    _build.check(lib, code, "lif_deliver (cooperative launch)")
    return ring, Vo, Iexo, Iino, refo, spk, ids, overflow


def lif_deliver_plastic(ring, targets, weights, dbins, pmask, spiked_prev,
                        V, I_ex, I_in, refrac, ext_ex, i_dc, x_pre, x_post,
                        t_prev: int, *, n_exc: int, budget: int,
                        prop: Propagators, coef: StdpCoef,
                        trace: bool = True):
    """Returns ``(ring, weights, V', I_ex', I_in', refrac', spiked,
    x_pre', x_post', ids, overflow)``; see
    :func:`lif_deliver_plastic_plain`."""
    args = (ring, targets, weights, dbins, spiked_prev, V, I_ex, I_in,
            refrac, ext_ex, i_dc)
    if ring.device.type == "cpu":
        return lif_deliver_plastic_plain(
            ring, targets, weights, dbins, pmask, *args[4:], x_pre, x_post,
            t_prev, n_exc=n_exc, budget=budget, prop=prop, coef=coef,
            trace=trace)
    _build.require_cuda("lif_deliver_plastic", pmask, x_pre, x_post)
    if pmask.dtype != torch.bool or pmask.shape != targets.shape:
        raise TypeError("lif_deliver_plastic: pmask must be bool, shaped "
                        "as the tables")
    if x_pre.dtype != torch.float32 or x_post.dtype != torch.float32:
        raise TypeError("lif_deliver_plastic: traces must be float32")
    (Vo, Iexo, Iino, refo, spk, ids, overflow), c_args = _step_args(
        "lif_deliver_plastic", *args, t_prev, n_exc, budget, prop, True)
    x_pre_o, x_post_o = ((torch.empty_like(x_pre), torch.empty_like(x_post))
                         if trace else (x_pre, x_post))
    lib = _lib()
    code = lib.lif_deliver_plastic_launch(
        *c_args, *(_build.ptr(t) for t in (pmask, x_pre, x_post, x_pre_o,
                                           x_post_o)),
        _F(coef.dep), _F(coef.decay_p), _F(coef.decay_m), _I(int(trace)),
        _build.stream_of(ring))
    _build.launches["lif_deliver_plastic"] += 1
    _build.check(lib, code, "lif_deliver_plastic (cooperative launch)")
    return (ring, weights, Vo, Iexo, Iino, refo, spk, x_pre_o, x_post_o, ids,
            overflow)
