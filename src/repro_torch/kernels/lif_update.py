"""K1: the LIF update kernel (``csrc/lif_update.cu``) and its plain version.

Replaces ``repro/kernels/lif_update.py:lif_update_pallas``.  The wrapper
runs the plain PyTorch version for CPU tensors (the tests) and launches the
CUDA kernel for CUDA tensors, or raises; it never falls back.  On ``meta``
tensors (a step laid out by ``launch.dryrun``) it gives its outputs'
shapes and reports the bytes and operations a launch would take to
``perf.step_analysis``; nothing runs.  With
rounding pinned on both sides (no FMA contraction) the kernel equals the
plain version bit for bit.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.neuron import NeuronState, Propagators, lif_step
from repro_torch.kernels import _build
from repro_torch.perf.step_analysis import note_kernel

_F, _I, _P = ctypes.c_float, ctypes.c_int, ctypes.c_void_p

#: float operations of one neuron's update (its bound's count)
LIF_OPS = 13


def lif_update_plain(V, I_ex, I_in, refrac, in_ex, in_in, i_dc, *,
                     prop: Propagators):
    """Returns (V', I_ex', I_in', refrac', spiked); all inputs are [N]."""
    st, spiked = lif_step(NeuronState(V, I_ex, I_in, refrac), prop,
                          in_ex, in_in, i_dc)
    return (*st, spiked)


def prop_args(prop: Propagators) -> tuple:
    """Propagators as C arguments, in the kernels' LifProp order."""
    return (_F(prop.P11_ex), _F(prop.P11_in), _F(prop.P22), _F(prop.P21_ex),
            _F(prop.P21_in), _F(prop.P20), _F(prop.V_th), _F(prop.V_reset),
            _F(prop.E_L), _I(prop.ref_steps))


def _lib():
    lib = _build.library("lif_update")
    if not getattr(lib, "_typed", False):
        lib.lif_update_launch.restype = ctypes.c_int
        lib.lif_update_launch.argtypes = ([_P] * 12 + [_I] + [_F] * 9
                                          + [_I, _P])
        lib._typed = True
    return lib


def lif_update(V, I_ex, I_in, refrac, in_ex, in_in, i_dc, *,
               prop: Propagators):
    """Returns (V', I_ex', I_in', refrac', spiked); all inputs are [N]."""
    args = (V, I_ex, I_in, refrac, in_ex, in_in, i_dc)
    if V.device.type == "cpu":
        return lif_update_plain(*args, prop=prop)
    if V.device.type == "meta":
        n = V.shape[0]
        note_kernel("lif_update", nbytes=(7 * 4 + 4 * 4 + 1) * n,
                    flops=LIF_OPS * n)
        return (*(torch.empty_like(t) for t in (V, I_ex, I_in, refrac)),
                torch.empty(n, dtype=torch.bool, device="meta"))
    _build.require_cuda("lif_update", *args)
    for t in (V, I_ex, I_in, in_ex, in_in, i_dc):
        if t.dtype != torch.float32:
            raise TypeError(f"lif_update takes float32 state, got {t.dtype}")
    if refrac.dtype != torch.int32:
        raise TypeError(f"lif_update takes int32 refrac, got {refrac.dtype}")
    n = V.shape[0]
    Vo, Iexo, Iino = (torch.empty_like(V) for _ in range(3))
    refo = torch.empty_like(refrac)
    spk = torch.empty(n, dtype=torch.bool, device=V.device)
    lib = _lib()
    code = lib.lif_update_launch(
        *(_build.ptr(t) for t in (*args, Vo, Iexo, Iino, refo, spk)),
        _I(n), *prop_args(prop), _build.stream_of(V))
    _build.launches["lif_update"] += 1
    _build.check(lib, code, "lif_update")
    return Vo, Iexo, Iino, refo, spk
