"""The pair-STDP weight update (``csrc/stdp_update.cu``) and its plain
version.

The JAX package leaves this update to XLA: ``repro/core/plasticity.py``
``stdp_step`` (:143) on the split path, ``stdp_pot_clip`` (:206) after its
fused kernel; there is no Pallas counterpart.  One call works on the rows
of the step's compacted ids only (ascending, then the sentinel N):

* ``full=True`` is the whole ``stdp_step``: depression on the ids' OUT
  rows, ``w + (-(dep * x_post[target]))``; then potentiation through their
  IN rows, ``w + pot * x_pre[source]``; then the clip; and the traces'
  decay and bump into new tensors.
* ``full=False`` is ``stdp_pot_clip``: K4 has done the depression and the
  traces, so only the potentiation and the clip are left.

Both read the traces from before the step's bump.  The clip to
``[0, w_max]`` covers the plastic entries the call touched (the ids' OUT
and IN rows), or with ``clip_all`` every plastic entry: one whole-table
clip per run, then touched entries only, equals the reference's clip of the
whole table every step (clipping is idempotent, untouched weights do not
change).  Only plastic entries are ever written.

The weights are the delivery strategy's ``[N+1, K]`` table, updated in
place; ``in_syn`` indexes it as ``row * K + col`` (the fill ``N * K`` is a
weight-0 entry of the sentinel row), so a synapse's source is
``in_syn // K``.  The kernel equals the plain version bit for bit (see the
source).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import _build

_I, _F, _P = ctypes.c_int, ctypes.c_float, ctypes.c_void_p

_grid: dict = {}


class StdpCoef(NamedTuple):
    """The immediates of one pair-STDP step, as Python floats (rounded to
    float32 where they meet a float32 tensor, as the reference's are)."""
    dep: float          # lr * A_minus * w_ref
    pot: float          # lr * A_plus * w_ref
    decay_p: float      # exp(-dt / tau_plus)
    decay_m: float      # exp(-dt / tau_minus)
    w_max: float        # w_max_factor * w_ref


def _row_entries(k: int, ids: torch.Tensor) -> torch.Tensor:
    """Flat indices ``[S, k]`` of rows ``ids`` of a ``[N+1, k]`` table."""
    return (ids.to(torch.int64)[:, None] * k
            + torch.arange(k, device=ids.device))


def depress_plain(weights, targets, pmask, x_post, ids, dep: float) -> None:
    """Depress the plastic entries of the OUT rows ``ids``, in place."""
    e = _row_entries(weights.shape[1], ids)
    wf = weights.view(-1)
    w = wf[e]
    # padding (target N) is never plastic; the clamp keeps its gather legal
    tg = targets.view(-1)[e].clamp(max=x_post.shape[0] - 1).to(torch.int64)
    wf[e] = torch.where(pmask.view(-1)[e], w + -(dep * x_post[tg]), w)


def potentiate_plain(weights, in_syn, pmask_in, x_pre, ids,
                     pot: float) -> None:
    """Potentiate the plastic entries of the IN rows ``ids``, in place."""
    rows = ids.to(torch.int64)
    syn = in_syn[rows].to(torch.int64)
    src = torch.div(syn, weights.shape[1], rounding_mode="floor")
    src = src.clamp(max=x_pre.shape[0] - 1)
    wf = weights.view(-1)
    w = wf[syn]
    wf[syn] = torch.where(pmask_in[rows], w + pot * x_pre[src], w)


def clip_plain(weights, pmask, in_syn, pmask_in, ids, w_max: float,
               clip_all: bool) -> None:
    """Clip plastic entries to ``[0, w_max]`` in place: those of the OUT
    and IN rows ``ids``, or with ``clip_all`` every one."""
    if clip_all:
        weights.copy_(torch.where(pmask, weights.clamp(0.0, w_max),
                                  weights))
        return
    wf = weights.view(-1)
    rows = ids.to(torch.int64)
    for e, m in ((_row_entries(weights.shape[1], ids), pmask[rows]),
                 (in_syn[rows].to(torch.int64), pmask_in[rows])):
        w = wf[e]
        wf[e] = torch.where(m, w.clamp(0.0, w_max), w)


def traces_plain(x_pre, x_post, spiked, decay_p: float, decay_m: float):
    """The traces' decay and bump, ``x * decay + spike``, as new tensors."""
    spk = spiked.to(torch.float32)
    return x_pre * decay_p + spk, x_post * decay_m + spk


def stdp_update_plain(weights, targets, pmask, in_syn, pmask_in, ids, x_pre,
                      x_post, spiked, coef: StdpCoef, *, full: bool,
                      clip_all: bool):
    """Returns ``(weights, x_pre', x_post')``; ``weights`` is updated in
    place.  ``x_post`` and ``spiked`` are read only with ``full`` (they may
    be None without it), and without it the traces come back as given."""
    if full:
        depress_plain(weights, targets, pmask, x_post, ids, coef.dep)
    potentiate_plain(weights, in_syn, pmask_in, x_pre, ids, coef.pot)
    clip_plain(weights, pmask, in_syn, pmask_in, ids, coef.w_max, clip_all)
    if full:
        x_pre, x_post = traces_plain(x_pre, x_post, spiked, coef.decay_p,
                                     coef.decay_m)
    return weights, x_pre, x_post


def _lib():
    lib = _build.library("stdp_update")
    if not getattr(lib, "_typed", False):
        lib.stdp_update_grid.restype = ctypes.c_int
        lib.stdp_update_grid.argtypes = [_P]
        lib.stdp_update_launch.restype = ctypes.c_int
        lib.stdp_update_launch.argtypes = (
            [_P, _I, _P, _P, _P, _I, _P, _P, _I] + [_P] * 5 + [_I] * 3
            + [_F] * 5 + [_I, _P])
        lib._typed = True
    return lib


def cooperative_grid(device: torch.device) -> int:
    """Blocks of the cooperative launch on ``device``."""
    if device.index not in _grid:
        lib = _lib()
        out = ctypes.c_int(0)
        with torch.cuda.device(device):
            code = lib.stdp_update_grid(ctypes.byref(out))
        if code == -1:
            raise RuntimeError(
                f"{torch.cuda.get_device_name(device)} has no cooperative "
                f"launch: the stdp_update kernel cannot run")
        _build.check(lib, code, "stdp_update_grid")
        if out.value < 1:
            raise RuntimeError("stdp_update: no block fits on an SM")
        _grid[device.index] = out.value
    return _grid[device.index]


def stdp_update(weights, targets, pmask, in_syn, pmask_in, ids, x_pre,
                x_post, spiked, coef: StdpCoef, *, full: bool,
                clip_all: bool):
    """Returns ``(weights, x_pre', x_post')``; see
    :func:`stdp_update_plain`."""
    args = (weights, targets, pmask, in_syn, pmask_in, ids, x_pre, x_post,
            spiked)
    if weights.device.type == "cpu":
        return stdp_update_plain(*args, coef, full=full, clip_all=clip_all)
    _build.require_cuda("stdp_update", weights, targets, pmask, in_syn,
                        pmask_in, ids, x_pre,
                        *((x_post, spiked) if full else ()))
    n = x_pre.shape[0]
    k, k_in = weights.shape[1], in_syn.shape[1]
    if weights.dtype != torch.float32 or x_pre.dtype != torch.float32 \
            or (full and x_post.dtype != torch.float32):
        raise TypeError("stdp_update: weights and traces must be float32")
    if targets.dtype != torch.int32 or in_syn.dtype != torch.int32 \
            or ids.dtype != torch.int32:
        raise TypeError("stdp_update: targets, in_syn and ids must be int32")
    if pmask.dtype != torch.bool or pmask_in.dtype != torch.bool \
            or (full and spiked.dtype != torch.bool):
        raise TypeError("stdp_update: masks and spikes must be bool")
    if weights.shape != (n + 1, k) or targets.shape != weights.shape \
            or pmask.shape != weights.shape \
            or in_syn.shape != pmask_in.shape or in_syn.shape[0] != n + 1:
        raise ValueError("stdp_update: tables must be [N+1, K] and "
                         "[N+1, K_in] with N = len(x_pre)")
    if (n + 1) * k >= 2 ** 31:
        raise ValueError("stdp_update: the table exceeds int32 indexing")
    x_pre_o, x_post_o = ((torch.empty_like(x_pre), torch.empty_like(x_post))
                         if full else (x_pre, x_post))
    maybe = lambda t: _build.ptr(t) if full else _P(None)
    dev = weights.device
    grid = cooperative_grid(dev)
    lib = _lib()
    code = lib.stdp_update_launch(
        _build.ptr(ids), _I(ids.shape[0]), _build.ptr(targets),
        _build.ptr(pmask), _build.ptr(weights), _I(k), _build.ptr(in_syn),
        _build.ptr(pmask_in), _I(k_in), _build.ptr(x_pre), maybe(x_post),
        maybe(spiked), maybe(x_pre_o), maybe(x_post_o), _I(n), _I(int(full)),
        _I(int(clip_all)), *(_F(v) for v in coef), _I(grid),
        _build.stream_of(weights))
    _build.launches["stdp_update"] += 1
    _build.check(lib, code, "stdp_update (cooperative launch)")
    return weights, x_pre_o, x_post_o
