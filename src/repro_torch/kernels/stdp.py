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

On the card each call is one launch of one block per SM, in which every
touched entry has one owner (the IN pass takes an OUT entry whose target is
among the ids, the OUT pass the rest; ``among_ids``), so a step needs no
grid barrier; only the whole-table clip waits for one, and only that form
is launched cooperatively.  The C argument pack of the tables, sizes,
coefficients and grid (``StdpConst``) is built once per session and cached
by its inputs.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import _build

_I, _F, _P = ctypes.c_int, ctypes.c_float, ctypes.c_void_p

_grid: dict = {}
#: what lies between a block's consecutive stamps (``stamps_buffer``)
PHASES = ("load_ids", "update", "whole_table_clip")


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


def among_ids(x: torch.Tensor, ids: torch.Tensor, n: int) -> torch.Tensor:
    """Whether each neuron of ``x`` is one of the step's ``ids`` (ascending,
    then the sentinel ``n``): the kernel's binary search.  A neuron that
    spiked but was cut by the budget is not among them."""
    if not ids.numel():                   # a spike budget of 0
        return torch.zeros_like(x, dtype=torch.bool)
    at = torch.searchsorted(ids, x.to(ids.dtype)).clamp(max=ids.shape[0] - 1)
    return (ids[at] == x) & (x < n)


def depress_plain(weights, targets, pmask, x_post, ids, dep: float) -> None:
    """Depress the plastic entries of the OUT rows ``ids``, in place."""
    e = _row_entries(weights.shape[1], ids)
    wf = weights.view(-1)
    w = wf[e]
    # padding (target N) is never plastic; the clamp keeps its gather legal
    tg = targets.view(-1)[e].clamp(max=x_post.shape[0] - 1).to(torch.int64)
    wf[e] = torch.where(pmask.view(-1)[e], w + -(dep * x_post[tg]), w)


def clip_plain(weights, pmask, w_max: float) -> None:
    """Clip every plastic entry to ``[0, w_max]``, in place."""
    weights.copy_(torch.where(pmask, weights.clamp(0.0, w_max), weights))


def traces_plain(x_pre, x_post, spiked, decay_p: float, decay_m: float):
    """The traces' decay and bump, ``x * decay + spike``, as new tensors."""
    spk = spiked.to(torch.float32)
    return x_pre * decay_p + spk, x_post * decay_m + spk


def stdp_update_plain(weights, targets, pmask, in_syn, pmask_in, ids, x_pre,
                      x_post, spiked, coef: StdpCoef, *, full: bool,
                      clip_all: bool):
    """Returns ``(weights, x_pre', x_post')``; ``weights`` is updated in
    place.  ``x_post`` and ``spiked`` are read only with ``full`` (they may
    be None without it), and without it the traces come back as given.

    Each touched entry gets its final value from the weights before the
    call, from its one owner, as the kernel computes it: the OUT pass owns
    the plastic entries of the ids' OUT rows whose target is not among the
    ids (depressed with ``full``, then clipped); the IN pass owns the
    plastic entries of the ids' IN rows (depressed with ``full`` when their
    source is among the ids, potentiated, clipped).  That is ``stdp_step``'s
    depression, potentiation and clip of the touched entries, in its order.
    """
    n, k = x_pre.shape[0], weights.shape[1]
    wf = weights.view(-1)
    rows = ids.to(torch.int64)
    last = lambda i: i.clamp(max=n - 1)    # keeps padding's gathers legal
    e_out = _row_entries(k, ids)
    tg = targets.view(-1)[e_out].to(torch.int64)
    own_out = pmask.view(-1)[e_out] & ~among_ids(tg, ids, n)
    w_out = wf[e_out]
    v_out = w_out + -(coef.dep * x_post[last(tg)]) if full else w_out
    syn = in_syn[rows].to(torch.int64)
    src = torch.div(syn, k, rounding_mode="floor")
    w_in = wf[syn]
    v_in = w_in
    if full:
        v_in = torch.where(among_ids(src, ids, n),
                           v_in + -(coef.dep * x_post[last(rows)][:, None]),
                           v_in)
    v_in = v_in + coef.pot * x_pre[last(src)]
    # an entry owned by neither pass is written back as it was
    wf[e_out] = torch.where(own_out, v_out.clamp(0.0, coef.w_max), w_out)
    wf[syn] = torch.where(pmask_in[rows], v_in.clamp(0.0, coef.w_max), w_in)
    if clip_all:
        clip_plain(weights, pmask, coef.w_max)
    if full:
        x_pre, x_post = traces_plain(x_pre, x_post, spiked, coef.decay_p,
                                     coef.decay_m)
    return weights, x_pre, x_post


class StdpConst(ctypes.Structure):
    """``StdpConst`` of ``csrc/stdp_update.cu``: what stays the same from
    step to step of a session, handed to the launch by pointer."""
    _fields_ = [("targets", _P), ("pmask", _P), ("w", _P), ("in_syn", _P),
                ("pmask_in", _P), ("n", _I), ("k", _I), ("k_in", _I),
                ("budget", _I), ("grid", _I), ("dep", _F), ("pot", _F),
                ("decay_p", _F), ("decay_m", _F), ("w_max", _F)]


def stdp_const(ptrs: tuple, sizes: tuple, coef: StdpCoef) -> StdpConst:
    """The pack of ``ptrs`` (targets, pmask, weights, in_syn, pmask_in:
    device addresses), ``sizes`` (n, k, k_in, budget, grid) and the STDP
    coefficients."""
    return StdpConst(*ptrs, *sizes, *coef)


#: ``stdp_const`` cached by its inputs, all plain values, so that a hit is
#: the pack those inputs build; the wrapper never writes into a pack
_cached_stdp_const = functools.lru_cache(maxsize=32)(stdp_const)


def session_pack(weights, targets, pmask, in_syn, pmask_in, *, n: int,
                 budget: int, grid: int, coef: StdpCoef) -> StdpConst:
    """The cached pack of a session's tables, sizes and coefficients, as a
    launch takes it."""
    return _cached_stdp_const(
        tuple(t.data_ptr() for t in (targets, pmask, weights, in_syn,
                                     pmask_in)),
        (n, weights.shape[1], in_syn.shape[1], budget, grid), coef)


def _lib():
    lib = _build.library("stdp_update")
    if not getattr(lib, "_typed", False):
        for fn in ("stdp_update_grid", "stdp_update_const_bytes",
                   "stdp_update_stamps", "stdp_update_launch",
                   "stdp_update_stamped_launch"):
            getattr(lib, fn).restype = ctypes.c_int
        lib.stdp_update_grid.argtypes = [_P]
        lib.stdp_update_const_bytes.argtypes = []
        lib.stdp_update_stamps.argtypes = []
        io = [_P] * 7 + [_I, _I]            # pack, tensors, full, clip_all
        lib.stdp_update_launch.argtypes = io + [_P]
        lib.stdp_update_stamped_launch.argtypes = io + [_P, _P]
        if lib.stdp_update_const_bytes() != ctypes.sizeof(StdpConst):
            raise RuntimeError(
                f"stdp_update: the C StdpConst has "
                f"{lib.stdp_update_const_bytes()} bytes, its ctypes mirror "
                f"{ctypes.sizeof(StdpConst)}")
        lib._typed = True
    return lib


def launch_grid(device: torch.device) -> int:
    """Blocks of the kernel's launch on ``device``: one per SM."""
    key = _build.device_index(device)
    if key not in _grid:
        lib = _lib()
        out = ctypes.c_int(0)
        with torch.cuda.device(device):
            code = lib.stdp_update_grid(ctypes.byref(out))
        if code == -1:
            raise RuntimeError(
                f"{torch.cuda.get_device_name(device)} has no cooperative "
                f"launch: the stdp_update kernel's whole-table clip cannot "
                f"run")
        if code == -2:
            raise RuntimeError("stdp_update: no block of the kernel fits "
                               "on an SM")
        _build.check(lib, code, "stdp_update_grid")
        _grid[key] = out.value
    return _grid[key]


def stamps_buffer(device: torch.device) -> torch.Tensor:
    """A ``[grid, len(PHASES) + 1]`` int64 buffer for one stamped launch:
    passed as ``stamps=`` to :func:`stdp_update`, it selects the kernel's
    stamped instantiation, where each block writes its ``%globaltimer``
    (ns) at its start and at the end of each of ``PHASES``."""
    return torch.zeros(launch_grid(device), _lib().stdp_update_stamps(),
                       dtype=torch.int64, device=device)


def _check(weights, targets, pmask, in_syn, pmask_in, ids, x_pre, x_post,
           spiked, full: bool, stamps) -> None:
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
    if (n + 1) * max(k, k_in) >= 2 ** 31 \
            or ids.shape[0] * (k + k_in) >= 2 ** 30:
        raise ValueError("stdp_update: the tables or the ids' entries "
                         "exceed the kernel's 32-bit indexing")
    if stamps is not None:
        want = (launch_grid(weights.device), _lib().stdp_update_stamps())
        if stamps.dtype != torch.int64 or tuple(stamps.shape) != want \
                or stamps.device != weights.device \
                or not stamps.is_contiguous():
            raise ValueError(f"stdp_update: stamps must be a stamps_buffer "
                             f"(int64 {list(want)} on {weights.device})")


def stdp_update(weights, targets, pmask, in_syn, pmask_in, ids, x_pre,
                x_post, spiked, coef: StdpCoef, *, full: bool,
                clip_all: bool, stamps=None):
    """Returns ``(weights, x_pre', x_post')``; see
    :func:`stdp_update_plain`.  ``stamps`` (a ``stamps_buffer``, on the
    card only) selects the stamped kernel, for a phase table."""
    args = (weights, targets, pmask, in_syn, pmask_in, ids, x_pre, x_post,
            spiked)
    if weights.device.type == "cpu":
        if stamps is not None:
            raise ValueError("stdp_update: stamps are the kernel's, on the "
                             "card")
        return stdp_update_plain(*args, coef, full=full, clip_all=clip_all)
    _check(*args, full, stamps)
    n = x_pre.shape[0]
    pack = session_pack(weights, targets, pmask, in_syn, pmask_in, n=n,
                        budget=ids.shape[0],
                        grid=launch_grid(weights.device), coef=coef)
    x_pre_o, x_post_o = ((torch.empty_like(x_pre), torch.empty_like(x_post))
                         if full else (x_pre, x_post))
    ptr = lambda t: t.data_ptr() if full else None
    c_args = (ctypes.addressof(pack), ids.data_ptr(), x_pre.data_ptr(),
              ptr(x_post), ptr(spiked), ptr(x_pre_o), ptr(x_post_o),
              int(full), int(clip_all))
    lib = _lib()
    stream = _build.stream_of(weights)
    if stamps is None:
        code = lib.stdp_update_launch(*c_args, stream)
    else:
        code = lib.stdp_update_stamped_launch(*c_args, stamps.data_ptr(),
                                              stream)
    _build.launches["stdp_update"] += 1
    _build.check(lib, code, "stdp_update")
    return weights, x_pre_o, x_post_o
