"""K3 and K4: the fused one-kernel step (``csrc/lif_deliver.cu``), static
and plastic, and their plain versions; and K2's, the same kernel's
delivery-only form (its entry point is ``kernels/ell_deliver``).

K3 replaces ``repro/kernels/lif_deliver.py:lif_deliver_pallas`` (static
synapses).  One call for step ``t`` delivers the previous step's spikes at
ring phase ``t - 1`` and integrates step ``t`` against slot ``t % D``,
which it then zeroes.  The plain version is exactly ``deliver_phase(t -
1)`` followed by ``update_phase(t)``, so the rotated fused loop is bitwise
the split loop on the CPU.

``t`` is the session's step counter, a 0-d int32 tensor on the ring's
device.  The kernels read it from device memory and never write it: K3
and K4 return ``t + 1`` and the running overflow plus the step's budget
excess as fresh 0-d tensors, which they write themselves, so a launch
captured in a CUDA graph reads the counter of its replay and the step
launches no op for its counters; the plain versions compute the slot by
index arithmetic on the tensor, with no read back to the host.

The external drive comes as the step draws it: ``ext_cnt``, the float32
spike counts the drive returns (None when no stimulus feeds spikes), and
the weight ``w_ext``.  Each neuron's input is ``row_ex + w_ext * ext_cnt``,
the product rounded once in float32 as PyTorch's product of a Python
float and a float32 tensor is, so the plain versions (which form it so)
are the split loop's ``update_phase`` bit for bit.

K4 replaces ``lif_deliver_plastic_pallas``: K3 on the live plastic table,
plus the pair-STDP depression of the delivered rows' plastic entries,
written back into the table in place, and the traces' decay and bump with
the delivered spikes, into new tensors.  It returns the delivered ids for
the potentiation and clip that follow (``kernels/stdp.py``).  Its plain
version is K3's followed by ``stdp.depress_plain`` and the trace update.
With ``trace=False`` (the rotated loop's first step, which delivers no
spikes) the traces pass through: the reference's fused loop decays them one
extra step there.

On the card each step is one cooperative launch of one block per SM:
a single-pass compaction by decoupled look-back, a grid sync, the scatter
split evenly by entries, a grid sync, the LIF update (see the source).  K2
(``kernels/ell_deliver``) is a third form of the same kernel that stops
after the scatter (:func:`deliver`), on the same workspace.  The
grid is asked once per device and network size; a card without
cooperative launch makes the wrapper raise -- it never falls back to K2 +
K1.  The ring is updated in place.  What stays the same from step to step
is built once: the C argument pack of the tables, sizes, propagators and
grid (``StepConst``, cached by its inputs), and the kernel's workspace
(the look-back words and the launch count that tags them, one per device
and grid, zeroed once and advanced by the kernel itself, so that a launch
captured in a CUDA graph replays right).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.core.neuron import Propagators
from repro_torch.kernels import _build
from repro_torch.kernels.lif_update import lif_update_plain
from repro_torch.kernels.stdp import StdpCoef, depress_plain, traces_plain

_I, _F, _P = ctypes.c_int, ctypes.c_float, ctypes.c_void_p

_grid: dict = {}
_workspaces: dict = {}
#: what lies between a block's consecutive stamps (``stamps_buffer``); K2
#: stops after the first five
PHASES = ("count", "look_back", "write_ids", "barrier_1", "scatter",
          "barrier_2", "lif")


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


def step_counter(t, device) -> torch.Tensor:
    """``t`` as the 0-d int32 tensor the plain versions take (a tensor
    already so is returned as it is; a Python int, as tests give it, is
    made one)."""
    return torch.as_tensor(t, dtype=torch.int32, device=device)


def slot_index(t: torch.Tensor, d_bins: int) -> torch.Tensor:
    """``[t % D]`` as an int64 index tensor, on ``t``'s device."""
    return torch.remainder(t, d_bins).view(1).to(torch.int64)


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


def ell_deliver_plain(ring, targets, weights, dbins, spiked, t,
                      n_exc: int, budget: int):
    """Returns ``(ring, ids, overflow)``; ``ring`` updated in place."""
    ids, overflow = compact_ids_plain(spiked, budget)
    scatter_rows_plain(ring, targets, weights, dbins, ids, t, n_exc)
    return ring, ids, overflow


def _check_inputs(what, ring, targets, weights, dbins, spiked, n_tgt):
    _build.require_cuda(what, ring, targets, weights, dbins, spiked)
    n = spiked.shape[0]
    if ring.dtype != torch.float32 or weights.dtype != torch.float32:
        raise TypeError(f"{what}: ring and weights must be float32")
    if targets.dtype != torch.int32 or dbins.dtype != torch.int32:
        raise TypeError(f"{what}: targets and dbins must be int32")
    if spiked.dtype != torch.bool:
        raise TypeError(f"{what}: spiked must be bool")
    check_ring(what, ring, n, n_tgt)
    if targets.shape[0] != n + 1 or weights.shape != targets.shape \
            or dbins.shape != targets.shape:
        raise ValueError(f"{what}: tables must be [N+1, K] alike")


def check_ring(what, ring, n: int, n_tgt: int) -> None:
    """``ring`` must be ``[D, 2, n_tgt + 1]``: a column per target and the
    dump column (``n_tgt == n`` but in K2's local-ring form)."""
    if ring.dim() != 3 or ring.shape[1:] != (2, n_tgt + 1):
        raise ValueError(f"{what}: ring must be [D, 2, n_tgt+1], got "
                         f"{tuple(ring.shape)} for n_tgt={n_tgt} (N={n})")


def lif_deliver_plain(ring, targets, weights, dbins, spiked_prev, V, I_ex,
                      I_in, refrac, ext_cnt, i_dc, t, overflow, *,
                      n_exc: int, budget: int, prop: Propagators,
                      w_ext: float):
    """Returns ``(ring, V', I_ex', I_in', refrac', spiked, ids, overflow',
    t')``.

    ``ring`` [D, 2, N+1] is updated in place; ``ext_cnt`` is the step's
    float32 external spike counts (None: no spike drive), weighted by
    ``w_ext``; ``overflow'`` is ``overflow`` plus the budget excess of
    ``spiked_prev`` (the delivered step, ``t - 1``), ``t'`` is ``t + 1``.
    """
    n = V.shape[0]
    t = step_counter(t, ring.device)
    ring, ids, excess = ell_deliver_plain(
        ring, targets, weights, dbins, spiked_prev, t - 1, n_exc, budget)
    slot = slot_index(t, ring.shape[0])
    arrivals = ring.index_select(0, slot)[0]
    in_ex = arrivals[0, :n]
    if ext_cnt is not None:
        in_ex = in_ex + w_ext * ext_cnt
    V, I_ex, I_in, refrac, spiked = lif_update_plain(
        V, I_ex, I_in, refrac, in_ex, arrivals[1, :n], i_dc, prop=prop)
    ring.index_fill_(0, slot, 0.0)        # consume the slot
    return (ring, V, I_ex, I_in, refrac, spiked, ids,
            step_counter(overflow, ring.device) + excess, t + 1)


def lif_deliver_plastic_plain(ring, targets, weights, dbins, pmask,
                              spiked_prev, V, I_ex, I_in, refrac, ext_cnt,
                              i_dc, x_pre, x_post, t, overflow, *,
                              n_exc: int, budget: int, prop: Propagators,
                              w_ext: float, coef: StdpCoef,
                              trace: bool = True):
    """Returns ``(ring, weights, V', I_ex', I_in', refrac', spiked,
    x_pre', x_post', ids, overflow', t')``; ``ring`` and ``weights`` (the
    live table, ``pmask`` its plastic entries) are updated in place; the
    drive and the counters as for :func:`lif_deliver_plain`."""
    (ring, V, I_ex, I_in, refrac, spiked, ids, overflow,
     t) = lif_deliver_plain(
        ring, targets, weights, dbins, spiked_prev, V, I_ex, I_in, refrac,
        ext_cnt, i_dc, t, overflow, n_exc=n_exc, budget=budget, prop=prop,
        w_ext=w_ext)
    depress_plain(weights, targets, pmask, x_post, ids, coef.dep)
    if trace:
        x_pre, x_post = traces_plain(x_pre, x_post, spiked_prev,
                                     coef.decay_p, coef.decay_m)
    return (ring, weights, V, I_ex, I_in, refrac, spiked, x_pre, x_post, ids,
            overflow, t)


class StepConst(ctypes.Structure):
    """``StepConst`` of ``csrc/lif_deliver.cu``: what stays the same from
    step to step of a session, handed to the launch by pointer."""
    _fields_ = [("targets", _P), ("weights", _P), ("dbins", _P),
                ("pmask", _P), ("ws", _P), ("k_pad", _I), ("n", _I),
                ("n_tgt", _I), ("n_exc", _I), ("d_bins", _I), ("budget", _I),
                ("grid", _I), ("P11_ex", _F), ("P11_in", _F), ("P22", _F),
                ("P21_ex", _F), ("P21_in", _F), ("P20", _F), ("V_th", _F),
                ("V_reset", _F), ("E_L", _F), ("ref_steps", _I),
                ("dep_coef", _F), ("decay_p", _F), ("decay_m", _F),
                ("w_ext", _F)]


def step_const(ptrs: tuple, sizes: tuple, prop, coef,
               w_ext: float = 0.0) -> StepConst:
    """The pack of ``ptrs`` (targets, weights, dbins, pmask, workspace:
    device addresses, 0 for none), ``sizes`` (k_pad, n, n_tgt, n_exc,
    d_bins, budget, grid), the propagators (None for K2: zeros), for K4
    the STDP coefficients, and for K3 and K4 the external spikes' weight
    ``w_ext`` (rounded to float32, as PyTorch rounds a Python float that
    multiplies a float32 tensor)."""
    lif = (prop.P11_ex, prop.P11_in, prop.P22, prop.P21_ex, prop.P21_in,
           prop.P20, prop.V_th, prop.V_reset, prop.E_L, prop.ref_steps) \
        if prop else (0,) * 10
    plastic = (coef.dep, coef.decay_p, coef.decay_m) if coef else (0, 0, 0)
    return StepConst(*ptrs, *sizes, *lif, *plastic, w_ext)


#: ``step_const`` cached by its inputs, all plain values, so that a hit is
#: the pack those inputs build; the wrapper never writes into a pack
_cached_step_const = functools.lru_cache(maxsize=32)(step_const)


def session_pack(targets, weights, dbins, pmask, ws, *, n: int, n_exc: int,
                 d_bins: int, budget: int, grid: int, prop, coef,
                 n_tgt: Optional[int] = None,
                 w_ext: float = 0.0) -> StepConst:
    """The cached pack of a session's tables (``pmask`` and ``coef`` None
    for K3 and K2, ``prop`` None and ``w_ext`` 0 for K2), workspace and
    sizes, as a launch takes it.  ``n`` is the spike vector's length,
    ``n_tgt`` the ring's target count (``n`` when None; K2's local-ring
    form gives its own)."""
    return _cached_step_const(
        (targets.data_ptr(), weights.data_ptr(), dbins.data_ptr(),
         0 if pmask is None else pmask.data_ptr(), ws.data_ptr()),
        (targets.shape[1], n, n if n_tgt is None else int(n_tgt), n_exc,
         d_bins, budget, grid), prop, coef, float(w_ext))


# pack, tensors, t, the running overflow, t's output
_IO_ARGTYPES = [_P] + [_P] * 15 + [_P] * 3
_PLASTIC_ARGTYPES = [_P] * 4 + [_I]             # traces in and out, trace
_DELIVER_ARGTYPES = [_P] * 5 + [_P]             # pack, K2's tensors, t


def _lib():
    lib = _build.library("lif_deliver")
    if not getattr(lib, "_typed", False):
        for fn in ("lif_deliver_grid", "lif_deliver_const_bytes",
                   "lif_deliver_workspace_words", "lif_deliver_stamps",
                   "lif_deliver_launch", "lif_deliver_plastic_launch",
                   "lif_deliver_stamped_launch",
                   "lif_deliver_plastic_stamped_launch", "ell_deliver_launch",
                   "ell_deliver_stamped_launch"):
            getattr(lib, fn).restype = ctypes.c_int
        lib.lif_deliver_grid.argtypes = [_I, _P]
        lib.lif_deliver_const_bytes.argtypes = []
        lib.lif_deliver_workspace_words.argtypes = [_I]
        lib.lif_deliver_stamps.argtypes = []
        lib.lif_deliver_launch.argtypes = _IO_ARGTYPES + [_P]
        lib.lif_deliver_plastic_launch.argtypes = (
            _IO_ARGTYPES + _PLASTIC_ARGTYPES + [_P])
        lib.lif_deliver_stamped_launch.argtypes = _IO_ARGTYPES + [_P, _P]
        lib.lif_deliver_plastic_stamped_launch.argtypes = (
            _IO_ARGTYPES + _PLASTIC_ARGTYPES + [_P, _P])
        lib.ell_deliver_launch.argtypes = _DELIVER_ARGTYPES + [_P]
        lib.ell_deliver_stamped_launch.argtypes = _DELIVER_ARGTYPES + [_P, _P]
        if lib.lif_deliver_const_bytes() != ctypes.sizeof(StepConst):
            raise RuntimeError(
                f"lif_deliver: the C StepConst has "
                f"{lib.lif_deliver_const_bytes()} bytes, its ctypes mirror "
                f"{ctypes.sizeof(StepConst)}")
        lib._typed = True
    return lib


def cooperative_grid(device: torch.device, n_cols: int) -> int:
    """Blocks of K3's and K4's cooperative launch on ``device`` for
    ``n_cols`` ring columns: one per SM, fewer for a small network."""
    key = (_build.device_index(device), n_cols)
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
        if code == -2:
            raise RuntimeError("lif_deliver: no block of the kernel fits "
                               "on an SM")
        _build.check(lib, code, "lif_deliver_grid")
        _grid[key] = out.value
    return _grid[key]


def compaction_tiles(n: int, grid: int) -> list:
    """The ``[lo, hi)`` neuron tile of each block's compaction: ``grid``
    tiles of ``ceil(n / grid)`` neurons (the last ones shorter or empty)
    covering ``[0, n)``, as the kernel cuts them."""
    tile = -(-n // grid)
    return [(min(b * tile, n), min(b * tile + tile, n)) for b in range(grid)]


def workspace(device: torch.device, grid: int) -> torch.Tensor:
    """The kernel's persistent workspace for ``grid`` blocks on ``device``
    (int64 words: the launch count, then one look-back word per block),
    zeroed when first asked for and never again: the kernel advances the
    count itself."""
    key = (_build.device_index(device), grid)
    if key not in _workspaces:
        _workspaces[key] = torch.zeros(
            _lib().lif_deliver_workspace_words(grid), dtype=torch.int64,
            device=device)
    return _workspaces[key]


def stamps_buffer(device: torch.device, n_cols: int) -> torch.Tensor:
    """A ``[grid, len(PHASES) + 1]`` int64 buffer for one stamped launch:
    passed as ``stamps=`` to :func:`lif_deliver` or
    :func:`lif_deliver_plastic`, it selects the kernel's stamped
    instantiation, where each block writes its ``%globaltimer`` (ns) at its
    start and at the end of each of ``PHASES``."""
    grid = cooperative_grid(device, n_cols)
    return torch.zeros(grid, _lib().lif_deliver_stamps(), dtype=torch.int64,
                       device=device)


def _check_stamps(what, stamps, ring, n_cols):
    want = (cooperative_grid(ring.device, n_cols), _lib().lif_deliver_stamps())
    if stamps.dtype != torch.int64 or tuple(stamps.shape) != want \
            or stamps.device != ring.device or not stamps.is_contiguous():
        raise ValueError(f"{what}: stamps must be a stamps_buffer (int64 "
                         f"{list(want)} on {ring.device})")


def _check_counter(what, t, ring):
    if not (isinstance(t, torch.Tensor) and t.dtype == torch.int32
            and t.dim() == 0 and t.device == ring.device):
        raise TypeError(f"{what}: the step counter t must be a 0-d int32 "
                        f"tensor on {ring.device} (the kernel reads it "
                        f"there), got {t!r}")


def _pack(what, ring, targets, weights, dbins, pmask, spiked, n_exc,
          budget, prop, coef, t, n_tgt=None, w_ext=0.0):
    """Checks the delivery's inputs; returns the session's cached pack.
    The grid is sized by the spike vector (``n + 1`` columns), which the
    compaction covers; ``n_tgt`` (default ``n``) is the ring's target
    count."""
    n = spiked.shape[0]
    n_tgt = n if n_tgt is None else int(n_tgt)
    _check_inputs(what, ring, targets, weights, dbins, spiked, n_tgt)
    _check_counter(what, t, ring)
    k_pad = targets.shape[1]
    if budget * k_pad >= 2 ** 30:
        raise ValueError(f"{what}: budget x k_pad = {budget * k_pad} "
                         f"entries; the kernel counts them in 32 bits")
    dev = ring.device
    grid = cooperative_grid(dev, n + 1)
    return session_pack(targets, weights, dbins, pmask, workspace(dev, grid),
                        n=n, n_tgt=n_tgt, n_exc=n_exc, d_bins=ring.shape[0],
                        budget=budget, grid=grid, prop=prop, coef=coef,
                        w_ext=w_ext)


def _check_drive(what, ext_cnt, overflow, ring, n):
    """The step's float32 counts (or None) and the running overflow, a 0-d
    int32 tensor, where the kernel reads them."""
    if ext_cnt is not None and not (
            ext_cnt.dtype == torch.float32 and ext_cnt.shape == (n,)
            and ext_cnt.device == ring.device and ext_cnt.is_contiguous()):
        raise TypeError(f"{what}: ext_cnt must be the step's [{n}] float32 "
                        f"spike counts on {ring.device}, contiguous, or "
                        f"None")
    if not (isinstance(overflow, torch.Tensor)
            and overflow.dtype == torch.int32 and overflow.dim() == 0
            and overflow.device == ring.device):
        raise TypeError(f"{what}: the running overflow must be a 0-d int32 "
                        f"tensor on {ring.device}, got {overflow!r}")


def _launch_args(what, ring, targets, weights, dbins, pmask, spiked_prev,
                 V, I_ex, I_in, refrac, ext_cnt, i_dc, t, overflow, n_exc,
                 budget, prop, coef, w_ext):
    """Checks K3's or K4's inputs and allocates the outputs; returns them
    with the C arguments that K3 and K4 share: the session's cached pack,
    then this step's tensors (0 for no counts), the counter ``t``'s
    address, the running overflow's, and ``t + 1``'s."""
    _build.require_cuda(what, ring, V, I_ex, I_in, refrac, i_dc)
    if budget < 1:
        raise ValueError("the fused step needs spike_budget >= 1")
    n = V.shape[0]
    _check_drive(what, ext_cnt, overflow, ring, n)
    pack = _pack(what, ring, targets, weights, dbins, pmask, spiked_prev,
                 n_exc, budget, prop, coef, t, w_ext=w_ext)
    dev = ring.device
    Vo, Iexo, Iino = (torch.empty_like(V) for _ in range(3))
    refo = torch.empty_like(refrac)
    spk = torch.empty(n, dtype=torch.bool, device=dev)
    ids = torch.empty(budget, dtype=torch.int32, device=dev)
    overflow_o = torch.empty((), dtype=torch.int32, device=dev)
    t_o = torch.empty((), dtype=torch.int32, device=dev)
    c_args = (ctypes.addressof(pack),
              *(x.data_ptr() for x in (spiked_prev, ring, V, I_ex, I_in,
                                       refrac)),
              0 if ext_cnt is None else ext_cnt.data_ptr(),
              *(x.data_ptr() for x in (i_dc, Vo, Iexo, Iino, refo, spk, ids,
                                       overflow_o, t, overflow, t_o)))
    return (Vo, Iexo, Iino, refo, spk, ids, overflow_o, t_o), c_args


def lif_deliver(ring, targets, weights, dbins, spiked_prev, V, I_ex, I_in,
                refrac, ext_cnt, i_dc, t, overflow, *, n_exc: int,
                budget: int, prop: Propagators, w_ext: float, stamps=None):
    """Returns ``(ring, V', I_ex', I_in', refrac', spiked, ids, overflow',
    t')``; see :func:`lif_deliver_plain`.  ``stamps`` (a
    ``stamps_buffer``, on the card only) selects the stamped kernel, for a
    phase table."""
    args = (ring, targets, weights, dbins, spiked_prev, V, I_ex, I_in,
            refrac, ext_cnt, i_dc, t, overflow)
    if ring.device.type == "cpu":
        if stamps is not None:
            raise ValueError("lif_deliver: stamps are the kernel's, on the "
                             "card")
        return lif_deliver_plain(*args, n_exc=n_exc, budget=budget,
                                 prop=prop, w_ext=w_ext)
    (Vo, Iexo, Iino, refo, spk, ids, overflow_o, t_o), c_args = _launch_args(
        "lif_deliver", ring, targets, weights, dbins, None, *args[4:],
        n_exc, budget, prop, None, w_ext)
    lib = _lib()
    stream = _build.stream_of(ring)
    if stamps is None:
        code = lib.lif_deliver_launch(*c_args, stream)
    else:
        _check_stamps("lif_deliver", stamps, ring, ring.shape[2])
        code = lib.lif_deliver_stamped_launch(*c_args, stamps.data_ptr(),
                                              stream)
    _build.launches["lif_deliver"] += 1
    _build.check(lib, code, "lif_deliver (cooperative launch)")
    return ring, Vo, Iexo, Iino, refo, spk, ids, overflow_o, t_o


def lif_deliver_plastic(ring, targets, weights, dbins, pmask, spiked_prev,
                        V, I_ex, I_in, refrac, ext_cnt, i_dc, x_pre, x_post,
                        t, overflow, *, n_exc: int, budget: int,
                        prop: Propagators, w_ext: float, coef: StdpCoef,
                        trace: bool = True, stamps=None):
    """Returns ``(ring, weights, V', I_ex', I_in', refrac', spiked,
    x_pre', x_post', ids, overflow', t')``; see
    :func:`lif_deliver_plastic_plain`.  ``stamps`` as for
    :func:`lif_deliver`."""
    if ring.device.type == "cpu":
        if stamps is not None:
            raise ValueError("lif_deliver_plastic: stamps are the "
                             "kernel's, on the card")
        return lif_deliver_plastic_plain(
            ring, targets, weights, dbins, pmask, spiked_prev, V, I_ex,
            I_in, refrac, ext_cnt, i_dc, x_pre, x_post, t, overflow,
            n_exc=n_exc, budget=budget, prop=prop, w_ext=w_ext, coef=coef,
            trace=trace)
    _build.require_cuda("lif_deliver_plastic", ring, pmask, x_pre, x_post)
    if pmask.dtype != torch.bool or pmask.shape != targets.shape:
        raise TypeError("lif_deliver_plastic: pmask must be bool, shaped "
                        "as the tables")
    if x_pre.dtype != torch.float32 or x_post.dtype != torch.float32:
        raise TypeError("lif_deliver_plastic: traces must be float32")
    (Vo, Iexo, Iino, refo, spk, ids, overflow_o, t_o), c_args = _launch_args(
        "lif_deliver_plastic", ring, targets, weights, dbins, pmask,
        spiked_prev, V, I_ex, I_in, refrac, ext_cnt, i_dc, t, overflow,
        n_exc, budget, prop, coef, w_ext)
    x_pre_o, x_post_o = ((torch.empty_like(x_pre), torch.empty_like(x_post))
                         if trace else (x_pre, x_post))
    traces = (x_pre.data_ptr(), x_post.data_ptr(), x_pre_o.data_ptr(),
              x_post_o.data_ptr(), int(trace))
    lib = _lib()
    stream = _build.stream_of(ring)
    if stamps is None:
        code = lib.lif_deliver_plastic_launch(*c_args, *traces, stream)
    else:
        _check_stamps("lif_deliver_plastic", stamps, ring, ring.shape[2])
        code = lib.lif_deliver_plastic_stamped_launch(
            *c_args, *traces, stamps.data_ptr(), stream)
    _build.launches["lif_deliver_plastic"] += 1
    _build.check(lib, code, "lif_deliver_plastic (cooperative launch)")
    return (ring, weights, Vo, Iexo, Iino, refo, spk, x_pre_o, x_post_o, ids,
            overflow_o, t_o)


def deliver(ring, targets, weights, dbins, spiked, t, *, n_exc: int,
            budget: int, n_tgt=None, stamps=None):
    """K2 on the card: the kernel's delivery-only form, one cooperative
    launch.  Returns ``(ring, ids, overflow)``; ``ring`` is updated in
    place (see ``ell_deliver.ell_deliver``).  With ``n_tgt`` (the local-ring
    form) the ring is ``[D, 2, n_tgt + 1]`` and the launch is counted under
    ``ell_deliver_local``.  ``stamps`` as for :func:`lif_deliver`; the
    launch stamps the first five of ``PHASES``."""
    pack = _pack("ell_deliver", ring, targets, weights, dbins, None, spiked,
                 n_exc, budget, None, None, t, n_tgt)
    ids = torch.empty(budget, dtype=torch.int32, device=ring.device)
    overflow = torch.empty((), dtype=torch.int32, device=ring.device)
    c_args = (ctypes.addressof(pack), spiked.data_ptr(), ring.data_ptr(),
              ids.data_ptr(), overflow.data_ptr(), t.data_ptr())
    lib = _lib()
    stream = _build.stream_of(ring)
    if stamps is None:
        code = lib.ell_deliver_launch(*c_args, stream)
    else:
        _check_stamps("ell_deliver", stamps, ring, spiked.shape[0] + 1)
        code = lib.ell_deliver_stamped_launch(*c_args, stamps.data_ptr(),
                                              stream)
    _build.launches["ell_deliver" if n_tgt is None
                    else "ell_deliver_local"] += 1
    _build.check(lib, code, "ell_deliver (cooperative launch)")
    return ring, ids, overflow
