"""K5: activity-gated dense spike delivery (``csrc/spike_deliver.cu``) and
its plain version.

Replaces ``repro/kernels/spike_deliver.py:gated_spike_matvec_pallas``
together with the einsum, roll and add of ``repro/core/delivery.py:
deliver_dense`` around it.  The step's spiking ids are compacted in order
(all of them: the dense strategy has no budget), and for each channel
(``p < n_exc`` excitatory, Dale's law) ``upd[d, ch, n] = Σ_p W[d, p, n]``
is summed from zero in ascending ``p`` in float32 (a bfloat16 ``W`` is
widened as it is read); bin ``d`` is added into ``ring[(t + d) % D, ch,
n]``.  The ring is updated **in place**.  ``t`` is the step counter, a 0-d
int32 tensor on the ring's device: the kernel reads it there, and the plain
version shifts the bins by index arithmetic on it (no read to the host).

The plain version gathers the spiking rows and adds them one after the
other in the same order, so the kernel equals it bit for bit.  The JAX
reference sums with an einsum or a GEMM instead: the same numbers up to
the order of the sum.

``gated_spike_matvec(s, W) -> [D, N]`` is the kernel with the reference
kernel's own signature (``repro/kernels/ops.py:37``): the one sum
``Σ_p s[p]·W[d, p, n]`` over the ``p`` with ``s[p] != 0``.  It is the
local product of the dense sharded step (``core/distributed``).  On
``meta`` tensors (``launch.dryrun``) it gives the result's shape and
reports to ``perf.step_analysis`` the dense product it stands for (every
row: a meta tensor holds no spikes), as the reference's dry run counts its
einsum; nothing runs.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.perf.step_analysis import note_kernel

_I, _P = ctypes.c_int, ctypes.c_void_p


def _ordered_sum(W: torch.Tensor, ids: torch.Tensor,
                 scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``Σ_j scale[j]·W[:, ids[j], :]`` in float32, from zero, in the order
    of ``ids``: ``[D, N]``."""
    rows = W[:, ids, :].to(torch.float32)                  # [D, S, N]
    if scale is not None:
        rows = rows * scale.to(torch.float32)[None, :, None]
    acc = torch.zeros((W.shape[0], W.shape[2]), dtype=torch.float32,
                      device=W.device)
    for j in range(rows.shape[1]):
        acc += rows[:, j]
    return acc


def gated_spike_matvec_plain(s: torch.Tensor, W: torch.Tensor
                             ) -> torch.Tensor:
    """``s`` [P], ``W`` [D, P, N] float32 or bfloat16 -> [D, N] float32."""
    ids = torch.nonzero(s).view(-1)
    return _ordered_sum(W, ids, s[ids])


def rolled(upd: torch.Tensor, t) -> torch.Tensor:
    """``torch.roll(upd, t, dims=0)`` for a step counter ``t`` that is a
    0-d tensor (or an int): row ``(j + t) % D`` of the result is row ``j``
    of ``upd``, by a gather with no read of ``t`` to the host."""
    d = upd.shape[0]
    t = torch.as_tensor(t, dtype=torch.int64, device=upd.device)
    src = torch.remainder(torch.arange(d, device=upd.device) - t, d)
    return upd.index_select(0, src)


def dense_deliver_plain(ring: torch.Tensor, W: torch.Tensor,
                        spiked: torch.Tensor, t, n_exc: int
                        ) -> torch.Tensor:
    """Adds the step's dense update into ``ring`` [D, 2, N+1] in place."""
    n = spiked.shape[0]
    ids = torch.nonzero(spiked).view(-1)
    upd = torch.stack([_ordered_sum(W, ids[ids < n_exc]),
                       _ordered_sum(W, ids[ids >= n_exc])], dim=1)
    ring[:, :, :n] += rolled(upd, t)
    return ring


def _lib():
    lib = _build.library("spike_deliver")
    if not getattr(lib, "_typed", False):
        lib.spike_compact_tile.restype = ctypes.c_int
        lib.spike_compact_tile.argtypes = []
        lib.gated_spike_launch.restype = ctypes.c_int
        lib.gated_spike_launch.argtypes = (
            [_P, _I, _P, _P, _P, _P, _I, _P, _I, _I, _I, _P, _P, _P, _P])
        lib._typed = True
    return lib


def _launch(spiked, W, scale, n_exc: int, ring=None, t=None,
            out=None) -> None:
    """Compaction and rows kernel; ``ring`` (at phase ``t``, the counter
    tensor) or ``out``."""
    d_bins, p, n = W.shape
    lib = _lib()
    tile = lib.spike_compact_tile()
    dev = W.device
    counts = torch.empty(max(1, -(-p // tile)), dtype=torch.int32,
                         device=dev)
    ids = torch.empty(max(1, p), dtype=torch.int32, device=dev)
    count = torch.empty(1, dtype=torch.int32, device=dev)
    opt = lambda x: _P(None) if x is None else _build.ptr(x)
    code = lib.gated_spike_launch(
        _build.ptr(spiked), _I(p), _build.ptr(counts), _build.ptr(ids),
        _build.ptr(count), _build.ptr(W),
        _I(1 if W.dtype == torch.bfloat16 else 0), opt(scale), _I(d_bins),
        _I(n), _I(n_exc), opt(ring), opt(t), opt(out),
        _build.stream_of(W))
    _build.launches["gated_spike_matvec"] += 1
    _build.check(lib, code, "gated_spike_matvec")


def _check_table(what: str, W: torch.Tensor) -> None:
    if W.dim() != 3:
        raise ValueError(f"{what}: W must be [D, P, N], got "
                         f"{tuple(W.shape)}")
    if W.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{what}: W must be float32 or bfloat16, got "
                        f"{W.dtype}")


def dense_deliver(ring: torch.Tensor, W: torch.Tensor, spiked: torch.Tensor,
                  t, n_exc: int) -> torch.Tensor:
    """Returns ``ring`` [D, 2, N+1] f32, updated in place; ``W`` is the
    bin-major table [D, N, N], ``spiked`` [N] bool."""
    if ring.device.type == "cpu":
        return dense_deliver_plain(ring, W, spiked, t, n_exc)
    _build.require_cuda("dense_deliver", ring, W, spiked)
    _check_table("dense_deliver", W)
    if not (isinstance(t, torch.Tensor) and t.dtype == torch.int32
            and t.dim() == 0 and t.device == ring.device):
        raise TypeError(f"dense_deliver: the step counter t must be a 0-d "
                        f"int32 tensor on {ring.device}, got {t!r}")
    n = spiked.shape[0]
    if ring.dtype != torch.float32 or spiked.dtype != torch.bool:
        raise TypeError("dense_deliver: ring must be float32 and spiked "
                        "bool")
    if W.shape != (ring.shape[0], n, n) or ring.shape[1:] != (2, n + 1):
        raise ValueError(f"dense_deliver: W {tuple(W.shape)} and ring "
                         f"{tuple(ring.shape)} do not fit N={n}")
    _launch(spiked, W, None, n_exc, ring=ring, t=t)
    return ring


def gated_spike_matvec(s: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """``s`` [P], ``W`` [D, P, N] float32 or bfloat16 -> [D, N] float32."""
    if W.device.type == "cpu":
        return gated_spike_matvec_plain(s, W)
    _check_table("gated_spike_matvec", W)
    if W.device.type == "meta":
        d, p, n = W.shape
        note_kernel("gated_spike_matvec",
                    nbytes=W.numel() * W.element_size() + 4 * p + 4 * d * n,
                    flops=2 * d * p * n)
        return torch.empty((d, n), dtype=torch.float32, device="meta")
    if s.shape != (W.shape[1],):
        raise ValueError(f"gated_spike_matvec: s {tuple(s.shape)} does not "
                         f"fit W {tuple(W.shape)}")
    spiked = s != 0
    scale = s.to(torch.float32).contiguous()
    out = torch.empty((W.shape[0], W.shape[2]), dtype=torch.float32,
                      device=W.device)
    _build.require_cuda("gated_spike_matvec", W, spiked, scale, out)
    _launch(spiked, W, scale, W.shape[1], out=out)
    return out
