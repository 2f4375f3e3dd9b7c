"""K6: causal or full GQA flash attention (``csrc/flash_attention.cu``) and
its plain version.

Replaces ``repro/kernels/flash_attention.py:flash_attention_pallas``.
``q`` is ``[B, Hq, T, D]``, ``k`` and ``v`` ``[B, Hkv, S, D]`` with
``Hq % Hkv == 0``; query head ``h`` reads KV head ``h // (Hq // Hkv)``.
The scores ``(q . k) * scale`` (default ``1 / sqrt(D)``) go through a
float32 softmax over the live keys and weight ``v``; the output has q's
type.  Inputs are float32 or bfloat16, float32 inside.

The causal mask is the TPU kernel's, top-left aligned: query ``r`` sees
keys ``c <= r`` (``repro/kernels/flash_attention.py:44-48``, and
``repro/models/layers.py:_mha_block`` with ``q_offset=0``).  The JAX
package's oracle ``ref.mha_ref`` aligns it bottom-right instead
(``tril(k=S-T)``); the two agree only where ``T == S``.  ``q_offset``
(0 in the TPU kernel) is the global index of query 0: query ``r`` then
sees keys ``c <= q_offset + r``, as ``_mha_block``'s does; a prefill into
a KV cache passes the cache's index and its filled prefix.  A row with no
live key gives 0, as the TPU kernel's ``l == 0`` guard does.

The kernel takes any batch, head and row strides as long as the last dim
is contiguous, so the attention layer hands it ``[B, T, H, D]`` tensors
as transposed views, without a copy; the output is allocated in q's
layout.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build

#: head dims the kernel is instantiated for
HEAD_DIMS = (32, 64, 128)
DTYPES = (torch.float32, torch.bfloat16)

_I, _L, _F, _P = ctypes.c_int, ctypes.c_longlong, ctypes.c_float, \
    ctypes.c_void_p


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: q must be [B, Hq, T, D] and k, v "
                         f"[B, Hkv, S, D], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, hq, _, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or hq % k.shape[1]:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} does not fit "
                         f"q {tuple(q.shape)} (Hq % Hkv must be 0)")


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          scale: Optional[float] = None,
                          q_offset: int = 0) -> torch.Tensor:
    """One-shot float32 softmax with the kernel's mask (``q_offset`` as
    the kernel's, but any integer: a band of rows can be checked without
    the whole ``[T, S]`` score matrix)."""
    _check(q, k, v)
    b, hq, t, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    scale = float(scale if scale is not None else 1.0 / (d ** 0.5))
    qf = q.to(torch.float32).reshape(b, hkv, hq // hkv, t, d)
    logits = torch.einsum("bhgtd,bhsd->bhgts", qf,
                          k.to(torch.float32)) * scale
    if causal:
        rows = q_offset + torch.arange(t, device=q.device)[:, None]
        live = torch.arange(s, device=q.device)[None, :] <= rows
        logits = logits.masked_fill(~live, float("-inf"))
    m = logits.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isinf(m), torch.zeros_like(m), m)
    p = logits.sub_(m).exp_()                 # in place: one [.., T, S] copy
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhgts,bhsd->bhgtd", p, v.to(torch.float32))
    out = out / torch.where(l == 0, torch.ones_like(l), l)
    return out.reshape(b, hq, t, d).to(q.dtype)


def _lib():
    lib = _build.library("flash_attention")
    if not getattr(lib, "_typed", False):
        lib.flash_attention_launch.restype = ctypes.c_int
        lib.flash_attention_launch.argtypes = (
            [_P] * 4 + [_L] * 12 + [_I] * 7 + [_F, _I, _I, _P])
        lib._typed = True
    return lib


def _check_layout(*tensors: torch.Tensor) -> None:
    """One CUDA device; last dim contiguous; strides (of dims longer than
    1) multiples of 4 and data 16-byte aligned, for the kernel's 16- and
    8-byte loads."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"flash_attention: tensors must all lie on one "
                             f"CUDA device (got {t.device} and {dev})")
        if t.stride(-1) != 1 or t.data_ptr() % 16 or any(
                st % 4 for st, n in zip(t.stride()[:-1], t.shape[:-1])
                if n > 1):
            raise ValueError(
                f"flash_attention: each tensor needs a contiguous last dim, "
                f"strides that are multiples of 4 and 16-byte aligned data "
                f"(got strides {t.stride()})")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: Optional[float] = None,
                    q_offset: int = 0) -> torch.Tensor:
    """``q`` [B, Hq, T, D], ``k``/``v`` [B, Hkv, S, D] -> [B, Hq, T, D] in
    q's type and layout.  ``q_offset`` >= 0 is query 0's index in the
    causal mask."""
    q_offset = int(q_offset)
    if q_offset < 0:
        raise ValueError(f"flash_attention: q_offset {q_offset} < 0")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, scale=scale,
                                     q_offset=q_offset)
    _check(q, k, v)
    b, hq, t, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} not in {HEAD_DIMS}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: q, k, v must all be float32 or "
                        f"all bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if b * hq > 65535:
        raise ValueError(f"flash_attention: B * Hq = {b * hq} exceeds the "
                         f"grid's 65535")
    out = torch.empty_like(q)
    _check_layout(q, k, v, out)
    if t == 0:
        return out
    scale = float(scale if scale is not None else 1.0 / (d ** 0.5))
    lib = _lib()
    strides = [st for x in (q, k, v, out) for st in x.stride()[:3]]
    code = lib.flash_attention_launch(
        _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(out),
        *(_L(st) for st in strides), _I(b), _I(hq), _I(hkv), _I(t), _I(s),
        _I(d), _I(1 if q.dtype == torch.bfloat16 else 0), _F(scale),
        _I(1 if causal else 0), _I(q_offset), _build.stream_of(q))
    _build.launches["flash_attention"] += 1
    _build.check(lib, code, "flash_attention")
    return out
