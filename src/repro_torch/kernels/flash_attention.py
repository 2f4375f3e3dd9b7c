"""K6: causal or full GQA flash attention, its two CUDA kernels and its
plain version.

* bfloat16 inputs take ``csrc/flash_attention_sm90.cu``: both products
  on Hopper's tensor cores (``wgmma``), K/V tiles through TMA into an
  ``mbarrier`` ring, the probabilities rounded to bfloat16 before P.V,
  as ``repro/models/layers.py:_mha_block`` rounds them.  It is held to
  ``bf16_bar``.
* float32 inputs take ``csrc/flash_attention.cu``: float32 FMAs on the
  CUDA cores, held to 2e-5.

Replaces ``repro/kernels/flash_attention.py:flash_attention_pallas``.
``q`` is ``[B, Hq, T, D]``, ``k`` and ``v`` ``[B, Hkv, S, D]`` with
``Hq % Hkv == 0``; query head ``h`` reads KV head ``h // (Hq // Hkv)``.
The scores ``(q . k) * scale`` (default ``1 / sqrt(D)``) go through a
float32 softmax over the live keys and weight ``v``; the output has q's
type.  Inputs are float32 or bfloat16, every sum float32.

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
layout.  The data must be 16-byte aligned and every stride (of a dim
longer than 1) a multiple of 16 bytes: 4 float32 elements for the
float32 kernel's vector loads, 8 bfloat16 for TMA.  Anything else raises
``ValueError``; nothing falls back.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build

#: head dims the kernels are instantiated for
HEAD_DIMS = (32, 64, 128)
DTYPES = (torch.float32, torch.bfloat16)
#: the device type the kernels take
DEVICE_TYPE = "cuda"

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


def bf16_bar(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             **kw) -> torch.Tensor:
    """The elementwise limit of ``|K6 - plain|`` for bfloat16 inputs,

        ``2**-7 * |plain(q, k, v)| + 2**-8 * plain(q, k, |v|)``,

    with ``plain`` the float32 plain version on the same (bfloat16)
    values and ``kw`` the call's ``causal``, ``scale`` and ``q_offset``.

    The tensor-core kernel feeds P.V the probabilities rounded to
    bfloat16, which moves each p by at most 2**-8 of itself, so the
    numerator ``sum_c p[c] v[c]`` moves by at most 2**-8 ``sum_c p[c]
    |v[c]|``; divided by the float32 ``l`` (summed from the unrounded p)
    that is ``2**-8 * plain(q, k, |v|)``.  Rounding the output adds 2**-8
    of it; the other 2**-8 of ``|plain|`` covers the float32 sums taken in
    another order and the hardware's ``exp2``, each about 1e-6 relative.
    """
    f = [x.to(torch.float32) for x in (q, k, v)]
    want = flash_attention_plain(*f, **kw)
    spread = flash_attention_plain(f[0], f[1], f[2].abs(), **kw)
    return 2.0 ** -7 * want.abs() + 2.0 ** -8 * spread


def _lib(dtype: torch.dtype):
    """The library of the kernel for ``dtype`` and its typed C entry."""
    if dtype == torch.bfloat16:
        lib = _build.library("flash_attention_sm90")
        fn = lib.flash_attention_sm90_launch
    else:
        lib = _build.library("flash_attention")
        fn = lib.flash_attention_launch
    if not getattr(fn, "_typed", False):
        fn.restype = ctypes.c_int
        fn.argtypes = [_P] * 4 + [_L] * 12 + [_I] * 6 + [_F, _I, _I, _P]
        fn._typed = True
    return lib, fn


def _check_layout(*tensors: torch.Tensor) -> None:
    """One CUDA device; last dim contiguous; data 16-byte aligned and the
    strides (of dims longer than 1) multiples of 16 bytes, for the float32
    kernel's vector loads and the bfloat16 kernel's TMA."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != DEVICE_TYPE:
            raise ValueError(f"flash_attention: tensors must all lie on one "
                             f"CUDA device (got {t.device} and {dev})")
        per16 = 16 // t.element_size()
        if t.stride(-1) != 1 or t.data_ptr() % 16 or any(
                st % per16 for st, n in zip(t.stride()[:-1], t.shape[:-1])
                if n > 1):
            raise ValueError(
                f"flash_attention: each tensor needs a contiguous last dim, "
                f"strides that are multiples of {per16} ({t.dtype}: 16 "
                f"bytes) and 16-byte aligned data (got strides "
                f"{t.stride()})")


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
    scale = float(scale if scale is not None else 1.0 / (d ** 0.5))
    if q.dtype == torch.bfloat16 and not scale > 0:
        raise ValueError(f"flash_attention: scale {scale} must be > 0 for "
                         f"bfloat16 (the kernel takes the row max of the "
                         f"unscaled scores)")
    out = torch.empty_like(q)
    _check_layout(q, k, v, out)
    if t == 0:
        return out
    if s == 0:                           # no live key: every row is 0
        return out.zero_()
    lib, fn = _lib(q.dtype)
    strides = [st for x in (q, k, v, out) for st in x.stride()[:3]]
    code = fn(_build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(out),
              *(_L(st) for st in strides), _I(b), _I(hq), _I(hkv), _I(t),
              _I(s), _I(d), _F(scale), _I(1 if causal else 0), _I(q_offset),
              _build.stream_of(q))
    _build.launches["flash_attention"] += 1
    _build.check(lib, code, "flash_attention")
    return out
