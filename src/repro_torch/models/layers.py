"""LM layer primitives: the port of ``repro.models.layers`` (rms_norm, rope,
GQA attention with qk-norm, a KV cache and cross-attention, SwiGLU).

Functional, with explicit parameter trees: plain dicts of tensors, with
the reference's names, nesting and shapes.  ``param(...)`` draws from an
explicit ``torch.Generator`` (the JAX package splits a PRNG key instead,
so the two give different weights from one seed; ``repro_torch.convert``
carries the reference's weights over) and records its logical sharding
axes beside the value, which ``split_tree`` separates.  Under
``abstract_params`` the values are tensors on the ``meta`` device: shapes
and dtypes, no storage.

``gathered`` is a cast on one card.  ``constrain`` is the ambient mesh's
(``repro_torch.sharding.ctx``): the identity outside a mesh, as the
reference's is (``repro/sharding/ctx.py:39-45``), and a redistribution of
a ``DTensor`` under one.

Attention routes by case (``mha``):

* every ``T > 1`` goes through K6 (``kernels.ops.flash_attention``; its
  plain version on CPU tensors), with ``[B, T, H, D]`` passed as
  transposed views: prefill, cross-attention, and a prefill into a KV
  cache, which hands K6 the cache's filled prefix and its index as
  ``q_offset`` (the reference's length mask adds nothing to the causal
  mask there: every key a query sees lies below ``cache_index + T``).
  The reference's ``mha`` scans query chunks of ``MHA_Q_CHUNK`` (512)
  instead, as the XLA stand-in for the same blocking; K6 needs none, and
  its memory grows with ``T``, not ``T**2``.
* a decode step (``T == 1``) keeps the reference's grouped einsum with
  its length mask and its rounding point: the probabilities are cast to
  ``v``'s type before the product.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.sharding.ctx import constrain


class ParamSpec(NamedTuple):
    value: torch.Tensor
    axes: Tuple[Optional[str], ...]


def is_spec(x) -> bool:
    return isinstance(x, ParamSpec)


_ABSTRACT = [False]


class abstract_params:
    """Context manager: param() yields tensors on the ``meta`` device (no
    sampling, no storage)."""

    def __enter__(self):
        _ABSTRACT.append(True)

    def __exit__(self, *exc):
        _ABSTRACT.pop()


def param(gen: torch.Generator, shape, axes, dtype=torch.float32,
          scale: float = 0.02, init: str = "normal") -> ParamSpec:
    """A parameter on ``gen``'s device: ``scale`` times a normal truncated
    to [-2, 2] (drawn in float32, then cast), or ones.  The reference's
    other initialisers (zeros, S4D) serve layers the port does not have."""
    if len(shape) != len(axes):
        raise ValueError(f"shape {shape} and axes {axes} differ in rank")
    shape = tuple(shape)
    if _ABSTRACT[-1]:
        return ParamSpec(torch.empty(shape, dtype=dtype, device="meta"),
                         tuple(axes))
    if init == "normal":
        v = torch.empty(shape, dtype=torch.float32, device=gen.device)
        torch.nn.init.trunc_normal_(v, 0.0, 1.0, -2.0, 2.0, generator=gen)
        v = scale * v
    elif init == "ones":
        v = torch.ones(shape, dtype=torch.float32, device=gen.device)
    else:
        raise ValueError(f"init {init!r} is not 'normal' or 'ones'")
    return ParamSpec(v.to(dtype), tuple(axes))


def _tree_map(fn, tree):
    if is_spec(tree):
        return fn(tree)
    return {k: _tree_map(fn, v) for k, v in tree.items()}


def split_tree(tree):
    """ParamSpec tree -> (values tree, logical-axes tree)."""
    return (_tree_map(lambda s: s.value, tree),
            _tree_map(lambda s: s.axes, tree))


def gathered(w: torch.Tensor, axes, dt: torch.dtype) -> torch.Tensor:
    """The reference's ZeRO-3 gather on one card: a cast."""
    return w.to(dt)


# ---------------------------------------------------------------------------
# Norms / rotary
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5):
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * w.to(x.dtype)


def init_rms(gen, d, dtype):
    return {"scale": param(gen, (d,), ("embed",), dtype, init="ones")}


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """x: [..., T, H, D]; positions: broadcastable to [..., T]."""
    d = x.shape[-1]
    half = d // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions.to(torch.float32)[..., None, None] * freqs
    cos, sin = torch.cos(ang).to(x.dtype), torch.sin(ang).to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


# ---------------------------------------------------------------------------
# Attention (GQA, optional qk-norm, self/causal/cross, cache support)
# ---------------------------------------------------------------------------

def init_attention(gen, cfg, cross: bool = False):
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    p = {
        "wq": param(gen, (d, h, hd), ("embed", "heads", "head_dim"),
                    scale=0.02),
        "wk": param(gen, (d, kv, hd), ("embed", "kv_heads", "head_dim")),
        "wv": param(gen, (d, kv, hd), ("embed", "kv_heads", "head_dim")),
        "wo": param(gen, (h, hd, d), ("heads", "head_dim", "embed"),
                    scale=0.02 / (2 * cfg.n_layers) ** 0.5),
    }
    if cfg.qk_norm and not cross:
        p["q_norm"] = param(gen, (hd,), ("head_dim",), init="ones")
        p["k_norm"] = param(gen, (hd,), ("head_dim",), init="ones")
    return p


def _qkv(p, x, x_kv, cfg, positions, cross: bool):
    dt = x.dtype
    ax = ("embed", "heads", "head_dim")
    axk = ("embed", "kv_heads", "head_dim")
    q = torch.einsum("btd,dhk->bthk", x, gathered(p["wq"], ax, dt))
    k = torch.einsum("bsd,dhk->bshk", x_kv, gathered(p["wk"], axk, dt))
    v = torch.einsum("bsd,dhk->bshk", x_kv, gathered(p["wv"], axk, dt))
    if "q_norm" in p:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if not cross and cfg.use_rope:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def mha(q, k, v, *, causal: bool, length_mask: Optional[torch.Tensor] = None,
        q_offset=0):
    """q: [B,T,H,hd]; k,v: [B,S,KV,hd]. f32 softmax. Returns [B,T,H,hd].

    ``length_mask``: [B, S] bool (valid kv positions), for a decode step
    (``T == 1``) against a cache.
    ``q_offset``: global position of query 0, for causal masking vs a cache.
    """
    b, t, h, hd = q.shape
    kvh = k.shape[2]
    scale = hd ** -0.5

    if t == 1:
        # decode: grouped-query einsum against the cache, no KV expansion
        g = h // kvh
        q5 = q.reshape(b, 1, kvh, g, hd)
        logits = torch.einsum("btkgd,bskd->bkgts", q5, k).to(torch.float32)
        logits = constrain(logits * scale,
                           ("batch", "kv_heads", None, None, "kv_seq"))
        if length_mask is not None:
            logits = logits.masked_fill(
                ~length_mask[:, None, None, None, :], float("-inf"))
        probs = torch.softmax(logits, dim=-1)
        out = torch.einsum("bkgts,bskd->btkgd", probs.to(v.dtype), v)
        return out.reshape(b, 1, h, hd)

    if length_mask is not None:
        raise ValueError("mha: a length mask is taken by a decode step "
                         "(T == 1) only; a prefill into a cache passes the "
                         "cache's filled prefix and q_offset")
    # K6; heads to dim 1 as views
    out = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal=causal, scale=scale,
                              q_offset=q_offset)
    return out.transpose(1, 2)


def _update_slice(buf: torch.Tensor, new: torch.Tensor, index) -> torch.Tensor:
    """``jax.lax.dynamic_update_slice_in_dim(buf, new, index, axis=1)``: a
    copy of ``buf`` with ``new`` written from ``index`` (clamped so that it
    fits, as JAX clamps)."""
    start = min(max(int(index), 0), buf.shape[1] - new.shape[1])
    out = buf.clone()
    out[:, start:start + new.shape[1]] = new
    return out


def attention(p, x, cfg, positions, *, causal=True, x_kv=None,
              cache=None, cache_index=None):
    """Self/cross attention.

    cache: dict(k=[B,S,KV,hd], v=...) updated at ``cache_index`` when given
    (decode; the cache given is not modified, a new one is returned); for
    cross-attention with a cache, k/v are read straight from it.
    Returns (out, new_cache).
    """
    if x_kv is not None:
        q, k, v = _qkv(p, x, x_kv, cfg, positions, cross=True)
        out = mha(q, k, v, causal=False)
        return torch.einsum("bthk,hkd->btd", out,
                            p["wo"].to(x.dtype)), cache
    q, k, v = _qkv(p, x, x, cfg, positions, cross=False)
    if cache is None:
        out = mha(q, k, v, causal=causal)
        new_cache = None
    else:
        kc = _update_slice(cache["k"], k.to(cache["k"].dtype), cache_index)
        vc = _update_slice(cache["v"], v.to(cache["v"].dtype), cache_index)
        s, t = kc.shape[1], q.shape[1]
        if t == 1:
            valid = torch.arange(s, device=x.device)[None, :] \
                < (cache_index + 1)
            out = mha(q, kc.to(v.dtype), vc.to(v.dtype), causal=True,
                      length_mask=valid.expand(x.shape[0], s),
                      q_offset=cache_index)
        else:
            end = min(int(cache_index) + t, s)       # the filled prefix
            out = mha(q, kc[:, :end].to(v.dtype), vc[:, :end].to(v.dtype),
                      causal=True, q_offset=cache_index)
        new_cache = {"k": kc, "v": vc}
    wo = gathered(p["wo"], ("heads", "head_dim", "embed"), x.dtype)
    return torch.einsum("bthk,hkd->btd", out, wo), new_cache


def cross_kv(p, enc_out, cfg):
    """Precompute cross-attention K/V from encoder/image embeddings."""
    dt = enc_out.dtype
    k = torch.einsum("bsd,dhk->bshk", enc_out, p["wk"].to(dt))
    v = torch.einsum("bsd,dhk->bshk", enc_out, p["wv"].to(dt))
    return {"k": k, "v": v}


def cross_attention_cached(p, x, cfg, ckv):
    """Cross-attn against precomputed K/V (no RoPE, not causal)."""
    dt = x.dtype
    q = torch.einsum("btd,dhk->bthk", x, p["wq"].to(dt))
    out = mha(q, ckv["k"].to(dt), ckv["v"].to(dt), causal=False)
    return torch.einsum("bthk,hkd->btd", out, p["wo"].to(dt))


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def init_mlp(gen, d, f, n_layers):
    return {
        "w_gate": param(gen, (d, f), ("embed", "mlp")),
        "w_up": param(gen, (d, f), ("embed", "mlp")),
        "w_down": param(gen, (f, d), ("mlp", "embed"),
                        scale=0.02 / (2 * n_layers) ** 0.5),
    }


def mlp(p, x):
    dt = x.dtype
    wg = gathered(p["w_gate"], ("embed", "mlp"), dt)
    wu = gathered(p["w_up"], ("embed", "mlp"), dt)
    wd = gathered(p["w_down"], ("mlp", "embed"), dt)
    h = F.silu(x @ wg) * (x @ wu)
    return h @ wd
