"""K6 (flash attention): the port against the JAX package.

Inputs are made with numpy from a seed and handed to both packages (a
bfloat16 case rounds the same float32 numbers in each).  What the wrapper
runs on CPU tensors is K6's plain version, the one-shot float32 softmax
the CUDA kernel is held to on the card (``chip_smoke.py``).

* The plain version against JAX's Pallas kernel
  (``repro.kernels.ops.flash_attention``, interpret mode on the CPU) and
  its oracle ``ref.mha_ref`` at ``tests/test_kernels.py``'s four shapes,
  float32 within 2e-5 and bfloat16 within 3e-2 (that test's tolerances).
* Causal with ``T != S``: the kernel and ``layers.mha`` align the mask
  top-left, ``mha_ref`` bottom-right.  The port follows the kernel and
  the layers and departs from ``mha_ref``, which gives NaN where a row
  has no live key.
* The plain version's ``q_offset`` (a band of rows, as ``chip_smoke.py``
  checks the 32k call) and its rows with no live key (zeros); the
  wrapper's ``q_offset`` on a cache's filled prefix against the JAX
  layers' ``mha`` over the whole cache with its length mask.
* The guards: on a tensor that is not on the CPU the wrapper checks the
  head dim and the dtypes and then launches the kernel or raises; here a
  ``meta`` tensor stands for one on the card, and nothing falls back to
  the plain version.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models.layers import mha as jax_mha
from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as K6
from repro_torch.kernels import ops as kops

TOL = {"float32": 2e-5, "bfloat16": 3e-2}
SHAPES = [
    # (B, Hq, Hkv, T, S, D, causal): tests/test_kernels.py's
    (1, 2, 2, 64, 64, 32, True),
    (2, 4, 2, 128, 128, 64, True),
    (1, 8, 1, 100, 100, 64, True),       # ragged T
    (2, 4, 4, 128, 256, 32, False),      # cross-shaped
]


def _inputs(b, hq, hkv, t, s, d, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, hq, t, d), np.float32),
            rng.standard_normal((b, hkv, s, d), np.float32),
            rng.standard_normal((b, hkv, s, d), np.float32))


def _both(arrays, dtype: str):
    jx = [jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrays]
    tx = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]
    return jx, tx


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cfg", SHAPES, ids=lambda c: "x".join(map(str, c)))
def test_plain_matches_pallas_kernel(cfg, dtype):
    b, hq, hkv, t, s, d, causal = cfg
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(b, hq, hkv, t, s, d), dtype)
    before = _build.launches["flash_attention"]
    got = kops.flash_attention(tq, tk, tv, causal=causal)
    assert _build.launches["flash_attention"] == before   # CPU: plain
    assert got.dtype == tq.dtype and got.shape == tq.shape
    tol = TOL[dtype]
    for want in (jops.flash_attention(jq, jk, jv, causal=causal),
                 jref.mha_ref(jq, jk, jv, causal=causal)):
        np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("t,s", [(64, 128), (128, 64)])
def test_causal_t_ne_s_follows_kernel_not_mha_ref(t, s):
    b, hq, hkv, d = 1, 4, 2, 32
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(b, hq, hkv, t, s, d, seed=9),
                                       "float32")
    got = _np(kops.flash_attention(tq, tk, tv, causal=True))
    kernel = _np(jops.flash_attention(jq, jk, jv, causal=True))
    layer = _np(jax_mha(jq.swapaxes(1, 2), jk.swapaxes(1, 2),
                        jv.swapaxes(1, 2), causal=True)).swapaxes(1, 2)
    np.testing.assert_allclose(got, kernel, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, layer, rtol=2e-5, atol=2e-5)
    oracle = _np(jref.mha_ref(jq, jk, jv, causal=True))
    assert np.isfinite(got).all()
    if t > s:
        # bottom-right: rows r < T - S have no live key -> NaN
        assert np.isnan(oracle[:, :, :t - s]).all()
        assert np.isfinite(oracle[:, :, t - s:]).all()
    else:
        assert np.abs(got - oracle).max() > 0.1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_q_offset_is_a_band_of_rows(dtype):
    _, (tq, tk, tv) = _both(_inputs(1, 4, 2, 96, 96, 64, seed=4), dtype)
    full = K6.flash_attention_plain(tq, tk, tv, causal=True)
    band = K6.flash_attention_plain(tq[:, :, -32:], tk, tv, causal=True,
                                    q_offset=64)
    np.testing.assert_allclose(_np(band), _np(full[:, :, -32:]),
                               rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_q_offset_on_cache_prefix_matches_layers_mha(dtype):
    """8 queries at positions 20..27 of a 48-slot cache: K6 over the first
    28 slots with q_offset 20 is the JAX ``mha`` over all 48 with the
    length mask."""
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(2, 4, 2, 8, 48, 32, seed=6),
                                       dtype)
    valid = jnp.broadcast_to(jnp.arange(48)[None] < 28, (2, 48))
    want = jax_mha(jq.swapaxes(1, 2), jk.swapaxes(1, 2), jv.swapaxes(1, 2),
                   causal=True, length_mask=valid, q_offset=20)
    got = kops.flash_attention(tq, tk[:, :, :28], tv[:, :, :28],
                               causal=True, q_offset=20)
    np.testing.assert_allclose(_np(got), _np(want).swapaxes(1, 2),
                               rtol=TOL[dtype], atol=TOL[dtype])


def test_plain_rows_with_no_live_key_are_zero():
    _, (tq, tk, tv) = _both(_inputs(1, 2, 1, 16, 16, 32, seed=5), "float32")
    out = K6.flash_attention_plain(tq, tk, tv, causal=True, q_offset=-5)
    assert torch.equal(out[:, :, :5], torch.zeros_like(out[:, :, :5]))
    assert torch.isfinite(out).all() and (out[:, :, 5:] != 0).any()


def _meta(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("case,exc,match", [
    ("head_dim_48", ValueError, "head dim 48"),
    ("float16", TypeError, "float32 or"),
    ("mixed_dtypes", TypeError, "float32 or"),
    ("gqa_mismatch", ValueError, "Hq % Hkv"),
    ("not_cuda", ValueError, "CUDA device"),
    ("negative_q_offset", ValueError, "q_offset -1"),
])
def test_wrapper_guards_off_cpu(case, exc, match):
    """Off the CPU the wrapper launches K6 or raises; it never takes the
    plain version."""
    d = 48 if case == "head_dim_48" else 64
    dt = torch.float16 if case == "float16" else torch.float32
    hkv = 3 if case == "gqa_mismatch" else 2
    q, k = _meta((1, 4, 16, d), dt), _meta((1, hkv, 16, d), dt)
    v = _meta((1, hkv, 16, d),
              torch.bfloat16 if case == "mixed_dtypes" else dt)
    before = _build.launches["flash_attention"]
    with pytest.raises(exc, match=match):
        kops.flash_attention(q, k, v, causal=True,
                             q_offset=-1 if case == "negative_q_offset"
                             else 0)
    assert _build.launches["flash_attention"] == before
