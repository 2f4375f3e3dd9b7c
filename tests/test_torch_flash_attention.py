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
  the plain version.  bfloat16 strides must be multiples of 8 (TMA's 16
  bytes); bfloat16 and float32 reach two different C entries (a stub
  library stands for the built one).
* ``bf16_bar``, the bar of the tensor-core kernel, which rounds P to
  bfloat16 before P.V: the JAX layers' own attention with bfloat16
  probabilities (``_mha_block`` given float32 q and k that hold bfloat16
  values and a bfloat16 v) meets it, and a tiled emulation of the kernel
  meets it at scores x1 and x4, while the same emulation with the causal
  mask shifted by one key, or one K/V tile skipped, does not.  With q = 0
  every live p is exactly 1 and the plain version gives the mean of the
  live V rows.
"""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models.layers import _mha_block as jax_mha_block
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


# --------------------------------------------------------------- bf16 bar
BAR_SHAPES = SHAPES + [(1, 4, 2, 64, 192, 64, True)]   # q_offset 128 below


def _bf16_inputs(cfg, seed=3):
    b, hq, hkv, t, s, d, _ = cfg
    return [torch.from_numpy(a).to(torch.bfloat16)
            for a in _inputs(b, hq, hkv, t, s, d, seed=seed)]


def _jax_bf16_probs(tq, tk, tv, qk_dtype, **kw):
    """``repro.models.layers._mha_block`` (``[B, T, H, D]``, K/V heads
    repeated) on the same values: q and k in ``qk_dtype``, v in bfloat16,
    so the probabilities are rounded to bfloat16 before P.V."""
    rep = tq.shape[1] // tk.shape[1]

    def bthd(x, dtype, r=1):
        a = np.repeat(x.to(torch.float32).numpy(), r, axis=1)
        return jnp.asarray(a.swapaxes(1, 2)).astype(dtype)

    out = jax_mha_block(bthd(tq, qk_dtype), bthd(tk, qk_dtype, rep),
                        bthd(tv, jnp.bfloat16, rep), length_mask=None,
                        scale=tq.shape[-1] ** -0.5, **kw)
    return torch.from_numpy(_np(out).swapaxes(1, 2).copy())


def _over_bar(got, tq, tk, tv, **kw) -> float:
    """The largest ``|got - plain| / bf16_bar`` (plain in float32)."""
    want = K6.flash_attention_plain(tq.float(), tk.float(), tv.float(), **kw)
    bar = K6.bf16_bar(tq, tk, tv, **kw)
    return float(((got.float() - want).abs() / bar).max())


@pytest.mark.parametrize("cfg", BAR_SHAPES,
                         ids=lambda c: "x".join(map(str, c)))
def test_jax_bf16_probabilities_within_bf16_bar(cfg):
    """The reference's own bf16 attention arithmetic (exact scores, P and
    the output rounded to bfloat16) is what ``bf16_bar`` admits; with the
    scores also in bfloat16 (``layers.py:175``) it is not, at a causal
    shape."""
    causal, q_offset = cfg[6], 128 if cfg[3] != cfg[4] and cfg[6] else 0
    tq, tk, tv = _bf16_inputs(cfg)
    kw = dict(causal=causal, q_offset=q_offset)
    got = _jax_bf16_probs(tq, tk, tv, jnp.float32, **kw)
    assert _over_bar(got, tq, tk, tv, **kw) <= 1.0
    if cfg == SHAPES[1]:
        all_bf16 = _jax_bf16_probs(tq, tk, tv, jnp.bfloat16, **kw)
        assert _over_bar(all_bf16, tq, tk, tv, **kw) > 1.0


def _emulate_sm90(tq, tk, tv, *, causal=True, shift=0, skip_tile=None,
                  tile=128):
    """The tensor-core kernel's arithmetic in float32 on the CPU: 128-key
    tiles, a running max, p rounded to bfloat16 before P.V, l summed from
    the float32 p, the output rounded to bfloat16.  ``shift`` moves the
    causal mask by that many keys and ``skip_tile`` drops one tile: the
    faults the bar must catch."""
    q, k, v = (x.to(torch.float32) for x in (tq, tk, tv))
    rep = q.shape[1] // k.shape[1]
    k, v = k.repeat_interleave(rep, 1), v.repeat_interleave(rep, 1)
    t, s, d = q.shape[2], k.shape[2], q.shape[3]
    scale = d ** -0.5
    m = torch.full(q.shape[:3] + (1,), float("-inf"))
    l = torch.zeros_like(m)
    acc = torch.zeros_like(q)
    rows = torch.arange(t)[:, None]
    for k0 in range(0, s, tile):
        if k0 // tile == skip_tile:
            continue
        sc = q @ k[:, :, k0:k0 + tile].transpose(-1, -2) * scale
        cols = k0 + torch.arange(sc.shape[-1])[None, :]
        if causal:
            sc = sc.masked_fill(cols > rows + shift, float("-inf"))
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        m_use = torch.where(torch.isinf(m_new), torch.zeros_like(m_new),
                            m_new)
        p = (sc - m_use).exp()
        alpha = (m - m_use).exp()
        l = l * alpha + p.sum(-1, keepdim=True)
        p16 = p.to(torch.bfloat16).to(torch.float32)
        acc = acc * alpha + p16 @ v[:, :, k0:k0 + tile]
        m = m_new
    out = acc / torch.where(l == 0, torch.ones_like(l), l)
    return out.to(torch.bfloat16)


@pytest.mark.parametrize("score_scale", [1.0, 4.0])
def test_tiled_emulation_meets_bf16_bar(score_scale):
    cfg = (1, 4, 2, 512, 512, 128, True)
    tq, tk, tv = _bf16_inputs(cfg, seed=11)
    tq = (tq.float() * score_scale).to(torch.bfloat16)
    got = _emulate_sm90(tq, tk, tv)
    assert _over_bar(got, tq, tk, tv, causal=True) <= 1.0


@pytest.mark.parametrize("fault", ["mask_shifted_one_key", "tile_skipped"])
def test_tiled_emulation_faults_break_bf16_bar(fault):
    cfg = (1, 4, 2, 512, 512, 128, True)
    tq, tk, tv = _bf16_inputs(cfg, seed=11)
    kw = (dict(shift=1) if fault == "mask_shifted_one_key"
          else dict(skip_tile=1))
    got = _emulate_sm90(tq, tk, tv, **kw)
    assert _over_bar(got, tq, tk, tv, causal=True) > 1.0


@pytest.mark.parametrize("cfg,q_offset", [
    ((2, 4, 2, 128, 128, 64, True), 0),
    ((1, 8, 1, 100, 100, 64, True), 0),
    ((2, 4, 4, 128, 256, 32, False), 0),
    ((1, 4, 2, 64, 192, 64, True), 128),
], ids=["causal", "ragged", "cross", "q_offset"])
def test_plain_zero_q_gives_mean_of_live_v_rows(cfg, q_offset):
    """q = 0: every live score is 0 and every p exactly 1 (in bfloat16
    too), so out[r] is the mean of v over the keys row r sees.  The card
    holds the tensor-core kernel to one rounding of this case."""
    b, hq, hkv, t, s, d, causal = cfg
    _, tk, tv = _bf16_inputs(cfg, seed=8)
    tq = torch.zeros(b, hq, t, d, dtype=torch.bfloat16)
    got = K6.flash_attention_plain(tq.float(), tk.float(), tv.float(),
                                   causal=causal, q_offset=q_offset)
    v64 = tv.to(torch.float64).repeat_interleave(hq // hkv, 1)
    n_live = torch.full((t,), s) if not causal else torch.clamp(
        q_offset + torch.arange(t) + 1, max=s)
    means = v64.cumsum(2)[:, :, n_live - 1] / n_live[None, None, :, None]
    np.testing.assert_allclose(got.numpy(), means.numpy(), rtol=1e-6,
                               atol=1e-6)


@pytest.fixture
def on_meta(monkeypatch):
    """``meta`` tensors stand for CUDA ones: the wrapper takes them as on
    the card, and a stub library records which C entry each call
    reaches."""
    calls = []

    def entry(name):
        def fn(*args):
            calls.append((name, args))
            return 0
        return fn

    def lib():
        return types.SimpleNamespace(
            flash_attention_launch=entry("flash_attention_launch"),
            flash_attention_sm90_launch=entry("flash_attention_sm90_launch"),
            kernel_error_string=lambda code: b"stub")

    libs = {}
    monkeypatch.setattr(K6, "DEVICE_TYPE", "meta")
    monkeypatch.setattr(_build, "library",
                        lambda name: libs.setdefault(name, lib()))
    monkeypatch.setattr(_build, "stream_of", lambda t: None)
    return calls, libs


@pytest.mark.parametrize("dtype,entry,library", [
    (torch.bfloat16, "flash_attention_sm90_launch", "flash_attention_sm90"),
    (torch.float32, "flash_attention_launch", "flash_attention"),
])
def test_wrapper_picks_kernel_by_dtype(on_meta, dtype, entry, library):
    calls, libs = on_meta
    q = _meta((2, 8, 40, 64), dtype)
    k, v = _meta((2, 2, 72, 64), dtype), _meta((2, 2, 72, 64), dtype)
    before = _build.launches["flash_attention"]
    out = kops.flash_attention(q, k, v, causal=True, q_offset=5)
    assert _build.launches["flash_attention"] == before + 1
    assert out.shape == q.shape and out.dtype == dtype
    assert list(libs) == [library]
    (name, args), = calls
    assert name == entry
    strides = [a.value for a in args[4:16]]
    assert strides == [*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                       *q.stride()[:3]]
    assert [a.value for a in args[16:22]] == [2, 8, 2, 40, 72, 64]
    assert args[22].value == pytest.approx(64 ** -0.5)
    assert (args[23].value, args[24].value) == (1, 5)


@pytest.mark.parametrize("case,match", [
    ("row_stride_68", "multiples of 8"),
    ("head_dim_16", "head dim 16"),
    ("scale_0", "scale 0.0 must be > 0"),
])
def test_wrapper_bf16_guards(on_meta, case, match):
    """bfloat16 on the card: every stride a multiple of 8 elements (16
    bytes, for TMA), D in (32, 64, 128) and a positive scale, or
    ``ValueError``; nothing is launched."""
    calls, _ = on_meta
    d = 16 if case == "head_dim_16" else 64
    bf = torch.bfloat16
    q = (torch.empty_strided((1, 4, 16, 64), (4 * 16 * 68, 68, 4 * 68, 1),
                             dtype=bf, device="meta")
         if case == "row_stride_68" else _meta((1, 4, 16, d), bf))
    k, v = _meta((1, 2, 16, d), bf), _meta((1, 2, 16, d), bf)
    before = _build.launches["flash_attention"]
    with pytest.raises(ValueError, match=match):
        kops.flash_attention(q, k, v, causal=True,
                             scale=0.0 if case == "scale_0" else None)
    assert _build.launches["flash_attention"] == before and not calls
    if case == "row_stride_68":          # the float32 kernel takes it
        q32 = torch.empty_strided(q.shape, q.stride(), device="meta")
        kops.flash_attention(q32, k.float(), v.float(), causal=True)
        assert [c[0] for c in calls] == ["flash_attention_launch"]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_wrapper_no_keys_launches_nothing(on_meta, dtype):
    """S = 0: every row has no live key, so the output is zeroed on the
    card without a launch (a TMA map cannot describe an empty tensor)."""
    calls, _ = on_meta
    q = _meta((1, 4, 16, 64), dtype)
    k, v = _meta((1, 2, 0, 64), dtype), _meta((1, 2, 0, 64), dtype)
    before = _build.launches["flash_attention"]
    out = kops.flash_attention(q, k, v, causal=False)
    assert out.shape == q.shape and out.dtype == dtype
    assert _build.launches["flash_attention"] == before and not calls
