"""The LM attention and MLP layers: the port (``repro_torch.models.layers``)
against ``repro.models.layers``.

Both packages compute from the same weights: the JAX package's
``init_attention`` / ``init_mlp`` trees, through ``split_tree`` and
``convert.layer_params_to_torch``.  Activations are made with numpy from a
seed (a bfloat16 case rounds the same float32 numbers in each).  The width
is Qwen3-32B's smoke configuration (``d_model`` 64, 4 query and 2 KV
heads, ``head_dim`` 16, qk-norm, rope); float32 within 2e-5 and bfloat16
within 3e-2, ``tests/test_kernels.py``'s attention tolerances.

Prefill and cross-attention run through K6's plain version on the CPU
(the port's ``mha`` routes them to ``kernels.ops.flash_attention``); the
reference's ``mha`` runs its XLA math, in query chunks above
``MHA_Q_CHUNK``.  A prefill into a cache also goes through K6 in the port,
on the cache's filled prefix with the cache's index as ``q_offset``, where
the reference masks the whole cache by length; a decode step runs the
reference's own math in both.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JaxConfig
from repro.models import layers as JL
from repro_torch import convert
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import _build
from repro_torch.models import layers as TL

FIELDS = dict(name="qwen3-32b-smoke", n_layers=2, d_model=64, n_heads=4,
              n_kv_heads=2, d_ff=160, head_dim=16, qk_norm=True)
JCFG = JaxConfig(family="dense", vocab_size=512, **FIELDS)
TCFG = ModelConfig(**FIELDS)
TOL = {"float32": 2e-5, "bfloat16": 3e-2}
DTYPES = ["float32", "bfloat16"]
CPU = torch.device("cpu")


def _weights(init, *args, seed=0):
    """The JAX tree's values, and the same numbers as the port's dict."""
    values, _ = JL.split_tree(init(jax.random.PRNGKey(seed), *args))
    arrays = jax.tree.map(np.asarray, values)
    return values, convert.layer_params_to_torch(arrays, CPU)


def _acts(shape, dtype: str, seed: int):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return (jnp.asarray(a).astype(getattr(jnp, dtype)),
            torch.from_numpy(a).to(getattr(torch, dtype)))


def _close(got, want, dtype: str):
    got = got.to(torch.float32).numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=TOL[dtype], atol=TOL[dtype])


def _positions(b, t):
    pos = np.broadcast_to(np.arange(t, dtype=np.int32), (b, t))
    return jnp.asarray(pos), torch.from_numpy(pos.copy())


def _specs(tree):
    return {k: (_specs(v) if isinstance(v, dict)
                else (tuple(v.value.shape), tuple(v.axes)))
            for k, v in tree.items()}


@pytest.mark.parametrize("which", ["attention", "cross_attention", "mlp",
                                   "rms"])
def test_param_trees_match(which):
    """Keys, shapes and logical axes equal the reference's, sampled and
    abstract (the meta device)."""
    make = {
        "attention": (lambda k: JL.init_attention(k, JCFG),
                      lambda g: TL.init_attention(g, TCFG)),
        "cross_attention": (lambda k: JL.init_attention(k, JCFG, cross=True),
                            lambda g: TL.init_attention(g, TCFG, cross=True)),
        "mlp": (lambda k: JL.init_mlp(k, 64, 160, 2),
                lambda g: TL.init_mlp(g, 64, 160, 2)),
        "rms": (lambda k: JL.init_rms(k, 64, jnp.float32),
                lambda g: TL.init_rms(g, 64, torch.float32)),
    }[which]
    want = _specs(make[0](jax.random.PRNGKey(0)))
    tree = make[1](torch.Generator().manual_seed(0))
    assert _specs(tree) == want
    with TL.abstract_params():
        abstract = make[1](torch.Generator())
    assert _specs(abstract) == want
    values, axes = TL.split_tree(abstract)
    assert all(v.device.type == "meta" for v in values.values())
    assert axes == JL.split_tree(make[0](jax.random.PRNGKey(0)))[1]
    w, _ = TL.split_tree(tree)
    for v in w.values():
        assert v.dtype == torch.float32 and torch.isfinite(v).all()
        assert v.abs().max() <= 2.0 * 0.02 or v.eq(1.0).all()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,t", [(2, 64), (1, 1100)],
                         ids=["t64", "t1100_chunked_ref"])
def test_self_attention_prefill(b, t, dtype):
    jp, tp = _weights(JL.init_attention, JCFG)
    jx, tx = _acts((b, t, 64), dtype, seed=1)
    jpos, tpos = _positions(b, t)
    want, _ = JL.attention(jp, jx, JCFG, jpos)
    got, cache = TL.attention(tp, tx, TCFG, tpos)
    assert cache is None
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_mha_routes_prefill_through_k6(dtype, monkeypatch):
    """Prefill reaches ``ops.flash_attention`` once, with the heads moved to
    dim 1 as views and the layer's scale; decode does not reach it."""
    calls = []
    real = TL.ops.flash_attention

    def spy(q, k, v, **kw):
        calls.append((q.shape, q.is_contiguous(), kw))
        return real(q, k, v, **kw)

    monkeypatch.setattr(TL.ops, "flash_attention", spy)
    _, tq = _acts((1, 24, 4, 16), dtype, seed=2)
    _, tk = _acts((1, 24, 2, 16), dtype, seed=3)
    TL.mha(tq, tk, tk, causal=True)
    TL.mha(tq[:, :1], tk, tk, causal=False)
    assert calls == [((1, 4, 24, 16), False,
                      {"causal": True, "scale": 16 ** -0.5, "q_offset": 0})]


@pytest.mark.parametrize("dtype", DTYPES)
def test_cache_prefill_routes_through_k6(dtype, monkeypatch):
    """A prefill of 6 tokens at cache_index 5 hands K6 the cache's first
    11 slots and q_offset 5, as views."""
    calls = []
    real = TL.ops.flash_attention

    def spy(q, k, v, **kw):
        calls.append((q.shape, k.shape, kw))
        return real(q, k, v, **kw)

    monkeypatch.setattr(TL.ops, "flash_attention", spy)
    _, tp = _weights(JL.init_attention, JCFG)
    _, tx = _acts((2, 6, 64), dtype, seed=4)
    cache = {"k": torch.zeros(2, 32, 2, 16, dtype=tx.dtype),
             "v": torch.zeros(2, 32, 2, 16, dtype=tx.dtype)}
    pos = torch.arange(5, 11)[None].expand(2, 6)
    TL.attention(tp, tx, TCFG, pos, cache=cache, cache_index=5)
    assert calls == [((2, 4, 6, 16), (2, 2, 11, 16),
                      {"causal": True, "scale": 16 ** -0.5, "q_offset": 5})]


def test_mha_takes_a_length_mask_only_in_decode():
    _, tq = _acts((1, 4, 4, 16), "float32", seed=2)
    _, tk = _acts((1, 8, 2, 16), "float32", seed=3)
    mask = torch.ones(1, 8, dtype=torch.bool)
    assert TL.mha(tq[:, :1], tk, tk, causal=True,
                  length_mask=mask).shape == (1, 1, 4, 16)
    with pytest.raises(ValueError, match="decode step"):
        TL.mha(tq, tk, tk, causal=True, length_mask=mask)


#: (tokens, cache_index, cache slots) of each cache step
CACHE_STEPS = {"masked_prefill": (6, 5, 32), "decode": (1, 11, 32),
               "long_prefill": (1100, 300, 1500),
               "prefill_past_end": (6, 29, 32)}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("step", list(CACHE_STEPS))
def test_cache_paths(step, dtype):
    """A prefill into a cache holding earlier K/V (6 tokens at index 5;
    1,100 at index 300, past ``MHA_Q_CHUNK``, where the reference scans
    query chunks; 6 at index 29 of 32, where the write is clamped to the
    cache's end as JAX clamps it), or one decode step at index 11."""
    jp, tp = _weights(JL.init_attention, JCFG)
    t, index, slots = CACHE_STEPS[step]
    jx, tx = _acts((2, t, 64), dtype, seed=4)
    jk, tk = _acts((2, slots, 2, 16), dtype, seed=5)
    jv, tv = _acts((2, slots, 2, 16), dtype, seed=6)
    pos = np.broadcast_to(np.arange(index, index + t, dtype=np.int32),
                          (2, t))
    want, jcache = JL.attention(jp, jx, JCFG, jnp.asarray(pos),
                                cache={"k": jk, "v": jv}, cache_index=index)
    before = (tk.clone(), tv.clone(), _build.launches["flash_attention"])
    got, tcache = TL.attention(tp, tx, TCFG, torch.from_numpy(pos.copy()),
                               cache={"k": tk, "v": tv}, cache_index=index)
    _close(got, want, dtype)
    _close(tcache["k"], jcache["k"], dtype)
    _close(tcache["v"], jcache["v"], dtype)
    assert torch.equal(tk, before[0]) and torch.equal(tv, before[1])
    assert _build.launches["flash_attention"] == before[2]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("route", ["x_kv", "cross_kv_cached"])
def test_cross_attention(route, dtype):
    jp, tp = _weights(JL.init_attention, JCFG, True)
    jx, tx = _acts((2, 24, 64), dtype, seed=7)
    je, te = _acts((2, 40, 64), dtype, seed=8)
    jpos, tpos = _positions(2, 24)
    if route == "x_kv":
        want, _ = JL.attention(jp, jx, JCFG, jpos, x_kv=je)
        got, _ = TL.attention(tp, tx, TCFG, tpos, x_kv=te)
    else:
        jckv, tckv = JL.cross_kv(jp, je, JCFG), TL.cross_kv(tp, te, TCFG)
        _close(tckv["k"], jckv["k"], dtype)
        _close(tckv["v"], jckv["v"], dtype)
        want = JL.cross_attention_cached(jp, jx, JCFG, jckv)
        got = TL.cross_attention_cached(tp, tx, TCFG, tckv)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("op", ["mlp", "rms_norm", "rope"])
def test_mlp_norm_rope(op, dtype):
    jx, tx = _acts((2, 24, 64), dtype, seed=10)
    if op == "mlp":
        jp, tp = _weights(JL.init_mlp, 64, 160, 2)
        want, got = JL.mlp(jp, jx), TL.mlp(tp, tx)
    elif op == "rms_norm":
        w = 1.0 + 0.1 * np.random.default_rng(11).standard_normal(64)
        w = w.astype(np.float32)
        want = JL.rms_norm(jx, jnp.asarray(w), 1e-6)
        got = TL.rms_norm(tx, torch.from_numpy(w), 1e-6)
    else:
        jh, th = _acts((2, 24, 4, 16), dtype, seed=12)
        jpos, tpos = _positions(2, 24)
        want = JL.rope(jh, jpos * 37, 1e6)
        got = TL.rope(th, tpos * 37, 1e6)
    _close(got, want, dtype)
    assert got.dtype == getattr(torch, dtype)


def test_layer_params_round_trip():
    """numpy -> the port's dict -> numpy, bitwise, and bfloat16 through
    float32 exactly."""
    values, tp = _weights(JL.init_attention, JCFG)
    back = convert.layer_params_to_numpy(tp)
    for key, v in values.items():
        assert np.array_equal(back[key], np.asarray(v))
    bf = convert.layer_params_to_torch(
        jax.tree.map(lambda v: np.asarray(v.astype(jnp.bfloat16)), values),
        CPU)
    assert bf["wq"].dtype == torch.bfloat16
    assert np.array_equal(convert.layer_params_to_numpy(bf)["wq"],
                          np.asarray(values["wq"].astype(jnp.bfloat16),
                                     np.float32))
    cast = convert.layer_params_to_torch(back, CPU, torch.bfloat16)
    assert all(v.dtype == torch.bfloat16 for v in cast.values())
    assert torch.equal(cast["wq"], bf["wq"])


def test_config_fields_are_the_references():
    """Each of the port's fields is the reference's, with its default, and
    the properties the layers read agree."""
    ref = {f.name: f.default for f in dataclasses.fields(JaxConfig)}
    for f in dataclasses.fields(ModelConfig):
        assert f.name in ref and f.default == ref[f.name], f.name
    for prop in ("head_dim_", "use_rope"):
        assert getattr(TCFG, prop) == getattr(JCFG, prop)
    assert TCFG.activation_dtype == torch.bfloat16
    assert ModelConfig(**{**FIELDS, "head_dim": None}).head_dim_ == 16
