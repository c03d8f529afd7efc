"""Attention paths that stay on every backend, against float64 references.

Covers the plain (einsum) attention of models/layers.multi_head_attention
over a (Tq, Tk) grid up to Whisper's 1500 encoder positions, its gradient
and stop-gradient, the int8/int4 cross-KV decode paths against attention
over the dequantized cache, the init_cache padding contract, and the
backend kernel policy. Tests marked ``gpu`` need the card; chip_smoke.py's
kernel phase runs the same checks there.
"""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from whisper_ipa.config import CONFIGS
from whisper_ipa.models import init_params, layers
from whisper_ipa.models.whisper import (
    _quantize_kv_heads,
    _quantize_kv_heads4,
    init_cache,
)

N_HEAD, D = 2, 16


def _ref_attention(q, k, v, n_head, g=None):
    """float64 softmax attention per head, and its VJP for cotangent g."""
    B, Tq, d = q.shape
    dh = d // n_head
    s = dh ** -0.5
    split = lambda x: x.reshape(B, -1, n_head, dh).transpose(0, 2, 1, 3)  # noqa: E731
    merge = lambda x: x.transpose(0, 2, 1, 3).reshape(B, -1, d)  # noqa: E731
    Q, K, V = (split(np.asarray(x, np.float64)) for x in (q, k, v))
    S = np.einsum("bhqd,bhkd->bhqk", Q, K) * s
    P = np.exp(S - S.max(-1, keepdims=True))
    P /= P.sum(-1, keepdims=True)
    O = np.einsum("bhqk,bhkd->bhqd", P, V)
    if g is None:
        return merge(O)
    dO = split(np.asarray(g, np.float64))
    dV = np.einsum("bhqk,bhqd->bhkd", P, dO)
    dP = np.einsum("bhqd,bhkd->bhqk", dO, V)
    dS = P * (dP - (dP * P).sum(-1, keepdims=True))
    dQ = np.einsum("bhqk,bhkd->bhqd", dS, K) * s
    dK = np.einsum("bhqk,bhqd->bhkd", dS, Q) * s
    return merge(O), (merge(dQ), merge(dK), merge(dV))


def _qkvg(tq, tk, seed=0, batch=1):
    rng = np.random.default_rng(seed)
    return tuple(
        rng.standard_normal((batch, t, D)).astype(np.float32)
        for t in (tq, tk, tk, tq)
    )


GRID = [(1, 1500), (47, 1500), (128, 128), (200, 333), (1500, 1500)]


@pytest.mark.parametrize("tq,tk", GRID)
def test_attention_matches_float64(tq, tk):
    q, k, v, _ = _qkvg(tq, tk)
    out = layers.multi_head_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), N_HEAD)
    np.testing.assert_allclose(
        np.asarray(out), _ref_attention(q, k, v, N_HEAD), atol=2e-5, rtol=1e-4
    )


@pytest.mark.parametrize("tq,tk", GRID)
def test_attention_gradient_matches_float64(tq, tk):
    q, k, v, g = _qkvg(tq, tk, seed=1)
    grads = jax.grad(
        lambda q, k, v: jnp.sum(layers.multi_head_attention(q, k, v, N_HEAD)
                                * g),
        argnums=(0, 1, 2),
    )(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    _, ref = _ref_attention(q, k, v, N_HEAD, g)
    for got, want in zip(grads, ref):
        np.testing.assert_allclose(np.asarray(got), want, atol=5e-5,
                                   rtol=1e-3)


def test_attention_stop_gradient():
    """Under stop_gradient (the frozen-encoder regime) the attention
    output still flows forward and contributes no gradient."""
    q, k, v, g = _qkvg(64, 1500, seed=2)

    def f(q, k, v):
        out = jax.lax.stop_gradient(layers.multi_head_attention(q, k, v,
                                                                N_HEAD))
        return jnp.sum(out * g) + jnp.sum(q)

    val, (dq, dk, dv) = jax.value_and_grad(f, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ref = _ref_attention(q, k, v, N_HEAD)
    assert np.isclose(float(val), (ref * g).sum() + q.sum(), rtol=1e-4)
    np.testing.assert_array_equal(np.asarray(dq), np.ones_like(q))
    assert not np.asarray(dk).any() and not np.asarray(dv).any()


def test_masked_attention_matches_float64():
    """The decoder's additive causal mask goes through the same path."""
    q, k, v, _ = _qkvg(24, 24, seed=3)
    mask = layers.causal_mask(24)
    out = layers.multi_head_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), N_HEAD,
        jnp.asarray(mask))
    split = lambda x: x.reshape(1, 24, N_HEAD, -1)  # noqa: E731
    ref = np.concatenate([
        _ref_attention(q[:, i:i + 1], k[:, :i + 1], v[:, :i + 1], N_HEAD)
        for i in range(24)
    ], axis=1)
    np.testing.assert_allclose(split(np.asarray(out)), split(ref), atol=2e-5)


# -- int8 / int4 cross-KV caches -------------------------------------------

def _dequant_int8(codes, scale, T):
    x = np.asarray(codes, np.float64) * np.asarray(scale)[:, :, None, :]
    B, H, Dh, _ = x.shape
    return x[..., :T].transpose(0, 3, 1, 2).reshape(B, T, H * Dh)


def _dequant_int4(packed, scale, T):
    p = np.asarray(packed).astype(np.int8)
    lo = (p.astype(np.int16) << 12 >> 12).astype(np.float64)  # low nibble
    hi = (p.astype(np.int16) >> 4).astype(np.float64)
    codes = np.stack([lo, hi], axis=-1).reshape(p.shape[:-1] + (-1,))
    return _dequant_int8(codes, scale, T)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("s_len", [1, 3])
def test_quantized_cross_attention_matches_dequantized(bits, s_len):
    rng = np.random.default_rng(bits + s_len)
    T, B = 1500, 2
    q = rng.standard_normal((B, s_len, D)).astype(np.float32)
    k = rng.standard_normal((B, T, D)).astype(np.float32)
    v = rng.standard_normal((B, T, D)).astype(np.float32)
    quant = _quantize_kv_heads if bits == 8 else _quantize_kv_heads4
    deq = _dequant_int8 if bits == 8 else _dequant_int4
    kq, ks = quant(jnp.asarray(k), N_HEAD)
    vq, vs = quant(jnp.asarray(v), N_HEAD)
    out = layers.multi_head_attention_int8kv(
        jnp.asarray(q), kq, ks, vq, vs, N_HEAD)
    ref = _ref_attention(q, deq(kq, ks, T), deq(vq, vs, T), N_HEAD)
    np.testing.assert_allclose(np.asarray(out), ref, atol=2e-5, rtol=1e-4)
    # the dequantized cache is close to the float one it replaces
    step = 2.0 / 254 if bits == 8 else 2.0 / 14
    assert np.abs(deq(kq, ks, T) - k).max() <= step * np.abs(k).max()


@pytest.mark.parametrize("int4", [False, True])
def test_init_cache_padding_contract(int4):
    """Cross-KV caches pad T=1500 to 1536 with scale 0 and code 0."""
    cfg = replace(CONFIGS["test-tiny"], n_text_layer=1)
    params = init_params(cfg, seed=0)
    feats = jnp.asarray(np.random.default_rng(0).standard_normal(
        (2, cfg.n_audio_ctx, cfg.n_audio_state)).astype(np.float32))
    cache = init_cache(params, cfg, feats, max_len=8,
                       cross_kv_int8=not int4, cross_kv_int4=int4)
    T = cfg.n_audio_ctx
    for codes, scale in ((cache.cross_k, cache.cross_k_scale),
                         (cache.cross_v, cache.cross_v_scale)):
        scale = np.asarray(scale)
        assert scale.shape[-1] == 1536
        assert (scale[..., :T] > 0).all() and not scale[..., T:].any()
        codes = np.asarray(codes)
        assert codes.dtype == np.int8
        pad = codes[..., T // 2:] if int4 else codes[..., T:]
        assert codes.shape[-1] == (768 if int4 else 1536)
        assert not pad.any()


# -- kernel policy ----------------------------------------------------------

@pytest.mark.parametrize(
    "backend,dtype,tq,tk,masked,expected",
    [
        ("gpu", jnp.bfloat16, 1500, 1500, False, True),
        ("gpu", jnp.float16, 128, 1500, False, True),
        ("gpu", jnp.float32, 1500, 1500, False, False),
        ("gpu", jnp.bfloat16, 47, 1500, False, True),
        ("gpu", jnp.bfloat16, 1500, 1500, True, False),
        ("cpu", jnp.bfloat16, 1500, 1500, False, False),
        ("gpu", jnp.bfloat16, 1, 1500, False, False),
        ("gpu", jnp.bfloat16, 5, 1500, False, True),
        ("gpu", jnp.bfloat16, 128, 1501, False, False),
    ],
)
def test_cudnn_policy(monkeypatch, backend, dtype, tq, tk, masked, expected):
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    q = jnp.zeros((1, tq, D), dtype)
    k = jnp.zeros((1, tk, D), dtype)
    mask = jnp.zeros((tq, tk)) if masked else None
    assert layers.use_cudnn_attention(q, k, mask) is expected


@pytest.mark.parametrize("tq", [47, 48])
def test_cudnn_route_pads_odd_query(monkeypatch, tq):
    """The cuDNN branch's reshapes and odd-length padding, with JAX's XLA
    implementation standing in for cuDNN (which needs the card): output
    and gradients equal the einsum path's."""
    real = jax.nn.dot_product_attention
    seen = []

    def stand_in(*args, implementation=None, **kw):
        seen.append((implementation, args[0].shape[1]))
        return real(*args, implementation="xla", **kw)

    monkeypatch.setattr(jax.nn, "dot_product_attention", stand_in)
    q, k, v, g = _qkvg(tq, 64, seed=5)

    def loss(cudnn, q, k, v):
        out = layers.multi_head_attention(q, k, v, N_HEAD, cudnn=cudnn)
        return jnp.sum(out * g), out

    (_, out), grads = jax.value_and_grad(
        lambda *a: loss(True, *a), (0, 1, 2), has_aux=True)(q, k, v)
    (_, ref), ref_grads = jax.value_and_grad(
        lambda *a: loss(False, *a), (0, 1, 2), has_aux=True)(q, k, v)
    assert seen == [("cudnn", tq + tq % 2)]
    assert out.shape == (1, tq, D)
    np.testing.assert_allclose(out, ref, atol=1e-5)
    for gr, rg in zip(grads, ref_grads):
        np.testing.assert_allclose(gr, rg, atol=1e-5)


def test_cpu_bf16_encoder_attention_takes_einsum_path():
    q, k, v, _ = _qkvg(256, 256, seed=4)
    args = [jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)]
    out = layers.multi_head_attention(*args, N_HEAD)
    assert out.dtype == jnp.bfloat16 and out.shape == (1, 256, D)
    np.testing.assert_allclose(
        np.asarray(out, np.float32), _ref_attention(q, k, v, N_HEAD),
        atol=3e-2)


@pytest.fixture
def gpu():
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py runs this check "
                    "on the card")


@pytest.mark.gpu
def test_cudnn_encoder_attention_on_card(gpu):
    import chip_smoke
    from whisper_ipa.config import get_config

    chip_smoke.check_encoder_attention(get_config("small"), batch=4)


@pytest.mark.gpu
def test_int8_cross_attention_on_card(gpu):
    import chip_smoke
    from whisper_ipa.config import get_config

    chip_smoke.check_int8_cross_attention(get_config("small"), batch=4)
