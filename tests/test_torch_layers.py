"""Port layers (beatrice_vst_tpu_torch/models/layers.py) against the JAX
layers on the same numpy inputs.  f32 on both sides; tolerance 1e-5 (sums
are taken in another order), hash_noise bit-exact."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from beatrice_vst_tpu.models import layers as J
from beatrice_vst_tpu_torch.models import layers as P
from beatrice_vst_tpu_torch.models.io import params_from_numpy

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)


def _tp(tree):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, tree), "cpu")


def _x(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def test_linear_and_layer_norm():
    rng = np.random.default_rng(0)
    p = J.linear_init(jax.random.PRNGKey(0), 48, 24)
    p["b"] = jnp.asarray(_x(rng, 24))
    x = _x(rng, 3, 2, 48)
    np.testing.assert_allclose(P.linear(_tp(p), torch.from_numpy(x)).numpy(),
                               np.asarray(J.linear(p, jnp.asarray(x))), **TOL)
    ln = {"g": jnp.asarray(_x(rng, 48)), "b": jnp.asarray(_x(rng, 48))}
    np.testing.assert_allclose(P.layer_norm(_tp(ln), torch.from_numpy(x * 3 + 1)).numpy(),
                               np.asarray(J.layer_norm(ln, jnp.asarray(x * 3 + 1))), **TOL)


@pytest.mark.parametrize("dilation", [1, 2, 4, 8])
@pytest.mark.parametrize("t", [1, 3, 12])
def test_causal_conv(dilation, t):
    rng = np.random.default_rng(dilation * 10 + t)
    p = J.causal_conv_init(jax.random.PRNGKey(dilation), 4, 32, 16)
    p["b"] = jnp.asarray(_x(rng, 16))
    x = _x(rng, 2, t, 32)
    s = _x(rng, 2, 3 * dilation, 32)
    yj, sj = J.causal_conv(p, jnp.asarray(x), jnp.asarray(s), dilation)
    yp, sp = P.causal_conv(_tp(p), torch.from_numpy(x), torch.from_numpy(s), dilation)
    np.testing.assert_allclose(yp.numpy(), np.asarray(yj), **TOL)
    np.testing.assert_array_equal(sp.numpy(), np.asarray(sj))


@pytest.mark.parametrize("dilation", [1, 8])
def test_conv_block(dilation):
    rng = np.random.default_rng(dilation)
    p = J.conv_block_init(jax.random.PRNGKey(dilation), 64, 4, dilation)
    x = _x(rng, 3, 1, 64)
    s = _x(rng, 3, 3 * dilation, 64)
    yj, sj = J.conv_block(p, jnp.asarray(x), jnp.asarray(s), dilation)
    yp, sp = P.conv_block(_tp(p), torch.from_numpy(x), torch.from_numpy(s), dilation)
    np.testing.assert_allclose(yp.numpy(), np.asarray(yj), **TOL)
    # the carry holds the layer-normed input: equal up to rounding
    np.testing.assert_allclose(sp.numpy(), np.asarray(sj), **TOL)


@pytest.mark.parametrize("dilation", [1, 2, 4, 8])
def test_conv_block_chunk(dilation):
    """A chunk of 12 frames (the offline and frames_per_tick > 1 path)
    through one call, from a nonzero carry."""
    rng = np.random.default_rng(20 + dilation)
    p = J.conv_block_init(jax.random.PRNGKey(dilation), 64, 4, dilation)
    x = _x(rng, 3, 12, 64)
    s = _x(rng, 3, 3 * dilation, 64)
    yj, sj = J.conv_block(p, jnp.asarray(x), jnp.asarray(s), dilation)
    yp, sp = P.conv_block(_tp(p), torch.from_numpy(x), torch.from_numpy(s), dilation)
    np.testing.assert_allclose(yp.numpy(), np.asarray(yj), **TOL)
    np.testing.assert_allclose(sp.numpy(), np.asarray(sj), **TOL)


def test_cross_attention_cached():
    rng = np.random.default_rng(3)
    p = J.cross_attention_init(jax.random.PRNGKey(3), 64, 32, 16)
    kv = _x(rng, 2, 48, 32)
    x = _x(rng, 2, 1, 64)
    kj, vj = J.cross_attention_project_kv(p, jnp.asarray(kv))
    kp, vp = P.cross_attention_project_kv(_tp(p), torch.from_numpy(kv))
    np.testing.assert_allclose(kp.numpy(), np.asarray(kj), **TOL)
    np.testing.assert_allclose(vp.numpy(), np.asarray(vj), **TOL)
    want = J.cross_attention_cached(p, jnp.asarray(x), kj, vj)
    got = P.cross_attention_cached(_tp(p), torch.from_numpy(x), kp, vp)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_snake():
    rng = np.random.default_rng(4)
    p = {"log_alpha": jnp.asarray(_x(rng, 16, scale=0.5))}
    x = _x(rng, 5, 7, 16, scale=3.0)
    np.testing.assert_allclose(P.snake(_tp(p), torch.from_numpy(x)).numpy(),
                               np.asarray(J.snake(p, jnp.asarray(x))), **TOL)


@pytest.mark.parametrize("salt", [0x5EED, 0x5EED + 3 * 0x2545F491, 0x10777E])
def test_hash_noise_bit_exact(salt):
    counters = np.array([0, 1, 7, 12345, 2**31 - 1, 2**31, 2**32 - 2, 2**32 - 1],
                        np.uint32)
    want = np.asarray(J.hash_noise(jnp.asarray(counters), 240, salt))
    got = P.hash_noise(torch.from_numpy(counters.astype(np.int64)), 240, salt).numpy()
    np.testing.assert_array_equal(got, want)
    # [B, T] counters, as the vocoder passes them
    c2 = counters.reshape(4, 2)
    want2 = np.asarray(J.hash_noise(jnp.asarray(c2), 20, salt))
    got2 = P.hash_noise(torch.from_numpy(c2.astype(np.int64)), 20, salt).numpy()
    np.testing.assert_array_equal(got2, want2)


# ---- compute dtype, int8 and the slot bank ----

BF16 = dict(j=jnp.bfloat16, p=torch.bfloat16)


def _np(x):
    """A JAX or torch array as f64 numpy (bf16 widened exactly)."""
    if isinstance(x, torch.Tensor):
        return x.double().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32), np.float64)


def _assert_bf16_ulps(got, want, ulps=1, scale=None):
    """got within `ulps` bf16 units in the last place of |want| (or of
    `scale`, for a sum whose terms are larger than its result; bf16 keeps 8
    significant bits: its ulp is f32's spacing times 2^16)."""
    g, w = _np(got), _np(want)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    scale = np.abs(w) if scale is None else scale
    spacing = np.spacing(scale.astype(np.float32)).astype(np.float64) * 2.0**16
    print(f" max {np.max(np.abs(g - w) / spacing):.3g} bf16 ulps (gate {ulps})", end="")
    bad = np.abs(g - w) > ulps * spacing
    assert not bad.any(), f"{bad.sum()} of {bad.size} beyond {ulps} bf16 ulp: max |d| " \
                          f"{np.abs(g - w).max():.3g}"


def test_linear_bf16_rounds_once():
    """bf16 operands, f32 sums, bias added in f32, one rounding: within 1
    bf16 ulp of JAX (a second rounding after the bias would not be); the
    f32-emitting form (pitch logits) at 1e-5."""
    rng = np.random.default_rng(10)
    p = J.linear_init(jax.random.PRNGKey(10), 256, 192)
    p["b"] = jnp.asarray(_x(rng, 192))
    x = _x(rng, 4, 1, 256)
    want = J.linear(p, jnp.asarray(x), BF16["j"])
    got = P.linear(_tp(p), torch.from_numpy(x), BF16["p"])
    _assert_bf16_ulps(got, want)
    want32 = J.linear(p, jnp.asarray(x), BF16["j"], out_dtype=jnp.float32)
    got32 = P.linear(_tp(p), torch.from_numpy(x), BF16["p"], out_dtype=torch.float32)
    np.testing.assert_allclose(got32.numpy(), np.asarray(want32), **TOL)


@pytest.mark.parametrize("dilation", [1, 4])
def test_causal_conv_bf16(dilation):
    """bf16 causal conv within 1 bf16 ulp; the bf16 carry bit-equal."""
    rng = np.random.default_rng(20 + dilation)
    p = J.causal_conv_init(jax.random.PRNGKey(dilation), 4, 64, 32)
    p["b"] = jnp.asarray(_x(rng, 32))
    x = jnp.asarray(_x(rng, 3, 1, 64)).astype(jnp.bfloat16)
    s = jnp.asarray(_x(rng, 3, 3 * dilation, 64)).astype(jnp.bfloat16)
    yj, sj = J.causal_conv(p, x, s, dilation, BF16["j"])
    yp, sp = P.causal_conv(_tp(p), _bf16(x), _bf16(s), dilation, BF16["p"])
    _assert_bf16_ulps(yp, yj)
    np.testing.assert_array_equal(_np(sp), _np(sj))


def _bf16(x):
    return torch.from_numpy(np.array(jnp.asarray(x, jnp.float32))).to(torch.bfloat16)


def _from_jax(a):
    """A JAX array (int8 or f32) as a torch tensor."""
    return torch.from_numpy(np.array(a))


def _gelu_rounded_once(x):
    """jax.nn.gelu in f32, rounded once to x's dtype (as torch's bf16 GELU
    is; JAX's bf16 GELU rounds each of its steps to bf16 on the CPU, up to
    12 bf16 ulps away from this)."""
    return _JAX_GELU(x.astype(jnp.float32)).astype(x.dtype)


_JAX_GELU = jax.nn.gelu


@pytest.mark.parametrize("dilation", [1, 8])
def test_conv_block_bf16(dilation, monkeypatch):
    """A bf16 block (layer norm in f32, bf16 conv and MLP, bf16 residual
    y = x + h): with JAX's GELU rounded once, as the port's is, output and
    carry within 1 bf16 ulp of JAX, the output's ulp taken at |x| + |y|
    (the residual's terms can be larger than its sum); against JAX's own
    bf16 GELU, within 4 such ulps."""
    rng = np.random.default_rng(30 + dilation)
    p = J.conv_block_init(jax.random.PRNGKey(dilation), 64, 4, dilation)
    x = jnp.asarray(_x(rng, 3, 1, 64)).astype(jnp.bfloat16)
    s = jnp.asarray(_x(rng, 3, 3 * dilation, 64)).astype(jnp.bfloat16)
    yp, sp = P.conv_block(_tp(p), _bf16(x), _bf16(s), dilation, BF16["p"])
    yj, sj = J.conv_block(p, x, s, dilation, BF16["j"])
    terms = np.abs(_np(x)) + np.abs(_np(yj))
    _assert_bf16_ulps(yp, yj, ulps=4, scale=terms)
    monkeypatch.setattr(jax.nn, "gelu", _gelu_rounded_once)
    yj, sj = J.conv_block(p, x, s, dilation, BF16["j"])
    _assert_bf16_ulps(yp, yj, scale=np.abs(_np(x)) + np.abs(_np(yj)))
    _assert_bf16_ulps(sp, sj)


def test_quantize_rows():
    """int8 bit-equal, scales at rtol 1e-6."""
    rng = np.random.default_rng(40)
    x = _x(rng, 5, 7, 64, scale=2.0)
    x[1, 2] = 0.0  # an all-zero row takes the scale floor
    qj, sj = J.quantize_rows(jnp.asarray(x))
    qp, sp = P.quantize_rows(torch.from_numpy(x))
    assert qp.dtype == torch.int8 and sp.shape == (5, 7, 1)
    np.testing.assert_array_equal(qp.numpy(), np.asarray(qj))
    np.testing.assert_allclose(sp.numpy(), np.asarray(sj), rtol=1e-6, atol=0)


def _slot_inputs(seed, b=5, z=6, l=48, a=16, h=64):
    rng = np.random.default_rng(seed)
    p = J.cross_attention_init(jax.random.PRNGKey(seed), h, 32, a)
    x = _x(rng, b, 1, h)
    k = _x(rng, z, l, a)
    v = _x(rng, z, l, a)
    slot = rng.integers(0, z, b)
    onehot = np.eye(z, dtype=np.float32)[slot]
    return p, x, k, v, onehot


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_cross_attention_slots(dtype):
    """f32 at atol 1e-5; bf16 within 1 bf16 ulp of JAX."""
    p, x, k, v, onehot = _slot_inputs(50)
    cd = BF16 if dtype == "bf16" else dict(j=None, p=None)
    xj = jnp.asarray(x) if cd["j"] is None else jnp.asarray(x).astype(cd["j"])
    want = J.cross_attention_slots(p, xj, jnp.asarray(k), jnp.asarray(v),
                                   jnp.asarray(onehot), cd["j"])
    xp = torch.from_numpy(x) if cd["p"] is None else _bf16(xj)
    got = P.cross_attention_slots(_tp(p), xp, torch.from_numpy(k), torch.from_numpy(v),
                                  torch.from_numpy(onehot), cd["p"])
    if dtype == "bf16":
        _assert_bf16_ulps(got, want)
    else:
        print(f" max |d| {np.abs(got.numpy() - np.asarray(want)).max():.3g}", end="")
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        # the same as attending to each stream's gathered slot
        slot = onehot.argmax(-1)
        kp, vp = torch.from_numpy(k[slot]), torch.from_numpy(v[slot])
        gathered = P.cross_attention_cached(_tp(p), torch.from_numpy(x), kp, vp)
        np.testing.assert_allclose(got.numpy(), gathered.numpy(), **TOL)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_cross_attention_slots_q8(dtype):
    """The same int8 slot bank and scales into both: f32 at atol 1e-5, bf16
    within 1 bf16 ulp of JAX."""
    p, x, k, v, onehot = _slot_inputs(60)
    kq, ks = J.quantize_rows(jnp.asarray(k))
    vq, vs = J.quantize_rows(jnp.asarray(v))
    cd = BF16 if dtype == "bf16" else dict(j=None, p=None)
    xj = jnp.asarray(x) if cd["j"] is None else jnp.asarray(x).astype(cd["j"])
    want = J.cross_attention_slots_q8(p, xj, kq, ks, vq, vs, jnp.asarray(onehot), cd["j"])
    xp = torch.from_numpy(x) if cd["p"] is None else _bf16(xj)
    kv8 = [_from_jax(a) for a in (kq, ks, vq, vs)]
    got = P.cross_attention_slots_q8(_tp(p), xp, *kv8, torch.from_numpy(onehot), cd["p"])
    if dtype == "bf16":
        _assert_bf16_ulps(got, want)
    else:
        print(f" max |d| {np.abs(got.numpy() - np.asarray(want)).max():.3g}", end="")
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("quantized", [False, True])
def test_cross_attention_cached_bf16(quantized):
    """Per-stream K/V under a compute dtype, bf16 or int8 with scales (the
    same int8 inputs into both): within 1 bf16 ulp of JAX."""
    p, x, k, v, onehot = _slot_inputs(70)
    slot = onehot.argmax(-1)
    kb, vb = jnp.asarray(k[slot]), jnp.asarray(v[slot])
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    if quantized:
        (kq, ks), (vq, vs) = J.quantize_rows(kb), J.quantize_rows(vb)
        want = J.cross_attention_cached_q(p, xj, kq, ks, vq, vs, jnp.bfloat16)
        kv8 = [_from_jax(a) for a in (kq, ks, vq, vs)]
        got = P.cross_attention_cached_q(_tp(p), _bf16(xj), *kv8, torch.bfloat16)
    else:
        want = J.cross_attention_cached(p, xj, kb.astype(jnp.bfloat16),
                                        vb.astype(jnp.bfloat16), jnp.bfloat16)
        got = P.cross_attention_cached(_tp(p), _bf16(xj), _bf16(kb), _bf16(vb), torch.bfloat16)
    _assert_bf16_ulps(got, want)


def test_snake_bf16():
    """f32 inside, rounded once to bf16: within 1 bf16 ulp."""
    rng = np.random.default_rng(80)
    p = {"log_alpha": jnp.asarray(_x(rng, 16, scale=0.5))}
    x = jnp.asarray(_x(rng, 5, 7, 16, scale=3.0)).astype(jnp.bfloat16)
    _assert_bf16_ulps(P.snake(_tp(p), _bf16(x)), J.snake(p, x))
