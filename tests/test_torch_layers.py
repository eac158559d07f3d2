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
@pytest.mark.parametrize("t", [1, 3])
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
