"""Port sub-models and chain against the JAX package on the same numpy
inputs and the same random-init weights (f32).  The JAX vocoder runs its
default XLA upsampler (use_pallas_upsampler off); the port's runs the
upsampler head's plain version on the CPU.  Tolerances: 1e-4 on
activations and audio (f32 sums in another order, the harmonic source
through sin/cos of phases up to 2*pi)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from beatrice_vst_tpu.constants import V20RC0
from beatrice_vst_tpu.models import chain as JC
from beatrice_vst_tpu.models import phone_extractor as JPE
from beatrice_vst_tpu.models import pitch_estimator as JPI
from beatrice_vst_tpu.models import waveform_generator as JW
from beatrice_vst_tpu_torch.models import chain as PC
from beatrice_vst_tpu_torch.models import phone_extractor as PPE
from beatrice_vst_tpu_torch.models import pitch_estimator as PPI
from beatrice_vst_tpu_torch.models import waveform_generator as PW
from beatrice_vst_tpu_torch.models.io import params_from_numpy

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)
# jitted once: eager JAX dispatch of the vocoder costs seconds per frame
_jit_wg = jax.jit(JW.apply, static_argnums=(1,))
_jit_chain = jax.jit(JC.apply, static_argnums=(1,))
JCFG = JC.VoiceConverterConfig.for_version(V20RC0)
PCFG = PC.VoiceConverterConfig.for_version(V20RC0)


@pytest.fixture(scope="module")
def params():
    jp = JC.init(jax.random.PRNGKey(0), JCFG)
    return jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")


def _t(x):
    x = np.asarray(x)
    if x.dtype in (np.int32, np.uint32):
        x = x.astype(np.int64)
    return torch.from_numpy(np.array(x))


def _close_tree(got, want, **tol):
    flat_w, _ = jax.tree_util.tree_flatten(want)
    flat_g, _ = jax.tree_util.tree_flatten(got)
    assert len(flat_w) == len(flat_g)
    for g, w in zip(flat_g, flat_w):
        np.testing.assert_allclose(g.numpy(), np.asarray(w).astype(g.numpy().dtype), **tol)


def _random_state(js, rng, scale=0.1):
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray((rng.standard_normal(a.shape) * scale).astype(np.float32))
        if jnp.issubdtype(a.dtype, jnp.floating) else a, js)


def test_phone_extractor(params):
    jp, pp = params
    rng = np.random.default_rng(0)
    js = _random_state(JPE.init_state(JCFG.phone, (3,)), rng)
    ps = jax.tree_util.tree_map(_t, js)
    for _ in range(2):
        audio = (rng.standard_normal((3, 160)) * 0.1).astype(np.float32)
        yj, js = JPE.apply(jp["phone"], JCFG.phone, jnp.asarray(audio), js)
        yp, ps = PPE.apply(pp["phone"], PCFG.phone, torch.from_numpy(audio), ps)
        np.testing.assert_allclose(yp.numpy(), np.asarray(yj), **TOL)
        _close_tree(ps, js, **TOL)


@pytest.mark.parametrize("t", [1, 2])
def test_vq_knn_smooth(t):
    rng = np.random.default_rng(t)
    phone = rng.standard_normal((4, t, 16)).astype(np.float32)
    cb = rng.standard_normal((4, 64, 16)).astype(np.float32)
    n = np.array([0, 1, 4, 8], np.int32)
    want = JPE.vq_knn_smooth(jnp.asarray(phone), jnp.asarray(cb), jnp.asarray(n))
    got = PPE.vq_knn_smooth(torch.from_numpy(phone), torch.from_numpy(cb), _t(n))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_pitch_estimator(params):
    jp, pp = params
    rng = np.random.default_rng(1)
    js = _random_state(JPI.init_state(JCFG.pitch, (4,)), rng)
    ps = jax.tree_util.tree_map(_t, js)
    lo = np.array([1, 1, 100, 200], np.int32)
    hi = np.array([447, 60, 300, 210], np.int32)
    for _ in range(2):
        audio = (rng.standard_normal((4, 160)) * 0.1).astype(np.float32)
        qj, fj, js = JPI.apply(jp["pitch"], JCFG.pitch, jnp.asarray(audio), js,
                               jnp.asarray(lo), jnp.asarray(hi))
        qp, fp, ps = PPI.apply(pp["pitch"], PCFG.pitch, torch.from_numpy(audio), ps,
                               _t(lo), _t(hi))
        np.testing.assert_array_equal(qp.numpy(), np.asarray(qj))
        assert ((qp.numpy() >= lo[:, None]) & (qp.numpy() <= hi[:, None])).all()
        np.testing.assert_allclose(fp.numpy(), np.asarray(fj), **TOL)
        _close_tree(ps, js, **TOL)


def _wg_inputs(rng, b):
    return dict(
        phone=(rng.standard_normal((b, 1, 128))).astype(np.float32),
        qp=rng.integers(50, 400, (b, 1)).astype(np.int32),
        feats=rng.standard_normal((b, 1, 4)).astype(np.float32),
        spk=(rng.standard_normal((b, 256)) * 0.1).astype(np.float32),
        kv=(rng.standard_normal((b, 384, 128)) * 0.1).astype(np.float32),
    )


def test_waveform_generator(params):
    jp, pp = params
    b = 4
    rng = np.random.default_rng(2)
    js = _random_state(JW.init_state(JCFG.wg, (b,)), rng)
    js["phase"] = jnp.asarray(rng.uniform(0, 6.28, b).astype(np.float32))
    js["noise_counter"] = jnp.asarray([0, 5, 2**31, 2**32 - 2], jnp.uint32)
    ps = jax.tree_util.tree_map(_t, js)
    for _ in range(3):
        x = _wg_inputs(rng, b)
        kv_j = JW.project_kv(jp["wg"], JCFG.wg, jnp.asarray(x["kv"]))
        kv_p = PW.project_kv(pp["wg"], torch.from_numpy(x["kv"]))
        _close_tree(kv_p, kv_j, rtol=1e-5, atol=1e-5)
        aj, js = _jit_wg(jp["wg"], JCFG.wg, jnp.asarray(x["phone"]), jnp.asarray(x["qp"]),
                          jnp.asarray(x["feats"]), jnp.asarray(x["spk"]), js,
                          kv_cache=kv_j)
        ap, ps = PW.apply(pp["wg"], PCFG.wg, torch.from_numpy(x["phone"]), _t(x["qp"]),
                          torch.from_numpy(x["feats"]), torch.from_numpy(x["spk"]), ps,
                          kv_p)
        np.testing.assert_allclose(ap.numpy(), np.asarray(aj), **TOL)
        np.testing.assert_array_equal(ps["noise_counter"].numpy(),
                                      np.asarray(js["noise_counter"]).astype(np.int64))
        _close_tree(ps, js, **TOL)


def test_waveform_generator_rejects_chunks(params):
    _, pp = params
    rng = np.random.default_rng(3)
    ps = PW.init_state(PCFG.wg, (1,))
    kv = PW.project_kv(pp["wg"], torch.zeros(1, 384, 128))
    with pytest.raises(ValueError, match="one frame"):
        PW.apply(pp["wg"], PCFG.wg, torch.zeros(1, 2, 128),
                 torch.full((1, 2), 100), torch.zeros(1, 2, 4),
                 torch.from_numpy(rng.standard_normal((1, 256)).astype(np.float32)), ps, kv)


def test_chain_frames(params):
    """Three frames through both chains from zero state, with per-stream
    codebooks, K/V caches and pitch controls."""
    jp, pp = params
    b = 3
    rng = np.random.default_rng(4)
    kv = (rng.standard_normal((b, 384, 128)) * 0.1).astype(np.float32)
    cond_np = dict(
        speaker_embedding=(rng.standard_normal((b, 256)) * 0.1).astype(np.float32),
        codebook=rng.standard_normal((b, 512, 128)).astype(np.float32),
        vq_num_neighbors=np.array([0, 2, 8], np.int32),
        min_q=np.array([1, 1, 50], np.int32),
        max_q=np.array([447, 447, 250], np.int32),
        average_source_pitch=np.array([52.0, 80.0, 52.0], np.float32),
        intonation_intensity=np.array([1.0, 0.8, 1.2], np.float32),
        pitch_shift=np.array([0.0, 3.0, -2.0], np.float32),
        pitch_correction=np.array([0.0, 0.5, 0.9], np.float32),
        pitch_correction_type=np.array([0, 0, 1], np.int32),
    )
    cond_j = {k: jnp.asarray(v) for k, v in cond_np.items()}
    cond_j["kv_cache"] = JW.project_kv(jp["wg"], JCFG.wg, jnp.asarray(kv))
    cond_p = {k: _t(v) for k, v in cond_np.items()}
    cond_p["kv_cache"] = PW.project_kv(pp["wg"], torch.from_numpy(kv))
    js = JC.init_state(JCFG, (b,))
    ps = PC.init_state(PCFG, (b,))
    n = np.arange(3 * 160)
    audio = (0.3 * np.sin(2 * np.pi * 220 * n / 16000)[None]
             + 0.02 * rng.standard_normal((b, n.size))).astype(np.float32)
    for k in range(3):
        x = audio[:, 160 * k:160 * (k + 1)]
        yj, js = _jit_chain(jp, JCFG, jnp.asarray(x), js, cond_j)
        yp, ps = PC.apply(pp, PCFG, torch.from_numpy(x), ps, cond_p)
        np.testing.assert_allclose(yp.numpy(), np.asarray(yj), **TOL)
        _close_tree(ps, js, **TOL)
