"""Port ops (mel front end, resampling, gain, pitch transform) against the
JAX ops on the same numpy inputs.  f32; tolerances 1e-5 relative (1e-4 on
log-mels, whose DFT sums run over 512-1024 terms in another order)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from beatrice_vst_tpu.ops import frontend as JF
from beatrice_vst_tpu.ops import gain as JG
from beatrice_vst_tpu.ops import pitch_math as JPM
from beatrice_vst_tpu.ops import resample as JR
from beatrice_vst_tpu_torch.ops import frontend as PF
from beatrice_vst_tpu_torch.ops import gain as PG
from beatrice_vst_tpu_torch.ops import pitch_math as PPM
from beatrice_vst_tpu_torch.ops import resample as PR

torch.set_num_threads(1)

FRONTENDS = [dict(win=512, n_mels=80), dict(win=1024, n_mels=128, fmax=4000.0)]


@pytest.mark.parametrize("kw", FRONTENDS)
def test_frontend_constants_equal(kw):
    np.testing.assert_array_equal(PF.hann_window(kw["win"]), JF.hann_window(kw["win"]))
    for a, b in zip(PF.real_dft_matrices(kw["win"]), JF.real_dft_matrices(kw["win"])):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(PF.MelFrontend(**kw).consts_np(), JF.MelFrontend(**kw)._consts_np):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kw", FRONTENDS)
@pytest.mark.parametrize("t", [1, 3, 12])
def test_frontend_mel_from_chunk(kw, t):
    rng = np.random.default_rng(t)
    jf, pf = JF.MelFrontend(**kw), PF.MelFrontend(**kw)
    hist = (rng.standard_normal((2, jf.history)) * 0.1).astype(np.float32)
    chunk = (rng.standard_normal((2, t * 160)) * 0.1).astype(np.float32)
    wj, hj = jf.frames_from_chunk(jnp.asarray(hist), jnp.asarray(chunk))
    wp, hp = pf.frames_from_chunk(torch.from_numpy(hist), torch.from_numpy(chunk))
    np.testing.assert_array_equal(wp.numpy(), np.asarray(wj))
    np.testing.assert_array_equal(hp.numpy(), np.asarray(hj))
    np.testing.assert_allclose(pf(wp).numpy(), np.asarray(jf(wj)), rtol=1e-4, atol=1e-4)


def test_compute_simple_fraction():
    for ratio in (1 / 3, 2.0, 44100 / 48000, 22050 / 16000, 0.7071, 3.14159):
        assert PR.compute_simple_fraction(ratio) == JR.compute_simple_fraction(ratio)


@pytest.mark.parametrize("make", ["input_resampler_48k_to_16k",
                                  "output_resampler_24k_to_48k"])
def test_resampler_blocks(make):
    jr, pr = getattr(JR, make)(), getattr(PR, make)()
    w_j, k_j, d_j = JR.design_polyphase(jr.L, jr.M, jr.taps, jr.cutoff)
    w_p, k_p, d_p = PR.design_polyphase(pr.L, pr.M, pr.taps, pr.cutoff)
    np.testing.assert_array_equal(w_p, w_j)
    assert (k_p, d_p) == (k_j, d_j)
    np.testing.assert_array_equal(pr.dense_np(), jr._dense)
    assert pr.history_len == jr.history_len
    rng = np.random.default_rng(5)
    sj = jr.init_state((3,))
    sp = pr.init_state((3,), device="cpu")
    for _ in range(3):
        x = rng.standard_normal((3, jr.in_block)).astype(np.float32)
        yj, sj = jr.apply_block(jnp.asarray(x), sj)
        yp, sp = pr.apply_block(torch.from_numpy(x), sp)
        np.testing.assert_allclose(yp.numpy(), np.asarray(yj), rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(sp.numpy(), np.asarray(sj))


@pytest.mark.parametrize("cur,tgt", [(0.0, 0.0), (0.0, 12.0), (6.0, -60.0),
                                     (-60.0, 20.0), (3.0, 3.5)])
def test_gain_process(cur, tgt):
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 480)).astype(np.float32)
    c = np.full(2, cur, np.float32)
    g = np.full(2, tgt, np.float32)
    yj, dj = JG.gain_process(jnp.asarray(x), jnp.asarray(c), jnp.asarray(g), 48000.0)
    yp, dp = PG.gain_process(torch.from_numpy(x), torch.from_numpy(c), torch.from_numpy(g),
                             48000.0)
    np.testing.assert_allclose(yp.numpy(), np.asarray(yj), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(dp.numpy(), np.asarray(dj), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("ctype", [0, 1])
def test_transform_pitch(ctype):
    rng = np.random.default_rng(7 + ctype)
    n = 64
    q = rng.integers(1, 448, n).astype(np.int32)
    kw = dict(
        average_source_pitch=rng.uniform(30, 300, n).astype(np.float32),
        intonation_intensity=rng.uniform(0.5, 1.5, n).astype(np.float32),
        pitch_shift=rng.uniform(-12, 12, n).astype(np.float32),
        pitch_correction=np.where(rng.random(n) < 0.25, 0.0,
                                  rng.uniform(0, 1, n)).astype(np.float32),
        pitch_correction_type=np.full(n, ctype, np.int32),
    )
    want = np.asarray(JPM.transform_pitch(
        jnp.asarray(q), pitch_bins=448, **{k: jnp.asarray(v) for k, v in kw.items()}))
    got = PPM.transform_pitch(
        torch.from_numpy(q.astype(np.int64)), pitch_bins=448,
        **{k: torch.from_numpy(v.astype(np.int64) if v.dtype == np.int32 else v)
           for k, v in kw.items()}).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("ctype", [0, 1])
@pytest.mark.parametrize("bins", [384, 448])
def test_transform_pitch_soft(ctype, bins):
    """round_output=False (soft pitch): continuous f32 bins from continuous
    inputs, clipped to [1, bins - 1]."""
    rng = np.random.default_rng(17 + ctype)
    n = 64
    q = rng.uniform(0, bins + 20, n).astype(np.float32)
    kw = dict(
        average_source_pitch=rng.uniform(30, 300, n).astype(np.float32),
        intonation_intensity=rng.uniform(0.5, 1.5, n).astype(np.float32),
        pitch_shift=rng.uniform(-12, 12, n).astype(np.float32),
        pitch_correction=np.where(rng.random(n) < 0.25, 0.0,
                                  rng.uniform(0, 1, n)).astype(np.float32),
        pitch_correction_type=np.full(n, ctype, np.int32),
    )
    want = np.asarray(JPM.transform_pitch(
        jnp.asarray(q), pitch_bins=bins, round_output=False,
        **{k: jnp.asarray(v) for k, v in kw.items()}))
    got = PPM.transform_pitch(
        torch.from_numpy(q), pitch_bins=bins, round_output=False,
        **{k: torch.from_numpy(v.astype(np.int64) if v.dtype == np.int32 else v)
           for k, v in kw.items()}).numpy()
    assert got.dtype == np.float32 and got.min() >= 1.0 and got.max() <= bins - 1
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-4)
