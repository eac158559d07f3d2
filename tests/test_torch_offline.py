"""Offline conversion in the port against the JAX package: the resampler's
sub-block and offline forms, `convert_utterance` on klatt8 at 44.1 kHz in
and out (both resamplers fractional), and the golden file of the JAX
package's offline output.

Gates: the resamplers at atol 1e-6 (the same taps summed in another
order); `convert_utterance` f32 and soft pitch at atol 1e-3, the waveform
gate of tests/test_golden.py; bf16 by the envelope of
`beatrice_vst_tpu_torch.golden` against the JAX f32 and bf16 runs; the
port chunked against the port whole at 1e-5 (the same arithmetic, carried
state in between).  Run with -s to see the measured numbers.

`PYTHONPATH=. python tests/test_torch_offline.py` rewrites the golden file
from the JAX package."""

import dataclasses
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from beatrice_vst_tpu.models.io import load_model_dir
from beatrice_vst_tpu.ops import resample as JR
from beatrice_vst_tpu.runtime import offline as JO
from beatrice_vst_tpu_torch import golden
from beatrice_vst_tpu_torch.constants import V20RC0
from beatrice_vst_tpu_torch.errors import BeatriceError
from beatrice_vst_tpu_torch.models import chain as PC
from beatrice_vst_tpu_torch.models.io import load_weights
from beatrice_vst_tpu_torch.ops import resample as PR
from beatrice_vst_tpu_torch.runtime import offline as PO
from beatrice_vst_tpu_torch.speakers import bank as bank_mod

torch.set_num_threads(1)

MODEL_DIR = os.path.join(os.path.dirname(__file__), "..", "models_demo", "klatt8")
GOLDEN = os.path.join(os.path.dirname(__file__), "data", "torch_offline_golden.npz")
RATE = golden.OFFLINE_RATE
# the golden file against a fresh JAX run: XLA's CPU sums differ between
# thread counts
GOLDEN_TOL = 1e-5
RATE_PAIRS = [(48000, 16000), (24000, 48000), (44100, 16000), (24000, 44100),
              (22050, 16000), (16000, 44100), (32000, 24000)]


@pytest.mark.parametrize("rate_in,rate_out", RATE_PAIRS)
def test_rational_rate_ratio(rate_in, rate_out):
    assert PR.rational_rate_ratio(rate_in, rate_out) == JR.rational_rate_ratio(rate_in, rate_out)
    block = PO._block_for(rate_in, rate_out)
    assert block == JO._block_for(rate_in, rate_out)
    pr = PR.make_resampler(rate_in, rate_out, block)
    jr = JR.make_resampler(rate_in, rate_out, block)
    assert (pr.L, pr.M, pr.in_block, pr.cutoff) == (jr.L, jr.M, jr.in_block, jr.cutoff)
    assert pr.delay_in_samples == jr.delay_in_samples
    assert pr.offline_time_offset == jr.offline_time_offset
    assert pr.dense_sub_block() == jr._dense_sub_block()


def test_make_resampler_rejects_a_block_off_the_ratio():
    with pytest.raises(ValueError, match="multiple of 441"):
        PR.make_resampler(44100, 16000, 4096)


@pytest.mark.parametrize("make", ["input_resampler_48k_to_16k",
                                  "output_resampler_24k_to_48k"])
def test_apply_block_in_sub_blocks_at_25_frames(make):
    """At frames_per_tick = 25 each edge's block is cut into sub-blocks of
    1,500 samples sharing one small matrix; the result equals the JAX
    package's."""
    jr, pr = getattr(JR, make)(25), getattr(PR, make)(25)
    assert pr.dense_sub_block() == jr._dense_sub_block() == 1500
    rng = np.random.default_rng(7)
    sj = jr.init_state((3,))
    sp = pr.init_state((3,), device="cpu")
    worst = 0.0
    for _ in range(2):
        x = (rng.standard_normal((3, jr.in_block)) * 0.3).astype(np.float32)
        yj, sj = jr.apply_block(jnp.asarray(x), sj)
        yp, sp = pr.apply_block(torch.from_numpy(x), sp)
        worst = max(worst, float(np.abs(yp.numpy() - np.asarray(yj)).max()))
        np.testing.assert_allclose(yp.numpy(), np.asarray(yj), rtol=0, atol=1e-6)
        np.testing.assert_array_equal(sp.numpy(), np.asarray(sj))
    print(f" {make}(25) max |d| {worst:.3g}", end="")


@pytest.mark.parametrize("rate_in,rate_out,n", [(44100, 16000, 20000), (24000, 44100, 9001),
                                                (48000, 16000, 4801)])
def test_apply_offline(rate_in, rate_out, n):
    rng = np.random.default_rng(n)
    x = (rng.standard_normal((2, n)) * 0.3).astype(np.float32)
    block = PO._block_for(rate_in, rate_out)
    want = np.asarray(JR.make_resampler(rate_in, rate_out, block).apply_offline(jnp.asarray(x)))
    got = PR.make_resampler(rate_in, rate_out, block).apply_offline(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    print(f" max |d| {np.abs(got - want).max():.3g}", end="")
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def klatt8():
    """(JAX config, params and bank, port params, port bank) of klatt8."""
    _, jcfg, jparams, jbank = load_model_dir(MODEL_DIR)
    params = load_weights(os.path.join(MODEL_DIR, "weights.npz"), device="cpu")
    bank = bank_mod.load(os.path.join(MODEL_DIR, "speakers.npz"), V20RC0, device="cpu")
    return jcfg, jparams, jbank, params, bank


PCFG = PC.VoiceConverterConfig.for_version(V20RC0)
# name -> (chunk_frames, JAX compute dtype, port compute dtype, soft pitch)
RUNS = {
    "chunk64_f32": (golden.OFFLINE_CHUNK_FRAMES, None, None, False),
    "whole_f32": (0, None, None, False),
    "whole_bf16": (0, jnp.bfloat16, torch.bfloat16, False),
    "whole_soft_f32": (0, None, None, True),
}


def _jax_run(jcfg, jparams, jbank, name):
    chunk, dtype, _, soft = RUNS[name]
    settings = JO.ConversionSettings(**golden.OFFLINE_SETTINGS, soft_pitch=soft)
    return JO.convert_utterance(jparams, jcfg, jbank, golden.offline_signal(), RATE, settings,
                                compute_dtype=dtype, chunk_frames=chunk)


@pytest.fixture(scope="module")
def runs(klatt8):
    """{name: (JAX output, port output)} of every run in RUNS."""
    jcfg, jparams, jbank, params, bank = klatt8
    out = {}
    for name, (chunk, _, dtype, soft) in RUNS.items():
        settings = PO.ConversionSettings(**golden.OFFLINE_SETTINGS, soft_pitch=soft)
        got = PO.convert_utterance(params, PCFG, bank, golden.offline_signal(), RATE, settings,
                                   compute_dtype=dtype, chunk_frames=chunk, device="cpu")
        out[name] = (_jax_run(jcfg, jparams, jbank, name), got)
    return out


@pytest.mark.parametrize("name", ["chunk64_f32", "whole_f32", "whole_soft_f32"])
def test_convert_utterance_matches_jax(runs, name):
    want, got = runs[name]
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.abs(want).max() > 0.05
    print(f" {name}: max |d| against the JAX package {np.abs(got - want).max():.3g}", end="")
    np.testing.assert_allclose(got, want, rtol=0, atol=golden.F32_ATOL)


def test_convert_utterance_bf16_within_the_envelope(runs):
    env = golden.envelope(runs["whole_bf16"][1],
                          {"f32": runs["whole_f32"][0], "bf16": runs["whole_bf16"][0]})
    print(f"\nbf16: {env}")
    assert env["ok"], env


def test_chunked_equals_whole(runs):
    """Chunks of 64 frames with the state carried between them give the
    whole-utterance output (the same arithmetic in each frame)."""
    chunked, whole = runs["chunk64_f32"][1], runs["whole_f32"][1]
    print(f" max |d| {np.abs(chunked - whole).max():.3g}", end="")
    np.testing.assert_allclose(chunked, whole, rtol=0, atol=1e-5)


def test_golden_file_matches_jax(runs):
    """The committed offline golden file equals a fresh JAX run, up to the
    spread of XLA's CPU sums, and the port's f32 run is held to it."""
    committed = golden.load(GOLDEN)
    assert sorted(committed) == ["f32"]
    assert committed["f32"].dtype == np.float32
    want, got = runs["chunk64_f32"]
    np.testing.assert_allclose(committed["f32"], want, rtol=0, atol=GOLDEN_TOL)
    np.testing.assert_allclose(got, committed["f32"], rtol=0, atol=golden.F32_ATOL)
    assert os.path.getsize(GOLDEN) < 300_000


def test_auto_chunking_and_morph_weights(klatt8):
    """chunk_frames=None chunks beyond 384 frames, as in the JAX package;
    morph weights raise (morphing is not ported)."""
    for n, frames in ((48000, 384), (48001, 384), (100, 1)):
        assert PO.audio_longer_than(np.zeros(n), 48000, frames) == \
            JO.audio_longer_than(np.zeros(n), 48000, frames)
    params, bank = klatt8[3:]
    settings = dataclasses.replace(PO.ConversionSettings(), morph_weights=np.ones(8, np.float32))
    with pytest.raises(BeatriceError, match="SPEAKER_ID_OUT_OF_RANGE"):
        PO.convert_utterance(params, PCFG, bank, np.zeros(1600, np.float32), 16000, settings,
                             device="cpu")
    with pytest.raises(BeatriceError, match="SPEAKER_ID_OUT_OF_RANGE"):
        PO.convert_utterance(params, PCFG, bank, np.zeros(1600, np.float32), 16000,
                             PO.ConversionSettings(target_speaker=8), device="cpu")


if __name__ == "__main__":
    _, jcfg, jparams, jbank = load_model_dir(MODEL_DIR)
    os.makedirs(os.path.dirname(GOLDEN), exist_ok=True)
    np.savez_compressed(GOLDEN, f32=_jax_run(jcfg, jparams, jbank, "chunk64_f32"))
    print(f"wrote {GOLDEN} ({os.path.getsize(GOLDEN)} bytes)")
