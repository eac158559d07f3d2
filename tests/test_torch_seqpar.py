"""The port's sequence-parallel offline conversion
(`beatrice_vst_tpu_torch/runtime/seqpar.py`) against its sequential
conversion, the float64 oracle and the JAX package's, on the CPU; mirrors
tests/test_seqpar.py.

Gates: segmented against sequential at 2e-5 (f32 round-off of the same
arithmetic in other batch shapes and of the boundary phase: the JAX
package's own seqpar is 1.2e-5 from its sequential conversion on these
parameters, 7.1e-5 with soft pitch), one segment at 2e-5; the float64
oracle with tests/test_seqpar.py's gate (1.5e-3, 99.99 % of samples
within 1e-3); the JAX package's `convert_utterance_sp` on klatt8, the
golden file and `cli convert --seq-parallel 4` against the JAX CLI at
1e-3.  Run with -s to see the measured numbers.

`PYTHONPATH=. python tests/test_torch_seqpar.py` rewrites
tests/data/torch_seqpar_golden.npz from the JAX package."""

import os

import numpy as np
import jax
import pytest
import torch

from beatrice_vst_tpu import cli as JCLI
from beatrice_vst_tpu.constants import V20RC0 as JV20RC0
from beatrice_vst_tpu.models import chain as JC
from beatrice_vst_tpu.models.io import load_model_dir
from beatrice_vst_tpu.models.phone_extractor import PhoneExtractorConfig as JPhone
from beatrice_vst_tpu.models.pitch_estimator import PitchEstimatorConfig as JPitch
from beatrice_vst_tpu.runtime import offline as JO
from beatrice_vst_tpu.runtime import seqpar as JS
from beatrice_vst_tpu.speakers import bank as jbank_mod
from beatrice_vst_tpu_torch import cli as PCLI
from beatrice_vst_tpu_torch import golden
from beatrice_vst_tpu_torch.audio_io import read_wav, write_wav
from beatrice_vst_tpu_torch.constants import V20RC0
from beatrice_vst_tpu_torch.models import chain as PC
from beatrice_vst_tpu_torch.models.phone_extractor import PhoneExtractorConfig
from beatrice_vst_tpu_torch.models.pitch_estimator import PitchEstimatorConfig
from beatrice_vst_tpu_torch.runtime.offline import ConversionSettings, convert_utterance
from beatrice_vst_tpu_torch.runtime.seqpar import (chain_receptive_field_frames,
                                                   convert_utterance_sp)

torch.set_num_threads(1)

MODEL_DIR = os.path.join(os.path.dirname(__file__), "..", "models_demo", "klatt8")
GOLDEN = os.path.join(os.path.dirname(__file__), "data", "torch_seqpar_golden.npz")
SEQ_ATOL = 2e-5


def _shallow(phone_cls, pitch_cls, chain_mod):
    return chain_mod.VoiceConverterConfig(
        spec=V20RC0, phone=phone_cls(phone_channels=V20RC0.phone_channels, dilations=(1, 2)),
        pitch=pitch_cls(pitch_bins=V20RC0.pitch_bins, dilations=(1, 2)))


@pytest.fixture(scope="module")
def model():
    """The shallow configuration of tests/test_seqpar.py (receptive field
    29 frames) with the JAX package's parameters and bank."""
    jcfg = _shallow(JPhone, JPitch, JC)
    params = JC.init(jax.random.PRNGKey(0), jcfg)
    bank = jbank_mod.random_bank(jax.random.PRNGKey(1), JV20RC0, 4)
    return _shallow(PhoneExtractorConfig, PitchEstimatorConfig, PC), params, bank, jcfg


def _utterance(n_frames, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n_frames * 160) / 16000.0
    x = 0.3 * np.sin(2 * np.pi * 150 * t) * (1 + 0.3 * np.sin(2 * np.pi * 3 * t))
    return (x + 0.02 * rng.standard_normal(x.size)).astype(np.float32)


def test_receptive_field_matches_jax(model):
    cfg, _, _, jcfg = model
    assert chain_receptive_field_frames(cfg) == JS.chain_receptive_field_frames(jcfg) == 29
    full = PC.VoiceConverterConfig.for_version(V20RC0)
    want = JS.chain_receptive_field_frames(JC.VoiceConverterConfig.for_version(JV20RC0))
    assert chain_receptive_field_frames(full) == want and 60 < want < 120


@pytest.mark.parametrize("soft", [False, True])
def test_seqpar_matches_sequential(model, soft):
    """96 frames, n_segments=4 capped to 3 (f = 32); the joins too."""
    cfg, params, bank, _ = model
    settings = ConversionSettings(target_speaker=1, pitch_shift=2.0 if soft else 3.0,
                                  vq_num_neighbors=0 if soft else 2, soft_pitch=soft)
    audio = _utterance(96, seed=3 if soft else 0)
    ref = convert_utterance(params, cfg, bank, audio, 16000, settings, chunk_frames=0,
                            device="cpu")
    sp = convert_utterance_sp(params, cfg, bank, audio, 16000, settings, n_segments=4,
                              device="cpu")
    assert sp.shape == ref.shape and np.abs(ref).max() > 0.05
    print(f" max |d| {np.abs(sp - ref).max():.3g}", end="")
    assert np.abs(sp - ref).max() <= SEQ_ATOL
    for b in (32, 64):
        lo, hi = b * 240 - 480, b * 240 + 480
        assert np.abs(sp[lo:hi] - ref[lo:hi]).max() <= SEQ_ATOL


def test_short_warmup_is_inexact(model):
    cfg, params, bank, _ = model
    audio = _utterance(96, seed=5)
    ref = convert_utterance(params, cfg, bank, audio, 16000, chunk_frames=0, device="cpu")
    sp = convert_utterance_sp(params, cfg, bank, audio, 16000, n_segments=4, warmup_frames=2,
                              device="cpu")
    assert np.abs(sp - ref).max() > 1e-3


def test_single_segment_is_sequential(model):
    cfg, params, bank, _ = model
    audio = _utterance(40, seed=7)
    ref = convert_utterance(params, cfg, bank, audio, 16000, chunk_frames=0, device="cpu")
    sp = convert_utterance_sp(params, cfg, bank, audio, 16000, n_segments=1, device="cpu")
    np.testing.assert_allclose(sp, ref, rtol=0, atol=SEQ_ATOL)


def test_seqpar_matches_float64_oracle():
    """The full 2.0.0-rc.0 configuration, 288 frames in three segments,
    against the JAX package's float64 NumPy oracle (reference_impl)."""
    from beatrice_vst_tpu import reference_impl as oref

    jcfg = JC.VoiceConverterConfig.for_version(JV20RC0)
    params = JC.init(jax.random.PRNGKey(0), jcfg)
    bank = jbank_mod.random_bank(jax.random.PRNGKey(1), JV20RC0, 4)
    audio = _utterance(288, seed=11)
    settings = ConversionSettings(target_speaker=2, pitch_shift=3.0, vq_num_neighbors=2)
    sp = convert_utterance_sp(params, PC.VoiceConverterConfig.for_version(V20RC0), bank, audio,
                              16000, settings, n_segments=4, out_sample_rate=24000, device="cpu")
    bank_np = {k: np.asarray(v) for k, v in bank.items()}
    bins = V20RC0.pitch_bins

    def q(midi):
        return int(np.clip(round((np.clip(midi, 0, 128) - 33.0) * 8.0), 1, bins - 1))

    eff = {"speaker_embedding": bank_np["additive"][2] + bank_np["formant"][4],
           "kv": bank_np["kv"][2], "codebook": bank_np["codebook"][2], "vq_num_neighbors": 2,
           "pitch_shift": 3.0, "min_q": q(settings.min_source_pitch),
           "max_q": q(settings.max_source_pitch)}
    want = oref.chain_forward(params, jcfg, audio, target_settings=eff)
    assert sp.shape == want.shape
    diff = np.abs(sp - want)
    print(f" max |d| {diff.max():.3g}", end="")
    assert diff.max() < 1.5e-3 and np.mean(diff < 1e-3) > 0.9999


def _jax_golden_run():
    _, jcfg, jparams, jbank = load_model_dir(MODEL_DIR)
    return JS.convert_utterance_sp(jparams, jcfg, jbank, golden.offline_signal(),
                                   golden.OFFLINE_RATE,
                                   JO.ConversionSettings(**golden.OFFLINE_SETTINGS),
                                   n_segments=golden.SEQPAR_SEGMENTS)


def test_klatt8_matches_jax_and_the_golden_file():
    """klatt8 at 44.1 kHz in and out (both resamplers fractional): the
    port's segmented conversion against the JAX package's, fresh and
    committed (the committed file against a fresh JAX run at 1e-5)."""
    _, _, params, bank = load_model_dir(MODEL_DIR)
    want = _jax_golden_run()
    got = convert_utterance_sp(params, PC.VoiceConverterConfig.for_version(V20RC0), bank, golden.offline_signal(), golden.OFFLINE_RATE,
                               ConversionSettings(**golden.OFFLINE_SETTINGS),
                               n_segments=golden.SEQPAR_SEGMENTS, device="cpu")
    committed = golden.load(GOLDEN)
    assert sorted(committed) == ["f32"] and committed["f32"].dtype == np.float32
    np.testing.assert_allclose(committed["f32"], want, rtol=0, atol=1e-5)
    assert got.shape == want.shape
    print(f" max |d| against JAX {np.abs(got - want).max():.3g}", end="")
    np.testing.assert_allclose(got, want, rtol=0, atol=golden.F32_ATOL)
    assert os.path.getsize(GOLDEN) < 300_000


def test_cli_convert_seq_parallel_matches_the_jax_cli(tmp_path, capsys):
    audio = golden.offline_signal(seconds=1.2, rate=22050)
    src = str(tmp_path / "in.wav")
    write_wav(src, audio, 22050)
    outs = {}
    for name, main in (("port", PCLI.main), ("jax", JCLI.main)):
        dst = str(tmp_path / f"{name}.wav")
        argv = ["convert", src, dst, "--model", MODEL_DIR, "--voice", "5", "--pitch-shift",
                "-2", "--seq-parallel", "4"]
        main(argv + (["--device", "cpu"] if name == "port" else []))
        outs[name], rate = read_wav(dst)
        assert rate == 22050
    assert "converted" in capsys.readouterr().out
    assert outs["port"].shape == outs["jax"].shape
    assert abs(len(outs["port"]) - len(audio)) < 22050 * 0.01  # the last frame's resampler tail
    np.testing.assert_allclose(outs["port"], outs["jax"], rtol=0, atol=golden.F32_ATOL)


if __name__ == "__main__":
    os.makedirs(os.path.dirname(GOLDEN), exist_ok=True)
    np.savez_compressed(GOLDEN, f32=_jax_golden_run())
    print(f"wrote {GOLDEN} ({os.path.getsize(GOLDEN)} bytes)")
