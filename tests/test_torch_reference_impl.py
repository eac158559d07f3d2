"""The port's copy of the float64 oracle (`beatrice_vst_tpu_torch/reference_impl.py`)
against the JAX package's (`beatrice_vst_tpu/reference_impl.py`): exactly
equal (`np.array_equal`) on seeded inputs, one case per function, the
chain for each model version with the argmax and with soft pitch.  Both
are NumPy; the parameters are the port's `chain.init` from a seeded CPU
generator, as numpy arrays, and each oracle reads its own package's
model configuration."""

import ast
import os

import numpy as np
import pytest
import torch

from beatrice_vst_tpu import reference_impl as jref
from beatrice_vst_tpu.constants import VERSIONS as JVERSIONS
from beatrice_vst_tpu.models.chain import VoiceConverterConfig as JConfig
from beatrice_vst_tpu_torch import reference_impl as pref
from beatrice_vst_tpu_torch.constants import VERSIONS
from beatrice_vst_tpu_torch.models import chain as PC

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAMES = 12
RC0 = "2.0.0-rc.0"


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_numpy(v) for v in tree]
    return tree.numpy()


def _model(version, seed=0):
    """(the port's config, the JAX package's, numpy parameters)."""
    pcfg = PC.VoiceConverterConfig.for_version(VERSIONS[version])
    params = _numpy(PC.init(torch.Generator().manual_seed(seed), pcfg, "cpu"))
    return pcfg, JConfig.for_version(JVERSIONS[version]), params


def _audio(rng, frames=FRAMES):
    n = np.arange(frames * 160) / 16000
    return (0.3 * np.sin(2 * np.pi * (180 * n + 300 * n * n))
            + 0.02 * rng.standard_normal(n.size))


def _settings(rng, spec, soft):
    s = {"speaker_embedding": 0.1 * rng.standard_normal(256), "vq_num_neighbors": 4,
         "min_q": 1, "max_q": 383, "average_source_pitch": 52.0, "intonation_intensity": 1.2,
         "pitch_shift": 3.0, "pitch_correction": 0.0 if soft else 0.5,
         "pitch_correction_type": 1}
    if spec.has_kv:
        s["kv"] = 0.1 * rng.standard_normal((spec.kv_length, spec.kv_channels))
    if spec.has_vq:
        s["codebook"] = rng.standard_normal((64, 128))
    return s


def _same(got, want):
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
    elif want is None:
        assert got is None
    else:
        got, want = np.asarray(got), np.asarray(want)
        assert got.dtype == want.dtype and got.shape == want.shape
        assert np.array_equal(got, want)


@pytest.mark.parametrize("soft", [False, True], ids=["argmax", "soft"])
@pytest.mark.parametrize("version", sorted(VERSIONS))
def test_chain_forward_equals_the_jax_oracle(version, soft):
    pcfg, jcfg, params = _model(version)
    rng = np.random.default_rng(1)
    audio, settings = _audio(rng), _settings(rng, pcfg.spec, soft)
    got = pref.chain_forward(params, pcfg, audio, target_settings=settings, soft_pitch=soft)
    want = jref.chain_forward(params, jcfg, audio, target_settings=settings, soft_pitch=soft)
    assert want.shape == (FRAMES * 240,) and np.abs(want).max() > 1e-3
    _same(got, want)


def test_chain_forward_with_a_phase_trajectory_and_a_codebook_per_frame():
    """The harness hooks: a given phase trajectory and the lottery route."""
    pcfg, jcfg, params = _model(RC0, seed=2)
    rng = np.random.default_rng(2)
    audio, settings = _audio(rng), _settings(rng, pcfg.spec, False)
    settings["codebook_bank"] = rng.standard_normal((3, 64, 128))
    settings["codebook_idx"] = rng.integers(0, 3, FRAMES)
    start = np.mod(np.cumsum(rng.uniform(0, 12, FRAMES)), 2 * np.pi).astype(np.float32)
    got, want = (ref.chain_forward(params, cfg, audio, target_settings=settings,
                                   phase_start=start)
                 for ref, cfg in ((pref, pcfg), (jref, jcfg)))
    _same(got, want)


def _stage_cases():
    """name -> fn(ref, pcfg or jcfg, params, rng): one call of an oracle
    function on inputs drawn from rng."""
    def blk(p, i=0):
        return p["phone"]["blocks"][i]

    return {
        "gelu": lambda r, c, p, g: r.gelu(g.standard_normal(50) * 3),
        "layer_norm": lambda r, c, p, g: r.layer_norm(
            r._np(blk(p)["ln"]), g.standard_normal((5, 256))),
        "linear": lambda r, c, p, g: r.linear(r._np(p["phone"]["prenet"]),
                                              g.standard_normal((5, 80))),
        "causal_conv": lambda r, c, p, g: r.causal_conv(
            r._np(p["wg"]["up"][0]["conv"]), g.standard_normal((6, 256)), 1),
        "conv_block": lambda r, c, p, g: r.conv_block(
            r._np(blk(p, 2)), g.standard_normal((9, 256)), 4),
        "cross_attention": lambda r, c, p, g: r.cross_attention(
            r._np(p["wg"]["blocks"][0]["attn"]), g.standard_normal((4, 256)),
            0.1 * g.standard_normal((384, 128))),
        "snake": lambda r, c, p, g: r.snake(r._np(p["wg"]["up"][1]["snake"]),
                                            g.standard_normal((7, 64))),
        "hash_noise": lambda r, c, p, g: r.hash_noise(
            g.integers(0, 2**32, 10, dtype=np.uint64).astype(np.uint32), 80, 0x1234567),
        "logmel": lambda r, c, p, g: r.logmel(_audio(g), 1024, 80, 4000.0),
        "phone_forward": lambda r, c, p, g: r.phone_forward(r._np(p["phone"]), c, _audio(g)),
        "pitch_forward": lambda r, c, p, g: r.pitch_forward(r._np(p["pitch"]), c, _audio(g),
                                                            20, 300),
        "pitch_forward_soft": lambda r, c, p, g: r.pitch_forward(
            r._np(p["pitch"]), c, _audio(g), 1, None, soft=True),
        "vq_knn": lambda r, c, p, g: r.vq_knn(g.standard_normal((8, 128)),
                                              g.standard_normal((64, 128)), 5),
        "vq_knn_per_frame": lambda r, c, p, g: r.vq_knn_per_frame(
            g.standard_normal((8, 128)), g.standard_normal((3, 64, 128)),
            g.integers(0, 3, 8), 3),
        "transform_pitch": lambda r, c, p, g: [
            r.transform_pitch(g.integers(1, 447, 30), 52.0, inton, shift, corr, ctype, 448,
                              round_output=rnd)
            for inton, shift, corr, ctype, rnd in (
                (1.0, 0.0, 0.0, 0, True), (1.3, 5.0, 0.6, 0, True),
                (0.7, -4.0, 0.4, 1, False), (1.0, 2.5, 1.0, 1, True))],
        "waveform_forward": lambda r, c, p, g: r.waveform_forward(
            r._np(p["wg"]), c, g.standard_normal((6, 128)), g.integers(100, 300, 6),
            g.standard_normal((6, 4)), 0.1 * g.standard_normal(256),
            0.1 * g.standard_normal((384, 128))),
        "morph_voice_weights": lambda r, c, p, g: [
            r.morph_voice_weights(0.3, -0.2, falloff, [0, 3, 3, 7], g.uniform(-1, 1, 4),
                                  g.uniform(-1, 1, 4), 3)
            for falloff in (0.0, 2.0)],
        "prepare_morph_weights": lambda r, c, p, g: r.prepare_morph_weights(
            g.uniform(0, 0.05, 256), 12),
        "prune_top8": lambda r, c, p, g: r.prune_top8(
            np.round(g.uniform(0, 1, 256), 1)),
        "spherical_weighted_average": lambda r, c, p, g: r.spherical_weighted_average(
            g.standard_normal((8, 64)), g.uniform(0, 1, 8)),
        "codebook_lottery": lambda r, c, p, g: [
            r.codebook_lottery(w8, np.arange(8) * 3, 24, np.arange(40, dtype=np.uint32))
            for w8 in (g.uniform(0, 1, 8), np.zeros(8))],
        "morph_conditioning": lambda r, c, p, g: r.morph_conditioning(
            {"additive": g.standard_normal((12, 256)), "formant": g.standard_normal((9, 256)),
             "kv": g.standard_normal((12, 6, 128))},
            g.uniform(0, 1, 256) * (np.arange(256) < 14), 12, formant_index=6),
    }


STAGES = _stage_cases()


@pytest.mark.parametrize("name", sorted(STAGES))
def test_function_equals_the_jax_oracle(name):
    pcfg, jcfg, params = _model(RC0, seed=3)
    got = STAGES[name](pref, pcfg, params, np.random.default_rng(4))
    want = STAGES[name](jref, jcfg, params, np.random.default_rng(4))
    _same(got, want)


def test_every_function_has_a_case():
    public = {n for n in dir(jref) if callable(getattr(jref, n)) and not n.startswith("_")
              and getattr(getattr(jref, n), "__module__", "") == jref.__name__}
    assert public - {"mel_filterbank"} <= set(STAGES) | {"chain_forward"}


def test_the_copy_is_line_for_line():
    """Below the module docstring the two files are the same code."""
    def body(path):
        tree = ast.parse(open(path).read())
        return ast.dump(ast.Module(body=tree.body[1:], type_ignores=[]))

    assert body(os.path.join(REPO, "beatrice_vst_tpu_torch", "reference_impl.py")) == body(
        os.path.join(REPO, "beatrice_vst_tpu", "reference_impl.py"))
