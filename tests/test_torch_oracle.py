"""The port's f32 chain against the float64 NumPy oracle
(`beatrice_vst_tpu/reference_impl.py:chain_forward`), mirroring
tests/test_golden.py's `_run_pair`: frames of a 220 Hz sine plus noise,
random parameters from the JAX package's `chain.init` passed through
`params_from_numpy`, from zero state.

  * frame by frame (T = 1), 2.0.0-rc.0, 12 frames: the conditioning goes
    in by either route of the port's engine -- the per-stream projected
    K/V cache and codebook, or the slot bank and the shared codebook bank
    (a one-speaker bank);
  * as one chunk (the offline path), each model version: 12 frames, with
    argmax and with soft pitch, and 2.0.0-rc.0 over 300 frames (3 s) with
    controls, where the tail alone holds the gate too (phase accumulation).

Gate: atol 1e-3, the waveform gate of tests/test_golden.py."""

import numpy as np
import jax
import pytest
import torch

from beatrice_vst_tpu import reference_impl as ref
from beatrice_vst_tpu.constants import V20A2, V20B1, V20RC0
from beatrice_vst_tpu.models import chain as JC
from beatrice_vst_tpu_torch.models import chain as PC
from beatrice_vst_tpu_torch.models import waveform_generator as PW
from beatrice_vst_tpu_torch.models.io import params_from_numpy

torch.set_num_threads(1)

FRAMES = 12
# tests/test_golden.py's default settings, and its controls case
OVERRIDES = {
    "default": {},
    "controls": {"vq_num_neighbors": 4, "pitch_shift": 7.0, "pitch_correction": 0.5,
                 "pitch_correction_type": 1, "intonation_intensity": 1.5},
}


def _settings(rng, overrides, spec=V20RC0):
    """tests/test_golden.py's settings, drawn in its order."""
    s = {
        "speaker_embedding": rng.standard_normal(256).astype(np.float32) * 0.1,
        "vq_num_neighbors": 0,
        "min_q": 1,
        "max_q": spec.pitch_bins - 1,
        "average_source_pitch": 52.0,
        "intonation_intensity": 1.0,
        "pitch_shift": 0.0,
        "pitch_correction": 0.0,
        "pitch_correction_type": 0,
    }
    if spec.has_kv:
        s["kv"] = rng.standard_normal((384, 128)).astype(np.float32) * 0.1
    if spec.has_vq:
        s["codebook"] = rng.standard_normal((512, 128)).astype(np.float32)
    s.update(overrides)
    return s


def _port_cond(pp, settings, route):
    one = lambda v, dtype: torch.tensor([v], dtype=dtype)  # noqa: E731
    cond = {"speaker_embedding": torch.from_numpy(settings["speaker_embedding"])[None]}
    for name in ("vq_num_neighbors", "min_q", "max_q", "pitch_correction_type"):
        cond[name] = one(settings[name], torch.int64)
    for name in ("average_source_pitch", "intonation_intensity", "pitch_shift",
                 "pitch_correction"):
        cond[name] = one(settings[name], torch.float32)
    if "kv" not in settings:  # 2.0.0-alpha.2 and 2.0.0-beta.1
        return cond
    kv = PW.project_kv(pp["wg"], torch.from_numpy(settings["kv"])[None])
    codebook = torch.from_numpy(settings["codebook"])[None]
    if route == "per_stream":
        cond["kv_cache"] = kv
        cond["codebook"] = codebook
    else:
        cond["kv_bank"], cond["kv_slot"] = kv, torch.zeros(1, dtype=torch.int64)
        cond["codebook_bank"] = codebook
        cond["codebook_idx"] = torch.zeros(1, dtype=torch.int64)
    return cond


@pytest.mark.parametrize("route", ["per_stream", "shared"])
@pytest.mark.parametrize("case,seed", [("default", 0), ("controls", 1)])
def test_chain_frames_match_numpy_oracle(route, case, seed):
    cfg = JC.VoiceConverterConfig.for_version(V20RC0)
    params = JC.init(jax.random.PRNGKey(seed), cfg)
    rng = np.random.default_rng(seed)
    audio = (0.3 * np.sin(2 * np.pi * 220 * np.arange(FRAMES * 160) / 16000)
             + 0.02 * rng.standard_normal(FRAMES * 160)).astype(np.float32)
    settings = _settings(rng, OVERRIDES[case])
    want = ref.chain_forward(params, cfg, audio, target_settings=settings)

    pp = params_from_numpy(jax.tree_util.tree_map(np.asarray, params), "cpu")
    pcfg = PC.VoiceConverterConfig.for_version(V20RC0)
    cond = _port_cond(pp, settings, route)
    state = PC.init_state(pcfg, (1,), device="cpu")
    got = []
    for k in range(FRAMES):
        y, state = PC.apply(pp, pcfg, torch.from_numpy(audio[None, 160 * k:160 * (k + 1)]),
                            state, cond)
        got.append(y[0].numpy())
    got = np.concatenate(got)
    assert got.shape == want.shape == (FRAMES * 240,)
    assert np.abs(want).max() > 1e-3
    print(f" max |d| from the oracle {np.abs(got - want).max():.3g}", end="")
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


SPECS = pytest.mark.parametrize("spec", [V20A2, V20B1, V20RC0], ids=["20a2", "20b1", "20rc0"])


def _run_chunk(spec, overrides, seed, t, soft_pitch=False):
    """(the port's chain over t frames in one call, the oracle's)."""
    cfg = JC.VoiceConverterConfig.for_version(spec)
    params = JC.init(jax.random.PRNGKey(seed), cfg)
    rng = np.random.default_rng(seed)
    audio = (0.3 * np.sin(2 * np.pi * 220 * np.arange(t * 160) / 16000)
             + 0.02 * rng.standard_normal(t * 160)).astype(np.float32)
    settings = _settings(rng, overrides, spec)
    want = ref.chain_forward(params, cfg, audio, target_settings=settings,
                             soft_pitch=soft_pitch)
    pp = params_from_numpy(jax.tree_util.tree_map(np.asarray, params), "cpu")
    pcfg = PC.VoiceConverterConfig.for_version(spec)
    state = PC.init_state(pcfg, (1,), device="cpu")
    got, _ = PC.apply(pp, pcfg, torch.from_numpy(audio[None]), state,
                      _port_cond(pp, settings, "per_stream"), soft_pitch=soft_pitch)
    got = got[0].numpy()
    assert got.shape == want.shape == (t * 240,)
    assert np.abs(want).max() > 1e-3
    print(f" max |d| from the oracle {np.abs(got - want).max():.3g}", end="")
    return got, want


@SPECS
def test_chain_chunk_matches_numpy_oracle(spec):
    got, want = _run_chunk(spec, {}, seed=0, t=FRAMES)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


@SPECS
def test_chain_soft_pitch_matches_oracle(spec):
    """Soft pitch (the expected bin, transformed without rounding, the
    pitch embedding interpolated) with a shift and intonation, as in
    tests/test_golden.py."""
    got, want = _run_chunk(spec, {"pitch_shift": 3.0, "intonation_intensity": 1.2}, seed=3,
                           t=FRAMES, soft_pitch=True)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


def test_chain_matches_oracle_long_horizon():
    """300 frames (3 s) in one chunk with controls: deep into the source
    phase's accumulation, which the f64 prefix sum keeps at rounding
    level; the last 2,400 samples alone hold the gate too."""
    overrides = {"pitch_shift": 5.0, "pitch_correction": 0.35, "intonation_intensity": 1.2,
                 "vq_num_neighbors": 2}
    got, want = _run_chunk(V20RC0, overrides, seed=2, t=300)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    np.testing.assert_allclose(got[-2400:], want[-2400:], rtol=0, atol=1e-3)
