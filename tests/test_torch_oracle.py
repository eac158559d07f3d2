"""The port's f32 chain against the float64 NumPy oracle
(`beatrice_vst_tpu/reference_impl.py:chain_forward`), mirroring
tests/test_golden.py's `_run_pair` for 2.0.0-rc.0: 12 frames of a 220 Hz
sine plus noise, random parameters from the JAX package's `chain.init`
passed through `params_from_numpy`, the port run frame by frame (T = 1)
from zero state.  The conditioning goes in by either route of the port's
engine: the per-stream projected K/V cache and codebook, or the slot bank
and the shared codebook bank (a one-speaker bank).  Gate: atol 1e-3, the
waveform gate of tests/test_golden.py."""

import numpy as np
import jax
import pytest
import torch

from beatrice_vst_tpu import reference_impl as ref
from beatrice_vst_tpu.constants import V20RC0
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


def _settings(rng, overrides):
    s = {
        "speaker_embedding": rng.standard_normal(256).astype(np.float32) * 0.1,
        "vq_num_neighbors": 0,
        "min_q": 1,
        "max_q": V20RC0.pitch_bins - 1,
        "average_source_pitch": 52.0,
        "intonation_intensity": 1.0,
        "pitch_shift": 0.0,
        "pitch_correction": 0.0,
        "pitch_correction_type": 0,
        "kv": rng.standard_normal((384, 128)).astype(np.float32) * 0.1,
        "codebook": rng.standard_normal((512, 128)).astype(np.float32),
    }
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
