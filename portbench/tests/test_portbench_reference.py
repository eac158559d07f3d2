"""The reference against the program's float64 NumPy oracle and its
resamplers, and against the program's f32 engine on the CPU."""

import numpy as np
import torch

from beatrice_vst_tpu_torch import reference_impl as oracle
from beatrice_vst_tpu_torch.models.io import load_model_dir
from beatrice_vst_tpu_torch.ops.resample import (input_resampler_48k_to_16k,
                                                 output_resampler_24k_to_48k)
from portbench import spec
from portbench.reference import beatrice2
from portbench.tests.helpers import ROOT

MODEL = f"{ROOT}/models_demo/klatt8"


def _dense_f64(x, rs):
    """The program's banded resampling matrix applied in f64 block by block."""
    s = rs.dense_np().astype(np.float64)
    full = np.concatenate([np.zeros(rs.history_len), x])
    n = (len(full) - rs.history_len) // rs.in_block
    windows = np.lib.stride_tricks.sliding_window_view(
        full, rs.history_len + rs.in_block)[::rs.in_block][:n]
    return (windows @ s).reshape(-1)


def test_resamplers_equal_the_programs():
    x = np.random.default_rng(0).standard_normal(480 * 7)
    got = beatrice2.resample(torch.as_tensor(x)[None], 1, 3)[0].numpy()
    np.testing.assert_allclose(got, _dense_f64(x, input_resampler_48k_to_16k(1)), atol=1e-12)
    y = x[:240 * 7]
    got = beatrice2.resample(torch.as_tensor(y)[None], 2, 1)[0].numpy()
    np.testing.assert_allclose(got, _dense_f64(y, output_resampler_24k_to_48k(1)), atol=1e-12)


def test_chain_equals_the_oracle():
    """One stream's chain (16 kHz in, 24 kHz out) against the oracle with
    the same source phases."""
    _, mcfg, params, bank = load_model_dir(MODEL)
    model = spec.load_json(f"{ROOT}/portbench/configs/beatrice2-rc0-f32.json")["model"]
    w, b = beatrice2.load_model(MODEL)
    ref = beatrice2.Reference(w, b, model)
    t = 30
    rng = np.random.default_rng(1)
    n16 = np.arange(t * 160) / 16000
    x16 = 0.3 * np.sin(2 * np.pi * 170 * n16) + 0.01 * rng.standard_normal(t * 160)
    x = torch.as_tensor(x16)[None]
    c = {"min_q": torch.tensor([1]), "max_q": torch.tensor([447])}
    spk, target, formant, n_vq, shift = 3, 3, 6, 2, 1.5
    phone = ref.vq(ref.phone(x), ref.bank["codebook"][[target]], torch.tensor([n_vq]))
    q_raw, feats = ref.pitch(x, c["min_q"], c["max_q"])
    one = torch.ones(1, 1, dtype=torch.float64)
    qp = beatrice2.transform_pitch(q_raw, 52.0 * one, one, shift * one, 0.0 * one,
                                   torch.zeros(1, 1, dtype=torch.int64), 448)
    start, _ = ref.source_phases(qp)
    emb = ref.bank["additive"][[spk]] + ref.bank["formant"][[formant]]
    got = ref.waveform(phone, qp, feats, emb, ref.bank["kv"][[target]])[0].numpy()
    settings = {"speaker_embedding": emb[0].numpy(), "kv": bank["kv"][target],
                "codebook": bank["codebook"][target], "vq_num_neighbors": n_vq,
                "pitch_shift": shift, "min_q": 1, "max_q": 447}
    want = oracle.chain_forward(params, mcfg, x16, target_settings=settings,
                                phase_start=start[0].numpy())
    # the reference takes the per-sample phase step in f32, as the model
    # carries it; the oracle in f64: 2e-9 at outputs near 1e-2
    np.testing.assert_allclose(got, want, atol=1e-8, rtol=0)
