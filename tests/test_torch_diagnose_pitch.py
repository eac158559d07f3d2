"""The port's pitch diagnosis (`beatrice_vst_tpu_torch/scripts/
diagnose_pitch.py`) against the JAX package's computation on the CPU (the
repo's `scripts/diagnose_pitch.py`, composed here from the same library
calls, since the script writes into docs/): the first drawn pair of
utterance 45 on klatt8, every number within 1e-6 relative, and the pair
draw."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beatrice_vst_tpu.constants import quantized_pitch_to_hz as j_qp_to_hz
from beatrice_vst_tpu.models import chain as JC
from beatrice_vst_tpu.models import waveform_generator as JWG
from beatrice_vst_tpu.models.io import load_model_dir as j_load_model_dir
from beatrice_vst_tpu.native.host import HostResampler as JHostResampler
from beatrice_vst_tpu.runtime.offline import ConversionSettings as JSettings
from beatrice_vst_tpu.runtime.offline import build_cond as j_build_cond
from beatrice_vst_tpu.training import synthesis as JS
from beatrice_vst_tpu.training.distill import f0_to_bin as j_f0_to_bin
from beatrice_vst_tpu.training.quality import f0_track as j_f0_track
from beatrice_vst_tpu_torch.models.io import load_model_dir
from beatrice_vst_tpu_torch.scripts import diagnose_pitch as D
from beatrice_vst_tpu_torch.scripts.make_corpus import plans as draw_plans
from beatrice_vst_tpu_torch.training.synthesis import default_speakers
from test_torch_quality_eval import KLATT8, UTT

torch.set_num_threads(1)

RTOL = 1e-6


def jax_row(j, s, t, seed=0):
    """scripts/diagnose_pitch.py:99-160 for one pair."""
    _, cfg, params, bank = j_load_model_dir(KLATT8)
    speakers = JS.default_speakers(bank["additive"].shape[0])
    rng_plan = np.random.default_rng(seed)
    plans = [JS.sample_utterance(rng_plan) for _ in range(j + 1)]

    def to16k(x48):
        r = JHostResampler(48000.0, 16000.0)
        y = r.process(x48.astype(np.float32))
        return np.concatenate([y, r.process(np.zeros(256, np.float32))])

    def cents(a_hz, b_hz):
        return 1200.0 * np.abs(np.log2(np.maximum(a_hz, 1e-3) / np.maximum(b_hz, 1e-3)))

    tapped = jax.jit(lambda a, c: JC.apply(params, cfg, a, JC.init_state(cfg, (1,)), c,
                                           with_taps=True))

    def render_forced(taps, cond, qp_forced, per_forced):
        st = JC.init_state(cfg, (1,))
        return JWG.apply(params["wg"], cfg.wg, taps["phone"], qp_forced, per_forced,
                         cond["speaker_embedding"], st["wg"], kv_embedding=cond.get("kv"))[0]

    rf = jax.jit(render_forced)
    segs, f0_plan = plans[j]
    tr, n_plan = JS._tracks(segs, f0_plan, np.random.default_rng(0))
    v_plan = (tr["voiced"] * tr["amp"]) > 0.25
    x48 = JS.render(segs, f0_plan, speakers[s], np.random.default_rng(seed * 100003 + j * 131 + s))
    x16 = to16k(x48)
    n_frames = min(len(x16) // 160, n_plan)
    x16 = x16[: n_frames * 160]
    f0p, vp = tr["f0"][:n_frames], v_plan[:n_frames]
    cond = j_build_cond(cfg, bank, JSettings(target_speaker=t))
    audio24, _, taps = tapped(jnp.asarray(x16[None]), cond)
    audio24 = np.asarray(audio24)[0]
    qp_raw = np.asarray(taps["qp_raw"])[0][:n_frames]
    per = np.asarray(taps["pitch_feats"])[0, :, 0][:n_frames]
    est_cents = cents(np.asarray(j_qp_to_hz(qp_raw))[vp], f0p[vp])
    voicing_agree = float(((1.0 / (1.0 + np.exp(-per)) > 0.5) == vp).mean())
    qp_forced = jnp.asarray(j_f0_to_bin(f0p, cfg.spec.pitch_bins)[None].astype(np.int32))
    pf = np.array(np.asarray(taps["pitch_feats"])[:, :n_frames])
    pf[0, :, 0] = np.where(vp, 8.0, -8.0)
    forced24 = np.asarray(rf({"phone": taps["phone"][:, :n_frames]}, cond, qp_forced,
                             jnp.asarray(pf)))[0]
    ff, fv = j_f0_track(np.pad(forced24, (360, 0)), 24000)
    m = min(len(ff), n_frames)
    sel = vp[:m] & fv[:m]
    forced_cents = cents(ff[:m][sel], f0p[:m][sel]) if sel.sum() > 3 else np.array([np.nan])
    cf, cv = j_f0_track(np.pad(audio24[: n_frames * 240], (360, 0)), 24000)
    m2 = min(len(cf), n_frames)
    sel2 = vp[:m2] & cv[:m2]
    conv_cents = cents(cf[:m2][sel2], f0p[:m2][sel2]) if sel2.sum() > 3 else np.array([np.nan])
    return {
        "utt": j, "src": s, "tgt": t,
        "estimator_f0_rmse_cents": float(np.sqrt((est_cents ** 2).mean())),
        "estimator_f0_median_cents": float(np.median(est_cents)),
        "voicing_agreement": voicing_agree,
        "forced_render_f0_rmse_cents": float(np.sqrt((forced_cents ** 2).mean())),
        "fullchain_f0_rmse_cents": float(np.sqrt((conv_cents ** 2).mean())),
        "conv_tracker_voiced_frac": float(cv[:m2][vp[:m2]].mean()),
    }


def jax_draw(utts, n_spk, pairs_per_utt):
    """scripts/diagnose_pitch.py:99-107's draw."""
    rng = np.random.default_rng(123)
    out = []
    for j in utts:
        for _ in range(pairs_per_utt):
            s = int(rng.integers(n_spk))
            t = int(rng.integers(n_spk))
            if s == t:
                continue
            out.append((j, s, t))
    return out


def test_pair_draw_is_the_jax_scripts():
    assert D.draw_pairs([45, 46, 47], 8, 4) == jax_draw([45, 46, 47], 8, 4)
    assert D.draw_pairs([45, 46, 47], 8, 4)[0][0] == UTT


@pytest.fixture(scope="module")
def rows():
    j, s, t = D.draw_pairs([UTT], 8, 4)[0]
    _, cfg, params, bank = load_model_dir(KLATT8)
    port = D.diagnose_row(params, cfg, bank, draw_plans(j + 1), default_speakers(8), j, s, t,
                          device="cpu")
    return port, jax_row(j, s, t)


def test_diagnosis_row_equals_jax(rows):
    port, jax_ = rows
    assert set(port) == set(jax_)
    for key, want in jax_.items():
        if isinstance(want, int):
            assert port[key] == want, key
        else:
            np.testing.assert_allclose(port[key], want, rtol=RTOL, atol=0, err_msg=key)


def test_summary_rounds_the_means(rows):
    port, _ = rows
    summary = D.summarize([port, port])
    assert set(summary) == set(port) - {"utt", "src", "tgt"}
    assert summary["voicing_agreement"] == round(port["voicing_agreement"], 2)
