"""Split the converted-F0 error between the pitch estimator and the
renderer, through the port (counterpart of the repo's
`scripts/diagnose_pitch.py`, which runs the JAX package).

    python -m beatrice_vst_tpu_torch.scripts.diagnose_pitch
        [--model models_demo/klatt8] [--utts 45 46 47] [--pairs-per-utt 4]
        [--seed 0] [--out docs/TORCH_PITCH_DIAGNOSIS.json] [--device cuda]

Per drawn pair (rng(123), source != target) the source rendition is
resampled to 16 kHz by the host-edge `HostResampler` (flushed with 256
zeros) and run through `chain.apply(..., with_taps=True)` as one chunk:

  A. the pitch ESTIMATOR: its raw bins (`qp_raw`) in Hz against the plan's
     F0 on the plan's voiced frames; its voicing (sigmoid of pitch
     feature 0) against the plan's;
  B. the waveform GENERATOR: `waveform_generator.apply` forced with the
     plan's bins and a saturated voicing gate, its output's tracked F0
     (`f0_track` after a 360-sample pre-pad) against the plan's;

and the whole chain's tracked F0 for reference.  Both steps are compiled
(`runtime/graphs.py`: one captured step per utterance length).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from ..constants import quantized_pitch_to_hz
from ..models import chain, waveform_generator
from ..models.io import load_model_dir, params_from_numpy
from ..native.host import HostResampler
from ..runtime import graphs
from ..runtime.offline import ConversionSettings, build_cond
from ..training import synthesis
from ..training.distill import f0_to_bin
from ..training.quality import f0_track
from . import quality_eval as Q
from .make_corpus import plans as draw_plans

OUT = os.path.join(Q.REPO, "docs", "TORCH_PITCH_DIAGNOSIS.json")
PRE_PAD = 360  # samples at 24 kHz before f0_track, as the JAX script pads
FLUSH = 256  # zeros through the resampler after the utterance
GATE = 8.0  # the forced voicing logit: sigmoid(8) = 0.9997
INTERPRETATION = (
    "estimator_f0_rmse_cents measures suspect A (pitch estimator bins vs plan F0 on "
    "plan-voiced frames); forced_render_f0_rmse_cents measures suspect B (renderer given "
    "ground-truth bins + saturated voicing gate); fullchain is the end-to-end tracked error "
    "for reference.")


def to16k(x48: np.ndarray) -> np.ndarray:
    r = HostResampler(48000.0, 16000.0)
    y = r.process(x48.astype(np.float32))
    return np.concatenate([y, r.process(np.zeros(FLUSH, np.float32))])


def cents(a_hz, b_hz):
    return 1200.0 * np.abs(np.log2(np.maximum(a_hz, 1e-3) / np.maximum(b_hz, 1e-3)))


def draw_pairs(utts, n_speakers: int, pairs_per_utt: int) -> list:
    """[(utterance, source, target)]: per utterance `pairs_per_utt` draws
    from rng(123), the draws with source == target skipped."""
    rng = np.random.default_rng(123)
    out = []
    for j in utts:
        for _ in range(pairs_per_utt):
            s, t = int(rng.integers(n_speakers)), int(rng.integers(n_speakers))
            if s != t:
                out.append((j, s, t))
    return out


def rmse(x) -> float:
    return float(np.sqrt((x ** 2).mean()))


def _tapped(params, cfg, audio16, cond):
    state = chain.init_state(cfg, (audio16.shape[0],), audio16.device)
    audio24, _, taps = chain.apply(params, cfg, audio16, state, cond, with_taps=True)
    return audio24, taps["phone"], taps["qp_raw"], taps["pitch_feats"]


def _forced(params, cfg, phone, qp, pf, cond):
    state = chain.init_state(cfg, (phone.shape[0],), phone.device)
    return waveform_generator.apply(params["wg"], cfg.wg, phone, qp, pf,
                                    cond["speaker_embedding"], state["wg"],
                                    kv_cache=cond.get("kv_cache"))[0]


def diagnose_row(params, cfg, bank, plans, speakers, j: int, s: int, t: int, seed: int = 0,
                 device="cuda") -> dict:
    """One pair's row.  params and bank: tensors on `device` (numpy is
    moved there, and captures anew)."""
    dev = torch.device(device)
    params = params_from_numpy(params, dev)
    bank = {k: v.float() for k, v in params_from_numpy(bank, dev).items()}
    segs, f0_plan = plans[j]
    tr, n_plan = synthesis._tracks(segs, f0_plan, np.random.default_rng(0))
    v_plan = (tr["voiced"] * tr["amp"]) > 0.25
    x48 = synthesis.render(segs, f0_plan, speakers[s],
                           np.random.default_rng(seed * 100003 + j * 131 + s))
    x16 = to16k(x48)
    n_frames = min(len(x16) // 160, n_plan)
    x16 = x16[: n_frames * 160]
    f0p, vp = tr["f0"][:n_frames], v_plan[:n_frames]

    cond = build_cond(params, cfg, bank, ConversionSettings(target_speaker=t))
    key = graphs.identity(params)
    audio24, phone, qp_raw, pf = graphs.call(
        ("diagnose_tapped", cfg, key), lambda a, c: _tapped(params, cfg, a, c),
        torch.as_tensor(x16[None], device=dev), cond)
    audio24 = audio24[0].cpu().numpy()
    qp_raw = qp_raw[0].cpu().numpy()[:n_frames]
    pf_host = pf.cpu().numpy()
    per = pf_host[0, :, 0][:n_frames]

    # A. the estimator on the plan's voiced frames
    est_cents = cents(np.asarray(quantized_pitch_to_hz(qp_raw))[vp], f0p[vp])
    voicing_agree = float(((1.0 / (1.0 + np.exp(-per)) > 0.5) == vp).mean())

    # B. the renderer forced with the plan's bins and a saturated gate
    qp_forced = torch.as_tensor(f0_to_bin(f0p, cfg.spec.pitch_bins)[None].astype(np.int64),
                                device=dev)
    pf_forced = np.array(pf_host[:, :n_frames])
    pf_forced[0, :, 0] = np.where(vp, GATE, -GATE)
    forced24 = graphs.call(
        ("diagnose_forced", cfg, key), lambda ph, q, p, c: _forced(params, cfg, ph, q, p, c),
        phone[:, :n_frames], qp_forced, torch.as_tensor(pf_forced, device=dev), cond)
    forced24 = forced24[0].cpu().numpy()
    ff, fv = f0_track(np.pad(forced24, (PRE_PAD, 0)), 24000)
    m = min(len(ff), n_frames)
    sel = vp[:m] & fv[:m]
    forced_cents = cents(ff[:m][sel], f0p[:m][sel]) if sel.sum() > 3 else np.array([np.nan])

    # the whole chain's tracked F0
    cf, cv = f0_track(np.pad(audio24[: n_frames * 240], (PRE_PAD, 0)), 24000)
    m2 = min(len(cf), n_frames)
    sel2 = vp[:m2] & cv[:m2]
    conv_cents = cents(cf[:m2][sel2], f0p[:m2][sel2]) if sel2.sum() > 3 else np.array([np.nan])
    return {
        "utt": j, "src": s, "tgt": t,
        "estimator_f0_rmse_cents": rmse(est_cents),
        "estimator_f0_median_cents": float(np.median(est_cents)),
        "voicing_agreement": voicing_agree,
        "forced_render_f0_rmse_cents": rmse(forced_cents),
        "fullchain_f0_rmse_cents": rmse(conv_cents),
        "conv_tracker_voiced_frac": float(cv[:m2][vp[:m2]].mean()),
    }


def summarize(rows) -> dict:
    def mean(key):
        v = [r[key] for r in rows if np.isfinite(r[key])]
        return round(float(np.mean(v)), 2) if v else None

    return {k: mean(k) for k in rows[0] if k not in ("utt", "src", "tgt")}


def diagnose(model_dir: str, utts=(45, 46, 47), pairs_per_utt: int = 4, seed: int = 0,
             device="cuda", log=print) -> dict:
    _, cfg, params, bank = load_model_dir(model_dir)
    dev = torch.device(device)
    params = params_from_numpy(params, dev)
    bank = params_from_numpy(bank, dev)
    speakers = synthesis.default_speakers(bank["additive"].shape[0])
    plans = draw_plans(max(utts) + 1, seed)
    watch = Q.CaptureWatch()
    rows = []
    for j, s, t in draw_pairs(utts, len(speakers), pairs_per_utt):
        rows.append(diagnose_row(params, cfg, bank, plans, speakers, j, s, t, seed, dev))
        watch.note()
        log(json.dumps(rows[-1]))
    return {**Q.device_fields(dev), "model": Q.relpath(model_dir), "summary": summarize(rows),
            "rows": rows, "compiled_steps": watch.stats(), "interpretation": INTERPRETATION}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", default=Q.MODEL_DIR)
    ap.add_argument("--utts", type=int, nargs="*", default=[45, 46, 47])
    ap.add_argument("--pairs-per-utt", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report = diagnose(args.model, tuple(args.utts), args.pairs_per_utt, args.seed, args.device,
                      log=lambda s: print(s, flush=True))
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report["summary"], indent=1))
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
