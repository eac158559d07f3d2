"""Distillation-to-parity study through the port (counterpart of the repo's
`scripts/distill_parity.py`, which runs the JAX package).

    python -m beatrice_vst_tpu_torch.scripts.make_corpus
    python -m beatrice_vst_tpu_torch.scripts.distill_parity
        [--corpus $TMPDIR/beatrice_corpus] [--teacher models_demo/klatt8]
        [--steps-per-module 5000] [--pitch-steps-mult 2] [--e2e-steps 2000]
        [--batch 16] [--frames 32] [--lr 1e-3] [--seed 0]
        [--report docs/TORCH_DISTILL_PARITY_REPORT.json] [--device cuda]

Can a fresh student of the 2.0.0-rc.0 architecture be distilled to the
1e-3 waveform-parity gate against a frozen teacher?  The student learns
module by module from the teacher's taps (`training/feature_distill.py`:
phone, then pitch at --pitch-steps-mult times the steps, then the
vocoder, each with AdamW under a cosine decay), then end to end in a
pitch-anchored polish (`polish_step`: the waveform losses against the
teacher's waveform plus a cross-entropy on the student's pitch logits at
the teacher's bins).  After each phase the student chain is compared
with the teacher's on one held batch (`end_to_end_error` and its
soft-pitch twin), with an error budget (the student vocoder on the
teacher's taps; then with the student's features and the teacher's bins;
then the whole student) that names the limiting factor.

The draws are the JAX script's: the speech clips (the first 4 speaker
directories of the corpus's raw/, 12 files each, at 16 kHz), one
`np.random.default_rng(--seed)` for every batch in the same order, a cond
a voice with the raw speaker KV (so the student's K/V projection gets
its gradient); the teacher is --teacher's model, else `chain.init` at
seed + 1 with a random bank at seed + 3; the student is `chain.init` at
seed + 2.  Every step and diagnostic is compiled (one CUDA graph each on
the card); the chains run the stage loop at 32 frames and the student
trains through the plain upsampler head, so the kernel's forms never
launch (the report's `upsampler_kernel_launches`).  The report goes to
--report, not over the JAX package's `docs/DISTILL_PARITY_REPORT.json`.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from ..audio_io import read_wav
from ..constants import V20RC0
from ..device import resolve_device
from ..models import chain, fused_upsampler
from ..models.io import load_model_dir, params_from_numpy
from ..runtime import graphs
from ..runtime.offline import ConversionSettings, build_cond
from ..speakers import bank as bank_mod
from ..training import distill
from ..training import feature_distill as FD
from ..training.data import _to_rate
from . import make_corpus as MC
from . import quality_eval as Q
from .train_real_model import PhaseClock

REPORT = os.path.join(Q.REPO, "docs", "TORCH_DISTILL_PARITY_REPORT.json")
MODULES = ("phone", "pitch", "wg")
LOG_EVERY = 100
GATE = 1e-3  # the golden tests' waveform tolerance against the float64 oracle
SOFT_GATE = 0.02  # the soft-pitch mode's behavioral gate
SAMPLE_RATE = 16000
SPEAKER_DIRS = 4
FILES_PER_SPEAKER = 12


def load_clips(corpus: str) -> list:
    """The study's speech: the first SPEAKER_DIRS speaker directories of
    the corpus's raw/ (sorted), the first FILES_PER_SPEAKER files of each,
    at 16 kHz."""
    raw = os.path.join(corpus, "raw")
    spk_dirs = sorted(d for d in os.listdir(raw) if os.path.isdir(os.path.join(raw, d)))
    clips = []
    for spk in spk_dirs[:SPEAKER_DIRS]:
        for fn in sorted(os.listdir(os.path.join(raw, spk)))[:FILES_PER_SPEAKER]:
            a, sr = read_wav(os.path.join(raw, spk, fn))
            clips.append(_to_rate(a, sr, SAMPLE_RATE))
    return clips


def load_models(teacher_dir, seed: int, device):
    """(cfg, teacher, bank, student): --teacher's model, else a random
    teacher (chain.init at seed + 1) and bank (seed + 3); the student drawn
    by chain.init at seed + 2 and made trainable."""
    if teacher_dir:
        _, cfg, params, bank = load_model_dir(teacher_dir)
        teacher = params_from_numpy(params, device)
        bank = params_from_numpy(bank, device)
    else:
        cfg = chain.VoiceConverterConfig.for_version(V20RC0)
        teacher = chain.init(torch.Generator().manual_seed(seed + 1), cfg, device)
        bank = bank_mod.random_bank(torch.Generator().manual_seed(seed + 3), V20RC0, 8,
                                    device=device)
    student = distill.trainable(
        chain.init(torch.Generator().manual_seed(seed + 2), cfg, device), device)
    return cfg, teacher, bank, student


def batch_maker(clips, conds, batch: int, frames: int, seed: int, device):
    """make_batch(step) of the JAX script: `batch` windows of `frames` 10 ms
    frames, each a clip and an offset from one np.random.default_rng(seed)
    in the JAX script's order, on `device`, with the cond of voice
    step % len(conds)."""
    rng = np.random.default_rng(seed)
    n16 = frames * SAMPLE_RATE // 100

    def make_batch(step: int) -> dict:
        out = np.zeros((batch, n16), np.float32)
        for b in range(batch):
            c = clips[rng.integers(len(clips))]
            o = rng.integers(len(c) - n16)
            out[b] = c[o: o + n16]
        return {"audio16": torch.from_numpy(out).to(device), "cond": conds[step % len(conds)]}

    return make_batch


def module_optimizer(params, lr: float, n_steps: int) -> distill.Optimizer:
    """A module phase's optimizer: optax.adamw(cosine_decay_schedule(lr,
    n_steps), weight_decay=1e-3) over the module's leaves."""
    return distill.Optimizer(params, lr, betas=(0.9, 0.999), weight_decay=1e-3,
                             schedule=distill.cosine_decay(lr, n_steps))


def polish_optimizer(params, lr: float) -> distill.Optimizer:
    """The polish's optimizer: `make_optimizer` (AdamW, b2 0.99, weight
    decay 1e-2, constant) at a tenth of the study's lr over every leaf."""
    return distill.make_optimizer(params, lr * 0.1)


def polish_loss(params, cfg, batch):
    """The pitch-anchored polish's loss (`scripts/distill_parity.py:162`):
    the multi-resolution STFT and L1 of the student's waveform against the
    teacher's (batch["target24"]) plus the cross-entropy of the student's
    pre-transform pitch logits at the teacher's bins (batch["t_qp_raw"]).
    A waveform loss alone erodes bin agreement, which it cannot see.  The
    chain runs the plain upsampler head (`trainer_config`)."""
    cfg = distill.trainer_config(cfg)
    audio16, t24 = batch["audio16"], batch["target24"]
    state = chain.init_state(cfg, (audio16.shape[0],), audio16.device)
    pred, _, taps = chain.apply(params, cfg, audio16, state, batch["cond"], with_taps=True)
    log_p = torch.log_softmax(taps["pitch_logits"], -1)
    ce = -torch.gather(log_p, -1, batch["t_qp_raw"][..., None].to(torch.int64))[..., 0].mean()
    return (distill.multi_resolution_stft_loss(pred, t24) + torch.mean(torch.abs(pred - t24))
            + ce)


def polish_step(student, opt, batch, *, cfg, jit: bool | None = None):
    """One polish step: the loss, its gradient and one update of `opt`
    (over every leaf of the student) in place; returns the loss.
    Compiled (`jit` None or True), one step of the step cache
    (`distill.run_update`: one CUDA graph on the card); `jit=False` runs it
    op by op."""
    if not graphs.resolve_jit(jit):
        return _polish_step(student, opt, batch, opt.step, cfg=cfg)
    return distill.run_update(("distill_parity.polish_step", cfg),
                              lambda p, o, b: _polish_step(p, o, b, o.update, cfg=cfg),
                              (student,), (opt,), batch)


def _polish_step(params, opt, batch, update, *, cfg):
    opt.zero_grad()
    loss = polish_loss(params, cfg, batch)
    loss.backward()
    update()
    return loss.detach()


def teacher_wav(teacher, cfg, batch, jit: bool | None = None):
    """(audio24, taps["qp_raw"]) of the frozen teacher on a batch, without
    gradients; compiled through the step cache, keyed by the teacher's
    identity."""
    if not graphs.resolve_jit(jit):
        return _teacher_wav(teacher, cfg, batch)
    return graphs.call(("distill_parity.teacher_wav", cfg, graphs.identity(teacher)),
                       lambda b: _teacher_wav(teacher, cfg, b), batch)


@torch.no_grad()
def _teacher_wav(teacher, cfg, batch):
    audio16 = batch["audio16"]
    state = chain.init_state(cfg, (audio16.shape[0],), audio16.device)
    wav, _, taps = chain.apply(teacher, cfg, audio16, state, batch["cond"], with_taps=True)
    return wav, taps["qp_raw"]


def phase_record(module: str, steps: int, curve: list, clock: PhaseClock) -> dict:
    """A phase's entry of the report before its diagnostics: the JAX
    script's keys, then its rate between the first and last logged steps,
    its peak MiB (on a card) and its captures."""
    s = clock.stats()
    compiled = s["compiled_steps"]
    return {"module": module, "steps": steps, "loss_curve": curve, "wall_s": s["wall_s"],
            "steps_per_s": s.get("steps_per_s"), "peak_mib": s.get("peak_mib"),
            "captures": compiled["captures"], "capture_ms": compiled["capture_ms_total"]}


def analysis(final: dict) -> dict:
    """The error budget and the limiting factor of the final diagnostics."""
    return {
        "wav_l1_vs_gate": final["wav_l1"] / GATE,
        # the student vocoder on the teacher's taps; then with the student's
        # phone and pitch features but the teacher's bins; then the whole
        # student: the differences attribute the floor
        "error_budget": {
            "wg_only_wav_l1": final.get("wg_only_wav_l1"),
            "plus_student_phone_feats": final.get("teacher_bins_wav_l1"),
            "full_student": final["wav_l1"],
        },
        "limiting_factor": (
            "quantized-pitch bin disagreements (each flipped frame "
            "shifts the harmonic source for that frame)"
            if final["qp_match"] < 0.999 else
            "waveform-generator optimization floor (nonconvex L1/L2 "
            "descent, not architecture mismatch)"),
    }


def run(args, log=print) -> dict:
    """The study; returns the report (also written to args.report)."""
    dev = resolve_device(args.device)
    cfg, teacher, bank, student = load_models(args.teacher, args.seed, dev)
    clips = load_clips(args.corpus)
    n_voices = bank["additive"].shape[0]
    conds = [build_cond(None, cfg, bank, ConversionSettings(target_speaker=t), batch=args.batch,
                        raw_kv=True) for t in range(n_voices)]
    make_batch = batch_maker(clips, conds, args.batch, args.frames, args.seed, dev)
    report = {"phases": [], "device": Q.nvidia_smi() if dev.type == "cuda" else "cpu",
              "teacher": args.teacher or "random-init (held out)"}
    eval_batch = make_batch(7)

    def e2e(tag):
        m = {k: float(v) for k, v in FD.end_to_end_error(
            student, teacher, eval_batch, cfg=cfg).items()}
        m.update({k: float(v) for k, v in FD.end_to_end_error_soft(
            student, teacher, eval_batch, cfg=cfg).items()})
        log(f"{tag} {json.dumps(m)}")
        return m

    t_start = time.time()
    log("baseline (random student):")
    report["baseline"] = e2e("e2e@init")

    # the student's leaves are updated in place and never rebound: the
    # compiled diagnostics read them at their capture-time addresses
    for module in MODULES:
        n_steps = args.steps_per_module * (args.pitch_steps_mult if module == "pitch" else 1)
        opt = module_optimizer(student[module], args.lr, n_steps)
        clock, curve = PhaseClock(dev, log), []
        for step in range(n_steps):
            _, _, m = FD.module_step(student, opt, teacher, make_batch(step), cfg=cfg,
                                     module=module)
            if step % LOG_EVERY == 0 or step == n_steps - 1:
                loss = float(m["loss"])
                clock.mark(step)
                curve.append([step, loss])
                log(f"{module} step {step}: {loss:.6f}")
        phase = phase_record(module, n_steps, curve, clock)
        phase["e2e_after"] = e2e(f"e2e@{module}")
        report["phases"].append(phase)

    if args.e2e_steps:
        opt = polish_optimizer(student, args.lr)
        clock, curve = PhaseClock(dev, log), []
        for step in range(args.e2e_steps):
            b = make_batch(1000 + step)
            t24, t_qp = teacher_wav(teacher, cfg, b)
            loss = polish_step(student, opt, {**b, "target24": t24, "t_qp_raw": t_qp}, cfg=cfg)
            if step % LOG_EVERY == 0 or step == args.e2e_steps - 1:
                loss = float(loss)
                clock.mark(step)
                curve.append([step, loss])
                log(f"e2e step {step}: {loss:.6f}")
        phase = phase_record("e2e_polish", args.e2e_steps, curve, clock)
        phase["e2e_after"] = e2e("e2e@polish")
        report["phases"].append(phase)

    final = report["phases"][-1]["e2e_after"]
    report.update({
        "wall_s_total": round(time.time() - t_start, 1),
        "gate": GATE,
        "gate_reached": bool(final["wav_max"] < GATE),
        "final": final,
        "analysis": analysis(final),
        # the bin-flip discontinuity does not exist in the soft-pitch
        # inference mode: that mode's parity against its behavioral gate
        "soft_mode": {
            "wav_l1": final["wav_l1_soft"],
            "wav_max": final["wav_max_soft"],
            "qp_l1_bins": final["qp_l1_bins_soft"],
            "gate": SOFT_GATE,
            "gate_reached": bool(final["wav_l1_soft"] < SOFT_GATE),
        },
        "settings": {"batch": args.batch, "frames": args.frames, "lr": args.lr,
                     "seed": args.seed, "pitch_steps_mult": args.pitch_steps_mult},
        # the chains run the stage loop and the student the plain head
        "upsampler_kernel_launches": {"float32": fused_upsampler.launches,
                                      "bfloat16": fused_upsampler.launches_bf16},
    })
    os.makedirs(os.path.dirname(os.path.abspath(args.report)), exist_ok=True)
    with open(args.report, "w") as f:
        json.dump(report, f, indent=1)
    log(json.dumps({"gate_reached": report["gate_reached"], "final": final}))
    log(f"wrote {args.report}")
    return report


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--corpus", default=MC.default_corpus())
    ap.add_argument("--teacher", default=None,
                    help="model dir of the frozen teacher (e.g. models_demo/klatt8); a "
                         "trained teacher's peaked pitch logits are representative of "
                         "distilling a trained model, a random one's near-uniform logits make "
                         "bin agreement adversarially hard")
    ap.add_argument("--steps-per-module", type=int, default=5000)
    ap.add_argument("--pitch-steps-mult", type=int, default=2,
                    help="step budget multiplier of the pitch module (bin agreement is the "
                         "parity limiter and needs iterations)")
    ap.add_argument("--e2e-steps", type=int, default=2000)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--frames", type=int, default=32)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--report", default=REPORT)
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    run(args, log=lambda s: print(s, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
