"""Train a voice-conversion model on the synthetic parallel corpus, through
the port (counterpart of the repo's `scripts/train_real_model.py`, which
runs the JAX package).

    python -m beatrice_vst_tpu_torch.scripts.make_corpus
    python -m beatrice_vst_tpu_torch.scripts.train_real_model
        [--corpus $TMPDIR/beatrice_corpus] [--out $TMPDIR/beatrice_klatt8]
        [--steps 6000] [--gan-steps 800] [--batch 16] [--frames 64]
        [--f0-weight 2] [--register-boost 1] [--periodicity-weight 0]
        [--speakers 0 1 2 3 4 5] [--resume] [--overwrite]
        [--report docs/TORCH_TRAIN_REAL_REPORT.json]
        [--ckpt-dir $TMPDIR/beatrice_train_ckpt] [--device cuda]

A burst of distillation (`training/loop.py:train`: multi-resolution STFT +
L1, the pitch-bin CE and voicing BCE at --f0-weight, the periodicity
anchor at --periodicity-weight, soft pitch, warmup-cosine LR) and then of
the adversarial polish (`train_gan` at half the LR), each step a compiled
step (one CUDA graph on the card), on `make_pair_batcher`'s batches (its
thread; --register-boost weights the high-register pairs).  The weights
are saved into --out's weights.npz and the burst into --report.

The JAX script's rules are kept: a model directory that holds weights is
not re-initialized without --overwrite (--resume continues it); --speakers
must be a prefix 0..k-1, and then only pairs between those speakers train;
a --resume whose checkpoints already cover both phases' steps refuses to
run; the report keeps the earlier bursts under "bursts".  Output goes
into the temporary directory (`tempfile.gettempdir()`: $TMPDIR, else
/tmp) unless told otherwise: --out is never a directory of the repo by
default, and nothing is written into `models_demo/`.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
import tempfile
import time

import torch

from ..models import fused_upsampler
from ..models.io import init_random_model_dir, load_model_dir, save_weights
from ..training import PairDataset, make_pair_batcher, train, train_gan
from ..training.checkpoint import latest_step
from . import make_corpus as MC
from . import quality_eval as Q

REPORT = os.path.join(Q.REPO, "docs", "TORCH_TRAIN_REAL_REPORT.json")
LOG_EVERY = 50


def speaker_filter(speakers):
    """The pair-name filter of a --speakers list (None: every pair); raises
    SystemExit unless it is a prefix 0..k-1 (so the corpus's speaker ids
    index the smaller bank unchanged)."""
    if speakers is None:
        return None
    if sorted(speakers) != list(range(len(speakers))):
        raise SystemExit("--speakers must be a contiguous prefix 0..k-1")
    allowed = set(speakers)

    def keep(name):  # pair names are u{j:03d}_s{s}_t{t}
        m = re.match(r"u\d+_s(\d+)_t(\d+)$", name)
        return bool(m) and int(m.group(1)) in allowed and int(m.group(2)) in allowed

    return keep


def open_model(out: str, resume: bool, overwrite: bool, n_voices: int, seed: int):
    """(model config, params, bank): --out's model with --resume, else a
    fresh init there, refused where --out already holds weights unless
    --overwrite."""
    if resume and os.path.isdir(out):
        _, cfg, params, bank = load_model_dir(out)
        return cfg, params, bank
    if os.path.exists(os.path.join(out, "weights.npz")) and not overwrite:
        raise SystemExit(f"{out} already holds a model; pass --resume to continue it or "
                         "--overwrite to re-initialize")
    _, cfg, params, bank = init_random_model_dir(out, version="2.0.0-rc.0", n_voices=n_voices,
                                                 seed=seed, name="klatt8-demo")
    return cfg, params, bank


def planned_steps(args) -> tuple:
    """(distill start, gan start, distill to run, gan to run); raises
    SystemExit for a resume that would run no step in either phase."""
    start_distill = (latest_step(args.ckpt_dir) or 0) if args.resume else 0
    start_gan = (latest_step(args.ckpt_dir + "_gan") or 0) if args.resume else 0
    exec_distill = max(0, args.steps - start_distill)
    exec_gan = max(0, args.gan_steps - start_gan)
    if exec_distill == 0 and exec_gan == 0 and (args.steps or args.gan_steps):
        raise SystemExit(
            f"resume-and-skip: checkpoints at step {start_distill} (distill) / {start_gan} "
            f"(gan) already cover --steps {args.steps} / --gan-steps {args.gan_steps}; nothing "
            "would run. Clear the ckpt dirs for a fresh burst or raise the step targets.")
    return start_distill, start_gan, exec_distill, exec_gan


class PhaseClock:
    """A phase's wall time, its rate between its first and last logged
    steps (each log reads the loss, so the device has caught up: the
    capture and the first step are left out), its peak MiB and the step
    cache's captures."""

    def __init__(self, device, log):
        self.device, self.log, self.marks = device, log, []
        self.cuda = device.type == "cuda"
        if self.cuda:
            torch.cuda.synchronize(device)
            self.base = torch.cuda.memory_allocated(device)
            torch.cuda.reset_peak_memory_stats(device)
        self.watch = Q.CaptureWatch()
        self.t0 = time.time()

    def log_fn(self, msg):
        m = re.match(r"step (\d+):", msg)
        if m:
            self.marks.append((int(m.group(1)), time.time()))
        self.log(msg)

    def stats(self) -> dict:
        out = {"wall_s": round(time.time() - self.t0, 1)}
        if len(self.marks) >= 2:
            (s0, t0), (s1, t1) = self.marks[0], self.marks[-1]
            out["steps_per_s"] = (s1 - s0) / (t1 - t0) if t1 > t0 else None
            out["rate_steps"] = [s0, s1]
        if self.cuda:
            out["peak_mib"] = (torch.cuda.max_memory_allocated(self.device) - self.base) / 2**20
        out["compiled_steps"] = self.watch.stats()
        return out


def run(args, log=print) -> dict:
    """One burst; returns the report (also written to args.report)."""
    dev = torch.device(args.device)
    with open(os.path.join(args.corpus, "manifest.json")) as f:
        manifest = json.load(f)
    name_filter = speaker_filter(args.speakers)
    n_voices = len(args.speakers) if args.speakers is not None else manifest["n_speakers"]
    cfg, params, bank = open_model(args.out, args.resume, args.overwrite, n_voices, args.seed)
    ds = PairDataset(os.path.join(args.corpus, "pairs"), name_filter=name_filter)
    log(f"dataset: {len(ds.items)} pairs, {ds.n_frames_total()} frames "
        f"({ds.n_frames_total() * 0.01 / 3600:.2f} h)")
    batches = make_pair_batcher(ds, cfg, bank, batch=args.batch, frames=args.frames,
                                seed=args.seed, register_boost=args.register_boost, device=dev)
    start_distill, start_gan, exec_distill, exec_gan = planned_steps(args)
    if args.resume and (start_distill or start_gan):
        log(f"resume: distill from step {start_distill} ({exec_distill} to run), gan from "
            f"{start_gan} ({exec_gan} to run)")

    clock = PhaseClock(dev, log)
    params, history = train(
        params, cfg, batches, steps=args.steps, lr=args.lr, log_every=LOG_EVERY,
        log_fn=clock.log_fn, ckpt_dir=args.ckpt_dir, save_every=1000, resume=args.resume,
        f0_weight=args.f0_weight, soft_pitch=args.soft_pitch, lr_schedule=args.lr_schedule,
        periodicity_weight=args.periodicity_weight, device=dev)
    distill = clock.stats()

    gan_history, gan = [], {"wall_s": 0.0}
    if args.gan_steps:
        clock = PhaseClock(dev, log)
        params, gan_history = train_gan(
            params, cfg, batches, steps=args.gan_steps, lr=args.lr * 0.5, seed=args.seed,
            log_every=LOG_EVERY, log_fn=clock.log_fn, ckpt_dir=args.ckpt_dir + "_gan",
            save_every=400, resume=args.resume, soft_pitch=args.soft_pitch,
            periodicity_weight=args.periodicity_weight, device=dev)
        gan = clock.stats()
    batches.close()

    save_weights(os.path.join(args.out, "weights.npz"), params)
    report = {
        **Q.device_fields(dev),
        "corpus": manifest,
        "batch": args.batch,
        "frames_per_example": args.frames,
        "f0_weight": args.f0_weight,
        "register_boost": args.register_boost,
        "periodicity_weight": args.periodicity_weight,
        "soft_pitch": args.soft_pitch,
        "lr_schedule": args.lr_schedule,
        "train_speakers": args.speakers,
        "distill": {"steps": args.steps, "steps_executed": exec_distill,
                    "resumed_from_step": start_distill, "loss_curve": history, **distill},
        "gan": {"steps": args.gan_steps, "steps_executed": exec_gan,
                "resumed_from_step": start_gan, "g_loss_curve": gan_history, **gan},
        "model_dir": Q.relpath(args.out),
        "ended_at": time.strftime("%Y-%m-%dT%H:%M:%S"),
        # the trainers run the plain head: the kernel's forms never launch
        "upsampler_kernel_launches": {"float32": fused_upsampler.launches,
                                      "bfloat16": fused_upsampler.launches_bf16},
    }
    # burst-append: an earlier burst's record at the same path moves into
    # "bursts", never lost
    if os.path.exists(args.report):
        try:
            with open(args.report) as f:
                prev = json.load(f)
        except (json.JSONDecodeError, OSError):
            prev = None
        if prev:
            bursts = prev.pop("bursts", [])
            bursts.append({k: prev.get(k) for k in ("distill", "gan", "ended_at", "model_dir")})
            report["bursts"] = bursts
    with open(args.report, "w") as f:
        json.dump(report, f, indent=1)
    log(f"saved {args.out} + {args.report}")
    return report


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    tmp = tempfile.gettempdir()
    ap.add_argument("--corpus", default=MC.default_corpus())
    ap.add_argument("--out", default=os.path.join(tmp, "beatrice_klatt8"))
    ap.add_argument("--steps", type=int, default=6000)
    ap.add_argument("--gan-steps", type=int, default=800)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--frames", type=int, default=64)
    ap.add_argument("--lr", type=float, default=2e-4)
    ap.add_argument("--lr-schedule", dest="lr_schedule", action="store_true", default=True,
                    help="linear-warmup cosine decay over --steps (default on)")
    ap.add_argument("--no-lr-schedule", dest="lr_schedule", action="store_false")
    ap.add_argument("--f0-weight", type=float, default=2.0,
                    help="weight on the pitch-bin CE + voicing BCE")
    ap.add_argument("--soft-pitch", dest="soft_pitch", action="store_true", default=True,
                    help="condition the vocoder on E[bin] over the pitch logits while training")
    ap.add_argument("--no-soft-pitch", dest="soft_pitch", action="store_false")
    ap.add_argument("--speakers", type=int, nargs="*", default=None,
                    help="train only on these speaker ids, a prefix 0..k-1")
    ap.add_argument("--periodicity-weight", type=float, default=0.0,
                    help="weight of the rendered waveform's periodicity anchor, both phases")
    ap.add_argument("--register-boost", type=float, default=1.0,
                    help="sampling weight multiplier for high-register pairs "
                         "(mean voiced F0 ramp 240->320 Hz)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--report", default=REPORT)
    ap.add_argument("--ckpt-dir", default=os.path.join(tmp, "beatrice_train_ckpt"))
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--overwrite", action="store_true",
                    help="allow re-initializing an existing model dir")
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
