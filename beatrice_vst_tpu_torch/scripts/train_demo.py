"""Training demo of the port: distillation and adversarial steps with a
checkpoint and a resume (counterpart of the repo's `scripts/train_demo.py`,
which runs the JAX package).

    python -m beatrice_vst_tpu_torch.scripts.train_demo [steps] [gan_steps]
        [--device cuda] [--report docs/TORCH_TRAIN_DEMO_REPORT.json]

A student (`chain.init` at seed 0) distills a frozen random teacher (seed
1) over `make_teacher_batcher`'s batches (BATCH x FRAMES, numpy seed 0;
the bank `random_bank` at seed 2 with 4 speakers; each drawn through its
module, so that a test can swap in the JAX package's draws): `train` for
`steps` (default 200) with a checkpoint every `steps // 2`, then `train`
again to `steps + 10` resumed from the latest checkpoint, then
`train_gan` for `gan_steps` (default 30) -- the JAX script's calls, one
for one.  Every step is compiled (one CUDA graph on the card).  The
report has the JAX script's keys, `device` holding nvidia-smi's name and
power limit on a card; `converged` is whether the mean of the last three
logged losses is under the first.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

from ..constants import V20RC0
from ..device import resolve_device
from ..models import chain
from ..speakers import bank as bank_mod
from ..training import make_teacher_batcher, train, train_gan
from .quality_eval import card_line

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
REPORT = os.path.join(REPO, "docs", "TORCH_TRAIN_DEMO_REPORT.json")
BATCH, FRAMES = 16, 16
EXTRA_STEPS = 10  # the resumed run's steps past the first run's


def run(steps: int = 200, gan_steps: int = 30, device="cuda", log_fn=print) -> dict:
    """The demo; returns the report."""
    dev = resolve_device(device)
    cfg = chain.VoiceConverterConfig.for_version(V20RC0)
    student = chain.init(torch.Generator().manual_seed(0), cfg, dev)
    teacher = chain.init(torch.Generator().manual_seed(1), cfg, dev)
    bank = bank_mod.random_bank(torch.Generator().manual_seed(2), V20RC0, 4, device=dev)
    batches = make_teacher_batcher(cfg, teacher, bank, batch=BATCH, frames=FRAMES, seed=0,
                                   device=dev)
    with tempfile.TemporaryDirectory(prefix="train_demo_ck_") as ck:
        t0 = time.time()
        student, hist = train(student, cfg, batches, steps=steps, lr=5e-4,
                              log_every=max(1, steps // 10), log_fn=log_fn,
                              ckpt_dir=ck, save_every=max(1, steps // 2), device=dev)
        distill_s = time.time() - t0
        # resume from the checkpoint for a few more steps (proves restore)
        t1 = time.time()
        student, hist2 = train(student, cfg, batches, steps=steps + EXTRA_STEPS, lr=5e-4,
                               log_every=5, log_fn=log_fn, ckpt_dir=ck, resume=True,
                               device=dev)
        resume_s = time.time() - t1
    t2 = time.time()
    student, ghist = train_gan(student, cfg, batches, steps=gan_steps, lr=1e-4,
                               log_every=max(1, gan_steps // 5), log_fn=log_fn, device=dev)
    gan_s = time.time() - t2

    losses = [loss for _, loss in hist]
    return {
        "device": card_line(dev),
        "distill": {
            "steps": steps,
            "batch": BATCH,
            "frames_per_example": FRAMES,
            "first_loss": round(losses[0], 4),
            "last_loss": round(losses[-1], 4),
            "loss_curve": [(s, round(v, 4)) for s, v in hist],
            "wall_s": round(distill_s, 1),
            "steps_per_s_steady": round((steps - 1) / max(distill_s, 1e-9), 2),
        },
        "resume": {
            "resumed_at": hist2[0][0] if hist2 else None,
            "extra_steps": EXTRA_STEPS,
            "wall_s": round(resume_s, 1),
        },
        "gan": {
            "steps": gan_steps,
            "g_loss_curve": [(s, round(v, 4)) for s, v in ghist],
            "wall_s": round(gan_s, 1),
        },
        "converged": bool(np.mean(losses[-3:]) < losses[0]),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("steps", nargs="?", type=int, default=200)
    ap.add_argument("gan_steps", nargs="?", type=int, default=30)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--report", default=REPORT)
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report = run(args.steps, args.gan_steps, args.device,
                 log_fn=lambda msg: print(msg, flush=True))
    os.makedirs(os.path.dirname(os.path.abspath(args.report)), exist_ok=True)
    with open(args.report, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps({k: v for k, v in report.items() if k != "distill"}
                     | {"distill_first_last": (report["distill"]["first_loss"],
                                               report["distill"]["last_loss"])}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
