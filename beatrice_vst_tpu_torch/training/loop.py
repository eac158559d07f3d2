"""Training loops (port of `beatrice_vst_tpu/training/loop.py`):
distillation (`train`) and adversarial (`train_gan`) over a batch
iterator, with checkpoint and resume; `make_teacher_batcher` gives
batches converted by a frozen teacher chain, the stand-in for a recorded
pair dataset.  Both run on `cuda` unless the caller passes device="cpu".
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..device import resolve_device
from ..models import chain
from ..models.io import params_from_numpy
from ..runtime import graphs
from .checkpoint import latest_step, restore_checkpoint, save_checkpoint
from .distill import make_optimizer, train_step, trainable, tree_leaves


def make_teacher_batcher(cfg, teacher_params, bank, *, batch: int, frames: int, seed: int = 0,
                         device="cuda", jit: bool | None = None):
    """Yield {audio16, target24, cond} batches: sawtooth-plus-noise inputs
    from a numpy generator (the JAX package's draws, `loop.py:27-54`)
    converted by the frozen teacher, without a gradient.  The teacher's
    forward is compiled (`jit` None or True; the JAX package jits it,
    `loop.py:35`) through the step cache; `jit=False` runs it op by op."""
    from ..runtime.offline import ConversionSettings, build_cond

    dev = resolve_device(device)
    teacher_params = params_from_numpy(teacher_params, dev)
    bank = {k: v.float() for k, v in params_from_numpy(bank, dev).items()}
    cond = build_cond(None, cfg, bank, ConversionSettings(target_speaker=0), batch,
                      raw_kv=True)
    rng = np.random.default_rng(seed)
    compiled = graphs.resolve_jit(jit)

    @torch.no_grad()
    def teacher(audio16):
        return chain.apply(teacher_params, cfg, audio16, chain.init_state(cfg, (batch,), dev),
                           cond)[0]

    def batcher():
        while True:
            n = frames * 160
            t = np.arange(n) / 16000.0
            f0 = rng.uniform(80.0, 300.0, (batch, 1))
            phase = rng.uniform(0, 2 * np.pi, (batch, 1))
            saw = 2.0 * ((f0 * t[None, :] + phase) % 1.0) - 1.0
            noise = rng.standard_normal((batch, n)) * 0.05
            audio16 = torch.from_numpy((0.3 * saw + noise).astype(np.float32)).to(dev)
            if compiled:
                target24 = graphs.call(("teacher", cfg, graphs.identity(teacher_params, cond)),
                                       teacher, audio16)
            else:
                target24 = teacher(audio16)
            yield {"audio16": audio16, "target24": target24, "cond": cond}

    return batcher()


def _restore_into(ckpt_dir: str, tree):
    """Copy the latest checkpoint into the tensors of `tree` (the leaves
    the optimizers hold); returns (its step, the restored tree)."""
    step, restored = restore_checkpoint(ckpt_dir, tree)
    with torch.no_grad():
        for dst, src in zip(tree_leaves(tree), tree_leaves(restored)):
            if isinstance(dst, torch.Tensor):
                dst.copy_(src)
    return step, restored


def train(params, cfg, batches, *, steps: int, lr: float = 2e-4, log_every: int = 10,
          log_fn=print, ckpt_dir: str | None = None, save_every: int = 500,
          resume: bool = False, f0_weight: float = 1.0, soft_pitch: bool = False,
          lr_schedule: bool = False, periodicity_weight: float = 0.0, device="cuda",
          jit: bool | None = None):
    """Run `steps` of distillation (`loop.py:57`); returns (params,
    history [(step, loss)]).  params: the JAX package's tree or the
    port's (numpy arrays or tensors), trained as fresh leaf tensors on
    `device`.  With `ckpt_dir` the parameters and the optimizer state are
    saved every `save_every` steps and at the end; `resume` continues from
    the latest checkpoint.  A checkpoint's step is the number of updates
    it holds (the JAX loop names its periodic checkpoints one update
    short, so that a run resumed from one repeats a step).  Each step is
    `train_step` with `jit` (compiled by default: the batch copied into
    the static tensors of one CUDA graph on the card)."""
    params = trainable(params, device)
    optimizer = make_optimizer(params, lr, total_steps=steps if lr_schedule else None)
    start = 0
    if resume and ckpt_dir and latest_step(ckpt_dir) is not None:
        start, (_, opt_tree) = _restore_into(ckpt_dir, (params, optimizer.state_tree()))
        optimizer.load_state_tree(opt_tree)
        log_fn(f"resumed from step {start}")
    history = []
    t0 = time.time()
    step = start
    for step, batch in zip(range(start, steps), batches):
        params, optimizer, metrics = train_step(
            params, optimizer, batch, cfg=cfg, f0_weight=f0_weight, soft_pitch=soft_pitch,
            periodicity_weight=periodicity_weight, jit=jit)
        if step % log_every == 0 or step == steps - 1:
            loss = float(metrics["loss"])
            history.append((step, loss))
            extra = "".join(f", {k} {float(metrics[k]):.4f}"
                            for k in ("f0", "voice", "perio") if k in metrics)
            log_fn(f"step {step}: loss {loss:.4f} "
                   f"(stft {float(metrics['stft']):.4f}, "
                   f"l1 {float(metrics['l1']):.4f}{extra}) "
                   f"[{time.time() - t0:.1f}s]")
        if ckpt_dir and (step + 1) % save_every == 0 and step + 1 < steps:
            save_checkpoint(ckpt_dir, step + 1, (params, optimizer.state_tree()))
    if ckpt_dir and steps > start:
        save_checkpoint(ckpt_dir, step + 1, (params, optimizer.state_tree()))
    return params, history


def train_gan(params, cfg, batches, *, steps: int, lr: float = 2e-4, seed: int = 0,
              log_every: int = 10, log_fn=print, ckpt_dir: str | None = None,
              save_every: int = 500, resume: bool = False, compute_dtype=None,
              soft_pitch: bool = False, periodicity_weight: float = 0.0, device="cuda",
              jit: bool | None = None):
    """Adversarial training (`loop.py:110`): least-squares GAN with feature
    matching on top of the reconstruction objective.  Returns (params,
    history [(step, g_loss)]); the critics, from `discriminator.init`
    seeded with `seed`, live only in the checkpoint.  Each step is
    `gan_train_step` with `jit` (compiled by default)."""
    from . import discriminator
    from .gan import gan_train_step, make_gan_optimizers

    dev = resolve_device(device)
    params = trainable(params, dev)
    disc_params = trainable(discriminator.init(torch.Generator().manual_seed(seed), dev), dev)
    gen_opt, disc_opt = make_gan_optimizers(params, disc_params, lr)
    start = 0

    def tree():
        return (params, disc_params, gen_opt.state_tree(), disc_opt.state_tree())

    if resume and ckpt_dir and latest_step(ckpt_dir) is not None:
        start, restored = _restore_into(ckpt_dir, tree())
        gen_opt.load_state_tree(restored[2])
        disc_opt.load_state_tree(restored[3])
        log_fn(f"resumed from step {start}")
    history = []
    t0 = time.time()
    step = start
    for step, batch in zip(range(start, steps), batches):
        params, disc_params, gen_opt, disc_opt, metrics = gan_train_step(
            params, disc_params, gen_opt, disc_opt, batch, cfg=cfg,
            compute_dtype=compute_dtype, soft_pitch=soft_pitch,
            periodicity_weight=periodicity_weight, jit=jit)
        if step % log_every == 0 or step == steps - 1:
            g = float(metrics["g_loss"])
            history.append((step, g))
            extra = "".join(f", {k} {float(metrics[k]):.4f}"
                            for k in ("f0", "voice", "perio")
                            if k in metrics and not isinstance(metrics[k], float))
            log_fn(f"step {step}: g {g:.4f} d {float(metrics['d_loss']):.4f} "
                   f"(rec {float(metrics['rec']):.4f}, fm {float(metrics['fm']):.4f}, "
                   f"adv {float(metrics['adv']):.4f}{extra}) [{time.time() - t0:.1f}s]")
        if ckpt_dir and (step + 1) % save_every == 0 and step + 1 < steps:
            save_checkpoint(ckpt_dir, step + 1, tree())
    if ckpt_dir and steps > start:
        save_checkpoint(ckpt_dir, step + 1, tree())
    return params, history
