"""Adversarial training step: least-squares GAN plus feature matching over
the MPD/MRD/PCD critics, on top of the reconstruction objective (port of
`beatrice_vst_tpu/training/gan.py`):

    d_loss = sum over critics  E[(1 - D(y))^2] + E[D(y_hat)^2]
    g_loss = 15 (multi-res STFT + L1) + 2 FM + 1 sum E[(1 - D(y_hat))^2]
             + 15 (pitch CE + voicing BCE, with f0_bin)

One step is one critic update, then one generator update on the same
batch.  Gradients are taken with `torch.autograd.grad` with respect to the
player being updated only, which is where the JAX package's
`stop_gradient`s sit (`gan.py:48-49, 77-78, 86`): the critic's loss does
not reach the generator, and the real audio's feature maps are constants
of the generator's loss.  `gan_train_step` is compiled by default, as the
JAX package jits it (`runtime/graphs.py`).
"""

from __future__ import annotations

import torch

from ..models import chain
from ..parallel.collectives import all_reduce_grads_, dp_group, global_mean, is_sharded
from . import discriminator
from .distill import (Optimizer, multi_resolution_stft_loss, periodicity_loss,
                      pitch_supervision_losses, resolve_step_jit, run_update, trainer_config,
                      tree_leaves)

LAMBDA_REC = 15.0
LAMBDA_FM = 2.0
LAMBDA_ADV = 1.0
LAMBDA_F0 = 15.0  # LAMBDA_REC times the distillation step's f0_weight of 1


def _generate(gen_params, cfg, batch, compute_dtype=None, with_taps: bool = False,
              soft_pitch: bool = False):
    cfg = trainer_config(cfg)
    audio16 = batch["audio16"]
    state = chain.init_state(cfg, (audio16.shape[0],), audio16.device)
    out = chain.apply(gen_params, cfg, audio16, state, batch["cond"], compute_dtype,
                      soft_pitch=soft_pitch, with_taps=with_taps)
    return (out[0], out[2]) if with_taps else out[0]


def disc_loss(disc_params, real, fake, f0_bin=None, group=None):
    """The critics' least-squares loss; with a data-parallel `group`, its
    means over the whole batch."""
    outs_real = discriminator.apply(disc_params, real, f0_bin=f0_bin)
    outs_fake = discriminator.apply(disc_params, fake.detach(), f0_bin=f0_bin)
    loss = 0.0
    for (lr_, _), (lf, _) in zip(outs_real, outs_fake):
        loss = loss + global_mean((1.0 - lr_) ** 2, group) + global_mean(lf ** 2, group)
    return loss / len(outs_real)


def gen_loss(gen_params, disc_params, cfg, batch, compute_dtype=None,
             soft_pitch: bool = False, periodicity_weight: float = 0.0, group=None):
    """(total, {"rec", "fm", "adv", "f0", "voice"[, "perio"]}) (`gan.py:55`);
    "f0" and "voice" are 0.0 without f0_bin.  With a data-parallel `group`
    the batch is this rank's rows and every term the whole batch's."""
    f0_bin = batch.get("f0_bin")
    if f0_bin is not None:
        pred, taps = _generate(gen_params, cfg, batch, compute_dtype, with_taps=True,
                               soft_pitch=soft_pitch)
        l_f0, l_voice = pitch_supervision_losses(taps, f0_bin, group)
    else:
        pred = _generate(gen_params, cfg, batch, compute_dtype, soft_pitch=soft_pitch)
        l_f0 = l_voice = 0.0
    target = batch["target24"]
    l_rec = (multi_resolution_stft_loss(pred, target, group)
             + global_mean(torch.abs(pred - target), group))
    outs_fake = discriminator.apply(disc_params, pred, f0_bin=f0_bin)
    with torch.no_grad():
        outs_real = discriminator.apply(disc_params, target, f0_bin=f0_bin)
    l_adv = 0.0
    l_fm = 0.0
    n_maps = 0
    for (lf, ff), (_, fr) in zip(outs_fake, outs_real):
        l_adv = l_adv + global_mean((1.0 - lf) ** 2, group)
        for a, b in zip(ff, fr):
            l_fm = l_fm + global_mean(torch.abs(a - b), group)
            n_maps += 1
    l_adv = l_adv / len(outs_fake)
    l_fm = l_fm / max(n_maps, 1)
    total = (LAMBDA_REC * l_rec + LAMBDA_FM * l_fm + LAMBDA_ADV * l_adv
             + LAMBDA_F0 * (l_f0 + l_voice))
    aux = {"rec": l_rec, "fm": l_fm, "adv": l_adv, "f0": l_f0, "voice": l_voice}
    if periodicity_weight and f0_bin is not None:
        l_perio = periodicity_loss(pred, f0_bin, group=group)
        total = total + periodicity_weight * l_perio
        aux["perio"] = l_perio
    return total, aux


def make_gan_optimizers(gen_params, disc_params, lr: float = 2e-4, b1: float = 0.8,
                        b2: float = 0.99):
    """(generator, critic) optimizers: optax.chain(clip_by_global_norm(10),
    adamw(lr, b1, b2)) each, with optax's default weight decay 1e-4
    (`gan.py:103`)."""
    return tuple(Optimizer(p, lr, betas=(b1, b2), weight_decay=1e-4, clip_norm=10.0)
                 for p in (gen_params, disc_params))


def set_grads(loss, opt: Optimizer, group=None) -> None:
    """The gradient of `loss` with respect to the optimizer's leaves only,
    into their .grad (zero where the loss does not reach a leaf); with a
    data-parallel `group`, summed over its ranks (each rank's loss is the
    whole batch's, so its gradient is its rows' share)."""
    grads = torch.autograd.grad(loss, opt.leaves, allow_unused=True)
    for p, g in zip(opt.leaves, grads):
        p.grad = torch.zeros_like(p) if g is None else g
    if group is not None:
        all_reduce_grads_(opt.leaves, group)


def gan_train_step(gen_params, disc_params, gen_opt: Optimizer, disc_opt: Optimizer, batch,
                   *, cfg, compute_dtype=None, soft_pitch: bool = False,
                   periodicity_weight: float = 0.0, mesh=None, jit: bool | None = None):
    """One critic step, then one generator step on the same batch
    (`gan.py:111`); the leaves are updated in place.  batch: the
    distillation batch.  Returns (gen_params, disc_params, gen_opt,
    disc_opt, metrics), the metrics detached.  Compiled
    (`distill.resolve_step_jit`: by default wherever a CUDA graph can hold
    the step), the no-grad fake, the critic's grads and update and the
    generator's grads and update are one step of the step cache
    (`distill.run_update`: one CUDA graph on the card, whose pool owns the
    grads `set_grads` assigns); `jit=False` runs them op by op.  With a
    `mesh` whose 'streams' axis has several ranks, data-parallel as
    `distill.train_step`: this rank's rows, the whole batch's losses, the
    gradients summed over 'streams' before each update; with the
    generator's weights split over 'model', its updates on their blocks.
    The compiled step holds those collectives on NCCL ranks; on gloo ranks
    on the card it is eager (and `jit=True` raises)."""
    kw = dict(cfg=cfg, compute_dtype=compute_dtype, soft_pitch=soft_pitch,
              periodicity_weight=periodicity_weight, group=dp_group(mesh))
    split = any(is_sharded(p) for p in tree_leaves([gen_params, disc_params]))
    if not resolve_step_jit(jit, mesh, split):
        metrics = _gan_step(gen_params, disc_params, gen_opt, disc_opt, batch, gen_opt.step,
                            disc_opt.step, **kw)
    else:
        metrics = run_update(
            ("gan_train_step", cfg, compute_dtype, soft_pitch, periodicity_weight),
            lambda g, d, go, do, b: _gan_step(g, d, go, do, b, go.update, do.update, **kw),
            (gen_params, disc_params), (gen_opt, disc_opt), batch, mesh)
    return gen_params, disc_params, gen_opt, disc_opt, metrics


def _gan_step(gen_params, disc_params, gen_opt, disc_opt, batch, gen_update, disc_update, *,
              cfg, compute_dtype, soft_pitch, periodicity_weight, group=None):
    with torch.no_grad():
        fake = _generate(gen_params, cfg, batch, compute_dtype, soft_pitch=soft_pitch)
    d_loss = disc_loss(disc_params, batch["target24"], fake, batch.get("f0_bin"), group)
    set_grads(d_loss, disc_opt, group)
    disc_update()

    g_loss, aux = gen_loss(gen_params, disc_params, cfg, batch, compute_dtype, soft_pitch,
                           periodicity_weight, group)
    set_grads(g_loss, gen_opt, group)
    gen_update()
    return {"g_loss": g_loss.detach(), "d_loss": d_loss.detach(),
            **{k: v.detach() if isinstance(v, torch.Tensor) else v for k, v in aux.items()}}
