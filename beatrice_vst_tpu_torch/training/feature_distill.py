"""Per-module feature distillation (port of
`beatrice_vst_tpu/training/feature_distill.py`): each sub-model learns
from a frozen teacher's taps at its own boundary.

- phone: MSE on the [B, T, C] phone features;
- pitch: MSE on the bin logits and the aux features, soft and hard
  cross-entropy against the teacher's bins and a margin hinge around the
  teacher's winning bin;
- wg: waveform L1 + 10 L2 + 0.1 multi-resolution STFT, rendered from the
  teacher's phone and pitch taps.

`module_step` takes an optimizer over the module's leaves only (for
example `Optimizer(student[module], lr, betas=(0.9, 0.999),
weight_decay=0.0)`, optax's adam) and updates them in place.  The steps
and the diagnostics are compiled by default, as the JAX package jits them
(`runtime/graphs.py`).
"""

from __future__ import annotations

import torch

from ..models import chain, phone_extractor, pitch_estimator, waveform_generator
from ..runtime import graphs
from .distill import multi_resolution_stft_loss, run_update, trainer_config


def teacher_taps(params, cfg, audio16, cond):
    """The frozen teacher's forward with every supervision point: the
    chain's taps and "audio24"."""
    state = chain.init_state(cfg, (audio16.shape[0],), audio16.device)
    audio24, _, taps = chain.apply(params, cfg, audio16, state, cond, with_taps=True)
    return {**taps, "audio24": audio24}


def phone_loss(student_phone_params, cfg, audio16, t_phone, cond):
    state = phone_extractor.init_state(cfg.phone, (audio16.shape[0],), audio16.device)
    phone, _ = phone_extractor.apply(student_phone_params, cfg.phone, audio16, state)
    return torch.mean((phone - t_phone) ** 2)


def pitch_loss(student_pitch_params, cfg, audio16, t_logits, t_feats, cond):
    state = pitch_estimator.init_state(cfg.pitch, (audio16.shape[0],), audio16.device)
    _, feats, _, logits = pitch_estimator.apply(
        student_pitch_params, cfg.pitch, audio16, state, cond["min_q"], cond["max_q"],
        with_logits=True)
    t_soft = torch.softmax(t_logits, dim=-1)
    log_p = torch.log_softmax(logits, -1)
    ce = -torch.mean(torch.sum(t_soft * log_p, -1))
    l_feat = torch.mean((feats - t_feats) ** 2)
    l_logit = torch.mean((logits - t_logits) ** 2)
    t_best = torch.argmax(t_logits, dim=-1)[..., None]  # [B, T, 1]
    ce_hard = -torch.mean(torch.gather(log_p, -1, t_best)[..., 0])
    s_at_best = torch.gather(logits, -1, t_best)  # [B, T, 1]
    delta = 1.0
    margin = torch.clamp(logits - s_at_best + delta, min=0.0)
    l_rank = torch.mean(torch.sum(margin, -1) - delta)
    return l_logit + l_feat + 0.1 * ce + 0.5 * ce_hard + 0.1 * l_rank


def wg_loss(student_wg_params, cfg, taps, cond):
    cfg = trainer_config(cfg)
    b = taps["phone"].shape[0]
    state = waveform_generator.init_state(cfg.wg, (b,), taps["phone"].device)
    audio24, _ = waveform_generator.apply(
        student_wg_params, cfg.wg, taps["phone"], taps["qp"], taps["pitch_feats"],
        cond["speaker_embedding"], state, kv_embedding=cond.get("kv"))
    t = taps["audio24"]
    l1 = torch.mean(torch.abs(audio24 - t))
    l2 = torch.mean((audio24 - t) ** 2)
    return l1 + 10.0 * l2 + 0.1 * multi_resolution_stft_loss(audio24, t)


def module_step(student_params, opt, teacher_params, batch, *, cfg, module: str,
                jit: bool | None = None):
    """One distillation step of one module ("phone", "pitch" or "wg";
    `feature_distill.py:124`): the teacher's taps, the module's loss, its
    gradient and one update of `opt` (over student_params[module]'s
    leaves).  Returns (student_params, opt, {"loss"}).  Compiled (`jit`
    None or True), one step of the step cache per module
    (`distill.run_update`: one CUDA graph on the card); `jit=False` runs
    it op by op."""
    if not graphs.resolve_jit(jit):
        loss = _module_step(student_params[module], opt, teacher_params, batch, opt.step,
                            cfg=cfg, module=module)
    else:
        loss = run_update(
            ("module_step", module, cfg, graphs.identity(teacher_params)),
            lambda p, o, b: _module_step(p, o, teacher_params, b, o.update, cfg=cfg,
                                         module=module),
            (student_params[module],), (opt,), batch)
    return student_params, opt, {"loss": loss}


def _module_step(p, opt, teacher_params, batch, update, *, cfg, module):
    audio16, cond = batch["audio16"], batch["cond"]
    with torch.no_grad():
        taps = teacher_taps(teacher_params, cfg, audio16, cond)
    if module == "phone":
        loss = phone_loss(p, cfg, audio16, taps["phone"], cond)
    elif module == "pitch":
        loss = pitch_loss(p, cfg, audio16, taps["pitch_logits"], taps["pitch_feats"], cond)
    else:
        loss = wg_loss(p, cfg, taps, cond)
    opt.zero_grad()
    loss.backward()
    update()
    return loss.detach()


def end_to_end_error(student_params, teacher_params, batch, *, cfg, jit: bool | None = None):
    """Waveform error of the student chain against the teacher's, with
    per-stage diagnostics (`feature_distill.py:148`): the student vocoder
    from the teacher's taps (wg only), and from the student's features
    with the teacher's bins.  Compiled (`jit` None or True) through the
    step cache, keyed by the identity of both chains' parameters."""
    return _diagnostics(_end_to_end_error, "end_to_end_error", student_params,
                        teacher_params, batch, cfg, jit)


def end_to_end_error_soft(student_params, teacher_params, batch, *, cfg,
                          jit: bool | None = None):
    """Student-against-teacher waveform parity with both chains in the
    soft-pitch mode (`feature_distill.py:196`), compiled as
    `end_to_end_error`."""
    return _diagnostics(_end_to_end_error_soft, "end_to_end_error_soft", student_params,
                        teacher_params, batch, cfg, jit)


def _diagnostics(fn, name, student_params, teacher_params, batch, cfg, jit):
    if not graphs.resolve_jit(jit):
        return fn(student_params, teacher_params, batch, cfg)
    return graphs.call((name, cfg, graphs.identity(student_params, teacher_params)),
                       lambda b: fn(student_params, teacher_params, b, cfg), batch)


@torch.no_grad()
def _end_to_end_error(student_params, teacher_params, batch, cfg):
    audio16, cond = batch["audio16"], batch["cond"]
    t = teacher_taps(teacher_params, cfg, audio16, cond)
    b = audio16.shape[0]
    dev = audio16.device
    s_audio, _, s = chain.apply(student_params, cfg, audio16,
                                chain.init_state(cfg, (b,), dev), cond, with_taps=True)
    qp_match = torch.mean((s["qp"] == t["qp"]).float())

    def render(phone, qp, feats):
        return waveform_generator.apply(
            student_params["wg"], cfg.wg, phone, qp, feats, cond["speaker_embedding"],
            waveform_generator.init_state(cfg.wg, (b,), dev), kv_embedding=cond.get("kv"))[0]

    wg_only = render(t["phone"], t["qp"], t["pitch_feats"])
    forced_bins = render(s["phone"], t["qp"], s["pitch_feats"])
    d = s_audio - t["audio24"]
    return {
        "wav_l1": torch.mean(torch.abs(d)),
        "wav_max": torch.max(torch.abs(d)),
        "wav_rms": torch.sqrt(torch.mean(d ** 2)),
        "teacher_rms": torch.sqrt(torch.mean(t["audio24"] ** 2)),
        "phone_rmse": torch.sqrt(torch.mean((s["phone"] - t["phone"]) ** 2)),
        "qp_match": qp_match,
        "feats_rmse": torch.sqrt(torch.mean((s["pitch_feats"] - t["pitch_feats"]) ** 2)),
        "wg_only_wav_l1": torch.mean(torch.abs(wg_only - t["audio24"])),
        "teacher_bins_wav_l1": torch.mean(torch.abs(forced_bins - t["audio24"])),
    }


@torch.no_grad()
def _end_to_end_error_soft(student_params, teacher_params, batch, cfg):
    audio16, cond = batch["audio16"], batch["cond"]
    b = audio16.shape[0]
    dev = audio16.device
    t_audio, _, t = chain.apply(teacher_params, cfg, audio16, chain.init_state(cfg, (b,), dev),
                                cond, with_taps=True, soft_pitch=True)
    s_audio, _, s = chain.apply(student_params, cfg, audio16, chain.init_state(cfg, (b,), dev),
                                cond, with_taps=True, soft_pitch=True)
    return {
        "wav_l1_soft": torch.mean(torch.abs(s_audio - t_audio)),
        "wav_max_soft": torch.max(torch.abs(s_audio - t_audio)),
        "qp_l1_bins_soft": torch.mean(torch.abs(s["qp"].float() - t["qp"].float())),
    }
