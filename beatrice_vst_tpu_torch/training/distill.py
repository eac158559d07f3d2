"""Distillation objective, optimizer and one training step (port of
`beatrice_vst_tpu/training/distill.py`).

Losses: multi-resolution STFT (spectral convergence plus log-magnitude
L1, at three resolutions) and waveform L1; with ground-truth pitch bins,
cross-entropy on the pitch logits and a BCE on the voicing gate; with a
weight, the periodicity of the rendered waveform at the conditioned F0.

Parameters stay the port's nested dicts and lists of tensors; `trainable`
makes them f32 leaf tensors that require grad, and `Optimizer` holds the
flattened leaves: `torch.optim.AdamW` with optax's adamw semantics
(decoupled weight decay, eps outside the square root), an optional
warmup-cosine `LambdaLR` and an optional global-norm clip written as
optax's `clip_by_global_norm`.  The vocoder's upsampler head runs its
plain PyTorch version under autograd (`trainer_config`): the CUDA kernel
has no backward.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..device import resolve_device
from ..models import chain
from ..models.io import params_from_numpy

STFT_RESOLUTIONS = ((512, 128), (1024, 256), (256, 64))  # (fft, hop)


def trainer_config(cfg):
    """cfg with the vocoder's upsampler head on its plain version at T = 1
    (`upsampler_kernel=False`): the kernel has no backward, as the JAX
    kernel has no VJP and the JAX trainer runs the XLA head."""
    if not cfg.wg.upsampler_kernel:
        return cfg
    return dataclasses.replace(cfg, wg=dataclasses.replace(cfg.wg, upsampler_kernel=False))


def tree_leaves(tree) -> list:
    """The leaves of nested dicts, lists and tuples in the JAX package's
    order (dict keys sorted), as `jax.tree_util.tree_leaves`."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree):
    """fn applied to every leaf, the structure kept."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def trainable(params, device="cuda"):
    """A params tree (numpy arrays or tensors, the JAX package's layouts)
    -> the same tree of fresh f32 leaf tensors on `device` that require
    grad."""
    dev = resolve_device(device)
    return tree_map(lambda x: x.detach().float().clone().requires_grad_(True),
                    params_from_numpy(params, dev))


def _stft_mag(x, n_fft: int, hop: int):
    """[B, n] -> [B, frames, bins] magnitude of Hann-windowed frames
    (`jnp.hanning`: the symmetric window).  As the JAX package's gather,
    an index past the end reads the last sample (a signal shorter than
    n_fft gives one frame)."""
    n = x.shape[-1]
    frames = max(1, (n - n_fft) // hop + 1)
    dev = x.device
    idx = (torch.arange(frames, device=dev)[:, None] * hop
           + torch.arange(n_fft, device=dev)[None, :]).clamp(max=n - 1)
    win = torch.hann_window(n_fft, periodic=False, dtype=x.dtype, device=dev)
    return torch.fft.rfft(x[..., idx] * win, dim=-1).abs()


def multi_resolution_stft_loss(pred, target):
    loss = 0.0
    for n_fft, hop in STFT_RESOLUTIONS:
        p = _stft_mag(pred, n_fft, hop)
        t = _stft_mag(target, n_fft, hop)
        sc = torch.linalg.norm(t - p) / (torch.linalg.norm(t) + 1e-6)  # spectral convergence
        mag = torch.mean(torch.abs(torch.log(p + 1e-5) - torch.log(t + 1e-5)))
        loss = loss + sc + mag
    return loss / len(STFT_RESOLUTIONS)


def f0_to_bin(f0_hz, pitch_bins: int):
    """True F0 (Hz) -> quantized pitch bin (bin = (midi - 33) * 8, the
    vocoder's fixed mapping); f0 <= 0 maps to bin 0 (unvoiced).  NumPy."""
    f0 = np.asarray(f0_hz, np.float32)
    midi = 69.0 + 12.0 * np.log2(np.maximum(f0, 1e-3) / 440.0)
    bins = np.clip(np.round((midi - 33.0) * 8.0), 1, pitch_bins - 1)
    return np.where(f0 > 0, bins, 0).astype(np.int32)


def pitch_supervision_losses(taps, f0_bin):
    """(CE on the pitch bins over voiced frames, BCE of the voicing gate
    -- pitch feature 0 as a logit) from chain taps; f0_bin [B, T] int,
    0 = unvoiced (`distill.py:65`)."""
    logits = taps["pitch_logits"]  # [B, T, bins]
    t = min(logits.shape[1], f0_bin.shape[1])
    lg, fb = logits[:, :t], f0_bin[:, :t].to(torch.int64)
    voiced = (fb > 0).float()
    ce = -torch.gather(torch.log_softmax(lg, -1), -1, fb[..., None])[..., 0]
    l_f0 = torch.sum(ce * voiced) / torch.clamp(voiced.sum(), min=1.0)
    per = taps["pitch_feats"][:, :t, 0]
    l_voice = torch.mean(torch.clamp(per, min=0) - per * voiced
                         + torch.log1p(torch.exp(-torch.abs(per))))
    return l_f0, l_voice


def periodicity_loss(pred24, f0_bin, frame: int = 240, window: int = 480):
    """1 - the normalized autocorrelation of the rendered 24 kHz waveform
    at the ground-truth period lag, averaged over voiced frames whose
    window and lag stay inside the signal (`distill.py:93`).  Both gathers
    are clamped to the signal (the JAX package clamps the lagged one and
    relies on the gather's own clamping for the other); the mask keeps
    the clamped frames out."""
    bsz, n = pred24.shape
    dev = pred24.device
    t_n = min(f0_bin.shape[1], n // frame)
    fb = f0_bin[:, :t_n]
    midi = fb.float() / 8.0 + 33.0
    f0 = 440.0 * 2.0 ** ((midi - 69.0) / 12.0)
    lag = torch.clamp(torch.round(24000.0 / f0), 48.0, 440.0).to(torch.int64)
    starts = torch.arange(t_n, device=dev) * frame
    i = torch.arange(window, device=dev)
    idx0 = starts[:, None] + i[None, :]  # [T, W]
    max_idx = n - 1
    x0 = pred24[:, idx0.clamp(max=max_idx).reshape(-1)].reshape(bsz, t_n, window)
    idx1 = idx0[None] + lag[:, :, None]  # [B, T, W]
    valid = idx1[:, :, -1] <= max_idx
    x1 = torch.gather(pred24, 1, idx1.clamp(max=max_idx).reshape(bsz, -1)).reshape(
        bsz, t_n, window)
    dot = torch.sum(x0 * x1, -1)
    e0 = torch.sum(x0 * x0, -1)
    e1 = torch.sum(x1 * x1, -1)
    r = dot * torch.rsqrt(e0 * e1 + 1e-8)
    mask = (fb > 0).float() * valid.float()
    return torch.sum((1.0 - r) * mask) / torch.clamp(mask.sum(), min=1.0)


def distillation_loss(params, cfg, audio16, target24, cond, state=None, f0_bin=None,
                      f0_weight: float = 1.0, soft_pitch: bool = False,
                      periodicity_weight: float = 0.0):
    """Forward the chain and score it against the target 24 kHz waveform
    (`distill.py:151`): (total, {"stft", "l1"[, "f0", "voice"][, "perio"]}).
    f0_bin: optional [B, T] ground-truth pitch bins (0 = unvoiced)."""
    cfg = trainer_config(cfg)
    if state is None:
        state = chain.init_state(cfg, (audio16.shape[0],), audio16.device)
    aux = {}
    if f0_bin is None:
        pred, _ = chain.apply(params, cfg, audio16, state, cond, soft_pitch=soft_pitch)
    else:
        pred, _, taps = chain.apply(params, cfg, audio16, state, cond, with_taps=True,
                                    soft_pitch=soft_pitch)
        l_f0, l_voice = pitch_supervision_losses(taps, f0_bin)
        aux = {"f0": l_f0, "voice": l_voice}
    l_stft = multi_resolution_stft_loss(pred, target24)
    l_wav = torch.mean(torch.abs(pred - target24))
    total = (l_stft + l_wav + f0_weight * aux.get("f0", 0.0)
             + f0_weight * aux.get("voice", 0.0))
    if periodicity_weight and f0_bin is not None:
        l_perio = periodicity_loss(pred, f0_bin)
        total = total + periodicity_weight * l_perio
        aux["perio"] = l_perio
    return total, {"stft": l_stft, "l1": l_wav, **aux}


def warmup_cosine(lr: float, total_steps: int, warmup: int = 500):
    """optax.warmup_cosine_decay_schedule(0, lr, min(warmup, total_steps
    // 10 + 1), total_steps, 0.05 * lr) as a function of the update count
    (evaluated, as optax does, at the count before the update: step 0
    has lr 0)."""
    w = min(warmup, total_steps // 10 + 1)
    decay = total_steps - w
    if decay <= 0:
        raise ValueError(f"the cosine decay needs total_steps > {w}, got {total_steps}")
    alpha = 0.05

    def schedule(count: int) -> float:
        if count < w:
            return lr * count / w
        c = min(count - w, decay)
        return lr * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * c / decay)) + alpha)

    return schedule


class Optimizer:
    """optax's `adamw` (after `clip_by_global_norm` with clip_norm) over
    the leaves of a params tree.

    torch's AdamW is optax's adamw: decoupled weight decay lr * wd * p,
    bias-corrected moments, eps outside the square root.  A parameter
    without a gradient gets a zero one, so weight decay reaches it as in
    optax.  The moments are made at construction, so that a checkpoint
    holds the same leaves before the first step as after it."""

    def __init__(self, params, lr: float, *, betas, weight_decay: float, eps: float = 1e-8,
                 schedule=None, clip_norm: float | None = None):
        self.leaves = tree_leaves(params)
        self.adamw = torch.optim.AdamW(self.leaves, lr=lr, betas=betas, eps=eps,
                                       weight_decay=weight_decay)
        for p in self.leaves:
            self.adamw.state[p] = {"step": torch.tensor(0.0),
                                   "exp_avg": torch.zeros_like(p),
                                   "exp_avg_sq": torch.zeros_like(p)}
        self._lr = lr
        self._schedule = schedule
        self.scheduler = None
        if schedule is not None:
            self.scheduler = torch.optim.lr_scheduler.LambdaLR(
                self.adamw, lambda k: schedule(k) / lr)
        self.clip_norm = clip_norm

    def zero_grad(self) -> None:
        self.adamw.zero_grad(set_to_none=True)

    def step(self) -> None:
        """One update from the leaves' .grad, then the grads are cleared."""
        for p in self.leaves:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if self.clip_norm is not None:
            clip_by_global_norm_([p.grad for p in self.leaves], self.clip_norm)
        self.adamw.step()
        if self.scheduler is not None:
            self.scheduler.step()
        self.zero_grad()

    def state_tree(self) -> dict:
        """The state as a tree of tensors and an int, for checkpoints:
        per leaf AdamW's step, exp_avg and exp_avg_sq; the schedule's
        count."""
        st = self.adamw.state
        return {"adamw": [{k: st[p][k] for k in ("step", "exp_avg", "exp_avg_sq")}
                          for p in self.leaves],
                "count": 0 if self.scheduler is None else int(self.scheduler.last_epoch)}

    def load_state_tree(self, tree: dict) -> None:
        for p, s in zip(self.leaves, tree["adamw"], strict=True):
            for k, v in s.items():
                self.adamw.state[p][k].copy_(v)
        if self.scheduler is not None:
            self.scheduler.last_epoch = int(tree["count"])
            for g in self.adamw.param_groups:
                g["lr"] = self._schedule(int(tree["count"]))


def clip_by_global_norm_(grads, max_norm: float) -> None:
    """optax.clip_by_global_norm in place: with g_norm the L2 norm over
    every gradient, unchanged if g_norm < max_norm, else each gradient
    becomes (g / g_norm) * max_norm (torch's clip_grad_norm_ scales by
    max_norm / (g_norm + 1e-6) instead).  No host synchronisation."""
    norm = torch.sqrt(sum(torch.sum(g.float() * g.float()) for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, (g / norm.to(g.dtype)) * max_norm))


def make_optimizer(params, lr: float = 2e-4, weight_decay: float = 1e-2,
                   total_steps: int | None = None, warmup: int = 500) -> Optimizer:
    """AdamW (b1 0.9, b2 0.99, eps 1e-8) over the params' leaves; with
    total_steps, a linear-warmup cosine decay to 5 % of lr
    (`distill.py:182`)."""
    schedule = warmup_cosine(lr, total_steps, warmup) if total_steps else None
    return Optimizer(params, lr, betas=(0.9, 0.99), weight_decay=weight_decay,
                     schedule=schedule)


def train_step(params, optimizer: Optimizer, batch, *, cfg, f0_weight: float = 1.0,
               soft_pitch: bool = False, periodicity_weight: float = 0.0):
    """One distillation step (`distill.py:196`): the loss, its gradient and
    one update of the leaves in place.  batch: {audio16 [B, T*160],
    target24 [B, T*240], cond[, f0_bin [B, T]]}.  Returns (params,
    optimizer, metrics), the metrics detached tensors."""
    optimizer.zero_grad()
    loss, aux = distillation_loss(
        params, cfg, batch["audio16"], batch["target24"], batch["cond"],
        f0_bin=batch.get("f0_bin"), f0_weight=f0_weight, soft_pitch=soft_pitch,
        periodicity_weight=periodicity_weight)
    loss.backward()
    optimizer.step()
    return params, optimizer, {"loss": loss.detach(), **{k: v.detach() for k, v in aux.items()}}
