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
warmup-cosine schedule written into its learning-rate tensor before each
update and an optional global-norm clip written as optax's
`clip_by_global_norm`.  The vocoder's upsampler head runs its
plain PyTorch version under autograd (`trainer_config`): the CUDA kernel
has no backward.  `train_step` is compiled by default, as the JAX
package jits it (`runtime/graphs.py`): the whole step is one CUDA graph
on the card.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..device import resolve_device
from ..models import chain
from ..models.io import params_from_numpy
from ..parallel.collectives import (all_reduce_grads_, dp_group, global_mean, global_norm,
                                    global_sum, is_sharded, model_group, reduce_sum)
from ..runtime import graphs

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


def multi_resolution_stft_loss(pred, target, group=None):
    """Spectral convergence plus log-magnitude L1 at each resolution; with a
    data-parallel `group`, of the whole batch (norms and means over every
    rank's rows, `parallel/collectives.py`)."""
    loss = 0.0
    for n_fft, hop in STFT_RESOLUTIONS:
        p = _stft_mag(pred, n_fft, hop)
        t = _stft_mag(target, n_fft, hop)
        # spectral convergence
        sc = global_norm(t - p, group) / (global_norm(t, group) + 1e-6)
        mag = global_mean(torch.abs(torch.log(p + 1e-5) - torch.log(t + 1e-5)), group)
        loss = loss + sc + mag
    return loss / len(STFT_RESOLUTIONS)


def f0_to_bin(f0_hz, pitch_bins: int):
    """True F0 (Hz) -> quantized pitch bin (bin = (midi - 33) * 8, the
    vocoder's fixed mapping); f0 <= 0 maps to bin 0 (unvoiced).  NumPy."""
    f0 = np.asarray(f0_hz, np.float32)
    midi = 69.0 + 12.0 * np.log2(np.maximum(f0, 1e-3) / 440.0)
    bins = np.clip(np.round((midi - 33.0) * 8.0), 1, pitch_bins - 1)
    return np.where(f0 > 0, bins, 0).astype(np.int32)


def pitch_supervision_losses(taps, f0_bin, group=None):
    """(CE on the pitch bins over voiced frames, BCE of the voicing gate
    -- pitch feature 0 as a logit) from chain taps; f0_bin [B, T] int,
    0 = unvoiced (`distill.py:65`).  With a data-parallel `group`, of the
    whole batch: the CE is the masked sum over every rank's rows over their
    voiced count, not a mean of the ranks' ratios."""
    logits = taps["pitch_logits"]  # [B, T, bins]
    t = min(logits.shape[1], f0_bin.shape[1])
    lg, fb = logits[:, :t], f0_bin[:, :t].to(torch.int64)
    voiced = (fb > 0).float()
    ce = -torch.gather(torch.log_softmax(lg, -1), -1, fb[..., None])[..., 0]
    l_f0 = global_sum(ce * voiced, group) / torch.clamp(global_sum(voiced, group), min=1.0)
    per = taps["pitch_feats"][:, :t, 0]
    l_voice = global_mean(torch.clamp(per, min=0) - per * voiced
                          + torch.log1p(torch.exp(-torch.abs(per))), group)
    return l_f0, l_voice


def periodicity_loss(pred24, f0_bin, frame: int = 240, window: int = 480, group=None):
    """1 - the normalized autocorrelation of the rendered 24 kHz waveform
    at the ground-truth period lag, averaged over voiced frames whose
    window and lag stay inside the signal (`distill.py:93`).  Both gathers
    are clamped to the signal (the JAX package clamps the lagged one and
    relies on the gather's own clamping for the other); the mask keeps
    the clamped frames out.  With a data-parallel `group`, the masked sum
    and the count are the whole batch's."""
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
    return global_sum((1.0 - r) * mask, group) / torch.clamp(global_sum(mask, group), min=1.0)


def distillation_loss(params, cfg, audio16, target24, cond, state=None, f0_bin=None,
                      f0_weight: float = 1.0, soft_pitch: bool = False,
                      periodicity_weight: float = 0.0, group=None):
    """Forward the chain and score it against the target 24 kHz waveform
    (`distill.py:151`): (total, {"stft", "l1"[, "f0", "voice"][, "perio"]}).
    f0_bin: optional [B, T] ground-truth pitch bins (0 = unvoiced).  With a
    data-parallel `group` the rows are this rank's and the losses the
    whole batch's."""
    cfg = trainer_config(cfg)
    if state is None:
        state = chain.init_state(cfg, (audio16.shape[0],), audio16.device)
    aux = {}
    if f0_bin is None:
        pred, _ = chain.apply(params, cfg, audio16, state, cond, soft_pitch=soft_pitch)
    else:
        pred, _, taps = chain.apply(params, cfg, audio16, state, cond, with_taps=True,
                                    soft_pitch=soft_pitch)
        l_f0, l_voice = pitch_supervision_losses(taps, f0_bin, group)
        aux = {"f0": l_f0, "voice": l_voice}
    l_stft = multi_resolution_stft_loss(pred, target24, group)
    l_wav = global_mean(torch.abs(pred - target24), group)
    total = (l_stft + l_wav + f0_weight * aux.get("f0", 0.0)
             + f0_weight * aux.get("voice", 0.0))
    if periodicity_weight and f0_bin is not None:
        l_perio = periodicity_loss(pred, f0_bin, group=group)
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


def cosine_decay(lr: float, total_steps: int):
    """optax.cosine_decay_schedule(lr, total_steps) (alpha 0) as a function
    of the update count, evaluated, as optax does, at the count before the
    update (step 0 runs at lr) and in float32, as optax evaluates it."""
    if total_steps <= 0:
        raise ValueError(f"the cosine decay needs total_steps > 0, got {total_steps}")
    f32 = np.float32

    def schedule(count: int) -> float:
        c = f32(min(count, total_steps))
        cos = np.cos(f32(math.pi) * c / f32(total_steps), dtype=f32)
        return float(f32(lr) * (f32(0.5) * (f32(1.0) + cos)))

    return schedule


class Optimizer:
    """optax's `adamw` (after `clip_by_global_norm` with clip_norm) over
    the leaves of a params tree.

    torch's AdamW is optax's adamw: decoupled weight decay lr * wd * p,
    bias-corrected moments, eps outside the square root.  A parameter
    without a gradient gets a zero one, so weight decay reaches it as in
    optax.  The moments are made at construction, so that a checkpoint
    holds the same leaves before the first step as after it.

    The learning rate is a tensor on the leaves' device (`lr`) and
    AdamW's step counts live there too: on CUDA AdamW is capturable, so
    that `update`, the device half of a step, can be captured in a CUDA
    graph (the compiled `train_step`), which reads `lr` at its address.
    `prepare`, the host half, writes the schedule's value at the host's
    count of updates (`count`) into `lr` before each update.  AdamW runs
    over the leaves' blocks (`blocks`): a leaf split over 'model' (a
    `DTensor`) is updated on its local block, from its gradient's block,
    so that split and whole leaves go through one capturable update."""

    def __init__(self, params, lr: float, *, betas, weight_decay: float, eps: float = 1e-8,
                 schedule=None, clip_norm: float | None = None):
        self.leaves = tree_leaves(params)
        self.blocks = [graphs.block(p) for p in self.leaves]
        self._kw = dict(lr=lr, betas=betas, weight_decay=weight_decay, eps=eps,
                        schedule=schedule, clip_norm=clip_norm)
        self._lr = lr
        self._schedule = schedule
        self.clip_norm = clip_norm
        self.count = 0
        dev = self.blocks[0].device
        capturable = dev.type == "cuda"
        # float64 where AdamW is not capturable: the arithmetic of a Python
        # float learning rate, bit for bit
        self.lr = torch.tensor(self._lr_at(0), device=dev,
                               dtype=torch.float32 if capturable else torch.float64)
        self.adamw = torch.optim.AdamW(self.blocks, lr=self.lr, betas=betas, eps=eps,
                                       weight_decay=weight_decay, capturable=capturable)
        step_dev = dev if capturable else "cpu"
        for b in self.blocks:
            self.adamw.state[b] = {"step": torch.zeros((), device=step_dev),
                                   "exp_avg": torch.zeros_like(b),
                                   "exp_avg_sq": torch.zeros_like(b)}

    def _lr_at(self, count: int) -> float:
        return self._lr if self._schedule is None else self._schedule(count)

    def zero_grad(self) -> None:
        for p in self.leaves:
            p.grad = None
        self.adamw.zero_grad(set_to_none=True)

    def step(self) -> None:
        """One update from the leaves' .grad, then the grads are cleared."""
        self.prepare()
        self.update()

    def prepare(self) -> None:
        """The host half of a step: the schedule's learning rate at the
        count of updates so far written into `lr`, and the count advanced."""
        if self._schedule is not None:
            self.lr.fill_(self._schedule(self.count))
        self.count += 1

    def update(self) -> None:
        """The device half of a step: the update from the leaves' .grad,
        then the grads are cleared.  No host synchronisation."""
        for p in self.leaves:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if self.clip_norm is not None:
            clip_by_global_norm_([p.grad for p in self.leaves], self.clip_norm)
        for p, b in zip(self.leaves, self.blocks):
            if b is not p:
                b.grad = graphs.block(p.grad)
        self.adamw.step()
        self.zero_grad()

    def state_tree(self) -> dict:
        """The state as a tree of tensors and an int, for checkpoints:
        per leaf AdamW's step, exp_avg and exp_avg_sq (of its block); the
        schedule's count."""
        st = self.adamw.state
        return {"adamw": [{k: st[b][k] for k in ("step", "exp_avg", "exp_avg_sq")}
                          for b in self.blocks],
                "count": 0 if self._schedule is None else self.count}

    def load_state_tree(self, tree: dict) -> None:
        for b, s in zip(self.blocks, tree["adamw"], strict=True):
            for k, v in s.items():
                self.adamw.state[b][k].copy_(v)
        self.count = int(tree["count"])

    def scratch(self, params) -> "Optimizer":
        """An optimizer with these settings and a copy of this one's state
        over `params` (copies of the leaves, in the same tree): a compiled
        step's warm-up calls run on it."""
        opt = Optimizer(params, **self._kw)
        opt.load_state_tree(self.state_tree())
        return opt


def compile_update(fn, params: tuple, optimizers: tuple, batch) -> graphs.CompiledStep:
    """A compiled step of `fn(*params, *optimizers, batch)`, a step that
    updates the leaves of each params tree with its optimizer (by position)
    in place and returns its metrics: over the live leaves and optimizers
    and a static copy of the batch, with the warm-up calls on scratch
    copies of both (the leaves and their optimizer states stay as they
    are).  The grads are cleared first (PyTorch's whole-network capture:
    the graph's pool then owns the grads its backward pass makes)."""
    for opt in optimizers:
        opt.zero_grad()
    scratch = tuple(tree_map(lambda p: p.detach().clone().requires_grad_(p.requires_grad), t)
                    for t in params)
    scratch_opts = tuple(opt.scratch(t) for opt, t in zip(optimizers, scratch, strict=True))
    static = graphs.clone_tree(batch)
    return graphs.CompiledStep(fn, (*params, *optimizers, static),
                               warmup_args=(*scratch, *scratch_opts, static))


def run_update(key, fn, params: tuple, optimizers: tuple, batch, mesh=None):
    """`fn` (as `compile_update` takes it) as a compiled step from the
    step cache, keyed by `key`, the identity of the leaves (of a split
    leaf, its block) and the optimizers, the mesh (`graphs.mesh_key`) and
    the batch's signature: each optimizer's host half (`prepare`), the
    batch copied in, the step run.  Returns its metrics, cloned.  On a
    mesh every rank builds and calls the same steps in the same order, so
    that the collectives of the warm-up calls, the capture and each replay
    meet their peers'."""
    key = (key, graphs.identity(*params), tuple(id(o) for o in optimizers),
           graphs.mesh_key(mesh), graphs.signature(batch))
    step = graphs.CACHE.get(key, lambda: compile_update(fn, params, optimizers, batch))
    with step.lock:
        for opt in optimizers:
            opt.prepare()
        graphs.copy_tree_(step.args[-1], batch)
        return graphs.clone_tree(step())


def resolve_step_jit(jit, mesh, split: bool) -> bool:
    """`graphs.resolve_jit` for a training step: its body issues
    collectives where the mesh has a 'streams' group (the gradients' sum)
    or weights are `split` over 'model' (a 1 x 1 mesh splits them too)."""
    return graphs.resolve_jit(jit, mesh, collectives=dp_group(mesh) is not None or split)


def clip_by_global_norm_(grads, max_norm: float) -> None:
    """optax.clip_by_global_norm in place: with g_norm the L2 norm over
    every gradient, unchanged if g_norm < max_norm, else each gradient
    becomes (g / g_norm) * max_norm (torch's clip_grad_norm_ scales by
    max_norm / (g_norm + 1e-6) instead).  No host synchronisation.  The
    gradient of a leaf split over 'model' counts with every rank's block
    (its squares summed over the 'model' group)."""
    squares = [torch.sum(g.float() * g.float()) for g in grads if not is_sharded(g)]
    for g in grads:
        if is_sharded(g):
            block = g.to_local().float()
            squares.append(reduce_sum(torch.sum(block * block), model_group(g)))
    norm = torch.sqrt(sum(squares))
    keep = norm < max_norm
    for g in grads:
        g = g.to_local() if is_sharded(g) else g
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
               soft_pitch: bool = False, periodicity_weight: float = 0.0, mesh=None,
               jit: bool | None = None):
    """One distillation step (`distill.py:196`): the loss, its gradient and
    one update of the leaves in place.  batch: {audio16 [B, T*160],
    target24 [B, T*240], cond[, f0_bin [B, T]]}.  Returns (params,
    optimizer, metrics), the metrics detached tensors.

    Compiled (`resolve_step_jit`: by default wherever a CUDA graph can
    hold the step), the forward pass, the backward pass, the clip and the
    AdamW update are one step of the step cache (`run_update`): one CUDA
    graph on the card, keyed by the identity of the leaves and the
    optimizer and by the mesh, the batch copied into its static tensors;
    `jit=False` runs it op by op.

    With a `mesh` (`parallel/mesh.py`) whose 'streams' axis has several
    ranks, the batch is this rank's rows (`shard_tree`), the loss is the
    whole batch's and the gradients are summed over 'streams' before the
    update, so every rank's parameters stay the same; weights split over
    'model' (`DTensor`s) keep their gradients on their blocks.  The
    compiled step holds those collectives on NCCL ranks; on gloo ranks on
    the card it is eager (and `jit=True` raises)."""
    kw = dict(cfg=cfg, f0_weight=f0_weight, soft_pitch=soft_pitch,
              periodicity_weight=periodicity_weight, group=dp_group(mesh))
    if not resolve_step_jit(jit, mesh, any(is_sharded(p) for p in tree_leaves(params))):
        metrics = _train_step(params, optimizer, batch, optimizer.step, **kw)
        return params, optimizer, metrics
    metrics = run_update(("train_step", cfg, f0_weight, soft_pitch, periodicity_weight),
                         lambda p, opt, b: _train_step(p, opt, b, opt.update, **kw),
                         (params,), (optimizer,), batch, mesh)
    return params, optimizer, metrics


def _train_step(params, optimizer, batch, update, *, cfg, f0_weight, soft_pitch,
                periodicity_weight, group=None):
    optimizer.zero_grad()
    loss, aux = distillation_loss(
        params, cfg, batch["audio16"], batch["target24"], batch["cond"],
        f0_bin=batch.get("f0_bin"), f0_weight=f0_weight, soft_pitch=soft_pitch,
        periodicity_weight=periodicity_weight, group=group)
    loss.backward()
    if group is not None:
        all_reduce_grads_(optimizer.leaves, group)
    update()
    return {"loss": loss.detach(), **{k: v.detach() for k, v in aux.items()}}
