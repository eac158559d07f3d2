"""Training checkpoint/resume (port of `beatrice_vst_tpu/training/checkpoint.py`).

One `ckpt_<step>.npz` per checkpoint holds the leaves of the whole
training tree (parameters, optimizer moments and counts) as `leaf_00000`,
..., in the JAX package's leaf order (dict keys sorted), restored against
a `like` tree for structure: arrays only, no pickled objects, written to a
temporary file and renamed.
"""

from __future__ import annotations

import os
import re
import tempfile

import numpy as np
import torch

from .distill import tree_leaves

_PAT = re.compile(r"^ckpt_(\d+)\.npz$")


def _numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def save_checkpoint(ckpt_dir: str, step: int, tree) -> str:
    """Atomically write the training tree at `step`."""
    os.makedirs(ckpt_dir, exist_ok=True)
    arrays = {f"leaf_{i:05d}": _numpy(x) for i, x in enumerate(tree_leaves(tree))}
    path = os.path.join(ckpt_dir, f"ckpt_{step:08d}.npz")
    fd, tmp = tempfile.mkstemp(dir=ckpt_dir, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    return path


def available_steps(ckpt_dir: str):
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(m.group(1)) for m in map(_PAT.match, os.listdir(ckpt_dir)) if m)


def latest_step(ckpt_dir: str):
    steps = available_steps(ckpt_dir)
    return steps[-1] if steps else None


def _rebuild(like, leaves):
    """`like`'s structure with its leaves taken in order from `leaves`."""
    if isinstance(like, dict):
        out = {k: _rebuild(like[k], leaves) for k in sorted(like)}
        return {k: out[k] for k in like}
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, leaves) for v in like)
    return next(leaves)


def restore_checkpoint(ckpt_dir: str, like, step: int | None = None):
    """Restore the tree saved at `step` (default: the latest) against
    `like`: (step, tree), each tensor leaf with its like's dtype and
    device, each Python scalar a Python scalar.  Raises FileNotFoundError
    if there is no checkpoint and ValueError if the leaves' count or
    shapes differ from like's."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"ckpt_{step:08d}.npz")
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    like_leaves = tree_leaves(like)
    with np.load(path) as z:
        keys = sorted(z.files)
        if len(keys) != len(like_leaves):
            raise ValueError(f"checkpoint has {len(keys)} leaves, expected "
                             f"{len(like_leaves)} (structure changed?)")
        leaves = []
        for k, ref in zip(keys, like_leaves):
            arr = z[k]
            ref_shape = getattr(ref, "shape", None)
            if ref_shape is not None and tuple(arr.shape) != tuple(ref_shape):
                raise ValueError(f"leaf {k}: shape {arr.shape} != expected {tuple(ref_shape)}")
            if isinstance(ref, torch.Tensor):
                leaves.append(torch.from_numpy(arr).to(device=ref.device, dtype=ref.dtype))
            elif ref_shape is None:
                leaves.append(arr.item())
            else:
                leaves.append(arr.astype(ref.dtype))
    return step, _rebuild(like, iter(leaves))


def prune_checkpoints(ckpt_dir: str, keep: int = 3) -> None:
    steps = available_steps(ckpt_dir)
    for s in steps[:-keep] if keep > 0 else steps:
        os.unlink(os.path.join(ckpt_dir, f"ckpt_{s:08d}.npz"))
