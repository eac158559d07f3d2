"""Weight IO: `weights.npz` (flattened "a/b/0/w" keys, as written by
`beatrice_vst_tpu/models/io.py:save_weights`) -> nested dicts and lists
of torch tensors in the JAX package's layouts."""

from __future__ import annotations

import os

import numpy as np
import torch

from ..device import resolve_device
from ..errors import BeatriceError, ErrorCode


def unflatten_params(flat):
    """{"a/b/0/w": x} -> {"a": {"b": [{"w": x}]}} (`io.py:48`): a level
    whose keys are all digits becomes a list."""
    tree: dict = {}
    for key, value in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value

    def listify(node):
        if not isinstance(node, dict):
            return node
        keys = list(node.keys())
        if keys and all(k.isdigit() for k in keys):
            return [listify(node[str(i)]) for i in range(len(keys))]
        return {k: listify(v) for k, v in node.items()}

    return listify(tree)


def params_from_numpy(tree, device="cuda"):
    """The JAX package's parameters (nested dicts/lists or a flat
    "a/b/0/w" dict of numpy-convertible arrays) -> the same tree of torch
    tensors on `device`, layouts unchanged."""
    dev = resolve_device(device)
    if isinstance(tree, dict) and any("/" in k for k in tree):
        tree = unflatten_params(tree)

    def convert(node):
        if isinstance(node, dict):
            return {k: convert(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [convert(v) for v in node]
        if isinstance(node, torch.Tensor):
            return node.to(dev)
        return torch.from_numpy(np.array(node)).to(dev)

    return convert(tree)


def load_weights(path: str, device="cuda"):
    """Load `weights.npz` as nested tensors on `device` (`io.py:72`)."""
    if not os.path.exists(path):
        raise BeatriceError(ErrorCode.FILE_OPEN_ERROR, path)
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    return params_from_numpy(unflatten_params(flat), device)
