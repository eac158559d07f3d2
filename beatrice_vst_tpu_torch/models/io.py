"""Model directory IO (port of `beatrice_vst_tpu/models/io.py`).

A model directory holds:
    config.toml    the model card (params/model_config.py)
    weights.npz    chain parameters, flattened "a/b/0/w" -> array
    speakers.npz   the speaker bank (speakers/bank.py)

`load_weights` gives nested dicts and lists of torch tensors in the JAX
package's layouts on a device; `load_model_dir` gives host (numpy)
arrays, which `StreamEngine` and `convert_utterance` move to their device
with `params_from_numpy`."""

from __future__ import annotations

import os

import numpy as np
import torch

from ..constants import VERSIONS
from ..device import resolve_device
from ..errors import BeatriceError, ErrorCode
from ..params.model_config import (ModelConfig, Portrait, Voice, load_model_config,
                                   write_model_config)

WEIGHTS_FILE = "weights.npz"
SPEAKERS_FILE = "speakers.npz"
CONFIG_FILE = "config.toml"


def _numpy(value) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def flatten_params(params, prefix=""):
    """Nested dicts and lists -> {"a/b/0/w": leaf} (`io.py:30`)."""
    out = {}
    if isinstance(params, dict):
        items = params.items()
    elif isinstance(params, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(params))
    else:
        raise TypeError(type(params))
    for k, v in items:
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, (dict, list, tuple)):
            out.update(flatten_params(v, key))
        else:
            out[key] = v
    return out


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


def save_weights(path: str, params) -> None:
    """Write `weights.npz` from a tree of tensors or arrays (`io.py:68`)."""
    np.savez(path, **{k: _numpy(v) for k, v in flatten_params(params).items()})


def save_model_dir(dirpath: str, config: ModelConfig, params, bank) -> None:
    """Write a model directory: card, weights and speaker bank."""
    from ..speakers import bank as bank_mod

    os.makedirs(dirpath, exist_ok=True)
    write_model_config(config, os.path.join(dirpath, CONFIG_FILE))
    save_weights(os.path.join(dirpath, WEIGHTS_FILE), params)
    bank_mod.save(os.path.join(dirpath, SPEAKERS_FILE), bank)


def load_model_dir(path: str):
    """(config, model_cfg, params, bank) from a model directory or its
    config.toml (`io.py:86`): params and bank as numpy arrays.  Raises
    BeatriceError(INVALID_MODEL_CONFIG) when the bank has fewer speakers
    than the card lists."""
    from ..speakers import bank as bank_mod
    from .chain import VoiceConverterConfig

    if path.endswith(".toml"):
        config = load_model_config(path)
        dirpath = os.path.dirname(os.path.abspath(path))
    else:
        dirpath = path
        config = load_model_config(os.path.join(dirpath, CONFIG_FILE))
    spec = config.spec
    weights = os.path.join(dirpath, WEIGHTS_FILE)
    if not os.path.exists(weights):
        raise BeatriceError(ErrorCode.FILE_OPEN_ERROR, weights)
    with np.load(weights) as z:
        params = unflatten_params({k: z[k] for k in z.files})
    bank = {k: v.numpy() for k, v in bank_mod.load(os.path.join(dirpath, SPEAKERS_FILE), spec,
                                                     device="cpu").items()}
    if bank_mod.n_speakers(bank) < config.voice_count:
        raise BeatriceError(
            ErrorCode.INVALID_MODEL_CONFIG,
            f"bank has {bank_mod.n_speakers(bank)} speakers, card lists {config.voice_count}")
    return config, VoiceConverterConfig.for_version(spec), params, bank


def init_random_model_dir(dirpath: str, version: str = "2.0.0-rc.0", n_voices: int = 4,
                          seed: int = 0, name: str = "random-init"):
    """Create a runnable (untrained) model directory (`io.py:106`): the
    port's `chain.init` and `random_bank`, each from a seeded CPU
    generator (seed and seed + 1).  The keys, shapes and distributions are
    the JAX package's; the values are not (another generator)."""
    from ..speakers import bank as bank_mod
    from . import chain

    spec = VERSIONS[version]
    model_cfg = chain.VoiceConverterConfig.for_version(spec)
    params = chain.init(torch.Generator().manual_seed(seed), model_cfg, "cpu")
    bank = bank_mod.random_bank(torch.Generator().manual_seed(seed + 1), spec, n_voices,
                                device="cpu")
    config = ModelConfig(
        version=version, name=name, description="randomly initialized model",
        voices=tuple(Voice(name=f"voice{i}", description="", average_pitch=60.0,
                           portrait=Portrait()) for i in range(n_voices)),
        path=os.path.abspath(dirpath))
    save_model_dir(dirpath, config, params, bank)
    return config, model_cfg, params, bank
