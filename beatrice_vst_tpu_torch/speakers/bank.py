"""Speaker banks: the `speakers.npz` loader (port of
`beatrice_vst_tpu/speakers/bank.py:66 load`, npz format) and
`random_bank` for models without trained weights.

Contents: additive [n, 256] and formant [9, 256]; 2.0.0-rc.0 adds
codebook [n, 512, 128] and kv [n, 384, 128].
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..constants import (MAX_N_SPEAKERS, N_FORMANT_SHIFT_EMBEDDINGS, VersionSpec,
                         WAVEFORM_GENERATOR_HIDDEN_CHANNELS as HID)
from ..device import resolve_device
from ..errors import BeatriceError, ErrorCode


def random_bank(gen: torch.Generator, spec: VersionSpec, n_speakers: int, scale: float = 0.5,
                device="cuda"):
    """A random bank with the JAX package's keys, shapes and distributions
    (`bank.py:36`), drawn from `gen` (a CPU generator): additive
    N(0, scale^2), formant N(0, (scale/5)^2), codebook N(0, 1), kv
    N(0, scale^2)."""
    if not 1 <= n_speakers <= MAX_N_SPEAKERS:
        raise BeatriceError(ErrorCode.SPEAKER_ID_OUT_OF_RANGE, str(n_speakers))
    bank = {
        "additive": torch.randn((n_speakers, HID), generator=gen) * scale,
        "formant": torch.randn((N_FORMANT_SHIFT_EMBEDDINGS, HID), generator=gen) * (scale * 0.2),
    }
    if spec.has_vq:
        bank["codebook"] = torch.randn((n_speakers, spec.codebook_size, spec.phone_channels),
                                       generator=gen)
    if spec.has_kv:
        bank["kv"] = torch.randn((n_speakers, spec.kv_length, spec.kv_channels),
                                 generator=gen) * scale
    dev = resolve_device(device)
    return {k: v.to(dev) for k, v in bank.items()}


def n_speakers(bank) -> int:
    return bank["additive"].shape[0]


def load(path: str, spec: VersionSpec, device="cuda"):
    """Load and validate an .npz speaker bank onto `device`."""
    dev = resolve_device(device)
    if not os.path.exists(path):
        raise BeatriceError(ErrorCode.FILE_OPEN_ERROR, path)
    if not path.endswith(".npz"):
        raise BeatriceError(ErrorCode.FILE_OPEN_ERROR, f"{path}: only .npz banks are ported")
    with np.load(path) as z:
        bank = {k: torch.from_numpy(z[k]).to(dev) for k in z.files}
    validate(bank, spec)
    return bank


def validate(bank, spec: VersionSpec) -> None:
    if "additive" not in bank or bank["additive"].ndim != 2:
        raise BeatriceError(ErrorCode.INVALID_FILE_SIZE, "missing additive embeddings")
    n = bank["additive"].shape[0]
    if not 1 <= n <= MAX_N_SPEAKERS:
        raise BeatriceError(ErrorCode.SPEAKER_ID_OUT_OF_RANGE, str(n))
    if bank["additive"].shape[1] != HID:
        raise BeatriceError(ErrorCode.INVALID_FILE_SIZE, "additive dim")
    if spec.has_vq and "codebook" in bank:
        if tuple(bank["codebook"].shape) != (n, spec.codebook_size, spec.phone_channels):
            raise BeatriceError(ErrorCode.INVALID_FILE_SIZE, "codebook shape")
    if spec.has_kv and "kv" in bank:
        if tuple(bank["kv"].shape) != (n, spec.kv_length, spec.kv_channels):
            raise BeatriceError(ErrorCode.INVALID_FILE_SIZE, "kv shape")
