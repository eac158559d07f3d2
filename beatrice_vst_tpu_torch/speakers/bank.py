"""Speaker bank loader: `speakers.npz` -> dict of tensors (port of
`beatrice_vst_tpu/speakers/bank.py:66 load`, npz format).

2.0.0-rc.0 contents: additive [n, 256], formant [9, 256],
codebook [n, 512, 128], kv [n, 384, 128].
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..constants import MAX_N_SPEAKERS, VersionSpec, WAVEFORM_GENERATOR_HIDDEN_CHANNELS as HID
from ..device import resolve_device
from ..errors import BeatriceError, ErrorCode


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
