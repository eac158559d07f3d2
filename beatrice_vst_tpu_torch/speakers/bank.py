"""Speaker banks (port of `beatrice_vst_tpu/speakers/bank.py`): the
`speakers.npz` container, the reference's raw float32 files, and
`random_bank` for models without trained weights.

Contents: additive [n, 256] and formant [9, 256]; 2.0.0-rc.0 adds
codebook [n, 512, 128] and kv [n, 384, 128].  Banks store only the n real
speakers: morph results live in per-stream engine state.
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


def save(path: str, bank) -> None:
    """Write a bank (tensors or arrays) as .npz (`bank.py:62`)."""
    np.savez(path, **{k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                          else np.asarray(v)) for k, v in bank.items()})


def _raw_f32(path: str) -> np.ndarray:
    if not os.path.exists(path):
        raise BeatriceError(ErrorCode.FILE_OPEN_ERROR, path)
    return np.fromfile(path, dtype=np.float32)


def _raw_additive(path: str) -> np.ndarray:
    """A raw [n, 256] float32 file; n inferred from its size, as the
    reference's ReadNSpeakers does."""
    raw = _raw_f32(path)
    if raw.size == 0:
        raise BeatriceError(ErrorCode.FILE_TOO_SMALL, path)
    if raw.size % HID:
        raise BeatriceError(ErrorCode.INVALID_FILE_SIZE, path)
    n = raw.size // HID
    if n > MAX_N_SPEAKERS:
        raise BeatriceError(ErrorCode.FILE_TOO_LARGE, path)
    return raw.reshape(n, HID)


def _raw_exact(path: str, shape) -> np.ndarray:
    raw = _raw_f32(path)
    want = int(np.prod(shape))
    if raw.size < want:
        raise BeatriceError(ErrorCode.FILE_TOO_SMALL, path)
    if raw.size > want:
        raise BeatriceError(ErrorCode.FILE_TOO_LARGE, path)
    return raw.reshape(shape)


def _formant_beside(dirpath: str) -> np.ndarray:
    path = os.path.join(dirpath, "formant_shift_embeddings.bin")
    if os.path.exists(path):
        return _raw_exact(path, (N_FORMANT_SHIFT_EMBEDDINGS, HID))
    return np.zeros((N_FORMANT_SHIFT_EMBEDDINGS, HID), np.float32)


def _on(bank: dict, device) -> dict:
    dev = resolve_device(device)
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for k, v in bank.items()}


def load(path: str, spec: VersionSpec, device="cuda"):
    """Load a bank onto `device` (`bank.py:66`): .npz (validated), or a raw
    float32 [n, 256] additive file (2.0.0-alpha.2 / 2.0.0-beta.1 style)
    with `formant_shift_embeddings.bin` beside it, or zero formant
    embeddings without it."""
    if not os.path.exists(path):
        raise BeatriceError(ErrorCode.FILE_OPEN_ERROR, path)
    if path.endswith(".npz"):
        with np.load(path) as z:
            bank = _on({k: z[k] for k in z.files}, device)
        validate(bank, spec)
        return bank
    return _on({"additive": _raw_additive(path),
                "formant": _formant_beside(os.path.dirname(path))}, device)


def load_raw_rc0_dir(dirpath: str, spec: VersionSpec, device="cuda"):
    """A 2.0.0-rc.0-style directory of raw float32 files (the reference's
    per-model layout, processor_core_2.cc:300-366), onto `device`
    (`bank.py:110`):

        additive_speaker_embeddings.bin   n x 256  (n from its size)
        formant_shift_embeddings.bin      9 x 256  (zeros when absent)
        speaker_embeddings.bin            n x 512 x 128  (VQ codebooks)
        key_value_speaker_embeddings.bin  n x 384 x 128

    Every file but the first is validated against n."""
    additive = _raw_additive(os.path.join(dirpath, "additive_speaker_embeddings.bin"))
    n = additive.shape[0]
    bank = {"additive": additive, "formant": _formant_beside(dirpath)}
    if spec.has_vq:
        bank["codebook"] = _raw_exact(os.path.join(dirpath, "speaker_embeddings.bin"),
                                      (n, spec.codebook_size, spec.phone_channels))
    if spec.has_kv:
        bank["kv"] = _raw_exact(os.path.join(dirpath, "key_value_speaker_embeddings.bin"),
                                (n, spec.kv_length, spec.kv_channels))
    bank = _on(bank, device)
    validate(bank, spec)
    return bank


def load_raw_formant(path: str, device="cuda"):
    """A raw float32 formant-shift file: exactly 9 x 256 floats (-2..+2
    semitones in 0.5 steps), onto `device` (`bank.py:171`)."""
    return _on({"formant": _raw_exact(path, (N_FORMANT_SHIFT_EMBEDDINGS, HID))},
               device)["formant"]


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
