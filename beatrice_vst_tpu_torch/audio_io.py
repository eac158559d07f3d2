"""WAV file IO (stdlib `wave` + numpy; 16/24/32-bit PCM and float32).

A copy of `beatrice_vst_tpu/audio_io.py` (the port imports nothing of the
JAX package).
"""

from __future__ import annotations

import wave

import numpy as np


def read_wav(path: str) -> tuple[np.ndarray, int]:
    """Returns (mono float32 audio in [-1, 1], sample_rate)."""
    with wave.open(path, "rb") as w:
        sr = w.getframerate()
        n = w.getnframes()
        ch = w.getnchannels()
        width = w.getsampwidth()
        raw = w.readframes(n)
    if width == 2:
        x = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
    elif width == 4:
        x = np.frombuffer(raw, np.int32).astype(np.float32) / 2147483648.0
    elif width == 3:
        b = np.frombuffer(raw, np.uint8).reshape(-1, 3)
        x = (
            (b[:, 0].astype(np.int32))
            | (b[:, 1].astype(np.int32) << 8)
            | (b[:, 2].astype(np.int32) << 16)
        )
        x = (x - ((x & 0x800000) << 1)).astype(np.float32) / 8388608.0
    else:
        raise ValueError(f"unsupported sample width {width}")
    if ch > 1:
        # downmix to mono like the reference processor (processor.cc:182-191)
        x = x.reshape(-1, ch).mean(axis=1)
    return x, sr


def write_wav(path: str, audio: np.ndarray, sample_rate: int) -> None:
    x = np.clip(np.asarray(audio, np.float32), -1.0, 1.0)
    pcm = (x * 32767.0).astype(np.int16)
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm.tobytes())
