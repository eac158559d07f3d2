"""Framed log-mel front end as matmuls (port of
`beatrice_vst_tpu/ops/frontend.py`, linear-history path).

The windowed real-DFT bases and the mel filterbank are built in numpy
exactly as the JAX package builds them, then kept per device as torch
constants.  Each frame is two [B, win] x [win, bins] products, the power
spectrum, one product with the filterbank and a floored log.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..device import pin


def hann_window(win: int) -> np.ndarray:
    """Periodic Hann window."""
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(win) / win)


@functools.lru_cache(maxsize=None)
def real_dft_matrices(win: int) -> tuple[np.ndarray, np.ndarray]:
    """Cos/sin bases for an rFFT of length `win`: two [win, win//2+1] mats."""
    n = np.arange(win)[:, None]
    k = np.arange(win // 2 + 1)[None, :]
    ang = 2.0 * np.pi * n * k / win
    return np.cos(ang).astype(np.float32), (-np.sin(ang)).astype(np.float32)


def mel_filterbank(sr: int, n_fft: int, n_mels: int, fmin: float, fmax: float) -> np.ndarray:
    """Triangular mel filterbank, Slaney-style area-normalized: [bins, n_mels]."""

    def hz_to_mel(f):
        return 2595.0 * np.log10(1.0 + np.asarray(f) / 700.0)

    def mel_to_hz(m):
        return 700.0 * (10.0 ** (np.asarray(m) / 2595.0) - 1.0)

    n_bins = n_fft // 2 + 1
    fft_freqs = np.linspace(0.0, sr / 2.0, n_bins)
    mel_pts = np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2)
    hz_pts = mel_to_hz(mel_pts)
    fb = np.zeros((n_bins, n_mels), dtype=np.float32)
    for m in range(n_mels):
        lo, ctr, hi = hz_pts[m], hz_pts[m + 1], hz_pts[m + 2]
        up = (fft_freqs - lo) / max(ctr - lo, 1e-9)
        down = (hi - fft_freqs) / max(hi - ctr, 1e-9)
        fb[:, m] = np.maximum(0.0, np.minimum(up, down))
        fb[:, m] *= 2.0 / max(hi - lo, 1e-9)
    return fb


@dataclasses.dataclass(frozen=True)
class MelFrontend:
    """Log-mel front end over a sliding window with hop = 160 samples."""

    sample_rate: int = 16_000
    win: int = 512
    hop: int = 160
    n_mels: int = 80
    fmin: float = 0.0
    fmax: float | None = None
    log_floor: float = 1e-5

    @property
    def history(self) -> int:
        return self.win - self.hop

    def consts_np(self):
        """(cos [win, nb], sin [win, nb], mel [nb, n_mels]) in numpy: the
        window folded into the DFT bases, and the bins above the
        filterbank's last nonzero row dropped (`frontend.py:105-127`;
        exact, the dropped mel rows are all zero)."""
        return _consts_np(self)

    def consts(self, device):
        """The same constants as torch tensors on `device` (cached; pinned
        by a graph being captured)."""
        return pin(_consts_torch(self, str(torch.device(device))))

    def __call__(self, frames):
        """[..., win] windowed raw audio -> [..., n_mels] log-mel."""
        cos_m, sin_m, mel = self.consts(frames.device)
        re = torch.matmul(frames, cos_m)
        im = torch.matmul(frames, sin_m)
        power = re * re + im * im
        return torch.log(torch.clamp(torch.matmul(power, mel), min=self.log_floor))

    def frames_from_chunk(self, history, chunk):
        """[..., T*hop] chunk plus [..., history] left context -> (windows
        [..., T, win], new_history) (`frontend.py:252`)."""
        t = chunk.shape[-1] // self.hop
        full = torch.cat([history.to(chunk.dtype), chunk], dim=-1)
        new_history = full[..., t * self.hop:]
        return full.unfold(-1, self.win, self.hop), new_history


@functools.lru_cache(maxsize=None)
def _consts_np(fe: MelFrontend):
    fmax = fe.fmax if fe.fmax is not None else fe.sample_rate / 2.0
    w = hann_window(fe.win).astype(np.float32)
    cos_m, sin_m = real_dft_matrices(fe.win)
    mel = mel_filterbank(fe.sample_rate, fe.win, fe.n_mels, fe.fmin, fmax)
    n_bins = int(np.max(np.nonzero(mel.any(axis=1))[0])) + 1 if mel.any() else 1
    cos_m, sin_m, mel = cos_m[:, :n_bins], sin_m[:, :n_bins], mel[:n_bins]
    return cos_m * w[:, None], sin_m * w[:, None], mel


@functools.lru_cache(maxsize=32)
def _consts_torch(fe: MelFrontend, device: str):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in _consts_np(fe))
