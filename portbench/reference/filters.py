"""Frozen copies of the two filter designs the Beatrice chain's edges and
front ends are defined by: the mel filterbank of the log-mel front ends
and the polyphase resampling filter of the 48 kHz edges.  They are the
model's specification, copied so that a later change to the program
cannot move the yardstick; `portbench/tests` holds them equal to the
program's copies of today."""

from __future__ import annotations

import numpy as np


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


def design_polyphase(L: int, M: int, taps: int = 16, cutoff: float = 1.0):
    """Polyphase weight table for L/M resampling: (W [L, K] float32, K,
    delay).  A causal stream from zero history gives
    y[n] = sum_k W[n*M % L, k] * x[floor(n*M/L) - k]."""
    zspace = max(L, M) / cutoff
    c = int(round(taps * zspace))
    length = 2 * c + 1
    i = np.arange(length) - c
    proto = np.sinc(i / zspace) * np.hanning(length)
    k_fwd = int(np.ceil(c / L))
    k_bwd = int(np.floor(c / L))
    K = k_fwd + k_bwd + 1
    W = np.zeros((L, K), dtype=np.float64)
    for p in range(L):
        for k in range(K):
            j = c + p + (k - k_fwd) * L
            if 0 <= j < length:
                W[p, k] = proto[j]
    W /= np.maximum(W.sum(axis=1, keepdims=True), 1e-12)
    return W.astype(np.float32), K, k_fwd
