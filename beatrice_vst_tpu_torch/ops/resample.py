"""Rational polyphase resampling for the engine's 48 kHz edges (port of
`beatrice_vst_tpu/ops/resample.py`, dense form).

The filter design is the JAX package's, in numpy: a Hann-windowed sinc on
the L*M common grid, per-phase DC-normalized.  A block converts as one
banded-matrix product y = [history | x] @ S with S [hist + in_block,
out_block] built once per configuration and kept per device.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch


def compute_simple_fraction(ratio: float, limit: int = 1000) -> tuple[int, int]:
    """Best rational approximation with numerator/denominator < limit
    (Stern-Brocot mediant walk)."""
    ln, ld = 0, 1
    rn, rd = 1, 0
    while True:
        mn, md = ln + rn, ld + rd
        if ratio * md < mn:
            if mn >= limit or md >= limit:
                return ln, ld
            rn, rd = mn, md
        else:
            if mn >= limit or md >= limit:
                return rn, rd
            ln, ld = mn, md


@functools.lru_cache(maxsize=None)
def design_polyphase(L: int, M: int, taps: int = 16, cutoff: float = 1.0):
    """Polyphase weight table for L/M resampling: (W [L, K] float32, K,
    delay) with y[n] = sum_k W[n*M % L, k] * x[floor(n*M/L) + delay - k]."""
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


@dataclasses.dataclass(frozen=True)
class Resampler:
    """Static-shape streaming resampler for one (L, M, in_block) config."""

    L: int
    M: int
    in_block: int  # must be a multiple of M
    taps: int = 16
    cutoff: float = 1.0

    def __post_init__(self):
        if self.in_block % self.M != 0:
            raise ValueError(
                f"in_block ({self.in_block}) must be a multiple of M ({self.M})"
            )

    @property
    def out_block(self) -> int:
        return self.in_block * self.L // self.M

    @property
    def history_len(self) -> int:
        return design_polyphase(self.L, self.M, self.taps, self.cutoff)[1] - 1

    def dense_np(self) -> np.ndarray:
        """Banded resampling matrix S [hist + in_block, out_block]."""
        return _dense_np(self)

    def init_state(self, batch_shape=(), device="cpu"):
        return torch.zeros((*batch_shape, self.history_len),
                           dtype=torch.float32, device=device)

    def apply_block(self, x, history):
        """[..., in_block] + [..., hist] -> ([..., out_block], new history)
        (`resample.py:199`)."""
        full = torch.cat([history.to(x.dtype), x], dim=-1)
        s = _dense_torch(self, str(x.device))
        return torch.matmul(full, s), full[..., full.shape[-1] - self.history_len:]


@functools.lru_cache(maxsize=None)
def _dense_np(rs: Resampler) -> np.ndarray:
    W, K, _ = design_polyphase(rs.L, rs.M, rs.taps, rs.cutoff)
    hist = K - 1
    n_j = rs.out_block // rs.L
    S = np.zeros((hist + rs.in_block, rs.out_block), np.float32)
    for r in range(rs.L):
        base_r = (r * rs.M) // rs.L
        w_row = W[(r * rs.M) % rs.L]
        for k in range(K):
            w = float(w_row[k])
            if w == 0.0:
                continue
            for q in range(n_j):
                S[hist + base_r - k + q * rs.M, q * rs.L + r] += w
    return S


@functools.lru_cache(maxsize=32)
def _dense_torch(rs: Resampler, device: str) -> torch.Tensor:
    return torch.from_numpy(_dense_np(rs)).to(device)


def input_resampler_48k_to_16k(n_frames: int = 1, taps: int = 16) -> Resampler:
    return Resampler(L=1, M=3, in_block=480 * n_frames, taps=taps, cutoff=0.99)


def output_resampler_24k_to_48k(n_frames: int = 1, taps: int = 16) -> Resampler:
    return Resampler(L=2, M=1, in_block=240 * n_frames, taps=taps, cutoff=0.99)
