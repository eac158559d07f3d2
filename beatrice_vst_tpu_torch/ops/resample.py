"""Rational polyphase resampling for the engine's 48 kHz edges and for
offline conversion at any rate (port of `beatrice_vst_tpu/ops/resample.py`,
dense form).

The filter design is the JAX package's, in numpy: a Hann-windowed sinc on
the L*M common grid, per-phase DC-normalized.  A block converts as a
banded-matrix product y = [history | x] @ S with S [hist + in_block,
out_block] built once per configuration and kept per device.  A block
longer than `_DENSE_CHUNK_MAX` samples is cut into equal sub-blocks that
share one small matrix (the band is shift-invariant), so S stays a few MB
at any block size.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from ..device import pin, resolve_device


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


def rational_rate_ratio(rate_in: float, rate_out: float, limit: int = 1000) -> tuple[int, int]:
    """(L, M) in lowest terms with rate_out / rate_in ~= L / M
    (`resample.py:56`)."""
    n, d = compute_simple_fraction(rate_out / rate_in, limit)
    g = math.gcd(n, d)
    return n // g, d // g


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

    # blocks longer than this are cut into shift-invariant sub-blocks
    # (`resample.py:162`)
    _DENSE_CHUNK_MAX = 1920

    @property
    def delay_in_samples(self) -> int:
        """Causal latency in input-rate samples (the sinc's group delay)."""
        return design_polyphase(self.L, self.M, self.taps, self.cutoff)[2]

    @property
    def offline_time_offset(self) -> float:
        """Sub-sample offset (output samples, <= 0) that `apply_offline`'s
        integer delay trim leaves (`resample.py:186`)."""
        d_ticks = self.delay_in_samples * self.L
        return (d_ticks // self.M) - d_ticks / self.M

    def dense_np(self) -> np.ndarray:
        """Banded resampling matrix S [hist + in_block, out_block]."""
        return _dense_np(self)

    def dense_sub_block(self) -> int:
        """The largest sub-block <= _DENSE_CHUNK_MAX that divides in_block
        and is a multiple of M; 0 when the block is used whole
        (`resample.py:167`)."""
        if self.in_block <= self._DENSE_CHUNK_MAX:
            return 0
        for k in range(-(-self.in_block // self._DENSE_CHUNK_MAX), self.in_block + 1):
            if self.in_block % k == 0 and (self.in_block // k) % self.M == 0:
                return self.in_block // k
        return 0

    def init_state(self, batch_shape=(), device="cuda"):
        return torch.zeros((*batch_shape, self.history_len),
                           dtype=torch.float32, device=resolve_device(device))

    def apply_block(self, x, history):
        """[..., in_block] + [..., hist] -> ([..., out_block], new history)
        (`resample.py:199`).  With sub-blocks of `sub` samples, the
        overlapping windows [hist + sub] of [history | x] go through the
        sub-block's matrix in one product: the same taps as the whole
        block's matrix."""
        full = torch.cat([history.to(x.dtype), x], dim=-1)
        hist = self.history_len
        sub = self.dense_sub_block()
        if sub:
            s = pin(_dense_torch(dataclasses.replace(self, in_block=sub), str(x.device)))
            windows = full.unfold(-1, hist + sub, sub)  # [..., in_block / sub, hist + sub]
            y = torch.matmul(windows, s).flatten(-2)
        else:
            y = torch.matmul(full, pin(_dense_torch(self, str(x.device))))
        return y, full[..., full.shape[-1] - hist:]

    def apply_offline(self, x):
        """Whole-signal resample from zero history; the causal delay is
        trimmed, so output sample n stands for input time n*M/L
        (`resample.py:287`).  A last partial block goes through a
        resampler of its own size, rounded up to a multiple of M."""
        n = x.shape[-1]
        pad = (-n) % self.M
        if pad:
            x = torch.nn.functional.pad(x, (0, pad))
        blocks = x.shape[-1] // self.in_block
        rem = x.shape[-1] - blocks * self.in_block
        parts = []
        state = self.init_state(x.shape[:-1], x.device).to(x.dtype)
        for b in range(blocks):
            yb, state = self.apply_block(x[..., b * self.in_block:(b + 1) * self.in_block], state)
            parts.append(yb)
        if rem:
            tail_rs = dataclasses.replace(self, in_block=rem + (-rem) % self.M)
            tail = torch.nn.functional.pad(x[..., blocks * self.in_block:],
                                           (0, tail_rs.in_block - rem))
            yb, _ = tail_rs.apply_block(tail, state[..., state.shape[-1] - tail_rs.history_len:])
            parts.append(yb)
        y = torch.cat(parts, dim=-1)
        lead = (self.delay_in_samples * self.L) // self.M
        return y[..., lead:lead + (n * self.L) // self.M]


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


def make_resampler(rate_in: float, rate_out: float, in_block: int,
                   taps: int = 16, cutoff: float = 0.99) -> Resampler:
    """A resampler between two rates by their Stern-Brocot ratio
    (`resample.py:323`); in_block must be a multiple of its M."""
    L, M = rational_rate_ratio(rate_in, rate_out)
    if in_block % M:
        raise ValueError(f"in_block {in_block} incompatible with ratio {L}/{M} for "
                         f"{rate_in}->{rate_out}; use a multiple of {M}")
    return Resampler(L=L, M=M, in_block=in_block, taps=taps, cutoff=cutoff)


def input_resampler_48k_to_16k(n_frames: int = 1, taps: int = 16) -> Resampler:
    return Resampler(L=1, M=3, in_block=480 * n_frames, taps=taps, cutoff=0.99)


def output_resampler_24k_to_48k(n_frames: int = 1, taps: int = 16) -> Resampler:
    return Resampler(L=2, M=1, in_block=240 * n_frames, taps=taps, cutoff=0.99)
