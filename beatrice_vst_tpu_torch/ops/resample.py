"""Rational polyphase resampling for the engine's 48 kHz edges and for
offline conversion at any rate (port of `beatrice_vst_tpu/ops/resample.py`).

The filter design is the JAX package's, in numpy: a Hann-windowed sinc on
the L*M common grid, per-phase DC-normalized.  On a CUDA tensor a block
converts in one launch of the polyphase kernel (`csrc/polyphase_resample.cu`,
built with `nvcc`, loaded with `ctypes`): each output sums only its K taps,
y[n] = sum_k W[n*M % L, k] * [history | x][floor(n*M/L) + K-1 - k], reading
history and x where they lie.  On the CPU, and as the plain version the
card tests hold the kernel to, a block converts as the JAX package's
banded-matrix product y = [history | x] @ S with S [hist + in_block,
out_block] built once per configuration and kept per device.  A block
longer than `_DENSE_CHUNK_MAX` samples is cut into equal sub-blocks that
share one small matrix (the band is shift-invariant), so S stays a few MB
at any block size.

`launches` counts the kernel's launches on the card and `samples` the
output samples they computed (B * out_block a launch); a call made while
a CUDA graph is captured is counted once per replay of the graph
(`device.count_launch`, under the kernel name "polyphase_resample").
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import numpy as np
import torch

from ..device import count_launch, launch_counter, launch_record, pin, resolve_device

# kernel launches since the counts were last set to 0, and the output
# samples they computed
launches = 0
samples = 0
KERNEL_THREADS = 128  # a block of the kernel; it takes 128 x reps outputs
KERNEL_MAX_SMEM = 232448  # the most dynamic shared memory a block may ask for


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
        (`resample.py:199`).  A CUDA tensor takes the kernel
        (`polyphase_block`).  On the CPU, with sub-blocks of `sub`
        samples, the overlapping windows [hist + sub] of [history | x] go
        through the sub-block's matrix in one product: the same taps as
        the whole block's matrix."""
        if x.device.type == "cuda":
            return polyphase_block(self, x, history)
        return self.dense_block(x, history)

    def dense_block(self, x, history):
        """`apply_block` as the banded-matrix product on any device: the
        CPU's path, and the plain version of the kernel."""
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
        (`resample.py:287`).  On a CUDA tensor the signal is one block,
        one launch of the kernel, whose sums do not depend on where blocks
        start: a block of ~4,000 samples is a few tiles, so a launch a
        block would leave the card waiting on each.  Else
        `offline_blocks`."""
        if x.device.type != "cuda":
            return self.offline_blocks(x)
        n = x.shape[-1]
        pad = (-n) % self.M
        if pad:
            x = torch.nn.functional.pad(x, (0, pad))
        lead = (self.delay_in_samples * self.L) // self.M
        one = dataclasses.replace(self, in_block=x.shape[-1])
        y, _ = one.apply_block(x, one.init_state(x.shape[:-1], x.device))
        return y[..., lead:lead + (n * self.L) // self.M]

    def offline_blocks(self, x):
        """`apply_offline` in blocks of in_block on any device (the CPU's
        path, and the card's before the kernel).  A last partial block goes
        through a resampler of its own size, rounded up to a multiple of
        M."""
        n = x.shape[-1]
        pad = (-n) % self.M
        if pad:
            x = torch.nn.functional.pad(x, (0, pad))
        lead = (self.delay_in_samples * self.L) // self.M
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


@dataclasses.dataclass(frozen=True)
class KernelPlan:
    """How the kernel takes a block: `reps` outputs a thread, so `tile` =
    128 x reps consecutive outputs of one stream a block; the block stages
    `rows` rows of the table (row i: the phase of its output i, used by
    its outputs i, i + rows, ...) and a `window` of [history | x] from
    floor(n0*M/L), its first output n0's first tap."""

    reps: int
    tile: int
    rows: int
    window: int

    def smem_bytes(self, K: int) -> int:
        return 4 * (self.rows * K + self.window)


@functools.lru_cache(maxsize=64)
def kernel_plan(rs: Resampler) -> KernelPlan:
    """The kernel's tiling of `rs`'s block: 4 outputs a thread where the
    block has more than 256, else 2 or 1, so a tile covers the block with
    the fewest idle threads; fewer again until the block's shared memory
    fits, and raises where even 1 does not."""
    K = design_polyphase(rs.L, rs.M, rs.taps, rs.cutoff)[1]
    reps = 1 if rs.out_block <= KERNEL_THREADS else 2 if rs.out_block <= 2 * KERNEL_THREADS else 4
    while True:
        tile = KERNEL_THREADS * reps
        # the outputs n0..n0+tile-1 read [history | x] from floor(n0*M/L) to
        # floor((n0+tile-1)*M/L) + K-1, at most floor((tile-1)*M/L) + K
        # samples on
        plan = KernelPlan(reps, tile, min(rs.L, tile), (tile - 1) * rs.M // rs.L + K + 1)
        if plan.smem_bytes(K) <= KERNEL_MAX_SMEM:
            return plan
        if reps == 1:
            raise ValueError(f"polyphase kernel: {rs.L}/{rs.M} with {K} taps needs "
                             f"{plan.smem_bytes(K)} bytes of shared memory a block, over "
                             f"{KERNEL_MAX_SMEM}")
        reps //= 2


def bytes_per_call(rs: Resampler, batch: int) -> int:
    """Bytes the kernel must move for `batch` streams: each input read
    once (the block, the history, the table) and each output written once
    (the block, the new history), in f32."""
    K = design_polyphase(rs.L, rs.M, rs.taps, rs.cutoff)[1]
    return 4 * (batch * (rs.in_block + rs.out_block + 2 * (K - 1)) + rs.L * K)


def bound_ms(rs: Resampler, batch: int) -> float:
    """Least time an H100 SXM could take for `batch` streams: the bytes
    over 3.35 TB/s (its K multiply-adds an output over 67 TFLOP/s of f32
    take less at every rate the port uses)."""
    K = design_polyphase(rs.L, rs.M, rs.taps, rs.cutoff)[1]
    return max(bytes_per_call(rs, batch) / 3.35e12,
               2 * K * rs.out_block * batch / 67e12) * 1e3


@functools.lru_cache(maxsize=32)
def _table_torch(L: int, M: int, taps: int, cutoff: float, device: str) -> torch.Tensor:
    return torch.from_numpy(design_polyphase(L, M, taps, cutoff)[0]).to(device)


class _Args(ctypes.Structure):
    """Mirror of `PolyphaseArgs` in csrc/polyphase_resample.cu."""

    _fields_ = [(name, ctypes.c_void_p) for name in ("x", "history", "table", "y",
                                                     "new_history")] + [
        (name, ctypes.c_int) for name in ("batch", "L", "M", "K", "in_block", "out_block",
                                          "tile", "window", "rows")]


@functools.lru_cache(maxsize=None)
def _launcher():
    """The kernel's launcher, built and loaded, its argument types set."""
    from .. import cuda_build

    fn = cuda_build.load_library("polyphase_resample").polyphase_resample_launch
    # (const PolyphaseArgs*, int reps, cudaStream_t)
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def polyphase_block(rs: Resampler, x, history):
    """`rs.apply_block` on CUDA tensors: one launch of the kernel on the
    current stream, without synchronising.  x [..., in_block] and history
    [..., hist] in float32; returns (y [..., out_block], new history), new
    tensors.  The kernel has no backward: under autograd with an input
    that requires grad it raises."""
    hist = rs.history_len
    if x.dtype != torch.float32 or history.dtype != torch.float32:
        raise ValueError(f"polyphase kernel takes float32, not x {x.dtype}, "
                         f"history {history.dtype}")
    if x.shape[-1] != rs.in_block or history.shape[-1] != hist \
            or x.shape[:-1] != history.shape[:-1]:
        raise ValueError(f"polyphase kernel takes x [..., {rs.in_block}] and history "
                         f"[..., {hist}], not {tuple(x.shape)} and {tuple(history.shape)}")
    if history.device != x.device:
        raise ValueError(f"history is on {history.device}, x on {x.device}")
    if torch.is_grad_enabled() and (x.requires_grad or history.requires_grad):
        raise RuntimeError("the polyphase kernel has no backward")
    recorded = launch_record("polyphase_resample")
    lead = x.shape[:-1]
    xs = x.reshape(-1, rs.in_block).contiguous()
    hs = history.reshape(-1, hist).contiguous()
    batch = xs.shape[0]
    y = torch.empty((batch, rs.out_block), dtype=torch.float32, device=x.device)
    new_history = torch.empty_like(hs)
    plan = kernel_plan(rs)
    table = pin(_table_torch(rs.L, rs.M, rs.taps, rs.cutoff, str(x.device)))
    args = _Args(xs.data_ptr(), hs.data_ptr(), table.data_ptr(), y.data_ptr(),
                 new_history.data_ptr(), batch, rs.L, rs.M, hist + 1, rs.in_block,
                 rs.out_block, plan.tile, plan.window, plan.rows)
    with torch.cuda.device(x.device):
        err = _launcher()(ctypes.addressof(args), plan.reps,
                          torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"polyphase_resample kernel launch failed: CUDA error {err}")
    count_launch(recorded, "polyphase_resample",
                 {"launches": 1, "samples": batch * rs.out_block})
    return y.reshape(*lead, rs.out_block), new_history.reshape(*lead, hist)


def _count(key: str, n: int) -> None:
    """Add n to the counter `key`: "launches" or "samples"."""
    global launches, samples
    if key == "launches":
        launches += n
    else:
        samples += n


launch_counter("polyphase_resample", _count)


def counts() -> dict:
    """The kernel's launches and output samples in this process, as the
    engine's and the server's `metrics` report them."""
    return {"resample_kernel_launches": launches, "resample_kernel_samples": samples}


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
