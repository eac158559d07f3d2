"""Frozen roofline arithmetic of the fused upsampler head, and the chip's
published peaks.

A copy of `flops_per_stream`, `bytes_per_call` and `bound_ms` of the
program's `models/fused_upsampler.py` as they stand when this benchmark
was written, so that a later change to the program cannot move the
yardstick; `portbench/tests` holds the copy equal to the program's of
today.  The counts come from the head's shapes: rates 4, 5, 4, 3 to 240
samples a frame, channels 128, 64, 32, 16 after a hidden width of 256,
8 harmonics plus noise as the source, kernels of 3 taps.
"""

from __future__ import annotations

import math

OUT_HOP = 240
RATES = (4, 5, 4, 3)
CHANNELS = (128, 64, 32, 16)
HIDDEN = 256
N_SRC = 9  # 8 harmonics + noise
KERNEL = 3

# NVIDIA H100 SXM data sheet, dense rates: f32 on the CUDA cores, bf16 on
# the tensor cores; HBM3 bandwidth.  They assume the card's full 700 W.
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
PEAK_BYTES_PER_S = 3.35e12
ELEMENT_BYTES = {"float32": 4, "bfloat16": 2}


def _stage_dims():
    """(c_in, rate, c_out, rows_in) of each stage at one frame a tick."""
    out, c_in, rows = [], HIDDEN, 1
    for r, c in zip(RATES, CHANNELS):
        out.append((c_in, r, c, rows))
        c_in, rows = c, rows * r
    return out


def flops_per_stream() -> int:
    """Multiply-adds x 2 of one stream's frame: the four stage convs, the
    source projections and the final conv."""
    macs = 0
    for c_in, r, c_out, rows in _stage_dims():
        macs += rows * KERNEL * c_in * r * c_out + rows * r * N_SRC * c_out
    macs += OUT_HOP * KERNEL * CHANNELS[-1]
    return 2 * macs


def bytes_per_call(b: int, dtype: str = "float32") -> int:
    """Bytes the head must move for b streams: each input read once (frame
    features, carries, source features, weights) and each output written
    once (audio, new carries).  Frame features, carries and the matmul
    weights are stored in `dtype`; the rest is f32."""
    states = [(b, 2, c_in) for c_in, *_ in _stage_dims()] + [(b, 2, CHANNELS[-1])]
    src = [(b, rows * r, N_SRC) for _, r, _, rows in _stage_dims()]
    stages = [{"conv_w": (KERNEL, c_in, r * c), "conv_b": (r * c,), "src_w": (N_SRC, c),
               "src_b": (c,), "log_alpha": (c,)} for c_in, r, c, _ in _stage_dims()]
    final = {"w": (KERNEL, CHANNELS[-1], 1), "b": (1,)}
    stored = [(b, 1, HIDDEN), *states, *states] + [st[k] for st in stages
                                                    for k in ("conv_w", "src_w")]
    stored.append(final["w"])
    f32 = [*src, (b, OUT_HOP), final["b"]]
    f32 += [st[k] for st in stages for k in ("conv_b", "src_b", "log_alpha")]
    return (ELEMENT_BYTES[dtype] * sum(math.prod(s) for s in stored)
            + 4 * sum(math.prod(s) for s in f32))


def bound_ms(b: int, dtype: str = "float32") -> float:
    """Least time an H100 SXM could take for b streams: the larger of the
    operations over the dtype's peak and the bytes over memory bandwidth."""
    ops = flops_per_stream() * b / PEAK_FLOPS[dtype]
    moved = bytes_per_call(b, dtype) / PEAK_BYTES_PER_S
    return max(ops, moved) * 1e3
