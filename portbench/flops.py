"""The model's floating-point operations per stream and frame, summed from
a configuration's shapes: the work the tick must do, whatever implements
it.  A product of an [m, k] by a [k, n] counts 2*m*k*n.  Not counted: the
one-hot contractions over the slot bank and the shared codebook bank (an
implementation of a gather), the K/V projection of a speaker's 384 keys
(made once per speaker, not per frame), elementwise work (norms,
activations, gains) and the k-NN selection.

`tick_mfu` divides `flops_per_tick` by the tick's time and the chip's
published peak for the configuration's compute dtype.
"""

from __future__ import annotations

import math

from . import yardstick
from .reference.filters import design_polyphase

IN_HOP = 160  # samples of a frame at 16 kHz
OUT_HOP = 240  # at 24 kHz
EDGE_HOP = 480  # at 48 kHz


def real_fft(n: int) -> float:
    """A real FFT of n points: 2.5 n log2 n (half a complex FFT of n
    points at 5 n log2 n)."""
    return 2.5 * n * math.log2(n)


def spectrum(win: int, n_mels: int) -> float:
    """A log-mel frame: the real FFT, |X|^2 at 3 per bin, the mel product."""
    bins = win // 2 + 1
    return real_fft(win) + 3 * bins + 2 * bins * n_mels


def conv_block(hidden: int, kernel: int) -> int:
    """A k-tap causal conv hidden -> hidden and a 2x-wide MLP."""
    return 2 * (kernel * hidden * hidden + hidden * 2 * hidden + 2 * hidden * hidden)


def cross_attention(hidden: int, attn: int, keys: int) -> int:
    """q projection, scores over the speaker's keys, their weighted sum of
    values, the output projection (K and V are the speaker's, projected
    once)."""
    return 2 * (hidden * attn + attn * keys + keys * attn + attn * hidden)


def resampler_taps(L: int, M: int, outputs: int) -> int:
    """A polyphase filter's multiply-adds: each output reads K taps."""
    return 2 * outputs * design_polyphase(L, M, 16, 0.99)[1]


def flops_per_frame(model: dict) -> dict:
    """{item: FLOPs of one stream's frame} for the configuration's "model"
    group."""
    ph, pi, wg = model["phone"], model["pitch"], model["wg"]
    out = {
        "resample_48_16": resampler_taps(1, 3, IN_HOP),
        "phone_spectrum": spectrum(ph["win"], ph["n_mels"]),
        "phone_prenet": 2 * ph["n_mels"] * ph["hidden"],
        "phone_blocks": len(ph["dilations"]) * conv_block(ph["hidden"], ph["kernel"]),
        "phone_head": 2 * ph["hidden"] * model["phone_channels"],
        "vq_distances": 2 * model["codebook_size"] * model["phone_channels"],
        "pitch_spectrum": spectrum(pi["win"], pi["n_mels"]),
        "pitch_prenet": 2 * pi["n_mels"] * pi["hidden"],
        "pitch_blocks": len(pi["dilations"]) * conv_block(pi["hidden"], pi["kernel"]),
        "pitch_heads": 2 * pi["hidden"] * (model["pitch_bins"] + pi["features"]),
        "wg_inputs": 2 * wg["hidden"] * (model["phone_channels"] + pi["features"] + wg["hidden"]),
        "wg_blocks": wg["n_blocks"] * (conv_block(wg["hidden"], wg["kernel"])
                                       + cross_attention(wg["hidden"], wg["attn_dim"],
                                                         model["kv_length"])),
        # sin(k phi) for k = 1..H at each 24 kHz sample by the Chebyshev
        # recurrence, one multiply-add a harmonic
        "source": 2 * OUT_HOP * wg["n_harmonics"],
        "upsampler": yardstick.flops_per_stream(),
        "resample_24_48": resampler_taps(2, 1, EDGE_HOP),
    }
    return out


def flops_per_tick(model: dict, capacity: int, frames_per_tick: int) -> float:
    return capacity * frames_per_tick * sum(flops_per_frame(model).values())
