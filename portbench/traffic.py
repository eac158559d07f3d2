"""The general traffic generator: a traffic file's parameters and a seed
give every stream's controls and its speech-like 48 kHz input.

Each stream gets its own voice: a harmonic tone whose f0 glides and
vibrates inside the pitch estimator's range, shaped by a syllable-rate
envelope, gated into voiced stretches and silences, over low noise.  Its
controls (target speaker, formant, pitch shift, VQ neighbours, gains) are
drawn from the seed as well.  Every seed gives the same sizes (capacity,
frames per tick, loop length); only the content differs.

The per-stream parameters come from NumPy's generator (the same on any
machine); the samples are made on the run's device in a few large calls
per block of streams, with a `torch.Generator` on that device for the
noise, and land in one (pinned, on a card) host buffer
[loop_ticks, capacity, frames_per_tick * 480] that the window cycles
through.
"""

from __future__ import annotations

import math

import numpy as np
import torch

EDGE_RATE = 48000
EDGE_HOP = 480
BLOCK_STREAMS = 512  # streams synthesised per device call


def _uniform(rng, span, n):
    lo, hi = span
    return rng.uniform(lo, hi, n)


def stream_controls(traffic: dict, n_speakers: int, seed: int) -> dict:
    """{control field: [capacity] array}: the drawn ones per the traffic's
    "controls" spans, the rest at the traffic's "fixed" values."""
    cap = traffic["capacity"]
    spec = traffic["controls"]
    rng = np.random.default_rng([seed, 1])
    out = {"target_speaker": rng.integers(0, n_speakers, cap),
           "formant_index": rng.integers(spec["formant_index"][0],
                                         spec["formant_index"][1] + 1, cap),
           "vq_num_neighbors": rng.integers(spec["vq_num_neighbors"][0],
                                            spec["vq_num_neighbors"][1] + 1, cap)}
    step = spec["pitch_shift_step"]
    lo, hi = (round(v / step) for v in spec["pitch_shift"])
    out["pitch_shift"] = (rng.integers(lo, hi + 1, cap) * step).astype(np.float32)
    for field in ("input_gain_db", "output_gain_db"):
        out[field] = _uniform(rng, spec[field], cap).astype(np.float32)
    for field, value in traffic["fixed"].items():
        dtype = np.float32 if isinstance(value, float) else np.int64
        out[field] = np.full(cap, value, dtype)
    return out


def voice_parameters(traffic: dict, seed: int) -> dict:
    """Each stream's voice: {name: [capacity] float64}."""
    cap, v = traffic["capacity"], traffic["voice"]
    rng = np.random.default_rng([seed, 2])
    log_f0 = _uniform(rng, np.log(v["f0_hz"]), cap)
    return {
        "f0": np.exp(log_f0),
        "glide_st": _uniform(rng, v["glide_semitones"], cap),
        "glide_hz": _uniform(rng, v["glide_hz"], cap),
        "vibrato_st": _uniform(rng, v["vibrato_semitones"], cap),
        "vibrato_hz": _uniform(rng, v["vibrato_hz"], cap),
        "syllable_hz": _uniform(rng, v["syllable_hz"], cap),
        "gate_hz": _uniform(rng, v["gate_hz"], cap),
        "gate_cut": _uniform(rng, v["gate_cut"], cap),
        "tilt": _uniform(rng, v["tilt"], cap),
        "level": 10.0 ** (_uniform(rng, v["level_db"], cap) / 20.0),
        "noise": 10.0 ** (_uniform(rng, v["noise_db"], cap) / 20.0),
        "phase": rng.uniform(0.0, 2 * math.pi, (4, cap)),
    }


def _voices(p: dict, n: int, harmonics: int, noise_gen, device) -> torch.Tensor:
    """[streams, n] at 48 kHz for the parameter rows p (tensors [streams])."""
    t = torch.arange(n, dtype=torch.float64, device=device) / EDGE_RATE
    ph = p["phase"]
    def wave(rate, phase):
        return torch.sin(2 * math.pi * rate[:, None] * t + phase[:, None])

    semis = p["glide_st"][:, None] * wave(p["glide_hz"], ph[0]) + p["vibrato_st"][:, None] * wave(
        p["vibrato_hz"], ph[1])
    f0 = p["f0"][:, None] * torch.pow(2.0, semis / 12.0)
    phase = torch.cumsum(2 * math.pi * f0 / EDGE_RATE, dim=-1)
    # harmonics below 8 kHz, each k^-tilt: sin(k*phi) by the Chebyshev
    # recurrence, in float32
    s1, c2 = torch.sin(phase).float(), 2.0 * torch.cos(phase).float()
    f0 = f0.float()
    prev, cur = torch.zeros_like(s1), s1
    voice = torch.zeros_like(s1)
    for k in range(1, harmonics + 1):
        gain = (k ** (-p["tilt"][:, None])).float()
        voice = voice + cur * (k * f0 < 8000.0) * gain
        prev, cur = cur, c2 * cur - prev
    syllable = 0.55 + 0.45 * wave(p["syllable_hz"], ph[2])
    gate = torch.clamp((wave(p["gate_hz"], ph[3]) - p["gate_cut"][:, None]) * 8.0, 0.0, 1.0)
    noise = torch.randn(voice.shape, generator=noise_gen, dtype=torch.float32, device=device)
    level = (p["level"][:, None] * gate * syllable).float()
    return level * voice + p["noise"][:, None].float() * noise


def loop_ticks(traffic: dict) -> int:
    """Ticks in one pass of the input loop: at least loop_frames frames."""
    return -(-traffic["loop_frames"] // traffic["frames_per_tick"])


def make_inputs(traffic: dict, seed: int, device, pin: bool) -> torch.Tensor:
    """The input loop [loop_ticks, capacity, T*480] float32 on the host
    (pinned when `pin`): row s of tick k is stream s's k-th block."""
    cap, t = traffic["capacity"], traffic["frames_per_tick"]
    ticks = loop_ticks(traffic)
    n = ticks * t * EDGE_HOP
    params = voice_parameters(traffic, seed)
    out = torch.empty((ticks, cap, t * EDGE_HOP), dtype=torch.float32, pin_memory=pin)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (2 ** 63))
    for lo in range(0, cap, BLOCK_STREAMS):
        hi = min(cap, lo + BLOCK_STREAMS)
        rows = {k: torch.as_tensor(v[..., lo:hi], dtype=torch.float64, device=device)
                for k, v in params.items()}
        x = _voices(rows, n, traffic["voice"]["harmonics"], gen, device)
        out[:, lo:hi].copy_(x.reshape(hi - lo, ticks, t * EDGE_HOP).transpose(0, 1))
    return out


def check_rows(traffic: dict, seed: int) -> np.ndarray:
    """The streams whose output the reference checks, drawn from the seed."""
    rng = np.random.default_rng([seed, 3])
    cap = traffic["capacity"]
    return np.sort(rng.choice(cap, size=min(traffic["check_streams"], cap), replace=False))


def history(inputs: torch.Tensor, rows, n_ticks: int) -> np.ndarray:
    """Streams `rows`' input over their first n_ticks ticks, [len(rows),
    n_ticks * T * 480]: the loop repeated."""
    loop = inputs[:, rows].numpy()  # [ticks, rows, T*480]
    reps = -(-n_ticks // loop.shape[0])
    full = np.concatenate([loop] * reps, axis=0)[:n_ticks]
    return np.ascontiguousarray(full.transpose(1, 0, 2).reshape(len(rows), -1))
