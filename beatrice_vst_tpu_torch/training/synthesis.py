"""Multi-speaker parallel speech corpus, synthesized locally.

The reference ships a trained 156-voice model
(the reference CMakeLists.txt:123-137); training an equivalent needs
speech audio, and this environment has no corpus and no network egress.
This module closes that gap with a classic Klatt-style cascade formant
synthesizer (source-filter: glottal pulse train + aspiration -> cascade
of formant resonators -> frication path -> radiation), good enough to
carry real phonetic structure (vowel/fricative/nasal/stop inventory,
syllabic prosody, F0 declination + accents) through the conversion
chain and to measure conversion quality objectively.

Speaker identity is carried by the *filter* and *source shape*: vocal
tract length (global formant scale), per-formant warps, spectral tilt,
breathiness, and glottal open quotient.  The F0 contour is shared by all
speakers for a given utterance, so (speaker i, utterance u) ->
(speaker k, utterance u) is a frame-aligned parallel pair: conversion
targets for training AND references for mel-cepstral-distortion eval
without DTW.  (The chain preserves source pitch by design -- the
reference's pitch path is shift/intonation math on the *input* pitch,
processor_core_0.cc:58-120 -- so pitch is deliberately not a speaker
trait here.)

Everything is host-side NumPy + scipy.signal.lfilter (per-frame biquads
with carried state); rendering is ~100x real time on the dev box.

A copy of `beatrice_vst_tpu/training/synthesis.py` (the port imports nothing of
the JAX package).
"""

from __future__ import annotations

import dataclasses

import numpy as np
from scipy.signal import lfilter

FRAME_S = 0.010
SR = 48000
SPF = int(SR * FRAME_S)  # samples per frame at the render rate

# phone -> (F1, F2, F3, F4, voiced, frication, fric_center, fric_bw, amp)
# Formant targets are adult-neutral; bandwidths are set below.
_PHONES = {
    "a":  (800, 1200, 2500, 3300, 1.0, 0.0, 0, 0, 1.0),
    "e":  (500, 1900, 2500, 3300, 1.0, 0.0, 0, 0, 1.0),
    "i":  (300, 2300, 2900, 3400, 1.0, 0.0, 0, 0, 0.9),
    "o":  (450, 800, 2500, 3300, 1.0, 0.0, 0, 0, 1.0),
    "u":  (325, 700, 2400, 3300, 1.0, 0.0, 0, 0, 0.9),
    "m":  (250, 1000, 2200, 3300, 1.0, 0.0, 0, 0, 0.45),
    "n":  (250, 1500, 2500, 3300, 1.0, 0.0, 0, 0, 0.45),
    "l":  (350, 1100, 2700, 3300, 1.0, 0.0, 0, 0, 0.6),
    "w":  (300, 650, 2300, 3300, 1.0, 0.0, 0, 0, 0.6),
    "j":  (300, 2200, 2900, 3400, 1.0, 0.0, 0, 0, 0.6),
    "s":  (300, 1600, 2500, 3300, 0.0, 1.0, 6500, 3000, 0.35),
    "sh": (300, 1800, 2500, 3300, 0.0, 1.0, 3500, 2500, 0.4),
    "f":  (300, 1200, 2500, 3300, 0.0, 0.8, 5000, 6000, 0.25),
    "z":  (300, 1600, 2500, 3300, 0.6, 0.7, 6500, 3000, 0.4),
    "h":  (500, 1500, 2500, 3300, 0.0, 0.35, 1200, 2000, 0.5),
    "t":  (300, 1700, 2600, 3300, 0.0, 1.0, 4500, 3500, 0.0),  # stop burst
    "k":  (300, 1300, 2300, 3300, 0.0, 1.0, 2200, 1500, 0.0),  # stop burst
    "p":  (300, 900, 2300, 3300, 0.0, 1.0, 1000, 1500, 0.0),   # stop burst
    "_":  (500, 1500, 2500, 3300, 0.0, 0.0, 0, 0, 0.0),        # pause
}
_FRIC_GAIN = 0.12  # frication level relative to voicing (vowels lead by ~12 dB)
_VOWELS = ["a", "e", "i", "o", "u"]
_ONSETS = ["m", "n", "l", "w", "j", "s", "sh", "f", "z", "h", "t", "k", "p", ""]
_STOPS = {"t", "k", "p"}


@dataclasses.dataclass(frozen=True)
class SpeakerSpec:
    """Timbre parameters for one synthetic voice."""

    name: str
    formant_scale: float          # vocal tract length factor (0.8 deep .. 1.25 bright)
    f2_warp: float = 1.0          # extra independent warp on F2
    tilt: float = 0.0             # 0 (bright) .. 0.9 (dark): one-pole lowpass on the source
    breathiness: float = 0.04     # aspiration level during voicing
    open_quotient: float = 0.6    # glottal pulse shape (0.4 pressed .. 0.85 lax)
    bw_scale: float = 1.0         # formant bandwidth factor


def default_speakers(n: int = 8) -> list[SpeakerSpec]:
    """A spread of n distinct voices covering the timbre space."""
    base = [
        SpeakerSpec("spk0", 0.82, 0.95, 0.55, 0.02, 0.45, 1.1),
        SpeakerSpec("spk1", 0.90, 1.00, 0.35, 0.04, 0.55, 1.0),
        SpeakerSpec("spk2", 0.97, 1.05, 0.20, 0.06, 0.62, 0.95),
        SpeakerSpec("spk3", 1.04, 0.92, 0.10, 0.10, 0.70, 1.05),
        SpeakerSpec("spk4", 1.10, 1.08, 0.45, 0.03, 0.50, 0.9),
        SpeakerSpec("spk5", 1.17, 0.98, 0.05, 0.14, 0.78, 1.0),
        SpeakerSpec("spk6", 1.24, 1.12, 0.30, 0.08, 0.65, 1.15),
        SpeakerSpec("spk7", 0.86, 1.10, 0.15, 0.12, 0.74, 0.85),
    ]
    return base[:n]


def sample_utterance(rng: np.random.Generator, min_syllables: int = 6,
                     max_syllables: int = 11,
                     f0_scale_range: tuple = (0.6, 2.2)):
    """Random CV-syllable utterance plan: [(phone, frames)] + F0 contour.

    Returns (segments, f0_frames): segments is a list of (phone, n_frames);
    f0_frames is the shared per-frame F0 in Hz (0 in pauses is fine -- the
    voicing amplitude gates it).

    f0_scale_range: per-utterance register augmentation -- a log-uniform
    scale on the 120-180 Hz base band, so the corpus spans ~72-396 Hz
    base registers (with contour accents: ~62-460 Hz instantaneous; the
    upper edge is capped so the eval's autocorrelation tracker, fmax
    460 Hz, still tracks every accent).  The r3 OOD study showed the
    model breaks outside the training band (unseen-F0 x1.6 row: 635
    cents; docs/PITCH_DIAGNOSIS.json) and the r4 study showed the 330 Hz
    absolute register -- above the earlier (0.6, 1.8) span -- losing to
    do-nothing (VERDICT r4 item/missing #3), while the reference's pitch
    contract spans its whole bin range
    (the reference include/beatrice/beatrice.h:12,24) -- wide-register
    coverage in training is the fix.  Pass (1.0, 1.0) for the legacy
    fixed band.
    """
    segs: list[tuple[str, int]] = [("_", int(rng.integers(4, 8)))]
    n_syll = int(rng.integers(min_syllables, max_syllables + 1))
    for s in range(n_syll):
        onset = _ONSETS[rng.integers(len(_ONSETS))]
        if onset:
            if onset in _STOPS:
                segs.append(("_", int(rng.integers(3, 6))))  # closure
                segs.append((onset, 1))                       # burst
            else:
                segs.append((onset, int(rng.integers(6, 13))))
        v = _VOWELS[rng.integers(len(_VOWELS))]
        segs.append((v, int(rng.integers(9, 22))))
        if rng.random() < 0.25:  # coda nasal
            segs.append((["m", "n"][rng.integers(2)], int(rng.integers(5, 9))))
        if rng.random() < 0.2:  # inter-word pause
            segs.append(("_", int(rng.integers(3, 7))))
    segs.append(("_", int(rng.integers(4, 8))))

    n_frames = sum(n for _, n in segs)
    # F0: declination + per-syllable accents + slow vibrato. 110-220 Hz band
    # scaled by the per-utterance register augmentation.
    lo, hi = f0_scale_range
    scale = float(np.exp(rng.uniform(np.log(lo), np.log(hi))))
    base = rng.uniform(120.0, 180.0) * scale
    if hi > 2.0 and rng.random() < 0.15:
        # stratified high-register draws: the log-uniform scale alone
        # puts only ~5% of utterances above 320 Hz (base x scale must
        # exceed 340), too thin for a 45-utterance corpus to anchor the
        # 330 Hz eval register -- force ~15% of draws into the top band
        base = float(rng.uniform(300.0, 396.0))
    t = np.arange(n_frames) / n_frames
    f0 = base * (1.06 - 0.18 * t)
    n_acc = max(2, n_syll // 2)
    for _ in range(n_acc):
        c = rng.uniform(0.05, 0.95)
        w = rng.uniform(0.04, 0.12)
        f0 *= 1.0 + rng.uniform(-0.10, 0.16) * np.exp(-0.5 * ((t - c) / w) ** 2)
    f0 *= 1.0 + 0.008 * np.sin(2 * np.pi * 5.3 * np.arange(n_frames) * FRAME_S
                               + rng.uniform(0, 6.28))
    # stacked accents on a top-band draw can exceed the 460 Hz
    # autocorrelation-tracker limit (quality.f0_track fmax) that both the
    # training supervision and the eval metrics rely on -- cap the
    # contour just below it
    f0 = np.minimum(f0, 450.0)
    return segs, f0.astype(np.float32)


def plan_f0_voiced(segs, f0_frames, voicing_threshold: float = 0.25):
    """Per-frame ground-truth F0 (Hz) with 0 in unvoiced frames.

    The utterance plan's contour is defined at every frame (the voicing
    AMPLITUDE gates it in the renderer, not the contour); supervision and
    eval truth need the gated form -- an ungated contour would label
    pauses/fricatives as voiced.  The gate replays the same smoothed
    voiced*amp track the renderer excites with (_tracks)."""
    tr, n = _tracks(segs, np.asarray(f0_frames, np.float32),
                    np.random.default_rng(0))
    gate = tr["voiced"] * tr["amp"] > voicing_threshold
    return np.where(gate, tr["f0"], 0.0).astype(np.float32)


def _tracks(segs, f0_frames, rng):
    """Expand the segment plan to smoothed per-frame parameter tracks."""
    keys = ["F1", "F2", "F3", "F4", "voiced", "fric", "fc", "fbw", "amp"]
    rows = []
    for ph, n in segs:
        p = _PHONES[ph]
        burst = 3.0 if ph in _STOPS else 1.0
        for _ in range(max(1, n)):
            rows.append([p[0], p[1], p[2], p[3], p[4], p[5] * burst
                         if ph in _STOPS else p[5], p[6], p[7], p[8]
                         if ph not in _STOPS else 0.8])
    tr = {k: np.array([r[i] for r in rows], np.float32)
          for i, k in enumerate(keys)}
    n = len(rows)
    f0 = f0_frames[:n] if len(f0_frames) >= n else np.pad(
        f0_frames, (0, n - len(f0_frames)), mode="edge")
    tr["f0"] = f0
    # coarticulation: moving-average smooth everything but the frication
    # excitation flags (formants glide ~30 ms; amplitudes ~20 ms)
    k3 = np.ones(3, np.float32) / 3.0
    for k in ("F1", "F2", "F3", "F4"):
        tr[k] = np.convolve(tr[k], k3, mode="same")
        tr[k][0], tr[k][-1] = tr[k][1], tr[k][-2]
    for k in ("voiced", "amp", "fric"):
        tr[k] = np.convolve(tr[k], k3, mode="same")
    return tr, n


def _resonator_coeffs(f, bw, sr, norm: str = "dc"):
    """Klatt second-order resonator.

    norm="dc": unity gain at DC (the cascade-vocoder convention -- low
    harmonics pass at ~1, the resonance peaks at ~Q above; a cascade of
    these shapes the glottal spectrum without crushing the F0 region).
    norm="peak": unity gain at the resonant frequency (for the frication
    band-pass path, whose energy lives AT the resonance)."""
    r = np.exp(-np.pi * bw / sr)
    theta = 2 * np.pi * f / sr
    a = np.array([1.0, -2.0 * r * np.cos(theta), r * r])
    if norm == "dc":
        b0 = 1.0 - 2.0 * r * np.cos(theta) + r * r
    else:
        w = theta
        b0 = np.abs(1.0 - 2.0 * r * np.cos(theta) * np.exp(-1j * w)
                    + r * r * np.exp(-2j * w))
    return np.array([b0, 0.0, 0.0]), a


def render(segs, f0_frames, speaker: SpeakerSpec, rng: np.random.Generator,
           sr: int = SR) -> np.ndarray:
    """Render one utterance for one speaker -> float32 waveform at sr."""
    tr, n_frames = _tracks(segs, f0_frames, rng)
    n = n_frames * SPF

    # ---- per-sample source tracks (linear interp of frame tracks) ----
    fi = np.arange(n) / SPF
    f0s = np.interp(fi, np.arange(n_frames), tr["f0"])
    voiced = np.interp(fi, np.arange(n_frames), tr["voiced"] * tr["amp"])
    fric = np.interp(fi, np.arange(n_frames), tr["fric"])

    # glottal source: Rosenberg-style pulse from accumulated phase
    phase = np.cumsum(f0s) / sr % 1.0
    oq = speaker.open_quotient
    rising = np.clip(phase / oq, 0.0, 1.0)
    g = 0.5 * (1.0 - np.cos(np.pi * rising))          # opening
    falling = np.clip((phase - oq) / (1.0 - oq), 0.0, 1.0)
    g = np.where(phase < oq, g, np.cos(0.5 * np.pi * falling))
    glottal = np.diff(g, prepend=g[:1])               # flow derivative
    glottal /= max(1e-6, np.abs(glottal).max())
    jit = 1.0 + 0.01 * rng.standard_normal(n_frames)  # shimmer per frame
    glottal *= np.repeat(jit, SPF).astype(np.float32)

    asp = rng.standard_normal(n).astype(np.float32)
    source = voiced * (glottal + speaker.breathiness * asp)

    # speaker tilt: one-pole lowpass mixed by tilt amount
    if speaker.tilt > 0:
        lp = lfilter([1 - 0.85], [1, -0.85], source)
        source = (1 - speaker.tilt) * source + speaker.tilt * lp

    # ---- cascade formant filter, frame-wise coefficients ----
    bws = np.array([80.0, 100.0, 140.0, 220.0]) * speaker.bw_scale
    warps = np.array([speaker.formant_scale,
                      speaker.formant_scale * speaker.f2_warp,
                      speaker.formant_scale, speaker.formant_scale])
    out = np.zeros(n, np.float32)
    zis = [np.zeros(2) for _ in range(4)]
    src = source.reshape(n_frames, SPF)
    for fidx in range(n_frames):
        seg = src[fidx].astype(np.float64)
        for k, key in enumerate(("F1", "F2", "F3", "F4")):
            f = float(tr[key][fidx]) * warps[k]
            f = min(f, sr * 0.45)
            b, a = _resonator_coeffs(f, bws[k], sr)
            seg, zis[k] = lfilter(b, a, seg, zi=zis[k])
        out[fidx * SPF: (fidx + 1) * SPF] = seg

    # ---- frication path (bypasses the cascade) ----
    if tr["fric"].max() > 0:
        fnoise = rng.standard_normal(n).astype(np.float64)
        fout = np.zeros(n)
        zi = np.zeros(2)
        for fidx in range(n_frames):
            fc = float(tr["fc"][fidx])
            fbw = max(float(tr["fbw"][fidx]), 500.0)
            if fc <= 0:
                fc, fbw = 4000.0, 4000.0
            fc = min(fc * speaker.formant_scale, sr * 0.45)
            b, a = _resonator_coeffs(fc, fbw, sr, norm="peak")
            seg, zi = lfilter(b, a, fnoise[fidx * SPF: (fidx + 1) * SPF],
                              zi=zi)
            fout[fidx * SPF: (fidx + 1) * SPF] = seg
        out = out + (fric * _FRIC_GAIN * fout).astype(np.float32)

    # radiation (first difference) + normalize + recording-noise floor
    # (~-80 dBFS: real corpora are never digitally silent, and metrics
    # behave badly on true zeros)
    out = np.diff(out, prepend=out[:1]).astype(np.float32)
    peak = np.abs(out).max()
    if peak > 1e-6:
        out *= 0.3 / peak
    out += (3e-5 * rng.standard_normal(n)).astype(np.float32)
    return out


def make_corpus(out_dir: str, *, n_speakers: int = 8, n_utterances: int = 40,
                seed: int = 0, sr: int = SR) -> dict:
    """Render the full parallel corpus to out_dir/spk{k}/utt{j}.wav.

    Returns a manifest {speakers, n_utterances, seconds_total}."""
    import os

    from ..audio_io import write_wav

    speakers = default_speakers(n_speakers)
    rng_plan = np.random.default_rng(seed)
    total = 0.0
    for j in range(n_utterances):
        segs, f0 = sample_utterance(rng_plan)
        for k, spk in enumerate(speakers):
            rng_render = np.random.default_rng(seed * 100003 + j * 131 + k)
            y = render(segs, f0, spk, rng_render, sr)
            d = os.path.join(out_dir, spk.name)
            os.makedirs(d, exist_ok=True)
            write_wav(os.path.join(d, f"utt{j:03d}.wav"), y, sr)
            total += len(y) / sr
    return {
        "speakers": [dataclasses.asdict(s) for s in speakers],
        "n_utterances": n_utterances,
        "seconds_total": round(total, 1),
        "sample_rate": sr,
    }
