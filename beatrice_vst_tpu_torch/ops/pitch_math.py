"""Per-frame pitch transform: shift, intonation and correction (port of
`beatrice_vst_tpu/ops/pitch_math.py`).

    tmp = avg_src + (q - avg_src) * intonation + 8 * pitch_shift
    if correction != 0: snap toward the nearest semitone (two curve types)
    q_out = clamp(round(tmp), 1, pitch_bins - 1)

or, for soft pitch, q_out = clamp(tmp, 1, pitch_bins - 1) without the
rounding.
"""

from __future__ import annotations

import torch

from ..constants import PITCH_BINS_PER_SEMITONE

_EPS_DELTA = 1e-4


def pitch_correction_type0(pitch, correction):
    """Snap curve x|x|^-p around the semitone bin centers."""
    bps = PITCH_BINS_PER_SEMITONE
    nearest = (torch.floor(pitch / bps) + 0.5) * bps
    delta = (pitch - nearest) * (2.0 / bps)
    absd = torch.abs(delta)
    safe = torch.clamp(absd, min=_EPS_DELTA)
    corrected = nearest + delta * torch.pow(safe, -correction) * (bps / 2.0)
    return torch.where(absd < _EPS_DELTA, nearest, corrected)


def pitch_correction_type1(pitch, correction):
    """Snap curve sgn(x)|x|^(1/(1-p)) around the semitones."""
    bps = PITCH_BINS_PER_SEMITONE
    nearest = torch.round(pitch / bps) * bps
    delta = (pitch - nearest) * (2.0 / bps)
    full_snap = correction > 1.0 - _EPS_DELTA
    exponent = 1.0 / torch.clamp(1.0 - correction, min=_EPS_DELTA)
    corrected = nearest + torch.sign(delta) * torch.pow(torch.abs(delta), exponent) * (bps / 2.0)
    return torch.where(full_snap, nearest, corrected)


def transform_pitch(quantized_pitch, *, average_source_pitch,
                    intonation_intensity, pitch_shift, pitch_correction,
                    pitch_correction_type, pitch_bins: int, round_output: bool = True):
    """Full per-frame pitch transform (`pitch_math.py:52`).

    All arguments broadcast against `quantized_pitch`; `pitch_shift` is in
    semitones and `average_source_pitch` in bins.  Returns int64 bins in
    [1, pitch_bins - 1], or with round_output=False (soft pitch,
    `pitch_math.py:86-90`) the continuous f32 bins clipped to that range.
    """
    q = quantized_pitch.to(torch.float32)
    tmp = (average_source_pitch
           + (q - average_source_pitch) * intonation_intensity
           + PITCH_BINS_PER_SEMITONE * pitch_shift)
    c0 = pitch_correction_type0(tmp, pitch_correction)
    c1 = pitch_correction_type1(tmp, pitch_correction)
    corrected = torch.where(pitch_correction_type == 0, c0, c1)
    tmp = torch.where(pitch_correction != 0.0, corrected, tmp)
    if not round_output:
        return torch.clamp(tmp, 1.0, float(pitch_bins - 1))
    return torch.clamp(torch.round(tmp), 1, pitch_bins - 1).to(torch.int64)
