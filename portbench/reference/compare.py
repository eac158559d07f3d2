"""The numbers that decide `correct`: how far the program's 48 kHz output
lies from the reference's, stream by stream over the compared ticks.

Every checked stream is held to the limits, all but two of the 16 that a
run checks: the numbers compared are the third worst stream's.  The pitch
argmax and the VQ neighbour choice are discrete; where rounding flips a
near-tie, the source's phase moves by a constant for the rest of the
stream, and that one stream's output parts from the reference for good
(one f32 run in 12 read one stream 300x its others, PERF.md).  A planted
fault that reaches half of the batch reaches three or more of 16 streams
drawn from it on all but 0.2 % of seeds.

Spectra (20 ms frames, 960 samples, hop 480, Hann) of the two outputs:

  lsd_3rd_db  the third largest over the checked streams of a stream's
              mean over frames of the frame's root mean square
              log-spectral distance, in dB, with each stream's power
              floored 40 dB under its own mean bin power (the bf16 chunk
              path's rounding, 8 significant bits, lifts the 4-12 kHz
              bins that lie 25-35 dB under the mean; with a lower floor
              that noise weighed as much as a lower precision's errors).
  wave_off    the checked streams whose waveform is not aligned with the
              reference's over the window's first WAVE_SECONDS: the peak
              of the phase-only cross-correlation (each bin's cross
              spectrum cut to unit length, summed over frames, bins above
              the floor only) lies at another lag than 0, or is negative.
              The spectra above cannot see a shift or a sign flip of the
              output; this can.  Only the start of the window, where the
              discrete choices of both sides have had least time to part.

Logged beside them and not compared: the median and the mean over
streams, the frames' 99th percentile, each stream's mean LSD, each
stream's peak lag and its coherence (the mean cosine of the phase gap at
lag 0 over the bins counted: 1 where the waveforms agree).
"""

from __future__ import annotations

import numpy as np
import torch

FRAME = 960
HOP = 480
FLOOR_DB = -40.0
WAVE_SECONDS = 2.0
RATE = 48000
WORST_EXCUSED = 2  # streams of a run that the numbers compared leave out


def _spectra(x):
    window = torch.hann_window(FRAME, periodic=True, dtype=torch.float64)
    return torch.fft.rfft(x.unfold(-1, FRAME, HOP) * window, dim=-1)


def _floor(p_ref):
    return p_ref.mean(dim=(-1, -2), keepdim=True) * 10.0 ** (FLOOR_DB / 10.0) + 1e-30


def frame_lsd_db(out, ref) -> np.ndarray:
    """Per-frame log-spectral distance in dB of out against ref, each
    [S, n] at 48 kHz: [S, frames]."""
    out = torch.as_tensor(np.asarray(out), dtype=torch.float64)
    ref = torch.as_tensor(np.asarray(ref), dtype=torch.float64)
    rows = []
    for o, r in zip(out, ref):  # a stream at a time: a window's spectra are large
        p_out, p_ref = _spectra(o).abs() ** 2, _spectra(r).abs() ** 2
        floor = _floor(p_ref)
        gap = 10.0 * torch.log10((p_out + floor) / (p_ref + floor))
        rows.append(torch.sqrt((gap ** 2).mean(dim=-1)))
    return torch.stack(rows).numpy()


def alignment(out, ref) -> tuple[np.ndarray, np.ndarray]:
    """Each stream's (peak lag in samples, coherence at lag 0) of out
    against ref over their first WAVE_SECONDS, from the phase-only cross
    spectrum of their frames.  A negative peak reads as lag FRAME, and so
    does a stream with nothing to align (an output of zeros)."""
    n = min(int(WAVE_SECONDS * RATE), np.asarray(out).shape[-1])
    out = torch.as_tensor(np.asarray(out)[:, :n], dtype=torch.float64)
    ref = torch.as_tensor(np.asarray(ref)[:, :n], dtype=torch.float64)
    x_out, x_ref = _spectra(out), _spectra(ref)
    cross = x_out * x_ref.conj()
    keep = (x_ref.abs() ** 2 >= _floor(x_ref.abs() ** 2)) & (cross.abs() > 0)
    unit = torch.where(keep, cross / cross.abs().clamp_min(1e-300), torch.zeros_like(cross))
    summed = unit.sum(dim=-2)  # [S, bins]
    g = torch.fft.irfft(summed, n=FRAME, dim=-1)  # [S, lags], lag FRAME - 1 is -1
    peak = g.abs().argmax(dim=-1)
    positive = g.gather(-1, peak[:, None])[:, 0] > 0
    lag = torch.where(peak < FRAME // 2, peak, peak - FRAME)
    count = keep.sum(dim=(-1, -2)).clamp_min(1)
    coherence = summed.real.sum(dim=-1) / count
    lag = torch.where(positive, lag, torch.full_like(lag, FRAME))
    return lag.numpy(), coherence.numpy()


def numbers(out, ref) -> dict:
    """One run's numbers: the two compared ("lsd_3rd_db", "wave_off") and
    those logged beside them."""
    d = frame_lsd_db(out, ref)
    per_stream = d.mean(axis=1)
    worst = np.sort(per_stream)[::-1]
    lag, coherence = alignment(out, ref)
    return {"lsd_3rd_db": float(worst[min(WORST_EXCUSED, len(worst) - 1)]),
            "wave_off": int((lag != 0).sum()),
            "lsd_median_db": float(np.median(per_stream)), "lsd_mean_db": float(d.mean()),
            "lsd_p99_db": float(np.percentile(d, 99)),
            "lsd_streams_db": [float(v) for v in per_stream],
            "wave_lags": [int(v) for v in lag],
            "wave_coherence": [float(v) for v in coherence]}


def judge(found: dict, limits: dict) -> tuple[bool, list]:
    """(every limited number within its limit, [[name, value, limit], ...])."""
    rows = [[name, found.get(name, float("nan")), limit] for name, limit in limits.items()]
    ok = all(np.isfinite(v) and v <= lim for _, v, lim in rows)
    return ok, rows
