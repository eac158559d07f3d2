"""Objective voice-conversion quality metrics (host-side NumPy).

The standard VC eval trio, computed on frame-aligned parallel audio (the
synthetic corpus shares utterance timing across speakers, so no DTW is
needed; see synthesis.py):

- MCD (mel-cepstral distortion, dB): 10/ln10 * sqrt(2 * sum (dc_k)^2)
  over cepstral coefficients 1..K, averaged over co-speech frames.
- F0 RMSE (cents) + voicing decision agreement, F0 by autocorrelation.
- LSD (log-spectral distance, dB) over rFFT magnitudes.

These score the *converted* output against the target speaker's own
rendition of the same utterance; the (source vs target) score with no
conversion applied is the do-nothing baseline a conversion must beat.

A copy of `beatrice_vst_tpu/training/quality.py` (the port imports nothing of
the JAX package).
"""

from __future__ import annotations

import numpy as np

EPS = 1e-10


def _frames(x: np.ndarray, sr: int, win_s: float = 0.025, hop_s: float = 0.010):
    w = int(sr * win_s)
    h = int(sr * hop_s)
    n = 1 + max(0, (len(x) - w) // h)
    idx = np.arange(n)[:, None] * h + np.arange(w)[None, :]
    return x[idx] * np.hanning(w)


def _mel_filters(sr: int, n_fft: int, n_mels: int = 40,
                 fmin: float = 0.0, fmax: float | None = None):
    fmax = fmax or sr / 2
    mel = lambda f: 2595.0 * np.log10(1.0 + f / 700.0)
    imel = lambda m: 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    pts = imel(np.linspace(mel(fmin), mel(fmax), n_mels + 2))
    bins = np.fft.rfftfreq(n_fft, 1.0 / sr)
    fb = np.zeros((n_mels, len(bins)))
    for i in range(n_mels):
        lo, c, hi = pts[i], pts[i + 1], pts[i + 2]
        fb[i] = np.clip(np.minimum((bins - lo) / (c - lo + EPS),
                                   (hi - bins) / (hi - c + EPS)), 0, None)
    return fb


def mel_cepstra(x: np.ndarray, sr: int, n_mels: int = 40, n_ceps: int = 13,
                fmax: float | None = 8000.0):
    """[T] -> (ceps [frames, n_ceps+1] incl c0, frame energies).

    fmax defaults to 8 kHz -- the conventional MCD band; above it
    aspiration noise (incoherent between renditions) dominates."""
    seg = _frames(x, sr)
    n_fft = seg.shape[1]
    mag = np.abs(np.fft.rfft(seg, axis=-1))
    fb = _mel_filters(sr, n_fft, n_mels,
                      fmax=min(fmax or sr / 2, sr / 2))
    mel = mag @ fb.T
    # -60 dB relative floor: without it, bands that are numerically silent
    # in both signals (e.g. tilted-away high frequencies) contribute huge
    # log-differences that have no perceptual counterpart
    mel = np.maximum(mel, mel.max() * 1e-6 + EPS)
    logmel = np.log(mel)
    # DCT-II orthonormal
    k = np.arange(n_mels)
    dct = np.cos(np.pi * (k[None, :] + 0.5) * np.arange(n_ceps + 1)[:, None]
                 / n_mels) * np.sqrt(2.0 / n_mels)
    dct[0] /= np.sqrt(2.0)
    ceps = logmel @ dct.T
    energy = (seg ** 2).mean(-1)
    return ceps, energy


def mcd_db(x: np.ndarray, y: np.ndarray, sr: int,
           energy_gate_db: float = 35.0) -> float:
    """Mel-cepstral distortion between frame-aligned waveforms (dB)."""
    n = min(len(x), len(y))
    cx, ex = mel_cepstra(x[:n], sr)
    cy, ey = mel_cepstra(y[:n], sr)
    m = min(len(cx), len(cy))
    cx, cy, ex, ey = cx[:m], cy[:m], ex[:m], ey[:m]
    # co-speech frames: both within energy_gate_db of their own peak
    def active(e):
        db = 10 * np.log10(e + EPS)
        return db > db.max() - energy_gate_db
    sel = active(ex) & active(ey)
    if sel.sum() < 4:
        sel = np.ones(m, bool)
    d = cx[sel, 1:] - cy[sel, 1:]  # exclude c0 (gain)
    return float((10.0 / np.log(10.0))
                 * np.mean(np.sqrt(2.0 * (d ** 2).sum(-1))))


def f0_track(x: np.ndarray, sr: int, fmin: float = 60.0, fmax: float = 460.0,
             clarity: float = 0.5):
    """Autocorrelation F0 per 40 ms window / 10 ms hop -> (f0 Hz, voiced mask).

    The search band covers the F0-augmented corpus registers
    (training/synthesis.py f0_scale_range: ~62-400 Hz instantaneous)."""
    parts = f0_track_parts(x, sr, fmin, fmax, clarity)
    return parts["f0"], parts["voiced"]


def f0_track_parts(x: np.ndarray, sr: int, fmin: float = 60.0, fmax: float = 460.0,
                   clarity: float = 0.5) -> dict:
    """`f0_track` with its intermediates per frame: the normalized
    autocorrelation over the lag band from `lo` (`band`), the first argmax
    (`lag0`) and its value (`peak`), the energy (`e_db`) against its gate
    (`e_thr`), `voiced`, the band's local maxima (`local`), the median
    voiced lag (`med_lag`, None when nothing is voiced), the re-locked
    `lag` and the filtered `f0`, beside the `clarity` threshold."""
    seg = _frames(x, sr, 0.040, 0.010)
    seg = seg - seg.mean(-1, keepdims=True)
    n = seg.shape[1]
    spec = np.fft.rfft(seg, n=2 * n, axis=-1)
    ac = np.fft.irfft(spec * np.conj(spec), axis=-1)[:, :n]
    ac0 = ac[:, :1] + EPS
    acn = ac / ac0
    lo = int(sr / fmax)
    hi = min(int(sr / fmin), n - 1)
    band = acn[:, lo:hi]
    lag0 = lo + np.argmax(band, axis=-1)
    peak = acn[np.arange(len(lag0)), lag0]
    energy = ac[:, 0] / n
    e_db = 10 * np.log10(energy + EPS)
    e_thr = e_db.max() - 35.0
    voiced = (peak > clarity) & (e_db > e_thr)
    prev = np.pad(band, ((0, 0), (1, 0)), constant_values=-2)[:, :-1]
    nxt = np.pad(band, ((0, 0), (0, 1)), constant_values=-2)[:, 1:]
    local = (band >= prev) & (band >= nxt)
    # Peak disambiguation (r6): the corpus shares one F0 contour across
    # speakers, so do-nothing pairs have IDENTICAL true F0 -- yet the
    # plain argmax tracker scored them at ~245 cents RMSE: the entire
    # do-nothing baseline (and a chunk of every converted number, plus
    # the TRAINING labels data.py derives with this same tracker) was
    # octave flips and band-edge formant locks (measured per-speaker vs
    # the synthesis plan: up to 1340 cents on an 89 Hz utterance).
    # Candidates = local maxima of the normalized autocorrelation within
    # 2x of the frame's best peak; among them pick the lag closest
    # (log-domain) to the utterance's median -- corpus contours stay
    # well inside +-half an octave of their median, and the median is
    # robust to <50% bad frames.  Threshold swept on the rendered
    # corpus vs plan F0: 0.6 -> worst 380 / mean 67 cents, 0.5 -> 251/57,
    # 0.45 -> 252/52 (from 1340/245 unfixed); 0.5 keeps margin against
    # weak noise bumps near the median.
    lag = lag0.astype(np.int64)
    med_lag = None
    if voiced.any():
        strong = local & (band >= 0.5 * peak[:, None])
        strong[np.arange(len(lag)), lag - lo] = True
        med_lag = float(np.median(lag[voiced]))
        dist = np.abs(np.log2(np.arange(lo, hi)[None, :] / med_lag))
        lag = lo + np.argmin(np.where(strong, dist, np.inf), axis=-1)
    f0 = sr / np.maximum(lag, 1)
    # 5-frame median filter: single-frame octave / formant-peak errors at
    # transitions otherwise dominate the RMSE
    from scipy.signal import medfilt

    f0 = medfilt(f0, 5)
    return {"band": band, "lo": lo, "lag0": lag0, "peak": peak, "e_db": e_db,
            "e_thr": e_thr, "clarity": clarity, "voiced": voiced, "local": local,
            "med_lag": med_lag, "lag": lag, "f0": f0}


def f0_rmse_cents(x: np.ndarray, y: np.ndarray, sr: int):
    """(RMSE in cents over co-voiced frames, voicing agreement 0..1)."""
    n = min(len(x), len(y))
    fx, vx = f0_track(x[:n], sr)
    fy, vy = f0_track(y[:n], sr)
    m = min(len(fx), len(fy))
    fx, fy, vx, vy = fx[:m], fy[:m], vx[:m], vy[:m]
    both = vx & vy
    agree = float((vx == vy).mean()) if m else 0.0
    if both.sum() < 4:
        return float("nan"), agree
    cents = 1200.0 * np.log2(fx[both] / fy[both])
    return float(np.sqrt((cents ** 2).mean())), agree


def lsd_db(x: np.ndarray, y: np.ndarray, sr: int) -> float:
    """Log-spectral distance (dB), averaged over co-speech frames."""
    n = min(len(x), len(y))
    sx = _frames(x[:n], sr)
    sy = _frames(y[:n], sr)
    m = min(len(sx), len(sy))
    gx = np.abs(np.fft.rfft(sx[:m], axis=-1))
    gy = np.abs(np.fft.rfft(sy[:m], axis=-1))
    # speech band only (see mel_cepstra) + -60 dB relative floor
    bins = np.fft.rfftfreq(sx.shape[1], 1.0 / sr)
    band = bins <= 8000.0
    gx = np.maximum(gx[:, band], gx.max() * 1e-3 + EPS)
    gy = np.maximum(gy[:, band], gy.max() * 1e-3 + EPS)
    mx = 20 * np.log10(gx)
    my = 20 * np.log10(gy)
    ex = (sx[:m] ** 2).mean(-1)
    db = 10 * np.log10(ex + EPS)
    sel = db > db.max() - 35.0
    if sel.sum() < 4:
        sel = np.ones(m, bool)
    return float(np.mean(np.sqrt(((mx[sel] - my[sel]) ** 2).mean(-1))))


def f0_rmse_cents_vs_truth(x: np.ndarray, f0_truth: np.ndarray, sr: int):
    """(RMSE cents of track(x) vs the known per-frame truth contour,
    voicing agreement vs truth voicing).

    The synthetic corpus KNOWS its F0 (the synthesis plan, 10 ms frames,
    0 = unvoiced); scoring against it removes the reference rendition's
    own tracker error from every row (the two-sided tracked comparison
    charged converted audio for the REFERENCE's mistracks too -- on some
    low-register speaker pairs that alone was >1000 cents)."""
    fx, vx = f0_track(x, sr)
    m = min(len(fx), len(f0_truth))
    fx, vx, ft = fx[:m], vx[:m], np.asarray(f0_truth[:m], np.float64)
    tv = ft > 0
    both = vx & tv
    agree = float((vx == tv).mean()) if m else 0.0
    if both.sum() < 4:
        return float("nan"), agree
    cents = 1200.0 * np.log2(fx[both] / ft[both])
    return float(np.sqrt((cents ** 2).mean())), agree


def compare(converted: np.ndarray, target_ref: np.ndarray, sr: int,
            f0_truth: np.ndarray | None = None) -> dict:
    """All metrics of a converted clip vs the target speaker's rendition.

    f0_truth: optional known per-frame F0 contour (Hz, 10 ms frames,
    0 = unvoiced); when given, the F0/voicing rows score against it
    instead of against a second tracker pass over target_ref."""
    if f0_truth is not None:
        rmse, agree = f0_rmse_cents_vs_truth(converted, f0_truth, sr)
    else:
        rmse, agree = f0_rmse_cents(converted, target_ref, sr)
    return {
        "mcd_db": round(mcd_db(converted, target_ref, sr), 3),
        "f0_rmse_cents": round(rmse, 1) if np.isfinite(rmse) else None,
        "voicing_agreement": round(agree, 3),
        "lsd_db": round(lsd_db(converted, target_ref, sr), 3),
    }


def should_promote(old_summary: dict, new_summary: dict, *,
                   mcd_spread_db: float = 0.3,
                   f0_regress_tol: float = 1.10) -> tuple[bool, str]:
    """Multi-metric model-promotion rule (VERDICT r4 weak #2).

    The r5 MCD-only gate could not accept the burst that won the round's
    priority metric (F0 RMSE 507->424 cents at +0.11 dB MCD, within the
    eval's pair-to-pair spread) -- and, symmetrically, would have accepted
    a large F0 regression that shaved 0.1 dB MCD.  This encodes the rule
    the round actually wanted:

      promote iff  (a) clear MCD win  AND F0 not regressed by more than
                       `f0_regress_tol` AND worse-than-do-nothing pair
                       count not up,   or
                   (b) MCD within `mcd_spread_db` of the incumbent AND
                       F0 strictly better AND worse-pairs not up.

    old_summary/new_summary: QUALITY_REPORT "summary" dicts (needs
    converted.mcd_db, converted.f0_rmse_cents,
    pairs_worse_than_do_nothing_mcd).  Returns (promote, reason).
    """
    try:
        mcd_o = old_summary["converted"]["mcd_db"]
        f0_o = old_summary["converted"]["f0_rmse_cents"]
        mcd_n = new_summary["converted"]["mcd_db"]
        f0_n = new_summary["converted"]["f0_rmse_cents"]
    except (KeyError, TypeError):
        return False, "summary missing converted metrics"
    if None in (mcd_o, f0_o, mcd_n, f0_n):
        return False, "non-finite metric (eval failure); keeping incumbent"
    worse_o = old_summary.get("pairs_worse_than_do_nothing_mcd")
    worse_n = new_summary.get("pairs_worse_than_do_nothing_mcd")
    pairs_ok = worse_o is None or worse_n is None or worse_n <= worse_o
    if not pairs_ok:
        return False, (f"worse-than-do-nothing pairs up "
                       f"{worse_o} -> {worse_n}")
    if mcd_n < mcd_o and f0_n <= f0_o * f0_regress_tol:
        return True, (f"MCD win {mcd_o:.3f} -> {mcd_n:.3f} dB, F0 "
                      f"{f0_o:.1f} -> {f0_n:.1f} cents within tolerance")
    if mcd_n <= mcd_o + mcd_spread_db and f0_n < f0_o:
        return True, (f"F0 win {f0_o:.1f} -> {f0_n:.1f} cents, MCD "
                      f"{mcd_o:.3f} -> {mcd_n:.3f} dB within spread")
    return False, (f"no win: MCD {mcd_o:.3f} -> {mcd_n:.3f} dB, "
                   f"F0 {f0_o:.1f} -> {f0_n:.1f} cents")
