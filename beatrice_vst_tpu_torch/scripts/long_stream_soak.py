"""Long-horizon streaming soak of the port (counterpart of the repo's
`scripts/long_stream_soak.py`, which runs the JAX package).

    python -m beatrice_vst_tpu_torch.scripts.long_stream_soak [--minutes 10]
        [--oracle-minutes 2] [--chunk-frames 600] [--legs a,b]
        [--model models_demo/klatt8] [--report PATH]
        [--device cuda]

The golden files hold the port to 20-40 ticks and the oracle tests to 300
frames; serving runs for hours.  This drives reset-free streams for
`--minutes` (60,000 frames at 10) through the compiled real-time tick
(`StreamEngine(jit=True)`, one frame a tick, each tick's output read back
on the host) and through the compiled chunk tick (`--chunk-frames` frames
a tick) with the state carried, one minute window at a time, and gates,
as the JAX soak does:

  * `state_bounded`: the largest |value| of the streaming engine's
    floating carries (its state less the control tensors, whose average
    source pitch of 52 would hide every carry) at the end of each minute
    is at most 3x the first minute's + 1 (no accumulator blows up);
  * `stream_eq_chunk_within_drift_budget`: each minute's max |d| between
    the two paths is at most 1e-3 + 6e-3 a minute (the two paths carry
    the source phase in f32 in different orders: T = 1 adds each frame's
    increment to the carried phase, T > 1 takes one f64 prefix sum,
    `models/waveform_generator.py:_source_phases`);
  * `stream_eq_chunk_spectral_1e-2`: the relative max |d| of 960-sample
    Hann STFT magnitudes each minute is at most 1e-2 (insensitive to that
    phase drift; ring-pointer, filter-state or noise-counter faults break
    it at once);
  * `oracle_prefix_2e-3` (leg a): stream 0's first `--oracle-minutes` are
    within 2e-3 of the float64 oracle (`reference_impl.chain_forward`)
    between the engine's own resampler matrices in f64, conditioned by
    `runtime/offline.py:build_cond` for stream 0's settings, with the
    source-phase trajectory built from the oracle's pitch bins by the
    port's own T = 1 carry (`_source_phases` frame by frame, on the
    engine's device), so that f32 phase-step rounding shared by any f32
    renderer is not counted as error.

Two legs.  Leg a is the JAX soak's scenario: two streams
(`EngineConfig.realtime(2)`: slot-bank K/V, shared-bank VQ at T = 1), a
150 Hz tone (VQ off) and a vibrato tone (VQ 2), on a model directory's
weights (klatt8 by default: the JAX soak's random `chain.init` cannot be
drawn without JAX).  Leg b is the service's scale: 256 streams of
`EngineConfig.realtime(256)`, stream i on signal i % 2 with the controls
of leg a's stream i % 2 and the speaker and pitch shift of `VOICES[i %
len(VOICES)]`, chunks of CHUNK_FRAMES_B frames; no oracle.  Only a minute window of each path is held on
the host at a time (leg b's full horizon would be 29 GB), and its
deviations are taken on the engine's device in batches of rows.

`run_soak` returns the report; `main` writes it to `--report` (if given),
prints it and exits 1 if any gate failed.  TF32 is turned off in `main`
(the gates are f32 gates); a caller of `run_soak` turns it off itself.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from .. import reference_impl as oracle
from ..constants import COMMON_HOP_LENGTH
from ..device import resolve_device
from ..models import chain, waveform_generator
from ..models.io import load_model_dir
from ..ops.resample import input_resampler_48k_to_16k, output_resampler_24k_to_48k
from ..runtime import graphs
from ..runtime.engine import EngineConfig, StreamEngine, engine_tick
from ..runtime.offline import ConversionSettings, build_cond

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
MODEL_DIR = os.path.join(REPO, "models_demo", "klatt8")
MINUTE = 6000  # frames
HOP = COMMON_HOP_LENGTH  # 480 samples at 48 kHz a frame
STFT_WIN = 960
DRIFT_BASE, DRIFT_PER_MINUTE = 1e-3, 6e-3
SPECTRAL_GATE = 1e-2
ORACLE_GATE = 2e-3
STATE_FACTOR, STATE_SLACK = 3.0, 1.0
# leg a's streams: the JAX soak's controls (`long_stream_soak.py:96-122`);
# stream 0 keeps VQ off so that the oracle leg has no k-NN near-ties
LEG_A = ({"target_speaker": 0, "pitch_shift": 3.0, "vq_num_neighbors": 0, "min_q": 1,
          "max_q": 383},
         {"target_speaker": 0, "pitch_shift": -2.0, "vq_num_neighbors": 2, "min_q": 1,
          "max_q": 383})
# leg b: stream i's (speaker, pitch shift), taken mod the bank's speakers
VOICES = ((0, 3.0), (1, -2.0), (2, 5.0), (3, 0.0), (4, -4.0), (5, 2.0), (6, -1.0), (7, 7.0),
          (3, -6.0), (5, 4.0), (1, 1.5), (6, -3.5))
STREAMS_B = 256
# leg b's chunk: the T = 600 engine at 256 streams holds most of the card
# in its graph's pool (49 GB with the T = 1 engine, on an H100), and a
# flip's replay (`locate_flips`) builds a second pair beside them
CHUNK_FRAMES_B = 100
DEVIATION_ROWS = 16  # rows a batch in window_deviation
# a flip between two candidates closer than this (relative to their size)
# is a tie that f32 rounding decides; a stream's windows are held up to it
TIE_GAP = 1e-5
VQ_PART = 1e-4  # the VQ-smoothed phones of the two paths part by more
MAX_REPLAYS = 4  # locate_flips calls in a leg


def soak_signals(n_frames: int, seed: int = 0, streams: int = 2) -> np.ndarray:
    """The JAX soak's two signals at 48 kHz (`long_stream_soak.py:86-95`):
    a 150 Hz tone and a vibrato tone, each plus N(0, 0.02^2) noise from
    one numpy generator; [streams, n_frames * 480] f32, row i signal
    i % 2."""
    rng = np.random.default_rng(seed)
    t48 = np.arange(n_frames * HOP) / 48000.0
    pair = np.stack([
        (0.3 * np.sin(2 * np.pi * 150.0 * t48)
         + 0.02 * rng.standard_normal(len(t48))),
        (0.25 * np.sin(2 * np.pi * (220 + 40 * np.sin(2 * np.pi * 0.23 * t48)) * t48)
         + 0.02 * rng.standard_normal(len(t48))),
    ]).astype(np.float32)
    return pair if streams == 2 else pair[np.arange(streams) % 2]


def soak_controls(streams: int, n_speakers: int = 8) -> list[dict]:
    """Each stream's controls: leg a's two for two streams; otherwise
    stream i has leg a's stream i % 2 with VOICES[i % len(VOICES)]'s
    speaker (mod n_speakers) and pitch shift."""
    if streams <= len(LEG_A):
        return [dict(c) for c in LEG_A[:streams]]
    out = []
    for i in range(streams):
        speaker, shift = VOICES[i % len(VOICES)]
        out.append(dict(LEG_A[i % 2], target_speaker=speaker % n_speakers, pitch_shift=shift))
    return out


def soak_engine(params, bank, model_cfg, streams: int, frames_per_tick: int = 1,
                device="cuda") -> StreamEngine:
    """A compiled `EngineConfig.realtime(streams)` engine of `frames_per_tick`
    frames a tick with every stream admitted under `soak_controls`, the
    controls applied."""
    engine = StreamEngine(EngineConfig.realtime(streams, spec=model_cfg.spec,
                                                frames_per_tick=frames_per_tick),
                          params, bank, device=device)
    for c in soak_controls(streams, bank["additive"].shape[0]):
        i = engine.admit()
        for field, value in c.items():
            engine.set_control(i, field, value)
    engine.flush_controls()  # the state holds the controls: a snapshot of it is whole
    return engine


def state_max_abs(state) -> float:
    """The largest |value| over the floating tensors of a state tree."""
    if isinstance(state, dict):
        return max((state_max_abs(v) for v in state.values()), default=0.0)
    if isinstance(state, (list, tuple)):
        return max((state_max_abs(v) for v in state), default=0.0)
    if torch.is_tensor(state) and state.is_floating_point() and state.numel():
        return float(state.abs().max())
    return 0.0


def window_deviation(a, b, device="cpu", rows: int = DEVIATION_ROWS) -> dict:
    """Two paths' outputs over one window, [streams, samples] each (numpy or
    tensors): the max |d| ("max_abs"), the relative max |d| of their
    960-sample Hann STFT magnitudes ("spec_rel": max |d| over the largest
    magnitude of `b`), the stream of the largest |d| ("worst_stream") and
    the first frame of that stream whose |d| exceeds DRIFT_BASE
    ("first_frame_over_base", None if none); and each stream's own ("rows":
    [(max |d|, spectral max |d| over the window's largest magnitude, first
    frame over DRIFT_BASE or None)]).  Taken in f64 on `device`, `rows`
    streams at a time."""
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    if a.shape != b.shape or a.shape[1] % STFT_WIN:
        raise ValueError(f"windows of shapes {tuple(a.shape)}, {tuple(b.shape)}: equal shapes "
                         f"of a multiple of {STFT_WIN} samples expected")
    hann = torch.from_numpy(np.hanning(STFT_WIN)).to(device)
    per_row, num, first, den = [], [], [], 0.0
    for r0 in range(0, a.shape[0], rows):
        x = a[r0:r0 + rows].to(device, torch.float64)
        y = b[r0:r0 + rows].to(device, torch.float64)
        d = (x - y).abs().reshape(x.shape[0], -1, HOP).amax(dim=2)  # [rows, frames]
        per_row += d.amax(dim=1).tolist()
        over = d > DRIFT_BASE
        first += [int(i) if o else None
                  for i, o in zip(over.int().argmax(dim=1).tolist(), over.any(dim=1).tolist())]
        mx = torch.fft.rfft(x.reshape(x.shape[0], -1, STFT_WIN) * hann).abs()
        my = torch.fft.rfft(y.reshape(y.shape[0], -1, STFT_WIN) * hann).abs()
        num += (mx - my).abs().amax(dim=(1, 2)).tolist()
        den = max(den, float(my.max()))
    den = max(den, 1e-9)
    stream = int(np.argmax(per_row))
    return {"max_abs": per_row[stream], "spec_rel": max(num) / den, "worst_stream": stream,
            "first_frame_over_base": first[stream],
            "rows": [(m, n / den, f) for m, n, f in zip(per_row, num, first)]}


def drift_budget(window: int, win: int = MINUTE) -> float:
    """Window `window`'s waveform budget: 1e-3 + 6e-3 a minute elapsed
    at its end (`long_stream_soak.py:197-201`)."""
    return DRIFT_BASE + DRIFT_PER_MINUTE * (window + 1) * win / MINUTE


def gates(per_minute, spec_per_minute, state_norms, win: int = MINUTE,
          oracle_diff: float | None = None) -> dict:
    """The JAX soak's gates under its names, from each window's max |d| and
    spectral deviation, the per-minute state norms and, if measured, the
    oracle prefix's max |d|."""
    out = {
        "state_bounded": bool(all(n <= STATE_FACTOR * state_norms[0] + STATE_SLACK
                                  for n in state_norms)),
        "stream_eq_chunk_within_drift_budget": bool(all(
            d <= drift_budget(m, win) for m, d in enumerate(per_minute))),
        "stream_eq_chunk_spectral_1e-2": bool(max(spec_per_minute) <= SPECTRAL_GATE),
    }
    if oracle_diff is not None:
        out["oracle_prefix_2e-3"] = bool(oracle_diff <= ORACLE_GATE)
    return out


def soak_gates(out_stream, out_chunk, state_norms, oracle_diff: float | None = None,
               win: int = MINUTE) -> dict:
    """The JAX soak's report fields and gates from the two paths' whole
    outputs [streams, n_frames * 480] (windows of `win` frames, the last
    one possibly shorter), the per-minute state norms and the oracle
    prefix's max |d| (None: not measured, no oracle gate)."""
    n_frames = np.shape(out_stream)[1] // HOP
    devs = [window_deviation(out_stream[:, s * HOP:min(s + win, n_frames) * HOP],
                             out_chunk[:, s * HOP:min(s + win, n_frames) * HOP])
            for s in range(0, n_frames, win)]
    per_minute = [d["max_abs"] for d in devs]
    spec = [d["spec_rel"] for d in devs]
    report = {"state_max_abs_per_minute": list(state_norms),
              "stream_vs_chunk_max_abs_per_minute": per_minute,
              "stream_vs_chunk_spec_rel_per_minute": spec,
              "gates": gates(per_minute, spec, state_norms, win, oracle_diff)}
    if oracle_diff is not None:
        report["oracle_max_abs_diff"] = oracle_diff
    return report


def _resample_f64(x, rs) -> np.ndarray:
    """A resampler's banded matrix applied in f64 block by block from zero
    history (the engine's streaming convention)."""
    s = rs.dense_np().astype(np.float64)
    full = np.concatenate([np.zeros(rs.history_len), np.asarray(x, np.float64)])
    n = (len(full) - rs.history_len) // rs.in_block
    windows = np.lib.stride_tricks.sliding_window_view(
        full, rs.history_len + rs.in_block)[::rs.in_block][:n]
    return (windows @ s).reshape(-1)


def _port_phases(qp, device) -> np.ndarray:
    """Frame-start source phases [T] for the pitch bins qp [T], carried frame
    by frame through the port's `_source_phases` as its T = 1 tick carries
    them, on `device` (its f32 pitch-to-step arithmetic is the device's)."""
    q = torch.as_tensor(np.asarray(qp), dtype=torch.int64, device=device)[None]
    phase = torch.zeros(1, device=device)
    starts = []
    for i in range(q.shape[1]):
        start, _, phase = waveform_generator._source_phases(q[:, i:i + 1], phase)
        starts.append(start[0, 0])
    return torch.stack(starts).cpu().numpy()


def oracle_prefix(params, bank, model_cfg, audio48, controls, out48, device="cuda") -> float:
    """Max |d| of one stream's streamed output out48 [n * 480] from the
    float64 oracle run on its input audio48 (at least as long) with its
    controls (`long_stream_soak.py:212-281`)."""
    n = len(out48) // HOP
    x16 = _resample_f64(audio48[:n * HOP], input_resampler_48k_to_16k(1))
    bank_t = {k: torch.as_tensor(v) for k, v in bank.items()}
    cond = build_cond(None, model_cfg, bank_t, ConversionSettings(
        target_speaker=controls["target_speaker"], pitch_shift=controls["pitch_shift"],
        vq_num_neighbors=controls["vq_num_neighbors"]), raw_kv=True)
    spec = model_cfg.spec
    settings = {"speaker_embedding": cond["speaker_embedding"][0].double().numpy(),
                "pitch_shift": controls["pitch_shift"],
                "vq_num_neighbors": controls["vq_num_neighbors"],
                "min_q": controls["min_q"], "max_q": controls["max_q"]}
    if spec.has_vq:
        settings["codebook"] = cond["codebook"][0].double().numpy()
    if spec.has_kv:
        settings["kv"] = cond["kv"][0].double().numpy()
    p64 = oracle._np(params)
    qp_raw, _ = oracle.pitch_forward(p64["pitch"], model_cfg, x16, settings["min_q"],
                                     settings["max_q"])
    qp = oracle.transform_pitch(qp_raw, 52.0, 1.0, settings["pitch_shift"], 0.0, 0,
                                spec.pitch_bins)
    y24 = oracle.chain_forward(params, model_cfg, x16, target_settings=settings,
                               phase_start=_port_phases(qp, device))
    y48 = _resample_f64(y24, output_resampler_24k_to_48k(1))
    m = min(len(y48), len(out48))
    return float(np.abs(np.asarray(out48[:m], np.float64) - y48[:m]).max())


@contextlib.contextmanager
def _chain_taps():
    """While active, every `chain.apply` records its taps (`with_taps`) and
    the VQ's query (the phone before smoothing, "vq_query") in the
    yielded dict."""
    rec = {}
    apply, smooth = chain.apply, chain._smooth_phone

    def tapped_apply(*args, **kw):
        y, state, taps = apply(*args, **kw, with_taps=True)
        rec.update(taps)
        return y, state

    def tapped_smooth(phone, cond, *args):
        rec["vq_query"] = phone
        return smooth(phone, cond, *args)

    chain.apply, chain._smooth_phone = tapped_apply, tapped_smooth
    try:
        yield rec
    finally:
        chain.apply, chain._smooth_phone = apply, smooth


def _gap(scores, a, b, lower_wins: bool) -> float:
    """How far candidate a beats candidate b in `scores` (>= 0 when a wins)."""
    d = float(scores[b] - scores[a]) if lower_wins else float(scores[a] - scores[b])
    return d / max(1.0, abs(float(scores[a])))


def locate_flips(params, bank, model_cfg, streams: int, chunk_frames: int, signals,
                 candidates: dict, start=None, device="cuda") -> tuple[list[dict], int]:
    """Where each candidate stream's two paths part, at or before its frame
    (`candidates`: stream -> frame).  Both paths restart from `start`, (w0,
    {"stream": state, "chunk": state}) snapshots of the two engines at
    frame w0 (None: from frame 0), are replayed (compiled) to the start of
    the chunk holding the earliest frame, then run eagerly with the chain's
    taps up to the latest, the T = 1 path frame by frame.  The first frame
    where a stream's pitch bins differ, or its VQ-smoothed phones part by
    more than VQ_PART, is its flip.  The flip's gap is how far each path's
    choice beats the other's there, the larger of the two, relative to the
    winner's size: the pitch logits, or the f64 distances of the T = 1
    path's query to its n-th and (n+1)-th nearest codebook entries.  A gap
    within TIE_GAP is a tie.  Returns ([{"stream", "frame", "kind" ("pitch",
    "vq", or None: none found), "candidates", "gap", "tie"}], the T = 1
    engine's ticks, warm-up ticks included)."""
    w0, snaps = start or (0, None)
    c0 = min(candidates.values()) // chunk_frames * chunk_frames
    last = max(candidates.values())
    rows = torch.arange(streams, device=device) % 2

    def block(f0, n):
        return signals[rows, f0 * HOP:(f0 + n) * HOP]

    eng = {name: soak_engine(params, bank, model_cfg, streams, t, device)
           for name, t in (("stream", 1), ("chunk", chunk_frames))}
    if snaps is not None:
        for name, e in eng.items():
            graphs.copy_tree_(e.state, snaps[name])
    for f in range(w0, c0):
        eng["stream"].tick(block(f, 1))
    for c in range(w0, c0, chunk_frames):
        eng["chunk"].tick(block(c, chunk_frames))
    controls = soak_controls(streams, bank["additive"].shape[0])
    flips = {s: {"stream": s, "frame": None, "kind": None, "candidates": None, "gap": None,
                 "tie": False} for s in candidates}
    with _chain_taps() as rec:
        e, state, chunk = eng["chunk"], eng["chunk"].state, {s: [] for s in candidates}
        for c in range(c0, last + 1, chunk_frames):
            _, state = engine_tick(e.params, e.bank, state, block(c, chunk_frames), cfg=e.cfg)
            for s in candidates:
                chunk[s].append({k: v[s].detach().cpu() for k, v in rec.items()})
        e, state, frame = eng["stream"], eng["stream"].state, c0
        pending = set(candidates)
        while pending and frame <= last:
            _, state = engine_tick(e.params, e.bank, state, block(frame, 1), cfg=e.cfg)
            i, t = divmod(frame - c0, chunk_frames)
            for s in sorted(pending):
                tap = {k: v[s, 0].detach().cpu() for k, v in rec.items()}
                ch = {k: v[t] for k, v in chunk[s][i].items()}
                qs, qc = int(tap["qp_raw"]), int(ch["qp_raw"])
                n = controls[s]["vq_num_neighbors"]
                if qs != qc:
                    ls, lc = tap["pitch_logits"].double(), ch["pitch_logits"].double()
                    flips[s].update(frame=frame, kind="pitch", candidates=[qs, qc],
                                    gap=max(_gap(ls, qs, qc, False), _gap(lc, qc, qs, False)))
                elif n and float((tap["phone"] - ch["phone"]).abs().max()) > VQ_PART:
                    cb = torch.as_tensor(bank["codebook"][controls[s]["target_speaker"]],
                                         dtype=torch.float64)
                    dist = (cb * cb).sum(-1) - 2.0 * cb @ tap["vq_query"].double()
                    order = torch.argsort(dist)
                    a, b = int(order[n - 1]), int(order[n])
                    flips[s].update(frame=frame, kind="vq", candidates=[a, b],
                                    gap=_gap(dist, a, b, True))
                if flips[s]["kind"] is not None or frame >= candidates[s]:
                    pending.discard(s)
            frame += 1
    for flip in flips.values():
        flip["tie"] = flip["gap"] is not None and flip["gap"] <= TIE_GAP
    ticks = eng["stream"].counters.get("graph_warmup_ticks", 0) + frame - w0
    return [flips[s] for s in sorted(flips)], ticks


def _hold(out, w0: int, held: dict) -> None:
    """Zero each held stream's samples of a window [streams, samples] that
    starts at frame w0, from its tie frame on."""
    for stream, frame in held.items():
        out[stream, max(frame - w0, 0) * HOP:] = 0.0


def run_leg(params, bank, model_cfg, streams: int, n_frames: int, chunk_frames: int,
            oracle_frames: int = 0, seed: int = 0, device="cuda", log=print) -> dict:
    """One leg: `streams` streams of `soak_controls` on `soak_signals`,
    n_frames frames through the compiled T = 1 engine and the compiled
    T = chunk_frames engine, compared a minute at a time (or as one window
    if the run is shorter); with oracle_frames > 0, stream 0's first
    oracle_frames against the float64 oracle.  A window that fails the
    drift budget or the spectral gate has the flips of its failing streams
    located (`locate_flips`, from a snapshot of the window's start); a tie
    holds its stream from its frame on (its samples leave the comparison,
    `_hold`) and the window is compared again; any other flip stands.  Returns the leg's report, with the
    flips and the held streams."""
    device = resolve_device(device)
    win = min(MINUTE, n_frames)
    if n_frames % win or win % chunk_frames or oracle_frames > n_frames or win % 2:
        raise ValueError(f"{n_frames} frames in windows of {win} and chunks of "
                         f"{chunk_frames}: the run must be whole even windows of whole "
                         f"chunks, and the oracle prefix ({oracle_frames}) inside it")
    t0 = time.perf_counter()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    signals = torch.from_numpy(soak_signals(n_frames, seed, 2)).to(device)
    rows = torch.arange(streams, device=device) % 2
    engines = {name: soak_engine(params, bank, model_cfg, streams, t, device)
               for name, t in (("stream", 1), ("chunk", chunk_frames))}
    build_s = time.perf_counter() - t0
    spent = {"stream": 0.0, "chunk": 0.0}
    norms, devs, unheld, flips, held = [], [], [], [], {}
    replays = t1_ticks = 0
    prefix = np.empty(oracle_frames * HOP, np.float32)
    for w0 in range(0, n_frames, win):
        # the engines' states at the window's start, for a flip's replay
        snap = {name: graphs.clone_tree(e.state) for name, e in engines.items()}
        outs = {}
        for name, engine in engines.items():
            t = engine.cfg.frames_per_tick
            out = torch.empty((streams, win * HOP))  # the window, on the host
            t1 = time.perf_counter()
            for f in range(0, win, t):
                s0 = (w0 + f) * HOP
                out[:, f * HOP:(f + t) * HOP].copy_(
                    engine.tick(signals[rows, s0:s0 + t * HOP]))
            spent[name] += time.perf_counter() - t1
            outs[name] = out
        norms.append(state_max_abs({k: v for k, v in engines["stream"].state.items()
                                    if k != "controls"}))
        if w0 < oracle_frames:
            k = min(oracle_frames - w0, win)
            prefix[w0 * HOP:(w0 + k) * HOP] = outs["stream"][0, :k * HOP].numpy()
        for out in outs.values():
            _hold(out, w0, held)
        dev = window_deviation(outs["stream"], outs["chunk"], device)
        unheld.append(dev["max_abs"])
        budget = drift_budget(len(devs), win)
        while ((dev["max_abs"] > budget or dev["spec_rel"] > SPECTRAL_GATE)
               and replays < MAX_REPLAYS and all(f["tie"] for f in flips)):
            bad = {k: w0 + f for k, (m, sp, f) in enumerate(dev["rows"])
                   if (m > budget or sp > SPECTRAL_GATE) and f is not None}
            if not bad:
                break
            found, ticks = locate_flips(params, bank, model_cfg, streams, chunk_frames,
                                        signals, bad, (w0, snap), device)
            replays, t1_ticks = replays + 1, t1_ticks + ticks
            flips += found
            log(f"  flips: {found}")
            held.update((f["stream"], f["frame"]) for f in found if f["tie"])
            for out in outs.values():
                _hold(out, w0, held)
            dev = window_deviation(outs["stream"], outs["chunk"], device)
        del dev["rows"]
        if dev["first_frame_over_base"] is not None:
            dev["first_frame_over_base"] += w0
        devs.append(dev)
        log(f"  {streams} streams, minute {(w0 + win) / MINUTE:g}: max|state| {norms[-1]:.4g}, "
            f"stream vs chunk max|d| {dev['max_abs']:.3g} (stream {dev['worst_stream']}), "
            f"spectral {dev['spec_rel']:.3g} [{time.perf_counter() - t0:.0f} s]")
    del engines, outs
    oracle_diff = None
    if oracle_frames:
        t1 = time.perf_counter()
        oracle_diff = oracle_prefix(params, bank, model_cfg,
                                    signals[0, :oracle_frames * HOP].cpu().numpy(),
                                    soak_controls(streams)[0], prefix, device)
        log(f"  oracle over {oracle_frames} frames: max|d| {oracle_diff:.3g} "
            f"[{time.perf_counter() - t1:.0f} s]")
    per_minute = [d["max_abs"] for d in devs]
    spec = [d["spec_rel"] for d in devs]
    report = {
        "streams": streams, "n_frames": n_frames, "minutes": n_frames / MINUTE,
        "window_frames": win, "chunk_frames": chunk_frames,
        "config": f"EngineConfig.realtime({streams}) (slots f32, shared-bank VQ at T = 1)",
        "state_max_abs_per_minute": norms,
        "stream_vs_chunk_max_abs_per_minute": per_minute,
        "stream_vs_chunk_spec_rel_per_minute": spec,
        "drift_budget_per_minute": [drift_budget(m, win) for m in range(len(devs))],
        "worst_stream_per_minute": [d["worst_stream"] for d in devs],
        "first_frame_over_1e-3_per_minute": [d["first_frame_over_base"] for d in devs],
        "flips": flips,
        "held_streams": held,
        "flip_replay_t1_ticks": t1_ticks,
        "max_abs_before_holds_per_minute": unheld,
        "gates": gates(per_minute, spec, norms, win, oracle_diff),
        "stream_ticks_per_s": n_frames / spent["stream"],
        "chunk_ticks_per_s": n_frames / chunk_frames / spent["chunk"],
        "build_s": build_s,
        "wall_s": time.perf_counter() - t0,
    }
    if device.type == "cuda":
        report["peak_mib"] = torch.cuda.max_memory_allocated(device) / 2**20
    if oracle_frames:
        report["oracle_prefix_frames"] = oracle_frames
        report["oracle_max_abs_diff"] = oracle_diff
    return report


def run_soak(model: str = MODEL_DIR, minutes: float = 10.0, oracle_minutes: float = 2.0,
             chunk_frames: int = 600, legs=("a", "b"), seed: int = 0, device="cuda",
             log=print) -> dict:
    """Leg a (two streams, chunks of chunk_frames, the oracle over the first
    oracle_minutes) and leg b (STREAMS_B streams, chunks of CHUNK_FRAMES_B),
    each for `minutes`.  Returns {"legs": {name: report}, "ok": every gate
    held, "device": ...}."""
    device = resolve_device(device)
    _, model_cfg, params, bank = load_model_dir(model)
    n_frames = int(round(minutes * MINUTE))
    report = {"model": os.path.relpath(os.path.abspath(model), REPO), "seed": seed,
              "device": (torch.cuda.get_device_name(device) if device.type == "cuda"
                         else "cpu"),
              "legs": {}}
    for leg in legs:
        log(f"leg {leg}")
        if leg == "a":
            report["legs"]["a"] = run_leg(params, bank, model_cfg, 2, n_frames, chunk_frames,
                                          int(round(oracle_minutes * MINUTE)), seed, device,
                                          log=log)
        elif leg == "b":
            report["legs"]["b"] = run_leg(params, bank, model_cfg, STREAMS_B, n_frames,
                                          CHUNK_FRAMES_B, 0, seed, device, log=log)
        else:
            raise ValueError(f"unknown leg {leg!r}: 'a' or 'b'")
    report["ok"] = all(all(r["gates"].values()) for r in report["legs"].values())
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--minutes", type=float, default=10.0)
    ap.add_argument("--oracle-minutes", type=float, default=2.0)
    ap.add_argument("--chunk-frames", type=int, default=600, help="leg a's chunk")
    ap.add_argument("--legs", default="a,b")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--model", default=MODEL_DIR)
    ap.add_argument("--report", default=None, help="write the report (JSON) here")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report = run_soak(args.model, args.minutes, args.oracle_minutes, args.chunk_frames,
                      tuple(args.legs.split(",")), args.seed, args.device,
                      log=lambda s: print(s, flush=True))
    if args.device.startswith("cuda"):
        report["nvidia_smi"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    if args.report:
        with open(args.report, "w") as f:
            json.dump(report, f, indent=1)
    print(json.dumps(report, indent=1))
    print("LONG STREAM SOAK:", "PASS" if report["ok"] else "FAIL")
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
