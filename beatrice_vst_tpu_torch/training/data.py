"""Training data pipeline: recorded-pair WAV datasets (port of
`beatrice_vst_tpu/training/data.py`).

    data_dir/
      inputs/<name>.wav    any sample rate (resampled to 16 kHz here)
      targets/<name>.wav   any sample rate (resampled to 24 kHz here)
      [speakers.json]      optional {"<name>": speaker_id} map
      [f0_plan.npz]        optional exact F0 contours {"<name>": [frames] Hz}

Without `targets/` the dataset runs in identity mode: the target is the
input resampled to 24 kHz.  Loading is host-side NumPy over the port's
host-edge resampler (`native/host.py`); batches are fixed-shape
[B, frames*160] / [B, frames*240] crops on the 10 ms frame grid, made by a
background thread into a bounded queue and moved to the device there.
"""

from __future__ import annotations

import json
import os
import queue as _queue
import threading

import numpy as np
import torch

from ..audio_io import read_wav
from ..constants import IN_SAMPLE_RATE, OUT_SAMPLE_RATE
from ..device import resolve_device
from ..models.io import params_from_numpy
from ..native.host import HostResampler
from .distill import f0_to_bin


def _to_rate(audio: np.ndarray, rate_in: int, rate_out: int) -> np.ndarray:
    if rate_in == rate_out:
        return audio.astype(np.float32)
    r = HostResampler(float(rate_in), float(rate_out))
    out = r.process(audio.astype(np.float32))
    # flush the filter tail so short files don't lose their end
    tail = r.process(np.zeros(256, np.float32))
    return np.concatenate([out, tail])


class PairDataset:
    """Every utterance loaded and cached in memory, each item
    (audio16, target24, speaker id, F0 in Hz per 10 ms frame, 0 where
    unvoiced).  The F0 is the corpus's exact contour from f0_plan.npz
    where it has one, else the autocorrelation tracker's
    (`quality.f0_track`) on the input, aligned to the model's frame
    centres."""

    def __init__(self, data_dir: str, name_filter=None):
        """name_filter: optional callable(name) -> bool selecting utterances
        by basename."""
        in_dir = os.path.join(data_dir, "inputs")
        tgt_dir = os.path.join(data_dir, "targets")
        if not os.path.isdir(in_dir):
            raise FileNotFoundError(f"{in_dir} not found")
        self.identity_mode = not os.path.isdir(tgt_dir)
        spk_path = os.path.join(data_dir, "speakers.json")
        spk_map = {}
        if os.path.exists(spk_path):
            with open(spk_path) as f:
                spk_map = json.load(f)
        plan_path = os.path.join(data_dir, "f0_plan.npz")
        f0_plan = dict(np.load(plan_path)) if os.path.exists(plan_path) else {}
        self.items = []  # (audio16, target24, speaker_id, f0_hz [frames])
        for fn in sorted(os.listdir(in_dir)):
            if not fn.lower().endswith(".wav"):
                continue
            name = os.path.splitext(fn)[0]
            if name_filter is not None and not name_filter(name):
                continue
            a, sr = read_wav(os.path.join(in_dir, fn))
            a16 = _to_rate(a, sr, IN_SAMPLE_RATE)
            if self.identity_mode:
                t24 = _to_rate(a, sr, OUT_SAMPLE_RATE)
            else:
                tp = os.path.join(tgt_dir, fn)
                if not os.path.exists(tp):
                    continue
                t, tsr = read_wav(tp)
                t24 = _to_rate(t, tsr, OUT_SAMPLE_RATE)
            n_frames = min(len(a16) // 160, len(t24) // 240)
            if n_frames < 2:
                continue
            a16 = a16[: n_frames * 160]
            if name in f0_plan:
                f0 = np.asarray(f0_plan[name], np.float32)
            else:
                from .quality import f0_track

                # 240 samples of pre-padding put the tracker's window i
                # (centre i*160+320) on model frame i's centre i*160+80
                f0, voiced = f0_track(np.pad(a16, (240, 0)), IN_SAMPLE_RATE)
                f0 = np.where(voiced, f0, 0.0).astype(np.float32)
            if len(f0) < n_frames:
                f0 = np.pad(f0, (0, n_frames - len(f0)), mode="edge")
            self.items.append((a16, t24[: n_frames * 240], int(spk_map.get(name, 0)),
                               f0[:n_frames]))
        if not self.items:
            raise ValueError(f"no usable wav pairs under {data_dir}")

    def n_frames_total(self) -> int:
        return sum(len(a) // 160 for a, *_ in self.items)


def make_pair_batcher(dataset: PairDataset, cfg, bank, *, batch: int, frames: int,
                      seed: int = 0, prefetch: int = 2, register_boost: float = 1.0,
                      device="cuda"):
    """Yield {audio16, target24, cond, f0_bin} batches of random aligned
    crops on `device` (`data.py:132`): the draws of the JAX package's
    batcher for the same seed.  Each example's cond row is its speaker's
    (speakers.json), with the raw speaker KV (`build_cond(raw_kv=True)`).

    register_boost: the sampling weight of a pair ramps from 1 to
    register_boost as its mean voiced F0 crosses 240 -> 320 Hz (1.0:
    uniform).  prefetch > 0 makes batches on a background thread into a
    queue of that depth."""
    from ..runtime.offline import ConversionSettings, build_cond

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    n16 = frames * 160
    usable = [i for i, (a, *_) in enumerate(dataset.items) if len(a) >= n16]
    if not usable:
        raise ValueError(f"no utterance has >= {frames} frames")
    if register_boost != 1.0:
        w = np.empty(len(usable), np.float64)
        for k, i in enumerate(usable):
            f0_hz = dataset.items[i][3]
            voiced = f0_hz[f0_hz > 0]
            mean_f0 = float(voiced.mean()) if len(voiced) else 0.0
            ramp = min(1.0, max(0.0, (mean_f0 - 240.0) / 80.0))
            w[k] = 1.0 + (register_boost - 1.0) * ramp
        p_usable = w / w.sum()
    else:
        p_usable = None

    # one cond row per speaker, made once; a batch gathers its rows
    bank = {k: v.float() for k, v in params_from_numpy(bank, dev).items()}
    n_speakers = bank["additive"].shape[0]
    rows = [build_cond(None, cfg, bank, ConversionSettings(target_speaker=s), 1, raw_kv=True)
            for s in range(n_speakers)]
    cond_table = {k: torch.cat([r[k] for r in rows]) for k in rows[0]}

    def make_batch():
        a_out = np.zeros((batch, frames * 160), np.float32)
        t_out = np.zeros((batch, frames * 240), np.float32)
        f0_out = np.zeros((batch, frames), np.float32)
        spk = np.zeros((batch,), np.int64)
        for b in range(batch):
            idx = (int(rng.choice(len(usable), p=p_usable))
                   if p_usable is not None else int(rng.integers(len(usable))))
            a, t, sid, f0_hz = dataset.items[usable[idx]]
            f_max = len(a) // 160 - frames
            f0 = int(rng.integers(f_max + 1))
            a_out[b] = a[f0 * 160: (f0 + frames) * 160]
            t_out[b] = t[f0 * 240: (f0 + frames) * 240]
            f0_out[b] = f0_hz[f0: f0 + frames]
            spk[b] = sid
        sel = torch.from_numpy(spk).to(dev)
        return {
            "audio16": torch.from_numpy(a_out).to(dev),
            "target24": torch.from_numpy(t_out).to(dev),
            "cond": {k: v[sel] for k, v in cond_table.items()},
            "f0_bin": torch.from_numpy(f0_to_bin(f0_out, cfg.pitch.pitch_bins)).to(dev),
        }

    if prefetch <= 0:
        while True:
            yield make_batch()

    q: "_queue.Queue" = _queue.Queue(maxsize=prefetch)
    stop = threading.Event()

    def worker():
        while not stop.is_set():
            try:
                q.put(make_batch(), timeout=1.0)
            except _queue.Full:
                continue

    th = threading.Thread(target=worker, daemon=True)
    th.start()
    try:
        while True:
            yield q.get()
    finally:
        stop.set()
