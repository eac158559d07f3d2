"""Streaming-vs-chunk parity through the whole engine tick (port of
`beatrice_vst_tpu/parity.py`).

`run_parity` runs the same 48 kHz audio through
  (a) one tick of the whole utterance (frames_per_tick = T), and
  (b) T real-time ticks of one frame each, through carried state,
and reports the largest deviation.  A fault anywhere in the carried state
(resampler histories, conv carries, source phase, noise index, gain ramp)
shows here.  On the card the streaming half runs the upsampler kernel
and the chunk tick the stage loop, so the gate also holds the two heads
against each other.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from .constants import COMMON_HOP_LENGTH, V20RC0
from .device import resolve_device
from .errors import BeatriceError, ErrorCode
from .models import chain
from .models.io import params_from_numpy
from .runtime.engine import (EngineConfig, cast_params, engine_tick, init_engine_state,
                             prepare_bank, refresh_kv_cache)
from .speakers import bank as bank_mod


@dataclasses.dataclass
class ParityReport:
    max_abs_diff: float
    rms_diff: float
    tolerance: float
    n_frames: int
    passed: bool

    def __str__(self):
        status = "PASS" if self.passed else "FAIL"
        return (f"parity {status}: max|d|={self.max_abs_diff:.2e} "
                f"rms={self.rms_diff:.2e} tol={self.tolerance} over {self.n_frames} frames")


def parity_audio(n_frames: int, batch: int, seed: int = 0) -> np.ndarray:
    """The default input: a 220 Hz tone plus noise from a numpy seed at
    48 kHz, the same for every stream, [batch, n_frames * 480] f32."""
    rng = np.random.default_rng(seed)
    t = np.arange(n_frames * COMMON_HOP_LENGTH) / 48000.0
    tone = 0.3 * np.sin(2 * np.pi * 220.0 * t)
    return np.tile((tone + 0.05 * rng.standard_normal(len(t))).astype(np.float32),
                   (batch, 1))


def run_parity(params=None, model_cfg=None, bank=None, audio48=None, spec=V20RC0,
               n_frames: int = 25, batch: int = 2, tolerance: float = 1e-3, seed: int = 0,
               controls: dict | None = None, device="cuda", engine_kw: dict | None = None,
               timer=None) -> ParityReport:
    """Streaming-vs-chunk parity through the whole engine tick
    (`parity.py:57`).

    params and bank default to random ones from `chain.init` and
    `random_bank` (CPU generators seeded with `seed` and `seed + 1`);
    audio48 [B, T*480] defaults to `parity_audio`.  controls {field:
    value} are set on every stream (the target speaker must be one of the
    bank's: morph mode is not ported).  engine_kw: more `EngineConfig`
    fields for both engines (the JAX harness uses the default
    configuration, slots f32).  timer(name), if given, returns a context
    manager entered around the chunk tick ("chunk") and around the
    streaming ticks ("stream").
    """
    dev = resolve_device(device)
    if model_cfg is None:
        model_cfg = chain.VoiceConverterConfig.for_version(spec)
    if params is None:
        params = chain.init(torch.Generator().manual_seed(seed), model_cfg, dev)
    if bank is None:
        bank = bank_mod.random_bank(torch.Generator().manual_seed(seed + 1), model_cfg.spec,
                                    4, device=dev)
    if audio48 is None:
        audio48 = parity_audio(n_frames, batch, seed)
    audio48 = torch.as_tensor(audio48, dtype=torch.float32, device=dev)
    b = audio48.shape[0]
    n_frames = audio48.shape[1] // COMMON_HOP_LENGTH
    params = params_from_numpy(params, dev)
    n_spk = bank_mod.n_speakers(bank)
    target = (controls or {}).get("target_speaker", 0)
    if not 0 <= int(target) < n_spk:
        raise BeatriceError(ErrorCode.SPEAKER_ID_OUT_OF_RANGE,
                            f"target_speaker {target} outside [0, {n_spk}); "
                            "morph mode is not ported yet")
    timer = timer or (lambda name: contextlib.nullcontext())

    def setup(frames_per_tick):
        cfg = EngineConfig(capacity=b, model=model_cfg, frames_per_tick=frames_per_tick,
                           **(engine_kw or {}))
        p = cast_params(params, cfg.dtype)
        bk = prepare_bank(cfg, p, bank, dev)
        state = init_engine_state(cfg, dev)
        state["controls"]["active"][:] = True
        for field, value in (controls or {}).items():
            state["controls"][field][:] = value
        if "kv_cache" in state:  # prime the per-stream K/V of direct speakers
            refresh_kv_cache(p, bk, state, torch.arange(b, device=dev), cfg.dtype)
        return cfg, p, bk, state

    cfg, p, bk, state = setup(n_frames)
    with timer("chunk"):
        out_chunk, _ = engine_tick(p, bk, state, audio48, cfg=cfg)

    cfg, p, bk, state = setup(1)
    outs = []
    with timer("stream"):
        for f in range(n_frames):
            o, state = engine_tick(
                p, bk, state, audio48[:, f * COMMON_HOP_LENGTH:(f + 1) * COMMON_HOP_LENGTH],
                cfg=cfg)
            outs.append(o)
    out_stream = torch.cat(outs, dim=1)

    diff = (out_stream.double() - out_chunk.double()).abs()
    max_d = float(diff.max())
    return ParityReport(max_abs_diff=max_d, rms_diff=float(torch.sqrt((diff * diff).mean())),
                        tolerance=tolerance, n_frames=n_frames, passed=max_d <= tolerance)
