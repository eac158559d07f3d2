"""Offline (whole-utterance) conversion (port of
`beatrice_vst_tpu/runtime/offline.py`).

The same chain as the real-time engine, over a whole utterance: the input
is resampled to 16 kHz, runs through the chain as one chunk of T frames
(or in chunks of `chunk_frames` with the state carried between them), and
the 24 kHz output is resampled to the output rate.  Any input and output
rate whose ratio to the model's rates has terms below 1000 works (a
44.1 kHz input has the ratio 160/441).

Morphing is not ported yet: `ConversionSettings.morph_weights` raises, as
a morph-mode target does in the engine.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..constants import IN_HOP_LENGTH, OUT_HOP_LENGTH
from ..device import resolve_device
from ..errors import BeatriceError, ErrorCode
from ..models import chain, waveform_generator
from ..models.chain import VoiceConverterConfig
from ..models.io import params_from_numpy
from ..ops.resample import make_resampler, rational_rate_ratio
from ..speakers import morpher


@dataclasses.dataclass
class ConversionSettings:
    """Per-utterance settings (the reference's Set* parameters as data)."""

    target_speaker: int = 0
    formant_shift: float = 0.0
    pitch_shift: float = 0.0
    average_source_pitch: float = 52.0
    intonation_intensity: float = 1.0
    pitch_correction: float = 0.0
    pitch_correction_type: int = 0
    min_source_pitch: float = 33.125
    max_source_pitch: float = 80.875
    vq_num_neighbors: int = 0
    morph_weights: np.ndarray | None = None  # morph mode: not ported yet, raises
    # condition the vocoder on the expected pitch bin instead of the argmax
    soft_pitch: bool = False


def build_cond(params, cfg: VoiceConverterConfig, bank, settings: ConversionSettings,
               batch: int = 1, compute_dtype=None):
    """The chain's cond dict for `settings` (`offline.py:45`), on the
    bank's device.  Where the JAX package hands the chain the raw speaker
    KV, the port hands it the projected per-stream K/V cache (the same
    products, taken once)."""
    if settings.morph_weights is not None:
        raise BeatriceError(ErrorCode.SPEAKER_ID_OUT_OF_RANGE,
                            "morph_weights: morph mode is not ported yet")
    spec = cfg.spec
    n = bank["additive"].shape[0]
    if not 0 <= settings.target_speaker < n:
        raise BeatriceError(ErrorCode.SPEAKER_ID_OUT_OF_RANGE,
                            f"target_speaker {settings.target_speaker} outside [0, {n})")
    dev = bank["additive"].device

    def full(value, dtype):
        return torch.full((batch,), value, dtype=dtype, device=dev)

    formant = int(round(np.clip(settings.formant_shift, -2, 2) * 2 + 4))
    additive, cb_idx = morpher.select_conditioning(
        bank, full(settings.target_speaker, torch.int64), full(formant, torch.int64))

    def q(midi):
        return int(np.clip(round((np.clip(midi, 0, 128) - 33.0) * 8.0), 1, spec.pitch_bins - 1))

    f32 = torch.float32
    cond = {
        "speaker_embedding": additive,
        "vq_num_neighbors": full(settings.vq_num_neighbors, torch.int64),
        "min_q": full(q(settings.min_source_pitch), torch.int64),
        "max_q": full(q(settings.max_source_pitch), torch.int64),
        "average_source_pitch": full(settings.average_source_pitch, f32),
        "intonation_intensity": full(settings.intonation_intensity, f32),
        "pitch_shift": full(float(np.clip(settings.pitch_shift, -24, 24)), f32),
        "pitch_correction": full(float(np.clip(settings.pitch_correction, 0, 1)), f32),
        "pitch_correction_type": full(settings.pitch_correction_type, torch.int64),
    }
    speaker = full(settings.target_speaker, torch.int64)
    if spec.has_kv:
        cond["kv_cache"] = waveform_generator.project_kv(params["wg"], bank["kv"][speaker],
                                                         compute_dtype)
    if spec.has_vq:
        cond["codebook"] = bank["codebook"][cb_idx]
    return cond


def convert_utterance(params, cfg: VoiceConverterConfig, bank, audio, sample_rate: float,
                      settings: ConversionSettings = None, out_sample_rate: float = None,
                      compute_dtype=None, chunk_frames: int = None, device="cuda"):
    """Convert one utterance [n] or a batch [B, n] at `sample_rate`
    (`offline.py:131`).  Returns numpy f32 audio at `out_sample_rate`
    (default: the input rate).

    params and bank: the JAX package's trees or the port's (numpy arrays
    or tensors), moved to `device`.  compute_dtype: None (f32) or
    torch.bfloat16.  chunk_frames > 0 runs the chain in chunks of that
    many frames with the state carried between them (bounded memory);
    0 runs the utterance as one chunk; None (auto) chunks at 256 frames
    beyond 384 frames.
    """
    if chunk_frames is None:
        chunk_frames = 256 if audio_longer_than(audio, sample_rate, 384) else 0
    settings = settings or ConversionSettings()
    out_sample_rate = out_sample_rate or sample_rate
    dev = resolve_device(device)
    params = params_from_numpy(params, dev)
    bank = {k: v.float() for k, v in params_from_numpy(bank, dev).items()}
    x = torch.as_tensor(audio, dtype=torch.float32, device=dev)
    squeeze = x.dim() == 1
    if squeeze:
        x = x[None]
    b = x.shape[0]

    if sample_rate != 16000:
        x = make_resampler(sample_rate, 16000, _block_for(sample_rate, 16000)).apply_offline(x)
    t = -(-x.shape[-1] // IN_HOP_LENGTH)
    x = torch.nn.functional.pad(x, (0, t * IN_HOP_LENGTH - x.shape[-1]))

    cond = build_cond(params, cfg, bank, settings, b, compute_dtype)
    state = chain.init_state(cfg, (b,), dev)
    if chunk_frames and chunk_frames < t:
        x = torch.nn.functional.pad(x, (0, ((-t) % chunk_frames) * IN_HOP_LENGTH))
        parts = []
        for seg in torch.split(x, chunk_frames * IN_HOP_LENGTH, dim=-1):
            y_seg, state = chain.apply(params, cfg, seg, state, cond, compute_dtype,
                                       soft_pitch=settings.soft_pitch)
            parts.append(y_seg)
        y = torch.cat(parts, dim=-1)[:, :t * OUT_HOP_LENGTH]
    else:
        y, _ = chain.apply(params, cfg, x, state, cond, compute_dtype,
                           soft_pitch=settings.soft_pitch)

    if out_sample_rate != 24000:
        y = make_resampler(24000, out_sample_rate,
                           _block_for(24000, out_sample_rate)).apply_offline(y)
    y = y.float().cpu().numpy()
    return y[0] if squeeze else y


def audio_longer_than(audio, sample_rate: float, frames: int) -> bool:
    """Whether the audio lasts longer than `frames` 10 ms frames."""
    return np.shape(audio)[-1] / sample_rate > frames * 0.010


def _block_for(rate_in: float, rate_out: float) -> int:
    """The offline resampler's block: a multiple of the ratio's M near
    4096 samples (`offline.py:196`)."""
    _, m = rational_rate_ratio(rate_in, rate_out)
    return m * max(1, 4096 // m)
