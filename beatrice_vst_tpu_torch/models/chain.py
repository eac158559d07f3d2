"""VoiceConverter: the per-frame stage chain PhoneExtractor -> VQ k-NN
smoothing -> PitchEstimator -> pitch transform -> WaveformGenerator (port
of `beatrice_vst_tpu/models/chain.py`, argmax mode, T = 1).

Per-stream conditioning arrives as a `cond` dict:

  speaker_embedding [B, 256]        additive speaker + formant embedding
  vq_num_neighbors  [B] int         0 = no smoothing
  min_q / max_q     [B] int         pitch bin clamps
  average_source_pitch, intonation_intensity, pitch_shift,
  pitch_correction  [B] float; pitch_correction_type [B] int

with one of each pair of routes:

  kv_cache          {"k","v"(,"k_scale","v_scale")}: [B, n_blocks, 384, A(|1)]
                    the per-stream projected speaker KV, or
  kv_bank, kv_slot  the shared slot bank [Z, n_blocks, 384, A(|1)] and
                    each stream's slot [B]
  codebook(, codebook_scale)  [B, 512, 128] the stream's VQ codebook, or
  codebook_bank, codebook_idx(, codebook_bank_scale)  the model's bank
                    [S, 512, 128] and each stream's speaker [B]
"""

from __future__ import annotations

import dataclasses

from ..constants import V20RC0, VersionSpec
from ..device import resolve_device
from ..ops.pitch_math import transform_pitch
from . import phone_extractor, pitch_estimator, waveform_generator


@dataclasses.dataclass(frozen=True)
class VoiceConverterConfig:
    spec: VersionSpec
    phone: phone_extractor.PhoneExtractorConfig = None
    pitch: pitch_estimator.PitchEstimatorConfig = None
    wg: waveform_generator.WaveformGeneratorConfig = None

    def __post_init__(self):
        if self.phone is None:
            object.__setattr__(self, "phone", phone_extractor.PhoneExtractorConfig.for_version(self.spec))
        if self.pitch is None:
            object.__setattr__(self, "pitch", pitch_estimator.PitchEstimatorConfig.for_version(self.spec))
        if self.wg is None:
            object.__setattr__(self, "wg", waveform_generator.WaveformGeneratorConfig.for_version(self.spec))

    @classmethod
    def for_version(cls, spec: VersionSpec = V20RC0) -> "VoiceConverterConfig":
        return cls(spec=spec)


def init_state(cfg: VoiceConverterConfig, batch_shape=(), device="cuda"):
    device = resolve_device(device)
    return {
        "phone": phone_extractor.init_state(cfg.phone, batch_shape, device),
        "pitch": pitch_estimator.init_state(cfg.pitch, batch_shape, device),
        "wg": waveform_generator.init_state(cfg.wg, batch_shape, device),
    }


def apply(params, cfg: VoiceConverterConfig, audio16, state, cond, compute_dtype=None):
    """audio16: [B, 160] at 16 kHz -> (audio24 [B, 240] at 24 kHz, state)
    (`chain.py:128`)."""
    spec = cfg.spec
    phone, phone_state = phone_extractor.apply(params["phone"], cfg.phone, audio16,
                                               state["phone"], compute_dtype)
    if "codebook_bank" in cond:
        phone = phone_extractor.vq_knn_smooth_shared(
            phone, cond["codebook_bank"], cond["codebook_idx"], cond["vq_num_neighbors"],
            codebook_scale=cond.get("codebook_bank_scale"))
    else:
        phone = phone_extractor.vq_knn_smooth(
            phone, cond["codebook"], cond["vq_num_neighbors"],
            codebook_scale=cond.get("codebook_scale"))
    qp_raw, pitch_feats, pitch_state = pitch_estimator.apply(
        params["pitch"], cfg.pitch, audio16, state["pitch"], cond["min_q"],
        cond["max_q"], compute_dtype)
    qp = transform_pitch(
        qp_raw,
        average_source_pitch=cond["average_source_pitch"][:, None],
        intonation_intensity=cond["intonation_intensity"][:, None],
        pitch_shift=cond["pitch_shift"][:, None],
        pitch_correction=cond["pitch_correction"][:, None],
        pitch_correction_type=cond["pitch_correction_type"][:, None],
        pitch_bins=spec.pitch_bins,
    )
    audio24, wg_state = waveform_generator.apply(
        params["wg"], cfg.wg, phone, qp, pitch_feats, cond["speaker_embedding"],
        state["wg"], cond.get("kv_cache"), compute_dtype,
        kv_bank=cond.get("kv_bank"), kv_slot=cond.get("kv_slot"))
    return audio24, {"phone": phone_state, "pitch": pitch_state, "wg": wg_state}
