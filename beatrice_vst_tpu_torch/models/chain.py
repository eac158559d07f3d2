"""VoiceConverter: the per-frame stage chain PhoneExtractor -> VQ k-NN
smoothing -> PitchEstimator -> pitch transform -> WaveformGenerator (port
of `beatrice_vst_tpu/models/chain.py`, argmax mode, per-stream codebook
and precomputed speaker K/V).

Per-stream conditioning arrives as a `cond` dict:

  speaker_embedding [B, 256]        additive speaker + formant embedding
  kv_cache          {"k","v": [B, n_blocks, 384, A]}  projected speaker KV
  codebook          [B, 512, 128]   the stream's VQ codebook
  vq_num_neighbors  [B] int         0 = no smoothing
  min_q / max_q     [B] int         pitch bin clamps
  average_source_pitch, intonation_intensity, pitch_shift,
  pitch_correction  [B] float; pitch_correction_type [B] int
"""

from __future__ import annotations

import dataclasses

from ..constants import V20RC0, VersionSpec
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


def init_state(cfg: VoiceConverterConfig, batch_shape=(), device="cpu"):
    return {
        "phone": phone_extractor.init_state(cfg.phone, batch_shape, device),
        "pitch": pitch_estimator.init_state(cfg.pitch, batch_shape, device),
        "wg": waveform_generator.init_state(cfg.wg, batch_shape, device),
    }


def apply(params, cfg: VoiceConverterConfig, audio16, state, cond):
    """audio16: [B, 160] at 16 kHz -> (audio24 [B, 240] at 24 kHz, state)
    (`chain.py:128`)."""
    spec = cfg.spec
    phone, phone_state = phone_extractor.apply(params["phone"], cfg.phone, audio16,
                                               state["phone"])
    phone = phone_extractor.vq_knn_smooth(phone, cond["codebook"],
                                          cond["vq_num_neighbors"])
    qp_raw, pitch_feats, pitch_state = pitch_estimator.apply(
        params["pitch"], cfg.pitch, audio16, state["pitch"], cond["min_q"],
        cond["max_q"])
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
        state["wg"], cond["kv_cache"])
    return audio24, {"phone": phone_state, "pitch": pitch_state, "wg": wg_state}
