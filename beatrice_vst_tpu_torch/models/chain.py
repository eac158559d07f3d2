"""VoiceConverter: the stage chain PhoneExtractor -> VQ k-NN smoothing ->
PitchEstimator -> pitch transform -> WaveformGenerator over a chunk of T
frames (port of `beatrice_vst_tpu/models/chain.py`), for 2.0.0-rc.0 and
the older 2.0.0-alpha.2 and 2.0.0-beta.1 (no VQ, no attention).  The
pitch is the argmax bin, or with soft_pitch its softmax expectation,
transformed without rounding.

Per-stream conditioning arrives as a `cond` dict:

  speaker_embedding [B, 256]        additive speaker + formant embedding
  vq_num_neighbors  [B] int         0 = no smoothing
  min_q / max_q     [B] int         pitch bin clamps
  average_source_pitch, intonation_intensity, pitch_shift,
  pitch_correction  [B] float; pitch_correction_type [B] int

and, for 2.0.0-rc.0, one of each group of routes:

  kv_cache          {"k","v"(,"k_scale","v_scale")}: [B, n_blocks, 384, A(|1)]
                    the per-stream projected speaker KV, or
  kv_bank, kv_slot  the shared slot bank [Z, n_blocks, 384, A(|1)] and
                    each stream's slot [B], or
  kv                [B, 384, 128] the raw speaker KV, projected in every
                    call (the JAX package's training cond: the gradient
                    reaches the K/V projections)
  codebook(, codebook_scale)  [B, 512, 128] the stream's VQ codebook, or
  codebook_bank, codebook_idx(, codebook_bank_scale)  the model's bank
                    [S, 512, 128] and each stream's speaker [B] (read
                    through one-hot contractions at T = 1; at T > 1 each
                    stream's codebook is gathered)
"""

from __future__ import annotations

import dataclasses

import torch

from ..constants import V20RC0, VersionSpec
from ..device import mark, resolve_device
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


def init(gen: torch.Generator, cfg: VoiceConverterConfig, device="cuda"):
    """Random parameters with the JAX package's tree, shapes, dtypes and
    per-leaf distributions (`chain.py:57`), drawn from `gen` (a CPU
    generator: one seed gives the same values on any device)."""
    return {
        "phone": phone_extractor.init(gen, cfg.phone, device),
        "pitch": pitch_estimator.init(gen, cfg.pitch, device),
        "wg": waveform_generator.init(gen, cfg.wg, device),
    }


def _smooth_phone(phone, cond, int8_query: bool = False):
    """2.0.0-rc.0's VQ k-NN smoothing by the cond's codebook route
    (`chain.py:183-203`)."""
    if "codebook_bank" not in cond:
        return phone_extractor.vq_knn_smooth(
            phone, cond["codebook"], cond["vq_num_neighbors"],
            codebook_scale=cond.get("codebook_scale"))
    if phone.shape[1] == 1:
        return phone_extractor.vq_knn_smooth_shared(
            phone, cond["codebook_bank"], cond["codebook_idx"], cond["vq_num_neighbors"],
            codebook_scale=cond.get("codebook_bank_scale"), int8_query=int8_query)
    idx = cond["codebook_idx"]
    scale = cond.get("codebook_bank_scale")
    return phone_extractor.vq_knn_smooth(
        phone, cond["codebook_bank"][idx], cond["vq_num_neighbors"],
        codebook_scale=None if scale is None else scale[idx])


def init_state(cfg: VoiceConverterConfig, batch_shape=(), device="cuda"):
    device = resolve_device(device)
    return {
        "phone": phone_extractor.init_state(cfg.phone, batch_shape, device),
        "pitch": pitch_estimator.init_state(cfg.pitch, batch_shape, device),
        "wg": waveform_generator.init_state(cfg.wg, batch_shape, device),
    }


def apply(params, cfg: VoiceConverterConfig, audio16, state, cond, compute_dtype=None,
          soft_pitch: bool = False, vq_int8_query: bool = False, with_taps: bool = False):
    """audio16: [B, T*160] at 16 kHz -> (audio24 [B, T*240] at 24 kHz,
    state) (`chain.py:128`).  soft_pitch conditions the vocoder on the
    expected bin over the masked pitch logits (`chain.py:207-237`).
    vq_int8_query quantizes the query of the shared int8 codebook bank's
    distances at T = 1 (`vq_knn_smooth_shared`).  with_taps also returns
    the stage boundaries (`chain.py:242-246`), the supervision points of
    the training losses: (audio24, state, {"phone" (after the VQ),
    "qp_raw", "qp", "pitch_feats", "pitch_logits"}).  Marks the stages
    phone, vq and pitch (`device.mark`)."""
    spec = cfg.spec
    mark("phone")
    phone, phone_state = phone_extractor.apply(params["phone"], cfg.phone, audio16,
                                               state["phone"], compute_dtype)
    if spec.has_vq:
        mark("vq")
        phone = _smooth_phone(phone, cond, vq_int8_query)
    mark("pitch")
    pe_out = pitch_estimator.apply(
        params["pitch"], cfg.pitch, audio16, state["pitch"], cond["min_q"],
        cond["max_q"], compute_dtype, with_logits=soft_pitch or with_taps)
    qp_raw, pitch_feats, pitch_state = pe_out[:3]
    pitch_logits = pe_out[3] if len(pe_out) > 3 else None
    if soft_pitch:
        qp_raw = pitch_estimator.expected_bin(pitch_logits, cond["min_q"], cond["max_q"])
    qp = transform_pitch(
        qp_raw,
        average_source_pitch=cond["average_source_pitch"][:, None],
        intonation_intensity=cond["intonation_intensity"][:, None],
        pitch_shift=cond["pitch_shift"][:, None],
        pitch_correction=cond["pitch_correction"][:, None],
        pitch_correction_type=cond["pitch_correction_type"][:, None],
        pitch_bins=spec.pitch_bins,
        round_output=not soft_pitch,
    )
    audio24, wg_state = waveform_generator.apply(
        params["wg"], cfg.wg, phone, qp, pitch_feats, cond["speaker_embedding"],
        state["wg"], cond.get("kv_cache"), compute_dtype,
        kv_bank=cond.get("kv_bank"), kv_slot=cond.get("kv_slot"), soft_pitch=soft_pitch,
        kv_embedding=cond.get("kv"))
    new_state = {"phone": phone_state, "pitch": pitch_state, "wg": wg_state}
    if with_taps:
        return audio24, new_state, {"phone": phone, "qp_raw": qp_raw, "qp": qp,
                                    "pitch_feats": pitch_feats, "pitch_logits": pitch_logits}
    return audio24, new_state
