"""PitchEstimator: streaming pitch tracker, 160 samples at 16 kHz per
frame -> one quantized pitch bin and 4 pitch features (port of
`beatrice_vst_tpu/models/pitch_estimator.py`).

A 1024-sample log-mel (fmax 4 kHz), four dilated causal blocks, and two
heads: bin logits, masked to each stream's [min_q, max_q] before the
argmax, and the 4 features.
"""

from __future__ import annotations

import dataclasses

import torch

from ..constants import VersionSpec
from ..device import resolve_device
from ..ops.frontend import MelFrontend
from . import layers


@dataclasses.dataclass(frozen=True)
class PitchEstimatorConfig:
    pitch_bins: int
    n_mels: int = 128
    win: int = 1024
    hidden: int = 256
    kernel: int = 4
    dilations: tuple = (1, 2, 4, 1)

    @classmethod
    def for_version(cls, spec: VersionSpec) -> "PitchEstimatorConfig":
        return cls(pitch_bins=spec.pitch_bins)

    @property
    def frontend(self) -> MelFrontend:
        return MelFrontend(win=self.win, n_mels=self.n_mels, fmax=4000.0)


def init_state(cfg: PitchEstimatorConfig, batch_shape=(), device="cuda"):
    """Zero streaming state: raw-audio history and per-block conv windows."""
    device = resolve_device(device)
    return {
        "audio": torch.zeros((*batch_shape, cfg.frontend.history), device=device),
        "blocks": [
            torch.zeros((*batch_shape, (cfg.kernel - 1) * d, cfg.hidden), device=device)
            for d in cfg.dilations
        ],
    }


def apply(params, cfg: PitchEstimatorConfig, audio, state,
          min_quantized_pitch, max_quantized_pitch, compute_dtype=None):
    """audio: [B, T*160] -> (quantized_pitch [B, T] int64, features
    [B, T, 4] f32, new_state) (`pitch_estimator.py:81`).

    min/max_quantized_pitch: [B] int, the inclusive bin range the argmax
    may pick from.  With compute_dtype the trunk computes in it; the bin
    logits and the features are emitted in f32, so that the argmax does
    not compare logits rounded to bf16 (`pitch_estimator.py:108-120`).
    """
    fe = cfg.frontend
    windows, new_audio = fe.frames_from_chunk(state["audio"], audio)
    h = layers.linear(params["prenet"], fe(windows), compute_dtype)
    new_blocks = []
    for p, s, d in zip(params["blocks"], state["blocks"], cfg.dilations):
        h, ns = layers.conv_block(p, h, s, d, compute_dtype)
        new_blocks.append(ns)
    h = layers.layer_norm(params["out_ln"], h)
    f32 = torch.float32
    logits = layers.linear(params["logits"], h, compute_dtype, out_dtype=f32)
    features = layers.linear(params["features"], h, compute_dtype, out_dtype=f32)
    bins = torch.arange(cfg.pitch_bins, device=logits.device)
    lo = min_quantized_pitch[:, None, None]
    hi = max_quantized_pitch[:, None, None]
    masked = torch.where((bins >= lo) & (bins <= hi), logits, float("-inf"))
    qp = torch.argmax(masked, dim=-1)
    return qp, features, {"audio": new_audio, "blocks": new_blocks}
