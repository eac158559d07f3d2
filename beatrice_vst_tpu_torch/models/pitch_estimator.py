"""PitchEstimator: streaming pitch tracker, 160 samples at 16 kHz per
frame -> one quantized pitch bin and 4 pitch features (port of
`beatrice_vst_tpu/models/pitch_estimator.py`).

A 1024-sample log-mel (fmax 4 kHz), four dilated causal blocks, and two
heads: bin logits (448 bins for 2.0.0-rc.0, 384 for the older versions),
masked to each stream's [min_q, max_q] before the argmax, and the 4
features.  `expected_bin` is the soft counterpart of the argmax: the
softmax expectation over the same masked logits.
"""

from __future__ import annotations

import dataclasses

import torch

from ..constants import VersionSpec
from ..device import resolve_device
from ..ops.frontend import MelFrontend
from ..parallel import collectives
from . import layers
from .io import params_from_numpy


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


def init(gen: torch.Generator, cfg: PitchEstimatorConfig, device="cuda"):
    """Random parameters with the JAX package's tree, shapes and
    distributions (`pitch_estimator.py:51`), drawn from `gen`."""
    params = {
        "prenet": layers.linear_init(gen, cfg.n_mels, cfg.hidden),
        "blocks": [layers.conv_block_init(gen, cfg.hidden, cfg.kernel)
                   for _ in cfg.dilations],
        "out_ln": layers.layer_norm_init(cfg.hidden),
        "logits": layers.linear_init(gen, cfg.hidden, cfg.pitch_bins),
        "features": layers.linear_init(gen, cfg.hidden, 4),
    }
    return params_from_numpy(params, device)


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


def _masked(logits, min_quantized_pitch, max_quantized_pitch):
    """The logits with the bins outside each stream's [min_q, max_q] at
    -inf."""
    bins = torch.arange(logits.shape[-1], device=logits.device)
    lo = min_quantized_pitch[:, None, None]
    hi = max_quantized_pitch[:, None, None]
    return torch.where((bins >= lo) & (bins <= hi), logits, float("-inf"))


def expected_bin(logits, min_quantized_pitch, max_quantized_pitch):
    """Softmax expectation of the bin over the masked logits -> [B, T] f32
    (`pitch_estimator.py:145`): the soft pitch, over the same bins the
    argmax may pick."""
    probs = torch.softmax(_masked(logits, min_quantized_pitch, max_quantized_pitch), dim=-1)
    bins = torch.arange(logits.shape[-1], device=logits.device, dtype=torch.float32)
    return (probs * bins).sum(dim=-1)


def _logits(params, h, compute_dtype=None):
    """The bin logits [B, T, bins] f32.  With the head split over 'model'
    (column-parallel, `parallel/mesh.py`) each rank computes its block of
    bins and the blocks are gathered before the argmax reads them."""
    w = params["w"]
    if not collectives.is_sharded(w):
        return layers.linear(params, h, compute_dtype, out_dtype=torch.float32)
    group = collectives.model_group(w)
    h = collectives.copy_to_model(h, group)
    block = layers.linear({"w": collectives.local(w), "b": collectives.local(params["b"])}, h,
                          compute_dtype, out_dtype=torch.float32)
    return collectives.gather_from_model(block, group)


def apply(params, cfg: PitchEstimatorConfig, audio, state,
          min_quantized_pitch, max_quantized_pitch, compute_dtype=None,
          with_logits: bool = False):
    """audio: [B, T*160] -> (quantized_pitch [B, T] int64, features
    [B, T, 4] f32, new_state), and with_logits the bin logits [B, T, bins]
    f32 last (`pitch_estimator.py:81`).

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
    logits = _logits(params["logits"], h, compute_dtype)
    features = layers.linear(params["features"], h, compute_dtype, out_dtype=f32)
    qp = torch.argmax(_masked(logits, min_quantized_pitch, max_quantized_pitch), dim=-1)
    new_state = {"audio": new_audio, "blocks": new_blocks}
    if with_logits:
        return qp, features, new_state, logits
    return qp, features, new_state
