"""PhoneExtractor: streaming content encoder, 160 samples at 16 kHz per
frame -> phone vector (port of `beatrice_vst_tpu/models/phone_extractor.py`).

Log-mel front end, a prenet, six dilated causal ConvNeXt blocks and an
output projection; then the 2.0.0-rc.0 k-NN smoothing against the
stream's own VQ codebook (`vq_knn_smooth`).
"""

from __future__ import annotations

import dataclasses

import torch

from ..constants import VersionSpec
from ..ops.frontend import MelFrontend
from . import layers


@dataclasses.dataclass(frozen=True)
class PhoneExtractorConfig:
    n_mels: int = 80
    win: int = 512
    hidden: int = 256
    kernel: int = 4
    dilations: tuple = (1, 2, 4, 8, 1, 2)

    @classmethod
    def for_version(cls, spec: VersionSpec) -> "PhoneExtractorConfig":
        return cls()

    @property
    def frontend(self) -> MelFrontend:
        return MelFrontend(win=self.win, n_mels=self.n_mels)


def init_state(cfg: PhoneExtractorConfig, batch_shape=(), device="cpu"):
    """Zero streaming state: raw-audio history and per-block conv windows."""
    return {
        "audio": torch.zeros((*batch_shape, cfg.frontend.history), device=device),
        "blocks": [
            torch.zeros((*batch_shape, (cfg.kernel - 1) * d, cfg.hidden), device=device)
            for d in cfg.dilations
        ],
    }


def apply(params, cfg: PhoneExtractorConfig, audio, state):
    """audio: [B, T*160] -> (phone [B, T, phone_channels], new_state)
    (`phone_extractor.py:82`)."""
    fe = cfg.frontend
    windows, new_audio = fe.frames_from_chunk(state["audio"], audio)
    h = layers.linear(params["prenet"], fe(windows))
    new_blocks = []
    for p, s, d in zip(params["blocks"], state["blocks"], cfg.dilations):
        h, ns = layers.conv_block(p, h, s, d)
        new_blocks.append(ns)
    h = layers.layer_norm(params["out_ln"], h)
    phone = layers.linear(params["out"], h)
    return phone, {"audio": new_audio, "blocks": new_blocks}


def vq_knn_smooth(phone, codebook, num_neighbors, max_neighbors: int = 8):
    """k-NN phone smoothing against a per-stream codebook
    (`phone_extractor.py:121`).

    phone: [B, T, C]; codebook: [B, K, C]; num_neighbors: [B] int in
    [0, max_neighbors], 0 = passthrough.  Each phone vector becomes the
    mean of its n nearest codebook entries (squared L2 distance; the
    query's own norm is constant per row and omitted).
    """
    c2 = (codebook * codebook).sum(dim=-1)  # [B, K]
    pc = torch.matmul(phone, codebook.transpose(-1, -2))  # [B, T, K]
    dist = c2[:, None, :] - 2.0 * pc
    nearest = torch.topk(-dist, max_neighbors, dim=-1, sorted=True).indices
    n = num_neighbors.to(torch.int64)[:, None, None]  # [B, 1, 1]
    take = (torch.arange(max_neighbors, device=phone.device) < n).to(phone.dtype)
    batch = torch.arange(phone.shape[0], device=phone.device)[:, None, None]
    rows = codebook[batch, nearest]  # [B, T, max_neighbors, C]
    smoothed = (rows * take[..., None]).sum(dim=2) / torch.clamp(n, min=1).to(phone.dtype)
    return torch.where(n > 0, smoothed, phone)
