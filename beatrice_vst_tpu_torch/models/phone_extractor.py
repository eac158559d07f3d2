"""PhoneExtractor: streaming content encoder, 160 samples at 16 kHz per
frame -> phone vector (port of `beatrice_vst_tpu/models/phone_extractor.py`).

Log-mel front end, a prenet, six dilated causal ConvNeXt blocks and an
output projection to the version's phone channels (128 for 2.0.0-rc.0,
256 for the older versions); then the 2.0.0-rc.0 k-NN smoothing against the
stream's VQ codebook: a per-stream codebook (`vq_knn_smooth`) or the
model's shared bank read through one-hot contractions
(`vq_knn_smooth_shared`), each f32, bf16 or int8 with per-row scales.
"""

from __future__ import annotations

import dataclasses

import torch

from ..constants import VersionSpec
from ..device import resolve_device
from ..ops.frontend import MelFrontend
from . import layers
from .io import params_from_numpy

MAX_NEIGHBORS = 8


@dataclasses.dataclass(frozen=True)
class PhoneExtractorConfig:
    phone_channels: int = 128
    n_mels: int = 80
    win: int = 512
    hidden: int = 256
    kernel: int = 4
    dilations: tuple = (1, 2, 4, 8, 1, 2)

    @classmethod
    def for_version(cls, spec: VersionSpec) -> "PhoneExtractorConfig":
        return cls(phone_channels=spec.phone_channels)

    @property
    def frontend(self) -> MelFrontend:
        return MelFrontend(win=self.win, n_mels=self.n_mels)


def init(gen: torch.Generator, cfg: PhoneExtractorConfig, device="cuda"):
    """Random parameters with the JAX package's tree, shapes and
    distributions (`phone_extractor.py:53`), drawn from `gen`."""
    params = {
        "prenet": layers.linear_init(gen, cfg.n_mels, cfg.hidden),
        "blocks": [layers.conv_block_init(gen, cfg.hidden, cfg.kernel)
                   for _ in cfg.dilations],
        "out_ln": layers.layer_norm_init(cfg.hidden),
        "out": layers.linear_init(gen, cfg.hidden, cfg.phone_channels),
    }
    return params_from_numpy(params, device)


def init_state(cfg: PhoneExtractorConfig, batch_shape=(), device="cuda"):
    """Zero streaming state: raw-audio history and per-block conv windows."""
    device = resolve_device(device)
    return {
        "audio": torch.zeros((*batch_shape, cfg.frontend.history), device=device),
        "blocks": [
            torch.zeros((*batch_shape, (cfg.kernel - 1) * d, cfg.hidden), device=device)
            for d in cfg.dilations
        ],
    }


def apply(params, cfg: PhoneExtractorConfig, audio, state, compute_dtype=None):
    """audio: [B, T*160] -> (phone [B, T, phone_channels] in compute_dtype
    or f32, new_state) (`phone_extractor.py:82`)."""
    fe = cfg.frontend
    windows, new_audio = fe.frames_from_chunk(state["audio"], audio)
    h = layers.linear(params["prenet"], fe(windows), compute_dtype)
    new_blocks = []
    for p, s, d in zip(params["blocks"], state["blocks"], cfg.dilations):
        h, ns = layers.conv_block(p, h, s, d, compute_dtype)
        new_blocks.append(ns)
    h = layers.layer_norm(params["out_ln"], h)
    phone = layers.linear(params["out"], h, compute_dtype)
    return phone, {"audio": new_audio, "blocks": new_blocks}


def _operands(phone, codebook):
    """(codebook, query) in the dtype the distances are taken in: an int8
    codebook is read as bf16 (exact), the query in the codebook's dtype
    (`phone_extractor.py:137-142`)."""
    if codebook.dtype == torch.int8:
        return codebook.to(torch.bfloat16), phone.to(torch.bfloat16)
    return codebook, phone.to(codebook.dtype)


def _nearest(dist, num_neighbors, max_neighbors):
    """[..., K] distances -> [..., K] 0/1 weights of each row's n nearest
    entries; num_neighbors has dist's rank with the last axis of size 1."""
    nearest = torch.topk(-dist, max_neighbors, dim=-1, sorted=True).indices
    take = torch.arange(max_neighbors, device=dist.device) < num_neighbors
    return torch.zeros_like(dist).scatter_(-1, nearest, take.to(dist.dtype).expand_as(nearest))


def vq_knn_smooth(phone, codebook, num_neighbors, max_neighbors: int = MAX_NEIGHBORS,
                  codebook_scale=None):
    """k-NN phone smoothing against a per-stream codebook
    (`phone_extractor.py:121`).

    phone: [B, T, C]; codebook: [B, K, C] (f32, bf16, or int8 with per-row
    codebook_scale [B, K, 1]); num_neighbors: [B] int in [0,
    max_neighbors], 0 = passthrough.  Each phone vector becomes the mean
    of its n nearest codebook entries (squared L2 distance, summed in f32;
    the query's own norm is constant per row and omitted).  Returns
    phone's dtype.
    """
    cb, query = _operands(phone, codebook)
    c2 = (cb.float() * cb.float()).sum(dim=-1)  # [B, K]
    pc = layers.matmul_f32(query, cb.transpose(-1, -2))  # [B, T, K]
    if codebook_scale is not None:
        sc = codebook_scale[..., 0]  # [B, K]
        c2 = c2 * (sc * sc)
        pc = pc * sc[:, None, :]
    dist = c2[:, None, :] - 2.0 * pc
    n = num_neighbors.to(torch.int64)[:, None, None]  # [B, 1, 1]
    weights = _nearest(dist, n, max_neighbors)
    if codebook_scale is not None:
        weights = weights * codebook_scale[..., 0][:, None, :]
    smoothed = layers.matmul_f32(weights.to(cb.dtype), cb) / torch.clamp(n, min=1).float()
    return torch.where(n > 0, smoothed, phone.float()).to(phone.dtype)


def vq_knn_smooth_shared(phone, bank_codebooks, codebook_idx, num_neighbors,
                         max_neighbors: int = MAX_NEIGHBORS, codebook_scale=None,
                         int8_query: bool = False):
    """Gather-free k-NN phone smoothing against the shared codebook bank
    (`phone_extractor.py:217`).

    phone: [B, 1, C]; bank_codebooks: [S, K, C] (f32, bf16, or int8 with
    per-row codebook_scale [S, K, 1]); codebook_idx: [B] int;
    num_neighbors: [B] int, 0 = passthrough.  The same result as gathering
    each stream's codebook for `vq_knn_smooth`, by the JAX package's
    one-hot contractions: distances are [B, S*C] x [S*C, K] with the query
    in its speaker's block, and the mean is [B, S*K] x [S*K, C] with the
    weights in its speaker's block, so the bank is read once and nothing of
    size B*K*C is made.

    int8_query (an int8 bank only, `phone_extractor.py:258-276`): the
    query is quantized per stream row to int8 and the distances are int8
    x int8 products with exact integer sums (`layers._int8_dot`), the
    entries' squared norms too; the scales are applied after.
    """
    s, k_entries, c = bank_codebooks.shape
    cb, query = _operands(phone, bank_codebooks)
    onehot = torch.nn.functional.one_hot(codebook_idx.to(torch.int64), s)  # [B, S]
    oh32 = onehot.float()
    if codebook_scale is not None:
        sc = codebook_scale[..., 0]  # [S, K]
        sc_b = (oh32[:, :, None] * sc).sum(dim=1)  # [B, K], one nonzero term
    bank_t = bank_codebooks.permute(0, 2, 1).reshape(s * c, k_entries)
    if int8_query and bank_codebooks.dtype == torch.int8:
        q8, qs = layers.quantize_rows(phone[:, 0, :])
        masked8 = (onehot[:, :, None] * q8[:, None, :].to(torch.int64)).reshape(-1, s * c)
        pci = layers._int8_dot(masked8, bank_t)  # [B, K]
        c2i = bank_codebooks.float().square().sum(dim=-1)  # [S, K], integer sums: exact
        c2 = (oh32[:, :, None] * (c2i * (sc * sc))).sum(dim=1)  # [B, K]
        pc = pci * qs * sc_b
    else:
        c2_all = (cb.float() * cb.float()).sum(dim=-1)  # [S, K]
        if codebook_scale is not None:
            c2_all = c2_all * (sc * sc)
        c2 = (oh32[:, :, None] * c2_all).sum(dim=1)  # [B, K]
        masked = (onehot.to(query.dtype)[:, :, None] * query[:, 0, None, :]).reshape(-1, s * c)
        pc = layers.matmul_f32(masked, bank_t.to(cb.dtype))  # [B, K]
        if codebook_scale is not None:
            pc = pc * sc_b
    dist = c2 - 2.0 * pc
    n = num_neighbors.to(torch.int64)[:, None]  # [B, 1]
    weights = _nearest(dist, n, max_neighbors)
    if codebook_scale is not None:
        weights = weights * sc_b
    w_by_spk = onehot.to(query.dtype)[:, :, None] * weights.to(query.dtype)[:, None, :]
    smoothed = layers.matmul_f32(w_by_spk.reshape(-1, s * k_entries),
                                 cb.reshape(s * k_entries, c)) / torch.clamp(n, min=1).float()
    out = torch.where(n > 0, smoothed, phone[:, 0, :].float())
    return out[:, None, :].to(phone.dtype)
