"""Voice-morph pad weight math, batched over any leading stream axes (port
of `beatrice_vst_tpu/ops/morph.py`).

The 2-D morph pad of the reference plugin: up to 8 markers (voice id, x,
y), a cursor and a falloff.  Marker weights are 1/(d^2+eps)^falloff,
normalised, accumulated per voice into a dense [256] vector, folded at the
speaker count, thresholded at 0.01 and pruned to the 8 largest.
"""

from __future__ import annotations

import torch

from ..constants import MAX_N_SPEAKERS, MAX_N_VOICE_MORPH_MARKERS, VOICE_MORPH_WEIGHT_THRESHOLD

_EPSILON = 0.0008


def calculate_marker_weights(cursor_x, cursor_y, falloff, marker_x, marker_y, marker_count):
    """Per-marker weights (`morph.py:27`).

    cursor_x, cursor_y, falloff: [...]; marker_x, marker_y: [..., 8];
    marker_count: [...] int, the active markers.  Returns [..., 8]
    normalised weights, 0 for inactive markers; with falloff <= 0, uniform
    over the active markers."""
    idx = torch.arange(MAX_N_VOICE_MORPH_MARKERS, device=marker_x.device)
    active = idx < marker_count[..., None]
    dx = cursor_x[..., None] - marker_x
    dy = cursor_y[..., None] - marker_y
    w = (dx * dx + dy * dy + _EPSILON) ** -falloff[..., None]
    w = torch.where(active, w, 0.0)
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-30)
    uniform = active.to(w.dtype) / torch.clamp(marker_count[..., None].to(w.dtype), min=1.0)
    return torch.where(falloff[..., None] <= 0.0, uniform, w)


def calculate_voice_weights(cursor_x, cursor_y, falloff, marker_voice_id, marker_x, marker_y,
                            marker_count, max_n_speakers: int = MAX_N_SPEAKERS):
    """Marker weights accumulated per voice id (`morph.py:54`):
    marker_voice_id [..., 8] int, clamped to the speaker range.  Returns
    [..., max_n_speakers]."""
    mw = calculate_marker_weights(cursor_x, cursor_y, falloff, marker_x, marker_y, marker_count)
    vid = torch.clamp(marker_voice_id, 0, max_n_speakers - 1)
    onehot = (vid[..., None] == torch.arange(max_n_speakers, device=vid.device)).to(mw.dtype)
    return torch.einsum("...m,...ms->...s", mw, onehot)


def prepare_voice_morph_weights(weights, speaker_count):
    """Fold the weights past the speaker count into the last speaker, then
    zero those below the threshold (`morph.py:71`).

    weights: [..., S]; speaker_count: [...] int, the model's speakers."""
    s = weights.shape[-1]
    idx = torch.arange(s, device=weights.device)
    count = torch.clamp(torch.as_tensor(speaker_count, device=weights.device), max=s)[..., None]
    in_range = idx < count
    excess = torch.where(in_range, 0.0, weights).sum(-1, keepdim=True)
    w = torch.where(in_range, weights, 0.0) + torch.where(idx == count - 1, excess, 0.0)
    w = torch.where(w < VOICE_MORPH_WEIGHT_THRESHOLD, 0.0, w)
    return torch.where(count > 0, w, 0.0)


def prune_top_k(weights, k: int):
    """Keep the k largest weights and zero the rest (`morph.py:90`).
    Returns (pruned [..., S], indices [..., k] most weighted first).

    Equal weights come in index order, as `jax.lax.top_k` gives them: a
    stable sort, where `torch.topk` promises no order (and orders ties
    differently on the CPU and on the card).  The order decides which
    speaker a lottery draw lands on."""
    if weights.shape[-1] < k:
        raise ValueError(f"weights must have >= {k} entries (pad to MAX_N_SPEAKERS first); "
                         f"got {weights.shape[-1]}")
    top = torch.sort(weights, dim=-1, descending=True, stable=True).indices[..., :k]
    mask = torch.zeros_like(weights).scatter_(-1, top, 1.0)
    return weights * mask, top
