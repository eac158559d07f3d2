"""Per-stream speaker conditioning and morphing (port of
`beatrice_vst_tpu/speakers/morpher.py`).

A stream in morph mode (target speaker >= the bank's speaker count, the
plugin's "Voice Morphing Mode") is conditioned on the spherical average of
the additive and K/V embeddings of its (at most 8) morph speakers,
recomputed when its morph controls change (`update_morphed_embeddings`),
and draws one speaker's VQ codebook per frame by a weighted lottery
(`codebook_lottery`): codebook entries are phone prototypes, which are not
averaged.
"""

from __future__ import annotations

import torch

from ..constants import SPH_AVG_MAX_N_SPEAKERS, SPH_AVG_MAX_N_UPDATES
from ..models.layers import hash_noise
from ..ops.morph import prepare_voice_morph_weights, prune_top_k
from ..ops.spherical_average import spherical_average

N_FORMANTS = 9
LOTTERY_SALT = 0x10777E


def _rows(table, idx):
    """table[idx] with idx clamped to the table's rows, as JAX's gather
    clamps (a top-8 list over fewer than 8 speakers holds indices past the
    bank, with zero weight)."""
    return table[torch.clamp(idx, 0, table.shape[0] - 1)]


def pruned_morph_weights(dense_weights, n_speakers):
    """Fold, threshold and prune to the top 8 (`morpher.py:30`).
    dense_weights: [B, S]; n_speakers: [B] int.  Returns (pruned [B, S],
    top_idx [B, 8] most weighted first)."""
    w = prepare_voice_morph_weights(dense_weights, n_speakers)
    return prune_top_k(w, SPH_AVG_MAX_N_SPEAKERS)


def update_morphed_embeddings(bank, pruned_weights, top_idx, n_iters: int = SPH_AVG_MAX_N_UPDATES):
    """Spherical averages of the top-8 speakers' embeddings per stream
    (`morpher.py:42`), solved in f32 whatever the bank's dtype.

    pruned_weights: [B, S]; top_idx: [B, 8].  Returns {"additive" [B, 256]}
    and, for a bank with K/V, "kv" [B, 384, 128] (one average per row)."""
    w8 = torch.gather(pruned_weights, -1, top_idx).float()
    out = {"additive": spherical_average(_rows(bank["additive"], top_idx).float(), w8, n_iters)}
    if "kv" in bank:
        pts = _rows(bank["kv"], top_idx).float().transpose(1, 2).contiguous()  # [B, L, 8, C]
        out["kv"] = spherical_average(pts, w8[:, None, :].expand(pts.shape[:-1]), n_iters)
    return out


def codebook_lottery(pruned_weights, top_idx, n_speakers, frame_counter, w8=None):
    """Each frame's codebook speaker by weighted lottery (`morpher.py:64`):
    [B], or [B, T] for a [B, T] frame_counter.

    The draw u in [0, 1) is `hash_noise` of the frame counter (uint32
    values); the pick is the first of the top-8 buckets whose cumulative
    weight passes u * total.  With weights that sum to about 0, a uniform
    pick over the n_speakers real speakers.  w8 [B, 8]: pruned_weights at
    top_idx, if the caller has it."""
    if w8 is None:
        w8 = torch.gather(pruned_weights, -1, top_idx)
    total = w8.sum(-1)
    u = (hash_noise(frame_counter, 1, LOTTERY_SALT)[..., 0] + 1.0) * 0.5
    top = top_idx
    if frame_counter.dim() > 1:
        w8, top, total, n_speakers = w8[:, None], top[:, None], total[:, None], n_speakers[:, None]
    past = torch.cumsum(w8, -1) > (u * total)[..., None]
    pick = torch.argmax(past.to(torch.int32), dim=-1)  # the first bucket past the draw
    chosen = torch.gather(top.expand(*pick.shape, top.shape[-1]), -1, pick[..., None])[..., 0]
    uniform = torch.floor(u * n_speakers.to(u.dtype)).to(chosen.dtype)
    uniform = torch.minimum(torch.clamp(uniform, min=0), torch.clamp(n_speakers - 1, min=0))
    return torch.where(total <= torch.finfo(torch.float32).eps, uniform, chosen)


def select_conditioning(bank, target_speaker, morphed, formant_index, frame_counter=None,
                        pruned_weights=None, top_idx=None, include_kv: bool = True, w8=None):
    """One tick's per-stream conditioning (`morpher.py:106`).

    target_speaker: [B] int, a value >= the bank's speaker count is morph
    mode; morphed: `update_morphed_embeddings`' dict per stream;
    formant_index: [B] int in [0, 9).  With frame_counter ([B] or [B, T])
    a morph stream's codebook speaker comes from `codebook_lottery` over
    pruned_weights / top_idx (or w8).

    Returns (additive + formant embedding [B, 256], summed in f32 whatever
    the bank's dtype; kv [B, 384, 128] or None; codebook speaker [B(, T)]
    or None for a bank without codebooks)."""
    n = bank["additive"].shape[0]
    is_morph = target_speaker >= n
    direct = torch.clamp(target_speaker, 0, n - 1)
    additive = torch.where(is_morph[:, None], morphed["additive"].float(),
                           bank["additive"][direct].float())
    additive = additive + bank["formant"][torch.clamp(formant_index, 0, N_FORMANTS - 1)].float()
    kv = None
    if "kv" in bank and include_kv:
        kv = torch.where(is_morph[:, None, None], morphed["kv"], bank["kv"][direct])
    cb_idx = None
    if "codebook" in bank:
        cb_idx = direct
        if frame_counter is not None:
            lottery = codebook_lottery(pruned_weights, top_idx, torch.full_like(target_speaker, n),
                                       frame_counter, w8=w8)
            if frame_counter.dim() > 1:
                direct, is_morph = direct[:, None], is_morph[:, None]
            cb_idx = torch.where(is_morph, lottery, direct)
    return additive, kv, cb_idx
