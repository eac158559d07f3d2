"""Per-stream speaker conditioning (port of
`beatrice_vst_tpu/speakers/morpher.py:106 select_conditioning`, the
direct-speaker branch).

Morphing (spherical averages, the codebook lottery) is not ported yet:
a target speaker must be one of the bank's speakers.
"""

from __future__ import annotations

import torch

N_FORMANTS = 9


def select_conditioning(bank, target_speaker, formant_index):
    """Resolve one tick's conditioning for direct (non-morph) speakers.

    target_speaker: [B] int in [0, n_speakers) -- callers validate it
    (StreamEngine.set_control raises on a morph-mode value); formant_index:
    [B] int in [0, 9).  Returns (additive + formant embedding [B, 256],
    summed in f32 whatever the bank's dtype, as the JAX package does;
    codebook speaker index [B]).
    """
    n = bank["additive"].shape[0]
    direct = torch.clamp(target_speaker, 0, n - 1)
    formant = torch.clamp(formant_index, 0, N_FORMANTS - 1)
    additive = bank["additive"][direct].float() + bank["formant"][formant].float()
    return additive, direct
