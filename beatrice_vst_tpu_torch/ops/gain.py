"""Click-free gain ramp, closed form over a block (port of
`beatrice_vst_tpu/ops/gain.py`): the gain walks 2 dB/ms toward its
target, clamped there, applied per sample."""

from __future__ import annotations

import torch

DB_PER_MS = 2.0


def db_to_amp(db):
    return torch.pow(10.0, db * 0.05)


def gain_process(x, current_db, target_db, sample_rate: float):
    """Apply a smoothed gain ramp to a block of audio (`gain.py:28`).

    x: [..., n] audio; current_db, target_db: [...].  Returns (y,
    new_current_db).  The per-sample amplitude factors as
    amp(cur) * amp(+-d*t), so a block needs two [B] pows and a constant
    [n] ramp.
    """
    n = x.shape[-1]
    db_per_sample = DB_PER_MS / (sample_rate * 0.001)
    t = torch.arange(1, n + 1, dtype=x.dtype, device=x.device)
    cur = current_db[..., None]
    tgt = target_db[..., None]
    direction = torch.sign(tgt - cur)
    amp_cur = db_to_amp(cur)
    amp_tgt = db_to_amp(tgt)
    ramp_up = db_to_amp(db_per_sample * t)
    ramp_dn = db_to_amp(-db_per_sample * t)
    amp_t = torch.where(
        direction >= 0,
        torch.minimum(amp_cur * ramp_up, amp_tgt),
        torch.maximum(amp_cur * ramp_dn, amp_tgt),
    )
    y = x * amp_t
    end = direction[..., 0] * db_per_sample * n + current_db
    new_db = torch.where(
        direction[..., 0] >= 0,
        torch.minimum(end, target_db),
        torch.maximum(end, target_db),
    )
    return y, new_db
