"""Per-stream control tensors and host-side staging (port of
`beatrice_vst_tpu/runtime/controls.py`)."""

from __future__ import annotations

import numpy as np
import torch

from ..constants import MAX_N_SPEAKERS, SPH_AVG_MAX_N_SPEAKERS, VersionSpec
from ..device import resolve_device

# field -> (dtype, default, shape of one stream's value); defaults and
# shapes mirror the JAX package's init_controls
CONTROL_FIELDS = {
    "active": (torch.bool, False, ()),
    "target_speaker": (torch.int64, 0, ()),
    "formant_index": (torch.int64, 4, ()),  # formant shift 0.0 -> slot 4
    "pitch_shift": (torch.float32, 0.0, ()),
    "average_source_pitch": (torch.float32, 52.0, ()),
    "intonation_intensity": (torch.float32, 1.0, ()),
    "pitch_correction": (torch.float32, 0.0, ()),
    "pitch_correction_type": (torch.int64, 0, ()),
    "min_q": (torch.int64, 1, ()),
    "max_q": (torch.int64, None, ()),  # pitch_bins - 1
    "vq_num_neighbors": (torch.int64, 0, ()),
    "input_gain_db": (torch.float32, 0.0, ()),
    "output_gain_db": (torch.float32, 0.0, ()),
    # pruned morph weights over the dense speaker axis, and the top-8
    # speakers most weighted first (`morpher.pruned_morph_weights`)
    "morph_weights": (torch.float32, 0.0, (MAX_N_SPEAKERS,)),
    "morph_top_idx": (torch.int64, 0, (SPH_AVG_MAX_N_SPEAKERS,)),
    # slots-mode KV selector, an index into [n_speakers + n_morph_slots):
    # read only for morph-mode streams (a leased morph slot, or the
    # dominant morph speaker's base slot when none is free); a direct
    # speaker's slot is its target_speaker (`controls.py:40-43`)
    "kv_slot": (torch.int64, 0, ()),
}


def init_controls(spec: VersionSpec, capacity: int, device="cuda"):
    """Default control tensors, [capacity, *shape] per field."""
    device = resolve_device(device)
    out = {}
    for field, (dtype, default, shape) in CONTROL_FIELDS.items():
        value = spec.pitch_bins - 1 if default is None else default
        out[field] = torch.full((capacity, *shape), value, dtype=dtype, device=device)
    return out


class ControlStage:
    """Host-side accumulator of per-stream control edits.

    `stage(idx, field, value)` records an edit; `drain()` returns
    {field: (indices, values)} and clears the stage.  The last write per
    (stream, field) wins.
    """

    def __init__(self):
        self._edits: dict[str, dict[int, np.ndarray]] = {}

    def stage(self, idx: int, field: str, value) -> None:
        self._edits.setdefault(field, {})[int(idx)] = np.asarray(value)

    def pending(self) -> bool:
        return bool(self._edits)

    def drain(self):
        out = {}
        for field, per_stream in self._edits.items():
            idx = np.fromiter(per_stream.keys(), np.int64, len(per_stream))
            vals = np.stack([per_stream[int(i)] for i in idx])
            out[field] = (idx, vals)
        self._edits.clear()
        return out
