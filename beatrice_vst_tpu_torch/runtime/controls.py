"""Per-stream control tensors and host-side staging (port of
`beatrice_vst_tpu/runtime/controls.py`, the fields of direct-speaker
streams; the morph fields come with morphing)."""

from __future__ import annotations

import numpy as np
import torch

from ..constants import VersionSpec

# field -> (dtype, default); defaults mirror the JAX package's init_controls
CONTROL_FIELDS = {
    "active": (torch.bool, False),
    "target_speaker": (torch.int64, 0),
    "formant_index": (torch.int64, 4),  # formant shift 0.0 -> slot 4
    "pitch_shift": (torch.float32, 0.0),
    "average_source_pitch": (torch.float32, 52.0),
    "intonation_intensity": (torch.float32, 1.0),
    "pitch_correction": (torch.float32, 0.0),
    "pitch_correction_type": (torch.int64, 0),
    "min_q": (torch.int64, 1),
    "max_q": (torch.int64, None),  # pitch_bins - 1
    "vq_num_neighbors": (torch.int64, 0),
    "input_gain_db": (torch.float32, 0.0),
    "output_gain_db": (torch.float32, 0.0),
}


def init_controls(spec: VersionSpec, capacity: int, device="cpu"):
    """Default control tensors, one [capacity] tensor per field."""
    out = {}
    for field, (dtype, default) in CONTROL_FIELDS.items():
        value = spec.pitch_bins - 1 if default is None else default
        out[field] = torch.full((capacity,), value, dtype=dtype, device=device)
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
