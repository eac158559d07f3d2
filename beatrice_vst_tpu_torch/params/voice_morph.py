"""Voice-morph state <-> parameter mapping (the 28 morph scalars).

Mirrors `voice_morph_parameter.{h,cc}` (bidirectional mapping between
VoiceMorphState and ParameterState, voice_morph_parameter.cc:24-99) and the
weight math of voice_morph_state.h (reimplemented in ops/morph.py; this
module provides the scalar/host-side version used by the parameter system).

A copy of `beatrice_vst_tpu/params/voice_morph.py` (the port imports nothing of the
JAX package).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..constants import (
    DEFAULT_N_VOICE_MORPH_MARKERS,
    MAX_N_SPEAKERS,
    MAX_N_VOICE_MORPH_MARKERS,
    VOICE_MORPH_FALLOFF_DEFAULT,
)
from .schema import ParameterID

_DEFAULT_MARKERS = ((0, 0.18, 0.5), (1, 0.82, 0.5), (2, 0.5, 0.18), (3, 0.5, 0.82))


@dataclasses.dataclass
class VoiceMorphStateParams:
    cursor_x: float = 0.5
    cursor_y: float = 0.5
    falloff: float = VOICE_MORPH_FALLOFF_DEFAULT
    marker_count: int = DEFAULT_N_VOICE_MORPH_MARKERS
    marker_voice_ids: tuple = tuple(
        _DEFAULT_MARKERS[i][0] if i < 4 else 0 for i in range(MAX_N_VOICE_MORPH_MARKERS)
    )
    marker_x: tuple = tuple(
        _DEFAULT_MARKERS[i][1] if i < 4 else 0.5 for i in range(MAX_N_VOICE_MORPH_MARKERS)
    )
    marker_y: tuple = tuple(
        _DEFAULT_MARKERS[i][2] if i < 4 else 0.5 for i in range(MAX_N_VOICE_MORPH_MARKERS)
    )

    def calculate_weights(self) -> np.ndarray:
        """Dense per-voice weights [MAX_N_SPEAKERS]
        (voice_morph_state.h:50-85), host-side NumPy."""
        eps = 0.0008
        w = np.zeros(MAX_N_VOICE_MORPH_MARKERS, np.float64)
        count = max(1, min(self.marker_count, MAX_N_VOICE_MORPH_MARKERS))
        if self.falloff <= 0.0:
            w[:count] = 1.0 / count
        else:
            for i in range(count):
                d2 = (self.cursor_x - self.marker_x[i]) ** 2 + (
                    self.cursor_y - self.marker_y[i]
                ) ** 2
                w[i] = 1.0 / (d2 + eps) ** self.falloff
            w[:count] /= w[:count].sum()
        voice_w = np.zeros(MAX_N_SPEAKERS, np.float64)
        for i in range(count):
            vid = int(np.clip(self.marker_voice_ids[i], 0, MAX_N_SPEAKERS - 1))
            voice_w[vid] += w[i]
        return voice_w.astype(np.float32)


def get_voice_morph_state(parameter_state) -> VoiceMorphStateParams:
    g = parameter_state.get_value
    return VoiceMorphStateParams(
        cursor_x=float(g(ParameterID.VOICE_MORPH_CURSOR_X)),
        cursor_y=float(g(ParameterID.VOICE_MORPH_CURSOR_Y)),
        falloff=float(g(ParameterID.VOICE_MORPH_FALLOFF)),
        marker_count=int(round(float(g(ParameterID.VOICE_MORPH_MARKER_COUNT)))),
        marker_voice_ids=tuple(
            int(round(float(g(int(ParameterID.VOICE_MORPH_MARKER_VOICE_BASE) + i))))
            for i in range(MAX_N_VOICE_MORPH_MARKERS)
        ),
        marker_x=tuple(
            float(g(int(ParameterID.VOICE_MORPH_MARKER_X_BASE) + i))
            for i in range(MAX_N_VOICE_MORPH_MARKERS)
        ),
        marker_y=tuple(
            float(g(int(ParameterID.VOICE_MORPH_MARKER_Y_BASE) + i))
            for i in range(MAX_N_VOICE_MORPH_MARKERS)
        ),
    )


def get_voice_morph_parameter_values(state: VoiceMorphStateParams):
    """State -> [(parameter id, value)] (voice_morph_parameter.cc:24-99)."""
    out = [
        (int(ParameterID.VOICE_MORPH_CURSOR_X), float(state.cursor_x)),
        (int(ParameterID.VOICE_MORPH_CURSOR_Y), float(state.cursor_y)),
        (int(ParameterID.VOICE_MORPH_FALLOFF), float(state.falloff)),
        (int(ParameterID.VOICE_MORPH_MARKER_COUNT), float(state.marker_count)),
    ]
    for i in range(MAX_N_VOICE_MORPH_MARKERS):
        out.append((int(ParameterID.VOICE_MORPH_MARKER_VOICE_BASE) + i,
                    float(state.marker_voice_ids[i])))
        out.append((int(ParameterID.VOICE_MORPH_MARKER_X_BASE) + i,
                    float(state.marker_x[i])))
        out.append((int(ParameterID.VOICE_MORPH_MARKER_Y_BASE) + i,
                    float(state.marker_y[i])))
    return out
