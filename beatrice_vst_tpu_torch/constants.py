"""Frame/model-contract constants for the Beatrice-2 stage chain.

A copy of `beatrice_vst_tpu/constants.py` (the port imports nothing of the
JAX package): 10 ms frames, 160 samples in at 16 kHz, 240 samples out at
24 kHz, and the per-version conditioning dimensions of the Beatrice
inference library's contract (`beatrice.h:10-28`).
"""

from __future__ import annotations

import dataclasses

# --- Frame contract (beatrice.h:10-15) ---
IN_HOP_LENGTH = 160
OUT_HOP_LENGTH = 240
IN_SAMPLE_RATE = 16_000
OUT_SAMPLE_RATE = 24_000
FRAME_RATE = IN_SAMPLE_RATE // IN_HOP_LENGTH  # 100 frames / s
COMMON_SAMPLE_RATE = 48_000  # the 48 kHz grid used by the edge resampler
COMMON_HOP_LENGTH = 480  # 10 ms at 48 kHz

# --- Pitch quantization (beatrice.h:12; processor_core_0.cc:310-331) ---
PITCH_BINS_PER_OCTAVE = 96
PITCH_BINS_PER_SEMITONE = PITCH_BINS_PER_OCTAVE / 12.0  # == 8
# Quantized pitch bin 0 corresponds to MIDI note 33 (A1, 55 Hz):
# the reference maps MIDI -> bin as round((midi - 33) * 8)
# (processor_core_0.cc:316-318).
PITCH_BIN_ZERO_MIDI = 33.0
PITCH_BIN_ZERO_HZ = 55.0

# --- Conditioning dims (beatrice.h:13,17-28) ---
WAVEFORM_GENERATOR_HIDDEN_CHANNELS = 256
N_FORMANT_SHIFT_EMBEDDINGS = 9  # -2..+2 st in 0.5 st steps

# --- Speaker / morphing limits (model_config.h:17, voice_morph_state.h) ---
MAX_N_SPEAKERS = 256
MAX_N_VOICE_MORPH_MARKERS = 8
DEFAULT_N_VOICE_MORPH_MARKERS = 4
VOICE_MORPH_WEIGHT_THRESHOLD = 0.01
VOICE_MORPH_FALLOFF_DEFAULT = 2.0
VOICE_MORPH_FALLOFF_MIN = 0.0
VOICE_MORPH_FALLOFF_MAX = 4.0
# Morphing compute budget (processor_core_2.h:90-91)
SPH_AVG_MAX_N_SPEAKERS = 8
SPH_AVG_MAX_N_UPDATES = 4


@dataclasses.dataclass(frozen=True)
class VersionSpec:
    """Per-model-version dimensions (beatrice.h:17-28)."""

    name: str  # TOML `model.version` string (model_config.h:25-35)
    version_int: int
    phone_channels: int
    pitch_bins: int
    # 20rc0-only speaker conditioning (beatrice.h:23-28)
    has_vq: bool = False
    codebook_size: int = 0
    has_kv: bool = False
    kv_length: int = 0
    kv_channels: int = 0
    n_blocks: int = 4
    hidden_channels: int = WAVEFORM_GENERATOR_HIDDEN_CHANNELS


V20A2 = VersionSpec(
    name="2.0.0-alpha.2", version_int=0, phone_channels=256, pitch_bins=384
)
V20B1 = VersionSpec(
    name="2.0.0-beta.1", version_int=1, phone_channels=256, pitch_bins=384
)
V20RC0 = VersionSpec(
    name="2.0.0-rc.0",
    version_int=2,
    phone_channels=128,
    pitch_bins=448,
    has_vq=True,
    codebook_size=512,
    has_kv=True,
    kv_length=384,
    kv_channels=128,
    n_blocks=4,
)

VERSIONS = {spec.name: spec for spec in (V20A2, V20B1, V20RC0)}
VERSIONS_BY_INT = {spec.version_int: spec for spec in (V20A2, V20B1, V20RC0)}


def quantized_pitch_to_hz(q):
    """Map a quantized pitch bin to Hz (bin 0 = 55 Hz, 96 bins/octave)."""
    return PITCH_BIN_ZERO_HZ * 2.0 ** (q / PITCH_BINS_PER_OCTAVE)


def midi_to_quantized_pitch(midi):
    """Map MIDI note number to quantized pitch bins (float, unclamped)."""
    return (midi - PITCH_BIN_ZERO_MIDI) * PITCH_BINS_PER_SEMITONE
