"""StreamHandle: the per-stream CoreInterface over the batched engine
(port of `beatrice_vst_tpu/runtime/handle.py`).

One handle is one plugin instance in the reference's terms: the parameter
proxy (params/proxy.py) drives it as ProcessorProxy drives a
ProcessorCore (processor_core.h:22-92), and every Set* lands as a staged
control edit on the engine's stream slot.  Handles are called from client
threads: nothing here touches the device.  `reset_context` is staged on
the engine and applied by the thread that ticks, and morph weights are
folded and pruned on CPU tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import MAX_N_SPEAKERS
from ..errors import ErrorCode
from ..ops.morph import prepare_voice_morph_weights, prune_top_k
from ..speakers import bank as bank_mod


class StreamHandle:
    """CoreInterface implementation bound to (engine, stream slot)."""

    def __init__(self, engine, idx: int):
        self.engine = engine
        self.idx = idx
        self.model_config = None

    # -- lifecycle --

    def load_model(self, config, model_path: str) -> ErrorCode:
        """The engine's weights are shared across streams; a handle-level
        load only checks that the versions agree (the serving layer routes
        streams to an engine of the right version)."""
        if config.version != self.engine.cfg.spec.name:
            return ErrorCode.INVALID_MODEL_CONFIG
        self.model_config = config
        return ErrorCode.SUCCESS

    def reset_context(self) -> ErrorCode:
        self.engine.reset_context(self.idx)
        return ErrorCode.SUCCESS

    def set_sample_rate(self, v: float) -> ErrorCode:
        # streams ride the 48 kHz grid; client rates are converted at the
        # host edge (server.StreamSession)
        return ErrorCode.SUCCESS if v == 48000.0 else ErrorCode.RESAMPLER_NOT_READY

    # -- Set* surface (processor_core.h:34-92) --

    def _stage(self, field, value) -> ErrorCode:
        self.engine.set_control(self.idx, field, value)
        return ErrorCode.SUCCESS

    def set_target_speaker(self, v: int) -> ErrorCode:
        n = bank_mod.n_speakers(self.engine.bank)
        if v < 0 or v > n:  # == n selects morph mode (core_2.cc:436)
            return ErrorCode.SPEAKER_ID_OUT_OF_RANGE
        return self._stage("target_speaker", np.int32(v))

    def set_formant_shift(self, v: float) -> ErrorCode:
        v = float(np.clip(v, -2.0, 2.0))
        return self._stage("formant_index", np.int32(round(v * 2.0 + 4.0)))

    def set_pitch_shift(self, v: float) -> ErrorCode:
        return self._stage("pitch_shift", np.float32(np.clip(v, -24.0, 24.0)))

    def set_input_gain(self, v: float) -> ErrorCode:
        return self._stage("input_gain_db", np.float32(v))

    def set_output_gain(self, v: float) -> ErrorCode:
        return self._stage("output_gain_db", np.float32(v))

    def set_average_source_pitch(self, v: float) -> ErrorCode:
        return self._stage("average_source_pitch", np.float32(np.clip(v, 0.0, 128.0)))

    def set_intonation_intensity(self, v: float) -> ErrorCode:
        return self._stage("intonation_intensity", np.float32(v))

    def set_pitch_correction(self, v: float) -> ErrorCode:
        return self._stage("pitch_correction", np.float32(np.clip(v, 0.0, 1.0)))

    def set_pitch_correction_type(self, v: int) -> ErrorCode:
        if v < 0 or v > 1:
            return ErrorCode.INVALID_PITCH_CORRECTION_TYPE
        return self._stage("pitch_correction_type", np.int32(v))

    def _pitch_to_bins(self, midi: float) -> np.int32:
        bins = round((float(np.clip(midi, 0.0, 128.0)) - 33.0) * 8.0)
        return np.int32(np.clip(bins, 1, self.engine.cfg.spec.pitch_bins - 1))

    def set_min_source_pitch(self, v: float) -> ErrorCode:
        return self._stage("min_q", self._pitch_to_bins(v))

    def set_max_source_pitch(self, v: float) -> ErrorCode:
        return self._stage("max_q", self._pitch_to_bins(v))

    def set_vq_num_neighbors(self, v: int) -> ErrorCode:
        return self._stage("vq_num_neighbors", np.int32(np.clip(v, 0, 8)))

    def set_speaker_morphing_weights(self, weights) -> ErrorCode:
        """Dense per-voice weights [256] -> pruned weights and top-8
        indices (ApplySpeakerMorphingWeights, processor_core_2.cc:507-532),
        computed on CPU tensors so that a client never waits for the tick
        in flight on the card."""
        n = bank_mod.n_speakers(self.engine.bank)
        w = torch.as_tensor(np.asarray(weights, np.float32))[None, :MAX_N_SPEAKERS]
        pruned = prepare_voice_morph_weights(w, torch.tensor([n]))
        pruned, top_idx = prune_top_k(pruned, 8)
        self._stage("morph_weights", pruned[0].numpy())
        self._stage("morph_top_idx", top_idx[0].numpy().astype(np.int32))
        return ErrorCode.SUCCESS
