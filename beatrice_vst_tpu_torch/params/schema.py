"""The parameter registry: IDs, ranges, defaults, flags, and the
coupled-parameter semantics.

Faithful reimplementation of the reference's `kSchema`
(`src/common/parameter_schema.h:44-70`,
`parameter_schema.cc:51-477`): every parameter carries two callbacks --
`controller_set` (UI-side coupled-parameter logic operating on a
ControllerCore) and `processor_set` (routing into a core's Set* methods).
The Lock semantics decide whether changing Voice/FormantShift rewrites
PitchShift (lock average source pitch) or AverageSourcePitch (lock shift):
parameter_schema.cc:133-162,193-224,240-269.

The "core" here is anything implementing the Set* interface of
`processor_core.h:22-92` -- in this framework that's a stream handle of the
runtime engine (runtime/handle.py) or the offline converter.

A copy of `beatrice_vst_tpu/params/schema.py` (the port imports nothing of the
JAX package).
"""

from __future__ import annotations

import dataclasses
import enum
import typing

from ..constants import (
    DEFAULT_N_VOICE_MORPH_MARKERS,
    MAX_N_SPEAKERS,
    MAX_N_VOICE_MORPH_MARKERS,
    VOICE_MORPH_FALLOFF_DEFAULT,
    VOICE_MORPH_FALLOFF_MAX,
    VOICE_MORPH_FALLOFF_MIN,
)
from ..errors import ErrorCode
from .model_config import load_model_config

MAX_ABS_PITCH_SHIFT = 24.0


class ParameterFlag(enum.IntFlag):
    NONE = 0
    CAN_AUTOMATE = 1 << 0
    IS_READ_ONLY = 1 << 1
    IS_WRAP_AROUND = 1 << 2
    IS_LIST = 1 << 3
    IS_HIDDEN = 1 << 4


class ParameterID(enum.IntEnum):
    NULL = -1
    MODEL = 1
    VOICE = 2
    FORMANT_SHIFT = 3
    PITCH_SHIFT = 4
    AVERAGE_SOURCE_PITCH = 5
    LOCK = 6
    INPUT_GAIN = 7
    OUTPUT_GAIN = 8
    INTONATION_INTENSITY = 9
    PITCH_CORRECTION = 10
    PITCH_CORRECTION_TYPE = 11
    MIN_SOURCE_PITCH = 12
    MAX_SOURCE_PITCH = 13
    VQ_NUM_NEIGHBORS = 14
    VOICE_MORPH_CURSOR_X = 15
    VOICE_MORPH_CURSOR_Y = 16
    VOICE_MORPH_FALLOFF = 17
    VOICE_MORPH_MARKER_COUNT = 18
    VOICE_MORPH_MARKER_VOICE_BASE = 19
    VOICE_MORPH_MARKER_X_BASE = 19 + MAX_N_VOICE_MORPH_MARKERS
    VOICE_MORPH_MARKER_Y_BASE = 19 + 2 * MAX_N_VOICE_MORPH_MARKERS
    AVERAGE_TARGET_PITCH_BASE = 100
    END = 100 + MAX_N_SPEAKERS + 1


def is_voice_morph_parameter(pid: int) -> bool:
    return (
        int(ParameterID.VOICE_MORPH_CURSOR_X)
        <= int(pid)
        < int(ParameterID.VOICE_MORPH_MARKER_Y_BASE) + MAX_N_VOICE_MORPH_MARKERS
    )


class CoreInterface(typing.Protocol):
    """The Set* surface of ProcessorCoreBase (processor_core.h:22-92)."""

    def load_model(self, config, model_path: str) -> ErrorCode: ...
    def set_sample_rate(self, v: float) -> ErrorCode: ...
    def set_target_speaker(self, v: int) -> ErrorCode: ...
    def set_formant_shift(self, v: float) -> ErrorCode: ...
    def set_pitch_shift(self, v: float) -> ErrorCode: ...
    def set_input_gain(self, v: float) -> ErrorCode: ...
    def set_output_gain(self, v: float) -> ErrorCode: ...
    def set_average_source_pitch(self, v: float) -> ErrorCode: ...
    def set_intonation_intensity(self, v: float) -> ErrorCode: ...
    def set_pitch_correction(self, v: float) -> ErrorCode: ...
    def set_pitch_correction_type(self, v: int) -> ErrorCode: ...
    def set_min_source_pitch(self, v: float) -> ErrorCode: ...
    def set_max_source_pitch(self, v: float) -> ErrorCode: ...
    def set_vq_num_neighbors(self, v: int) -> ErrorCode: ...
    def set_speaker_morphing_weights(self, weights) -> ErrorCode: ...


class ControllerCore:
    """UI-side mirror: parameter state + queue of coupled updates
    (controller_core.h:13-19)."""

    def __init__(self, parameter_state):
        self.parameter_state = parameter_state
        self.updated_parameters: list[int] = []

    def _set(self, pid, value):
        self.parameter_state.set_value(pid, value)
        self.updated_parameters.append(int(pid))


@dataclasses.dataclass(frozen=True)
class NumberParameter:
    name: str
    default_value: float
    min_value: float
    max_value: float
    units: str = ""
    divisions: int = 0
    short_name: str = ""
    flags: int = ParameterFlag.NONE
    controller_set: typing.Callable = None
    processor_set: typing.Callable = None


@dataclasses.dataclass(frozen=True)
class ListParameter:
    name: str
    values: tuple
    default_value: int = 0
    short_name: str = ""
    flags: int = ParameterFlag.NONE
    controller_set: typing.Callable = None
    processor_set: typing.Callable = None

    @property
    def divisions(self) -> int:
        return len(self.values) - 1

    @property
    def min_value(self):
        return 0

    @property
    def max_value(self):
        return len(self.values) - 1


@dataclasses.dataclass(frozen=True)
class StringParameter:
    name: str
    default_value: str = ""
    reset_when_model_load: bool = False
    controller_set: typing.Callable = None
    processor_set: typing.Callable = None


# ------------------------------------------------------ coupled updates --


def _avg_target_pitch_id(voice: int) -> int:
    return int(ParameterID.AVERAGE_TARGET_PITCH_BASE) + voice


def _sync_lock(controller: ControllerCore, average_target_pitch: float,
               formant_shift: float) -> None:
    """Apply the Lock rule (parameter_schema.cc:133-162 et al.): either
    rewrite PitchShift from the fixed AverageSourcePitch, or rewrite
    AverageSourcePitch from the fixed PitchShift."""
    st = controller.parameter_state
    lock = st.get_value(ParameterID.LOCK)
    if lock == 0:  # AverageSourcePitch is fixed
        avg_src = st.get_value(ParameterID.AVERAGE_SOURCE_PITCH)
        shift = max(-MAX_ABS_PITCH_SHIFT,
                    min(MAX_ABS_PITCH_SHIFT,
                        average_target_pitch + formant_shift - avg_src))
        controller._set(ParameterID.PITCH_SHIFT, shift)
    else:  # PitchShift is fixed
        shift = st.get_value(ParameterID.PITCH_SHIFT)
        controller._set(
            ParameterID.AVERAGE_SOURCE_PITCH,
            average_target_pitch + formant_shift - shift,
        )


def _controller_model(controller: ControllerCore, value: str) -> ErrorCode:
    """Model-load coupled updates (parameter_schema.cc:57-164)."""
    if not value:
        return ErrorCode.SUCCESS
    try:
        config = load_model_config(value)
    except Exception as e:  # map to codes like the reference's catch chain
        from ..errors import BeatriceError

        if isinstance(e, BeatriceError):
            return e.code
        return ErrorCode.UNKNOWN_ERROR
    if config.version_int < 0:
        return ErrorCode.INVALID_MODEL_CONFIG

    controller._set(ParameterID.VOICE, 0)
    controller._set(ParameterID.FORMANT_SHIFT, 0.0)
    # per-voice average target pitches; unset voices read 0.0 (the C++
    # default-constructed Voice), parameter_schema.cc:91-102
    for i in range(MAX_N_SPEAKERS):
        pitch = config.voices[i].average_pitch if i < config.voice_count else 0.0
        controller._set(_avg_target_pitch_id(i), pitch)
    # morph slot: simple mean over the real voices (parameter_schema.cc:104-119)
    morph_avg = sum(v.average_pitch for v in config.voices) / config.voice_count
    controller._set(_avg_target_pitch_id(config.voice_count), morph_avg)
    # morph pad defaults with marker_count = min(count, 4)
    from .voice_morph import VoiceMorphStateParams, get_voice_morph_parameter_values

    vm = VoiceMorphStateParams(
        marker_count=min(config.voice_count, DEFAULT_N_VOICE_MORPH_MARKERS)
    )
    for pid, pvalue in get_voice_morph_parameter_values(vm):
        controller._set(pid, pvalue)
    _sync_lock(controller, config.voices[0].average_pitch, 0.0)
    return ErrorCode.SUCCESS


def _controller_voice(controller: ControllerCore, value: int) -> ErrorCode:
    if value < 0 or value > MAX_N_SPEAKERS:
        return ErrorCode.SPEAKER_ID_OUT_OF_RANGE
    st = controller.parameter_state
    formant = st.get_value(ParameterID.FORMANT_SHIFT)
    avg_target = st.get_value(_avg_target_pitch_id(value))
    _sync_lock(controller, avg_target, formant)
    return ErrorCode.SUCCESS


def _controller_formant(controller: ControllerCore, value: float) -> ErrorCode:
    st = controller.parameter_state
    voice = st.get_value(ParameterID.VOICE)
    avg_target = st.get_value(_avg_target_pitch_id(voice))
    _sync_lock(controller, avg_target, value)
    return ErrorCode.SUCCESS


def _controller_pitch_shift(controller: ControllerCore, value: float) -> ErrorCode:
    # always rewrites AverageSourcePitch (parameter_schema.cc:279-297)
    st = controller.parameter_state
    voice = st.get_value(ParameterID.VOICE)
    formant = st.get_value(ParameterID.FORMANT_SHIFT)
    avg_target = st.get_value(_avg_target_pitch_id(voice))
    controller._set(ParameterID.AVERAGE_SOURCE_PITCH, avg_target + formant - value)
    return ErrorCode.SUCCESS


def _controller_avg_source(controller: ControllerCore, value: float) -> ErrorCode:
    # always rewrites PitchShift (parameter_schema.cc:302-327)
    st = controller.parameter_state
    voice = st.get_value(ParameterID.VOICE)
    formant = st.get_value(ParameterID.FORMANT_SHIFT)
    avg_target = st.get_value(_avg_target_pitch_id(voice))
    shift = max(-MAX_ABS_PITCH_SHIFT,
                min(MAX_ABS_PITCH_SHIFT, avg_target + formant - value))
    controller._set(ParameterID.PITCH_SHIFT, shift)
    return ErrorCode.SUCCESS


def _controller_voice_morph(controller: ControllerCore, value) -> ErrorCode:
    # Deliberate no-op, matching the reference exactly: its
    # SetVoiceMorphParameterOnController is `return kSuccess` with no
    # coupled updates (parameter_schema.cc:32-34); morph-pad layout changes
    # are driven by the editor through the 28 plain parameters
    # (editor_morph_controller.cc), and the morph-average-pitch coupling
    # happens at model load (_controller_model, parameter_schema.cc:82-129).
    return ErrorCode.SUCCESS


def _processor_voice_morph(proxy, value) -> ErrorCode:
    from .voice_morph import get_voice_morph_state

    vm = get_voice_morph_state(proxy.parameter_state)
    return proxy.core.set_speaker_morphing_weights(vm.calculate_weights())


def _noop_controller(controller, value) -> ErrorCode:
    return ErrorCode.SUCCESS


def build_schema() -> dict:
    """The registry (parameter IDs -> parameter descriptors)."""
    schema: dict[int, object] = {
        ParameterID.MODEL: StringParameter(
            "Model", "", False,
            controller_set=_controller_model,
            processor_set=lambda proxy, v: proxy.load_model(v),
        ),
        ParameterID.VOICE: ListParameter(
            "Voice", tuple(f"ID {i}" for i in range(MAX_N_SPEAKERS + 1)), 0,
            "Voi", ParameterFlag.CAN_AUTOMATE,
            controller_set=_controller_voice,
            processor_set=lambda proxy, v: proxy.core.set_target_speaker(int(v)),
        ),
        ParameterID.FORMANT_SHIFT: NumberParameter(
            "Formant Shift", 0.0, -2.0, 2.0, "st", 8, "For",
            ParameterFlag.CAN_AUTOMATE,
            controller_set=_controller_formant,
            processor_set=lambda proxy, v: proxy.core.set_formant_shift(v),
        ),
        ParameterID.PITCH_SHIFT: NumberParameter(
            "Pitch Shift", 0.0, -MAX_ABS_PITCH_SHIFT, MAX_ABS_PITCH_SHIFT,
            "st", 48 * 8, "Pit", ParameterFlag.CAN_AUTOMATE,
            controller_set=_controller_pitch_shift,
            processor_set=lambda proxy, v: proxy.core.set_pitch_shift(v),
        ),
        ParameterID.AVERAGE_SOURCE_PITCH: NumberParameter(
            "Average Source Pitch", 52.0, 0.0, 128.0, "", 128 * 8, "SrcPit",
            ParameterFlag.NONE,
            controller_set=_controller_avg_source,
            processor_set=lambda proxy, v: proxy.core.set_average_source_pitch(v),
        ),
        ParameterID.LOCK: ListParameter(
            "Lock", ("Average Source Pitch", "Pitch Shift"), 0, "Loc",
            ParameterFlag.IS_LIST,
            controller_set=_noop_controller,
            processor_set=lambda proxy, v: ErrorCode.SUCCESS,
        ),
        ParameterID.INPUT_GAIN: NumberParameter(
            "Input Gain", 0.0, -60.0, 20.0, "dB", 0, "Gain/In",
            ParameterFlag.CAN_AUTOMATE,
            controller_set=_noop_controller,
            processor_set=lambda proxy, v: proxy.core.set_input_gain(v),
        ),
        ParameterID.OUTPUT_GAIN: NumberParameter(
            "Output Gain", 0.0, -60.0, 20.0, "dB", 0, "Gain/Out",
            ParameterFlag.CAN_AUTOMATE,
            controller_set=_noop_controller,
            processor_set=lambda proxy, v: proxy.core.set_output_gain(v),
        ),
        ParameterID.INTONATION_INTENSITY: NumberParameter(
            "Intonation Intensity", 1.0, -1.0, 3.0, "", 40, "Inton",
            ParameterFlag.CAN_AUTOMATE,
            controller_set=_noop_controller,
            processor_set=lambda proxy, v: proxy.core.set_intonation_intensity(v),
        ),
        ParameterID.PITCH_CORRECTION: NumberParameter(
            "Pitch Correction", 0.0, 0.0, 1.0, "", 10, "PitCor",
            ParameterFlag.CAN_AUTOMATE,
            controller_set=_noop_controller,
            processor_set=lambda proxy, v: proxy.core.set_pitch_correction(v),
        ),
        ParameterID.PITCH_CORRECTION_TYPE: ListParameter(
            "Pitch Correction Type", ("Hard 0", "Hard 1"), 0, "CorTyp",
            ParameterFlag.CAN_AUTOMATE,
            controller_set=_noop_controller,
            processor_set=lambda proxy, v: proxy.core.set_pitch_correction_type(int(v)),
        ),
        ParameterID.MIN_SOURCE_PITCH: NumberParameter(
            "Min Source Pitch", 33.125, 0.0, 128.0, "", 128 * 8, "MinPit",
            ParameterFlag.CAN_AUTOMATE,
            controller_set=_noop_controller,
            processor_set=lambda proxy, v: proxy.core.set_min_source_pitch(v),
        ),
        ParameterID.MAX_SOURCE_PITCH: NumberParameter(
            "Max Source Pitch", 80.875, 0.0, 128.0, "", 128 * 8, "MaxPit",
            ParameterFlag.CAN_AUTOMATE,
            controller_set=_noop_controller,
            processor_set=lambda proxy, v: proxy.core.set_max_source_pitch(v),
        ),
        ParameterID.VQ_NUM_NEIGHBORS: NumberParameter(
            "VQ Neighbor Count", 0.0, 0.0, 8.0, "", 8, "VQNbr",
            ParameterFlag.CAN_AUTOMATE,
            controller_set=_noop_controller,
            processor_set=lambda proxy, v: proxy.core.set_vq_num_neighbors(int(round(v))),
        ),
        ParameterID.VOICE_MORPH_CURSOR_X: NumberParameter(
            "Morph Cursor X", 0.5, 0.0, 1.0, "", 1000, "MrphCX",
            ParameterFlag.CAN_AUTOMATE, _controller_voice_morph, _processor_voice_morph,
        ),
        ParameterID.VOICE_MORPH_CURSOR_Y: NumberParameter(
            "Morph Cursor Y", 0.5, 0.0, 1.0, "", 1000, "MrphCY",
            ParameterFlag.CAN_AUTOMATE, _controller_voice_morph, _processor_voice_morph,
        ),
        ParameterID.VOICE_MORPH_FALLOFF: NumberParameter(
            "Morph Falloff", VOICE_MORPH_FALLOFF_DEFAULT,
            VOICE_MORPH_FALLOFF_MIN, VOICE_MORPH_FALLOFF_MAX, "", 40, "MrphFo",
            ParameterFlag.CAN_AUTOMATE, _controller_voice_morph, _processor_voice_morph,
        ),
        ParameterID.VOICE_MORPH_MARKER_COUNT: NumberParameter(
            "Morph Marker Count", DEFAULT_N_VOICE_MORPH_MARKERS, 1.0,
            MAX_N_VOICE_MORPH_MARKERS, "", MAX_N_VOICE_MORPH_MARKERS - 1,
            "MrphCt", ParameterFlag.CAN_AUTOMATE,
            _controller_voice_morph, _processor_voice_morph,
        ),
    }
    # default marker layout (voice_morph_state.h:36-41)
    default_markers = [(0, 0.18, 0.5), (1, 0.82, 0.5), (2, 0.5, 0.18), (3, 0.5, 0.82)]
    for i in range(MAX_N_VOICE_MORPH_MARKERS):
        vid, mx, my = default_markers[i] if i < 4 else (0, 0.5, 0.5)
        schema[int(ParameterID.VOICE_MORPH_MARKER_VOICE_BASE) + i] = NumberParameter(
            f"Morph Marker {i} Voice", float(vid), 0.0, MAX_N_SPEAKERS - 1, "",
            MAX_N_SPEAKERS - 1, "MrphV", ParameterFlag.CAN_AUTOMATE,
            _controller_voice_morph, _processor_voice_morph,
        )
        schema[int(ParameterID.VOICE_MORPH_MARKER_X_BASE) + i] = NumberParameter(
            f"Morph Marker {i} X", mx, 0.0, 1.0, "", 1000, "MrphX",
            ParameterFlag.CAN_AUTOMATE, _controller_voice_morph, _processor_voice_morph,
        )
        schema[int(ParameterID.VOICE_MORPH_MARKER_Y_BASE) + i] = NumberParameter(
            f"Morph Marker {i} Y", my, 0.0, 1.0, "", 1000, "MrphY",
            ParameterFlag.CAN_AUTOMATE, _controller_voice_morph, _processor_voice_morph,
        )
    # hidden read-only per-speaker average target pitches (+ morph slot)
    for i in range(MAX_N_SPEAKERS + 1):
        schema[_avg_target_pitch_id(i)] = NumberParameter(
            f"Speaker {i}", 60.0, 0.0, 128.0, "", 128 * 8, "TgtPit",
            ParameterFlag.IS_READ_ONLY | ParameterFlag.IS_HIDDEN,
            _noop_controller, lambda proxy, v: ErrorCode.SUCCESS,
        )
    return schema


SCHEMA = build_schema()
