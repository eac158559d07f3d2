"""Unified error codes.

A copy of `beatrice_vst_tpu/errors.py`: the Beatrice plugin's error enum
(`error.h:11-25`), whose first four values share the file-error ABI of the
inference library (`beatrice.h:30-36`).  The control plane raises these;
the data plane never raises -- a failing stream mutes itself (emits zeros).
"""

from __future__ import annotations

import enum


class ErrorCode(enum.IntEnum):
    SUCCESS = 0
    FILE_OPEN_ERROR = 1
    FILE_TOO_SMALL = 2
    FILE_TOO_LARGE = 3
    INVALID_FILE_SIZE = 4
    MODEL_NOT_LOADED = 5
    RESAMPLER_NOT_READY = 6
    GAIN_NOT_READY = 7
    SPEAKER_ID_OUT_OF_RANGE = 8
    INVALID_PITCH_CORRECTION_TYPE = 9
    TOML_SYNTAX_ERROR = 10
    INVALID_MODEL_CONFIG = 11
    UNKNOWN_ERROR = 12


class BeatriceError(Exception):
    """Control-plane exception carrying an ErrorCode."""

    def __init__(self, code: ErrorCode, message: str = ""):
        super().__init__(f"{code.name}: {message}" if message else code.name)
        self.code = code
