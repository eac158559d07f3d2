"""Model-card TOML parsing, mirroring the reference's ModelConfig
(`src/common/model_config.h:20-137`): `[model]`
version/name/description plus `[voice.N]` entries with name, description,
average_pitch and portrait metadata; <=256 speakers with contiguous ids;
display text NUL-scrubbed; version string -> {0, 1, 2}.

A model directory holds:
  config.toml (this card)  |  weights.npz  |  speakers.npz  |  portraits/
replacing the reference's phone_extractor.bin / pitch_estimator.bin /
waveform_generator.bin / speaker_embeddings.bin / embedding_setter.bin
(processor_core_2.cc:300-351).

A copy of `beatrice_vst_tpu/params/model_config.py` (the port imports nothing of the
JAX package).
"""

from __future__ import annotations

import dataclasses
import math
import os
import tomllib

from ..constants import MAX_N_SPEAKERS, VERSIONS, VersionSpec
from ..errors import BeatriceError, ErrorCode


def _display_text(value) -> str:
    """NUL -> space, per model_config.h:63-69."""
    if not isinstance(value, str):
        raise BeatriceError(ErrorCode.INVALID_MODEL_CONFIG, f"expected string, got {type(value)}")
    return value.replace("\x00", " ")


@dataclasses.dataclass(frozen=True)
class Portrait:
    path: str = ""
    description: str = ""


@dataclasses.dataclass(frozen=True)
class Voice:
    name: str = ""
    description: str = ""
    average_pitch: float = 0.0
    portrait: Portrait = Portrait()


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    version: str
    name: str
    description: str
    voices: tuple  # tuple[Voice, ...], contiguous ids from 0
    path: str = ""  # directory the card was loaded from

    @property
    def version_int(self) -> int:
        spec = VERSIONS.get(self.version)
        return spec.version_int if spec else -1

    @property
    def spec(self) -> VersionSpec:
        spec = VERSIONS.get(self.version)
        if spec is None:
            raise BeatriceError(ErrorCode.INVALID_MODEL_CONFIG, f"unknown version {self.version!r}")
        return spec

    @property
    def voice_count(self) -> int:
        return len(self.voices)


def parse_model_config(text: str, path: str = "") -> ModelConfig:
    try:
        data = tomllib.loads(text)
    except tomllib.TOMLDecodeError as e:
        raise BeatriceError(ErrorCode.TOML_SYNTAX_ERROR, str(e)) from e
    try:
        model = data["model"]
        version = model["version"]
        name = _display_text(model.get("name", ""))
        description = _display_text(model.get("description", ""))
        voice_table = data.get("voice", {})
        voices_by_id = {}
        for key, v in voice_table.items():
            vid = int(key)
            if vid < 0 or vid >= MAX_N_SPEAKERS:
                raise BeatriceError(ErrorCode.INVALID_MODEL_CONFIG, f"speaker id {vid} out of range")
            pitch = float(v["average_pitch"])
            if not math.isfinite(pitch) or not 0.0 <= pitch <= 128.0:
                raise BeatriceError(
                    ErrorCode.INVALID_MODEL_CONFIG,
                    "average_pitch must be finite and between 0 and 128",
                )
            portrait_tbl = v.get("portrait", {})
            voices_by_id[vid] = Voice(
                name=_display_text(v.get("name", "")),
                description=_display_text(v.get("description", "")),
                average_pitch=pitch,
                portrait=Portrait(
                    path=portrait_tbl.get("path", ""),
                    description=_display_text(portrait_tbl.get("description", "")),
                ),
            )
    except BeatriceError:
        raise
    except (KeyError, TypeError, ValueError) as e:
        raise BeatriceError(ErrorCode.INVALID_MODEL_CONFIG, str(e)) from e
    count = len(voices_by_id)
    if count == 0 or sorted(voices_by_id) != list(range(count)):
        raise BeatriceError(
            ErrorCode.INVALID_MODEL_CONFIG,
            "voice ids must start at zero and be contiguous",
        )
    return ModelConfig(
        version=version, name=name, description=description,
        voices=tuple(voices_by_id[i] for i in range(count)), path=path,
    )


def load_model_config(toml_path: str) -> ModelConfig:
    if not os.path.exists(toml_path):
        raise BeatriceError(ErrorCode.FILE_OPEN_ERROR, toml_path)
    with open(toml_path, "rb") as f:
        text = f.read().decode("utf-8", errors="replace")
    return parse_model_config(text, path=os.path.dirname(os.path.abspath(toml_path)))


def write_model_config(cfg: ModelConfig, toml_path: str) -> None:
    """Emit a model card (for exporting models we build/train)."""
    lines = [
        "[model]",
        f'version = "{cfg.version}"',
        f'name = "{cfg.name}"',
        f'description = "{cfg.description}"',
        "",
    ]
    for i, v in enumerate(cfg.voices):
        lines += [
            f"[voice.{i}]",
            f'name = "{v.name}"',
            f'description = "{v.description}"',
            f"average_pitch = {v.average_pitch}",
            f"[voice.{i}.portrait]",
            f'path = "{v.portrait.path}"',
            f'description = "{v.portrait.description}"',
            "",
        ]
    with open(toml_path, "w", encoding="utf-8") as f:
        f.write("\n".join(lines))
