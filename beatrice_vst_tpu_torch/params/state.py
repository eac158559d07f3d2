"""Parameter state: typed values + binary (de)serialization.

Byte-compatible with the reference's persistence format
(`src/common/parameter_state.cc:68-147`): a stream of
``[id:int16][type_index:int32][payload]`` records, little-endian, where
type_index 0 = int32, 1 = float64, 2 = length-prefixed UTF-8 string.
This is the plugin's *entire* persistence format, so keeping it bit-exact
means session state can move between the VST and this framework.

A copy of `beatrice_vst_tpu/params/state.py` (the port imports nothing of the
JAX package).
"""

from __future__ import annotations

import io
import struct

from ..errors import BeatriceError, ErrorCode


class ParameterState:
    """Mapping ParameterID(int) -> int | float | str with binary IO."""

    def __init__(self):
        self._values: dict[int, int | float | str] = {}

    def set_value(self, param_id: int, value) -> None:
        if not isinstance(value, (int, float, str)):
            raise TypeError(f"unsupported parameter type {type(value)}")
        if isinstance(value, bool):
            value = int(value)
        self._values[int(param_id)] = value

    def get_value(self, param_id: int):
        return self._values[int(param_id)]

    def __contains__(self, param_id) -> bool:
        return int(param_id) in self._values

    def items(self):
        return self._values.items()

    def copy(self) -> "ParameterState":
        s = ParameterState()
        s._values = dict(self._values)
        return s

    def set_default_values(self, schema) -> None:
        for pid, param in schema.items():
            self.set_value(pid, param.default_value)

    # ---- binary format (parameter_state.cc:68-147) ----

    def write(self, stream: io.RawIOBase) -> None:
        for pid, value in sorted(self._values.items()):
            if isinstance(value, int):
                stream.write(struct.pack("<hi", pid, 0))
                stream.write(struct.pack("<i", value))
            elif isinstance(value, float):
                stream.write(struct.pack("<hi", pid, 1))
                stream.write(struct.pack("<d", value))
            else:
                raw = value.encode("utf-8")
                stream.write(struct.pack("<hi", pid, 2))
                stream.write(struct.pack("<i", len(raw)))
                stream.write(raw)

    def read(self, stream: io.RawIOBase) -> None:
        while True:
            head = stream.read(6)
            if len(head) == 0:
                return
            if len(head) < 6:
                raise BeatriceError(ErrorCode.FILE_TOO_SMALL, "truncated record header")
            pid, type_index = struct.unpack("<hi", head)
            if type_index == 0:
                raw = stream.read(4)
                if len(raw) < 4:
                    raise BeatriceError(ErrorCode.FILE_TOO_SMALL, "truncated int")
                self.set_value(pid, struct.unpack("<i", raw)[0])
            elif type_index == 1:
                raw = stream.read(8)
                if len(raw) < 8:
                    raise BeatriceError(ErrorCode.FILE_TOO_SMALL, "truncated double")
                self.set_value(pid, struct.unpack("<d", raw)[0])
            elif type_index == 2:
                raw = stream.read(4)
                if len(raw) < 4:
                    raise BeatriceError(ErrorCode.FILE_TOO_SMALL, "truncated length")
                (siz,) = struct.unpack("<i", raw)
                if siz < 0:
                    raise BeatriceError(ErrorCode.INVALID_FILE_SIZE, "negative string size")
                data = stream.read(siz)
                if len(data) < siz:
                    raise BeatriceError(ErrorCode.FILE_TOO_SMALL, "truncated string")
                self.set_value(pid, data.decode("utf-8", errors="replace"))
            else:
                raise BeatriceError(ErrorCode.UNKNOWN_ERROR, f"bad type index {type_index}")

    def read_or_set_default(self, stream, schema) -> None:
        """Defaults first, then overlay the stream
        (parameter_state.cc:119-125)."""
        self._values.clear()
        self.set_default_values(schema)
        self.read(stream)

    def to_bytes(self) -> bytes:
        buf = io.BytesIO()
        self.write(buf)
        return buf.getvalue()

    @classmethod
    def from_bytes(cls, data: bytes, schema=None) -> "ParameterState":
        s = cls()
        if schema is not None:
            s.set_default_values(schema)
        s.read(io.BytesIO(data))
        return s
