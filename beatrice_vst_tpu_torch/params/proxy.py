"""ProcessorProxy: owns the authoritative ParameterState + the active core.

Reimplements the semantics of
`src/common/processor_proxy.{h,cc}`: version dispatch on
the model card's version string, full parameter replay into a freshly
constructed core on every model (re)load (`SyncAllParameters`,
processor_proxy.cc:44-56), and state restore as deserialize + replay
(processor_proxy.cc:58-63).

The core is produced by a `core_factory(model_config) -> CoreInterface`
so the same proxy drives an offline converter core or a live stream handle
of the batched runtime engine.

A copy of `beatrice_vst_tpu/params/proxy.py` (the port imports nothing of the
JAX package).
"""

from __future__ import annotations

import io

from ..errors import BeatriceError, ErrorCode
from .model_config import load_model_config
from .schema import SCHEMA, ParameterID
from .state import ParameterState


class NullCore:
    """Unloaded core: every call succeeds and does nothing
    (ProcessorCoreUnloaded, processor_core.h:95-104)."""

    def __getattr__(self, name):
        if name.startswith("set_") or name == "load_model":
            return lambda *a, **k: ErrorCode.SUCCESS
        raise AttributeError(name)


class ProcessorProxy:
    def __init__(self, core_factory, sample_rate: float = 48000.0, schema=None):
        self.schema = schema or SCHEMA
        self.core_factory = core_factory
        self.core = NullCore()
        self.sample_rate = sample_rate
        self.parameter_state = ParameterState()
        self.parameter_state.set_default_values(self.schema)
        self.model_config = None

    # ---- parameter routing (processor_proxy.h:41-44) ----

    def set_parameter(self, param_id, value) -> ErrorCode:
        self.parameter_state.set_value(param_id, value)
        return self.sync_parameter(param_id)

    def sync_parameter(self, param_id) -> ErrorCode:
        param = self.schema.get(int(param_id))
        if param is None:
            return ErrorCode.UNKNOWN_ERROR
        value = self.parameter_state.get_value(param_id)
        if param.processor_set is None:
            return ErrorCode.SUCCESS
        return param.processor_set(self, value)

    def sync_all_parameters(self) -> ErrorCode:
        """Replay every parameter into the core except Model itself
        (processor_proxy.cc:44-56)."""
        err = ErrorCode.SUCCESS
        for pid, _ in sorted(self.schema.items()):
            if pid == int(ParameterID.MODEL):
                continue
            e = self.sync_parameter(pid)
            if err == ErrorCode.SUCCESS and e != ErrorCode.SUCCESS:
                err = e
        return err

    # ---- model lifecycle (processor_proxy.h:45-100) ----

    def load_model(self, toml_path: str) -> ErrorCode:
        if not toml_path:
            return ErrorCode.SUCCESS
        try:
            config = load_model_config(str(toml_path))
        except BeatriceError as e:
            return e.code
        if config.version_int < 0:
            return ErrorCode.INVALID_MODEL_CONFIG
        try:
            core = self.core_factory(config)
        except BeatriceError as e:
            return e.code
        err = core.load_model(config, str(toml_path))
        if err != ErrorCode.SUCCESS:
            return err
        core.set_sample_rate(self.sample_rate)
        self.core = core
        self.model_config = config
        return self.sync_all_parameters()

    def set_sample_rate(self, sample_rate: float) -> ErrorCode:
        self.sample_rate = sample_rate
        return self.core.set_sample_rate(sample_rate)

    # ---- persistence (processor_proxy + processor.cc:233-268) ----

    def write_state(self, stream) -> ErrorCode:
        self.parameter_state.write(stream)
        return ErrorCode.SUCCESS

    def read_state(self, stream) -> ErrorCode:
        """Deserialize + full replay, including model reload via the Model
        parameter (processor_proxy.cc:58-63)."""
        self.parameter_state.read_or_set_default(stream, self.schema)
        model_path = self.parameter_state.get_value(ParameterID.MODEL)
        err = ErrorCode.SUCCESS
        if model_path:
            err = self.load_model(model_path)
        else:
            err = self.sync_all_parameters()
        return err

    def state_bytes(self) -> bytes:
        buf = io.BytesIO()
        self.write_state(buf)
        return buf.getvalue()

    def restore_state_bytes(self, data: bytes) -> ErrorCode:
        return self.read_state(io.BytesIO(data))


class Controller:
    """UI-side parameter logic (ControllerCore + kSchema
    controller_set lambdas).  Feed it user edits; drain
    `pop_updated_parameters()` for the coupled updates to propagate to the
    processor side (the reference does this through host automation,
    editor.cc:1270-1291)."""

    def __init__(self, schema=None):
        from .schema import ControllerCore

        self.schema = schema or SCHEMA
        self.parameter_state = ParameterState()
        self.parameter_state.set_default_values(self.schema)
        self.core = ControllerCore(self.parameter_state)

    def set_parameter(self, param_id, value) -> ErrorCode:
        param = self.schema.get(int(param_id))
        if param is None:
            return ErrorCode.UNKNOWN_ERROR
        self.parameter_state.set_value(param_id, value)
        if param.controller_set is None:
            return ErrorCode.SUCCESS
        return param.controller_set(self.core, value)

    def pop_updated_parameters(self):
        out = [(pid, self.parameter_state.get_value(pid))
               for pid in self.core.updated_parameters]
        self.core.updated_parameters.clear()
        return out
