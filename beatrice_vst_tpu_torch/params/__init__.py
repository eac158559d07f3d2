"""Parameter/config system: typed schema registry with coupled-update
semantics, binary-compatible parameter state persistence, model-card TOML
parsing, and the processor/controller proxies.

A copy of `beatrice_vst_tpu/params/__init__.py` (the port imports nothing of the
JAX package).
"""

from .model_config import (  # noqa: F401
    ModelConfig,
    Portrait,
    Voice,
    load_model_config,
    parse_model_config,
    write_model_config,
)
from .proxy import Controller, NullCore, ProcessorProxy  # noqa: F401
from .schema import (  # noqa: F401
    SCHEMA,
    ControllerCore,
    CoreInterface,
    ListParameter,
    NumberParameter,
    ParameterFlag,
    ParameterID,
    StringParameter,
    build_schema,
    is_voice_morph_parameter,
)
from .state import ParameterState  # noqa: F401
from .voice_morph import (  # noqa: F401
    VoiceMorphStateParams,
    get_voice_morph_parameter_values,
    get_voice_morph_state,
)
