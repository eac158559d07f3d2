"""Batched streaming runtime of the port: stream table, control staging,
the tick, offline conversion, and the serving layer (handles, the
scheduler, the model host)."""

from .controls import ControlStage, init_controls  # noqa: F401
from .engine import (  # noqa: F401
    EngineConfig,
    StreamEngine,
    apply_control_updates,
    engine_tick,
    init_engine_state,
    refresh_conditioning,
    refresh_kv_cache,
    refresh_morphed,
    reset_streams,
)
from .handle import StreamHandle  # noqa: F401
from .metrics import EngineMetrics  # noqa: F401
from .offline import ConversionSettings, build_cond, convert_utterance  # noqa: F401
from .server import StreamingServer, StreamSession  # noqa: F401
from .service import ClientSession, ModelHost  # noqa: F401
