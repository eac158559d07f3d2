"""ModelHost: the deployment control plane (model load/swap + sessions);
port of `beatrice_vst_tpu/runtime/service.py`.

Reference semantics being reproduced (SURVEY.md 3.2): a model (re)load
happens off the audio thread while processing emits silence
(`src/vst/processor.cc:129-141`), the new core is constructed, weights
loaded, and then *every* parameter is replayed into it
(`ProcessorProxy::SyncAllParameters`, processor_proxy.cc:44-56).

Batched equivalent: a ModelHost owns one StreamEngine + StreamingServer
for the currently loaded model.  `load_model()` builds the new engine,
re-opens every client session on it, rebinds each session's parameter
proxy (schema replay restores all per-stream controls), and swaps
atomically.  Client sessions keep their identity and parameter state;
in-flight audio during the swap is dropped (silence), matching the
reference's behavior.  The new engine is built while the old one still
ticks, so on the card both engines' memory is resident for that moment.

The port's ModelHost takes the JAX one's `jit` flag (default True: each
engine ticks with donated state, on CUDA by replaying the CUDA graph it
captures in `load_model`, off the scheduler's tick) and a `device`
(default "cuda"; "cpu" only when asked), and hands both to each
StreamEngine it builds.
"""

from __future__ import annotations

import os
import threading

from ..device import resolve_device
from ..errors import BeatriceError, ErrorCode
from ..models.io import load_model_dir
from ..params import ParameterID, ProcessorProxy
from .engine import EngineConfig, StreamEngine
from .handle import StreamHandle
from .server import StreamingServer


class ClientSession:
    """One client: audio session + full parameter surface (proxy)."""

    def __init__(self, host: "ModelHost", session_id: int, sample_rate: float):
        self.host = host
        self.session_id = session_id
        self.sample_rate = sample_rate
        self.stream = None  # StreamSession on the current server
        self.proxy = ProcessorProxy(self._core_factory)

    def _core_factory(self, config):
        return StreamHandle(self.host.engine, self.stream.idx)

    # -- client API --

    def set_parameter(self, param_id, value) -> ErrorCode:
        if int(param_id) == int(ParameterID.MODEL):
            # model loads route through the host (engine-level swap)
            return self.host.load_model(str(value), initiator=self)
        return self.proxy.set_parameter(param_id, value)

    def push(self, audio):
        self.stream.push(audio)

    def pull(self, n):
        return self.stream.pull(n)

    def state_bytes(self) -> bytes:
        return self.proxy.state_bytes()

    def restore_state_bytes(self, blob: bytes) -> ErrorCode:
        return self.proxy.restore_state_bytes(blob)

    def close(self):
        self.host.close_session(self)


class ModelHost:
    def __init__(self, capacity: int, compute_dtype: str | None = None,
                 realtime: bool = True, jit: bool = True,
                 frames_per_tick: int = 1, pipeline: bool = False, device="cuda"):
        self.capacity = capacity
        self.compute_dtype = compute_dtype
        self.realtime = realtime
        self.jit = jit
        self.device = resolve_device(device)
        # frames_per_tick > 1 trades latency for per-tick host work: each
        # scheduler tick moves frames_per_tick * 10 ms of audio.
        # pipeline=True overlaps the copy to the host of tick t-1 with the
        # device work of tick t (one extra tick of latency).
        self.frames_per_tick = frames_per_tick
        self.pipeline = pipeline
        self.engine: StreamEngine | None = None
        self.server: StreamingServer | None = None
        self.model_config = None
        self.model_dir: str | None = None  # portrait files resolve here
        self.sessions: dict[int, ClientSession] = {}
        self._next_id = 0
        self._lock = threading.Lock()

    @property
    def loaded(self) -> bool:
        return self.engine is not None

    def open_session(self, sample_rate: float = 48000.0) -> ClientSession:
        with self._lock:
            s = ClientSession(self, self._next_id, sample_rate)
            self._next_id += 1
            self.sessions[s.session_id] = s
            if self.server is not None:
                s.stream = self.server.open_session(sample_rate)
                self._bind(s)
            return s

    def _replay_all_sessions(self) -> None:
        """Post-recovery control-plane replay (StreamingServer.on_recover):
        push every live session's authoritative ParameterState back into
        the rebuilt engine -- the same restore-by-replay mechanism as
        state loading (processor_proxy.cc:58-63)."""
        with self._lock:
            for s in self.sessions.values():
                if s.stream is not None:
                    s.proxy.sync_all_parameters()

    def _bind(self, s: ClientSession) -> None:
        """(Re)bind the proxy to the live engine and replay parameters."""
        s.proxy.core = StreamHandle(self.engine, s.stream.idx)
        if self.model_config is not None:
            s.proxy.core.model_config = self.model_config
        s.proxy.sync_all_parameters()

    def close_session(self, s: ClientSession) -> None:
        with self._lock:
            self.sessions.pop(s.session_id, None)
            if s.stream is not None:
                s.stream.close()
                s.stream = None

    def load_model(self, model_path: str, initiator: ClientSession | None = None
                   ) -> ErrorCode:
        """Build the new engine off the tick thread, then swap + replay."""
        try:
            config, model_cfg, params, bank = load_model_dir(model_path)
        except BeatriceError as e:
            return e.code
        cfg = EngineConfig(
            capacity=self.capacity, model=model_cfg,
            compute_dtype=self.compute_dtype,
            frames_per_tick=self.frames_per_tick,
        )
        new_engine = StreamEngine(cfg, params, bank, device=self.device, jit=self.jit)
        new_server = StreamingServer(new_engine, realtime=self.realtime,
                                     pipeline=self.pipeline)
        new_server.on_recover(self._replay_all_sessions)

        # stop the old scheduler BEFORE taking the lock: its thread may be
        # inside a recovery replay (_replay_all_sessions) that needs
        # self._lock, and stop() joins that thread -- classic deadlock
        old_server = self.server
        if old_server is not None:
            old_server.stop()
        with self._lock:
            self.engine = new_engine
            self.server = new_server
            self.model_config = config
            self.model_dir = str(model_path)
            if initiator is not None:
                initiator.proxy.parameter_state.set_value(
                    ParameterID.MODEL, str(model_path)
                )
            for s in self.sessions.values():
                s.stream = new_server.open_session(s.sample_rate)
                self._bind(s)
            if self.realtime:
                new_server.start()
        return ErrorCode.SUCCESS

    def tick_once(self):
        """Manual scheduler tick (when realtime=False)."""
        if self.server is not None:
            self.server.tick_once()

    def metrics(self) -> dict:
        return self.server.metrics() if self.server else {}

    def describe(self) -> dict:
        """Model metadata for clients (the demo page's voice selector)."""
        c = self.model_config
        if c is None:
            return {"loaded": False}
        return {
            "loaded": True,
            "name": c.name,
            "description": c.description,
            "version": c.version,
            "voices": [
                {"id": i, "name": v.name or f"voice {i}",
                 "description": v.description,
                 # the reference editor loads each voice's portrait from
                 # the model card (editor.cc:1005-1188); clients fetch
                 # the bytes from GET /portrait/<id> when has_portrait
                 "has_portrait": self._portrait_path(i) is not None,
                 "portrait_description": v.portrait.description}
                for i, v in enumerate(c.voices)
            ],
            "capacity": self.capacity,
            "frames_per_tick": self.frames_per_tick,
        }

    def _portrait_path(self, voice_id: int) -> str | None:
        """Resolve a voice's portrait file inside the model dir, or None.

        The model card's portrait path resolves inside the model dir only
        (a card is untrusted input -- ../ traversal must not escape, the
        same stance as the NUL/URL scrubbing in model_config.py)."""
        c = self.model_config
        if c is None or self.model_dir is None:
            return None
        if not (0 <= voice_id < len(c.voices)):
            return None
        rel = c.voices[voice_id].portrait.path
        if not rel:
            return None
        base = os.path.realpath(self.model_dir)
        full = os.path.realpath(os.path.join(base, rel))
        if not full.startswith(base + os.sep) or not os.path.isfile(full):
            return None
        return full

    def portrait_bytes(self, voice_id: int) -> tuple[bytes, str] | None:
        """Portrait image for a voice -> (bytes, mime) or None.

        The service's counterpart of the reference editor's portrait
        loading (src/vst/editor.cc:1005-1188): the server
        ships the original bytes and the client scales them (no server-
        side resize -- browsers do it better)."""
        full = self._portrait_path(voice_id)
        if full is None:
            return None
        ext = os.path.splitext(full)[1].lower()
        mime = {".png": "image/png", ".jpg": "image/jpeg",
                ".jpeg": "image/jpeg", ".webp": "image/webp",
                ".gif": "image/gif"}.get(ext, "application/octet-stream")
        with open(full, "rb") as f:
            return f.read(), mime

    def stop(self):
        # outside the lock, as in load_model: the scheduler may be inside a
        # recovery replay that takes it
        server = self.server
        if server is not None:
            server.stop()
