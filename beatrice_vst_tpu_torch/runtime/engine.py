"""StreamEngine: the batched real-time tick (port of
`beatrice_vst_tpu/runtime/engine.py`, f32, per-stream conditioning).

A fixed-capacity table of streams advances together, one 10 ms tick at a
time:

    audio48 in [B, 480] -> sanitize -> input gain -> 48k->16k resample ->
    chain (phone/pitch/vocoder) -> 24k->48k resample -> output gain ->
    mute inactive -> audio48 out [B, 480]

What this port honours of the JAX engine's configuration: T = 1 frame per
tick, f32 compute, the per-stream projected K/V cache
(`kv_cache_mode="per_stream"` without int8), the per-stream VQ codebook
gather (`vq_shared_bank=False`), no morphing.  Per-stream state is kept in
the linear conv convention (no ring buffers, no tick index).

Control edits are staged on the host and applied between ticks; the
engine updates its control and state tensors in place there (the JAX
engine rebuilds them functionally), while `engine_tick` itself returns a
new state dict and leaves its input state untouched.
"""

from __future__ import annotations

import dataclasses
import heapq
import time

import numpy as np
import torch

from ..constants import COMMON_HOP_LENGTH, V20RC0, VersionSpec
from ..device import resolve_device
from ..errors import BeatriceError, ErrorCode
from ..models import chain, waveform_generator
from ..models.chain import VoiceConverterConfig
from ..models.io import params_from_numpy
from ..ops.gain import gain_process
from ..ops.resample import input_resampler_48k_to_16k, output_resampler_24k_to_48k
from ..speakers import morpher
from .controls import CONTROL_FIELDS, ControlStage, init_controls
from .metrics import EngineMetrics


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    capacity: int  # stream slots (static batch)
    model: VoiceConverterConfig

    @classmethod
    def realtime(cls, capacity: int, spec: VersionSpec = V20RC0,
                 upsampler_kernel: bool = True) -> "EngineConfig":
        """upsampler_kernel=False forces the vocoder's upsampler head onto
        its plain PyTorch version (the yardstick for the CUDA kernel)."""
        model = VoiceConverterConfig.for_version(spec)
        if not upsampler_kernel:
            model = dataclasses.replace(
                model, wg=dataclasses.replace(model.wg, upsampler_kernel=False))
        return cls(capacity=capacity, model=model)

    @property
    def spec(self) -> VersionSpec:
        return self.model.spec

    @property
    def samples_per_tick(self) -> int:
        return COMMON_HOP_LENGTH


def init_engine_state(cfg: EngineConfig, device="cpu"):
    """Zero per-stream state: chain carries, resampler histories, gain
    states, controls and the projected K/V cache."""
    b = (cfg.capacity,)
    wg = cfg.model.wg
    kv_shape = (cfg.capacity, wg.n_blocks, cfg.spec.kv_length, wg.attn_dim)
    return {
        "model": chain.init_state(cfg.model, b, device),
        "rs_in": input_resampler_48k_to_16k().init_state(b, device),
        "rs_out": output_resampler_24k_to_48k().init_state(b, device),
        "gain_in_db": torch.zeros(b, device=device),
        "gain_out_db": torch.zeros(b, device=device),
        "controls": init_controls(cfg.spec, cfg.capacity, device),
        "kv_cache": {"k": torch.zeros(kv_shape, device=device),
                     "v": torch.zeros(kv_shape, device=device)},
    }


def cast_bank(bank, device):
    """The speaker bank as f32 tensors on `device` (the port computes in
    f32 only; the JAX package's `cast_bank` also narrows to bf16/int8)."""
    return {k: v.float() for k, v in params_from_numpy(bank, device).items()}


def _build_cond(bank, state):
    """One tick's per-stream conditioning (`engine.py:225`, per-stream
    branch): additive + formant embedding, the projected K/V cache and
    each stream's own codebook."""
    c = state["controls"]
    additive, cb_idx = morpher.select_conditioning(
        bank, c["target_speaker"], c["formant_index"])
    cond = {name: c[name] for name in (
        "vq_num_neighbors", "min_q", "max_q", "average_source_pitch",
        "intonation_intensity", "pitch_shift", "pitch_correction",
        "pitch_correction_type")}
    cond["speaker_embedding"] = additive
    cond["kv_cache"] = state["kv_cache"]
    cond["codebook"] = bank["codebook"][cb_idx]
    return cond


def engine_tick(params, bank, state, audio48, *, cfg: EngineConfig):
    """One tick: [B, 480] at 48 kHz in -> ([B, 480] at 48 kHz out, new
    state) (`engine.py:331`)."""
    c = state["controls"]
    # a client feeding NaN/inf or absurd amplitudes only hurts its own
    # stream, and only for this block
    audio48 = torch.clamp(torch.nan_to_num(audio48, nan=0.0, posinf=0.0, neginf=0.0),
                          -4.0, 4.0)
    x, gain_in_db = gain_process(audio48, state["gain_in_db"], c["input_gain_db"], 48000.0)
    x16, rs_in_state = input_resampler_48k_to_16k().apply_block(x, state["rs_in"])
    cond = _build_cond(bank, state)
    y24, model_state = chain.apply(params, cfg.model, x16, state["model"], cond)
    y48, rs_out_state = output_resampler_24k_to_48k().apply_block(y24, state["rs_out"])
    y48, gain_out_db = gain_process(y48, state["gain_out_db"], c["output_gain_db"], 48000.0)
    y48 = torch.where(c["active"][:, None], y48, 0.0)
    return y48, {
        **state,
        "model": model_state,
        "rs_in": rs_in_state,
        "rs_out": rs_out_state,
        "gain_in_db": gain_in_db,
        "gain_out_db": gain_out_db,
    }


def apply_control_updates(state, updates) -> None:
    """Write staged control edits {field: (idx [K], values [K])} into the
    control tensors, in place."""
    controls = state["controls"]
    for field, (idx, values) in updates.items():
        dst = controls[field]
        dst[torch.as_tensor(idx, device=dst.device)] = torch.as_tensor(
            values, device=dst.device).to(dst.dtype)


def _zero_rows(tree, idx) -> None:
    if isinstance(tree, dict):
        for v in tree.values():
            _zero_rows(v, idx)
    elif isinstance(tree, list):
        for v in tree:
            _zero_rows(v, idx)
    else:
        tree[idx] = 0


def reset_streams(state, idx) -> None:
    """Give the streams `idx` fresh carries, in place: zero model and
    resampler state, gains at their targets; controls are kept."""
    for key in ("model", "rs_in", "rs_out"):
        _zero_rows(state[key], idx)
    c = state["controls"]
    state["gain_in_db"][idx] = c["input_gain_db"][idx]
    state["gain_out_db"][idx] = c["output_gain_db"][idx]


def refresh_kv_cache(params, bank, state, idx) -> None:
    """Re-project the speaker KV of the streams `idx` into their per-block
    K/V cache rows, in place (`engine.py:435`; speaker events only)."""
    n = bank["additive"].shape[0]
    direct = torch.clamp(state["controls"]["target_speaker"][idx], 0, n - 1)
    proj = waveform_generator.project_kv(params["wg"], bank["kv"][direct])
    for name in ("k", "v"):
        state["kv_cache"][name][idx] = proj[name]


class StreamEngine:
    """Host-side wrapper: owns params, bank and state, the stream table
    (admit/evict) and the control stage.

    Typical loop, one tick per 10 ms:
        out48 = engine.tick(in48)   # [capacity, 480] -> [capacity, 480]
    (tick flushes staged control edits first).
    """

    def __init__(self, cfg: EngineConfig, params, bank, device="cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params_from_numpy(params, self.device)
        self.bank = cast_bank(bank, self.device)
        self._n_speakers = self.bank["additive"].shape[0]
        self.state = init_engine_state(cfg, self.device)
        self.stage = ControlStage()
        # min-heap: admit() always takes the smallest free index
        self._free = list(range(cfg.capacity))
        self._pending_reset: set[int] = set()
        self._kv_dirty: set[int] = set()
        self.metrics = EngineMetrics()
        self.counters = {"admitted": 0, "evicted": 0}

    # ---- stream table ----

    def admit(self) -> int:
        """Allocate a stream slot; returns its index (raises if full).  The
        slot's carries are reset at the next flush."""
        if not self._free:
            raise RuntimeError("stream capacity exhausted")
        idx = heapq.heappop(self._free)
        self._pending_reset.add(idx)
        self._kv_dirty.add(idx)
        self.stage.stage(idx, "active", True)
        self.counters["admitted"] += 1
        return idx

    def evict(self, idx: int) -> None:
        self.stage.stage(idx, "active", False)
        heapq.heappush(self._free, idx)
        self.counters["evicted"] += 1

    # ---- controls ----

    def set_control(self, idx: int, field: str, value) -> None:
        """Stage one control edit for stream `idx`, applied at the next
        flush.  Morph controls are not ported yet, so a target speaker
        outside the bank raises."""
        if field not in CONTROL_FIELDS:
            raise KeyError(f"unknown or unported control {field!r}; "
                           f"ported: {sorted(CONTROL_FIELDS)}")
        if field == "target_speaker":
            v = int(np.asarray(value))
            if not 0 <= v < self._n_speakers:
                raise BeatriceError(
                    ErrorCode.SPEAKER_ID_OUT_OF_RANGE,
                    f"target_speaker {v} outside [0, {self._n_speakers}); "
                    "morph mode is not ported yet")
            self._kv_dirty.add(int(idx))
        self.stage.stage(idx, field, value)

    def flush_controls(self) -> None:
        """Apply staged edits, reset admitted slots and refresh the K/V
        cache of streams whose speaker changed."""
        if self.stage.pending():
            apply_control_updates(self.state, self.stage.drain())
        if self._pending_reset:
            idx = torch.as_tensor(sorted(self._pending_reset), device=self.device)
            reset_streams(self.state, idx)
            self._pending_reset.clear()
        if self._kv_dirty:
            idx = torch.as_tensor(sorted(self._kv_dirty), device=self.device)
            refresh_kv_cache(self.params, self.bank, self.state, idx)
            self._kv_dirty.clear()

    # ---- the tick ----

    def tick(self, audio48_in) -> torch.Tensor:
        """audio48_in: [capacity, 480] (numpy or tensor) -> [capacity, 480]
        on the engine's device."""
        x = torch.as_tensor(audio48_in, dtype=torch.float32, device=self.device)
        expect = (self.cfg.capacity, self.cfg.samples_per_tick)
        if tuple(x.shape) != expect:
            raise ValueError(f"tick input shape {tuple(x.shape)}, expected {expect}")
        self.flush_controls()
        t0 = time.perf_counter()
        out, self.state = engine_tick(self.params, self.bank, self.state, x, cfg=self.cfg)
        self.metrics.record_tick(time.perf_counter() - t0, self.n_active)
        return out

    def metrics_snapshot(self) -> dict:
        return {**self.metrics.snapshot(self.n_active), **self.counters}

    @property
    def n_active(self) -> int:
        return self.cfg.capacity - len(self._free)
