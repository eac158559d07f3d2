"""StreamEngine: the batched tick (port of
`beatrice_vst_tpu/runtime/engine.py`).

A fixed-capacity table of streams advances together, T = frames_per_tick
10 ms frames per tick (T = 1 is the real-time tick; a tick of T > 1
frames is the chunk path that offline conversion and the parity harness
run):

    audio48 in [B, T*480] -> sanitize -> input gain -> 48k->16k resample ->
    chain (phone/pitch/vocoder) -> 24k->48k resample -> output gain ->
    mute inactive -> audio48 out [B, T*480]

It runs the three model versions: 2.0.0-rc.0, and 2.0.0-alpha.2 and
2.0.0-beta.1, which have no K/V and no VQ conditioning.
`EngineConfig` has the JAX engine's fields, names and defaults.  What
this port honours of them:
  * compute_dtype None (f32) or "bfloat16": activations and conv carries
    in bf16, products summed in f32; resamplers, gains, mel front ends,
    pitch logits and the source phase stay f32.
  * kv_cache_mode "slots" (the default: the bank's speakers projected once
    into a shared slot bank read through one-hot contractions, plus
    n_morph_slots zero slots for morphing) or "per_stream" (a projected
    K/V cache per stream); with a compute dtype and quantize_kv_cache,
    int8 with per-row scales (and int8 contractions in slots mode).
  * vq_shared_bank None (shared while T = 1 and the bank has at most
    vq_shared_max_speakers speakers), True or False; with a compute dtype
    and quantize_conditioning, an int8 codebook with per-row scales.
Not ported yet: morphing (morph-slot leasing, `refresh_kv_slots`, the
morph controls and `frame_counter`).  A target speaker outside the bank
raises.  Per-stream state is kept in the linear conv convention (no ring
buffers, no tick index).

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
from ..models.layers import quantize_rows
from ..ops.gain import gain_process
from ..ops.resample import input_resampler_48k_to_16k, output_resampler_24k_to_48k
from ..speakers import morpher
from .controls import CONTROL_FIELDS, ControlStage, init_controls
from .metrics import EngineMetrics

KV_CACHE_MODES = ("slots", "per_stream")


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    capacity: int  # stream slots (static batch)
    model: VoiceConverterConfig
    frames_per_tick: int = 1  # T; 1 = real-time 10 ms ticks
    compute_dtype: str | None = None  # None (f32) or "bfloat16"
    # int8 VQ codebooks with per-row scales (only with compute_dtype)
    quantize_conditioning: bool = True
    # int8 K/V: the per-stream cache, or the slot bank and its contractions
    # (only with compute_dtype)
    quantize_kv_cache: bool = True
    kv_cache_mode: str = "slots"  # "slots" or "per_stream"
    n_morph_slots: int = 16
    # shared-bank VQ: None = on while T = 1 and the bank has at most
    # vq_shared_max_speakers speakers; True/False forces
    vq_shared_bank: bool | None = None
    vq_shared_max_speakers: int = 128

    def __post_init__(self):
        if self.kv_cache_mode not in KV_CACHE_MODES:
            raise ValueError(f"kv_cache_mode {self.kv_cache_mode!r}, expected one of "
                             f"{KV_CACHE_MODES}")
        if self.compute_dtype not in (None, "bfloat16"):
            raise ValueError(f"compute_dtype {self.compute_dtype!r}: the port computes in "
                             "float32 (None) or bfloat16")
        if self.frames_per_tick < 1:
            raise ValueError(f"frames_per_tick {self.frames_per_tick} < 1")

    @classmethod
    def realtime(cls, capacity: int, spec: VersionSpec = V20RC0,
                 upsampler_kernel: bool = True, **kw) -> "EngineConfig":
        """The real-time engine; `kw` sets the other fields.
        upsampler_kernel=False forces the vocoder's upsampler head onto its
        plain PyTorch version (the yardstick for the CUDA kernel)."""
        model = VoiceConverterConfig.for_version(spec)
        if not upsampler_kernel:
            model = dataclasses.replace(
                model, wg=dataclasses.replace(model.wg, upsampler_kernel=False))
        return cls(capacity=capacity, model=model, **kw)

    @property
    def spec(self) -> VersionSpec:
        return self.model.spec

    @property
    def samples_per_tick(self) -> int:
        return self.frames_per_tick * COMMON_HOP_LENGTH

    @property
    def dtype(self):
        """The compute dtype as a torch dtype, or None for f32."""
        return getattr(torch, self.compute_dtype) if self.compute_dtype else None

    def use_shared_vq(self, n_speakers: int) -> bool:
        """Whether the VQ reads the shared bank (`engine.py:304-315`),
        decided on the host from the config and the bank's size: by
        default only at T = 1 (a chunk gathers each stream's codebook)."""
        if self.vq_shared_bank is not None:
            return self.vq_shared_bank
        return self.frames_per_tick == 1 and n_speakers <= self.vq_shared_max_speakers


def _cast_activation_state(model_state, dtype):
    """The chain's floating carries in `dtype`; raw-audio histories, the
    source phase and the noise counter keep theirs (`engine.py:106`)."""

    def walk(tree, keep):
        if isinstance(tree, dict):
            return {k: walk(v, keep or k in ("audio", "phase", "noise_counter"))
                    for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v, keep) for v in tree]
        if keep or not tree.is_floating_point():
            return tree
        return tree.to(dtype)

    return walk(model_state, False)


def _kv_tensors(shape, quantized, dtype, device):
    """Zero K/V of `shape`: int8 with unit per-row scales, or `dtype`."""
    if quantized:
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.ones((*shape[:-1], 1), device=device),
                "v_scale": torch.ones((*shape[:-1], 1), device=device)}
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def init_engine_state(cfg: EngineConfig, device="cuda"):
    """Zero per-stream state on `device` (the card unless the caller asks
    for the CPU): chain carries (in the compute dtype), resampler
    histories, gain states, controls, and for a version with K/V the K/V
    of the config's mode -- the morph slots of the slot bank, or the
    per-stream projected cache (`engine.py:125`)."""
    device = resolve_device(device)
    b = (cfg.capacity,)
    wg = cfg.model.wg
    model_state = chain.init_state(cfg.model, b, device)
    cond_dtype = torch.float32
    if cfg.dtype is not None:
        model_state = _cast_activation_state(model_state, cfg.dtype)
        cond_dtype = cfg.dtype
    state = {
        "model": model_state,
        "rs_in": input_resampler_48k_to_16k(cfg.frames_per_tick).init_state(b, device),
        "rs_out": output_resampler_24k_to_48k(cfg.frames_per_tick).init_state(b, device),
        "gain_in_db": torch.zeros(b, device=device),
        "gain_out_db": torch.zeros(b, device=device),
        "controls": init_controls(cfg.spec, cfg.capacity, device),
    }
    if not cfg.spec.has_kv:
        return state
    quantized = cfg.quantize_kv_cache and cfg.dtype is not None
    rows = cfg.n_morph_slots if cfg.kv_cache_mode == "slots" else cfg.capacity
    kv = _kv_tensors((rows, wg.n_blocks, cfg.spec.kv_length, wg.attn_dim), quantized,
                     cond_dtype, device)
    state["kv_slots" if cfg.kv_cache_mode == "slots" else "kv_cache"] = kv
    return state


def cast_params(params, dtype):
    """The parameters with every matmul weight (`w`) and the pitch
    embedding in `dtype`, the rest unchanged.  The JAX package rounds
    these to the compute dtype where it reads them; rounding them once
    gives the same values and saves a cast per product."""
    if dtype is None:
        return params

    def walk(node, key=None):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        return node.to(dtype) if key in ("w", "pitch_emb") else node

    return walk(params)


def cast_bank(bank, dtype=None, quantize_codebook: bool = False, device="cuda"):
    """The speaker bank as tensors on `device` (`engine.py:205`): f32, or
    with a compute dtype its floating tensors in it; with
    quantize_codebook the VQ codebooks are int8 with per-row scales
    (`codebook_scale`), quantized from the f32 values."""
    bank = {k: v.float() for k, v in params_from_numpy(bank, device).items()}
    if dtype is None:
        return bank
    out = {k: v.to(dtype) for k, v in bank.items()}
    if quantize_codebook and "codebook" in bank:
        out["codebook"], out["codebook_scale"] = quantize_rows(bank["codebook"])
    return out


def _build_cond(cfg: EngineConfig, bank, state):
    """One tick's per-stream conditioning (`engine.py:225`): additive +
    formant embedding (f32) and, for 2.0.0-rc.0, the K/V of the config's
    mode and the VQ codebook route (shared bank or per-stream gather)."""
    c = state["controls"]
    additive, cb_idx = morpher.select_conditioning(
        bank, c["target_speaker"], c["formant_index"])
    cond = {name: c[name] for name in (
        "vq_num_neighbors", "min_q", "max_q", "average_source_pitch",
        "intonation_intensity", "pitch_shift", "pitch_correction",
        "pitch_correction_type")}
    cond["speaker_embedding"] = additive
    if "kv_slots" in state:  # (no K/V state without attention)
        slots = state["kv_slots"]
        cond["kv_bank"] = {name: torch.cat([bank[f"kv_proj_{name}"], slots[name]])
                           for name in slots}
        n = bank["additive"].shape[0]
        target = c["target_speaker"]
        cond["kv_slot"] = torch.where(target >= n, c["kv_slot"], torch.clamp(target, 0, n - 1))
    elif "kv_cache" in state:
        cond["kv_cache"] = state["kv_cache"]
    if not cfg.spec.has_vq:
        return cond
    if cfg.use_shared_vq(bank["codebook"].shape[0]):
        cond["codebook_bank"] = bank["codebook"]
        cond["codebook_idx"] = cb_idx
        if "codebook_scale" in bank:
            cond["codebook_bank_scale"] = bank["codebook_scale"]
    else:
        cond["codebook"] = bank["codebook"][cb_idx]
        if "codebook_scale" in bank:
            cond["codebook_scale"] = bank["codebook_scale"][cb_idx]
    return cond


def engine_tick(params, bank, state, audio48, *, cfg: EngineConfig):
    """One tick: [B, T*480] at 48 kHz in -> ([B, T*480] at 48 kHz out, new
    state) (`engine.py:331`).  params and bank as `StreamEngine` holds
    them (`cast_params` and `prepare_bank`)."""
    c = state["controls"]
    # a client feeding NaN/inf or absurd amplitudes only hurts its own
    # stream, and only for this block
    audio48 = torch.clamp(torch.nan_to_num(audio48, nan=0.0, posinf=0.0, neginf=0.0),
                          -4.0, 4.0)
    x, gain_in_db = gain_process(audio48, state["gain_in_db"], c["input_gain_db"], 48000.0)
    t = cfg.frames_per_tick
    x16, rs_in_state = input_resampler_48k_to_16k(t).apply_block(x, state["rs_in"])
    cond = _build_cond(cfg, bank, state)
    y24, model_state = chain.apply(params, cfg.model, x16, state["model"], cond, cfg.dtype)
    y48, rs_out_state = output_resampler_24k_to_48k(t).apply_block(y24, state["rs_out"])
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


def _store_kv(dst, idx, proj) -> None:
    """Write projected K/V {"k", "v"} into rows `idx` of a K/V dict, in
    place: quantized per row where it holds int8 with scales."""
    for name in ("k", "v"):
        if f"{name}_scale" in dst:
            dst[name][idx], dst[f"{name}_scale"][idx] = quantize_rows(proj[name])
        else:
            dst[name][idx] = proj[name].to(dst[name].dtype)


def refresh_kv_cache(params, bank, state, idx, compute_dtype=None) -> None:
    """Re-project the speaker KV of the streams `idx` into their per-block
    K/V cache rows, in place (`engine.py:435`; per-stream mode, speaker
    events only)."""
    n = bank["additive"].shape[0]
    direct = torch.clamp(state["controls"]["target_speaker"][idx], 0, n - 1)
    proj = waveform_generator.project_kv(params["wg"], bank["kv"][direct], compute_dtype)
    _store_kv(state["kv_cache"], idx, proj)


def project_base_speakers(params, bank, cfg: EngineConfig) -> dict:
    """The bank's speakers projected once into the slot bank's base rows
    (`engine.py:616-640`): {"kv_proj_k", "kv_proj_v"} [S, n_blocks, L, A]
    in the compute dtype (or f32), or int8 with `kv_proj_{k,v}_scale`."""
    proj = waveform_generator.project_kv(params["wg"], bank["kv"], cfg.dtype)
    out = {}
    for name in ("k", "v"):
        if cfg.quantize_kv_cache and cfg.dtype is not None:
            out[f"kv_proj_{name}"], out[f"kv_proj_{name}_scale"] = quantize_rows(proj[name])
        else:
            out[f"kv_proj_{name}"] = proj[name].to(cfg.dtype or torch.float32)
    return out


def prepare_bank(cfg: EngineConfig, params, bank, device="cuda") -> dict:
    """The speaker bank as the tick reads it (`engine.py:623-640`): cast by
    `cast_bank` and, in slots mode for a version with K/V, with the bank's
    speakers projected by `project_base_speakers`.  params as
    `cast_params` gives them."""
    out = cast_bank(bank, cfg.dtype, cfg.quantize_conditioning and cfg.dtype is not None,
                    device)
    if cfg.kv_cache_mode == "slots" and cfg.spec.has_kv:
        out.update(project_base_speakers(params, out, cfg))
    return out


class StreamEngine:
    """Host-side wrapper: owns params, bank and state, the stream table
    (admit/evict) and the control stage.

    Typical loop, one tick per T * 10 ms:
        out48 = engine.tick(in48)   # [capacity, T*480] -> [capacity, T*480]
    (tick flushes staged control edits first).
    """

    def __init__(self, cfg: EngineConfig, params, bank, device="cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = cast_params(params_from_numpy(params, self.device), cfg.dtype)
        self.bank = prepare_bank(cfg, self.params, bank, self.device)
        self._slots_mode = cfg.kv_cache_mode == "slots" and cfg.spec.has_kv
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
        if self._slots_mode:
            self.stage.stage(idx, "kv_slot", 0)
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
        """Apply staged edits, reset admitted slots and, in per-stream
        mode for a version with K/V, refresh the K/V cache of streams
        whose speaker changed (in slots mode a direct speaker's slot
        follows target_speaker inside the tick)."""
        if self.stage.pending():
            apply_control_updates(self.state, self.stage.drain())
        if self._pending_reset:
            idx = torch.as_tensor(sorted(self._pending_reset), device=self.device)
            reset_streams(self.state, idx)
            self._pending_reset.clear()
        if self._kv_dirty and "kv_cache" in self.state:
            idx = torch.as_tensor(sorted(self._kv_dirty), device=self.device)
            refresh_kv_cache(self.params, self.bank, self.state, idx, self.cfg.dtype)
        self._kv_dirty.clear()

    # ---- the tick ----

    def tick(self, audio48_in) -> torch.Tensor:
        """audio48_in: [capacity, T*480] (numpy or tensor) -> [capacity,
        T*480] on the engine's device."""
        x = torch.as_tensor(audio48_in, dtype=torch.float32, device=self.device)
        expect = (self.cfg.capacity, self.cfg.samples_per_tick)
        if tuple(x.shape) != expect:
            raise ValueError(f"tick input shape {tuple(x.shape)}, expected {expect}")
        self.flush_controls()
        t0 = time.perf_counter()
        out, self.state = engine_tick(self.params, self.bank, self.state, x, cfg=self.cfg)
        self.metrics.record_tick(time.perf_counter() - t0, self.n_active,
                                 self.cfg.frames_per_tick)
        return out

    def metrics_snapshot(self) -> dict:
        return {**self.metrics.snapshot(self.n_active), **self.counters}

    @property
    def n_active(self) -> int:
        return self.cfg.capacity - len(self._free)
