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
  * morphing: a target speaker >= the bank's speaker count is morph mode,
    conditioned on the spherical averages of its morph speakers'
    embeddings (`refresh_morphed`, recomputed when its morph controls
    change; the K/V average kept in the compute dtype) and, every tick,
    a codebook lottery driven by the per-stream `frame_counter`.  In slots
    mode a morph stream leases one of n_morph_slots slot-bank rows for its
    projected K/V and, when none is free, reads its dominant morph
    speaker's base row instead; in per-stream mode its K/V cache row
    holds the projected average.
  * `StreamEngine.recover()` rebuilds the state and replays every
    control set through `set_control`.
Per-stream state is kept in the linear conv convention (no ring buffers,
no tick index).

Control edits are staged on the host and applied between ticks; the
engine updates its control and state tensors in place there (the JAX
engine rebuilds them functionally), while `engine_tick` itself returns a
new state dict and leaves its input state untouched.

`StreamEngine(..., jit=True)` (the default, as in the JAX engine) ticks
with donated state, the counterpart of the JAX engine's
`jax.jit(engine_tick, donate_argnums=(2,))`: `donated_tick` writes the new
state into the tensors it was given.  On CUDA the engine captures one
donated tick in a `torch.cuda.CUDAGraph` when it is built, over static
tensors (its state, an input and an output), and each tick replays it:
three host launches (copy in, replay, copy out) in place of about a
thousand.  On the CPU, where CUDA graphs do not exist, it runs the
donated tick op by op.  `jit=False` ticks `engine_tick` op by op and
rebinds the state, the yardstick of both.
"""

from __future__ import annotations

import dataclasses
import functools
import heapq
import threading
import time

import numpy as np
import torch

from ..constants import (COMMON_HOP_LENGTH, MAX_N_SPEAKERS, SPH_AVG_MAX_N_SPEAKERS, V20RC0,
                         VersionSpec)
from ..device import resolve_device
from ..errors import BeatriceError, ErrorCode
from ..models import chain, fused_upsampler, waveform_generator
from ..models.chain import VoiceConverterConfig
from ..models.io import params_from_numpy
from ..models.layers import quantize_rows
from ..ops.gain import gain_process
from ..ops.resample import input_resampler_48k_to_16k, output_resampler_24k_to_48k
from ..speakers import morpher
from .controls import CONTROL_FIELDS, ControlStage, init_controls
from .metrics import EngineMetrics

KV_CACHE_MODES = ("slots", "per_stream")
# donated ticks run on a scratch copy of the state before a CUDA graph is
# captured: they build every constant the tick makes at its first call
GRAPH_WARMUP_TICKS = 2


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
        # each stream's frame index, uint32 values (wrapped mod 2^32): the
        # codebook lottery's random stream
        "frame_counter": torch.zeros(b, dtype=torch.int64, device=device),
        "morphed": {
            "additive": torch.zeros((cfg.capacity, wg.hidden), device=device),
            # the pruned weights at the top-8 indices, read by the lottery
            "w8": torch.zeros((cfg.capacity, SPH_AVG_MAX_N_SPEAKERS), device=device),
        },
    }
    if not cfg.spec.has_kv:
        return state
    # in the compute dtype, as the JAX engine stores it: the K/V
    # projections read this rounded copy (`engine.py:159-164`)
    state["morphed"]["kv"] = torch.zeros((cfg.capacity, cfg.spec.kv_length, cfg.spec.kv_channels),
                                         dtype=cond_dtype, device=device)
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
    formant embedding (f32; a morph stream's average) and, for
    2.0.0-rc.0, the K/V of the config's mode and the VQ codebook route
    (shared bank or per-stream gather) with one lottery draw per stream
    and tick for morph streams."""
    c = state["controls"]
    additive, _, cb_idx = morpher.select_conditioning(
        bank, c["target_speaker"], state["morphed"], c["formant_index"],
        frame_counter=state["frame_counter"] if "codebook" in bank else None,
        pruned_weights=c["morph_weights"], top_idx=c["morph_top_idx"], include_kv=False,
        w8=state["morphed"]["w8"])
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
        "frame_counter": (state["frame_counter"] + t) & 0xFFFFFFFF,
    }


def _changed_leaves(old, new, dst, src) -> None:
    """Append to dst / src each leaf of `old` and the leaf of `new` that
    replaces it, where the tick made a new tensor; subtrees and leaves it
    passed through (the same objects) are skipped."""
    if new is old:
        return
    if isinstance(old, dict):
        if old.keys() != new.keys():
            raise ValueError(f"the tick changed the state's keys: {sorted(old)} -> {sorted(new)}")
        for k in old:
            _changed_leaves(old[k], new[k], dst, src)
    elif isinstance(old, list):
        if len(old) != len(new):
            raise ValueError(f"the tick changed a state list's length: {len(old)} -> {len(new)}")
        for o, n in zip(old, new):
            _changed_leaves(o, n, dst, src)
    else:
        if new.shape != old.shape or new.dtype != old.dtype:
            raise ValueError(f"the tick changed a state leaf: {tuple(old.shape)} {old.dtype} -> "
                             f"{tuple(new.shape)} {new.dtype}")
        dst.append(old)
        src.append(new)


def donated_tick(params, bank, state, audio48, *, cfg: EngineConfig) -> torch.Tensor:
    """`engine_tick` with donated state (the JAX engine's `jax.jit(tick,
    donate_argnums=(2,))`): the new state is written into `state`'s own
    tensors, which stay the same objects, and the output is returned.
    Only the leaves the tick replaced are copied: the K/V cache, the slot
    bank and the controls pass through untouched.  A new leaf that shares
    memory with a leaf being written is copied aside first, so no copy
    reads what another has overwritten."""
    out, new = engine_tick(params, bank, state, audio48, cfg=cfg)
    dst, src = [], []
    _changed_leaves(state, new, dst, src)
    written = {t.untyped_storage().data_ptr() for t in dst}
    src = [t.clone() if t.untyped_storage().data_ptr() in written else t for t in src]
    torch._foreach_copy_(dst, src)
    return out


def _clone_tree(tree):
    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone_tree(v) for v in tree]
    return tree.clone()


def _copy_tree_(dst, src) -> None:
    """Copy every leaf of `src` into the same leaf of `dst`, in place."""
    d, s = [], []
    _changed_leaves(dst, src, d, s)
    torch._foreach_copy_(d, s)


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
    resampler state and frame counters, gains at their targets; controls
    are kept."""
    for key in ("model", "rs_in", "rs_out"):
        _zero_rows(state[key], idx)
    state["frame_counter"][idx] = 0
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


def refresh_morphed(state, bank, idx) -> None:
    """Recompute the morphed embeddings of the streams `idx` from their
    morph controls, in place (`engine.py:394`): the spherical averages and
    the weights at the top-8 indices."""
    c = state["controls"]
    pruned, top = c["morph_weights"][idx], c["morph_top_idx"][idx]
    m = morpher.update_morphed_embeddings(bank, pruned, top)
    m["w8"] = torch.gather(pruned, -1, top)
    for key, dst in state["morphed"].items():
        dst[idx] = m[key].to(dst.dtype)


def refresh_kv_slots(params, state, cfg: EngineConfig, stream_idx, slot_idx) -> None:
    """Project the morphed K/V of the streams `stream_idx` into the morph
    slots `slot_idx` of the slot bank, in place (`engine.py:409`)."""
    proj = waveform_generator.project_kv(params["wg"], state["morphed"]["kv"][stream_idx],
                                         cfg.dtype)
    _store_kv(state["kv_slots"], slot_idx, proj)


def refresh_kv_cache(params, bank, state, idx, compute_dtype=None) -> None:
    """Re-project the K/V of the streams `idx` into their per-block K/V
    cache rows, in place (`engine.py:435`; per-stream mode): the target
    speaker's, or a morph stream's morphed K/V."""
    n = bank["additive"].shape[0]
    target = state["controls"]["target_speaker"][idx]
    kv = torch.where((target >= n)[:, None, None], state["morphed"]["kv"][idx],
                     bank["kv"][torch.clamp(target, 0, n - 1)])
    proj = waveform_generator.project_kv(params["wg"], kv, compute_dtype)
    _store_kv(state["kv_cache"], idx, proj)


def refresh_conditioning(params, bank, state, cfg: EngineConfig, idx) -> None:
    """The morph embeddings, then the K/V conditioning, of the streams
    `idx`, in place (`engine.py:467`).  In slots mode morph slots are
    assigned round robin by position in `idx` -- the harness's shortcut;
    `StreamEngine` leases them."""
    refresh_morphed(state, bank, idx)
    if "kv_slots" in state:
        n = bank["additive"].shape[0]
        rows = torch.arange(len(idx), device=idx.device) % cfg.n_morph_slots
        refresh_kv_slots(params, state, cfg, idx, rows)
        c = state["controls"]
        c["kv_slot"][idx] = torch.where(c["target_speaker"][idx] >= n, n + rows,
                                        c["kv_slot"][idx])
    elif "kv_cache" in state:
        refresh_kv_cache(params, bank, state, idx, cfg.dtype)


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


def _locked(method):
    """Run a StreamEngine method under the engine's lock: the serving
    layer edits streams from client threads while the scheduler thread
    flushes and ticks."""

    @functools.wraps(method)
    def run(self, *args, **kw):
        with self._lock:
            return method(self, *args, **kw)

    return run


class StreamEngine:
    """Host-side wrapper: owns params, bank and state, the stream table
    (admit/evict), the control stage and, in slots mode, the lease of
    morph slots.  Stream-table and control methods may be called from any
    thread; they hold the engine's lock, as `flush_controls` does.

    Typical loop, one tick per T * 10 ms:
        out48 = engine.tick(in48)   # [capacity, T*480] -> [capacity, T*480]
    (tick flushes staged control edits first).

    jit=True (the default) ticks with donated state, on CUDA by replaying
    a CUDA graph captured here (see the module docstring); jit=False runs
    `engine_tick` op by op.  With jit=True `self.state`'s tensors are the
    graph's and are only ever updated in place.
    """

    def __init__(self, cfg: EngineConfig, params, bank, device="cuda", jit: bool = True):
        self.device = resolve_device(device)
        self.jit = jit
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
        # streams whose context a client reset (reset_context)
        self._context_reset: set[int] = set()
        self._lock = threading.RLock()
        self._slot_used = [False] * cfg.capacity
        self._morph_dirty: set[int] = set()
        self._kv_dirty: set[int] = set()
        # slots mode: free morph slots (popped from the end: slot 0 first),
        # stream -> leased slot, each stream's dominant morph speaker (its
        # base slot when no morph slot is free), the streams in morph mode,
        # and the streams whose leased slot needs projecting
        self._free_morph_slots = list(range(cfg.n_morph_slots - 1, -1, -1))
        self._morph_slot: dict[int, int] = {}
        self._last_top: dict[int, int] = {}
        self._morph_mode: set[int] = set()
        self._slot_dirty: set[int] = set()
        # every control set through set_control, stream -> field -> value
        # in the order first set: recover() replays it
        self._applied: dict[int, dict[str, np.ndarray]] = {}
        self.metrics = EngineMetrics()
        self.counters = {"admitted": 0, "evicted": 0}
        self._graph = None
        if jit and self.device.type == "cuda":
            self._capture()

    def _capture(self) -> None:
        """Capture one donated tick in a CUDA graph over `self.state`, a
        static input and the output it returns.  GRAPH_WARMUP_TICKS donated
        ticks first run on a side stream on a scratch copy of the state
        (ticking the live state would advance every stream), counted in
        `counters["graph_warmup_ticks"]`: they build the tick's lazily made
        constants, whose copies from the host could not be captured.
        thread_local capture leaves other threads' CUDA work alone: a
        ModelHost builds a new engine while the old one ticks.  A failed
        warm-up or capture raises.  `capture_ms` is the host's time for
        all of it, the graph's instantiation included."""
        cfg = self.cfg
        t0 = time.perf_counter()
        with torch.cuda.device(self.device):
            self._static_in = torch.zeros((cfg.capacity, cfg.samples_per_tick),
                                          device=self.device)
            scratch = _clone_tree(self.state)
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                for _ in range(GRAPH_WARMUP_TICKS):
                    donated_tick(self.params, self.bank, scratch, self._static_in, cfg=cfg)
            torch.cuda.current_stream().wait_stream(side)
            del scratch
            self.counters["graph_warmup_ticks"] = GRAPH_WARMUP_TICKS
            graph = torch.cuda.CUDAGraph()
            with fused_upsampler.recording() as recorded:
                with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                    self._static_out = donated_tick(self.params, self.bank, self.state,
                                                    self._static_in, cfg=cfg)
        self._graph, self._recorded = graph, dict(recorded)
        self.capture_ms = (time.perf_counter() - t0) * 1e3

    # ---- stream table ----

    @_locked
    def admit(self) -> int:
        """Allocate a stream slot; returns its index (raises if full).  The
        slot's carries are reset at the next flush, and it starts from the
        default controls."""
        if not self._free:
            raise RuntimeError("stream capacity exhausted")
        idx = heapq.heappop(self._free)
        self._pending_reset.add(idx)
        self._slot_used[idx] = True
        self._applied.pop(idx, None)
        self._kv_dirty.add(idx)
        self.stage.stage(idx, "active", True)
        if self._slots_mode:
            self._release_morph_slot(idx)
            self._morph_mode.discard(idx)
            self.stage.stage(idx, "kv_slot", 0)
        self.counters["admitted"] += 1
        return idx

    @_locked
    def evict(self, idx: int) -> None:
        self.stage.stage(idx, "active", False)
        heapq.heappush(self._free, idx)
        self._applied.pop(idx, None)
        if self._slots_mode:
            self._release_morph_slot(idx)
            self._morph_mode.discard(idx)
        self.counters["evicted"] += 1

    # ---- morph slots (slots mode) ----

    def _lease_morph_slot(self, idx: int):
        if idx not in self._morph_slot and self._free_morph_slots:
            self._morph_slot[idx] = self._free_morph_slots.pop()
        return self._morph_slot.get(idx)

    def _release_morph_slot(self, idx: int) -> None:
        slot = self._morph_slot.pop(idx, None)
        if slot is not None:
            self._free_morph_slots.append(slot)

    def _stage_kv_slot(self, idx: int) -> None:
        """Point a morph stream at its row of the slot bank: its leased
        morph slot or, with every slot leased, its dominant morph
        speaker's base slot (the additive morph stays exact)."""
        if idx not in self._morph_mode:
            return
        slot = self._lease_morph_slot(idx)
        if slot is None:
            self.stage.stage(idx, "kv_slot", self._last_top.get(idx, 0))
        else:
            self.stage.stage(idx, "kv_slot", self._n_speakers + slot)
            self._slot_dirty.add(idx)

    # ---- controls ----

    @_locked
    def set_control(self, idx: int, field: str, value) -> None:
        """Stage one control edit for stream `idx`, applied at the next
        flush (`engine.py:750`).  A target speaker >= the bank's speaker
        count is morph mode, conditioned by the stream's `morph_weights`
        [256] and `morph_top_idx` [8] (`morpher.pruned_morph_weights`)."""
        if field not in CONTROL_FIELDS:
            raise KeyError(f"unknown control {field!r}; known: {sorted(CONTROL_FIELDS)}")
        value = np.asarray(value)
        shape = CONTROL_FIELDS[field][2]
        if value.shape != shape:
            raise ValueError(f"{field}: value of shape {value.shape}, expected {shape}")
        if field == "target_speaker" and value < 0:
            raise BeatriceError(ErrorCode.SPEAKER_ID_OUT_OF_RANGE, f"target_speaker {value} < 0")
        if field == "morph_top_idx" and not ((value >= 0) & (value < MAX_N_SPEAKERS)).all():
            raise BeatriceError(ErrorCode.SPEAKER_ID_OUT_OF_RANGE,
                                f"morph_top_idx {value} outside [0, {MAX_N_SPEAKERS})")
        i = int(idx)
        self.stage.stage(i, field, value)
        self._applied.setdefault(i, {})[field] = value
        if field in ("morph_weights", "morph_top_idx"):
            self._morph_dirty.add(i)
            self._kv_dirty.add(i)
            if self._slots_mode:
                if field == "morph_top_idx":
                    self._last_top[i] = int(value[0])
                self._stage_kv_slot(i)
        elif field == "target_speaker":
            self._kv_dirty.add(i)
            if self._slots_mode:
                if int(value) >= self._n_speakers:
                    self._morph_mode.add(i)
                    self._stage_kv_slot(i)
                else:
                    # a direct speaker's slot follows target_speaker
                    # inside the tick; return any leased slot
                    self._morph_mode.discard(i)
                    self._release_morph_slot(i)

    @_locked
    def flush_controls(self) -> None:
        """Reset the contexts asked for by `reset_context`, then apply
        staged edits, then in the JAX engine's order (`engine.py:773`):
        reset admitted slots, recompute the morphed embeddings of streams
        whose morph controls changed, refresh the per-stream K/V cache of
        streams whose speaker or morph changed (per-stream mode), and
        project the morphed K/V into leased morph slots (slots mode)."""
        if self._context_reset:
            reset_streams(self.state, self._index(sorted(self._context_reset)))
            self._context_reset.clear()
        if self.stage.pending():
            apply_control_updates(self.state, self.stage.drain())
        if self._pending_reset:
            reset_streams(self.state, self._index(sorted(self._pending_reset)))
            self._pending_reset.clear()
        if self._morph_dirty:
            refresh_morphed(self.state, self.bank, self._index(sorted(self._morph_dirty)))
            self._morph_dirty.clear()
        if self._kv_dirty and "kv_cache" in self.state:
            refresh_kv_cache(self.params, self.bank, self.state,
                             self._index(sorted(self._kv_dirty)), self.cfg.dtype)
        self._kv_dirty.clear()
        streams = sorted(i for i in self._slot_dirty if i in self._morph_slot)
        if streams:
            refresh_kv_slots(self.params, self.state, self.cfg, self._index(streams),
                             self._index([self._morph_slot[i] for i in streams]))
        self._slot_dirty.clear()

    @_locked
    def reset_context(self, idx: int) -> None:
        """ResetContext of stream `idx` (fresh carries, controls kept), from
        any thread.  It is staged and applied at the next flush, on the
        thread that ticks, ahead of the staged control edits: the gains
        restart at the targets in force when it was asked, as after the
        JAX handle's immediate reset (`handle.py:39-46`), which leaves
        staged edits for the next flush."""
        self._context_reset.add(int(idx))

    def _index(self, values: list[int]) -> torch.Tensor:
        return torch.as_tensor(values, dtype=torch.int64, device=self.device)

    @_locked
    def recover(self) -> list[int]:
        """Rebuild the device state after a device fault (`engine.py:825`),
        keeping the stream table and every control set through
        `set_control`: occupied slots are re-activated, their controls
        replayed in the order first set, and their morph and K/V
        conditioning refreshed at the next flush.  Streaming contexts
        restart from zero, as the reference's ResetContext does.  Returns
        the re-activated slots.  With jit=True the fresh state is copied
        into the state's own tensors (a captured graph reads them)."""
        fresh = init_engine_state(self.cfg, self.device)
        if self.jit:
            _copy_tree_(self.state, fresh)
        else:
            self.state = fresh
        self.stage = ControlStage()
        for pending in (self._pending_reset, self._context_reset, self._morph_dirty,
                        self._kv_dirty, self._slot_dirty):
            pending.clear()
        active = [i for i in range(self.cfg.capacity)
                  if self._slot_used[i] and i not in self._free]
        for idx in active:
            self.stage.stage(idx, "active", True)
            self._kv_dirty.add(idx)
            for field, value in list(self._applied.get(idx, {}).items()):
                self.set_control(idx, field, value)
            if idx in self._morph_slot:
                self._morph_dirty.add(idx)
                self._slot_dirty.add(idx)
        self.counters["recoveries"] = self.counters.get("recoveries", 0) + 1
        return active

    # ---- the tick ----

    def tick(self, audio48_in) -> torch.Tensor:
        """audio48_in: [capacity, T*480] (numpy or tensor) -> [capacity,
        T*480] on the engine's device, a new tensor each tick."""
        x = torch.as_tensor(audio48_in, dtype=torch.float32, device=self.device)
        expect = (self.cfg.capacity, self.cfg.samples_per_tick)
        if tuple(x.shape) != expect:
            raise ValueError(f"tick input shape {tuple(x.shape)}, expected {expect}")
        self.flush_controls()
        t0 = time.perf_counter()
        if self._graph is not None:
            self._static_in.copy_(x)
            self._graph.replay()
            fused_upsampler.count_replay(self._recorded)
            # the graph's output is overwritten by the next replay
            out = self._static_out.clone()
        elif self.jit:
            out = donated_tick(self.params, self.bank, self.state, x, cfg=self.cfg)
        else:
            out, self.state = engine_tick(self.params, self.bank, self.state, x, cfg=self.cfg)
        self.metrics.record_tick(time.perf_counter() - t0, self.n_active,
                                 self.cfg.frames_per_tick)
        return out

    def metrics_snapshot(self) -> dict:
        return {**self.metrics.snapshot(self.n_active), **self.counters}

    @property
    def n_active(self) -> int:
        return self.cfg.capacity - len(self._free)
