"""Offline (whole-utterance) conversion (port of
`beatrice_vst_tpu/runtime/offline.py`).

The same chain as the real-time engine, over a whole utterance: the input
is resampled to 16 kHz, runs through the chain as one chunk of T frames
(or in chunks of `chunk_frames` with the state carried between them), and
the 24 kHz output is resampled to the output rate.  Any input and output
rate whose ratio to the model's rates has terms below 1000 works (a
44.1 kHz input has the ratio 160/441).  `ConversionSettings.morph_weights`
converts to the morph of its speakers (one codebook lottery draw, at
frame 0, for the whole utterance, as the JAX package does).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..constants import IN_HOP_LENGTH, MAX_N_SPEAKERS, OUT_HOP_LENGTH, SPH_AVG_MAX_N_SPEAKERS
from ..device import resolve_device
from ..errors import BeatriceError, ErrorCode
from ..models import chain, waveform_generator
from ..models.chain import VoiceConverterConfig
from ..models.io import params_from_numpy
from ..ops.resample import make_resampler, rational_rate_ratio
from ..speakers import morpher
from . import graphs


@dataclasses.dataclass
class ConversionSettings:
    """Per-utterance settings (the reference's Set* parameters as data)."""

    target_speaker: int = 0
    formant_shift: float = 0.0
    pitch_shift: float = 0.0
    average_source_pitch: float = 52.0
    intonation_intensity: float = 1.0
    pitch_correction: float = 0.0
    pitch_correction_type: int = 0
    min_source_pitch: float = 33.125
    max_source_pitch: float = 80.875
    vq_num_neighbors: int = 0
    morph_weights: np.ndarray | None = None  # dense [n_speakers] -> morph mode
    # condition the vocoder on the expected pitch bin instead of the argmax
    soft_pitch: bool = False


def build_cond(params, cfg: VoiceConverterConfig, bank, settings: ConversionSettings,
               batch: int = 1, compute_dtype=None, raw_kv: bool = False):
    """The chain's cond dict for `settings` (`offline.py:45`), on the
    bank's device.  With morph_weights (zero-padded to 256) the weights
    are folded, thresholded and pruned, the embeddings averaged once, and
    the codebook drawn by one lottery at frame 0; a target speaker >= the
    bank's count without weights is morph mode with zero embeddings, as
    in the JAX package.  Where the JAX package hands the chain the raw
    speaker KV, the port hands it the projected per-stream K/V cache (the
    same products, taken once); raw_kv hands it the raw KV under "kv", as
    the JAX package does, for training (the vocoder projects it in every
    call, so the gradient reaches the K/V weights; params may be None)."""
    spec = cfg.spec
    n = bank["additive"].shape[0]
    if settings.target_speaker < 0:
        raise BeatriceError(ErrorCode.SPEAKER_ID_OUT_OF_RANGE,
                            f"target_speaker {settings.target_speaker} < 0")
    dev = bank["additive"].device

    def full(value, dtype):
        return torch.full((batch,), value, dtype=dtype, device=dev)

    target = settings.target_speaker
    pruned = torch.zeros((1, MAX_N_SPEAKERS), device=dev)
    top_idx = torch.zeros((1, SPH_AVG_MAX_N_SPEAKERS), dtype=torch.int64, device=dev)
    if settings.morph_weights is not None:
        target = n
        w = torch.as_tensor(np.asarray(settings.morph_weights, np.float32), device=dev)[None]
        if w.shape[1] > MAX_N_SPEAKERS:
            raise BeatriceError(ErrorCode.SPEAKER_ID_OUT_OF_RANGE,
                                f"{w.shape[1]} morph weights, at most {MAX_N_SPEAKERS}")
        w = torch.nn.functional.pad(w, (0, MAX_N_SPEAKERS - w.shape[1]))
        pruned, top_idx = morpher.pruned_morph_weights(w, torch.tensor([n], device=dev))
        morphed = morpher.update_morphed_embeddings(bank, pruned, top_idx)
    else:
        morphed = {k: torch.zeros((1, *bank[k].shape[1:]), device=dev)
                   for k in ("additive", "kv") if k in bank}
    formant = int(round(np.clip(settings.formant_shift, -2, 2) * 2 + 4))
    morphed = {k: v.expand(batch, *v.shape[1:]) for k, v in morphed.items()}
    additive, kv, cb_idx = morpher.select_conditioning(
        bank, full(target, torch.int64), morphed, full(formant, torch.int64),
        frame_counter=full(0, torch.int64) if "codebook" in bank else None,
        pruned_weights=pruned.expand(batch, -1), top_idx=top_idx.expand(batch, -1))

    def q(midi):
        return int(np.clip(round((np.clip(midi, 0, 128) - 33.0) * 8.0), 1, spec.pitch_bins - 1))

    f32 = torch.float32
    cond = {
        "speaker_embedding": additive,
        "vq_num_neighbors": full(settings.vq_num_neighbors, torch.int64),
        "min_q": full(q(settings.min_source_pitch), torch.int64),
        "max_q": full(q(settings.max_source_pitch), torch.int64),
        "average_source_pitch": full(settings.average_source_pitch, f32),
        "intonation_intensity": full(settings.intonation_intensity, f32),
        "pitch_shift": full(float(np.clip(settings.pitch_shift, -24, 24)), f32),
        "pitch_correction": full(float(np.clip(settings.pitch_correction, 0, 1)), f32),
        "pitch_correction_type": full(settings.pitch_correction_type, torch.int64),
    }
    if spec.has_kv and raw_kv:
        cond["kv"] = kv
    elif spec.has_kv:
        cond["kv_cache"] = waveform_generator.project_kv(params["wg"], kv, compute_dtype)
    if spec.has_vq:
        cond["codebook"] = bank["codebook"][cb_idx]
    return cond


def convert_utterance(params, cfg: VoiceConverterConfig, bank, audio, sample_rate: float,
                      settings: ConversionSettings = None, out_sample_rate: float = None,
                      compute_dtype=None, chunk_frames: int = None, device="cuda",
                      jit: bool | None = None):
    """Convert one utterance [n] or a batch [B, n] at `sample_rate`
    (`offline.py:131`).  Returns numpy f32 audio at `out_sample_rate`
    (default: the input rate).

    params and bank: the JAX package's trees or the port's (numpy arrays
    or tensors), moved to `device`.  compute_dtype: None (f32) or
    torch.bfloat16.  chunk_frames > 0 runs the chain in chunks of that
    many frames with the state carried between them (bounded memory);
    0 runs the utterance as one chunk; None (auto) chunks at 256 frames
    beyond 384 frames.

    Compiled (`jit` None or True, the default, as the JAX package jits
    `_jitted_apply` and `_jitted_resample`), the chunk step (the state
    donated into its static tensors), the whole-utterance step and the two
    resamplers are steps of the step cache (`graphs`): CUDA graphs on the
    card, captured at the first call of each shape and keyed by the
    identity of the parameter tensors, so that params already on the
    device as tensors reuse them across calls (numpy params are moved anew
    at every call, and capture anew).  The cond (`build_cond`: the morph
    average and the lottery at frame 0) is computed outside them and
    copied in.  `jit=False` runs everything op by op.
    """
    compiled = graphs.resolve_jit(jit)
    if chunk_frames is None:
        chunk_frames = 256 if audio_longer_than(audio, sample_rate, 384) else 0
    settings = settings or ConversionSettings()
    out_sample_rate = out_sample_rate or sample_rate
    dev = resolve_device(device)
    params = params_from_numpy(params, dev)
    bank = {k: v.float() for k, v in params_from_numpy(bank, dev).items()}
    x = torch.as_tensor(audio, dtype=torch.float32, device=dev)
    squeeze = x.dim() == 1
    if squeeze:
        x = x[None]
    b = x.shape[0]

    if sample_rate != 16000:
        x = resample(make_resampler(sample_rate, 16000, _block_for(sample_rate, 16000)), x,
                     compiled)
    t = -(-x.shape[-1] // IN_HOP_LENGTH)
    x = torch.nn.functional.pad(x, (0, t * IN_HOP_LENGTH - x.shape[-1]))

    cond = build_cond(params, cfg, bank, settings, b, compute_dtype)
    kw = dict(compute_dtype=compute_dtype, soft_pitch=settings.soft_pitch)
    if chunk_frames and chunk_frames < t:
        x = torch.nn.functional.pad(x, (0, ((-t) % chunk_frames) * IN_HOP_LENGTH))
        segs = torch.split(x, chunk_frames * IN_HOP_LENGTH, dim=-1)
        if compiled:
            parts = _compiled_chunks(params, cfg, segs, cond, **kw)
        else:
            state = chain.init_state(cfg, (b,), dev)
            parts = []
            for seg in segs:
                y_seg, state = chain.apply(params, cfg, seg, state, cond, **kw)
                parts.append(y_seg)
        y = torch.cat(parts, dim=-1)[:, :t * OUT_HOP_LENGTH]
    elif compiled:
        y = graphs.call(("whole", cfg, tuple(kw.items()), graphs.identity(params)),
                        lambda x16, c: _whole(params, cfg, x16, c, **kw), x, cond)
    else:
        y = _whole(params, cfg, x, cond, **kw)

    if out_sample_rate != 24000:
        y = resample(make_resampler(24000, out_sample_rate, _block_for(24000, out_sample_rate)),
                     y, compiled)
    y = y.float().cpu().numpy()
    return y[0] if squeeze else y


def _whole(params, cfg, x16, cond, *, compute_dtype, soft_pitch):
    """The chain over a whole utterance from the zero state."""
    state = chain.init_state(cfg, (x16.shape[0],), x16.device)
    return chain.apply(params, cfg, x16, state, cond, compute_dtype, soft_pitch=soft_pitch)[0]


def _chunk(params, cfg, seg, state, cond, *, compute_dtype, soft_pitch):
    """One chunk with donated state: the chain's new state written into
    `state`'s own tensors; returns the chunk's audio."""
    y, new = chain.apply(params, cfg, seg, state, cond, compute_dtype, soft_pitch=soft_pitch)
    graphs.write_back_(state, new)
    return y


def _compiled_chunks(params, cfg, segs, cond, **kw) -> list:
    """Every chunk through the chunk step of the step cache: its state
    zeroed and the cond copied in once, each chunk copied in and replayed."""
    key = ("chunk", cfg, tuple(kw.items()), graphs.identity(params),
           graphs.signature((segs[0], cond)))
    step = graphs.CACHE.get(key, lambda: graphs.CompiledStep(
        lambda seg, state, c: _chunk(params, cfg, seg, state, c, **kw),
        (segs[0].clone(), chain.init_state(cfg, (segs[0].shape[0],), segs[0].device),
         graphs.clone_tree(cond))))
    seg_in, state, cond_in = step.args
    parts = []
    with step.lock:
        graphs.zero_tree_(state)
        graphs.copy_tree_(cond_in, cond)
        for seg in segs:
            seg_in.copy_(seg)
            parts.append(step().clone())
    return parts


def resample(rs, x, compiled: bool):
    """`rs.apply_offline(x)`, compiled (a step of the step cache per
    resampler and input shape) or op by op."""
    if not compiled:
        return rs.apply_offline(x)
    return graphs.call(("resample", rs), rs.apply_offline, x)


def audio_longer_than(audio, sample_rate: float, frames: int) -> bool:
    """Whether the audio lasts longer than `frames` 10 ms frames."""
    return np.shape(audio)[-1] / sample_rate > frames * 0.010


def _block_for(rate_in: float, rate_out: float) -> int:
    """The offline resampler's block: a multiple of the ratio's M near
    4096 samples (`offline.py:196`)."""
    _, m = rational_rate_ratio(rate_in, rate_out)
    return m * max(1, 4096 // m)
