"""Sequence-parallel offline conversion (port of
`beatrice_vst_tpu/runtime/seqpar.py`): the frame axis of one utterance is
cut into segments that run as one batch.

Every stage of the chain is FIR -- the mel front ends keep win - hop raw
samples, the conv stacks (k - 1) * dilation rows a block -- so a segment
that replays `warmup` frames of real left context from a zero state gives
the sequential outputs once the warmup covers the chain's receptive field
(`chain_receptive_field_frames`).  The only unbounded carries are the
source phase and the noise counter:

  * the noise counter is positional: segment k starts at frame k*f - w,
    masked to 32 bits;
  * the phase is a prefix sum of per-frame increments: pass A runs the
    pitch stage alone on every segment and returns the increments the
    vocoder will integrate (`waveform_generator.frame_increments`, the
    same f32 values); a float64 prefix over them on the host gives each
    segment's starting phase, less what its own warmup adds; pass B runs
    the whole chain on every segment with that phase.

Without a mesh the segments are one batch on one device.  With a `mesh`
(`parallel/mesh.py`) the segment-major work axis of segments 1..s-1,
(s-1)*B rows, is split over the ranks of its `axis`: each rank runs pass A
on its rows and the increments are all-gathered, every rank takes the
float64 prefix on its host, each rank runs pass B on its rows and the
outputs are all-gathered.  Segment 0 runs on every rank.  Where (s-1)*B
does not divide by the axis size the work axis is not split and every rank
runs it whole: the JAX package's own rule (`seqpar.py:190-191`).
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import IN_HOP_LENGTH, OUT_HOP_LENGTH
from ..device import resolve_device
from ..models import chain, pitch_estimator, waveform_generator
from ..models.chain import VoiceConverterConfig
from ..models.io import params_from_numpy
from ..ops.pitch_math import transform_pitch
from ..ops.resample import make_resampler
from ..parallel.mesh import all_gather_cat, axis_sizes
from .offline import ConversionSettings, _block_for, build_cond


def chain_receptive_field_frames(cfg: VoiceConverterConfig) -> int:
    """Frames of left context after which a zero-state replay is exact:
    the deeper of the phone and pitch stacks (raw-history frames of the
    mel front end plus sum (k-1)*d) plus the vocoder's frame-rate blocks,
    plus 2 frames of slack for the upsampler's sub-frame carries."""
    def stack_rf(c):
        fe_frames = -(-c.frontend.history // IN_HOP_LENGTH)
        return fe_frames + sum((c.kernel - 1) * d for d in c.dilations)

    wg_rf = (cfg.wg.kernel - 1) * cfg.wg.n_blocks
    return max(stack_rf(cfg.phone), stack_rf(cfg.pitch)) + wg_rf + 2


def _pitch_pass(params, cfg, seg16, cond, compute_dtype, soft_pitch):
    """Pass A: the pitch stage of a batch of segments -> the vocoder's
    per-frame phase increments [N, T] f32, from the bins `chain.apply`
    hands it (argmax or, with soft_pitch, the expected bin; transformed;
    clamped as the vocoder clamps them)."""
    n = seg16.shape[0]
    state = pitch_estimator.init_state(cfg.pitch, (n,), seg16.device)
    pe_out = pitch_estimator.apply(params["pitch"], cfg.pitch, seg16, state, cond["min_q"],
                                   cond["max_q"], compute_dtype, with_logits=soft_pitch)
    qp_raw = pe_out[0]
    if soft_pitch:
        qp_raw = pitch_estimator.expected_bin(pe_out[3], cond["min_q"], cond["max_q"])
    qp = transform_pitch(
        qp_raw,
        average_source_pitch=cond["average_source_pitch"][:, None],
        intonation_intensity=cond["intonation_intensity"][:, None],
        pitch_shift=cond["pitch_shift"][:, None],
        pitch_correction=cond["pitch_correction"][:, None],
        pitch_correction_type=cond["pitch_correction_type"][:, None],
        pitch_bins=cfg.spec.pitch_bins,
        round_output=not soft_pitch,
    )
    bins = cfg.wg.pitch_bins - 1
    qp = torch.clamp(qp.float(), 0.0, float(bins)) if soft_pitch else torch.clamp(qp, 0, bins)
    return waveform_generator.frame_increments(qp)


def _chain_pass(params, cfg, seg16, cond, phase0, counter0, compute_dtype, soft_pitch):
    """Pass B: the whole chain over a batch of segments from a zero state
    with the given source phase [N] and noise counter [N]."""
    state = chain.init_state(cfg, (seg16.shape[0],), seg16.device)
    state["wg"]["phase"] = phase0
    state["wg"]["noise_counter"] = counter0
    return chain.apply(params, cfg, seg16, state, cond, compute_dtype, soft_pitch=soft_pitch)[0]


def _work_rows(n: int, mesh, axis: str):
    """(this rank's rows of the n-row work axis, the function that gathers
    a result of those rows back to n rows): a block of n/k rows on each of
    the k ranks of the mesh's `axis`; all rows, and no gather, without a
    mesh or where n does not divide by k (`seqpar.py:190-191`)."""
    k = 1 if mesh is None else axis_sizes(mesh)[axis]
    if k == 1 or n % k:
        return slice(0, n), lambda x: x
    block = n // k
    r = mesh.get_local_rank(axis)
    group = mesh.get_group(axis)
    return slice(r * block, (r + 1) * block), lambda x: all_gather_cat(x, 0, group)


@torch.no_grad()
def convert_utterance_sp(params, cfg: VoiceConverterConfig, bank, audio, sample_rate: float,
                         settings: ConversionSettings | None = None, n_segments: int = 8,
                         warmup_frames: int | None = None,
                         out_sample_rate: float | None = None, compute_dtype=None,
                         device="cuda", mesh=None, axis: str = "streams"):
    """Convert one utterance [n] (or a batch [B, n]) at `sample_rate` with
    its frame axis cut into `n_segments` segments (`seqpar.py:136`).
    Returns numpy f32 at `out_sample_rate` (default: the input rate), the
    result of `offline.convert_utterance` to f32 round-off.

    The segment count is capped so that every segment is at least the
    warmup long (each halo is real audio); segment 0 starts from the true
    zero state.  params and bank: numpy arrays or tensors, moved to
    `device`.  With a `mesh`, every rank of it calls this with the same
    arguments and gets the whole result; the segments' rows are split over
    the ranks of `axis` where (s-1)*B divides by its size, else every rank
    converts them all (the JAX package's rule)."""
    settings = settings or ConversionSettings()
    out_sample_rate = out_sample_rate or sample_rate
    w = int(chain_receptive_field_frames(cfg) if warmup_frames is None else warmup_frames)
    dev = resolve_device(device)
    params = params_from_numpy(params, dev)
    bank = {k: v.float() for k, v in params_from_numpy(bank, dev).items()}
    x = torch.as_tensor(np.asarray(audio, np.float32), device=dev)
    squeeze = x.dim() == 1
    if squeeze:
        x = x[None]
    b = x.shape[0]
    if sample_rate != 16000:
        x = make_resampler(sample_rate, 16000, _block_for(sample_rate, 16000)).apply_offline(x)
    n16 = x.shape[-1]
    t_real = -(-n16 // IN_HOP_LENGTH)

    s = max(1, min(int(n_segments), t_real // max(w, 1)))
    f = -(-t_real // s)  # frames per segment, >= w by the cap
    x = torch.nn.functional.pad(x, (0, s * f * IN_HOP_LENGTH - n16))
    cond1 = build_cond(params, cfg, bank, settings, b, compute_dtype)
    seg0 = x[:, :f * IN_HOP_LENGTH]
    zeros = torch.zeros((b,), device=dev)
    zero_counter = torch.zeros((b,), dtype=torch.int64, device=dev)
    if s == 1:
        y24 = _chain_pass(params, cfg, seg0, cond1, zeros, zero_counter, compute_dtype,
                          settings.soft_pitch)[:, :t_real * OUT_HOP_LENGTH]
    else:
        # segments 1..s-1 with a w-frame halo, segment-major [(s-1)*B, (w+f)*160]
        segs = torch.stack([x[:, (k * f - w) * IN_HOP_LENGTH:(k * f + f) * IN_HOP_LENGTH]
                            for k in range(1, s)]).reshape((s - 1) * b, -1)
        cond = {k: v.repeat((s - 1,) + (1,) * (v.dim() - 1)) if isinstance(v, torch.Tensor)
                else {kk: vv.repeat((s - 1,) + (1,) * (vv.dim() - 1)) for kk, vv in v.items()}
                for k, v in cond1.items()}
        rows, gather = _work_rows((s - 1) * b, mesh, axis)
        segs, cond = segs[rows], {k: v[rows] if isinstance(v, torch.Tensor)
                                  else {kk: vv[rows] for kk, vv in v.items()}
                                  for k, v in cond.items()}
        # pass A: increments of every frame; the phase prefix on the host in f64
        inc0 = _pitch_pass(params, cfg, seg0, cond1, compute_dtype, settings.soft_pitch)
        inc_seg = gather(_pitch_pass(params, cfg, segs, cond, compute_dtype,
                                     settings.soft_pitch))
        inc0 = inc0.double().cpu().numpy()
        inc_seg = inc_seg.double().cpu().numpy().reshape(s - 1, b, w + f)
        inc_real = np.concatenate(
            [inc0, inc_seg[:, :, w:].transpose(1, 0, 2).reshape(b, (s - 1) * f)], axis=-1)
        prefix = np.concatenate([np.zeros((b, 1)), np.cumsum(inc_real, axis=-1)], axis=-1)
        seg_start_phase = prefix[:, ::f][:, 1:s].T  # [s-1, B]
        warm_sum = inc_seg[:, :, :w].sum(axis=-1)
        phase0 = np.mod(seg_start_phase - warm_sum, 2.0 * np.pi).astype(np.float32)
        counter0 = np.repeat((np.arange(1, s, dtype=np.int64) * f - w) & 0xFFFFFFFF, b)
        # pass B: the whole chain on every segment, the warmup dropped
        y0 = _chain_pass(params, cfg, seg0, cond1, zeros, zero_counter, compute_dtype,
                         settings.soft_pitch)
        y = gather(_chain_pass(params, cfg, segs, cond,
                               torch.from_numpy(phase0.reshape(-1)[rows]).to(dev),
                               torch.from_numpy(counter0[rows]).to(dev), compute_dtype,
                               settings.soft_pitch))
        rest = y[:, w * OUT_HOP_LENGTH:].reshape(s - 1, b, f * OUT_HOP_LENGTH)
        rest = rest.permute(1, 0, 2).reshape(b, (s - 1) * f * OUT_HOP_LENGTH)
        y24 = torch.cat([y0, rest], dim=-1)[:, :t_real * OUT_HOP_LENGTH]

    if out_sample_rate != 24000:
        y24 = make_resampler(24000, out_sample_rate,
                             _block_for(24000, out_sample_rate)).apply_offline(y24)
    out = y24.float().cpu().numpy()
    return out[0] if squeeze else out
