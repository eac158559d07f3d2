"""WaveformGenerator: the speaker-conditioned streaming vocoder, one 10 ms
frame -> 240 samples at 24 kHz (port of
`beatrice_vst_tpu/models/waveform_generator.py`, T = 1).

Frame-rate conditioning (phone, pitch-bin embedding, pitch features and
the additive speaker embedding), four causal conv blocks each followed by
cross-attention into the speaker K/V -- a per-stream projected cache
(f32/bf16, or int8 with per-row scales) or a shared slot bank read
through one-hot contractions (f32/bf16, or int8 with int8 contractions)
-- then a harmonic-plus-noise source evaluated at every upsampler rate
and the depth-to-time upsampler head (`fused_upsampler.py`).  With a
compute dtype the residual stream, the carries and the head compute in
it (`waveform_generator.py:336-395`).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..constants import OUT_HOP_LENGTH, OUT_SAMPLE_RATE, VersionSpec
from ..device import resolve_device
from . import layers
from .fused_upsampler import fused_upsample, fused_upsample_reference, head_params

_TWO_PI = 2.0 * math.pi


@dataclasses.dataclass(frozen=True)
class WaveformGeneratorConfig:
    pitch_bins: int
    hidden: int = 256
    n_blocks: int = 4
    kernel: int = 4
    attn_dim: int = 64
    upsample: tuple = ((4, 128), (5, 64), (4, 32), (3, 16))
    up_kernel: int = 3
    n_harmonics: int = 8
    noise_salt: int = 0x5EED
    # True: the upsampler head goes through the fused_upsample wrapper (the
    # CUDA kernel on a CUDA tensor).  False forces its plain PyTorch
    # version on any device -- the yardstick the kernel is checked against.
    upsampler_kernel: bool = True

    @classmethod
    def for_version(cls, spec: VersionSpec) -> "WaveformGeneratorConfig":
        if not spec.has_kv:
            raise ValueError(f"only the 2.0.0-rc.0 vocoder is ported, not {spec.name}")
        return cls(pitch_bins=spec.pitch_bins, n_blocks=spec.n_blocks)

    def __post_init__(self):
        if math.prod(r for r, _ in self.upsample) != OUT_HOP_LENGTH:
            raise ValueError(f"upsample rates {self.upsample} must multiply to {OUT_HOP_LENGTH}")


def init_state(cfg: WaveformGeneratorConfig, batch_shape=(), device="cuda"):
    """Zero streaming state (linear conv windows, phase, noise counter)."""
    device = resolve_device(device)
    k = cfg.kernel - 1
    u = cfg.up_kernel - 1
    c_ins = [cfg.hidden] + [c for _, c in cfg.upsample]
    return {
        "blocks": [torch.zeros((*batch_shape, k, cfg.hidden), device=device)
                   for _ in range(cfg.n_blocks)],
        "up": [torch.zeros((*batch_shape, u, c), device=device) for c in c_ins[:-1]],
        "final": torch.zeros((*batch_shape, u, c_ins[-1]), device=device),
        "phase": torch.zeros(batch_shape, device=device),
        "noise_counter": torch.zeros(batch_shape, dtype=torch.int64, device=device),
    }


def _mod(x, y: float):
    """Floor modulo with the JAX package's float semantics (`jnp.mod`):
    fmod, shifted by y where the remainder has the other sign."""
    r = torch.fmod(x, y)
    return torch.where((r != 0) & (r < 0), r + y, r)


def quantized_pitch_to_hz(q):
    """Quantized pitch bin -> Hz (bin 0 = 55 Hz, 96 bins/octave)."""
    return 55.0 * torch.pow(2.0, q / 96.0)


def _source_phases(quantized_pitch, phase0):
    """(start [B, T], step [B, T], new_phase [B]) (`waveform_generator.py:169`):
    the source phase at sample p = 1..240 of frame t is start + step * p.

    Frame-start phases are a prefix sum taken mod 2*pi at every step, as in
    the JAX package: a plain f32 cumsum of ~10 rad per frame drifts.
    """
    f0 = quantized_pitch_to_hz(quantized_pitch.to(torch.float32))
    step = _TWO_PI * f0 / OUT_SAMPLE_RATE
    frame_inc = step * OUT_HOP_LENGTH
    inc_mod = _mod(step * OUT_HOP_LENGTH, _TWO_PI)
    acc = inc_mod[:, 0]
    csum = [acc]
    for t in range(1, inc_mod.shape[1]):
        acc = _mod(acc + inc_mod[:, t], _TWO_PI)
        csum.append(acc)
    csum = torch.stack(csum, dim=1)
    start = _mod(phase0[:, None] + csum - inc_mod, _TWO_PI)
    new_phase = _mod(start[:, -1] + frame_inc[:, -1], _TWO_PI)
    return start, step, new_phase


def _harmonic_features(phases, periodicity, n_harmonics: int):
    """[B, T, S, H] sin(k*phi), k = 1..H, gated by sigmoid(periodicity)
    (`waveform_generator.py:275`); Chebyshev recurrence
    sin((k+1)phi) = 2cos(phi) sin(k phi) - sin((k-1)phi)."""
    s1 = torch.sin(phases)
    sines = [s1]
    if n_harmonics > 1:
        c2 = 2.0 * torch.cos(phases)
        sines.append(c2 * s1)
        for _ in range(n_harmonics - 2):
            sines.append(c2 * sines[-1] - sines[-2])
    bank = torch.stack(sines, dim=-1)
    return bank * torch.sigmoid(periodicity)[..., None, None]


def project_kv(params, kv_embedding, compute_dtype=None):
    """Per-block K/V of a speaker KV bank [..., L, Ckv] ->
    {"k", "v": [..., n_blocks, L, A]}, in compute_dtype if given
    (`waveform_generator.py:298`)."""
    ks, vs = [], []
    for p in params["blocks"]:
        k, v = layers.cross_attention_project_kv(p["attn"], kv_embedding, compute_dtype)
        ks.append(k)
        vs.append(v)
    return {"k": torch.stack(ks, dim=-3), "v": torch.stack(vs, dim=-3)}


def source_features(cfg: WaveformGeneratorConfig, quantized_pitch, periodicity,
                    state):
    """The upsampler's source input at each stage rate: 4 tensors
    [B, T*spf, H+1] = [sin(k*phi) bank | 0.1 * noise]
    (`waveform_generator.py:412-454`), and the new (phase, noise_counter)."""
    b, t = quantized_pitch.shape
    start, step, new_phase = _source_phases(quantized_pitch, state["phase"])
    counters = state["noise_counter"][:, None] + torch.arange(
        t, dtype=torch.int64, device=quantized_pitch.device)
    feats = []
    spf = 1
    for i, (r, _) in enumerate(cfg.upsample):
        spf *= r
        stride = OUT_HOP_LENGTH // spf
        pos = torch.arange(1, spf + 1, dtype=torch.float32,
                           device=quantized_pitch.device) * float(stride)
        phases = start[..., None] + step[..., None] * pos  # [B, T, spf]
        noise = layers.hash_noise(counters, spf, cfg.noise_salt + i * 0x2545F491)
        harm = _harmonic_features(phases, periodicity, cfg.n_harmonics)
        feats.append(torch.cat([harm.reshape(b, t * spf, cfg.n_harmonics),
                                0.1 * noise.reshape(b, t * spf, 1)], dim=-1))
    new_counter = (state["noise_counter"] + t) & 0xFFFFFFFF
    return feats, new_phase, new_counter


def _attention(p, h, i, kv_cache, kv_bank, slot_onehot, compute_dtype):
    """Block i's cross-attention into the per-stream cache or the slot
    bank, f32/bf16 or int8 (`waveform_generator.py:370-395`)."""
    if slot_onehot is not None:
        if "k_scale" in kv_bank:
            return layers.cross_attention_slots_q8(
                p, h, kv_bank["k"][:, i], kv_bank["k_scale"][:, i], kv_bank["v"][:, i],
                kv_bank["v_scale"][:, i], slot_onehot, compute_dtype)
        return layers.cross_attention_slots(p, h, kv_bank["k"][:, i], kv_bank["v"][:, i],
                                            slot_onehot, compute_dtype)
    if kv_cache is None:
        raise ValueError("the 2.0.0-rc.0 vocoder needs kv_cache or kv_bank and kv_slot")
    if "k_scale" in kv_cache:
        return layers.cross_attention_cached_q(
            p, h, kv_cache["k"][:, i], kv_cache["k_scale"][:, i], kv_cache["v"][:, i],
            kv_cache["v_scale"][:, i], compute_dtype)
    return layers.cross_attention_cached(p, h, kv_cache["k"][:, i], kv_cache["v"][:, i],
                                         compute_dtype)


def apply(params, cfg: WaveformGeneratorConfig, phone, quantized_pitch,
          pitch_features, speaker_embedding, state, kv_cache=None, compute_dtype=None,
          kv_bank=None, kv_slot=None):
    """One frame per stream (`waveform_generator.py:315`, T = 1).

    phone: [B, 1, phone_channels]; quantized_pitch: [B, 1] int bins;
    pitch_features: [B, 1, 4]; speaker_embedding: [B, hidden];
    kv_cache: {"k", "v"(, "k_scale", "v_scale"): [B, n_blocks, L, A(|1)]}
    from `project_kv`, or kv_bank {"k", "v"(, scales): [Z, n_blocks, L,
    A(|1)]} with kv_slot [B] int, each stream's slot.  With compute_dtype
    the residual stream and the carries are in it; the head computes in
    it.  Returns (audio [B, 240] f32 in [-1, 1], new_state).
    """
    b, t = quantized_pitch.shape
    if t != 1:
        raise ValueError(f"the ported vocoder runs one frame per call, got T={t}")
    qp = torch.clamp(quantized_pitch, 0, cfg.pitch_bins - 1)
    pe = params["pitch_emb"]
    if compute_dtype is not None:
        pe = pe.to(compute_dtype)  # cast before the gather, as the JAX package
    h = (layers.linear(params["phone_in"], phone, compute_dtype)
         + pe[qp]
         + layers.linear(params["feat_in"], pitch_features, compute_dtype))
    h = h + layers.linear(params["spk_in"], speaker_embedding[:, None, :], compute_dtype)
    slot_onehot = None
    if kv_bank is not None and kv_slot is not None:
        slot_onehot = torch.nn.functional.one_hot(
            kv_slot, kv_bank["k"].shape[0]).to(torch.float32)
    new_blocks = []
    for i, (p, s) in enumerate(zip(params["blocks"], state["blocks"])):
        h, ns = layers.conv_block(p["conv"], h, s, 1, compute_dtype)
        h = _attention(p["attn"], h, i, kv_cache, kv_bank, slot_onehot, compute_dtype)
        new_blocks.append(ns)
    h = layers.layer_norm(params["out_ln"], h)

    src, new_phase, new_counter = source_features(
        cfg, qp, pitch_features[..., 0], state)
    head = fused_upsample if cfg.upsampler_kernel else fused_upsample_reference
    up, final = head_params(params["up"], params["final"], h.dtype)
    audio, new_states = head(up, final, h.contiguous(), [*state["up"], state["final"]], src)
    return audio, {
        "blocks": new_blocks,
        "up": new_states[:-1],
        "final": new_states[-1],
        "phase": new_phase,
        "noise_counter": new_counter,
    }
