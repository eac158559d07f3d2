"""WaveformGenerator: the speaker-conditioned streaming vocoder, a chunk of
T 10 ms frames -> T*240 samples at 24 kHz (port of
`beatrice_vst_tpu/models/waveform_generator.py`), for the three model
versions.

Frame-rate conditioning (phone, pitch-bin embedding, pitch features and
the additive speaker embedding), four causal conv blocks -- in 2.0.0-rc.0
each followed by cross-attention into the speaker K/V: a per-stream
projected cache (f32/bf16, or int8 with per-row scales) or a shared slot
bank read through one-hot contractions (f32/bf16, or int8 with int8
contractions); 2.0.0-alpha.2 and 2.0.0-beta.1 have no attention -- then a
harmonic-plus-noise source evaluated at every upsampler rate and the
depth-to-time upsampler head.  The head, chosen by T as in the JAX
package (`waveform_generator.py:439`): at T = 1 the fused head
(`fused_upsampler.py`: the CUDA kernel on a CUDA tensor, or with
`upsampler_kernel=False` its plain version); at T > 1 `upsample_stages`,
the stage loop of the JAX package's XLA path.  With soft pitch the bins
are continuous and the pitch embedding is interpolated between the
bracketing rows.  With a compute dtype the residual stream, the carries
and the head compute in it (`waveform_generator.py:336-395`).
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from ..constants import OUT_HOP_LENGTH, OUT_SAMPLE_RATE, VersionSpec
from ..device import resolve_device
from ..parallel import collectives
from . import layers
from .fused_upsampler import fused_upsample, fused_upsample_reference, head_params
from .io import params_from_numpy

_TWO_PI = 2.0 * math.pi
# 2*pi as the f32 value the f32 modulo uses (`jnp.mod(x, 2.0 * jnp.pi)`)
_TWO_PI_F32 = float(np.float32(_TWO_PI))


@dataclasses.dataclass(frozen=True)
class WaveformGeneratorConfig:
    pitch_bins: int
    phone_channels: int = 128
    hidden: int = 256
    n_blocks: int = 4
    kernel: int = 4
    # 2.0.0-rc.0's cross-attention into the speaker's K/V (beatrice.h:26-27)
    use_kv_attention: bool = False
    kv_channels: int = 128
    attn_dim: int = 64
    upsample: tuple = ((4, 128), (5, 64), (4, 32), (3, 16))
    up_kernel: int = 3
    n_harmonics: int = 8
    noise_salt: int = 0x5EED
    # True: at T = 1 the upsampler head goes through the fused_upsample
    # wrapper (the CUDA kernel on a CUDA tensor).  False forces its plain
    # PyTorch version on any device -- the yardstick the kernel is checked
    # against.  At T > 1 the head is always `upsample_stages`.
    upsampler_kernel: bool = True

    @classmethod
    def for_version(cls, spec: VersionSpec) -> "WaveformGeneratorConfig":
        return cls(pitch_bins=spec.pitch_bins, phone_channels=spec.phone_channels,
                   n_blocks=spec.n_blocks, use_kv_attention=spec.has_kv,
                   kv_channels=spec.kv_channels or 128)

    def __post_init__(self):
        if math.prod(r for r, _ in self.upsample) != OUT_HOP_LENGTH:
            raise ValueError(f"upsample rates {self.upsample} must multiply to {OUT_HOP_LENGTH}")


def init(gen: torch.Generator, cfg: WaveformGeneratorConfig, device="cuda"):
    """Random parameters with the JAX package's tree, shapes and
    distributions (`waveform_generator.py:99`), drawn from `gen`."""
    params = {
        "phone_in": layers.linear_init(gen, cfg.phone_channels, cfg.hidden),
        "pitch_emb": layers.normal(gen, (cfg.pitch_bins, cfg.hidden), 0.02),
        "feat_in": layers.linear_init(gen, 4, cfg.hidden),
        "spk_in": layers.linear_init(gen, cfg.hidden, cfg.hidden),
        "blocks": [],
        "up": [],
        "out_ln": layers.layer_norm_init(cfg.hidden),
    }
    for _ in range(cfg.n_blocks):
        block = {"conv": layers.conv_block_init(gen, cfg.hidden, cfg.kernel)}
        if cfg.use_kv_attention:
            block["attn"] = layers.cross_attention_init(gen, cfg.hidden, cfg.kv_channels,
                                                        cfg.attn_dim)
        params["blocks"].append(block)
    c_in = cfg.hidden
    for r, c_out in cfg.upsample:
        params["up"].append({
            "conv": layers.causal_conv_init(gen, cfg.up_kernel, c_in, r * c_out),
            "src": layers.linear_init(gen, cfg.n_harmonics + 1, c_out),
            "snake": layers.snake_init(c_out),
        })
        c_in = c_out
    params["final"] = layers.causal_conv_init(gen, cfg.up_kernel, c_in, 1)
    return params_from_numpy(params, device)


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


def _steps(quantized_pitch):
    """(per-sample phase step, per-frame phase increment) [B, T] f32."""
    f0 = quantized_pitch_to_hz(quantized_pitch.to(torch.float32))
    step = _TWO_PI * f0 / OUT_SAMPLE_RATE
    return step, step * OUT_HOP_LENGTH


def frame_increments(quantized_pitch):
    """Per-frame source-phase increment mod 2*pi, [*, T] f32
    (`waveform_generator.py:153`): bitwise what `_source_phases`
    integrates, so that sequence-parallel conversion (runtime/seqpar.py)
    sums the same values on the host."""
    return _mod(_steps(quantized_pitch)[1], _TWO_PI)


def _source_phases(quantized_pitch, phase0):
    """(start [B, T], step [B, T], new_phase [B]) (`waveform_generator.py:169`):
    the source phase at sample p = 1..240 of frame t is start + step * p.

    Frame-start phases are a prefix sum of the f32 per-frame increments
    taken mod 2*pi: a plain f32 cumsum of ~10 rad per frame drifts.  The
    JAX package folds the modulo into an associative scan; here the sum
    is taken in f64 and reduced once (one cumsum for any T, at rounding
    level of the scan's result; at T = 1 it is the increment itself).
    """
    step, frame_inc = _steps(quantized_pitch)
    inc_mod = _mod(frame_inc, _TWO_PI)
    csum = inc_mod
    if inc_mod.shape[1] > 1:
        csum = torch.remainder(torch.cumsum(inc_mod.double(), dim=1), _TWO_PI_F32).float()
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


def stage_sources(cfg: WaveformGeneratorConfig, quantized_pitch, state):
    """The source at each upsampler stage's rate: a list of (phases,
    noise), each [B, T, spf] at the stage's spf = 4, 20, 80, 240 samples
    per frame (`waveform_generator.py:412-430`), and the new (phase,
    noise_counter).  The noise depends only on the absolute frame index,
    so chunked and per-frame runs draw the same noise."""
    t = quantized_pitch.shape[1]
    dev = quantized_pitch.device
    start, step, new_phase = _source_phases(quantized_pitch, state["phase"])
    counters = state["noise_counter"][:, None] + torch.arange(t, dtype=torch.int64, device=dev)
    out = []
    spf = 1
    for i, (r, _) in enumerate(cfg.upsample):
        spf *= r
        pos = torch.arange(1, spf + 1, dtype=torch.float32, device=dev) * float(
            OUT_HOP_LENGTH // spf)
        out.append((start[..., None] + step[..., None] * pos,
                    layers.hash_noise(counters, spf, cfg.noise_salt + i * 0x2545F491)))
    new_counter = (state["noise_counter"] + t) & 0xFFFFFFFF
    return out, new_phase, new_counter


def source_features(cfg: WaveformGeneratorConfig, quantized_pitch, periodicity,
                    state):
    """The fused head's source input at each stage rate: 4 tensors
    [B, T*spf, H+1] = [sin(k*phi) bank | 0.1 * noise]
    (`waveform_generator.py:441-454`), and the new (phase, noise_counter)."""
    b, t = quantized_pitch.shape
    sources, new_phase, new_counter = stage_sources(cfg, quantized_pitch, state)
    feats = []
    for phases, noise in sources:
        n = phases.shape[-1] * t
        harm = _harmonic_features(phases, periodicity, cfg.n_harmonics)
        feats.append(torch.cat([harm.reshape(b, n, cfg.n_harmonics),
                                0.1 * noise.reshape(b, n, 1)], dim=-1))
    return feats, new_phase, new_counter


@functools.lru_cache(maxsize=None)
def _cheb_u_transposed(n_harmonics: int, device: str) -> torch.Tensor:
    """U^T for the [H, H] monomial coefficients U of Chebyshev-U, sin(k*phi)
    = sin(phi) * U_{k-1}(cos(phi)) (`waveform_generator.py:198`), f32 on
    `device` (made once per device)."""
    u = np.zeros((n_harmonics, n_harmonics), np.float64)
    u[0, 0] = 1.0
    if n_harmonics > 1:
        u[1, 1] = 2.0
        for k in range(2, n_harmonics):
            u[k, 1:] = 2.0 * u[k - 1, :-1]
            u[k] -= u[k - 2]
    return torch.from_numpy(np.ascontiguousarray(u.T.astype(np.float32))).to(device)


def _fold_src_weights(src_params, n_harmonics: int):
    """The source projection's weights with the Chebyshev-U basis change
    folded in (`waveform_generator.py:214`): [harm | noise] @ W equals
    [x | noise] @ W' for the monomial features x_j = gate*sin*cos^j, with
    W'[:H] = U^T @ W[:H], folded in f32."""
    w = src_params["w"].float()
    u_t = _cheb_u_transposed(n_harmonics, str(w.device))
    return torch.cat([u_t @ w[:n_harmonics], w[n_harmonics:]]), src_params["b"]


def _monomial_source_features(phases, periodicity, noise, n_harmonics: int,
                              compute_dtype=None):
    """[B, S, H+1] source features in the monomial basis: gate*sin(phi)*
    cos(phi)^j for j = 0..H-1 and the 0.1-scaled noise
    (`waveform_generator.py:234`).  sin and cos in f32; the power chain
    in the compute dtype."""
    dt = compute_dtype or torch.float32
    b = phases.shape[0]
    gate = torch.sigmoid(periodicity)[..., None]  # [B, T, 1]
    gs = (gate * torch.sin(phases)).reshape(b, -1).to(dt)
    cols = [gs]
    if n_harmonics > 1:
        pows = {1: torch.cos(phases).reshape(b, -1).to(dt)}
        for j in range(2, n_harmonics):
            pows[j] = pows[j // 2] * pows[j - j // 2]
        cols += [gs * pows[j] for j in range(1, n_harmonics)]
    return torch.stack([*cols, noise.to(dt)], dim=-1)


def upsample_stages(cfg: WaveformGeneratorConfig, up_params, final_params, h, up_states,
                    final_state, sources, periodicity, compute_dtype=None):
    """The upsampler head for a chunk of any T: the stage loop of the JAX
    package's XLA path (`waveform_generator.py:463-515`).  Per stage a
    causal conv whose output columns carry the rate, the source projection
    in the monomial basis with the folded weights, and the snake; then the
    final conv and tanh.  h: [B, T, hidden]; sources from
    `stage_sources`.  Returns (audio [B, T*240] f32, new up carries, new
    final carry)."""
    b = h.shape[0]
    x = h
    new_up = []
    for (r, c_out), up, state, (phases, noise) in zip(cfg.upsample, up_params, up_states,
                                                      sources):
        y, ns = layers.causal_conv(up["conv"], x, state, 1, compute_dtype)
        new_up.append(ns)
        y = y.reshape(b, y.shape[1] * r, c_out)
        feats = _monomial_source_features(phases, periodicity, 0.1 * noise.reshape(b, -1),
                                          cfg.n_harmonics, compute_dtype)
        w_f, b_f = _fold_src_weights(up["src"], cfg.n_harmonics)
        if compute_dtype is not None:
            w_f = w_f.to(compute_dtype)
        src = layers.matmul_f32(feats, w_f)
        y = y + src.to(y.dtype) + b_f.to(y.dtype)
        if compute_dtype is not None:
            y = y.to(compute_dtype)
        x = layers.snake(up["snake"], y)
    y, new_final = layers.causal_conv(final_params, x, final_state, 1, compute_dtype)
    return torch.tanh(y.float())[..., 0], new_up, new_final


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
          kv_bank=None, kv_slot=None, soft_pitch: bool = False, kv_embedding=None):
    """A chunk of T frames per stream (`waveform_generator.py:315`).

    phone: [B, T, phone_channels]; quantized_pitch: [B, T] int bins, or
    f32 continuous bins with soft_pitch; pitch_features: [B, T, 4];
    speaker_embedding: [B, hidden] or [B, T, hidden]; with attention
    (2.0.0-rc.0), kv_cache {"k", "v"(, "k_scale", "v_scale"): [B,
    n_blocks, L, A(|1)]} from `project_kv`, or kv_bank {"k", "v"(,
    scales): [Z, n_blocks, L, A(|1)]} with kv_slot [B] int, each stream's
    slot, or kv_embedding [B, L, Ckv], the raw speaker KV projected here
    (`layers.py:556 cross_attention`: the K/V weights get a gradient).
    With compute_dtype the residual stream and the carries are in
    it; the head computes in it.  Returns (audio [B, T*240] f32 in
    [-1, 1], new_state).
    """
    b, t = quantized_pitch.shape
    if cfg.use_kv_attention and kv_cache is None and kv_slot is None and kv_embedding is not None:
        kv_cache = project_kv(params, kv_embedding, compute_dtype)
    # split over 'model' (`parallel/mesh.py`), the table's block of hidden
    # columns on this rank: its rows are looked up, then gathered
    pe = collectives.local(params["pitch_emb"])
    if compute_dtype is not None:
        pe = pe.to(compute_dtype)  # cast before the gather, as the JAX package
    if soft_pitch:
        qp = torch.clamp(quantized_pitch.to(torch.float32), 0.0, float(cfg.pitch_bins - 1))
        i0 = torch.floor(qp).to(torch.int64)
        i1 = torch.clamp(i0 + 1, max=cfg.pitch_bins - 1)
        frac = (qp - i0.to(torch.float32))[..., None].to(pe.dtype)
        pitch_term = pe[i0] * (1.0 - frac) + pe[i1] * frac
    else:
        qp = torch.clamp(quantized_pitch, 0, cfg.pitch_bins - 1)
        pitch_term = pe[qp]
    if collectives.is_sharded(params["pitch_emb"]):
        pitch_term = collectives.gather_from_model(
            pitch_term, collectives.model_group(params["pitch_emb"]))
    h = (layers.linear(params["phone_in"], phone, compute_dtype)
         + pitch_term
         + layers.linear(params["feat_in"], pitch_features, compute_dtype))
    spk = speaker_embedding[:, None, :] if speaker_embedding.dim() == 2 else speaker_embedding
    h = h + layers.linear(params["spk_in"], spk, compute_dtype)
    slot_onehot = None
    if kv_bank is not None and kv_slot is not None:
        slot_onehot = torch.nn.functional.one_hot(
            kv_slot, kv_bank["k"].shape[0]).to(torch.float32)
    new_blocks = []
    for i, (p, s) in enumerate(zip(params["blocks"], state["blocks"])):
        h, ns = layers.conv_block(p["conv"], h, s, 1, compute_dtype)
        if cfg.use_kv_attention:
            h = _attention(p["attn"], h, i, kv_cache, kv_bank, slot_onehot, compute_dtype)
        new_blocks.append(ns)
    h = layers.layer_norm(params["out_ln"], h)

    periodicity = pitch_features[..., 0]  # feature 0 gates voicing
    if t == 1:
        src, new_phase, new_counter = source_features(cfg, qp, periodicity, state)
        head = fused_upsample if cfg.upsampler_kernel else fused_upsample_reference
        up, final = head_params(params["up"], params["final"], h.dtype)
        audio, new_states = head(up, final, h.contiguous(), [*state["up"], state["final"]],
                                 src)
        new_up, new_final = new_states[:-1], new_states[-1]
    else:
        sources, new_phase, new_counter = stage_sources(cfg, qp, state)
        audio, new_up, new_final = upsample_stages(
            cfg, params["up"], params["final"], h, state["up"], state["final"], sources,
            periodicity, compute_dtype)
    return audio, {
        "blocks": new_blocks,
        "up": new_up,
        "final": new_final,
        "phase": new_phase,
        "noise_counter": new_counter,
    }
