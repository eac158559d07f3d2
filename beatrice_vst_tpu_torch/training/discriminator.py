"""Adversarial critics for vocoder training (port of
`beatrice_vst_tpu/training/discriminator.py`).

  - Multi-period (MPD): one 2-D conv critic per prime period p, the
    waveform folded to [n/p, p].
  - Multi-resolution spectrogram (MRD): one critic per STFT resolution on
    log-magnitudes from the reconstruction loss's `_stft_mag`.
  - Pitch-conditioned (PCD): one critic on the waveform together with
    reference harmonic oscillators cos/sin(k*phi) at the batch's
    ground-truth pitch bins (`pitch_phase_channels`).

Parameters keep the JAX package's tree and layouts (a conv `w` is HWIO
[kh, kw, Cin, Cout]), so the same arrays feed both; the convs run NCHW
with the JAX package's "SAME" padding (the extra row of an odd pad at the
end).  Every critic returns (logits, feature maps) for feature matching.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..models.io import params_from_numpy
from .distill import _stft_mag

MPD_PERIODS = (2, 3, 5, 7, 11)
MRD_RESOLUTIONS = ((512, 128), (1024, 256), (256, 64))  # (fft, hop)
PCD_HARMONICS = (1, 2, 4)  # reference oscillators at k x conditioned F0
PCD_SPF = 240              # samples per 10 ms frame at the 24 kHz output
_MPD_CHANNELS = (32, 128, 512, 512)
_MRD_CHANNELS = (32, 64, 128, 128)
_PCD_CHANNELS = (32, 128, 256, 256)
_LRELU = 0.1


def _conv2d_init(gen, kh, kw, c_in, c_out):
    scale = 1.0 / math.sqrt(kh * kw * c_in)
    w = (torch.rand((kh, kw, c_in, c_out), generator=gen) * 2.0 - 1.0) * scale
    return {"w": w, "b": torch.zeros(c_out)}


def _critic_init(gen, channels, kh, kw, c_in=1):
    layers = []
    for c_out in channels:
        layers.append(_conv2d_init(gen, kh, kw, c_in, c_out))
        c_in = c_out
    layers.append(_conv2d_init(gen, 3, kw, c_in, 1))
    return layers


def init(gen: torch.Generator, device="cuda"):
    """Random critics with the JAX package's tree, shapes and
    distributions (`discriminator.py:99`: w ~ U(+-1/sqrt(kh*kw*Cin)),
    b = 0), drawn from `gen` (a CPU generator) in the order MPD, MRD,
    PCD; the values differ from JAX's."""
    params = {
        "mpd": [_critic_init(gen, _MPD_CHANNELS, kh=5, kw=1) for _ in MPD_PERIODS],
        "mrd": [_critic_init(gen, _MRD_CHANNELS, kh=3, kw=3) for _ in MRD_RESOLUTIONS],
        "pcd": _critic_init(gen, _PCD_CHANNELS, kh=5, kw=3, c_in=1 + 2 * len(PCD_HARMONICS)),
    }
    return params_from_numpy(params, device)


def _same_pad(size: int, k: int, stride: int):
    """(before, after) of XLA's "SAME" padding along one axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv2d(p, x, stride_h: int, compute_dtype=None):
    """x [B, C, H, W] -> [B, Cout, ceil(H/stride_h), W] f32 with "SAME"
    padding (`discriminator.py:61`).  With compute_dtype the operands are
    rounded to it and the products summed in f32 (the JAX conv's
    preferred f32 element type)."""
    w = p["w"]
    kh, kw = w.shape[0], w.shape[1]
    dt = compute_dtype or x.dtype
    xs = x.to(dt).float()
    ws = w.to(dt).float().permute(3, 2, 0, 1)  # HWIO -> OIHW
    top, bottom = _same_pad(x.shape[2], kh, stride_h)
    left, right = _same_pad(x.shape[3], kw, 1)
    y = F.conv2d(F.pad(xs, (left, right, top, bottom)), ws, stride=(stride_h, 1))
    return y + p["b"].float()[None, :, None, None]


def _critic_apply(layers, x, stride_h: int, compute_dtype=None):
    feats = []
    for p in layers[:-1]:
        x = F.leaky_relu(_conv2d(p, x, stride_h, compute_dtype), _LRELU)
        feats.append(x)
    return _conv2d(layers[-1], x, 1, compute_dtype), feats


def _fold_period(audio, period: int):
    """[B, n] -> [B, 1, ceil(n/p), p] (right-padded with zeros)."""
    b, n = audio.shape
    pad = (-n) % period
    return F.pad(audio, (0, pad)).reshape(b, 1, (n + pad) // period, period)


def pitch_phase_channels(audio, f0_bin):
    """[B, n] audio + [B, T] ground-truth pitch bins -> [B, SPF, T', C]
    (the JAX package's NHWC layout, `discriminator.py:128`): the waveform
    folded frame-major plus cos/sin(k*phi) for k in PCD_HARMONICS, phi the
    f32 running sum of 2*pi*F0/24000 per sample (bin -> Hz: midi = bin/8
    + 33), zero in unvoiced frames."""
    b, n = audio.shape
    t = min(n // PCD_SPF, f0_bin.shape[1])
    fb = f0_bin[:, :t]
    voiced = (fb > 0).float()
    hz = torch.where(fb > 0, 440.0 * 2.0 ** ((fb.float() / 8.0 + 33.0 - 69.0) / 12.0),
                     torch.zeros((), device=audio.device))
    hz_s = torch.repeat_interleave(hz, PCD_SPF, dim=1)
    v_s = torch.repeat_interleave(voiced, PCD_SPF, dim=1)
    phase = 2.0 * math.pi * torch.cumsum(hz_s, dim=1) / 24000.0
    chans = [audio[:, :t * PCD_SPF]]
    for k in PCD_HARMONICS:
        chans.append(v_s * torch.cos(k * phase))
        chans.append(v_s * torch.sin(k * phase))
    x = torch.stack(chans, dim=-1).reshape(b, t, PCD_SPF, len(chans))
    return x.permute(0, 2, 1, 3)


def apply(params, audio, compute_dtype=None, f0_bin=None):
    """Every critic on a [B, n] waveform: a list of (logits, feature
    maps), one per MPD period, then per MRD resolution, then, with f0_bin
    and a "pcd" critic in params, the pitch-conditioned one.  Tensors are
    NCHW."""
    outs = []
    for p, layers in zip(MPD_PERIODS, params["mpd"]):
        outs.append(_critic_apply(layers, _fold_period(audio, p), 3, compute_dtype))
    for (n_fft, hop), layers in zip(MRD_RESOLUTIONS, params["mrd"]):
        mag = _stft_mag(audio.float(), n_fft, hop)
        outs.append(_critic_apply(layers, torch.log(mag + 1e-5)[:, None], 2, compute_dtype))
    if f0_bin is not None and "pcd" in params:
        x = pitch_phase_channels(audio, f0_bin).permute(0, 3, 1, 2)
        outs.append(_critic_apply(params["pcd"], x, 3, compute_dtype))
    return outs
