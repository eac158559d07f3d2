"""The vocoder's upsampler head at T=1 as one CUDA kernel, its plain
PyTorch version, and its launch counter.

Replaces the TPU kernel `beatrice_vst_tpu/models/pallas_upsampler.py:203
fused_upsample` (its `pl.pallas_call` at `:260`).  For one 10 ms frame per
stream it runs four depth-to-time stages (rates 4, 5, 4, 3; channels 128,
64, 32, 16): a k=3 causal conv over [2 carried rows | input] whose output
columns carry the rate, plus `linear(src_feats)` over the 9 source
features (sin k*phi for k = 1..8 and 0.1*noise), then the polynomial
snake; a final k=3 conv to one channel and tanh give 240 samples at
24 kHz.  It also returns the five new 2-row conv carries.

`fused_upsample` is the wrapper: on a CPU tensor it runs
`fused_upsample_reference`; on a CUDA tensor it launches the kernel of
`csrc/fused_upsampler.cu` (built with `nvcc`, loaded with `ctypes`) or
raises.  `launches` counts kernel launches and nothing else.

Bound on an H100 SXM, f32 (the source note in the .cu has the count):
3.66 MFLOP per stream, so 0.94 GFLOP at B=256, over 67 TFLOP/s of f32
CUDA-core peak is 14 us; the bytes it must move (22.3 KB per stream of
inputs, carries and outputs plus 2.2 MB of weights, 7.9 MB at B=256) take
2.4 us at 3.35 TB/s.  It is bound by operations.
"""

from __future__ import annotations

import ctypes

import torch

from ..constants import OUT_HOP_LENGTH
from . import layers

RATES = (4, 5, 4, 3)
CHANNELS = (128, 64, 32, 16)
HIDDEN = 256
N_SRC = 9  # 8 harmonics + noise
KERNEL = 3

launches = 0  # kernel launches since the count was last set to 0


def _stage_dims():
    """(c_in, rate, c_out, rows_in) of each stage at T=1."""
    out, c_in, rows = [], HIDDEN, 1
    for r, c in zip(RATES, CHANNELS):
        out.append((c_in, r, c, rows))
        c_in, rows = c, rows * r
    return out


def flops_per_stream() -> int:
    """Multiply-adds x 2 of one stream's frame: the four stage convs, the
    source projections and the final conv."""
    macs = 0
    for c_in, r, c_out, rows in _stage_dims():
        macs += rows * KERNEL * c_in * r * c_out + rows * r * N_SRC * c_out
    macs += OUT_HOP_LENGTH * KERNEL * CHANNELS[-1]
    return 2 * macs


def expected_shapes(b: int):
    """Shapes of (h, states, src_feats, stage weights, final weights)."""
    states = [(b, 2, c_in) for c_in, *_ in _stage_dims()] + [(b, 2, CHANNELS[-1])]
    src = [(b, rows * r, N_SRC) for _, r, _, rows in _stage_dims()]
    stages = [
        {"conv_w": (KERNEL, c_in, r * c), "conv_b": (r * c,),
         "src_w": (N_SRC, c), "src_b": (c,), "log_alpha": (c,)}
        for c_in, r, c, _ in _stage_dims()
    ]
    final = {"w": (KERNEL, CHANNELS[-1], 1), "b": (1,)}
    return (b, 1, HIDDEN), states, src, stages, final


def _flat_weights(up_params, final_params):
    """Weights in launch order: per stage conv w, conv b, src w, src b,
    log_alpha; then the final conv w, b."""
    out = []
    for p in up_params:
        out += [p["conv"]["w"], p["conv"]["b"], p["src"]["w"], p["src"]["b"],
                p["snake"]["log_alpha"]]
    return out + [final_params["w"], final_params["b"]]


def _check(up_params, final_params, h, states, src_feats):
    if len(up_params) != len(RATES) or len(states) != len(RATES) + 1 \
            or len(src_feats) != len(RATES):
        raise ValueError("fused_upsample takes 4 stages, 5 carries and 4 source tensors")
    b = h.shape[0]
    want_h, want_states, want_src, want_stages, want_final = expected_shapes(b)
    wants = [want_h, *want_states, *want_src]
    for st in want_stages:
        wants += [st["conv_w"], st["conv_b"], st["src_w"], st["src_b"], st["log_alpha"]]
    wants += [want_final["w"], want_final["b"]]
    got = [h, *states, *src_feats, *_flat_weights(up_params, final_params)]
    for i, (t, shape) in enumerate(zip(got, wants)):
        if tuple(t.shape) != shape:
            raise ValueError(f"fused_upsample argument {i}: shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if t.dtype != torch.float32:
            raise ValueError(f"fused_upsample argument {i}: dtype {t.dtype}, expected float32")
        if t.device != h.device:
            raise ValueError(f"fused_upsample argument {i} is on {t.device}, h on {h.device}")
    return got


def fused_upsample_reference(up_params, final_params, h, states, src_feats):
    """Plain PyTorch version: the stage loop of the JAX package's XLA path
    (`tests/test_pallas.py:33-44`).

    h: [B, 1, 256]; states: 5 carries [B, 2, C]; src_feats: 4 tensors
    [B, 4|20|80|240, 9].  Returns (audio [B, 240], new_states).
    """
    b = h.shape[0]
    x = h
    new_states = []
    for i, ((r, c_out), up) in enumerate(zip(zip(RATES, CHANNELS), up_params)):
        y, ns = layers.causal_conv(up["conv"], x, states[i])
        new_states.append(ns)
        y = y.reshape(b, y.shape[1] * r, c_out)
        y = y + layers.linear(up["src"], src_feats[i])
        x = layers.snake(up["snake"], y)
    y, ns = layers.causal_conv(final_params, x, states[-1])
    new_states.append(ns)
    return torch.tanh(y)[..., 0], new_states


class _Args(ctypes.Structure):
    """Mirror of `FusedUpsamplerArgs` in csrc/fused_upsampler.cu."""

    _fields_ = [
        ("h", ctypes.c_void_p),
        ("state", ctypes.c_void_p * 5),
        ("src", ctypes.c_void_p * 4),
        ("conv_w", ctypes.c_void_p * 4),
        ("conv_b", ctypes.c_void_p * 4),
        ("src_w", ctypes.c_void_p * 4),
        ("src_b", ctypes.c_void_p * 4),
        ("log_alpha", ctypes.c_void_p * 4),
        ("final_w", ctypes.c_void_p),
        ("final_b", ctypes.c_void_p),
        ("audio", ctypes.c_void_p),
        ("new_state", ctypes.c_void_p * 5),
    ]


def _library():
    from .. import cuda_build

    lib = cuda_build.load_library("fused_upsampler")
    fn = lib.fused_upsampler_launch
    # (const FusedUpsamplerArgs*, int batch, cudaStream_t)
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def fused_upsample(up_params, final_params, h, states, src_feats):
    """Run the upsampler head for one frame (same arguments and results as
    `fused_upsample_reference`).  CPU tensors take the plain version; CUDA
    tensors launch the kernel on the current stream, without
    synchronising, or raise."""
    global launches
    got = _check(up_params, final_params, h, states, src_feats)
    if h.device.type == "cpu":
        return fused_upsample_reference(up_params, final_params, h, states, src_feats)
    if h.device.type != "cuda":
        raise ValueError(f"fused_upsample runs on cpu or cuda, not {h.device}")
    for i, t in enumerate(got):
        if not t.is_contiguous():
            raise ValueError(f"fused_upsample argument {i} is not contiguous")
    launch = _library()
    b = h.shape[0]
    audio = torch.empty((b, OUT_HOP_LENGTH), dtype=torch.float32, device=h.device)
    new_states = [torch.empty_like(s) for s in states]
    w = _flat_weights(up_params, final_params)
    args = _Args()
    args.h = h.data_ptr()
    for i in range(5):
        args.state[i] = states[i].data_ptr()
        args.new_state[i] = new_states[i].data_ptr()
    for i in range(4):
        args.src[i] = src_feats[i].data_ptr()
        (args.conv_w[i], args.conv_b[i], args.src_w[i], args.src_b[i],
         args.log_alpha[i]) = (t.data_ptr() for t in w[5 * i: 5 * i + 5])
    args.final_w, args.final_b = w[-2].data_ptr(), w[-1].data_ptr()
    args.audio = audio.data_ptr()
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        err = launch(ctypes.addressof(args), b, stream)
    if err != 0:
        raise RuntimeError(f"fused_upsampler kernel launch failed: CUDA error {err}")
    launches += 1
    return audio, new_states
