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

Bound on an H100 SXM, f32 (`bound_ms`; the source note in the .cu has the
count): 3.66 MFLOP per stream, so 0.94 GFLOP at B=256, over 67 TFLOP/s of
f32 CUDA-core peak is 14.0 us; the bytes it must move (22.3 KB per stream
of inputs, carries and outputs plus 2.2 MB of weights, 7.9 MB at B=256)
take 2.4 us at 3.35 TB/s.  It is bound by operations.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from ..constants import OUT_HOP_LENGTH
from . import layers

RATES = (4, 5, 4, 3)
CHANNELS = (128, 64, 32, 16)
HIDDEN = 256
N_SRC = 9  # 8 harmonics + noise
KERNEL = 3
# H100 SXM peaks (NVIDIA data sheet): f32 on CUDA cores, HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

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


def bytes_per_call(b: int) -> int:
    """Bytes the head must move for b streams: each input read once (frame
    features, carries, source features, weights) and each output written
    once (audio, new carries), f32."""
    h, states, src, stages, final = expected_shapes(b)
    per_call = [h, *states, *src, *states, (b, OUT_HOP_LENGTH)]
    per_call += [shape for st in stages for shape in st.values()] + list(final.values())
    return 4 * sum(math.prod(shape) for shape in per_call)


def bound_ms(b: int) -> float:
    """Least time an H100 SXM could take for b streams: the larger of the
    operations over f32 peak and the bytes over memory bandwidth."""
    return max(flops_per_stream() * b / PEAK_F32_FLOPS, bytes_per_call(b) / PEAK_BYTES_PER_S) * 1e3


def bound_by(b: int) -> str:
    """"operations" or "bytes": which of the two sets `bound_ms(b)`."""
    ops = flops_per_stream() * b / PEAK_F32_FLOPS
    return "operations" if ops >= bytes_per_call(b) / PEAK_BYTES_PER_S else "bytes"


@functools.lru_cache(maxsize=None)
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


_ALIGN = 16  # the kernel reads frame features, carries and weights as float4


def _check(up_params, final_params, h, states, src_feats):
    """Every argument's shape, dtype and device, and for the kernel its
    contiguity and alignment.  Returns the 32 tensors in launch order: h,
    the 5 carries, the 4 source tensors, then `_flat_weights`."""
    if len(up_params) != len(RATES) or len(states) != len(RATES) + 1 \
            or len(src_feats) != len(RATES):
        raise ValueError("fused_upsample takes 4 stages, 5 carries and 4 source tensors")
    kernel = h.device.type == "cuda"
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
        if kernel and not t.is_contiguous():
            raise ValueError(f"fused_upsample argument {i} is not contiguous")
        if kernel and t.data_ptr() % _ALIGN:
            raise ValueError(f"fused_upsample argument {i} is not {_ALIGN}-byte aligned")
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


def _pack(tensors, audio, new_states) -> _Args:
    """A new argument block for one launch: the pointers of `_check`'s 32
    tensors, the audio and the 5 new carries."""
    ptrs = [t.data_ptr() for t in tensors]
    args = _Args()
    args.h = ptrs[0]
    args.state[:] = ptrs[1:6]
    args.src[:] = ptrs[6:10]
    w = ptrs[10:]
    for i in range(4):
        (args.conv_w[i], args.conv_b[i], args.src_w[i], args.src_b[i],
         args.log_alpha[i]) = w[5 * i: 5 * i + 5]
    args.final_w, args.final_b = w[20], w[21]
    args.audio = audio.data_ptr()
    args.new_state[:] = [t.data_ptr() for t in new_states]
    return args


@functools.lru_cache(maxsize=None)
def _library(source: str = "fused_upsampler"):
    """csrc/<source>.cu built and loaded, its launcher's types set."""
    from .. import cuda_build

    lib = cuda_build.load_library(source)
    # (const FusedUpsamplerArgs*, int batch, cudaStream_t)
    lib.fused_upsampler_launch.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    lib.fused_upsampler_launch.restype = ctypes.c_int
    return lib


def occupancy(device=None) -> dict:
    """How many of the kernel's clusters of 8 blocks the card holds at
    once, and the kernel's dynamic shared memory per block."""
    query = _library().fused_upsampler_occupancy
    query.argtypes = [ctypes.c_void_p, ctypes.c_void_p]  # (int* clusters, int* smem_bytes)
    query.restype = ctypes.c_int
    clusters, smem = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(device):
        err = query(ctypes.addressof(clusters), ctypes.addressof(smem))
    if err != 0:
        raise RuntimeError(f"fused_upsampler occupancy query failed: CUDA error {err}")
    return {"max_active_clusters": clusters.value, "smem_bytes": smem.value}


def fused_upsample(up_params, final_params, h, states, src_feats):
    """Run the upsampler head for one frame (same arguments and results as
    `fused_upsample_reference`).  CPU tensors take the plain version; CUDA
    tensors launch the kernel on the current stream, without
    synchronising, or raise."""
    return _fused_upsample(up_params, final_params, h, states, src_feats)


def _fused_upsample(up_params, final_params, h, states, src_feats, source="fused_upsampler"):
    """`fused_upsample` with the kernel of csrc/<source>.cu (another
    version of the kernel with the same launcher, for timing against)."""
    global launches
    got = _check(up_params, final_params, h, states, src_feats)
    if h.device.type == "cpu":
        return fused_upsample_reference(up_params, final_params, h, states, src_feats)
    if h.device.type != "cuda":
        raise ValueError(f"fused_upsample runs on cpu or cuda, not {h.device}")
    b = h.shape[0]
    audio = torch.empty((b, OUT_HOP_LENGTH), dtype=torch.float32, device=h.device)
    new_states = [torch.empty_like(s) for s in states]
    args = _pack(got, audio, new_states)
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        err = _library(source).fused_upsampler_launch(ctypes.addressof(args), b, stream)
    if err != 0:
        raise RuntimeError(f"fused_upsampler kernel launch failed: CUDA error {err}")
    launches += 1
    return audio, new_states
