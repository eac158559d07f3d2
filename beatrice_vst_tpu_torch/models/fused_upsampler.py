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

Two forms, picked by the dtype of the frame features `h`, as the JAX
kernel's `compute_dtype` (`pallas_upsampler.py:204`):
  * f32: everything in f32.
  * bf16: the frame features, the carries and the three matmul weights
    (conv, source and final-conv `w`) are bf16; source features, biases
    and snake alphas are f32.  Conv and source operands are rounded to
    bf16, products summed in f32, biases and the snake in f32; a stage's
    output is rounded to bf16 where the next stage reads it; audio is
    tanh in f32 (`pallas_upsampler.py:_kernel`, `:115-200`).

`fused_upsample` is the wrapper: on a CPU tensor it runs
`fused_upsample_reference`; on a CUDA tensor it launches the kernel of
the form of h's dtype (built with `nvcc`, loaded with `ctypes`) or
raises: f32 `csrc/fused_upsampler.cu`, bf16 `csrc/fused_upsampler_bf16.cu`
(tensor cores).  `launches` and `launches_bf16` count the two forms'
kernel launches on the card and nothing else.  A call made while a CUDA
graph is captured launches nothing: inside `recording()` it is counted
for that graph, and the graph's owner adds it to the counts once per
replay (`count_replay`); outside, the wrapper raises.  Two earlier
kernels stay as yardsticks that `chip_smoke.py` times the forms against,
reachable only through `_fused_upsample(..., source=...)` and counted in
`yardstick_launches`: the f32 form's first version
(`csrc/fused_upsampler_v1.cu`) and the bf16 form that does its
arithmetic as f32 FFMA (`csrc/fused_upsampler.cu`).

Bound on an H100 SXM (`bound_ms`; the source note in the .cu has the
count): 3.66 MFLOP per stream, so 0.94 GFLOP at B=256.  f32: over 67
TFLOP/s of f32 CUDA-core peak, 14.0 us; the bytes it must move (22.3 KB
per stream of inputs, carries and outputs plus 2.2 MB of weights, 7.9 MB
at B=256) take 2.4 us at 3.35 TB/s: bound by operations.  bf16: over
989 TFLOP/s of dense bf16 tensor-core peak, 0.95 us; with bf16 storage
it moves 17.8 KB per stream plus 1.1 MB of weights, 5.66 MB at B=256,
1.69 us: bound by bytes.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import functools
import math
import threading

import torch

from ..constants import OUT_HOP_LENGTH
from ..parallel import collectives
from . import layers

RATES = (4, 5, 4, 3)
CHANNELS = (128, 64, 32, 16)
HIDDEN = 256
N_SRC = 9  # 8 harmonics + noise
KERNEL = 3
# H100 SXM peaks (NVIDIA data sheet): f32 on CUDA cores, dense bf16 on
# the tensor cores, HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
DTYPES = (torch.float32, torch.bfloat16)

# kernel launches of the f32 and the bf16 form since the counts were last
# set to 0
launches = 0
launches_bf16 = 0
# launches of the yardsticks, by (source, dtype)
yardstick_launches = collections.Counter()
# the launches recorded into the CUDA graph being captured on this thread
# (`recording`)
_capture = threading.local()


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


def bytes_per_call(b: int, dtype=torch.float32) -> int:
    """Bytes the head must move for b streams: each input read once (frame
    features, carries, source features, weights) and each output written
    once (audio, new carries).  Frame features, carries and the matmul
    weights are stored in `dtype`; the rest is f32."""
    h, states, src, stages, final = expected_shapes(b)
    stored = [h, *states, *states] + [st[k] for st in stages for k in ("conv_w", "src_w")]
    stored.append(final["w"])
    f32 = [*src, (b, OUT_HOP_LENGTH), final["b"]]
    f32 += [st[k] for st in stages for k in ("conv_b", "src_b", "log_alpha")]
    size = torch.empty((), dtype=dtype).element_size()
    return (size * sum(math.prod(shape) for shape in stored)
            + 4 * sum(math.prod(shape) for shape in f32))


def _bound_times(b: int, dtype):
    """(seconds of operations at the dtype's peak, seconds of bytes)."""
    peak = PEAK_F32_FLOPS if dtype == torch.float32 else PEAK_BF16_FLOPS
    return flops_per_stream() * b / peak, bytes_per_call(b, dtype) / PEAK_BYTES_PER_S


def bound_ms(b: int, dtype=torch.float32) -> float:
    """Least time an H100 SXM could take for b streams: the larger of the
    operations over the dtype's peak (f32 CUDA cores, or dense bf16 tensor
    cores) and the bytes over memory bandwidth."""
    return max(_bound_times(b, dtype)) * 1e3


def bound_by(b: int, dtype=torch.float32) -> str:
    """"operations" or "bytes": which of the two sets `bound_ms(b, dtype)`."""
    ops, moved = _bound_times(b, dtype)
    return "operations" if ops >= moved else "bytes"


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


_ALIGN = 16  # the kernel reads frame features, carries and weights as vectors
# positions in `_check`'s launch order of the tensors stored in h's dtype:
# h, the 5 carries, and per stage conv w and source w, then the final w
_STORED = frozenset([*range(6), *(10 + 5 * i for i in range(4)),
                     *(12 + 5 * i for i in range(4)), 30])


def _check(up_params, final_params, h, states, src_feats):
    """Every argument's shape, dtype and device, and where h is on CUDA
    what the kernel needs of its layout (`_check_layout`).  Returns the 32
    tensors in launch order: h, the 5 carries, the 4 source tensors, then
    `_flat_weights`."""
    if len(up_params) != len(RATES) or len(states) != len(RATES) + 1 \
            or len(src_feats) != len(RATES):
        raise ValueError("fused_upsample takes 4 stages, 5 carries and 4 source tensors")
    if h.dtype not in DTYPES:
        raise ValueError(f"fused_upsample computes in float32 or bfloat16, not {h.dtype}")
    _refuse_split(up_params, final_params)
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
        dtype = h.dtype if i in _STORED else torch.float32
        if t.dtype != dtype:
            raise ValueError(f"fused_upsample argument {i}: dtype {t.dtype}, expected {dtype} "
                             f"(h is {h.dtype}; mixed dtypes are refused)")
        if t.device != h.device:
            raise ValueError(f"fused_upsample argument {i} is on {t.device}, h on {h.device}")
    if h.device.type == "cuda":
        _check_layout(got)
    return got


def _check_layout(tensors):
    """The kernel reads every argument as contiguous 16-byte vectors."""
    for i, t in enumerate(tensors):
        if not t.is_contiguous():
            raise ValueError(f"fused_upsample argument {i} is not contiguous")
        if t.data_ptr() % _ALIGN:
            raise ValueError(f"fused_upsample argument {i} is not {_ALIGN}-byte aligned")


def _refuse_split(up_params, final_params):
    """Raise on a weight split over 'model' (a `DTensor`): the head runs its
    four stages on one rank and needs every weight whole (`shard_tree`
    keeps them whole, `parallel/mesh.py:KEPT_WHOLE`)."""
    for i, t in enumerate(_flat_weights(up_params, final_params)):
        if collectives.is_sharded(t):
            raise ValueError(f"fused_upsample weight {i} is split over 'model' (a DTensor): "
                             "the head needs every weight whole")


def head_params(up_params, final_params, dtype):
    """The head's parameters with the matmul weights (conv, source and
    final-conv `w`) in `dtype`, as the wrapper takes them; tensors already
    in `dtype` are passed through."""
    up = [{"conv": {"w": p["conv"]["w"].to(dtype), "b": p["conv"]["b"]},
           "src": {"w": p["src"]["w"].to(dtype), "b": p["src"]["b"]},
           "snake": p["snake"]} for p in up_params]
    return up, {"w": final_params["w"].to(dtype), "b": final_params["b"]}


def fused_upsample_reference(up_params, final_params, h, states, src_feats):
    """Plain PyTorch version, with h's dtype as the compute dtype: the
    roundings of `pallas_upsampler.py:_kernel` (`:115-200`), whose f32 form
    is the stage loop of the JAX package's XLA path
    (`tests/test_pallas.py:33-44`).

    h: [B, 1, 256]; states: 5 carries [B, 2, C]; src_feats: 4 tensors
    [B, 4|20|80|240, 9].  Conv and source operands are rounded to h's
    dtype and their products summed in f32; biases and the snake are f32;
    each stage's output is rounded where the next stage reads it; the new
    carries keep their dtype.  Returns (audio [B, 240] f32, new_states).
    """
    cd = h.dtype
    b = h.shape[0]

    def conv(x, state, w, bias):
        """k=3 causal conv of x over [2 carried rows | x] (f32 out) and the
        new carry."""
        seq = torch.cat([state.to(x.dtype), x], dim=1)
        t = x.shape[1]
        xt = torch.cat([seq[:, j:j + t] for j in range(KERNEL)], dim=-1).to(cd)
        y = layers.matmul_f32(xt, w.reshape(-1, w.shape[-1]).to(cd)) + bias.float()
        return y, seq[:, -2:].to(state.dtype)

    x = h
    new_states = []
    for i, ((r, c_out), up) in enumerate(zip(zip(RATES, CHANNELS), up_params)):
        y, ns = conv(x, states[i], up["conv"]["w"], up["conv"]["b"])
        new_states.append(ns)
        y = y.reshape(b, y.shape[1] * r, c_out)
        y = y + (layers.matmul_f32(src_feats[i].to(cd), up["src"]["w"].to(cd))
                 + up["src"]["b"].float())
        x = layers.snake(up["snake"], y)  # f32
    y, ns = conv(x.to(cd), states[-1], final_params["w"], final_params["b"])
    new_states.append(ns)
    return torch.tanh(y)[..., 0], new_states


class _Args(ctypes.Structure):
    """Mirror of `FusedUpsamplerArgs<T>` in csrc/fused_upsampler.cu and
    csrc/fused_upsampler_bf16.cu (the same pointers for every form)."""

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


# the source of each form, and of the yardstick it is timed against
FORMS = {torch.float32: "fused_upsampler", torch.bfloat16: "fused_upsampler_bf16"}
YARDSTICKS = {torch.float32: "fused_upsampler_v1", torch.bfloat16: "fused_upsampler"}
# every source names its launcher and occupancy query by the dtype alone
_ENTRY = {torch.float32: ("fused_upsampler_launch", "fused_upsampler_occupancy"),
          torch.bfloat16: ("fused_upsampler_bf16_launch", "fused_upsampler_bf16_occupancy")}


@functools.lru_cache(maxsize=None)
def _launcher(source: str, dtype):
    """The launcher of the dtype's form in csrc/<source>.cu, built and
    loaded, its argument types set."""
    from .. import cuda_build

    if source not in (FORMS[dtype], YARDSTICKS[dtype]):
        raise ValueError(f"csrc/{source}.cu is not the {dtype} form or its yardstick")
    fn = getattr(cuda_build.load_library(source), _ENTRY[dtype][0])
    # (const FusedUpsamplerArgs<T>*, int batch, cudaStream_t)
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def occupancy(device=None, dtype=torch.float32) -> dict:
    """How many of the kernel's clusters of 8 blocks the card holds at
    once, and the kernel's dynamic shared memory per block, for the
    dtype's form."""
    from .. import cuda_build

    query = getattr(cuda_build.load_library(FORMS[dtype]), _ENTRY[dtype][1])
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
    tensors launch the kernel's form of h's dtype on the current stream,
    without synchronising, or raise.  The kernel has no backward (nor has
    the JAX kernel a VJP), so under autograd with an input that requires
    grad a CUDA call raises instead of returning outputs without a
    gradient: the trainer runs the plain head (`upsampler_kernel=False`)."""
    return _fused_upsample(up_params, final_params, h, states, src_feats)


def _requires_grad(*trees) -> bool:
    """Whether any tensor in the nested lists and dicts requires grad."""
    for node in trees:
        if isinstance(node, torch.Tensor):
            if node.requires_grad:
                return True
        elif isinstance(node, dict):
            if _requires_grad(*node.values()):
                return True
        elif isinstance(node, (list, tuple)) and _requires_grad(*node):
            return True
    return False


def _fused_upsample(up_params, final_params, h, states, src_feats, source=None):
    """`fused_upsample` with the kernel of csrc/<source>.cu: by default the
    form of h's dtype, else its yardstick (`YARDSTICKS`), for timing
    against."""
    got = _check(up_params, final_params, h, states, src_feats)
    if h.device.type == "cpu":
        return fused_upsample_reference(up_params, final_params, h, states, src_feats)
    if h.device.type != "cuda":
        raise ValueError(f"fused_upsample runs on cpu or cuda, not {h.device}")
    if torch.is_grad_enabled() and _requires_grad(up_params, final_params, h, states,
                                                  src_feats):
        raise RuntimeError("the fused upsampler kernel has no backward: run the plain head "
                           "(WaveformGeneratorConfig(upsampler_kernel=False)) under autograd")
    source = source or FORMS[h.dtype]
    recorded = None
    if torch.cuda.is_current_stream_capturing():
        recorded = getattr(_capture, "counts", None)
        if recorded is None:
            raise RuntimeError("fused_upsample captured into a CUDA graph outside "
                               "fused_upsampler.recording(): its replays would go uncounted")
    launch = _launcher(source, h.dtype)
    b = h.shape[0]
    audio = torch.empty((b, OUT_HOP_LENGTH), dtype=torch.float32, device=h.device)
    new_states = [torch.empty_like(s) for s in states]
    args = _pack(got, audio, new_states)
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        err = launch(ctypes.addressof(args), b, stream)
    if err != 0:
        raise RuntimeError(f"fused_upsampler kernel launch failed: CUDA error {err}")
    if recorded is not None:
        recorded[source, h.dtype] += 1
    else:
        _count(source, h.dtype, 1)
    return audio, new_states


def _count(source, dtype, n):
    """Add n launches of csrc/<source>.cu's kernel for `dtype` to its count."""
    global launches, launches_bf16
    if source != FORMS[dtype]:
        yardstick_launches[source, str(dtype)] += n
    elif dtype == torch.float32:
        launches += n
    else:
        launches_bf16 += n


@contextlib.contextmanager
def recording():
    """Around the capture of a CUDA graph on this thread: yields a Counter
    of the kernel launches the graph records, by (source, dtype), which
    go to no count (capture launches nothing).  Pass it to `count_replay`
    at each replay."""
    _capture.counts = counts = collections.Counter()
    try:
        yield counts
    finally:
        _capture.counts = None


def count_replay(recorded) -> None:
    """Count one replay of a graph that recorded `recorded` (`recording`):
    each of its kernel launches is a launch on the card."""
    for (source, dtype), n in recorded.items():
        _count(source, dtype, n)
