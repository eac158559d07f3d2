"""Streaming layer primitives over parameter dicts (port of
`beatrice_vst_tpu/models/layers.py`).

Conventions kept from the JAX package so that the same `weights.npz`
feeds both: a linear `w` is `[in, out]`, a causal conv `w` is
`[k, Cin, Cout]` (`layers.py:36,81`), activations are time-major chunks
`[B, T, C]`, and streaming state is explicit.

Conv carries use the *linear* convention only: a `[B, R, Cin]` window of
the last R = (k-1)*dilation inputs in time order.  The JAX serving tick
keeps ring buffers instead (`layers.py:196-258`); a zero state is valid
in both conventions and the outputs are the same, so the port needs no
ring or layout knobs.

Compute dtype (`compute_dtype=torch.bfloat16`), as in the JAX package:
the operands of a product are rounded to it, products are summed in f32,
the bias is added in f32 and the result is rounded once
(`jnp.dot(..., preferred_element_type=f32)`; `matmul_f32`).  Layer norm
and the snake compute in f32 and return their input's dtype.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

_M32 = 0xFFFFFFFF


def matmul_f32(a, b):
    """a @ b with an f32 result, for operands of one dtype.  bf16 operands
    are multiplied exactly and summed in f32, so the caller rounds once:
    on the card through the bf16 GEMM with f32 output
    (`torch.mm(..., out_dtype=torch.float32)`), on the CPU by up-casting
    the operands (what XLA's CPU backend does)."""
    if a.dtype == torch.float32:
        return torch.matmul(a, b)
    if a.dtype != b.dtype:
        raise ValueError(f"matmul_f32 operands {a.dtype} and {b.dtype} differ")
    if a.is_cuda:
        if b.dim() == 2:
            y = torch.mm(a.reshape(-1, a.shape[-1]), b, out_dtype=torch.float32)
            return y.reshape(*a.shape[:-1], b.shape[-1])
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.matmul(a.float(), b.float())


def linear(params, x, compute_dtype=None, out_dtype=None):
    """y = x @ w + b (w is [in, out]).  With compute_dtype the operands are
    rounded to it and the result is emitted in it (or in out_dtype), the
    bias added in f32 before that one rounding (`layers.py:45`)."""
    w, b = params["w"], params["b"]
    if compute_dtype is None:
        y = torch.matmul(x, w) + b
        return y if out_dtype is None else y.to(out_dtype)
    y = matmul_f32(x.to(compute_dtype), w.to(compute_dtype)) + b.float()
    return y.to(out_dtype or compute_dtype)


def layer_norm(params, x, eps: float = 1e-5):
    """Layer norm over the last axis with the population variance, in f32;
    returns x's dtype (`layers.py:72`)."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, unbiased=False)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * params["g"] + params["b"]).to(x.dtype)


def causal_conv(params, x, state, dilation: int = 1, compute_dtype=None):
    """Causal dilated conv over time, linear state convention
    (`layers.py:196`).

    x: [B, T, Cin]; state: [B, (k-1)*dilation, Cin] (past inputs, oldest
    first).  Tap j reads the input at time t - (k-1-j)*dilation.  Returns
    (y [B, T, Cout], new_state): the taps are concatenated into one
    [B, T, k*Cin] x [k*Cin, Cout] product, as in the JAX package.  The
    new state keeps the state's dtype; with compute_dtype, y is emitted
    in it.
    """
    w, b = params["w"], params["b"]
    k, c_in, c_out = w.shape
    t = x.shape[-2]
    full = torch.cat([state.to(x.dtype), x], dim=-2)
    new_state = full[..., t:, :].to(state.dtype) if state.shape[-2] else state
    taps = [full[..., j * dilation: j * dilation + t, :] for j in range(k)]
    xt = torch.cat(taps, dim=-1)
    y = linear({"w": w.reshape(k * c_in, c_out), "b": b}, xt, compute_dtype)
    return y, new_state


def gelu(x):
    """GELU, tanh approximation (`jax.nn.gelu`'s default)."""
    return F.gelu(x, approximate="tanh")


def conv_block(params, x, state, dilation: int = 1, compute_dtype=None):
    """Pre-LN ConvNeXt-style causal block (`layers.py:389`)."""
    h = layer_norm(params["ln"], x)
    h, new_state = causal_conv(params["conv"], h, state, dilation, compute_dtype)
    h = gelu(h)
    h = linear(params["mlp_in"], h, compute_dtype)
    h = gelu(h)
    h = linear(params["mlp_out"], h, compute_dtype)
    return x + h.to(x.dtype), new_state


def cross_attention_project_kv(params, kv, compute_dtype=None):
    """K/V projections of a speaker KV bank [..., L, Ckv] (`layers.py:416`):
    refreshed on speaker events, read every tick."""
    return linear(params["k"], kv, compute_dtype), linear(params["v"], kv, compute_dtype)


def _dot(a, b):
    """A dot of two operands of one dtype emitted in that dtype, as
    `jnp.einsum` without a preferred element type: f32 sums, one
    rounding."""
    return matmul_f32(a, b).to(a.dtype)


def cross_attention_cached(params, x, k, v, compute_dtype=None):
    """Residual cross-attention against precomputed K/V (`layers.py:430`).

    x: [B, T, H]; k, v: [B, L, A].
    """
    h = layer_norm(params["ln"], x)
    q = linear(params["q"], h, compute_dtype)  # [B, T, A]
    k, v = k.to(q.dtype), v.to(q.dtype)
    scores = _dot(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    w = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    o = _dot(w, v)
    return x + linear(params["o"], o, compute_dtype).to(x.dtype)


def quantize_rows(x, dim: int = -1, floor: float = 1e-8):
    """Symmetric int8 quantization with a per-row scale along `dim`
    (`layers.py:445`): (q int8, scale f32 with `dim` reduced to 1).  The
    scale is at least floor / 127."""
    x32 = x.float()
    amax = x32.abs().amax(dim=dim, keepdim=True)
    scale = torch.clamp(amax, min=floor) / 127.0
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


def cross_attention_cached_q(params, x, k_q, k_scale, v_q, v_scale, compute_dtype=None):
    """`cross_attention_cached` with int8 K/V and per-row scales
    (`layers.py:459`): the scales are applied outside the contractions.

    k_q, v_q: [B, L, A] int8; k_scale, v_scale: [B, L, 1] f32.
    """
    h = layer_norm(params["ln"], x)
    q = linear(params["q"], h, compute_dtype)  # [B, T, A]
    scores = _dot(q, k_q.to(q.dtype).transpose(-1, -2)) / math.sqrt(q.shape[-1])
    scores = scores.float() * k_scale[..., 0][:, None, :]
    w = torch.softmax(scores, dim=-1)
    wv = (w * v_scale[..., 0][:, None, :]).to(q.dtype)
    o = _dot(wv, v_q.to(q.dtype))
    return x + linear(params["o"], o, compute_dtype).to(x.dtype)


def _masked_query(onehot, q):
    """[B, T, Z*A]: each stream's query in its slot's block, zeros
    elsewhere (the one-hot product of `layers.py:503`, exact)."""
    b, t, a = q.shape
    return (onehot[:, None, :, None] * q[:, :, None, :]).reshape(b, t, -1)


def _bank_rows(bank):
    """[Z, L, A] -> [Z*A, L] (the contraction over slot and channel)."""
    z, l, a = bank.shape
    return bank.permute(0, 2, 1).reshape(z * a, l)


def _select_rows(onehot, table):
    """[B, Z] one-hot and a [Z, L] table -> [B, L]: each stream's row, as
    an elementwise product and sum (one nonzero term: exact, whatever the
    card's matmul precision flags are)."""
    return (onehot[:, :, None] * table).sum(dim=1)


def _pick_slot(tmp, onehot):
    """[B, T, Z*A] and [B, Z] -> [B, T, A]: each stream's block (a sum with
    one nonzero term, exact)."""
    b, t, _ = tmp.shape
    z = onehot.shape[-1]
    return (tmp.reshape(b, t, z, -1) * onehot[:, None, :, None]).sum(dim=2)


def cross_attention_slots(params, x, k_z, v_z, onehot, compute_dtype=None):
    """Cross-attention against a shared slot bank of precomputed K/V
    (`layers.py:479`): x [B, T, H]; k_z, v_z [Z, L, A]; onehot [B, Z]
    selects each stream's slot.  The same contractions as the JAX
    package: the bank is read once, [B, Z*A] x [Z*A, L] and
    [B, L] x [L, Z*A], instead of a per-stream [B, L, A] gather.
    """
    h = layer_norm(params["ln"], x)
    q = linear(params["q"], h, compute_dtype)  # [B, T, A]
    a = q.shape[-1]
    k_z, v_z = k_z.to(q.dtype), v_z.to(q.dtype)
    oh = onehot.to(q.dtype)
    scores = matmul_f32(_masked_query(oh, q), _bank_rows(k_z)) / math.sqrt(a)  # [B, T, L]
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    z, l, _ = v_z.shape
    tmp = matmul_f32(w, v_z.permute(1, 0, 2).reshape(l, z * a)).to(q.dtype)  # [B, T, Z*A]
    o = _pick_slot(tmp.float(), oh.float()).to(q.dtype)
    return x + linear(params["o"], o, compute_dtype).to(x.dtype)


def _int8_dot(a, b):
    """The exact int32 result of a product of int8 tensors, as an f32
    tensor.  Each value is exact in f32 and in every reduced precision the
    card's f32 GEMM may use (TF32 keeps 11 significant bits, bf16 8), and
    every partial sum stays below 2^24 (L * 127^2 = 6.2 M at L = 384), so
    the f32 product is exact whatever the TF32 flags are."""
    return torch.matmul(a.float(), b.float())


def cross_attention_slots_q8(params, x, k_q, k_scale, v_q, v_scale, onehot,
                             compute_dtype=None):
    """`cross_attention_slots` with an int8 slot bank and int8 contractions
    (`layers.py:513`).

    k_q, v_q: [Z, L, A] int8; k_scale, v_scale: [Z, L, 1] f32; onehot
    [B, Z].  The query and the softmax weights are quantized per row; the
    two large contractions are int8 x int8 with exact int32 sums
    (`_int8_dot`); the scales are applied outside them.
    """
    h = layer_norm(params["ln"], x)
    q = linear(params["q"], h, compute_dtype)  # [B, T, A]
    a = q.shape[-1]
    q8, qs = quantize_rows(q)
    oh = onehot.float()
    si = _int8_dot(_masked_query(oh, q8), _bank_rows(k_q))  # [B, T, L]
    ks_sel = _select_rows(oh, k_scale[..., 0])  # [B, L]
    scores = si * (qs * ks_sel[:, None, :]) / math.sqrt(a)
    w = torch.softmax(scores, dim=-1)
    wv = w * _select_rows(oh, v_scale[..., 0])[:, None, :]
    wv8, ws = quantize_rows(wv, floor=1e-12)
    z, l, _ = v_q.shape
    tv = _int8_dot(wv8, v_q.permute(1, 0, 2).reshape(l, z * a))  # [B, T, Z*A]
    o = _pick_slot(tv, oh) * ws
    if compute_dtype is not None:
        o = o.to(compute_dtype)
    return x + linear(params["o"], o, compute_dtype).to(x.dtype)


def snake(params, x):
    """Periodic polynomial snake x + Q(a*x)/a (`layers.py:583`): with
    u = frac(a*x/pi), Q = 16*(u*(1-u))^2; in f32, returned in x's
    dtype."""
    a = torch.exp(params["log_alpha"].float())
    x32 = x.float()
    y = x32 * (a / math.pi)
    u = y - torch.floor(y)
    q = u * (1.0 - u)
    return (x32 + (16.0 / (a + 1e-9)) * (q * q)).to(x.dtype)


def _mul32(a, m: int):
    """(a * m) mod 2^32 for int64 a in [0, 2^32) without int64 overflow:
    the constant is split into 16-bit halves."""
    lo, hi = m & 0xFFFF, m >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & _M32


def hash_noise(counter, n: int, salt: int):
    """Deterministic per-stream uniform noise in [-1, 1): [B, n]
    (`layers.py:607`).

    The JAX package's uint32 splitmix-style hash, emulated in int64 with
    every product and sum taken mod 2^32, so it is bit-exact.  counter:
    [B] (or [B, T]) integer tensor holding uint32 values.
    """
    counter = counter.to(torch.int64) & _M32
    pos = (torch.arange(n, dtype=torch.int64, device=counter.device)
           + (salt & _M32)) & _M32
    z = (_mul32(counter[..., None], 0x9E3779B9) + _mul32(pos, 0x85EBCA6B)) & _M32
    z = _mul32(z ^ (z >> 16), 0x7FEB352D)
    z = _mul32(z ^ (z >> 15), 0x846CA68B)
    z = z ^ (z >> 16)
    return z.to(torch.float32) * (2.0 / 4294967296.0) - 1.0
