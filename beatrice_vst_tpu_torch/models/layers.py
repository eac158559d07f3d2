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
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

_M32 = 0xFFFFFFFF


def linear(params, x):
    """y = x @ w + b (w is [in, out])."""
    return torch.matmul(x, params["w"]) + params["b"]


def layer_norm(params, x, eps: float = 1e-5):
    """Layer norm over the last axis with the population variance."""
    mean = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, unbiased=False)
    y = (x - mean) * torch.rsqrt(var + eps)
    return y * params["g"] + params["b"]


def causal_conv(params, x, state, dilation: int = 1):
    """Causal dilated conv over time, linear state convention
    (`layers.py:196`).

    x: [B, T, Cin]; state: [B, (k-1)*dilation, Cin] (past inputs, oldest
    first).  Tap j reads the input at time t - (k-1-j)*dilation.  Returns
    (y [B, T, Cout], new_state): the taps are concatenated into one
    [B, T, k*Cin] x [k*Cin, Cout] product, as in the JAX package.
    """
    w, b = params["w"], params["b"]
    k, c_in, c_out = w.shape
    t = x.shape[-2]
    full = torch.cat([state.to(x.dtype), x], dim=-2)
    new_state = full[..., t:, :] if state.shape[-2] else state
    taps = [full[..., j * dilation: j * dilation + t, :] for j in range(k)]
    xt = torch.cat(taps, dim=-1)
    y = torch.matmul(xt, w.reshape(k * c_in, c_out)) + b
    return y, new_state


def gelu(x):
    """GELU, tanh approximation (`jax.nn.gelu`'s default)."""
    return F.gelu(x, approximate="tanh")


def conv_block(params, x, state, dilation: int = 1):
    """Pre-LN ConvNeXt-style causal block (`layers.py:389`)."""
    h = layer_norm(params["ln"], x)
    h, new_state = causal_conv(params["conv"], h, state, dilation)
    h = gelu(h)
    h = linear(params["mlp_in"], h)
    h = gelu(h)
    h = linear(params["mlp_out"], h)
    return x + h, new_state


def cross_attention_project_kv(params, kv):
    """K/V projections of a speaker KV bank [..., L, Ckv] (`layers.py:416`):
    refreshed on speaker events, read every tick."""
    return linear(params["k"], kv), linear(params["v"], kv)


def cross_attention_cached(params, x, k, v):
    """Residual cross-attention against precomputed K/V (`layers.py:430`).

    x: [B, T, H]; k, v: [B, L, A].
    """
    h = layer_norm(params["ln"], x)
    q = linear(params["q"], h)  # [B, T, A]
    scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    w = torch.softmax(scores, dim=-1)
    o = torch.matmul(w, v)
    return x + linear(params["o"], o)


def snake(params, x):
    """Periodic polynomial snake x + Q(a*x)/a (`layers.py:583`): with
    u = frac(a*x/pi), Q = 16*(u*(1-u))^2."""
    a = torch.exp(params["log_alpha"])
    y = x * (a / math.pi)
    u = y - torch.floor(y)
    q = u * (1.0 - u)
    return x + (16.0 / (a + 1e-9)) * (q * q)


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
