"""Weighted spherical averages (Buss-Fillmore), batched (port of
`beatrice_vst_tpu/ops/spherical_average.py`).

The reference's L-BFGS(memory 2) iteration on the unit sphere with a fixed
number of updates (4, the reference's budget):
  - normalise the N points p; q0 = normalise(sum_n w_n p_n);
  - per update: theta_n = angle(p_n, q), v_n = w_n / sinc(theta_n)
    normalised, the Riemannian gradient g, the two-loop L-BFGS step d,
    q <- normalise(q - d);
  - the result is sum_n v_n p_raw_n (the raw, unnormalised points).

Written once on [..., N, M] tensors: every leading axis (streams, K/V rows)
is a lane, and no Python loop runs over lanes.  A lane whose step fell
below 8 eps is frozen by masks, as the reference stops early, so every lane
still updating has made the same number of updates and its history ring
position is the update count mod 2.
"""

from __future__ import annotations

import math

import torch

from ..constants import SPH_AVG_MAX_N_UPDATES

_K = 2  # L-BFGS memory (the reference's num_memory)


def _normalize(x):
    norm = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    return torch.where(norm > 0.0, x / torch.clamp(norm, min=1e-30), x), norm[..., 0]


def _dot(a, b):
    """[..., M] . [..., M] -> [...]"""
    return (a * b).sum(-1)


def _compute_vgd(p_norm, w, q, s, t, r, gamma, mem: int):
    """One UpdateVGD pass (`spherical_average.py:48`): (v [..., N], g
    [..., M], d [..., M]).  s, t: K tensors [..., M]; r: K tensors [...];
    mem: the ring position of every lane still updating."""
    eps = torch.finfo(q.dtype).eps
    cos = torch.clamp(torch.matmul(p_norm, q[..., None])[..., 0], -1.0, 1.0)
    inv_sinc = 1.0 / (torch.sinc(torch.arccos(cos) / math.pi) + eps)
    v_un = w * inv_sinc
    v = v_un / ((w * cos * inv_sinc).sum(-1, keepdim=True) + eps)
    g = torch.matmul((-2.0 * v_un)[..., None, :], p_norm)[..., 0, :]
    g = g - _dot(q, g)[..., None] * q  # onto the tangent plane at q
    d = g
    a = [None] * _K
    for k in range(_K):
        i = (mem - k - 1) % _K
        a[i] = r[i] * _dot(s[i], d)
        d = d - a[i][..., None] * t[i]
    d = gamma[..., None] * d
    for k in range(_K):
        i = (mem + k) % _K
        d = d + (a[i] - r[i] * _dot(t[i], d))[..., None] * s[i]
    return v, g, d


def spherical_average(p_raw, w, n_iters: int = SPH_AVG_MAX_N_UPDATES):
    """Spherical weighted mean of each lane's N points (`spherical_average.py:148`).

    p_raw: [..., N, M] unnormalised points; w: [..., N] nonnegative
    weights (0 excludes a point).  Returns [..., M] in unnormalised space;
    zeros where the weights are all zero or the mean direction is zero
    (the reference then never computes v)."""
    eps = torch.finfo(p_raw.dtype).eps
    p_norm, _ = _normalize(p_raw)
    w_sum = w.sum(-1, keepdim=True)
    wn = torch.where(w_sum > 0.0, w / torch.clamp(w_sum, min=1e-30), w)
    q, q_norm = _normalize(torch.matmul(wn[..., None, :], p_norm)[..., 0, :])
    degenerate = (w_sum[..., 0] <= 0.0) | (q_norm <= 0.0)

    zeros = torch.zeros_like(q)
    s, t = [zeros] * _K, [zeros] * _K
    r = [torch.zeros_like(q_norm)] * _K
    gamma = torch.ones_like(q_norm)
    v, g, d = _compute_vgd(p_norm, wn, q, s, t, r, gamma, 0)
    converged = degenerate
    for it in range(n_iters):
        mem = it % _K
        converged = converged | (torch.linalg.vector_norm(d, dim=-1) < 8.0 * eps)
        keep, keep_m = converged, converged[..., None]
        # UpdateQS
        q_new, _ = _normalize(q - d)
        s_new = list(s)
        s_new[mem] = q_new - q
        # UpdateVGDT: t[mem] holds the old g while UpdateVGD runs, and the
        # two-loop recursion reads that stale row (with the equally stale
        # r[mem]) -- the reference's behaviour, kept on purpose
        t_tmp = list(t)
        t_tmp[mem] = g
        v_new, g_new, d_new = _compute_vgd(p_norm, wn, q_new, s_new, t_tmp, r, gamma, mem)
        t_row = g_new - g
        t_row = t_row - _dot(q_new, t_row)[..., None] * q_new
        # UpdateGammaR
        st = _dot(s_new[mem], t_row)
        tt = _dot(t_row, t_row)
        r_new = 1.0 / torch.where(st == 0.0, eps, st)
        gamma_new = st / torch.where(tt == 0.0, eps, tt)
        # converged lanes keep everything they had
        s[mem] = torch.where(keep_m, s[mem], s_new[mem])
        t[mem] = torch.where(keep_m, t[mem], t_row)
        r[mem] = torch.where(keep, r[mem], r_new)
        q =torch.where(keep_m, q, q_new)
        gamma = torch.where(keep, gamma, gamma_new)
        v = torch.where(keep_m, v, v_new)
        g = torch.where(keep_m, g, g_new)
        d = torch.where(keep_m, d, d_new)
    v = torch.where(degenerate[..., None], 0.0, v)
    return torch.matmul(v[..., None, :], p_raw)[..., 0, :]
