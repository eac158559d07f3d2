"""Independent NumPy (float64) oracle of the Beatrice-2 stage chain: a copy
of `beatrice_vst_tpu/reference_impl.py` (the port imports nothing of the
JAX package), kept line for line so that it is the same oracle and not a
new one; `tests/test_torch_reference_impl.py` holds the two equal.  It
uses no torch, so the port's float64 references (the oracle leg of
`beatrice_vst_tpu_torch/scripts/long_stream_soak.py`) run it anywhere.

The original's notes follow.

The closed reference binary only ships Windows/macOS static libraries, so
the executable golden reference for waveform parity on this platform is an
independent reimplementation: this module forwards the *same parameter
pytree* through a from-scratch NumPy implementation (np.fft instead of
matmul-DFT, argsort instead of top_k, float64 throughout, no JAX imports
in the compute path) and the golden tests require the JAX chain to match
it within the 1e-3 waveform gate (SURVEY.md section 4, strategy #2).

Everything here is deliberately written to the *spec* of models/ (the
docstrings and the reference C ABI contract), not by importing its code --
a bug shared between both implementations would have to be a spec bug.
Offline whole-utterance only; no streaming state (the chunk path is the
reference; streaming==chunk is tested separately).
"""

from __future__ import annotations

import numpy as np

from .constants import (
    IN_HOP_LENGTH,
    MAX_N_SPEAKERS,
    OUT_HOP_LENGTH,
    OUT_SAMPLE_RATE,
    PITCH_BIN_ZERO_HZ,
    PITCH_BINS_PER_OCTAVE,
    PITCH_BINS_PER_SEMITONE,
    VOICE_MORPH_WEIGHT_THRESHOLD,
)
from .ops.frontend import mel_filterbank


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_np(v) for v in tree]
    return np.asarray(tree, np.float64)


def gelu(x):
    # tanh approximation (jax.nn.gelu default)
    return 0.5 * x * (1.0 + np.tanh(np.sqrt(2.0 / np.pi) * (x + 0.044715 * x**3)))


def layer_norm(p, x, eps=1e-5):
    mean = x.mean(axis=-1, keepdims=True)
    var = x.var(axis=-1, keepdims=True)
    return (x - mean) / np.sqrt(var + eps) * p["g"] + p["b"]


def linear(p, x):
    return x @ p["w"] + p["b"]


def causal_conv(p, x, dilation=1):
    """x: [T, Cin] zero left-padded; returns [T, Cout]."""
    w, b = p["w"], p["b"]
    k = w.shape[0]
    t = x.shape[0]
    pad = (k - 1) * dilation
    full = np.concatenate([np.zeros((pad, x.shape[1])), x], axis=0)
    out = np.zeros((t, w.shape[2]))
    for j in range(k):
        out += full[j * dilation: j * dilation + t] @ w[j]
    return out + b


def conv_block(p, x, dilation=1):
    h = layer_norm(p["ln"], x)
    h = causal_conv(p["conv"], h, dilation)
    h = gelu(h)
    h = gelu(linear(p["mlp_in"], h))
    h = linear(p["mlp_out"], h)
    return x + h


def cross_attention(p, x, kv):
    h = layer_norm(p["ln"], x)
    q = linear(p["q"], h)          # [T, A]
    k = linear(p["k"], kv)         # [L, A]
    v = linear(p["v"], kv)
    scores = q @ k.T / np.sqrt(q.shape[-1])
    scores -= scores.max(axis=-1, keepdims=True)
    w = np.exp(scores)
    w /= w.sum(axis=-1, keepdims=True)
    return x + linear(p["o"], w @ v)


def snake(p, x):
    """Polynomial periodic snake: x + Q(a*x)/a with Q(y) = 16*(u*(1-u))^2,
    u = frac(y/pi) -- the model spec (see models/layers.snake)."""
    a = np.exp(p["log_alpha"])
    y = x * (a / np.pi)
    u = y - np.floor(y)
    q = u * (1.0 - u)
    return x + 16.0 * (q * q) / (a + 1e-9)


def hash_noise(counter, n, salt):
    """Bit-exact NumPy mirror of models/layers.hash_noise."""
    with np.errstate(over="ignore"):
        c = np.asarray(counter, np.uint32)[..., None] * np.uint32(0x9E3779B9)
        idx = c + (np.arange(n, dtype=np.uint32) + np.uint32(salt & 0xFFFFFFFF)) * np.uint32(0x85EBCA6B)
        z = idx
        z = (z ^ (z >> np.uint32(16))) * np.uint32(0x7FEB352D)
        z = (z ^ (z >> np.uint32(15))) * np.uint32(0x846CA68B)
        z = z ^ (z >> np.uint32(16))
    return z.astype(np.float64) * (2.0 / 4294967296.0) - 1.0


def logmel(audio, win, n_mels, fmax, hop=IN_HOP_LENGTH, sr=16000, floor=1e-5):
    """Framed log-mel: [T, n_mels] from [T*hop] with zero history."""
    t = len(audio) // hop
    full = np.concatenate([np.zeros(win - hop), audio])
    wnd = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(win) / win)
    frames = np.stack([full[i * hop: i * hop + win] * wnd for i in range(t)])
    power = np.abs(np.fft.rfft(frames, axis=-1)) ** 2
    mel = mel_filterbank(sr, win, n_mels, 0.0, fmax).astype(np.float64)
    return np.log(np.maximum(power @ mel, floor))


def phone_forward(p, cfg, audio):
    mel = logmel(audio, cfg.phone.win, cfg.phone.n_mels, 8000.0)
    h = linear(p["prenet"], mel)
    for blk, d in zip(p["blocks"], cfg.phone.dilations):
        h = conv_block(blk, h, d)
    return linear(p["out"], layer_norm(p["out_ln"], h))


def pitch_forward(p, cfg, audio, min_q=1, max_q=None, soft=False):
    """soft=True returns the softmax expectation over the masked bin
    logits (float bins) instead of the argmax -- the oracle counterpart
    of chain.apply(soft_pitch=True) / pitch_estimator.expected_bin."""
    max_q = max_q if max_q is not None else cfg.pitch.pitch_bins - 1
    mel = logmel(audio, cfg.pitch.win, cfg.pitch.n_mels, 4000.0)
    h = linear(p["prenet"], mel)
    for blk, d in zip(p["blocks"], cfg.pitch.dilations):
        h = conv_block(blk, h, d)
    h = layer_norm(p["out_ln"], h)
    logits = linear(p["logits"], h)
    feats = linear(p["features"], h)
    bins = np.arange(cfg.pitch.pitch_bins)
    masked = np.where((bins >= min_q) & (bins <= max_q), logits, -np.inf)
    if soft:
        e = np.exp(masked - masked.max(axis=-1, keepdims=True))
        probs = e / e.sum(axis=-1, keepdims=True)
        return (probs * bins).sum(axis=-1), feats
    return masked.argmax(axis=-1), feats


def vq_knn(phone, codebook, n):
    if n <= 0:
        return phone
    c2 = (codebook**2).sum(axis=-1)
    out = np.empty_like(phone)
    for t in range(phone.shape[0]):
        dist = c2 - 2.0 * codebook @ phone[t]
        idx = np.argsort(dist, kind="stable")[:n]
        out[t] = codebook[idx].mean(axis=0)
    return out


def transform_pitch(q, avg, inton, shift, corr, ctype, bins,
                    round_output=True):
    bps = PITCH_BINS_PER_SEMITONE
    tmp = avg + (q.astype(np.float64) - avg) * inton + bps * shift
    if corr != 0.0:
        if ctype == 0:
            nearest = (np.floor(tmp / bps) + 0.5) * bps
            delta = (tmp - nearest) * (2.0 / bps)
            absd = np.abs(delta)
            safe = np.maximum(absd, 1e-4)
            corrected = nearest + delta * safe**-corr * (bps / 2.0)
            tmp = np.where(absd < 1e-4, nearest, corrected)
        else:
            nearest = np.round(tmp / bps) * bps
            delta = (tmp - nearest) * (2.0 / bps)
            if corr > 1 - 1e-4:
                tmp = nearest
            else:
                tmp = nearest + np.sign(delta) * np.abs(delta) ** (
                    1.0 / (1.0 - corr)
                ) * (bps / 2.0)
    if not round_output:
        return np.clip(tmp, 1.0, float(bins - 1))
    return np.clip(np.round(tmp), 1, bins - 1).astype(np.int64)


def waveform_forward(p, cfg, phone, qp, feats, spk, kv=None,
                     phase_start=None):
    """phase_start: optional [T] source-phase trajectory (radians) to use
    instead of the f64 cumulative sum -- a HARNESS hook, not model spec.
    Long-horizon gates supply the phase accumulated from the chain's own
    f32 `frame_increments` (the runtime/seqpar.py lesson: a float64
    re-derivation differs ~1 ulp/frame systematically, which the 8th
    harmonic amplifies past the 1e-3 gate after a few hundred frames --
    that drift is phase-step quantization, not an implementation bug)."""
    wcfg = cfg.wg
    t = len(qp)
    qp = np.clip(qp, 0, wcfg.pitch_bins - 1)
    if np.issubdtype(np.asarray(qp).dtype, np.floating):
        # soft-pitch mode: linear interpolation between bracketing
        # embedding rows (equals the gather at integral bins)
        i0 = np.floor(qp).astype(np.int64)
        i1 = np.minimum(i0 + 1, wcfg.pitch_bins - 1)
        frac = (qp - i0)[:, None]
        pitch_term = p["pitch_emb"][i0] * (1.0 - frac) + p["pitch_emb"][i1] * frac
    else:
        pitch_term = p["pitch_emb"][qp]
    h = linear(p["phone_in"], phone) + pitch_term + linear(p["feat_in"], feats)
    h = h + linear(p["spk_in"], spk)[None, :]
    for blk in p["blocks"]:
        h = conv_block(blk["conv"], h, 1)
        if wcfg.use_kv_attention:
            h = cross_attention(blk["attn"], h, kv)
    h = layer_norm(p["out_ln"], h)

    # harmonic source with carried phase (zero initial)
    f0 = PITCH_BIN_ZERO_HZ * 2.0 ** (qp / PITCH_BINS_PER_OCTAVE)
    step = 2.0 * np.pi * f0 / OUT_SAMPLE_RATE
    frame_inc = step * OUT_HOP_LENGTH
    if phase_start is not None:
        start = np.asarray(phase_start, np.float64)[:t]
    else:
        start = np.cumsum(frame_inc) - frame_inc
        start = np.mod(start, 2.0 * np.pi)
    n = np.arange(1, OUT_HOP_LENGTH + 1)
    phases = start[:, None] + step[:, None] * n  # [T, 240]
    harm = np.sin(phases[..., None] * np.arange(1, wcfg.n_harmonics + 1))
    gate = 1.0 / (1.0 + np.exp(-feats[:, 0]))
    harm = harm * gate[:, None, None]
    counters = np.arange(t, dtype=np.uint32)

    x = h
    samples_per_frame = 1
    for i, (r, c_out) in enumerate(wcfg.upsample):
        y = causal_conv(p["up"][i]["conv"], x, 1)
        y = y.reshape(y.shape[0] * r, c_out)
        samples_per_frame *= r
        stride = OUT_HOP_LENGTH // samples_per_frame
        harm_r = harm[:, stride - 1:: stride, :].reshape(t * samples_per_frame, -1)
        noise_r = hash_noise(counters, samples_per_frame,
                             wcfg.noise_salt + i * 0x2545F491).reshape(-1, 1)
        src = np.concatenate([harm_r, 0.1 * noise_r], axis=-1)
        y = y + linear(p["up"][i]["src"], src)
        x = snake(p["up"][i]["snake"], y)
    y = causal_conv(p["final"], x, 1)
    return np.tanh(y[:, 0])


# ---- speaker morphing oracle (float64) -------------------------------------
#
# Mirrors the morph semantics of the reference (voice_morph_state.h:50-104,
# processor_core_2.cc:93-181, spherical_average.h) from the spec, so the
# morph/formant/lottery path of speakers/morpher.py can be golden-tested
# end-to-end through the chain.

_MORPH_EPSILON = 0.0008
LOTTERY_SALT = 0x10777E  # must match speakers/morpher.LOTTERY_SALT


def morph_voice_weights(cursor_x, cursor_y, falloff, marker_voice_id,
                        marker_x, marker_y, marker_count,
                        max_n_speakers=MAX_N_SPEAKERS):
    """Morph-pad weights for one stream: markers -> dense per-voice weights
    (voice_morph_state.h:50-85)."""
    marker_x = np.asarray(marker_x, np.float64)
    marker_y = np.asarray(marker_y, np.float64)
    idx = np.arange(marker_x.shape[0])
    active = idx < marker_count
    if falloff <= 0.0:
        w = active.astype(np.float64) / max(float(marker_count), 1.0)
    else:
        d2 = (cursor_x - marker_x) ** 2 + (cursor_y - marker_y) ** 2
        w = np.where(active, (d2 + _MORPH_EPSILON) ** -float(falloff), 0.0)
        w = w / max(w.sum(), 1e-30)
    dense = np.zeros(max_n_speakers)
    for m in idx[active]:
        dense[int(np.clip(marker_voice_id[m], 0, max_n_speakers - 1))] += w[m]
    return dense


def prepare_morph_weights(weights, n_speakers):
    """Fold out-of-range weights into the last speaker, threshold at 0.01
    (voice_morph_state.h:87-104)."""
    w = np.asarray(weights, np.float64).copy()
    count = min(int(n_speakers), w.shape[0])
    if count <= 0:
        return np.zeros_like(w)
    w[count - 1] += w[count:].sum()
    w[count:] = 0.0
    w[w < VOICE_MORPH_WEIGHT_THRESHOLD] = 0.0
    return w


def prune_top8(weights, k=8):
    """Keep the k largest weights (lowest index wins ties, like lax.top_k);
    returns (pruned, indices most-weighted-first)."""
    w = np.asarray(weights, np.float64)
    idx = np.argsort(-w, kind="stable")[:k]
    pruned = np.zeros_like(w)
    pruned[idx] = w[idx]
    return pruned, idx


def spherical_weighted_average(p_raw, w, n_iters=4):
    """Weighted spherical (Buss-Fillmore) mean of N unnormalized vectors,
    solved with L-BFGS(memory=2) on the sphere -- float64 mirror of the
    reference algorithm (spherical_average.h:81-444) including its
    stale-row UpdateVGDT quirk; result re-projected to unnormalized space
    (GetResult, spherical_average.h:237-244)."""
    p_raw = np.asarray(p_raw, np.float64)
    w = np.asarray(w, np.float64)
    eps = np.finfo(np.float64).eps
    norms = np.linalg.norm(p_raw, axis=-1, keepdims=True)
    p = np.where(norms > 0.0, p_raw / np.maximum(norms, 1e-30), p_raw)
    w_sum = w.sum()
    if w_sum <= 0.0:
        return np.zeros(p_raw.shape[1])
    wn = w / w_sum
    q = wn @ p
    q_norm = np.linalg.norm(q)
    if q_norm <= 0.0:
        return np.zeros(p_raw.shape[1])
    q = q / q_norm

    K, m = 2, p_raw.shape[1]
    s_hist, t_hist = np.zeros((K, m)), np.zeros((K, m))
    r_hist, gamma, mem = np.zeros(K), 1.0, 0

    def vgd(q):
        cos = np.clip(p @ q, -1.0, 1.0)
        theta = np.arccos(cos)
        inv_sinc = 1.0 / (np.sinc(theta / np.pi) + eps)
        v_un = wn * inv_sinc
        v = v_un / (np.sum(wn * cos * inv_sinc) + eps)
        g = (-2.0 * v_un) @ p
        g = g - (q @ g) * q
        d = g.copy()
        a = np.zeros(K)
        for k in range(K):
            i = (mem - k - 1) % K
            a[i] = r_hist[i] * (s_hist[i] @ d)
            d = d - a[i] * t_hist[i]
        d = gamma * d
        for k in range(K):
            i = (mem + k) % K
            b = r_hist[i] * (t_hist[i] @ d)
            d = d + (a[i] - b) * s_hist[i]
        return v, g, d

    v, g, d = vgd(q)
    for _ in range(n_iters):
        if np.linalg.norm(d) < 8.0 * eps:
            break
        q_new = q - d
        q_new = q_new / max(np.linalg.norm(q_new), 1e-30)
        s_hist[mem] = q_new - q
        t_hist[mem] = g  # stale row deliberately read by the recursion below
        v, g_new, d = vgd(q_new)
        t_row = g_new - g
        t_row = t_row - (q_new @ t_row) * q_new
        t_hist[mem] = t_row
        st = s_hist[mem] @ t_row
        r_hist[mem] = 1.0 / (st if st != 0.0 else eps)
        tt = t_row @ t_row
        gamma = st / (tt if tt != 0.0 else eps)
        mem = (mem + 1) % K
        q, g = q_new, g_new
    return v @ p_raw


def codebook_lottery(w8, top8, n_speakers, frame_counter):
    """Per-frame weighted random codebook pick (processor_core_2.cc:93-121):
    w8/top8 from prune_top8 gathered at the top indices; frame_counter [T]
    uint32 drives the deterministic hash RNG.  Returns [T] speaker ids."""
    u = (hash_noise(np.asarray(frame_counter, np.uint32), 1,
                    LOTTERY_SALT)[..., 0] + 1.0) * 0.5
    total = float(np.sum(w8))
    if total <= float(np.finfo(np.float32).eps):
        uniform = np.floor(u * n_speakers).astype(np.int64)
        return np.clip(uniform, 0, max(n_speakers - 1, 0))
    cum = np.cumsum(np.asarray(w8, np.float64))
    pick = np.argmax(cum[None, :] > (u * total)[:, None], axis=-1)
    return np.asarray(top8)[pick]


def morph_conditioning(bank, dense_weights, n_speakers, formant_index=4,
                       n_iters=4):
    """Morph-mode conditioning: spherical-average the additive and KV
    embeddings over the pruned top-8 speakers and add the formant-shift
    embedding (processor_core_2.cc:124-181, 468-481).

    bank: numpy speaker bank (additive [S,C], formant [9,C], kv [S,L,C]).
    Returns (speaker_embedding [C], kv [L,C] | None, pruned [S], top8 [8]).
    """
    w = prepare_morph_weights(dense_weights, n_speakers)
    pruned, top8 = prune_top8(w)
    w8 = pruned[top8]
    # zero-weight top-8 slots may point past the real speaker count (the
    # dense weight vector is MAX_N_SPEAKERS wide); they are excluded from
    # the average, so clip the gather like the JAX side does
    safe8 = np.clip(top8, 0, bank["additive"].shape[0] - 1)
    additive = spherical_weighted_average(
        np.asarray(bank["additive"], np.float64)[safe8], w8, n_iters)
    additive = additive + np.asarray(bank["formant"], np.float64)[
        int(np.clip(formant_index, 0, 8))]
    kv = None
    if "kv" in bank:
        pts = np.asarray(bank["kv"], np.float64)[safe8]  # [8, L, C]
        kv = np.stack([
            spherical_weighted_average(pts[:, l], w8, n_iters)
            for l in range(pts.shape[1])
        ])
    return additive, kv, pruned, top8


def vq_knn_per_frame(phone, codebook_bank, idx, n):
    """k-NN smoothing with a per-frame codebook choice (the lottery path):
    codebook_bank [S, K, C], idx [T] speaker per frame."""
    if n <= 0:
        return phone
    out = np.empty_like(phone)
    for t in range(phone.shape[0]):
        cb = np.asarray(codebook_bank[int(idx[t])], np.float64)
        dist = (cb ** 2).sum(axis=-1) - 2.0 * cb @ phone[t]
        j = np.argsort(dist, kind="stable")[:n]
        out[t] = cb[j].mean(axis=0)
    return out


def chain_forward(params, cfg, audio16, *, target_settings=None,
                  phase_start=None, soft_pitch=False):
    """Full offline forward for ONE stream: [T*160] @16k -> [T*240] @24k.

    target_settings: dict with speaker_embedding [256], kv [384,128],
    codebook [512,128], vq_num_neighbors, min_q, max_q,
    average_source_pitch, intonation_intensity, pitch_shift,
    pitch_correction, pitch_correction_type.  For the morph lottery path,
    codebook_bank [S,512,128] + codebook_idx [T] select a codebook per
    frame instead of the single per-stream codebook.
    """
    s = dict(target_settings or {})
    p = _np(params)
    spec = cfg.spec
    phone = phone_forward(p["phone"], cfg, np.asarray(audio16, np.float64))
    if spec.has_vq:
        if "codebook_bank" in s:
            phone = vq_knn_per_frame(
                phone, np.asarray(s["codebook_bank"], np.float64),
                np.asarray(s["codebook_idx"], np.int64),
                int(s.get("vq_num_neighbors", 0)))
        else:
            phone = vq_knn(phone, np.asarray(s["codebook"], np.float64),
                           int(s.get("vq_num_neighbors", 0)))
    qp_raw, feats = pitch_forward(
        p["pitch"], cfg, np.asarray(audio16, np.float64),
        int(s.get("min_q", 1)), int(s.get("max_q", spec.pitch_bins - 1)),
        soft=soft_pitch,
    )
    qp = transform_pitch(
        qp_raw,
        float(s.get("average_source_pitch", 52.0)),
        float(s.get("intonation_intensity", 1.0)),
        float(s.get("pitch_shift", 0.0)),
        float(s.get("pitch_correction", 0.0)),
        int(s.get("pitch_correction_type", 0)),
        spec.pitch_bins,
        round_output=not soft_pitch,
    )
    kv = np.asarray(s["kv"], np.float64) if spec.has_kv else None
    spk = np.asarray(s.get("speaker_embedding", np.zeros(256)), np.float64)
    return waveform_forward(p["wg"], cfg, phone, qp, feats, spk, kv,
                            phase_start=phase_start)
