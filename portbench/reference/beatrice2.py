"""Plain PyTorch reference of the Beatrice 2.0.0-rc.0 real-time tick, end
to end at 48 kHz, for a few streams at once.

It follows the float64 NumPy oracle of the chain (the program's
`reference_impl.py`, written to the model's specification) operation for
operation, batched over streams, and adds the streaming edge in its own
code: sanitize, input gain, the 48->16 kHz polyphase resampler, the chain,
the 24->48 kHz resampler and the output gain.  A stream's output is worked
out from the stream's whole input history, from zero state, as the
program's carried state holds it.  It imports nothing of the program and
reads the model directory (`weights.npz`, `speakers.npz`) with NumPy.

Precision: "float64" is the reference.  "tf32" and "fp8" are the controls
of the benchmark's correctness check: every product of the model (linear
layers, convolutions, attention, VQ distances) takes operands rounded to
TensorFloat-32 or to float8 e4m3 (each row or column scaled to the
format's range), summed in float32; everything else runs in float32.
Each is the step below the precision its configuration states (f32 with
TF32 off; bf16), which a later change could be tempted to take.

Departures from the oracle, all of the harness and none of the model:
  * the harmonic source's phase is carried frame by frame in float32 and
    reduced mod 2*pi every frame, as the model carries it, rather than a
    float64 cumulative sum (which drifts from it by an ulp a frame);
  * the edge's gains are constant: the benchmark sets every gain before a
    stream's first tick, so the 2 dB/ms ramp never runs.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch
import torch.nn.functional as F

from .filters import design_polyphase, mel_filterbank

PRECISIONS = ("float64", "tf32", "fp8")
IN_HOP = 160  # samples a frame at 16 kHz
OUT_HOP = 240  # samples a frame at 24 kHz
EDGE_HOP = 480  # samples a frame at 48 kHz
BINS_PER_OCTAVE = 96
BINS_PER_SEMITONE = 8.0
BIN_ZERO_HZ = 55.0
OUT_RATE = 24000
FP8_MAX = 448.0  # largest finite float8 e4m3fn
_M32 = 0xFFFFFFFF


def load_model(model_dir: str):
    """(weights, bank) of a model directory as nested dicts / lists of
    float32 NumPy arrays: "a/b/0/w" keys of weights.npz unflattened, a
    level whose keys are all digits a list."""
    with np.load(os.path.join(model_dir, "weights.npz")) as z:
        flat = {k: z[k] for k in z.files}
    with np.load(os.path.join(model_dir, "speakers.npz")) as z:
        bank = {k: z[k] for k in z.files}
    tree: dict = {}
    for key, value in flat.items():
        node = tree
        parts = key.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [lists(node[str(i)]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}

    return lists(tree), bank


def _round_tf32(x):
    """float32 rounded to TensorFloat-32's 10-bit mantissa, to nearest even."""
    i = x.float().contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


def _round_fp8(x, dim: int):
    """float32 rounded to float8 e4m3fn, scaled along `dim` to its range."""
    x = x.float()
    scale = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class Precision:
    """How the reference computes: its float dtype, and the rounding of a
    product's operands."""

    def __init__(self, name: str):
        if name not in PRECISIONS:
            raise ValueError(f"precision {name!r}, expected one of {PRECISIONS}")
        self.name = name
        self.dtype = torch.float64 if name == "float64" else torch.float32

    def mm(self, a, b):
        """a @ b, b [..., K, N]; the operands rounded to the precision."""
        if self.name == "tf32":
            a, b = _round_tf32(a), _round_tf32(b)
        elif self.name == "fp8":
            a, b = _round_fp8(a, -1), _round_fp8(b, -2)
        return torch.matmul(a, b)


def gelu(x):
    # tanh approximation, as the model specifies
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))


def layer_norm(p, x, eps=1e-5):
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * p["g"] + p["b"]


def linear(pr: Precision, p, x):
    return pr.mm(x, p["w"]) + p["b"]


def causal_conv(pr: Precision, p, x, dilation=1):
    """x [S, T, Cin] from zero history -> [S, T, Cout]; tap j reads
    t - (k-1-j)*dilation."""
    w, b = p["w"], p["b"]
    k, t = w.shape[0], x.shape[1]
    full = F.pad(x, (0, 0, (k - 1) * dilation, 0))
    out = b
    for j in range(k):
        out = out + pr.mm(full[:, j * dilation: j * dilation + t], w[j])
    return out


def conv_block(pr, p, x, dilation=1):
    h = layer_norm(p["ln"], x)
    h = gelu(causal_conv(pr, p["conv"], h, dilation))
    h = gelu(linear(pr, p["mlp_in"], h))
    return x + linear(pr, p["mlp_out"], h)


def cross_attention(pr, p, x, kv):
    """x [S, T, C] attends over each stream's own speaker K/V kv [S, L, Ckv]."""
    h = layer_norm(p["ln"], x)
    q = linear(pr, p["q"], h)
    k = linear(pr, p["k"], kv)
    v = linear(pr, p["v"], kv)
    w = torch.softmax(pr.mm(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1]), dim=-1)
    return x + linear(pr, p["o"], pr.mm(w, v))


def snake(p, x):
    """x + Q(a*x)/a with Q(y) = 16*(u*(1-u))^2, u = frac(y/pi)."""
    a = torch.exp(p["log_alpha"])
    y = x * (a / math.pi)
    u = y - torch.floor(y)
    q = u * (1.0 - u)
    return x + 16.0 * (q * q) / (a + 1e-9)


def _mul32(a, b: int):
    """(a * b) mod 2^32 for a in [0, 2^32), in int64 without overflow."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def hash_noise(counter, n: int, salt: int, dtype):
    """The model's uint32 hash noise in [-1, 1): counter [T] -> [T, n]."""
    pos = (torch.arange(n, dtype=torch.int64, device=counter.device) + (salt & _M32)) & _M32
    z = (_mul32(counter[:, None] & _M32, 0x9E3779B9) + _mul32(pos, 0x85EBCA6B)) & _M32
    z = _mul32(z ^ (z >> 16), 0x7FEB352D)
    z = _mul32(z ^ (z >> 15), 0x846CA68B)
    z = z ^ (z >> 16)
    return z.to(dtype) * (2.0 / 4294967296.0) - 1.0


def logmel(audio, win, n_mels, fmax, dtype, hop=IN_HOP, sr=16000, floor=1e-5):
    """Framed log-mel [S, T, n_mels] of audio [S, T*hop] from zero history."""
    t = audio.shape[-1] // hop
    full = F.pad(audio, (win - hop, 0))
    frames = full.unfold(-1, win, hop)[:, :t]
    n = torch.arange(win, dtype=dtype, device=audio.device)
    frames = frames * (0.5 - 0.5 * torch.cos(2.0 * math.pi * n / win))
    power = torch.fft.rfft(frames, dim=-1).abs() ** 2
    mel = torch.as_tensor(mel_filterbank(sr, win, n_mels, 0.0, fmax), dtype=dtype,
                          device=audio.device)
    return torch.log(torch.clamp(power @ mel, min=floor))


def transform_pitch(q, avg, inton, shift, corr, ctype, bins):
    """Pitch transform of integer bins q [S, T]; the controls [S, 1]."""
    tmp = avg + (q.to(avg.dtype) - avg) * inton + BINS_PER_SEMITONE * shift
    bps = BINS_PER_SEMITONE
    nearest0 = (torch.floor(tmp / bps) + 0.5) * bps
    delta0 = (tmp - nearest0) * (2.0 / bps)
    absd = delta0.abs()
    c0 = torch.where(absd < 1e-4, nearest0,
                     nearest0 + delta0 * absd.clamp_min(1e-4) ** (-corr) * (bps / 2.0))
    nearest1 = torch.round(tmp / bps) * bps
    delta1 = (tmp - nearest1) * (2.0 / bps)
    expo = 1.0 / (1.0 - torch.clamp(corr, max=1 - 1e-4))
    c1 = torch.where(corr > 1 - 1e-4, nearest1,
                     nearest1 + torch.sign(delta1) * delta1.abs() ** expo * (bps / 2.0))
    tmp = torch.where(corr != 0.0, torch.where(ctype == 0, c0, c1), tmp)
    return torch.clamp(torch.round(tmp), 1, bins - 1).to(torch.int64)


def resample(x, L: int, M: int, taps: int = 16, cutoff: float = 0.99):
    """Causal polyphase L/M resampling of x [S, n] from zero history
    (n a multiple of M): y[m] = sum_k W[m*M % L, k] * x[floor(m*M/L) - k]."""
    W, K, _ = design_polyphase(L, M, taps, cutoff)
    w = torch.as_tensor(W, dtype=x.dtype, device=x.device).flip(-1)  # [L, K]
    xp = F.pad(x, (K - 1, 0))[:, None]  # [S, 1, K - 1 + n]
    n_out = x.shape[-1] * L // M
    if L != 1 and M != 1:
        raise ValueError(f"resample {L}/{M}: only L = 1 or M = 1")
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        if L == 1:
            return F.conv1d(xp, w[:1, None], stride=M)[:, 0, :n_out]
        phases = F.conv1d(xp, w[:, None])  # [S, L, n]: y[m*L + r] in row r
    return phases.transpose(1, 2).reshape(x.shape[0], -1)[:, :n_out]


def _tree(node, dtype, device):
    if isinstance(node, dict):
        return {k: _tree(v, dtype, device) for k, v in node.items()}
    if isinstance(node, list):
        return [_tree(v, dtype, device) for v in node]
    return torch.as_tensor(np.asarray(node), dtype=dtype, device=device)


class Reference:
    """The reference tick for one model at one precision on one device.

    model: the configuration file's "model" group (the widths of the
    chain).  `convert(audio48, controls)` returns each stream's 48 kHz
    output for its whole input history."""

    def __init__(self, weights, bank, model: dict, precision: str = "float64",
                 device="cpu"):
        self.pr = Precision(precision)
        self.model = model
        self.device = torch.device(device)
        self.p = _tree(weights, self.pr.dtype, self.device)
        self.bank = _tree(bank, self.pr.dtype, self.device)

    # ---- the chain (per the model specification) ----

    def phone(self, audio16):
        m, pr = self.model["phone"], self.pr
        p = self.p["phone"]
        h = linear(pr, p["prenet"], logmel(audio16, m["win"], m["n_mels"], 8000.0, pr.dtype))
        for blk, d in zip(p["blocks"], m["dilations"]):
            h = conv_block(pr, blk, h, d)
        return linear(pr, p["out"], layer_norm(p["out_ln"], h))

    def pitch(self, audio16, min_q, max_q):
        m, pr = self.model["pitch"], self.pr
        p = self.p["pitch"]
        h = linear(pr, p["prenet"], logmel(audio16, m["win"], m["n_mels"], 4000.0, pr.dtype))
        for blk, d in zip(p["blocks"], m["dilations"]):
            h = conv_block(pr, blk, h, d)
        h = layer_norm(p["out_ln"], h)
        logits = linear(pr, p["logits"], h)
        feats = linear(pr, p["features"], h)
        bins = torch.arange(logits.shape[-1], device=logits.device)
        allowed = (bins >= min_q[:, None, None]) & (bins <= max_q[:, None, None])
        masked = torch.where(allowed, logits, torch.full_like(logits, -math.inf))
        return masked.argmax(dim=-1), feats

    def vq(self, phone, codebook, n_neighbors):
        """k-NN smoothing of each stream's phones against its codebook
        [S, K, C]: the mean of the n nearest entries (stable order)."""
        out = phone.clone()
        c2 = (codebook ** 2).sum(dim=-1)
        dist = c2[:, None, :] - 2.0 * self.pr.mm(phone, codebook.transpose(-1, -2))
        for s, n in enumerate(n_neighbors.tolist()):
            if n > 0:
                idx = torch.sort(dist[s], dim=-1, stable=True).indices[:, :n]
                out[s] = codebook[s][idx].mean(dim=1)
        return out

    def source_phases(self, qp):
        """Frame-start phases [S, T] and per-sample steps [S, T]: the
        increment of each frame in float32, the phase carried in float32
        and reduced mod 2*pi every frame."""
        f0 = BIN_ZERO_HZ * torch.pow(2.0, qp.to(torch.float32) / BINS_PER_OCTAVE)
        step = 2.0 * math.pi * f0 / OUT_RATE
        inc = step * OUT_HOP
        two_pi = torch.tensor(2.0 * math.pi, dtype=torch.float32, device=qp.device)
        phase = torch.zeros(qp.shape[0], dtype=torch.float32, device=qp.device)
        starts = torch.empty_like(inc)
        for t in range(qp.shape[1]):
            starts[:, t] = phase
            phase = torch.remainder(phase + inc[:, t], two_pi)
        return starts.to(self.pr.dtype), step.to(self.pr.dtype)

    def waveform(self, phone, qp, feats, spk, kv):
        m, pr, p = self.model["wg"], self.pr, self.p["wg"]
        s, t = qp.shape
        h = linear(pr, p["phone_in"], phone) + p["pitch_emb"][qp] + linear(pr, p["feat_in"], feats)
        h = h + linear(pr, p["spk_in"], spk)[:, None, :]
        for blk in p["blocks"]:
            h = conv_block(pr, blk["conv"], h, 1)
            h = cross_attention(pr, blk["attn"], h, kv)
        h = layer_norm(p["out_ln"], h)

        start, step = self.source_phases(qp)
        n = torch.arange(1, OUT_HOP + 1, dtype=pr.dtype, device=qp.device)
        phases = start[..., None] + step[..., None] * n  # [S, T, 240]
        k = torch.arange(1, m["n_harmonics"] + 1, dtype=pr.dtype, device=qp.device)
        harm = torch.sin(phases[..., None] * k)  # [S, T, 240, H]
        harm = harm * torch.sigmoid(feats[..., 0])[..., None, None]
        counters = torch.arange(t, dtype=torch.int64, device=qp.device)

        x, spf = h, 1
        for i, (r, c_out) in enumerate(m["upsample"]):
            y = causal_conv(pr, p["up"][i]["conv"], x, 1)
            y = y.reshape(s, -1, c_out)
            spf *= r
            stride = OUT_HOP // spf
            harm_r = harm[:, :, stride - 1:: stride, :].reshape(s, t * spf, -1)
            noise = hash_noise(counters, spf, m["noise_salt"] + i * 0x2545F491, pr.dtype)
            noise = noise.reshape(1, t * spf, 1).expand(s, -1, -1)
            y = y + linear(pr, p["up"][i]["src"], torch.cat([harm_r, 0.1 * noise], dim=-1))
            x = snake(p["up"][i]["snake"], y)
        return torch.tanh(causal_conv(pr, p["final"], x, 1)[..., 0])

    # ---- the tick, end to end ----

    def convert(self, audio48, controls: dict):
        """audio48 [S, T*480] each stream's input history at 48 kHz (T a
        whole number of frames); controls {field: [S]} with the fields of
        `CONTROL_FIELDS` -> [S, T*480] at 48 kHz, in the precision's dtype."""
        dt, dev = self.pr.dtype, self.device
        c = {k: torch.as_tensor(np.asarray(v), device=dev) for k, v in controls.items()}
        x = torch.as_tensor(np.asarray(audio48), device=dev).to(dt)
        x = torch.clamp(torch.nan_to_num(x, nan=0.0, posinf=0.0, neginf=0.0), -4.0, 4.0)
        x = x * torch.pow(10.0, c["input_gain_db"].to(dt) / 20.0)[:, None]
        x16 = resample(x, 1, 3)

        target = c["target_speaker"]
        spk = self.bank["additive"][target] + self.bank["formant"][c["formant_index"]]
        phone = self.vq(self.phone(x16), self.bank["codebook"][target], c["vq_num_neighbors"])
        q_raw, feats = self.pitch(x16, c["min_q"], c["max_q"])
        col = {k: c[k].to(dt)[:, None] for k in ("average_source_pitch", "intonation_intensity",
                                                   "pitch_shift", "pitch_correction")}
        qp = transform_pitch(q_raw, col["average_source_pitch"], col["intonation_intensity"],
                             col["pitch_shift"], col["pitch_correction"],
                             c["pitch_correction_type"][:, None], self.model["pitch_bins"])
        y24 = self.waveform(phone, qp, feats, spk, self.bank["kv"][target])
        y48 = resample(y24, 2, 1)
        return y48 * torch.pow(10.0, c["output_gain_db"].to(dt) / 20.0)[:, None]


# the controls the tick reads, each stream's value set by the benchmark
CONTROL_FIELDS = ("target_speaker", "formant_index", "pitch_shift", "vq_num_neighbors",
                  "input_gain_db", "output_gain_db", "min_q", "max_q",
                  "average_source_pitch", "intonation_intensity", "pitch_correction",
                  "pitch_correction_type")
