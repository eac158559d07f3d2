"""The golden runs: the JAX package's output on klatt8, stored in
`tests/data/torch_engine_golden.npz` (the engine) and
`tests/data/torch_offline_golden.npz` (offline conversion), and what
makes them -- the streams' controls, the settings and the input signals
-- so that the port on any device can be held to them.

The file holds, for 4 streams x 20 ticks of `swept_sine`, the output
[ticks, streams, 480] of the JAX `StreamEngine` on the CPU in its default
configuration `EngineConfig.realtime(4)` (f32, slot-bank K/V, shared-bank
VQ) under the key "f32", and in `EngineConfig.realtime(4,
compute_dtype="bfloat16")` under "bf16".  `tests/test_torch_engine.py`
regenerates it with the JAX package and requires it to match
(`PYTHONPATH=. python tests/test_torch_engine.py` rewrites it).

The gates: an f32 engine is held to "f32" at atol 1e-3, the waveform gate
of `tests/test_golden.py`.  A bf16 engine is held by an envelope: its
largest and its RMS deviation from "f32" may each be at most twice the JAX
bf16 engine's own ("bf16" against "f32").  bf16 roundings taken in
another order can flip a pitch-bin argmax or a VQ neighbour, so a tight
gate against the JAX bf16 output would not be honest.

The offline file holds, under the key "f32", the output of the JAX
package's `convert_utterance` on the CPU for `offline_signal` (1.5 s at
44.1 kHz in and out, so both resamplers are fractional) with
OFFLINE_SETTINGS, f32, in chunks of OFFLINE_CHUNK_FRAMES frames (a carry
between chunks).  `tests/test_torch_offline.py` regenerates it and
requires it to match (`PYTHONPATH=. python tests/test_torch_offline.py`
rewrites it); the port is held to it at atol 1e-3.

The morph file `tests/data/torch_morph_golden.npz` holds `run_morph`'s
output [MORPH_TICKS, MORPH_CAPACITY, 480] of the JAX `StreamEngine` on the
CPU on klatt8 under the names of MORPH_CONFIGS (each with n_morph_slots =
MORPH_SLOTS, so the slot pool runs out), and under "offline" the JAX
`convert_utterance` of `offline_signal` with OFFLINE_SETTINGS and the
weights of MORPH_OFFLINE_STREAM.  The scenario: a direct stream, a
0.5 / 0.5 tie, eight speakers with one below the 0.01 threshold, a single
speaker, all-zero weights (degenerate: zero embeddings and a uniform
codebook lottery), a direct stream switched to morph at MORPH_SWITCH_TICK
after both slots are leased (it reads its dominant speaker's base slot),
the tie switched to a direct speaker at MORPH_LEAVE_TICK (its slot is
released) and `recover()` at MORPH_RECOVER_TICK (the replay leases the
released slot to the single-speaker stream).
`tests/test_torch_morph_engine.py` regenerates it and requires it to
match (`PYTHONPATH=. python tests/test_torch_morph_engine.py` rewrites
it); f32 engines and offline conversion are held to it at atol 1e-3,
slots bf16 by the envelope against "slots_f32".

The serving file `tests/data/torch_serve_golden.npz` holds `run_serve`'s
output through the JAX `ModelHost` (jit, realtime=False) on the CPU on
klatt8: for each session i of SERVE_SESSIONS, "s{i}" the audio it pulled
after each tick, concatenated, and "s{i}_len" the length of each pull.
The scenario: capacity SERVE_CAPACITY, SERVE_TICKS manual ticks, each
session fed `serve_signal` at its own rate in blocks of SERVE_BLOCKS
samples (one tick ahead) and pulled once after each tick; a session at
48 kHz with a voice and a pitch shift, whose output gain is edited and
context reset just before tick SERVE_RESET_TICK; one at 44.1 kHz with a
voice and a formant shift; one at 16 kHz in a two-voice morph set through
the parameter surface's morph pad; one at 32 kHz opened at tick
SERVE_OPEN_TICK and closed at tick SERVE_CLOSE_TICK.
`tests/test_torch_serving.py` regenerates it and requires it to match
(`PYTHONPATH=. python tests/test_torch_serving.py` rewrites it); the
port's ModelHost is held to it at atol 1e-3, and in pipeline mode to its
own plain run one tick later.
"""

from __future__ import annotations

import numpy as np

CAPACITY = 4
TICKS = 20
SEED = 0
# per stream: (target_speaker, formant_index, vq_num_neighbors, pitch_shift)
CONTROLS = [(0, 4, 0, 0.0), (3, 2, 4, 2.0), (5, 6, 8, -3.0), (7, 0, 1, 0.5)]
F32_ATOL = 1e-3
ENVELOPE = 2.0
OFFLINE_RATE = 44100
OFFLINE_SECONDS = 1.5
OFFLINE_CHUNK_FRAMES = 64
# ConversionSettings fields (the same for both packages)
OFFLINE_SETTINGS = dict(target_speaker=3, formant_shift=0.5, pitch_shift=2.0,
                        vq_num_neighbors=4)


MORPH_CAPACITY = 6
MORPH_TICKS = 20
MORPH_SLOTS = 2
MORPH_TARGET = 8  # klatt8's speaker count: morph mode
MORPH_SWITCH_TICK = 8
MORPH_LEAVE_TICK = 10
MORPH_RECOVER_TICK = 12
# name -> EngineConfig.realtime keywords (the same for both packages)
MORPH_CONFIGS = {
    "per_stream_f32": dict(kv_cache_mode="per_stream", vq_shared_bank=False,
                           n_morph_slots=MORPH_SLOTS),
    "slots_f32": dict(n_morph_slots=MORPH_SLOTS),
    "slots_bf16": dict(compute_dtype="bfloat16", n_morph_slots=MORPH_SLOTS),
}
# per stream: (target_speaker, formant_index, vq_num_neighbors, pitch_shift)
MORPH_CONTROLS = [(3, 4, 4, 0.0), (MORPH_TARGET, 2, 4, 2.0), (MORPH_TARGET, 6, 4, -3.0),
                  (MORPH_TARGET, 4, 8, 0.5), (MORPH_TARGET, 3, 4, 0.0), (1, 5, 4, 1.0)]
# per stream: dense weights over klatt8's 8 speakers (none: direct)
MORPH_WEIGHTS = [
    None,
    [0.0, 0.5, 0.0, 0.0, 0.0, 0.5, 0.0, 0.0],  # a tie
    [0.25, 0.2, 0.15, 0.12, 0.1, 0.09, 0.085, 0.005],  # one below the threshold
    [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0, 0.0],  # a single speaker
    [0.0] * 8,  # degenerate
    [0.1, 0.0, 0.6, 0.0, 0.3, 0.0, 0.0, 0.0],  # set at MORPH_SWITCH_TICK
]
MORPH_LEAVE_SPEAKER = 4  # stream 1's direct speaker from MORPH_LEAVE_TICK
MORPH_OFFLINE_STREAM = 2


def morph_controls(weights, n_speakers: int = MORPH_TARGET):
    """Dense weights over n_speakers -> (morph_weights [256] f32,
    morph_top_idx [8] int32): folded, thresholded and pruned by the port's
    `pruned_morph_weights` on the CPU, so both packages' engines get the
    same values."""
    import torch

    from .constants import MAX_N_SPEAKERS
    from .speakers.morpher import pruned_morph_weights

    dense = np.zeros((1, MAX_N_SPEAKERS), np.float32)
    dense[0, :len(weights)] = weights
    pruned, top = pruned_morph_weights(torch.from_numpy(dense), torch.tensor([n_speakers]))
    return pruned[0].numpy(), top[0].numpy().astype(np.int32)


def set_morph(engine, i, pruned, top, target: int = MORPH_TARGET) -> None:
    """Put stream i of either package's `StreamEngine` in morph mode with
    the pruned weights and top-8 indices of `morph_controls`."""
    engine.set_control(i, "target_speaker", np.int32(target))
    engine.set_control(i, "morph_weights", pruned)
    engine.set_control(i, "morph_top_idx", top)


def run_morph(engine, to_numpy=np.asarray) -> np.ndarray:
    """The morph scenario through a fresh engine of capacity
    MORPH_CAPACITY (either package's `StreamEngine`): [MORPH_TICKS,
    MORPH_CAPACITY, 480] of `swept_sine`."""
    audio = swept_sine(cap=MORPH_CAPACITY, ticks=MORPH_TICKS)
    for i, (speaker, formant, vq, shift) in enumerate(MORPH_CONTROLS):
        if engine.admit() != i:
            raise ValueError("run_morph needs a fresh engine")
        engine.set_control(i, "formant_index", np.int32(formant))
        engine.set_control(i, "vq_num_neighbors", np.int32(vq))
        engine.set_control(i, "pitch_shift", np.float32(shift))
        if speaker == MORPH_TARGET:
            set_morph(engine, i, *morph_controls(MORPH_WEIGHTS[i]))
        else:
            engine.set_control(i, "target_speaker", np.int32(speaker))
    out = []
    for k in range(MORPH_TICKS):
        if k == MORPH_SWITCH_TICK:
            set_morph(engine, 5, *morph_controls(MORPH_WEIGHTS[5]))
        if k == MORPH_LEAVE_TICK:
            engine.set_control(1, "target_speaker", np.int32(MORPH_LEAVE_SPEAKER))
        if k == MORPH_RECOVER_TICK:
            engine.recover()
        out.append(to_numpy(engine.tick(audio[:, 480 * k:480 * (k + 1)])))
    return np.stack(out)


def swept_sine(seed: int = SEED, cap: int = CAPACITY, ticks: int = TICKS) -> np.ndarray:
    """Swept sine (120 Hz upward) plus noise from a numpy seed at 48 kHz,
    [cap, ticks * 480] f32; every stream gets the same sweep and its own
    noise."""
    rng = np.random.default_rng(seed)
    n = np.arange(480 * ticks) / 48000.0
    sweep = 0.3 * np.sin(2 * np.pi * (120 * n + 200 * n * n))
    return (sweep[None] + 0.02 * rng.standard_normal((cap, n.size))).astype(np.float32)


def offline_signal(seed: int = SEED, seconds: float = OFFLINE_SECONDS,
                   rate: int = OFFLINE_RATE) -> np.ndarray:
    """A sine swept upward from 110 Hz plus noise from a numpy seed,
    [seconds * rate] f32."""
    rng = np.random.default_rng(seed)
    n = np.arange(int(seconds * rate)) / rate
    sweep = 0.3 * np.sin(2 * np.pi * (110 * n + 60 * n * n))
    return (sweep + 0.02 * rng.standard_normal(n.size)).astype(np.float32)


def admit_all(engine) -> None:
    """Admit len(CONTROLS) streams and set their controls; works on the
    JAX package's StreamEngine and on the port's."""
    for speaker, formant, vq, shift in CONTROLS:
        i = engine.admit()
        engine.set_control(i, "target_speaker", np.int32(speaker))
        engine.set_control(i, "formant_index", np.int32(formant))
        engine.set_control(i, "vq_num_neighbors", np.int32(vq))
        engine.set_control(i, "pitch_shift", np.float32(shift))


def run(engine, to_numpy=np.asarray, frames: int = TICKS) -> np.ndarray:
    """Admit the golden streams and run `frames` frames of `swept_sine`
    through the engine, `engine.cfg.frames_per_tick` frames a tick:
    [ticks, streams, frames_per_tick * 480]."""
    admit_all(engine)
    n = engine.cfg.frames_per_tick * 480
    audio = swept_sine(ticks=frames)
    return np.stack([to_numpy(engine.tick(audio[:, n * k:n * (k + 1)]))
                     for k in range(frames * 480 // n)])


EDITS_CAPACITY = 4
EDITS_TICKS = 32
EDITS_SEED = 3


def run_edits(engine, to_numpy=np.asarray, reset_context=None, keep=None) -> np.ndarray:
    """EDITS_TICKS ticks of `swept_sine` through a fresh engine of capacity
    EDITS_CAPACITY (either package's `StreamEngine`, any frames_per_tick),
    with the stream table and the controls edited between ticks: gain and
    pitch edits, an admit, two morphs, an evict and a re-admit,
    `reset_context` twice and `recover()`.  reset_context(i) resets stream
    i's context (default: the port's `engine.reset_context`); `keep`, a
    list, receives every tick's output as `tick` returned it.  Returns
    [ticks, EDITS_CAPACITY, frames_per_tick * 480]."""
    reset_context = reset_context or engine.reset_context
    n = engine.cfg.frames_per_tick * 480
    audio = swept_sine(EDITS_SEED, EDITS_CAPACITY, EDITS_TICKS * n // 480)

    def controls(i, speaker, formant, vq, shift):
        engine.set_control(i, "target_speaker", np.int32(speaker))
        engine.set_control(i, "formant_index", np.int32(formant))
        engine.set_control(i, "vq_num_neighbors", np.int32(vq))
        engine.set_control(i, "pitch_shift", np.float32(shift))

    def admit(i, *values):
        if engine.admit() != i:
            raise ValueError("run_edits needs a fresh engine")
        controls(i, *values)

    for i in range(3):
        admit(i, *CONTROLS[i])
    events = {
        3: lambda: (engine.set_control(1, "pitch_shift", np.float32(3.0)),
                    engine.set_control(0, "output_gain_db", np.float32(-6.0))),
        5: lambda: admit(3, *CONTROLS[3]),
        7: lambda: set_morph(engine, 2, *morph_controls(MORPH_WEIGHTS[2])),
        10: lambda: engine.evict(1),
        12: lambda: admit(1, 6, 5, 2, -1.0),
        14: lambda: reset_context(0),
        17: lambda: set_morph(engine, 3, *morph_controls(MORPH_WEIGHTS[1])),
        20: engine.recover,
        23: lambda: engine.set_control(2, "target_speaker", np.int32(5)),
        26: lambda: (engine.set_control(3, "input_gain_db", np.float32(4.0)),
                     reset_context(1)),
    }
    out = []
    for k in range(EDITS_TICKS):
        if k in events:
            events[k]()
        y = engine.tick(audio[:, n * k:n * (k + 1)])
        if keep is not None:
            keep.append(y)
        out.append(to_numpy(y))
    return np.stack(out)


def load(path) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def deviation(got, ref) -> dict:
    """Largest and RMS |got - ref|."""
    d = np.asarray(got, np.float64) - np.asarray(ref, np.float64)
    return {"max": float(np.abs(d).max()), "rms": float(np.sqrt(np.mean(d * d)))}


def envelope(got, golden) -> dict:
    """A bf16 engine's output against the golden file: its deviation from
    the JAX f32 engine, the JAX bf16 engine's, their ratios (each must be
    at most ENVELOPE) and, for the record, its deviation from the JAX bf16
    engine."""
    port = deviation(got, golden["f32"])
    jax_bf16 = deviation(golden["bf16"], golden["f32"])
    ratio = {k: port[k] / jax_bf16[k] for k in port}
    return {"vs_f32": port, "jax_bf16_vs_f32": jax_bf16, "ratio": ratio,
            "ok": all(r <= ENVELOPE for r in ratio.values()),
            "vs_jax_bf16": deviation(got, golden["bf16"])}


SERVE_CAPACITY = 4
SERVE_TICKS = 40
SERVE_SEED = 5
SERVE_BLOCKS = (441, 137, 1000)  # push sizes, in turn, at the session's rate
SERVE_RESET_TICK = 20
SERVE_OPEN_TICK = 10
SERVE_CLOSE_TICK = 25
SERVE_RESET_GAIN_DB = -12.0  # session 0's output gain, set just before its reset


def _serve_sessions():
    """Per session: (rate, opened before tick, closed before tick or None,
    [(parameter id, value)])."""
    from .params.schema import ParameterID as P

    morph = [(P.VOICE, MORPH_TARGET), (P.VOICE_MORPH_MARKER_COUNT, 2.0),
             (P.VOICE_MORPH_MARKER_VOICE_BASE, 1.0), (P.VOICE_MORPH_MARKER_VOICE_BASE + 1, 5.0),
             (P.VOICE_MORPH_CURSOR_X, 0.35)]
    return [(48000, 0, None, [(P.VOICE, 3), (P.PITCH_SHIFT, 2.0)]),
            (44100, 0, None, [(P.VOICE, 6), (P.FORMANT_SHIFT, 0.5)]),
            (16000, 0, None, morph),
            (32000, SERVE_OPEN_TICK, SERVE_CLOSE_TICK, [(P.VOICE, 1)])]


def serve_signal(rate: int, index: int, seed: int = SERVE_SEED) -> np.ndarray:
    """Session `index`'s input at `rate`: a sine swept up from
    100 + 30 * index Hz plus noise from a numpy seed, SERVE_TICKS + 2
    ticks long, f32."""
    rng = np.random.default_rng(seed + index)
    n = np.arange((SERVE_TICKS + 2) * rate // 100) / rate
    sweep = 0.3 * np.sin(2 * np.pi * ((100 + 30 * index) * n + 150 * n * n))
    return (sweep + 0.02 * rng.standard_normal(n.size)).astype(np.float32)


def run_serve(host_cls, model_dir, inspect=None, **host_kw) -> dict:
    """The serving scenario through a fresh `host_cls(capacity=
    SERVE_CAPACITY, realtime=False, **host_kw)` (either package's
    ModelHost) on `model_dir`, ticked by hand: {"s{i}": the audio session
    i pulled, concatenated; "s{i}_len": each pull's length}.  inspect(host),
    if given, is called after the last tick, before the host stops."""
    from .params.schema import ParameterID as P

    host = host_cls(capacity=SERVE_CAPACITY, realtime=False, **host_kw)
    if int(host.load_model(str(model_dir))) != 0:
        raise ValueError(f"ModelHost could not load {model_dir}")
    plan = _serve_sessions()
    signals = [serve_signal(rate, i) for i, (rate, *_) in enumerate(plan)]
    sessions, pushed, blocks = {}, [0] * len(plan), [0] * len(plan)
    pulls = {i: [] for i in range(len(plan))}
    try:
        for k in range(SERVE_TICKS):
            for i, (rate, opened, closed, params) in enumerate(plan):
                if k == opened:
                    sessions[i] = host.open_session(float(rate))
                    for pid, value in params:
                        if int(sessions[i].set_parameter(int(pid), value)) != 0:
                            raise ValueError(f"session {i}: parameter {pid} = {value} refused")
                if k == closed:
                    sessions.pop(i).close()
            for i, s in sessions.items():
                rate, opened = plan[i][:2]
                while pushed[i] < (k - opened + 2) * rate // 100:
                    n = SERVE_BLOCKS[blocks[i] % len(SERVE_BLOCKS)]
                    s.push(signals[i][pushed[i]:pushed[i] + n])
                    pushed[i] += n
                    blocks[i] += 1
            if k == SERVE_RESET_TICK:
                sessions[0].set_parameter(int(P.OUTPUT_GAIN), SERVE_RESET_GAIN_DB)
                sessions[0].proxy.core.reset_context()
            host.tick_once()
            for i, s in sessions.items():
                pulls[i].append(np.asarray(s.pull(plan[i][0] // 100), np.float32))
        if inspect is not None:
            inspect(host)
    finally:
        host.stop()
    out = {}
    for i, blocks_i in pulls.items():
        out[f"s{i}"] = np.concatenate(blocks_i) if blocks_i else np.zeros(0, np.float32)
        out[f"s{i}_len"] = np.asarray([len(b) for b in blocks_i], np.int64)
    return out


def serve_blocks(run: dict, i: int) -> list:
    """Session i's pulls of a `run_serve` result, one array per tick."""
    return np.split(run[f"s{i}"], np.cumsum(run[f"s{i}_len"])[:-1])


# ---- training and sequence-parallel conversion ----
#
# The train file `tests/data/torch_train_golden.npz` holds TRAIN_BATCH
# (`train_batch`: "audio16", "target24", "f0_bin") and the JAX package's
# numbers on the CPU for one step of each trainer on klatt8 with the cond
# of ConversionSettings(target_speaker=TRAIN_SPEAKER), f32:
#   "distill/<metric>"       distillation_loss's total ("loss") and terms,
#                            f0_weight 1, periodicity_weight TRAIN_PERIO;
#   "distill/grad/<leaf>"    each parameter's gradient L2 norm;
#   "distill/loss2"          the loss of a second step, after one AdamW
#                            update (make_optimizer(TRAIN_LR));
#   "gan/<metric>"           gan_train_step's "d_loss", "g_loss" and terms,
#                            on the critics of `disc_params(TRAIN_SEED)`;
#   "gan/d_grad/<leaf>"      each critic parameter's gradient norm (the D
#                            step), "gan/g_grad/<leaf>" each generator
#                            parameter's (the G step, after the D update);
#   "gan/d_loss2", "gan/g_loss2"  the second step's losses.
# `tests/test_torch_training.py` regenerates it with the JAX package and
# requires it to match (`PYTHONPATH=. python tests/test_torch_training.py`
# rewrites it); chip_smoke.py's train_golden phase holds the port on the
# card to it: losses at TRAIN_LOSS_RTOL, gradient norms at TRAIN_GRAD_RTOL.
#
# The seqpar file `tests/data/torch_seqpar_golden.npz` holds under "f32"
# the JAX package's `convert_utterance_sp` on the CPU of `offline_signal`
# (OFFLINE_RATE in and out) on klatt8 with OFFLINE_SETTINGS and
# n_segments=SEQPAR_SEGMENTS; `tests/test_torch_seqpar.py` regenerates it
# (`PYTHONPATH=. python tests/test_torch_seqpar.py` rewrites it) and the
# port is held to it at F32_ATOL.

TRAIN_BATCH = 2
TRAIN_FRAMES = 16
TRAIN_SEED = 3
TRAIN_SPEAKER = 2
TRAIN_LR = 2e-4
TRAIN_PERIO = 0.5
TRAIN_LOSS_RTOL = 1e-4
TRAIN_GRAD_RTOL = 1e-3
SEQPAR_SEGMENTS = 4


def train_batch(seed: int = TRAIN_SEED, batch: int = TRAIN_BATCH,
                frames: int = TRAIN_FRAMES) -> dict:
    """A training batch from a numpy seed: a sawtooth at a per-row F0
    plus noise at 16 kHz ("audio16" [B, frames*160]), a noisy sine target
    at 24 kHz ("target24" [B, frames*240]) and pitch bins ("f0_bin"
    [B, frames] int32, 0 = unvoiced in the first and last two frames)."""
    rng = np.random.default_rng(seed)
    t16 = np.arange(frames * 160) / 16000.0
    t24 = np.arange(frames * 240) / 24000.0
    f0 = rng.uniform(90.0, 280.0, (batch, 1))
    saw = 2.0 * ((f0 * t16) % 1.0) - 1.0
    audio16 = 0.3 * saw + 0.05 * rng.standard_normal((batch, t16.size))
    target24 = 0.2 * np.sin(2 * np.pi * f0 * t24) + 0.03 * rng.standard_normal((batch, t24.size))
    midi = 69.0 + 12.0 * np.log2(f0 / 440.0)
    f0_bin = np.repeat(np.round((midi - 33.0) * 8.0), frames, axis=1).astype(np.int32)
    f0_bin[:, :2] = 0
    f0_bin[:, -2:] = 0
    return {"audio16": audio16.astype(np.float32), "target24": target24.astype(np.float32),
            "f0_bin": f0_bin}


def disc_params(seed: int = TRAIN_SEED) -> dict:
    """The critics' parameters (the tree, shapes and distributions of the
    discriminator's `init`: w ~ U(+-1/sqrt(kh*kw*Cin)), b = 0) from a
    numpy seed, as float32 arrays, so that both packages and the card get
    the same values without a file."""
    from .training import discriminator as D

    rng = np.random.default_rng(seed)

    def critic(channels, kh, kw, c_in=1):
        layers = []
        for c_out, k in [(c, kh) for c in channels] + [(1, 3)]:  # the logits conv is 3 high
            scale = 1.0 / np.sqrt(k * kw * c_in)
            layers.append({"w": rng.uniform(-scale, scale, (k, kw, c_in, c_out))
                           .astype(np.float32), "b": np.zeros(c_out, np.float32)})
            c_in = c_out
        return layers

    return {"mpd": [critic(D._MPD_CHANNELS, 5, 1) for _ in D.MPD_PERIODS],
            "mrd": [critic(D._MRD_CHANNELS, 3, 3) for _ in D.MRD_RESOLUTIONS],
            "pcd": critic(D._PCD_CHANNELS, 5, 3, 1 + 2 * len(D.PCD_HARMONICS))}


def train_inputs(cfg, bank, device, batch_np=None) -> dict:
    """The port's training batch on `device`: `train_batch` (or batch_np)
    with the raw-KV cond of ConversionSettings(target_speaker=TRAIN_SPEAKER)."""
    import torch

    from .models.io import params_from_numpy
    from .runtime.offline import ConversionSettings, build_cond

    batch_np = train_batch() if batch_np is None else batch_np
    bank = {k: v.float() for k, v in params_from_numpy(bank, device).items()}
    out = {k: torch.from_numpy(np.asarray(batch_np[k])).to(device)
           for k in ("audio16", "target24", "f0_bin")}
    out["cond"] = build_cond(None, cfg, bank, ConversionSettings(target_speaker=TRAIN_SPEAKER),
                             out["audio16"].shape[0], raw_kv=True)
    return out


def run_train(cfg, params, bank, device, batch_np=None, mesh=None,
              model_parallel: bool = False, jit: bool | None = False) -> dict:
    """The port's numbers of the train golden file (the keys above but
    "batch/*"): one distillation step and one GAN step from `params` on
    the golden batch, and each one's second step, as Python floats.  With
    a `mesh` (`parallel/mesh.py`, every rank calling this with the same
    arguments), data-parallel over its 'streams' axis (this rank's rows,
    the whole batch's losses, the gradients summed over 'streams') and
    with model_parallel the generator's weights split over 'model'; the
    gradient norms are those of the whole gradients.  Compiled (`jit`
    True, or None where `distill.resolve_step_jit` compiles the steps on
    this mesh) the losses come from the compiled steps
    (`distill.train_step` and `gan.gan_train_step` on the mesh), each step
    of them from the same parameters, and the gradient norms from the
    eager backward passes."""
    import torch

    from .models.io import flatten_params, params_from_numpy
    from .parallel import collectives
    from .parallel.mesh import params_sharding, shard_tree, state_sharding
    from .training import distill, gan

    group = collectives.dp_group(mesh)
    compiled = distill.resolve_step_jit(jit, mesh, split=model_parallel)
    batch = train_inputs(cfg, bank, device, batch_np)
    generator = params
    if mesh is not None:
        batch = shard_tree(batch, state_sharding(batch, mesh), mesh)
        generator = params_from_numpy(params, device)
        generator = shard_tree(generator, params_sharding(generator, mesh,
                                                          model_parallel=model_parallel), mesh)
    out = {}

    def norms(prefix, tree):
        out.update({f"{prefix}/{k}": float(torch.linalg.norm(collectives.gathered(v.grad)))
                    for k, v in flatten_params(tree).items()})

    def distill_loss(p):
        return distill.distillation_loss(p, cfg, batch["audio16"], batch["target24"],
                                         batch["cond"], f0_bin=batch["f0_bin"],
                                         periodicity_weight=TRAIN_PERIO, group=group)

    p = distill.trainable(generator, device)
    opt = distill.make_optimizer(p, TRAIN_LR)
    loss, aux = distill_loss(p)
    loss.backward()
    if group is not None:
        collectives.all_reduce_grads_(opt.leaves, group)
    norms("distill/grad", p)
    if compiled:
        # the eager autograd graph (held by loss and aux) goes before the
        # capture: its AccumulateGrad nodes would tie the captured backward
        # pass to the default stream
        del loss, aux
        opt.zero_grad()
        aux = distill.train_step(p, opt, batch, cfg=cfg, periodicity_weight=TRAIN_PERIO,
                                 mesh=mesh, jit=True)[-1]
        loss = aux.pop("loss")
    else:
        opt.step()
    out["distill/loss"] = float(loss.detach())
    out.update({f"distill/{k}": float(v) for k, v in aux.items()})
    with torch.no_grad():
        out["distill/loss2"] = float(distill_loss(p)[0])

    def gan_players():
        g = distill.trainable(generator, device)
        d = distill.trainable(disc_params(), device)
        return (g, d, *gan.make_gan_optimizers(g, d, TRAIN_LR))

    # the first GAN step op by op, for its gradient norms
    g, d, gen_opt, disc_opt = gan_players()
    with torch.no_grad():
        fake = gan._generate(g, cfg, batch)
    d_loss = gan.disc_loss(d, batch["target24"], fake, batch["f0_bin"], group)
    gan.set_grads(d_loss, disc_opt, group)
    norms("gan/d_grad", d)
    disc_opt.step()
    g_loss, aux = gan.gen_loss(g, d, cfg, batch, group=group)
    gan.set_grads(g_loss, gen_opt, group)
    norms("gan/g_grad", g)
    gen_opt.step()
    if compiled:
        g, d, gen_opt, disc_opt = gan_players()
        aux = gan.gan_train_step(g, d, gen_opt, disc_opt, batch, cfg=cfg, mesh=mesh,
                                 jit=True)[-1]
        d_loss, g_loss = aux.pop("d_loss"), aux.pop("g_loss")
    out.update({"gan/d_loss": float(d_loss), "gan/g_loss": float(g_loss)})
    out.update({f"gan/{k}": float(v) for k, v in aux.items()})
    metrics = gan.gan_train_step(g, d, gen_opt, disc_opt, batch, cfg=cfg, mesh=mesh,
                                 jit=compiled)[-1]
    out["gan/d_loss2"] = float(metrics["d_loss"])
    out["gan/g_loss2"] = float(metrics["g_loss"])
    return out


# Gradient norms that f32 cannot pin to TRAIN_GRAD_RTOL, and their gates.
# The key bias of each attention block has a zero gradient in exact
# arithmetic (the softmax over the keys ignores a shift common to all of
# them): its f32 norm is rounding noise, held below TRAIN_GRAD_ZERO.  The
# final conv's bias sums the cotangent of the STFT's log-magnitudes over
# every sample, and that cotangent is ill-conditioned at the bins near
# zero (the JAX package's own eager and jitted runs differ by 1.2 % there,
# on the CPU); the PCD's first bias sums over its f32 running phase, which
# the two packages sum in different orders.  Both are held at
# TRAIN_GRAD_LOOSE.
TRAIN_GRAD_ZERO = 1e-6
TRAIN_GRAD_LOOSE = 3e-2
_ZERO_GRADS = ("attn/k/b",)
_LOOSE_GRADS = ("wg/final/b", "pcd/0/b")


def train_gate(key: str, got: float, want: float, loss_rtol: float = TRAIN_LOSS_RTOL):
    """(passes, relative or absolute deviation, bound) of one number of the
    train golden file."""
    if "grad/" not in key:
        dev = abs(got - want) / abs(want)
        return dev <= loss_rtol, dev, loss_rtol
    if key.endswith(_ZERO_GRADS):
        return max(abs(got), abs(want)) <= TRAIN_GRAD_ZERO, abs(got), TRAIN_GRAD_ZERO
    dev = abs(got - want) / abs(want)
    bound = TRAIN_GRAD_LOOSE if key.endswith(_LOOSE_GRADS) else TRAIN_GRAD_RTOL
    return dev <= bound, dev, bound
