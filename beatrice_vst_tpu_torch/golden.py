"""The engine's golden run: the JAX engine's output on klatt8, stored in
`tests/data/torch_engine_golden.npz`, and what makes it -- the streams'
controls and the input signal -- so that the port's engine on any device
can be held to it.

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


def swept_sine(seed: int = SEED, cap: int = CAPACITY, ticks: int = TICKS) -> np.ndarray:
    """Swept sine (120 Hz upward) plus noise from a numpy seed at 48 kHz,
    [cap, ticks * 480] f32; every stream gets the same sweep and its own
    noise."""
    rng = np.random.default_rng(seed)
    n = np.arange(480 * ticks) / 48000.0
    sweep = 0.3 * np.sin(2 * np.pi * (120 * n + 200 * n * n))
    return (sweep[None] + 0.02 * rng.standard_normal((cap, n.size))).astype(np.float32)


def admit_all(engine) -> None:
    """Admit len(CONTROLS) streams and set their controls; works on the
    JAX package's StreamEngine and on the port's."""
    for speaker, formant, vq, shift in CONTROLS:
        i = engine.admit()
        engine.set_control(i, "target_speaker", np.int32(speaker))
        engine.set_control(i, "formant_index", np.int32(formant))
        engine.set_control(i, "vq_num_neighbors", np.int32(vq))
        engine.set_control(i, "pitch_shift", np.float32(shift))


def run(engine, to_numpy=np.asarray) -> np.ndarray:
    """Admit the golden streams and run the golden ticks of `swept_sine`:
    [TICKS, streams, 480]."""
    admit_all(engine)
    audio = swept_sine()
    return np.stack([to_numpy(engine.tick(audio[:, 480 * k:480 * (k + 1)]))
                     for k in range(TICKS)])


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
