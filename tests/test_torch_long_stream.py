"""The port's long-stream soak (`beatrice_vst_tpu_torch/scripts/long_stream_soak.py`)
at smoke scale on the CPU: leg a on klatt8 for 0.1 minute with chunks of
100 frames and the float64 oracle over the whole run passes all four
gates and reports the JAX soak's fields; a small leg b (4 streams, the
leg-b controls) passes the three stream-vs-chunk gates; the streamed
output of the soak's engine over its first 100 frames is within 1e-3 of
the JAX engine (`beatrice_vst_tpu/runtime/engine.py:engine_tick` through
its StreamEngine: same weights, signals and controls); `soak_gates` on
doctored outputs fails the gate each fault is meant to trip; and the flip
locator finds no flip where the paths agree and a pitch flip that is no
tie where one path is held to other bins."""

import os

import numpy as np
import pytest
import torch

from beatrice_vst_tpu.models.io import load_model_dir as jload_model_dir
from beatrice_vst_tpu.runtime.engine import EngineConfig as JEngineConfig
from beatrice_vst_tpu.runtime.engine import StreamEngine as JStreamEngine
from beatrice_vst_tpu_torch.models.io import load_model_dir
from beatrice_vst_tpu_torch.scripts import long_stream_soak as soak

torch.set_num_threads(1)

MODEL_DIR = os.path.join(os.path.dirname(__file__), "..", "models_demo", "klatt8")
SMOKE_FRAMES = 600
HEAD_FRAMES = 100
F32_ATOL = 1e-3  # the waveform gate of tests/test_golden.py
# the JAX soak's report fields (`scripts/long_stream_soak.py`)
JAX_FIELDS = {"n_frames", "minutes", "gates", "state_max_abs_per_minute",
              "stream_vs_chunk_max_abs_per_minute", "stream_vs_chunk_spec_rel_per_minute",
              "oracle_prefix_frames", "oracle_max_abs_diff", "wall_s"}
JAX_GATES = {"state_bounded", "stream_eq_chunk_within_drift_budget",
             "stream_eq_chunk_spectral_1e-2", "oracle_prefix_2e-3"}


def test_leg_a_at_smoke_scale_holds_every_gate():
    report = soak.run_soak(MODEL_DIR, minutes=SMOKE_FRAMES / soak.MINUTE,
                           oracle_minutes=SMOKE_FRAMES / soak.MINUTE, chunk_frames=100,
                           legs=("a",), device="cpu", log=lambda s: None)
    leg = report["legs"]["a"]
    print(f"\nleg a: stream vs chunk {leg['stream_vs_chunk_max_abs_per_minute']}, "
          f"oracle {leg['oracle_max_abs_diff']:.3g}")
    assert JAX_FIELDS <= set(leg) and set(leg["gates"]) == JAX_GATES
    assert leg["n_frames"] == SMOKE_FRAMES and leg["oracle_prefix_frames"] == SMOKE_FRAMES
    assert all(leg["gates"].values()), leg["gates"]
    assert report["ok"] and report["device"] == "cpu"


def test_small_leg_b_holds_the_stream_vs_chunk_gates():
    _, cfg, params, bank = load_model_dir(MODEL_DIR)
    leg = soak.run_leg(params, bank, cfg, streams=4, n_frames=200, chunk_frames=100,
                       device="cpu", log=lambda s: None)
    assert leg["gates"] == dict.fromkeys(sorted(JAX_GATES - {"oracle_prefix_2e-3"}), True)
    assert leg["stream_vs_chunk_max_abs_per_minute"][0] <= F32_ATOL


def test_leg_b_controls_cycle_the_voices_over_leg_a():
    controls = soak.soak_controls(256, n_speakers=8)
    assert len(controls) == 256 and soak.soak_controls(2) == list(soak.LEG_A)
    for i, c in enumerate(controls):
        speaker, shift = soak.VOICES[i % len(soak.VOICES)]
        assert c == dict(soak.LEG_A[i % 2], target_speaker=speaker % 8, pitch_shift=shift)
    assert len({(c["target_speaker"], c["pitch_shift"]) for c in controls}) == len(soak.VOICES)


def test_the_streamed_head_matches_the_jax_engine():
    audio = soak.soak_signals(SMOKE_FRAMES)[:, :HEAD_FRAMES * soak.HOP]
    _, cfg, params, bank = load_model_dir(MODEL_DIR)
    port = soak.soak_engine(params, bank, cfg, 2, device="cpu")
    _, _, jparams, jbank = jload_model_dir(MODEL_DIR)
    jax_engine = JStreamEngine(JEngineConfig.realtime(2), jparams, jbank)
    for c in soak.soak_controls(2):
        i = jax_engine.admit()
        for field, value in c.items():
            jax_engine.set_control(i, field, value)
    got, want = [], []
    for f in range(HEAD_FRAMES):
        x = audio[:, f * soak.HOP:(f + 1) * soak.HOP]
        got.append(port.tick(x).numpy())
        want.append(np.asarray(jax_engine.tick(x)))
    got, want = np.concatenate(got, axis=1), np.concatenate(want, axis=1)
    assert np.abs(want[:, -50 * soak.HOP:]).max(axis=1).min() > 1e-2  # real output
    print(f"\nmax |d| from the JAX engine over {HEAD_FRAMES} frames: "
          f"{np.abs(got - want).max():.3g}")
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_ATOL)


def _outputs(minutes=3):
    """A stream's output [1, minutes of 48 kHz] and the chunk path's, 1e-5 apart."""
    n = np.arange(minutes * soak.MINUTE * soak.HOP) / 48000.0
    stream = (0.3 * np.sin(2 * np.pi * 220.0 * n))[None]
    rng = np.random.default_rng(0)
    return stream, stream + 1e-5 * rng.standard_normal(stream.shape)


def _doctored(fault):
    """(stream, chunk, state norms, oracle max |d|) with one fault."""
    stream, chunk = _outputs()
    norms, oracle = [2.0, 2.1, 2.05], 1e-4
    minute = soak.MINUTE * soak.HOP
    if fault == "step":  # one sample 1e-2 off in minute 1 (budget 7e-3)
        chunk[0, minute // 2] += 1e-2
    elif fault == "late_step":  # one sample 2e-2 off in minute 2 (budget 1.3e-2)
        chunk[0, minute + 1000] += 2e-2
    elif fault == "spectral":  # a 3 kHz tone of 5e-3 in minute 3: inside the waveform budget
        n = np.arange(minute) / 48000.0
        chunk[0, 2 * minute:] += 5e-3 * np.sin(2 * np.pi * 3000.0 * n)
    elif fault == "norm":  # a carry that grows
        norms = [2.0, 4.0, 8.0]
    elif fault == "oracle":
        oracle = 3e-3
    return stream, chunk, norms, oracle


FAULTS = {"none": set(), "step": {"stream_eq_chunk_within_drift_budget"},
          "late_step": {"stream_eq_chunk_within_drift_budget"},
          "spectral": {"stream_eq_chunk_spectral_1e-2"}, "norm": {"state_bounded"},
          "oracle": {"oracle_prefix_2e-3"}}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_soak_gates_fail_the_gate_of_each_fault(fault):
    report = soak.soak_gates(*_doctored(fault))
    failed = {name for name, ok in report["gates"].items() if not ok}
    assert set(report["gates"]) == JAX_GATES
    assert failed == FAULTS[fault], report
    assert len(report["stream_vs_chunk_max_abs_per_minute"]) == 3
    assert report["oracle_max_abs_diff"] == _doctored(fault)[3]


def test_soak_gates_without_an_oracle_have_no_oracle_gate():
    stream, chunk, norms, _ = _doctored("none")
    report = soak.soak_gates(stream, chunk, norms)
    assert set(report["gates"]) == JAX_GATES - {"oracle_prefix_2e-3"}
    assert "oracle_max_abs_diff" not in report


def test_window_deviation_names_the_worst_stream_and_its_first_frame():
    a = np.zeros((20, 100 * soak.HOP))
    b = a.copy()
    b[17, 42 * soak.HOP + 7] = 0.5
    b[3, 60 * soak.HOP] = 0.1
    dev = soak.window_deviation(a, b, rows=8)
    assert dev["max_abs"] == 0.5 and dev["worst_stream"] == 17
    assert dev["first_frame_over_base"] == 42


def test_locate_flips_finds_none_where_the_paths_agree():
    _, cfg, params, bank = load_model_dir(MODEL_DIR)
    signals = torch.from_numpy(soak.soak_signals(100))
    flips, ticks = soak.locate_flips(params, bank, cfg, 2, 50, signals, {1: 60, 0: 55},
                                     device="cpu")
    assert [f["stream"] for f in flips] == [0, 1]
    assert all(f["kind"] is None and f["gap"] is None and not f["tie"] for f in flips)
    assert ticks == 61  # the compiled replay to frame 50, then 11 with taps


def test_locate_flips_from_a_snapshot_names_a_pitch_flip_that_is_no_tie(monkeypatch):
    """The chunk path's stream 1 held to pitch bins <= 100 (its tone sits
    near bin 190): from a snapshot of both engines at frame 50, the two
    paths' bins part at once, by a wide logit gap."""
    _, cfg, params, bank = load_model_dir(MODEL_DIR)
    signals = torch.from_numpy(soak.soak_signals(100))
    build = soak.soak_engine

    def engine(*args, **kw):
        e = build(*args, **kw)
        if e.cfg.frames_per_tick > 1:
            e.set_control(1, "max_q", 100)
            e.flush_controls()
        return e

    monkeypatch.setattr(soak, "soak_engine", engine)
    engines = {name: soak.soak_engine(params, bank, cfg, 2, t, "cpu")
               for name, t in (("stream", 1), ("chunk", 25))}
    for f in range(0, 50, 25):
        engines["chunk"].tick(signals[:, f * soak.HOP:(f + 25) * soak.HOP])
    for f in range(50):
        engines["stream"].tick(signals[:, f * soak.HOP:(f + 1) * soak.HOP])
    snap = {name: {k: v for k, v in e.state.items()} for name, e in engines.items()}
    flips, ticks = soak.locate_flips(params, bank, cfg, 2, 25, signals, {1: 60},
                                     start=(50, snap), device="cpu")
    (flip,) = flips
    assert flip["kind"] == "pitch" and 50 <= flip["frame"] <= 60
    assert flip["candidates"][1] <= 100 < flip["candidates"][0]
    assert flip["gap"] > soak.TIE_GAP and not flip["tie"]
    assert ticks == flip["frame"] - 50 + 1


def test_a_leg_with_a_flip_that_is_no_tie_fails_and_reports_it(monkeypatch):
    _, cfg, params, bank = load_model_dir(MODEL_DIR)
    build = soak.soak_engine

    def engine(*args, **kw):
        e = build(*args, **kw)
        if e.cfg.frames_per_tick > 1:
            e.set_control(1, "max_q", 100)
            e.flush_controls()
        return e

    monkeypatch.setattr(soak, "soak_engine", engine)
    leg = soak.run_leg(params, bank, cfg, streams=2, n_frames=100, chunk_frames=50,
                       device="cpu", log=lambda s: None)
    assert not leg["gates"]["stream_eq_chunk_within_drift_budget"]
    assert [(f["stream"], f["kind"], f["tie"]) for f in leg["flips"]] == [(1, "pitch", False)]
    assert leg["held_streams"] == {} and leg["flip_replay_t1_ticks"] > 0


def test_hold_zeroes_a_held_stream_from_its_tie_frame():
    out = torch.ones((3, 10 * soak.HOP))
    soak._hold(out, 20, {1: 24, 2: 5})
    assert out[0].min() == 1 and out[2].abs().max() == 0
    assert out[1, :4 * soak.HOP].min() == 1 and out[1, 4 * soak.HOP:].abs().max() == 0
