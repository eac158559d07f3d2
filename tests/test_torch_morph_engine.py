"""Morphing through the port's engine and offline conversion, against the
JAX package on klatt8 on the CPU: the morph scenario of
`beatrice_vst_tpu_torch.golden.run_morph` (a direct stream, a tie, eight
speakers with one below the threshold, a single speaker, all-zero
weights, a switch into and out of morph mode, `recover()`) through the
JAX `StreamEngine` and the port's in per-stream f32, slots f32 and slots
bf16, each with two morph slots so that the pool runs out; the slot
leases and frame counters tick by tick; `recover()` against a fresh
engine; `convert_utterance` with morph weights; and the golden file made
from the JAX runs.

Gates: f32 engines and offline conversion at atol 1e-3, the waveform gate
of tests/test_golden.py; slots bf16 by the envelope of
`beatrice_vst_tpu_torch.golden` against the JAX slots f32 and bf16 runs;
kv_slot and frame_counter equal.  Run with -s to see the measured numbers.

`PYTHONPATH=. python tests/test_torch_morph_engine.py` rewrites
tests/data/torch_morph_golden.npz from the JAX package."""

import os

import numpy as np
import pytest
import torch

from beatrice_vst_tpu.models.io import load_model_dir
from beatrice_vst_tpu.runtime import offline as JO
from beatrice_vst_tpu.runtime.engine import EngineConfig as JEngineConfig
from beatrice_vst_tpu.runtime.engine import StreamEngine as JStreamEngine
from beatrice_vst_tpu_torch import golden
from beatrice_vst_tpu_torch.constants import V20RC0
from beatrice_vst_tpu_torch.models import chain as PC
from beatrice_vst_tpu_torch.models.io import load_weights
from beatrice_vst_tpu_torch.runtime import offline as PO
from beatrice_vst_tpu_torch.runtime.engine import EngineConfig, StreamEngine
from beatrice_vst_tpu_torch.speakers import bank as bank_mod

torch.set_num_threads(1)

MODEL_DIR = os.path.join(os.path.dirname(__file__), "..", "models_demo", "klatt8")
GOLDEN = os.path.join(os.path.dirname(__file__), "data", "torch_morph_golden.npz")
CAP = golden.MORPH_CAPACITY
CONFIGS = golden.MORPH_CONFIGS
# the golden file against a fresh JAX run: XLA's CPU sums differ between
# thread counts (tests/test_torch_engine.py, tests/test_torch_offline.py)
GOLDEN_TOL = {"per_stream_f32": 1e-6, "slots_f32": 1e-6, "slots_bf16": 1e-3, "offline": 1e-5}
PCFG = PC.VoiceConverterConfig.for_version(V20RC0)


def _recording(engine, to_numpy):
    """Wrap engine.tick to record kv_slot and frame_counter after each
    tick: returns the list it appends to."""
    record, tick = [], engine.tick

    def recorded(x):
        out = tick(x)
        c = engine.state
        record.append((to_numpy(c["controls"]["kv_slot"]).astype(np.int64),
                       to_numpy(c["frame_counter"]).astype(np.int64)))
        return out

    engine.tick = recorded
    return record


def _offline_settings(cls):
    """OFFLINE_SETTINGS with the dense weights of MORPH_OFFLINE_STREAM (as a
    user gives them: the conversion folds and prunes them)."""
    return cls(**golden.OFFLINE_SETTINGS, morph_weights=np.asarray(
        golden.MORPH_WEIGHTS[golden.MORPH_OFFLINE_STREAM], np.float32))


def _jax_runs():
    """The JAX engine's morph scenario in each configuration (output and
    per-tick records) and the JAX offline morph conversion."""
    _, jcfg, jparams, jbank = load_model_dir(MODEL_DIR)
    out, records = {}, {}
    for name, kw in CONFIGS.items():
        engine = JStreamEngine(JEngineConfig.realtime(CAP, **kw), jparams, jbank)
        records[name] = _recording(engine, np.asarray)
        out[name] = golden.run_morph(engine)
    out["offline"] = JO.convert_utterance(
        jparams, jcfg, jbank, golden.offline_signal(), golden.OFFLINE_RATE,
        _offline_settings(JO.ConversionSettings), chunk_frames=golden.OFFLINE_CHUNK_FRAMES)
    return out, records


@pytest.fixture(scope="module")
def jax_runs():
    return _jax_runs()


@pytest.fixture(scope="module")
def klatt8_port():
    params = load_weights(os.path.join(MODEL_DIR, "weights.npz"), device="cpu")
    bank = bank_mod.load(os.path.join(MODEL_DIR, "speakers.npz"), V20RC0, device="cpu")
    return params, bank


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_morph_engine_matches_jax_engine(klatt8_port, jax_runs, config):
    want, records = jax_runs[0], jax_runs[1]
    engine = StreamEngine(EngineConfig.realtime(CAP, **CONFIGS[config]), *klatt8_port,
                          device="cpu")
    record = _recording(engine, lambda t: t.numpy())
    got = golden.run_morph(engine, lambda t: t.numpy())
    assert np.abs(want[config]).max(axis=(0, 2)).min() > 1e-3  # every stream sounds
    for k, ((slot, frames), (jslot, jframes)) in enumerate(zip(record, records[config])):
        np.testing.assert_array_equal(frames, jframes, err_msg=f"frame_counter, tick {k}")
        if config.startswith("slots"):
            np.testing.assert_array_equal(slot, jslot, err_msg=f"kv_slot, tick {k}")
    if config.endswith("bf16"):
        env = golden.envelope(got, {"f32": want["slots_f32"], "bf16": want[config]})
        print(f"\n{config}: {env}")
        assert env["ok"], env
    else:
        print(f"\n{config}: max |d| against the JAX engine {np.abs(got - want[config]).max():.3g}")
        np.testing.assert_allclose(got, want[config], rtol=0, atol=golden.F32_ATOL)


def test_morph_slots_lease_and_fall_back(klatt8_port):
    """Two morph slots: the tie and the eight-speaker stream lease them;
    the single-speaker and all-zero streams, and the stream switched to
    morph later, read their dominant speaker's base slot; the tie's slot
    is released when it turns direct, and recover() leases it to the
    single-speaker stream."""
    engine = StreamEngine(EngineConfig.realtime(CAP, **CONFIGS["slots_f32"]), *klatt8_port,
                          device="cpu")
    record = _recording(engine, lambda t: t.numpy())
    golden.run_morph(engine)
    n = golden.MORPH_TARGET
    first, switched, recovered = (record[k][0] for k in (
        0, golden.MORPH_SWITCH_TICK, golden.MORPH_RECOVER_TICK))
    # stream 0 and 5 are direct: their kv_slot is not read
    assert list(first[1:5]) == [n, n + 1, 6, 0]
    assert switched[5] == 2
    assert engine._free_morph_slots == [] and engine._morph_slot == {2: 1, 3: 0}
    assert list(recovered[1:6]) == [0, n + 1, n, 0, 2]
    assert engine.counters["recoveries"] == 1
    assert list(record[-1][1]) == [golden.MORPH_TICKS - golden.MORPH_RECOVER_TICK] * CAP


def test_recover_replays_controls(klatt8_port):
    """After recover() the engine's output equals a fresh engine's with the
    same controls (tests/test_fault_isolation.py's case, with morph
    streams)."""
    x = golden.swept_sine(cap=3, ticks=1)

    def setup(engine):
        for i in range(3):
            engine.admit()
        engine.set_control(1, "target_speaker", np.int32(2))
        engine.set_control(1, "pitch_shift", np.float32(4.0))
        golden.set_morph(engine, 0, *golden.morph_controls(golden.MORPH_WEIGHTS[2]))
        engine.set_control(2, "intonation_intensity", np.float32(0.5))

    for kw in ({}, dict(kv_cache_mode="per_stream", vq_shared_bank=False)):
        cfg = EngineConfig.realtime(3, n_morph_slots=1, **kw)
        engine = StreamEngine(cfg, *klatt8_port, device="cpu")
        setup(engine)
        engine.tick(x)
        engine.evict(2)
        assert engine.recover() == [0, 1]
        recovered = engine.tick(x)
        fresh = StreamEngine(cfg, *klatt8_port, device="cpu")
        setup(fresh)
        fresh.evict(2)
        assert torch.equal(recovered, fresh.tick(x)), kw
        assert engine.metrics_snapshot()["recoveries"] == 1
        assert (recovered[2] == 0).all()


def test_frame_counter_wraps_and_resets(klatt8_port):
    """uint32 semantics: the counter wraps mod 2^32; admission zeroes it."""
    engine = StreamEngine(EngineConfig.realtime(2, frames_per_tick=3), *klatt8_port,
                          device="cpu")
    engine.admit()
    engine.flush_controls()
    engine.state["frame_counter"][:] = 2**32 - 2
    engine.tick(golden.swept_sine(cap=2, ticks=3))
    assert engine.state["frame_counter"].tolist() == [1, 1]
    engine.admit()
    engine.tick(golden.swept_sine(cap=2, ticks=3))
    assert engine.state["frame_counter"].tolist() == [4, 3]


def test_offline_morph_matches_jax(klatt8_port, jax_runs):
    """convert_utterance with morph weights (the eight-speaker stream's,
    one below the threshold) in chunks of 64 frames; and a bare morph
    target without weights (zero embeddings, the lottery's uniform pick),
    whole."""
    params, bank = klatt8_port
    got = PO.convert_utterance(params, PCFG, bank, golden.offline_signal(),
                               golden.OFFLINE_RATE, _offline_settings(PO.ConversionSettings),
                               chunk_frames=golden.OFFLINE_CHUNK_FRAMES, device="cpu")
    want = jax_runs[0]["offline"]
    print(f" max |d| {np.abs(got - want).max():.3g}", end="")
    np.testing.assert_allclose(got, want, rtol=0, atol=golden.F32_ATOL)
    _, jcfg, jparams, jbank = load_model_dir(MODEL_DIR)
    audio = golden.offline_signal(seconds=0.3)
    settings = dict(target_speaker=golden.MORPH_TARGET, vq_num_neighbors=4)
    want = JO.convert_utterance(jparams, jcfg, jbank, audio, golden.OFFLINE_RATE,
                                JO.ConversionSettings(**settings), chunk_frames=0)
    got = PO.convert_utterance(params, PCFG, bank, audio, golden.OFFLINE_RATE,
                               PO.ConversionSettings(**settings),
                               chunk_frames=0, device="cpu")
    np.testing.assert_allclose(got, want, rtol=0, atol=golden.F32_ATOL)


def test_morph_golden_file_matches_jax(jax_runs):
    """The committed golden file equals a fresh JAX run, up to the spread
    of XLA's CPU sums."""
    committed = golden.load(GOLDEN)
    assert sorted(committed) == sorted([*CONFIGS, "offline"])
    for key, tol in GOLDEN_TOL.items():
        assert committed[key].dtype == np.float32
        np.testing.assert_allclose(committed[key], jax_runs[0][key], rtol=0, atol=tol,
                                   err_msg=key)
    assert committed["slots_f32"].shape == (golden.MORPH_TICKS, CAP, 480)
    assert os.path.getsize(GOLDEN) < 1_200_000


if __name__ == "__main__":
    runs, _ = _jax_runs()
    os.makedirs(os.path.dirname(GOLDEN), exist_ok=True)
    np.savez_compressed(GOLDEN, **{k: np.asarray(v, np.float32) for k, v in runs.items()})
    print(f"wrote {GOLDEN} ({os.path.getsize(GOLDEN)} bytes)")
