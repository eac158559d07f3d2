"""The slice as a whole: the port's StreamEngine against the JAX
StreamEngine on the shipped klatt8 weights, and the engine's control
plane.

The JAX engine runs f32 (its default compute dtype) with the per-stream
K/V cache and per-stream codebooks -- the configuration the port honours
-- and its default XLA upsampler (use_pallas_upsampler off).  Audio is
held at atol 1e-3, the waveform gate of tests/test_golden.py."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from beatrice_vst_tpu.models.io import load_model_dir
from beatrice_vst_tpu.runtime.engine import EngineConfig as JEngineConfig
from beatrice_vst_tpu.runtime.engine import StreamEngine as JStreamEngine
from beatrice_vst_tpu_torch.constants import V20RC0
from beatrice_vst_tpu_torch.errors import BeatriceError
from beatrice_vst_tpu_torch.models.io import load_weights
from beatrice_vst_tpu_torch.models import chain as PC
from beatrice_vst_tpu_torch.models import phone_extractor as PPE
from beatrice_vst_tpu_torch.models import pitch_estimator as PPI
from beatrice_vst_tpu_torch.models import waveform_generator as PW
from beatrice_vst_tpu_torch.ops.resample import input_resampler_48k_to_16k
from beatrice_vst_tpu_torch.runtime.controls import init_controls
from beatrice_vst_tpu_torch.runtime.engine import EngineConfig, StreamEngine, init_engine_state
from beatrice_vst_tpu_torch.speakers import bank as bank_mod

torch.set_num_threads(1)

MODEL_DIR = os.path.join(os.path.dirname(__file__), "..", "models_demo", "klatt8")
CAP = 4
TICKS = 8
# (target_speaker, formant_index, vq_num_neighbors, pitch_shift)
CONTROLS = [(0, 4, 0, 0.0), (3, 2, 4, 2.0), (5, 6, 8, -3.0), (7, 0, 1, 0.5)]


@pytest.fixture(scope="module")
def klatt8_port():
    params = load_weights(os.path.join(MODEL_DIR, "weights.npz"), device="cpu")
    bank = bank_mod.load(os.path.join(MODEL_DIR, "speakers.npz"), V20RC0, device="cpu")
    return params, bank


def _audio(seed, cap=CAP, ticks=TICKS):
    """Swept sine (120 Hz upward) plus noise at 48 kHz, [cap, ticks*480]."""
    rng = np.random.default_rng(seed)
    n = np.arange(480 * ticks) / 48000.0
    sweep = 0.3 * np.sin(2 * np.pi * (120 * n + 200 * n * n))
    return (sweep[None] + 0.02 * rng.standard_normal((cap, n.size))).astype(np.float32)


def _admit_all(engine):
    for speaker, formant, vq, shift in CONTROLS:
        i = engine.admit()
        engine.set_control(i, "target_speaker", np.int32(speaker))
        engine.set_control(i, "formant_index", np.int32(formant))
        engine.set_control(i, "vq_num_neighbors", np.int32(vq))
        engine.set_control(i, "pitch_shift", np.float32(shift))


def test_engine_matches_jax_engine_on_klatt8(klatt8_port):
    _, _, jparams, jbank = load_model_dir(MODEL_DIR)
    jcfg = dataclasses.replace(JEngineConfig.realtime(CAP), kv_cache_mode="per_stream",
                               vq_shared_bank=False)
    assert jcfg.compute_dtype is None and not jcfg.model.wg.use_pallas_upsampler
    jeng = JStreamEngine(jcfg, jparams, jbank)
    peng = StreamEngine(EngineConfig.realtime(CAP), *klatt8_port, device="cpu")
    _admit_all(jeng)
    _admit_all(peng)
    audio = _audio(0)
    for k in range(TICKS):
        x = audio[:, 480 * k:480 * (k + 1)]
        want = np.asarray(jeng.tick(x))
        got = peng.tick(x).numpy()
        assert np.abs(want).max() > 1e-3  # real output, not silence
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


def test_engine_defaults_to_cuda_and_raises_without_it(klatt8_port):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present, so the default device works")
    with pytest.raises(RuntimeError, match="CUDA"):
        StreamEngine(EngineConfig.realtime(2), *klatt8_port)
    with pytest.raises(RuntimeError, match="CUDA"):
        load_weights(os.path.join(MODEL_DIR, "weights.npz"))


def test_morph_and_unknown_controls_raise(klatt8_port):
    eng = StreamEngine(EngineConfig.realtime(2), *klatt8_port, device="cpu")
    i = eng.admit()
    with pytest.raises(BeatriceError, match="SPEAKER_ID_OUT_OF_RANGE"):
        eng.set_control(i, "target_speaker", 8)  # == n_speakers: morph mode
    with pytest.raises(BeatriceError):
        eng.set_control(i, "target_speaker", -1)
    with pytest.raises(KeyError, match="morph_weights"):
        eng.set_control(i, "morph_weights", np.zeros(256, np.float32))


def test_stream_table_mute_and_sanitization(klatt8_port):
    eng = StreamEngine(EngineConfig.realtime(3), *klatt8_port, device="cpu")
    assert [eng.admit(), eng.admit(), eng.admit()] == [0, 1, 2]
    with pytest.raises(RuntimeError, match="capacity"):
        eng.admit()
    eng.evict(1)
    x = _audio(2, cap=3, ticks=1)
    x[2, ::7] = np.nan
    x[2, 3] = np.inf
    y = eng.tick(x).numpy()
    assert np.isfinite(y).all()
    assert (y[1] == 0).all()  # evicted: muted
    assert np.abs(y[0]).max() > 0
    assert eng.admit() == 1  # smallest free slot is reused
    with pytest.raises(ValueError, match="shape"):
        eng.tick(x[:, :240])
    snap = eng.metrics_snapshot()
    assert snap["ticks"] == 1 and snap["streams_active"] == 3
    assert snap["admitted"] == 4 and snap["evicted"] == 1


def test_admission_resets_a_recycled_slot(klatt8_port):
    """A re-admitted slot starts from zero carries: its output equals a
    fresh engine's on the same input."""
    used = StreamEngine(EngineConfig.realtime(1), *klatt8_port, device="cpu")
    used.admit()
    audio = _audio(3, cap=1, ticks=4)
    for k in range(3):
        used.tick(audio[:, 480 * k:480 * (k + 1)])
    used.evict(0)
    used.admit()
    fresh = StreamEngine(EngineConfig.realtime(1), *klatt8_port, device="cpu")
    fresh.admit()
    x = audio[:, 480 * 3:]
    # a leaked context would differ by orders of magnitude more than the
    # f32 rounding two engines' matmuls may differ by
    torch.testing.assert_close(used.tick(x), fresh.tick(x), rtol=0, atol=1e-6)


_CFG = EngineConfig.realtime(2)
# every public init function of the port, called without a device
_INITS = {
    "init_engine_state": lambda **kw: init_engine_state(_CFG, **kw),
    "init_controls": lambda **kw: init_controls(_CFG.spec, 2, **kw),
    "chain.init_state": lambda **kw: PC.init_state(_CFG.model, (2,), **kw),
    "waveform_generator.init_state": lambda **kw: PW.init_state(_CFG.model.wg, (2,), **kw),
    "phone_extractor.init_state": lambda **kw: PPE.init_state(_CFG.model.phone, (2,), **kw),
    "pitch_estimator.init_state": lambda **kw: PPI.init_state(_CFG.model.pitch, (2,), **kw),
    "Resampler.init_state": lambda **kw: input_resampler_48k_to_16k().init_state((2,), **kw),
}


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    items = tree.values() if isinstance(tree, dict) else tree
    return [t for item in items for t in _tensors(item)]


@pytest.mark.parametrize("name", sorted(_INITS))
def test_init_functions_default_to_cuda_and_raise_without_it(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present, so the default device works")
    with pytest.raises(RuntimeError, match="CUDA"):
        _INITS[name]()


@pytest.mark.parametrize("name", sorted(_INITS))
def test_init_functions_run_on_the_cpu_when_asked(name):
    tensors = _tensors(_INITS[name](device="cpu"))
    assert tensors and all(t.device.type == "cpu" for t in tensors)
