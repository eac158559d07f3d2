"""The slice as a whole: the port's StreamEngine against the JAX
StreamEngine on the shipped klatt8 weights in four configurations and at
frames_per_tick = 25 (the chunk path) in two, the golden file made from
the JAX engine, and the engine's control plane and metrics (the older
model versions: tests/test_torch_versions.py).

Configurations (the same `EngineConfig.realtime` keywords for both
packages): per-stream f32 (per-stream K/V cache and codebooks); the JAX
default, slots f32 (slot-bank K/V, shared-bank VQ); the one bench.py
measures, slots bf16 (bf16 compute, int8 slot bank and contractions,
int8 codebook through the shared-bank VQ); and per-stream bf16 (the int8
K/V cache and per-stream int8 codebooks).  The JAX engine runs its
default XLA upsampler (use_pallas_upsampler off); the port runs the
upsampler head's plain version on the CPU.

Gates: f32 audio at atol 1e-3, the waveform gate of tests/test_golden.py.
bf16 by the envelope of `beatrice_vst_tpu_torch.golden`: the port's
largest and RMS deviation from the JAX f32 engine (of the same K/V mode)
are each at most twice the JAX bf16 engine's own.  Run with -s to see the measured numbers.

`PYTHONPATH=. python tests/test_torch_engine.py` rewrites the golden file
from the JAX engine."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from beatrice_vst_tpu.models.io import load_model_dir
from beatrice_vst_tpu.runtime.engine import EngineConfig as JEngineConfig
from beatrice_vst_tpu.runtime.engine import StreamEngine as JStreamEngine
from beatrice_vst_tpu.runtime.engine import cast_bank as jcast_bank
from beatrice_vst_tpu.runtime.engine import init_engine_state as jinit_engine_state
from beatrice_vst_tpu_torch import golden
from beatrice_vst_tpu_torch.constants import V20RC0
from beatrice_vst_tpu_torch.errors import BeatriceError
from beatrice_vst_tpu_torch.models.io import load_weights
from beatrice_vst_tpu_torch.models import chain as PC
from beatrice_vst_tpu_torch.models import phone_extractor as PPE
from beatrice_vst_tpu_torch.models import pitch_estimator as PPI
from beatrice_vst_tpu_torch.models import waveform_generator as PW
from beatrice_vst_tpu_torch.ops.resample import input_resampler_48k_to_16k
from beatrice_vst_tpu_torch.runtime.controls import init_controls
from beatrice_vst_tpu_torch.runtime.metrics import EngineMetrics
from beatrice_vst_tpu_torch.runtime.engine import (EngineConfig, StreamEngine, cast_bank,
                                                    init_engine_state)
from beatrice_vst_tpu_torch.speakers import bank as bank_mod

torch.set_num_threads(1)

MODEL_DIR = os.path.join(os.path.dirname(__file__), "..", "models_demo", "klatt8")
GOLDEN = os.path.join(os.path.dirname(__file__), "data", "torch_engine_golden.npz")
CAP = golden.CAPACITY
# name -> EngineConfig.realtime keywords, the same for both packages
CONFIGS = {
    "per_stream_f32": dict(kv_cache_mode="per_stream", vq_shared_bank=False),
    "slots_f32": {},
    "slots_bf16": dict(compute_dtype="bfloat16"),
    # bf16 per stream: the int8 K/V cache and the per-stream int8 codebook
    "per_stream_bf16": dict(compute_dtype="bfloat16", kv_cache_mode="per_stream",
                            vq_shared_bank=False),
}
# golden file key -> configuration
GOLDEN_KEYS = {"f32": "slots_f32", "bf16": "slots_bf16"}
# the golden file against a fresh JAX run: XLA's CPU sums differ between
# thread counts by up to 4.5e-8 (f32) and 8.1e-5 (bf16) on these inputs
GOLDEN_TOL = {"f32": 1e-6, "bf16": 1e-3}


@pytest.fixture(scope="module")
def klatt8_port():
    params = load_weights(os.path.join(MODEL_DIR, "weights.npz"), device="cpu")
    bank = bank_mod.load(os.path.join(MODEL_DIR, "speakers.npz"), V20RC0, device="cpu")
    return params, bank


_audio = golden.swept_sine


def _jax_runs(names):
    """The JAX engine's golden run in each named configuration:
    {name: [ticks, CAP, 480]}."""
    _, _, jparams, jbank = load_model_dir(MODEL_DIR)
    out = {}
    for name in names:
        jcfg = JEngineConfig.realtime(CAP, **CONFIGS[name])
        assert not jcfg.model.wg.use_pallas_upsampler
        out[name] = golden.run(JStreamEngine(jcfg, jparams, jbank))
    return out


@pytest.fixture(scope="module")
def jax_outputs():
    return _jax_runs(CONFIGS)


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_engine_matches_jax_engine_on_klatt8(klatt8_port, jax_outputs, config):
    peng = StreamEngine(EngineConfig.realtime(CAP, **CONFIGS[config]), *klatt8_port,
                        device="cpu")
    got = golden.run(peng, lambda t: t.numpy())
    want = jax_outputs[config]
    assert np.abs(want).max(axis=(1, 2)).min() > 1e-3  # real output every tick, not silence
    if config.endswith("bf16"):
        ref = jax_outputs[config.replace("bf16", "f32")]
        env = golden.envelope(got, {"f32": ref, "bf16": want})
        print(f"\n{config}: {env}")
        assert env["ok"], env
    else:
        print(f"\n{config}: max |d| against the JAX engine {np.abs(got - want).max():.3g}")
        np.testing.assert_allclose(got, want, rtol=0, atol=golden.F32_ATOL)


def test_golden_file_matches_the_jax_engine(jax_outputs):
    """The committed golden file equals a fresh run of the JAX engine, up to
    the spread of XLA's CPU sums (GOLDEN_TOL), so it cannot drift."""
    committed = golden.load(GOLDEN)
    assert sorted(committed) == sorted(GOLDEN_KEYS)
    for key, config in GOLDEN_KEYS.items():
        assert committed[key].dtype == np.float32
        assert committed[key].shape == (golden.TICKS, CAP, 480)
        np.testing.assert_allclose(committed[key], jax_outputs[config], rtol=0,
                                   atol=GOLDEN_TOL[key])
    assert os.path.getsize(GOLDEN) < 400_000


def test_engine_config_has_the_jax_fields_and_defaults():
    def fields(cls):
        return [(f.name, f.default) for f in dataclasses.fields(cls)]

    assert fields(EngineConfig) == fields(JEngineConfig)
    port, ref = EngineConfig.realtime(CAP), JEngineConfig.realtime(CAP)
    for name, _ in fields(EngineConfig)[2:]:
        assert getattr(port, name) == getattr(ref, name), name
    with pytest.raises(ValueError, match="kv_cache_mode"):
        EngineConfig.realtime(CAP, kv_cache_mode="ring")


def _dtypes(tree):
    """{path: (shape, dtype name)} of a state tree's K/V and carries."""
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{path}/{k}")
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{path}/{i}")
        else:
            out[path] = (tuple(node.shape), str(node.dtype).replace("torch.", ""))

    walk(tree, "")
    return out


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_init_engine_state_matches_jax_kv_and_carry_dtypes(config):
    """The K/V state (slot bank or per-stream cache, f32, bf16 or int8 with
    f32 scales) and the vocoder's carries match the JAX engine's in shape
    and dtype."""
    pstate = init_engine_state(EngineConfig.realtime(3, **CONFIGS[config]), device="cpu")
    jstate = jinit_engine_state(JEngineConfig.realtime(3, **CONFIGS[config]))
    kv = "kv_cache" if config.startswith("per_stream") else "kv_slots"
    assert kv in pstate and kv in jstate
    assert _dtypes(pstate[kv]) == _dtypes(jstate[kv])
    # the vocoder's carries have the JAX engine's dtypes (its T = 1 layout
    # keeps some ring-major, so shapes are not compared)
    for key in ("blocks", "up", "final"):
        assert ([d for _, d in _dtypes(pstate["model"]["wg"][key]).values()]
                == [d for _, d in _dtypes(jstate["model"]["wg"][key]).values()]), key
    want = "bfloat16" if config.endswith("bf16") else "float32"
    for path, (_, dtype) in _dtypes(pstate["model"]).items():
        if path.endswith(("/audio", "/phase")):
            assert dtype == "float32", path
        elif path.endswith("/noise_counter"):
            assert dtype == "int64", path
        else:
            assert dtype == want, path


def test_cast_bank_matches_jax():
    """bf16 bank and int8 codebook: int8 bit-equal, scales and bf16
    tensors equal."""
    _, _, _, jbank = load_model_dir(MODEL_DIR)
    import jax.numpy as jnp

    want = jcast_bank(jbank, jnp.bfloat16, quantize_codebook=True)
    got = cast_bank({k: np.asarray(v) for k, v in jbank.items()}, torch.bfloat16, True,
                    device="cpu")
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        w = np.asarray(w.astype(jnp.float32) if w.dtype == jnp.bfloat16 else w)
        g = got[k].float().numpy() if got[k].dtype == torch.bfloat16 else got[k].numpy()
        np.testing.assert_array_equal(g, w, err_msg=k)


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
    "chain.init": lambda **kw: PC.init(torch.Generator().manual_seed(0), _CFG.model, **kw),
    "random_bank": lambda **kw: bank_mod.random_bank(torch.Generator().manual_seed(0),
                                                     _CFG.spec, 2, **kw),
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


# ---- the chunk path (frames_per_tick > 1) ----

CHUNK = 25  # frames per tick
CHUNK_FRAMES = 50
CHUNK_CONFIGS = ["slots_f32", "slots_bf16"]


@pytest.fixture(scope="module")
def jax_chunk_outputs():
    """The JAX engine at frames_per_tick = 25 on the golden streams:
    {"f32", "bf16"}: [2 ticks, CAP, 25 * 480]."""
    _, _, jparams, jbank = load_model_dir(MODEL_DIR)
    return {config.split("_")[1]: golden.run(
        JStreamEngine(JEngineConfig.realtime(CAP, frames_per_tick=CHUNK, **CONFIGS[config]),
                      jparams, jbank), frames=CHUNK_FRAMES) for config in CHUNK_CONFIGS}


@pytest.mark.parametrize("config", CHUNK_CONFIGS)
def test_chunk_engine_matches_jax_engine_on_klatt8(klatt8_port, jax_chunk_outputs, config):
    """Ticks of 25 frames: the resamplers in sub-blocks, every stage over
    T = 25, the upsampler head as the stage loop, and per-stream codebooks
    (the shared-bank VQ is a T = 1 route)."""
    cfg = EngineConfig.realtime(CAP, frames_per_tick=CHUNK, **CONFIGS[config])
    assert not cfg.use_shared_vq(8)
    got = golden.run(StreamEngine(cfg, *klatt8_port, device="cpu"), lambda t: t.numpy(),
                     frames=CHUNK_FRAMES)
    assert got.shape == (CHUNK_FRAMES // CHUNK, CAP, CHUNK * 480)
    if config.endswith("bf16"):
        env = golden.envelope(got, jax_chunk_outputs)
        print(f"\n{config} at T = {CHUNK}: {env}")
        assert env["ok"], env
    else:
        want = jax_chunk_outputs["f32"]
        print(f"\n{config} at T = {CHUNK}: max |d| against the JAX engine "
              f"{np.abs(got - want).max():.3g}")
        np.testing.assert_allclose(got, want, rtol=0, atol=golden.F32_ATOL)


def test_shared_vq_only_at_one_frame_per_tick():
    """The shared-bank VQ is the T = 1 route by default (`engine.py:306-310`);
    a chunk gathers each stream's codebook unless the config forces it."""
    for t, want in ((1, True), (25, False)):
        cfg = EngineConfig.realtime(CAP, frames_per_tick=t)
        jcfg = JEngineConfig.realtime(CAP, frames_per_tick=t)
        assert cfg.use_shared_vq(8) is want
        assert (jcfg.frames_per_tick == 1 and 8 <= jcfg.vq_shared_max_speakers) is want
    assert EngineConfig.realtime(CAP, frames_per_tick=25, vq_shared_bank=True).use_shared_vq(8)
    assert not EngineConfig.realtime(CAP, vq_shared_max_speakers=4).use_shared_vq(8)
    with pytest.raises(ValueError, match="frames_per_tick"):
        EngineConfig.realtime(CAP, frames_per_tick=0)


def test_metrics_count_frames_and_budget_per_frame():
    """A tick of T frames carries T frames per stream and has a budget of
    T * 10 ms (`metrics.py:29-32`)."""
    m = EngineMetrics()
    m.record_tick(0.2, 4, 25)  # 200 ms for 250 ms of audio: in budget
    m.record_tick(0.3, 4, 25)  # over it
    m.record_tick(0.005, 2, 1)
    snap = m.snapshot(4)
    assert snap["frames_total"] == 4 * 25 * 2 + 2
    assert snap["underruns"] == 1


def test_chunk_engine_tick_shape_and_metrics(klatt8_port):
    eng = StreamEngine(EngineConfig.realtime(2, frames_per_tick=3), *klatt8_port, device="cpu")
    eng.admit()
    x = _audio(9, cap=2, ticks=3)
    with pytest.raises(ValueError, match="shape"):
        eng.tick(x[:, :480])
    assert eng.tick(x).shape == (2, 3 * 480)
    assert eng.metrics_snapshot()["frames_total"] == 3


if __name__ == "__main__":
    runs = _jax_runs(GOLDEN_KEYS.values())
    os.makedirs(os.path.dirname(GOLDEN), exist_ok=True)
    np.savez_compressed(GOLDEN, **{key: runs[config] for key, config in GOLDEN_KEYS.items()})
    print(f"wrote {GOLDEN} ({os.path.getsize(GOLDEN)} bytes)")
