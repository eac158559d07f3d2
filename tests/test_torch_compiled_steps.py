"""The compiled steps of the port (`beatrice_vst_tpu_torch/runtime/graphs.py`,
the counterpart of the JAX package's `jax.jit`) on the CPU.  On the card a
compiled step is one CUDA graph (tests/test_torch_cuda.py and the
`*_graph` phases of chip_smoke.py); here, where CUDA graphs do not exist,
it runs op by op over its static tensors, and it is held to its eager
twin (`jit=False`) exactly, over several calls: offline conversion
chunked (f32 and bf16) and whole (argmax and soft pitch), seqpar's two
passes, parity's streaming half.  Also: the step cache (one capture a
key, a new one for a new shape or another model's tensors, the LRU
bound, the counters), the donated write, the `jit` flag on a mesh, and
`convert_utterance(jit=True)` and `run_parity(jit=True)` against the JAX
package at the 1e-3 gate.  The model is the shallow 2.0.0-rc.0
configuration of tests/test_seqpar.py with the JAX package's `init`.
The training steps are in tests/test_torch_compiled_training.py."""

import gc

import numpy as np
import jax
import pytest
import torch

from beatrice_vst_tpu.constants import V20RC0 as JV20RC0
from beatrice_vst_tpu.models import chain as JC
from beatrice_vst_tpu.models.phone_extractor import PhoneExtractorConfig as JPhone
from beatrice_vst_tpu.models.pitch_estimator import PitchEstimatorConfig as JPitch
from beatrice_vst_tpu.parity import run_parity as jax_run_parity
from beatrice_vst_tpu.runtime import offline as JO
from beatrice_vst_tpu.speakers import bank as jbank_mod
from beatrice_vst_tpu_torch import golden
from beatrice_vst_tpu_torch.constants import V20RC0
from beatrice_vst_tpu_torch.models import chain as PC
from beatrice_vst_tpu_torch.models.io import params_from_numpy
from beatrice_vst_tpu_torch.models.phone_extractor import PhoneExtractorConfig
from beatrice_vst_tpu_torch.models.pitch_estimator import PitchEstimatorConfig
from beatrice_vst_tpu_torch.parity import run_parity
from beatrice_vst_tpu_torch.runtime import graphs
from beatrice_vst_tpu_torch.runtime.offline import ConversionSettings, convert_utterance
from beatrice_vst_tpu_torch.runtime.seqpar import convert_utterance_sp
from beatrice_vst_tpu_torch.training import distill, gan

torch.set_num_threads(1)

RATE = 44100
GATE = 1e-3  # the JAX package's waveform gate (tests/test_golden.py, parity)


def _shallow(phone_cls, pitch_cls, chain_mod):
    return chain_mod.VoiceConverterConfig(
        spec=V20RC0, phone=phone_cls(phone_channels=V20RC0.phone_channels, dilations=(1, 2)),
        pitch=pitch_cls(pitch_bins=V20RC0.pitch_bins, dilations=(1, 2)))


@pytest.fixture(scope="module")
def model():
    """(port config, port params, port bank, JAX config, JAX params, JAX
    bank): the shallow configuration with the JAX package's parameters."""
    jcfg = _shallow(JPhone, JPitch, JC)
    jparams = JC.init(jax.random.PRNGKey(0), jcfg)
    jbank = jbank_mod.random_bank(jax.random.PRNGKey(1), JV20RC0, 4)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    bank = {k: v.float() for k, v in params_from_numpy(
        {k: np.asarray(v) for k, v in jbank.items()}, "cpu").items()}
    return (_shallow(PhoneExtractorConfig, PitchEstimatorConfig, PC), params, bank, jcfg,
            jparams, jbank)


def _signal(seconds, seed):
    return golden.offline_signal(seed=seed, seconds=seconds)


# ---- the step cache ----

def test_cache_captures_once_a_key_and_shape():
    cache = graphs.StepCache(maxsize=2)
    fn = lambda x: x * 2.0 + 1.0  # noqa: E731
    for k in range(3):
        got = graphs.call("double", fn, torch.full((3,), float(k)), cache=cache)
        assert torch.equal(got, torch.full((3,), 2.0 * k + 1.0))
    assert cache.counters == {"captures": 1, "hits": 2, "replays": 3, "evictions": 0}
    graphs.call("double", fn, torch.zeros(4), cache=cache)  # a new shape: a new step
    graphs.call("double", fn, torch.zeros(3, dtype=torch.float64), cache=cache)  # a new dtype
    assert cache.counters["captures"] == 3 and cache.counters["evictions"] == 1
    assert len(cache) == 2


def test_cache_drops_the_least_recently_used():
    cache = graphs.StepCache(maxsize=2)
    built = []

    def build(name):
        built.append(name)
        return graphs.CompiledStep(lambda x: x + 1, (torch.zeros(1),))

    a = cache.get("a", lambda: build("a"))
    cache.get("b", lambda: build("b"))
    assert cache.get("a", lambda: build("a2")) is a  # "a" is now the most recent
    cache.get("c", lambda: build("c"))  # drops "b"
    assert "a" in cache and "c" in cache and "b" not in cache
    cache.get("b", lambda: build("b2"))
    assert built == ["a", "b", "c", "b2"]
    assert cache.counters == {"captures": 4, "hits": 1, "replays": 0, "evictions": 2}
    a()
    assert cache.counters["replays"] == 1 and a.replays == 1
    with pytest.raises(ValueError):
        graphs.StepCache(maxsize=0)


def test_call_returns_outputs_the_next_call_leaves_alone():
    cache = graphs.StepCache()
    first = graphs.call("id", lambda x: x, torch.ones(2), cache=cache)
    graphs.call("id", lambda x: x, torch.zeros(2), cache=cache)
    assert torch.equal(first, torch.ones(2))


def test_write_back_donates_and_keeps_an_aliased_source():
    """The new state lands in the old state's tensors; a new leaf that is
    a view of a leaf being written is read before the write (b gets a's
    old values)."""
    state = {"a": torch.arange(4.0), "b": [torch.zeros(2)], "keep": torch.ones(1)}
    a, b0, keep = state["a"], state["b"][0], state["keep"]
    new = {"a": state["a"].flip(0) + 0.0, "b": [state["a"][:2]], "keep": keep}
    graphs.write_back_(state, new)
    assert state["a"] is a and state["b"][0] is b0 and state["keep"] is keep
    assert state["a"].tolist() == [3.0, 2.0, 1.0, 0.0] and state["b"][0].tolist() == [0.0, 1.0]
    with pytest.raises(ValueError, match="changed a state leaf"):
        graphs.write_back_(state, {**state, "a": torch.zeros(5)})


def test_signature_and_identity():
    x = torch.zeros(2, 3)
    assert graphs.signature({"x": x, "n": 4}) == graphs.signature({"x": torch.ones(2, 3), "n": 4})
    assert graphs.signature({"x": x}) != graphs.signature({"x": torch.zeros(3, 2)})
    assert graphs.identity({"x": x}) == graphs.identity([x]) != graphs.identity(x.clone())


# ---- the jit flag ----

class _GlooMesh:
    """What resolve_jit and dp_group read of a 2 x 1 `DeviceMesh` of gloo
    ranks on the card (`parallel/mesh.py:backend` is patched to read
    `backend`)."""
    mesh_dim_names, shape, device_type, backend = ("streams", "model"), (2, 1), "cuda", "gloo"

    def get_group(self, name):
        return (self, name)


@pytest.fixture
def gloo_mesh(monkeypatch):
    from beatrice_vst_tpu_torch.parallel import mesh as mesh_mod

    monkeypatch.setattr(mesh_mod, "backend", lambda m: m.backend)
    return _GlooMesh()


def test_resolve_jit(gloo_mesh):
    """Without a mesh None and True compile and False is eager; on a mesh
    the same, but for a collective-holding step on gloo ranks on the card,
    which None runs eagerly and True refuses
    (tests/test_torch_compiled_mesh.py holds the whole table)."""
    assert graphs.resolve_jit(None) and graphs.resolve_jit(True)
    assert not graphs.resolve_jit(False)
    assert graphs.resolve_jit(None, mesh=gloo_mesh) and graphs.resolve_jit(True, gloo_mesh)
    assert not graphs.resolve_jit(False, mesh=gloo_mesh)
    assert not graphs.resolve_jit(None, mesh=gloo_mesh, collectives=True)
    with pytest.raises(RuntimeError, match="'gloo'"):
        graphs.resolve_jit(True, mesh=gloo_mesh, collectives=True)


@pytest.mark.parametrize("entry", ["train_step", "gan_train_step", "run_train"])
def test_jit_true_with_a_mesh_raises(entry, gloo_mesh):
    """jit=True on gloo ranks on the card, for a step whose body issues
    collectives (the gradients' sum over 'streams'): each entry point
    raises, naming the backend, before it touches its arguments.  (The
    mesh steps without collectives, such as seqpar's passes, compile on
    any backend.)"""
    mesh = gloo_mesh
    calls = {
        "train_step": lambda: distill.train_step(None, None, None, cfg=None, mesh=mesh,
                                                 jit=True),
        "gan_train_step": lambda: gan.gan_train_step(None, None, None, None, None, cfg=None,
                                                     mesh=mesh, jit=True),
        "run_train": lambda: golden.run_train(None, None, None, "cpu", mesh=mesh, jit=True),
    }
    with pytest.raises(RuntimeError, match="'gloo' group on CUDA"):
        calls[entry]()


# ---- offline conversion ----

# name -> (chunk_frames, compute dtype, soft pitch)
OFFLINE = {
    "chunk16_f32": (16, None, False),
    "chunk16_bf16": (16, torch.bfloat16, False),
    "whole_f32": (0, None, False),
    "whole_soft_f32": (0, None, True),
}


@pytest.mark.parametrize("name", sorted(OFFLINE))
def test_offline_compiled_equals_eager(model, name):
    """Three utterances through the compiled steps (the second of the
    same shape as the first: its steps replayed with a fresh state),
    each equal to the eager conversion."""
    cfg, params, bank = model[:3]
    chunk, dtype, soft = OFFLINE[name]
    settings = ConversionSettings(**golden.OFFLINE_SETTINGS, soft_pitch=soft)
    before = graphs.CACHE.counters["hits"]
    for seconds, seed in ((0.4, 0), (0.4, 1), (0.25, 2)):
        kw = dict(compute_dtype=dtype, chunk_frames=chunk, device="cpu")
        sig = _signal(seconds, seed)
        got = convert_utterance(params, cfg, bank, sig, RATE, settings, jit=True, **kw)
        want = convert_utterance(params, cfg, bank, sig, RATE, settings, jit=False, **kw)
        assert got.shape == want.shape and np.abs(want).max() > 0.01
        np.testing.assert_array_equal(got, want)
    assert graphs.CACHE.counters["hits"] > before


def test_offline_two_models_of_one_shape_get_their_own_steps(model):
    """Steps are keyed by the identity of the parameters they read: a
    second model of the same shapes is captured anew, and each model's
    compiled conversion equals its own eager one."""
    cfg, params, bank = model[:3]
    other = PC.init(torch.Generator().manual_seed(5), cfg, "cpu")
    sig = _signal(0.3, 3)
    outs = []
    for p in (params, other, params):
        before = graphs.CACHE.counters["captures"]
        got = convert_utterance(p, cfg, bank, sig, RATE, chunk_frames=8, device="cpu")
        np.testing.assert_array_equal(
            got, convert_utterance(p, cfg, bank, sig, RATE, chunk_frames=8, device="cpu",
                                   jit=False))
        outs.append((got, graphs.CACHE.counters["captures"] - before))
    assert outs[1][1] >= 1 and outs[2][1] == 0  # params' chunk step still cached
    assert np.abs(outs[0][0] - outs[1][0]).max() > 1e-3


def test_offline_compiled_matches_jax(model):
    """convert_utterance(jit=True) against the JAX package's, chunked, at
    the waveform gate."""
    cfg, params, bank, jcfg, jparams, jbank = model
    sig = _signal(0.4, 4)
    settings = golden.OFFLINE_SETTINGS
    got = convert_utterance(params, cfg, bank, sig, RATE, ConversionSettings(**settings),
                            chunk_frames=16, device="cpu", jit=True)
    want = JO.convert_utterance(jparams, jcfg, jbank, sig, RATE, JO.ConversionSettings(**settings),
                                chunk_frames=16)
    assert got.shape == want.shape
    print(f" max |d| against the JAX package {np.abs(got - want).max():.3g}", end="")
    np.testing.assert_allclose(got, want, rtol=0, atol=GATE)


# ---- seqpar and parity ----

@pytest.mark.parametrize("soft", [False, True])
def test_seqpar_compiled_equals_eager(model, soft):
    """Both passes of two utterances of one length (the second replays
    the steps of the first) and one of another, at 4 segments."""
    cfg, params, bank = model[:3]
    settings = ConversionSettings(soft_pitch=soft)
    for seconds, seed in ((1.0, 0), (1.0, 1), (0.8, 2)):
        sig = _signal(seconds, seed)
        got = convert_utterance_sp(params, cfg, bank, sig, RATE, settings, n_segments=4,
                                   device="cpu", jit=True)
        want = convert_utterance_sp(params, cfg, bank, sig, RATE, settings, n_segments=4,
                                    device="cpu", jit=False)
        np.testing.assert_array_equal(got, want)


def test_parity_compiled_equals_eager_and_jax(model):
    """run_parity with the compiled streaming half: the same report as the
    eager streaming half (the same chunk tick, so equal outputs give equal
    numbers), within the gate, and the JAX harness on the same inputs
    within it too."""
    cfg, params, bank, jcfg, jparams, jbank = model
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    np_bank = {k: np.asarray(v) for k, v in jbank.items()}
    spans = []

    def timer(name):
        spans.append(name)
        return torch.no_grad()

    kw = dict(n_frames=12, batch=2, tolerance=GATE, controls={"pitch_shift": 2.0},
              device="cpu")
    got = run_parity(np_params, cfg, np_bank, jit=True, timer=timer, **kw)
    want = run_parity(np_params, cfg, np_bank, jit=False, **kw)
    assert spans == ["chunk", "capture", "stream"]
    assert (got.max_abs_diff, got.rms_diff) == (want.max_abs_diff, want.rms_diff)
    assert got.passed and got.n_frames == 12, str(got)
    jrep = jax_run_parity(jparams, jcfg, jbank, n_frames=12, batch=2, tolerance=GATE,
                          controls={"pitch_shift": 2.0})
    print(f" port {got}; JAX {jrep}", end="")
    assert jrep.passed


def test_collection_stays_paused_while_any_capture_runs():
    """Automatic garbage collection is off from the first capture's start
    to the last one's end (captures on two threads overlap), then as it
    was before."""
    assert gc.isenabled()
    with graphs._collection_paused():
        assert not gc.isenabled()
        with graphs._collection_paused():
            assert not gc.isenabled()
        assert not gc.isenabled()
    assert gc.isenabled()
    gc.disable()
    try:
        with graphs._collection_paused():
            pass
        assert not gc.isenabled()
    finally:
        gc.enable()
