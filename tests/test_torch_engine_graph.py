"""The compiled tick on the CPU: `StreamEngine(jit=True)`, the counterpart
of the JAX engine's `jax.jit(engine_tick, donate_argnums=(2,))`, runs the
donated tick (`donated_tick`: the new state written into the state's own
tensors) here, where CUDA graphs do not exist; on the card the same step
is captured in a CUDA graph (tests/test_torch_cuda.py).  It is held
against `jit=False` (the functional `engine_tick`, the state rebound) and
against the JAX `StreamEngine` on klatt8, in per-stream f32, slots f32
and slots bf16, at frames_per_tick 1 and 3, through `golden.run_edits`
(32 ticks with control edits, admit and evict, `reset_context`, morphs
and `recover()` between them).

Gates: donated against functional exactly (the same operations on the
same values); f32 against the JAX engine at atol 1e-3, the waveform gate
of tests/test_golden.py; slots bf16 by the envelope of
`beatrice_vst_tpu_torch.golden` against the JAX slots f32 and bf16 runs
of the same scenario.  Run with -s to see the measured numbers."""

import collections
import os

import numpy as np
import pytest
import torch

from beatrice_vst_tpu.models.io import load_model_dir
from beatrice_vst_tpu.runtime.engine import EngineConfig as JEngineConfig
from beatrice_vst_tpu.runtime.engine import StreamEngine as JStreamEngine
from beatrice_vst_tpu.runtime.handle import StreamHandle as JStreamHandle
from beatrice_vst_tpu_torch import golden
from beatrice_vst_tpu_torch.constants import V20RC0
from beatrice_vst_tpu_torch.models import fused_upsampler as FU
from beatrice_vst_tpu_torch.models.io import load_weights
from beatrice_vst_tpu_torch.runtime import ModelHost
from beatrice_vst_tpu_torch.runtime import engine as engine_mod
from beatrice_vst_tpu_torch.runtime.engine import EngineConfig, StreamEngine, donated_tick
from beatrice_vst_tpu_torch.speakers import bank as bank_mod

torch.set_num_threads(1)

MODEL_DIR = os.path.join(os.path.dirname(__file__), "..", "models_demo", "klatt8")
CAP = golden.EDITS_CAPACITY
FRAMES_PER_TICK = (1, 3)
CONFIGS = {
    "per_stream_f32": dict(kv_cache_mode="per_stream", vq_shared_bank=False),
    "slots_f32": {},
    "slots_bf16": dict(compute_dtype="bfloat16"),
}


@pytest.fixture(scope="module")
def klatt8_port():
    params = load_weights(os.path.join(MODEL_DIR, "weights.npz"), device="cpu")
    bank = bank_mod.load(os.path.join(MODEL_DIR, "speakers.npz"), V20RC0, device="cpu")
    return params, bank


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX engine (jit, donated state) through `golden.run_edits`:
    {(config, T): [ticks, CAP, T*480]}."""
    _, _, jparams, jbank = load_model_dir(MODEL_DIR)
    out = {}
    for t in FRAMES_PER_TICK:
        for name, kw in CONFIGS.items():
            jcfg = JEngineConfig.realtime(CAP, frames_per_tick=t, **kw)
            engine = JStreamEngine(jcfg, jparams, jbank)
            out[name, t] = golden.run_edits(
                engine, reset_context=lambda i, e=engine: JStreamHandle(e, i).reset_context())
    return out


@pytest.mark.parametrize("frames_per_tick", FRAMES_PER_TICK)
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_donated_tick_engine_matches_functional_and_jax(klatt8_port, jax_runs, config,
                                                        frames_per_tick):
    cfg = EngineConfig.realtime(CAP, frames_per_tick=frames_per_tick, **CONFIGS[config])
    runs, kept = {}, []
    for jit in (True, False):
        engine = StreamEngine(cfg, *klatt8_port, device="cpu", jit=jit)
        assert engine.jit is jit
        leaves = list(_leaves(engine.state))
        runs[jit] = golden.run_edits(engine, lambda t: t.numpy(), keep=kept if jit else None)
        if jit:  # donated: the same tensors throughout, recover() included
            assert all(a is b for a, b in zip(leaves, _leaves(engine.state)))
            state_storages = {t.untyped_storage().data_ptr() for t in leaves}
    np.testing.assert_array_equal(runs[True], runs[False])
    # every tick returned a tensor of its own, apart from the state
    outs = {t.untyped_storage().data_ptr() for t in kept}
    assert len(outs) == golden.EDITS_TICKS and not outs & state_storages
    got, want = runs[True], jax_runs[config, frames_per_tick]
    assert np.abs(want).max(axis=(1, 2)).min() > 1e-3  # real output every tick
    if config.endswith("bf16"):
        env = golden.envelope(got, {"f32": jax_runs["slots_f32", frames_per_tick],
                                    "bf16": want})
        print(f"\n{config} T={frames_per_tick}: {env}")
        assert env["ok"], env
    else:
        print(f"\n{config} T={frames_per_tick}: max |d| against the JAX engine "
              f"{np.abs(got - want).max():.3g}")
        np.testing.assert_allclose(got, want, rtol=0, atol=golden.F32_ATOL)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def test_donated_tick_writes_the_functional_state_and_passes_the_rest_through(klatt8_port):
    """donated_tick leaves in `state` what engine_tick returns as the new
    state, in the same tensors, and touches no leaf the tick passed
    through (the controls, the slot bank)."""
    engine = StreamEngine(EngineConfig.realtime(CAP), *klatt8_port, device="cpu", jit=False)
    golden.admit_all(engine)
    engine.flush_controls()
    x = torch.from_numpy(golden.swept_sine(cap=CAP, ticks=1))
    state = engine.state
    out_f, new = engine_mod.engine_tick(engine.params, engine.bank, state, x, cfg=engine.cfg)
    before = [(t, t.clone()) for t in _leaves(state)]
    passed = {id(t) for t in _leaves(state["controls"])}
    passed |= {id(t) for t in _leaves(state["kv_slots"])}
    out_d = donated_tick(engine.params, engine.bank, state, x, cfg=engine.cfg)
    assert torch.equal(out_d, out_f)
    for (t, old), t_new in zip(before, _leaves(new)):
        assert torch.equal(t, t_new)
        if id(t) in passed:
            assert t_new is t and torch.equal(t, old)
    assert any(not torch.equal(t, old) for t, old in before)


def test_donated_tick_reads_no_overwritten_leaf(monkeypatch):
    """A new leaf that is an old leaf being written (here the tick swaps
    two carries and adds one to the first) is copied aside first."""
    def swap(params, bank, state, audio48, *, cfg):
        return audio48 * 2, {**state, "a": state["b"] + 1, "b": state["a"]}

    monkeypatch.setattr(engine_mod, "engine_tick", swap)
    state = {"a": torch.tensor([1.0, 2.0]), "b": torch.tensor([10.0, 20.0]),
             "c": torch.zeros(2)}
    a, b, c = state["a"], state["b"], state["c"]
    out = donated_tick(None, None, state, torch.ones(2), cfg=None)
    assert state["a"] is a and state["b"] is b and state["c"] is c
    assert a.tolist() == [11.0, 21.0] and b.tolist() == [1.0, 2.0]
    assert out.tolist() == [2.0, 2.0]


def test_donated_tick_refuses_a_state_of_another_shape(monkeypatch):
    def grow(params, bank, state, audio48, *, cfg):
        return audio48, {**state, "a": torch.zeros(3)}

    monkeypatch.setattr(engine_mod, "engine_tick", grow)
    with pytest.raises(ValueError, match="changed a state leaf"):
        donated_tick(None, None, {"a": torch.zeros(2)}, torch.ones(2), cfg=None)


@pytest.mark.parametrize("jit", [True, False])
def test_recover_keeps_the_donated_state_tensors(klatt8_port, jit):
    """recover() with jit=True zeroes the state in its own tensors (a
    captured graph reads them); with jit=False it rebinds fresh ones."""
    engine = StreamEngine(EngineConfig.realtime(CAP), *klatt8_port, device="cpu", jit=jit)
    golden.admit_all(engine)
    x = golden.swept_sine(cap=CAP, ticks=3)
    for k in range(3):
        engine.tick(x[:, 480 * k:480 * (k + 1)])
    leaves = list(_leaves(engine.state))
    assert int(engine.state["frame_counter"].sum()) == 3 * CAP
    assert engine.recover() == list(range(CAP))
    same = [a is b for a, b in zip(leaves, _leaves(engine.state))]
    assert all(same) if jit else not any(same)
    fresh = engine_mod.init_engine_state(engine.cfg, "cpu")
    for key in ("model", "rs_in", "rs_out", "frame_counter"):
        assert all(torch.equal(a, b) for a, b in zip(_leaves(engine.state[key]),
                                                     _leaves(fresh[key])))


@pytest.mark.parametrize("jit", [True, False])
def test_model_host_hands_jit_to_its_engines(jit):
    host = ModelHost(capacity=2, realtime=False, device="cpu", jit=jit)
    assert host.load_model(MODEL_DIR) == 0
    try:
        assert host.jit is jit and host.engine.jit is jit
        s = host.open_session(48000.0)
        s.push(np.zeros(960, np.float32))
        host.tick_once()
        assert len(s.pull(480)) == 480
    finally:
        host.stop()
    assert ModelHost(capacity=1, device="cpu").jit is True


def test_replays_count_the_launches_their_capture_recorded(monkeypatch):
    """The launch counters count a replayed graph's kernel launches by
    form: `recording` collects what a capture records (and nothing goes to
    the counters), `count_replay` adds it once per replay."""
    monkeypatch.setattr(FU, "launches", 5)
    monkeypatch.setattr(FU, "launches_bf16", 7)
    monkeypatch.setattr(FU, "yardstick_launches", collections.Counter())
    with FU.recording() as recorded:
        assert FU._capture.counts is recorded and not recorded
        recorded["fused_upsampler", torch.float32] += 1
    assert FU._capture.counts is None
    for _ in range(3):
        FU.count_replay(recorded)
    FU.count_replay({("fused_upsampler_bf16", torch.bfloat16): 2,
                     ("fused_upsampler", torch.bfloat16): 1})
    assert (FU.launches, FU.launches_bf16) == (8, 9)
    assert FU.yardstick_launches == {("fused_upsampler", "torch.bfloat16"): 1}
