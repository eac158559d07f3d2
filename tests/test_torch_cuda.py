"""Card-only tests of the port: each form of the CUDA kernel against its
plain PyTorch version (the f32 form of csrc/fused_upsampler.cu and the
tensor-core bf16 form of csrc/fused_upsampler_bf16.cu), the bf16 form
against its yardstick (the FFMA bf16 form) and its SASS, the engine
through the kernel against the engine
through the plain version and against the golden file of the JAX engine,
in the three configurations, the exact int8 contractions, and a tick
without host synchronisation, functional and graph; the compiled tick (a
CUDA graph over the donated tick): bitwise equal to the eager tick
through edits, morphs and recover(), its replays counted as kernel
launches, a capture while another engine's graph ticks (a ModelHost
swap), and a capture that cannot succeed raising; offline conversion against the golden file
of the JAX package's, and a tick of 25 frames (the stage loop) against 25
real-time ticks (the kernel) for 2.0.0-rc.0 and 2.0.0-alpha.2; with morph
streams, a warm tick without host synchronisation, tie order on the card,
and the morph golden file; serving: pipeline mode equal to plain mode one
tick later over 50 ticks (bitwise), `reset_context` from a client thread
while the scheduler ticks leaving the other streams bitwise unchanged,
`ModelHost()` on the card by default, and a warm serving tick whose only
wait is on its output copy's event; multi-GPU: a world-size-1 NCCL group's
1 x 1 mesh tick equal to the unsharded tick, and two gloo ranks sharing
the card, each ticking half the streams, against one process.  They skip
where torch.cuda.is_available() is false.

This file imports no JAX, so it also runs on a machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: f32 atol 1e-4, sums of up to 768 terms in another order (TF32
off on both sides).  bf16 atol 2e-2: the same sums can put a stage output
on the other side of a bf16 rounding (one bf16 ulp is 2^-8 to 2^-7 of a
value), and the next stages carry that on.  The golden file: f32 engines
at atol 1e-3, the bf16 engine by the envelope of
`beatrice_vst_tpu_torch.golden`.
"""

import os

import numpy as np
import pytest
import torch

from beatrice_vst_tpu_torch import golden
from beatrice_vst_tpu_torch.models import fused_upsampler as FU
from beatrice_vst_tpu_torch.models import layers

MODEL_DIR = os.path.join(os.path.dirname(__file__), "..", "models_demo", "klatt8")
GOLDEN = os.path.join(os.path.dirname(__file__), "data", "torch_engine_golden.npz")
OFFLINE_GOLDEN = os.path.join(os.path.dirname(__file__), "data", "torch_offline_golden.npz")
TOL = 1e-4
BF16_TOL = 2e-2
# name -> EngineConfig.realtime keywords
CONFIGS = {
    "per_stream_f32": dict(kv_cache_mode="per_stream", vq_shared_bank=False),
    "slots_f32": {},
    "slots_bf16": dict(compute_dtype="bfloat16"),
    "per_stream_bf16": dict(compute_dtype="bfloat16", kv_cache_mode="per_stream",
                            vq_shared_bank=False),
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _upsampler_args(b, seed, device, dtype=torch.float32):
    """Random head arguments; with bf16, h, the carries and the matmul
    weights in bf16 (rounded from the same f32 draws)."""
    up, final, h, states, src = _upsampler_args_f32(b, seed, device)
    up, final = FU.head_params(up, final, dtype)
    return up, final, h.to(dtype), [s.to(dtype) for s in states], src


def _upsampler_args_f32(b, seed, device):
    rng = np.random.default_rng(seed)
    h_shape, state_shapes, src_shapes, stage_shapes, final_shapes = FU.expected_shapes(b)

    def n(shape, scale):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).to(device)

    up = [{"conv": {"w": n(st["conv_w"], 1.0 / np.sqrt(3 * st["conv_w"][1])),
                    "b": n(st["conv_b"], 0.1)},
           "src": {"w": n(st["src_w"], 0.3), "b": n(st["src_b"], 0.1)},
           "snake": {"log_alpha": n(st["log_alpha"], 0.3)}} for st in stage_shapes]
    final = {"w": n(final_shapes["w"], 0.15), "b": n(final_shapes["b"], 0.1)}
    return (up, final, n(h_shape, 0.5), [n(s, 0.1) for s in state_shapes],
            [n(s, 0.3) for s in src_shapes])


@pytest.mark.cuda
# 15 and 17: a tile's ragged edge; 1, 3 and 100: partial clusters; 1000:
# more clusters than the card holds at once
@pytest.mark.parametrize("b", [1, 3, 15, 16, 17, 100, 256, 1000])
def test_fused_upsampler_kernel_matches_plain(cuda_device, b):
    args = _upsampler_args(b, b, cuda_device)
    before = FU.launches
    audio, new_states = FU.fused_upsample(*args)
    torch.cuda.synchronize()
    assert FU.launches == before + 1
    want_audio, want_states = FU.fused_upsample_reference(*args)
    torch.testing.assert_close(audio, want_audio, rtol=0, atol=TOL)
    assert len(new_states) == 5
    for got, want in zip(new_states, want_states):
        torch.testing.assert_close(got, want, rtol=0, atol=TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 3, 15, 16, 17, 100, 256, 1000])
def test_fused_upsampler_bf16_kernel_matches_plain(cuda_device, b):
    args = _upsampler_args(b, b, cuda_device, torch.bfloat16)
    before, before_f32 = FU.launches_bf16, FU.launches
    audio, new_states = FU.fused_upsample(*args)
    torch.cuda.synchronize()
    assert (FU.launches_bf16, FU.launches) == (before + 1, before_f32)
    want_audio, want_states = FU.fused_upsample_reference(*args)
    assert audio.dtype == torch.float32
    torch.testing.assert_close(audio, want_audio, rtol=0, atol=BF16_TOL)
    for got, want in zip(new_states, want_states):
        assert got.dtype == torch.bfloat16
        torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=BF16_TOL)


@pytest.mark.cuda
def test_fused_upsampler_bf16_kernel_rounds_where_the_plain_version_does(cuda_device):
    """The bf16 form rounds to bf16 where the plain bf16 version does: on
    the same bf16 inputs its RMS distance from that version is at most a
    quarter of the plain f32 version's (which rounds nowhere), for the
    audio and every carry."""
    up, final, h, states, src = _upsampler_args(256, 5, cuda_device, torch.bfloat16)
    got = FU.fused_upsample(up, final, h, states, src)
    want = FU.fused_upsample_reference(up, final, h, states, src)
    up32, final32 = FU.head_params(up, final, torch.float32)
    f32 = FU.fused_upsample_reference(up32, final32, h.float(), [s.float() for s in states],
                                      src)

    def rms(a, b):
        return float(((a.float() - b.float()) ** 2).mean().sqrt())

    for g, w, f in zip([got[0], *got[1]], [want[0], *want[1]], [f32[0], *f32[1]]):
        assert rms(g, w) <= 0.25 * rms(f, w)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_upsampler_is_deterministic(cuda_device, dtype):
    # no atomics and sums in a fixed order: two launches agree bit for bit
    args = _upsampler_args(100, 7, cuda_device, dtype)
    first = FU.fused_upsample(*args)
    second = FU.fused_upsample(*args)
    torch.cuda.synchronize()
    for got, want in zip([second[0], *second[1]], [first[0], *first[1]]):
        assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [256, 1024])
def test_fused_upsampler_bf16_matches_the_ffma_form(cuda_device, b):
    """The tensor-core bf16 form against its yardstick, the FFMA bf16 form
    of csrc/fused_upsampler.cu, on the same inputs: both round where the
    plain version does, their f32 sums differ in order."""
    args = _upsampler_args(b, 11, cuda_device, torch.bfloat16)
    before = FU.launches_bf16
    got = FU.fused_upsample(*args)
    ffma = FU._fused_upsample(*args, source=FU.YARDSTICKS[torch.bfloat16])
    torch.cuda.synchronize()
    assert FU.launches_bf16 == before + 1  # the yardstick's launch is not the form's
    torch.testing.assert_close(got[0], ffma[0], rtol=0, atol=BF16_TOL)
    for g, w in zip(got[1], ffma[1]):
        torch.testing.assert_close(g.float(), w.float(), rtol=0, atol=BF16_TOL)


@pytest.mark.cuda
def test_tensor_core_form_has_hmma_in_its_sass(cuda_device):
    from beatrice_vst_tpu_torch import cuda_build

    assert FU.FORMS[torch.bfloat16] == "fused_upsampler_bf16"
    assert cuda_build.sass("fused_upsampler_bf16").count("HMMA") > 0


@pytest.mark.cuda
def test_fused_upsampler_interleaved_parameter_sets(cuda_device):
    # two parameter sets and batches, launched in turn without a synchronise
    first, second = _upsampler_args(16, 1, cuda_device), _upsampler_args(33, 2, cuda_device)
    outs = [FU.fused_upsample(*args) for args in (first, second, first, second)]
    torch.cuda.synchronize()
    for args, (audio, new_states) in zip((first, second, first, second), outs):
        want_audio, want_states = FU.fused_upsample_reference(*args)
        torch.testing.assert_close(audio, want_audio, rtol=0, atol=TOL)
        for got, want in zip(new_states, want_states):
            torch.testing.assert_close(got, want, rtol=0, atol=TOL)


@pytest.mark.cuda
def test_fused_upsampler_rejects_misaligned(cuda_device):
    up, final, h, states, src = _upsampler_args(4, 0, cuda_device)
    h = torch.empty(h.numel() + 1, device=cuda_device)[1:].view(h.shape).copy_(h)
    with pytest.raises(ValueError, match="aligned"):
        FU.fused_upsample(up, final, h, states, src)


@pytest.mark.cuda
def test_fused_upsampler_rejects_non_contiguous(cuda_device):
    up, final, h, states, src = _upsampler_args(4, 0, cuda_device)
    states[1] = states[1].transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        FU.fused_upsample(up, final, h, states, src)


def _klatt8(device):
    from beatrice_vst_tpu_torch.constants import V20RC0
    from beatrice_vst_tpu_torch.models.io import load_weights
    from beatrice_vst_tpu_torch.speakers import bank as bank_mod

    return (load_weights(os.path.join(MODEL_DIR, "weights.npz"), device=device),
            bank_mod.load(os.path.join(MODEL_DIR, "speakers.npz"), V20RC0, device=device))


def _engine(config, device, upsampler_kernel=True, cap=8, jit=True, frames_per_tick=1):
    from beatrice_vst_tpu_torch.runtime.engine import EngineConfig, StreamEngine

    params, bank = _klatt8(device)
    cfg = EngineConfig.realtime(cap, upsampler_kernel=upsampler_kernel,
                                frames_per_tick=frames_per_tick, **CONFIGS[config])
    return StreamEngine(cfg, params, bank, device=device, jit=jit)


def _counter(config):
    return "launches_bf16" if config.endswith("bf16") else "launches"


@pytest.mark.cuda
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_engine_kernel_matches_plain_engine(cuda_device, config):
    cap, ticks = 8, 6
    engines = []
    for kernel in (True, False):
        e = _engine(config, cuda_device, kernel, cap)
        for i in range(cap):
            e.admit()
            e.set_control(i, "target_speaker", i)
            e.set_control(i, "vq_num_neighbors", i % 3)
        engines.append(e)
    rng = np.random.default_rng(0)
    audio = torch.from_numpy((rng.standard_normal((ticks, cap, 480)) * 0.1)
                             .astype(np.float32)).to(cuda_device)
    before = getattr(FU, _counter(config))
    tol = BF16_TOL if config.endswith("bf16") else TOL
    for k in range(ticks):
        got = engines[0].tick(audio[k])
        want = engines[1].tick(audio[k])
        torch.testing.assert_close(got, want, rtol=0, atol=tol)
    assert getattr(FU, _counter(config)) == before + ticks


@pytest.mark.cuda
def test_slots_bf16_tick_launches_the_tensor_core_form_once(cuda_device):
    cap = 8
    engine = _engine("slots_bf16", cuda_device, cap=cap)
    for i in range(cap):
        engine.admit()
        engine.set_control(i, "target_speaker", i)
    rng = np.random.default_rng(1)
    audio = torch.from_numpy((rng.standard_normal((2, cap, 480)) * 0.1)
                             .astype(np.float32)).to(cuda_device)
    engine.tick(audio[0])
    torch.cuda.synchronize()
    before = (FU.launches_bf16, FU.launches, dict(FU.yardstick_launches))
    engine.tick(audio[1])
    torch.cuda.synchronize()
    assert (FU.launches_bf16, FU.launches, dict(FU.yardstick_launches)) == (
        before[0] + 1, before[1], before[2])


@pytest.mark.cuda
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_engine_on_the_card_matches_the_golden_file(cuda_device, config):
    """The card's engine on the golden run (4 streams x 20 ticks): f32 at
    atol 1e-3 of the JAX engine's output, bf16 by the envelope."""
    ref = golden.load(GOLDEN)
    got = golden.run(_engine(config, cuda_device, cap=golden.CAPACITY),
                     lambda t: t.cpu().numpy())
    if config.endswith("bf16"):
        env = golden.envelope(got, ref)
        assert env["ok"], env
    else:
        np.testing.assert_allclose(got, ref["f32"], rtol=0, atol=golden.F32_ATOL)


@pytest.mark.cuda
def test_int8_contractions_are_exact_on_the_card(cuda_device):
    """The slot attention's int8 x int8 products equal the CPU's int32
    results bit for bit, with TF32 allowed or not."""
    rng = np.random.default_rng(3)
    a = rng.integers(-127, 128, (256, 24 * 64)).astype(np.int64)
    b = rng.integers(-127, 128, (24 * 64, 384)).astype(np.int64)
    want = a @ b  # int64 on the CPU: exact
    assert np.abs(want).max() < 2**24
    for allow in (False, True):
        torch.backends.cuda.matmul.allow_tf32 = allow
        got = layers._int8_dot(torch.from_numpy(a).to(cuda_device, torch.int8),
                               torch.from_numpy(b).to(cuda_device, torch.int8))
        assert np.array_equal(got.cpu().numpy().astype(np.int64), want), allow
    torch.backends.cuda.matmul.allow_tf32 = False


def _warm_tick(e, x):
    """A warm tick under torch's sync debug mode set to raise: with jit
    the engine's tick (copy in, replay, copy out), else engine_tick.
    Returns (output, the state after it)."""
    from beatrice_vst_tpu_torch.runtime.engine import engine_tick

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        if e.jit:
            out, state = e.tick(x), e.state
        else:
            out, state = engine_tick(e.params, e.bank, e.state, x, cfg=e.cfg)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return out, state


@pytest.mark.cuda
@pytest.mark.parametrize("jit", [False, True])
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_warm_tick_makes_no_host_synchronisation(cuda_device, config, jit):
    """A warm tick copies nothing to the host and waits for nothing: the
    functional engine_tick (what a CUDA graph over the tick needs), and
    the graph tick."""
    e = _engine(config, cuda_device, jit=jit)
    for i in range(e.cfg.capacity):
        e.admit()
        e.set_control(i, "target_speaker", i % 8)
    x = torch.zeros((e.cfg.capacity, 480), device=cuda_device)
    for _ in range(2):
        e.tick(x)
    out, _ = _warm_tick(e, x)
    assert bool(torch.isfinite(out).all())


@pytest.mark.cuda
@pytest.mark.parametrize("jit", [False, True])
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_morph_warm_tick_makes_no_host_synchronisation(cuda_device, config, jit):
    """With morph streams (the codebook lottery, morph slots or morphed K/V
    cache rows) a warm tick still copies nothing to the host and waits for
    nothing, functional or graph."""
    e = _engine(config, cuda_device, jit=jit)
    for i in range(e.cfg.capacity):
        e.admit()
        e.set_control(i, "target_speaker", i % 8)
    for i, weights in enumerate(golden.MORPH_WEIGHTS[1:5]):
        golden.set_morph(e, 2 * i + 1, *golden.morph_controls(weights))
    x = torch.zeros((e.cfg.capacity, 480), device=cuda_device)
    for _ in range(2):
        e.tick(x)
    out, state = _warm_tick(e, x)
    assert bool(torch.isfinite(out).all())
    assert state["frame_counter"].tolist() == [3] * e.cfg.capacity


@pytest.mark.cuda
def test_prune_top_k_orders_ties_by_index_on_the_card(cuda_device):
    """Exact ties come in index order on the card as on the CPU (the
    order decides the lottery's picks)."""
    from beatrice_vst_tpu_torch.speakers.morpher import pruned_morph_weights

    dense = torch.zeros(4, 256)
    dense[0, [3, 1]] = 0.5
    dense[1, [7, 2, 5]] = 1 / 3
    dense[2, :10] = 0.1
    counts = torch.tensor([8, 8, 256, 4])
    want = pruned_morph_weights(dense, counts)
    got = pruned_morph_weights(dense.to(cuda_device), counts.to(cuda_device))
    assert torch.equal(got[1].cpu(), want[1])
    assert torch.equal(got[0].cpu(), want[0])
    assert want[1][0, :3].tolist() == [1, 3, 0]


@pytest.mark.cuda
def test_morph_engine_on_the_card_matches_the_golden_file(cuda_device):
    """The morph scenario (tests/data/torch_morph_golden.npz) through the
    kernel engine in each configuration: f32 at atol 1e-3, bf16 by the
    envelope."""
    from beatrice_vst_tpu_torch.runtime.engine import EngineConfig, StreamEngine

    ref = golden.load(os.path.join(os.path.dirname(GOLDEN), "torch_morph_golden.npz"))
    params, bank = _klatt8(cuda_device)
    for config, kw in golden.MORPH_CONFIGS.items():
        engine = StreamEngine(EngineConfig.realtime(golden.MORPH_CAPACITY, **kw), params, bank,
                              device=cuda_device)
        got = golden.run_morph(engine, lambda t: t.cpu().numpy())
        if config.endswith("bf16"):
            env = golden.envelope(got, {"f32": ref["slots_f32"], "bf16": ref[config]})
            assert env["ok"], env
        else:
            np.testing.assert_allclose(got, ref[config], rtol=0, atol=golden.F32_ATOL,
                                       err_msg=config)


@pytest.mark.cuda
def test_offline_on_the_card_matches_the_golden_file(cuda_device):
    """convert_utterance on the card (chunks of 64 frames, 44.1 kHz in and
    out) at atol 1e-3 of the JAX package's output."""
    from beatrice_vst_tpu_torch.constants import V20RC0
    from beatrice_vst_tpu_torch.models.chain import VoiceConverterConfig
    from beatrice_vst_tpu_torch.runtime.offline import ConversionSettings, convert_utterance

    params, bank = _klatt8(cuda_device)
    got = convert_utterance(params, VoiceConverterConfig.for_version(V20RC0), bank,
                            golden.offline_signal(), golden.OFFLINE_RATE,
                            ConversionSettings(**golden.OFFLINE_SETTINGS),
                            chunk_frames=golden.OFFLINE_CHUNK_FRAMES, device=cuda_device)
    want = golden.load(OFFLINE_GOLDEN)["f32"]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=golden.F32_ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("version", ["2.0.0-rc.0", "2.0.0-alpha.2"])
def test_chunk_tick_matches_streaming_on_the_card(cuda_device, version):
    """run_parity on the card: one tick of 25 frames (the stage loop, no
    kernel launch) against 25 ticks of one frame (the f32 kernel, one
    launch each), at the JAX harness's 1e-3.  2.0.0-rc.0 on klatt8,
    2.0.0-alpha.2 on random parameters from a seed."""
    from beatrice_vst_tpu_torch.constants import VERSIONS
    from beatrice_vst_tpu_torch.models.chain import VoiceConverterConfig
    from beatrice_vst_tpu_torch.parity import run_parity

    spec = VERSIONS[version]
    params = bank = None
    if spec.has_kv:
        params, bank = _klatt8(cuda_device)
    cfg = VoiceConverterConfig.for_version(spec)
    counts = {}

    def timer(name):
        import contextlib

        @contextlib.contextmanager
        def count():
            before = FU.launches
            yield
            counts[name] = FU.launches - before
        return count()

    report = run_parity(params, cfg, bank, spec=spec, n_frames=25, batch=8,
                        controls={"vq_num_neighbors": 2, "pitch_shift": 3.0},
                        device=cuda_device, timer=timer)
    assert report.passed, str(report)
    assert counts == {"chunk": 0, "stream": 25}


# ---- the compiled tick: a CUDA graph over the donated tick ----


@pytest.mark.cuda
@pytest.mark.parametrize("frames_per_tick", [1, 3])
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_graph_tick_equals_eager_tick(cuda_device, config, frames_per_tick):
    """golden.run_edits (32 ticks with control edits, admit and evict,
    reset_context, morphs and recover() between them) through the graph
    engine and the eager one (jit=False): bitwise equal, every tick's
    output a tensor of its own, the state's tensors the graph's
    throughout."""
    runs, kept = {}, []
    for jit in (True, False):
        e = _engine(config, cuda_device, cap=golden.EDITS_CAPACITY, jit=jit,
                    frames_per_tick=frames_per_tick)
        assert (e._graph is not None) is jit
        leaves = [id(t) for t in _leaves(e.state)]
        runs[jit] = golden.run_edits(e, lambda t: t.cpu().numpy(), keep=kept if jit else None)
        assert ([id(t) for t in _leaves(e.state)] == leaves) is jit
    np.testing.assert_array_equal(runs[True], runs[False])
    assert len({t.data_ptr() for t in kept}) == golden.EDITS_TICKS
    assert np.abs(runs[True]).max() > 1e-3


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


@pytest.mark.cuda
@pytest.mark.parametrize("config", ["slots_f32", "slots_bf16"])
def test_kernel_counters_count_graph_replays(cuda_device, config):
    """The capture records one launch of the configuration's form and
    counts none; the warm-up ticks before it launch it once each; every
    replay counts one launch, and the other form none."""
    import beatrice_vst_tpu_torch.runtime.engine as engine_mod

    counter = _counter(config)
    other = "launches" if counter == "launches_bf16" else "launches_bf16"
    before = (getattr(FU, counter), getattr(FU, other))
    e = _engine(config, cuda_device)
    torch.cuda.synchronize()
    assert e.counters["graph_warmup_ticks"] == engine_mod.GRAPH_WARMUP_TICKS
    form = FU.FORMS[torch.bfloat16 if config.endswith("bf16") else torch.float32]
    assert e._recorded == {(form, torch.bfloat16 if config.endswith("bf16") else torch.float32): 1}
    assert (getattr(FU, counter), getattr(FU, other)) == (
        before[0] + engine_mod.GRAPH_WARMUP_TICKS, before[1])
    e.admit()
    x = torch.zeros((e.cfg.capacity, 480), device=cuda_device)
    for _ in range(5):
        e.tick(x)
    torch.cuda.synchronize()
    assert (getattr(FU, counter), getattr(FU, other)) == (
        before[0] + engine_mod.GRAPH_WARMUP_TICKS + 5, before[1])


@pytest.mark.cuda
def test_model_host_swap_captures_while_the_old_server_ticks(cuda_device):
    """A model swap on a realtime ModelHost: the new engine warms up and
    captures its graph on the caller's thread while the old engine's
    scheduler keeps ticking its graph; both engines tick without a
    failure and the session hears audio after the swap."""
    import time

    from beatrice_vst_tpu_torch.runtime import ModelHost

    host = ModelHost(capacity=4)
    assert host.jit and host.load_model(MODEL_DIR) == 0
    try:
        s = host.open_session(48000.0)
        s.push(np.tile(golden.serve_signal(48000, 0), 3)[:48000])
        old = host.engine
        deadline = time.monotonic() + 60
        while old.metrics.ticks < 10 and time.monotonic() < deadline:
            time.sleep(0.01)
        ticks = old.metrics.ticks
        assert host.load_model(os.path.join(MODEL_DIR, "..", "klatt8_r6")) == 0
        new = host.engine
        assert new is not old and new._graph is not None
        assert old.metrics.ticks > ticks  # the old graph ticked during the capture
        s.push(golden.serve_signal(48000, 1)[:9600])
        while new.metrics.ticks < 30 and time.monotonic() < deadline:
            time.sleep(0.01)
        out = s.pull(48000)
        assert host.server.running
    finally:
        host.stop()
    for e in (old, new):
        snap = e.metrics_snapshot()
        assert "last_error" not in snap and not snap.get("recoveries"), snap
    assert len(out) and np.isfinite(out).all() and np.abs(out).max() > 1e-3


# ---- serving on the card ----


def _server(device, cap=4, pipeline=False):
    from beatrice_vst_tpu_torch.models.io import load_model_dir
    from beatrice_vst_tpu_torch.runtime import EngineConfig, StreamEngine, StreamingServer

    _, cfg, params, bank = load_model_dir(MODEL_DIR)
    engine = StreamEngine(EngineConfig(capacity=cap, model=cfg), params, bank, device=device)
    return StreamingServer(engine, realtime=False, pipeline=pipeline)


def _serve_ticks(srv, ticks, rates=(48000, 44100, 16000)):
    """Sessions at `rates`, each fed golden.serve_signal (one tick ahead)
    and pulled after every tick: each session's pulls."""
    sessions = [srv.open_session(float(r)) for r in rates]
    for i, s in enumerate(sessions):
        srv.engine.set_control(s.idx, "target_speaker", np.int32(2 * i + 1))
    signals = [np.tile(golden.serve_signal(r, i), 2) for i, r in enumerate(rates)]
    pulls = [[] for _ in rates]
    for k in range(ticks):
        for i, (s, r) in enumerate(zip(sessions, rates)):
            if k == 0:
                s.push(signals[i][:r // 100])
            s.push(signals[i][(k + 1) * r // 100:(k + 2) * r // 100])
        srv.tick_once()
        for i, (s, r) in enumerate(zip(sessions, rates)):
            pulls[i].append(s.pull(r // 100))
    return pulls


@pytest.mark.cuda
def test_serving_pipeline_equals_plain_one_tick_late(cuda_device):
    """50 ticks of varying input at three client rates: pipeline mode
    delivers plain mode's audio one tick later, bitwise."""
    plain = _serve_ticks(_server(cuda_device), 50)
    piped = _serve_ticks(_server(cuda_device, pipeline=True), 50)
    for a, b in zip(plain, piped):
        assert len(b[0]) == 0
        for k in range(49):
            assert np.array_equal(b[k + 1], a[k]), k
    assert max(float(np.abs(np.concatenate(a)).max()) for a in plain) > 1e-3


@pytest.mark.cuda
def test_reset_context_from_another_thread_leaves_the_other_streams_alone(cuda_device):
    """A client thread resets stream 0's context again and again while the
    scheduler thread ticks: the other streams' outputs equal a run without
    it, bitwise (the input is queued before the scheduler starts, so each
    tick reads the same samples whatever the timing)."""
    import threading
    import time

    from beatrice_vst_tpu_torch.runtime.handle import StreamHandle

    ticks = 100

    def run(resets):
        srv = _server(cuda_device)
        sessions = [srv.open_session(48000.0) for _ in range(3)]
        for i, s in enumerate(sessions):
            srv.engine.set_control(s.idx, "target_speaker", np.int32(i + 2))
            s.push(golden.serve_signal(48000, i)[:480 * ticks])
        stop = threading.Event()

        def resetter():
            handle = StreamHandle(srv.engine, sessions[0].idx)
            while not stop.is_set():
                handle.reset_context()
                time.sleep(0.002)

        t = threading.Thread(target=resetter)
        if resets:
            t.start()
        srv.start()
        deadline = time.monotonic() + 120
        while srv.engine.metrics.ticks < ticks + 5 and time.monotonic() < deadline:
            time.sleep(0.01)
        stop.set()
        srv.stop()
        if resets:
            t.join(timeout=30)
        assert srv.engine.metrics.ticks >= ticks and not srv.engine.counters.get("recoveries")
        return [s.ring_out.read(480 * ticks) for s in sessions]

    calm, busy = run(False), run(True)
    for a, b in zip(calm[1:], busy[1:]):
        assert len(a) == len(b) == 480 * ticks and np.array_equal(a, b)
    assert not np.array_equal(calm[0], busy[0])


@pytest.mark.cuda
def test_model_host_runs_on_the_card_by_default(cuda_device):
    from beatrice_vst_tpu_torch.runtime import ModelHost

    host = ModelHost(capacity=2, realtime=False)
    assert host.device.type == "cuda"
    assert host.load_model(MODEL_DIR) == 0
    s = host.open_session(48000.0)
    assert host.engine.state["controls"]["active"].device.type == "cuda"
    before = FU.launches
    s.push(golden.serve_signal(48000, 0)[:4800])
    for _ in range(5):
        host.tick_once()
    assert FU.launches - before == 5
    out = s.pull(4800)
    assert len(out) == 2400 and np.isfinite(out).all()
    host.stop()


@pytest.mark.cuda
@pytest.mark.parametrize("pipeline", [False, True])
def test_serving_tick_syncs_only_on_the_output_copy(cuda_device, pipeline):
    """A warm serving tick (no control edit staged) makes no host
    synchronisation that torch's sync debug mode sees: its input goes to
    the card from a pinned buffer without blocking, and the host waits for
    the card only on the event behind the output's copy."""
    srv = _server(cuda_device, pipeline=pipeline)
    pulls = _serve_ticks(srv, 3)
    s = srv.sessions[0]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            s.push(np.zeros(480, np.float32))
            srv.tick_once()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    out = s.pull(480 * 3)
    assert len(out) == 480 * 3 and np.isfinite(out).all()
    assert sum(len(p) for p in pulls[0]) == 480 * (2 if pipeline else 3)


@pytest.mark.cuda
def test_fused_upsampler_refuses_autograd(cuda_device):
    """The kernel has no backward (the JAX kernel has no VJP): under
    autograd, with an input that requires grad, the CUDA route raises
    instead of returning outputs without a gradient, and launches
    nothing; with no input requiring grad, or under no_grad, it runs."""
    up, final, h, states, src = _upsampler_args(16, 5, cuda_device)
    before = FU.launches
    with pytest.raises(RuntimeError, match="no backward"):
        FU.fused_upsample(up, final, h.clone().requires_grad_(True), states, src)
    up[0]["conv"]["w"].requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        FU.fused_upsample(up, final, h, states, src)
    assert FU.launches == before
    with torch.no_grad():
        FU.fused_upsample(up, final, h, states, src)
    up[0]["conv"]["w"].requires_grad_(False)
    FU.fused_upsample(up, final, h, states, src)
    torch.cuda.synchronize()
    assert FU.launches == before + 2


@pytest.mark.cuda
def test_training_on_the_card_never_launches_the_kernel(cuda_device):
    """A train step at one frame a batch (T = 1, where the vocoder's head
    is the fused upsampler's route) takes the plain head under autograd:
    no launch, gradients in every stage of the head."""
    from beatrice_vst_tpu_torch.constants import V20RC0
    from beatrice_vst_tpu_torch.models.chain import VoiceConverterConfig
    from beatrice_vst_tpu_torch.models.io import load_model_dir
    from beatrice_vst_tpu_torch.training import distill

    _, cfg, params, bank = load_model_dir(MODEL_DIR)
    assert cfg == VoiceConverterConfig.for_version(V20RC0) and cfg.wg.upsampler_kernel
    batch = golden.train_inputs(cfg, bank, cuda_device, golden.train_batch(frames=1))
    p = distill.trainable(params, cuda_device)
    before = FU.launches
    loss, _ = distill.distillation_loss(p, cfg, batch["audio16"], batch["target24"],
                                        batch["cond"], f0_bin=batch["f0_bin"])
    loss.backward()
    torch.cuda.synchronize()
    assert FU.launches == before
    for stage in p["wg"]["up"]:
        assert float(stage["conv"]["w"].grad.abs().max()) > 0


MESH_CAPACITY = 8
MESH_TICKS = 6


def _mesh_tick_kwargs(config):
    from beatrice_vst_tpu_torch.models.io import load_model_dir

    _, _, params, bank = load_model_dir(MODEL_DIR)
    rng = np.random.default_rng(3)
    audio = (0.3 * np.sin(np.arange(MESH_TICKS * 480) * 2 * np.pi * 180 / 48000)
             + 0.02 * rng.standard_normal((MESH_CAPACITY, MESH_TICKS * 480)))
    audio = audio.astype(np.float32).reshape(MESH_CAPACITY, MESH_TICKS, 480).transpose(1, 0, 2)
    return dict(params=params, bank=bank, audio=np.ascontiguousarray(audio),
                version="2.0.0-rc.0", capacity=MESH_CAPACITY, admit="all",
                engine_kw=CONFIGS[config], keep_state=False)


@pytest.mark.cuda
@pytest.mark.parametrize("config", ["slots_f32", "slots_bf16"])
def test_nccl_mesh_tick_equals_unsharded(cuda_device, config):
    """A world-size-1 NCCL group (distributed_init's default backend on
    the card) and a 1 x 1 mesh: the tick equals the unsharded tick."""
    import socket

    import torch.distributed as dist
    from beatrice_vst_tpu_torch.parallel import checks, distributed_init

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    kw = _mesh_tick_kwargs(config)
    distributed_init(f"tcp://127.0.0.1:{port}", 1, 0)
    try:
        assert dist.get_backend() == "nccl"
        sharded = checks.tick_case(mesh_shape=(1, 1), device=cuda_device, **kw)
    finally:
        dist.destroy_process_group()
    plain = checks.tick_case(device=cuda_device, **kw)
    np.testing.assert_array_equal(sharded["out"], plain["out"])


@pytest.mark.cuda
@pytest.mark.parametrize("config", ["slots_f32", "slots_bf16"])
def test_two_gloo_ranks_on_the_card_match_one_process(cuda_device, config):
    """Two gloo ranks sharing the card, each ticking half the streams: the
    gathered output equals the single-process tick at the kernel's
    tolerance, and each rank launches its form once a tick."""
    from beatrice_vst_tpu_torch.parallel import checks, spawn_cpu_ranks

    kw = _mesh_tick_kwargs(config)
    form = "bfloat16" if "compute_dtype" in CONFIGS[config] else "float32"
    results = spawn_cpu_ranks(2, checks.run_cases, "cuda",
                              [("tick", checks.tick_case, dict(kw, mesh_shape=(2, 1)))])
    plain = checks.tick_case(device=cuda_device, **kw)
    for res in results:
        got = res["tick"]
        assert got["rows"] == MESH_CAPACITY // 2
        assert got["launches"] == {"float32": 0, "bfloat16": 0, form: MESH_TICKS}
        np.testing.assert_allclose(got["out"], plain["out"], rtol=0,
                                   atol=BF16_TOL if form == "bfloat16" else TOL)


@pytest.mark.cuda
def test_a_capture_that_cannot_succeed_raises(cuda_device, monkeypatch):
    """A synchronising step (a copy to the host) warms up, as eager code
    may, but cannot be captured: building the engine raises and no engine
    ticks eagerly in its place.  (Last in the file: it leaves a failed
    capture behind.)"""
    import beatrice_vst_tpu_torch.runtime.engine as engine_mod

    donated = engine_mod.donated_tick

    def syncing(*args, **kw):
        out = donated(*args, **kw)
        float(out.sum())  # waits for the card
        return out

    monkeypatch.setattr(engine_mod, "donated_tick", syncing)
    before = (FU.launches, FU.launches_bf16)
    with pytest.raises(RuntimeError):
        _engine("slots_f32", cuda_device)
    assert FU._capture.counts is None
    assert (FU.launches, FU.launches_bf16) == (before[0] + engine_mod.GRAPH_WARMUP_TICKS,
                                               before[1])
    monkeypatch.undo()
    e = _engine("slots_f32", cuda_device)  # the card still captures and ticks
    e.admit()
    out = e.tick(torch.zeros((e.cfg.capacity, 480), device=cuda_device))
    assert bool(torch.isfinite(out).all())
