"""Card-only tests of the port: each form of the CUDA kernel against its
plain PyTorch version (the f32 form of csrc/fused_upsampler.cu and the
tensor-core bf16 form of csrc/fused_upsampler_bf16.cu), the bf16 form
against its yardstick (the FFMA bf16 form) and its SASS; the bf16 form
over a chunk of T frames in one launch against the plain version, against
T chained one-frame launches and every split of its frame axis (bitwise),
twice on the same inputs (bitwise), a bf16 engine at T = 25 counting one
launch and capacity x 25 frames a tick, and a chunk under autograd taking
the stage loop; the engine
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
the card, each ticking half the streams, against one process; the
compiled mesh steps: the tensor-parallel tick on a world-size-1 NCCL group
(its all-reduces in the graph) equal to its eager twin, jit=True refused on
a gloo group for that tick, and the NCCL spawner refusing more ranks than
cards; the edges' polyphase resampler kernel against the dense banded
product at four rates, four block sizes and three batches, a stream
carried block by block against one offline launch (bitwise), and its
launches and samples counted once a replay of the tick graph.  They skip
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

import gc
import os

import numpy as np
import pytest
import torch

from beatrice_vst_tpu_torch import device as device_mod
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


def _upsampler_args(b, seed, device, dtype=torch.float32, frames=1):
    """Random head arguments for `frames` frames; with bf16, h, the carries
    and the matmul weights in bf16 (rounded from the same f32 draws)."""
    up, final, h, states, src = _upsampler_args_f32(b, seed, device, frames)
    up, final = FU.head_params(up, final, dtype)
    return up, final, h.to(dtype), [s.to(dtype) for s in states], src


def _upsampler_args_f32(b, seed, device, frames=1):
    rng = np.random.default_rng(seed)
    h_shape, state_shapes, src_shapes, stage_shapes, final_shapes = FU.expected_shapes(b, frames)

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


# ---- the bf16 form over a chunk of T frames (the chunk entry point) ----

SPF = (4, 20, 80, 240)  # source rows a frame, by stage


def _frames_of(args, f):
    """The one-frame arguments of frame f of a chunk's, carries aside."""
    up, final, h, _, src = args
    return up, final, h[:, f:f + 1].contiguous(), [
        s[:, f * k:(f + 1) * k].contiguous() for s, k in zip(src, SPF)]


@pytest.mark.cuda
@pytest.mark.parametrize("frames", [2, 25])
@pytest.mark.parametrize("b", [16, 40, 256])
def test_fused_upsampler_bf16_chunk_matches_plain(cuda_device, b, frames):
    """One launch for a chunk of T frames against the plain version over
    the T frames, at the one-frame bf16 tolerance; counted as one launch
    and b * T frames."""
    args = _upsampler_args(b, b + frames, cuda_device, torch.bfloat16, frames)
    before = (FU.launches_bf16, FU.frames_bf16, FU.launches, FU.frames)
    audio, new_states = FU.fused_upsample(*args)
    torch.cuda.synchronize()
    assert (FU.launches_bf16, FU.frames_bf16, FU.launches, FU.frames) == (
        before[0] + 1, before[1] + b * frames, before[2], before[3])
    want_audio, want_states = FU.fused_upsample_reference(*args)
    assert audio.shape == (b, frames * 240)
    torch.testing.assert_close(audio, want_audio, rtol=0, atol=BF16_TOL)
    for got, want in zip(new_states, want_states):
        assert got.dtype == torch.bfloat16
        torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=BF16_TOL)


@pytest.mark.cuda
# 1 x 40 and 3 x 7: the frame axis split over clusters (`frame_block`),
# each block after a warm-up frame; 256 x 25: one block of every frame
@pytest.mark.parametrize("b, frames", [(1, 40), (3, 7), (17, 5), (256, 25)])
def test_fused_upsampler_bf16_chunk_is_chained_one_frame_launches(cuda_device, b, frames):
    """A chunk's launch equals T one-frame launches with the carries handed
    on, bit for bit (the same per-frame arithmetic), and so does every
    split of its frame axis."""
    args = _upsampler_args(b, 3 * b + frames, cuda_device, torch.bfloat16, frames)
    audio, new_states = FU.fused_upsample(*args)
    parts, carries = [], args[3]
    for f in range(frames):
        up, final, h, src = _frames_of(args, f)
        a, carries = FU.fused_upsample(up, final, h, carries, src)
        parts.append(a)
    torch.cuda.synchronize()
    assert torch.equal(audio, torch.cat(parts, dim=1))
    for got, want in zip(new_states, carries):
        assert torch.equal(got, want)
    import ctypes

    for block in sorted({1, 2, 3, frames}):  # the launch at each block of frames
        got = FU._check(*args)
        out = torch.empty_like(audio)
        outs = [torch.empty_like(s) for s in args[3]]
        packed = FU._pack(got, out, outs)
        err = FU._chunk_launcher()(ctypes.addressof(packed), b, frames, block,
                                   torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        assert err == 0
        assert torch.equal(out, audio), block
        for g, w in zip(outs, new_states):
            assert torch.equal(g, w), block


@pytest.mark.cuda
def test_fused_upsampler_bf16_chunk_is_deterministic(cuda_device):
    args = _upsampler_args(100, 8, cuda_device, torch.bfloat16, 25)
    first = FU.fused_upsample(*args)
    second = FU.fused_upsample(*args)
    torch.cuda.synchronize()
    for got, want in zip([second[0], *second[1]], [first[0], *first[1]]):
        assert torch.equal(got, want)


@pytest.mark.cuda
def test_f32_form_refuses_a_chunk(cuda_device):
    # the f32 form takes one frame a launch; a chunk in f32 runs the stage loop
    with pytest.raises(ValueError, match="one frame"):
        FU.fused_upsample(*_upsampler_args(4, 0, cuda_device, torch.float32, 3))


@pytest.mark.cuda
def test_bf16_t25_tick_launches_the_kernel_once_for_every_frame(cuda_device):
    """A bf16 engine at 25 frames a tick: its captured tick records one
    launch of the tensor-core form and capacity x 25 frames, and each
    replay counts them (the metrics op reports both); the f32 form, and
    the engine under autograd, launch nothing."""
    cap, t = 16, 25
    e = _engine("slots_bf16", cuda_device, cap=cap, frames_per_tick=t)
    form = FU.FORMS[torch.bfloat16]
    # the graph's record, by kernel: the edges' resampler launches twice a tick
    assert e._recorded == {("fused_upsampler", (form, torch.bfloat16)): 1,
                           ("fused_upsampler", (form, torch.bfloat16, "frames")): cap * t,
                           ("polyphase_resample", "launches"): 2,
                           ("polyphase_resample", "samples"): cap * (160 + 480) * t}
    for i in range(cap):
        e.admit()
    x = torch.zeros((cap, 480 * t), device=cuda_device)
    e.tick(x)
    torch.cuda.synchronize()
    before = (FU.launches_bf16, FU.frames_bf16, FU.launches, FU.frames)
    for _ in range(3):
        e.tick(x)
    torch.cuda.synchronize()
    assert (FU.launches_bf16, FU.frames_bf16, FU.launches, FU.frames) == (
        before[0] + 3, before[1] + 3 * cap * t, before[2], before[3])
    snap = e.metrics_snapshot()
    assert snap["upsampler_kernel_frames"]["bfloat16"] == FU.frames_bf16
    assert snap["upsampler_kernel_launches"]["bfloat16"] == FU.launches_bf16


@pytest.mark.cuda
def test_bf16_chunk_head_under_autograd_keeps_the_stage_loop(cuda_device, monkeypatch):
    """With a head weight that needs a gradient a bf16 chunk on the card
    takes the stage loop (the kernel has no backward) and launches
    nothing; without, the kernel once."""
    from beatrice_vst_tpu_torch.constants import V20RC0
    from beatrice_vst_tpu_torch.models import waveform_generator as W
    from beatrice_vst_tpu_torch.models.chain import VoiceConverterConfig

    wcfg = VoiceConverterConfig.for_version(V20RC0).wg
    params = W.init(torch.Generator().manual_seed(0), wcfg, cuda_device)
    b, t = 4, 5
    state = W.init_state(wcfg, (b,), cuda_device)
    state["up"] = [s.bfloat16() for s in state["up"]]
    state["final"] = state["final"].bfloat16()
    gen = torch.Generator().manual_seed(1)
    kv = torch.randn(b, 8, wcfg.kv_channels, generator=gen).to(cuda_device)
    inputs = [torch.randn(b, t, wcfg.phone_channels, generator=gen),
              torch.randint(0, wcfg.pitch_bins, (b, t), generator=gen),
              torch.randn(b, t, 4, generator=gen), torch.randn(b, wcfg.hidden, generator=gen)]
    inputs = [x.to(cuda_device) for x in inputs]
    stage_loops = []
    loop = W.upsample_stages
    monkeypatch.setattr(W, "upsample_stages", lambda *a: stage_loops.append(1) or loop(*a))
    for grad in (False, True):
        params["up"][0]["conv"]["w"].requires_grad_(grad)
        before = (FU.launches_bf16, FU.frames_bf16)
        with torch.no_grad() if not grad else torch.enable_grad():
            audio, _ = W.apply(params, wcfg, *inputs, state, compute_dtype=torch.bfloat16,
                               kv_embedding=kv)
        torch.cuda.synchronize()
        assert audio.shape == (b, t * 240) and bool(torch.isfinite(audio).all())
        launched = (FU.launches_bf16 - before[0], FU.frames_bf16 - before[1])
        assert (launched, len(stage_loops)) == (((0, 0), 1) if grad else ((1, b * t), 0))


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
    launch each, replays of the compiled streaming tick, whose capture's
    warm-up ticks launch it GRAPH_WARMUP_CALLS times), at the JAX
    harness's 1e-3.  2.0.0-rc.0 on klatt8, 2.0.0-alpha.2 on random
    parameters from a seed."""
    from beatrice_vst_tpu_torch.constants import VERSIONS
    from beatrice_vst_tpu_torch.models.chain import VoiceConverterConfig
    from beatrice_vst_tpu_torch.parity import run_parity
    from beatrice_vst_tpu_torch.runtime.graphs import GRAPH_WARMUP_CALLS

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
    assert counts == {"chunk": 0, "capture": GRAPH_WARMUP_CALLS, "stream": 25}


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
    dtype = torch.bfloat16 if config.endswith("bf16") else torch.float32
    assert e._recorded == {("fused_upsampler", (form, dtype)): 1,
                           ("fused_upsampler", (form, dtype, "frames")): e.cfg.capacity,
                           ("polyphase_resample", "launches"): 2,
                           ("polyphase_resample", "samples"): e.cfg.capacity * (160 + 480)}
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
    """Two gloo ranks sharing the card, each ticking half the streams
    through its compiled tick (no collective in it): the gathered output
    equals the single-process tick at the kernel's tolerance, and each
    rank launches its form once a tick and once a warm-up tick."""
    from beatrice_vst_tpu_torch.parallel import checks, spawn_cpu_ranks

    kw = _mesh_tick_kwargs(config)
    form = "bfloat16" if "compute_dtype" in CONFIGS[config] else "float32"
    results = spawn_cpu_ranks(2, checks.run_cases, "cuda",
                              [("tick", checks.tick_case, dict(kw, mesh_shape=(2, 1)))])
    plain = checks.tick_case(device=cuda_device, **kw)
    for res in results:
        got = res["tick"]
        assert got["rows"] == MESH_CAPACITY // 2
        assert got["compiled"] and got["warmup_ticks"] == 2
        assert got["launches"] == {"float32": 0, "bfloat16": 0,
                                   form: MESH_TICKS + got["warmup_ticks"]}
        np.testing.assert_allclose(got["out"], plain["out"], rtol=0,
                                   atol=BF16_TOL if form == "bfloat16" else TOL)


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.cuda
@pytest.mark.parametrize("config", ["slots_f32", "slots_bf16"])
def test_nccl_compiled_tensor_parallel_tick_equals_eager(cuda_device, config):
    """A world-size-1 NCCL group and a 1 x 1 mesh with the weights split
    over 'model': the compiled tick holds the tensor-parallel all-reduces
    in its graph and equals its eager twin bitwise."""
    import torch.distributed as dist
    from beatrice_vst_tpu_torch.parallel import checks, distributed_init

    kw = dict(_mesh_tick_kwargs(config), mesh_shape=(1, 1), model_parallel=True,
              device=cuda_device)
    distributed_init(f"tcp://127.0.0.1:{_free_port()}", 1, 0)
    try:
        graph = checks.tick_case(**kw)
        eager = checks.tick_case(jit=False, **kw)
    finally:
        dist.destroy_process_group()
    assert graph["compiled"] and not eager["compiled"]
    assert graph["captured_collectives"] > 0 and eager["captured_collectives"] == 0
    np.testing.assert_array_equal(graph["out"], eager["out"])


@pytest.mark.cuda
def test_jit_true_on_a_gloo_group_with_collectives_raises(cuda_device):
    """A gloo group on the card: the tensor-parallel tick asked for
    compiled raises, naming the backend; with jit None it runs eagerly."""
    import torch.distributed as dist
    from beatrice_vst_tpu_torch.parallel import checks, distributed_init

    kw = dict(_mesh_tick_kwargs("slots_f32"), mesh_shape=(1, 1), model_parallel=True,
              device=cuda_device)
    distributed_init(f"tcp://127.0.0.1:{_free_port()}", 1, 0, backend="gloo")
    try:
        with pytest.raises(RuntimeError, match="'gloo' group on CUDA"):
            checks.tick_case(jit=True, **kw)
        assert not checks.tick_case(**kw)["compiled"]
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_nccl_spawner_with_more_ranks_than_cards_raises(cuda_device):
    """NCCL ranks are one a card: more ranks than cards raise, in the
    spawner and in the dry run, which falls back to nothing unless asked
    for gloo ranks sharing card 0."""
    from beatrice_vst_tpu_torch.parallel import spawn_nccl_ranks
    from beatrice_vst_tpu_torch.parallel.dryrun import dryrun_multichip

    n = torch.cuda.device_count() + 1
    with pytest.raises(RuntimeError, match=f"{n} NCCL ranks need {n} cards"):
        spawn_nccl_ranks(n, print)
    with pytest.raises(RuntimeError, match="NCCL ranks need"):
        dryrun_multichip(n, "cuda")


# ---- the compiled offline, seqpar, parity and training steps ----

TRAIN_RTOL = 1e-4  # golden.TRAIN_LOSS_RTOL: compiled and eager run the same kernels


def _klatt8_cfg():
    from beatrice_vst_tpu_torch.constants import V20RC0
    from beatrice_vst_tpu_torch.models.chain import VoiceConverterConfig

    return VoiceConverterConfig.for_version(V20RC0)


@pytest.mark.cuda
@pytest.mark.parametrize("chunk_frames,dtype", [(64, None), (64, torch.bfloat16), (0, None)],
                         ids=["chunk_f32", "chunk_bf16", "whole_f32"])
def test_offline_compiled_equals_eager_on_the_card(cuda_device, chunk_frames, dtype):
    """convert_utterance's compiled steps (CUDA graphs: the chunk step, the
    whole-utterance step, the resamplers) equal the eager conversion
    bitwise, on two utterances of one length (the second replays)."""
    from beatrice_vst_tpu_torch.runtime.offline import ConversionSettings, convert_utterance

    params, bank = _klatt8(cuda_device)
    settings = ConversionSettings(**golden.OFFLINE_SETTINGS)
    for seed in (0, 1):
        sig = golden.offline_signal(seed=seed)
        got, want = (convert_utterance(params, _klatt8_cfg(), bank, sig, golden.OFFLINE_RATE,
                                       settings, compute_dtype=dtype, chunk_frames=chunk_frames,
                                       device=cuda_device, jit=jit) for jit in (True, False))
        np.testing.assert_array_equal(got, want)
        assert np.abs(got).max() > 0.01


@pytest.mark.cuda
def test_offline_steps_of_two_models_of_one_shape(cuda_device):
    """klatt8 and klatt8_r6 (the same shapes): each model's compiled
    conversion equals its own eager one, bitwise (a graph reads the
    parameters it captured, keyed by their identity)."""
    from beatrice_vst_tpu_torch.models.io import load_model_dir
    from beatrice_vst_tpu_torch.runtime.offline import convert_utterance

    sig = golden.offline_signal()
    outs = []
    for name in ("klatt8", "klatt8_r6", "klatt8"):
        _, cfg, params, bank = load_model_dir(os.path.join(MODEL_DIR, "..", name))
        params = _to(params, cuda_device)
        got, want = (convert_utterance(params, cfg, bank, sig, golden.OFFLINE_RATE,
                                       chunk_frames=64, device=cuda_device, jit=jit)
                     for jit in (True, False))
        np.testing.assert_array_equal(got, want)
        outs.append(got)
    assert np.abs(outs[0] - outs[1]).max() > 1e-3
    np.testing.assert_array_equal(outs[0], outs[2])


def _to(params, device):
    from beatrice_vst_tpu_torch.models.io import params_from_numpy

    return params_from_numpy(params, device)


@pytest.mark.cuda
def test_seqpar_compiled_equals_eager_on_the_card(cuda_device):
    from beatrice_vst_tpu_torch.runtime.offline import ConversionSettings
    from beatrice_vst_tpu_torch.runtime.seqpar import convert_utterance_sp

    params, bank = _klatt8(cuda_device)
    sig = golden.offline_signal(seconds=4.0)
    got, want = (convert_utterance_sp(params, _klatt8_cfg(), bank, sig, golden.OFFLINE_RATE,
                                      ConversionSettings(**golden.OFFLINE_SETTINGS),
                                      n_segments=4, device=cuda_device, jit=jit)
                 for jit in (True, False))
    np.testing.assert_array_equal(got, want)


@pytest.mark.cuda
def test_parity_compiled_replays_count_one_launch_a_frame(cuda_device):
    """run_parity's compiled streaming half on klatt8: its capture's
    warm-up ticks launch the f32 form once each, each of the T replays
    counts one launch, the chunk tick none; the report equals the eager
    streaming half's."""
    import contextlib

    from beatrice_vst_tpu_torch.parity import run_parity
    from beatrice_vst_tpu_torch.runtime import graphs

    params, bank = _klatt8(cuda_device)
    launches = {}

    @contextlib.contextmanager
    def timer(name):
        torch.cuda.synchronize()
        before = (FU.launches, FU.launches_bf16)
        yield
        torch.cuda.synchronize()
        launches[name] = (FU.launches - before[0], FU.launches_bf16 - before[1])

    kw = dict(n_frames=20, batch=4, controls={"pitch_shift": 2.0}, device=cuda_device)
    got = run_parity(params, _klatt8_cfg(), bank, timer=timer, jit=True, **kw)
    assert launches == {"chunk": (0, 0), "capture": (graphs.GRAPH_WARMUP_CALLS, 0),
                        "stream": (20, 0)}
    want = run_parity(params, _klatt8_cfg(), bank, jit=False, **kw)
    assert got.passed and (got.max_abs_diff, got.rms_diff) == (want.max_abs_diff,
                                                               want.rms_diff)


def _train_setup(device):
    from beatrice_vst_tpu_torch.models.io import load_model_dir

    _, cfg, params, bank = load_model_dir(MODEL_DIR)
    return cfg, params, golden.train_inputs(cfg, bank, device)


def _rel(a, b):
    return abs(float(a) - float(b)) / abs(float(b))


@pytest.mark.cuda
def test_train_step_compiled_matches_eager_on_the_card(cuda_device):
    from beatrice_vst_tpu_torch.training import distill

    cfg, params, batch = _train_setup(cuda_device)
    runs = []
    for jit in (True, False):
        p = distill.trainable(params, cuda_device)
        opt = distill.make_optimizer(p, golden.TRAIN_LR, total_steps=10)
        runs.append([distill.train_step(p, opt, batch, cfg=cfg, jit=jit,
                                        periodicity_weight=golden.TRAIN_PERIO)[-1]
                     for _ in range(3)])
    for mc, me in zip(*runs):
        for k in me:
            assert _rel(mc[k], me[k]) <= TRAIN_RTOL, (k, float(mc[k]), float(me[k]))


@pytest.mark.cuda
def test_gan_train_step_compiled_matches_eager_on_the_card(cuda_device):
    from beatrice_vst_tpu_torch.training import distill, gan

    cfg, params, batch = _train_setup(cuda_device)
    runs = []
    for jit in (True, False):
        g = distill.trainable(params, cuda_device)
        d = distill.trainable(golden.disc_params(), cuda_device)
        opts = gan.make_gan_optimizers(g, d, golden.TRAIN_LR)
        runs.append([gan.gan_train_step(g, d, *opts, batch, cfg=cfg, jit=jit)[-1]
                     for _ in range(2)])
    for mc, me in zip(*runs):
        for k in ("g_loss", "d_loss", "rec", "fm", "adv"):
            assert _rel(mc[k], me[k]) <= TRAIN_RTOL, (k, float(mc[k]), float(me[k]))


@pytest.mark.cuda
@pytest.mark.parametrize("module", ["phone", "pitch", "wg"])
def test_module_step_compiled_matches_eager_on_the_card(cuda_device, module):
    from beatrice_vst_tpu_torch.models import chain
    from beatrice_vst_tpu_torch.training import distill
    from beatrice_vst_tpu_torch.training import feature_distill as FD

    cfg, params, batch = _train_setup(cuda_device)
    teacher = _to(params, cuda_device)
    losses = []
    for jit in (True, False):
        student = distill.trainable(chain.init(torch.Generator().manual_seed(2), cfg, "cpu"),
                                    cuda_device)
        opt = distill.Optimizer(student[module], 1e-3, betas=(0.9, 0.999), weight_decay=0.0)
        losses.append([float(FD.module_step(student, opt, teacher, batch, cfg=cfg,
                                            module=module, jit=jit)[-1]["loss"])
                       for _ in range(3)])
    for a, b in zip(*losses):
        assert abs(a - b) <= TRAIN_RTOL * abs(b), losses


@pytest.mark.cuda
def test_compiled_training_on_the_card_matches_the_golden_file(cuda_device):
    """golden.run_train through the compiled steps: the JAX package's
    losses at 1e-4 (golden.train_gate) and no launch of the kernel."""
    from beatrice_vst_tpu_torch.models.io import load_model_dir

    _, cfg, params, bank = load_model_dir(MODEL_DIR)
    want = golden.load(os.path.join(os.path.dirname(__file__), "data",
                                    "torch_train_golden.npz"))
    batch = {k: want[f"batch/{k}"] for k in ("audio16", "target24", "f0_bin")}
    before = FU.launches
    got = golden.run_train(cfg, params, bank, cuda_device, batch, jit=True)
    assert FU.launches == before
    for k, v in got.items():
        ok, dev, bound = golden.train_gate(k, v, float(want[k]))
        assert ok, (k, v, float(want[k]), dev, bound)


def _waited_ticks(e, ticks, seed=0, behind_sleep=False):
    """`ticks` ticks of engine e, each waited for on the host: the outputs
    and the host's perf_counter_ns as each wait returned.  behind_sleep
    enqueues each tick behind a device sleep, so that the card never
    waits for the host's launch inside the tick."""
    import time

    x = torch.as_tensor(golden.swept_sine(seed, cap=e.cfg.capacity,
                                          ticks=ticks * e.cfg.frames_per_tick), device=e.device)
    n = e.cfg.samples_per_tick
    outs, waited = [], []
    for k in range(ticks):
        if behind_sleep:
            torch.cuda._sleep(20_000_000)  # about 10 ms
        outs.append(e.tick(x[:, n * k:n * (k + 1)]).cpu())
        waited.append(time.perf_counter_ns())
    return outs, waited


def _all_streams(e):
    for i in range(e.cfg.capacity):
        e.admit()
        e.set_control(i, "target_speaker", i % 8)
    return e


@pytest.mark.cuda
@pytest.mark.parametrize("config", ["slots_f32", "slots_bf16"])
def test_traced_graph_tick_equals_the_untraced_bitwise(cuda_device, config):
    """The graph holds its stage marks either way: 20 ticks with tracing on
    give the untraced engine's output bit for bit, every tick's stages read."""
    untraced, traced = (_all_streams(_engine(config, cuda_device, cap=16)) for _ in range(2))
    traced.tracing(True)
    got, _ = _waited_ticks(traced, 20)
    want, _ = _waited_ticks(untraced, 20)
    dump = traced.tracer.dump()
    assert traced.tracing(False)["drift_ns"] is not None
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    names = [row[1] for row in dump["spans"]]
    assert names.count("engine.device") == 20 and names.count("head") == 20
    assert dump["counters"]["stage_reads_missed"] == 0
    assert untraced.tracer.dump()["spans"] == []


@pytest.mark.cuda
@pytest.mark.parametrize("frames_per_tick", [1, 3])
def test_device_stages_fill_the_engine_span_on_the_shared_clock(cuda_device, frames_per_tick):
    """A tick's stage intervals sum to its engine span (the event pair
    around copy in, replay and clone) within 3 % or 30 us; on the host's
    clock each stage of tick n starts after tick n's engine.launch starts
    and ends before the host's wait for tick n returns.  Each tick waits
    behind a device sleep, so the card never waits inside it for the
    host's launch (that wait is graph_in's: the next test)."""
    e = _all_streams(_engine("slots_bf16", cuda_device, cap=256,
                             frames_per_tick=frames_per_tick))
    _waited_ticks(e, 3)
    e.tracing(True)
    _, waited = _waited_ticks(e, 10, seed=1, behind_sleep=True)
    from beatrice_vst_tpu_torch.runtime.metrics import SPAN_FIELDS, STAGES

    spans = [dict(zip(SPAN_FIELDS, row)) for row in e.tracer.dump()["spans"]]
    e.tracing(False)
    ticks = sorted({s["tick"] for s in spans})
    assert len(ticks) == 10
    for i, tick in enumerate(ticks):
        group = [s for s in spans if s["tick"] == tick]
        device = next(s for s in group if s["name"] == "engine.device")
        launch = next(s for s in group if s["name"] == "engine.launch")
        stages = [s for s in group if s["parent"] == device["id"] and s["name"] in STAGES]
        total = sum(s["end_ns"] - s["start_ns"] for s in stages)
        span = device["end_ns"] - device["start_ns"]
        assert abs(span - total) <= max(0.03 * span, 30_000), (tick, span, total)
        for s in stages:
            assert launch["start_ns"] < s["start_ns"] <= s["end_ns"] < waited[i], (tick, s)


@pytest.mark.cuda
def test_the_cards_wait_for_the_launch_is_named_graph_in(cuda_device):
    """Ticked with nothing in front, the card reaches a tick's start event
    before the host has launched the replay and waits inside the engine
    span, outside every stage.  The span's parts tile it (graph_in, the
    stages in order, graph_out), and graph_in, which holds that wait, is
    no longer than the host's engine.launch (with 50 us for the card to
    start the graph): the stages and graph_in account for the span."""
    from beatrice_vst_tpu_torch.runtime.metrics import GAPS, SPAN_FIELDS, STAGES

    e = _all_streams(_engine("slots_bf16", cuda_device, cap=256))
    _waited_ticks(e, 3)
    e.tracing(True)
    _waited_ticks(e, 10, seed=1)
    spans = [dict(zip(SPAN_FIELDS, row)) for row in e.tracer.dump()["spans"]]
    e.tracing(False)
    ticks = sorted({s["tick"] for s in spans})
    assert len(ticks) == 10
    waits = []
    for tick in ticks:
        group = [s for s in spans if s["tick"] == tick]
        device = next(s for s in group if s["name"] == "engine.device")
        launch = next(s for s in group if s["name"] == "engine.launch")
        parts = sorted((s for s in group if s["parent"] == device["id"]),
                       key=lambda s: (s["start_ns"], s["id"]))
        names = [s["name"] for s in parts]
        assert names[0] == GAPS[0] and names[-1] == GAPS[1], names
        assert set(names[1:-1]) <= set(STAGES)
        assert parts[0]["start_ns"] == device["start_ns"]
        assert parts[-1]["end_ns"] == device["end_ns"]
        for a, b in zip(parts, parts[1:]):
            assert a["end_ns"] == b["start_ns"], (a, b)
        wait = parts[0]["end_ns"] - parts[0]["start_ns"]
        host = launch["end_ns"] - launch["start_ns"]
        assert 0 <= wait <= host + 50_000, (tick, wait, host)
        waits.append(wait)
    print("graph_in us", [w // 1000 for w in waits])


@pytest.mark.cuda
def test_underruns_count_a_tick_over_its_budget_on_the_cards_clock(cuda_device):
    """tick_p50_ms is the engine's span on the card (an event pair), not
    the host's enqueue; a tick held some 50 ms on the card is one underrun."""
    e = _all_streams(_engine("slots_bf16", cuda_device, cap=8))
    _waited_ticks(e, 5)
    snap = e.metrics_snapshot()
    assert snap["tick_clock"] == "cuda_events" and snap["underruns"] == 0
    e.tracing(True)
    _waited_ticks(e, 5)
    device = [(row[3] - row[2]) * 1e-6 for row in e.tracer.dump()["spans"]
              if row[1] == "engine.device"]
    e.tracing(False)
    assert e.metrics_snapshot()["tick_p50_ms"] == pytest.approx(float(np.median(device)),
                                                                rel=0.05)
    graph = e._graph

    def held(x, **kw):
        torch.cuda._sleep(100_000_000)  # 50 ms at 2 GHz
        return graph(x, **kw)

    e._graph = held
    _waited_ticks(e, 1)
    e._graph = graph
    _waited_ticks(e, 1)
    assert e.metrics_snapshot()["underruns"] == 1


@pytest.mark.cuda
def test_a_capture_runs_without_automatic_garbage_collection(cuda_device):
    """A collection during a capture may free an older graph held in a
    reference cycle, whose reset invalidates the capture: the step's
    warm-up calls run with collection on, its capture with it off, and
    the step turns it back on."""
    from beatrice_vst_tpu_torch.runtime import graphs

    seen = []

    def step(x):
        seen.append(gc.isenabled())
        return x * 2

    x = torch.arange(4.0, device=cuda_device)
    assert gc.isenabled()
    compiled = graphs.CompiledStep(step, (x,))
    assert seen == [True] * graphs.GRAPH_WARMUP_CALLS + [False]
    assert gc.isenabled()
    assert torch.equal(compiled(), x * 2)


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
    assert device_mod._capture.launches is None and gc.isenabled()
    assert (FU.launches, FU.launches_bf16) == (before[0] + engine_mod.GRAPH_WARMUP_TICKS,
                                               before[1])
    monkeypatch.undo()
    e = _engine("slots_f32", cuda_device)  # the card still captures and ticks
    e.admit()
    out = e.tick(torch.zeros((e.cfg.capacity, 480), device=cuda_device))
    assert bool(torch.isfinite(out).all())


# ---- the edges' polyphase resampler kernel (csrc/polyphase_resample.cu) ----

# f32 sums of at most K = 97 products (|w| summing to under 1.5) of inputs
# in [-1, 1], in the kernel's order and in the dense GEMM's: the worst-case
# rounding bound is about K x 2^-24 x 1.5 = 9e-6 a side; a sum in bf16
# would be off by about 2^-9 of |y| (1e-3 at |y| = 0.5), 50x this
RESAMPLE_TOL = 2e-5
# (L, M): the engine's 48 -> 16 and 24 -> 48 kHz, 48 <-> 44.1 kHz
RESAMPLE_RATES = [(1, 3), (2, 1), (160, 147), (147, 160)]


def _resample_blocks(L, M):
    """in_block for T = 1, 25 and 256 frames of 10 ms at the input rate
    (48 kHz, 24 kHz for the output edge, 44.1 kHz for 160/147), and an
    offline tail: a block shorter than the history."""
    rate = {(1, 3): 480, (2, 1): 240, (160, 147): 441, (147, 160): 480}[(L, M)]
    tail = {(1, 3): 30, (2, 1): 7, (160, 147): 147, (147, 160): 160}[(L, M)]
    return {"t1": rate, "t25": 25 * rate, "t256": 256 * rate, "tail": tail}


def _uniform(shape, seed, device):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.uniform(-1, 1, shape).astype(np.float32)).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 256, 4096])
@pytest.mark.parametrize("block", ["t1", "t25", "t256", "tail"])
@pytest.mark.parametrize("L, M", RESAMPLE_RATES)
def test_polyphase_kernel_matches_the_dense_product(cuda_device, L, M, block, b):
    """One launch, counted with its output samples, against the dense
    banded product (`dense_block`) on the same card; the new history
    bitwise."""
    from beatrice_vst_tpu_torch.ops import resample as R

    rs = R.Resampler(L=L, M=M, in_block=_resample_blocks(L, M)[block], cutoff=0.99)
    x = _uniform((b, rs.in_block), b + rs.in_block, cuda_device)
    h = _uniform((b, rs.history_len), b, cuda_device)
    launches, samples = R.launches, R.samples
    y, new_h = rs.apply_block(x, h)
    torch.cuda.synchronize()
    assert (R.launches, R.samples) == (launches + 1, samples + b * rs.out_block)
    want_y, want_h = rs.dense_block(x, h)
    assert y.shape == want_y.shape and new_h.shape == want_h.shape
    torch.testing.assert_close(y, want_y, rtol=0, atol=RESAMPLE_TOL)
    assert torch.equal(new_h, want_h)
    assert torch.equal(rs.apply_block(x, h)[0], y)  # the same sums each launch


@pytest.mark.cuda
@pytest.mark.parametrize("L, M", RESAMPLE_RATES)
def test_polyphase_stream_carried_block_by_block_equals_offline(cuda_device, L, M):
    """A stream carried block by block through the kernel equals
    `apply_offline` over the whole signal (one launch) and in blocks (a
    launch a block) bitwise, and the dense product's offline conversion
    within the tolerance."""
    from beatrice_vst_tpu_torch.ops import resample as R

    rs = R.Resampler(L=L, M=M, in_block=_resample_blocks(L, M)["t1"], cutoff=0.99)
    blocks = 40
    x = _uniform((3, blocks * rs.in_block), 7, cuda_device)
    state, parts = rs.init_state((3,), cuda_device), []
    for i in range(blocks):
        y, state = rs.apply_block(x[:, i * rs.in_block:(i + 1) * rs.in_block], state)
        parts.append(y)
    lead = rs.delay_in_samples * L // M
    n_out = x.shape[-1] * L // M
    streamed = torch.cat(parts, dim=-1)[:, lead:lead + n_out]
    launches = R.launches
    whole = rs.apply_offline(x)
    torch.cuda.synchronize()
    assert R.launches == launches + 1
    assert whole.shape == (3, n_out - lead) == streamed.shape
    assert torch.equal(whole, streamed)
    assert torch.equal(rs.offline_blocks(x), whole)
    torch.cuda.synchronize()
    assert R.launches == launches + 1 + blocks
    torch.testing.assert_close(whole.cpu(), rs.apply_offline(x.cpu()), rtol=0,
                               atol=RESAMPLE_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("frames_per_tick", [1, 25])
def test_resample_counters_count_graph_replays(cuda_device, frames_per_tick):
    """The tick graph records the two edges' launches and counts none; its
    warm-up ticks launch them, every replay counts them once, and the
    engine's metrics show the counts; the graph's output equals the eager
    tick's bitwise."""
    import beatrice_vst_tpu_torch.runtime.engine as engine_mod
    from beatrice_vst_tpu_torch.ops import resample as R

    cap, t = 8, frames_per_tick
    per_tick = cap * (160 * t + 480 * t)
    before = (R.launches, R.samples)
    e = _engine("slots_f32", cuda_device, cap=cap, frames_per_tick=t)
    eager = _engine("slots_f32", cuda_device, cap=cap, frames_per_tick=t, jit=False)
    torch.cuda.synchronize()
    assert {k: n for k, n in e._graph.step.recorded.items() if k[0] == "polyphase_resample"} \
        == {("polyphase_resample", "launches"): 2, ("polyphase_resample", "samples"): per_tick}
    warm = engine_mod.GRAPH_WARMUP_TICKS
    assert (R.launches, R.samples) == (before[0] + 2 * warm, before[1] + warm * per_tick)
    for engine in (e, eager):
        for i in range(cap):
            engine.admit()
            engine.set_control(i, "target_speaker", i)
    x = _uniform((5, cap, 480 * t), 11, cuda_device) * 0.1
    before = (R.launches, R.samples)
    for k in range(5):
        assert torch.equal(e.tick(x[k]), eager.tick(x[k]))
    torch.cuda.synchronize()
    assert (R.launches, R.samples) == (before[0] + 20, before[1] + 10 * per_tick)
    snap = e.metrics_snapshot()
    assert (snap["resample_kernel_launches"], snap["resample_kernel_samples"]) == (
        R.launches, R.samples)
