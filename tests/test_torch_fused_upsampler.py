"""The upsampler head's plain PyTorch version against the TPU kernel
(`fused_upsample(..., interpret=True)`, as tests/test_pallas.py runs it on
the CPU), and the wrapper's CPU route, checks, choice of kernel source and
build key, without building anything.  The CUDA kernels themselves are
held against the plain version in tests/test_torch_cuda.py.

Tolerances against the Pallas kernel: f32 audio rtol 1e-4 / atol 1e-5
and carries rtol 1e-5 / atol 1e-6, as tests/test_pallas.py holds it
against XLA.  bf16 (`compute_dtype=bfloat16`, bf16 frame features and
carries): f32 sums in another order can put a stage output on the other
side of a bf16 rounding, so each carry is held within 1 bf16 ulp of its
largest value and the audio at atol 1e-4 (measured: 1.5e-5, carries
within 1.9e-6)."""

import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from beatrice_vst_tpu.constants import V20RC0
from beatrice_vst_tpu.models import waveform_generator as JW
from beatrice_vst_tpu.models.chain import VoiceConverterConfig
from beatrice_vst_tpu.models.pallas_upsampler import fused_upsample as pallas_fused_upsample
from beatrice_vst_tpu_torch import cuda_build
from beatrice_vst_tpu_torch import device as device_mod
from beatrice_vst_tpu_torch.models import fused_upsampler as FU
from beatrice_vst_tpu_torch.models.io import params_from_numpy

torch.set_num_threads(1)

CFG = VoiceConverterConfig.for_version(V20RC0).wg


def _inputs(b, seed):
    """Random stage weights (with nonzero biases and snake alphas), carries,
    frame features and source features, as numpy."""
    params = jax.tree_util.tree_map(np.asarray, JW.init(jax.random.PRNGKey(seed), CFG))
    rng = np.random.default_rng(seed)
    for p in params["up"]:
        p["conv"]["b"] = (rng.standard_normal(p["conv"]["b"].shape) * 0.1).astype(np.float32)
        p["src"]["b"] = (rng.standard_normal(p["src"]["b"].shape) * 0.1).astype(np.float32)
        p["snake"]["log_alpha"] = (rng.standard_normal(p["snake"]["log_alpha"].shape)
                                   * 0.3).astype(np.float32)
    params["final"]["b"] = np.full((1,), 0.05, np.float32)
    h = (rng.standard_normal((b, 1, CFG.hidden)) * 0.5).astype(np.float32)
    states = [(rng.standard_normal(s) * 0.1).astype(np.float32)
              for s in FU.expected_shapes(b)[1]]
    src = [(rng.standard_normal(s) * 0.3).astype(np.float32)
           for s in FU.expected_shapes(b)[2]]
    return params, h, states, src


def _torch_args(params, h, states, src, device="cpu", dtype=torch.float32):
    """Torch arguments; with bf16, h and the carries in bf16 and the matmul
    weights too (`head_params`), as the bf16 engine passes them."""
    tp = params_from_numpy({"up": params["up"], "final": params["final"]}, device)
    up, final = FU.head_params(tp["up"], tp["final"], dtype)
    return (up, final, torch.from_numpy(h).to(device, dtype),
            [torch.from_numpy(s).to(device, dtype) for s in states],
            [torch.from_numpy(s).to(device) for s in src])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_plain_matches_pallas_kernel_interpret(dtype):
    b = 16
    params, h, states, src = _inputs(b, seed=0)
    jdt, pdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bf16" else (jnp.float32,
                                                                      torch.float32)
    # bf16 inputs are made by rounding the f32 ones, the same in both
    audio_j, states_j = pallas_fused_upsample(
        params["up"], params["final"], jnp.asarray(h).astype(jdt),
        [jnp.asarray(s).astype(jdt) for s in states], [jnp.asarray(s) for s in src],
        rates=FU.RATES, channels=FU.CHANNELS, compute_dtype=jdt, interpret=True)
    audio_p, states_p = FU.fused_upsample_reference(
        *_torch_args(params, h, states, src, dtype=pdt))
    assert audio_p.dtype == torch.float32
    assert len(states_p) == len(states_j) == 5
    if dtype == "f32":
        np.testing.assert_allclose(audio_p.numpy(), np.asarray(audio_j), rtol=1e-4, atol=1e-5)
        for got, want in zip(states_p, states_j):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
        return
    print(f"\nbf16 plain vs Pallas: audio max |d| "
          f"{np.abs(audio_p.numpy() - np.asarray(audio_j)).max():.3g}, carries "
          + ", ".join(f"{np.abs(g.float().numpy() - np.asarray(w, np.float32)).max():.3g}"
                      for g, w in zip(states_p, states_j)))
    np.testing.assert_allclose(audio_p.numpy(), np.asarray(audio_j), rtol=0, atol=1e-4)
    for got, want in zip(states_p, states_j):
        assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
        want = np.asarray(want.astype(jnp.float32))
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                                   atol=2.0**-7 * np.abs(want).max())


def test_wrapper_on_cpu_runs_plain_version_without_counting():
    params, h, states, src = _inputs(3, seed=1)
    args = _torch_args(params, h, states, src)
    before = FU.launches
    audio, new_states = FU.fused_upsample(*args)
    want_audio, want_states = FU.fused_upsample_reference(*args)
    assert FU.launches == before
    torch.testing.assert_close(audio, want_audio, rtol=0, atol=0)
    for got, want in zip(new_states, want_states):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert audio.shape == (3, 240) and bool(torch.isfinite(audio).all())
    assert bool((audio.abs() <= 1).all())


@pytest.mark.parametrize("bad", ["h_shape", "state_shape", "src_shape", "dtype", "weight",
                                 "mixed_carry", "mixed_weight", "bf16_bias"])
def test_wrapper_rejects_what_the_kernel_cannot_take(bad):
    params, h, states, src = _inputs(2, seed=2)
    up, final, th, ts, tsrc = _torch_args(params, h, states, src)
    if bad == "mixed_carry":  # bf16 h with an f32 carry
        up, final, th, ts, tsrc = _torch_args(params, h, states, src, dtype=torch.bfloat16)
        ts[3] = ts[3].float()
    elif bad == "mixed_weight":  # bf16 h with an f32 conv weight
        up, final, th, ts, tsrc = _torch_args(params, h, states, src, dtype=torch.bfloat16)
        up[2]["conv"]["w"] = up[2]["conv"]["w"].float()
    elif bad == "bf16_bias":  # biases stay f32 in both forms
        up, final, th, ts, tsrc = _torch_args(params, h, states, src, dtype=torch.bfloat16)
        final["b"] = final["b"].bfloat16()
    if bad == "h_shape":
        th = th[:, :, :128]
    elif bad == "state_shape":
        ts[2] = ts[2][:, :1]
    elif bad == "src_shape":
        tsrc[3] = tsrc[3][:, :, :8]
    elif bad == "dtype":
        th = th.double()
    else:
        up[1]["conv"]["w"] = up[1]["conv"]["w"][:, :, :64]
    with pytest.raises(ValueError):
        FU.fused_upsample(up, final, th, ts, tsrc)


def test_flop_count_matches_the_plan():
    # 4 stage convs + source projections + final conv, per stream
    assert FU.flops_per_stream() == 2 * 1_830_144


def test_bound_matches_the_hand_count():
    # per stream: h 256, carries 2 x (256+128+64+32+16) in and out, source
    # features (4+20+80+240) x 9, audio 240 floats
    per_stream = 4 * (256 + 2 * 2 * 496 + 344 * 9 + 240)
    assert per_stream == 22_304
    weights = 4 * (3 * 256 * 512 + 3 * 128 * 320 + 3 * 64 * 128 + 3 * 32 * 48  # convs
                   + (512 + 320 + 128 + 48)  # conv biases
                   + 9 * 240 + 240 + 240  # source weights and biases, snake alphas
                   + 3 * 16 + 1)  # final conv
    assert weights == 2_195_908
    for b in (1, 16, 256, 1024):
        assert FU.bytes_per_call(b) == per_stream * b + weights
    assert FU.flops_per_stream() == 3_660_288  # 3.66 MFLOP
    # 0.937 GFLOP over 67 TFLOP/s at B=256: 14.0 us, above 7.9 MB over 3.35 TB/s (2.4 us)
    assert FU.bound_ms(256) == pytest.approx(0.013986, rel=1e-4)
    assert FU.bound_by(256) == "operations"
    assert FU.bytes_per_call(256) / FU.PEAK_BYTES_PER_S * 1e3 == pytest.approx(0.00236, rel=1e-2)
    assert FU.bound_by(1) == "bytes"  # one stream still reads all 2.2 MB of weights


def test_bf16_bound_matches_the_hand_count():
    """bf16 form: h, carries in and out and the three matmul weights in
    bf16; source features, audio, biases and alphas f32; operations over
    989 TFLOP/s."""
    per_stream = 2 * (256 + 2 * 2 * 496) + 4 * (344 * 9 + 240)
    assert per_stream == 17_824
    weights = (2 * (3 * 256 * 512 + 3 * 128 * 320 + 3 * 64 * 128 + 3 * 32 * 48 + 9 * 240
                    + 3 * 16)
               + 4 * (512 + 320 + 128 + 48 + 240 + 240 + 1))
    assert weights == 1_100_932
    for b in (1, 16, 256, 1024):
        assert FU.bytes_per_call(b, torch.bfloat16) == per_stream * b + weights
    # 0.937 GFLOP over 989 TFLOP/s at B=256: 0.947 us, below 5.66 MB over 3.35 TB/s (1.69 us)
    assert FU.bound_ms(256, torch.bfloat16) == pytest.approx(
        (per_stream * 256 + weights) / 3.35e12 * 1e3, rel=1e-9)
    assert FU.bound_by(256, torch.bfloat16) == "bytes"
    assert FU.bound_by(16 * 1024, torch.bfloat16) == "bytes"


@pytest.mark.parametrize("name", ["fused_upsampler", "fused_upsampler_bf16",
                                  "fused_upsampler_v1"])
def test_build_path_follows_source_headers_and_flags(tmp_path, monkeypatch, name):
    # each kernel source, the tensor-core bf16 form's too, keyed by its own
    # text, every header in csrc/ and the flags
    text = (cuda_build.CSRC / f"{name}.cu").read_text()
    monkeypatch.setattr(cuda_build, "CSRC", tmp_path)
    (tmp_path / f"{name}.cu").write_text(text)
    (tmp_path / "k.cuh").write_text("// v1\n")
    first = cuda_build.library_path(name)
    assert first.name.startswith(f"lib{name}-")
    assert cuda_build.library_path(name) == first
    (tmp_path / "k.cuh").write_text("// v2\n")
    second = cuda_build.library_path(name)
    assert second != first
    (tmp_path / "other.cuh").write_text("// new header\n")
    third = cuda_build.library_path(name)
    assert third not in (first, second)
    (tmp_path / f"{name}.cu").write_text(text + "// edited\n")
    fourth = cuda_build.library_path(name)
    assert fourth not in (first, second, third)
    monkeypatch.setattr(cuda_build, "NVCC_FLAGS", (*cuda_build.NVCC_FLAGS, "-DX"))
    assert cuda_build.library_path(name) != fourth


def test_build_keeps_the_compiler_log_beside_the_library(tmp_path, monkeypatch):
    # a stand-in nvcc that records its runs, writes the library and prints
    # a ptxas line; a library built earlier returns its log without a rebuild
    (tmp_path / "csrc").mkdir()
    (tmp_path / "csrc" / "k.cu").write_text("// k\n")
    monkeypatch.setattr(cuda_build, "CSRC", tmp_path / "csrc")
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    runs = tmp_path / "runs"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(f'#!/bin/sh\necho run >> "{runs}"\n'
                    'while [ "$1" != "-o" ]; do shift; done\necho lib > "$2"\n'
                    'echo "ptxas info    : Used 42 registers"\n')
    nvcc.chmod(0o755)
    monkeypatch.setattr(cuda_build, "nvcc_path", lambda: str(nvcc))
    first = cuda_build.build(["k"])
    assert "Used 42 registers" in first["k"]
    assert cuda_build.library_path("k").exists()
    assert cuda_build.build(["k"]) == first
    assert runs.read_text().count("run") == 1


class _FakeLibrary:
    """Stands in for a built kernel library: records the entry points
    looked up in it."""

    def __init__(self, name, looked_up):
        self.name, self.looked_up = name, looked_up

    def __getattr__(self, entry):
        self.looked_up.append((self.name, entry))
        return types.SimpleNamespace()


@pytest.fixture
def fake_build(monkeypatch):
    """`cuda_build.load_library` replaced by one that builds nothing; the
    entry points looked up, in order."""
    looked_up = []
    monkeypatch.setattr(cuda_build, "load_library", lambda name: _FakeLibrary(name, looked_up))
    FU._launcher.cache_clear()
    yield looked_up
    FU._launcher.cache_clear()


@pytest.mark.parametrize("dtype, source, entry", [
    (torch.float32, "fused_upsampler", "fused_upsampler_launch"),
    (torch.bfloat16, "fused_upsampler_bf16", "fused_upsampler_bf16_launch"),
])
def test_each_form_launches_its_own_source(fake_build, dtype, source, entry):
    # the route of h's dtype: f32 to csrc/fused_upsampler.cu, bf16 to the
    # tensor-core source csrc/fused_upsampler_bf16.cu
    assert FU.FORMS[dtype] == source
    FU._launcher(FU.FORMS[dtype], dtype)
    assert fake_build == [(source, entry)]
    assert (cuda_build.CSRC / f"{source}.cu").exists()


@pytest.mark.parametrize("source, dtype, entry", [
    ("fused_upsampler", torch.bfloat16, "fused_upsampler_bf16_launch"),  # the FFMA bf16 form
    ("fused_upsampler_v1", torch.float32, "fused_upsampler_launch"),
    ("fused_upsampler_v1", torch.bfloat16, None),
    ("fused_upsampler_bf16", torch.float32, None),
])
def test_yardsticks_are_reachable_only_as_timing_sources(fake_build, source, dtype, entry):
    # a yardstick is never the route of a dtype, and only its own dtype's
    # yardstick may be launched through `_fused_upsample(..., source=...)`
    assert FU.FORMS[dtype] != source
    if entry is None:
        with pytest.raises(ValueError, match="yardstick"):
            FU._launcher(source, dtype)
        assert fake_build == []
        return
    assert FU.YARDSTICKS[dtype] == source
    FU._launcher(source, dtype)
    assert fake_build == [(source, entry)]


@pytest.mark.parametrize("bad", ["misaligned", "non_contiguous", "mixed_carry", "mixed_src_w"])
def test_bf16_route_refuses_what_the_kernel_cannot_take(bad):
    # what the wrapper checks before a bf16 launch, on CPU tensors: the
    # arguments (`_check`) and the kernel's layout (`_check_layout`)
    params, h, states, src = _inputs(4, seed=4)
    up, final, th, ts, tsrc = _torch_args(params, h, states, src, dtype=torch.bfloat16)
    got = FU._check(up, final, th, ts, tsrc)
    assert len(got) == 32
    FU._check_layout(got)  # well formed: accepted
    if bad == "misaligned":
        th = torch.empty(th.numel() + 1, dtype=th.dtype)[1:].view(th.shape).copy_(th)
    elif bad == "non_contiguous":
        ts[1] = ts[1].transpose(1, 2).contiguous().transpose(1, 2)
    elif bad == "mixed_carry":
        ts[4] = ts[4].float()
    else:
        up[0]["src"]["w"] = up[0]["src"]["w"].float()
    match = {"misaligned": "aligned", "non_contiguous": "contiguous"}.get(bad, "mixed")
    with pytest.raises(ValueError, match=match):
        FU._check_layout(FU._check(up, final, th, ts, tsrc))


def test_launch_arguments_are_packed_in_launch_order():
    params, h, states, src = _inputs(2, seed=3)
    up, final, th, ts, tsrc = _torch_args(params, h, states, src)
    got = FU._check(up, final, th, ts, tsrc)
    audio = torch.empty(2, 240)
    new_states = [torch.empty_like(s) for s in ts]
    args = FU._pack(got, audio, new_states)
    assert args.h == th.data_ptr()
    assert list(args.state) == [s.data_ptr() for s in ts]
    assert list(args.src) == [s.data_ptr() for s in tsrc]
    for i, p in enumerate(up):
        assert (args.conv_w[i], args.conv_b[i], args.src_w[i], args.src_b[i],
                args.log_alpha[i]) == (p["conv"]["w"].data_ptr(), p["conv"]["b"].data_ptr(),
                                       p["src"]["w"].data_ptr(), p["src"]["b"].data_ptr(),
                                       p["snake"]["log_alpha"].data_ptr())
    assert (args.final_w, args.final_b) == (final["w"].data_ptr(), final["b"].data_ptr())
    assert args.audio == audio.data_ptr()
    assert list(args.new_state) == [s.data_ptr() for s in new_states]
    # each call packs its own block
    assert FU._pack(got, audio, new_states) is not args


# ---- a chunk of T frames ----

def _chunk_inputs(b, t, seed, dtype):
    """Head arguments for a chunk of t frames in `dtype` (`_torch_args`'s
    weights and carries, frame features [b, t, 256]) and the vocoder's own
    source for them: `source_features` (the head's) and `stage_sources`
    (the stage loop's) of random pitch bins, voicing, phases and noise
    counters.  Returns (head args, f32 stage weights, sources, voicing)."""
    from beatrice_vst_tpu_torch.models import waveform_generator as W

    params, _, states, _ = _inputs(b, seed)
    rng = np.random.default_rng(seed)
    h = (rng.standard_normal((b, t, CFG.hidden)) * 0.5).astype(np.float32)
    qp = torch.from_numpy(rng.integers(50, 350, (b, t)))
    voicing = torch.from_numpy(rng.standard_normal((b, t)).astype(np.float32))
    state = {"phase": torch.from_numpy(rng.uniform(0.0, 6.0, b).astype(np.float32)),
             "noise_counter": torch.from_numpy(rng.integers(0, 1 << 20, b))}
    wcfg = W.WaveformGeneratorConfig(pitch_bins=CFG.pitch_bins)
    feats = W.source_features(wcfg, qp, voicing, state)[0]
    sources = W.stage_sources(wcfg, qp, state)[0]
    tp = params_from_numpy({"up": params["up"], "final": params["final"]}, "cpu")
    up, final = FU.head_params(tp["up"], tp["final"], dtype)
    carries = [torch.from_numpy(s).to(dtype) for s in states]
    return (up, final, torch.from_numpy(h).to(dtype), carries, feats), tp, sources, voicing


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_reference_over_frames_matches_the_stage_loop(dtype):
    """The plain head over a chunk of 5 frames (frame by frame, carries
    chained, the harmonic source features) against `upsample_stages` (the
    whole chunk per stage, the monomial basis with folded weights), the
    head the CPU and the f32 card run at T > 1: f32 at 1e-5 (measured 1e-6);
    bf16 within the roundings the two place apart (the stage loop rounds
    the sum before the snake and powers the source in bf16; a carry not
    handed on is off by its own size): each carry within 2^-3 of its
    largest value at most and 2^-4 in RMS, the audio at 0.15 and 0.025 RMS
    (the largest over 12 seeds: 10.6 % and 2.8 %, 0.091 and 0.012)."""
    from beatrice_vst_tpu_torch.models import waveform_generator as W

    pdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    b, t = 3, 5
    args, tp, sources, voicing = _chunk_inputs(b, t, 5, pdt)
    audio, states = FU.fused_upsample_reference(*args)
    assert audio.shape == (b, t * 240) and [s.dtype for s in states] == [pdt] * 5
    wcfg = W.WaveformGeneratorConfig(pitch_bins=CFG.pitch_bins)
    want_audio, want_up, want_final = W.upsample_stages(
        wcfg, tp["up"], tp["final"], args[2], args[3][:4], args[3][4], sources, voicing,
        None if dtype == "f32" else pdt)
    for got, want in zip(states, [*want_up, want_final]):
        got, want = got.float(), want.float()
        if dtype == "f32":
            torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
        else:
            scale = float(want.abs().max())
            assert float((got - want).abs().max()) <= 2.0**-3 * scale
            assert float((got - want).pow(2).mean().sqrt()) <= 2.0**-4 * scale
    if dtype == "f32":
        torch.testing.assert_close(audio, want_audio, rtol=0, atol=1e-5)
    else:
        assert float((audio - want_audio).abs().max()) <= 0.15
        assert float((audio - want_audio).pow(2).mean().sqrt()) <= 0.025
    assert float(audio.abs().max()) > 0.1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_chunk_is_its_frames_chained(dtype):
    """A chunk through the wrapper's CPU route (the plain version, nothing
    counted) equals its frames run one call each with the carries handed
    on, bitwise: the chunk the kernel is held to on the card."""
    b, t = 2, 4
    (up, final, h, carries, feats), *_ = _chunk_inputs(b, t, 6, dtype)
    before = (FU.launches, FU.launches_bf16, FU.frames, FU.frames_bf16)
    audio, states = FU.fused_upsample(up, final, h, carries, feats)
    assert (FU.launches, FU.launches_bf16, FU.frames, FU.frames_bf16) == before
    parts, chained = [], carries
    for f in range(t):
        a, chained = FU.fused_upsample(up, final, h[:, f:f + 1].contiguous(), chained,
                                       [s.reshape(b, t, -1, FU.N_SRC)[:, f] for s in feats])
        parts.append(a)
    assert torch.equal(audio, torch.cat(parts, dim=1))
    for got, want in zip(states, chained):
        assert torch.equal(got, want)


def test_chunk_shapes_and_bound_extend_one_frame():
    """`frames=` extends the shapes and the bound; at the one-frame
    signatures they are as before (the benchmark's frozen copy holds them)."""
    h, states, src, *_ = FU.expected_shapes(4, 25)
    assert h == (4, 25, 256) and src == [(4, 100, 9), (4, 500, 9), (4, 2000, 9), (4, 6000, 9)]
    assert states == FU.expected_shapes(4)[1]
    assert FU.flops_per_stream(25) == 25 * FU.flops_per_stream()
    per_stream = FU.bytes_per_call(2, torch.bfloat16) - FU.bytes_per_call(1, torch.bfloat16)
    carries = 2 * 2 * 2 * 496  # bf16 carries in and out, read and written once a chunk
    assert (FU.bytes_per_call(1, torch.bfloat16, 25) - FU.bytes_per_call(1, torch.bfloat16)
            == 24 * (per_stream - carries))
    # 4,096 streams, 25 frames: 1.44 GB over 3.35 TB/s, above 0.375 TFLOP over 989
    assert FU.bound_by(4096, torch.bfloat16, 25) == "bytes"
    assert FU.bound_ms(4096, torch.bfloat16, 25) == pytest.approx(0.4287, rel=1e-3)
    with pytest.raises(ValueError, match="T >= 1"):
        params, h1, states1, src1 = _inputs(2, seed=2)
        up, final, th, ts, tsrc = _torch_args(params, h1, states1, src1)
        FU.fused_upsample(up, final, th[:, :0], ts, [s[:, :0] for s in tsrc])


@pytest.mark.parametrize("b, t, clusters, block", [
    (4096, 25, 30, 25),  # 256 tiles fill the card: one block of every frame
    (480, 25, 30, 25),   # 30 tiles: full
    (256, 25, 30, 25),   # 16 tiles: two blocks would take two waves
    (240, 25, 30, 13),   # 15 tiles: two blocks of 13 and 12 frames
    (16, 25, 30, 1),     # one tile: a cluster a frame, each after a warm-up frame
    (1, 256, 30, 9),     # offline conversion: 29 blocks of 9 frames
    (1, 2, 30, 1),
    (1, 5, 0, 5),        # no occupancy: one block
])
def test_frame_block_fills_the_card(b, t, clusters, block):
    assert FU.frame_block(b, t, clusters) == block
    tiles, blocks = -(-b // FU.TILE), -(-t // block)
    assert tiles * blocks <= max(tiles, clusters)


class _Cfg:
    upsampler_kernel = True


@pytest.mark.parametrize("frames, device, dtype, kernel, grad, split, route", [
    (1, "cuda", torch.bfloat16, True, False, False, "fused"),      # T = 1: as before
    (1, "cpu", torch.float32, True, False, False, "fused"),        # (the wrapper's CPU route)
    (1, "cuda", torch.float32, False, False, False, "reference"),
    (25, "cuda", torch.bfloat16, True, False, False, "fused"),     # the chunk path on the card
    (2, "cuda", torch.bfloat16, True, False, False, "fused"),
    (25, "cuda", torch.float32, True, False, False, "stages"),     # f32 keeps the stage loop
    (25, "cpu", torch.bfloat16, True, False, False, "stages"),     # the CPU is the JAX package's
    (25, "cuda", torch.bfloat16, True, True, False, "stages"),     # training: no backward
    (25, "cuda", torch.bfloat16, True, False, True, "stages"),     # split head weights
    (25, "cuda", torch.bfloat16, False, False, False, "stages"),   # upsampler_kernel=False
])
def test_head_route(frames, device, dtype, kernel, grad, split, route):
    from beatrice_vst_tpu_torch.models import waveform_generator as W

    cfg = _Cfg()
    cfg.upsampler_kernel = kernel
    assert W.head_route(cfg, frames, device, dtype, grad, split) == route


def test_apply_reads_the_route_from_the_call(monkeypatch):
    """`apply` on the CPU: at T > 1 the stage loop; it hands head_route
    what it observes: T, device, dtype, whether an input needs a gradient."""
    from beatrice_vst_tpu_torch.models import waveform_generator as W

    seen = []
    route = W.head_route
    monkeypatch.setattr(W, "head_route", lambda *a: seen.append(a[1:]) or route(*a))
    wcfg = W.WaveformGeneratorConfig(pitch_bins=CFG.pitch_bins)
    params = W.init(torch.Generator().manual_seed(0), wcfg, "cpu")
    b, t = 2, 3
    state = W.init_state(wcfg, (b,), "cpu")
    gen = torch.Generator().manual_seed(1)
    inputs = (torch.randn(b, t, wcfg.phone_channels, generator=gen),
              torch.randint(0, wcfg.pitch_bins, (b, t), generator=gen),
              torch.randn(b, t, 4, generator=gen), torch.randn(b, wcfg.hidden, generator=gen))
    with torch.no_grad():
        W.apply(params, wcfg, *inputs, state)
    params["up"][0]["conv"]["w"].requires_grad_(True)
    W.apply(params, wcfg, *inputs, state)
    assert seen == [(t, "cpu", torch.float32, False, False), (t, "cpu", torch.float32, True, False)]


def test_frame_counter_counts_launches_frames_and_replays(monkeypatch):
    """B*T frames a launch of a form, added once per replay of a graph that
    recorded it; a yardstick's launches count apart and add no frames."""
    for name in ("launches", "launches_bf16", "frames", "frames_bf16"):
        monkeypatch.setattr(FU, name, 0)
    monkeypatch.setattr(FU, "yardstick_launches", __import__("collections").Counter())
    bf16, f32 = FU.FORMS[torch.bfloat16], FU.FORMS[torch.float32]
    device_mod.count_launch(None, "fused_upsampler", {(bf16, torch.bfloat16): 1,
                                                      (bf16, torch.bfloat16, "frames"): 4096 * 25})
    device_mod.count_launch(None, "fused_upsampler", {(f32, torch.float32): 1,
                                                      (f32, torch.float32, "frames"): 3072})
    recorded = {("fused_upsampler", (bf16, torch.bfloat16)): 1,
                ("fused_upsampler", (bf16, torch.bfloat16, "frames")): 8 * 25,
                ("fused_upsampler", (FU.YARDSTICKS[torch.bfloat16], torch.bfloat16)): 1}
    device_mod.count_replay(recorded)
    device_mod.count_replay(recorded)
    assert FU.counts() == {
        "upsampler_kernel_launches": {"float32": 1, "bfloat16": 3},
        "upsampler_kernel_frames": {"float32": 3072, "bfloat16": 4096 * 25 + 2 * 8 * 25}}
    assert dict(FU.yardstick_launches) == {(FU.YARDSTICKS[torch.bfloat16], "torch.bfloat16"): 2}


def test_chunk_source_features_are_the_one_frame_builders():
    """`source_features` at T > 1 builds its planes a feature at a time and
    interleaves them once; the values are those of the one-frame builder
    (`_harmonic_features` stacked, the noise beside it), bit for bit."""
    from beatrice_vst_tpu_torch.models import waveform_generator as W

    wcfg = W.WaveformGeneratorConfig(pitch_bins=CFG.pitch_bins)
    gen = torch.Generator().manual_seed(3)
    b, t = 3, 4
    qp = torch.randint(0, wcfg.pitch_bins, (b, t), generator=gen)
    voicing = torch.randn(b, t, generator=gen)
    state = {"phase": torch.rand(b, generator=gen) * 6,
             "noise_counter": torch.randint(0, 1 << 30, (b,), generator=gen)}
    feats = W.source_features(wcfg, qp, voicing, state)[0]
    for got, (phases, noise) in zip(feats, W.stage_sources(wcfg, qp, state)[0]):
        n = phases.shape[-1] * t
        harm = W._harmonic_features(phases, voicing, wcfg.n_harmonics)
        want = torch.cat([harm.reshape(b, n, wcfg.n_harmonics), 0.1 * noise.reshape(b, n, 1)],
                         dim=-1)
        assert got.is_contiguous() and torch.equal(got, want)
