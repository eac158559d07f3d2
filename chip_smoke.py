#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--profile DIR]

Phases, each printing one line with its seconds:
  1. env     -- Python, torch and CUDA versions; the card's name and power
                limit from nvidia-smi.
  2. build   -- builds every CUDA kernel of the port from csrc/ with nvcc
                (the f32 form csrc/fused_upsampler.cu, the bf16 form
                csrc/fused_upsampler_bf16.cu on the tensor cores) and the
                yardsticks they are timed against (csrc/fused_upsampler_v1.cu,
                the f32 form's first version; the FFMA bf16 form in
                csrc/fused_upsampler.cu), one nvcc each, all at once; each
                source's ptxas registers and spills, and the HMMA
                (tensor-core) instructions in its SASS.
  3. kernel  -- each form of each kernel (the upsampler head in f32 and in
                bf16) against its plain PyTorch version on the card at
                B = 16, 240, 256 (the engine's capacity) and 1024, on inputs
                made with numpy from a fixed seed: max |d|; the kernel's
                device time with L2 warm and with L2 cold (128 MiB written
                before each launch, not timed), from CUDA event pairs around
                launches enqueued behind a device sleep so that the host
                never sets the pace; the wrapper's host time per call; the
                plain version's device time; the bound; occupancy.  Each
                form's yardstick is checked too and timed against it, warm
                and cold, in the order yardstick, form, form, yardstick: the
                f32 form's first version at B = 256, the FFMA bf16 form at
                every B.
  4. engine  -- one line per configuration (ENGINE_CONFIGS: per-stream f32;
                the JAX default, slot bank and shared-bank VQ in f32; and
                bf16 with the int8 slot bank and codebook): the port's
                StreamEngine at capacity 256 on the card with the klatt8
                weights (models_demo/klatt8), TICKS ticks of a swept sine
                plus noise, with the launch counts set to 0 just before
                and read just after; every output finite and not silent,
                the configuration's kernel form launched once per tick and
                the other form never; the first 20 ticks again through an
                engine forced onto the plain upsampler, compared; median
                and p90 tick, host ms per tick, peak memory.  Then the
                golden run (4 streams x 20 ticks, beatrice_vst_tpu_torch/
                golden.py) held to the JAX engine's output in
                tests/data/torch_engine_golden.npz: f32 at atol 1e-3, bf16
                by the envelope.
  5. morph   -- one line per configuration: the engine at capacity 256 with
                every odd stream morphing (target 8, its own weights over
                klatt8's 8 speakers from a numpy seed, pruned on the card
                by ops/morph; in slots mode 16 streams lease the 16 morph
                slots and the others read their dominant speaker's base
                slot): the refresh (flush_controls of the staged morph
                controls) between CUDA events, twice; MORPH_TICKS ticks with
                the launch counts set to 0 just before and read just after,
                the kernel form once per tick; every output finite, no
                stream silent; the direct engine's ticks in the same run
                (half before, half after); the first 20 morph ticks against
                a plain-upsampler engine; median and p90 tick, host ms,
                the memory live before the ticks (every engine in the
                process) and the ticks' peak above it; the morph golden run (golden.run_morph)
                against tests/data/torch_morph_golden.npz (f32 at 1e-3,
                bf16 by the envelope).  Then, once every configuration is
                timed, morph_profile: device launches per tick (morph and
                direct) and the lottery's own under torch.profiler, and the
                direct ticks timed again after the profiler ran; and
                morph_offline: convert_utterance with morph weights against
                the golden file at 1e-3.
  6. parity  -- the port's run_parity (beatrice_vst_tpu_torch/parity.py) on
                klatt8, slots f32, capacity 256: one tick of 25 frames
                (the stage loop) against 25 real-time ticks (the f32
                kernel), max |d| <= 1e-3, the f32 kernel launched 25
                times in the streaming half and never in the chunk tick;
                each half's span per 10 ms of audio, host ms and peak
                memory, run twice (the first warms up).  Then the engine
                at frames_per_tick = 25: CHUNK_TICKS ticks with CUDA
                events (median and p90 tick, host ms per tick), and a few
                ticks under torch.profiler (device launches and
                device-busy ms per tick).
  7. offline -- runtime/offline.py:convert_utterance on klatt8 (f32, chunks
                of 64 frames) of golden.offline_signal (1.5 s at 44.1 kHz
                in and out) held to tests/data/torch_offline_golden.npz
                (the JAX package's output) at atol 1e-3; audio seconds
                converted per second, on the second of two runs.
  8. versions -- 2.0.0-alpha.2 and 2.0.0-beta.1 on random parameters and
                banks from the port's chain.init and random_bank at fixed
                seeds, capacity 256: the kernel engine against the
                plain-upsampler engine over 20 ticks at 1e-4, the f32 form
                launched once per tick; then run_parity at 25 frames at
                1e-3.
  9. profile -- only with `--profile DIR`: where the engine's tick time
                goes in each configuration (torch.profiler; tables and
                gzipped traces written to DIR).
Then the kernels line (each form's launches summed over every path that
drove it: the engine configurations, the morph engines, the streaming
halves of parity and the older versions' engines), the card line, and the
last line
{"ok": true, "device": {...}}.  Any failed check raises, and the script
exits non-zero without printing a result.  It exits with 1 where
torch.cuda.is_available() is false.
"""

from __future__ import annotations

import contextlib
import json
import os
import platform
import subprocess
import sys
import time

import numpy as np

CAPACITY = 256
TICKS = 120
WARMUP_TICKS = 20
COMPARE_TICKS = 20
# per form: f32 sums of up to 768 terms in another order; in bf16 the same
# sums can put a stage output on the other side of a bf16 rounding (one
# bf16 ulp is 2^-8 to 2^-7 of a value), which the next stages carry on
KERNEL_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
KERNEL_BATCHES = (16, 240, CAPACITY, 1024)  # 240: 15 clusters of 16 streams, one fewer than 256
KERNEL_REPS = 50
# the plain version is ~100 launches a call: 5 calls stay well inside the
# card's queue of pending launches, which a longer run behind the sleep
# fills (the host then waits for the card and device_ms reads again)
PLAIN_REPS = 5
FLUSH_BYTES = 128 << 20  # written before each cold-L2 launch: 2.5x the 50 MB L2
# the batches at which each form is timed against its yardstick
# (fused_upsampler.YARDSTICKS) in the same run
YARDSTICK_BATCHES = {"float32": (CAPACITY,), "bfloat16": KERNEL_BATCHES}
# name -> (EngineConfig.realtime keywords, kernel form, engine tolerance
# against the plain-upsampler engine: the kernel's, carried through the
# upsampler state)
ENGINE_CONFIGS = {
    "per_stream_f32": (dict(kv_cache_mode="per_stream", vq_shared_bank=False), "float32"),
    "slots_f32": ({}, "float32"),
    "slots_bf16": (dict(compute_dtype="bfloat16"), "bfloat16"),
}
# the main path of each kernel form, whose launches the kernels line reports
MAIN_CONFIG = {"float32": "slots_f32", "bfloat16": "slots_bf16"}
KERNEL_NAME = {"float32": "fused_upsampler", "bfloat16": "fused_upsampler_bf16"}
COUNTER = {"float32": "launches", "bfloat16": "launches_bf16"}
HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "tests", "data", "torch_engine_golden.npz")
OFFLINE_GOLDEN = os.path.join(HERE, "tests", "data", "torch_offline_golden.npz")
MODEL_DIR = os.path.join(HERE, "models_demo", "klatt8")
CHUNK = 25  # frames per tick of the chunk path
CHUNK_TICKS = 12  # T = 25 engine ticks timed, after 2 of warm-up
CHUNK_PROFILE_TICKS = 3
PARITY_TOL = 1e-3  # the JAX harness's gate
# parity's controls, the same for every stream: a speaker, a formant, VQ
# smoothing (the shared bank at T = 1, gathered codebooks at T = 25) and
# a pitch shift
PARITY_CONTROLS = {"target_speaker": 3, "formant_index": 2, "vq_num_neighbors": 4,
                   "pitch_shift": 2.0}
VERSION_TICKS = 20
VERSION_SEED = 7
MORPH_TICKS = 60
MORPH_WARMUP_TICKS = 10
MORPH_SEED = 11
MORPH_PROFILE_TICKS = 3
MORPH_AFTER_PROFILER_TICKS = 30
MORPH_GOLDEN = os.path.join(HERE, "tests", "data", "torch_morph_golden.npz")


def log(phase, t0, **fields):
    print(json.dumps({"phase": phase, "seconds": round(time.perf_counter() - t0, 3),
                      **fields}), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def sleep_cycles_per_ms():
    """Clock cycles of torch.cuda._sleep per millisecond on this card."""
    import torch

    torch.cuda._sleep(1_000_000)  # warm-up
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(20_000_000)
    end.record()
    end.synchronize()
    return 20_000_000 / start.elapsed_time(end)


def host_us(fn, n=200):
    """Host microseconds per call of fn: wall time over n calls without a
    synchronise (the calls only enqueue work), after warm-up."""
    import torch

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n):
        fn()
    dt = time.perf_counter() - t
    torch.cuda.synchronize()
    return dt / n * 1e6


def device_ms(fn, n, cycles_per_ms, call_us, before=None, tries=3):
    """Median device ms of fn, each call between its own pair of CUDA
    events.  The calls are enqueued behind a torch.cuda._sleep long enough
    to cover their host time, so the device runs them back to back and the
    host never sets the pace.  If the enqueue outlasted the sleep (the
    host was held up), the reading is thrown away and taken again behind a
    4x longer sleep; raises after `tries` readings.  before() (an L2
    flush) runs ahead of each pair, outside it."""
    import torch

    for _ in range(3):
        if before:
            before()
        fn()
    torch.cuda.synchronize()
    sleep_ms = 3.0 * n * call_us * 1e-3 + 2.0
    for _ in range(tries):
        s0, s1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s0.record()
        torch.cuda._sleep(int(sleep_ms * cycles_per_ms))
        s1.record()
        t = time.perf_counter()
        pairs = []
        for _ in range(n):
            if before:
                before()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            pairs.append((start, end))
        enqueue_ms = (time.perf_counter() - t) * 1e3
        torch.cuda.synchronize()
        slept = s0.elapsed_time(s1)
        if enqueue_ms < slept:
            return float(np.median([a.elapsed_time(b) for a, b in pairs]))
        print(f"device_ms: enqueue took {enqueue_ms:.3f} ms, longer than the {slept:.3f} ms "
              "sleep; reading again", file=sys.stderr, flush=True)
        sleep_ms *= 4
    raise AssertionError(f"the host set the pace in {tries} readings")


def upsampler_inputs(b, seed, device, dtype):
    """Stage weights, frame features, carries and source features for the
    upsampler head at batch b, from a numpy seed (weights scaled as the
    JAX package initialises them); for bf16, frame features, carries and
    matmul weights rounded to bf16."""
    import torch
    from beatrice_vst_tpu_torch.models import fused_upsampler as FU

    rng = np.random.default_rng(seed)
    h_shape, state_shapes, src_shapes, stage_shapes, final_shapes = FU.expected_shapes(b)

    def u(shape, fan_in):
        s = 1.0 / np.sqrt(fan_in)
        return torch.from_numpy(rng.uniform(-s, s, shape).astype(np.float32)).to(device)

    def n(shape, scale):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).to(device)

    up = []
    for st in stage_shapes:
        k, c_in, _ = st["conv_w"]
        up.append({"conv": {"w": u(st["conv_w"], k * c_in), "b": n(st["conv_b"], 0.1)},
                   "src": {"w": u(st["src_w"], FU.N_SRC), "b": n(st["src_b"], 0.1)},
                   "snake": {"log_alpha": n(st["log_alpha"], 0.3)}})
    final = {"w": u(final_shapes["w"], 3 * 16), "b": n(final_shapes["b"], 0.1)}
    h = n(h_shape, 0.5)
    states = [n(s, 0.1) for s in state_shapes]
    src = [n(s, 0.3) for s in src_shapes]
    up, final = FU.head_params(up, final, dtype)
    return up, final, h.to(dtype), [s.to(dtype) for s in states], src


def max_abs_diffs(got, want):
    """max |d| of the audio and of each of the 5 new carries."""
    (audio, states), (want_audio, want_states) = got, want
    return [float((audio - want_audio).abs().max())] + [
        float((g - w).abs().max()) for g, w in zip(states, want_states)]


def kernel_phase(device, dtype_name):
    """One form of the kernel against its plain version at B in
    KERNEL_BATCHES: max |d| of audio and the 5 carries, device ms with L2
    warm and cold, the wrapper's host us per call, the plain version's
    device ms and the bound.  At YARDSTICK_BATCHES the form's yardstick
    (the f32 form's first version, the FFMA bf16 form) is checked as well
    and timed against it in the order yardstick, form, form, yardstick.
    Returns the kernels-line entry (without launches, which the engine
    phase counts)."""
    import torch
    from beatrice_vst_tpu_torch.models import fused_upsampler as FU

    t0 = time.perf_counter()
    dtype = getattr(torch, dtype_name)
    tol = KERNEL_TOL[dtype_name]
    cycles_per_ms = sleep_cycles_per_ms()
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device=device)
    yardstick = FU.YARDSTICKS[dtype]
    source = FU.FORMS[dtype]
    occupancy = FU.occupancy(device, dtype)
    by_batch = []
    for b in KERNEL_BATCHES:
        args = upsampler_inputs(b, 0, device, dtype)
        want = FU.fused_upsample_reference(*args)
        diffs = max_abs_diffs(FU.fused_upsample(*args), want)
        err = max(diffs)
        if not np.isfinite(err) or err > tol:
            raise AssertionError(f"fused_upsampler {dtype_name} vs plain at B={b}: "
                                 f"max|d| {diffs} > {tol}")

        def kernel():
            FU.fused_upsample(*args)

        def plain():
            FU.fused_upsample_reference(*args)

        call_us = host_us(kernel)
        warm = device_ms(kernel, KERNEL_REPS, cycles_per_ms, call_us)
        cold = device_ms(kernel, KERNEL_REPS, cycles_per_ms, call_us, before=flush.zero_)
        plain_ms = device_ms(plain, PLAIN_REPS, cycles_per_ms, host_us(plain, n=20))
        bound = FU.bound_ms(b, dtype)
        row = {"batch": b, "max_abs_diff": err, "per_output_max_abs_diff": diffs,
               "ms": warm, "cold_l2_ms": cold, "host_us_per_call": call_us,
               "plain_ms": plain_ms, "bound_ms": bound, "bound_by": FU.bound_by(b, dtype),
               "share_of_bound": bound / warm,
               "flops": FU.flops_per_stream() * b, "bytes": FU.bytes_per_call(b, dtype)}
        if b in YARDSTICK_BATCHES[dtype_name]:
            def yard():
                return FU._fused_upsample(*args, source=yardstick)

            y_diffs = max_abs_diffs(yard(), want)
            if not np.isfinite(max(y_diffs)) or max(y_diffs) > tol:
                raise AssertionError(f"{yardstick} {dtype_name} vs plain at B={b}: "
                                     f"max|d| {y_diffs} > {tol}")
            y_us = host_us(yard)
            # [warm, cold] per reading, in the order yardstick, form, form,
            # yardstick
            same_call = {yardstick: [], source: []}
            for name, fn, us in ((yardstick, yard, y_us), (source, kernel, call_us),
                                 (source, kernel, call_us), (yardstick, yard, y_us)):
                same_call[name].append([
                    device_ms(fn, KERNEL_REPS, cycles_per_ms, us),
                    device_ms(fn, KERNEL_REPS, cycles_per_ms, us, before=flush.zero_)])
            runs = same_call[yardstick]
            row.update(yardstick=yardstick, yardstick_max_abs_diff=max(y_diffs),
                       yardstick_host_us_per_call=y_us, same_call_ms_warm_cold=same_call,
                       parent_ms=float(np.mean([r[0] for r in runs])),
                       parent_cold_l2_ms=float(np.mean([r[1] for r in runs])))
        by_batch.append(row)
    del flush
    at = next(r for r in by_batch if r["batch"] == CAPACITY)
    entry = {
        "name": KERNEL_NAME[dtype_name],
        "route": "cuda",
        "source": f"beatrice_vst_tpu_torch/csrc/{source}.cu",
        "replaces": "beatrice_vst_tpu/models/pallas_upsampler.py:203",
        "dtype": dtype_name,
        "max_abs_err": at["max_abs_diff"],
        "max_abs_diff": at["max_abs_diff"],
        "tol": tol,
        "ms": at["ms"],
        "cold_l2_ms": at["cold_l2_ms"],
        "host_us_per_call": at["host_us_per_call"],
        "plain_ms": at["plain_ms"],
        "bound_ms": at["bound_ms"],
        "bound_by": at["bound_by"],
        "library_ms": None,  # no single PyTorch call computes this fused head
        "by_batch": [{k: r[k] for k in ("batch", "ms", "cold_l2_ms", "host_us_per_call",
                                        "plain_ms", "bound_ms", "max_abs_diff", "parent_ms",
                                        "parent_cold_l2_ms") if k in r}
                     for r in by_batch],
        # the yardstick on the same inputs in the same run, timed the same
        # way (mean of its two readings)
        "parent": f"beatrice_vst_tpu_torch/csrc/{yardstick}.cu",
        "parent_ms": at["parent_ms"],
        "parent_cold_l2_ms": at["parent_cold_l2_ms"],
    }
    log("kernel", t0, dtype=dtype_name, tol=tol, occupancy=occupancy, reps=KERNEL_REPS,
        flush_mib=FLUSH_BYTES / 2**20, by_batch=by_batch)
    return entry


def klatt8(device):
    """The klatt8 weights and speaker bank on the card."""
    from beatrice_vst_tpu_torch.constants import V20RC0
    from beatrice_vst_tpu_torch.models.io import load_weights
    from beatrice_vst_tpu_torch.speakers import bank as bank_mod

    return (load_weights(os.path.join(MODEL_DIR, "weights.npz"), device=device),
            bank_mod.load(os.path.join(MODEL_DIR, "speakers.npz"), V20RC0, device=device))


def admit_all(engine, n_speakers):
    """Admit every stream with its own speaker, formant, VQ neighbours and
    pitch shift."""
    for i in range(engine.cfg.capacity):
        engine.admit()
        engine.set_control(i, "target_speaker", i % n_speakers)
        engine.set_control(i, "formant_index", (i // n_speakers) % 9)
        engine.set_control(i, "vq_num_neighbors", i % 5)
        engine.set_control(i, "pitch_shift", float((i % 7) - 3))


def build_engine(device, config, upsampler_kernel=True, capacity=CAPACITY, controls=True,
                 frames_per_tick=1):
    """The port's StreamEngine in the named configuration on the klatt8
    weights; with `controls`, every stream admitted by `admit_all`."""
    from beatrice_vst_tpu_torch.runtime.engine import EngineConfig, StreamEngine
    from beatrice_vst_tpu_torch.speakers import bank as bank_mod

    params, bank = klatt8(device)
    cfg = EngineConfig.realtime(capacity, upsampler_kernel=upsampler_kernel,
                                frames_per_tick=frames_per_tick, **ENGINE_CONFIGS[config][0])
    engine = StreamEngine(cfg, params, bank, device=device)
    if controls:
        admit_all(engine, bank_mod.n_speakers(bank))
    return engine


def engine_audio(device, frames=TICKS):
    """[frames, CAPACITY, 480] at 48 kHz on the card: a swept sine (each
    stream its own start frequency) plus noise from a numpy seed."""
    import torch

    rng = np.random.default_rng(1)
    n = np.arange(frames * 480) / 48000.0
    f0 = rng.uniform(90.0, 300.0, CAPACITY)[:, None]
    x = 0.3 * np.sin(2 * np.pi * (f0 * n + 150.0 * n * n))
    x = x + 0.02 * rng.standard_normal(x.shape)
    x = x.astype(np.float32).reshape(CAPACITY, frames, 480).transpose(1, 0, 2)
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


def utterance(audio):
    """[frames, B, 480] -> [B, frames * 480]: each stream's frames in a row."""
    return audio.permute(1, 0, 2).reshape(audio.shape[1], -1).contiguous()


def launch_counts():
    """Each kernel form's launches since the counts were last set to 0, and
    each yardstick's (under "yardstick_<form>"; no path launches one)."""
    import torch
    from beatrice_vst_tpu_torch.models import fused_upsampler as FU

    counts = {form: getattr(FU, COUNTER[form]) for form in COUNTER}
    for form in COUNTER:
        dtype = getattr(torch, form)
        counts[f"yardstick_{form}"] = FU.yardstick_launches[FU.YARDSTICKS[dtype], str(dtype)]
    return counts


def reset_launch_counts():
    from beatrice_vst_tpu_torch.models import fused_upsampler as FU

    FU.launches = FU.launches_bf16 = 0
    FU.yardstick_launches.clear()


def timed_ticks(engine, audio, ticks, keep=0):
    """`ticks` ticks of audio, each between CUDA events: (each stream's
    peak per tick [ticks, CAPACITY], whether all were finite, span ms per
    tick, host ms per tick, the first `keep` outputs)."""
    import torch

    spans, host_ms, peaks, finite, kept = [], [], [], [], []
    for k in range(ticks):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        t = time.perf_counter()
        out = engine.tick(audio[k])
        host_ms.append((time.perf_counter() - t) * 1e3)
        end.record()
        peaks.append(out.abs().max(dim=1).values)
        finite.append(torch.isfinite(out).all())
        spans.append((start, end))
        if k < keep:
            kept.append(out.clone())
    torch.cuda.synchronize()
    return (torch.stack(peaks), bool(torch.stack(finite).all()),
            [s.elapsed_time(e) for s, e in spans], host_ms, kept)


class Spans:
    """A `run_parity` timer: for each named block, its span from CUDA
    events, the host's time to enqueue it, each kernel form's launches
    and the peak memory."""

    def __init__(self):
        self.out = {}

    @contextlib.contextmanager
    def __call__(self, name):
        import torch

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = launch_counts()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        t = time.perf_counter()
        yield
        host_ms = (time.perf_counter() - t) * 1e3
        end.record()
        torch.cuda.synchronize()
        self.out[name] = {"span_ms": start.elapsed_time(end), "host_ms": host_ms,
                          "launches": {k: v - before[k] for k, v in launch_counts().items()},
                          "peak_mib": torch.cuda.max_memory_allocated() / 2**20}


def check_parity(report, spans, label):
    """The parity gate and the f32 kernel's launches: one per streaming
    tick, none in the chunk tick.  Returns the f32 form's launches."""
    if not report.passed:
        raise AssertionError(f"{label}: {report}")
    n = report.n_frames
    stream, chunk = spans.out["stream"]["launches"], spans.out["chunk"]["launches"]
    if stream != {**dict.fromkeys(stream, 0), "float32": n} or sum(chunk.values()) != 0:
        raise AssertionError(f"{label}: kernel launches {stream} in {n} streaming ticks and "
                             f"{chunk} in the chunk tick; expected {n} f32 and 0")
    return stream["float32"]


def golden_gate(label, form, got, f32_ref, bf16_ref):
    """A run on the card against the JAX engine's golden output: f32 at
    atol 1e-3 to f32_ref; bf16 by the envelope of golden.py against the
    JAX f32 and bf16 runs (f32_ref, bf16_ref).  Raises if it fails."""
    from beatrice_vst_tpu_torch import golden

    if form == "bfloat16":
        env = golden.envelope(got, {"f32": f32_ref, "bf16": bf16_ref})
        if not env["ok"]:
            raise AssertionError(f"{label} outside the golden envelope: {env}")
        return {"envelope": env}
    dev = golden.deviation(got, f32_ref)
    if not dev["max"] <= golden.F32_ATOL:
        raise AssertionError(f"{label} vs the golden file: max|d| {dev['max']} > "
                             f"{golden.F32_ATOL}")
    return {"vs_golden_f32": dev, "tol": golden.F32_ATOL}


def golden_check(device, config):
    """The engine's golden run on the card (4 streams x 20 ticks) against
    the JAX engine's output in tests/data/torch_engine_golden.npz."""
    from beatrice_vst_tpu_torch import golden

    ref = golden.load(GOLDEN)
    engine = build_engine(device, config, capacity=golden.CAPACITY, controls=False)
    got = golden.run(engine, lambda t: t.cpu().numpy())
    return golden_gate(config, ENGINE_CONFIGS[config][1], got, ref["f32"], ref["bf16"])


def engine_phase(device, config):
    """One configuration at capacity 256: TICKS ticks with the launch
    counts set to 0 just before and read just after; returns the launches
    of its kernel form."""
    import torch

    t0 = time.perf_counter()
    form = ENGINE_CONFIGS[config][1]
    tol = KERNEL_TOL[form]
    audio = engine_audio(device)
    engine = build_engine(device, config)
    engine.flush_controls()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    peaks, finite, spans, host_ms, kept = timed_ticks(engine, audio, TICKS, COMPARE_TICKS)
    counts = launch_counts()
    if counts[form] != TICKS or sum(counts.values()) != TICKS:
        raise AssertionError(f"{config}: kernel launches {counts} in {TICKS} ticks, "
                             f"expected {TICKS} of the {form} form only")
    if not finite:
        raise AssertionError(f"{config}: non-finite engine output")
    times = spans[WARMUP_TICKS:]
    median_tick = float(np.median(times))
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    if float(peaks[:COMPARE_TICKS].max()) <= 1e-3:
        raise AssertionError(f"{config}: engine output is silent")

    plain = build_engine(device, config, upsampler_kernel=False)
    diff = 0.0
    for k in range(COMPARE_TICKS):
        out = plain.tick(audio[k])
        diff = max(diff, float((out - kept[k]).abs().max()))
    if launch_counts()[form] != counts[form]:
        raise AssertionError(f"{config}: the plain-upsampler engine launched the kernel")
    if not np.isfinite(diff) or diff > tol:
        raise AssertionError(f"{config}: kernel engine vs plain engine: max|d| {diff} > {tol}")
    log("engine", t0, config=config, kernel_form=form, capacity=CAPACITY, ticks=TICKS,
        launches=counts, median_tick_ms=median_tick,
        p90_tick_ms=float(np.percentile(times, 90)),
        median_host_ms=float(np.median(host_ms[WARMUP_TICKS:])),
        implied_streams_per_10ms=CAPACITY * 10.0 / median_tick,
        peak_mib=peak_mib, plain_engine_ticks=COMPARE_TICKS,
        plain_engine_max_abs_diff=diff, tol=tol, golden=golden_check(device, config))
    return counts[form]


def parity_phase(device):
    """run_parity on klatt8, slots f32, capacity 256, 25 frames (twice,
    the second timed), then the engine at frames_per_tick = 25.  Returns
    the f32 form's launches in the streaming halves."""
    import torch
    from beatrice_vst_tpu_torch.models.chain import VoiceConverterConfig
    from beatrice_vst_tpu_torch.constants import V20RC0
    from beatrice_vst_tpu_torch.parity import run_parity

    t0 = time.perf_counter()
    params, bank = klatt8(device)
    cfg = VoiceConverterConfig.for_version(V20RC0)
    audio = utterance(engine_audio(device, CHUNK))
    launches = 0
    runs = []
    for _ in range(2):
        spans = Spans()
        reset_launch_counts()
        report = run_parity(params, cfg, bank, audio, tolerance=PARITY_TOL,
                            controls=PARITY_CONTROLS, device=device, timer=spans)
        launches += check_parity(report, spans, "parity on klatt8")
        runs.append({"max_abs_diff": report.max_abs_diff, "rms_diff": report.rms_diff,
                     **{f"{half}_{k}": v for half, s in spans.out.items()
                        for k, v in s.items()}})
    timed = runs[-1]
    per_10ms = {f"{half}_span_ms_per_10ms_audio": timed[f"{half}_span_ms"] / CHUNK
                for half in ("stream", "chunk")}
    log("parity", t0, model="klatt8", config="slots_f32", capacity=CAPACITY, frames=CHUNK,
        tol=PARITY_TOL, controls=PARITY_CONTROLS, runs=runs, **per_10ms,
        chunk_engine=chunk_engine(device))
    return launches


def chunk_engine(device):
    """The engine at frames_per_tick = 25, slots f32, capacity 256:
    CHUNK_TICKS ticks after 2 of warm-up, each between CUDA events; then
    CHUNK_PROFILE_TICKS ticks under torch.profiler.  Every output finite
    and not silent; the kernel never launched (the chunk head is the
    stage loop)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    engine = build_engine(device, "slots_f32", frames_per_tick=CHUNK)
    frames = (2 + CHUNK_TICKS + CHUNK_PROFILE_TICKS) * CHUNK
    audio = engine_audio(device, frames).reshape(-1, CHUNK, CAPACITY, 480)
    ticks = [utterance(a) for a in audio]
    engine.flush_controls()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    peaks, finite, spans, host_ms, _ = timed_ticks(engine, ticks, 2 + CHUNK_TICKS)
    peaks = peaks.max(dim=1).values
    if not finite or float(peaks.min()) <= 1e-3:
        raise AssertionError(f"T = {CHUNK} engine: output not finite or silent: {peaks}")
    if sum(launch_counts().values()):
        raise AssertionError(f"T = {CHUNK} engine launched the kernel: {launch_counts()}")
    times = spans[2:]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for k in range(2 + CHUNK_TICKS, len(ticks)):
            engine.tick(ticks[k])
        torch.cuda.synchronize()
    rows = sorted(((e.self_device_time_total, e.count, e.key) for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.self_device_time_total > 0), reverse=True)
    n = CHUNK_PROFILE_TICKS
    return {"frames_per_tick": CHUNK, "ticks": CHUNK_TICKS,
            "median_tick_ms": float(np.median(times)), "p90_tick_ms": float(np.percentile(times, 90)),
            "median_host_ms": float(np.median(host_ms[2:])),
            "median_tick_ms_per_10ms_audio": float(np.median(times)) / CHUNK,
            "implied_streams_per_10ms": CAPACITY * CHUNK * 10.0 / float(np.median(times)),
            "peak_mib": torch.cuda.max_memory_allocated() / 2**20,
            "profiled_ticks": CHUNK_PROFILE_TICKS,
            "device_launches_per_tick": sum(c for _, c, _ in rows) / n,
            "device_busy_ms_per_tick": sum(us for us, _, _ in rows) / n / 1e3,
            "top": [{"kernel": key[:100], "ms_per_tick": us / n / 1e3, "launches_per_tick": c / n}
                    for us, c, key in rows[:12]]}


def offline_phase(device):
    """convert_utterance on klatt8 against the JAX package's output in
    tests/data/torch_offline_golden.npz, and its speed."""
    import torch
    from beatrice_vst_tpu_torch import golden
    from beatrice_vst_tpu_torch.constants import V20RC0
    from beatrice_vst_tpu_torch.models.chain import VoiceConverterConfig
    from beatrice_vst_tpu_torch.runtime.offline import ConversionSettings, convert_utterance

    t0 = time.perf_counter()
    params, bank = klatt8(device)
    cfg = VoiceConverterConfig.for_version(V20RC0)
    signal = golden.offline_signal()
    want = golden.load(OFFLINE_GOLDEN)["f32"]
    seconds = []
    for _ in range(2):
        reset_launch_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        got = convert_utterance(params, cfg, bank, signal, golden.OFFLINE_RATE,
                                ConversionSettings(**golden.OFFLINE_SETTINGS),
                                chunk_frames=golden.OFFLINE_CHUNK_FRAMES, device=device)
        seconds.append(time.perf_counter() - t)
        dev = golden.deviation(got, want)
        if got.shape != want.shape or not dev["max"] <= golden.F32_ATOL:
            raise AssertionError(f"offline vs the golden file: shape {got.shape} "
                                 f"(want {want.shape}), {dev} > {golden.F32_ATOL}")
    audio_s = len(signal) / golden.OFFLINE_RATE
    log("offline", t0, model="klatt8", rate=golden.OFFLINE_RATE, audio_seconds=audio_s,
        chunk_frames=golden.OFFLINE_CHUNK_FRAMES, vs_golden=dev, tol=golden.F32_ATOL,
        seconds=seconds, audio_seconds_per_second=audio_s / seconds[-1],
        kernel_launches=launch_counts())


def versions_phase(device):
    """The older versions' engines at capacity 256 on random parameters:
    kernel against plain upsampler, then parity.  Returns the f32 form's
    launches on these paths."""
    import torch
    from beatrice_vst_tpu_torch.constants import V20A2, V20B1
    from beatrice_vst_tpu_torch.models import chain
    from beatrice_vst_tpu_torch.parity import run_parity
    from beatrice_vst_tpu_torch.runtime.engine import EngineConfig, StreamEngine
    from beatrice_vst_tpu_torch.speakers import bank as bank_mod

    audio = engine_audio(device, max(VERSION_TICKS, CHUNK))
    launches = 0
    for spec in (V20A2, V20B1):
        t0 = time.perf_counter()
        cfg = chain.VoiceConverterConfig.for_version(spec)
        seed = VERSION_SEED + spec.version_int
        params = chain.init(torch.Generator().manual_seed(seed), cfg, device)
        bank = bank_mod.random_bank(torch.Generator().manual_seed(seed + 100), spec, 8,
                                    device=device)
        outs = {}
        for kernel in (True, False):
            engine = StreamEngine(EngineConfig.realtime(CAPACITY, spec=spec,
                                                        upsampler_kernel=kernel),
                                  params, bank, device=device)
            admit_all(engine, 8)
            engine.flush_controls()
            reset_launch_counts()
            outs[kernel] = torch.stack([engine.tick(audio[k]) for k in range(VERSION_TICKS)])
            counts = launch_counts()
            want = {**dict.fromkeys(counts, 0), "float32": VERSION_TICKS if kernel else 0}
            if counts != want:
                raise AssertionError(f"{spec.name} engine (kernel {kernel}): launches {counts}, "
                                     f"expected {want}")
            if kernel:
                launches += counts["float32"]
        if not bool(torch.isfinite(outs[True]).all()) or float(outs[True].abs().max()) <= 1e-3:
            raise AssertionError(f"{spec.name} engine: output not finite or silent")
        diff = float((outs[True] - outs[False]).abs().max())
        if not diff <= KERNEL_TOL["float32"]:
            raise AssertionError(f"{spec.name}: kernel engine vs plain engine: max|d| {diff}")
        spans = Spans()
        reset_launch_counts()
        report = run_parity(params, cfg, bank, utterance(audio[:CHUNK]), tolerance=PARITY_TOL,
                            device=device, timer=spans)
        launches += check_parity(report, spans, f"parity of {spec.name}")
        log("versions", t0, version=spec.name, capacity=CAPACITY, seed=seed,
            ticks=VERSION_TICKS, launches=VERSION_TICKS, plain_engine_max_abs_diff=diff,
            tol=KERNEL_TOL["float32"], parity={"max_abs_diff": report.max_abs_diff,
                                               "rms_diff": report.rms_diff,
                                               "tol": PARITY_TOL, "frames": report.n_frames,
                                               **spans.out})
    return launches


def morph_controls(device, n_speakers):
    """Every odd stream's morph controls: its own weights over the bank's
    speakers from a numpy seed (Dirichlet(0.5), so some fall below the
    threshold), pruned on the card by the port's ops/morph.  Returns
    {stream: (morph_weights [256], morph_top_idx [8])} as numpy."""
    import torch
    from beatrice_vst_tpu_torch.constants import MAX_N_SPEAKERS
    from beatrice_vst_tpu_torch.speakers.morpher import pruned_morph_weights

    streams = list(range(1, CAPACITY, 2))
    dense = np.zeros((len(streams), MAX_N_SPEAKERS), np.float32)
    dense[:, :n_speakers] = np.random.default_rng(MORPH_SEED).dirichlet(
        np.full(n_speakers, 0.5), len(streams))
    pruned, top = pruned_morph_weights(torch.from_numpy(dense).to(device),
                                       torch.full((len(streams),), n_speakers, device=device))
    pruned, top = pruned.cpu().numpy(), top.cpu().numpy()
    return {i: (pruned[k], top[k]) for k, i in enumerate(streams)}


def set_morph(engine, controls, n_speakers):
    from beatrice_vst_tpu_torch import golden

    for i, (pruned, top) in controls.items():
        golden.set_morph(engine, i, pruned, top, n_speakers)


def tick_launches(engine, audio, ticks):
    """Device kernel launches per tick over `ticks` ticks under
    torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for k in range(ticks):
            engine.tick(audio[k])
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / ticks


def lottery_launches(engine, n_speakers, calls=5):
    """The codebook lottery as the tick calls it, alone: (device kernel
    launches per call over `calls` calls under torch.profiler, host us per
    call)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from beatrice_vst_tpu_torch.speakers import morpher

    c, st = engine.state["controls"], engine.state

    def lottery():
        return morpher.codebook_lottery(
            c["morph_weights"], c["morph_top_idx"],
            torch.full_like(c["target_speaker"], n_speakers), st["frame_counter"],
            w8=st["morphed"]["w8"])

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            lottery()
        torch.cuda.synchronize()
    launches = sum(e.count for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    return launches / calls, host_us(lottery)


def refresh_span(engine):
    """flush_controls between CUDA events, after a synchronise: (span ms,
    host ms)."""
    import torch

    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    t = time.perf_counter()
    engine.flush_controls()
    host_ms = (time.perf_counter() - t) * 1e3
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), host_ms


def morph_golden_check(device, config):
    """The morph scenario (golden.run_morph: 6 streams x 20 ticks, two
    morph slots) on the card against the JAX engine's output in
    tests/data/torch_morph_golden.npz (bf16: the envelope against the JAX
    slots f32 and bf16 runs)."""
    from beatrice_vst_tpu_torch import golden
    from beatrice_vst_tpu_torch.runtime.engine import EngineConfig, StreamEngine

    ref = golden.load(MORPH_GOLDEN)
    engine = StreamEngine(EngineConfig.realtime(golden.MORPH_CAPACITY,
                                                **golden.MORPH_CONFIGS[config]),
                          *klatt8(device), device=device)
    got = golden.run_morph(engine, lambda t: t.cpu().numpy())
    form = ENGINE_CONFIGS[config][1]
    return golden_gate(f"morph {config}", form, got,
                       ref["slots_f32" if form == "bfloat16" else config], ref[config])


def morph_phase(device, config, card):
    """Half the streams morphing at capacity 256 in one configuration:
    every odd stream's morph controls staged after the direct streams
    settle, the refresh (flush_controls) timed twice (the second warm);
    MORPH_TICKS ticks with the launch counts set to 0 just before and read
    just after (the configuration's kernel form once per tick), outputs
    finite and not silent (the morph streams too); the direct engine's
    ticks in the same run, half before and half after; the first
    COMPARE_TICKS against a plain-upsampler engine with the same morphs,
    staged the same way; the memory allocated before the ticks (every
    engine alive in the process) and the ticks' peak above it;
    the morph golden run.  Returns the launches of its kernel form and what
    `morph_profile_phase` profiles later (no profiler runs before every
    configuration's ticks are timed)."""
    import torch
    from beatrice_vst_tpu_torch.speakers import bank as bank_mod

    t0 = time.perf_counter()
    form = ENGINE_CONFIGS[config][1]
    tol = KERNEL_TOL[form]
    audio = engine_audio(device)
    engines = {}
    for name, kernel in (("morph", True), ("plain", False), ("direct", True)):
        engines[name] = build_engine(device, config, upsampler_kernel=kernel)
        engines[name].flush_controls()
    n_spk = bank_mod.n_speakers(engines["morph"].bank)
    controls = morph_controls(device, n_spk)
    eng = engines["morph"]
    refresh = []
    for _ in range(2):  # the second refresh is warm
        set_morph(eng, controls, n_spk)
        refresh.append(refresh_span(eng))
    set_morph(engines["plain"], controls, n_spk)
    engines["plain"].flush_controls()
    n_slot_leases = len(eng._morph_slot)

    half = MORPH_TICKS // 2
    _, direct_finite, direct_a, direct_host_a, _ = timed_ticks(engines["direct"], audio, half)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    live = torch.cuda.memory_allocated()
    reset_launch_counts()
    peaks, finite, spans, host_ms, kept = timed_ticks(eng, audio, MORPH_TICKS, COMPARE_TICKS)
    counts = launch_counts()
    tick_mib = (torch.cuda.max_memory_allocated() - live) / 2**20
    if counts[form] != MORPH_TICKS or sum(counts.values()) != MORPH_TICKS:
        raise AssertionError(f"morph {config}: kernel launches {counts} in {MORPH_TICKS} ticks, "
                             f"expected {MORPH_TICKS} of the {form} form only")
    _, direct_finite_b, direct_b, direct_host_b, _ = timed_ticks(
        engines["direct"], audio[half:], MORPH_TICKS - half)
    if not (finite and direct_finite and direct_finite_b):
        raise AssertionError(f"morph {config}: non-finite engine output")
    morph_peak = float(peaks[:, 1::2].max(dim=0).values.min())
    if float(peaks.max(dim=1).values.min()) <= 1e-3 or morph_peak <= 1e-3:
        raise AssertionError(f"morph {config}: silent output (quietest morph stream {morph_peak})")

    diff = 0.0
    before = launch_counts()
    for k in range(COMPARE_TICKS):
        diff = max(diff, float((engines["plain"].tick(audio[k]) - kept[k]).abs().max()))
    if launch_counts() != before:
        raise AssertionError(f"morph {config}: the plain-upsampler engine launched the kernel")
    if not np.isfinite(diff) or diff > tol:
        raise AssertionError(f"morph {config}: kernel engine vs plain engine: max|d| {diff} > "
                             f"{tol}")
    direct = direct_a[MORPH_WARMUP_TICKS:] + direct_b
    times = spans[MORPH_WARMUP_TICKS:]
    log("morph", t0, config=config, kernel_form=form, capacity=CAPACITY,
        morph_streams=len(controls), morph_slots_leased=n_slot_leases, ticks=MORPH_TICKS,
        launches=counts, refresh_ms=[r[0] for r in refresh],
        refresh_host_ms=[r[1] for r in refresh],
        median_tick_ms=float(np.median(times)), p90_tick_ms=float(np.percentile(times, 90)),
        median_host_ms=float(np.median(host_ms[MORPH_WARMUP_TICKS:])),
        direct_median_tick_ms=float(np.median(direct)),
        direct_p90_tick_ms=float(np.percentile(direct, 90)),
        direct_median_host_ms=float(np.median(direct_host_a[MORPH_WARMUP_TICKS:] + direct_host_b)),
        live_mib=live / 2**20, tick_peak_over_live_mib=tick_mib,
        plain_engine_ticks=COMPARE_TICKS, plain_engine_max_abs_diff=diff,
        tol=tol,
        golden=morph_golden_check(device, config), nvidia_smi=card)
    return counts[form], (eng, engines["direct"], n_spk)


def morph_profile_phase(device, runs, card):
    """For each configuration's morph and direct engines, after all of
    them were timed: device launches per tick under torch.profiler
    (MORPH_PROFILE_TICKS ticks each), the lottery's own launches and host
    time, and the direct engine's ticks timed again after the profiler
    ran (MORPH_AFTER_PROFILER_TICKS, median after MORPH_WARMUP_TICKS)."""
    audio = engine_audio(device)
    start = MORPH_TICKS + MORPH_PROFILE_TICKS
    for config, (eng, direct, n_spk) in runs.items():
        t0 = time.perf_counter()
        lottery, lottery_us = lottery_launches(eng, n_spk)
        per_tick = {"morph": tick_launches(eng, audio[MORPH_TICKS:], MORPH_PROFILE_TICKS),
                    "direct": tick_launches(direct, audio[MORPH_TICKS:], MORPH_PROFILE_TICKS)}
        _, finite, after, after_host, _ = timed_ticks(direct, audio[start:],
                                                      MORPH_AFTER_PROFILER_TICKS)
        if not finite:
            raise AssertionError(f"morph profile {config}: non-finite engine output")
        log("morph_profile", t0, config=config, device_launches_per_tick=per_tick,
            lottery_launches=lottery, lottery_host_us=lottery_us,
            direct_median_tick_ms_after_profiler=float(np.median(after[MORPH_WARMUP_TICKS:])),
            direct_median_host_ms_after_profiler=float(np.median(after_host[MORPH_WARMUP_TICKS:])),
            nvidia_smi=card)


def morph_offline_phase(device, card):
    """convert_utterance with morph weights (golden.MORPH_WEIGHTS of
    MORPH_OFFLINE_STREAM) on klatt8 against the JAX package's output in
    tests/data/torch_morph_golden.npz at atol 1e-3."""
    from beatrice_vst_tpu_torch import golden
    from beatrice_vst_tpu_torch.constants import V20RC0
    from beatrice_vst_tpu_torch.models.chain import VoiceConverterConfig
    from beatrice_vst_tpu_torch.runtime.offline import ConversionSettings, convert_utterance

    t0 = time.perf_counter()
    params, bank = klatt8(device)
    weights = np.asarray(golden.MORPH_WEIGHTS[golden.MORPH_OFFLINE_STREAM], np.float32)
    got = convert_utterance(params, VoiceConverterConfig.for_version(V20RC0), bank,
                            golden.offline_signal(), golden.OFFLINE_RATE,
                            ConversionSettings(**golden.OFFLINE_SETTINGS, morph_weights=weights),
                            chunk_frames=golden.OFFLINE_CHUNK_FRAMES, device=device)
    want = golden.load(MORPH_GOLDEN)["offline"]
    dev = golden.deviation(got, want)
    if got.shape != want.shape or not dev["max"] <= golden.F32_ATOL:
        raise AssertionError(f"morph offline vs the golden file: shape {got.shape} "
                             f"(want {want.shape}), {dev} > {golden.F32_ATOL}")
    log("morph_offline", t0, model="klatt8", weights=weights.tolist(), vs_golden=dev,
        tol=golden.F32_ATOL, nvidia_smi=card)


def profile_phase(device, out_dir, config, ticks=20):
    """Where the engine's tick time goes in one configuration: `ticks`
    ticks at capacity 256 under torch.profiler after warm-up.  Prints
    device-busy and host time per tick, kernel launches per tick and the
    kernels with the most device time; writes the table and a gzipped
    Chrome trace to `out_dir`."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    audio = engine_audio(device)
    engine = build_engine(device, config)
    for k in range(WARMUP_TICKS):
        engine.tick(audio[k])
    torch.cuda.synchronize()
    host = []
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        for k in range(WARMUP_TICKS, WARMUP_TICKS + ticks):
            t = time.perf_counter()
            engine.tick(audio[k])
            host.append((time.perf_counter() - t) * 1e3)
        end.record()
        torch.cuda.synchronize()
    span_ms = start.elapsed_time(end) / ticks

    # device-side events only: an operator's row repeats the time of the
    # kernels it launched
    rows = [(e.key, e.self_device_time_total / ticks / 1e3, e.count / ticks)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out_dir, f"tick_trace_{config}.json.gz"))
    table = [{"kernel": k[:120], "ms_per_tick": ms, "launches_per_tick": n} for k, ms, n in rows]
    with open(os.path.join(out_dir, f"tick_profile_{config}.json"), "w") as f:
        json.dump({"config": config, "capacity": CAPACITY, "ticks": ticks,
                   "span_ms_per_tick": span_ms, "device_busy_ms_per_tick": busy_ms,
                   "host_ms_per_tick": float(np.median(host)), "kernels": table}, f, indent=1)
    upsampler_ms = sum(ms for k, ms, _ in rows if "fused_upsampler" in k)
    log("profile", t0, config=config, capacity=CAPACITY, ticks=ticks,
        span_ms_per_tick=span_ms, upsampler_kernel_ms_per_tick=upsampler_ms,
        device_busy_ms_per_tick=busy_ms, idle_share=1.0 - busy_ms / span_ms,
        median_host_ms_per_tick=float(np.median(host)),
        device_launches_per_tick=sum(r[2] for r in rows), top=table[:12])


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")

    t0 = time.perf_counter()
    card = nvidia_smi_line()
    log("env", t0, python=platform.python_version(), torch=torch.__version__,
        cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
        device_count=torch.cuda.device_count(), nvidia_smi=card)

    from beatrice_vst_tpu_torch import cuda_build

    t0 = time.perf_counter()
    from beatrice_vst_tpu_torch.models import fused_upsampler as FU

    sources = sorted({*FU.FORMS.values(), *FU.YARDSTICKS.values()})
    logs = cuda_build.build(sources)
    ptxas = {name: [ln.strip() for ln in text.splitlines() if "registers" in ln or "spill" in ln]
             for name, text in logs.items()}
    hmma = {name: cuda_build.sass(name).count("HMMA") for name in sources}
    if not hmma[FU.FORMS[torch.bfloat16]]:
        raise AssertionError("the tensor-core bf16 form has no HMMA instruction in its SASS")
    log("build", t0, built=sorted(logs), ptxas=ptxas, sass_hmma=hmma)

    entries = {form: kernel_phase(device, form) for form in KERNEL_NAME}
    by_path = {form: {} for form in KERNEL_NAME}
    for config, (_, form) in ENGINE_CONFIGS.items():
        by_path[form][f"engine_{config}"] = engine_phase(device, config)
    morph_runs = {}
    for config, (_, form) in ENGINE_CONFIGS.items():
        by_path[form][f"morph_{config}"], morph_runs[config] = morph_phase(device, config, card)
    morph_profile_phase(device, morph_runs, card)
    del morph_runs
    morph_offline_phase(device, card)
    by_path["float32"]["parity_stream"] = parity_phase(device)
    offline_phase(device)
    by_path["float32"]["versions"] = versions_phase(device)
    for form, entry in entries.items():
        entry["launches"] = sum(by_path[form].values())
        entry["launches_by_path"] = by_path[form]
        entry["main_path"] = MAIN_CONFIG[form]
    if "--profile" in sys.argv[1:]:
        for config in ENGINE_CONFIGS:
            profile_phase(device, sys.argv[sys.argv.index("--profile") + 1], config)

    print(json.dumps({"kernels": list(entries.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
