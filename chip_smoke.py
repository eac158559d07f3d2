#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--profile DIR]

Phases, each printing one line with its seconds:
  1. env     -- Python, torch and CUDA versions; the card's name and power
                limit from nvidia-smi.
  2. build   -- builds every CUDA kernel of the port from csrc/ with nvcc,
                and the first version of the upsampler kernel
                (csrc/fused_upsampler_v1.cu), one nvcc each, all at once.
  3. kernel  -- each form of each kernel (the upsampler head in f32 and in
                bf16) against its plain PyTorch version on the card at
                B = 16, 240, 256 (the engine's capacity) and 1024, on inputs
                made with numpy from a fixed seed: max |d|; the kernel's
                device time with L2 warm and with L2 cold (128 MiB written
                before each launch, not timed), from CUDA event pairs around
                launches enqueued behind a device sleep so that the host
                never sets the pace; the wrapper's host time per call; the
                plain version's device time; the bound.  At B = 256 the
                f32 form's first version is checked too and timed against
                it, warm and cold, in the order v1, v2, v2, v1.
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
  5. profile -- only with `--profile DIR`: where the engine's tick time
                goes in each configuration (torch.profiler; tables and
                gzipped traces written to DIR).
Then the kernels line, the card line, and the last line
{"ok": true, "device": {...}}.  Any failed check raises, and the script
exits non-zero without printing a result.  It exits with 1 where
torch.cuda.is_available() is false.
"""

from __future__ import annotations

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
V1 = "fused_upsampler_v1"  # the kernel's first version, timed against it
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
    device ms and the bound.  For the f32 form at the engine's capacity
    the first version (V1) is checked as well and timed against it in the
    order v1, v2, v2, v1.  Returns the kernels-line entry (without
    launches, which the engine phase counts)."""
    import torch
    from beatrice_vst_tpu_torch.models import fused_upsampler as FU

    t0 = time.perf_counter()
    dtype = getattr(torch, dtype_name)
    tol = KERNEL_TOL[dtype_name]
    cycles_per_ms = sleep_cycles_per_ms()
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device=device)
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
        if b == CAPACITY and dtype == torch.float32:
            def v1():
                return FU._fused_upsample(*args, source=V1)

            v1_diffs = max_abs_diffs(v1(), want)
            if not np.isfinite(max(v1_diffs)) or max(v1_diffs) > tol:
                raise AssertionError(f"{V1} vs plain at B={b}: max|d| {v1_diffs} > {tol}")
            v1_us = host_us(v1)
            # [warm, cold] per reading, in the order v1, v2, v2, v1
            same_call = {V1: [], "fused_upsampler": []}
            for name, fn, us in ((V1, v1, v1_us), ("fused_upsampler", kernel, call_us),
                                 ("fused_upsampler", kernel, call_us), (V1, v1, v1_us)):
                same_call[name].append([
                    device_ms(fn, KERNEL_REPS, cycles_per_ms, us),
                    device_ms(fn, KERNEL_REPS, cycles_per_ms, us, before=flush.zero_)])
            row.update(v1_max_abs_diff=max(v1_diffs), v1_host_us_per_call=v1_us,
                       same_call_ms_warm_cold=same_call)
        by_batch.append(row)
    del flush
    at = next(r for r in by_batch if r["batch"] == CAPACITY)
    entry = {
        "name": KERNEL_NAME[dtype_name],
        "route": "cuda",
        "source": "beatrice_vst_tpu_torch/csrc/fused_upsampler.cu",
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
                                        "plain_ms", "bound_ms", "max_abs_diff")}
                     for r in by_batch],
    }
    if dtype == torch.float32:
        # the first version on the same inputs in the same run, timed the
        # same way (mean of its two readings)
        runs = at["same_call_ms_warm_cold"][V1]
        entry.update(parent=f"beatrice_vst_tpu_torch/csrc/{V1}.cu",
                     parent_ms=float(np.mean([r[0] for r in runs])),
                     parent_cold_l2_ms=float(np.mean([r[1] for r in runs])))
    log("kernel", t0, dtype=dtype_name, tol=tol, occupancy=occupancy, reps=KERNEL_REPS,
        flush_mib=FLUSH_BYTES / 2**20, by_batch=by_batch)
    return entry


def build_engine(device, config, upsampler_kernel=True, capacity=CAPACITY, controls=True):
    """The port's StreamEngine in the named configuration on the klatt8
    weights; with `controls`, every stream admitted with its own speaker,
    formant, VQ neighbours and pitch shift."""
    from beatrice_vst_tpu_torch.constants import V20RC0
    from beatrice_vst_tpu_torch.models.io import load_weights
    from beatrice_vst_tpu_torch.runtime.engine import EngineConfig, StreamEngine
    from beatrice_vst_tpu_torch.speakers import bank as bank_mod

    model_dir = os.path.join(HERE, "models_demo", "klatt8")
    params = load_weights(os.path.join(model_dir, "weights.npz"), device=device)
    bank = bank_mod.load(os.path.join(model_dir, "speakers.npz"), V20RC0, device=device)
    cfg = EngineConfig.realtime(capacity, upsampler_kernel=upsampler_kernel,
                                **ENGINE_CONFIGS[config][0])
    engine = StreamEngine(cfg, params, bank, device=device)
    if controls:
        n_spk = bank_mod.n_speakers(bank)
        for i in range(capacity):
            engine.admit()
            engine.set_control(i, "target_speaker", i % n_spk)
            engine.set_control(i, "formant_index", (i // n_spk) % 9)
            engine.set_control(i, "vq_num_neighbors", i % 5)
            engine.set_control(i, "pitch_shift", float((i % 7) - 3))
    return engine


def engine_audio(device):
    """[TICKS, CAPACITY, 480] at 48 kHz on the card: a swept sine (each
    stream its own start frequency) plus noise from a numpy seed."""
    import torch

    rng = np.random.default_rng(1)
    n = np.arange(TICKS * 480) / 48000.0
    f0 = rng.uniform(90.0, 300.0, CAPACITY)[:, None]
    x = 0.3 * np.sin(2 * np.pi * (f0 * n + 150.0 * n * n))
    x = x + 0.02 * rng.standard_normal(x.shape)
    x = x.astype(np.float32).reshape(CAPACITY, TICKS, 480).transpose(1, 0, 2)
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


def golden_check(device, config):
    """The engine's golden run on the card (4 streams x 20 ticks) against
    the JAX engine's output: f32 at atol 1e-3, bf16 by the envelope."""
    from beatrice_vst_tpu_torch import golden

    ref = golden.load(GOLDEN)
    engine = build_engine(device, config, capacity=golden.CAPACITY, controls=False)
    got = golden.run(engine, lambda t: t.cpu().numpy())
    if ENGINE_CONFIGS[config][1] == "bfloat16":
        env = golden.envelope(got, ref)
        if not env["ok"]:
            raise AssertionError(f"{config} outside the golden envelope: {env}")
        return {"envelope": env}
    dev = golden.deviation(got, ref["f32"])
    if not dev["max"] <= golden.F32_ATOL:
        raise AssertionError(f"{config} vs the golden file: max|d| {dev['max']} > "
                             f"{golden.F32_ATOL}")
    return {"vs_golden_f32": dev, "tol": golden.F32_ATOL}


def engine_phase(device, config):
    """One configuration at capacity 256: TICKS ticks with the launch
    counts set to 0 just before and read just after; returns the launches
    of its kernel form."""
    import torch
    from beatrice_vst_tpu_torch.models import fused_upsampler as FU

    t0 = time.perf_counter()
    form = ENGINE_CONFIGS[config][1]
    tol = KERNEL_TOL[form]
    audio = engine_audio(device)
    engine = build_engine(device, config)
    engine.flush_controls()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    finite = []
    kept = []
    tick_ms = []
    host_ms = []
    FU.launches = FU.launches_bf16 = 0
    for k in range(TICKS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        t_host = time.perf_counter()
        out = engine.tick(audio[k])
        host_ms.append((time.perf_counter() - t_host) * 1e3)
        end.record()
        finite.append(torch.isfinite(out).all())
        if k < COMPARE_TICKS:
            kept.append(out.clone())
        tick_ms.append((start, end))
    torch.cuda.synchronize()
    counts = {form_name: getattr(FU, COUNTER[form_name]) for form_name in COUNTER}
    if counts[form] != TICKS or sum(counts.values()) != TICKS:
        raise AssertionError(f"{config}: kernel launches {counts} in {TICKS} ticks, "
                             f"expected {TICKS} of the {form} form only")
    if not bool(torch.stack(finite).all()):
        raise AssertionError(f"{config}: non-finite engine output")
    times = [s.elapsed_time(e) for s, e in tick_ms[WARMUP_TICKS:]]
    median_tick = float(np.median(times))
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    if float(torch.stack([o.abs().max() for o in kept]).max()) <= 1e-3:
        raise AssertionError(f"{config}: engine output is silent")

    plain = build_engine(device, config, upsampler_kernel=False)
    diff = 0.0
    for k in range(COMPARE_TICKS):
        out = plain.tick(audio[k])
        diff = max(diff, float((out - kept[k]).abs().max()))
    if getattr(FU, COUNTER[form]) != counts[form]:
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
    logs = cuda_build.build(["fused_upsampler", V1])
    ptxas = {name: [ln.strip() for ln in text.splitlines() if "registers" in ln or "spill" in ln]
             for name, text in logs.items()}
    log("build", t0, built=sorted(logs), ptxas=ptxas)

    entries = {form: kernel_phase(device, form) for form in KERNEL_NAME}
    for config, (_, form) in ENGINE_CONFIGS.items():
        launches = engine_phase(device, config)
        if config == MAIN_CONFIG[form]:
            entries[form]["launches"] = launches
            entries[form]["main_path"] = config
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
