#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one line with its seconds:
  1. env     -- Python, torch and CUDA versions; the card's name and power
                limit from nvidia-smi.
  2. build   -- builds every CUDA kernel of the port from csrc/ with nvcc.
  3. kernel  -- each kernel against its plain PyTorch version on the card,
                at the shapes the engine gives it (capacity 256), on inputs
                made with numpy from a fixed seed; max |d|, the kernel's and
                the plain version's median time (CUDA events) and the bound.
  4. engine  -- the port's StreamEngine at capacity 256 on the card with the
                klatt8 weights (models_demo/klatt8): 200 ticks of a swept
                sine plus noise; every output finite, the kernel launched
                once per tick; the first 20 ticks again through an engine
                forced onto the plain upsampler, compared; median tick time.
  5. profile -- only with `--profile DIR`: where the engine's tick time
                goes (torch.profiler; table and trace written to DIR).
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
TICKS = 200
WARMUP_TICKS = 20
COMPARE_TICKS = 20
KERNEL_TOL = 1e-4  # f32 sums of up to 768 terms in another order
ENGINE_TOL = 1e-4  # the same differences, carried through the upsampler state
# H100 SXM peaks (NVIDIA data sheet): f32 on CUDA cores, HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
HERE = os.path.dirname(os.path.abspath(__file__))


def log(phase, t0, **fields):
    print(json.dumps({"phase": phase, "seconds": round(time.perf_counter() - t0, 3),
                      **fields}), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def median_ms(fn, reps=30, warmup=5):
    """Median of per-call device times from CUDA event pairs."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def upsampler_inputs(b, seed, device):
    """Stage weights, frame features, carries and source features for the
    upsampler head at batch b, from a numpy seed (weights scaled as the
    JAX package initialises them)."""
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
    return up, final, h, states, src


def kernel_phase(device):
    """Kernel vs plain at the engine's capacity; returns the kernels-line
    entry (without launches, which the engine phase counts)."""
    import torch
    from beatrice_vst_tpu_torch.models import fused_upsampler as FU

    t0 = time.perf_counter()
    up, final, h, states, src = upsampler_inputs(CAPACITY, 0, device)
    args = (up, final, h, states, src)
    audio, new_states = FU.fused_upsample(*args)
    torch.cuda.synchronize()
    want_audio, want_states = FU.fused_upsample_reference(*args)
    diffs = [float((audio - want_audio).abs().max())]
    diffs += [float((g - w).abs().max()) for g, w in zip(new_states, want_states)]
    err = max(diffs)
    if not np.isfinite(err) or err > KERNEL_TOL:
        raise AssertionError(f"fused_upsampler vs plain: max|d| {diffs} > {KERNEL_TOL}")
    kernel_ms = median_ms(lambda: FU.fused_upsample(*args))
    plain_ms = median_ms(lambda: FU.fused_upsample_reference(*args))
    flops = FU.flops_per_stream() * CAPACITY
    weights = [t for p in up for t in (p["conv"]["w"], p["conv"]["b"], p["src"]["w"],
                                       p["src"]["b"], p["snake"]["log_alpha"])]
    weights += [final["w"], final["b"]]
    nbytes = sum(t.numel() * 4 for t in [h, *states, *src, *weights, audio, *new_states])
    t_ops, t_bytes = flops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    entry = {
        "name": "fused_upsampler",
        "route": "cuda",
        "source": "beatrice_vst_tpu_torch/csrc/fused_upsampler.cu",
        "replaces": "beatrice_vst_tpu/models/pallas_upsampler.py:203",
        "max_abs_err": err,
        "max_abs_diff": err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": None,  # no single PyTorch call computes this fused head
    }
    log("kernel", t0, batch=CAPACITY, flops=flops, bytes=nbytes, max_abs_diff=err,
        per_output_max_abs_diff=diffs, kernel_ms=kernel_ms, plain_ms=plain_ms,
        bound_ms=entry["bound_ms"], bound_by=entry["bound_by"])
    return entry


def build_engine(device, upsampler_kernel):
    from beatrice_vst_tpu_torch.constants import V20RC0
    from beatrice_vst_tpu_torch.models.io import load_weights
    from beatrice_vst_tpu_torch.runtime.engine import EngineConfig, StreamEngine
    from beatrice_vst_tpu_torch.speakers import bank as bank_mod

    model_dir = os.path.join(HERE, "models_demo", "klatt8")
    params = load_weights(os.path.join(model_dir, "weights.npz"), device=device)
    bank = bank_mod.load(os.path.join(model_dir, "speakers.npz"), V20RC0, device=device)
    engine = StreamEngine(EngineConfig.realtime(CAPACITY, upsampler_kernel=upsampler_kernel),
                          params, bank, device=device)
    n_spk = bank_mod.n_speakers(bank)
    for i in range(CAPACITY):
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


def engine_phase(device):
    import torch
    from beatrice_vst_tpu_torch.models import fused_upsampler as FU

    t0 = time.perf_counter()
    audio = engine_audio(device)
    engine = build_engine(device, upsampler_kernel=True)
    engine.flush_controls()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    finite = []
    kept = []
    tick_ms = []
    host_ms = []
    FU.launches = 0
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
    launches = FU.launches
    if launches != TICKS:
        raise AssertionError(f"fused_upsampler launched {launches} times in {TICKS} ticks")
    if not bool(torch.stack(finite).all()):
        raise AssertionError("non-finite engine output")
    times = [s.elapsed_time(e) for s, e in tick_ms[WARMUP_TICKS:]]
    median_tick = float(np.median(times))
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    if float(torch.stack([o.abs().max() for o in kept]).max()) <= 1e-3:
        raise AssertionError("engine output is silent")

    plain = build_engine(device, upsampler_kernel=False)
    diff = 0.0
    for k in range(COMPARE_TICKS):
        out = plain.tick(audio[k])
        diff = max(diff, float((out - kept[k]).abs().max()))
    if FU.launches != launches:
        raise AssertionError("the plain-upsampler engine launched the kernel")
    if not np.isfinite(diff) or diff > ENGINE_TOL:
        raise AssertionError(f"kernel engine vs plain engine: max|d| {diff} > {ENGINE_TOL}")
    log("engine", t0, capacity=CAPACITY, ticks=TICKS, launches=launches,
        median_tick_ms=median_tick, p90_tick_ms=float(np.percentile(times, 90)),
        median_host_ms=float(np.median(host_ms[WARMUP_TICKS:])),
        implied_streams_per_10ms=CAPACITY * 10.0 / median_tick,
        peak_mib=peak_mib, plain_engine_ticks=COMPARE_TICKS,
        plain_engine_max_abs_diff=diff, tol=ENGINE_TOL)
    return launches


def profile_phase(device, out_dir, ticks=20):
    """Where the engine's tick time goes: `ticks` ticks at capacity 256
    under torch.profiler after warm-up.  Prints device-busy and host time
    per tick, kernel launches per tick and the kernels with the most
    device time; writes the table and a Chrome trace to `out_dir`."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    audio = engine_audio(device)
    engine = build_engine(device, upsampler_kernel=True)
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
    prof.export_chrome_trace(os.path.join(out_dir, "tick_trace.json"))
    table = [{"kernel": k[:120], "ms_per_tick": ms, "launches_per_tick": n} for k, ms, n in rows]
    with open(os.path.join(out_dir, "tick_profile.json"), "w") as f:
        json.dump({"capacity": CAPACITY, "ticks": ticks, "span_ms_per_tick": span_ms,
                   "device_busy_ms_per_tick": busy_ms,
                   "host_ms_per_tick": float(np.median(host)), "kernels": table}, f, indent=1)
    log("profile", t0, capacity=CAPACITY, ticks=ticks, span_ms_per_tick=span_ms,
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
    logs = cuda_build.build(["fused_upsampler"])
    ptxas = {name: [ln.strip() for ln in text.splitlines() if "registers" in ln or "smem" in ln]
             for name, text in logs.items()}
    log("build", t0, built=sorted(logs), ptxas=ptxas)

    entry = kernel_phase(device)
    entry["launches"] = engine_phase(device)
    if "--profile" in sys.argv[1:]:
        profile_phase(device, sys.argv[sys.argv.index("--profile") + 1])

    print(json.dumps({"kernels": [entry]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
