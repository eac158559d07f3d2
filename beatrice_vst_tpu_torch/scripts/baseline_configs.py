"""BASELINE.json's evaluation configurations on the port (counterpart of
the repo's `scripts/baseline_configs.py`, which runs the JAX package).

    python -m beatrice_vst_tpu_torch.scripts.baseline_configs
        [--device cuda] [--report docs/TORCH_BASELINE_CONFIGS_REPORT.json]

  #1 single-utterance offline conversion, one target speaker: 2 s at
     48 kHz, speaker 3, 4 VQ neighbours (`convert_utterance`, compiled;
     `compile_seconds` is the first call, its captures included, and the
     second call is the number)
  #2 streaming frame by frame, one admitted stream in the real-time engine
     (capacity 64 in bf16 on `cuda`, 2 in f32 on the CPU): after 20
     settling ticks, 100 isolated ticks each timed to its completion
     (`torch.cuda.synchronize`), then 100 ticks back to back (amortized)
  #3 the pitch/formant sweep: four (pitch, formant) pairs on 0.5 s against
     the neutral conversion (`differs_from_neutral`: max |d| > 1e-3)
  #4 256 concurrent streams over 16 speakers, pitch shifts -12..+11: 100
     ticks on `cuda`, 5 on the CPU
  #5 multi-host: `beatrice_vst_tpu_torch.scripts.multihost_smoke` and
     `chip_smoke.py --nccl-ranks N`

The engines tick compiled (`StreamEngine(jit=True)`, one CUDA graph on the
card), as the service runs them.  Weights: `chain.init` at seed 0 and
`random_bank` at seed 1 with 16 speakers, drawn through their modules (a
test swaps in the JAX package's draws).  Prints one JSON report with the
JAX script's keys, `device` holding nvidia-smi's name and power limit on
a card, and writes it to --report.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from ..constants import V20RC0
from ..device import resolve_device
from ..models import chain
from ..runtime.engine import EngineConfig, StreamEngine
from ..runtime.offline import ConversionSettings, convert_utterance
from ..speakers import bank as bank_mod
from .quality_eval import card_line

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
REPORT = os.path.join(REPO, "docs", "TORCH_BASELINE_CONFIGS_REPORT.json")
SR = 48000
N_SPEAKERS = 16
SWEEP = ((6.0, 0.0), (-6.0, 0.0), (0.0, 1.5), (12.0, -2.0))  # (pitch, formant)
MULTIHOST = ("see beatrice_vst_tpu_torch/scripts/multihost_smoke.py (two torch.distributed "
             "processes, a state sharded over one ('streams', 'model') mesh, one tick and a "
             "global reduction) and chip_smoke.py --nccl-ranks N (the compiled mesh steps "
             "across N cards)")


def draws(device):
    """(model config, params, bank): the configurations' weights, drawn
    through their modules from CPU generators at seeds 0 and 1."""
    dev = resolve_device(device)
    cfg = chain.VoiceConverterConfig.for_version(V20RC0)
    params = chain.init(torch.Generator().manual_seed(0), cfg, dev)
    bank = bank_mod.random_bank(torch.Generator().manual_seed(1), V20RC0, N_SPEAKERS,
                                device=dev)
    return cfg, params, bank


def utterance() -> np.ndarray:
    """2 s of a 180 Hz tone at 48 kHz with a 3 Hz tremolo."""
    t = np.arange(SR * 2) / SR
    return (0.3 * np.sin(2 * np.pi * 180 * t)
            * (1 + 0.3 * np.sin(2 * np.pi * 3 * t))).astype(np.float32)


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def config1_offline(cfg, params, bank, utt, device):
    """#1 -> (report entry, the output)."""
    dev = resolve_device(device)
    settings = ConversionSettings(target_speaker=3, vq_num_neighbors=4)
    t0 = time.perf_counter()
    out = convert_utterance(params, cfg, bank, utt, SR, settings, device=dev)
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = convert_utterance(params, cfg, bank, utt, SR, settings, device=dev)
    dt = time.perf_counter() - t0
    return {
        "audio_seconds": 2.0,
        "wall_seconds": round(dt, 3),
        "compile_seconds": round(compile_s, 1),
        "speedup_vs_realtime": round(2.0 / dt, 1),
        "finite": bool(np.isfinite(out).all()),
    }, out


def config2_stream_latency(cfg, params, bank, utt, device, capacity: int | None = None):
    """#2 -> (report entry, the last tick's output [capacity, 480])."""
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    ecfg = EngineConfig.realtime(capacity or (64 if cuda else 2), V20RC0,
                                 compute_dtype="bfloat16" if cuda else None)
    eng = StreamEngine(ecfg, params, bank, device=dev, jit=True)
    eng.admit()
    x = torch.as_tensor(np.tile(utt[:480], (ecfg.capacity, 1)), device=dev)
    o = eng.tick(x)
    _sync(dev)
    for _ in range(20):  # settle
        o = eng.tick(x)
    _sync(dev)
    times = []
    for _ in range(100):
        t0 = time.perf_counter()
        o = eng.tick(x)
        _sync(dev)
        times.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    for _ in range(100):
        o = eng.tick(x)
    _sync(dev)
    amortized = (time.perf_counter() - t0) / 100
    return {
        "p50_ms": round(float(np.percentile(times, 50)) * 1e3, 3),
        "p99_ms": round(float(np.percentile(times, 99)) * 1e3, 3),
        "amortized_tick_ms": round(amortized * 1e3, 3),
        "frame_budget_ms": 10.0,
        "under_budget": bool(amortized < 0.010),
        "note": (f"capacity {ecfg.capacity}, {ecfg.compute_dtype or 'float32'}, one stream "
                 "admitted, the compiled tick; isolated p50/p99: each tick timed to its "
                 "completion on the host's clock; amortized: 100 ticks back to back, then "
                 "one synchronize"),
    }, o.cpu().numpy()


def config3_control_sweep(cfg, params, bank, utt, device):
    """#3 -> (report entries, {"neutral": output, (pitch, formant): output})."""
    dev = resolve_device(device)
    half = utt[: SR // 2]
    outs = {"neutral": np.asarray(convert_utterance(
        params, cfg, bank, half, SR, ConversionSettings(target_speaker=1), device=dev))}
    sweep = []
    for shift, formant in SWEEP:
        y = np.asarray(convert_utterance(
            params, cfg, bank, half, SR,
            ConversionSettings(target_speaker=1, pitch_shift=shift, formant_shift=formant),
            device=dev))
        outs[(shift, formant)] = y
        sweep.append({
            "pitch_shift": shift, "formant_shift": formant,
            "finite": bool(np.isfinite(y).all()),
            "differs_from_neutral": bool(np.abs(y - outs["neutral"]).max() > 1e-3),
        })
    return sweep, outs


def config4_256_streams(cfg, params, bank, utt, device, capacity: int = 256,
                        ticks: int | None = None):
    """#4 -> (report entry, the last tick's output [capacity, 480])."""
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    ecfg = EngineConfig.realtime(capacity, V20RC0, compute_dtype="bfloat16" if cuda else None)
    eng = StreamEngine(ecfg, params, bank, device=dev, jit=True)
    for i in range(capacity):
        s = eng.admit()
        eng.set_control(s, "target_speaker", np.int32(i % N_SPEAKERS))
        eng.set_control(s, "pitch_shift", np.float32((i % 24) - 12))
    x = torch.as_tensor(np.tile(utt[:480], (capacity, 1)), device=dev)
    o = eng.tick(x)
    _sync(dev)
    n = ticks or (100 if cuda else 5)
    t0 = time.perf_counter()
    for _ in range(n):
        o = eng.tick(x)
    _sync(dev)
    tick = (time.perf_counter() - t0) / n
    return {
        "tick_ms": round(tick * 1e3, 3),
        "realtime": bool(tick < 0.010),
        "audio_sec_per_s": round(capacity * 0.01 / tick, 1),
    }, o.cpu().numpy()


def run(device="cuda", capacity2: int | None = None, capacity4: int = 256,
        ticks4: int | None = None) -> tuple[dict, dict]:
    """Every configuration -> (the report, each configuration's output)."""
    dev = resolve_device(device)
    cfg, params, bank = draws(dev)
    utt = utterance()
    report = {"device": card_line(dev)}
    outputs = {}
    report["config1_offline"], outputs[1] = config1_offline(cfg, params, bank, utt, dev)
    report["config2_stream_latency"], outputs[2] = config2_stream_latency(
        cfg, params, bank, utt, dev, capacity2)
    report["config3_control_sweep"], outputs[3] = config3_control_sweep(cfg, params, bank, utt,
                                                                        dev)
    report["config4_256_streams"], outputs[4] = config4_256_streams(
        cfg, params, bank, utt, dev, capacity4, ticks4)
    report["config5_multihost"] = MULTIHOST
    return report, outputs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--report", default=REPORT)
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report, _ = run(args.device)
    os.makedirs(os.path.dirname(os.path.abspath(args.report)), exist_ok=True)
    with open(args.report, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
