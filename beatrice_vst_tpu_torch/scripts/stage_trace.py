"""The chain's stages on the card over an engine's first seconds (the T = 1
slow phase: a fresh engine ticks about 0.4 ms slower for its first 2 to
over 22 s), timed by the tracer's stage marks (`runtime/metrics.py`), for
a full real-time engine (klatt8, 2.0.0-rc.0, every stream a direct
speaker, its slots-mode defaults):

    python -m beatrice_vst_tpu_torch.scripts.stage_trace
        [--capacity 4096] [--dtype bfloat16] [--seconds 40] [--report PATH]

The engine is traced from its first tick; each tick's output is copied
to pinned host memory and waited for.  Reports each stage's and the
engine span's (engine.device) median over the first 2 s and over the
last 10 s, and every second's.  Prints the report as one JSON line and
writes it to --report.  Needs a card.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import time

import numpy as np
import torch

from .. import golden
from ..models.io import load_model_dir
from ..runtime import metrics
from ..runtime.engine import EngineConfig, StreamEngine
from .quality_eval import nvidia_smi

MODEL_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "models_demo", "klatt8")
LOOP = 16  # ticks of input, looped


def build(capacity: int, dtype) -> StreamEngine:
    _, cfg, params, bank = load_model_dir(MODEL_DIR)
    ecfg = EngineConfig.realtime(capacity, spec=cfg.spec, compute_dtype=dtype)
    engine = StreamEngine(ecfg, params, bank, device="cuda")
    speakers = engine.bank["additive"].shape[0]
    for i in range(capacity):
        engine.admit()
        engine.set_control(i, "target_speaker", i % speakers)
    engine.flush_controls()
    return engine


def stage_ms(dump) -> dict:
    """{tick: {stage or "engine.device": ms}} of a dump's device spans."""
    f = {name: i for i, name in enumerate(dump["fields"])}
    out = collections.defaultdict(lambda: collections.defaultdict(float))
    for row in dump["spans"]:
        name = row[f["name"]]
        if name in metrics.STAGES or name == "engine.device":
            out[row[f["tick"]]][name] += (row[f["end_ns"]] - row[f["start_ns"]]) * 1e-6
    return out


def medians(per_tick: list) -> dict:
    names = sorted({k for t in per_tick for k in t})
    return {n: float(np.median([t.get(n, 0.0) for t in per_tick])) for n in names}


def slow_phase(engine: StreamEngine, seconds: float) -> dict:
    cap, n = engine.cfg.capacity, engine.cfg.samples_per_tick
    x = golden.swept_sine(0, cap=cap, ticks=LOOP)
    inputs = torch.from_numpy(x.reshape(cap, LOOP, n).transpose(1, 0, 2).copy()).cuda()
    out = torch.empty((cap, n), pin_memory=True)
    engine.tracing(True)
    t0 = time.perf_counter_ns()
    stages, when = {}, []
    last_dump = t0
    while True:
        out.copy_(engine.tick(inputs[len(when) % LOOP]), non_blocking=True)
        torch.cuda.current_stream().synchronize()
        done = time.perf_counter_ns()
        when.append((done - t0) * 1e-9)  # of tick number len(when) - 1
        end = done - t0 > seconds * 1e9
        if done - last_dump > 1e9 or end:
            stages.update(stage_ms(engine.tracer.dump()))
            last_dump = done
        if end:
            break
    drift = engine.tracing(False)["drift_ns"]
    stages.update(stage_ms(engine.tracer.dump()))

    def over(lo, hi):
        return [stages[k] for k, w in enumerate(when) if lo <= w < hi and k in stages]

    end = when[-1]
    return {"ticks": len(when), "read": len(stages), "drift_ns": drift,
            "missed": engine.tracer.counters["stage_reads_missed"],
            "first_2s": medians(over(0.0, 2.0)), "last_10s": medians(over(end - 10.0, end + 1)),
            "by_second": [medians(over(s, s + 1.0)) for s in range(int(end))]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--capacity", type=int, default=4096)
    ap.add_argument("--dtype", default="bfloat16", choices=("bfloat16", "float32"))
    ap.add_argument("--seconds", type=float, default=40.0)
    ap.add_argument("--report", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("stage_trace: needs a CUDA card", file=sys.stderr)
        return 2
    t = time.perf_counter()
    engine = build(args.capacity, None if args.dtype == "float32" else args.dtype)
    report = {"capacity": args.capacity, "dtype": args.dtype, "nvidia_smi": nvidia_smi(),
              "build_s": time.perf_counter() - t,
              "slow_phase": slow_phase(engine, args.seconds)}
    line = json.dumps(report)
    if args.report:
        os.makedirs(os.path.dirname(os.path.abspath(args.report)), exist_ok=True)
        with open(args.report, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
