"""The capacity sweep that fixed the cells' capacities (run once, on the
card; its table is in PERF.md and the capacities in the traffic files).

    python3 -m portbench.sweep --config beatrice2-rc0-bf16 --traffic direct-t1-c4096 \
        [--start 256] [--seconds 10] [--at 8192] [--out chiprun_out/sweep.json]

At one frame a tick: from --start, double; each rung is a fresh engine
with a window of --seconds; stop at the first rung whose tick_p95_ms is
over 95 % of the frame (9.5 ms at T = 1, `bench.py`'s headroom), then try
once the multiple of 256 midway between the last rung that held and that
one.  The capacity is the largest that held.  With --at (T > 1): try that
capacity and halve it until a rung holds (memory and the tick's limit).
No correctness check: the benchmark's runs make it.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from . import spec  # noqa: E402
from .run import Context  # noqa: E402

HEADROOM = 0.95


def rung(root, config, traffic, capacity, seconds, seed) -> dict:
    t0 = time.perf_counter()
    traffic = dict(traffic, capacity=capacity)
    cell = spec.Cell(f"sweep.{capacity}", 1, config, traffic, [], [])
    ctx = Context(root, cell, seed, seconds, False, torch.device("cuda", 0), t0)
    driver = spec.load_module("drivers", traffic["driver"])
    try:
        record = driver.run(ctx)
    except torch.cuda.OutOfMemoryError as e:
        return {"capacity": capacity, "error": f"out of memory: {str(e)[:160]}"}
    finally:
        gc.collect()
        torch.cuda.empty_cache()
    lat = np.asarray(record["latency_ms"])
    limit = traffic["latency_limit_ms"]
    out = {"capacity": capacity, "ticks": record["ticks"],
           "tick_p50_ms": float(np.percentile(lat, 50)),
           "tick_p95_ms": float(np.percentile(lat, 95)),
           "tick_max_ms": float(lat.max()),
           "audio_s_per_s": record["ticks"] * capacity * traffic["frames_per_tick"] * 0.01
           / record["wall_s"],
           "setup_s": record["setup_s"], "setup_parts": record["setup_parts"],
           "memory_peak_bytes": record["memory_peak_bytes"], "failed": record["failed"],
           "window": record["window"]}
    out["held"] = out["tick_p95_ms"] <= HEADROOM * limit
    torch.cuda.reset_peak_memory_stats()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--traffic", required=True)
    ap.add_argument("--start", type=int, default=256)
    ap.add_argument("--at", type=int, default=0)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=20261018)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench.sweep: no CUDA card", file=sys.stderr)
        return 2
    root = os.getcwd()
    config = spec.load_json(os.path.join(spec.HERE, "configs", f"{args.config}.json"))
    traffic = spec.load_json(os.path.join(spec.HERE, "traffic", f"{args.traffic}.json"))
    rungs = []

    def step(c):
        r = rung(root, config, traffic, c, args.seconds, args.seed)
        rungs.append(r)
        print(json.dumps(r), file=sys.stderr, flush=True)
        return r.get("held", False)

    if args.at:
        c = args.at
        while c >= 256 and not step(c):
            c //= 2
    else:
        c, last_held = args.start, 0
        while step(c):
            last_held, c = c, 2 * c
        mid = (last_held + c) // 2 // 256 * 256
        if last_held and last_held < mid < c:
            step(mid)
    held = [r["capacity"] for r in rungs if r.get("held")]
    result = {"config": args.config, "traffic": args.traffic, "seconds": args.seconds,
              "capacity": max(held) if held else None, "rungs": rungs,
              "device": torch.cuda.get_device_name(0)}
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps({k: v for k, v in result.items() if k != "rungs"}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
