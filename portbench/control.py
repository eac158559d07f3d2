"""The control of a cell's correctness check: the configuration's
reference computed in the precision below the one it states (its
"control": fp8 for bf16, TF32 for f32 with TF32 off), put in the
program's place on the cell's own inputs and judged as a run's output is.
It has to come out not correct; its readings set the upper end of each
limit (PERF.md).  Not run by the benchmark's runs.

    python3 -m portbench.control --workload <name> --seeds 1,2,3 --ticks <n>

--ticks: the window's ticks in a run of the cell, so that the checked
histories are as long as a run's.  Prints one JSON line per seed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

from . import spec, traffic as traffic_mod
from .reference import compare
from .run import Context, limits, reference_outputs


def readings(ctx: Context, ticks: int, precision: str) -> dict:
    """The compared numbers of `precision`'s reference against float64 on
    the cell's inputs for ctx.seed, over `ticks` window ticks."""
    traffic = ctx.traffic
    inputs = traffic_mod.make_inputs(traffic, ctx.seed, ctx.device, pin=False)
    rows = traffic_mod.check_rows(traffic, ctx.seed)
    warm = traffic["warmup_ticks"]
    controls = traffic_mod.stream_controls(traffic, ctx.config["n_speakers"], ctx.seed)
    n = ticks * traffic["frames_per_tick"] * traffic_mod.EDGE_HOP
    check = {"audio48": traffic_mod.history(inputs, rows, warm + ticks),
             "controls": {k: v[rows] for k, v in controls.items()},
             "offset": warm * traffic["frames_per_tick"] * traffic_mod.EDGE_HOP}
    del inputs
    return compare.numbers(reference_outputs(ctx, check, n, precision),
                           reference_outputs(ctx, check, n))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--ticks", type=int, required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    root = os.getcwd()
    cell = spec.load_cell(spec.load_json(os.path.join(root, "BENCHMARK.json")),
                          args.workload, root)
    for seed in (int(s) for s in args.seeds.split(",")):
        ctx = Context(root, cell, seed, 0.0, False, torch.device(args.device), 0.0)
        found = readings(ctx, args.ticks, cell.config["control"])
        ok, _ = compare.judge(found, limits(ctx))
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": cell.config["control"], "ticks": args.ticks,
                          "correct": ok, "readings": found}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
