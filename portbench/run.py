"""Run one cell of the benchmark once and print its result line.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell's driver sets up (counted in
`setup_s`), runs the window for --seconds and, with --trace 1, a profiled
stretch after it.  Then the program's state is freed and the plain
reference, on the card in float64, works out the checked streams' output
from their whole input history; the numbers compared and their limits
are printed last on standard error and last in the result line.

The last line of standard output is one JSON object: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics, or with
--trace 1 its per-layer ones), `device`, with --trace 1 `breakdown`, and
`checks` last.  Without a CUDA card, with fewer cards than the cell asks
for, or with JAX or the JAX package loaded once the window has closed, it
prints no result and exits with a code other than 0.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from . import spec  # noqa: E402
from .reference import compare  # noqa: E402

# top-level module names that no run may load: JAX, and the JAX package
# (the port's name begins with it, so names are compared whole)
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "beatrice_vst_tpu"})
REF_BLOCK = 4  # streams the reference converts at once


@dataclasses.dataclass
class Context:
    """What a driver and a metric reader are given."""

    root: str
    cell: spec.Cell
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t0: float

    @property
    def config(self) -> dict:
        return self.cell.config

    @property
    def traffic(self) -> dict:
        return self.cell.traffic


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def card() -> dict:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError) as e:
        return {"nvidia_smi": f"unavailable: {e}"}
    return {"nvidia_smi": out[0] if out else ""}


def reference_outputs(ctx: Context, check: dict, n: int, precision: str = "float64"):
    """The configuration's reference over the checked streams' histories,
    cut to the n compared samples from check["offset"]: [streams, n]."""
    ref_mod = spec.load_module("reference", ctx.config["reference"])
    weights, bank = ref_mod.load_model(os.path.join(ctx.root, ctx.config["model_dir"]))
    ref = ref_mod.Reference(weights, bank, ctx.config["model"], precision, ctx.device)
    lo = check["offset"]
    rows = []
    for s in range(0, check["audio48"].shape[0], REF_BLOCK):
        sl = slice(s, s + REF_BLOCK)
        y = ref.convert(check["audio48"][sl], {k: v[sl] for k, v in check["controls"].items()})
        rows.append(y[:, lo:lo + n].double().cpu().numpy())
    return np.concatenate(rows)


def limits(ctx: Context) -> dict:
    """The numbers compared and their limits: the configuration's."""
    return dict(ctx.config["correct"])


def judge(ctx: Context, record: dict, log) -> tuple[bool, list]:
    t = time.perf_counter()
    out = record["check"]["out"]
    ref = reference_outputs(ctx, record["check"], out.shape[1])
    found = compare.numbers(out, ref)
    found["failed_ticks"] = record["failed"]
    ok, rows = compare.judge(found, {**limits(ctx), "failed_ticks": 0})
    log(f"reference: {ref.shape[0]} streams x {ref.shape[1]} samples in "
        f"{time.perf_counter() - t:.1f} s; read {found}")
    return ok, rows


def run_cell(root: str, cell: spec.Cell, seed: int, seconds: float, trace: bool, device,
             t0: float, log=None) -> dict:
    """One run of `cell`: its result (the printed line's object)."""
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    ctx = Context(root, cell, seed, seconds, trace, torch.device(device), t0)
    driver = spec.load_module("drivers", cell.traffic["driver"])
    record = driver.run(ctx)
    log(f"setup {record['setup_s']:.3f} s: {record['setup_parts']}; window "
        f"{record['ticks']} ticks in {record['wall_s']:.3f} s")
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = spec.load_module("metrics", m["name"]).read(record, ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    on_card = ctx.device.type == "cuda"
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(ctx.device) if on_card else "cpu",
                   "count": cell.chips, "memory_peak_bytes": record["memory_peak_bytes"]}
    result = {"correct": False, "attempted": record["attempted"], "failed": record["failed"],
              "metrics": metrics, "device": device_info}
    tr = record.get("trace")
    if tr is not None:
        device_info.update(busy_s=tr["busy_s"], window_s=tr["span_s"])
        result["breakdown"] = {"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"]}
    result["setup"] = record["setup_parts"]
    result["window"] = record["window"]
    result["card"] = card() if on_card else {}
    ok, rows = judge(ctx, record, log)
    result["correct"] = ok
    for name, value, limit in rows:
        log(f"check {name}: {value!r} (limit {limit!r})")
    result["checks"] = {name: {"value": value, "limit": limit} for name, value, limit in rows}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = os.getcwd()
    cell = spec.load_cell(spec.load_json(os.path.join(root, "BENCHMARK.json")),
                          args.workload, root)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    result = run_cell(root, cell, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0), T0)
    loaded = forbidden_modules()
    if loaded:
        print(f"portbench: the run loaded {loaded}", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
