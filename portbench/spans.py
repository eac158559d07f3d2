"""The program's own spans in a `--trace 1` run: the traced stretch and
the readers' median.

The cell's driver frees its engine once the window and the profiled
stretch are done, so the first reader that asks builds an engine of its
own, as the driver builds one (`build`), switches its tracer on (no
profiler), ticks it for SETTLE_S (past a fresh engine's slow start; those
spans are dropped), then for at least TRACED_S and TRACED_TICKS,
and puts the tracer's `dump()` under `record["tracer"]`; the engine is
freed before the reference runs.  A program without a tracer gives
`record["tracer"]` None and no stretch (`beatrice_vst_tpu_torch/runtime/
metrics.py` names the spans).  Each reader takes the median over the
stretch's ticks of a tick's summed time in the spans it names."""

from __future__ import annotations

import collections
import gc
import time

import numpy as np
import torch

from . import spec, traffic as traffic_mod

DEVICE = "engine.device"  # a tick's device span: its stages were read
SETTLE_S = 30.0  # ticks traced and dropped before the stretch: a fresh engine
# ticks 4-5 % slower at T = 1 for its first 5 to 22 s on an H100
TRACED_S = 2.0  # the traced stretch: at least this long
TRACED_TICKS = 8  # and at least this many ticks


def _has_tracer() -> bool:
    from beatrice_vst_tpu_torch.runtime.engine import StreamEngine

    return hasattr(StreamEngine, "tracing")


def stretch(ctx) -> dict | None:
    """The traced stretch on an engine built for it: the tracer's dump
    with the stretch's ticks, its settling ticks and the anchor's drift
    (None where the program has no tracer)."""
    if not _has_tracer():
        return None
    traffic, dev = ctx.traffic, ctx.device
    cuda = dev.type == "cuda"
    driver = spec.load_module("drivers", traffic["driver"])
    engine, _, _ = driver.build(ctx)
    inputs = traffic_mod.make_inputs(traffic, ctx.seed, dev, pin=cuda)
    x_dev = torch.empty((traffic["capacity"], traffic["frames_per_tick"] * traffic_mod.EDGE_HOP),
                        device=dev)
    out_host = torch.empty(tuple(inputs.shape[1:]), pin_memory=cuda)
    done = torch.cuda.Event() if cuda else None
    k = 0

    def ticks(least: int, seconds: float) -> int:
        nonlocal k
        n, t0 = 0, time.perf_counter()
        while n < least or time.perf_counter() - t0 < seconds:
            x_dev.copy_(inputs[k % inputs.shape[0]], non_blocking=True)
            out_host.copy_(engine.tick(x_dev), non_blocking=True)
            if cuda:
                done.record()
                done.synchronize()
            n += 1
            k += 1
        return n

    engine.tracing(True)
    settled = ticks(1, SETTLE_S)
    engine.tracer.dump()
    n = ticks(TRACED_TICKS, TRACED_S)
    out = engine.tracer.dump()
    out.update(engine.tracing(False), ticks=n, settle_ticks=settled)
    del engine, inputs, out_host, x_dev
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return out


def traced(record, ctx) -> dict | None:
    """record["tracer"], made by the first reader that asks (`stretch`)."""
    if "tracer" not in record:
        record["tracer"] = stretch(ctx) if ctx is not None else None
    return record["tracer"]


def median_ms(record, names, ctx=None, device: bool = True):
    """The median over the traced ticks of each tick's total ms in the
    spans named `names`: with device, over the ticks whose device span and
    stages were read on the card's clock; None without such spans."""
    tr = traced(record, ctx)
    if not tr or (device and tr["device_clock"] != "cuda_events"):
        return None
    col = {f: i for i, f in enumerate(tr["fields"])}
    name, start, end, tick = col["name"], col["start_ns"], col["end_ns"], col["tick"]
    totals = collections.defaultdict(float)
    ticks = set()
    for row in tr["spans"]:
        if row[name] in names:
            totals[row[tick]] += (row[end] - row[start]) * 1e-6
            if not device:
                ticks.add(row[tick])
        elif device and row[name] == DEVICE:
            ticks.add(row[tick])
    if not ticks:
        return None
    return float(np.median([totals[t] for t in sorted(ticks)]))
