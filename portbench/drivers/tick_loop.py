"""The real-time tick, back to back: `StreamEngine.tick` with jit=True (on a
card the captured CUDA graph of `donated_tick`, `flush_controls` in front
of it) over every stream of a full engine.

Each tick of the window copies its input [capacity, T*480] from pinned
host memory, ticks, copies the output back to pinned host memory and
waits for that copy.  Nothing is paced and nothing is dispatched ahead,
so the card sets the pace and a tick's span is the time a frame spends in
the engine: the served path's tick (`runtime/server.py` `tick_once`)
without its rings, its pacing and its pipeline.  While a tick runs, the
host checks the previous tick's output (finite, not silent) and keeps the
checked streams' rows.

Set-up: load the model, build the engine (its graph captured), admit every
stream with its controls, make the input loop, run the warm-up ticks.
"""

from __future__ import annotations

import gc
import hashlib
import os
import time

import numpy as np
import torch

from .. import flops, traffic as traffic_mod

CHECK_STRIDE = 30  # every 30th sample of every stream is checked each tick
MIN_TICKS = 2  # the comparison's spectra need two frames


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 22), b""):
            h.update(chunk)
    return h.hexdigest()


def check_widths(model_cfg, want: dict) -> None:
    """Raise unless the engine's chain has the configuration file's widths."""
    spec, ph, pi, wg = model_cfg.spec, model_cfg.phone, model_cfg.pitch, model_cfg.wg
    got = {
        "phone_channels": spec.phone_channels, "pitch_bins": spec.pitch_bins,
        "codebook_size": spec.codebook_size, "kv_length": spec.kv_length,
        "kv_channels": spec.kv_channels, "hidden_channels": spec.hidden_channels,
        "phone": {"win": ph.win, "n_mels": ph.n_mels, "hidden": ph.hidden, "kernel": ph.kernel,
                  "dilations": list(ph.dilations)},
        "pitch": {"win": pi.win, "n_mels": pi.n_mels, "hidden": pi.hidden, "kernel": pi.kernel,
                  "dilations": list(pi.dilations), "features": want["pitch"]["features"]},
        "wg": {"hidden": wg.hidden, "n_blocks": wg.n_blocks, "kernel": wg.kernel,
               "attn_dim": wg.attn_dim, "n_harmonics": wg.n_harmonics,
               "noise_salt": wg.noise_salt, "upsample": [list(u) for u in wg.upsample],
               "up_kernel": wg.up_kernel},
    }
    if got != want:
        raise RuntimeError(f"the engine's widths {got} differ from the configuration's {want}")


class Clock:
    """A tick's marks on the device's clock (CUDA events) on a card, on the
    host's clock on the CPU (tests only): its start, the input on the
    card, the engine's output ready, the output on the host."""

    MARKS = 4

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        if self.cuda:
            self.events = [[torch.cuda.Event(enable_timing=True) for _ in range(self.MARKS)]
                           for _ in range(2)]
        self.t = [[0.0] * self.MARKS for _ in range(2)]

    def mark(self, b, i):
        if self.cuda:
            self.events[b][i].record()
        else:
            self.t[b][i] = time.perf_counter()

    def wait_ms(self, b) -> list:
        """Wait for tick b's output on the host: the ms between its marks,
        [copy in, engine, copy out]."""
        if self.cuda:
            ev = self.events[b]
            ev[-1].synchronize()
            return [ev[i].elapsed_time(ev[i + 1]) for i in range(self.MARKS - 1)]
        self.t[b][-1] = time.perf_counter()
        return [(self.t[b][i + 1] - self.t[b][i]) * 1e3 for i in range(self.MARKS - 1)]


def window_summary(parts_ms, latency_ms, host_ms, post_ms, period_s) -> dict:
    """Where a window's tick went, in ms: each part's median and 95th
    percentile on the card's clock (copy in, engine, copy out, the whole
    span), the host's time in `tick` and in the check of an output, and
    the mean period from one tick's start to the next's."""
    def pct(x):
        return [float(np.percentile(x, 50)), float(np.percentile(x, 95))]

    names = ("copy_in", "engine", "copy_out")
    out = {name: pct(parts_ms[:, i]) for i, name in enumerate(names)}
    out.update(span=pct(latency_ms), host_tick=pct(host_ms), host_check=pct(post_ms),
               period=period_s * 1e3)
    return out


def build(ctx):
    """The engine with every stream admitted and its controls set, and the
    controls: (engine, controls {field: [capacity]}, parts {name: s})."""
    from beatrice_vst_tpu_torch.models.io import load_model_dir
    from beatrice_vst_tpu_torch.runtime.engine import EngineConfig, StreamEngine

    config, traffic, dev = ctx.config, ctx.traffic, ctx.device
    parts = {}
    t = time.perf_counter()
    model_dir = os.path.join(ctx.root, config["model_dir"])
    for name, digest in config["weights_sha256"].items():
        if _sha256(os.path.join(model_dir, name)) != digest:
            raise RuntimeError(f"{model_dir}/{name} is not the configuration's file")
    _, _, params, bank = load_model_dir(model_dir)
    if bank["additive"].shape[0] != config["n_speakers"]:
        raise RuntimeError(f"{model_dir}: {bank['additive'].shape[0]} speakers, "
                           f"expected {config['n_speakers']}")
    parts["load_s"] = time.perf_counter() - t
    t = time.perf_counter()
    cfg = EngineConfig.realtime(traffic["capacity"], frames_per_tick=traffic["frames_per_tick"],
                                **config["engine"])
    check_widths(cfg.model, config["model"])
    engine = StreamEngine(cfg, params, bank, device=dev, jit=True)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    parts["engine_s"] = time.perf_counter() - t
    parts["capture_ms"] = float(getattr(engine, "capture_ms", 0.0))
    t = time.perf_counter()
    controls = traffic_mod.stream_controls(traffic, config["n_speakers"], ctx.seed)
    for s in range(traffic["capacity"]):
        idx = engine.admit()
        for field, values in controls.items():
            engine.set_control(idx, field, values[s])
    engine.flush_controls()
    parts["admission_s"] = time.perf_counter() - t
    return engine, controls, parts


def run(ctx) -> dict:
    """Set up, warm up, run the window (and with ctx.trace a profiled
    stretch after it); return the run's record (see run.py)."""
    traffic, dev = ctx.traffic, ctx.device
    cap, t_frames = traffic["capacity"], traffic["frames_per_tick"]
    cuda = dev.type == "cuda"
    engine, controls, parts = build(ctx)

    t = time.perf_counter()
    inputs = traffic_mod.make_inputs(traffic, ctx.seed, dev, pin=cuda)
    loop = inputs.shape[0]
    x_dev = torch.empty((cap, t_frames * traffic_mod.EDGE_HOP), device=dev)
    out_host = [torch.empty(tuple(inputs.shape[1:]), pin_memory=cuda) for _ in range(2)]
    parts["traffic_s"] = time.perf_counter() - t

    def tick(k, b, clock):
        clock.mark(b, 0)
        x_dev.copy_(inputs[k % loop], non_blocking=True)
        clock.mark(b, 1)
        h0 = time.perf_counter()
        out = engine.tick(x_dev)
        host_s = time.perf_counter() - h0
        clock.mark(b, 2)
        out_host[b].copy_(out, non_blocking=True)
        clock.mark(b, 3)
        return host_s

    t = time.perf_counter()
    clock = Clock(dev)
    warm = traffic["warmup_ticks"]
    for k in range(warm):
        tick(k, 0, clock)
        clock.wait_ms(0)
    parts["warmup_s"] = time.perf_counter() - t
    setup_s = time.perf_counter() - ctx.t0

    rows = traffic_mod.check_rows(traffic, ctx.seed)
    kept, parts_ms, host_ms, post_ms = [], [], [], []
    failed = 0

    def post(b):
        nonlocal failed
        t_post = time.perf_counter()
        o = out_host[b].numpy()
        mine = o[rows]
        kept.append(mine)
        probe = o[:, ::CHECK_STRIDE]
        bad = (not np.isfinite(probe).all() or not np.isfinite(mine).all()
               or (np.abs(probe).max(axis=1) == 0).any() or (np.abs(mine).max(axis=1) == 0).any())
        failed += int(bad)
        post_ms.append((time.perf_counter() - t_post) * 1e3)

    n = 0
    pending = None
    # no collector pauses inside the window: the run's own garbage waits
    gc.collect()
    gc.disable()
    try:
        t_w0 = time.perf_counter()
        while True:
            b = n % 2
            host_ms.append(tick(warm + n, b, clock) * 1e3)
            if pending is not None:
                post(pending)
            parts_ms.append(clock.wait_ms(b))
            pending = b
            n += 1
            if n >= MIN_TICKS and time.perf_counter() - t_w0 >= ctx.seconds:
                break
        wall_s = time.perf_counter() - t_w0
    finally:
        gc.enable()
    post(pending)
    parts_ms = np.asarray(parts_ms)
    latency_ms = parts_ms.sum(axis=1)

    trace = None
    if ctx.trace:
        from .. import trace as trace_mod

        def profiled(k):
            tick(warm + n + k, 0, clock)
            clock.wait_ms(0)

        trace = trace_mod.profile(profiled, traffic["trace_ticks"], dev)

    record = {
        "setup_s": setup_s, "setup_parts": parts, "ticks": n, "wall_s": wall_s,
        "latency_ms": latency_ms.tolist(), "host_ms": host_ms, "attempted": n, "failed": failed,
        "window": window_summary(parts_ms, latency_ms, host_ms, post_ms, wall_s / n),
        "capacity": cap, "frames_per_tick": t_frames, "trace": trace,
        "flops_per_tick": flops.flops_per_tick(ctx.config["model"], cap, t_frames),
        "memory_peak_bytes": torch.cuda.max_memory_allocated(dev) if cuda else 0,
    }
    # the program's state goes before the reference runs
    sample = traffic_mod.history(inputs, rows, warm + n)
    del engine, inputs, out_host, x_dev
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    record["check"] = {
        "audio48": sample,
        "controls": {k: v[rows] for k, v in controls.items()},
        "out": np.concatenate(kept, axis=1),
        "offset": warm * t_frames * traffic_mod.EDGE_HOP,
        "rows": rows.tolist(),
    }
    return record
