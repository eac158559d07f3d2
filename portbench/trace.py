"""The traced stretch: a few ticks under `torch.profiler` (CUPTI), read
into what the per-layer metrics and the result's `breakdown` need.

Every device activity of the stretch is one of its ticks' (the stream is
idle before it starts).  Its span comes from CUDA events around it; busy
time is the union of the device intervals in it; an idle gap is named by
the innermost host operation running at its middle.
"""

from __future__ import annotations

import collections

import torch

TOP = 10  # entries of each breakdown list


def _union(intervals) -> tuple[float, list]:
    """(total length, merged intervals) of [(start, end)]."""
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return sum(b - a for a, b in merged), merged


def _host_op_at(cpu, t: float) -> str:
    """The shortest host operation whose interval holds time t (us)."""
    best, best_len = "host: no operation", float("inf")
    for name, a, b in cpu:
        if a <= t <= b and b - a < best_len:
            best, best_len = name, b - a
    return best


def read(events, span_s: float, ticks: int) -> dict:
    """The stretch's device record from the profiler's events."""
    device, cpu = [], []
    for e in events:
        interval = (e.name, float(e.time_range.start), float(e.time_range.end))
        if e.device_type == torch.autograd.DeviceType.CUDA:
            device.append(interval)
        elif e.device_type == torch.autograd.DeviceType.CPU:
            cpu.append(interval)
    kernels = [d for d in device if not d[0].startswith(("Memcpy", "Memset"))]
    busy_us, merged = _union((a, b) for _, a, b in device)
    kernel_busy_us, _ = _union((a, b) for _, a, b in kernels)
    by_name = collections.defaultdict(lambda: [0.0, 0])
    for name, a, b in device:
        by_name[name][0] += (b - a) * 1e-6
        by_name[name][1] += 1
    gaps = sorted(((merged[i + 1][0] - merged[i][1], (merged[i + 1][0] + merged[i][1]) / 2)
                   for i in range(len(merged) - 1)), reverse=True)[:TOP]
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:TOP]
    return {
        "ticks": ticks, "span_s": span_s, "busy_s": busy_us * 1e-6,
        "kernel_busy_s": kernel_busy_us * 1e-6, "kernels": len(kernels),
        "by_name": {k: tuple(v) for k, v in by_name.items()},
        "device_ops": [[name[:160], total] for name, (total, _) in top],
        "idle_gaps": [[_host_op_at(cpu, mid)[:160], gap * 1e-6] for gap, mid in gaps],
    }


def profile(tick, ticks: int, device) -> dict | None:
    """Run tick(k) for k < ticks under the profiler; its record, or None
    where there is no card to trace."""
    if device.type != "cuda":
        return None
    from torch.profiler import ProfilerActivity, profile as torch_profile

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(device)
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        for k in range(ticks):
            tick(k)
        end.record()
        torch.cuda.synchronize(device)
    return read(prof.events(), start.elapsed_time(end) * 1e-3, ticks)
