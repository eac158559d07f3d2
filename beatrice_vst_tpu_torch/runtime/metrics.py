"""Per-engine counters and tick-latency percentiles (port of
`beatrice_vst_tpu/runtime/metrics.py`).

Tick times are host wall time around `StreamEngine.tick`.  On CUDA the
tick returns once its work is enqueued, so these are enqueue times unless
the caller synchronises; device times come from CUDA events
(chip_smoke.py).
"""

from __future__ import annotations

import time

import numpy as np

FRAME_BUDGET_S = 0.010


class EngineMetrics:
    def __init__(self, window: int = 1024):
        self.window = window
        self._tick_times: list[float] = []
        self.ticks = 0
        self.frames = 0
        self.underruns = 0
        # the scheduler's last failure, exported so that a recovered fault
        # is visible (`metrics.py:26`; set by server.StreamingServer._loop)
        self.last_error = None
        self.started = time.monotonic()

    def record_tick(self, duration_s: float, n_active: int, frames_per_tick: int) -> None:
        """One tick of `frames_per_tick` frames per active stream: its
        budget is that many 10 ms frames (`metrics.py:29-32`)."""
        self.ticks += 1
        self.frames += n_active * frames_per_tick
        if duration_s > FRAME_BUDGET_S * frames_per_tick:
            self.underruns += 1
        self._tick_times.append(duration_s)
        if len(self._tick_times) > self.window:
            self._tick_times = self._tick_times[-self.window:]

    def snapshot(self, n_active: int) -> dict:
        t = np.asarray(self._tick_times[-self.window:] or [0.0])
        elapsed = max(time.monotonic() - self.started, 1e-9)
        return {
            "ticks": self.ticks,
            "streams_active": n_active,
            "frames_total": self.frames,
            "audio_seconds_total": self.frames * FRAME_BUDGET_S,
            "audio_seconds_per_s": self.frames * FRAME_BUDGET_S / elapsed,
            "tick_p50_ms": float(np.percentile(t, 50)) * 1e3,
            "tick_p99_ms": float(np.percentile(t, 99)) * 1e3,
            "underruns": self.underruns,
            **({"last_error": self.last_error} if self.last_error else {}),
        }
