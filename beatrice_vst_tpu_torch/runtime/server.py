"""Streaming service: sessions, host-edge conversion and the scheduler
(port of `beatrice_vst_tpu/runtime/server.py`).

A `StreamingServer` owns one batched engine and a 10 ms scheduler loop;
each `StreamSession` is the counterpart of one plugin instance (any client
sample rate and block size), wired through the host-edge primitives:

    client audio (any rate, any block)                 [client thread]
      -> HostResampler (rate -> 48 kHz)
      -> SpscRing (in)                                 lock-free handoff
    scheduler tick (every 10 ms):                      [scheduler thread]
      -> gather 480-sample blocks from all sessions into a pinned buffer
      -> copy to the device (non-blocking) -> engine.tick
      -> copy rows [0, hi) back into a pinned buffer (non-blocking), event
      -> once the event completes: scatter 480-sample outputs -> SpscRing (out)
    client pulls:
      <- SpscRing (out) -> HostResampler (48 kHz -> rate)

A session that has not supplied enough input by tick time contributes
silence for that tick (an underrun) rather than stalling the batch: the
batched form of the reference's try-lock-or-silence rule
(src/vst/processor.cc:129-141).

Where the JAX server leans on asynchronous arrays, this one is explicit:
two pinned input buffers alternate, and the host refills one only after
the event recorded behind its last copy to the device has completed; two
pinned output buffers alternate, so the copy of tick t never overwrites
the rows of tick t-1 before they are scattered.  The host waits for the
device only on the output copy's event.  On the CPU (device="cpu") the
same code runs with ordinary tensors and no events.  With a graph engine
(`StreamEngine(jit=True)` on CUDA) the tick copies the device input into
the graph's static input, replays and returns a fresh copy of the graph's
output, all on the scheduler's stream behind the copy from the pinned
buffer, so each tick's fetch reads that tick's own output.
"""

from __future__ import annotations

import collections
import os
import sys
import threading
import time
import traceback

import numpy as np
import torch

from ..constants import COMMON_SAMPLE_RATE
from ..models import fused_upsampler
from ..native import HostResampler, SpscRing


class StreamSession:
    """One client stream: host-rate edge conversion and ring buffers."""

    def __init__(self, server: "StreamingServer", idx: int, sample_rate: float):
        self.server = server
        self.idx = idx
        self.sample_rate = sample_rate
        resample = sample_rate != COMMON_SAMPLE_RATE
        self._rs_in = HostResampler(sample_rate, COMMON_SAMPLE_RATE) if resample else None
        self._rs_out = HostResampler(COMMON_SAMPLE_RATE, sample_rate) if resample else None
        self.ring_in = SpscRing(1 << 16)
        self.ring_out = SpscRing(1 << 16)
        self.underruns = 0
        self.dropped_in = 0   # client-side samples dropped (ring_in full)
        self.dropped_out = 0  # converted samples dropped (client not pulling)
        self.closed = False

    # -- client side --

    def push(self, audio: np.ndarray) -> None:
        """Feed client-rate audio (float32)."""
        x = np.ascontiguousarray(audio, np.float32)
        if self._rs_in is not None:
            x = self._rs_in.process(x)
        written = self.ring_in.write(x)
        if written < len(x):
            # the client is ahead of real time and the 64k-sample (~1.4 s)
            # ring is full: the newest excess is dropped (the SPSC writer
            # cannot evict the reader's side), and counted
            self.dropped_in += len(x) - written

    def pull(self, n: int) -> np.ndarray:
        """Fetch up to n samples of converted client-rate audio."""
        if self._rs_out is None:
            return self.ring_out.read(n)
        need48 = int(np.ceil(n * COMMON_SAMPLE_RATE / self.sample_rate)) + 4
        x48 = self.ring_out.read(need48)
        if not len(x48):
            return np.zeros(0, np.float32)
        return self._rs_out.process(x48)

    def set_parameter(self, field: str, value) -> None:
        self.server.engine.set_control(self.idx, field, value)

    def close(self) -> None:
        if not self.closed:
            self.closed = True
            self.server._close_session(self)


def _record_event(device: torch.device):
    """An event recorded on the current stream (None on the CPU, where
    every copy has finished when it returns)."""
    if device.type != "cuda":
        return None
    event = torch.cuda.Event()
    event.record()
    return event


class StreamingServer:
    """Owns the engine and the scheduler thread ticking every 10 ms.

    ``pipeline=True`` overlaps host I/O with device work: each tick
    enqueues the engine on this tick's input and its output's copy to the
    host, then scatters the previous tick's output (waiting on its copy's
    event) while the device works.  It costs one tick of latency
    (frames_per_tick * 10 ms).  Either way the copy to the host reads
    only rows [0, hi) up to the highest live session (admission takes the
    lowest free slot), so it scales with the live sessions, not the
    capacity.
    """

    def __init__(self, engine, realtime: bool = True, pipeline: bool = False):
        self.engine = engine
        self.realtime = realtime
        self.pipeline = pipeline
        self.sessions: dict[int, StreamSession] = {}
        self._lock = threading.Lock()
        self._running = False
        self._thread: threading.Thread | None = None
        self._device = engine.device
        shape = (engine.cfg.capacity, engine.cfg.samples_per_tick)
        pin = self._device.type == "cuda"
        self._in_host = [torch.zeros(shape, pin_memory=pin) for _ in range(2)]
        self._in_np = [t.numpy() for t in self._in_host]
        self._in_copied = [None, None]  # event behind the last copy out of each
        self._in_dev = torch.zeros(shape, device=self._device)
        self._out_host = [torch.zeros(shape, pin_memory=pin) for _ in range(2)]
        self._out_np = [t.numpy() for t in self._out_host]
        self._parity = 0
        self._inflight: tuple | None = None  # the fetch of tick t-1
        self._recover_callbacks: list = []
        self._tick_spans = collections.deque(maxlen=1024)  # host ms per tick_once
        self._ticks = 0
        self._started: float | None = None
        self._last_error = ""

    # -- session management --

    def open_session(self, sample_rate: float = 48000.0) -> StreamSession:
        with self._lock:
            idx = self.engine.admit()
            s = StreamSession(self, idx, sample_rate)
            self.sessions[idx] = s
            return s

    def _close_session(self, session: StreamSession) -> None:
        with self._lock:
            self.sessions.pop(session.idx, None)
            self.engine.evict(session.idx)

    # -- scheduler --

    def _fetch(self, out_dev, sessions, buf: int):
        """Enqueue the copy of rows [0, hi) of a tick's output into pinned
        buffer `buf`: (buf, hi, event, sessions)."""
        hi = max((s.idx for s in sessions), default=-1) + 1
        if hi:
            self._out_host[buf][:hi].copy_(out_dev[:hi], non_blocking=True)
        return buf, hi, _record_event(self._device), sessions

    def _scatter(self, buf: int, hi: int, event, sessions) -> None:
        """Wait for a fetched output's copy, then fan it out to its
        sessions' rings."""
        if not hi:
            return
        if event is not None:
            event.synchronize()
        out = self._out_np[buf]
        n = out.shape[1]
        for s in sessions:
            written = s.ring_out.write(out[s.idx])
            if written < n:  # the client is not pulling; newest dropped
                s.dropped_out += n - written

    def tick_once(self) -> None:
        """One scheduler tick: gather inputs, run the engine, scatter.

        In pipeline mode the scatter is of the previous tick's output:
        this tick's device work proceeds while the host distributes tick
        t-1."""
        t0 = time.perf_counter()
        n = self.engine.cfg.samples_per_tick
        with self._lock:
            sessions = list(self.sessions.values())
        buf = self._parity
        self._parity ^= 1
        if self._in_copied[buf] is not None:
            # the copy out of this buffer two ticks ago must be done
            # before the host overwrites it
            self._in_copied[buf].synchronize()
        x = self._in_np[buf]
        x[:] = 0.0
        for s in sessions:
            got = s.ring_in.read(n)
            if len(got) < n:
                s.underruns += 1
            x[s.idx, :len(got)] = got
        self._in_dev.copy_(self._in_host[buf], non_blocking=True)
        self._in_copied[buf] = _record_event(self._device)
        fetched = self._fetch(self.engine.tick(self._in_dev), sessions, buf)
        if self.pipeline:
            fetched, self._inflight = self._inflight, fetched
        if fetched is not None:
            self._scatter(*fetched)
        self._ticks += 1
        self._tick_spans.append((time.perf_counter() - t0) * 1e3)

    def flush_pipeline(self) -> None:
        """Drain the in-flight tick (pipeline mode): scatter its output
        without running another engine tick.  Call before teardown, or
        when manual-ticking (realtime=False) and the last outputs are
        needed now."""
        prev, self._inflight = self._inflight, None
        if prev is not None:
            self._scatter(*prev)

    def tick_period(self) -> float:
        """Seconds between the free-running loop's ticks: the audio a tick
        carries (10 ms per frame), times BEATRICE_TICK_PERIOD_SCALE (default
        1.0; `server.py:186-195`): a host whose tick takes longer than the
        audio it carries is measured with every clock slowed by that factor,
        its clients paced at the same scale."""
        scale = float(os.environ.get("BEATRICE_TICK_PERIOD_SCALE", "1.0"))
        return self.engine.cfg.frames_per_tick * 0.010 * scale

    def _loop(self) -> None:
        period = self.tick_period()
        next_t = time.monotonic()
        while self._running:
            try:
                self.tick_once()
            except Exception as e:  # noqa: BLE001 -- device/runtime failure
                # elastic recovery (SURVEY.md section 5.3): sessions hear
                # one tick of silence, the engine rebuilds its device
                # state, and registered control planes replay parameters
                # (ModelHost re-syncs every session's ParameterState).  A
                # second failure inside recover() ends the thread: the
                # device is gone, not glitched.  The failure is not
                # swallowed: the first occurrence of each message prints a
                # traceback and the message is exported in metrics.
                msg = f"{type(e).__name__}: {e}"
                if msg[:200] != self._last_error[:200]:
                    traceback.print_exc(file=sys.stderr)
                self._last_error = msg
                self.engine.metrics.last_error = msg[:500]
                self._inflight = None  # its output died with the tick
                self.engine.recover()
                for cb in self._recover_callbacks:
                    cb()
            next_t += period
            if self.realtime:
                delay = next_t - time.monotonic()
                if delay > 0:
                    time.sleep(delay)
                else:
                    next_t = time.monotonic()  # fell behind; resync

    def on_recover(self, callback) -> None:
        """Register a control-plane callback run after elastic recovery
        (e.g. replay each session's parameters into the fresh state)."""
        self._recover_callbacks.append(callback)

    @property
    def running(self) -> bool:
        """Whether the scheduler thread is alive."""
        return self._thread is not None and self._thread.is_alive()

    def start(self) -> None:
        if self._running:
            return
        # the scheduler competes for the GIL with a handler and a pump
        # thread per connection; the default 5 ms switch interval lets a
        # busy peer hold the GIL for half a frame budget
        if sys.getswitchinterval() > 0.001:
            sys.setswitchinterval(0.001)
        self._running = True
        self._started = time.monotonic()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._running = False
        if self._thread is not None:
            # wait out the tick in flight: a daemon thread torn down in the
            # middle of CUDA work at interpreter exit can abort the process
            self._thread.join(timeout=60.0)
            self._thread = None
        try:
            self.flush_pipeline()
        except Exception:  # noqa: BLE001
            # after a failure the scheduler recorded (last_error), the
            # device may be gone at teardown; any other failure is raised
            if not self._last_error:
                raise

    def metrics(self) -> dict:
        """The engine's metrics, the sessions' underruns and drops, and the
        scheduler's own: each tick_once's host span (gather to scatter, so
        in plain mode it waits for the tick's output on the device), ticks
        per second since start() (100 is real time at T = 1), and the
        upsampler kernel's launches in this process by form (its counters
        in models/fused_upsampler.py; none on the CPU)."""
        snap = self.engine.metrics_snapshot()
        with self._lock:
            sessions = list(self.sessions.values())
        snap["session_underruns"] = sum(s.underruns for s in sessions)
        snap["session_dropped_in"] = sum(s.dropped_in for s in sessions)
        snap["session_dropped_out"] = sum(s.dropped_out for s in sessions)
        spans = np.asarray(list(self._tick_spans) or [0.0])
        snap["serve_tick_p50_ms"] = float(np.percentile(spans, 50))
        snap["serve_tick_p90_ms"] = float(np.percentile(spans, 90))
        snap["upsampler_kernel_launches"] = {"float32": fused_upsampler.launches,
                                             "bfloat16": fused_upsampler.launches_bf16}
        if self._started is not None:
            snap["serve_ticks_per_s"] = self._ticks / max(time.monotonic() - self._started, 1e-9)
        return snap
