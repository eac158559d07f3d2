"""The port's tracer and the engine's aggregate metrics (the counters and
percentiles began as a port of `beatrice_vst_tpu/runtime/metrics.py`).

**Spans.**  A `Tracer` keeps spans in a preallocated in-memory ring: each
is (id, name, start_ns, end_ns, parent id or -1, tick), on the host's
`time.perf_counter_ns()` clock; every span of one tick carries that
tick's sequence number (the engine's tick count before it).  Tracing is
off until `StreamEngine.tracing(True)`; `Tracer.dump()` hands the spans
out and empties the ring; nothing is written to disk.  Off, a span site
costs one attribute check and records nothing.  The spans:

  engine.tick              `StreamEngine.tick`, host
    engine.flush_controls  the staged edits applied (`flush_controls`)
    engine.launch          copy into the static input, replay, clone
    engine.device          the same on the card's clock (the event pair
                           of `EngineMetrics`, below), tiled by:
      graph_in             from its start to the first stage: the copy into
                           the static input, and the card's wait for the
                           replay's launch where the card is idle
      <stage>              the chain's stages (STAGES), each interval from
                           its `mark` to the next; a stage's time in a
                           tick is the sum of the intervals of its name
      graph_out            from the closing mark to its end: the clone
  serve.tick_once          `StreamingServer.tick_once`, host
    serve.gather           the ring reads into the pinned input, its copy
                           to the card enqueued
    serve.wait_in          the wait for the pinned input's last copy
    serve.engine           `engine.tick`
    serve.wait_out         the wait for the fetched output's copy
    serve.scatter          the ring writes

**Stage marks.**  `mark(name)` (`device.py`) at each stage boundary of
the chain does nothing unless this thread records marks
(`recording_marks`): while the
tick graph's marked twin is captured (`graphs.CompiledStep.marked_twin`,
at the engine's first switch on; each mark an event-record node, which
costs the card about 5 us, so untraced ticks replay the graph without
them), and on an eager tick while tracing is on (CUDA events on a card,
the host clock on the CPU).  A tick's marks are read at the start
of the next tick if the last has completed (`Event.query`), never
waiting; one that cannot be read counts in `stage_reads_missed` (the
pipelined server, whose tick n+1 is enqueued before tick n is done).
Device times go onto the host clock by an anchor taken when tracing is
switched on (a synchronize, the host time, an event): a device mark is at
anchor_ns + elapsed(anchor event, mark).  Switching off takes a second
anchor and reports the drift between the two clocks.  While
`torch.profiler` runs and tracing is on, each host span also opens a
profiler range of its name (function scope, which puts nothing on the
device's track), so the profiler's CPU track carries the program's
spans.

**Counters** (always on, integer adds at the boundaries where the work
is done; `flush_controls` and the mark reader): edits_applied,
rows_reset_context, rows_reset_admitted, morph_rows_refreshed,
kv_rows_refreshed, slot_rows_projected, stage_reads_missed.

**`EngineMetrics.snapshot()`**, the operator's `metrics` op:
  ticks                 ticks run
  streams_active        streams admitted now
  frames_total          10 ms frames converted (streams x T a tick)
  audio_seconds_per_s   frames_total x 10 ms over the seconds since the
                        first tick
  tick_p50_ms, tick_p99_ms  over the last `window` ticks, a tick's engine
                        span: on a card from an event recorded before the
                        copy into the static input to one after the clone
                        of the output (the card's clock, read once done,
                        never waiting); on the CPU the host's time for the
                        tick
  tick_clock            "cuda_events" or "host": the clock of the two above
  underruns             ticks whose engine span exceeded their T x 10 ms
  last_error            the scheduler's last failure, where there was one
and the counters above.
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time

import numpy as np
import torch

from ..device import END

FRAME_BUDGET_S = 0.010
# the chain's stages in the order a tick runs them (`mark`'s names)
STAGES = ("edge_in", "cond", "phone", "vq", "pitch", "wg_in", "wg_conv", "wg_attn", "wg_out",
          "head", "edge_out")
GAPS = ("graph_in", "graph_out")  # engine.device's parts outside the stages
SPAN_FIELDS = ("id", "name", "start_ns", "end_ns", "parent", "tick")
SPAN_RING = 1 << 17  # spans kept between two dumps (the oldest are overwritten)
WINDOW = 1024  # ticks of the aggregate windows
TICK_EVENTS = 8  # event pairs of EngineMetrics in flight
COUNTERS = ("edits_applied", "rows_reset_context", "rows_reset_admitted",
            "morph_rows_refreshed", "kv_rows_refreshed", "slot_rows_projected",
            "stage_reads_missed")


def percentiles(values, qs) -> list:
    """The percentiles qs of `values` (0.0 each where there are none)."""
    if not len(values):
        return [0.0] * len(qs)
    return [float(v) for v in np.percentile(np.asarray(values, dtype=np.float64), qs)]


class _Span:
    """`with tracer.span(...)`: a host span timed always, kept in the
    tracer's window of its name and, while tracing is on, recorded."""

    __slots__ = ("tracer", "name", "tick", "id", "start")

    def __init__(self, tracer, name, tick):
        self.tracer, self.name, self.tick = tracer, name, tick
        self.id = None

    def __enter__(self):
        tr = self.tracer
        if tr.on:
            self.id = tr.begin(self.name, self.tick)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.tracer.keep(self.name, time.perf_counter_ns() - self.start)
        if self.id is not None:
            self.tracer.end(self.id)


class Tracer:
    """Spans and counters of one engine and the server that ticks it (see
    the module docstring).  Spans are recorded by the thread that ticks;
    `switch` and `dump` may be called from any thread."""

    def __init__(self, device="cpu", capacity: int = SPAN_RING, window: int = WINDOW):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.on = False
        self.capacity = capacity
        self._ring = [None] * capacity
        self._n = 0  # spans recorded since the last dump
        self._next_id = 0
        self._open: dict = {}
        self._stack: list = []  # the open spans' ids, innermost last
        # ticks whose stage marks await a read: (tick, parent id, pair, marks)
        self._pending: collections.deque = collections.deque()
        self.counters = dict.fromkeys(COUNTERS, 0)
        self.windows: dict = collections.defaultdict(
            lambda: collections.deque(maxlen=window))
        self._anchor = None  # (host ns, event) on a card
        self.drift_ns = None
        self._lock = threading.Lock()
        self._read_lock = threading.Lock()

    # ---- host spans ----

    def begin(self, name: str, tick: int, parent: int | None = None) -> int:
        """Open a span (tracing on): its id.  Its parent is by default the
        innermost span open on the tracer (-1 where none is)."""
        sid = self._next_id
        self._next_id += 1
        if parent is None:
            parent = self._stack[-1] if self._stack else -1
        self._stack.append(sid)
        scope = None
        if torch.autograd._profiler_enabled():
            # a function-scope range: a user-scope one (record_function)
            # would also put an annotation on the profiler's device track
            scope = torch._C._profiler._RecordFunctionFast(name)
            scope.__enter__()
        self._open[sid] = (name, parent, tick, scope, time.perf_counter_ns())
        return sid

    def end(self, sid: int) -> None:
        t = time.perf_counter_ns()
        name, parent, tick, scope, start = self._open.pop(sid)
        self._stack.remove(sid)
        if scope is not None:
            scope.__exit__(None, None, None)
        self._put((sid, name, start, t, parent, tick))

    @contextlib.contextmanager
    def opened(self, name: str, tick: int):
        """A span open for the context's extent (tracing on), closed also
        where the context raises: yields its id."""
        sid = self.begin(name, tick)
        try:
            yield sid
        finally:
            self.end(sid)

    def span(self, name: str, tick: int) -> _Span:
        """A context timing the span always (its window) and recording it
        while tracing is on (`begin`, `end`)."""
        return _Span(self, name, tick)

    def keep(self, name: str, ns: int) -> None:
        """Add one duration to the window of `name`."""
        self.windows[name].append(ns)

    def window_ms(self, name: str, qs=(50, 90)) -> list:
        return [v * 1e-6 for v in percentiles(list(self.windows.get(name, ())), qs)]

    def _put(self, span: tuple) -> None:
        with self._lock:
            self._ring[self._n % self.capacity] = span
            self._n += 1

    def record(self, name: str, start_ns: int, end_ns: int, parent: int, tick: int) -> int:
        """Record a finished span: its id."""
        sid = self._next_id
        self._next_id += 1
        self._put((sid, name, start_ns, end_ns, parent, tick))
        return sid

    # ---- the device's clock ----

    def switch(self, on: bool) -> dict:
        """Turn tracing on or off; each switch on takes a new anchor, each
        switch off a second one: {"drift_ns"} (the first anchor's
        prediction of the host time minus the host time; None on the CPU)."""
        with self._lock:
            if on == self.on:
                return {"drift_ns": self.drift_ns}
            if not self.cuda:
                self.on = on
                return {"drift_ns": None}
            torch.cuda.synchronize(self.device)
            host = time.perf_counter_ns()
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            if on:
                self._anchor = (host, event)
                self.drift_ns = None
                self.on = True
                return {"drift_ns": None}
            event.synchronize()
            self.on = False
        self.read_marks()
        a_host, a_event = self._anchor
        self.drift_ns = a_host + round(a_event.elapsed_time(event) * 1e6) - host
        return {"drift_ns": self.drift_ns}

    def _device_ns(self, event) -> int:
        a_host, a_event = self._anchor
        return a_host + round(a_event.elapsed_time(event) * 1e6)

    # ---- the chain's stages ----

    def pend(self, tick: int, parent: int, pair, marks) -> None:
        """A tick's device span (its pair of stamps) and stage marks, to be
        read once they are done."""
        self._pending.append((tick, parent, pair, marks))

    def read_marks(self, drop: bool = False) -> None:
        """Turn the pending ticks whose stamps are done into spans, without
        waiting; with drop, count the rest in stage_reads_missed and forget
        them (their events are about to be recorded again)."""
        with self._read_lock:
            self._read_marks(drop)

    def _read_marks(self, drop: bool) -> None:
        while self._pending:
            tick, parent, (start, end), marks = self._pending[0]
            if self.cuda and not (end.query() and marks[-1][1].query()):
                break
            self._pending.popleft()
            if self.cuda:
                t0 = self._device_ns(start)
                stamps = [t0 + round(start.elapsed_time(ev) * 1e6) for _, ev in marks]
                end = t0 + round(start.elapsed_time(end) * 1e6)
            else:
                t0, stamps = start, [ns for _, ns in marks]
            device = self.record("engine.device", t0, end, parent, tick)
            if not stamps:
                continue
            self.record(GAPS[0], t0, stamps[0], device, tick)
            for (name, _), a, b in zip(marks, stamps, stamps[1:]):
                self.record(name, a, b, device, tick)
            self.record(GAPS[1], stamps[-1], end, device, tick)
        if drop and self._pending:
            self.counters["stage_reads_missed"] += len(self._pending)
            self._pending.clear()

    # ---- out ----

    def dump(self) -> dict:
        """Hand out the spans recorded since the last dump, oldest first
        (rows of SPAN_FIELDS; `dropped` counts those the ring overwrote),
        and empty the ring; with the counters and the clock's anchor."""
        self.read_marks()
        with self._lock:
            n = min(self._n, self.capacity)
            spans = [list(self._ring[i % self.capacity]) for i in range(self._n - n, self._n)]
            dropped = self._n - n
            self._n = 0
        return {"fields": list(SPAN_FIELDS), "spans": spans, "dropped": dropped,
                "counters": dict(self.counters), "clock": "perf_counter_ns",
                "device_clock": "cuda_events" if self.cuda else "host",
                "drift_ns": self.drift_ns}


class EngineMetrics:
    """The engine's aggregate view (the `metrics` op: see the module
    docstring) and its `tracer`.  Ticks and frames are counted as a tick
    is issued; its time joins the window once it is known (on a card when
    its event pair has completed, read at a later tick or snapshot)."""

    def __init__(self, window: int = WINDOW, device="cpu"):
        self.window = window
        self.tracer = Tracer(device, window=window)
        self.cuda = self.tracer.cuda
        self._tick_times: collections.deque = collections.deque(maxlen=window)
        self.ticks = 0
        self.frames = 0
        self.underruns = 0
        # the scheduler's last failure, exported so that a recovered fault
        # is visible (`metrics.py:26`; set by server.StreamingServer._loop)
        self.last_error = None
        self.started = None  # time.monotonic() at the first tick
        self._pairs = None  # TICK_EVENTS event pairs, made at the first tick
        self._issued = 0
        self._inflight: collections.deque = collections.deque()  # (slot, frames_per_tick)
        self._lock = threading.Lock()

    def record_tick(self, duration_s: float, n_active: int, frames_per_tick: int) -> None:
        """One tick of `frames_per_tick` frames per active stream that took
        duration_s: its budget is that many 10 ms frames (`metrics.py:29-32`)."""
        self.count_tick(n_active, frames_per_tick)
        self.tick_time(duration_s, frames_per_tick)

    def count_tick(self, n_active: int, frames_per_tick: int) -> None:
        if self.started is None:
            self.started = time.monotonic()
        self.ticks += 1
        self.frames += n_active * frames_per_tick

    def tick_time(self, duration_s: float, frames_per_tick: int) -> None:
        with self._lock:
            self._add_time(duration_s, frames_per_tick)

    def _add_time(self, duration_s: float, frames_per_tick: int) -> None:
        if duration_s > FRAME_BUDGET_S * frames_per_tick:
            self.underruns += 1
        self._tick_times.append(duration_s)

    def begin_tick(self):
        """Stamp a tick's start, before the copy into the static input: an
        event on the current stream on a card (with its slot and stream),
        host ns on the CPU."""
        if not self.cuda:
            return time.perf_counter_ns()
        if self._pairs is None:
            self._pairs = [(torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True)) for _ in range(TICK_EVENTS)]
        with self._lock:
            if len(self._inflight) == TICK_EVENTS:
                # every pair still in flight: the oldest tick goes untimed
                self._inflight.popleft()
            slot = self._issued % TICK_EVENTS
            self._issued += 1
        # one lookup of the stream for both events (it costs more than a record)
        stream = torch.cuda.current_stream(self.tracer.device)
        self._pairs[slot][0].record(stream)
        return slot, stream

    def end_tick(self, stamp, n_active: int, frames_per_tick: int):
        """Stamp the tick's end (after the output's clone) and count it:
        the pair of stamps (events, or host ns).  Then time the earlier
        ticks that have completed: here, after the replay's launch, the
        reads overlap the card's work (before it, the card would wait for
        them)."""
        self.count_tick(n_active, frames_per_tick)
        if not self.cuda:
            now = time.perf_counter_ns()
            self.tick_time((now - stamp) * 1e-9, frames_per_tick)
            return stamp, now
        slot, stream = stamp
        pair = self._pairs[slot]
        pair[1].record(stream)
        with self._lock:
            self._inflight.append((slot, frames_per_tick))
        self.read_ticks()
        return pair

    def read_ticks(self) -> None:
        """Time the ticks whose event pairs have completed, without waiting."""
        with self._lock:
            while self._inflight:
                slot, fpt = self._inflight[0]
                start, end = self._pairs[slot]
                if not end.query():
                    break
                self._inflight.popleft()
                self._add_time(start.elapsed_time(end) * 1e-3, fpt)

    def snapshot(self, n_active: int) -> dict:
        if self.cuda:
            self.read_ticks()
        with self._lock:
            t = list(self._tick_times)
        p50, p99 = percentiles(t, (50, 99))
        elapsed = max(time.monotonic() - self.started, 1e-9) if self.started is not None else None
        return {
            "ticks": self.ticks,
            "streams_active": n_active,
            "frames_total": self.frames,
            "audio_seconds_per_s": self.frames * FRAME_BUDGET_S / elapsed if elapsed else 0.0,
            "tick_p50_ms": p50 * 1e3,
            "tick_p99_ms": p99 * 1e3,
            "tick_clock": "cuda_events" if self.cuda else "host",
            "underruns": self.underruns,
            **({"last_error": self.last_error} if self.last_error else {}),
        }
