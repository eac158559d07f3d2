"""Device selection for the port's entry points, the constants a
captured CUDA graph keeps alive (`pin`), the counts of the hand-written
kernels' launches (`count_launch`), and the chain's stage marks (`mark`,
read by the tracer in `runtime/metrics.py`)."""

from __future__ import annotations

import collections
import contextlib
import threading
import time

import torch


def resolve_device(device="cuda") -> torch.device:
    """The torch device an entry point runs on.

    Entry points default to `cuda`; the CPU is used only when the caller
    asks for it (`device="cpu"`, as the tests do).  Asking for CUDA where
    there is none raises: there is no silent fallback to the CPU.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA device was requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}; use 'cuda' or 'cpu'")
    return dev


# the constants handed out while a CUDA graph is captured on this thread
_capture = threading.local()


def pin(value):
    """Hand out a constant made once per device (a cached filter, basis or
    matrix that a step reads): while a CUDA graph is captured on this
    thread (`pinning`), the graph keeps it alive, since it reads the
    constant at its address and the cache that made it may drop it."""
    pins = getattr(_capture, "pins", None)
    if pins is not None:
        pins.append(value)
    return value


@contextlib.contextmanager
def pinning():
    """Around the capture of a CUDA graph on this thread: yields the list
    of the constants `pin` handed out meanwhile, for the graph to hold."""
    _capture.pins = pins = []
    try:
        yield pins
    finally:
        _capture.pins = None


# kernel name -> count(key, n), which adds n to that kernel's process-wide
# counter `key` (`launch_counter`)
_launch_counters: dict = {}


def launch_counter(kernel: str, count) -> None:
    """Register how `kernel`'s launches are counted: `count(key, n)` adds
    n to its counter `key`, at a launch or at each replay of a graph that
    recorded one."""
    _launch_counters[kernel] = count


def launch_record(kernel: str):
    """Before a counted launch of `kernel`: None outside a CUDA graph's
    capture (the launch is counted as it is made); inside one, the record
    that `recording_launches()` opened on this thread (a capture launches
    nothing: the graph's replays are counted).  Raises inside a capture
    outside `recording_launches()`, whose replays would go uncounted."""
    if not torch.cuda.is_current_stream_capturing():
        return None
    recorded = getattr(_capture, "launches", None)
    if recorded is None:
        raise RuntimeError(f"{kernel} captured into a CUDA graph outside "
                           "device.recording_launches(): its replays would go uncounted")
    return recorded


def count_launch(recorded, kernel: str, amounts: dict) -> None:
    """After a launch of `kernel`: add `amounts` (counter key -> n) to its
    counters, or to the graph's record `recorded` (`launch_record`)."""
    for key, n in amounts.items():
        if recorded is None:
            _launch_counters[kernel](key, n)
        else:
            recorded[kernel, key] += n


@contextlib.contextmanager
def recording_launches():
    """Around the capture of a CUDA graph on this thread: yields a Counter
    of the counted kernel launches the graph records, by (kernel, counter
    key), which go to no count.  Pass it to `count_replay` at each
    replay."""
    _capture.launches = recorded = collections.Counter()
    try:
        yield recorded
    finally:
        _capture.launches = None


def count_replay(recorded) -> None:
    """Count one replay of a graph that recorded `recorded`."""
    for (kernel, key), n in recorded.items():
        _launch_counters[kernel](key, n)


END = "end"  # the closing mark of a tick's device span


class _Active(threading.local):
    recorder = None  # this thread's mark recorder while one is open


_active = _Active()


class _Recorder:
    __slots__ = ("marks", "cuda", "external")

    def __init__(self, cuda: bool, external: bool):
        self.marks, self.cuda, self.external = [], cuda, external

    def add(self, name: str) -> None:
        if self.cuda:
            event = torch.cuda.Event(enable_timing=True, external=self.external)
            event.record()
            self.marks.append((name, event))
        else:
            self.marks.append((name, time.perf_counter_ns()))


def mark(name: str) -> None:
    """Stage `name` of the chain starts here: a no-op unless this thread
    records marks (`recording_marks`)."""
    recorder = _active.recorder
    if recorder is not None:
        recorder.add(name)


@contextlib.contextmanager
def recording_marks(device, capture: bool = False):
    """Record this thread's `mark`s: yields their list of (name, stamp),
    which ends with END as the context exits.  A stamp is a CUDA event on
    a card (with capture, an event-record node of the graph being
    captured), host ns on the CPU."""
    recorder = _Recorder(torch.device(device).type == "cuda", capture)
    outer, _active.recorder = _active.recorder, recorder
    try:
        yield recorder.marks
        recorder.add(END)
    finally:
        _active.recorder = outer
