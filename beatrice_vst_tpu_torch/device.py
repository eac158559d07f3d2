"""Device selection for the port's entry points, the constants a
captured CUDA graph keeps alive (`pin`), and the chain's stage marks
(`mark`, read by the tracer in `runtime/metrics.py`)."""

from __future__ import annotations

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
