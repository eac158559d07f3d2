"""Device selection for the port's entry points, and the constants a
captured CUDA graph keeps alive (`pin`)."""

from __future__ import annotations

import contextlib
import threading

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
