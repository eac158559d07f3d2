"""Host-edge primitives of the streaming server (port of
`beatrice_vst_tpu/native/host.py`): arbitrary-rate resampling, fixed-block
reblocking (one-block latency, resample.h:331-364 semantics) and SPSC
rings for the handoff between client threads and the scheduler thread.

They run on the host CPU per stream, between client audio and the
engine's 48 kHz tick grid, over the native library built from
`csrc/beatrice_host.cc` at first use (`cuda_build.build_host`, into the
gitignored `_build/`).  Where the JAX module quietly falls back to NumPy
when its library is missing, the port raises when the build fails; the
NumPy versions run only when asked for (`force_numpy=True`).
"""

from __future__ import annotations

import ctypes
import functools
import threading

import numpy as np

from .. import cuda_build

LIBRARY = "beatrice_host"


def load_library() -> ctypes.CDLL:
    """The host-edge library, built if needed, with its C signatures
    declared.  Raises if it cannot be built."""
    return _configured(cuda_build.host_compiler())


@functools.lru_cache(maxsize=None)
def _configured(compiler: str) -> ctypes.CDLL:
    """The library built by `compiler`, loaded and declared once."""
    lib = ctypes.CDLL(str(cuda_build.build_host(LIBRARY, compiler)))
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.bh_resampler_create.restype = ctypes.c_void_p
    lib.bh_resampler_create.argtypes = [ctypes.c_double, ctypes.c_double,
                                        ctypes.c_int, ctypes.c_double]
    lib.bh_resampler_destroy.argtypes = [ctypes.c_void_p]
    lib.bh_resampler_process.restype = ctypes.c_int
    lib.bh_resampler_process.argtypes = [ctypes.c_void_p, f32p, ctypes.c_int,
                                         f32p, ctypes.c_int]
    for name in ("bh_resampler_ratio_l", "bh_resampler_ratio_m", "bh_resampler_delay"):
        getattr(lib, name).restype = ctypes.c_int
        getattr(lib, name).argtypes = [ctypes.c_void_p]
    lib.bh_reblocker_create.restype = ctypes.c_void_p
    lib.bh_reblocker_create.argtypes = [ctypes.c_int]
    lib.bh_reblocker_destroy.argtypes = [ctypes.c_void_p]
    lib.bh_reblocker_push.argtypes = [ctypes.c_void_p, f32p, ctypes.c_int]
    lib.bh_reblocker_pop.restype = ctypes.c_int
    lib.bh_reblocker_pop.argtypes = [ctypes.c_void_p, f32p, ctypes.c_int]
    lib.bh_reblocker_fill.restype = ctypes.c_int
    lib.bh_reblocker_fill.argtypes = [ctypes.c_void_p]
    lib.bh_ring_create.restype = ctypes.c_void_p
    lib.bh_ring_create.argtypes = [ctypes.c_uint32]
    lib.bh_ring_destroy.argtypes = [ctypes.c_void_p]
    for name in ("bh_ring_write", "bh_ring_read"):
        getattr(lib, name).restype = ctypes.c_uint32
        getattr(lib, name).argtypes = [ctypes.c_void_p, f32p, ctypes.c_uint32]
    for name in ("bh_ring_readable", "bh_ring_writable"):
        getattr(lib, name).restype = ctypes.c_uint32
        getattr(lib, name).argtypes = [ctypes.c_void_p]
    return lib


def native_available() -> bool:
    """Whether the host-edge library builds and loads here (a query for
    reports: no primitive falls back when it does not)."""
    try:
        load_library()
    except (RuntimeError, OSError):
        return False
    return True


def _as_f32p(arr):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


class HostResampler:
    """Streaming arbitrary-rate resampler (native, or NumPy when asked)."""

    def __init__(self, rate_in: float, rate_out: float, taps: int = 16,
                 cutoff: float = 0.99, force_numpy: bool = False):
        self._lib = None if force_numpy else load_library()
        if self._lib is not None:
            self._h = self._lib.bh_resampler_create(rate_in, rate_out, taps, cutoff)
            self.L = self._lib.bh_resampler_ratio_l(self._h)
            self.M = self._lib.bh_resampler_ratio_m(self._h)
        else:
            from ..ops.resample import design_polyphase, rational_rate_ratio

            self.L, self.M = rational_rate_ratio(rate_in, rate_out)
            w, k, _ = design_polyphase(self.L, self.M, taps, cutoff)
            self._w = np.asarray(w)
            self._K = k
            self._hist = np.zeros(k - 1, np.float32)
            self._in_count = 0
            self._next_out = 0

    def process(self, x: np.ndarray) -> np.ndarray:
        x = np.ascontiguousarray(x, np.float32)
        cap = int(len(x) * self.L / self.M) + 4
        if self._lib is not None:
            out = np.empty(cap, np.float32)
            n = self._lib.bh_resampler_process(self._h, _as_f32p(x), len(x),
                                               _as_f32p(out), cap)
            return out[:n]
        buf = np.concatenate([self._hist, x])
        hist = len(self._hist)
        total_in = self._in_count + len(x)
        outs = []
        while True:
            base = self._next_out * self.M // self.L
            if base >= total_in:
                break
            p = (self._next_out * self.M) % self.L
            local = base - self._in_count + hist
            window = buf[local - self._K + 1: local + 1][::-1]
            outs.append(float(self._w[p] @ window))
            self._next_out += 1
        self._hist = buf[len(buf) - hist:]
        self._in_count = total_in
        return np.asarray(outs, np.float32)

    def __del__(self):
        if getattr(self, "_lib", None) is not None and getattr(self, "_h", None):
            self._lib.bh_resampler_destroy(self._h)
            self._h = None


class Reblocker:
    """Arbitrary-size stream -> fixed blocks (one-block latency)."""

    def __init__(self, block: int, force_numpy: bool = False):
        self.block = block
        self._lib = None if force_numpy else load_library()
        if self._lib is not None:
            self._h = self._lib.bh_reblocker_create(block)
        else:
            self._buf = np.zeros(0, np.float32)

    def push(self, x: np.ndarray) -> np.ndarray:
        """Feed samples; returns zero or more complete [k*block] samples."""
        x = np.ascontiguousarray(x, np.float32)
        if self._lib is not None:
            self._lib.bh_reblocker_push(self._h, _as_f32p(x), len(x))
            cap = len(x) + self.block
            out = np.empty(cap, np.float32)
            n = self._lib.bh_reblocker_pop(self._h, _as_f32p(out), cap)
            return out[:n]
        self._buf = np.concatenate([self._buf, x])
        n_blocks = len(self._buf) // self.block
        out = self._buf[: n_blocks * self.block]
        self._buf = self._buf[n_blocks * self.block:]
        return out

    def __del__(self):
        if getattr(self, "_lib", None) is not None and getattr(self, "_h", None):
            self._lib.bh_reblocker_destroy(self._h)
            self._h = None


class SpscRing:
    """Single-producer single-consumer float ring (native lock-free, or a
    locked NumPy ring when asked)."""

    def __init__(self, capacity_pow2: int = 1 << 15, force_numpy: bool = False):
        if capacity_pow2 <= 0 or capacity_pow2 & (capacity_pow2 - 1):
            raise ValueError(f"ring capacity {capacity_pow2} is not a power of two")
        self.capacity = capacity_pow2
        self._lib = None if force_numpy else load_library()
        if self._lib is not None:
            self._h = self._lib.bh_ring_create(capacity_pow2)
        else:
            self._buf = np.zeros(capacity_pow2, np.float32)
            self._head = 0
            self._tail = 0
            self._lock = threading.Lock()

    def write(self, x: np.ndarray) -> int:
        x = np.ascontiguousarray(x, np.float32)
        if self._lib is not None:
            return int(self._lib.bh_ring_write(self._h, _as_f32p(x), len(x)))
        with self._lock:
            can = min(len(x), self.capacity - (self._tail - self._head))
            idx = (self._tail + np.arange(can)) % self.capacity
            self._buf[idx] = x[:can]
            self._tail += can
            return can

    def read(self, n: int) -> np.ndarray:
        if self._lib is not None:
            out = np.empty(n, np.float32)
            got = self._lib.bh_ring_read(self._h, _as_f32p(out), n)
            return out[:got]
        with self._lock:
            can = min(n, self._tail - self._head)
            idx = (self._head + np.arange(can)) % self.capacity
            out = self._buf[idx].copy()
            self._head += can
            return out

    def readable(self) -> int:
        if self._lib is not None:
            return int(self._lib.bh_ring_readable(self._h))
        with self._lock:
            return self._tail - self._head

    def __del__(self):
        if getattr(self, "_lib", None) is not None and getattr(self, "_h", None):
            self._lib.bh_ring_destroy(self._h)
            self._h = None
