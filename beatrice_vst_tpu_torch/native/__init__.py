"""ctypes bindings for the host-edge library (`csrc/beatrice_host.cc`,
a copy of `native/beatrice_host.cc`), built with the host compiler at first
use; a failed build raises (no quiet NumPy fallback)."""

from .host import (  # noqa: F401
    HostResampler,
    Reblocker,
    SpscRing,
    load_library,
    native_available,
)
