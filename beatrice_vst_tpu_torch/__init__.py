"""PyTorch/CUDA port of `beatrice_vst_tpu` (the JAX package stays the
reference and is not imported here).

What is ported so far: the engine tick (`runtime/engine.py:StreamEngine`)
in the JAX engine's serving configurations (f32, or bf16 with int8
conditioning; slot-bank or per-stream K/V), at one 10 ms frame per tick
or a chunk of T frames; offline conversion (`runtime/offline.py`); the
streaming-vs-chunk parity harness (`parity.py`); the three model versions
(2.0.0-rc.0, 2.0.0-beta.1, 2.0.0-alpha.2) with random initialisation.  The
vocoder's upsampler head runs at T = 1 as one hand-written CUDA kernel
(`models/fused_upsampler.py`, `csrc/fused_upsampler.cu`).  Morphing,
serving, multi-GPU and training are not ported yet.

Importing the package builds nothing and touches no GPU: kernels are
compiled with `nvcc` at their first launch (`cuda_build.py`).
"""

from .device import resolve_device

__all__ = ["resolve_device"]
