"""PyTorch/CUDA port of `beatrice_vst_tpu` (the JAX package stays the
reference and is not imported here).

What is ported so far: the real-time 2.0.0-rc.0 engine tick at f32 with
per-stream speaker conditioning (`runtime/engine.py:StreamEngine`), whose
vocoder upsampler head runs as one hand-written CUDA kernel
(`models/fused_upsampler.py`, `csrc/fused_upsampler.cu`).

Importing the package builds nothing and touches no GPU: kernels are
compiled with `nvcc` at their first launch (`cuda_build.py`).
"""

from .device import resolve_device

__all__ = ["resolve_device"]
