"""PyTorch/CUDA port of `beatrice_vst_tpu` (the JAX package stays the
reference and is not imported here).

What is ported so far: the engine tick (`runtime/engine.py:StreamEngine`)
in the JAX engine's serving configurations (f32, or bf16 with int8
conditioning; slot-bank or per-stream K/V), at one 10 ms frame per tick
or a chunk of T frames; offline conversion (`runtime/offline.py`); the
streaming-vs-chunk parity harness (`parity.py`); the three model versions
(2.0.0-rc.0, 2.0.0-beta.1, 2.0.0-alpha.2) with random initialisation;
speaker morphing (`ops/morph.py`, `ops/spherical_average.py`,
`speakers/morpher.py`: the engine's morph controls, frame counter and
codebook lottery, morph-slot leasing, `StreamEngine.recover()`, offline
morph conversion and morph parity); serving (`runtime/service.py:ModelHost`,
`runtime/server.py:StreamingServer`, the TCP, WebSocket and gRPC front
ends, the parameter surface of `params/`, the host-edge library of
`native/`, `cli.py`).  The vocoder's upsampler head runs at T = 1 as one
hand-written CUDA kernel in an f32 and a bf16 form
(`models/fused_upsampler.py`, `csrc/fused_upsampler.cu`,
`csrc/fused_upsampler_bf16.cu`); training (`training/`: distillation,
feature distillation, the GAN step with its critics, the WAV-pair data
pipeline, checkpoints, `cli train`), which runs the plain head under
autograd; and sequence-parallel offline conversion (`runtime/seqpar.py`,
`cli convert --seq-parallel`), its segments one batch on one card.
Multi-GPU (`parallel/`) is not ported yet.

Importing the package builds nothing and touches no GPU: kernels are
compiled with `nvcc` at their first launch, and the host-edge library with
the host compiler at its first use (`cuda_build.py`).
"""

from .device import resolve_device

__all__ = ["resolve_device"]
