"""Card-only tests of the port: each CUDA kernel against its plain PyTorch
version, and the engine through the kernel against the engine through
the plain version.  They skip where torch.cuda.is_available() is false.

This file imports no JAX, so it also runs on a machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerance: atol 1e-4, f32 sums of up to 768 terms in another order (TF32
off on both sides).
"""

import os

import numpy as np
import pytest
import torch

from beatrice_vst_tpu_torch.models import fused_upsampler as FU

MODEL_DIR = os.path.join(os.path.dirname(__file__), "..", "models_demo", "klatt8")
TOL = 1e-4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _upsampler_args(b, seed, device):
    rng = np.random.default_rng(seed)
    h_shape, state_shapes, src_shapes, stage_shapes, final_shapes = FU.expected_shapes(b)

    def n(shape, scale):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).to(device)

    up = [{"conv": {"w": n(st["conv_w"], 1.0 / np.sqrt(3 * st["conv_w"][1])),
                    "b": n(st["conv_b"], 0.1)},
           "src": {"w": n(st["src_w"], 0.3), "b": n(st["src_b"], 0.1)},
           "snake": {"log_alpha": n(st["log_alpha"], 0.3)}} for st in stage_shapes]
    final = {"w": n(final_shapes["w"], 0.15), "b": n(final_shapes["b"], 0.1)}
    return (up, final, n(h_shape, 0.5), [n(s, 0.1) for s in state_shapes],
            [n(s, 0.3) for s in src_shapes])


@pytest.mark.cuda
# 15 and 17: a tile's ragged edge; 1, 3 and 100: partial clusters; 1000:
# more clusters than the card holds at once
@pytest.mark.parametrize("b", [1, 3, 15, 16, 17, 100, 256, 1000])
def test_fused_upsampler_kernel_matches_plain(cuda_device, b):
    args = _upsampler_args(b, b, cuda_device)
    before = FU.launches
    audio, new_states = FU.fused_upsample(*args)
    torch.cuda.synchronize()
    assert FU.launches == before + 1
    want_audio, want_states = FU.fused_upsample_reference(*args)
    torch.testing.assert_close(audio, want_audio, rtol=0, atol=TOL)
    assert len(new_states) == 5
    for got, want in zip(new_states, want_states):
        torch.testing.assert_close(got, want, rtol=0, atol=TOL)


@pytest.mark.cuda
def test_fused_upsampler_is_deterministic(cuda_device):
    # no atomics and sums in a fixed order: two launches agree bit for bit
    args = _upsampler_args(100, 7, cuda_device)
    first = FU.fused_upsample(*args)
    second = FU.fused_upsample(*args)
    torch.cuda.synchronize()
    for got, want in zip([second[0], *second[1]], [first[0], *first[1]]):
        assert torch.equal(got, want)


@pytest.mark.cuda
def test_fused_upsampler_interleaved_parameter_sets(cuda_device):
    # two parameter sets and batches, launched in turn without a synchronise
    first, second = _upsampler_args(16, 1, cuda_device), _upsampler_args(33, 2, cuda_device)
    outs = [FU.fused_upsample(*args) for args in (first, second, first, second)]
    torch.cuda.synchronize()
    for args, (audio, new_states) in zip((first, second, first, second), outs):
        want_audio, want_states = FU.fused_upsample_reference(*args)
        torch.testing.assert_close(audio, want_audio, rtol=0, atol=TOL)
        for got, want in zip(new_states, want_states):
            torch.testing.assert_close(got, want, rtol=0, atol=TOL)


@pytest.mark.cuda
def test_fused_upsampler_rejects_misaligned(cuda_device):
    up, final, h, states, src = _upsampler_args(4, 0, cuda_device)
    h = torch.empty(h.numel() + 1, device=cuda_device)[1:].view(h.shape).copy_(h)
    with pytest.raises(ValueError, match="aligned"):
        FU.fused_upsample(up, final, h, states, src)


@pytest.mark.cuda
def test_fused_upsampler_rejects_non_contiguous(cuda_device):
    up, final, h, states, src = _upsampler_args(4, 0, cuda_device)
    states[1] = states[1].transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        FU.fused_upsample(up, final, h, states, src)


@pytest.mark.cuda
def test_engine_kernel_matches_plain_engine(cuda_device):
    from beatrice_vst_tpu_torch.constants import V20RC0
    from beatrice_vst_tpu_torch.models.io import load_weights
    from beatrice_vst_tpu_torch.runtime.engine import EngineConfig, StreamEngine
    from beatrice_vst_tpu_torch.speakers import bank as bank_mod

    params = load_weights(os.path.join(MODEL_DIR, "weights.npz"), device=cuda_device)
    bank = bank_mod.load(os.path.join(MODEL_DIR, "speakers.npz"), V20RC0, device=cuda_device)
    cap, ticks = 8, 6
    engines = []
    for kernel in (True, False):
        e = StreamEngine(EngineConfig.realtime(cap, upsampler_kernel=kernel), params, bank,
                         device=cuda_device)
        for i in range(cap):
            e.admit()
            e.set_control(i, "target_speaker", i)
            e.set_control(i, "vq_num_neighbors", i % 3)
        engines.append(e)
    rng = np.random.default_rng(0)
    audio = torch.from_numpy((rng.standard_normal((ticks, cap, 480)) * 0.1)
                             .astype(np.float32)).to(cuda_device)
    before = FU.launches
    for k in range(ticks):
        got = engines[0].tick(audio[k])
        want = engines[1].tick(audio[k])
        torch.testing.assert_close(got, want, rtol=0, atol=TOL)
    assert FU.launches == before + ticks
