"""The frozen yardsticks against the program's copies of today, and the
model's FLOPs against a hand sum."""

import numpy as np
import pytest
import torch

from beatrice_vst_tpu_torch.models import fused_upsampler as FU
from beatrice_vst_tpu_torch.ops import frontend, resample
from portbench import flops, spec, yardstick
from portbench.reference import filters
from portbench.tests.helpers import ROOT

CONFIGS = ("beatrice2-rc0-bf16", "beatrice2-rc0-f32")


def test_upsampler_counts_equal_the_programs():
    assert yardstick.flops_per_stream() == FU.flops_per_stream()
    for b in (1, 256, 4096, 12288):
        for name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            assert yardstick.bytes_per_call(b, name) == FU.bytes_per_call(b, dtype)
            assert yardstick.bound_ms(b, name) == pytest.approx(FU.bound_ms(b, dtype), rel=1e-12)
    assert yardstick.PEAK_FLOPS == {"float32": FU.PEAK_F32_FLOPS, "bfloat16": FU.PEAK_BF16_FLOPS}
    assert yardstick.PEAK_BYTES_PER_S == FU.PEAK_BYTES_PER_S


def test_filters_equal_the_programs():
    for args in ((16000, 512, 80, 0.0, 8000.0), (16000, 1024, 128, 0.0, 4000.0)):
        np.testing.assert_array_equal(filters.mel_filterbank(*args), frontend.mel_filterbank(*args))
    for L, M in ((1, 3), (2, 1)):
        got = filters.design_polyphase(L, M, 16, 0.99)
        want = resample.design_polyphase(L, M, 16, 0.99)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:] == want[1:]


@pytest.mark.parametrize("name", CONFIGS)
def test_flops_equal_a_hand_sum(name):
    model = spec.load_json(f"{ROOT}/portbench/configs/{name}.json")["model"]
    fft = lambda n: 2.5 * n * np.log2(n)  # noqa: E731
    block = 2 * (4 * 256 * 256 + 256 * 512 + 512 * 256)  # k = 4 conv + 2x MLP
    attn = 2 * (256 * 64 + 64 * 384 + 384 * 64 + 64 * 256)
    up = 2 * (1 * 3 * 256 * 512 + 4 * 9 * 128      # stage 1: 1 row, 256 -> 4 x 128
              + 4 * 3 * 128 * 320 + 20 * 9 * 64     # stage 2: 4 rows, 128 -> 5 x 64
              + 20 * 3 * 64 * 128 + 80 * 9 * 32     # stage 3: 20 rows, 64 -> 4 x 32
              + 80 * 3 * 32 * 48 + 240 * 9 * 16     # stage 4: 80 rows, 32 -> 3 x 16
              + 240 * 3 * 16)                       # final conv
    hand = (2 * 160 * 97                                   # 48 -> 16 kHz, 97 taps
            + fft(512) + 3 * 257 + 2 * 257 * 80 + 2 * 80 * 256 + 6 * block + 2 * 256 * 128
            + 2 * 512 * 128                                # VQ distances
            + fft(1024) + 3 * 513 + 2 * 513 * 128 + 2 * 128 * 256 + 4 * block
            + 2 * 256 * (448 + 4)
            + 2 * 256 * (128 + 4 + 256) + 4 * (block + attn)
            + 2 * 240 * 8                                  # source
            + up
            + 2 * 480 * 33)                                # 24 -> 48 kHz, 33 taps
    assert sum(flops.flops_per_frame(model).values()) == pytest.approx(hand, rel=1e-12)
    assert flops.flops_per_tick(model, 4096, 25) == pytest.approx(4096 * 25 * hand, rel=1e-12)
