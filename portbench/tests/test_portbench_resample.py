"""`resample_roofline`: its frozen byte count against the program's of
today, and its reading of a profiled stretch with and without the kernel."""

import pytest

from beatrice_vst_tpu_torch.ops import resample
from portbench import spec, yardstick
from portbench.tests.helpers import small_cell

METRIC = spec.load_module("metrics", "resample_roofline")
NAME = "void (anonymous namespace)::polyphase_resample_kernel<4>(PolyphaseArgs)"


@pytest.mark.parametrize("capacity, frames", [(1, 1), (3072, 1), (4096, 1), (4096, 25)])
def test_bytes_equal_the_programs(capacity, frames):
    edges = (resample.input_resampler_48k_to_16k(frames),
             resample.output_resampler_24k_to_48k(frames))
    assert METRIC.bytes_per_tick(capacity, frames) == sum(
        resample.bytes_per_call(rs, capacity) for rs in edges)
    assert METRIC.bound_ms_per_tick(capacity, frames) == pytest.approx(
        sum(resample.bound_ms(rs, capacity) for rs in edges), rel=1e-12)


def _record(by_name, capacity=4096, frames=25):
    return {"trace": {"by_name": by_name, "ticks": 4}, "capacity": capacity,
            "frames_per_tick": frames}


def test_reads_the_kernels_mean_launch():
    ctx = type("Ctx", (), {"config": small_cell("rc0-bf16.t25").config})()
    bound = METRIC.bound_ms_per_tick(4096, 25)
    # 4 ticks, 2 launches each, the tick's pair taking twice its bound
    got = METRIC.read(_record({NAME: (4 * 2 * bound * 1e-3, 8), "other": (1.0, 3)}), ctx)
    assert got == pytest.approx(50.0)
    assert METRIC.read(_record({"magma_sgemmEx_kernel": (0.136, 4)}), ctx) is None
    assert METRIC.read({"trace": None}, ctx) is None
    assert yardstick.PEAK_BYTES_PER_S == 3.35e12
    # the upsampler's roofline does not read the resampler kernel
    upsampler = spec.load_module("metrics", "upsampler_roofline")
    assert upsampler.read(_record({NAME: (1.0, 8)}), ctx) is None
