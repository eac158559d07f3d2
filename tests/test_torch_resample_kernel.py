"""The polyphase resampler kernel's host side on the CPU: the index math
of `csrc/polyphase_resample.cu`, replayed here over the tables and the
plan `ops/resample.py` hands its launcher, rebuilds the dense product's
banded matrix (`_dense_np`) exactly, and reads inside its shared-memory
window; CPU tensors take the dense product; the wrapper refuses what the
kernel does not take; the launch and sample counters count a graph's
launches once per replay."""

import collections

import numpy as np
import pytest
import torch

from beatrice_vst_tpu_torch import device as device_mod
from beatrice_vst_tpu_torch.ops import resample as R

torch.set_num_threads(1)

# (L, M, in_block): the engine's edges at T = 1, 3 and a block over
# `_DENSE_CHUNK_MAX` (1,920) samples, two client rates of offline
# conversion (48 <-> 44.1 kHz), and offline tails: blocks shorter than a
# tile, and than the history (the new history then holds old history)
CASES = [(1, 3, 480), (1, 3, 1440), (1, 3, 3840), (1, 3, 99), (1, 3, 30),
         (2, 1, 240), (2, 1, 720), (2, 1, 1920), (2, 1, 7),
         (160, 147, 588), (160, 147, 1470), (160, 147, 147),
         (147, 160, 480), (147, 160, 1600), (147, 160, 160)]


def kernel_matrix(rs: R.Resampler):
    """The matrix [hist + in_block, out_block] whose product with
    [history | x] the kernel computes: `polyphase_resample_kernel`'s
    indexing, block by block, over the launch's table and plan.  Also
    asserts that every read lies inside the block's window and every
    stored output reads only samples of [history | x]."""
    W, K, _ = R.design_polyphase(rs.L, rs.M, rs.taps, rs.cutoff)
    plan = R.kernel_plan(rs)
    assert plan.tile == R.KERNEL_THREADS * plan.reps and plan.reps in (1, 2, 4)
    hist, total = K - 1, K - 1 + rs.in_block
    S = np.zeros((total, rs.out_block), np.float32)
    tiles = -(-rs.out_block // plan.tile)
    for t in range(tiles):
        n0 = t * plan.tile
        w0 = n0 * rs.M // rs.L
        rows = W[((n0 + np.arange(plan.rows)) * rs.M) % rs.L]  # the block's table rows
        n = np.minimum(n0 + np.arange(plan.tile), rs.out_block - 1)
        stored = n0 + np.arange(plan.tile) < rs.out_block
        base = n * rs.M // rs.L - w0 + hist  # xr = win + base; tap k reads xr[-k]
        taps = rows[(n - n0) % plan.rows]  # [tile, K]
        read = base[:, None] - np.arange(K)[None, :]
        assert read.min() >= 0 and read.max() < plan.window
        j = (w0 + read)[stored]
        assert j.max() < total
        cols = np.broadcast_to(n[stored][:, None], j.shape)
        np.add.at(S, (j, cols), taps[stored])
    return S


@pytest.mark.parametrize("L, M, in_block", CASES)
def test_kernel_index_math_rebuilds_the_dense_matrix(L, M, in_block):
    rs = R.Resampler(L=L, M=M, in_block=in_block, cutoff=0.99)
    np.testing.assert_array_equal(kernel_matrix(rs), R._dense_np(rs))


@pytest.mark.parametrize("L, M, in_block", CASES[::3])
def test_kernel_new_history_is_the_last_samples_of_the_block(L, M, in_block):
    """The kernel's new history, full[in_block + i] read from history or x
    where it lies, equals the dense product's."""
    rs = R.Resampler(L=L, M=M, in_block=in_block, cutoff=0.99)
    hist = rs.history_len
    rng = np.random.default_rng(in_block)
    x = torch.from_numpy(rng.standard_normal((2, in_block)).astype(np.float32))
    h = torch.from_numpy(rng.standard_normal((2, hist)).astype(np.float32))
    j = in_block + np.arange(hist)
    want = np.where(j < hist, h.numpy()[:, np.minimum(j, hist - 1)],
                    x.numpy()[:, np.maximum(j - hist, 0)])
    np.testing.assert_array_equal(rs.dense_block(x, h)[1].numpy(), want)


def test_kernel_plan_fits_shared_memory_or_raises():
    for rs in (R.input_resampler_48k_to_16k(25), R.output_resampler_24k_to_48k(25)):
        plan = R.kernel_plan(rs)
        assert (plan.reps, plan.rows) == (4, rs.L)
        assert plan.smem_bytes(rs.history_len + 1) < 48 * 1024
    # T = 1: 160 and 480 outputs, two blocks and one
    assert R.kernel_plan(R.input_resampler_48k_to_16k(1)).reps == 2
    assert R.kernel_plan(R.output_resampler_24k_to_48k(1)).reps == 4
    # 44.1 -> 16 kHz offline: 160 of the table's rows a block
    rs = R.make_resampler(44100, 16000, 3969)
    assert R.kernel_plan(rs).rows == rs.L == 160
    assert R.kernel_plan(rs).smem_bytes(rs.history_len + 1) <= R.KERNEL_MAX_SMEM
    with pytest.raises(ValueError, match="shared memory"):
        R.kernel_plan(R.Resampler(L=1, M=997, in_block=997, cutoff=0.99))


def test_cpu_tensors_take_the_dense_product(monkeypatch):
    def refuse(*args):
        raise AssertionError("a CPU tensor reached the kernel")

    monkeypatch.setattr(R, "polyphase_block", refuse)
    rng = np.random.default_rng(3)
    rs = R.input_resampler_48k_to_16k(5)
    x = torch.from_numpy(rng.standard_normal((3, rs.in_block)).astype(np.float32))
    h = rs.init_state((3,), device="cpu")
    for got, want in zip(rs.apply_block(x, h), rs.dense_block(x, h)):
        assert torch.equal(got, want)
    sig = torch.from_numpy(rng.standard_normal((2, 5000)).astype(np.float32))
    y = R.make_resampler(44100, 16000, 3969).apply_offline(sig)
    assert y.shape == (2, 5000 * 160 // 441) and torch.isfinite(y).all()


def test_the_wrapper_refuses_what_the_kernel_does_not_take():
    rs = R.output_resampler_24k_to_48k(1)
    x, h = torch.zeros(2, rs.in_block), torch.zeros(2, rs.history_len)
    with pytest.raises(ValueError, match="float32"):
        R.polyphase_block(rs, x.double(), h.double())
    with pytest.raises(ValueError, match="takes x"):
        R.polyphase_block(rs, x[:, 1:], h)
    with pytest.raises(ValueError, match="takes x"):
        R.polyphase_block(rs, x, h[:1])
    with pytest.raises(RuntimeError, match="no backward"):
        R.polyphase_block(rs, x.requires_grad_(), h)


def test_counters_count_launches_samples_and_replays(monkeypatch):
    """`recording_launches` collects what a capture records under the
    kernel's name (and nothing goes to the counters); `count_replay` adds
    it once per replay."""
    monkeypatch.setattr(R, "launches", 3)
    monkeypatch.setattr(R, "samples", 300)
    with device_mod.recording_launches() as recorded:
        assert device_mod._capture.launches is recorded and not recorded
        for out in (4096 * 4000, 4096 * 12000):
            device_mod.count_launch(recorded, "polyphase_resample",
                                    {"launches": 1, "samples": out})
    assert device_mod._capture.launches is None
    assert dict(recorded) == {("polyphase_resample", "launches"): 2,
                              ("polyphase_resample", "samples"): 4096 * 16000}
    assert R.counts() == {"resample_kernel_launches": 3, "resample_kernel_samples": 300}
    for _ in range(3):
        device_mod.count_replay(recorded)
    device_mod.count_replay({})
    device_mod.count_launch(None, "polyphase_resample", {"launches": 1, "samples": 160})
    assert R.counts() == {"resample_kernel_launches": 3 + 6 + 1,
                          "resample_kernel_samples": 300 + 3 * 4096 * 16000 + 160}
    assert isinstance(recorded, collections.Counter)


def test_bound_counts_every_sample_once():
    rs = R.input_resampler_48k_to_16k(25)
    assert R.bytes_per_call(rs, 4096) == 4 * (4096 * (12000 + 4000 + 2 * 96) + 97)
    assert R.bound_ms(rs, 4096) == pytest.approx(R.bytes_per_call(rs, 4096) / 3.35e9)
