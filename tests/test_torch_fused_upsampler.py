"""The upsampler head's plain PyTorch version against the TPU kernel
(`fused_upsample(..., interpret=True)`, as tests/test_pallas.py runs it on
the CPU), and the wrapper's CPU route and checks.  The CUDA kernel itself
is held against the plain version in tests/test_torch_cuda.py.

Tolerances: f32 audio rtol 1e-4 / atol 1e-5 and carries rtol 1e-5 /
atol 1e-6 against the Pallas kernel, as tests/test_pallas.py holds it
against XLA."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from beatrice_vst_tpu.constants import V20RC0
from beatrice_vst_tpu.models import waveform_generator as JW
from beatrice_vst_tpu.models.chain import VoiceConverterConfig
from beatrice_vst_tpu.models.pallas_upsampler import fused_upsample as pallas_fused_upsample
from beatrice_vst_tpu_torch.models import fused_upsampler as FU
from beatrice_vst_tpu_torch.models.io import params_from_numpy

torch.set_num_threads(1)

CFG = VoiceConverterConfig.for_version(V20RC0).wg


def _inputs(b, seed):
    """Random stage weights (with nonzero biases and snake alphas), carries,
    frame features and source features, as numpy."""
    params = jax.tree_util.tree_map(np.asarray, JW.init(jax.random.PRNGKey(seed), CFG))
    rng = np.random.default_rng(seed)
    for p in params["up"]:
        p["conv"]["b"] = (rng.standard_normal(p["conv"]["b"].shape) * 0.1).astype(np.float32)
        p["src"]["b"] = (rng.standard_normal(p["src"]["b"].shape) * 0.1).astype(np.float32)
        p["snake"]["log_alpha"] = (rng.standard_normal(p["snake"]["log_alpha"].shape)
                                   * 0.3).astype(np.float32)
    params["final"]["b"] = np.full((1,), 0.05, np.float32)
    h = (rng.standard_normal((b, 1, CFG.hidden)) * 0.5).astype(np.float32)
    states = [(rng.standard_normal(s) * 0.1).astype(np.float32)
              for s in FU.expected_shapes(b)[1]]
    src = [(rng.standard_normal(s) * 0.3).astype(np.float32)
           for s in FU.expected_shapes(b)[2]]
    return params, h, states, src


def _torch_args(params, h, states, src, device="cpu"):
    tp = params_from_numpy({"up": params["up"], "final": params["final"]}, device)
    return (tp["up"], tp["final"], torch.from_numpy(h).to(device),
            [torch.from_numpy(s).to(device) for s in states],
            [torch.from_numpy(s).to(device) for s in src])


def test_plain_matches_pallas_kernel_interpret():
    b = 16
    params, h, states, src = _inputs(b, seed=0)
    audio_j, states_j = pallas_fused_upsample(
        params["up"], params["final"], jnp.asarray(h),
        [jnp.asarray(s) for s in states], [jnp.asarray(s) for s in src],
        rates=FU.RATES, channels=FU.CHANNELS, compute_dtype=jnp.float32,
        interpret=True)
    audio_p, states_p = FU.fused_upsample_reference(*_torch_args(params, h, states, src))
    np.testing.assert_allclose(audio_p.numpy(), np.asarray(audio_j), rtol=1e-4, atol=1e-5)
    assert len(states_p) == len(states_j) == 5
    for got, want in zip(states_p, states_j):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_wrapper_on_cpu_runs_plain_version_without_counting():
    params, h, states, src = _inputs(3, seed=1)
    args = _torch_args(params, h, states, src)
    before = FU.launches
    audio, new_states = FU.fused_upsample(*args)
    want_audio, want_states = FU.fused_upsample_reference(*args)
    assert FU.launches == before
    torch.testing.assert_close(audio, want_audio, rtol=0, atol=0)
    for got, want in zip(new_states, want_states):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert audio.shape == (3, 240) and bool(torch.isfinite(audio).all())
    assert bool((audio.abs() <= 1).all())


@pytest.mark.parametrize("bad", ["h_shape", "state_shape", "src_shape", "dtype", "weight"])
def test_wrapper_rejects_what_the_kernel_cannot_take(bad):
    params, h, states, src = _inputs(2, seed=2)
    up, final, th, ts, tsrc = _torch_args(params, h, states, src)
    if bad == "h_shape":
        th = th[:, :, :128]
    elif bad == "state_shape":
        ts[2] = ts[2][:, :1]
    elif bad == "src_shape":
        tsrc[3] = tsrc[3][:, :, :8]
    elif bad == "dtype":
        th = th.double()
    else:
        up[1]["conv"]["w"] = up[1]["conv"]["w"][:, :, :64]
    with pytest.raises(ValueError):
        FU.fused_upsample(up, final, th, ts, tsrc)


def test_flop_count_matches_the_plan():
    # 4 stage convs + source projections + final conv, per stream
    assert FU.flops_per_stream() == 2 * 1_830_144
