"""The port's streaming-vs-chunk parity harness (`beatrice_vst_tpu_torch/
parity.py`), mirroring tests/test_parity.py: for each model version, one
engine tick of the whole utterance (frames_per_tick = 20) against 20
real-time ticks through carried state, on the port's engine, with
parameters from the JAX package's `chain.init` and a bank from its
`random_bank` passed through `params_from_numpy`.  On the CPU both halves
run the plain head (the fused head's plain version at T = 1, the stage
loop at T = 20).  Gate: max |d| <= 1e-3, the JAX harness's.  Run with -s
to see the measured numbers."""

import functools

import numpy as np
import jax
import pytest
import torch

from beatrice_vst_tpu.constants import V20A2, V20B1, V20RC0
from beatrice_vst_tpu.models import chain as JC
from beatrice_vst_tpu.speakers.bank import random_bank
from beatrice_vst_tpu_torch.constants import VERSIONS
from beatrice_vst_tpu_torch.errors import BeatriceError
from beatrice_vst_tpu_torch.models import chain as PC
from beatrice_vst_tpu_torch.parity import run_parity

torch.set_num_threads(1)

SPECS = {"20a2": V20A2, "20b1": V20B1, "20rc0": V20RC0}


@functools.lru_cache(maxsize=None)
def _jax_model(name):
    """(port config, JAX-initialised params, JAX random bank) as numpy."""
    spec = SPECS[name]
    params = JC.init(jax.random.PRNGKey(0), JC.VoiceConverterConfig.for_version(spec))
    bank = random_bank(jax.random.PRNGKey(1), spec, 4)
    return (PC.VoiceConverterConfig.for_version(VERSIONS[spec.name]),
            jax.tree_util.tree_map(np.asarray, params), {k: np.asarray(v) for k, v in bank.items()})


def _parity(name, **kw):
    cfg, params, bank = _jax_model(name)
    report = run_parity(params, cfg, bank, device="cpu", **kw)
    print(f" {name}: {report}", end="")
    return report


@pytest.mark.parametrize("name", sorted(SPECS))
def test_streaming_matches_chunk(name):
    report = _parity(name, n_frames=20, batch=2)
    assert report.n_frames == 20
    assert report.passed, str(report)
    assert report.max_abs_diff < 1e-3


@pytest.mark.parametrize("engine_kw", [{}, dict(kv_cache_mode="per_stream")],
                         ids=["slots", "per_stream"])
def test_parity_with_pitch_controls(engine_kw):
    """tests/test_parity.py's controls; per_stream primes each stream's
    K/V cache for its target speaker."""
    report = _parity("20rc0", n_frames=15, engine_kw=engine_kw, controls={
        "pitch_shift": 5.0, "intonation_intensity": 1.5, "pitch_correction": 0.5,
        "vq_num_neighbors": 3, "target_speaker": 1})
    assert report.passed, str(report)


def test_parity_rejects_a_morph_target():
    with pytest.raises(BeatriceError, match="SPEAKER_ID_OUT_OF_RANGE"):
        _parity("20rc0", n_frames=2, controls={"target_speaker": 4})
