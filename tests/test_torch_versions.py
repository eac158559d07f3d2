"""The older model versions, 2.0.0-alpha.2 and 2.0.0-beta.1 (no K/V, no VQ,
256 phone channels, 384 pitch bins): the port's StreamEngine against the
JAX StreamEngine on random parameters from the JAX package's `chain.init`
and `random_bank`; and the port's own `chain.init` and `random_bank`
against the JAX package's trees for all three versions.  Gate: f32 audio
at atol 1e-3, the waveform gate of tests/test_golden.py.  Run with -s to
see the measured numbers."""

import numpy as np
import jax
import pytest
import torch

from beatrice_vst_tpu.constants import V20A2 as JV20A2
from beatrice_vst_tpu.constants import V20B1 as JV20B1
from beatrice_vst_tpu.constants import V20RC0 as JV20RC0
from beatrice_vst_tpu.models import chain as JC
from beatrice_vst_tpu.runtime.engine import EngineConfig as JEngineConfig
from beatrice_vst_tpu.runtime.engine import StreamEngine as JStreamEngine
from beatrice_vst_tpu.speakers.bank import random_bank as jrandom_bank
from beatrice_vst_tpu_torch import golden
from beatrice_vst_tpu_torch.constants import VERSIONS
from beatrice_vst_tpu_torch.models import chain as PC
from beatrice_vst_tpu_torch.runtime.engine import EngineConfig, StreamEngine
from beatrice_vst_tpu_torch.speakers import bank as bank_mod

torch.set_num_threads(1)

CAP = golden.CAPACITY


OLDER = {"20a2": JV20A2, "20b1": JV20B1}


def _jax_random_model(jspec, seed=1):
    """JAX-initialised params and an 8-speaker random bank, as numpy."""
    params = JC.init(jax.random.PRNGKey(seed), JC.VoiceConverterConfig.for_version(jspec))
    bank = jrandom_bank(jax.random.PRNGKey(seed + 1), jspec, 8)
    return (jax.tree_util.tree_map(np.asarray, params),
            {k: np.asarray(v) for k, v in bank.items()})


@pytest.mark.parametrize("name", sorted(OLDER))
def test_older_version_engine_matches_jax_engine(name):
    """2.0.0-alpha.2 / 2.0.0-beta.1: no K/V, no VQ, 256 phone channels,
    384 pitch bins; the default configuration (slots f32) at T = 1."""
    jspec = OLDER[name]
    params, bank = _jax_random_model(jspec)
    want = golden.run(JStreamEngine(JEngineConfig.realtime(CAP, spec=jspec), params, bank),
                      frames=10)
    cfg = EngineConfig.realtime(CAP, spec=VERSIONS[jspec.name])
    eng = StreamEngine(cfg, params, bank, device="cpu")
    assert "kv_slots" not in eng.state and "kv_cache" not in eng.state
    got = golden.run(eng, lambda t: t.numpy(), frames=10)
    assert np.abs(want).max(axis=(1, 2)).min() > 1e-3
    print(f"\n{name}: max |d| against the JAX engine {np.abs(got - want).max():.3g}")
    np.testing.assert_allclose(got, want, rtol=0, atol=golden.F32_ATOL)


def _leaves(tree):
    """{path: numpy leaf} of a params tree of either package."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, torch.Tensor))
    return {jax.tree_util.keystr(path): np.asarray(leaf) for path, leaf in flat}


def _same_distribution(got, want, path):
    """Shapes and dtypes equal; constant leaves equal; random leaves of
    one law: the same bound and a standard deviation within 20 %."""
    assert got.shape == want.shape and got.dtype == want.dtype, path
    if want.std() == 0:
        np.testing.assert_array_equal(got, want, err_msg=path)
        return
    assert got.std() > 0, path
    if want.size >= 256:
        assert 0.8 < got.std() / want.std() < 1.25, path
        assert abs(got.mean()) < 0.2 * want.std() + abs(want.mean()) * 2, path


@pytest.mark.parametrize("jspec", [JV20A2, JV20B1, JV20RC0], ids=["20a2", "20b1", "20rc0"])
def test_init_and_random_bank_match_jax_trees(jspec):
    """The port's `chain.init` and `random_bank` give the JAX package's
    tree: the same keys, shapes, dtypes and per-leaf distributions (the
    values differ); one seed gives the same values every time."""
    spec = VERSIONS[jspec.name]
    jparams, jbank = _jax_random_model(jspec, seed=4)
    pcfg = PC.VoiceConverterConfig.for_version(spec)
    got = _leaves(PC.init(torch.Generator().manual_seed(4), pcfg, device="cpu"))
    want = _leaves(jparams)
    assert list(got) == list(want)
    for path in want:
        _same_distribution(got[path], want[path], path)
    again = _leaves(PC.init(torch.Generator().manual_seed(4), pcfg, device="cpu"))
    assert all(np.array_equal(again[k], got[k]) for k in got)
    pbank = bank_mod.random_bank(torch.Generator().manual_seed(5), spec, 8, device="cpu")
    assert sorted(pbank) == sorted(jbank)
    for key in jbank:
        _same_distribution(pbank[key].numpy(), jbank[key], key)
