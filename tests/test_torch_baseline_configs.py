"""The port's BASELINE.json configurations
(`beatrice_vst_tpu_torch/scripts/baseline_configs.py`) on the CPU, with the
JAX package's draws swapped in (`chain.init(PRNGKey(0))`,
`random_bank(PRNGKey(1), V20RC0, 16)`, through the port's modules):

- #1 (offline, speaker 3, 4 VQ neighbours, 2 s at 48 kHz) and #3 (the
  neutral conversion and the four pitch/formant pairs on 0.5 s) equal the
  JAX package's `convert_utterance` with the same settings at
  `golden.F32_ATOL`, and `differs_from_neutral` equals JAX's for every pair;
- #2 and #4, at a small capacity, tick; the report's keys are the
  committed JAX report's (`docs/BASELINE_CONFIGS_REPORT.json`)."""

import json
import os

import jax
import numpy as np
import pytest
import torch

from beatrice_vst_tpu.constants import V20RC0 as JV20RC0
from beatrice_vst_tpu.models import chain as JC
from beatrice_vst_tpu.runtime import ConversionSettings as JSettings
from beatrice_vst_tpu.runtime import convert_utterance as jconvert
from beatrice_vst_tpu.speakers import bank as JB
from beatrice_vst_tpu_torch import golden
from beatrice_vst_tpu_torch.models import chain as PC
from beatrice_vst_tpu_torch.models.io import params_from_numpy
from beatrice_vst_tpu_torch.scripts import baseline_configs as B
from beatrice_vst_tpu_torch.speakers import bank as PB

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAPACITY2, CAPACITY4, TICKS4 = 2, 4, 2


@pytest.fixture(scope="module")
def jax_draws():
    cfg = JC.VoiceConverterConfig.for_version(JV20RC0)
    params = JC.init(jax.random.PRNGKey(0), cfg)
    bank = JB.random_bank(jax.random.PRNGKey(1), JV20RC0, B.N_SPEAKERS)
    return cfg, params, bank


@pytest.fixture(scope="module")
def jax_outputs(jax_draws):
    """#1's output and #3's neutral and swept outputs from the JAX package."""
    cfg, params, bank = jax_draws
    utt = B.utterance()
    outs = {1: np.asarray(jconvert(params, cfg, bank, utt, B.SR,
                                   JSettings(target_speaker=3, vq_num_neighbors=4)))}
    half = utt[: B.SR // 2]
    outs["neutral"] = np.asarray(jconvert(params, cfg, bank, half, B.SR,
                                          JSettings(target_speaker=1)))
    for shift, formant in B.SWEEP:
        outs[(shift, formant)] = np.asarray(jconvert(
            params, cfg, bank, half, B.SR,
            JSettings(target_speaker=1, pitch_shift=shift, formant_shift=formant)))
    return outs


@pytest.fixture(scope="module")
def port_run(jax_draws):
    """The port's run on the CPU with the JAX draws: (report, outputs, the
    seeds the draws were asked for)."""
    _, params, bank = jax_draws
    seeds = []

    def jax_params(gen, cfg, device="cuda"):
        seeds.append(("params", gen.initial_seed()))
        return params_from_numpy(jax.tree_util.tree_map(np.asarray, params), device)

    def jax_bank(gen, spec, n_speakers, device="cuda"):
        seeds.append(("bank", gen.initial_seed(), n_speakers))
        return params_from_numpy(jax.tree_util.tree_map(np.asarray, bank), device)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(PC, "init", jax_params)
        mp.setattr(PB, "random_bank", jax_bank)
        report, outputs = B.run("cpu", capacity2=CAPACITY2, capacity4=CAPACITY4, ticks4=TICKS4)
    return report, outputs, seeds


def test_draws_go_through_the_modules_at_the_jax_scripts_seeds(port_run):
    assert port_run[2] == [("params", 0), ("bank", 1, 16)]


def test_config1_offline_equals_jax(port_run, jax_outputs):
    got, want = port_run[1][1], jax_outputs[1]
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= golden.F32_ATOL
    assert port_run[0]["config1_offline"]["finite"]


@pytest.mark.parametrize("pair", ["neutral", *B.SWEEP])
def test_config3_sweep_equals_jax(port_run, jax_outputs, pair):
    got, want = port_run[1][3][pair], jax_outputs[pair]
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= golden.F32_ATOL
    if pair != "neutral":
        row = port_run[0]["config3_control_sweep"][B.SWEEP.index(pair)]
        assert (row["pitch_shift"], row["formant_shift"]) == pair
        jax_differs = bool(np.abs(want - jax_outputs["neutral"]).max() > 1e-3)
        assert row["differs_from_neutral"] == jax_differs
        assert row["finite"]


def test_report_keys_are_the_jax_reports(port_run):
    report = port_run[0]
    with open(os.path.join(REPO, "docs", "BASELINE_CONFIGS_REPORT.json")) as f:
        want = json.load(f)
    assert list(report) == list(want)
    for key, entry in want.items():
        if isinstance(entry, dict):
            assert set(report[key]) == set(entry), key
    assert [set(r) for r in report["config3_control_sweep"]] == \
        [set(r) for r in want["config3_control_sweep"]]
    assert report["device"] == "cpu"
    assert isinstance(report["config5_multihost"], str)


def test_streaming_configs_tick(port_run):
    report, outputs, _ = port_run
    assert outputs[2].shape == (CAPACITY2, 480) and np.isfinite(outputs[2]).all()
    assert np.abs(outputs[2][0]).max() > 1e-3  # the admitted stream
    assert outputs[4].shape == (CAPACITY4, 480) and np.isfinite(outputs[4]).all()
    assert (np.abs(outputs[4]).max(axis=1) > 1e-3).all()
    assert report["config2_stream_latency"]["p50_ms"] > 0
    c4 = report["config4_256_streams"]
    # both are rounded in the report, audio_sec_per_s to 0.1
    assert c4["audio_sec_per_s"] == pytest.approx(CAPACITY4 * 0.01 / (c4["tick_ms"] / 1e3),
                                                  rel=1e-3, abs=0.051)
