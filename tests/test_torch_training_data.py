"""The port's training data side against the JAX package's, on the CPU:
the copies of synthesis.py and quality.py (bitwise equal), `PairDataset`
and `make_pair_batcher` (the same arrays for the same seed: the crops,
pitch bins and cond rows equal, the resampled audio within 1e-6, the two
packages' host resamplers), and `cli train` (teacher, `--data`, `--gan`,
checkpoint and resume) writing a weights.npz the JAX package's
`load_model_dir` reads."""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from beatrice_vst_tpu.audio_io import write_wav as jwrite_wav
from beatrice_vst_tpu.models.io import flatten_params as jflat
from beatrice_vst_tpu.models.io import load_model_dir as jload_model_dir
from beatrice_vst_tpu.training import data as JDA
from beatrice_vst_tpu.training import quality as JQ
from beatrice_vst_tpu.training import synthesis as JS
from beatrice_vst_tpu_torch import cli as PCLI
from beatrice_vst_tpu_torch.models.io import load_model_dir
from beatrice_vst_tpu_torch.training import data as PDA
from beatrice_vst_tpu_torch.training import quality as PQ
from beatrice_vst_tpu_torch.training import synthesis as PS
from beatrice_vst_tpu_torch.training.checkpoint import available_steps

torch.set_num_threads(1)

MODEL_DIR = os.path.join(os.path.dirname(__file__), "..", "models_demo", "klatt8")
RESAMPLED_ATOL = 1e-6


def test_synthesis_is_the_jax_packages(tmp_path):
    for seed in (0, 1):
        segs_p, f0_p = PS.sample_utterance(np.random.default_rng(seed), 4, 6)
        segs_j, f0_j = JS.sample_utterance(np.random.default_rng(seed), 4, 6)
        np.testing.assert_array_equal(f0_p, f0_j)
        assert repr(segs_p) == repr(segs_j)
        np.testing.assert_array_equal(PS.plan_f0_voiced(segs_p, f0_p),
                                      JS.plan_f0_voiced(segs_j, f0_j))
        for sp, sj in zip(PS.default_speakers(3), JS.default_speakers(3)):
            assert repr(sp) == repr(sj)
            np.testing.assert_array_equal(PS.render(segs_p, f0_p, sp, np.random.default_rng(3)),
                                          JS.render(segs_j, f0_j, sj, np.random.default_rng(3)))
    mp = PS.make_corpus(str(tmp_path / "p"), n_speakers=2, n_utterances=2, seed=4)
    mj = JS.make_corpus(str(tmp_path / "j"), n_speakers=2, n_utterances=2, seed=4)
    assert mp == mj
    for d, _, names in os.walk(tmp_path / "p"):
        for n in names:
            other = os.path.join(str(d).replace(str(tmp_path / "p"), str(tmp_path / "j")), n)
            assert open(os.path.join(d, n), "rb").read() == open(other, "rb").read()


def test_quality_is_the_jax_packages():
    segs, f0 = JS.sample_utterance(np.random.default_rng(2), 4, 6)
    x, y = (JS.render(segs, f0, s, np.random.default_rng(7)) for s in JS.default_speakers(2))
    sr = JS.SR
    for a, b in zip(PQ.mel_cepstra(x, sr), JQ.mel_cepstra(x, sr)):
        np.testing.assert_array_equal(a, b)
    assert PQ.mcd_db(x, y, sr) == JQ.mcd_db(x, y, sr)
    assert PQ.lsd_db(x, y, sr) == JQ.lsd_db(x, y, sr)
    for a, b in zip(PQ.f0_track(x, sr), JQ.f0_track(x, sr)):
        np.testing.assert_array_equal(a, b)
    assert PQ.f0_rmse_cents(x, y, sr) == JQ.f0_rmse_cents(x, y, sr)
    truth = JS.plan_f0_voiced(segs, f0)
    assert PQ.f0_rmse_cents_vs_truth(x, truth, sr) == JQ.f0_rmse_cents_vs_truth(x, truth, sr)
    assert PQ.compare(x, y, sr) == JQ.compare(x, y, sr)
    old = {"converted": {"mcd_db": 19.7, "f0_rmse_cents": 424.0},
           "pairs_worse_than_do_nothing_mcd": 4}
    for new in (old, {**old, "converted": {"mcd_db": 19.6, "f0_rmse_cents": 800.0}}):
        assert PQ.should_promote(old, new) == JQ.should_promote(old, new)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Two datasets: identity mode (inputs only, 16 and 22.05 kHz), and
    pairs (targets at 24 kHz, speakers.json, f0_plan.npz for one name)."""
    root = tmp_path_factory.mktemp("corpus")
    rng = np.random.default_rng(0)
    ident = root / "ident" / "inputs"
    ident.mkdir(parents=True)
    jwrite_wav(str(ident / "a.wav"), (0.1 * rng.standard_normal(16000)).astype(np.float32), 16000)
    jwrite_wav(str(ident / "b.wav"), (0.1 * rng.standard_normal(22050)).astype(np.float32), 22050)
    pairs = root / "pairs"
    (pairs / "inputs").mkdir(parents=True)
    (pairs / "targets").mkdir()
    segs, f0 = JS.sample_utterance(np.random.default_rng(1), 6, 8)
    renders = [JS.render(segs, f0, s, np.random.default_rng(5 + k), JS.SR)
               for k, s in enumerate(JS.default_speakers(3))]
    spk = {}
    for name, (s, t) in {"u0_s0_t1": (0, 1), "u0_s2_t0": (2, 0), "u0_s1_t2": (1, 2)}.items():
        jwrite_wav(str(pairs / "inputs" / f"{name}.wav"), renders[s], JS.SR)
        jwrite_wav(str(pairs / "targets" / f"{name}.wav"), renders[t], JS.SR)
        spk[name] = t
    (pairs / "speakers.json").write_text(json.dumps(spk))
    np.savez(str(pairs / "f0_plan.npz"), u0_s0_t1=JS.plan_f0_voiced(segs, f0))
    return str(root / "ident"), str(pairs)


@pytest.mark.parametrize("which", [0, 1])
def test_pair_dataset_matches_jax(corpus, which):
    port, ref = PDA.PairDataset(corpus[which]), JDA.PairDataset(corpus[which])
    assert port.identity_mode == ref.identity_mode == (which == 0)
    assert len(port.items) == len(ref.items) and port.n_frames_total() == ref.n_frames_total()
    for (a, t, s, f0), (ja, jt, js, jf0) in zip(port.items, ref.items):
        assert s == js and a.shape == ja.shape and t.shape == jt.shape
        np.testing.assert_allclose(a, ja, rtol=0, atol=RESAMPLED_ATOL)
        np.testing.assert_allclose(t, jt, rtol=0, atol=RESAMPLED_ATOL)
        np.testing.assert_array_equal(f0, jf0)


@pytest.mark.parametrize("prefetch,boost", [(0, 1.0), (2, 9.0)])
def test_pair_batcher_matches_jax(corpus, prefetch, boost):
    """The same crops, speakers, pitch bins and cond rows as the JAX
    batcher for the same seed, with and without register_boost, through
    the background thread or not."""
    _, cfg, _, bank = load_model_dir(MODEL_DIR)
    _, jcfg, _, jbank = jload_model_dir(MODEL_DIR)
    ds, jds = PDA.PairDataset(corpus[1]), JDA.PairDataset(corpus[1])
    ds.items[1] = (*ds.items[1][:3], np.full_like(ds.items[1][3], 300.0))
    jds.items[1] = (*jds.items[1][:3], np.full_like(jds.items[1][3], 300.0))
    port = PDA.make_pair_batcher(ds, cfg, bank, batch=4, frames=16, seed=9, prefetch=prefetch,
                                 register_boost=boost, device="cpu")
    ref = JDA.make_pair_batcher(jds, jcfg, jbank, batch=4, frames=16, seed=9, prefetch=prefetch,
                                register_boost=boost)
    for _ in range(3):
        got, want = next(port), next(ref)
        for k in ("audio16", "target24"):
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0,
                                       atol=RESAMPLED_ATOL)
        np.testing.assert_array_equal(got["f0_bin"].numpy(), np.asarray(want["f0_bin"]))
        assert sorted(got["cond"]) == sorted(want["cond"])
        for k, v in want["cond"].items():
            np.testing.assert_array_equal(got["cond"][k].numpy(), np.asarray(v), err_msg=k)


def _jax_reads(model_dir, out):
    """The JAX package's load_model_dir of model_dir with `out` as its
    weights: the tree and shapes of klatt8's, all finite."""
    d = os.path.join(os.path.dirname(out), "reload")
    shutil.copytree(model_dir, d)
    shutil.copy(out, os.path.join(d, "weights.npz"))
    _, _, trained, _ = jload_model_dir(d)
    _, _, ref, _ = jload_model_dir(model_dir)
    ft, fr = jflat(trained), jflat(ref)
    assert sorted(ft) == sorted(fr)
    assert all(np.shape(ft[k]) == np.shape(fr[k]) and np.isfinite(ft[k]).all() for k in fr)
    return ft, fr


def test_cli_train_writes_weights_the_jax_package_reads(tmp_path, capsys):
    out = str(tmp_path / "w.npz")
    PCLI.main(["train", "--model", MODEL_DIR, "--steps", "3", "--batch", "2", "--frames", "8",
               "--output", out, "--ckpt-dir", str(tmp_path / "ck"), "--save-every", "2",
               "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert [ln.split(":")[0] for ln in lines[:2]] == ["step 0", "step 2"]
    assert lines[-1].startswith("trained 3 steps; final loss ") and lines[-1].endswith(out)
    assert available_steps(str(tmp_path / "ck")) == [2, 3]
    ft, fr = _jax_reads(MODEL_DIR, out)
    assert any(not np.array_equal(ft[k], fr[k]) for k in fr)
    PCLI.main(["train", "--model", MODEL_DIR, "--steps", "4", "--batch", "2", "--frames", "8",
               "--output", out, "--ckpt-dir", str(tmp_path / "ck"), "--resume",
               "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "resumed from step 3" and lines[1].startswith("step 3:")
    assert available_steps(str(tmp_path / "ck")) == [2, 3, 4]


def test_cli_train_data_and_gan(corpus, tmp_path, capsys):
    out = str(tmp_path / "w.npz")
    PCLI.main(["train", "--model", MODEL_DIR, "--data", corpus[1], "--steps", "2", "--batch",
               "2", "--frames", "16", "--gan", "--output", out, "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "dataset: 3 utterances, " + lines[0].split(", ")[1]
    assert lines[1].startswith("step 0: g ") and ", f0 " in lines[1]
    _jax_reads(MODEL_DIR, out)
