"""The port's training demo (`beatrice_vst_tpu_torch/scripts/train_demo.py`)
on the CPU against the JAX library's `train` / `train_gan` called as the
repo's `scripts/train_demo.py` calls them, with the JAX package's draws
swapped into the port (student, teacher and bank at seeds 0, 1 and 2; the
critics at `PRNGKey(0)`, as `train_gan` draws them) and the batch reduced
to 2 x 16 frames through the module constant.

At 2 steps and 1 GAN step: the two logged distillation losses (the second
after one update) agree at `golden.train_gate`'s 1e-4 relative; the
resumed run starts where the JAX one does (its first logged step); and the
first GAN loss, from the same student (the port's after its resume, handed
to both), agrees at 1e-4.  The resumed run's ten updates are not compared
loss for loss: Adam's sign-like first steps amplify rounding (PR 17's
`tests/test_torch_train_real_jax.py`)."""

import tempfile

import jax
import numpy as np
import pytest
import torch

from beatrice_vst_tpu.constants import V20RC0 as JV20RC0
from beatrice_vst_tpu.models import chain as JC
from beatrice_vst_tpu.speakers import bank as JB
from beatrice_vst_tpu.training import discriminator as JDisc
from beatrice_vst_tpu.training import make_teacher_batcher as jbatcher
from beatrice_vst_tpu.training import train as jtrain
from beatrice_vst_tpu.training import train_gan as jtrain_gan
from beatrice_vst_tpu_torch import golden
from beatrice_vst_tpu_torch.models import chain as PC
from beatrice_vst_tpu_torch.models.io import params_from_numpy
from beatrice_vst_tpu_torch.scripts import train_demo as TD
from beatrice_vst_tpu_torch.speakers import bank as PB
from beatrice_vst_tpu_torch.training import discriminator as PDisc

torch.set_num_threads(1)

STEPS, GAN_STEPS, BATCH = 2, 1, 2


def numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(numpy_tree(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)


@pytest.fixture(scope="module")
def draws():
    cfg = JC.VoiceConverterConfig.for_version(JV20RC0)
    return {"cfg": cfg,
            "student": JC.init(jax.random.PRNGKey(0), cfg),
            "teacher": JC.init(jax.random.PRNGKey(1), cfg),
            "bank": JB.random_bank(jax.random.PRNGKey(2), JV20RC0, 4),
            "critics": JDisc.init(jax.random.PRNGKey(0))}


@pytest.fixture(scope="module")
def port_run(draws):
    """The port's demo with the JAX draws: (report, the calls made to
    train / train_gan with their histories, the draws' seeds)."""
    calls, seeds = [], []
    by_seed = {0: draws["student"], 1: draws["teacher"]}

    def jax_params(gen, cfg, device="cuda"):
        seeds.append(("params", gen.initial_seed()))
        return params_from_numpy(numpy_tree(by_seed[gen.initial_seed()]), device)

    def jax_bank(gen, spec, n_speakers, device="cuda"):
        seeds.append(("bank", gen.initial_seed(), n_speakers))
        return params_from_numpy(numpy_tree(draws["bank"]), device)

    def jax_critics(gen, device="cuda"):
        seeds.append(("critics", gen.initial_seed()))
        return params_from_numpy(numpy_tree(draws["critics"]), device)

    def recorded(fn, name):
        def call(params, cfg, batches, **kw):
            start = numpy_tree(params)
            out, hist = fn(params, cfg, batches, **kw)
            calls.append({"fn": name, "params": start, "kw": kw, "history": hist})
            return out, hist
        return call

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(PC, "init", jax_params)
        mp.setattr(PB, "random_bank", jax_bank)
        mp.setattr(PDisc, "init", jax_critics)
        mp.setattr(TD, "BATCH", BATCH)
        mp.setattr(TD, "train", recorded(TD.train, "train"))
        mp.setattr(TD, "train_gan", recorded(TD.train_gan, "train_gan"))
        report = TD.run(STEPS, GAN_STEPS, "cpu", log_fn=lambda _: None)
    return report, calls, seeds


@pytest.fixture(scope="module")
def jax_run(draws, port_run):
    """The JAX script's calls (`scripts/train_demo.py:48-63`) at the same
    settings; its GAN starts from the port's student after the resume."""
    cfg = draws["cfg"]
    batches = jbatcher(cfg, draws["teacher"], draws["bank"], batch=BATCH, frames=TD.FRAMES,
                       seed=0)
    quiet = dict(log_fn=lambda _: None)
    with tempfile.TemporaryDirectory() as ck:
        student, hist = jtrain(draws["student"], cfg, batches, steps=STEPS, lr=5e-4,
                               log_every=max(1, STEPS // 10), ckpt_dir=ck,
                               save_every=max(1, STEPS // 2), **quiet)
        _, hist2 = jtrain(student, cfg, batches, steps=STEPS + 10, lr=5e-4, log_every=5,
                          ckpt_dir=ck, resume=True, **quiet)
    gan_start = port_run[1][2]["params"]
    _, ghist = jtrain_gan(gan_start, cfg, batches, steps=GAN_STEPS, lr=1e-4,
                          log_every=max(1, GAN_STEPS // 5), **quiet)
    return {"hist": hist, "hist2": hist2, "ghist": ghist}


def test_calls_are_the_jax_scripts(port_run):
    report, calls, seeds = port_run
    assert seeds == [("params", 0), ("params", 1), ("bank", 2, 4), ("critics", 0)]
    assert [c["fn"] for c in calls] == ["train", "train", "train_gan"]
    first, resumed, gan = (c["kw"] for c in calls)
    assert (first["steps"], first["lr"], first["log_every"], first["save_every"]) == (
        STEPS, 5e-4, max(1, STEPS // 10), max(1, STEPS // 2))
    assert (resumed["steps"], resumed["lr"], resumed["log_every"], resumed["resume"]) == (
        STEPS + 10, 5e-4, 5, True)
    assert resumed["ckpt_dir"] == first["ckpt_dir"]
    assert (gan["steps"], gan["lr"], gan["log_every"]) == (GAN_STEPS, 1e-4,
                                                          max(1, GAN_STEPS // 5))
    assert set(report) == {"device", "distill", "resume", "gan", "converged"}
    assert report["distill"]["batch"] == BATCH and report["distill"]["frames_per_example"] == 16


def test_distillation_losses_equal_jax(port_run, jax_run):
    got, want = port_run[1][0]["history"], jax_run["hist"]
    assert [s for s, _ in got] == [s for s, _ in want] == [0, 1]
    for (_, g), (_, w) in zip(got, want):
        ok, dev, bound = golden.train_gate("distill/loss", g, w)
        assert ok, (g, w, dev, bound)


def test_resume_starts_where_the_jax_scripts_does(port_run, jax_run):
    report = port_run[0]
    got = port_run[1][1]["history"]
    assert [s for s, _ in got] == [s for s, _ in jax_run["hist2"]] == [5, 10, 11]
    assert report["resume"]["resumed_at"] == jax_run["hist2"][0][0]
    assert all(np.isfinite(v) for _, v in got)


def test_first_gan_loss_equals_jax(port_run, jax_run):
    got, want = port_run[1][2]["history"], jax_run["ghist"]
    assert [s for s, _ in got] == [s for s, _ in want] == [0]
    ok, dev, bound = golden.train_gate("gan/g_loss", got[0][1], want[0][1])
    assert ok, (got, want, dev, bound)
    assert port_run[0]["gan"]["g_loss_curve"] == [(0, round(got[0][1], 4))]
