"""The port's training script (`beatrice_vst_tpu_torch/scripts/
train_real_model.py`) against the repo's `scripts/train_real_model.py` (the
JAX package, in a subprocess writing only under the test's temporary
directory), on the CPU: two bursts with the r6 recipe's flags, each script
resuming its own copy of klatt8 on a tiny 8-speaker corpus, whose logged
losses agree at `golden.train_gate`'s 1e-4 relative.

The first burst runs 3 distillation steps: the warmup runs step 0 at lr 0,
so the loss logged at step 2 reads the schedule's peak.  The second resumes
the first (its distillation checkpoint covers --steps 3, so it starts from
the distilled weights) and runs one GAN step, whose loss reads the critic's
first update.  Each phase starts a process of its own because the JAX
batcher drops a batch its queue has held back for 1 s, so the batches
after a compile depend on the timing; a phase's first steps take the
batches made before it.  The port's critics are the JAX script's
(`discriminator.init` at --seed; the port's own draw differs).  The GAN's
later losses are not compared: the generator's gradients agree per leaf
only at 1e-2 (tests/test_torch_gan.py), Adam's sign-like first steps of
their smallest elements differ, and the two scripts' losses at the second
GAN step differ by 0.1-2 % on this corpus.  tests/test_torch_train_real.py
holds the arguments the scripts pass to the library (the GAN's lr among
them) equal."""

import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from beatrice_vst_tpu.training import discriminator as JDisc
from beatrice_vst_tpu_torch import golden
from beatrice_vst_tpu_torch.models.io import params_from_numpy
from beatrice_vst_tpu_torch.scripts import make_corpus as MC
from beatrice_vst_tpu_torch.training import discriminator as PDisc
from test_torch_train_real import KLATT8, R6, flags, jax_script, port

torch.set_num_threads(1)

SIDES = ("jax", "port")
# the report's settings, and each phase's step accounting
SETTINGS = ("f0_weight", "register_boost", "periodicity_weight", "soft_pitch", "lr_schedule",
            "batch", "frames_per_example", "train_speakers")
ACCOUNTING = ("steps", "steps_executed", "resumed_from_step")


@pytest.fixture(scope="module")
def corpus8(tmp_path_factory):
    """5 utterances by klatt8's 8 speakers, the last held out: 8 pairs,
    two of them of utterance 3, whose plan's mean voiced F0 (333 Hz) lies
    above the register ramp, so that --register-boost moves the draw."""
    root = str(tmp_path_factory.mktemp("tiny8") / "corpus")
    MC.make_corpus(root, utts=5, speakers=8, eval_utts=1, pairs_per_utt=2, seed=0,
                   log=lambda _: None)
    return root


def burst(corpus, tmp_path, steps, gan_steps):
    """Each side's burst; returns {side: (output, report)}."""
    out = {}
    for side in SIDES:
        argv = flags(corpus, str(tmp_path / side), "--resume", "--steps", str(steps),
                     "--gan-steps", str(gan_steps), *R6)
        code, text = jax_script(argv) if side == "jax" else port(argv)
        assert code == 0, (side, text[-2000:])
        with open(tmp_path / side / "report.json") as f:
            out[side] = (text, json.load(f))
    return out


def assert_curves_agree(reports, phase, curve, steps):
    got, want = reports["port"][phase][curve], reports["jax"][phase][curve]
    assert [s for s, _ in got] == [s for s, _ in want] == steps, (got, want)
    for (step, g), (_, w) in zip(got, want):
        ok, dev, bound = golden.train_gate(f"{phase}/loss", g, w)
        assert ok, (phase, step, g, w, dev, bound)
    for key in SETTINGS:
        assert reports["port"][key] == reports["jax"][key], key
    for key in ACCOUNTING:
        assert reports["port"][phase][key] == reports["jax"][phase][key], (phase, key)


def test_r6_bursts_losses_equal_the_jax_scripts(corpus8, tmp_path, monkeypatch):
    for side in SIDES:
        shutil.copytree(KLATT8, tmp_path / side / "model")
    first = burst(corpus8, tmp_path, 3, 0)
    reports = {side: report for side, (_, report) in first.items()}
    assert_curves_agree(reports, "distill", "loss_curve", [0, 2])

    critics = jax.tree_util.tree_map(np.asarray, JDisc.init(jax.random.PRNGKey(0)))
    seeds = []

    def jax_critics(gen, device):
        seeds.append(gen.initial_seed())
        return params_from_numpy(critics, device)

    monkeypatch.setattr(PDisc, "init", jax_critics)
    second = burst(corpus8, tmp_path, 3, 1)
    assert seeds == [0]
    reports = {side: report for side, (_, report) in second.items()}
    assert_curves_agree(reports, "gan", "g_loss_curve", [0])
    for side, (text, report) in second.items():
        assert "resume: distill from step 3 (0 to run), gan from 0 (1 to run)" in text, side
        assert report["distill"]["loss_curve"] == []
        assert [b["distill"]["steps_executed"] for b in report["bursts"]] == [3], side
