"""The port's training script (`beatrice_vst_tpu_torch/scripts/
train_real_model.py`) on the CPU on a tiny corpus: a burst with the r6
recipe's flags (2 distillation and 1 GAN step) whose report has the JAX
report's keys and finite losses, the burst-append record, and the rules it
shares with the repo's `scripts/train_real_model.py` (run on the JAX
package in a subprocess, writing only under the test's temporary
directory): the refusal to clobber a model directory, the resume-and-skip
refusal, and the --speakers prefix rule and pair filter; the arguments
each script passes to the library's batcher and trainers (the JAX script
run in this process with those functions recorded); and the pair
batcher's sequence under a consumer slower than its queue's timeout.
tests/test_torch_train_real_jax.py holds the bursts' losses to the JAX
script's."""

import json
import os
import runpy
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import beatrice_vst_tpu.training as JT
from beatrice_vst_tpu_torch.models.io import flatten_params, load_model_dir, load_weights
from beatrice_vst_tpu_torch.scripts import make_corpus as MC
from beatrice_vst_tpu_torch.scripts import train_real_model as TR
from beatrice_vst_tpu_torch.training import PairDataset, make_pair_batcher

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_REPORT = os.path.join(REPO, "docs", "TRAIN_R6_REPORT.json")
KLATT8 = os.path.join(REPO, "models_demo", "klatt8")
JAX_SCRIPT = os.path.join(REPO, "scripts", "train_real_model.py")
R6 = ["--f0-weight", "4", "--register-boost", "3", "--periodicity-weight", "2"]
TINY = ["--batch", "2", "--frames", "32"]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tiny") / "corpus")
    MC.make_corpus(root, utts=3, speakers=2, eval_utts=1, pairs_per_utt=2, seed=0,
                   log=lambda _: None)
    return root


def flags(corpus, root, *extra):
    return ["--corpus", corpus, "--out", os.path.join(root, "model"),
            "--report", os.path.join(root, "report.json"),
            "--ckpt-dir", os.path.join(root, "ckpt"), *TINY, *extra]


def port(argv):
    """(exit code, output) of the port's script on the CPU."""
    lines = []
    try:
        TR.run(TR.parser().parse_args([*argv, "--device", "cpu"]), log=lines.append)
    except SystemExit as e:
        return (e.code if isinstance(e.code, int) else 1), str(e.code)
    return 0, "\n".join(lines)


# The JAX script leaves its batcher's thread running inside XLA when it
# returns, and the interpreter's shutdown then aborts the process: it is
# run to its end and left with os._exit.  An exception (SystemExit
# included) still ends it with its own code and message.
JAX_MAIN = ("import os, runpy, sys; sys.argv = sys.argv[1:]; "
            "runpy.run_path(sys.argv[0], run_name='__main__'); sys.stdout.flush(); "
            "sys.stderr.flush(); os._exit(0)")


def jax_script(argv):
    """(exit code, stdout + stderr) of the JAX package's script."""
    proc = subprocess.run([sys.executable, "-c", JAX_MAIN, JAX_SCRIPT, *argv],
                          capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, JAX_PLATFORMS="cpu"))
    return proc.returncode, proc.stdout + proc.stderr


def test_r6_burst_report_has_the_jax_reports_keys(corpus, tmp_path):
    argv = flags(corpus, str(tmp_path), "--steps", "2", "--gan-steps", "1", *R6)
    assert port(argv)[0] == 0
    with open(tmp_path / "report.json") as f:
        report = json.load(f)
    with open(JAX_REPORT) as f:
        want = json.load(f)
    assert set(want) - {"bursts"} <= set(report)  # bursts: from the second burst on
    for phase in ("distill", "gan"):
        assert set(want[phase]) <= set(report[phase]), phase
    assert report["device"] == "cpu" and report["corpus"]["n_pairs"] == 4
    assert (report["f0_weight"], report["register_boost"], report["periodicity_weight"],
            report["soft_pitch"], report["lr_schedule"]) == (4.0, 3.0, 2.0, True, True)
    assert [s for s, _ in report["distill"]["loss_curve"]] == [0, 1]
    assert [s for s, _ in report["gan"]["g_loss_curve"]] == [0]
    losses = [v for _, v in report["distill"]["loss_curve"] + report["gan"]["g_loss_curve"]]
    assert np.isfinite(losses).all()
    assert report["distill"]["steps_executed"] == 2 and report["gan"]["steps_executed"] == 1
    weights = flatten_params(load_weights(str(tmp_path / "model" / "weights.npz"), "cpu"))
    assert all(bool(torch.isfinite(v).all()) for v in weights.values())

    # a resumed burst to more steps runs only the new ones and keeps the
    # first burst's record
    argv = flags(corpus, str(tmp_path), "--steps", "3", "--gan-steps", "1", "--resume", *R6)
    code, out = port(argv)
    assert code == 0 and "resume: distill from step 2 (1 to run), gan from 1 (0 to run)" in out
    with open(tmp_path / "report.json") as f:
        second = json.load(f)
    assert second["distill"]["steps_executed"] == 1 and second["distill"]["resumed_from_step"] == 2
    assert set(want) <= set(second)
    assert [b["distill"]["steps_executed"] for b in second["bursts"]] == [2]


# what each script passes to the library, by call
PASSED = {
    "make_pair_batcher": ("batch", "frames", "seed", "register_boost"),
    "train": ("steps", "lr", "log_every", "ckpt_dir", "save_every", "resume", "f0_weight",
              "soft_pitch", "lr_schedule", "periodicity_weight"),
    "train_gan": ("steps", "lr", "seed", "log_every", "ckpt_dir", "save_every", "resume",
                  "soft_pitch", "periodicity_weight"),
}


def recorders(calls):
    """Stand-ins for the batcher and the trainers that record the
    arguments in PASSED and run nothing."""
    def record(name, value):
        def fn(first, cfg, *rest, **kw):
            calls[name] = {k: kw[k] for k in PASSED[name]}
            if name == "make_pair_batcher":
                calls["pairs"] = len(first.items)
            return value(first)
        return fn

    return {"make_pair_batcher": record("make_pair_batcher", lambda _: (b for b in ())),
            "train": record("train", lambda params: (params, [(0, 1.0)])),
            "train_gan": record("train_gan", lambda params: (params, [(0, 1.0)]))}


@pytest.mark.parametrize("extra", [
    ("--resume", "--steps", "1500", "--gan-steps", "400", *R6),
    ("--steps", "7", "--gan-steps", "3", "--lr", "3e-4", "--no-soft-pitch", "--no-lr-schedule",
     "--seed", "2", "--speakers", "0"),
], ids=["r6_resume", "fresh_options"])
def test_library_arguments_are_the_jax_scripts(corpus, tmp_path, monkeypatch, extra):
    """Both scripts in this process, their batcher and trainers recorded:
    the same arguments (the GAN at half the lr, each phase's checkpoint
    directory, the schedule, soft pitch, the loss weights, the register
    boost) and the same pairs; the JAX script as `python
    scripts/train_real_model.py` runs it."""
    calls = {}
    for side in ("jax", "port"):
        if "--resume" in extra:
            shutil.copytree(KLATT8, tmp_path / side / "model")
        argv = flags(corpus, str(tmp_path / side), *extra)
        calls[side] = {}
        with monkeypatch.context() as m:
            for name, fn in recorders(calls[side]).items():
                m.setattr(JT if side == "jax" else TR, name, fn)
            if side == "jax":
                m.setattr(sys, "argv", [JAX_SCRIPT, *argv])
                runpy.run_path(JAX_SCRIPT, run_name="__main__")
            else:
                assert port(argv)[0] == 0
        for name in ("train", "train_gan"):  # each side's directories lie under its root
            rec = calls[side][name]
            rec["ckpt_dir"] = os.path.relpath(rec["ckpt_dir"], tmp_path / side)
    assert calls["jax"] == calls["port"]
    assert calls["port"]["train_gan"]["lr"] == calls["port"]["train"]["lr"] * 0.5
    assert (calls["port"]["train"]["ckpt_dir"], calls["port"]["train_gan"]["ckpt_dir"]) == \
        ("ckpt", "ckpt_gan")


def test_clobber_refusal_is_the_jax_scripts(corpus, tmp_path):
    os.makedirs(tmp_path / "model")
    open(tmp_path / "model" / "weights.npz", "wb").close()
    argv = flags(corpus, str(tmp_path), "--steps", "1", "--gan-steps", "0")
    want = f"{tmp_path / 'model'} already holds a model; pass --resume to continue it or " \
           "--overwrite to re-initialize"
    jcode, jout = jax_script(argv)
    assert jcode == 1 and want in jout
    assert port(argv) == (1, want)


def test_resume_and_skip_refusal_is_the_jax_scripts(corpus, tmp_path):
    """Checkpoints at steps 2 (distill) and 1 (GAN) cover --steps 2
    --gan-steps 1: neither script runs (nor loads the checkpoints)."""
    root = str(tmp_path)
    assert port(flags(corpus, root, "--steps", "0", "--gan-steps", "0"))[0] == 0
    for d, step in (("ckpt", 2), ("ckpt_gan", 1)):
        os.makedirs(tmp_path / d)
        open(tmp_path / d / f"ckpt_{step:08d}.npz", "wb").close()
    argv = flags(corpus, root, "--steps", "2", "--gan-steps", "1", "--resume")
    want = ("resume-and-skip: checkpoints at step 2 (distill) / 1 (gan) already cover --steps 2 /"
            " --gan-steps 1; nothing would run. Clear the ckpt dirs for a fresh burst or raise the"
            " step targets.")
    jcode, jout = jax_script(argv)
    assert jcode == 1 and want in jout
    assert port(argv) == (1, want)


def test_speakers_prefix_and_filter_are_the_jax_scripts(corpus, tmp_path):
    """--speakers 1 is refused by both (not a prefix 0..k-1); --speakers 0
    keeps only the pairs between speaker 0 and itself, the same dataset in
    both, and makes a one-voice model."""
    bad = flags(corpus, str(tmp_path / "bad"), "--steps", "0", "--gan-steps", "0",
                "--speakers", "1")
    jcode, jout = jax_script(bad)
    assert jcode == 1 and "--speakers must be a contiguous prefix 0..k-1" in jout
    assert port(bad) == (1, "--speakers must be a contiguous prefix 0..k-1")

    good = ["--steps", "0", "--gan-steps", "0", "--speakers", "0"]
    jcode, jout = jax_script(flags(corpus, str(tmp_path / "jax"), *good))
    code, out = port(flags(corpus, str(tmp_path / "port"), *good))
    assert jcode == 0 and code == 0
    dataset = [ln for ln in out.splitlines() if ln.startswith("dataset:")]
    assert dataset and dataset[0] in jout
    names = [n[:-4] for n in os.listdir(os.path.join(corpus, "pairs", "inputs"))]
    keep = TR.speaker_filter([0])
    assert f"dataset: {sum(map(keep, names))} pairs" in dataset[0]
    assert TR.speaker_filter(None) is None
    with open(tmp_path / "port" / "report.json") as f:
        assert json.load(f)["train_speakers"] == [0]


def test_pair_batcher_keeps_its_sequence_under_a_slow_consumer(corpus):
    """A consumer that waits longer than the worker's 1 s put timeout (as a
    compile does) gets the same batches as one that does not: the worker
    keeps the batch it made until the queue takes it."""
    _, cfg, _, bank = load_model_dir(KLATT8)
    ds = PairDataset(os.path.join(corpus, "pairs"))

    def batches(pause):
        it = make_pair_batcher(ds, cfg, bank, batch=2, frames=16, seed=3, prefetch=1,
                               device="cpu")
        out = [next(it)]
        time.sleep(pause)
        out += [next(it), next(it)]
        it.close()
        return [b["audio16"] for b in out]

    for fast, slow in zip(batches(0.0), batches(1.5)):
        assert torch.equal(fast, slow)
