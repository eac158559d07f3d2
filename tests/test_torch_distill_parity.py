"""The port's distillation-to-parity study (`beatrice_vst_tpu_torch/scripts/
distill_parity.py`) against the repo's `scripts/distill_parity.py` (the JAX
package), on the CPU.

- (a) `distill.cosine_decay` against `optax.cosine_decay_schedule` at the
  counts 0..n+2: bitwise at the step counts the study runs here (optax
  evaluates in float32, and so does the port), within 1e-7 relative plus
  1e-7 of the lr at the committed report's (float32's rounding of
  1 + cos near the end of the decay).
- (b) One pitch-anchored polish step on a JAX-drawn student (chain.init
  at seed 2) and the klatt8 teacher at 2 x 8 frames of corpus speech,
  against `jax.value_and_grad` of the JAX script's loss_fn (re-stated
  here): the loss at 1e-5 relative, the gradient per leaf at 1e-4 with
  the STFT term linearised at the JAX package's cotangent (the STFT's own
  gradient is ill-conditioned: tests/test_torch_training.py); the
  compiled step bitwise equal to its eager twin over two steps; the
  module phases' and the polish's optimizers against the JAX script's
  optax ones, three steps on the same gradients, at 1e-6.
- (c) The whole script against the JAX script, once, at the committed
  report's configuration scaled down (klatt8 teacher, 1 step a module,
  6 for pitch, 1 polish step, 2 x 32 frames, a 5-utterance corpus of
  the port's make_corpus: see SMALL for why not more), the port's
  `chain.init` swapped for the JAX draw at the generator's seed: every
  logged loss at `golden.train_gate`'s 1e-4 relative, every number of
  the baseline and of each phase's diagnostics at 1e-4 relative but the
  waveform maxima after the vocoder's updates (`MAXIMA_RTOL`: twice the
  JAX script's own jit-against-eager deviation), qp_match equal; the
  same report keys, gate_reached and limiting_factor; the committed JAX
  report unchanged.
- (d) The random-teacher path through the port alone at one step a
  phase: the seeds handed to chain.init (seed + 1, seed + 2) and
  random_bank (seed + 3), finite diagnostics, no kernel launch.
"""

import functools
import hashlib
import importlib.util
import json
import math
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from beatrice_vst_tpu.models import chain as JC
from beatrice_vst_tpu.models.io import flatten_params as jflat
from beatrice_vst_tpu.runtime.offline import ConversionSettings as JSettings
from beatrice_vst_tpu.runtime.offline import build_cond as jbuild_cond
from beatrice_vst_tpu.training import distill as JD
from beatrice_vst_tpu_torch import golden
from beatrice_vst_tpu_torch.models import chain as PC
from beatrice_vst_tpu_torch.models.io import flatten_params, load_model_dir, params_from_numpy
from beatrice_vst_tpu_torch.runtime.offline import ConversionSettings, build_cond
from beatrice_vst_tpu_torch.scripts import distill_parity as DP
from beatrice_vst_tpu_torch.scripts import make_corpus as MC
from beatrice_vst_tpu_torch.speakers import bank as PB
from beatrice_vst_tpu_torch.training import distill as PD
from test_torch_training import SAME_GRADS_ATOL

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KLATT8 = os.path.join(REPO, "models_demo", "klatt8")
JAX_SCRIPT = os.path.join(REPO, "scripts", "distill_parity.py")
JAX_REPORT = os.path.join(REPO, "docs", "DISTILL_PARITY_REPORT.json")
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
DIAG_RTOL = 1e-4
LR = 1e-3  # the study's default
# The committed report's configuration scaled down to one step a module
# (six for pitch) and one polish step.  Past one update of the vocoder the
# JAX script does not reproduce itself: Adam's first step moves an element
# with a near-zero gradient by about lr whatever the gradient's size, so a
# rounding difference flips its step (357 of the vocoder's 3.1e6 elements
# between the port and JAX), and every later gradient moves with it.  At
# three vocoder steps the JAX script run eagerly (jax.disable_jit) deviates
# from its jitted run by 3.5e-4 in the last loss and 1.0e-2 in the
# diagnostics after the polish, and a 6e-8 change of its input clips (the
# NumPy fallback of its resampler) moves its second polish loss by 1.5 %.
# After one update each, every loss and every mean-type diagnostic stays
# within 1e-4 of the JAX script (measured: at most 4.1e-5; the eager JAX
# run 7.2e-5, the NumPy fallback 6.3e-6).
SMALL = ["--teacher", KLATT8, "--steps-per-module", "1", "--pitch-steps-mult", "6",
         "--e2e-steps", "1", "--batch", "2", "--frames", "32"]
# The waveform maxima move with the largest single-sample change: after the
# phases that update the vocoder the JAX script's own eager run deviates
# from its jitted run by 1.2e-4 (after the vocoder phase) and 7.7e-4 (after
# the polish) in them, and the port is held to twice that (measured: 1.5e-4
# and 5.2e-4).
MAXIMA = ("wav_max", "wav_max_soft")
MAXIMA_RTOL = {"wg": 2.5e-4, "e2e_polish": 1.5e-3}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """5 utterances by 4 speakers, the speaker directories the study reads."""
    root = str(tmp_path_factory.mktemp("distill") / "corpus")
    MC.make_corpus(root, utts=5, speakers=4, eval_utts=1, pairs_per_utt=2, seed=0,
                   log=lambda _: None)
    return root


@functools.lru_cache(maxsize=None)
def jax_student(seed):
    """The JAX package's chain.init at PRNGKey(seed), as numpy arrays (an
    eager draw of ~13 s on the CPU, made once; callers copy it)."""
    return jax.tree_util.tree_map(np.asarray, JC.init(jax.random.PRNGKey(seed), JCFG))


_, PCFG, KLATT8_PARAMS, KLATT8_BANK = load_model_dir(KLATT8)
JCFG = JC.VoiceConverterConfig.for_version(PCFG.spec)


@pytest.mark.parametrize("n", [3, 6, 600, 1200])
@pytest.mark.parametrize("lr", [1e-3, 1e-4])
def test_cosine_decay_matches_optax(n, lr):
    want = optax.cosine_decay_schedule(lr, n)
    got = PD.cosine_decay(lr, n)
    counts = np.arange(n + 3, dtype=np.int32)
    w = np.asarray(want(jnp.asarray(counts)), np.float64)
    g = np.array([got(int(c)) for c in counts])
    assert g[0] == float(np.float32(lr)) and g[n] == 0.0 and g[n + 2] == 0.0
    if n <= 6:
        np.testing.assert_array_equal(g, w)
    np.testing.assert_allclose(g, w, rtol=1e-7, atol=1e-7 * lr)
    with pytest.raises(ValueError):
        PD.cosine_decay(lr, 0)


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def same_grads_deviation(popt, params, opt, jp, grads_fn, steps):
    """`steps` updates of the port's optimizer and of optax's (jitted) from
    the same parameters with the same gradients (JAX's, at optax's
    parameters): the largest |dp| over the steps (tests/test_torch_training
    .py:check_same_grads)."""
    @jax.jit
    def update(g, st, p):
        upd, st = opt.update(g, st, p)
        return optax.apply_updates(p, upd), st

    st, worst = opt.init(jp), 0.0
    for _ in range(steps):
        g = grads_fn(jp)
        for p, gl in zip(popt.leaves, jax.tree_util.tree_leaves(g)):
            p.grad = torch.from_numpy(np.array(gl))
        popt.step()
        jp, st = update(g, st, jp)
        got = flatten_params(params)
        for k, want in jflat(jp).items():
            worst = max(worst, float(np.abs(got[k].detach().numpy() - np.asarray(want)).max()))
    return worst


def j_polish_loss(p, audio16, cond, target24, t_qp_raw):
    """The JAX script's loss_fn (`scripts/distill_parity.py:162-177`)."""
    state = JC.init_state(JCFG, (audio16.shape[0],))
    pred, _, taps = JC.apply(p, JCFG, audio16, state, cond, with_taps=True)
    lg = taps["pitch_logits"]
    ce = -jnp.take_along_axis(jax.nn.log_softmax(lg, -1), t_qp_raw[..., None],
                              axis=-1)[..., 0].mean()
    return (JD.multi_resolution_stft_loss(pred, target24)
            + jnp.mean(jnp.abs(pred - target24)) + ce), pred


def test_polish_step_matches_jax(corpus, monkeypatch):
    clips = DP.load_clips(corpus)
    rng = np.random.default_rng(0)
    n16 = 8 * 160
    audio = np.stack([c[o: o + n16] for c in clips[:2]
                      for o in [int(rng.integers(len(c) - n16))]]).astype(np.float32)
    pbank = params_from_numpy(KLATT8_BANK, "cpu")
    cond = build_cond(None, PCFG, pbank, ConversionSettings(target_speaker=1), batch=2,
                      raw_kv=True)
    teacher = params_from_numpy(KLATT8_PARAMS, "cpu")
    batch = {"audio16": torch.from_numpy(audio), "cond": cond}
    t24, t_qp = DP.teacher_wav(teacher, PCFG, batch, jit=False)
    student = jax_student(2)

    jcond = jbuild_cond(JCFG, KLATT8_BANK, JSettings(target_speaker=1), batch=2)
    jt24, jtq = jnp.asarray(t24.numpy()), jnp.asarray(t_qp.numpy().astype(np.int32))

    @jax.jit
    def j_step(p):
        (loss, pred), grads = jax.value_and_grad(j_polish_loss, has_aux=True)(
            p, jnp.asarray(audio), jcond, jt24, jtq)
        return loss, grads, jax.grad(JD.multi_resolution_stft_loss)(pred, jt24)

    want, jgrads, c = j_step(student)
    full = {"audio16": batch["audio16"], "cond": cond, "target24": t24, "t_qp_raw": t_qp}

    # the compiled step against its eager twin, two steps, bitwise; the
    # first step's loss against the JAX script's
    runs = {}
    for jit in (True, False):
        s = PD.trainable(student, "cpu")
        opt = DP.polish_optimizer(s, LR)
        losses = [float(DP.polish_step(s, opt, full, cfg=PCFG, jit=jit)) for _ in range(2)]
        runs[jit] = (losses, flatten_params(s))
    assert runs[True][0] == runs[False][0]
    assert all(torch.equal(v, runs[False][1][k]) for k, v in runs[True][1].items())
    got = runs[False][0][0]
    assert abs(got - float(want)) <= LOSS_RTOL * abs(float(want)), (got, float(want))

    p = PD.trainable(student, "cpu")
    c = torch.from_numpy(np.array(c))
    with monkeypatch.context() as m:
        m.setattr(PD, "multi_resolution_stft_loss", lambda pred, t: torch.sum(pred * c))
        DP.polish_loss(p, PCFG, full).backward()
    jg = jflat(jgrads)
    worst = 0.0
    for k, leaf in flatten_params(p).items():
        if k.endswith("attn/k/b"):  # zero in exact arithmetic (test_torch_training)
            assert max(float(leaf.grad.norm()), float(jnp.linalg.norm(jg[k]))) < 1e-6
            continue
        worst = max(worst, rel(leaf.grad.numpy(), jg[k]))
        assert rel(leaf.grad.numpy(), jg[k]) <= GRAD_RTOL, (k, rel(leaf.grad.numpy(), jg[k]))
    print(f" worst |dg|/|g| {worst:.3g}", end="")

    # the phases' optimizers against optax's on the same gradients (JAX's
    # polish gradients of the phone module at optax's parameters), three
    # steps
    def grads(jp):
        return j_step({**student, "phone": jp})[1]["phone"]

    for port_opt, jax_opt in (
            (lambda p: DP.module_optimizer(p, LR, 3),
             optax.adamw(optax.cosine_decay_schedule(LR, 3), weight_decay=1e-3)),
            (lambda p: DP.polish_optimizer(p, LR), JD.make_optimizer(LR * 0.1))):
        params = PD.trainable(student["phone"], "cpu")
        same = same_grads_deviation(port_opt(params), params, jax_opt, student["phone"], grads,
                                    3)
        assert same <= SAME_GRADS_ATOL, same


def load_jax_script(root):
    """The JAX script as a module whose REPO is `root` (it writes
    root/docs/DISTILL_PARITY_REPORT.json)."""
    spec = importlib.util.spec_from_file_location("jax_distill_parity", JAX_SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.REPO = str(root)
    os.makedirs(os.path.join(root, "docs"), exist_ok=True)
    return mod


def close(got, want, rtol=DIAG_RTOL):
    return abs(got - want) <= rtol * abs(want)


def test_script_matches_the_jax_script(corpus, tmp_path, monkeypatch):
    with open(JAX_REPORT, "rb") as f:
        committed = hashlib.sha256(f.read()).hexdigest()
    jax_mod = load_jax_script(tmp_path / "jax")
    monkeypatch.setattr(sys, "argv", ["distill_parity.py", "--corpus", corpus, *SMALL])
    jax_mod.main()
    with open(tmp_path / "jax" / "docs" / "DISTILL_PARITY_REPORT.json") as f:
        want = json.load(f)

    seeds = []

    def jax_init(gen, cfg, device):
        seeds.append(gen.initial_seed())
        return params_from_numpy(jax_student(gen.initial_seed()), device)

    monkeypatch.setattr(PC, "init", jax_init)
    report = str(tmp_path / "port.json")
    assert DP.main(["--corpus", corpus, *SMALL, "--report", report, "--device", "cpu"]) == 0
    with open(report) as f:
        got = json.load(f)
    assert seeds == [2]

    assert set(want) <= set(got) and set(got) - set(want) == {"settings",
                                                              "upsampler_kernel_launches"}
    assert [p["module"] for p in got["phases"]] == [p["module"] for p in want["phases"]]
    for gp, wp in zip(got["phases"], want["phases"]):
        assert set(wp) <= set(gp) and gp["steps"] == wp["steps"], (gp, wp)
        assert [s for s, _ in gp["loss_curve"]] == [s for s, _ in wp["loss_curve"]]
        for (step, g), (_, w) in zip(gp["loss_curve"], wp["loss_curve"]):
            ok, dev, bound = golden.train_gate(f"{gp['module']}/loss", g, w)
            assert ok, (gp["module"], step, g, w, dev, bound)
    diagnostics = [("baseline", got["baseline"], want["baseline"])] + [
        (gp["module"], gp["e2e_after"], wp["e2e_after"])
        for gp, wp in zip(got["phases"], want["phases"])]
    for tag, g, w in diagnostics:
        assert sorted(g) == sorted(w), tag
        assert g["qp_match"] == w["qp_match"], (tag, g["qp_match"], w["qp_match"])
        rtol = {k: MAXIMA_RTOL.get(tag, DIAG_RTOL) if k in MAXIMA else DIAG_RTOL for k in w}
        bad = {k: (g[k], w[k], rtol[k]) for k in w if not close(g[k], w[k], rtol[k])}
        assert not bad, (tag, bad)
    assert got["gate_reached"] == want["gate_reached"]
    assert got["analysis"]["limiting_factor"] == want["analysis"]["limiting_factor"]
    assert sorted(got["soft_mode"]) == sorted(want["soft_mode"])
    assert got["soft_mode"]["gate_reached"] == want["soft_mode"]["gate_reached"]
    assert got["device"] == "cpu" and not any(got["upsampler_kernel_launches"].values())
    with open(JAX_REPORT, "rb") as f:
        assert hashlib.sha256(f.read()).hexdigest() == committed


def test_random_teacher_path(corpus, tmp_path, monkeypatch):
    inits, banks = [], []
    real_init, real_bank = PC.init, PB.random_bank

    def init(gen, cfg, device):
        inits.append(gen.initial_seed())
        return real_init(gen, cfg, device)

    def random_bank(gen, *args, **kw):
        banks.append(gen.initial_seed())
        return real_bank(gen, *args, **kw)

    monkeypatch.setattr(PC, "init", init)
    monkeypatch.setattr(PB, "random_bank", random_bank)
    report = str(tmp_path / "port.json")
    assert DP.main(["--corpus", corpus, "--seed", "4", "--steps-per-module", "1",
                    "--pitch-steps-mult", "1", "--e2e-steps", "1", "--batch", "2",
                    "--report", report, "--device", "cpu"]) == 0
    assert inits == [5, 6] and banks == [7]
    with open(report) as f:
        got = json.load(f)
    assert got["teacher"] == "random-init (held out)"
    assert [p["module"] for p in got["phases"]] == ["phone", "pitch", "wg", "e2e_polish"]
    assert all(len(p["loss_curve"]) == 1 for p in got["phases"])
    numbers = [v for p in got["phases"] for _, v in p["loss_curve"]] + [
        v for p in got["phases"] for v in p["e2e_after"].values()]
    assert all(math.isfinite(v) for v in numbers)
    assert not any(got["upsampler_kernel_launches"].values())
