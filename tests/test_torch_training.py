"""The port's distillation trainer (`beatrice_vst_tpu_torch/training/`:
distill, loop, checkpoint) against the JAX package's, on the CPU.

Gates: every loss at 1e-5 relative; gradients per leaf (|dg| / |g|) at
1e-4 for the chain's backward pass, driven by the whole objective with
its STFT term linearised at the JAX package's cotangent (the STFT's own
gradient is held separately against a float64 evaluation: it is
ill-conditioned at the spectral bins near zero, where JAX's eager and
jitted runs differ by 1.3e-3); parameters after 3 AdamW steps, with and
without the warmup-cosine schedule, at 1e-5; the train golden file
(`golden.run_train`) against a fresh JAX run, its distillation half here
and its GAN half in tests/test_torch_gan.py.  Run with -s to see the
measured numbers.

`PYTHONPATH=. python tests/test_torch_training.py` rewrites
tests/data/torch_train_golden.npz from the JAX package."""

import os
import re

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from beatrice_vst_tpu.models.io import flatten_params as jflat
from beatrice_vst_tpu.models.io import load_model_dir
from beatrice_vst_tpu.runtime import offline as JO
from beatrice_vst_tpu.training import checkpoint as JCk
from beatrice_vst_tpu.training import distill as JD
from beatrice_vst_tpu.training import loop as JL
from beatrice_vst_tpu_torch import golden
from beatrice_vst_tpu_torch.constants import V20RC0
from beatrice_vst_tpu_torch.models import chain as PC
from beatrice_vst_tpu_torch.models.io import flatten_params
from beatrice_vst_tpu_torch.training import checkpoint as PCk
from beatrice_vst_tpu_torch.training import distill as PD
from beatrice_vst_tpu_torch.training import loop as PL

torch.set_num_threads(1)

MODEL_DIR = os.path.join(os.path.dirname(__file__), "..", "models_demo", "klatt8")
GOLDEN = os.path.join(os.path.dirname(__file__), "data", "torch_train_golden.npz")
PCFG = PC.VoiceConverterConfig.for_version(V20RC0)
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
PARAM_ATOL = 1e-5


@pytest.fixture(scope="module")
def klatt8():
    _, jcfg, jparams, jbank = load_model_dir(MODEL_DIR)
    return jcfg, jparams, jbank


def jax_batch(jcfg, jbank, batch_np=None):
    """The golden batch for the JAX package: arrays and the JAX cond."""
    b = golden.train_batch() if batch_np is None else batch_np
    cond = JO.build_cond(jcfg, jbank, JO.ConversionSettings(target_speaker=golden.TRAIN_SPEAKER),
                         batch=b["audio16"].shape[0])
    return {**{k: jnp.asarray(b[k]) for k in ("audio16", "target24", "f0_bin")}, "cond": cond}


def jax_distill_vg(jcfg, batch):
    """Jitted (loss, aux), grads of the golden distillation objective."""
    return jax.jit(jax.value_and_grad(
        lambda p: JD.distillation_loss(p, jcfg, batch["audio16"], batch["target24"],
                                       batch["cond"], f0_bin=batch["f0_bin"],
                                       periodicity_weight=golden.TRAIN_PERIO),
        has_aux=True))


def jax_distill_golden(jcfg, jparams, jbank, vg=None):
    """The "batch/*" and "distill/*" numbers of the train golden file."""
    batch = jax_batch(jcfg, jbank)
    vg = vg or jax_distill_vg(jcfg, batch)
    (loss, aux), g = vg(jparams)
    out = {f"batch/{k}": v for k, v in golden.train_batch().items()}
    out["distill/loss"] = loss
    out.update({f"distill/{k}": v for k, v in aux.items()})
    out.update({f"distill/grad/{k}": jnp.linalg.norm(v) for k, v in jflat(g).items()})
    opt = JD.make_optimizer(golden.TRAIN_LR)
    upd, _ = opt.update(g, opt.init(jparams), jparams)
    out["distill/loss2"] = vg(optax.apply_updates(jparams, upd))[0][0]
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.fixture(scope="module")
def distill_run(klatt8):
    """The golden distillation objective in both packages: JAX's vg and
    its first result, the port's params (with grads), loss and terms."""
    jcfg, jparams, jbank = klatt8
    batch = jax_batch(jcfg, jbank)
    vg = jax_distill_vg(jcfg, batch)
    (jloss, jaux), jg = vg(jparams)
    pb = golden.train_inputs(PCFG, jbank, "cpu")
    params = PD.trainable(jparams, "cpu")
    loss, aux = PD.distillation_loss(params, PCFG, pb["audio16"], pb["target24"], pb["cond"],
                                     f0_bin=pb["f0_bin"], periodicity_weight=golden.TRAIN_PERIO)
    return {"vg": vg, "batch": batch, "jloss": jloss, "jaux": jaux, "jgrads": jflat(jg),
            "pbatch": pb, "params": params, "loss": loss, "aux": aux}


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def test_stft_loss_matches_jax():
    rng = np.random.default_rng(0)
    for n in (4800, 240):  # 240: shorter than every FFT, one clamped frame
        x, y = (rng.standard_normal((2, n)).astype(np.float32) for _ in range(2))
        want = float(JD.multi_resolution_stft_loss(jnp.asarray(x), jnp.asarray(y)))
        got = float(PD.multi_resolution_stft_loss(torch.from_numpy(x), torch.from_numpy(y)))
        assert abs(got - want) <= LOSS_RTOL * want, (n, got, want)
    assert float(PD.multi_resolution_stft_loss(torch.from_numpy(x), torch.from_numpy(x))) < 1e-5


def test_stft_gradient_no_worse_than_jax(distill_run):
    """The STFT term's gradient with respect to the prediction, for the
    chain's output on the golden batch: the port's distance to a float64
    evaluation of the same formula is at most the JAX package's."""
    pb = distill_run["pbatch"]
    with torch.no_grad():
        pred = PC.apply(distill_run["params"], PD.trainer_config(PCFG), pb["audio16"],
                        PC.init_state(PCFG, (2,), "cpu"), pb["cond"])[0].numpy()
    target = pb["target24"].numpy()
    want = np.asarray(jax.grad(JD.multi_resolution_stft_loss)(jnp.asarray(pred),
                                                                jnp.asarray(target)))
    grads = {}
    for dtype in (torch.float32, torch.float64):
        x = torch.from_numpy(pred).to(dtype).requires_grad_(True)
        PD.multi_resolution_stft_loss(x, torch.from_numpy(target).to(dtype)).backward()
        grads[dtype] = x.grad.numpy()
    port, jax_err = rel(grads[torch.float32], grads[torch.float64]), rel(want, grads[torch.float64])
    print(f" |d| to float64: port {port:.3g}, JAX {jax_err:.3g}", end="")
    assert port <= jax_err


def test_pitch_supervision_and_periodicity_match_jax():
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((2, 12, 448)).astype(np.float32)
    feats = rng.standard_normal((2, 12, 4)).astype(np.float32)
    f0_bin = rng.integers(0, 300, (2, 12)).astype(np.int32)
    pred = (0.3 * rng.standard_normal((2, 12 * 240))).astype(np.float32)

    def j_losses(lg, ft, pr):
        l_f0, l_voice = JD.pitch_supervision_losses({"pitch_logits": lg, "pitch_feats": ft},
                                                    jnp.asarray(f0_bin))
        return l_f0 + 2.0 * l_voice + 3.0 * JD.periodicity_loss(pr, jnp.asarray(f0_bin))

    want, jg = jax.value_and_grad(j_losses, argnums=(0, 1, 2))(
        jnp.asarray(logits), jnp.asarray(feats), jnp.asarray(pred))
    xs = [torch.from_numpy(a).requires_grad_(True) for a in (logits, feats, pred)]
    l_f0, l_voice = PD.pitch_supervision_losses({"pitch_logits": xs[0], "pitch_feats": xs[1]},
                                                torch.from_numpy(f0_bin))
    got = l_f0 + 2.0 * l_voice + 3.0 * PD.periodicity_loss(xs[2], torch.from_numpy(f0_bin))
    got.backward()
    assert abs(float(got) - float(want)) <= LOSS_RTOL * abs(float(want))
    for x, g in zip(xs, jg):
        assert rel(x.grad.numpy(), g) <= GRAD_RTOL
    np.testing.assert_array_equal(PD.f0_to_bin(np.array([0.0, 55.0, 220.0, 9e3]), 448),
                                  JD.f0_to_bin(np.array([0.0, 55.0, 220.0, 9e3]), 448))


def test_distillation_loss_matches_jax(distill_run):
    r = distill_run
    got = {"loss": r["loss"], **r["aux"]}
    want = {"loss": r["jloss"], **r["jaux"]}
    assert sorted(got) == sorted(want)
    for k in want:
        d = abs(float(got[k]) - float(want[k])) / abs(float(want[k]))
        assert d <= LOSS_RTOL, (k, float(got[k]), float(want[k]))


def test_distillation_gradients_match_jax(distill_run, klatt8):
    """Every leaf's gradient of the distillation objective with the STFT
    term replaced by its linearisation at the JAX cotangent c = dSTFT/dpred:
    l1 + f0 + voice + perio + <pred, c>.  That is the whole chain's
    backward pass (every leaf, the upsampler head included) at 1e-4.  The
    key biases of the attention blocks have a zero gradient in exact
    arithmetic (softmax over keys is shift-invariant): both packages'
    norms stay below 1e-6."""
    jcfg, jparams, _ = klatt8
    b = distill_run["batch"]
    from beatrice_vst_tpu.models import chain as JC

    def j_pred(p):
        return JC.apply(p, jcfg, b["audio16"], JC.init_state(jcfg, (2,)), b["cond"],
                        with_taps=True)

    pred0 = j_pred(jparams)[0]
    c = jax.grad(JD.multi_resolution_stft_loss)(pred0, b["target24"])

    def j_obj(p):
        pred, _, taps = j_pred(p)
        l_f0, l_voice = JD.pitch_supervision_losses(taps, b["f0_bin"])
        return (jnp.mean(jnp.abs(pred - b["target24"])) + l_f0 + l_voice
                + golden.TRAIN_PERIO * JD.periodicity_loss(pred, b["f0_bin"]) + jnp.sum(pred * c))

    jg = jflat(jax.jit(jax.grad(j_obj))(jparams))
    pb = distill_run["pbatch"]
    params = PD.trainable(jparams, "cpu")
    pred, _, taps = PC.apply(params, PD.trainer_config(PCFG), pb["audio16"],
                             PC.init_state(PCFG, (2,), "cpu"), pb["cond"], with_taps=True)
    l_f0, l_voice = PD.pitch_supervision_losses(taps, pb["f0_bin"])
    obj = (torch.mean(torch.abs(pred - pb["target24"])) + l_f0 + l_voice
           + golden.TRAIN_PERIO * PD.periodicity_loss(pred, pb["f0_bin"])
           + torch.sum(pred * torch.from_numpy(np.asarray(c))))
    obj.backward()
    worst = 0.0
    for k, p in flatten_params(params).items():
        g, want = p.grad.numpy(), np.asarray(jg[k])
        if k.endswith("attn/k/b"):
            assert max(np.linalg.norm(g), np.linalg.norm(want)) < 1e-6, k
            continue
        worst = max(worst, rel(g, want))
        assert rel(g, want) <= GRAD_RTOL, (k, rel(g, want))
    print(f" worst per-leaf |dg|/|g| {worst:.3g}", end="")


def test_schedule_matches_optax():
    for lr, total in ((2e-4, 3), (1e-3, 40), (2e-4, 10000)):
        want = optax.warmup_cosine_decay_schedule(0.0, lr, min(500, total // 10 + 1), total,
                                                  end_value=0.05 * lr)
        sched = PD.warmup_cosine(lr, total)
        for k in sorted({0, 1, 2, total // 2, total - 1, total, total + 3}):
            assert abs(sched(k) - float(want(k))) <= 1e-6 * lr, (lr, total, k)


# Adam moves each element by about lr * g / (|g| + eps), whatever the
# size of g: an element whose gradient is small flips its step with a
# rounding difference, and every gradient of the next step moves with it.
# So the optimizers are held to each other on the same gradients (JAX's,
# three steps), and the whole step end to end for one step, where an
# element with a gradient below ADAM_SMALL_GRAD is held to the most one
# step can move it (2 * lr; the attention key biases, whose gradients are
# rounding noise, are such elements).
ADAM_SMALL_GRAD = 1e-5
SAME_GRADS_ATOL = 1e-6


def check_adam_params(got_tree, want_tree, grads, lr):
    """Max |dp| after one step over the elements whose gradient (`grads`,
    the JAX package's, flat) is at least ADAM_SMALL_GRAD, each within
    PARAM_ATOL; the others within 2 * lr."""
    got, worst = flatten_params(got_tree), 0.0
    for k, want in jflat(want_tree).items():
        d = np.abs(got[k].detach().numpy() - np.asarray(want))
        small = np.abs(np.asarray(grads[k])) < ADAM_SMALL_GRAD
        assert d[small].max(initial=0.0) <= 2 * lr, k
        worst = max(worst, float(d[~small].max(initial=0.0)))
        assert worst <= PARAM_ATOL, (k, worst)
    return worst


def check_same_grads(popt, params, opt, jp, grads_fn, steps):
    """`steps` updates of the port's optimizer and of optax's from the same
    parameters with the same gradients (JAX's, at optax's parameters):
    the largest |dp| over the steps."""
    st, worst = opt.init(jp), 0.0
    for _ in range(steps):
        g = grads_fn(jp)
        for p, gl in zip(popt.leaves, jax.tree_util.tree_leaves(g)):
            p.grad = torch.from_numpy(np.array(gl))
        popt.step()
        upd, st = opt.update(g, st, jp)
        jp = optax.apply_updates(jp, upd)
        got = flatten_params(params)
        for k, want in jflat(jp).items():
            worst = max(worst, float(np.abs(got[k].detach().numpy() - np.asarray(want)).max()))
    return worst


@pytest.mark.parametrize("schedule", [False, True])
def test_train_steps_match_optax(distill_run, klatt8, schedule):
    """AdamW (b1 0.9, b2 0.99, weight decay 1e-2), with and without the
    warmup-cosine schedule (total_steps 3: step 0 has lr 0): three steps on
    the same gradients within 1e-6 of optax's, and one whole train_step
    within 1e-5 (see ADAM_SMALL_GRAD)."""
    _, jparams, _ = klatt8
    vg = distill_run["vg"]
    total = 3 if schedule else None
    opt = JD.make_optimizer(golden.TRAIN_LR, total_steps=total)
    params = PD.trainable(jparams, "cpu")
    popt = PD.make_optimizer(params, golden.TRAIN_LR, total_steps=total)
    same = check_same_grads(popt, params, opt, jparams, lambda p: vg(p)[1], 3)
    assert same <= SAME_GRADS_ATOL, same
    if schedule:
        return  # step 0 has lr 0: one whole step moves nothing
    params = PD.trainable(jparams, "cpu")
    popt = PD.make_optimizer(params, golden.TRAIN_LR, total_steps=total)
    (_, _), g = vg(jparams)
    upd, _ = opt.update(g, opt.init(jparams), jparams)
    PD.train_step(params, popt, distill_run["pbatch"], cfg=PCFG,
                  periodicity_weight=golden.TRAIN_PERIO)
    worst = check_adam_params(params, optax.apply_updates(jparams, upd), jflat(g),
                              golden.TRAIN_LR)
    print(f" same grads max |dp| {same:.3g}; one step max |dp| {worst:.3g}", end="")


def test_checkpoint_roundtrip_and_jax_restores_it(tmp_path):
    tree = {"b": [torch.zeros(4, dtype=torch.int32), 7],
            "a": torch.arange(6, dtype=torch.float32).reshape(2, 3)}
    d = str(tmp_path / "ckpts")
    for s in (5, 10, 15, 20):
        PCk.save_checkpoint(d, s, tree)
    assert PCk.latest_step(d) == 20 and PCk.available_steps(d) == [5, 10, 15, 20]
    PCk.prune_checkpoints(d, keep=3)
    assert PCk.available_steps(d) == JCk.available_steps(d) == [10, 15, 20]
    step, got = PCk.restore_checkpoint(d, tree)
    assert step == 20 and list(got) == ["b", "a"] and got["b"][1] == 7
    assert torch.equal(got["a"], tree["a"]) and got["b"][0].dtype == torch.int32
    # the JAX package's leaf order: its restore reads the port's file
    like = {"a": jnp.zeros((2, 3)), "b": [jnp.zeros(4, jnp.int32), 0]}
    step, jgot = JCk.restore_checkpoint(d, like, step=15)
    np.testing.assert_array_equal(np.asarray(jgot["a"]), tree["a"].numpy())
    assert step == 15 and jgot["b"][1] == 7
    with pytest.raises(ValueError):
        PCk.restore_checkpoint(d, {"a": tree["a"]})
    with pytest.raises(ValueError):
        PCk.restore_checkpoint(d, {"a": torch.zeros(3), "b": tree["b"]})
    with pytest.raises(FileNotFoundError):
        PCk.restore_checkpoint(str(tmp_path / "none"), tree)


def _batches(jcfg, jbank, n, port: bool, frames=8):
    out = []
    for i in range(n):
        b = golden.train_batch(seed=100 + i, frames=frames)
        out.append(golden.train_inputs(PCFG, jbank, "cpu", b) if port else jax_batch(jcfg, jbank, b))
    return out


def _norm_log(lines):
    """Log lines with the numbers and the seconds masked."""
    return [re.sub(r"\[[0-9.]+s\]", "[s]", re.sub(r"-?\d+\.\d{4}", "x", ln)) for ln in lines]


def test_train_matches_the_jax_loop(klatt8):
    """`train` with the schedule over the same 3 batches (f0 supervision
    and periodicity on): the JAX loop's history within 1e-5 relative and
    the same log lines."""
    jcfg, jparams, jbank = klatt8
    jlog, plog = [], []
    _, jh = JL.train(jparams, jcfg, iter(_batches(jcfg, jbank, 3, False)), steps=3,
                     log_every=1, log_fn=jlog.append, lr_schedule=True,
                     periodicity_weight=golden.TRAIN_PERIO)
    _, ph = PL.train(jparams, PCFG, iter(_batches(jcfg, jbank, 3, True)), steps=3,
                     log_every=1, log_fn=plog.append, lr_schedule=True,
                     periodicity_weight=golden.TRAIN_PERIO, device="cpu")
    assert [s for s, _ in ph] == [s for s, _ in jh] == [0, 1, 2]
    for (_, got), (_, want) in zip(ph, jh):
        assert abs(got - want) <= LOSS_RTOL * want, (got, want)
    assert _norm_log(plog) == _norm_log(jlog)


def test_resume_continues_the_trajectory(klatt8, tmp_path):
    """A checkpoint taken every 2 steps holds as many updates as its step
    says: resumed from the one at step 2, a run reproduces the straight
    run's steps 2-3 and its parameters (the AdamW moments, step counts and
    the schedule's count are in the checkpoint)."""
    jcfg, jparams, jbank = klatt8
    batches = _batches(jcfg, jbank, 4, True)
    kw = dict(steps=4, log_every=1, log_fn=lambda *_: None, lr_schedule=True, device="cpu")
    d = str(tmp_path / "ck")
    p_all, h_all = PL.train(jparams, PCFG, iter(batches), ckpt_dir=d, save_every=2, **kw)
    assert PCk.available_steps(d) == [2, 4]
    os.unlink(os.path.join(d, "ckpt_00000004.npz"))
    logs = []
    p_res, h_res = PL.train(jparams, PCFG, iter(batches[2:]), ckpt_dir=d, resume=True,
                            **{**kw, "log_fn": logs.append})
    assert logs[0] == "resumed from step 2"
    assert [s for s, _ in h_res] == [2, 3]
    for (_, a), (_, b) in zip(h_res, h_all[2:]):
        assert abs(a - b) <= 1e-6 * b
    for k, v in flatten_params(p_all).items():
        assert float((flatten_params(p_res)[k] - v).abs().max()) <= 1e-6, k
    assert PCk.latest_step(d) == 4


def test_frames_1_trains_the_upsampler_head(klatt8):
    """At one frame a batch (T = 1) the vocoder's head is the fused
    upsampler's route; the trainer takes its plain version, whose
    gradients reach every stage."""
    jcfg, jparams, jbank = klatt8
    assert PCFG.wg.upsampler_kernel and not PD.trainer_config(PCFG).wg.upsampler_kernel
    pb = golden.train_inputs(PCFG, jbank, "cpu", golden.train_batch(frames=1))
    params = PD.trainable(jparams, "cpu")
    opt = PD.make_optimizer(params)
    PD.train_step(params, opt, pb, cfg=PCFG)
    before = flatten_params(PD.trainable(jparams, "cpu"))
    for k, v in flatten_params(params).items():
        if k.startswith(("wg/up/", "wg/final/")) and not k.endswith("/b"):
            assert float((v - before[k]).abs().max()) > 0, k
    loss, _ = PD.distillation_loss(params, PCFG, pb["audio16"], pb["target24"], pb["cond"])
    loss.backward()
    for i in range(4):
        assert float(params["wg"]["up"][i]["conv"]["w"].grad.abs().max()) > 0


def test_golden_file_matches_jax(klatt8, distill_run):
    """The committed train golden file's batch and distillation numbers
    equal a fresh JAX run (the numbers to 1e-5 relative: XLA's CPU sums
    differ between thread counts), and the port's run is held to it by
    `golden.train_gate` at the CPU's loss tolerance."""
    jcfg, jparams, jbank = klatt8
    committed = golden.load(GOLDEN)
    fresh = jax_distill_golden(jcfg, jparams, jbank, distill_run["vg"])
    for k, v in fresh.items():
        if k.startswith("batch/"):
            np.testing.assert_array_equal(committed[k], v)
        elif "grad/" in k and k.endswith("attn/k/b"):
            assert committed[k] < golden.TRAIN_GRAD_ZERO
        else:
            np.testing.assert_allclose(committed[k], v, rtol=1e-5, err_msg=k)
    port = golden.run_train(PCFG, jparams, jbank, "cpu")
    assert {k for k in committed if not k.startswith("batch/")} == set(port)
    for k, got in port.items():
        ok, dev, bound = golden.train_gate(k, got, float(committed[k]), LOSS_RTOL)
        assert ok, (k, got, float(committed[k]), dev, bound)
    assert os.path.getsize(GOLDEN) < 300_000


if __name__ == "__main__":
    from test_torch_gan import jax_gan_golden

    _, jcfg, jparams, jbank = load_model_dir(MODEL_DIR)
    out = {**jax_distill_golden(jcfg, jparams, jbank), **jax_gan_golden(jcfg, jparams, jbank)}
    os.makedirs(os.path.dirname(GOLDEN), exist_ok=True)
    np.savez_compressed(GOLDEN, **out)
    print(f"wrote {GOLDEN} ({os.path.getsize(GOLDEN)} bytes)")
