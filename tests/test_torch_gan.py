"""The port's adversarial trainer (`beatrice_vst_tpu_torch/training/`:
discriminator, gan, train_gan) against the JAX package's, on the CPU, on
klatt8 with the critics of `golden.disc_params` in both packages.

Gates: the critics' logits and feature maps at 1e-4 relative (the PCD's
oscillator channels at 2e-4 absolute: both packages sum the running phase
in f32, in different orders); each loss at 1e-5 relative; the critic's
gradients per leaf on the same fake audio at 1e-4 (MPD), 1e-3 (MRD) and
3e-2 (PCD), the generator's at 1e-2; optax's global-norm clip at 1e-6; the optimizers on the same
gradients at 1e-6 over two steps, one whole step's parameters at 1e-5 and
two steps' losses at 1e-5; the GAN
half of tests/data/torch_train_golden.npz against a fresh JAX run.  Run
with -s to see the measured numbers."""

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
from beatrice_vst_tpu.training import discriminator as JDisc
from beatrice_vst_tpu.training import gan as JG
from beatrice_vst_tpu_torch import golden
from beatrice_vst_tpu_torch.constants import V20RC0
from beatrice_vst_tpu_torch.models import chain as PC
from beatrice_vst_tpu_torch.models.io import flatten_params, params_from_numpy
from beatrice_vst_tpu_torch.training import checkpoint as PCk
from beatrice_vst_tpu_torch.training import discriminator as PDisc
from beatrice_vst_tpu_torch.training import distill as PD
from beatrice_vst_tpu_torch.training import gan as PG
from beatrice_vst_tpu_torch.training import loop as PL
from test_torch_training import (SAME_GRADS_ATOL, _batches, check_adam_params,
                                 check_same_grads, jax_batch)

torch.set_num_threads(1)

MODEL_DIR = os.path.join(os.path.dirname(__file__), "..", "models_demo", "klatt8")
GOLDEN = os.path.join(os.path.dirname(__file__), "data", "torch_train_golden.npz")
PCFG = PC.VoiceConverterConfig.for_version(V20RC0)
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
SPECTRAL_GRAD_RTOL = 1e-3
PCD_GRAD_RTOL = 3e-2
GEN_GRAD_RTOL = 1e-2


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def jax_gan_fns(jcfg, batch):
    """Jitted generator forward, critic (loss, grads) and generator
    ((loss, aux), grads) of the golden batch."""
    t24, fb = batch["target24"], batch["f0_bin"]
    return (jax.jit(lambda p: JG._generate(p, jcfg, batch)),
            jax.jit(jax.value_and_grad(lambda d, fake: JG.disc_loss(d, t24, fake, fb))),
            jax.jit(jax.value_and_grad(lambda p, d: JG.gen_loss(p, d, jcfg, batch),
                                       has_aux=True)))


def jax_gan_steps(jcfg, jparams, batch, fns, steps=2):
    """`steps` of JAX's gan_train_step on the golden batch and critics,
    from the jitted pieces: per step (d_loss, d_grads, g_loss, aux,
    g_grads), and the final (gen, disc)."""
    generate, d_vg, g_vg = fns
    disc = jax.tree_util.tree_map(jnp.asarray, golden.disc_params())
    gen_opt, disc_opt = JG.make_gan_optimizers(golden.TRAIN_LR)
    gen, gen_st, disc_st = jparams, gen_opt.init(jparams), disc_opt.init(disc)
    out = []
    for _ in range(steps):
        d_loss, dg = d_vg(disc, generate(gen))
        upd, disc_st = disc_opt.update(dg, disc_st, disc)
        disc = optax.apply_updates(disc, upd)
        (g_loss, aux), gg = g_vg(gen, disc)
        upd, gen_st = gen_opt.update(gg, gen_st, gen)
        gen = optax.apply_updates(gen, upd)
        out.append((d_loss, dg, g_loss, aux, gg))
    return out, (gen, disc)


def jax_gan_golden(jcfg, jparams, jbank, fns=None, steps=None):
    """The "gan/*" numbers of the train golden file."""
    batch = jax_batch(jcfg, jbank)
    if steps is None:
        steps, _ = jax_gan_steps(jcfg, jparams, batch, fns or jax_gan_fns(jcfg, batch))
    (d_loss, dg, g_loss, aux, gg), (d_loss2, _, g_loss2, _, _) = steps
    out = {"gan/d_loss": d_loss, "gan/g_loss": g_loss, "gan/d_loss2": d_loss2,
           "gan/g_loss2": g_loss2, **{f"gan/{k}": v for k, v in aux.items()}}
    out.update({f"gan/d_grad/{k}": jnp.linalg.norm(v) for k, v in jflat(dg).items()})
    out.update({f"gan/g_grad/{k}": jnp.linalg.norm(v) for k, v in jflat(gg).items()})
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.fixture(scope="module")
def klatt8():
    _, jcfg, jparams, jbank = load_model_dir(MODEL_DIR)
    return jcfg, jparams, jbank


@pytest.fixture(scope="module")
def jax_run(klatt8):
    jcfg, jparams, jbank = klatt8
    batch = jax_batch(jcfg, jbank)
    fns = jax_gan_fns(jcfg, batch)
    steps, final = jax_gan_steps(jcfg, jparams, batch, fns)
    return {"batch": batch, "fns": fns, "steps": steps, "final": final}


def test_critics_match_jax():
    """Every critic's logits and feature maps on one waveform and pitch
    track (the port's NCHW against the JAX package's NHWC); the PCD's
    input channels; the PCD stays out without f0_bin."""
    rng = np.random.default_rng(4)
    audio = (0.3 * rng.standard_normal((2, 12 * 240))).astype(np.float32)
    f0_bin = np.concatenate([np.zeros((2, 2)), rng.integers(60, 300, (2, 10))], 1).astype(np.int32)
    dnp = golden.disc_params()
    want = JDisc.apply(jax.tree_util.tree_map(jnp.asarray, dnp), jnp.asarray(audio),
                       f0_bin=jnp.asarray(f0_bin))
    got = PDisc.apply(params_from_numpy(dnp, "cpu"), torch.from_numpy(audio),
                      f0_bin=torch.from_numpy(f0_bin))
    assert len(got) == len(want) == len(PDisc.MPD_PERIODS) + len(PDisc.MRD_RESOLUTIONS) + 1
    worst = 0.0
    for (gl, gf), (wl, wf) in zip(got, want):
        for g, w in zip([gl, *gf], [wl, *wf]):
            g = g.permute(0, 2, 3, 1).numpy()
            assert g.shape == w.shape
            worst = max(worst, rel(g, w))
    print(f" worst |d|/|x| {worst:.3g}", end="")
    assert worst <= 1e-4
    ch_w = np.asarray(JDisc.pitch_phase_channels(jnp.asarray(audio), jnp.asarray(f0_bin)))
    ch_g = PDisc.pitch_phase_channels(torch.from_numpy(audio), torch.from_numpy(f0_bin)).numpy()
    np.testing.assert_allclose(ch_g, ch_w, rtol=0, atol=2e-4)
    assert np.abs(ch_g[:, :, :2, 1:]).max() == 0.0  # unvoiced frames: no oscillators
    assert len(PDisc.apply(params_from_numpy(dnp, "cpu"), torch.from_numpy(audio))) == len(got) - 1


def test_critic_init_tree_and_distribution():
    d = PDisc.init(torch.Generator().manual_seed(0), "cpu")
    want = jflat(jax.eval_shape(JDisc.init, jax.random.PRNGKey(0)))
    got = flatten_params(d)
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        assert tuple(v.shape) == tuple(want[k].shape), k
        if k.endswith("/w"):
            kh, kw, c_in, _ = v.shape
            assert float(v.abs().max()) <= 1.0 / np.sqrt(kh * kw * c_in)
        else:
            assert float(v.abs().max()) == 0.0


def test_clip_by_global_norm_matches_optax():
    rng = np.random.default_rng(5)
    for scale in (0.1, 100.0):
        gs = [(scale * rng.standard_normal(s)).astype(np.float32) for s in ((3, 4), (7,))]
        want, _ = optax.clip_by_global_norm(10.0).update([jnp.asarray(g) for g in gs], None)
        got = [torch.from_numpy(g.copy()) for g in gs]
        PD.clip_by_global_norm_(got, 10.0)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=0)


def test_losses_and_critic_gradients_match_jax(klatt8, jax_run):
    """The first step's losses, and the critic's gradients on the JAX
    package's own fake audio: each MPD leaf at 1e-4; the MRD's, whose input
    is the log of STFT magnitudes (ill-conditioned at the bins near zero),
    at 1e-3; the PCD's, whose oscillator channels each package sums in
    its own order (2e-4 apart), at 3e-2."""
    jcfg, jparams, jbank = klatt8
    d_loss, dg, g_loss, aux, _ = jax_run["steps"][0]
    pb = golden.train_inputs(PCFG, jbank, "cpu")
    fake = torch.from_numpy(np.asarray(jax_run["fns"][0](jparams)))
    d = PD.trainable(golden.disc_params(), "cpu")
    loss = PG.disc_loss(d, pb["target24"], fake, pb["f0_bin"])
    loss.backward()
    assert abs(float(loss) - float(d_loss)) <= LOSS_RTOL * float(d_loss)
    worst = {}
    for k, p in flatten_params(d).items():
        r = rel(p.grad.numpy(), jflat(dg)[k])
        critic = k.split("/")[0]
        worst[critic] = max(worst.get(critic, 0.0), r)
        bound = {"mpd": GRAD_RTOL, "mrd": SPECTRAL_GRAD_RTOL, "pcd": PCD_GRAD_RTOL}[critic]
        assert r <= bound, (k, r)
    print(f" worst critic |dg|/|g| {worst}", end="")
    # the generator's losses, after the same critic update as JAX's
    g = PD.trainable(jparams, "cpu")
    d = PD.trainable(golden.disc_params(), "cpu")
    gen_opt, disc_opt = PG.make_gan_optimizers(g, d, golden.TRAIN_LR)
    with torch.no_grad():
        fake = PG._generate(g, PCFG, pb)
    PG.set_grads(PG.disc_loss(d, pb["target24"], fake, pb["f0_bin"]), disc_opt)
    disc_opt.step()
    got, got_aux = PG.gen_loss(g, d, PCFG, pb)
    assert abs(float(got) - float(g_loss)) <= LOSS_RTOL * float(g_loss)
    for k, v in aux.items():
        assert abs(float(got_aux[k]) - float(v)) <= LOSS_RTOL * abs(float(v)), k


def test_gan_steps_match_optax(klatt8, jax_run):
    """The GAN optimizers (clip 10, then AdamW b1 0.8, b2 0.99 and optax's
    weight decay 1e-4) on the same gradients within 1e-6 of optax's over
    two steps; two whole gan_train_steps' losses at 1e-5 relative, and the
    critic's parameters after the first within 1e-5 (see
    test_torch_training.ADAM_SMALL_GRAD; the generator's gradient agrees
    only to its own tolerance below, so Adam's sign-like steps of its
    smallest elements differ)."""
    jcfg, jparams, jbank = klatt8
    batch = jax_run["batch"]
    generate, d_vg, g_vg = jax_run["fns"]
    disc = jax.tree_util.tree_map(jnp.asarray, golden.disc_params())
    jgen_opt, jdisc_opt = JG.make_gan_optimizers(golden.TRAIN_LR)
    g = PD.trainable(jparams, "cpu")
    d = PD.trainable(golden.disc_params(), "cpu")
    gen_opt, disc_opt = PG.make_gan_optimizers(g, d, golden.TRAIN_LR)
    assert gen_opt.adamw.param_groups[0]["weight_decay"] == 1e-4
    fake = generate(jparams)
    same = max(check_same_grads(disc_opt, d, jdisc_opt, disc, lambda p: d_vg(p, fake)[1], 2),
               check_same_grads(gen_opt, g, jgen_opt, jparams, lambda p: g_vg(p, disc)[1], 2))
    assert same <= SAME_GRADS_ATOL, same

    pb = golden.train_inputs(PCFG, jbank, "cpu")
    g = PD.trainable(jparams, "cpu")
    d = PD.trainable(golden.disc_params(), "cpu")
    gen_opt, disc_opt = PG.make_gan_optimizers(g, d, golden.TRAIN_LR)
    for i, (d_loss, dg, g_loss, _, gg) in enumerate(jax_run["steps"]):
        m = PG.gan_train_step(g, d, gen_opt, disc_opt, pb, cfg=PCFG)[-1]
        assert abs(float(m["d_loss"]) - float(d_loss)) <= LOSS_RTOL * float(d_loss)
        assert abs(float(m["g_loss"]) - float(g_loss)) <= LOSS_RTOL * float(g_loss)
        if i == 0:
            _, (_, disc1) = jax_gan_steps(jcfg, jparams, batch, jax_run["fns"], steps=1)
            worst = check_adam_params(d, disc1, jflat(dg), golden.TRAIN_LR)
    print(f" same grads max |dp| {same:.3g}; one critic step max |dp| {worst:.3g}", end="")


def test_generator_gradients_match_jax(klatt8, jax_run):
    """The generator's gradients of the first step (after the same critic
    update), per leaf at 1e-2: its loss reads the fake audio through the
    MRD's log-magnitudes and the PCD's running phase (see above), and its
    reconstruction term through the STFT's (tests/test_torch_training.py
    holds the chain's own backward pass at 1e-4); the final conv's bias,
    a scalar sum over the STFT's cotangent, at golden.TRAIN_GRAD_LOOSE.
    The attention key biases' gradients are rounding noise in both
    packages (below 1e-6)."""
    jcfg, jparams, jbank = klatt8
    pb = golden.train_inputs(PCFG, jbank, "cpu")
    g = PD.trainable(jparams, "cpu")
    d = PD.trainable(golden.disc_params(), "cpu")
    gen_opt, disc_opt = PG.make_gan_optimizers(g, d, golden.TRAIN_LR)
    with torch.no_grad():
        fake = PG._generate(g, PCFG, pb)
    PG.set_grads(PG.disc_loss(d, pb["target24"], fake, pb["f0_bin"]), disc_opt)
    disc_opt.step()
    PG.set_grads(PG.gen_loss(g, d, PCFG, pb)[0], gen_opt)
    want = jflat(jax_run["steps"][0][4])
    worst = 0.0
    for k, p in flatten_params(g).items():
        if k.endswith("attn/k/b"):
            assert max(float(p.grad.norm()), float(jnp.linalg.norm(want[k]))) < 1e-6, k
            continue
        r = rel(p.grad.numpy(), want[k])
        if k == "wg/final/b":  # a scalar sum of the STFT's cotangent: golden._LOOSE_GRADS
            assert r <= golden.TRAIN_GRAD_LOOSE, r
            continue
        worst = max(worst, r)
        assert r <= GEN_GRAD_RTOL, (k, r)
    print(f" worst |dg|/|g| {worst:.3g}", end="")


def test_train_gan_logs_and_resumes(klatt8, tmp_path):
    """`train_gan`: the JAX loop's log line, a checkpoint of generator,
    critics and both optimizers, and a resumed run that reproduces the
    straight run."""
    jcfg, jparams, jbank = klatt8
    batches = _batches(jcfg, jbank, 3, True, frames=4)
    kw = dict(steps=3, log_every=1, device="cpu")
    logs = []
    p_all, h_all = PL.train_gan(jparams, PCFG, iter(batches), log_fn=logs.append, **kw)
    pat = (r"step \d+: g \d+\.\d{4} d \d+\.\d{4} \(rec \d+\.\d{4}, fm \d+\.\d{4}, "
           r"adv \d+\.\d{4}, f0 \d+\.\d{4}, voice \d+\.\d{4}\) \[\d+\.\ds\]")
    assert len(logs) == 3 and all(re.fullmatch(pat, ln) for ln in logs), logs
    d = str(tmp_path / "ck")
    PL.train_gan(jparams, PCFG, iter(batches[:1]), ckpt_dir=d, log_fn=lambda *_: None,
                 **{**kw, "steps": 1})
    p_res, h_res = PL.train_gan(jparams, PCFG, iter(batches[1:]), ckpt_dir=d, resume=True,
                                log_fn=lambda *_: None, **kw)
    assert [s for s, _ in h_res] == [1, 2] and PCk.latest_step(d) == 3
    for (_, a), (_, b) in zip(h_res, h_all[1:]):
        assert abs(a - b) <= 1e-6 * b
    for k, v in flatten_params(p_all).items():
        assert float((flatten_params(p_res)[k] - v).abs().max()) <= 1e-6, k


def test_golden_file_gan_half_matches_jax(klatt8, jax_run):
    jcfg, jparams, jbank = klatt8
    committed = golden.load(GOLDEN)
    fresh = jax_gan_golden(jcfg, jparams, jbank, steps=jax_run["steps"])
    assert set(fresh) == {k for k in committed if k.startswith("gan/")}
    for k, v in fresh.items():
        if k.endswith("attn/k/b"):
            assert committed[k] < golden.TRAIN_GRAD_ZERO
        else:
            np.testing.assert_allclose(committed[k], v, rtol=1e-5, err_msg=k)
