"""The port's per-module feature distillation
(`beatrice_vst_tpu_torch/training/feature_distill.py`) against the JAX
package's, on the CPU: 2.0.0-rc.0 teacher and student from the JAX
package's `init` (seeds 1 and 2), a random bank (seed 3), two streams of
four frames, as tests/test_feature_distill.py.

Gates: the teacher's taps at 1e-4 (the chain's module tolerance); each
module's loss at 1e-5 relative; its gradients per leaf at 1e-4 for the
phone and pitch modules and, for the vocoder, at 1e-4 with its STFT term
linearised at the JAX package's cotangent (the STFT's own gradient is
ill-conditioned: tests/test_torch_training.py); one module_step of each
module (optax.adam against the port's `Optimizer` with its betas and no
weight decay) at 1e-5 in the loss it reports; 8 steps of each reduce
their loss; the end-to-end diagnostics at 1e-4 relative, and exactly 0 /
1 for a student equal to its teacher."""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from beatrice_vst_tpu.constants import V20RC0 as JV20RC0
from beatrice_vst_tpu.models import chain as JC
from beatrice_vst_tpu.models.io import flatten_params as jflat
from beatrice_vst_tpu.runtime.offline import ConversionSettings as JSettings
from beatrice_vst_tpu.runtime.offline import build_cond as jbuild_cond
from beatrice_vst_tpu.speakers import bank as jbank_mod
from beatrice_vst_tpu.training import distill as JD
from beatrice_vst_tpu.training import feature_distill as JF
from beatrice_vst_tpu_torch.constants import V20RC0
from beatrice_vst_tpu_torch.models import chain as PC
from beatrice_vst_tpu_torch.models.io import flatten_params, params_from_numpy
from beatrice_vst_tpu_torch.runtime.offline import ConversionSettings, build_cond
from beatrice_vst_tpu_torch.training import distill as PD
from beatrice_vst_tpu_torch.training import feature_distill as PF

torch.set_num_threads(1)

JCFG = JC.VoiceConverterConfig.for_version(JV20RC0)
PCFG = PC.VoiceConverterConfig.for_version(V20RC0)
TOL = dict(rtol=1e-4, atol=1e-4)
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
LR = 1e-3


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.fixture(scope="module")
def setup():
    teacher = JC.init(jax.random.PRNGKey(1), JCFG)
    student = JC.init(jax.random.PRNGKey(2), JCFG)
    bank = jbank_mod.random_bank(jax.random.PRNGKey(3), JV20RC0, 4)
    audio = (0.1 * np.random.default_rng(0).standard_normal((2, 4 * 160))).astype(np.float32)
    jbatch = {"audio16": jnp.asarray(audio),
              "cond": jbuild_cond(JCFG, bank, JSettings(target_speaker=1), batch=2)}
    pbank = {k: v.float() for k, v in params_from_numpy(bank, "cpu").items()}
    pbatch = {"audio16": torch.from_numpy(audio),
              "cond": build_cond(None, PCFG, pbank, ConversionSettings(target_speaker=1), 2,
                                 raw_kv=True)}
    jtaps = jax.jit(lambda p, b: JF.teacher_taps(p, JCFG, b["audio16"], b["cond"]))(
        teacher, jbatch)
    with torch.no_grad():
        ptaps = PF.teacher_taps(params_from_numpy(teacher, "cpu"), PCFG, pbatch["audio16"],
                                pbatch["cond"])
    return teacher, student, jbatch, pbatch, jtaps, ptaps


def test_teacher_taps_match_jax(setup):
    *_, jtaps, ptaps = setup
    assert sorted(ptaps) == sorted(jtaps)
    for k, want in jtaps.items():
        got = ptaps[k]
        if k in ("qp", "qp_raw"):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        else:
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL, err_msg=k)


def _j_loss(module, cfg, taps, batch, linear_c=None):
    """The JAX package's loss of one module, with the vocoder's STFT term
    replaced by <audio, c> when linear_c is given."""
    a, cond = batch["audio16"], batch["cond"]
    if module == "phone":
        return lambda p: JF.phone_loss(p, cfg, a, taps["phone"], cond)
    if module == "pitch":
        return lambda p: JF.pitch_loss(p, cfg, a, taps["pitch_logits"], taps["pitch_feats"],
                                       cond)
    if linear_c is None:
        return lambda p: JF.wg_loss(p, cfg, taps, cond)
    from beatrice_vst_tpu.models import waveform_generator as JW

    def lin(p):
        y, _ = JW.apply(p, cfg.wg, taps["phone"], taps["qp"], taps["pitch_feats"],
                        cond["speaker_embedding"], JW.init_state(cfg.wg, (2,)),
                        kv_embedding=cond.get("kv"))
        t = taps["audio24"]
        return (jnp.mean(jnp.abs(y - t)) + 10.0 * jnp.mean((y - t) ** 2)
                + 0.1 * jnp.sum(y * linear_c))
    return lin


def _p_loss(module, taps, batch, linear_c=None):
    a, cond = batch["audio16"], batch["cond"]
    if module == "phone":
        return lambda p: PF.phone_loss(p, PCFG, a, taps["phone"], cond)
    if module == "pitch":
        return lambda p: PF.pitch_loss(p, PCFG, a, taps["pitch_logits"], taps["pitch_feats"],
                                       cond)
    if linear_c is None:
        return lambda p: PF.wg_loss(p, PCFG, taps, cond)
    from beatrice_vst_tpu_torch.models import waveform_generator as PW

    def lin(p):
        cfg = PD.trainer_config(PCFG)
        y, _ = PW.apply(p, cfg.wg, taps["phone"], taps["qp"], taps["pitch_feats"],
                        cond["speaker_embedding"], PW.init_state(cfg.wg, (2,), "cpu"),
                        kv_embedding=cond.get("kv"))
        t = taps["audio24"]
        return (torch.mean(torch.abs(y - t)) + 10.0 * torch.mean((y - t) ** 2)
                + 0.1 * torch.sum(y * torch.from_numpy(np.asarray(linear_c))))
    return lin


@pytest.mark.parametrize("module", ["phone", "pitch", "wg"])
def test_module_losses_and_gradients_match_jax(setup, module):
    teacher, student, jbatch, pbatch, jtaps, ptaps = setup
    want = float(jax.jit(_j_loss(module, JCFG, jtaps, jbatch))(student[module]))
    p = PD.trainable(student[module], "cpu")
    got = float(_p_loss(module, ptaps, pbatch)(p))
    assert abs(got - want) <= LOSS_RTOL * abs(want), (got, want)
    c = None
    if module == "wg":
        from beatrice_vst_tpu.models import waveform_generator as JW

        y, _ = JW.apply(student["wg"], JCFG.wg, jtaps["phone"], jtaps["qp"],
                        jtaps["pitch_feats"], jbatch["cond"]["speaker_embedding"],
                        JW.init_state(JCFG.wg, (2,)), kv_embedding=jbatch["cond"].get("kv"))
        c = jax.grad(JD.multi_resolution_stft_loss)(y, jtaps["audio24"])
    jg = jflat(jax.jit(jax.grad(_j_loss(module, JCFG, jtaps, jbatch, c)))(student[module]))
    _p_loss(module, ptaps, pbatch, c)(p).backward()
    worst = 0.0
    for k, leaf in flatten_params(p).items():
        if k.endswith("attn/k/b"):  # zero in exact arithmetic (test_torch_training)
            assert max(float(leaf.grad.norm()), float(jnp.linalg.norm(jg[k]))) < 1e-6
            continue
        worst = max(worst, rel(leaf.grad.numpy(), jg[k]))
        assert rel(leaf.grad.numpy(), jg[k]) <= GRAD_RTOL, (k, rel(leaf.grad.numpy(), jg[k]))
    print(f" worst |dg|/|g| {worst:.3g}", end="")


@pytest.mark.parametrize("module", ["phone", "pitch", "wg"])
def test_module_step_matches_optax_and_trains(setup, module):
    """module_step's reported loss against JAX's first step; 8 steps reduce
    it (tests/test_feature_distill.py)."""
    teacher, student, jbatch, pbatch, *_ = setup
    opt = optax.adam(LR)
    _, _, m = JF.module_step(student, opt.init(student[module]), teacher, jbatch, cfg=JCFG,
                             opt=opt, module=module)
    s = {k: PD.trainable(v, "cpu") for k, v in student.items()}
    popt = PD.Optimizer(s[module], LR, betas=(0.9, 0.999), weight_decay=0.0)
    tparams = params_from_numpy(teacher, "cpu")
    losses = []
    for _ in range(8):
        s, popt, pm = PF.module_step(s, popt, tparams, pbatch, cfg=PCFG, module=module)
        losses.append(float(pm["loss"]))
    assert abs(losses[0] - float(m["loss"])) <= LOSS_RTOL * float(m["loss"])
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses


def test_end_to_end_diagnostics_match_jax(setup):
    teacher, student, jbatch, pbatch, *_ = setup
    tparams, sparams = params_from_numpy(teacher, "cpu"), params_from_numpy(student, "cpu")
    for jfn, pfn in ((JF.end_to_end_error, PF.end_to_end_error),
                     (JF.end_to_end_error_soft, PF.end_to_end_error_soft)):
        want = jfn(student, teacher, jbatch, cfg=JCFG)
        got = pfn(sparams, tparams, pbatch, cfg=PCFG)
        assert sorted(got) == sorted(want)
        for k, w in want.items():
            np.testing.assert_allclose(float(got[k]), float(w), rtol=1e-4, atol=1e-7, err_msg=k)
    same = PF.end_to_end_error(tparams, tparams, pbatch, cfg=PCFG)
    assert float(same["wav_max"]) == 0.0 and float(same["qp_match"]) == 1.0
