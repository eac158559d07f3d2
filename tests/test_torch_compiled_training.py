"""The compiled training steps of the port on the CPU: `train_step`,
`gan_train_step`, `module_step` for each module, the end-to-end
diagnostics and the teacher's forward, each a step of the step cache
(`beatrice_vst_tpu_torch/runtime/graphs.py`; one CUDA graph each on the
card, tests/test_torch_cuda.py).  Here a compiled step runs op by op over
its static tensors and is held to its eager twin (`jit=False`) exactly
over several steps: the parameters, the optimizer states and the metrics.
Also the capturable optimizer (its learning rate and step counts are
tensors; the learning rate follows the warmup-cosine schedule), the train
golden file's JAX numbers through the compiled steps (`golden.run_train`
with jit, at `golden.train_gate`'s 1e-4), and resume through the compiled
loop, bitwise.  The model is a shallow 2.0.0-rc.0 configuration from the
port's `chain.init` (2 streams of 8 frames); the golden test uses klatt8."""

import os

import pytest
import torch

from beatrice_vst_tpu_torch import golden
from beatrice_vst_tpu_torch.constants import V20RC0
from beatrice_vst_tpu_torch.models import chain as PC
from beatrice_vst_tpu_torch.models.io import load_weights
from beatrice_vst_tpu_torch.models.phone_extractor import PhoneExtractorConfig
from beatrice_vst_tpu_torch.models.pitch_estimator import PitchEstimatorConfig
from beatrice_vst_tpu_torch.runtime import graphs
from beatrice_vst_tpu_torch.speakers import bank as bank_mod
from beatrice_vst_tpu_torch.training import checkpoint, discriminator, distill, gan, loop
from beatrice_vst_tpu_torch.training import feature_distill as FD

torch.set_num_threads(1)

MODEL_DIR = os.path.join(os.path.dirname(__file__), "..", "models_demo", "klatt8")
CFG = PC.VoiceConverterConfig(
    spec=V20RC0, phone=PhoneExtractorConfig(phone_channels=V20RC0.phone_channels,
                                            dilations=(1, 2)),
    pitch=PitchEstimatorConfig(pitch_bins=V20RC0.pitch_bins, dilations=(1, 2)))
FRAMES = 8


@pytest.fixture(scope="module")
def model():
    params = PC.init(torch.Generator().manual_seed(0), CFG, "cpu")
    bank = bank_mod.random_bank(torch.Generator().manual_seed(1), V20RC0, 4, device="cpu")
    return params, bank


def _batch(bank, seed):
    return golden.train_inputs(CFG, bank, "cpu", golden.train_batch(seed=seed, frames=FRAMES))


def _same_tree(a, b):
    for x, y in zip(distill.tree_leaves(a), distill.tree_leaves(b), strict=True):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y)
        else:
            assert x == y


def _twins(params, make_opt):
    """Two copies of the trainable leaves, each with its own optimizer."""
    out = []
    for _ in range(2):
        p = distill.trainable(params, "cpu")
        out.append((p, make_opt(p)))
    return out


def test_optimizer_lr_and_steps_are_tensors_on_the_schedule(model):
    """The learning rate is one tensor that AdamW reads (what a captured
    update reads at its address) and that `prepare` sets from the
    schedule at the count of updates; the step counts are tensors on the
    leaves' device; the schedule's count round-trips through state_tree."""
    p = distill.trainable(model[0], "cpu")
    opt = distill.make_optimizer(p, 1e-3, total_steps=20)
    sched = distill.warmup_cosine(1e-3, 20)
    assert all(g["lr"] is opt.lr for g in opt.adamw.param_groups)
    for k in range(4):
        for leaf in opt.leaves:
            leaf.grad = torch.full_like(leaf, 0.01 * (k + 1))
        opt.step()
        assert opt.count == k + 1
        assert opt.lr.item() == torch.tensor(sched(k), dtype=opt.lr.dtype).item()
        assert all(leaf.grad is None for leaf in opt.leaves)
    steps = [s["step"] for s in opt.state_tree()["adamw"]]
    assert all(s.device == opt.leaves[0].device and float(s) == 4.0 for s in steps)
    twin = distill.make_optimizer(distill.trainable(model[0], "cpu"), 1e-3, total_steps=20)
    twin.load_state_tree(opt.state_tree())
    assert twin.count == 4
    _same_tree(twin.state_tree(), opt.state_tree())


@pytest.mark.parametrize("schedule", [False, True])
def test_train_step_compiled_equals_eager(model, schedule):
    params, bank = model
    (pc, oc), (pe, oe) = _twins(params, lambda p: distill.make_optimizer(
        p, 1e-3, total_steps=10 if schedule else None))
    before = graphs.CACHE.counters["captures"]
    for step in range(3):
        batch = _batch(bank, 100 + step)
        kw = dict(cfg=CFG, periodicity_weight=0.5)
        mc = distill.train_step(pc, oc, batch, jit=True, **kw)[-1]
        me = distill.train_step(pe, oe, batch, jit=False, **kw)[-1]
        assert mc.keys() == me.keys() == {"loss", "stft", "l1", "f0", "voice", "perio"}
        _same_tree(mc, me)
        _same_tree(pc, pe)
        _same_tree(oc.state_tree(), oe.state_tree())
    assert graphs.CACHE.counters["captures"] == before + 1


def test_gan_train_step_compiled_equals_eager(model):
    params, bank = model
    disc = discriminator.init(torch.Generator().manual_seed(2), "cpu")
    players = []
    for _ in range(2):
        g, d = distill.trainable(params, "cpu"), distill.trainable(disc, "cpu")
        players.append((g, d, *gan.make_gan_optimizers(g, d, 1e-3)))
    for step in range(2):
        batch = _batch(bank, 200 + step)
        mc = gan.gan_train_step(*players[0], batch, cfg=CFG, periodicity_weight=0.5,
                                jit=True)[-1]
        me = gan.gan_train_step(*players[1], batch, cfg=CFG, periodicity_weight=0.5,
                                jit=False)[-1]
        _same_tree(mc, me)
        for a, b in zip(players[0], players[1]):
            _same_tree(a.state_tree() if isinstance(a, distill.Optimizer) else a,
                       b.state_tree() if isinstance(b, distill.Optimizer) else b)


@pytest.mark.parametrize("module", ["phone", "pitch", "wg"])
def test_module_step_compiled_equals_eager(model, module):
    params, bank = model
    teacher = PC.init(torch.Generator().manual_seed(3), CFG, "cpu")
    twins = []
    for _ in range(2):
        student = distill.trainable(PC.init(torch.Generator().manual_seed(4), CFG, "cpu"), "cpu")
        twins.append((student, distill.Optimizer(student[module], 1e-3, betas=(0.9, 0.999),
                                                 weight_decay=0.0)))
    for step in range(2):
        batch = _batch(bank, 300 + step)
        mc = FD.module_step(*twins[0][:2], teacher, batch, cfg=CFG, module=module, jit=True)[-1]
        me = FD.module_step(*twins[1][:2], teacher, batch, cfg=CFG, module=module,
                            jit=False)[-1]
        _same_tree(mc, me)
        _same_tree(twins[0][0], twins[1][0])
        _same_tree(twins[0][1].state_tree(), twins[1][1].state_tree())


@pytest.mark.parametrize("fn", [FD.end_to_end_error, FD.end_to_end_error_soft])
def test_diagnostics_compiled_equal_eager(model, fn):
    params, bank = model
    teacher = PC.init(torch.Generator().manual_seed(3), CFG, "cpu")
    for seed in (400, 401):
        batch = _batch(bank, seed)
        _same_tree(fn(params, teacher, batch, cfg=CFG, jit=True),
                   fn(params, teacher, batch, cfg=CFG, jit=False))


def test_teacher_batcher_compiled_equals_eager(model):
    params, bank = model
    got, want = (loop.make_teacher_batcher(CFG, params, bank, batch=2, frames=FRAMES, seed=5,
                                           device="cpu", jit=jit) for jit in (True, False))
    for _ in range(3):
        a, b = next(got), next(want)
        _same_tree(a, b)


def test_compiled_train_golden_matches_jax():
    """The train golden file's numbers (the JAX package's, on klatt8)
    through the compiled distillation and GAN steps."""
    params = load_weights(os.path.join(MODEL_DIR, "weights.npz"), device="cpu")
    bank = bank_mod.load(os.path.join(MODEL_DIR, "speakers.npz"), V20RC0, device="cpu")
    committed = golden.load(os.path.join(os.path.dirname(__file__), "data",
                                         "torch_train_golden.npz"))
    port = golden.run_train(PC.VoiceConverterConfig.for_version(V20RC0), params, bank, "cpu",
                            jit=True)
    assert {k for k in committed if not k.startswith("batch/")} == set(port)
    for k, got in port.items():
        ok, dev, bound = golden.train_gate(k, got, float(committed[k]))
        assert ok, (k, got, float(committed[k]), dev, bound)


@pytest.mark.parametrize("gan_loop", [False, True], ids=["train", "train_gan"])
def test_compiled_loop_resumes_bitwise(model, tmp_path, gan_loop):
    """The compiled loop, checkpointed at step 2 and resumed, repeats the
    straight run's steps 2-3 and its parameters exactly; one step is
    captured for the whole run."""
    params, bank = model
    batches = [_batch(bank, 500 + k) for k in range(4)]
    run = loop.train_gan if gan_loop else loop.train
    kw = dict(steps=4, log_every=1, log_fn=lambda *_: None, device="cpu", jit=True)
    if not gan_loop:
        kw["lr_schedule"] = True
    d = str(tmp_path / "ck")
    before = graphs.CACHE.counters["captures"]
    p_all, h_all = run(params, CFG, iter(batches), ckpt_dir=d, save_every=2, **kw)
    assert graphs.CACHE.counters["captures"] == before + 1
    os.unlink(os.path.join(d, "ckpt_00000004.npz"))
    p_res, h_res = run(params, CFG, iter(batches[2:]), ckpt_dir=d, resume=True, **kw)
    assert [s for s, _ in h_res] == [2, 3] and h_res == h_all[2:]
    _same_tree(p_res, p_all)
    assert checkpoint.latest_step(d) == 4
