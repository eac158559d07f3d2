"""The port's multi-device layer (`beatrice_vst_tpu_torch/parallel/`) on
the CPU: ranks are processes under one `gloo` group (`spawn_cpu_ranks`),
held against the port unsharded and against the JAX package on its
8-device CPU mesh (tests/conftest.py); mirrors tests/test_sharding.py and
the mesh case of tests/test_seqpar.py.

One 2-rank group and one 4-rank group run every case of the module, each
in one spawn (`parallel/checks.py:run_cases`), started in the background
while this process computes the references; each rank runs on one thread.

Gates:
  * the rules, leaf by leaf: the JAX package's specs on a
    {"streams": 4, "model": 2} mesh, exactly;
  * the stream-sharded tick (V20A2, capacity 8, 2 ranks): the port
    unsharded at 1e-6, the JAX package's sharded tick at
    tests/test_sharding.py's rtol 5e-3, atol 1e-5;
  * the production tick (2.0.0-rc.0, bf16, int8 slot bank and codebook):
    the port unsharded at tests/test_sharding.py's rtol 2e-2, atol 2e-3,
    its phase, gains and frame counters at rtol 1e-3, atol 1e-4; the JAX
    package's sharded ticks by the golden envelope of
    `beatrice_vst_tpu_torch.golden` (its deviation from the JAX f32 tick
    at most twice the JAX bf16 tick's): bf16 roundings taken in another
    order flip pitch bins and VQ neighbours, so no tight gate against the
    JAX bf16 tick would be honest;
  * the tensor-parallel stages (2 x 2 over 4 ranks): the JAX package at
    tests/test_sharding.py's per-stage tolerances, the port unsharded at
    1e-5;
  * the data-parallel distillation and GAN steps (2 ranks, 2 rows each,
    the halves with 12 and 10 voiced frames, so that a mean of the ranks'
    ratios would differ from the whole batch's) and the tensor-parallel
    distillation and GAN steps (2 x 2): the port's single-process step on the whole
    batch, losses at 1e-6, each leaf's gradient at GRAD_RTOL of the leaf's
    largest entry, the updated parameters at PARAM_ATOL; every rank's
    parameters bitwise equal.  The gradients of a weight are sums over the
    batch and time; split over the ranks they are summed in another order
    (measured 2.6e-6 of the leaf's largest entry on the plain products,
    1.9e-5 on the source projections, whose Chebyshev basis change
    multiplies by up to 2^7), and Adam's first step moves an element by
    lr * g / (|g| + eps), so an element whose gradient is within rounding
    of zero may move differently (measured 3.8e-6 at lr 2e-4);
  * seqpar on a 2-rank mesh: the sequential conversion at 1e-3 and the
    unsharded seqpar at 1e-6, where (s-1)*B divides and where it does not;
  * the dry run on 4 ranks; the bring-up over a tcp:// rendezvous.

Run alone: `python -m pytest tests/test_torch_parallel.py -q -p no:cacheprovider`
(about a minute on two cores).
"""

import functools
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as JP

from beatrice_vst_tpu import parallel as JPAR
from beatrice_vst_tpu.constants import V20A2 as JV20A2, V20RC0 as JV20RC0
from beatrice_vst_tpu.models import chain as JC
from beatrice_vst_tpu.models import phone_extractor as JPE
from beatrice_vst_tpu.models import pitch_estimator as JPI
from beatrice_vst_tpu.models import waveform_generator as JWG
from beatrice_vst_tpu.models.phone_extractor import PhoneExtractorConfig as JPhone
from beatrice_vst_tpu.models.pitch_estimator import PitchEstimatorConfig as JPitch
from beatrice_vst_tpu.runtime import EngineConfig as JEngineConfig
from beatrice_vst_tpu.runtime import StreamEngine as JStreamEngine
from beatrice_vst_tpu.runtime import engine_tick as jengine_tick
from beatrice_vst_tpu.runtime import init_engine_state as jinit_engine_state
from beatrice_vst_tpu.speakers import bank as jbank_mod
from beatrice_vst_tpu_torch import golden
from beatrice_vst_tpu_torch.constants import V20RC0
from beatrice_vst_tpu_torch.models import chain as PC
from beatrice_vst_tpu_torch.models.io import flatten_params
from beatrice_vst_tpu_torch.models.phone_extractor import PhoneExtractorConfig
from beatrice_vst_tpu_torch.models.pitch_estimator import PitchEstimatorConfig
from beatrice_vst_tpu_torch.parallel import (MODEL_PARALLEL_RULES, P, checks, params_sharding,
                                             spawn_cpu_ranks, state_sharding)
from beatrice_vst_tpu_torch.parallel.dryrun import dryrun_rank
from beatrice_vst_tpu_torch.runtime.engine import EngineConfig, init_engine_state
from beatrice_vst_tpu_torch.runtime.offline import ConversionSettings, convert_utterance

torch.set_num_threads(1)

A2, RC0 = "2.0.0-alpha.2", "2.0.0-rc.0"
CAP = 8
GRAD_RTOL = 5e-5
PARAM_ATOL = 2e-5
STEP_ATOL = 1e-6


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _shallow(phone_cls, pitch_cls, chain_mod):
    """tests/test_seqpar.py's shallow 2.0.0-rc.0 (receptive field 29 frames)."""
    return chain_mod.VoiceConverterConfig(
        spec=V20RC0, phone=phone_cls(phone_channels=V20RC0.phone_channels, dilations=(1, 2)),
        pitch=pitch_cls(pitch_bins=V20RC0.pitch_bins, dilations=(1, 2)))


def _inputs():
    """Every case's inputs as numpy: the JAX package's parameters and banks
    (as tests/test_sharding.py draws them) and numpy-seeded signals."""
    rng = np.random.default_rng(0)
    a2 = JC.VoiceConverterConfig.for_version(JV20A2)
    rc0 = JC.VoiceConverterConfig.for_version(JV20RC0)
    batch = golden.train_batch(batch=4, frames=16)
    batch["f0_bin"][3, 2:4] = 0  # voiced frames 12, 12 | 12, 10
    shallow = _shallow(JPhone, JPitch, JC)
    t = np.arange(128 * 160) / 16000.0
    utt = 0.3 * np.sin(2 * np.pi * 150 * t) * (1 + 0.3 * np.sin(2 * np.pi * 3 * t))
    return {
        "a2": _np(JC.init(jax.random.PRNGKey(0), a2)),
        "a2_bank": _np(jbank_mod.random_bank(jax.random.PRNGKey(1), JV20A2, 3)),
        "rc0": _np(JC.init(jax.random.PRNGKey(0), rc0)),
        "rc0_bank": _np(jbank_mod.random_bank(jax.random.PRNGKey(1), JV20RC0, 3)),
        "x": (rng.standard_normal((CAP, 480)) * 0.1).astype(np.float32),
        "stage_audio": (rng.standard_normal((8, 4 * 160)) * 0.1).astype(np.float32),
        "stage_spk": (rng.standard_normal((8, 256)) * 0.1).astype(np.float32),
        "batch": batch,
        "disc": golden.disc_params(),
        "shallow": _np(JC.init(jax.random.PRNGKey(0), shallow)),
        "shallow_bank": _np(jbank_mod.random_bank(jax.random.PRNGKey(1), JV20RC0, 4)),
        "utt": (utt + 0.02 * rng.standard_normal(t.size)).astype(np.float32),
    }


def _cases(inp):
    """(2-rank cases, 4-rank cases, the unsharded runs of the same cases)."""
    shallow = _shallow(PhoneExtractorConfig, PitchEstimatorConfig, PC)
    settings = ConversionSettings(target_speaker=1, pitch_shift=3.0, vq_num_neighbors=2)
    tick = dict(params=inp["a2"], bank=inp["a2_bank"], audio=inp["x"][None], version=A2,
                capacity=CAP)
    prod = dict(params=inp["rc0"], bank=inp["rc0_bank"], audio=inp["x"][None], version=RC0,
                capacity=CAP, admit="all", engine_kw={"compute_dtype": "bfloat16"})
    distill = dict(params=inp["a2"], bank=inp["a2_bank"], batch=inp["batch"], version=A2)
    gan = dict(distill, disc=inp["disc"])
    stages = dict(params=inp["a2"], audio=inp["stage_audio"], spk=inp["stage_spk"], version=A2)
    seqpar = {f"seqpar_{n}": dict(params=inp["shallow"], bank=inp["shallow_bank"],
                                  audio=inp["utt"], rate=16000, n_segments=n, cfg=shallow,
                                  settings=settings)
              for n in (3, 4)}  # (s-1)*B = 2 divides by 2 ranks; 3 does not
    two = [("bringup", checks.bringup_case, {"mesh_shape": (2, 1)}),
           ("refusal", checks.refusal_case, {}),
           ("tick", checks.tick_case, dict(tick, mesh_shape=(2, 1))),
           ("prod", checks.tick_case, dict(prod, mesh_shape=(2, 1))),
           ("distill", checks.distill_case, dict(distill, mesh_shape=(2, 1))),
           ("gan", checks.gan_case, dict(gan, mesh_shape=(2, 1)))]
    two += [(k, checks.seqpar_case, dict(v, mesh_shape=(2, 1))) for k, v in seqpar.items()]
    four = [("stages", checks.stages_case, dict(stages, mesh_shape=(2, 2))),
            ("distill_tp", checks.distill_case, dict(distill, mesh_shape=(2, 2),
                                                    model_parallel=True)),
            ("gan_tp", checks.gan_case, dict(gan, mesh_shape=(2, 2), model_parallel=True)),
            ("dryrun", dryrun_rank, {"rank": None, "n_devices": 4}),
            ("bringup", checks.bringup_case, {"mesh_shape": (2, 2)})]
    plain = [("tick", checks.tick_case, tick), ("prod", checks.tick_case, prod),
             ("distill", checks.distill_case, distill), ("gan", checks.gan_case, gan),
             ("stages", checks.stages_case, stages)]
    plain += [(k, checks.seqpar_case, v) for k, v in seqpar.items()]
    return two, four, plain, shallow, settings


class _Spawn(threading.Thread):
    """spawn_cpu_ranks in a thread: the ranks run while this process
    computes the references."""

    def __init__(self, n, cases):
        super().__init__(daemon=True)
        self.n, self.cases, self.result, self.error = n, cases, None, None
        self.start()

    def run(self):
        try:
            self.result = spawn_cpu_ranks(self.n, checks.run_cases, "cpu", self.cases)
        except BaseException as e:  # handed to the test that reads it
            self.error = e

    def get(self):
        self.join()
        if self.error is not None:
            raise self.error
        return self.result


def _jax_refs(inp):
    """The JAX package's runs: the V20A2 and the production tick sharded on
    the 8-device mesh (tests/test_sharding.py), the unsharded stages."""
    out = {}
    mesh = JPAR.make_mesh(streams=8, model=1)
    x = jnp.asarray(inp["x"])
    sx = jax.device_put(x, NamedSharding(mesh, JP("streams", None)))

    cfg = JEngineConfig.realtime(CAP, JV20A2)
    state = jinit_engine_state(cfg)
    state["controls"]["active"] = jnp.ones(CAP, bool)
    tick = jax.jit(functools.partial(jengine_tick, cfg=cfg))
    with mesh:
        o, _ = tick(inp["a2"], inp["a2_bank"],
                    JPAR.shard_tree(state, JPAR.state_sharding(state, mesh)), sx)
    out["tick"] = np.asarray(o)

    for key, kw in (("prod", {"compute_dtype": "bfloat16"}), ("prod_f32", {})):
        cfg = JEngineConfig.realtime(CAP, JV20RC0, **kw)
        eng = JStreamEngine(cfg, inp["rc0"], inp["rc0_bank"], jit=False)
        for _ in range(CAP):
            eng.admit()
        eng.flush_controls()
        tick = jax.jit(functools.partial(jengine_tick, cfg=cfg))
        with mesh:
            o, _ = tick(inp["rc0"], eng.bank,
                        JPAR.shard_tree(eng.state, JPAR.state_sharding(eng.state, mesh,
                                                                        capacity=CAP)), sx)
        out[key] = np.asarray(o)

    cfg = JC.VoiceConverterConfig.for_version(JV20A2)
    p = inp["a2"]
    audio = jnp.asarray(inp["stage_audio"])
    st = JC.init_state(cfg, (audio.shape[0],))
    phone, _ = jax.jit(JPE.apply, static_argnums=(1,))(p["phone"], cfg.phone, audio,
                                                         st["phone"])
    qp, feats, _, logits = jax.jit(JPI.apply, static_argnums=(1,),
                                   static_argnames=("with_logits",))(
        p["pitch"], cfg.pitch, audio, st["pitch"], with_logits=True)
    wav, _ = jax.jit(JWG.apply, static_argnums=(1,))(p["wg"], cfg.wg, phone, qp, feats,
                                                      jnp.asarray(inp["stage_spk"]), st["wg"])
    out["stages"] = {k: np.asarray(v) for k, v in
                     dict(phone=phone, qp=qp, feats=feats, logits=logits, wav=wav).items()}
    return out


@pytest.fixture(scope="module")
def runs():
    """Both groups' results, the port's unsharded runs and the JAX
    package's, computed once for the module."""
    inp = _inputs()
    two, four, plain, shallow, settings = _cases(inp)
    groups = {2: _Spawn(2, two), 4: _Spawn(4, four)}
    ref = {name: fn(device="cpu", **kw) for name, fn, kw in plain}
    ref["sequential"] = convert_utterance(inp["shallow"], shallow, inp["shallow_bank"],
                                          inp["utt"], 16000, settings, chunk_frames=0,
                                          device="cpu")
    return {"inputs": inp, "ref": ref, "jax": _jax_refs(inp),
            2: groups[2].get(), 4: groups[4].get()}


def _spec_tree_paths(tree, prefix=""):
    """{path: spec} of a tree of specs (a spec is a tuple: not descended)."""
    if isinstance(tree, P):
        return {prefix: tuple(tree)}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        out.update(_spec_tree_paths(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _jax_specs(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(
        x, NamedSharding))
    out = {}
    for keypath, s in flat:
        parts = [str(getattr(k, "key", getattr(k, "idx", k))) for k in keypath]
        out["/".join(parts)] = tuple(s.spec)
    return out


# ---- 1-2: mesh axes and the rules, leaf by leaf ----

def test_mesh_axes(runs):
    for rank, res in enumerate(runs[2]):
        assert res["bringup"]["coords"] == {"streams": rank, "model": 0}
    for rank, res in enumerate(runs[4]):
        assert res["bringup"]["coords"] == {"streams": rank // 2, "model": rank % 2}
    assert P(None, "model") == (None, "model") and P() == ()


@pytest.mark.parametrize("model_parallel", [False, True])
def test_params_sharding_matches_jax(model_parallel):
    cfg = JC.VoiceConverterConfig.for_version(JV20RC0)
    params = JC.init(jax.random.PRNGKey(0), cfg)
    jmesh = JPAR.make_mesh(streams=4, model=2)
    want = _jax_specs(JPAR.params_sharding(params, jmesh, model_parallel=model_parallel))
    got = _spec_tree_paths(params_sharding(_np(params), {"streams": 4, "model": 2},
                                           model_parallel=model_parallel))
    assert got == want
    port = flatten_params(PC.init(torch.Generator().manual_seed(0),
                                  PC.VoiceConverterConfig.for_version(V20RC0), "cpu"))
    ported = _spec_tree_paths(params_sharding(port, {"streams": 4, "model": 2},
                                              model_parallel=model_parallel))
    assert ported == {k: want[k] for k in ported} and set(ported) == set(want)
    if model_parallel:
        import re

        matched = [k for k in want if any(re.search(r, k) for r, _ in MODEL_PARALLEL_RULES)]
        assert len(matched) > 20 and all(k in port for k in matched)
        assert want["phone/blocks/0/mlp_in/w"] == (None, "model")
        assert want["phone/blocks/0/mlp_out/w"] == ("model", None)
        assert want["phone/out_ln/g"] == ()


@pytest.mark.parametrize("capacity", [None, CAP])
def test_state_sharding_matches_jax(capacity):
    """The port's rule on the JAX engine's state gives the JAX specs leaf by
    leaf; on the port's own state, the same specs wherever a path and its
    shape are shared."""
    jcfg = JEngineConfig.realtime(CAP, JV20RC0, compute_dtype="bfloat16")
    jstate = jinit_engine_state(jcfg)
    jmesh = JPAR.make_mesh(streams=4, model=2)
    want = _jax_specs(JPAR.state_sharding(jstate, jmesh, capacity=capacity))
    sizes = {"streams": 4, "model": 2}
    got = _spec_tree_paths(state_sharding(_np(jstate), sizes, capacity=capacity))
    assert got == want
    pstate = init_engine_state(EngineConfig.realtime(CAP, V20RC0, compute_dtype="bfloat16"),
                               "cpu")
    pflat = flatten_params(pstate)
    jflat = flatten_params(_np(jstate))
    ported = _spec_tree_paths(state_sharding(pstate, sizes, capacity=capacity))
    shared = [k for k in pflat if k in jflat and tuple(pflat[k].shape) == jflat[k].shape]
    assert len(shared) > 10
    assert {k: ported[k] for k in shared} == {k: want[k] for k in shared}
    assert ported["kv_slots/k"] == ()
    if capacity:
        assert ported["model/wg/phase"] == ("streams",)


# ---- 3-4: the stream-sharded tick ----

def test_sharded_engine_tick_matches_single_process_and_jax(runs):
    ref, want = runs["ref"]["tick"]["out"][0], runs["jax"]["tick"]
    assert np.abs(ref).max() > 0
    for res in runs[2]:
        got = res["tick"]
        assert got["rows"] == CAP // 2
        np.testing.assert_allclose(got["out"][0], ref, rtol=0, atol=1e-6)
        np.testing.assert_allclose(got["out"][0], want, rtol=5e-3, atol=1e-5)
        for k, v in runs["ref"]["tick"]["state"].items():
            np.testing.assert_allclose(got["state"][k], v, rtol=0, atol=1e-6, err_msg=k)


def test_sharded_production_tick_matches_single_process(runs):
    """Held to the port unsharded at tests/test_sharding.py's tolerances and
    to the JAX package's sharded ticks by the golden envelope (its f32 tick
    of the same weights and input, and its bf16 int8 tick)."""
    ref = runs["ref"]["prod"]
    golden_jax = {"f32": runs["jax"]["prod_f32"], "bf16": runs["jax"]["prod"]}
    assert np.isfinite(ref["out"]).all() and np.abs(ref["out"]).max() > 0
    for res in runs[2]:
        got = res["prod"]
        np.testing.assert_allclose(got["out"], ref["out"], rtol=2e-2, atol=2e-3)
        for k in ("model/wg/phase", "gain_in_db", "frame_counter"):
            np.testing.assert_allclose(got["state"][k], ref["state"][k], rtol=1e-3, atol=1e-4,
                                       err_msg=k)
        for k, v in ref["state"].items():  # every carry, as tight as the tick
            np.testing.assert_allclose(got["state"][k], v, rtol=2e-2, atol=2e-3, err_msg=k)
        env = golden.envelope(got["out"][0], golden_jax)
        print(f" port vs JAX production tick: {env}", end="")
        assert env["ok"], env


# ---- 5: the stages under tensor parallelism ----

def test_tensor_parallel_stages_match(runs):
    want, ref = runs["jax"]["stages"], runs["ref"]["stages"]
    tol = {"phone": (1e-3, 2e-4), "logits": (1e-3, 2e-3), "feats": (1e-3, 2e-4),
           "wav": (2e-3, 2e-3)}
    for res in runs[4]:
        got = res["stages"]
        for k, (rtol, atol) in tol.items():
            np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol, err_msg=k)
            np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=1e-5, err_msg=k)
        assert (got["qp"] == want["qp"]).mean() > 0.95
        assert (got["qp"] == ref["qp"]).all()


# ---- 6-8: the training steps ----

def _hold_step(results, ref, grad_keys, param_keys):
    for res in results:
        for k, v in ref["metrics"].items():
            np.testing.assert_allclose(res["metrics"][k], v, rtol=STEP_ATOL, atol=STEP_ATOL,
                                       err_msg=k)
        for gk in grad_keys:
            for k, v in ref[gk].items():
                d = np.abs(res[gk][k] - v).max()
                assert d <= GRAD_RTOL * np.abs(v).max() + 1e-12, (gk, k, d, np.abs(v).max())
        for pk in param_keys:
            for k, v in ref[pk].items():
                np.testing.assert_allclose(res[pk][k], v, rtol=0, atol=PARAM_ATOL,
                                           err_msg=f"{pk}/{k}")
    for pk in param_keys:
        for res in results[1:]:
            assert all(np.array_equal(res[pk][k], results[0][pk][k]) for k in ref[pk]), pk


def test_data_parallel_distill_step(runs):
    voiced = (runs["inputs"]["batch"]["f0_bin"] > 0).sum(1)
    assert voiced[:2].sum() != voiced[2:].sum()
    _hold_step([r["distill"] for r in runs[2]], runs["ref"]["distill"], ["grads"], ["params"])


def test_data_parallel_gan_step(runs):
    _hold_step([r["gan"] for r in runs[2]], runs["ref"]["gan"], ["g_grads", "d_grads"],
               ["g", "d"])


def test_tensor_parallel_distill_step(runs):
    _hold_step([r["distill_tp"] for r in runs[4]], runs["ref"]["distill"], ["grads"],
               ["params"])


def test_tensor_parallel_gan_step(runs):
    """2 x 2: the generator's weights split over 'model' through the
    critic's and the generator's updates."""
    _hold_step([r["gan_tp"] for r in runs[4]], runs["ref"]["gan"], ["g_grads", "d_grads"],
               ["g", "d"])


# ---- 9: seqpar on the mesh ----

@pytest.mark.parametrize("n_segments", [3, 4])
def test_seqpar_on_mesh(runs, n_segments):
    ref = runs["ref"][f"seqpar_{n_segments}"]
    assert np.abs(ref).max() > 0.05
    for res in runs[2]:
        got = res[f"seqpar_{n_segments}"]
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
        np.testing.assert_allclose(got, runs["ref"]["sequential"], rtol=0, atol=1e-3)


# ---- 10-11: the dry run and the bring-up ----

def test_dryrun_multichip(runs):
    for res in runs[4]:
        d = res["dryrun"]
        assert d["mesh"] == {"streams": 2, "model": 2}
        assert np.isfinite(d["loss"]) and d["tick_finite"] and d["tick_shape"] == (4, 480)
    assert len({r["dryrun"]["loss"] for r in runs[4]}) == 1


def test_distributed_init_two_processes(runs):
    for rank, res in enumerate(runs[2]):
        b = res["bringup"]
        assert (b["backend"], b["world"], b["rank"], b["rank_sum"]) == ("gloo", 2, rank, 1.0)
        assert b["refused"] == "mesh 3x1 != 2 devices"


def test_sharded_weight_refused_by_the_fused_head(runs):
    """The rules split the upsampler's conv weights, but `shard_tree` keeps
    them whole on every model rank (the fused head needs them whole) while
    it splits pitch_emb; split weights reaching the head raise."""
    for res in runs[2]:
        got = res["refusal"]
        assert got["kept_whole"] and got["pitch_emb_split"]
        assert got["refused"] is not None and "split over 'model'" in got["refused"]
