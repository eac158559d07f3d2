"""Port sub-models and chain against the JAX package on the same numpy
inputs and the same random-init weights (f32).  The JAX vocoder runs its
default XLA upsampler (use_pallas_upsampler off); the port's runs the
upsampler head's plain version on the CPU.  Tolerances: 1e-4 on
activations and audio (f32 sums in another order, the harmonic source
through sin/cos of phases up to 2*pi)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from beatrice_vst_tpu.constants import V20A2, V20RC0
from beatrice_vst_tpu.models import chain as JC
from beatrice_vst_tpu.models import layers as JL
from beatrice_vst_tpu.models import phone_extractor as JPE
from beatrice_vst_tpu.models import pitch_estimator as JPI
from beatrice_vst_tpu.models import waveform_generator as JW
from beatrice_vst_tpu_torch.models import chain as PC
from beatrice_vst_tpu_torch.models import fused_upsampler as FU
from beatrice_vst_tpu_torch.models import layers as PL
from beatrice_vst_tpu_torch.models import phone_extractor as PPE
from beatrice_vst_tpu_torch.models import pitch_estimator as PPI
from beatrice_vst_tpu_torch.models import waveform_generator as PW
from beatrice_vst_tpu_torch.models.io import params_from_numpy

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)
# jitted once: eager JAX dispatch of the vocoder costs seconds per frame
_jit_wg = jax.jit(JW.apply, static_argnums=(1,), static_argnames=("compute_dtype", "soft_pitch"))
_jit_chain = jax.jit(JC.apply, static_argnums=(1,))
JCFG = JC.VoiceConverterConfig.for_version(V20RC0)
PCFG = PC.VoiceConverterConfig.for_version(V20RC0)


@pytest.fixture(scope="module")
def params():
    jp = JC.init(jax.random.PRNGKey(0), JCFG)
    return jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")


def _t(x):
    x = np.asarray(x)
    if x.dtype in (np.int32, np.uint32):
        x = x.astype(np.int64)
    return torch.from_numpy(np.array(x))


def _close_tree(got, want, **tol):
    flat_w, _ = jax.tree_util.tree_flatten(want)
    flat_g, _ = jax.tree_util.tree_flatten(got)
    assert len(flat_w) == len(flat_g)
    for g, w in zip(flat_g, flat_w):
        np.testing.assert_allclose(g.numpy(), np.asarray(w).astype(g.numpy().dtype), **tol)


def _random_state(js, rng, scale=0.1):
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray((rng.standard_normal(a.shape) * scale).astype(np.float32))
        if jnp.issubdtype(a.dtype, jnp.floating) else a, js)


def test_phone_extractor(params):
    jp, pp = params
    rng = np.random.default_rng(0)
    js = _random_state(JPE.init_state(JCFG.phone, (3,)), rng)
    ps = jax.tree_util.tree_map(_t, js)
    for _ in range(2):
        audio = (rng.standard_normal((3, 160)) * 0.1).astype(np.float32)
        yj, js = JPE.apply(jp["phone"], JCFG.phone, jnp.asarray(audio), js)
        yp, ps = PPE.apply(pp["phone"], PCFG.phone, torch.from_numpy(audio), ps)
        np.testing.assert_allclose(yp.numpy(), np.asarray(yj), **TOL)
        _close_tree(ps, js, **TOL)


@pytest.mark.parametrize("t", [1, 2])
def test_vq_knn_smooth(t):
    rng = np.random.default_rng(t)
    phone = rng.standard_normal((4, t, 16)).astype(np.float32)
    cb = rng.standard_normal((4, 64, 16)).astype(np.float32)
    n = np.array([0, 1, 4, 8], np.int32)
    want = JPE.vq_knn_smooth(jnp.asarray(phone), jnp.asarray(cb), jnp.asarray(n))
    got = PPE.vq_knn_smooth(torch.from_numpy(phone), torch.from_numpy(cb), _t(n))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_pitch_estimator(params):
    jp, pp = params
    rng = np.random.default_rng(1)
    js = _random_state(JPI.init_state(JCFG.pitch, (4,)), rng)
    ps = jax.tree_util.tree_map(_t, js)
    lo = np.array([1, 1, 100, 200], np.int32)
    hi = np.array([447, 60, 300, 210], np.int32)
    for _ in range(2):
        audio = (rng.standard_normal((4, 160)) * 0.1).astype(np.float32)
        qj, fj, js = JPI.apply(jp["pitch"], JCFG.pitch, jnp.asarray(audio), js,
                               jnp.asarray(lo), jnp.asarray(hi))
        qp, fp, ps = PPI.apply(pp["pitch"], PCFG.pitch, torch.from_numpy(audio), ps,
                               _t(lo), _t(hi))
        np.testing.assert_array_equal(qp.numpy(), np.asarray(qj))
        assert ((qp.numpy() >= lo[:, None]) & (qp.numpy() <= hi[:, None])).all()
        np.testing.assert_allclose(fp.numpy(), np.asarray(fj), **TOL)
        _close_tree(ps, js, **TOL)


def _wg_inputs(rng, b):
    return dict(
        phone=(rng.standard_normal((b, 1, 128))).astype(np.float32),
        qp=rng.integers(50, 400, (b, 1)).astype(np.int32),
        feats=rng.standard_normal((b, 1, 4)).astype(np.float32),
        spk=(rng.standard_normal((b, 256)) * 0.1).astype(np.float32),
        kv=(rng.standard_normal((b, 384, 128)) * 0.1).astype(np.float32),
    )


def test_waveform_generator(params):
    jp, pp = params
    b = 4
    rng = np.random.default_rng(2)
    js = _random_state(JW.init_state(JCFG.wg, (b,)), rng)
    js["phase"] = jnp.asarray(rng.uniform(0, 6.28, b).astype(np.float32))
    js["noise_counter"] = jnp.asarray([0, 5, 2**31, 2**32 - 2], jnp.uint32)
    ps = jax.tree_util.tree_map(_t, js)
    for _ in range(3):
        x = _wg_inputs(rng, b)
        kv_j = JW.project_kv(jp["wg"], JCFG.wg, jnp.asarray(x["kv"]))
        kv_p = PW.project_kv(pp["wg"], torch.from_numpy(x["kv"]))
        _close_tree(kv_p, kv_j, rtol=1e-5, atol=1e-5)
        aj, js = _jit_wg(jp["wg"], JCFG.wg, jnp.asarray(x["phone"]), jnp.asarray(x["qp"]),
                          jnp.asarray(x["feats"]), jnp.asarray(x["spk"]), js,
                          kv_cache=kv_j)
        ap, ps = PW.apply(pp["wg"], PCFG.wg, torch.from_numpy(x["phone"]), _t(x["qp"]),
                          torch.from_numpy(x["feats"]), torch.from_numpy(x["spk"]), ps,
                          kv_p)
        np.testing.assert_allclose(ap.numpy(), np.asarray(aj), **TOL)
        np.testing.assert_array_equal(ps["noise_counter"].numpy(),
                                      np.asarray(js["noise_counter"]).astype(np.int64))
        _close_tree(ps, js, **TOL)


def test_waveform_generator_rejects_chunks(params):
    """The fused head -- the kernel's wrapper -- takes one frame: it
    refuses the h of a chunk.  The generator sends chunks (T > 1) to the
    stage loop instead (`test_waveform_generator_chunk`)."""
    _, pp = params
    ps = PW.init_state(PCFG.wg, (1,), device="cpu")
    up, final = FU.head_params(pp["wg"]["up"], pp["wg"]["final"], torch.float32)
    src = [torch.zeros(1, 2 * n, 9) for n in (4, 20, 80, 240)]
    with pytest.raises(ValueError, match="argument 0: shape"):
        FU.fused_upsample(up, final, torch.zeros(1, 2, 256), [*ps["up"], ps["final"]], src)


def _wg_chunk_inputs(rng, b, t, phone_channels=128):
    return dict(
        phone=(rng.standard_normal((b, t, phone_channels))).astype(np.float32),
        qp=rng.integers(50, 380, (b, t)).astype(np.int32),
        feats=rng.standard_normal((b, t, 4)).astype(np.float32),
        spk=(rng.standard_normal((b, 256)) * 0.1).astype(np.float32),
        kv=(rng.standard_normal((b, 384, 128)) * 0.1).astype(np.float32),
    )


def _no_fused_head(*args, **kwargs):
    raise AssertionError("a chunk reached the fused head")


@pytest.mark.parametrize("soft", [False, True])
def test_waveform_generator_chunk(params, monkeypatch, soft):
    """T = 12 frames in one call from a random carry, twice: the stage loop
    of the JAX package's XLA path.  Neither the kernel's wrapper nor its
    plain version is called."""
    jp, pp = params
    monkeypatch.setattr(PW, "fused_upsample", _no_fused_head)
    monkeypatch.setattr(PW, "fused_upsample_reference", _no_fused_head)
    b, t = 3, 12
    rng = np.random.default_rng(12)
    js = _random_state(JW.init_state(JCFG.wg, (b,)), rng)
    js["phase"] = jnp.asarray(rng.uniform(0, 6.28, b).astype(np.float32))
    js["noise_counter"] = jnp.asarray([0, 7, 2**32 - 5], jnp.uint32)
    ps = jax.tree_util.tree_map(_t, js)
    for _ in range(2):
        x = _wg_chunk_inputs(rng, b, t)
        qp = x["qp"] + (rng.uniform(-0.5, 0.5, (b, t)).astype(np.float32) if soft else 0)
        kv_j = JW.project_kv(jp["wg"], JCFG.wg, jnp.asarray(x["kv"]))
        kv_p = PW.project_kv(pp["wg"], torch.from_numpy(x["kv"]))
        aj, js = _jit_wg(jp["wg"], JCFG.wg, jnp.asarray(x["phone"]), jnp.asarray(qp),
                         jnp.asarray(x["feats"]), jnp.asarray(x["spk"]), js, kv_cache=kv_j,
                         soft_pitch=soft)
        ap, ps = PW.apply(pp["wg"], PCFG.wg, torch.from_numpy(x["phone"]), _t(qp),
                          torch.from_numpy(x["feats"]), torch.from_numpy(x["spk"]), ps, kv_p,
                          soft_pitch=soft)
        assert ap.shape == (b, t * 240)
        np.testing.assert_allclose(ap.numpy(), np.asarray(aj), **TOL)
        np.testing.assert_array_equal(ps["noise_counter"].numpy(),
                                      np.asarray(js["noise_counter"]).astype(np.int64))
        _close_tree(ps, js, **TOL)


def test_stage_loop_bf16(params):
    """The stage loop in bf16 against the JAX package's in bf16, on the
    same bf16 frame features and carries: its products are summed in f32
    and rounded once, the power chain and the stage outputs are bf16, so
    outputs agree to a few bf16 roundings."""
    jp, pp = params
    b, t = 2, 12
    rng = np.random.default_rng(13)
    x = _wg_chunk_inputs(rng, b, t)
    js = _random_state(JW.init_state(JCFG.wg, (b,)), rng)
    kv_j = JW.project_kv(jp["wg"], JCFG.wg, jnp.asarray(x["kv"]), jnp.bfloat16)
    aj, _ = _jit_wg(jp["wg"], JCFG.wg, jnp.asarray(x["phone"]), jnp.asarray(x["qp"]),
                    jnp.asarray(x["feats"]), jnp.asarray(x["spk"]), js, kv_cache=kv_j,
                    compute_dtype=jnp.bfloat16)
    ps = jax.tree_util.tree_map(_t, js)
    kv_p = PW.project_kv(pp["wg"], torch.from_numpy(x["kv"]), torch.bfloat16)
    ap, _ = PW.apply(pp["wg"], PCFG.wg, torch.from_numpy(x["phone"]), _t(x["qp"]),
                     torch.from_numpy(x["feats"]), torch.from_numpy(x["spk"]), ps, kv_p,
                     torch.bfloat16)
    d = np.abs(ap.numpy() - np.asarray(aj))
    print(f" bf16 stage loop: max |d| {d.max():.3g}, rms {np.sqrt((d * d).mean()):.3g}", end="")
    assert d.max() < 0.05 and np.sqrt((d * d).mean()) < 4e-3


@pytest.mark.parametrize("spec", [V20A2, V20RC0], ids=["20a2", "20rc0"])
def test_pitch_estimator_chunk_logits_and_expected_bin(spec):
    """T = 12 through the pitch estimator of each bin count (384, 448):
    the argmax, the logits and the soft pitch (expected bin over the same
    masked logits)."""
    jcfg = JC.VoiceConverterConfig.for_version(spec).pitch
    pcfg = PC.VoiceConverterConfig.for_version(spec).pitch
    jparams = JPI.init(jax.random.PRNGKey(5), jcfg)
    pparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    rng = np.random.default_rng(5)
    js = _random_state(JPI.init_state(jcfg, (3,)), rng)
    ps = jax.tree_util.tree_map(_t, js)
    lo = np.array([1, 100, 20], np.int32)
    hi = np.array([spec.pitch_bins - 1, 300, 25], np.int32)
    audio = (rng.standard_normal((3, 12 * 160)) * 0.1).astype(np.float32)
    qj, fj, js, lj = JPI.apply(jparams, jcfg, jnp.asarray(audio), js, jnp.asarray(lo),
                               jnp.asarray(hi), with_logits=True)
    qp, fp, ps, lp = PPI.apply(pparams, pcfg, torch.from_numpy(audio), ps, _t(lo), _t(hi),
                               with_logits=True)
    assert lp.shape == (3, 12, spec.pitch_bins) and lp.dtype == torch.float32
    np.testing.assert_array_equal(qp.numpy(), np.asarray(qj))
    np.testing.assert_allclose(lp.numpy(), np.asarray(lj), **TOL)
    np.testing.assert_allclose(fp.numpy(), np.asarray(fj), **TOL)
    _close_tree(ps, js, **TOL)
    ej = JPI.expected_bin(lj, jnp.asarray(lo), jnp.asarray(hi), pitch_bins=spec.pitch_bins)
    ep = PPI.expected_bin(lp, _t(lo), _t(hi))
    assert ((ep.numpy() >= lo[:, None]) & (ep.numpy() <= hi[:, None])).all()
    np.testing.assert_allclose(ep.numpy(), np.asarray(ej), rtol=1e-5, atol=1e-3)


def test_phone_extractor_older_version_chunk():
    """2.0.0-alpha.2's phone extractor (256 channels), T = 12 in one call."""
    jcfg = JC.VoiceConverterConfig.for_version(V20A2).phone
    pcfg = PC.VoiceConverterConfig.for_version(V20A2).phone
    assert pcfg.phone_channels == jcfg.phone_channels == 256
    jparams = JPE.init(jax.random.PRNGKey(6), jcfg)
    pparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    rng = np.random.default_rng(6)
    js = _random_state(JPE.init_state(jcfg, (2,)), rng)
    ps = jax.tree_util.tree_map(_t, js)
    audio = (rng.standard_normal((2, 12 * 160)) * 0.1).astype(np.float32)
    yj, js = JPE.apply(jparams, jcfg, jnp.asarray(audio), js)
    yp, ps = PPE.apply(pparams, pcfg, torch.from_numpy(audio), ps)
    assert yp.shape == (2, 12, 256)
    np.testing.assert_allclose(yp.numpy(), np.asarray(yj), **TOL)
    _close_tree(ps, js, **TOL)


def test_chain_frames(params):
    """Three frames through both chains from zero state, with per-stream
    codebooks, K/V caches and pitch controls."""
    jp, pp = params
    b = 3
    rng = np.random.default_rng(4)
    kv = (rng.standard_normal((b, 384, 128)) * 0.1).astype(np.float32)
    cond_np = dict(
        speaker_embedding=(rng.standard_normal((b, 256)) * 0.1).astype(np.float32),
        codebook=rng.standard_normal((b, 512, 128)).astype(np.float32),
        vq_num_neighbors=np.array([0, 2, 8], np.int32),
        min_q=np.array([1, 1, 50], np.int32),
        max_q=np.array([447, 447, 250], np.int32),
        average_source_pitch=np.array([52.0, 80.0, 52.0], np.float32),
        intonation_intensity=np.array([1.0, 0.8, 1.2], np.float32),
        pitch_shift=np.array([0.0, 3.0, -2.0], np.float32),
        pitch_correction=np.array([0.0, 0.5, 0.9], np.float32),
        pitch_correction_type=np.array([0, 0, 1], np.int32),
    )
    cond_j = {k: jnp.asarray(v) for k, v in cond_np.items()}
    cond_j["kv_cache"] = JW.project_kv(jp["wg"], JCFG.wg, jnp.asarray(kv))
    cond_p = {k: _t(v) for k, v in cond_np.items()}
    cond_p["kv_cache"] = PW.project_kv(pp["wg"], torch.from_numpy(kv))
    js = JC.init_state(JCFG, (b,))
    ps = PC.init_state(PCFG, (b,), device="cpu")
    n = np.arange(3 * 160)
    audio = (0.3 * np.sin(2 * np.pi * 220 * n / 16000)[None]
             + 0.02 * rng.standard_normal((b, n.size))).astype(np.float32)
    for k in range(3):
        x = audio[:, 160 * k:160 * (k + 1)]
        yj, js = _jit_chain(jp, JCFG, jnp.asarray(x), js, cond_j)
        yp, ps = PC.apply(pp, PCFG, torch.from_numpy(x), ps, cond_p)
        np.testing.assert_allclose(yp.numpy(), np.asarray(yj), **TOL)
        _close_tree(ps, js, **TOL)


# ---- compute dtype, the shared-bank VQ and the slot bank ----
# bf16 tolerances are in bf16 units in the last place: one ulp of a value
# in [2^e, 2^(e+1)) is 2^(e-7), so 2^-7 of the largest |value| bounds it.

BF16_ULP = 2.0**-7


def _f64(x):
    if isinstance(x, torch.Tensor):
        return x.double().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32), np.float64)


def _close_bf16(got, want, ulps=1):
    """got within `ulps` bf16 ulps of the largest |want|."""
    g, w = _f64(got), _f64(want)
    tol = ulps * BF16_ULP * np.abs(w).max()
    print(f" max |d| {np.abs(g - w).max():.3g} (gate {tol:.3g})", end="")
    assert np.abs(g - w).max() <= tol, f"max |d| {np.abs(g - w).max():.3g} > {tol:.3g}"


def _vq_inputs(seed, b=6, s=5, k=64, c=16):
    rng = np.random.default_rng(seed)
    phone = rng.standard_normal((b, 1, c)).astype(np.float32)
    bank = rng.standard_normal((s, k, c)).astype(np.float32)
    idx = rng.integers(0, s, b).astype(np.int32)
    n = np.array([0, 1, 3, 4, 8, 8], np.int32)[:b]
    return phone, bank, idx, n


@pytest.mark.parametrize("int8", [False, True])
def test_vq_knn_smooth_shared(int8):
    """Against JAX: f32 at atol 1e-5; the int8 bank with per-row scales and
    a bf16 phone within 1 bf16 ulp of the largest output."""
    phone, bank, idx, n = _vq_inputs(11)
    jphone, jbank, scale = jnp.asarray(phone), jnp.asarray(bank), None
    if int8:
        jphone = jphone.astype(jnp.bfloat16)
        jbank, scale = JL.quantize_rows(jbank)
    want = JPE.vq_knn_smooth_shared(jphone, jbank, jnp.asarray(idx), jnp.asarray(n),
                                    codebook_scale=scale)
    pphone = torch.from_numpy(np.array(_f64(jphone), np.float32))
    if int8:
        pphone = pphone.to(torch.bfloat16)
    got = PPE.vq_knn_smooth_shared(pphone, _t(jbank), _t(idx), _t(n),
                                   codebook_scale=None if scale is None else _t(scale))
    assert got.dtype == pphone.dtype and got.shape == (6, 1, 16)
    if int8:
        _close_bf16(got, want)
    else:
        print(f" max |d| {np.abs(got.numpy() - np.asarray(want)).max():.3g}", end="")
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("int8", [False, True])
def test_vq_shared_equals_per_stream_on_the_gathered_codebook(int8):
    """The shared-bank VQ equals the per-stream VQ on each stream's gathered
    codebook (the JAX docstring's equivalence), in the port: f32 at atol
    1e-5, int8 within 1 bf16 ulp."""
    phone, bank, idx, n = _vq_inputs(12)
    tbank, scale = torch.from_numpy(bank), None
    tphone = torch.from_numpy(phone)
    if int8:
        tphone = tphone.to(torch.bfloat16)
        tbank, scale = PL.quantize_rows(tbank)
    ti = torch.from_numpy(idx).long()
    shared = PPE.vq_knn_smooth_shared(tphone, tbank, ti, _t(n), codebook_scale=scale)
    gathered = PPE.vq_knn_smooth(tphone, tbank[ti], _t(n),
                                 codebook_scale=None if scale is None else scale[ti])
    if int8:
        np.testing.assert_allclose(_f64(shared), _f64(gathered), rtol=0,
                                   atol=BF16_ULP * float(gathered.abs().max()))
    else:
        np.testing.assert_allclose(shared.numpy(), gathered.numpy(), rtol=1e-5, atol=1e-5)


def test_vq_knn_smooth_int8_codebook():
    """Per-stream int8 codebooks with per-row scales and a bf16 phone:
    within 1 bf16 ulp of JAX."""
    phone, bank, idx, n = _vq_inputs(13)
    cb_q, cb_s = JL.quantize_rows(jnp.asarray(bank[idx]))
    jphone = jnp.asarray(phone).astype(jnp.bfloat16)
    want = JPE.vq_knn_smooth(jphone, cb_q, jnp.asarray(n), codebook_scale=cb_s)
    got = PPE.vq_knn_smooth(torch.from_numpy(np.array(_f64(jphone), np.float32)).bfloat16(),
                            _t(cb_q), _t(n), codebook_scale=_t(cb_s))
    _close_bf16(got, want)


def _cast_floats(tree, jdtype):
    return jax.tree_util.tree_map(
        lambda a: a.astype(jdtype) if jnp.issubdtype(a.dtype, jnp.floating) else a, tree)


def _to_port(tree):
    """A JAX state tree as torch tensors, bf16 kept bf16."""
    def one(a):
        if a.dtype == jnp.bfloat16:
            return torch.from_numpy(np.array(a.astype(jnp.float32))).bfloat16()
        return _t(a)
    return jax.tree_util.tree_map(one, tree)


def test_phone_extractor_bf16(params):
    """bf16 trunk and carries from random bf16 state: phone and carries
    within 1 bf16 ulp of the largest value."""
    jp, pp = params
    rng = np.random.default_rng(5)
    js = _random_state(JPE.init_state(JCFG.phone, (3,)), rng)
    js["blocks"] = _cast_floats(js["blocks"], jnp.bfloat16)
    ps = _to_port(js)
    f = jax.jit(JPE.apply, static_argnums=(1, 4))
    for _ in range(2):
        audio = (rng.standard_normal((3, 160)) * 0.1).astype(np.float32)
        yj, js = f(jp["phone"], JCFG.phone, jnp.asarray(audio), js, jnp.bfloat16)
        yp, ps = PPE.apply(pp["phone"], PCFG.phone, torch.from_numpy(audio), ps, torch.bfloat16)
        assert yp.dtype == torch.bfloat16
        _close_bf16(yp, yj)
        for got, want in zip(ps["blocks"], js["blocks"]):
            assert got.dtype == torch.bfloat16
            _close_bf16(got, want)


def test_pitch_estimator_bf16(params):
    """bf16 trunk, f32 logits: the same bins, features within 1 bf16 ulp of
    the largest."""
    jp, pp = params
    rng = np.random.default_rng(6)
    js = _random_state(JPI.init_state(JCFG.pitch, (4,)), rng)
    js["blocks"] = _cast_floats(js["blocks"], jnp.bfloat16)
    ps = _to_port(js)
    lo = np.array([1, 1, 100, 200], np.int32)
    hi = np.array([447, 60, 300, 210], np.int32)
    f = jax.jit(JPI.apply, static_argnums=(1, 6))
    for _ in range(2):
        audio = (rng.standard_normal((4, 160)) * 0.1).astype(np.float32)
        qj, fj, js = f(jp["pitch"], JCFG.pitch, jnp.asarray(audio), js, jnp.asarray(lo),
                       jnp.asarray(hi), jnp.bfloat16)
        qp, fp, ps = PPI.apply(pp["pitch"], PCFG.pitch, torch.from_numpy(audio), ps,
                               _t(lo), _t(hi), torch.bfloat16)
        assert fp.dtype == torch.float32
        np.testing.assert_array_equal(qp.numpy(), np.asarray(qj))
        np.testing.assert_allclose(fp.numpy(), np.asarray(fj), rtol=0,
                                   atol=BF16_ULP * float(np.abs(np.asarray(fj)).max()))


def _slot_bank(jp, rng, jdtype):
    """A slot bank of 3 projected speakers and 2 zero morph slots, f32, or
    int8 with per-row scales projected in bf16 (`engine.py:_build_cond`),
    as JAX arrays."""
    kv = jnp.asarray((rng.standard_normal((3, 384, 128)) * 0.1).astype(np.float32))
    proj = JW.project_kv(jp["wg"], JCFG.wg, kv, jdtype)
    bank = {}
    for name in ("k", "v"):
        if jdtype is None:
            bank[name] = jnp.concatenate([proj[name], jnp.zeros((2, *proj[name].shape[1:]))])
        else:
            q, s = JL.quantize_rows(proj[name])
            bank[name] = jnp.concatenate([q, jnp.zeros((2, *q.shape[1:]), jnp.int8)])
            bank[f"{name}_scale"] = jnp.concatenate([s, jnp.ones((2, *s.shape[1:]))])
    return bank


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_waveform_generator_slot_bank(params, dtype):
    """The vocoder reading the shared slot bank, three frames from zero
    state.  f32: audio and carries at 1e-4.  bf16 with the int8 slot bank
    and contractions: the frame-rate trunk's carries within 2 bf16 ulps of
    the largest value; the audio by an envelope, its largest and RMS
    deviation from the JAX f32 vocoder (f32 slot bank) each at most twice
    the JAX bf16 vocoder's, because the JAX vocoder runs its XLA upsampler
    here, which rounds in other places than the TPU kernel whose roundings
    the port's head follows (that head is held to the kernel in
    tests/test_torch_fused_upsampler.py)."""
    jp, pp = params
    b = 4
    rng = np.random.default_rng(7)
    jdtype = jnp.bfloat16 if dtype == "bf16" else None
    pdtype = torch.bfloat16 if dtype == "bf16" else None
    bank_j = _slot_bank(jp, np.random.default_rng(8), jdtype)
    bank_32 = _slot_bank(jp, np.random.default_rng(8), None)
    bank_p = {k: _t(v) for k, v in bank_j.items()}
    slot = np.array([0, 2, 1, 2], np.int32)
    js = js32 = JW.init_state(JCFG.wg, (b,))
    if jdtype is not None:
        js = {**_cast_floats({k: js[k] for k in ("blocks", "up", "final")}, jdtype),
              "phase": js["phase"], "noise_counter": js["noise_counter"]}
    ps = _to_port(js)
    runs = {"port": [], "jax": [], "jax_f32": []}
    for _ in range(3):
        x = _wg_inputs(rng, b)
        args = [jnp.asarray(x["qp"]), jnp.asarray(x["feats"]), jnp.asarray(x["spk"])]
        phone = jnp.asarray(x["phone"])
        if jdtype is not None:
            a32, js32 = _jit_wg(jp["wg"], JCFG.wg, phone, *args, js32, kv_bank=bank_32,
                                kv_slot=jnp.asarray(slot))
            runs["jax_f32"].append(np.asarray(a32))
            phone = phone.astype(jdtype)
        aj, js = _jit_wg(jp["wg"], JCFG.wg, phone, *args, js, compute_dtype=jdtype,
                          kv_bank=bank_j, kv_slot=jnp.asarray(slot))
        ap, ps = PW.apply(pp["wg"], PCFG.wg, _to_port(phone), _t(x["qp"]),
                          torch.from_numpy(x["feats"]), torch.from_numpy(x["spk"]), ps,
                          compute_dtype=pdtype, kv_bank=bank_p, kv_slot=_t(slot))
        runs["port"].append(ap.numpy())
        runs["jax"].append(np.asarray(aj))
        if dtype == "f32":
            np.testing.assert_allclose(ap.numpy(), np.asarray(aj), **TOL)
            _close_tree(ps, js, **TOL)
        else:
            for got, want in zip(ps["blocks"], js["blocks"]):
                _close_bf16(got, want, ulps=2)
    if dtype == "bf16":
        port, jax_bf16, ref = (np.stack(runs[k]) for k in ("port", "jax", "jax_f32"))
        for stat in (lambda d: np.abs(d).max(), lambda d: np.sqrt(np.mean(d * d))):
            assert stat(port - ref) <= 2 * stat(jax_bf16 - ref)
