"""The port's morph functions against the JAX package's on the CPU, on the
same inputs from numpy seeds: `ops/morph.py` (marker and voice weights,
fold and threshold, top-8 pruning with exact ties), `ops/spherical_average.py`
(against JAX and the float64 oracle `reference_impl.spherical_weighted_average`),
`speakers/morpher.py` (the codebook lottery, the morphed embeddings and the
conditioning on the klatt8 bank in f32 and bf16), and the chain with
morphed conditioning and per-frame lottery picks against the float64 oracle
(the port's side of tests/test_golden.py's morph test).  The engines,
offline conversion and the golden file: tests/test_torch_morph_engine.py.

Gates: the morph weights at 1e-6 with identical top-8 indices; the
spherical average at 1e-5 against JAX and 2e-3 against the oracle (the
gate of tests/test_spherical_average.py); lottery picks identical; the
morphed embeddings and conditioning at 1e-5; the chain at atol 1e-3, the
waveform gate of tests/test_golden.py."""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from beatrice_vst_tpu import reference_impl as oref
from beatrice_vst_tpu.constants import MAX_N_SPEAKERS, V20RC0
from beatrice_vst_tpu.models import chain as JC
from beatrice_vst_tpu.models.io import load_model_dir
from beatrice_vst_tpu.ops import morph as JM
from beatrice_vst_tpu.ops.spherical_average import spherical_average as jsph
from beatrice_vst_tpu.runtime.engine import cast_bank as jcast_bank
from beatrice_vst_tpu.speakers import morpher as JMO
from beatrice_vst_tpu_torch.models import chain as PC
from beatrice_vst_tpu_torch.models import waveform_generator as PW
from beatrice_vst_tpu_torch.models.io import params_from_numpy
from beatrice_vst_tpu_torch.ops import morph as PM
from beatrice_vst_tpu_torch.ops.spherical_average import spherical_average as psph
from beatrice_vst_tpu_torch.runtime.engine import cast_bank
from beatrice_vst_tpu_torch.speakers import morpher as PMO

torch.set_num_threads(1)

MODEL_DIR = os.path.join(os.path.dirname(__file__), "..", "models_demo", "klatt8")
TOL = 1e-5


def _np(x):
    return np.asarray(x.float() if x.dtype == torch.bfloat16 else x)


def _pads(rng, shape):
    """Morph pad inputs with leading axes `shape`: cursor, falloff
    (including 0, the uniform case), 8 markers with voice ids past 256
    (clamped), 1-8 active markers."""
    return dict(
        cursor_x=rng.uniform(-1, 1, shape).astype(np.float32),
        cursor_y=rng.uniform(-1, 1, shape).astype(np.float32),
        falloff=np.where(rng.uniform(size=shape) < 0.25, 0.0,
                         rng.uniform(0.5, 4.0, shape)).astype(np.float32),
        marker_voice_id=rng.integers(0, 300, (*shape, 8)).astype(np.int32),
        marker_x=rng.uniform(-1, 1, (*shape, 8)).astype(np.float32),
        marker_y=rng.uniform(-1, 1, (*shape, 8)).astype(np.float32),
        marker_count=rng.integers(1, 9, shape).astype(np.int32))


def test_marker_and_voice_weights_match_jax():
    args = _pads(np.random.default_rng(0), (3, 5))
    mw_args = {k: v for k, v in args.items() if k != "marker_voice_id"}
    want = np.asarray(JM.calculate_marker_weights(
        **{k: jnp.asarray(v) for k, v in mw_args.items()}))
    got = PM.calculate_marker_weights(**{k: torch.from_numpy(v) for k, v in mw_args.items()})
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    want = np.asarray(JM.calculate_voice_weights(**{k: jnp.asarray(v) for k, v in args.items()}))
    got = PM.calculate_voice_weights(**{k: torch.from_numpy(v).long() if v.dtype == np.int32
                                        else torch.from_numpy(v) for k, v in args.items()})
    assert got.shape == (3, 5, MAX_N_SPEAKERS)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_fold_and_threshold_match_jax():
    """Weights past the speaker count fold into the last speaker; weights
    below 0.01 are zeroed; a count of 0 zeroes everything."""
    rng = np.random.default_rng(1)
    w = rng.uniform(0, 0.05, (4, 3, MAX_N_SPEAKERS)).astype(np.float32)
    w[..., :8] = rng.uniform(0, 0.3, (4, 3, 8))
    count = np.array([[8, 4, 1], [256, 300, 0], [2, 8, 16], [5, 5, 5]], np.int32)
    want = np.asarray(JM.prepare_voice_morph_weights(jnp.asarray(w), jnp.asarray(count)))
    got = PM.prepare_voice_morph_weights(torch.from_numpy(w), torch.from_numpy(count).long())
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    assert (want == 0).mean() > 0.5  # the threshold and the fold did work


def test_prune_top_k_ties_and_few_speakers_match_jax():
    """Exact ties (0.5 / 0.5, three-way, all-zero rows) and a 4-speaker
    count whose zero-weight tail indices lie past the bank: the same
    indices, in the same order, as jax.lax.top_k."""
    rows = np.zeros((6, MAX_N_SPEAKERS), np.float32)
    rows[0, [3, 1]] = 0.5
    rows[1, [7, 2, 5]] = 1 / 3
    rows[2, [0, 2]] = [0.25, 0.75]
    rows[3, [1, 2, 3]] = [0.2, 0.2, 0.6]  # a 4-speaker bank
    rows[5, :10] = 0.1  # more tied speakers than k
    counts = np.array([8, 8, 8, 4, 8, 256], np.int32)
    for dense in (rows, rows.reshape(2, 3, -1)):
        cnt = counts.reshape(dense.shape[:-1])
        want_w, want_i = JMO.pruned_morph_weights(jnp.asarray(dense), jnp.asarray(cnt))
        got_w, got_i = PMO.pruned_morph_weights(torch.from_numpy(dense),
                                                torch.from_numpy(cnt).long())
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w), rtol=0, atol=1e-6)
    assert list(got_i.reshape(6, 8)[0, :3]) == [1, 3, 0]
    assert list(got_i.reshape(6, 8)[3, :4]) == [3, 1, 2, 0]
    assert (got_i.reshape(6, 8)[3, 4:] >= 4).all()  # past the 4-speaker bank
    with pytest.raises(ValueError, match="pad"):
        PM.prune_top_k(torch.zeros(4, 7), 8)


def _sph_batch():
    """[2, 4] lanes of 8 points x 64 (random raw points, weights with
    zeros), and lanes with a single point, two points, all-zero weights and
    two antipodal points (a zero mean direction)."""
    rng = np.random.default_rng(4)
    p = rng.standard_normal((2, 4, 8, 64)) * rng.uniform(0.5, 3.0, (2, 4, 8, 1))
    p = p.astype(np.float32)
    w = rng.uniform(0, 1, (2, 4, 8)).astype(np.float32)
    w[w < 0.25] = 0.0
    w[0, 0] = 0.0
    w[0, 0, 3] = 1.0  # a single point
    w[0, 1] = 0.0
    w[0, 1, [2, 5]] = [0.3, 0.7]  # two points
    w[0, 2] = 0.0  # degenerate: no weight
    w[1, 0] = 0.0
    w[1, 0, [0, 1]] = 0.5
    p[1, 0, 1] = -p[1, 0, 0]  # antipodal: a zero mean direction
    return p, w


def test_spherical_average_matches_jax():
    """n_iters = 16 on lanes that converge at different updates (the
    single point at once, the two points early, others late or never):
    frozen lanes must stay frozen exactly as in JAX."""
    p, w = _sph_batch()
    want = np.asarray(jsph(jnp.asarray(p), jnp.asarray(w), n_iters=16))
    got = psph(torch.from_numpy(p), torch.from_numpy(w), 16).numpy()
    assert got.shape == (2, 4, 64)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    # a frozen lane's result stops changing: the first update count whose
    # result equals the 16-update one differs between lanes
    runs = [psph(torch.from_numpy(p), torch.from_numpy(w), n).numpy() for n in range(17)]
    settled = [min(n for n in range(17) if np.array_equal(runs[n][lane], got[lane]))
               for lane in np.ndindex(2, 4)]
    assert len(set(settled)) >= 3, settled
    np.testing.assert_allclose(
        psph(torch.from_numpy(p), torch.from_numpy(w)).numpy(),
        np.asarray(jsph(jnp.asarray(p), jnp.asarray(w))), rtol=0, atol=TOL)


def test_spherical_average_matches_float64_oracle():
    p, w = _sph_batch()
    got = psph(torch.from_numpy(p), torch.from_numpy(w)).numpy()
    for lane in np.ndindex(2, 4):
        want = oref.spherical_weighted_average(p[lane], w[lane])
        np.testing.assert_allclose(got[lane], want, rtol=2e-3, atol=2e-3, err_msg=str(lane))


def test_spherical_average_edge_cases():
    p, w = _sph_batch()
    got = psph(torch.from_numpy(p), torch.from_numpy(w), 16).numpy()
    np.testing.assert_array_equal(got[0, 2], 0.0)  # zero weights
    np.testing.assert_array_equal(got[1, 0], 0.0)  # zero mean direction
    np.testing.assert_allclose(got[0, 0], p[0, 0, 3], rtol=1e-5, atol=1e-5)  # one point
    a, b = np.eye(4, dtype=np.float32)[:2]
    mid = psph(torch.from_numpy(np.stack([a, b])), torch.tensor([0.5, 0.5]), 16).numpy()
    np.testing.assert_allclose(mid, (a + b) / np.sqrt(2), atol=1e-4)  # slerp midpoint


def _lottery_inputs():
    """Pruned weights over 8 streams: ties, uneven weights, a single
    speaker, a 4-speaker count, all-zero (degenerate) rows."""
    dense = np.zeros((8, MAX_N_SPEAKERS), np.float32)
    dense[0, [1, 5]] = 0.5
    dense[1, :8] = [0.25, 0.2, 0.15, 0.12, 0.1, 0.09, 0.085, 0.005]
    dense[2, 6] = 1.0
    dense[3, [0, 3]] = [0.9, 0.1]
    dense[5, [2, 4, 7]] = [0.3, 0.3, 0.4]
    dense[6, :3] = 1e-9  # below the threshold: degenerate
    dense[7, 300 % MAX_N_SPEAKERS] = 1.0  # folded into the last speaker
    counts = np.array([8, 8, 8, 4, 8, 8, 8, 8], np.int32)
    jw, ji = JMO.pruned_morph_weights(jnp.asarray(dense), jnp.asarray(counts))
    pw, pi = PMO.pruned_morph_weights(torch.from_numpy(dense), torch.from_numpy(counts).long())
    return (jw, ji, jnp.asarray(counts)), (pw, pi, torch.from_numpy(counts).long())


def test_codebook_lottery_matches_jax():
    """Picks over 4,000 frames, for [B] and [B, T] counters (starting past
    2^31, uint32 values), identical to JAX's; the degenerate rows pick
    uniformly over the real speakers."""
    (jw, ji, jn), (pw, pi, pn) = _lottery_inputs()
    frames = np.arange(4000, dtype=np.uint64) + np.uint64(2**31 - 1000)
    counters = np.tile(frames.astype(np.uint32)[None], (8, 1))
    counters[1] += np.uint32(17)  # streams at other frames
    want = np.asarray(JMO.codebook_lottery(jw, ji, jn, jnp.asarray(counters)))
    got = PMO.codebook_lottery(pw, pi, pn, torch.from_numpy(counters.astype(np.int64)))
    assert got.shape == (8, 4000)
    np.testing.assert_array_equal(got.numpy(), want)
    for t in (0, 1, 2, 3999):  # [B] counters, with the cached w8
        c = counters[:, t]
        want_t = np.asarray(JMO.codebook_lottery(jw, ji, jn, jnp.asarray(c)))
        w8 = torch.gather(pw, -1, pi)
        got_t = PMO.codebook_lottery(pw, pi, pn, torch.from_numpy(c.astype(np.int64)), w8=w8)
        np.testing.assert_array_equal(got_t.numpy(), want_t)
    picks = got.numpy()
    assert set(np.unique(picks[0])) == {1, 5}
    assert set(np.unique(picks[2])) == {6}
    assert set(np.unique(picks[3])) == {0, 3}
    assert set(np.unique(picks[4])) == set(range(8))  # all zero: uniform
    assert set(np.unique(picks[6])) == set(range(8))  # below the threshold: uniform
    assert set(np.unique(picks[7])) == {7}  # folded into the last speaker


@pytest.fixture(scope="module")
def klatt8_bank():
    _, _, _, jbank = load_model_dir(MODEL_DIR)
    return jbank


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_morphed_embeddings_and_conditioning_match_jax(klatt8_bank, dtype):
    """update_morphed_embeddings and select_conditioning on the klatt8 bank
    (bf16: the bank rounded to bf16, averaged in f32): a direct stream, a
    morph stream with a lottery, and a morph stream of all-zero weights."""
    (jw, ji, _), (pw, pi, _) = _lottery_inputs()
    jw, ji, pw, pi = jw[:3], ji[:3], pw[:3], pi[:3]
    jw = jw.at[2].set(0.0)
    pw = pw.clone()
    pw[2] = 0.0
    jbank = klatt8_bank if dtype == "float32" else jcast_bank(klatt8_bank, jnp.bfloat16)
    pbank = cast_bank({k: np.asarray(v) for k, v in klatt8_bank.items()},
                      None if dtype == "float32" else torch.bfloat16, device="cpu")
    jm = JMO.update_morphed_embeddings(jbank, jw, ji)
    pm = PMO.update_morphed_embeddings(pbank, pw, pi)
    for key in ("additive", "kv"):
        assert pm[key].dtype == torch.float32
        np.testing.assert_allclose(pm[key].numpy(), np.asarray(jm[key]), rtol=0, atol=TOL,
                                   err_msg=key)
    np.testing.assert_array_equal(pm["additive"][2].numpy(), 0.0)
    target, formant = np.array([5, 8, 8]), np.array([0, 4, 8])
    counter = np.array([3, 11, 2**32 - 1], np.uint32)
    want = JMO.select_conditioning(jbank, jnp.asarray(target), jm, jnp.asarray(formant),
                                   frame_counter=jnp.asarray(counter), pruned_weights=jw,
                                   top_idx=ji)
    got = PMO.select_conditioning(pbank, torch.from_numpy(target), pm, torch.from_numpy(formant),
                                  frame_counter=torch.from_numpy(counter.astype(np.int64)),
                                  pruned_weights=pw, top_idx=pi)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0, atol=TOL)
    np.testing.assert_allclose(_np(got[1]), np.asarray(want[1].astype(jnp.float32)), rtol=0,
                               atol=TOL)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert int(got[2][0]) == 5


def test_chain_with_morph_matches_oracle():
    """tests/test_golden.py's morph case on the port: morph-pad weights ->
    fold, threshold, top-8 -> spherical averages (additive and K/V) ->
    formant -> per-frame codebook lottery -> the chain frame by frame with
    the shared codebook bank, against reference_impl's float64 mirror."""
    spec = V20RC0
    jcfg = JC.VoiceConverterConfig.for_version(spec)
    jparams = jax.tree_util.tree_map(np.asarray, JC.init(jax.random.PRNGKey(3), jcfg))
    params = params_from_numpy(jparams, "cpu")
    rng = np.random.default_rng(3)
    n_spk, t = 5, 48
    bank_np = {
        "additive": (rng.standard_normal((n_spk, 256)) * 0.5).astype(np.float32),
        "formant": (rng.standard_normal((9, 256)) * 0.1).astype(np.float32),
        "kv": (rng.standard_normal((n_spk, 384, 128)) * 0.5).astype(np.float32),
        "codebook": rng.standard_normal((n_spk, 512, 128)).astype(np.float32),
    }
    audio = (0.3 * np.sin(2 * np.pi * 185 * np.arange(t * 160) / 16000)
             + 0.02 * rng.standard_normal(t * 160)).astype(np.float32)
    dense = np.zeros(MAX_N_SPEAKERS, np.float32)
    dense[:n_spk] = [0.40, 0.30, 0.18, 0.005, 0.115]
    formant_index = 6

    add_o, kv_o, pruned_o, top8_o = oref.morph_conditioning(bank_np, dense, n_spk, formant_index)
    cb_idx_o = oref.codebook_lottery(pruned_o[top8_o], top8_o, n_spk,
                                     np.arange(t, dtype=np.uint32))
    want = oref.chain_forward(jparams, jcfg, audio, target_settings={
        "speaker_embedding": add_o, "kv": kv_o, "codebook_bank": bank_np["codebook"],
        "codebook_idx": cb_idx_o, "vq_num_neighbors": 3, "pitch_shift": 2.0})

    bank = {k: torch.from_numpy(v) for k, v in bank_np.items()}
    pruned, top = PMO.pruned_morph_weights(torch.from_numpy(dense)[None], torch.tensor([n_spk]))
    morphed = PMO.update_morphed_embeddings(bank, pruned, top)
    additive, kv, _ = PMO.select_conditioning(bank, torch.tensor([n_spk]), morphed,
                                              torch.tensor([formant_index]))
    np.testing.assert_allclose(additive[0].numpy(), add_o, atol=2e-3)
    np.testing.assert_allclose(kv[0].numpy(), kv_o, atol=2e-3)
    picks = PMO.codebook_lottery(pruned, top, torch.tensor([n_spk]), torch.arange(t)[None])
    np.testing.assert_array_equal(picks[0].numpy(), cb_idx_o)
    assert len(set(cb_idx_o)) > 1

    pcfg = PC.VoiceConverterConfig.for_version(spec)
    one = lambda v, dtype: torch.tensor([v], dtype=dtype)  # noqa: E731
    base = {"speaker_embedding": additive, "kv_cache": PW.project_kv(params["wg"], kv),
            "codebook_bank": bank["codebook"], "vq_num_neighbors": one(3, torch.int64),
            "min_q": one(1, torch.int64), "max_q": one(spec.pitch_bins - 1, torch.int64),
            "average_source_pitch": one(52.0, torch.float32),
            "intonation_intensity": one(1.0, torch.float32),
            "pitch_shift": one(2.0, torch.float32), "pitch_correction": one(0.0, torch.float32),
            "pitch_correction_type": one(0, torch.int64)}
    state = PC.init_state(pcfg, (1,), "cpu")
    outs = []
    for f in range(t):
        out, state = PC.apply(params, pcfg, torch.from_numpy(audio[None, f * 160:(f + 1) * 160]),
                              state, dict(base, codebook_idx=picks[:, f]))
        outs.append(out[0].numpy())
    got = np.concatenate(outs)
    print(f" max |d| against the oracle {np.abs(got - want).max():.3g}", end="")
    np.testing.assert_allclose(got, want, atol=1e-3)
