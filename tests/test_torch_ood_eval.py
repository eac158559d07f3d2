"""The port's out-of-distribution evaluation (`beatrice_vst_tpu_torch/
scripts/ood_eval.py`) against the JAX package on the CPU: the first row of
noise_snr_20db and of unseen_f0_high_330hz on klatt8, the morph fit's
argmin on a reduced grid on klatt6 (one speaker pair at two ratios), and
those rows against the golden file (tests/data/torch_quality_golden.json).
Converted metrics agree to one unit of the last place `compare` rounds to
(tests/test_torch_quality_eval.py); do-nothing rows exactly.  Every row
draws from utterance 45."""

import json

import numpy as np
import pytest
import torch

from beatrice_vst_tpu_torch.scripts import ood_eval as O
from beatrice_vst_tpu_torch.scripts import quality_eval as Q
from test_torch_quality_eval import (GOLDEN, KLATT6, KLATT8, UTT, JaxSide, assert_metrics_close,
                                     write_renditions)

torch.set_num_threads(1)

REDUCED_PAIRS = [(0, 1)]  # trained speakers 0 and 1 of klatt6
REDUCED_RATIOS = (0.35, 0.65)


@pytest.fixture(scope="module")
def corpus_dir(tmp_path_factory):
    return write_renditions(str(tmp_path_factory.mktemp("corpus")), [UTT], [0, 3, 6])


@pytest.fixture(scope="module")
def sides(corpus_dir):
    return JaxSide(corpus_dir), Q.load_corpus(corpus_dir)


@pytest.fixture(scope="module")
def golden():
    return Q.load_golden(GOLDEN)


@pytest.fixture(scope="module")
def klatt8():
    return Q.load_model(KLATT8, "cpu")


def check_row(port, jax, golden_rows):
    assert port["do_nothing"] == jax["do_nothing"]
    assert_metrics_close(port["converted"], jax["converted"], "vs JAX")
    (want,) = [r for r in golden_rows if Q.row_key(r) == Q.row_key(port)]
    assert port["do_nothing"] == want["do_nothing"]
    assert_metrics_close(port["converted"], want["converted"], "vs golden")


def test_noise_20db_first_row(sides, klatt8, golden):
    jax_side, corpus = sides
    (jax,) = jax_side.noise_rows(20.0, limit=1)
    port = O.score_case(klatt8, next(O.noise_cases(corpus, 20.0)), corpus.sample_rate)
    assert (port["utt"], port["src"], port["tgt"]) == (UTT, 0, 3)
    check_row(port, jax, golden["ood"]["noise_snr_20db"]["rows"])


def test_register_330hz_first_row(sides, klatt8, golden):
    jax_side, corpus = sides
    (jax,) = jax_side.register_rows(330.0, limit=1)
    port = O.score_case(klatt8, next(O.register_cases(corpus, 330.0)), corpus.sample_rate)
    assert (port["utt"], port["src"], port["tgt"]) == (UTT, 1, 4)
    check_row(port, jax, golden["ood"]["unseen_f0_high_330hz"]["rows"])


def test_morph_fit_argmin_on_a_reduced_grid(sides):
    """The fit toward held-out speaker 6 over one trained pair at two
    ratios on klatt6: the same grid MCDs (to the last place) and the same
    chosen weights as the JAX script's loop."""
    jax_side, corpus = sides
    klatt6 = Q.load_model(KLATT6, "cpu")
    grid = jax_side.morph_grid(KLATT6, 6, pairs=REDUCED_PAIRS, ratios=REDUCED_RATIOS)
    fit = O.morph_fit(klatt6, corpus, 6, pairs=REDUCED_PAIRS, ratios=REDUCED_RATIOS)
    assert len(fit["grid_mcd_db"]) == 2
    np.testing.assert_allclose(fit["grid_mcd_db"], [m for _, m in grid], rtol=0, atol=1.0001e-3)
    wts, mcd, gap = JaxSide.fit(grid)
    assert fit["weights"] == wts.tolist()
    assert abs(fit["cal_mcd_db"] - mcd) <= 1.0001e-3 and abs(fit["runner_up_gap_db"] - gap) <= 2.1e-3


def test_grid_argmin_keeps_the_first_strict_minimum():
    w = [np.float32([i]) for i in range(4)]
    best, mcd, gap = O.grid_argmin([(w[0], 3.0), (w[1], 2.5), (w[2], 2.5), (w[3], 2.7)])
    assert best is w[1] and mcd == 2.5 and gap == 0.0
    best, mcd, gap = O.grid_argmin([(w[0], 3.0), (w[1], 2.0)])
    assert best is w[1] and gap == 1.0
    assert O.grid_argmin([(w[0], 1.0)])[2] == float("inf")


def test_morph_grid_is_the_jax_scripts_order():
    grid = O.morph_grid(6)
    assert len(grid) == 75
    np.testing.assert_array_equal(grid[0], np.float32([0.8, 0.2, 0, 0, 0, 0]))
    np.testing.assert_array_equal(grid[-1], np.float32([0, 0, 0, 0, 0.2, 0.8]))
    assert all(g.dtype == np.float32 and abs(float(g.sum()) - 1.0) < 1e-6 for g in grid)


class SilentCorpus(Q.Corpus):
    """The corpus with every rendition silent: the cases' identities need
    no audio (the corpus here holds utterance 45 only)."""

    def rendition(self, j, k):
        return np.zeros(4800, np.float32)


def test_condition_cases_follow_the_golden_rows(sides, golden):
    """Each condition's cases, in order, carry the golden rows' identities
    and weights (what `golden_failures` zips together)."""
    _, corpus = sides
    silent = SilentCorpus(corpus.root, corpus.manifest, corpus.plans, corpus.speakers)
    ood = golden["ood"]
    for name in ("noise_snr_10db", "unseen_f0_low_75hz", "unseen_source_novel_timbre",
                 "unseen_source", "morph_target_unseen"):
        metas = [c.meta for c in O.condition_cases(silent, name, fits=ood["morph_fits"])]
        assert metas == [{k: v for k, v in r.items() if k not in ("converted", "do_nothing")}
                         for r in ood[name]["rows"]], name


def test_golden_check_of_a_whole_run_needs_every_condition_row_and_fit(sides, golden):
    """The golden file's own OOD section as a run passes the whole check (68
    rows); a run without --model6, or one row short, fails it and passes
    as a subset (the rows are not converted: no model is needed)."""
    _, corpus = sides
    silent = SilentCorpus(corpus.root, corpus.manifest, corpus.plans, corpus.speakers)
    ood = json.loads(json.dumps(golden["ood"]))
    res = O.golden_failures(None, None, silent, ood, golden)
    assert res["checked"] == 68 and not res["failures"], res["failures"][:3]
    no_model6 = {k: v for k, v in ood.items() if k not in ("morph_fits", "morph_target_unseen")}
    no_model6["unseen_source"] = no_model6["morph_target_unseen"] = "skipped: no --model6"
    failures = O.golden_failures(None, None, silent, no_model6, golden)["failures"]
    assert sorted(f.get("condition", "fits") for f in failures) == \
        ["fits", "morph_target_unseen", "unseen_source"]
    assert {"morph_fits": "missing", "held_out": [6, 7]} in failures
    assert not O.golden_failures(None, None, silent, no_model6, golden, subset=True)["failures"]
    short = json.loads(json.dumps(ood))
    short["noise_snr_10db"]["rows"].pop()
    (failure,) = O.golden_failures(None, None, silent, short, golden)["failures"]
    assert (failure["condition"], failure["scored"], failure["golden"]) == ("noise_snr_10db", 8, 9)


def test_golden_run_refuses_a_missing_model6(tmp_path):
    with pytest.raises(SystemExit, match="--model6"):
        O.main(["--golden", GOLDEN, "--model6", str(tmp_path / "none"), "--device", "cpu"])
