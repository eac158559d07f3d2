"""The port's quality evaluation (`beatrice_vst_tpu_torch/scripts/
quality_eval.py`) against the JAX package on the CPU, and the quality
golden file.

`JaxSide` composes the JAX package's library functions exactly as the
repo's `scripts/quality_eval.py` and `scripts/ood_eval.py` call them (the
JAX scripts themselves write into docs/ and are not run here).  The tests
score pair (45, 0 -> 5) on klatt8 both ways: the model-free rows equal
docs/QUALITY_REPORT.json's first row digit for digit (its renditions read
back from 16-bit WAVs, as the corpus holds them); the converted rows equal
the JAX run's and the golden file's, to within one unit of the last place
`compare` rounds to (the waveforms agree to ~5e-7, and XLA's CPU sums
change with the thread count).  The golden file's pair list is
`eval_pairs`'.  The gates that hold a card run to the golden file
(`golden_failures`, `locate_ties`) are tested on the CPU rows.

`PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_quality_eval.py`
rewrites tests/data/torch_quality_golden.json: the JAX package's rows on
the CPU for the whole evaluation of klatt8 (30 pairs with the soft-pitch
A/B) and every OOD row (klatt6 for the held-out conditions), on the seed-0
corpus made by scripts/make_corpus.py in a temporary directory.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import pytest
import torch

from beatrice_vst_tpu.audio_io import read_wav as j_read_wav
from beatrice_vst_tpu.audio_io import write_wav as j_write_wav
from beatrice_vst_tpu.models.io import load_model_dir as j_load_model_dir
from beatrice_vst_tpu.runtime.offline import ConversionSettings as JSettings
from beatrice_vst_tpu.runtime.offline import convert_utterance as j_convert
from beatrice_vst_tpu.training import synthesis as JS
from beatrice_vst_tpu.training.quality import compare as j_compare
from beatrice_vst_tpu_torch.scripts import quality_eval as Q

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KLATT8 = os.path.join(REPO, "models_demo", "klatt8")
KLATT6 = os.path.join(REPO, "models_demo", "klatt6")
GOLDEN = os.path.join(REPO, "tests", "data", "torch_quality_golden.json")
JAX_REPORT = os.path.join(REPO, "docs", "QUALITY_REPORT.json")
# the corpus's split at its defaults (scripts/make_corpus.py: 50 utterances,
# 8 speakers, the last 5 held out, seed 0)
MANIFEST = {"n_speakers": 8, "n_utterances": 50, "eval_utterances": [45, 46, 47, 48, 49],
            "sample_rate": 48000, "seed": 0,
            "speakers": [f"spk{k}" for k in range(8)]}
UTT = 45  # every tier-1 row draws from utterance 45: one compiled JAX shape
# compare() rounds MCD, LSD and voicing to 3 places and F0 RMSE to 1
LAST_PLACE = {"mcd_db": 1e-3, "lsd_db": 1e-3, "voicing_agreement": 1e-3, "f0_rmse_cents": 0.1}


def write_renditions(root, utts, speakers, manifest=MANIFEST):
    """A corpus directory holding the renditions (j, k) of `utts` x
    `speakers`, rendered by the JAX package's synthesis.py as
    scripts/make_corpus.py renders them, and the full corpus's manifest."""
    rng = np.random.default_rng(manifest["seed"])
    plans = [JS.sample_utterance(rng) for _ in range(max(utts) + 1)]
    spk = JS.default_speakers(manifest["n_speakers"])
    for j in utts:
        for k in speakers:
            y = JS.render(*plans[j], spk[k],
                          np.random.default_rng(manifest["seed"] * 100003 + j * 131 + k), JS.SR)
            os.makedirs(os.path.join(root, "raw", spk[k].name), exist_ok=True)
            j_write_wav(os.path.join(root, "raw", spk[k].name, f"utt{j:03d}.wav"), y, JS.SR)
    with open(os.path.join(root, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    return root


def jax_pair_draw(n, eval_utts, pairs_per_utt=6):
    """scripts/quality_eval.py:83-98's pair draw."""
    rng = np.random.default_rng(123)
    out = []
    for j in eval_utts:
        combos = set()
        want = min(pairs_per_utt, max(n * n - n, 0))
        while len(combos) < want:
            s = int(rng.integers(n))
            t = int(rng.integers(n))
            if s != t:
                combos.add((s, t))
        out += [(j, s, t) for s, t in sorted(combos)]
    return out


class JaxSide:
    """The JAX scripts' protocol over the JAX package's library: the same
    calls, in the same order, with the same seeds."""

    def __init__(self, corpus_root, model_dir=KLATT8):
        self.root = corpus_root
        with open(os.path.join(corpus_root, "manifest.json")) as f:
            self.manifest = json.load(f)
        rng = np.random.default_rng(self.manifest["seed"])
        self.plans = [JS.sample_utterance(rng) for _ in range(self.manifest["n_utterances"])]
        self.speakers = JS.default_speakers(self.manifest["n_speakers"])
        self.sr = self.manifest["sample_rate"]
        self.eval_utts = self.manifest["eval_utterances"]
        self.models = {}
        self.model_dir = model_dir

    def model(self, path=None):
        path = path or self.model_dir
        if path not in self.models:
            _, cfg, params, bank = j_load_model_dir(path)
            self.models[path] = (params, cfg, bank)
        return self.models[path]

    def rendition(self, j, k):
        return j_read_wav(os.path.join(self.root, "raw", self.manifest["speakers"][k],
                                       f"utt{j:03d}.wav"))[0]

    def convert(self, audio, settings, model=None):
        return j_convert(*self.model(model), audio, self.sr, settings, out_sample_rate=self.sr)

    def gt(self, j):
        return JS.plan_f0_voiced(*self.plans[j])

    # scripts/quality_eval.py:99-131
    def quality_row(self, j, s, t, soft_ab=True):
        src, ref = self.rendition(j, s), self.rendition(j, t)
        conv = self.convert(src, JSettings(target_speaker=t))
        segs, f0 = self.plans[j]
        floor = JS.render(segs, f0, self.speakers[t],
                          np.random.default_rng(987650 + j * 131 + t), self.sr)
        gt = JS.plan_f0_voiced(segs, f0)
        row = {"utt": j, "src": s, "tgt": t,
               "converted": j_compare(conv, ref, self.sr, f0_truth=gt),
               "do_nothing": j_compare(src, ref, self.sr, f0_truth=gt),
               "rerender_floor": j_compare(floor, ref, self.sr, f0_truth=gt)}
        if soft_ab:
            conv_soft = self.convert(src, JSettings(target_speaker=t, soft_pitch=True))
            row["converted_soft"] = j_compare(conv_soft, ref, self.sr, f0_truth=gt)
        return row

    def quality_pairs(self, pairs_per_utt=6):
        return jax_pair_draw(len(self.speakers), self.eval_utts, pairs_per_utt)

    def _row(self, meta, src, ref, gt, settings, model=None):
        conv = self.convert(src, settings, model)
        return {**meta, "converted": j_compare(conv, ref, self.sr, f0_truth=gt),
                "do_nothing": j_compare(src, ref, self.sr, f0_truth=gt)}

    # scripts/ood_eval.py:104-131
    def noise_rows(self, snr_db, limit=None):
        rows = []
        rng = np.random.default_rng(int(snr_db))
        for j in self.eval_utts[:3]:
            gt = self.gt(j)
            for s, t in ((0, 3), (2, 5), (4, 1)):
                if limit is not None and len(rows) == limit:
                    return rows
                src, ref = self.rendition(j, s), self.rendition(j, t)
                p_sig = float(np.mean(src ** 2))
                noise = rng.standard_normal(len(src)).astype(np.float32)
                noise *= np.sqrt(p_sig / 10 ** (snr_db / 10))
                rows.append(self._row({"utt": j, "src": s, "tgt": t}, src + noise, ref, gt,
                                      JSettings(target_speaker=t)))
        return rows

    # scripts/ood_eval.py:145-160
    def register_rows(self, reg_hz, limit=None):
        rows = []
        for j in self.eval_utts[:3]:
            segs, f0 = self.plans[j]
            gmean = float(np.exp(np.mean(np.log(np.maximum(f0, 1e-3)))))
            f0_reg = f0 * (reg_hz / gmean)
            gt = JS.plan_f0_voiced(segs, f0_reg)
            for s, t in ((1, 4), (3, 0), (5, 2)):
                if limit is not None and len(rows) == limit:
                    return rows
                src = JS.render(segs, f0_reg, self.speakers[s],
                                np.random.default_rng(777001 + j * 131 + s), self.sr)
                ref = JS.render(segs, f0_reg, self.speakers[t],
                                np.random.default_rng(777002 + j * 131 + t), self.sr)
                rows.append(self._row({"utt": j, "src": s, "tgt": t}, src, ref, gt,
                                      JSettings(target_speaker=t)))
        return rows

    # scripts/ood_eval.py:169-191
    def novel_rows(self):
        novel = [JS.SpeakerSpec("novel_deep", 0.78, 0.93, 0.6, 0.05, 0.48, 1.2),
                 JS.SpeakerSpec("novel_bright", 1.30, 1.05, 0.0, 0.16, 0.8, 0.9)]
        rows = []
        for j in self.eval_utts[:3]:
            segs, f0 = self.plans[j]
            gt = JS.plan_f0_voiced(segs, f0)
            for si, spk in enumerate(novel):
                for t in (1, 4):
                    src = JS.render(segs, f0, spk, np.random.default_rng(888001 + j * 131 + si),
                                    self.sr)
                    rows.append(self._row({"utt": j, "src": spk.name, "tgt": t}, src,
                                          self.rendition(j, t), gt, JSettings(target_speaker=t)))
        return rows

    # scripts/ood_eval.py:198-217
    def unseen_source_rows(self, model6, held_out=(6, 7)):
        trained = [k for k in range(len(self.speakers)) if k not in held_out]
        rows = []
        for j in self.eval_utts[:3]:
            gt = self.gt(j)
            for s in held_out:
                for t in trained[:2]:
                    rows.append(self._row({"utt": j, "src": s, "tgt": t}, self.rendition(j, s),
                                          self.rendition(j, t), gt, JSettings(target_speaker=t),
                                          model6))
        return rows

    # scripts/ood_eval.py:222-248: the grid in order, MCD as compare rounds it
    def morph_grid(self, model6, held, held_out=(6, 7), pairs=None,
                   ratios=(0.2, 0.35, 0.5, 0.65, 0.8)):
        trained = [k for k in range(len(self.speakers)) if k not in held_out]
        cal_j = self.eval_utts[0]
        cal_src, cal_ref = self.rendition(cal_j, trained[0]), self.rendition(cal_j, held)
        pairs = pairs or [(a, b) for a in range(len(trained)) for b in range(a + 1, len(trained))]
        grid = []
        for a, b in pairs:
            for w in ratios:
                wts = np.zeros(len(trained), np.float32)
                wts[a], wts[b] = 1 - w, w
                conv = self.convert(cal_src, JSettings(morph_weights=wts), model6)
                grid.append((wts, j_compare(conv, cal_ref, self.sr)["mcd_db"]))
        return grid

    @staticmethod
    def fit(grid):
        """The JAX script's argmin (`mcd < best`), and the runner-up's gap."""
        best = (None, np.inf)
        for wts, mcd in grid:
            if mcd < best[1]:
                best = (wts, mcd)
        rest = sorted(m for w, m in grid if w is not best[0])
        return best[0], best[1], (rest[0] - best[1]) if rest else float("inf")

    # scripts/ood_eval.py:249-258
    def morph_rows(self, model6, held, wts, held_out=(6, 7)):
        trained = [k for k in range(len(self.speakers)) if k not in held_out]
        rows = []
        for j in self.eval_utts[1:3]:
            gt = self.gt(j)
            for s in trained[:2]:
                rows.append(self._row({"utt": j, "src": s, "tgt_held_out": held,
                                       "morph_weights": np.round(wts, 3).tolist()},
                                      self.rendition(j, s), self.rendition(j, held), gt,
                                      JSettings(morph_weights=wts), model6))
        return rows


def assert_metrics_close(got, want, label):
    for m, unit in LAST_PLACE.items():
        g, w = got[m], want[m]
        assert (g is None) == (w is None), (label, m, g, w)
        if g is not None:
            assert abs(g - w) <= unit * 1.0001, (label, m, g, w)


@pytest.fixture(scope="module")
def corpus_dir(tmp_path_factory):
    return write_renditions(str(tmp_path_factory.mktemp("corpus")), [UTT], [0, 3, 5, 6])


@pytest.fixture(scope="module")
def jax_side(corpus_dir):
    return JaxSide(corpus_dir)


@pytest.fixture(scope="module")
def port_model():
    return Q.load_model(KLATT8, "cpu")


@pytest.fixture(scope="module")
def golden():
    return Q.load_golden(GOLDEN)


@pytest.fixture(scope="module")
def pair_rows(jax_side, corpus_dir, port_model):
    port = Q.score_pair(port_model, Q.load_corpus(corpus_dir), UTT, 0, 5)
    return port, jax_side.quality_row(UTT, 0, 5)


def test_model_free_rows_equal_the_committed_report(pair_rows):
    """do_nothing and rerender_floor of (45, 0 -> 5) digit for digit as the
    JAX package's committed report has them (model-free: no device)."""
    port, jax = pair_rows
    first = json.load(open(JAX_REPORT))["pairs"][0]
    assert (first["utt"], first["src"], first["tgt"]) == (UTT, 0, 5)
    for key in ("do_nothing", "rerender_floor"):
        assert port[key] == first[key] == jax[key], key


def test_converted_rows_equal_jax_and_the_golden_file(pair_rows, golden):
    port, jax = pair_rows
    (want,) = [r for r in golden["quality"]["pairs"] if (r["utt"], r["src"], r["tgt"]) == (UTT, 0, 5)]
    for key in ("converted", "converted_soft"):
        assert_metrics_close(port[key], jax[key], f"{key} vs JAX")
        assert_metrics_close(port[key], want[key], f"{key} vs golden")
    for key in ("do_nothing", "rerender_floor"):
        assert port[key] == want[key]


def test_golden_gates_pass_on_the_cpu_row_and_catch_a_shift(pair_rows, golden, port_model,
                                                             corpus_dir):
    """`golden_failures` holds the CPU row to the golden file with nothing to
    report (a CPU model never runs the tie search) where the run is a
    subset, flags the 29 golden pairs left unscored where it is not, and
    flags a converted MCD moved past its tolerance and a changed
    model-free row."""
    port, _ = pair_rows
    corpus = Q.load_corpus(corpus_dir)
    res = Q.golden_failures(port_model, corpus, [port], golden, subset=True)
    assert res["checked"] == 1 and not res["failures"] and not res["ties"], res
    (short,) = Q.golden_failures(port_model, corpus, [port], golden)["failures"]
    assert (short["scored"], short["golden"], len(short["missing"])) == (1, 30, 29)
    assert Q.row_key(port) not in short["missing"]
    bad = json.loads(json.dumps(port))
    bad["converted"]["mcd_db"] += 0.06
    bad["rerender_floor"]["lsd_db"] += 0.001
    got = Q.row_failures(bad, port, ("converted", "converted_soft"),
                         ("do_nothing", "rerender_floor"))
    assert sorted((k, m) for k, m, *_ in got) == [("converted", "mcd_db"),
                                                  ("rerender_floor", "lsd_db")]
    assert not Q.row_failures(port, port, ("converted",), ("do_nothing",))


def test_golden_check_of_a_whole_run_needs_every_pair_and_the_soft_ab(golden, port_model,
                                                                    corpus_dir):
    """The golden file's own pairs as a run pass the whole check; a run
    without one pair, with one pair twice or without the soft-pitch A/B
    fails it (the rows are not converted: a CPU model checks by numbers)."""
    corpus = Q.load_corpus(corpus_dir)
    rows = json.loads(json.dumps(golden["quality"]["pairs"]))
    res = Q.golden_failures(port_model, corpus, rows, golden)
    assert res["checked"] == 30 and not res["failures"], res["failures"][:3]
    (gap,) = Q.golden_failures(port_model, corpus, rows[1:], golden)["failures"]
    assert gap["missing"] == [Q.row_key(rows[0])]
    (twice,) = Q.golden_failures(port_model, corpus, rows + rows[:1], golden)["failures"]
    assert (twice["scored"], twice["golden"], twice["missing"]) == (31, 30, [])
    no_ab = Q.golden_failures(port_model, corpus, rows, golden, soft_ab=False)["failures"]
    assert no_ab == [{"section": "quality", "missing": "converted_soft"}]


def test_locate_ties_finds_nothing_on_one_waveform_and_flags_a_change(corpus_dir):
    """`f0_track_detail` is `f0_track`; two equal waveforms have no
    differing frame; a waveform with a region replaced differs by far more
    than a tie there."""
    from beatrice_vst_tpu_torch.training.quality import f0_track

    x = Q.load_corpus(corpus_dir).rendition(UTT, 0)
    detail = Q.f0_track_detail(x, 48000)
    f0, voiced = f0_track(x, 48000)
    np.testing.assert_array_equal(detail["f0"], f0)
    np.testing.assert_array_equal(detail["voiced"], voiced)
    same = Q.locate_ties(x, x.copy(), 48000)
    assert same["frames"] == [] and not same["tie"]
    y = x.copy()
    y[20000:30000] = np.random.default_rng(0).standard_normal(10000).astype(np.float32) * 0.1
    moved = Q.locate_ties(y, x, 48000)
    assert moved["frames"] and not moved["tie"]
    assert moved["max_margin"] > Q.TIE_MARGIN


def test_golden_file_keys_and_pair_draw(golden):
    """The golden file holds the JAX evaluation's 30 pairs in `eval_pairs`'
    order (the JAX script's rng(123) draw), each with its four rows, and
    every OOD condition with its rows, on klatt8 and klatt6."""
    assert golden["model"] == "models_demo/klatt8" and golden["model6"] == "models_demo/klatt6"
    assert golden["device"] == "cpu" and golden["corpus"]["seed"] == 0
    pairs = golden["quality"]["pairs"]
    assert [(r["utt"], r["src"], r["tgt"]) for r in pairs] == Q.eval_pairs(golden["corpus"]) \
        == jax_pair_draw(8, golden["corpus"]["eval_utterances"])
    assert len(pairs) == 30
    for r in pairs:
        assert set(r) == {"utt", "src", "tgt", "converted", "converted_soft", "do_nothing",
                          "rerender_floor"}
        for key in ("converted", "converted_soft", "do_nothing", "rerender_floor"):
            assert set(r[key]) == set(Q.METRICS)
    assert golden["quality"]["summary"] == Q.summarize(pairs)
    ood = golden["ood"]
    sizes = {"noise_snr_20db": 9, "noise_snr_10db": 9, "unseen_f0_high_330hz": 9,
             "unseen_f0_low_75hz": 9, "unseen_source_novel_timbre": 12, "unseen_source": 12,
             "morph_target_unseen": 8}
    assert {k: len(ood[k]["rows"]) for k in sizes} == sizes
    assert [f["held_out"] for f in ood["morph_fits"]] == [6, 7]
    for f in ood["morph_fits"]:
        assert len(f["grid_mcd_db"]) == 75 and f["runner_up_gap_db"] >= 0.0
        assert f["cal_mcd_db"] == min(f["grid_mcd_db"])


def golden_run(log=print) -> dict:
    """The whole evaluation on the JAX package on the CPU (a corpus made by
    scripts/make_corpus.py in a temporary directory)."""
    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        subprocess.run([sys.executable, os.path.join(REPO, "scripts", "make_corpus.py"), tmp],
                       check=True, env=env, capture_output=True)
        side = JaxSide(tmp)
        corpus_s = time.time() - t0
        pairs = []
        for j, s, t in side.quality_pairs():
            pairs.append(side.quality_row(j, s, t))
            log(json.dumps(pairs[-1]))
        ood = {}
        for snr in (20.0, 10.0):
            ood[f"noise_snr_{int(snr)}db"] = side.noise_rows(snr)
        for name, hz in (("high_330hz", 330.0), ("low_75hz", 75.0)):
            ood[f"unseen_f0_{name}"] = side.register_rows(hz)
        ood["unseen_source_novel_timbre"] = side.novel_rows()
        ood["unseen_source"] = side.unseen_source_rows(KLATT6)
        fits, morph = [], []
        for held in (6, 7):
            grid = side.morph_grid(KLATT6, held)
            wts, mcd, gap = side.fit(grid)
            fits.append({"held_out": held, "weights": wts.tolist(), "cal_mcd_db": mcd,
                         "runner_up_gap_db": float(gap), "grid_mcd_db": [m for _, m in grid]})
            log(json.dumps(fits[-1]))
            morph += side.morph_rows(KLATT6, held, wts)
        ood["morph_target_unseen"] = morph
        manifest = side.manifest
    ood_out = {name: {**{k: Q.mean_metrics(rows, k) for k in ("converted", "do_nothing")},
                      "n_pairs": len(rows), "rows": rows} for name, rows in ood.items()}
    ood_out["morph_fits"] = fits
    return {
        "made_by": "PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_quality_eval.py",
        "device": "cpu", "model": "models_demo/klatt8", "model6": "models_demo/klatt6",
        "corpus": manifest,
        "quality": {"summary": Q.summarize(pairs), "pairs": pairs},
        "ood": ood_out,
        "seconds": {"corpus": round(corpus_s, 1), "total": round(time.time() - t0, 1)},
    }


if __name__ == "__main__":
    out = golden_run()
    with open(GOLDEN, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {GOLDEN} ({os.path.getsize(GOLDEN)} bytes) in {out['seconds']['total']} s")
