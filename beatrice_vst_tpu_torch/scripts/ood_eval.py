"""Out-of-distribution conversion quality through the port (counterpart of
the repo's `scripts/ood_eval.py`, which runs the JAX package).

    python -m beatrice_vst_tpu_torch.scripts.ood_eval
        [--model models_demo/klatt8] [--model6 models_demo/klatt6]
        [--corpus $TMPDIR/beatrice_corpus] [--held-out 6 7]
        [--report docs/TORCH_QUALITY_REPORT.json]
        [--golden tests/data/torch_quality_golden.json] [--device cuda]

Each condition is scored with `quality_eval`'s battery (MCD, F0 RMSE and
voicing against the plan's F0, LSD) beside the do-nothing baseline, on the
first three held-out utterances:

  noise_snr_{20,10}db         sources plus white noise at that SNR
                              (rng(snr)), converted by --model, scored
                              against clean targets;
  unseen_f0_{high_330hz,low_75hz}  the utterances re-rendered with their
                              contour moved to that geometric-mean F0,
                              sources and targets alike (pitch is kept by
                              design);
  unseen_source_novel_timbre  two synthesizer voices outside the corpus's
                              timbre range converted to trained targets;
  unseen_source               --model6 (trained without the --held-out
                              speakers) converting from them;
  morph_target_unseen         a held-out speaker reached through the morph
                              path of --model6: weights over two trained
                              speakers fit on one calibration utterance by
                              the MCD grid (15 pairs x 5 ratios,
                              `grid_argmin`), then scored on the next two.

Each condition is a generator of cases (numpy: the source, the reference,
the plan's F0, the settings) and `score_case` converts and scores one.
The "ood" section (aggregates, rows, the morph fits) is merged into
--report, never into the JAX package's report.  With --golden every row
and fit is held to the golden file's as `quality_eval` holds its rows; a
fit that picks other weights passes only where the golden fit's
runner-up lay within 1e-3 dB.  --golden needs --model6: every golden
condition, row and fit must have been scored.
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import os
import sys
import time

import numpy as np
import torch

from ..runtime.offline import ConversionSettings
from ..training.quality import compare, mcd_db
from ..training.synthesis import SpeakerSpec, render
from . import make_corpus as MC
from . import quality_eval as Q

MODEL6_DIR = os.path.join(Q.REPO, "models_demo", "klatt6")
NOISE_SNRS_DB = (20.0, 10.0)
NOISE_PAIRS = ((0, 3), (2, 5), (4, 1))
REGISTERS = (("high_330hz", 330.0), ("low_75hz", 75.0))
REGISTER_PAIRS = ((1, 4), (3, 0), (5, 2))
NOVEL = (SpeakerSpec("novel_deep", 0.78, 0.93, 0.6, 0.05, 0.48, 1.2),
         SpeakerSpec("novel_bright", 1.30, 1.05, 0.0, 0.16, 0.8, 0.9))
NOVEL_TARGETS = (1, 4)
MORPH_RATIOS = (0.2, 0.35, 0.5, 0.65, 0.8)
HELD_OUT = (6, 7)
N_UTTS = 3  # each condition runs on the first three held-out utterances
MORPH_TIE_DB = 1e-3  # a fit whose golden runner-up lies this close is a tie


@dataclasses.dataclass
class Case:
    """One conversion to score: the row's identity, the source and the
    reference audio, the plan's F0 and the conversion's settings."""

    meta: dict
    src: np.ndarray
    ref: np.ndarray
    gt: np.ndarray | None
    settings: ConversionSettings


def noise_cases(corpus: Q.Corpus, snr_db: float):
    rng = np.random.default_rng(int(snr_db))
    for j in corpus.manifest["eval_utterances"][:N_UTTS]:
        gt = corpus.f0_truth(j)
        for s, t in NOISE_PAIRS:
            src, ref = corpus.rendition(j, s), corpus.rendition(j, t)
            p_sig = float(np.mean(src ** 2))
            noise = rng.standard_normal(len(src)).astype(np.float32)
            noise *= np.sqrt(p_sig / 10 ** (snr_db / 10))
            yield Case({"utt": j, "src": s, "tgt": t}, src + noise, ref, gt,
                       ConversionSettings(target_speaker=t))


def register_cases(corpus: Q.Corpus, reg_hz: float):
    sr = corpus.sample_rate
    for j in corpus.manifest["eval_utterances"][:N_UTTS]:
        segs, f0 = corpus.plans[j]
        gmean = float(np.exp(np.mean(np.log(np.maximum(f0, 1e-3)))))
        f0_reg = f0 * (reg_hz / gmean)
        gt = corpus.f0_truth(j, f0_reg)
        for s, t in REGISTER_PAIRS:
            src = render(segs, f0_reg, corpus.speakers[s],
                         np.random.default_rng(777001 + j * 131 + s), sr)
            ref = render(segs, f0_reg, corpus.speakers[t],
                         np.random.default_rng(777002 + j * 131 + t), sr)
            yield Case({"utt": j, "src": s, "tgt": t}, src, ref, gt,
                       ConversionSettings(target_speaker=t))


def novel_cases(corpus: Q.Corpus):
    sr = corpus.sample_rate
    for j in corpus.manifest["eval_utterances"][:N_UTTS]:
        segs, f0 = corpus.plans[j]
        gt = corpus.f0_truth(j)
        for si, spk in enumerate(NOVEL):
            for t in NOVEL_TARGETS:
                src = render(segs, f0, spk, np.random.default_rng(888001 + j * 131 + si), sr)
                yield Case({"utt": j, "src": spk.name, "tgt": t}, src, corpus.rendition(j, t),
                           gt, ConversionSettings(target_speaker=t))


def trained_speakers(corpus: Q.Corpus, held_out) -> list:
    return [k for k in range(corpus.manifest["n_speakers"]) if k not in held_out]


def unseen_source_cases(corpus: Q.Corpus, held_out=HELD_OUT):
    trained = trained_speakers(corpus, held_out)
    for j in corpus.manifest["eval_utterances"][:N_UTTS]:
        gt = corpus.f0_truth(j)
        for s in held_out:
            for t in trained[:2]:
                yield Case({"utt": j, "src": s, "tgt": t}, corpus.rendition(j, s),
                           corpus.rendition(j, t), gt, ConversionSettings(target_speaker=t))


def morph_weights(n_trained: int, a: int, b: int, w: float) -> np.ndarray:
    wts = np.zeros(n_trained, np.float32)
    wts[a], wts[b] = 1 - w, w
    return wts


def morph_grid(n_trained: int, pairs=None, ratios=MORPH_RATIOS) -> list:
    """The fit's weights in the JAX script's order: every pair a < b of
    trained speakers (or `pairs`), each at every ratio."""
    pairs = pairs or [(a, b) for a in range(n_trained) for b in range(a + 1, n_trained)]
    return [morph_weights(n_trained, a, b, w) for a, b in pairs for w in ratios]


def grid_argmin(grid) -> tuple:
    """(weights, MCD, runner-up gap in dB) of [(weights, MCD)] in grid
    order: the first strictly smallest MCD, as the JAX script's loop keeps
    it; the gap is the next smallest MCD minus it (0 at an exact tie)."""
    best = (None, np.inf)
    for wts, mcd in grid:
        if mcd < best[1]:
            best = (wts, mcd)
    others = [mcd for wts, mcd in grid if wts is not best[0]]
    gap = float(min(others) - best[1]) if others else float("inf")
    return best[0], float(best[1]), gap


def morph_fit(model: Q.Model, corpus: Q.Corpus, held: int, held_out=HELD_OUT, pairs=None,
              ratios=MORPH_RATIOS) -> dict:
    """Fit morph weights toward held-out speaker `held` on the first
    held-out utterance: trained speaker 0's rendition converted with each
    grid weight, scored by MCD (to 3 places, as `compare` rounds it)
    against `held`'s rendition."""
    trained = trained_speakers(corpus, held_out)
    cal_j = corpus.manifest["eval_utterances"][0]
    sr = corpus.sample_rate
    cal_src, cal_ref = corpus.rendition(cal_j, trained[0]), corpus.rendition(cal_j, held)
    grid = [(wts, round(mcd_db(Q.convert(model, cal_src, sr,
                                         ConversionSettings(morph_weights=wts)), cal_ref, sr), 3))
            for wts in morph_grid(len(trained), pairs, ratios)]
    wts, mcd, gap = grid_argmin(grid)
    return {"held_out": held, "weights": wts.tolist(), "cal_mcd_db": mcd,
            "runner_up_gap_db": gap, "grid_mcd_db": [m for _, m in grid]}


def morph_cases(corpus: Q.Corpus, held: int, weights, held_out=HELD_OUT):
    trained = trained_speakers(corpus, held_out)
    wts = np.asarray(weights, np.float32)
    for j in corpus.manifest["eval_utterances"][1:N_UTTS]:
        gt = corpus.f0_truth(j)
        for s in trained[:2]:
            yield Case({"utt": j, "src": s, "tgt_held_out": held,
                        "morph_weights": np.round(wts, 3).tolist()},
                       corpus.rendition(j, s), corpus.rendition(j, held), gt,
                       ConversionSettings(morph_weights=wts))


def score_case(model: Q.Model, case: Case, sr: int) -> dict:
    conv = Q.convert(model, case.src, sr, case.settings)
    return {**case.meta, "converted": compare(conv, case.ref, sr, f0_truth=case.gt),
            "do_nothing": compare(case.src, case.ref, sr, f0_truth=case.gt)}


def aggregate(rows) -> dict:
    """The JAX script's per-condition aggregate, with the rows."""
    out = {key: Q.mean_metrics(rows, key) for key in ("converted", "do_nothing")}
    return {**out, "n_pairs": len(rows), "rows": rows}


def flagship_conditions(corpus: Q.Corpus) -> dict:
    """{condition: its cases} of the flagship model's conditions."""
    out = {f"noise_snr_{int(snr)}db": noise_cases(corpus, snr) for snr in NOISE_SNRS_DB}
    out.update({f"unseen_f0_{name}": register_cases(corpus, hz) for name, hz in REGISTERS})
    out["unseen_source_novel_timbre"] = novel_cases(corpus)
    return out


def run_ood(model: Q.Model, model6: Q.Model | None, corpus: Q.Corpus, held_out=HELD_OUT,
            log=print) -> dict:
    """Every condition; returns the "ood" section."""
    watch = Q.CaptureWatch()
    t0 = time.time()
    sr = corpus.sample_rate
    ood = {}

    def run(name, model_, cases):
        rows = []
        for case in cases:
            rows.append(score_case(model_, case, sr))
            watch.note()
            log(f"{name} {json.dumps(rows[-1])}")
        ood[name] = aggregate(rows)

    for name, cases in flagship_conditions(corpus).items():
        run(name, model, cases)
    if model6 is not None:
        run("unseen_source", model6, condition_cases(corpus, "unseen_source", held_out))
        fits = []
        for held in held_out:
            fits.append(morph_fit(model6, corpus, held, held_out))
            watch.note()
            log(f"morph fit for held-out spk{held}: weights "
                f"{np.round(fits[-1]['weights'], 2).tolist()} cal MCD {fits[-1]['cal_mcd_db']:.2f}"
                f" (runner-up +{fits[-1]['runner_up_gap_db']:.3f} dB)")
        run("morph_target_unseen", model6,
            condition_cases(corpus, "morph_target_unseen", held_out, fits))
        ood["morph_fits"] = fits
        ood["model6"] = Q.relpath(model6.path)
        ood["held_out_speakers"] = list(held_out)
    else:
        ood["unseen_source"] = ood["morph_target_unseen"] = "skipped: no --model6"
    ood.update(Q.device_fields(model.device))
    ood["compiled_steps"] = watch.stats()
    ood["wall_s"] = round(time.time() - t0, 1)
    return ood


def condition_cases(corpus: Q.Corpus, name: str, held_out=HELD_OUT, fits=None):
    """The cases of condition `name` (a morph condition needs its fits)."""
    if name == "unseen_source":
        return unseen_source_cases(corpus, held_out)
    if name == "morph_target_unseen":
        return itertools.chain.from_iterable(
            morph_cases(corpus, f["held_out"], f["weights"], held_out) for f in fits)
    return flagship_conditions(corpus)[name]


def golden_failures(model: Q.Model, model6: Q.Model | None, corpus: Q.Corpus, ood: dict,
                    golden: dict, held_out=HELD_OUT, subset: bool = False) -> dict:
    """Every OOD row and morph fit against the golden file's: rows as
    `quality_eval.golden_failures` holds them (do_nothing exactly, converted
    within its tolerance or a located tie); a fit's weights equal, or the
    golden runner-up within MORPH_TIE_DB (then the held speaker's morph rows
    are not compared: their weights differ).  Unless `subset`, every golden
    condition's rows and every golden fit must be in `ood`."""
    want = golden["ood"]
    out = {"checked": 0, "ties": [], "failures": [], "morph_ties": []}
    if not subset:
        for name, section in want.items():
            if isinstance(section, dict) and "rows" in section:
                got = ood.get(name)
                rows = got["rows"] if isinstance(got, dict) and "rows" in got else []
                out["failures"] += Q.coverage_failures(rows, section["rows"], {"condition": name})
        fitted = {f["held_out"] for f in ood.get("morph_fits", [])}
        missing = [f["held_out"] for f in want["morph_fits"] if f["held_out"] not in fitted]
        if missing:
            out["failures"].append({"morph_fits": "missing", "held_out": missing})
    tied_fits = set()
    for fit in ood.get("morph_fits", []):
        ref = next((f for f in want["morph_fits"] if f["held_out"] == fit["held_out"]), None)
        if ref is None:
            out["failures"].append({"morph_fit": fit["held_out"],
                                    "missing": "not in the golden file"})
            continue
        if not np.array_equal(np.float32(fit["weights"]), np.float32(ref["weights"])):
            if ref["runner_up_gap_db"] < MORPH_TIE_DB:
                tied_fits.add(fit["held_out"])
                out["morph_ties"].append({"held_out": fit["held_out"], "got": fit["weights"],
                                          "want": ref["weights"],
                                          "golden_gap_db": ref["runner_up_gap_db"]})
            else:
                out["failures"].append({"morph_fit": fit["held_out"], "got": fit["weights"],
                                        "want": ref["weights"]})
    for name, section in ood.items():
        if not isinstance(section, dict) or "rows" not in section:
            continue
        if name not in want:
            out["failures"].append({"condition": name, "missing": "not in the golden file"})
            continue
        wanted = {Q.row_key(r): r for r in want[name]["rows"]}
        cases = condition_cases(corpus, name, held_out, ood.get("morph_fits"))
        model_ = model6 if name in ("unseen_source", "morph_target_unseen") else model
        for row, case in zip(section["rows"], cases):
            if row.get("tgt_held_out") in tied_fits:
                continue
            ref = wanted.get(Q.row_key(row))
            if ref is None:
                out["failures"].append({"condition": name, "row": Q.row_key(row),
                                        "missing": "not in the golden file"})
                continue
            res = Q.check_row(model_, corpus, row, ref, ("converted",), ("do_nothing",),
                              source=case.src, settings_of=lambda _, c=case: c.settings)
            out["checked"] += 1
            out["ties"] += [{"condition": name, **t} for t in res["ties"]]
            out["failures"] += [{"condition": name, "row": Q.row_key(row), "key": k,
                                 "metric": m, "got": g, "want": w}
                                for k, m, g, w in res["failures"]]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", default=Q.MODEL_DIR)
    ap.add_argument("--model6", default=MODEL6_DIR)
    ap.add_argument("--corpus", default=MC.default_corpus())
    ap.add_argument("--held-out", type=int, nargs="*", default=list(HELD_OUT))
    ap.add_argument("--report", default=Q.REPORT)
    ap.add_argument("--golden", default=None,
                    help="hold every row and fit to this golden file (the JAX package's)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.golden and not os.path.isdir(args.model6):
        raise SystemExit(f"--golden holds every condition to the golden file, and the held-out "
                         f"conditions need --model6 ({args.model6} is not a directory)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    corpus = Q.load_corpus(args.corpus)
    model = Q.load_model(args.model, args.device)
    model6 = Q.load_model(args.model6, args.device) if os.path.isdir(args.model6) else None
    held_out = tuple(args.held_out)
    ood = run_ood(model, model6, corpus, held_out, log=lambda s: print(s, flush=True))
    ok = True
    if args.golden:
        ood["golden"] = {"file": Q.relpath(args.golden),
                         **golden_failures(model, model6, corpus, ood,
                                           Q.load_golden(args.golden), held_out)}
        ok = not ood["golden"]["failures"]
    Q.merge_report(args.report, {"ood": ood})
    print(json.dumps({k: {m: v for m, v in s.items() if m != "rows"} if isinstance(s, dict)
                      else s for k, s in ood.items()}, indent=1))
    print("merged into", args.report)
    if args.golden:
        print("OOD vs GOLDEN:", "PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
