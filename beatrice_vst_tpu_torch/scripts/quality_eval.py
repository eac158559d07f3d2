"""Objective conversion quality on held-out utterances, through the port
(counterpart of the repo's `scripts/quality_eval.py`, which runs the JAX
package).

    python -m beatrice_vst_tpu_torch.scripts.quality_eval
        [--model models_demo/klatt8] [--corpus $TMPDIR/beatrice_corpus]
        [--pairs-per-utt 6] [--no-soft-pitch-ab] [--demo-wavs 3]
        [--demo-dir $TMPDIR/beatrice_audio_demo]
        [--report docs/TORCH_QUALITY_REPORT.json]
        [--golden tests/data/torch_quality_golden.json]
        [--promote-over INCUMBENT_REPORT] [--device cuda]

For every held-out utterance of the corpus (`make_corpus`) and a draw of
(source speaker -> target voice) pairs (`eval_pairs`: the JAX script's
`rng(123)` draw), converts the source rendition with `convert_utterance`
(compiled: one captured step per utterance length and pitch mode) and
scores it against the target speaker's own rendition of the utterance
(frame-aligned, no DTW): MCD, F0 RMSE and voicing against the synthesis
plan's F0, LSD (`training/quality.py:compare`).  Beside it: "do_nothing"
(the source rendition itself) and "rerender_floor" (the target speaker
re-rendered with another noise seed), and with the soft-pitch A/B
"converted_soft".  Renditions are read from the corpus's 16-bit WAVs.

The report is merged into --report (sections of other tools, such as
`ood_eval`'s "ood", survive).  With --golden every row is held to the
golden file's (the JAX package's rows on the CPU for the same pairs,
`golden_failures`): the model-free rows exactly, each converted row's MCD
and LSD within 0.05 dB, voicing within 0.02 and F0 RMSE within 5 cents,
unless the F0 tracker's decisions differ only at near-ties (`locate_ties`,
run against the port's own conversion on the CPU); every golden pair must
have been scored, with the soft-pitch A/B.  The outcome goes into the
report's "golden" section and the exit code.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from ..audio_io import read_wav, write_wav
from ..models.io import load_model_dir, params_from_numpy
from ..runtime import graphs
from ..runtime.offline import ConversionSettings, convert_utterance
from ..training.quality import EPS, compare, f0_track_parts, should_promote
from ..training.synthesis import default_speakers, plan_f0_voiced, render
from .make_corpus import default_corpus
from .make_corpus import plans as draw_plans

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
MODEL_DIR = os.path.join(REPO, "models_demo", "klatt8")
REPORT = os.path.join(REPO, "docs", "TORCH_QUALITY_REPORT.json")
GOLDEN = os.path.join(REPO, "tests", "data", "torch_quality_golden.json")
METRICS = ("mcd_db", "f0_rmse_cents", "voicing_agreement", "lsd_db")
# a converted row against the golden file's (the card's waveforms differ
# from the CPU's by up to ~1.6e-4)
TOLERANCE = {"mcd_db": 0.05, "lsd_db": 0.05, "voicing_agreement": 0.02, "f0_rmse_cents": 5.0}
# a tracker decision whose deciding quantity lies within this relative
# margin of its threshold (or of the runner-up) is a tie
TIE_MARGIN = 1e-3
FLOOR_SEED = 987650  # the re-render floor's noise: 987650 + j * 131 + t
NOTE = ("corpus is synthetic (Klatt-style formant synthesis, training/synthesis.py); "
        "parallel renditions make the metrics frame-aligned (no DTW)")


@dataclasses.dataclass
class Corpus:
    """A corpus directory (`make_corpus`) and its utterance plans."""

    root: str
    manifest: dict
    plans: list
    speakers: list

    @property
    def sample_rate(self) -> int:
        return int(self.manifest["sample_rate"])

    def rendition(self, j: int, k: int) -> np.ndarray:
        """Speaker k's rendition of utterance j, read from its 16-bit WAV."""
        audio, _ = read_wav(os.path.join(self.root, "raw", self.manifest["speakers"][k],
                                         f"utt{j:03d}.wav"))
        return audio

    def f0_truth(self, j: int, f0=None) -> np.ndarray:
        """The plan's F0 per 10 ms frame, 0 where unvoiced (of `f0` in place
        of the plan's contour if given)."""
        segs, plan_f0 = self.plans[j]
        return plan_f0_voiced(segs, plan_f0 if f0 is None else f0)


def load_corpus(root: str) -> Corpus:
    with open(os.path.join(root, "manifest.json")) as f:
        manifest = json.load(f)
    return Corpus(root, manifest, draw_plans(manifest["n_utterances"], manifest["seed"]),
                  default_speakers(manifest["n_speakers"]))


@dataclasses.dataclass
class Model:
    """A model directory's weights on `device` (tensors, so that every
    conversion reuses the compiled steps captured for them) and on the host
    (for `locate_ties`' CPU conversion)."""

    path: str
    cfg: object
    params: dict
    bank: dict
    host_params: dict
    host_bank: dict
    device: torch.device


def load_model(path: str, device="cuda") -> Model:
    _, cfg, params, bank = load_model_dir(path)
    dev = torch.device(device)
    return Model(path, cfg, params_from_numpy(params, dev),
                 {k: v.float() for k, v in params_from_numpy(bank, dev).items()},
                 params, bank, dev)


def convert(model: Model, audio, sr: int, settings: ConversionSettings, device=None) -> np.ndarray:
    """`convert_utterance` at `sr` in and out on the model's device (or on
    `device`, from the host weights)."""
    if device is None or torch.device(device) == model.device:
        return convert_utterance(model.params, model.cfg, model.bank, audio, sr, settings,
                                 out_sample_rate=sr, device=model.device)
    return convert_utterance(model.host_params, model.cfg, model.host_bank, audio, sr, settings,
                             out_sample_rate=sr, device=device)


def eval_pairs(manifest: dict, pairs_per_utt: int = 6) -> list:
    """[(utterance, source, target)]: per held-out utterance, distinct
    source != target pairs drawn from rng(123) until `pairs_per_utt`,
    sorted (the JAX script's draw)."""
    n = manifest["n_speakers"]
    rng = np.random.default_rng(123)
    out = []
    for j in manifest["eval_utterances"]:
        combos = set()
        want = min(pairs_per_utt, max(n * n - n, 0))
        while len(combos) < want:
            s, t = int(rng.integers(n)), int(rng.integers(n))
            if s != t:
                combos.add((s, t))
        out += [(j, s, t) for s, t in sorted(combos)]
    return out


def floor_rendition(corpus: Corpus, j: int, t: int) -> np.ndarray:
    """The target speaker's re-render of utterance j with another noise seed."""
    segs, f0 = corpus.plans[j]
    return render(segs, f0, corpus.speakers[t], np.random.default_rng(FLOOR_SEED + j * 131 + t),
                  corpus.sample_rate)


def score_pair(model: Model, corpus: Corpus, j: int, s: int, t: int, soft_ab: bool = True,
               audio: dict | None = None) -> dict:
    """The row of pair (j, s -> t): converted, do_nothing, rerender_floor
    and, with soft_ab, converted_soft.  `audio`, if given, receives the
    waveforms (src, ref, converted[, converted_soft])."""
    sr = corpus.sample_rate
    src, ref = corpus.rendition(j, s), corpus.rendition(j, t)
    gt = corpus.f0_truth(j)
    conv = convert(model, src, sr, ConversionSettings(target_speaker=t))
    row = {"utt": j, "src": s, "tgt": t,
           "converted": compare(conv, ref, sr, f0_truth=gt),
           "do_nothing": compare(src, ref, sr, f0_truth=gt),
           "rerender_floor": compare(floor_rendition(corpus, j, t), ref, sr, f0_truth=gt)}
    waves = {"src": src, "ref": ref, "converted": conv}
    if soft_ab:
        waves["converted_soft"] = convert(model, src, sr,
                                          ConversionSettings(target_speaker=t, soft_pitch=True))
        row["converted_soft"] = compare(waves["converted_soft"], ref, sr, f0_truth=gt)
    if audio is not None:
        audio.update(waves)
    return row


def mean_metrics(rows, key) -> dict:
    """Each metric's mean over the rows where it is finite, to 3 places."""
    def mean(m):
        vals = [r[key][m] for r in rows if r[key][m] is not None and np.isfinite(r[key][m])]
        return round(float(np.mean(vals)), 3) if vals else None

    return {m: mean(m) for m in METRICS}


def summarize(rows, soft_ab: bool = True) -> dict:
    keys = ["converted", "do_nothing", "rerender_floor"]
    if soft_ab:
        keys.insert(1, "converted_soft")
    summary = {k: mean_metrics(rows, k) for k in keys}
    summary["pairs_worse_than_do_nothing_mcd"] = worse_than_do_nothing(rows)
    return summary


def worse_than_do_nothing(rows) -> int:
    return int(sum(1 for r in rows if r["converted"]["mcd_db"] > r["do_nothing"]["mcd_db"]))


class CaptureWatch:
    """The step cache's captures, hits and evictions since construction, and
    the capture ms of every step captured meanwhile (`note` after each
    conversion: a step evicted later keeps its count)."""

    def __init__(self):
        self.start = dict(graphs.CACHE.counters)
        self.seen = {id(s) for s in graphs.CACHE.steps()}
        self.capture_ms = []

    def note(self):
        for s in graphs.CACHE.steps():
            if id(s) not in self.seen:
                self.seen.add(id(s))
                self.capture_ms.append(s.capture_ms)

    def stats(self) -> dict:
        self.note()
        now = graphs.CACHE.counters
        return {**{k: now[k] - self.start[k] for k in ("captures", "hits", "evictions")},
                "capture_ms_total": float(sum(self.capture_ms)),
                "capture_ms_max": float(max(self.capture_ms, default=0.0))}


def nvidia_smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def device_fields(device) -> dict:
    """The report's device name and, on a card, nvidia-smi's name and power
    limit."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return {"device": torch.cuda.get_device_name(dev), "nvidia_smi": nvidia_smi()}
    return {"device": "cpu"}


def relpath(path: str) -> str:
    """A path relative to the repo when it lies inside it, else absolute."""
    full = os.path.abspath(path)
    return os.path.relpath(full, REPO) if full.startswith(REPO + os.sep) else full


def evaluate(model: Model, corpus: Corpus, pairs_per_utt: int = 6, soft_ab: bool = True,
             demo_dir: str | None = None, demo_wavs: int = 0, log=print) -> dict:
    """Score every pair of `eval_pairs`; returns the report."""
    watch = CaptureWatch()
    rows, n_demo = [], 0
    t0 = time.time()
    for j, s, t in eval_pairs(corpus.manifest, pairs_per_utt):
        waves = {}
        rows.append(score_pair(model, corpus, j, s, t, soft_ab, audio=waves))
        watch.note()
        log(json.dumps(rows[-1]))
        if demo_dir and n_demo < demo_wavs:
            os.makedirs(demo_dir, exist_ok=True)
            stem = os.path.join(demo_dir, f"u{j:03d}_s{s}_to_t{t}")
            for suffix, key in (("input", "src"), ("converted", "converted"),
                                ("target_ref", "ref")):
                write_wav(f"{stem}_{suffix}.wav", waves[key], corpus.sample_rate)
            n_demo += 1
    return {
        **device_fields(model.device),
        "model": relpath(model.path),
        "n_eval_pairs": len(rows),
        "eval_utterances": corpus.manifest["eval_utterances"],
        "summary": summarize(rows, soft_ab),
        "pairs": rows,
        "wall_s": round(time.time() - t0, 1),
        "compiled_steps": watch.stats(),
        "note": NOTE,
    }


def merge_report(path: str, section: dict) -> dict:
    """Write `section`'s keys into the JSON report at `path`, keeping the
    keys it does not have."""
    report = {}
    if os.path.exists(path):
        try:
            with open(path) as f:
                report = json.load(f)
        except (json.JSONDecodeError, OSError):
            report = {}
    report.update(section)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(report, f, indent=1)
    return report


# ---- the golden file: the JAX package's rows on the CPU ----

def load_golden(path: str = GOLDEN) -> dict:
    with open(path) as f:
        return json.load(f)


def row_key(row) -> tuple:
    """A row's identity within its condition: utterance, source, target."""
    return (row["utt"], str(row["src"]), str(row.get("tgt", row.get("tgt_held_out"))))


def metric_deviations(got: dict, want: dict) -> dict:
    """|got - want| per metric (inf where exactly one is None)."""
    out = {}
    for m in METRICS:
        g, w = got[m], want[m]
        out[m] = 0.0 if g is None and w is None else (
            float("inf") if g is None or w is None else abs(float(g) - float(w)))
    return out


def row_failures(got_row: dict, want_row: dict, converted_keys, exact_keys=()) -> list:
    """[(key, metric, got, want)] of a row outside the golden row: the
    exact keys (model-free rows) must be equal, the converted keys within
    TOLERANCE."""
    out = []
    for key in exact_keys:
        for m in METRICS:
            if got_row[key][m] != want_row[key][m]:
                out.append((key, m, got_row[key][m], want_row[key][m]))
    for key in converted_keys:
        dev = metric_deviations(got_row[key], want_row[key])
        out += [(key, m, got_row[key][m], want_row[key][m])
                for m in METRICS if not dev[m] <= TOLERANCE[m]]
    return out


def f0_track_detail(x: np.ndarray, sr: int) -> dict:
    """`training/quality.py:f0_track_parts` with the margin of each
    decision per frame: the voicing test (clarity and energy), the first
    argmax (its top two local maxima), the re-lock's candidate set (each
    local maximum against half the peak)."""
    p = f0_track_parts(x, sr)
    band, lo, peak, lag0 = p["band"], p["lo"], p["peak"], p["lag0"]
    rows = np.arange(len(band))
    scale = np.maximum(np.abs(peak), EPS)
    # the first argmax: the gap between the best and second-best local max
    masked = np.where(p["local"], band, -np.inf)
    masked[rows, lag0 - lo] = -np.inf
    # the re-lock's candidate set: local maxima at half the frame's peak
    strong_gap = np.where(p["local"], np.abs(band - 0.5 * peak[:, None]), np.inf).min(-1)
    return {**p, "clarity_margin": np.abs(peak - p["clarity"]) / p["clarity"],
            "energy_margin": np.abs(p["e_db"] - p["e_thr"]) / max(abs(p["e_thr"]), EPS),
            "argmax_margin": (peak - masked.max(-1)) / scale, "strong_margin": strong_gap / scale}


def locate_ties(got: np.ndarray, ref: np.ndarray, sr: int) -> dict:
    """Where the F0 tracker decides differently on two conversions of one
    pair (the card's and the CPU's), and by what margin: every frame whose
    voicing, first argmax or re-locked lag differs, with the smallest
    margin of the decisions that could have flipped it, on either side.
    `tie` is true when some frame differs and every such frame's margin is
    under TIE_MARGIN (a differing median lag follows from those frames)."""
    a, b = f0_track_detail(got, sr), f0_track_detail(ref, sr)
    m = min(len(a["voiced"]), len(b["voiced"]))
    frames = []
    for i in range(m):
        why = []
        if a["voiced"][i] != b["voiced"][i]:
            why.append(("voicing", min(a["clarity_margin"][i], b["clarity_margin"][i],
                                       a["energy_margin"][i], b["energy_margin"][i])))
        if a["lag0"][i] != b["lag0"][i]:
            why.append(("argmax", min(a["argmax_margin"][i], b["argmax_margin"][i])))
        if a["lag"][i] != b["lag"][i] and a["lag0"][i] == b["lag0"][i] \
                and a["med_lag"] == b["med_lag"]:
            why.append(("relock", min(a["strong_margin"][i], b["strong_margin"][i])))
        if why:
            frames.append({"frame": i, "decisions": [w for w, _ in why],
                           "margin": float(min(v for _, v in why))})
    return {"frames": frames, "median_lag": [a["med_lag"], b["med_lag"]],
            "max_margin": max((f["margin"] for f in frames), default=None),
            "tie": bool(frames) and all(f["margin"] < TIE_MARGIN for f in frames)}


def check_row(model: Model, corpus: Corpus, got: dict, want: dict, converted_keys,
              exact_keys=(), source=None, settings_of=None) -> dict:
    """Hold one row to its golden row; an F0 or voicing miss of a converted
    key is located against the port's conversion on the CPU (`locate_ties`).
    source: the pair's input audio (default: the corpus rendition);
    settings_of(key): its ConversionSettings.  Returns {"ok", "failures",
    "ties"}."""
    failures = row_failures(got, want, converted_keys, exact_keys)
    ties = []
    pitch = {"f0_rmse_cents", "voicing_agreement"}
    missed = {key for key, m, *_ in failures if key in converted_keys and m in pitch}
    if missed and model.device.type != "cpu":
        sr = corpus.sample_rate
        src = corpus.rendition(got["utt"], got["src"]) if source is None else source
        for key in sorted(missed):
            settings = settings_of(key)
            located = locate_ties(convert(model, src, sr, settings),
                                  convert(model, src, sr, settings, device="cpu"), sr)
            ties.append({"utt": got["utt"], "src": got["src"], "tgt": got.get("tgt"),
                         "key": key, **located})
            if located["tie"]:
                failures = [f for f in failures if not (f[0] == key and f[1] in pitch)]
    return {"ok": not failures, "failures": failures, "ties": ties}


def pair_settings(t: int):
    return lambda key: ConversionSettings(target_speaker=t, soft_pitch=key == "converted_soft")


def coverage_failures(rows, golden_rows, where: dict) -> list:
    """A failure where `rows` are not the golden rows' pairs, each once."""
    got, want = sorted(map(row_key, rows)), sorted(map(row_key, golden_rows))
    if got == want:
        return []
    return [{**where, "scored": len(got), "golden": len(want),
             "missing": sorted(set(want) - set(got))}]


def golden_failures(model: Model, corpus: Corpus, rows, golden: dict, soft_ab: bool = True,
                    subset: bool = False) -> dict:
    """Every quality row against the golden file's row for its pair:
    {"checked", "ties", "failures", "worse_than_do_nothing": [got, want]}.
    Unless `subset`, the rows must be all of the golden file's pairs, each
    scored with and without soft pitch."""
    want = {row_key(r): r for r in golden["quality"]["pairs"]}
    keys = ("converted", "converted_soft") if soft_ab else ("converted",)
    out = {"checked": 0, "ties": [], "failures": []}
    if not subset:
        out["failures"] += coverage_failures(rows, golden["quality"]["pairs"],
                                             {"section": "quality"})
        if not soft_ab:
            out["failures"].append({"section": "quality", "missing": "converted_soft"})
    wanted_rows = []
    for row in rows:
        ref = want.get(row_key(row))
        if ref is None:
            out["failures"].append({"row": row_key(row), "missing": "not in the golden file"})
            continue
        wanted_rows.append(ref)
        res = check_row(model, corpus, row, ref, keys, ("do_nothing", "rerender_floor"),
                        settings_of=pair_settings(row["tgt"]))
        out["checked"] += 1
        out["ties"] += res["ties"]
        out["failures"] += [{"row": row_key(row), "key": k, "metric": m, "got": g, "want": w}
                            for k, m, g, w in res["failures"]]
    out["worse_than_do_nothing"] = [worse_than_do_nothing(rows), worse_than_do_nothing(wanted_rows)]
    if out["worse_than_do_nothing"][0] != out["worse_than_do_nothing"][1]:
        out["failures"].append({"pairs_worse_than_do_nothing_mcd": out["worse_than_do_nothing"]})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", default=MODEL_DIR)
    ap.add_argument("--corpus", default=default_corpus())
    ap.add_argument("--pairs-per-utt", type=int, default=6)
    ap.add_argument("--demo-wavs", type=int, default=3)
    ap.add_argument("--demo-dir",
                    default=os.path.join(tempfile.gettempdir(), "beatrice_audio_demo"))
    ap.add_argument("--soft-pitch-ab", dest="soft_ab", action="store_true", default=True,
                    help="also convert every pair with soft pitch (converted_soft)")
    ap.add_argument("--no-soft-pitch-ab", dest="soft_ab", action="store_false")
    ap.add_argument("--report", default=REPORT)
    ap.add_argument("--golden", default=None,
                    help="hold every row to this golden file (the JAX package's rows)")
    ap.add_argument("--promote-over", default=None,
                    help="a report of the incumbent model: record training/quality.py:"
                         "should_promote's verdict of this summary over its summary")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = load_model(args.model, args.device)
    corpus = load_corpus(args.corpus)
    report = evaluate(model, corpus, args.pairs_per_utt, args.soft_ab, args.demo_dir,
                      args.demo_wavs, log=lambda s: print(s, flush=True))
    ok = True
    if args.golden:
        golden = load_golden(args.golden)
        report["golden"] = {"file": relpath(args.golden),
                            **golden_failures(model, corpus, report["pairs"], golden,
                                              args.soft_ab)}
        ok = not report["golden"]["failures"]
    if args.promote_over:
        with open(args.promote_over) as f:
            incumbent = json.load(f)
        promote, reason = should_promote(incumbent["summary"], report["summary"])
        report["should_promote"] = {"over": relpath(args.promote_over),
                                    "incumbent_model": incumbent.get("model"),
                                    "promote": promote, "reason": reason}
    merge_report(args.report, report)
    print(json.dumps({k: report[k] for k in ("summary", "compiled_steps", "golden",
                                             "should_promote") if k in report}, indent=1))
    print(f"wrote {args.report}" + (f" + {min(args.demo_wavs, len(report['pairs'])) * 3} "
                                    f"demo wavs in {args.demo_dir}" if args.demo_dir else ""))
    if args.golden:
        print("QUALITY vs GOLDEN:", "PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
