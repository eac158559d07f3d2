"""Synthesize the multi-speaker parallel corpus (counterpart of the repo's
`scripts/make_corpus.py`, which imports the JAX package; this one imports
only the port's NumPy copies of `training/synthesis.py` and `audio_io.py`).

    python -m beatrice_vst_tpu_torch.scripts.make_corpus [OUT_DIR]
        [--utts 50] [--speakers 8] [--eval-utts 5] [--pairs-per-utt 16]
        [--seed 0]

Renders the Klatt-style corpus and lays out the cross-speaker conversion
pairs in the `PairDataset` format (`training/data.py`): each pair is
(speaker s's utterance u -> speaker t's utterance u, conditioned on voice t).

    OUT_DIR/
      raw/spk{k}/utt{j}.wav      every rendition (48 kHz, 16-bit)
      raw/f0_plan.npz            utt{j} -> the plan's F0 per 10 ms frame
      pairs/inputs|targets/...   training pairs (train utterances only)
      pairs/speakers.json        pair name -> target voice id
      pairs/f0_plan.npz          pair name -> its utterance's F0 plan
      manifest.json              speakers, split, seconds

OUT_DIR defaults to beatrice_corpus in the temporary directory
(`tempfile.gettempdir()`: $TMPDIR, else /tmp), where the other drivers
look for it by default.

The last --eval-utts utterances are held out of pairs/ entirely:
`quality_eval` converts their source renditions and scores them against
the target renditions.  The seeds and the draws are the JAX script's, so
the files equal its files byte for byte (the two .npz archives member by
member: a zip header carries its write time).  One repair: a pair's F0
plan key is parsed from its name (`u1000_s0_t1` -> `utt1000`), where the
JAX script slices three digits (`utt100`); below 1,000 utterances the
output is the same.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import sys
import tempfile

import numpy as np

from ..audio_io import write_wav
from ..training.synthesis import SR, default_speakers, plan_f0_voiced, render, sample_utterance

RENDER_SEED = 100003  # rendition (j, k) draws its noise from seed * 100003 + j * 131 + k
PAIR_SEED_OFFSET = 1  # the pair draw's generator: seed + 1


def default_corpus() -> str:
    """The corpus directory the drivers default to, in the temporary
    directory."""
    return os.path.join(tempfile.gettempdir(), "beatrice_corpus")


def utterance_key(pair_name: str) -> str:
    """The f0 plan key of a pair named u{j:03d}_s{s}_t{t}: utt{j:03d}."""
    m = re.match(r"u(\d+)_s\d+_t\d+$", pair_name)
    if not m:
        raise ValueError(f"not a pair name: {pair_name!r}")
    return f"utt{int(m.group(1)):03d}"


def plans(n_utts: int, seed: int = 0) -> list:
    """The (segments, F0 per frame) plan of every utterance, drawn in order
    from one generator seeded with `seed`, as the corpus draws them."""
    rng = np.random.default_rng(seed)
    return [sample_utterance(rng) for _ in range(n_utts)]


def rendition(plan_list, speakers, j: int, k: int, seed: int = 0) -> np.ndarray:
    """Speaker k's rendition of utterance j at 48 kHz, as the corpus renders
    it (float32, before the 16-bit WAV write)."""
    segs, f0 = plan_list[j]
    return render(segs, f0, speakers[k], np.random.default_rng(seed * RENDER_SEED + j * 131 + k),
                  SR)


def render_utterances(out: str, plan_list, speakers, utts, seed: int = 0) -> float:
    """Write every speaker's rendition of each utterance in `utts` to
    out/raw/<speaker>/utt{j:03d}.wav; returns the seconds rendered."""
    total = 0.0
    for j in utts:
        for k, s in enumerate(speakers):
            y = rendition(plan_list, speakers, j, k, seed)
            d = os.path.join(out, "raw", s.name)
            os.makedirs(d, exist_ok=True)
            write_wav(os.path.join(d, f"utt{j:03d}.wav"), y, SR)
            total += len(y) / SR
    return total


def write_manifest(out: str, speakers, utts: int, eval_utts: int, n_pairs: int, seconds: float,
                   seed: int) -> dict:
    """Write out/manifest.json (the corpus of `utts` utterances, the last
    `eval_utts` held out); returns it."""
    manifest = {
        "n_speakers": len(speakers),
        "n_utterances": utts,
        "eval_utterances": list(range(utts - eval_utts, utts)),
        "n_pairs": n_pairs,
        "seconds_rendered": round(seconds, 1),
        "sample_rate": SR,
        "seed": seed,
        "speakers": [s.name for s in speakers],
    }
    with open(os.path.join(out, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    return manifest


def make_corpus(out: str, utts: int = 50, speakers: int = 8, eval_utts: int = 5,
                pairs_per_utt: int = 16, seed: int = 0, log=print) -> dict:
    """Render the corpus into `out` (replacing it); returns the manifest."""
    spk = default_speakers(speakers)
    raw = os.path.join(out, "raw")
    if os.path.isdir(out):
        shutil.rmtree(out)
    plan_list = plans(utts, seed)
    log(f"rendering {utts} utterances x {len(spk)} speakers ...")
    total = render_utterances(out, plan_list, spk, range(utts), seed)
    plan_f0 = {f"utt{j:03d}": plan_f0_voiced(segs, f0) for j, (segs, f0) in enumerate(plan_list)}

    # training pairs from the train split: for each utterance, (src, tgt)
    # combos drawn until `want` distinct; identity pairs anchor content
    # passthrough
    n_train = utts - eval_utts
    pairs_dir = os.path.join(out, "pairs")
    os.makedirs(os.path.join(pairs_dir, "inputs"))
    os.makedirs(os.path.join(pairs_dir, "targets"))
    rng_pairs = np.random.default_rng(seed + PAIR_SEED_OFFSET)
    spk_map = {}
    for j in range(n_train):
        combos = set()
        want = min(pairs_per_utt, len(spk) ** 2)
        while len(combos) < want:
            combos.add((int(rng_pairs.integers(len(spk))), int(rng_pairs.integers(len(spk)))))
        for s, t in sorted(combos):
            name = f"u{j:03d}_s{s}_t{t}"
            os.link(os.path.join(raw, spk[s].name, f"utt{j:03d}.wav"),
                    os.path.join(pairs_dir, "inputs", name + ".wav"))
            os.link(os.path.join(raw, spk[t].name, f"utt{j:03d}.wav"),
                    os.path.join(pairs_dir, "targets", name + ".wav"))
            spk_map[name] = t
    with open(os.path.join(pairs_dir, "speakers.json"), "w") as f:
        json.dump(spk_map, f)
    # the plan's exact F0 labels, which PairDataset prefers over the tracker
    np.savez(os.path.join(pairs_dir, "f0_plan.npz"),
             **{name: plan_f0[utterance_key(name)] for name in spk_map})
    np.savez(os.path.join(raw, "f0_plan.npz"), **plan_f0)
    return write_manifest(out, spk, utts, eval_utts, len(spk_map), total, seed)


def write_renditions(out: str, utts, n_utts: int = 50, speakers: int = 8, eval_utts: int = 5,
                     seed: int = 0) -> dict:
    """Only the renditions of utterances `utts` by every speaker, as the
    full corpus of `n_utts` utterances holds them (the same WAV files),
    with its manifest's split and no pairs (n_pairs 0; seconds_rendered
    counts these renditions): enough for `quality_eval` and `ood_eval` on
    those utterances.  Returns the manifest."""
    spk = default_speakers(speakers)
    total = render_utterances(out, plans(max(utts) + 1, seed), spk, utts, seed)
    return write_manifest(out, spk, n_utts, eval_utts, 0, total, seed)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out", nargs="?", default=default_corpus())
    ap.add_argument("--utts", type=int, default=50)
    ap.add_argument("--speakers", type=int, default=8)
    ap.add_argument("--eval-utts", type=int, default=5)
    ap.add_argument("--pairs-per-utt", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    manifest = make_corpus(args.out, args.utts, args.speakers, args.eval_utts,
                           args.pairs_per_utt, args.seed, log=lambda s: print(s, flush=True))
    print(json.dumps(manifest))
    return 0


if __name__ == "__main__":
    sys.exit(main())
