"""The port's corpus maker (`beatrice_vst_tpu_torch/scripts/make_corpus.py`)
against the repo's `scripts/make_corpus.py` (the JAX package's synthesis),
at a small size: the same files, byte for byte (each .npz archive member
by member: a zip header carries its write time), and the repaired F0
plan key."""

import os
import subprocess
import sys
import zipfile

import pytest

from beatrice_vst_tpu_torch.audio_io import read_wav
from beatrice_vst_tpu_torch.scripts import make_corpus as MC
from beatrice_vst_tpu_torch.training.synthesis import default_speakers

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--utts", "3", "--speakers", "2", "--eval-utts", "1", "--pairs-per-utt", "2"]


def tree(root):
    return sorted(os.path.relpath(os.path.join(d, n), root)
                  for d, _, names in os.walk(root) for n in names)


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpora")
    jax_dir, port_dir = str(root / "jax"), str(root / "port")
    subprocess.run([sys.executable, os.path.join(REPO, "scripts", "make_corpus.py"), jax_dir,
                    *SMALL], check=True, capture_output=True, timeout=300,
                   env=dict(os.environ, JAX_PLATFORMS="cpu"))
    manifest = MC.make_corpus(port_dir, utts=3, speakers=2, eval_utts=1, pairs_per_utt=2,
                              seed=0, log=lambda _: None)
    return jax_dir, port_dir, manifest


def test_corpus_equals_the_jax_scripts_byte_for_byte(corpora):
    jax_dir, port_dir, manifest = corpora
    files = tree(jax_dir)
    assert files == tree(port_dir)
    assert {"manifest.json", "pairs/speakers.json", "pairs/f0_plan.npz",
            "raw/f0_plan.npz", "raw/spk0/utt000.wav"} <= set(files)
    assert manifest["n_pairs"] == 4 and manifest["eval_utterances"] == [2]
    for rel in files:
        a, b = os.path.join(jax_dir, rel), os.path.join(port_dir, rel)
        if rel.endswith(".npz"):
            with zipfile.ZipFile(a) as za, zipfile.ZipFile(b) as zb:
                assert za.namelist() == zb.namelist(), rel
                for name in za.namelist():
                    assert za.read(name) == zb.read(name), (rel, name)
        else:
            assert open(a, "rb").read() == open(b, "rb").read(), rel


def test_pairs_are_links_to_the_renditions(corpora):
    _, port_dir, _ = corpora
    name = sorted(os.listdir(os.path.join(port_dir, "pairs", "inputs")))[0]
    j, s = int(name[1:4]), int(name.split("_s")[1].split("_")[0])
    raw = os.path.join(port_dir, "raw", f"spk{s}", f"utt{j:03d}.wav")
    assert os.path.samefile(os.path.join(port_dir, "pairs", "inputs", name), raw)


@pytest.mark.parametrize("name,key", [("u000_s0_t1", "utt000"), ("u045_s7_t2", "utt045"),
                                      ("u999_s1_t1", "utt999"), ("u1000_s0_t1", "utt1000"),
                                      ("u12345_s3_t4", "utt12345")])
def test_f0_plan_key_is_parsed_from_the_pair_name(name, key):
    """The JAX script slices name[1:4], which maps u1000_s0_t1 to utt100;
    below 1,000 utterances the two agree."""
    assert MC.utterance_key(name) == key
    if len(key) == 6:
        assert MC.utterance_key(name) == f"utt{name[1:4]}"


def test_utterance_key_rejects_other_names():
    with pytest.raises(ValueError):
        MC.utterance_key("utt000")


def test_rendition_is_the_corpus_rendition(corpora):
    """`rendition` is what the corpus wrote, before its 16-bit WAV write
    (which truncates to 1/32767 and reads back over 32768)."""
    _, port_dir, _ = corpora
    y = MC.rendition(MC.plans(3, 0), default_speakers(2), 1, 1, 0)
    got, sr = read_wav(os.path.join(port_dir, "raw", "spk1", "utt001.wav"))
    assert sr == 48000 and len(got) == len(y)
    assert float(abs(got - y).max()) <= 2.0 / 32768
