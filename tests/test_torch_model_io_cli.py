"""The port's model directory IO, speaker-bank files, WAV IO and CLI
against the JAX package's: `load_model_dir` on klatt8 (same keys and
values), `save_model_dir` -> `load_model_dir` exactly, `init_random_model_dir`
(the JAX keys and shapes; the values come from another generator, so they
differ), the raw bank loaders, `cli info`, and `cli convert` on a short
WAV against the JAX `cli convert` with the same flags on a random
2.0.0-rc.0 directory written by the JAX package.

Gates: exact equality for IO; `cli convert` within 1e-3 (the waveform gate
of tests/test_golden.py; both outputs pass through 16-bit WAV files)."""

import json
import os

import numpy as np
import pytest
import torch

from beatrice_vst_tpu import audio_io as JA
from beatrice_vst_tpu.cli import main as jax_cli
from beatrice_vst_tpu.constants import V20RC0 as J_V20RC0
from beatrice_vst_tpu.errors import BeatriceError as JError
from beatrice_vst_tpu.models import io as JIO
from beatrice_vst_tpu.speakers import bank as JB
from beatrice_vst_tpu_torch import audio_io as PA
from beatrice_vst_tpu_torch.cli import main as port_cli
from beatrice_vst_tpu_torch.constants import V20RC0
from beatrice_vst_tpu_torch.errors import BeatriceError as PError
from beatrice_vst_tpu_torch.models import io as PIO
from beatrice_vst_tpu_torch.speakers import bank as PB

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL_DIR = os.path.join(REPO, "models_demo", "klatt8")
CONVERT_TOL = 1e-3
# flags given to both CLIs' convert
CONVERT_FLAGS = {
    "voice": ["--voice", "1", "--pitch-shift", "2", "--formant-shift", "0.5",
              "--vq-neighbors", "4", "--output-rate", "48000"],
    "morph": ["--morph", "0.3,0.7", "--intonation", "0.5", "--pitch-correction", "0.5"],
}


def _flat_numpy(tree):
    return {k: (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
            for k, v in PIO.flatten_params(tree).items()}


def test_load_model_dir_matches_the_jax_one():
    jc, jm, jp, jb = JIO.load_model_dir(MODEL_DIR)
    pc, pm, pp, pb = PIO.load_model_dir(os.path.join(MODEL_DIR, "config.toml"))
    assert (pc.version, pc.name, pc.voice_count) == (jc.version, jc.name, jc.voice_count)
    assert pm.spec.name == jm.spec.name
    a, b = _flat_numpy(pp), _flat_numpy(jp)
    assert a.keys() == b.keys()
    for k in a:
        assert isinstance(PIO.flatten_params(pp)[k], np.ndarray)
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    assert pb.keys() == jb.keys()
    for k in pb:
        assert isinstance(pb[k], np.ndarray) and np.array_equal(pb[k], np.asarray(jb[k])), k


def test_save_and_load_model_dir_round_trip(tmp_path):
    config, _, params, bank = PIO.load_model_dir(MODEL_DIR)
    PIO.save_model_dir(str(tmp_path / "m"), config, params, bank)
    c2, _, p2, b2 = PIO.load_model_dir(str(tmp_path / "m"))
    assert [v.name for v in c2.voices] == [v.name for v in config.voices]
    a, b = _flat_numpy(params), _flat_numpy(p2)
    assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)
    assert all(np.array_equal(bank[k], b2[k]) for k in bank)
    # the JAX package reads what the port wrote
    _, _, jp, _ = JIO.load_model_dir(str(tmp_path / "m"))
    assert all(np.array_equal(np.asarray(v), a[k])
               for k, v in JIO.flatten_params(jp).items())


def test_load_model_dir_short_bank_raises_alike(tmp_path):
    config, _, params, bank = PIO.load_model_dir(MODEL_DIR)
    short = {k: v[:2] if k != "formant" else v for k, v in bank.items()}
    PIO.save_model_dir(str(tmp_path / "m"), config, params, short)
    codes = []
    for load, err in ((PIO.load_model_dir, PError), (JIO.load_model_dir, JError)):
        with pytest.raises(err) as e:
            load(str(tmp_path / "m"))
        codes.append(int(e.value.code))
    assert codes[0] == codes[1] == 11  # INVALID_MODEL_CONFIG


@pytest.mark.parametrize("version", ["2.0.0-rc.0", "2.0.0-beta.1", "2.0.0-alpha.2"])
def test_init_random_model_dir_has_the_jax_keys_and_shapes(tmp_path, version):
    pc, pm, pp, pb = PIO.init_random_model_dir(str(tmp_path / "p"), version=version,
                                               n_voices=3, seed=0)
    jc, jm, jp, jb = JIO.init_random_model_dir(str(tmp_path / "j"), version=version,
                                               n_voices=3, seed=0)
    a, b = _flat_numpy(pp), _flat_numpy(jp)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, k
    assert {k: tuple(v.shape) for k, v in pb.items()} == {k: tuple(v.shape)
                                                          for k, v in jb.items()}
    # another generator: the same seed gives other values
    assert not np.array_equal(a["wg/pitch_emb"], b["wg/pitch_emb"])
    assert (tmp_path / "p" / "config.toml").read_text().replace(
        str(tmp_path / "p"), "") == (tmp_path / "j" / "config.toml").read_text().replace(
        str(tmp_path / "j"), "")
    _, _, lp, _ = PIO.load_model_dir(str(tmp_path / "p"))
    assert all(np.array_equal(v, a[k]) for k, v in _flat_numpy(lp).items())


def _raw_rc0_dir(path, bank, formant=True):
    os.makedirs(path, exist_ok=True)
    bank["additive"].tofile(os.path.join(path, "additive_speaker_embeddings.bin"))
    bank["codebook"].tofile(os.path.join(path, "speaker_embeddings.bin"))
    bank["kv"].tofile(os.path.join(path, "key_value_speaker_embeddings.bin"))
    if formant:
        bank["formant"].tofile(os.path.join(path, "formant_shift_embeddings.bin"))


@pytest.mark.parametrize("case", ["full", "no_formant", "short_kv", "long_codebook",
                                  "missing_kv"])
def test_raw_bank_loaders_match_the_jax_ones(tmp_path, case):
    _, _, _, bank = PIO.load_model_dir(MODEL_DIR)
    d = str(tmp_path / "raw")
    _raw_rc0_dir(d, bank, formant=case != "no_formant")
    if case == "short_kv":
        bank["kv"][:, :-1].tofile(os.path.join(d, "key_value_speaker_embeddings.bin"))
    if case == "long_codebook":
        np.concatenate([bank["codebook"].ravel(), [1.0]]).astype(np.float32).tofile(
            os.path.join(d, "speaker_embeddings.bin"))
    if case == "missing_kv":
        os.remove(os.path.join(d, "key_value_speaker_embeddings.bin"))
    got = []
    for load, spec, err in ((PB.load_raw_rc0_dir, V20RC0, PError),
                            (JB.load_raw_rc0_dir, J_V20RC0, JError)):
        kw = {"device": "cpu"} if load is PB.load_raw_rc0_dir else {}
        try:
            b = load(d, spec, **kw)
            got.append({k: np.asarray(v) for k, v in b.items()})
        except err as e:
            got.append(int(e.code))
    if isinstance(got[1], int):
        assert got[0] == got[1]
    else:
        assert got[0].keys() == got[1].keys()
        assert all(np.array_equal(got[0][k], got[1][k]) for k in got[1])


def test_raw_additive_bank_and_formant_file(tmp_path):
    _, _, _, bank = PIO.load_model_dir(MODEL_DIR)
    bank["additive"].tofile(tmp_path / "speakers.bin")
    bank["formant"].tofile(tmp_path / "formant_shift_embeddings.bin")
    p = PB.load(str(tmp_path / "speakers.bin"), V20RC0, device="cpu")
    j = JB.load(str(tmp_path / "speakers.bin"), J_V20RC0)
    assert p.keys() == j.keys()
    assert all(np.array_equal(p[k].numpy(), np.asarray(j[k])) for k in j)
    f = PB.load_raw_formant(str(tmp_path / "formant_shift_embeddings.bin"), device="cpu")
    assert np.array_equal(f.numpy(), np.asarray(JB.load_raw_formant(
        str(tmp_path / "formant_shift_embeddings.bin"))))
    PB.save(str(tmp_path / "b.npz"), p)
    with np.load(tmp_path / "b.npz") as z:
        assert all(np.array_equal(z[k], p[k].numpy()) for k in p)


def test_wav_io_matches_the_jax_one(tmp_path):
    x = (0.5 * np.sin(2 * np.pi * 440 * np.arange(4410) / 44100)).astype(np.float32)
    PA.write_wav(str(tmp_path / "p.wav"), x, 44100)
    JA.write_wav(str(tmp_path / "j.wav"), x, 44100)
    assert (tmp_path / "p.wav").read_bytes() == (tmp_path / "j.wav").read_bytes()
    y, sr = PA.read_wav(str(tmp_path / "p.wav"))
    yj, srj = JA.read_wav(str(tmp_path / "j.wav"))
    assert sr == srj == 44100 and np.array_equal(y, yj)


@pytest.mark.parametrize("model", ["klatt8", "random"])
def test_cli_info_prints_the_same_fields(tmp_path, capsys, model):
    d = MODEL_DIR
    if model == "random":
        d = str(tmp_path / "m")
        port_cli(["init-model", d, "--voices", "3", "--version", "2.0.0-beta.1"])
        assert "initialized 2.0.0-beta.1 model with 3 voices" in capsys.readouterr().out
    port_cli(["info", "--model", d])
    got = json.loads(capsys.readouterr().out)
    jax_cli(["info", "--model", d])
    assert got == json.loads(capsys.readouterr().out)


@pytest.fixture(scope="module")
def jax_rc0_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("jax_rc0"))
    JIO.init_random_model_dir(d, version="2.0.0-rc.0", n_voices=3, seed=3)
    return d


@pytest.mark.parametrize("flags", sorted(CONVERT_FLAGS))
def test_cli_convert_matches_the_jax_cli(tmp_path, capsys, jax_rc0_dir, flags):
    rng = np.random.default_rng(4)
    n = np.arange(13230) / 44100  # 0.3 s at 44.1 kHz
    x = (0.3 * np.sin(2 * np.pi * (140 * n + 90 * n * n)) + 0.02 * rng.standard_normal(n.size))
    wav = str(tmp_path / "in.wav")
    PA.write_wav(wav, x.astype(np.float32), 44100)
    args = ["--model", jax_rc0_dir, *CONVERT_FLAGS[flags]]
    port_cli(["convert", wav, str(tmp_path / "p.wav"), *args, "--device", "cpu"])
    jax_cli(["convert", wav, str(tmp_path / "j.wav"), *args])
    assert "converted" in capsys.readouterr().out
    got, sr = PA.read_wav(str(tmp_path / "p.wav"))
    want, srj = JA.read_wav(str(tmp_path / "j.wav"))
    assert sr == srj and got.shape == want.shape
    dev = float(np.abs(got - want).max())
    print(f"cli convert {flags}: max|d| {dev:.3e} (tol {CONVERT_TOL}), peak "
          f"{float(np.abs(want).max()):.3f}")
    assert dev <= CONVERT_TOL and float(np.abs(want).max()) > 1e-3


def test_cli_parity_on_the_cpu(capsys):
    with pytest.raises(SystemExit) as e:
        port_cli(["parity", "--version", "2.0.0-alpha.2", "--frames", "6", "--device", "cpu"])
    assert e.value.code == 0
    assert "parity PASS" in capsys.readouterr().out
