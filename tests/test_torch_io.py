"""Weight and speaker-bank loading of the port, params_from_numpy, and
the rule that the port imports nothing of JAX or of the JAX package."""

import ast
import os
import re

import numpy as np
import pytest
import torch

from beatrice_vst_tpu.models.io import flatten_params, load_model_dir
from beatrice_vst_tpu_torch.constants import V20RC0
from beatrice_vst_tpu_torch.errors import BeatriceError, ErrorCode
from beatrice_vst_tpu_torch.models import io as PIO
from beatrice_vst_tpu_torch.speakers import bank as bank_mod

torch.set_num_threads(1)

REPO = os.path.join(os.path.dirname(__file__), "..")
MODEL_DIR = os.path.join(REPO, "models_demo", "klatt8")


def test_weights_round_trip_bit_exact():
    with np.load(os.path.join(MODEL_DIR, "weights.npz")) as z:
        flat = {k: z[k] for k in z.files}
    params = PIO.load_weights(os.path.join(MODEL_DIR, "weights.npz"), device="cpu")
    # JAX layouts kept: linear w [in, out], conv w [k, Cin, Cout]
    assert tuple(params["wg"]["up"][0]["conv"]["w"].shape) == (3, 256, 512)
    assert tuple(params["phone"]["prenet"]["w"].shape) == (80, 256)
    assert len(params["phone"]["blocks"]) == 6 and len(params["wg"]["blocks"]) == 4
    back = flatten_params(params)
    assert sorted(back) == sorted(flat)
    for k, v in flat.items():
        assert back[k].dtype == torch.float32
        np.testing.assert_array_equal(back[k].numpy(), v)


def test_params_from_numpy_takes_the_jax_tree():
    _, _, jparams, _ = load_model_dir(MODEL_DIR)
    nested = PIO.params_from_numpy(jparams, "cpu")
    flat = PIO.params_from_numpy({k: np.asarray(v) for k, v in
                                  flatten_params(jparams).items()}, "cpu")
    loaded = PIO.load_weights(os.path.join(MODEL_DIR, "weights.npz"), device="cpu")
    a, b, c = (flatten_params(t) for t in (nested, flat, loaded))
    assert a.keys() == b.keys() == c.keys()
    for k in a:
        assert torch.equal(a[k], c[k]) and torch.equal(b[k], c[k])


def test_unflatten_lists_and_dicts():
    tree = PIO.unflatten_params({"a/0/w": 1, "a/1/w": 2, "b/c": 3})
    assert tree == {"a": [{"w": 1}, {"w": 2}], "b": {"c": 3}}
    assert flatten_params(tree) == {"a/0/w": 1, "a/1/w": 2, "b/c": 3}


def test_bank_load_and_validation(tmp_path):
    bank = bank_mod.load(os.path.join(MODEL_DIR, "speakers.npz"), V20RC0, device="cpu")
    with np.load(os.path.join(MODEL_DIR, "speakers.npz")) as z:
        for k in z.files:
            np.testing.assert_array_equal(bank[k].numpy(), z[k])
    assert bank_mod.n_speakers(bank) == 8
    assert tuple(bank["kv"].shape) == (8, 384, 128)
    bad = tmp_path / "bad.npz"
    np.savez(bad, additive=np.zeros((2, 256), np.float32),
             codebook=np.zeros((2, 512, 64), np.float32))
    with pytest.raises(BeatriceError) as e:
        bank_mod.load(str(bad), V20RC0, device="cpu")
    assert e.value.code == ErrorCode.INVALID_FILE_SIZE


def test_missing_files_raise():
    with pytest.raises(BeatriceError) as e:
        PIO.load_weights("no/such/weights.npz", device="cpu")
    assert e.value.code == ErrorCode.FILE_OPEN_ERROR
    with pytest.raises(BeatriceError):
        bank_mod.load("no/such/speakers.npz", V20RC0, device="cpu")


def _port_files():
    root = os.path.join(REPO, "beatrice_vst_tpu_torch")
    files = [os.path.join(REPO, "chip_smoke.py")]
    for d, _, names in os.walk(root):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    return files


def test_port_imports_neither_jax_nor_the_jax_package():
    files = _port_files()
    assert len(files) > 10
    forbidden = re.compile(r"import jax|from jax|\bbeatrice_vst_tpu\.|from beatrice_vst_tpu\b"
                           r"|import beatrice_vst_tpu\b")
    for path in files:
        text = open(path).read()
        assert not forbidden.search(text), path
        for node in ast.walk(ast.parse(text)):
            if isinstance(node, ast.Import):
                roots = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                roots = [(node.module or "").split(".")[0]]
            else:
                continue
            assert not {"jax", "jaxlib", "beatrice_vst_tpu"} & set(roots), (path, roots)
