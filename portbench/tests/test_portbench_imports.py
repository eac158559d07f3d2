"""What a run and the reference load: never JAX or the JAX package, and the
reference nothing of the program.  Top-level names are compared whole:
`beatrice_vst_tpu_torch` begins with `beatrice_vst_tpu` and is allowed."""

import json
import os
import subprocess
import sys

import pytest

from portbench import run
from portbench.tests.helpers import ROOT

FORBIDDEN = ("jax", "jaxlib", "flax", "beatrice_vst_tpu")


def _loaded_after(code: str) -> set:
    """Top-level module names loaded by `code` in a fresh interpreter with
    only the repository on its path."""
    probe = (code + "\nimport json, sys\n"
             "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    proc = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return set(json.loads(proc.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax_nor_the_jax_package():
    loaded = _loaded_after(
        "import time\n"
        "from portbench import run\n"
        "from portbench.tests.helpers import small_cell, run_small, workloads\n"
        "for name in workloads():\n"
        "    run_small(small_cell(name, capacity=2), seconds=0.05)\n")
    assert "beatrice_vst_tpu_torch" in loaded  # the program ran
    assert not loaded & set(FORBIDDEN), loaded & set(FORBIDDEN)


def test_the_reference_loads_nothing_of_the_program():
    loaded = _loaded_after(
        "from portbench.reference import beatrice2, compare, filters\n"
        "from portbench import flops, yardstick, traffic\n"
        "w, b = beatrice2.load_model('models_demo/klatt8')\n")
    assert not loaded & {"beatrice_vst_tpu_torch", *FORBIDDEN}, loaded


@pytest.mark.parametrize("names, found", [
    (["beatrice_vst_tpu_torch.runtime.engine", "numpy"], []),
    (["beatrice_vst_tpu.models.chain"], ["beatrice_vst_tpu"]),
    (["jax._src.core", "jaxlib.xla_client"], ["jax", "jaxlib"]),
    (["jaxtyping", "flax_like"], []),
])
def test_forbidden_names_are_compared_whole(monkeypatch, names, found):
    for name in names:
        monkeypatch.setitem(sys.modules, name, object())
    got = run.forbidden_modules()
    assert [m for m in got if m in {n.split(".")[0] for n in names}] == found
