"""The port's multi-host smoke test
(`beatrice_vst_tpu_torch/scripts/multihost_smoke.py`) on the CPU: two
worker interpreters join one gloo group through `distributed_init` with an
explicit coordinator address, shard a 2.0.0-alpha.2 engine state of 16
streams over a 2 x 1 mesh (8 streams a rank), tick once and all-reduce
sum|out|.  Both exit 0, and the global sum equals one process's
`engine_tick` of the same weights on the same input within 1e-5 relative."""

import subprocess
import sys

import pytest
import torch

from beatrice_vst_tpu_torch.runtime.engine import engine_tick
from beatrice_vst_tpu_torch.scripts import multihost_smoke as M

torch.set_num_threads(1)

RTOL = 1e-5


@pytest.fixture(scope="module")
def records():
    return M.run("cpu")


def test_two_workers_tick_their_rows(records):
    assert [r["rank"] for r in records] == [0, 1]
    for r in records:
        assert (r["world_size"], r["backend"], r["device"], r["rows"]) == (2, "gloo", "cpu", 8)
        assert r["compiled"] and r["finite"]
        assert r["upsampler_kernel_launches"] == {"float32": 0, "bfloat16": 0}
    assert records[0]["sum_abs_out"] == records[1]["sum_abs_out"]
    assert records[0]["sum_abs_out"] == pytest.approx(
        sum(r["local_sum_abs_out"] for r in records), rel=1e-12)


def test_global_sum_equals_one_process_tick(records):
    cfg, p, b, state, x = M.engine_inputs(torch.device("cpu"))
    out, _ = engine_tick(p, b, state, x, cfg=cfg)
    want = float(out.double().abs().sum())
    assert want > 0
    assert records[0]["sum_abs_out"] == pytest.approx(want, rel=RTOL)
    half = M.CAPACITY // 2
    for r in records:
        rows = out[r["rank"] * half:(r["rank"] + 1) * half]
        assert r["local_sum_abs_out"] == pytest.approx(float(rows.double().abs().sum()),
                                                       rel=RTOL)


def test_entry_point_prints_the_jax_scripts_lines():
    got = subprocess.run([sys.executable, "-m", "beatrice_vst_tpu_torch.scripts.multihost_smoke",
                          "--device", "cpu"], capture_output=True, text=True, timeout=300,
                         cwd=M.REPO)
    assert got.returncode == 0, got.stderr[-3000:]
    lines = got.stdout.splitlines()
    assert lines[-1] == "multihost smoke OK"
    assert sorted(ln.split("]")[0] for ln in lines if ln.startswith("[proc")) == [
        "[proc 0", "[proc 1"]


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="CUDA"):
        M.run("cuda")
