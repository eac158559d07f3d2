"""On the card: each cell runs briefly through the command's own path and
is correct; its result line has what the contract asks of it."""

import json
import subprocess
import sys

import pytest

from portbench.tests.helpers import ROOT, workloads


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", workloads())
def test_cell_runs_correct_on_the_card(card, name, trace):
    proc = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", name,
                           "--seed", str(2 ** 31 + 11), "--seconds", "2", "--trace", str(trace)],
                          cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1
    assert list(res)[-1] == "checks"
    if trace:
        assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
        for m in ("upsampler_roofline", "tick_mfu", "idle_share"):
            if m in res["metrics"]:
                assert 0 < res["metrics"][m]["value"] <= 100
