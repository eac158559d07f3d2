"""A run's comparison on the CPU at 8 streams: correct against the
reference as the program stands, not correct with the timed path broken
underneath or with the control in the program's place; and the harness
finds a new traffic file and a new metric file by name alone."""

import json
import os
import uuid

import pytest
import torch

from beatrice_vst_tpu_torch.runtime import engine as engine_mod, graphs
from portbench import control, run, spec, traffic as traffic_mod
from portbench.reference import compare
from portbench.tests.helpers import ROOT, run_small, small_cell, workloads


@pytest.mark.parametrize("name", workloads())
def test_the_program_is_correct(name):
    res = run_small(small_cell(name))
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 2
    assert set(res["metrics"]) == {m["name"] for m in spec.load_cell(
        spec.load_json(f"{ROOT}/BENCHMARK.json"), name, ROOT).end_to_end}
    assert list(res)[-1] == "checks"


def _break_state(monkeypatch):
    """A tick that returns its state unchanged."""
    monkeypatch.setattr(graphs, "write_back_", lambda state, new: None)


def _wrap_output(monkeypatch, change):
    original = engine_mod.engine_tick
    calls = [0]

    def broken(params, bank, state, audio48, *, cfg):
        out, new = original(params, bank, state, audio48, cfg=cfg)
        calls[0] += 1
        return change(out.clone(), calls[0]), new

    monkeypatch.setattr(engine_mod, "engine_tick", broken)


def _drop_half(monkeypatch):
    """Half of the batch left out: its rows carry the other half's output."""
    def change(out, _):
        half = out.shape[0] // 2
        out[half:] = out[:out.shape[0] - half]
        return out
    _wrap_output(monkeypatch, change)


def _alter_answers(monkeypatch):
    """Every 4th tick each stream is handed its neighbour's output."""
    _wrap_output(monkeypatch, lambda out, k: out.roll(1, dims=0) if k % 4 == 0 else out)


def _negate(monkeypatch):
    """Every output with its sign flipped: the same spectra."""
    _wrap_output(monkeypatch, lambda out, _: -out)


def _delay_one_sample(monkeypatch):
    """Every output one sample late, carried across ticks: the spectra
    all but the same."""
    carry = {}

    def change(out, _):
        last = carry.get("x", torch.zeros_like(out[:, :1]))
        carry["x"] = out[:, -1:].clone()
        return torch.cat([last, out[:, :-1]], dim=1)
    _wrap_output(monkeypatch, change)


@pytest.mark.parametrize("fault", [_break_state, _drop_half, _alter_answers, _negate,
                                   _delay_one_sample])
@pytest.mark.parametrize("name", workloads())
def test_a_broken_tick_is_not_correct(monkeypatch, name, fault):
    fault(monkeypatch)
    res = run_small(small_cell(name), seconds=0.6)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("name", workloads())
def test_half_the_batch_reaches_three_checked_streams(name):
    """At the cell's own capacity, half of the batch left out reaches more
    checked streams than the numbers compared leave out, on all but a few
    seeds in a thousand: P(Binomial(16, 1/2) <= 2) = 0.21 %."""
    traffic = spec.load_cell(spec.load_json(f"{ROOT}/BENCHMARK.json"), name, ROOT).traffic
    half = traffic["capacity"] // 2
    seeds = range(2 ** 31, 2 ** 31 + 4000)
    missed = sum(int((traffic_mod.check_rows(traffic, s) >= half).sum()
                     <= compare.WORST_EXCUSED) for s in seeds)
    assert missed / len(seeds) < 0.005, missed


@pytest.mark.parametrize("name", workloads())
def test_the_control_is_not_correct(name):
    cell = small_cell(name)
    ctx = run.Context(ROOT, cell, 2 ** 32 + 3, 0.0, False, torch.device("cpu"), 0.0)
    ticks = max(2, 48 // cell.traffic["frames_per_tick"])
    found = control.readings(ctx, ticks, cell.config["control"])
    ok, rows = run.compare.judge(found, run.limits(ctx))
    assert not ok, rows


def test_new_traffic_and_metric_files_need_no_code():
    tag = f"tmp_{uuid.uuid4().hex[:8]}"
    traffic_file = f"{spec.HERE}/traffic/{tag}.json"
    metric_file = f"{spec.HERE}/metrics/{tag}.py"
    bench = spec.load_json(f"{ROOT}/BENCHMARK.json")
    first = bench["workloads"][0]
    base = spec.load_json(f"{spec.HERE}/traffic/{first['traffic']}.json")
    try:
        with open(traffic_file, "w") as f:
            json.dump(dict(base, capacity=4, check_streams=4, warmup_ticks=1), f)
        with open(metric_file, "w") as f:
            f.write('LAYER = "test"\nMOVES = "audio_s_per_s"\n\n\n'
                    'def read(record, ctx):\n    return float(record["ticks"])\n')
        bench["workloads"].append(dict(first, name=tag, traffic=tag))
        bench["per_layer"].append({"name": tag, "unit": "ticks", "better": "higher",
                                   "source": "host_clock", "layer": "test",
                                   "moves": "audio_s_per_s", "workloads": [tag]})
        cell = spec.load_cell(bench, tag, ROOT)
        assert cell.traffic["capacity"] == 4
        res = run_small(cell, seconds=0.1, trace=True)
        assert res["metrics"][tag]["value"] == res["attempted"]
        assert res["correct"], res["checks"]
    finally:
        for path in (traffic_file, metric_file):
            if os.path.exists(path):
                os.remove(path)


def test_no_card_no_result(capsys):
    name = workloads()[0]
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    cwd = os.getcwd()
    os.chdir(ROOT)
    try:
        rc = run.main(["--workload", name, "--seed", "1", "--seconds", "1", "--trace", "0"])
    finally:
        os.chdir(cwd)
    assert rc != 0 and capsys.readouterr().out == ""
