"""The port's serving soak (`beatrice_vst_tpu_torch/scripts/serve_soak.py`)
on the CPU: two client processes stream into the TCP front end for 5 s;
the report has every key of the JAX script's committed CPU entry
(`docs/SERVE_SOAK_REPORT.json`) and passes the JAX script's gate.

The port's CPU tick at capacity 8 takes about 9 ms a frame on one thread,
so the run slows every clock by the server's BEATRICE_TICK_PERIOD_SCALE
(3): the scheduler's period, the clients' pace and the gate's budget."""

import json
import os

import torch

from beatrice_vst_tpu_torch.scripts import serve_soak as S

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_soak_with_two_client_processes_passes_the_gate(monkeypatch, tmp_path):
    monkeypatch.setenv("BEATRICE_TICK_PERIOD_SCALE", "3")
    monkeypatch.delenv("SOAK_PIPELINE", raising=False)
    monkeypatch.delenv("SOAK_FPT", raising=False)
    key, report = S.run(2, 5.0, "cpu", log=lambda _: None)
    with open(os.path.join(REPO, "docs", "SERVE_SOAK_REPORT.json")) as f:
        want = json.load(f)["cpu"]
    assert key == "cpu"
    assert set(want) <= set(report), set(want) - set(report)
    assert set(want["clients"][0]) == set(report["clients"][0])
    assert set(want["server_metrics"]) <= set(report["server_metrics"])
    assert report["ok"], report
    assert report["device"] == "cpu" and report["n_clients"] == len(report["clients"]) == 2
    assert (report["capacity"], report["frames_per_tick"], report["pipeline"]) == (8, 4, False)
    assert report["upsampler_kernel_launches"] == {"float32": 0, "bfloat16": 0}
    assert all(c["received_s"] > 1.0 for c in report["clients"])
    path = tmp_path / "soak.json"
    S.write_report(str(path), "other", {"x": 1})
    S.write_report(str(path), key, report)
    assert set(json.loads(path.read_text())) == {"other", "cpu"}


def test_settings_follow_the_device_and_the_knobs(monkeypatch):
    monkeypatch.delenv("SOAK_PIPELINE", raising=False)
    monkeypatch.delenv("SOAK_FPT", raising=False)
    cuda = S.soak_settings(torch.device("cuda"))
    assert (cuda["capacity"], cuda["compute_dtype"], cuda["frames_per_tick"], cuda["pipeline"],
            cuda["key"]) == (256, "bfloat16", 25, True, "cuda")
    monkeypatch.setenv("SOAK_PIPELINE", "0")
    monkeypatch.setenv("SOAK_FPT", "1")
    cuda = S.soak_settings(torch.device("cuda"))
    assert (cuda["frames_per_tick"], cuda["pipeline"], cuda["key"]) == (1, False,
                                                                       "cuda_nopipeline")
    monkeypatch.setenv("SOAK_PIPELINE", "1")
    cpu = S.soak_settings(torch.device("cpu"))
    assert (cpu["capacity"], cpu["compute_dtype"], cpu["pipeline"], cpu["key"]) == (
        8, None, True, "cpu_pipeline")


def test_gate_is_the_jax_scripts(monkeypatch):
    monkeypatch.delenv("BEATRICE_TICK_PERIOD_SCALE", raising=False)
    monkeypatch.delenv("SOAK_MIN_CADENCE", raising=False)
    good = {"finite": True, "peak": 0.5, "sent_s": 10.0, "received_s": 9.5}
    m = {"serve_tick_p50_ms": 30.0}
    assert S.delivery_ok([good], m, 4, 5.0)
    assert not S.delivery_ok([{**good, "received_s": 8.5}], m, 4, 5.0)  # slack 1.08 s
    assert not S.delivery_ok([{**good, "peak": 0.0}], m, 4, 5.0)
    assert not S.delivery_ok([None], m, 4, 5.0)
    assert not S.delivery_ok([good], {"serve_tick_p50_ms": 40.0}, 4, 5.0)
    monkeypatch.setenv("BEATRICE_TICK_PERIOD_SCALE", "2")
    assert S.delivery_ok([good], {"serve_tick_p50_ms": 40.0}, 4, 5.0)
    monkeypatch.setenv("SOAK_MIN_CADENCE", "6")
    assert not S.delivery_ok([good], m, 4, 5.0)
