"""The port's tracer (`runtime/metrics.py`) on the CPU: a tick's spans
share its sequence number and point at their parents; with tracing off
nothing is recorded; the chain's stage marks come in order at T = 1 and
T = 25 and mark nothing outside the engine's tick (offline conversion,
training, sequence-parallel conversion); the scheduler's five parts lie
inside its tick and do not overlap; the metrics keys; `EngineMetrics`'
rate from the first tick and its underruns against the budget; the
counters of `flush_controls`; the ring; a tick that raises leaves no span
open.  The card's half (the graph's
event-record nodes, the device clock) is in tests/test_torch_cuda.py."""

import os

import numpy as np
import pytest
import torch

from beatrice_vst_tpu_torch import device as device_mod
from beatrice_vst_tpu_torch import golden
from beatrice_vst_tpu_torch.constants import V20RC0
from beatrice_vst_tpu_torch.models import chain as PC
from beatrice_vst_tpu_torch.models.io import load_weights
from beatrice_vst_tpu_torch.models.phone_extractor import PhoneExtractorConfig
from beatrice_vst_tpu_torch.models.pitch_estimator import PitchEstimatorConfig
from beatrice_vst_tpu_torch.runtime import metrics
from beatrice_vst_tpu_torch.runtime.engine import EngineConfig, StreamEngine
from beatrice_vst_tpu_torch.runtime.offline import convert_utterance
from beatrice_vst_tpu_torch.runtime.seqpar import convert_utterance_sp
from beatrice_vst_tpu_torch.runtime.server import SERVE_PARTS, StreamingServer
from beatrice_vst_tpu_torch.speakers import bank as bank_mod
from beatrice_vst_tpu_torch.training import distill

torch.set_num_threads(1)

MODEL_DIR = os.path.join(os.path.dirname(__file__), "..", "models_demo", "klatt8")
SHALLOW = PC.VoiceConverterConfig(
    spec=V20RC0, phone=PhoneExtractorConfig(phone_channels=V20RC0.phone_channels,
                                            dilations=(1, 2)),
    pitch=PitchEstimatorConfig(pitch_bins=V20RC0.pitch_bins, dilations=(1, 2)))
# a 2.0.0-rc.0 tick's stage marks (4 vocoder blocks with attention)
TICK_STAGES = (["edge_in", "cond", "phone", "vq", "pitch", "wg_in"]
               + ["wg_conv", "wg_attn"] * 4 + ["wg_out", "head", "edge_out"])


@pytest.fixture(scope="module")
def klatt8_port():
    params = load_weights(os.path.join(MODEL_DIR, "weights.npz"), device="cpu")
    bank = bank_mod.load(os.path.join(MODEL_DIR, "speakers.npz"), V20RC0, device="cpu")
    return params, bank


def _engine(port, cap=2, frames_per_tick=1, jit=True):
    e = StreamEngine(EngineConfig.realtime(cap, frames_per_tick=frames_per_tick), *port,
                     device="cpu", jit=jit)
    for _ in range(cap):
        e.admit()
    return e


def _spans(dump) -> list:
    return [dict(zip(dump["fields"], row)) for row in dump["spans"]]


def _by_tick(spans) -> dict:
    out = {}
    for s in spans:
        out.setdefault(s["tick"], []).append(s)
    return out


@pytest.mark.parametrize("jit", [True, False])
def test_spans_of_a_tick_share_its_id_and_point_at_their_parents(klatt8_port, jit):
    e = _engine(klatt8_port, jit=jit)
    x = golden.swept_sine(0, cap=2, ticks=1)
    e.tick(x)
    e.tracing(True)
    for _ in range(3):
        e.tick(x)
    dump = e.tracer.dump()
    assert e.tracing(False) == {"drift_ns": None}
    spans = _spans(dump)
    by_id = {s["id"]: s for s in spans}
    ticks = _by_tick(spans)
    assert sorted(ticks) == [1, 2, 3]
    for tick, group in ticks.items():
        names = [s["name"] for s in group]
        for name in ("engine.tick", "engine.flush_controls", "engine.launch", "engine.device"):
            assert names.count(name) == 1, (tick, names)
        top = next(s for s in group if s["name"] == "engine.tick")
        device = next(s for s in group if s["name"] == "engine.device")
        assert top["parent"] == -1
        for s in group:
            assert s["start_ns"] <= s["end_ns"]
            if s is top:
                continue
            parent = by_id[s["parent"]]
            assert parent["tick"] == tick
            want = device if s["name"] in metrics.STAGES + metrics.GAPS else top
            assert parent is want, (s, parent)
            assert parent["start_ns"] <= s["start_ns"] and s["end_ns"] <= parent["end_ns"]


def test_tracing_off_records_no_span_and_no_mark(klatt8_port, monkeypatch):
    added = []
    monkeypatch.setattr(device_mod._Recorder, "add", lambda self, name: added.append(name))
    e = _engine(klatt8_port)
    x = golden.swept_sine(1, cap=2, ticks=1)
    for _ in range(3):
        e.tick(x)
    assert added == [] and device_mod._active.recorder is None
    assert e.tracer.dump()["spans"] == []
    e.tracing(True)
    e.tick(x)
    e.tracing(False)
    assert added == TICK_STAGES + [metrics.END]
    e.tick(x)
    assert len(added) == len(TICK_STAGES) + 1
    assert {s["tick"] for s in _spans(e.tracer.dump())} == {3}


@pytest.mark.parametrize("frames_per_tick", [1, 25])
def test_eager_stage_marks_come_in_the_chains_order(klatt8_port, frames_per_tick):
    e = _engine(klatt8_port, frames_per_tick=frames_per_tick)
    e.tracing(True)
    e.tick(golden.swept_sine(2, cap=2, ticks=frames_per_tick))
    spans = _spans(e.tracer.dump())
    stages = sorted((s for s in spans if s["name"] in metrics.STAGES),
                    key=lambda s: s["start_ns"])
    assert [s["name"] for s in stages] == TICK_STAGES
    for a, b in zip(stages, stages[1:]):
        assert a["end_ns"] == b["start_ns"]
    device = next(s for s in spans if s["name"] == "engine.device")
    assert device["start_ns"] <= stages[0]["start_ns"]
    assert stages[-1]["end_ns"] <= device["end_ns"]


@pytest.mark.parametrize("jit", [True, False])
def test_graph_in_the_stages_and_graph_out_tile_the_device_span(klatt8_port, jit):
    """engine.device's parts follow each other without a hole: graph_in
    from its start to the first stage, the stages, graph_out to its end."""
    e = _engine(klatt8_port, jit=jit)
    e.tracing(True)
    for k in range(2):
        e.tick(golden.swept_sine(k, cap=2, ticks=1))
    spans = _spans(e.tracer.dump())
    e.tracing(False)
    for group in _by_tick(spans).values():
        device = next(s for s in group if s["name"] == "engine.device")
        parts = sorted((s for s in group if s["parent"] == device["id"]),
                       key=lambda s: (s["start_ns"], s["id"]))
        assert [s["name"] for s in parts] == ["graph_in"] + TICK_STAGES + ["graph_out"]
        assert parts[0]["start_ns"] == device["start_ns"]
        assert parts[-1]["end_ns"] == device["end_ns"]
        for a, b in zip(parts, parts[1:]):
            assert a["end_ns"] == b["start_ns"]


def test_mark_is_a_no_op_outside_the_engine_tick(klatt8_port, monkeypatch):
    """With an engine's tracing on in the same thread, offline conversion
    (compiled and eager), a training step and sequence-parallel conversion
    mark nothing: only the engine's tick records marks."""
    added = []
    monkeypatch.setattr(device_mod._Recorder, "add", lambda self, name: added.append(name))
    e = _engine(klatt8_port)
    e.tracing(True)
    params = PC.init(torch.Generator().manual_seed(0), SHALLOW, "cpu")
    bank = bank_mod.random_bank(torch.Generator().manual_seed(1), V20RC0, 4, device="cpu")
    sig = golden.offline_signal(seed=0, seconds=0.3)
    for jit in (True, False):
        convert_utterance(params, SHALLOW, bank, sig, 44100, chunk_frames=8, device="cpu",
                          jit=jit)
        convert_utterance_sp(params, SHALLOW, bank, sig, 44100, n_segments=2, device="cpu",
                             jit=jit)
        p = distill.trainable(params, "cpu")
        batch = golden.train_inputs(SHALLOW, bank, "cpu", golden.train_batch(seed=5, frames=8))
        distill.train_step(p, distill.make_optimizer(p, 1e-3), batch, cfg=SHALLOW, jit=jit)
    assert added == []
    e.tick(golden.swept_sine(3, cap=2, ticks=1))
    assert added == TICK_STAGES + [metrics.END]
    e.tracing(False)


@pytest.mark.parametrize("pipeline", [False, True])
def test_the_scheduler_tick_splits_into_parts_that_do_not_overlap(klatt8_port, pipeline):
    e = _engine(klatt8_port, cap=2)
    e.evict(0)
    e.evict(1)
    srv = StreamingServer(e, realtime=False, pipeline=pipeline)
    session = srv.open_session()
    e.tracing(True)
    for _ in range(4):
        session.push(np.zeros(480, np.float32))
        srv.tick_once()
    spans = _spans(e.tracer.dump())
    e.tracing(False)
    by_id = {s["id"]: s for s in spans}
    ticks = _by_tick(spans)
    assert sorted(ticks) == [0, 1, 2, 3]
    for tick, group in ticks.items():
        top = [s for s in group if s["name"] == "serve.tick_once"]
        assert len(top) == 1 and top[0]["parent"] == -1
        top = top[0]
        parts = sorted((s for s in group if s["parent"] == top["id"]),
                       key=lambda s: s["start_ns"])
        names = {s["name"] for s in parts}
        # the first pipelined tick has nothing in flight to scatter
        scattered = not pipeline or tick > 0
        assert names == {f"serve.{p}" for p in SERVE_PARTS
                         if scattered or p not in ("wait_out", "scatter")}, names
        for s in parts:
            assert top["start_ns"] <= s["start_ns"] <= s["end_ns"] <= top["end_ns"]
        for a, b in zip(parts, parts[1:]):
            assert a["end_ns"] <= b["start_ns"]
        engine_tick = next(s for s in group if s["name"] == "engine.tick")
        assert by_id[engine_tick["parent"]]["name"] == "serve.engine"


def test_server_metrics_keep_their_keys_and_add_the_parts(klatt8_port):
    """The window of the scheduler's spans is kept with tracing off."""
    e = _engine(klatt8_port, cap=2)
    e.evict(0)
    e.evict(1)
    srv = StreamingServer(e, realtime=False)
    session = srv.open_session()
    for _ in range(3):
        session.push(np.zeros(480, np.float32))
        srv.tick_once()
    m = srv.metrics()
    assert m["serve_tick_p90_ms"] >= m["serve_tick_p50_ms"] > 0
    for part in SERVE_PARTS:
        assert m[f"serve_{part}_p90_ms"] >= m[f"serve_{part}_p50_ms"] >= 0
    assert m["serve_tick_p50_ms"] >= m["serve_engine_p50_ms"] > 0
    assert e.tracer.dump()["spans"] == []
    for key in ("ticks", "streams_active", "frames_total", "audio_seconds_per_s", "tick_p50_ms",
                "tick_p99_ms", "underruns", "session_underruns", "session_dropped_in",
                "session_dropped_out", "upsampler_kernel_launches", "upsampler_kernel_frames",
                "resample_kernel_launches", "resample_kernel_samples"):
        assert key in m, key
    assert m["tick_clock"] == "host" and "audio_seconds_total" not in m


def test_rate_is_counted_from_the_first_tick(monkeypatch):
    now = [1000.0]
    monkeypatch.setattr(metrics.time, "monotonic", lambda: now[0])
    m = metrics.EngineMetrics()
    now[0] += 50.0  # set-up: not in the rate
    assert m.snapshot(4)["audio_seconds_per_s"] == 0.0
    m.record_tick(0.001, 4, 1)
    now[0] += 0.5
    m.record_tick(0.001, 4, 1)
    now[0] += 0.5
    snap = m.snapshot(4)
    assert snap["frames_total"] == 8
    assert snap["audio_seconds_per_s"] == pytest.approx(8 * 0.010 / 1.0)


@pytest.mark.parametrize("frames_per_tick,ms,over", [
    (1, 9.0, False), (1, 11.0, True), (25, 240.0, False), (25, 260.0, True)])
def test_underruns_count_ticks_over_their_budget_on_the_host_clock(monkeypatch, frames_per_tick,
                                                                    ms, over):
    now = [0]
    monkeypatch.setattr(metrics.time, "perf_counter_ns", lambda: now[0])
    m = metrics.EngineMetrics()
    stamp = m.begin_tick()
    now[0] += int(ms * 1e6)
    m.end_tick(stamp, 3, frames_per_tick)
    snap = m.snapshot(3)
    assert snap["underruns"] == int(over)
    assert snap["tick_p50_ms"] == pytest.approx(ms)
    assert snap["frames_total"] == 3 * frames_per_tick


def test_flush_controls_counts_the_rows_it_touches(klatt8_port):
    e = StreamEngine(EngineConfig.realtime(4, kv_cache_mode="per_stream", vq_shared_bank=False),
                     *klatt8_port, device="cpu")
    for _ in range(3):
        e.admit()
    e.set_control(0, "pitch_shift", 2.0)
    e.set_control(1, "target_speaker", 3)
    e.flush_controls()
    c = e.tracer.counters
    # 3 "active" edits and the two set; 3 admitted rows reset; their K/V
    assert (c["edits_applied"], c["rows_reset_admitted"], c["kv_rows_refreshed"]) == (5, 3, 3)
    e.reset_context(2)
    e.flush_controls()
    assert c["rows_reset_context"] == 1 and c["morph_rows_refreshed"] == 0
    assert e.metrics_snapshot()["edits_applied"] == 5


def test_the_ring_hands_out_the_newest_spans_once():
    tr = metrics.Tracer(capacity=4)
    tr.switch(True)
    for k in range(6):
        with tr.span("x", k):
            pass
    dump = tr.dump()
    assert [row[5] for row in dump["spans"]] == [2, 3, 4, 5] and dump["dropped"] == 2
    assert tr.dump()["spans"] == []
    assert len(tr.windows["x"]) == 6


def test_a_traced_tick_that_raises_leaves_no_span_open(klatt8_port):
    """A tick that raises while tracing is on (a wrong input shape, a
    failing replay) closes its spans, so the next tick's spans point at
    their own parents."""
    e = _engine(klatt8_port)
    e.tracing(True)
    with pytest.raises(ValueError, match="tick input shape"):
        e.tick(np.zeros((3, 480), np.float32))

    def fail(*args, **kwargs):
        raise RuntimeError("replay failed")

    launch, e._launch = e._launch, fail
    with pytest.raises(RuntimeError, match="replay failed"):
        e.tick(golden.swept_sine(0, cap=2, ticks=1))
    e._launch = launch
    assert e.tracer._stack == [] and e.tracer._open == {}
    e.tick(golden.swept_sine(0, cap=2, ticks=1))
    spans = _spans(e.tracer.dump())
    e.tracing(False)
    assert [s["name"] for s in spans if s["parent"] == -1] == ["engine.tick"] * 3
    top = [s for s in spans if s["name"] == "engine.tick"][-1]
    assert {s["name"] for s in spans if s["parent"] == top["id"]} == {
        "engine.flush_controls", "engine.launch", "engine.device"}
