"""The readers of the program's own spans (`portbench/spans.py`, the
metrics that read `record["tracer"]`): None where the record has no spans
or none on the card's clock, the median over ticks of a tick's summed
spans from a synthetic record; a reader file for every per-layer entry
of BENCHMARK.json; in a small traced run on the CPU, the profiled
stretch ticks untraced and the first reader's traced stretch, on an
engine of its own, fills the record; without a tracer, no stretch."""

import os
import types

import pytest

from portbench import spans, spec
from portbench import trace as trace_mod
from portbench.drivers import tick_loop
from portbench.tests.helpers import bench, run_small, small_cell

FIELDS = ["id", "name", "start_ns", "end_ns", "parent", "tick"]
STAGE_READERS = {"edge_ms": ("edge_in", "cond", "edge_out"), "phone_ms": ("phone", "vq"),
                 "pitch_ms": ("pitch",), "vocoder_ms": ("wg_in", "wg_conv", "wg_out"),
                 "attention_ms": ("wg_attn",), "head_ms": ("head",)}


def _record(device_clock="cuda_events"):
    """Three ticks: every stage of tick t lasts (t + 1) ms per interval
    (wg_conv and wg_attn twice), flush_controls (t + 1) x 0.01 ms; tick 3
    has host spans only (its device span was not read)."""
    spans, sid = [], 0

    def add(name, ms, tick):
        nonlocal sid
        spans.append([sid, name, 0, int(ms * 1e6), -1, tick])
        sid += 1

    for t in range(3):
        add("engine.device", 100.0, t)
        for name in ("edge_in", "cond", "phone", "vq", "pitch", "wg_in", "wg_out", "head",
                     "edge_out"):
            add(name, t + 1, t)
        for _ in range(2):
            add("wg_conv", t + 1, t)
            add("wg_attn", t + 1, t)
    for t in range(4):
        add("engine.flush_controls", (t + 1) * 0.01, t)
    return {"tracer": {"fields": FIELDS, "spans": spans, "device_clock": device_clock}}


def _read(name, record):
    return spec.load_module("metrics", name).read(record, None)


@pytest.mark.parametrize("name", [*STAGE_READERS, "flush_ms"])
def test_a_record_without_spans_reads_none(name):
    assert _read(name, {"ticks": 3}) is None
    assert _read(name, {"tracer": {"fields": FIELDS, "spans": [],
                                   "device_clock": "cuda_events"}}) is None


@pytest.mark.parametrize("name", list(STAGE_READERS))
def test_stage_readers_take_the_median_tick_on_the_cards_clock(name):
    # per tick: (t + 1) ms a stage interval; wg_conv, wg_attn twice a tick
    per_interval = {"edge_ms": 3, "phone_ms": 2, "pitch_ms": 1, "vocoder_ms": 4,
                    "attention_ms": 2, "head_ms": 1}[name]
    assert spec.load_module("metrics", name).SPANS == STAGE_READERS[name]
    assert _read(name, _record()) == pytest.approx(2 * per_interval)  # tick 1's
    assert _read(name, _record("host")) is None


def test_flush_reads_the_host_span_of_every_tick():
    assert _read("flush_ms", _record()) == pytest.approx(0.025)  # median of 4 ticks
    assert _read("flush_ms", _record("host")) == pytest.approx(0.025)


def test_every_per_layer_entry_has_its_reader():
    b = bench()
    cells = {w["name"] for w in b["workloads"]}
    for m in b["per_layer"]:
        path = os.path.join(spec.HERE, "metrics", f"{m['name']}.py")
        assert os.path.exists(path), path
        module = spec.load_module("metrics", m["name"])
        assert module.LAYER == m["layer"] and module.MOVES == m["moves"], m["name"]
        assert set(m.get("workloads", cells)) <= cells


def test_the_profiled_stretch_ticks_untraced_and_the_traced_stretch_follows(monkeypatch):
    """The driver's window and profiled stretch tick untraced, as at the
    parent; the first span reader then ticks an engine of its own with
    tracing on (`spans.stretch`), whose spans it finds (the profiler runs
    on a card alone, so here a stand-in runs its ticks)."""
    from beatrice_vst_tpu_torch.runtime.engine import StreamEngine

    phase, seen = ["window"], []
    tick = StreamEngine.tick

    def watched(self, x):
        seen.append((phase[0], id(self), self.tracer.on))
        return tick(self, x)

    def profile(tick_k, ticks, device):
        phase[0] = "profiled"
        for k in range(ticks):
            tick_k(k)
        phase[0] = "traced"

    monkeypatch.setattr(StreamEngine, "tick", watched)
    monkeypatch.setattr(trace_mod, "profile", profile)
    monkeypatch.setattr(spans, "SETTLE_S", 0.05)
    monkeypatch.setattr(spans, "TRACED_S", 0.1)
    name = bench()["workloads"][0]["name"]
    res = run_small(small_cell(name, capacity=4, trace_ticks=3), seconds=0.1, trace=True)
    on = {p: [o for q, _, o in seen if q == p] for p in ("window", "profiled", "traced")}
    engines = {p: {e for q, e, _ in seen if q == p} for p in ("window", "traced")}
    assert not any(on["window"]) and on["profiled"] == [False] * 3
    assert len(on["traced"]) >= spans.TRACED_TICKS + 1 and all(on["traced"])
    assert len(engines["traced"]) == 1 and engines["traced"] != engines["window"]
    assert res["metrics"]["flush_ms"]["value"] > 0


def test_without_a_tracer_no_engine_is_built_and_the_readers_read_none(monkeypatch):
    """A program without `StreamEngine.tracing` (the parent of the tracer)
    gets no traced stretch: every span reader leaves its metric out."""
    monkeypatch.setattr(spans, "_has_tracer", lambda: False)

    def no_build(ctx):
        raise AssertionError("an engine was built for a program without a tracer")

    record = {"ticks": 3}
    ctx = types.SimpleNamespace(traffic={"driver": "tick_loop"})
    monkeypatch.setattr(tick_loop, "build", no_build)
    for name in [*STAGE_READERS, "flush_ms"]:
        assert spec.load_module("metrics", name).read(record, ctx) is None
    assert record["tracer"] is None
