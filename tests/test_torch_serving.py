"""The port's serving layer (`runtime/handle.py`, `server.py`,
`service.py`) on the CPU against the JAX package's: the serving scenario of
`beatrice_vst_tpu_torch.golden.run_serve` (klatt8, four sessions at 48,
44.1, 16 and 32 kHz fed in odd block sizes, a voice, a pitch and a formant
shift, a two-voice morph through the morph pad's parameters, a session
opened and closed mid-run, an output-gain edit staged with a
`reset_context`) through the port's `ModelHost(device="cpu")` and the JAX
`ModelHost(jit=True)`; the golden file made from the JAX run; pipeline
mode one tick late; a model swap with parameter replay; a tick failure
that recovers and replays; underruns as silence; client threads editing
streams while the scheduler ticks.

Gates: the port against the JAX run and the golden file at atol 1e-3 (the
waveform gate of tests/test_golden.py); the golden file against a fresh
JAX run at 1e-5 (XLA's CPU sums differ between thread counts); pipeline
mode bitwise equal to plain mode one tick later.

`PYTHONPATH=. python tests/test_torch_serving.py` rewrites
tests/data/torch_serve_golden.npz from the JAX package."""

import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from beatrice_vst_tpu.runtime import ModelHost as JModelHost
from beatrice_vst_tpu_torch import golden
from beatrice_vst_tpu_torch.errors import ErrorCode
from beatrice_vst_tpu_torch.params import ParameterID
from beatrice_vst_tpu_torch.runtime import ModelHost, StreamingServer
from beatrice_vst_tpu_torch.runtime import handle as handle_mod
from beatrice_vst_tpu_torch.runtime.engine import EngineConfig, StreamEngine
from beatrice_vst_tpu_torch.models.io import load_model_dir

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL_DIR = os.path.join(REPO, "models_demo", "klatt8")
SWAP_DIR = os.path.join(REPO, "models_demo", "klatt8_r6", "config.toml")
GOLDEN = os.path.join(REPO, "tests", "data", "torch_serve_golden.npz")
TOL = golden.F32_ATOL
GOLDEN_TOL = 1e-5
N_SESSIONS = 4


def _jax_run():
    return golden.run_serve(JModelHost, MODEL_DIR, jit=True)


@pytest.fixture(scope="module")
def jax_run():
    return _jax_run()


@pytest.fixture(scope="module")
def port_run():
    return golden.run_serve(ModelHost, MODEL_DIR, device="cpu")


def _max_dev(a, b, i):
    assert np.array_equal(a[f"s{i}_len"], b[f"s{i}_len"]), i
    return float(np.abs(a[f"s{i}"] - b[f"s{i}"]).max(initial=0.0))


@pytest.mark.parametrize("i", range(N_SESSIONS))
def test_port_model_host_matches_the_jax_one(jax_run, port_run, i):
    dev = _max_dev(port_run, jax_run, i)
    print(f"session {i}: max|d| {dev:.3e} against the JAX ModelHost (tol {TOL})")
    assert dev <= TOL
    assert float(np.abs(port_run[f"s{i}"]).max()) > 1e-3  # not silent


def test_golden_file_matches_a_fresh_jax_run(jax_run):
    ref = golden.load(GOLDEN)
    assert sorted(ref) == sorted(jax_run)
    for i in range(N_SESSIONS):
        assert _max_dev(ref, jax_run, i) <= GOLDEN_TOL, i


def test_port_model_host_matches_the_golden_file(port_run):
    ref = golden.load(GOLDEN)
    for i in range(N_SESSIONS):
        assert _max_dev(port_run, ref, i) <= TOL, i


def test_pipeline_mode_is_one_tick_late(port_run):
    """The same scenario with pipeline=True: each pull equals plain mode's
    one tick earlier, bitwise (the same device and operations)."""
    piped = golden.run_serve(ModelHost, MODEL_DIR, device="cpu", pipeline=True)
    for i in range(N_SESSIONS):
        plain, late = golden.serve_blocks(port_run, i), golden.serve_blocks(piped, i)
        assert len(late) == len(plain) and len(late[0]) == 0, i
        for k in range(len(plain) - 1):
            assert np.array_equal(late[k + 1], plain[k]), (i, k)


def test_reset_order_matters_for_the_staged_gain(jax_run, monkeypatch):
    """Session 0's output gain is edited and its context reset just before
    tick SERVE_RESET_TICK.  The JAX handle resets at once, with the gain
    target then in force, and the edit lands at the next flush: the gain
    ramps from the old target.  A reset applied after the edit (flush
    first) would jump to the new target: that run leaves the JAX one
    where the port does not."""

    def reset_after_the_edits(self):
        self.engine.flush_controls()
        self.engine.reset_context(self.idx)
        return ErrorCode.SUCCESS

    monkeypatch.setattr(handle_mod.StreamHandle, "reset_context", reset_after_the_edits)
    wrong = golden.run_serve(ModelHost, MODEL_DIR, device="cpu")
    hop = golden.serve_blocks(jax_run, 0)
    before = sum(len(b) for b in hop[:golden.SERVE_RESET_TICK])
    d = np.abs(wrong["s0"] - jax_run["s0"])
    assert float(d[:before].max()) <= TOL
    assert float(d[before:].max()) > TOL


def test_pipeline_copies_only_live_rows():
    """Only row 0 is live at capacity 8 (tests/test_server.py:108): the
    output still arrives, finite, in pipeline mode."""
    _, cfg, params, bank = load_model_dir(MODEL_DIR)
    engine = StreamEngine(EngineConfig(capacity=8, model=cfg), params, bank, device="cpu")
    srv = StreamingServer(engine, realtime=False, pipeline=True)
    s0 = srv.open_session(48000.0)
    srv.open_session(48000.0).close()
    t = np.arange(480 * 6) / 48000
    s0.push((0.3 * np.sin(2 * np.pi * 220 * t)).astype(np.float32))
    got = []
    for _ in range(6):
        srv.tick_once()
        got.append(s0.pull(480))
    srv.flush_pipeline()
    got.append(s0.pull(480))
    y = np.concatenate(got)
    assert len(y) == 480 * 6 and np.isfinite(y).all() and np.abs(y).max() > 1e-3


@pytest.mark.parametrize("recorded", [False, True])
def test_stop_raises_a_failed_final_scatter(monkeypatch, recorded):
    """stop() drains the tick in flight (pipeline mode): a failure there is
    raised, unless the scheduler already recorded one (last_error), after
    which the device may be gone at teardown."""
    _, cfg, params, bank = load_model_dir(MODEL_DIR)
    engine = StreamEngine(EngineConfig(capacity=2, model=cfg), params, bank, device="cpu")
    srv = StreamingServer(engine, realtime=False, pipeline=True)
    srv.open_session(48000.0).push(np.zeros(480, np.float32))
    srv.tick_once()

    def fail(*_):
        raise RuntimeError("the last copy failed")

    monkeypatch.setattr(srv, "_scatter", fail)
    if recorded:
        srv._last_error = "RuntimeError: an earlier tick failed"
        srv.stop()
    else:
        with pytest.raises(RuntimeError, match="the last copy failed"):
            srv.stop()
    assert srv._inflight is None


def test_underrun_counts_as_silence():
    """A session with no input is counted as an underrun each tick and
    converts silence: its output equals a session fed zeros."""
    outs = []
    for feed in (False, True):
        host = ModelHost(capacity=2, realtime=False, device="cpu")
        assert host.load_model(MODEL_DIR) == ErrorCode.SUCCESS
        s = host.open_session(48000.0)
        for _ in range(5):
            if feed:
                s.push(np.zeros(480, np.float32))
            host.tick_once()
        assert s.stream.underruns == (0 if feed else 5)
        m = host.metrics()
        assert m["session_underruns"] == (0 if feed else 5) and m["ticks"] == 5
        outs.append(s.pull(480 * 5))
        host.stop()
    assert len(outs[0]) == 480 * 5 and np.isfinite(outs[0]).all()
    assert np.array_equal(outs[0], outs[1])


def _controls(host, idx):
    host.engine.flush_controls()
    c = host.engine.state["controls"]
    return int(c["target_speaker"][idx]), float(c["pitch_shift"][idx]), int(c["formant_index"][idx])


def test_model_swap_replays_parameters():
    """As tests/test_service.py: a session survives a swap to another model
    and its controls are replayed into the new engine; state bytes
    round-trip."""
    host = ModelHost(capacity=2, realtime=False, device="cpu")
    s = host.open_session(44100.0)
    assert not host.loaded and s.stream is None
    assert host.load_model(MODEL_DIR) == ErrorCode.SUCCESS
    assert s.set_parameter(ParameterID.VOICE, 2) == ErrorCode.SUCCESS
    assert s.set_parameter(ParameterID.PITCH_SHIFT, 5.0) == ErrorCode.SUCCESS
    assert s.set_parameter(ParameterID.FORMANT_SHIFT, -1.0) == ErrorCode.SUCCESS
    before = _controls(host, s.stream.idx)
    assert before == (2, 5.0, 2)
    tone = (0.3 * np.sin(2 * np.pi * 220 * np.arange(8820) / 44100)).astype(np.float32)
    s.push(tone)
    for _ in range(15):
        host.tick_once()
    assert len(s.pull(44100)) > 0
    engine = host.engine
    assert s.set_parameter(ParameterID.MODEL, SWAP_DIR) == ErrorCode.SUCCESS
    assert host.engine is not engine and host.model_dir == SWAP_DIR
    assert s.proxy.parameter_state.get_value(ParameterID.MODEL) == SWAP_DIR
    assert _controls(host, s.stream.idx) == before
    s.push(tone)
    for _ in range(15):
        host.tick_once()
    out = s.pull(44100)
    assert len(out) > 0 and np.isfinite(out).all() and np.abs(out).max() > 1e-3
    blob = s.state_bytes()
    assert s.restore_state_bytes(blob) == ErrorCode.SUCCESS
    assert host.describe()["voices"][0]["name"]
    assert s.set_parameter(ParameterID.MODEL, "/no/such/model") == ErrorCode.FILE_OPEN_ERROR
    s.close()
    assert host.engine.n_active == 0
    host.stop()


def test_model_host_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this checks the refusal where there is no card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ModelHost(capacity=1)


def test_tick_failure_recovers_and_replays():
    """As tests/test_fault_isolation.py:195: one failed tick, then the
    engine is rebuilt, the replay callbacks run, the error is exported,
    and audio flows again."""
    host = ModelHost(capacity=2, device="cpu", realtime=True)
    assert host.load_model(MODEL_DIR) == ErrorCode.SUCCESS
    s = host.open_session(48000.0)
    s.set_parameter(ParameterID.VOICE, 5)
    engine, srv = host.engine, host.server
    replayed = []
    srv.on_recover(lambda: replayed.append(True))
    tick, fail = engine.tick, {"n": 1}

    def flaky(audio):
        if fail["n"]:
            fail["n"] -= 1
            raise RuntimeError("injected device failure")
        return tick(audio)

    engine.tick = flaky
    got = np.zeros(0, np.float32)
    try:
        deadline = time.monotonic() + 60.0
        while time.monotonic() < deadline:
            s.push((0.3 * np.sin(2 * np.pi * 220 * np.arange(480) / 48000)).astype(np.float32))
            got = s.pull(480)
            if engine.counters.get("recoveries") and len(got) and np.abs(got).max() > 0:
                break
            time.sleep(0.01)
        assert srv.running
    finally:
        host.stop()
    assert engine.counters.get("recoveries") == 1 and replayed
    assert "injected device failure" in host.metrics()["last_error"]
    assert int(engine.state["controls"]["target_speaker"][s.stream.idx]) == 5
    assert np.isfinite(got).all() and np.abs(got).max() > 0


def test_client_threads_edit_streams_while_the_scheduler_ticks():
    """Four client threads set parameters and reset contexts while the
    scheduler ticks (a short switch interval, more threads than cores):
    no tick fails, and the last values set are the ones in force."""
    host = ModelHost(capacity=4, device="cpu", realtime=False)
    assert host.load_model(MODEL_DIR) == ErrorCode.SUCCESS
    sessions = [host.open_session(48000.0) for _ in range(4)]
    old = sys.getswitchinterval()
    stop = threading.Event()

    def ticker():
        while not stop.is_set():
            host.tick_once()

    def client(i, s):
        for k in range(60):
            s.set_parameter(ParameterID.VOICE, (i + k) % 8)
            s.set_parameter(ParameterID.PITCH_SHIFT, float(k % 5))
            if k % 7 == 0:
                s.proxy.core.reset_context()
            s.push(np.zeros(480, np.float32))
            s.pull(480)

    sys.setswitchinterval(1e-5)
    try:
        t = threading.Thread(target=ticker)
        t.start()
        clients = [threading.Thread(target=client, args=(i, s)) for i, s in enumerate(sessions)]
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=120)
            assert not c.is_alive()
        stop.set()
        t.join(timeout=60)
        assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    host.tick_once()
    c = host.engine.state["controls"]
    for i, s in enumerate(sessions):
        assert int(c["target_speaker"][s.stream.idx]) == (i + 59) % 8
        assert float(c["pitch_shift"][s.stream.idx]) == 59 % 5
    assert "last_error" not in host.metrics()
    host.stop()


@pytest.mark.parametrize("scale", [None, "2"])
def test_tick_period_scale(monkeypatch, scale):
    """BEATRICE_TICK_PERIOD_SCALE stretches the free-running loop's period
    (`beatrice_vst_tpu/runtime/server.py:186-195`): 10 ms a frame times the
    scale.  With the tick itself a no-op, the loop's cadence over 0.5 s is
    the period's: at most 0.5 s / period + 2 ticks, and at scale 2 about
    half as many as at scale 1."""
    if scale is None:
        monkeypatch.delenv("BEATRICE_TICK_PERIOD_SCALE", raising=False)
    else:
        monkeypatch.setenv("BEATRICE_TICK_PERIOD_SCALE", scale)
    _, cfg, params, bank = load_model_dir(MODEL_DIR)
    engine = StreamEngine(EngineConfig(capacity=2, model=cfg), params, bank, device="cpu")
    srv = StreamingServer(engine, realtime=True)
    period = 0.010 * float(scale or 1)
    assert srv.tick_period() == pytest.approx(period)
    ticks = []
    monkeypatch.setattr(srv, "tick_once", lambda: ticks.append(time.monotonic()))
    srv.start()
    time.sleep(0.5)
    srv.stop()
    assert 0.5 / period * 0.6 <= len(ticks) <= 0.5 / period + 2, len(ticks)


if __name__ == "__main__":
    run = _jax_run()
    np.savez_compressed(GOLDEN, **run)
    print(f"wrote {GOLDEN}: " + ", ".join(f"{k} {v.shape}" for k, v in run.items()))
