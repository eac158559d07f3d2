"""Client latency per 10 ms frame through the port's serving stack
(counterpart of the repo's `scripts/latency_probe.py`, which runs the JAX
package).

    python -m beatrice_vst_tpu_torch.scripts.latency_probe [--sessions 4[,64]]
        [--capacity 8[,64]] [--seconds 20] [--pace-ms 10]
        [--model models_demo/klatt8] [--report PATH] [--device cuda]

BASELINE.md's per-stream contract is "latency under the plugin's 10 ms
frame budget".  This measures what a client sees at a real cadence:
client push -> HostResampler -> SpscRing -> scheduler tick (the compiled
engine tick, `ModelHost(jit=True)`) -> SpscRing -> client pull, per 10 ms
frame.

Protocol (the JAX probe's): M in-process sessions on one
`ModelHost(capacity, realtime=True, jit=True)`; each session is pushed
one 480-sample 48 kHz frame every `pace` ms against a monotonic deadline,
like an audio callback (here by one client thread for all sessions,
`run_sessions`).  The scheduler free-runs (an underrun tick
scatters converted silence), so output sample counts do not index input
frames: latency is measured as a user hears it, with tone BURSTS in a
silent paced stream detected in the converted output by per-frame RMS;
latency = detection - push, per burst, over all sessions
(`burst_latencies`).

Pacing: `--pace-ms` (10 is the product cadence), or by default the JAX
probe's auto pacing: 10 ms if the loaded scheduler keeps 100 ticks a
second, else 2.2x its measured tick wall, with the scheduler's period
scaled to the same clock (BEATRICE_TICK_PERIOD_SCALE, restored
afterwards).  `sustainable_regime` says whether the scheduler kept the
pace while the clients ran: its tick rate over the run within 0.5 % of
the pace's (`frames_behind` says how far it fell behind them).  Below the
pace every ring's backlog grows for as long as the run lasts, and the
latency measures that.  (The JAX probe's test, pace >= the tick wall
1000 / rate, cannot hold at 10 ms: the period caps the rate at 100.)

The report's `scheduler.dispatch_tick_*` numbers are the engine's tick
spans as `EngineMetrics` records them: on a card its span on the card's
clock (copy in, replay, clone), on the CPU the host's time for the tick;
`serve_tick_*` are the scheduler's own spans, gather to scatter, which
wait for the tick's output.  The burst
latency includes completion either way.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from ..errors import ErrorCode
from ..params import ParameterID
from ..runtime.service import ModelHost

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
MODEL_DIR = os.path.join(REPO, "models_demo", "klatt8")
SR = 48000
FRAME = 480  # 10 ms at 48 kHz
BURST_FRAMES = 5  # 50 ms of tone: one 10 ms frame cannot open the chain's voicing gate
# the share of the pace's tick rate the scheduler keeps to keep the pace:
# below it the rings' backlog grows by more than a frame every 2 s
SUSTAINED = 0.995
# session i speaks with voice VOICES[i % 2], and a converted frame louder
# than RMS_THRESHOLD is a detection.  On klatt8 the burst converts to a
# peak frame RMS of 0.0086-0.0135 with voices 0 and 1 and to a tail of at
# most 0.0035 (12 bursts a voice, measured on the CPU: levels are the
# model's); voices 2 and 3, which the JAX probe also cycles through, peak
# at 0.005, too close to a tail for one threshold, and its 0.01 misses
# voice 1
VOICES = (0, 1)
RMS_THRESHOLD = 0.0055
PERIOD_SCALE = "BEATRICE_TICK_PERIOD_SCALE"


def burst_latencies(push_ts, detect_ts) -> dict:
    """Pair each burst's push time with its detection: the first detection
    at or after the push and before the next push (any time after the last
    push).  Returns {"latency_ms": [one per detected burst], "missed":
    bursts without a detection, "extra": detections paired with no burst
    (a second one in a burst's interval, or one before the first push)}.
    The interval pairing assumes a latency below the burst period (about a
    second), as the probe's bursts are spaced."""
    push = np.asarray(push_ts, np.float64)
    det = np.sort(np.asarray(detect_ts, np.float64))
    ends = np.append(push[1:], np.inf)
    lat, paired = [], 0
    for p, e in zip(push, ends):
        inside = det[(det >= p) & (det < e)]
        if len(inside):
            lat.append((inside[0] - p) * 1e3)
            paired += 1
    return {"latency_ms": np.asarray(lat), "missed": len(push) - paired,
            "extra": len(det) - paired}


def run_sessions(sessions, seconds, prefill: int = 2, pace_s: float = 0.010,
                 rms_threshold: float = RMS_THRESHOLD) -> list[dict]:
    """Paced pushes and burst detection for every session, from this one
    thread.  Each session gets one frame every `pace_s` seconds: silence,
    with a BURST_FRAMES tone burst about once a second, after `prefill`
    silent frames (a client's jitter buffer, part of the latency).
    Between pushes the thread pulls every session's converted frames and
    detects a burst by per-frame RMS (once, re-armed after 10 quiet
    frames).  Returns each session's {"push_ts", "detect_ts"}.

    The JAX probe runs a pusher and a puller thread a session; 128 such
    threads in the server's process starved its scheduler to 7.7 ticks a
    second at 64 sessions on an H100 (its pullers poll every 0.5 ms), so
    one paced client thread drives them all here."""
    burst_period = max(20, round(1.0 / pace_s))  # ~one burst per second
    n_frames = int(seconds / pace_s)
    t = np.arange(BURST_FRAMES * FRAME) / SR
    burst_sig = (0.4 * np.sin(2 * np.pi * 165.0 * t)
                 * np.hanning(BURST_FRAMES * FRAME)).astype(np.float32)
    silence = np.zeros(FRAME, np.float32)
    push_ts = [[] for _ in sessions]
    detect_ts = [[] for _ in sessions]
    armed = [True] * len(sessions)
    quiet_run = [0] * len(sessions)

    def poll() -> bool:
        got = False
        for k, s in enumerate(sessions):
            while len(out := s.pull(FRAME)):
                got = True
                now = time.monotonic()
                if float(np.sqrt(np.mean(out.astype(np.float64) ** 2))) > rms_threshold:
                    if armed[k]:
                        detect_ts[k].append(now)
                        armed[k] = False
                    quiet_run[k] = 0
                else:
                    quiet_run[k] += 1
                    if quiet_run[k] >= 10:
                        armed[k] = True
        return got

    def poll_until(deadline) -> None:
        while time.monotonic() < deadline:
            if not poll():
                time.sleep(min(0.0005, max(deadline - time.monotonic(), 0.0)))

    for s in sessions:
        for _ in range(prefill):
            s.push(silence)
    t0 = time.monotonic()
    for i in range(n_frames):
        poll_until(t0 + i * pace_s)
        ph = i % burst_period
        frame = burst_sig[ph * FRAME:(ph + 1) * FRAME] if ph < BURST_FRAMES else silence
        for k, s in enumerate(sessions):
            if ph == 0:
                push_ts[k].append(time.monotonic())
            s.push(frame)
    # let the last burst drain (p50 ~ 7 periods)
    poll_until(time.monotonic() + max(1.0, 12 * pace_s))
    return [{"push_ts": p, "detect_ts": d} for p, d in zip(push_ts, detect_ts)]


def _drain(sessions) -> None:
    for s in sessions:
        while len(s.pull(FRAME * 8)):
            pass


def _ticks(host) -> int:
    return host.metrics().get("ticks", 0)


def run_probe(model: str = MODEL_DIR, sessions: int = 4, seconds: float = 20.0,
              capacity: int = 8, warmup_s: float = 3.0, prefill: int = 2,
              pace_ms: float | None = None, rms_threshold: float = RMS_THRESHOLD, device="cuda",
              log=print) -> dict:
    """One run of the probe (the JAX probe's `main` as a function): returns
    its report."""
    host = ModelHost(capacity=capacity, realtime=True, jit=True, device=device)
    scale_before = os.environ.get(PERIOD_SCALE)
    try:
        if host.load_model(model) != ErrorCode.SUCCESS:
            raise RuntimeError(f"latency probe: {model} did not load")
        # the scheduler's first ticks (the kernel's build on the card)
        deadline = time.time() + 300
        while _ticks(host) < int(warmup_s * 100):
            if time.time() > deadline:
                raise RuntimeError("latency probe: the engine never warmed up")
            time.sleep(0.1)
        clients = [host.open_session(float(SR)) for _ in range(sessions)]
        for i, s in enumerate(clients):
            s.set_parameter(ParameterID.VOICE, VOICES[i % len(VOICES)])
        # feed and drain until every session has produced output (the JAX
        # probe also waits here for the compiles that admission triggers;
        # the port's engine was captured whole when the model loaded)
        warm = np.zeros(FRAME, np.float32)
        deadline = time.time() + 120
        flowed = [0] * len(clients)
        while not all(flowed):
            if time.time() > deadline:
                raise RuntimeError("latency probe: a session produced no output")
            for k, s in enumerate(clients):
                s.push(warm)
                flowed[k] += len(s.pull(FRAME * 4))
            time.sleep(0.008)
        _drain(clients)
        # the loaded tick cadence, clients pushing and pulling unpaced
        t_a, n_a = time.time(), _ticks(host)
        while time.time() < t_a + 3.0:
            for s in clients:
                s.push(warm)
                s.pull(FRAME * 4)
            time.sleep(0.004)
        rate = (_ticks(host) - n_a) / (time.time() - t_a)
        tick_wall_ms = 1000.0 / max(rate, 1.0)
        _drain(clients)
        if pace_ms is None:
            # 2.2x: the paced client's polling slows the loop down further
            pace_ms = max(10.0, 2.2 * tick_wall_ms)
        # the scheduler's period on the clients' clock; while it is stopped,
        # empty both rings (ring_in is read by the scheduler only)
        os.environ[PERIOD_SCALE] = str(pace_ms / (10.0 * host.frames_per_tick))
        host.server.stop()
        for s in clients:
            while len(s.stream.ring_in.read(FRAME * 16)):
                pass
        _drain(clients)
        host.server.start()
        log(f"pacing {pace_ms:.2f} ms a frame (loaded tick wall {tick_wall_ms:.2f} ms)")

        t0, n0 = time.time(), _ticks(host)
        results = run_sessions(clients, seconds, prefill, pace_ms * 1e-3, rms_threshold)
        wall = time.time() - t0
        m = host.metrics()
        measured_rate = (m["ticks"] - n0) / wall
        for s in clients:
            s.close()
    finally:
        host.stop()  # the engine ticks no more: its counts are final
        if scale_before is None:
            os.environ.pop(PERIOD_SCALE, None)
        else:
            os.environ[PERIOD_SCALE] = scale_before
    paired = [burst_latencies(r["push_ts"], r["detect_ts"]) for r in results]
    # each session's first burst may still meet the first ticks' warm-up
    lat = np.concatenate([p["latency_ms"][1:] for p in paired])
    pushed = sum(len(r["push_ts"]) for r in results)
    detected = sum(len(p["latency_ms"]) for p in paired)

    def q(p):
        return float(np.percentile(lat, p)) if len(lat) else None

    frames_behind = (1000.0 / pace_ms - measured_rate) * wall
    sustainable = measured_rate >= SUSTAINED * 1000.0 / pace_ms
    return {
        "device": (torch.cuda.get_device_name(host.device) if host.device.type == "cuda"
                   else "cpu"),
        "model": os.path.relpath(os.path.abspath(model), REPO),
        "sessions": sessions,
        "prefill_frames": prefill,
        "capacity": capacity,
        "seconds": seconds,
        "wall_s": wall,
        "pace_ms": pace_ms,
        "sustainable_regime": bool(sustainable),
        "tick_wall_p50_ms_under_load": tick_wall_ms,
        "ticks_per_s_measured": measured_rate,
        "frames_behind": frames_behind,
        "bursts_sent": pushed,
        "bursts_measured": int(len(lat)),
        "bursts_missed": sum(p["missed"] for p in paired),
        "extra_detections": sum(p["extra"] for p in paired),
        "burst_detection_ratio": detected / max(pushed, 1),
        "frame_latency_ms": {"p50": q(50), "p90": q(90), "p99": q(99),
                             "max": float(lat.max()) if len(lat) else None},
        # in pace periods: prefill (2) + ~1 queueing + 1 tick + 2-3 for the
        # voicing gate to open on a tone onset => p50 ~ 6-7 periods
        "frame_latency_periods": {p: (None if q(int(p[1:])) is None
                                      else q(int(p[1:])) / pace_ms)
                                  for p in ("p50", "p90", "p99")},
        "scheduler": {"dispatch_tick_p50_ms": m["tick_p50_ms"],
                      "dispatch_tick_p99_ms": m["tick_p99_ms"],
                      "serve_tick_p50_ms": m["serve_tick_p50_ms"],
                      "serve_tick_p90_ms": m["serve_tick_p90_ms"],
                      "underruns": m["underruns"],
                      "session_underruns": m["session_underruns"],
                      "session_dropped_in": m["session_dropped_in"],
                      "session_dropped_out": m["session_dropped_out"],
                      "streams_active": m["streams_active"],
                      "audio_seconds_per_s": m["audio_seconds_per_s"]},
        "engine_ticks": host.engine.metrics.ticks,
        "graph_warmup_ticks": host.engine.counters.get("graph_warmup_ticks", 0),
        "note": ("Burst latency through the whole serving stack (client push -> "
                 "resampler -> SPSC ring -> scheduler tick -> compiled engine tick -> ring -> "
                 "pull), detection - push per burst.  scheduler.dispatch_tick_* are the "
                 "engine's spans (on a card the device's); serve_tick_* wait for the tick's "
                 "output."),
    }


def report_ok(report) -> bool:
    """The JAX probe's verdict: bursts detected (ratio above 0.9), a p50, and
    in a sustainable regime a p50 of at most 8 pace periods."""
    p50 = report["frame_latency_periods"]["p50"]
    return (report["burst_detection_ratio"] > 0.9 and p50 is not None
            and (not report["sustainable_regime"] or p50 <= 8.0))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sessions", default="4",
                    help="sessions of each run, comma-separated (one run each)")
    ap.add_argument("--capacity", default="8", help="each run's capacity, comma-separated")
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--model", default=MODEL_DIR)
    ap.add_argument("--report", default=None, help="write the report (JSON) here")
    ap.add_argument("--warmup-s", type=float, default=3.0)
    ap.add_argument("--prefill", type=int, default=2,
                    help="client jitter-buffer frames pushed before the paced loop")
    ap.add_argument("--pace-ms", type=float, default=None,
                    help="client frame pacing in ms (default: auto, see the module's notes)")
    ap.add_argument("--rms-threshold", type=float, default=RMS_THRESHOLD)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sessions = [int(v) for v in args.sessions.split(",")]
    capacity = [int(v) for v in args.capacity.split(",")]
    if len(sessions) != len(capacity):
        ap.error("--sessions and --capacity need one value a run each")
    report = {"runs": [run_probe(args.model, n, args.seconds, cap, args.warmup_s, args.prefill,
                                 args.pace_ms, args.rms_threshold, args.device,
                                 log=lambda s: print(s, flush=True))
                       for n, cap in zip(sessions, capacity)]}
    if args.device.startswith("cuda"):
        report["nvidia_smi"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    if args.report:
        with open(args.report, "w") as f:
            json.dump(report, f, indent=1)
    print(json.dumps(report, indent=1))
    ok = all(report_ok(r) for r in report["runs"])
    print("LATENCY PROBE:", "OK" if ok else "DEGRADED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
