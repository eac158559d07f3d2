"""Serving soak of the port: client PROCESSES streaming in real time into
the live server (counterpart of the repo's `scripts/serve_soak.py`, which
runs the JAX package).

    python -m beatrice_vst_tpu_torch.scripts.serve_soak [n_clients] [duration_s]
        [--device cuda] [--port P] [--report docs/TORCH_SERVE_SOAK_REPORT.json]

Stands up the deployment stack -- `ModelHost` (the engine, its captured
tick and the scheduler thread) and the TCP front end -- on a random
2.0.0-rc.0 model of 4 voices (`init_random_model_dir`, seed 0, in a
temporary directory), and drives it with n_clients (default 8) client
processes, each streaming a tone in real time for duration_s (default
30) seconds with its own voice and pitch shift.  The clients are separate
interpreters (`--client i duration port`, which use only
`runtime/netserver.VCClient` and numpy), so none of them competes for the
server's GIL.

Settings by device, as the JAX script keys them by backend: on `cuda`
capacity 256, bf16, `frames_per_tick` 25 and the pipeline on; on the CPU
capacity 8, f32, 4 frames a tick and the pipeline off.  Knobs: SOAK_FPT
(frames a tick), SOAK_PIPELINE (0/1; when set, the report entry is keyed
`_pipeline` / `_nopipeline`), SOAK_MIN_CADENCE (ticks a second the gate
asks for, default 0), SOAK_QUIET_S (seconds a client drains after the
server has gone quiet, default 5).  The server's BEATRICE_TICK_PERIOD_SCALE
(`runtime/server.py:tick_period`, default 1) slows every clock of the run
by its factor, for a host whose tick takes longer than the audio it
carries: the scheduler's period, the clients' pace and the gate's budget
for the median tick.  (On one CPU thread the port's tick at capacity 8
takes about 9 ms a frame, so the CPU test runs at a scale of 3.)

The gate is the JAX script's: every client got finite, non-silent audio,
more than 1 s of it and all it sent but `1 + 2 * fpt * 10 ms`; the
scheduler's median tick under the audio a tick carries (times the
scale); the cadence at
least SOAK_MIN_CADENCE.  The median tick read is the scheduler's span
(`serve_tick_p50_ms`, to the output's completion), not the engine's
`tick_p50_ms`, its own span without the scheduler's rings and waits; the
warm-up's "under budget"
test reads it too.  The server is shut down through the front end's own
path (`ConnectionRegistry.close`: every connection ended and joined, then
the host stopped).  The entry (`cuda` or `cpu`) is written into --report
beside the entries already there; the exit code is 1 when the gate fails.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
REPORT = os.path.join(REPO, "docs", "TORCH_SERVE_SOAK_REPORT.json")
RATE = 48000
BLOCK = 480
NOTE = ("tick_p50_ms times the engine's own span (on a card the device's), not the "
        "scheduler's rings and waits; the warm-up and the gate read the scheduler's span "
        "to the output's completion (serve_tick_p50_ms); the clients are separate processes")


def period_scale() -> float:
    """BEATRICE_TICK_PERIOD_SCALE, as the server reads it."""
    return float(os.environ.get("BEATRICE_TICK_PERIOD_SCALE", "1.0"))


def run_client(i: int, duration: float, port: int) -> dict:
    """Client-process entry: stream a tone in real time (times the period
    scale), drain, and return (and print) one JSON line."""
    from beatrice_vst_tpu_torch.runtime.netserver import VCClient

    rng = np.random.default_rng(i)
    c = VCClient(addr=("127.0.0.1", port), sample_rate=float(RATE), timeout=120.0)
    c.set_parameter("voice", i % 4)
    c.set_parameter("pitch_shift", float(i - 4))
    f0 = 140.0 + 15.0 * i
    period = BLOCK / RATE * period_scale()
    t0 = time.monotonic()
    next_t = t0
    sent = got = 0
    peak = 0.0
    finite = True
    while time.monotonic() - t0 < duration:
        ts = (sent + np.arange(BLOCK)) / RATE
        x = (0.25 * np.sin(2 * np.pi * f0 * ts)
             + 0.01 * rng.standard_normal(BLOCK)).astype(np.float32)
        c.push(x)
        sent += BLOCK
        out = c.pull(BLOCK, timeout=0.004)
        if len(out):
            got += len(out)
            finite = finite and bool(np.isfinite(out).all())
            peak = max(peak, float(np.abs(out).max()))
        next_t += period
        delay = next_t - time.monotonic()
        if delay > 0:
            time.sleep(delay)
    # the final drain: the server may still hold audio in flight (the
    # input ring's backlog, the pipeline's tick), so pull until it has
    # been quiet for SOAK_QUIET_S, not merely until one empty pull
    drain_t0 = time.monotonic()
    quiet_since = None
    quiet_limit = float(os.environ.get("SOAK_QUIET_S", "5.0"))
    while time.monotonic() - drain_t0 < 120.0 and got < sent:
        out = c.pull(BLOCK, timeout=0.25)
        if len(out):
            got += len(out)
            finite = finite and bool(np.isfinite(out).all())
            peak = max(peak, float(np.abs(out).max()))
            quiet_since = None
        else:
            now = time.monotonic()
            if quiet_since is None:
                quiet_since = now
            elif now - quiet_since > quiet_limit:
                break
    c.close()
    result = {
        "sent_s": round(sent / RATE, 2),
        "received_s": round(got / RATE, 2),
        "drain_s": round(time.monotonic() - drain_t0, 2),
        "finite": finite,
        "peak": round(peak, 4),
    }
    print(json.dumps(result), flush=True)
    return result


def soak_settings(device) -> dict:
    """The host's settings on this device, the knobs applied."""
    cuda = device.type == "cuda"
    pipe_env = os.environ.get("SOAK_PIPELINE")
    return {
        "capacity": 256 if cuda else 8,
        "compute_dtype": "bfloat16" if cuda else None,
        "frames_per_tick": int(os.environ.get("SOAK_FPT", "25" if cuda else "4")),
        "pipeline": cuda if pipe_env is None else pipe_env == "1",
        "key": ("cuda" if cuda else "cpu") + ("" if pipe_env is None else
                                              "_pipeline" if pipe_env == "1" else "_nopipeline"),
    }


def delivery_ok(results, metrics, fpt: int, tick_cadence: float) -> bool:
    """The JAX script's gate (`serve_soak.py:209-222`), its median tick
    read from the scheduler's span, its budget times the period scale."""
    min_cadence = float(os.environ.get("SOAK_MIN_CADENCE", "0"))
    slack_s = 1.0 + 2 * fpt * 0.010
    return bool(
        all(r and r["finite"] and r["peak"] > 0
            and r["received_s"] > 1.0
            and r["sent_s"] - r["received_s"] <= slack_s for r in results)
        and metrics.get("serve_tick_p50_ms", 1e9) < 10.0 * fpt * period_scale()
        and tick_cadence >= min_cadence
    )


def run(n_clients: int = 8, duration: float = 30.0, device="cuda", port: int | None = None,
        log=lambda s: print(s, file=sys.stderr, flush=True)) -> tuple[str, dict]:
    """The soak; returns (the report's entry key, the entry)."""
    import tempfile

    from ..device import resolve_device
    from ..errors import ErrorCode
    from ..models.io import init_random_model_dir
    from ..parallel.mesh import free_port
    from ..runtime.netserver import VCClient, VCServer
    from ..runtime.service import ModelHost
    from .quality_eval import card_line

    dev = resolve_device(device)
    st = soak_settings(dev)
    fpt = st["frames_per_tick"]
    port = port or free_port()
    with tempfile.TemporaryDirectory(prefix="soak_model_") as model_dir:
        init_random_model_dir(model_dir, version="2.0.0-rc.0", n_voices=4, seed=0)
        host = ModelHost(capacity=st["capacity"], compute_dtype=st["compute_dtype"],
                         realtime=True, frames_per_tick=fpt, pipeline=st["pipeline"], device=dev)
        if host.load_model(model_dir) != ErrorCode.SUCCESS:
            raise RuntimeError("the soak's model did not load")
    srv = VCServer(("127.0.0.1", port), host)
    import threading

    serving = threading.Thread(target=srv.serve_forever, daemon=True)
    serving.start()
    try:
        # warm-up: the first ticks under budget, then a fleet-shaped
        # session set (as many sessions as the run, with the clients'
        # parameters), so that the fleet meets no first-time work
        t0 = time.monotonic()
        while time.monotonic() - t0 < 600:
            m = host.metrics()
            if (m.get("ticks", 0) > 20
                    and m.get("serve_tick_p50_ms", 1e9) < 9.0 * fpt * period_scale()):
                break
            time.sleep(1.0)
        warm = [VCClient(addr=("127.0.0.1", port), sample_rate=float(RATE), timeout=600.0)
                for _ in range(n_clients)]
        for i, wc in enumerate(warm):
            wc.set_parameter("voice", i % 4)
            wc.set_parameter("pitch_shift", float(i - 4))
            wc.push(np.zeros(BLOCK * fpt, np.float32))
        time.sleep(2.0 if dev.type == "cpu" else 8.0)
        for wc in warm:
            wc.pull(BLOCK, timeout=1.0)
            wc.close()
        time.sleep(1.0)
        base_ticks = host.metrics().get("ticks", 0)
        log("warm-up done")

        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join([REPO] + [p for p in env.get("PYTHONPATH", "")
                                                     .split(os.pathsep) if p])
        env["OMP_NUM_THREADS"] = "1"  # the clients compute nothing in torch
        t_run = time.monotonic()
        procs = [subprocess.Popen(
            [sys.executable, "-m", "beatrice_vst_tpu_torch.scripts.serve_soak", "--client",
             str(i), str(duration), str(port)],
            cwd=REPO, stdout=subprocess.PIPE, env=env, text=True) for i in range(n_clients)]
        results = []
        try:
            for p in procs:
                out, _ = p.communicate(timeout=duration + 300)
                line = out.strip().splitlines()[-1] if out.strip() else "null"
                results.append(json.loads(line))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        wall = time.monotonic() - t_run
        metrics = host.metrics()
    finally:
        srv.shutdown()
        stragglers = srv.close(host)
        serving.join(timeout=10)
    if stragglers:
        raise RuntimeError(f"connection threads outlived the shutdown: {stragglers}")

    tick_cadence = (metrics.get("ticks", 0) - base_ticks) / max(wall, 1e-9)
    report = {
        "device": card_line(dev),
        "n_clients": n_clients,
        "duration_s": duration,
        "frames_per_tick": fpt,
        "pipeline": st["pipeline"],
        "capacity": st["capacity"],
        "compute_dtype": st["compute_dtype"] or "float32",
        "tick_period_scale": period_scale(),
        "wall_s": round(wall, 1),
        "tick_cadence_hz": round(tick_cadence, 1),
        "serve_tick_p50_ms": metrics.get("serve_tick_p50_ms"),
        "serve_tick_p90_ms": metrics.get("serve_tick_p90_ms"),
        "upsampler_kernel_launches": metrics.get("upsampler_kernel_launches"),
        "note": NOTE,
        "clients": results,
        # the JAX script's report also carries audio_seconds_total, which
        # the port's metrics leave to frames_total (x 10 ms)
        "server_metrics": {**{k: (round(v, 3) if isinstance(v, float) else v)
                              for k, v in metrics.items()},
                           "audio_seconds_total": round(metrics["frames_total"] * 0.010, 3)},
        "ok": delivery_ok(results, metrics, fpt, tick_cadence),
    }
    return st["key"], report


def write_report(path: str, key: str, report: dict) -> None:
    """Put the entry under `key` in the report at `path`, keeping the
    others."""
    combined = {}
    if os.path.exists(path):
        try:
            with open(path) as f:
                combined = json.load(f)
        except (OSError, ValueError):
            combined = {}
    combined[key] = report
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(combined, f, indent=1)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--client"]:
        run_client(int(argv[1]), float(argv[2]), int(argv[3]))
        return 0
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n_clients", nargs="?", type=int, default=8)
    ap.add_argument("duration_s", nargs="?", type=float, default=30.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--port", type=int, default=None, help="default: a free port")
    ap.add_argument("--report", default=REPORT)
    args = ap.parse_args(argv)
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    key, report = run(args.n_clients, args.duration_s, args.device, args.port)
    write_report(args.report, key, report)
    print(json.dumps(report))
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
