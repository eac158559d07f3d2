"""`cli serve` of the port ends cleanly on SIGTERM with clients connected
(TCP, WebSocket and, where `grpc` imports, gRPC), on the CPU.

The server runs klatt8 at capacity 4 in a subprocess.  Two clients stream
until audio has come back, and SIGTERM arrives while both are still
connected and streaming.  The server must exit 0 with no "terminate
called" (a C++ abort) and no traceback on stderr, and the thread census it
prints at exit must show no connection or pump thread alive: the front
ends end and join every connection before the model host stops, so that
no thread is inside a torch or ctypes call when the interpreter exits."""

import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from beatrice_vst_tpu_torch.parallel.mesh import free_port
from beatrice_vst_tpu_torch.runtime import netserver as pn
from beatrice_vst_tpu_torch.runtime import wsserver as pw

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL_DIR = os.path.join(REPO, "models_demo", "klatt8")
STARTUP_S = 120
CENSUS = "threads alive at exit: "


def client(kind, port):
    if kind == "tcp":
        return pn.VCClient(("127.0.0.1", port), 48000.0, timeout=60.0)
    if kind == "ws":
        return pw.WSClient(("127.0.0.1", port))
    from beatrice_vst_tpu_torch.runtime.grpcserver import GRPCClient

    return GRPCClient(f"127.0.0.1:{port}")


@pytest.mark.parametrize("kind", ["tcp", "ws", "grpc"])
def test_serve_exits_cleanly_on_sigterm_with_live_clients(kind):
    if kind == "grpc":
        pytest.importorskip("grpc")
    port = free_port()
    flag = {"tcp": [], "ws": ["--ws"], "grpc": ["--grpc"]}[kind]
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    proc = subprocess.Popen(
        [sys.executable, "-m", "beatrice_vst_tpu_torch.cli", "serve", "--model", MODEL_DIR,
         "--capacity", "4", "--port", str(port), "--device", "cpu", *flag],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    clients = []
    try:
        t0 = time.monotonic()
        while "serving" not in proc.stdout.readline():
            assert proc.poll() is None and time.monotonic() - t0 < STARTUP_S, proc.stderr.read()
        clients = [client(kind, port) for _ in range(2)]
        rng = np.random.default_rng(0)
        got = [0, 0]
        while min(got) == 0:
            assert time.monotonic() - t0 < STARTUP_S, got
            for i, c in enumerate(clients):
                c.push((0.1 * rng.standard_normal(480)).astype(np.float32))
                got[i] += len(c.pull(1, timeout=0.02))
        proc.send_signal(signal.SIGTERM)  # both clients still connected
        rc = proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        for c in clients:
            c.close()
    stderr = proc.stderr.read()
    assert rc == 0, stderr[-3000:]
    assert "terminate called" not in stderr and "Traceback" not in stderr, stderr[-3000:]
    census = [ln for ln in stderr.splitlines() if CENSUS in ln]
    assert len(census) == 1, stderr[-3000:]
    alive = json.loads(census[0].split(CENSUS, 1)[1])
    assert not [name for name in alive if name.startswith("vc-")], alive


def test_a_thread_outliving_its_bound_is_named_and_fails_the_exit():
    with pytest.raises(SystemExit) as e:
        pn.exit_census("serve", ["vc-pump-1"])
    assert "vc-pump-1" in str(e.value.code)
    pn.exit_census("serve", [])  # nothing outlived: no exit


def test_close_connections_ends_handler_and_pump_threads(tmp_path):
    """In process: a VCServer with one streaming client; close() shuts the
    client's socket down, joins its handler and pump threads and stops the
    host, and the client sees the connection end."""
    import threading

    from beatrice_vst_tpu_torch.runtime import ModelHost

    host = ModelHost(capacity=4, realtime=True, device="cpu")
    assert host.load_model(MODEL_DIR) == 0
    srv = pn.VCServer(("127.0.0.1", 0), host)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    c = pn.VCClient(srv.server_address, 48000.0, timeout=30.0)
    try:
        deadline = time.monotonic() + 60
        while not len(c.pull(1, timeout=0.05)):
            c.push(np.zeros(480, np.float32))
            assert time.monotonic() < deadline
        names = [th.name for th in threading.enumerate()]
        assert any(n.startswith("vc-conn-") for n in names), names
        assert any(n.startswith("vc-pump-") for n in names), names
        srv.shutdown()
        assert srv.close(host) == []
        t.join(timeout=10)
        assert not [th.name for th in threading.enumerate() if th.name.startswith("vc-")]
        assert not host.server.running
        with pytest.raises((ConnectionError, OSError)):
            for _ in range(100):
                c.push(np.zeros(480, np.float32))
                c.metrics()
    finally:
        c.sock.close()
