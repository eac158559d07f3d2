"""TCP serving front end: the network face of the streaming service
(port of `beatrice_vst_tpu/runtime/netserver.py`).

A deliberately small wire protocol (length-prefixed frames, little-endian):

    [type: u8][length: u32][payload: length bytes]

    type 0  JSON control, client->server:
              {"op": "hello", "sample_rate": 48000}
              {"op": "set", "param": "<schema name or id>", "value": v}
              {"op": "metrics"}     -> server replies with a JSON frame
              {"op": "bye"}
            server->client: acks/errors/metrics as JSON
    type 1  audio, float32 PCM mono at the session rate (both directions)

One TCP connection == one ClientSession (one plugin instance in reference
terms): full parameter surface via the schema, arbitrary sample rate and
block sizes via the host-edge resampler chain.
"""

from __future__ import annotations

import json
import socket
import socketserver
import struct
import threading

import numpy as np

from ..errors import ErrorCode
from ..params import SCHEMA, ParameterID

MSG_JSON = 0
MSG_AUDIO = 1

_NAME_TO_ID = {
    **{p.name.lower().replace(" ", "_"): pid for pid, p in SCHEMA.items()
       if hasattr(p, "name")},
}


def send_frame(sock, msg_type: int, payload: bytes) -> None:
    sock.sendall(struct.pack("<BI", msg_type, len(payload)) + payload)


def recv_frame(sock, first: bytes = b""):
    """One frame -> (type, payload), or (None, None) at EOF; `first` is the
    frame's first byte when the caller has read it already."""
    rest = _recv_exact(sock, 5 - len(first))
    head = None if rest is None else first + rest
    if head is None:
        return None, None
    msg_type, length = struct.unpack("<BI", head)
    payload = _recv_exact(sock, length) if length else b""
    if payload is None:
        return None, None
    return msg_type, payload


def _recv_exact(sock, n: int):
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return buf


def _resolve_param(name):
    if isinstance(name, int):
        return name
    key = str(name).lower().replace(" ", "_")
    if key in _NAME_TO_ID:
        return int(_NAME_TO_ID[key])
    try:
        return int(ParameterID[str(name).upper()])
    except KeyError:
        return None


class _Handler(socketserver.BaseRequestHandler):
    def handle(self):
        conn = self.server.track(self.request)
        host = self.server.model_host
        session = None
        try:
            while True:
                msg_type, payload = recv_frame(self.request)
                if msg_type is None:
                    break
                if msg_type == MSG_JSON:
                    msg = json.loads(payload.decode("utf-8"))
                    op = msg.get("op")
                    if op == "hello":
                        session = host.open_session(float(msg.get("sample_rate", 48000)))
                        # ACK before the pump starts so the first frame the
                        # client sees is the handshake reply
                        send_frame(self.request, MSG_JSON,
                                   json.dumps({"ok": True, "session": session.session_id}).encode())
                        conn.start_pump(self._pump, session)
                    elif op == "set":
                        pid = _resolve_param(msg.get("param"))
                        if pid is None or session is None:
                            send_frame(self.request, MSG_JSON,
                                       json.dumps({"ok": False, "error": "bad param/session"}).encode())
                        else:
                            err = session.set_parameter(pid, msg.get("value"))
                            send_frame(self.request, MSG_JSON,
                                       json.dumps({"ok": err == ErrorCode.SUCCESS,
                                                   "code": int(err)}).encode())
                    elif op == "metrics":
                        send_frame(self.request, MSG_JSON,
                                   json.dumps(host.metrics(), default=float).encode())
                    elif op == "bye":
                        break
                elif msg_type == MSG_AUDIO and session is not None:
                    audio = np.frombuffer(payload, np.float32)
                    session.push(audio)
        except OSError:
            pass  # the client went away, or the server shut the socket down
        finally:
            conn.finish(session)

    def _pump(self, session, stop: threading.Event) -> None:
        """Push converted audio back to the client as it becomes ready."""
        import time

        while not stop.is_set():
            out = session.pull(4096)
            if len(out):
                try:
                    send_frame(self.request, MSG_AUDIO,
                               np.ascontiguousarray(out, np.float32).tobytes())
                except OSError:
                    return
            else:
                time.sleep(0.005)


# seconds a front end waits, at exit, for each live connection's threads
JOIN_TIMEOUT_S = 10.0


class Connection:
    """One live connection of a socket front end: its socket, the stop flag
    of its pump, and its threads (the handler's, then the pump's)."""

    def __init__(self, server, sock):
        self.server, self.sock = server, sock
        self.stop = threading.Event()
        self.threads = [threading.current_thread()]
        self.threads[0].name = f"vc-conn-{id(self):x}"

    def start_pump(self, target, session, *args) -> threading.Thread:
        """Start the pump thread target(session, *args, stop)."""
        pump = threading.Thread(target=target, args=(session, *args, self.stop), daemon=True,
                                name=f"vc-pump-{id(self):x}")
        self.threads.append(pump)
        pump.start()
        return pump

    def finish(self, session) -> None:
        """The handler's last act: stop the pump and wait for it before the
        session closes under it, then leave the registry."""
        self.stop.set()
        for pump in self.threads[1:]:
            pump.join(JOIN_TIMEOUT_S)
        if session is not None:
            session.close()
        self.server.untrack(self)


class ConnectionRegistry:
    """The live connections of a threaded socket server, so that it can end
    them before its `ModelHost` stops: a handler or pump thread left
    running into the interpreter's exit can be inside a torch or ctypes
    call when the runtime ends it, and the process then aborts."""

    def _init_registry(self):
        self._conns: set[Connection] = set()
        self._conns_lock = threading.Lock()
        self._closing = False

    def track(self, sock) -> Connection:
        conn = Connection(self, sock)
        with self._conns_lock:
            self._conns.add(conn)
            closing = self._closing
        if closing:  # accepted while the server was closing: end it now
            _shut(sock)
        return conn

    def untrack(self, conn: Connection) -> None:
        with self._conns_lock:
            self._conns.discard(conn)

    def close_connections(self) -> list[str]:
        """End every live connection: set its pump's stop flag, shut its
        socket down (the handler's blocking read returns) and join its
        threads, all within JOIN_TIMEOUT_S.  Returns the names of the
        threads still alive after it."""
        import time

        with self._conns_lock:
            self._closing = True
            conns = list(self._conns)
        for conn in conns:
            conn.stop.set()
            _shut(conn.sock)
        deadline = time.monotonic() + JOIN_TIMEOUT_S
        threads = [t for conn in conns for t in list(conn.threads)]
        for t in threads:
            t.join(max(deadline - time.monotonic(), 0.0))
        return [t.name for t in threads if t.is_alive()]

    def close(self, model_host) -> list[str]:
        """Stop serving: stop accepting, end every connection
        (`close_connections`), then stop the model host.  Call after
        `serve_forever` has returned (or call `shutdown()` first from
        another thread).  Returns the connection threads that outlived
        their bound."""
        self.server_close()
        stragglers = self.close_connections()
        model_host.stop()
        return stragglers


def _shut(sock) -> None:
    try:
        sock.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass  # already closed by the peer or by the handler


def exit_census(name: str, stragglers: list[str]) -> None:
    """At a blocking entry point's exit: print the threads still alive
    besides the main thread on stderr, and exit non-zero, naming them,
    where a connection thread outlived its bound."""
    import sys

    alive = [t.name for t in threading.enumerate() if t is not threading.main_thread()]
    print(f"{name}: threads alive at exit: {json.dumps(alive)}", file=sys.stderr, flush=True)
    if stragglers:
        raise SystemExit(f"{name}: connection threads alive {JOIN_TIMEOUT_S} s after their "
                         f"sockets were shut down: {', '.join(stragglers)}")


class VCServer(ConnectionRegistry, socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True

    def __init__(self, address, model_host):
        self._init_registry()
        super().__init__(address, _Handler)
        self.model_host = model_host


def serve(model_path: str, port: int = 7777, capacity: int = 64,
          compute_dtype: str | None = None,
          host_addr: str = "127.0.0.1", device="cuda"):
    """Blocking entry point used by `cli serve`.  At exit (a signal turned
    into SystemExit by the CLI) it stops accepting, ends and joins every
    connection, and only then stops the model host."""
    from .service import ModelHost

    mh = ModelHost(capacity=capacity, compute_dtype=compute_dtype, device=device)
    err = mh.load_model(model_path)
    if err != ErrorCode.SUCCESS:
        raise SystemExit(f"model load failed: {err!r}")
    srv = VCServer((host_addr, port), mh)
    print(f"serving {model_path} on {host_addr}:{srv.server_address[1]} "
          f"(capacity {capacity}, {mh.device})", flush=True)
    try:
        srv.serve_forever()
    finally:
        exit_census("serve", srv.close(mh))


class VCClient:
    """Minimal reference client (also used by tests)."""

    def __init__(self, addr=("127.0.0.1", 7777), sample_rate=48000.0,
                 timeout: float = 10.0):
        # session setup replays the full parameter schema into the engine;
        # the FIRST session after a model load may compile staging helpers
        # (tens of seconds through a dev relay) -- raise `timeout` when
        # connecting concurrently with cold caches
        self.sock = socket.create_connection(addr, timeout=timeout)
        self.timeout = timeout
        self.sample_rate = sample_rate
        # buffers BEFORE the handshake: the server's pump thread may emit
        # an audio frame ahead of the hello ACK, and _wait_json banks it
        self._json_replies = []
        self._audio = b""
        send_frame(self.sock, MSG_JSON,
                   json.dumps({"op": "hello", "sample_rate": sample_rate}).encode())
        msg = self._wait_json()
        assert msg.get("ok"), msg

    def _wait_json(self):
        self.sock.settimeout(self.timeout)
        while True:
            t, p = recv_frame(self.sock)
            if t is None:
                raise ConnectionError("server closed")
            if t == MSG_JSON:
                return json.loads(p.decode())
            self._audio += p

    def set_parameter(self, name, value):
        send_frame(self.sock, MSG_JSON,
                   json.dumps({"op": "set", "param": name, "value": value}).encode())
        return self._wait_json()

    def metrics(self):
        """The server's metrics (the `metrics` op)."""
        send_frame(self.sock, MSG_JSON, json.dumps({"op": "metrics"}).encode())
        return self._wait_json()

    def push(self, audio: np.ndarray):
        send_frame(self.sock, MSG_AUDIO,
                   np.ascontiguousarray(audio, np.float32).tobytes())

    def pull(self, min_samples: int, timeout: float = 30.0):
        import time

        deadline = time.time() + timeout
        while len(self._audio) < min_samples * 4:
            # bound each recv by the REMAINING deadline: a fixed 0.2 s
            # socket timeout made every short poll block 0.2 s, throttling
            # real-time clients to ~5% of real time
            remaining = deadline - time.time()
            if remaining <= 0:
                break
            self.sock.settimeout(min(0.2, max(0.005, remaining)))
            try:
                first = self.sock.recv(1)
            except socket.timeout:
                continue
            # a frame has begun: read the rest of it whole (a short
            # timeout in the middle of a frame would lose its bytes and
            # tear the stream)
            self.sock.settimeout(self.timeout)
            t, p = recv_frame(self.sock, first) if first else (None, None)
            if t is None:
                break
            if t == MSG_AUDIO:
                self._audio += p
        out = np.frombuffer(self._audio, np.float32)
        self._audio = b""
        return out

    def close(self):
        try:
            send_frame(self.sock, MSG_JSON, json.dumps({"op": "bye"}).encode())
        except OSError:
            pass
        self.sock.close()
