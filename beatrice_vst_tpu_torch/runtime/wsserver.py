"""WebSocket serving front end (RFC 6455, stdlib only; port of
`beatrice_vst_tpu/runtime/wsserver.py`).

Same session semantics as the TCP front end (`runtime/netserver.py`),
different wire: one WebSocket connection == one ClientSession (one plugin
instance in reference terms, src/vst/processor.cc:103).

    text frames    JSON control, same ops as netserver:
                     {"op": "hello", "sample_rate": 48000}
                     {"op": "set", "param": "<schema name or id>", "value": v}
                     {"op": "metrics"}
                     {"op": "bye"}
    binary frames  float32 PCM mono at the session rate (both directions)

Implemented directly on the stdlib (no websockets/aiohttp dependency):
HTTP/1.1 upgrade handshake, frame masking, fragmentation reassembly, ping/pong, close handshake.
"""

from __future__ import annotations

import base64
import hashlib
import json
import os
import socket
import socketserver
import struct
import threading

import numpy as np

from ..errors import ErrorCode
from .netserver import ConnectionRegistry, _resolve_param, exit_census

_WS_GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"

OP_CONT = 0x0
OP_TEXT = 0x1
OP_BINARY = 0x2
OP_CLOSE = 0x8
OP_PING = 0x9
OP_PONG = 0xA

_MAX_MESSAGE = 64 * 1024 * 1024  # refuse absurd frames instead of OOMing


def accept_key(client_key: str) -> str:
    digest = hashlib.sha1((client_key + _WS_GUID).encode("ascii")).digest()
    return base64.b64encode(digest).decode("ascii")


def _recv_exact(sock, n: int):
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return buf


def encode_frame(opcode: int, payload: bytes, mask: bool = False) -> bytes:
    """One unfragmented frame (FIN set). Servers send unmasked, clients
    masked (RFC 6455 §5.1)."""
    head = bytes([0x80 | opcode])
    mask_bit = 0x80 if mask else 0
    n = len(payload)
    if n < 126:
        head += bytes([mask_bit | n])
    elif n < (1 << 16):
        head += bytes([mask_bit | 126]) + struct.pack(">H", n)
    else:
        head += bytes([mask_bit | 127]) + struct.pack(">Q", n)
    if mask:
        key = os.urandom(4)
        masked = bytes(b ^ key[i % 4] for i, b in enumerate(payload))
        return head + key + masked
    return head + payload


def read_frame(sock):
    """-> (fin, opcode, payload) or (None, None, None) on EOF."""
    head = _recv_exact(sock, 2)
    if head is None:
        return None, None, None
    fin = bool(head[0] & 0x80)
    opcode = head[0] & 0x0F
    masked = bool(head[1] & 0x80)
    n = head[1] & 0x7F
    if n == 126:
        ext = _recv_exact(sock, 2)
        if ext is None:
            return None, None, None
        n = struct.unpack(">H", ext)[0]
    elif n == 127:
        ext = _recv_exact(sock, 8)
        if ext is None:
            return None, None, None
        n = struct.unpack(">Q", ext)[0]
    if n > _MAX_MESSAGE:
        raise ConnectionError(f"frame too large: {n}")
    key = b""
    if masked:
        key = _recv_exact(sock, 4)
        if key is None:
            return None, None, None
    payload = _recv_exact(sock, n) if n else b""
    if payload is None:
        return None, None, None
    if masked:
        payload = bytes(b ^ key[i % 4] for i, b in enumerate(payload))
    return fin, opcode, payload


def read_message(sock):
    """Reassemble one application message, transparently answering pings.
    -> (opcode, payload) with opcode in {OP_TEXT, OP_BINARY, OP_CLOSE},
    or (None, None) on EOF."""
    opcode_acc = None
    buf = b""
    while True:
        fin, opcode, payload = read_frame(sock)
        if fin is None:
            return None, None
        if opcode == OP_PING:
            sock.sendall(encode_frame(OP_PONG, payload))
            continue
        if opcode == OP_PONG:
            continue
        if opcode == OP_CLOSE:
            return OP_CLOSE, payload
        if opcode in (OP_TEXT, OP_BINARY):
            opcode_acc = opcode
            buf = payload
        elif opcode == OP_CONT and opcode_acc is not None:
            buf += payload
        else:
            raise ConnectionError(f"unexpected opcode {opcode}")
        if len(buf) > _MAX_MESSAGE:
            raise ConnectionError("message too large")
        if fin:
            return opcode_acc, buf


_DEMO_PAGE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "docs", "demo",
    "index.html")


def _serve_http(sock, lines, model_host=None) -> None:
    """Plain (non-upgrade) HTTP: serve the browser demo client.

    The service's answer to the reference's editor GUI
    (src/vst/editor.cc:255-683): GET / returns
    docs/demo/index.html, which streams microphone audio over this same
    port's WebSocket endpoint and exposes voice/pitch/morph controls.
    GET /info returns model metadata JSON (voice list for the selector).
    """
    path = lines[0].split(" ")[1] if len(lines[0].split(" ")) > 1 else "/"
    if path in ("/", "/index.html") and os.path.exists(_DEMO_PAGE):
        with open(_DEMO_PAGE, "rb") as f:
            body = f.read()
        sock.sendall(
            b"HTTP/1.1 200 OK\r\nContent-Type: text/html; charset=utf-8\r\n"
            + f"Content-Length: {len(body)}\r\n".encode("ascii")
            + b"Connection: close\r\n\r\n" + body)
    elif path == "/info" and model_host is not None:
        body = json.dumps(model_host.describe()).encode("utf-8")
        sock.sendall(
            b"HTTP/1.1 200 OK\r\nContent-Type: application/json\r\n"
            + f"Content-Length: {len(body)}\r\n".encode("ascii")
            + b"Connection: close\r\n\r\n" + body)
    elif path.startswith("/portrait/") and model_host is not None:
        # voice portrait bytes from the model card (the editor loads these
        # from disk in the reference, editor.cc:1005-1188)
        try:
            vid = int(path[len("/portrait/"):])
        except ValueError:
            vid = -1
        got = model_host.portrait_bytes(vid)
        if got is None:
            sock.sendall(b"HTTP/1.1 404 Not Found\r\nConnection: close\r\n\r\n")
        else:
            body, mime = got
            sock.sendall(
                b"HTTP/1.1 200 OK\r\n"
                + f"Content-Type: {mime}\r\n".encode("ascii")
                + f"Content-Length: {len(body)}\r\n".encode("ascii")
                + b"Cache-Control: max-age=3600\r\n"
                + b"Connection: close\r\n\r\n" + body)
    else:
        sock.sendall(b"HTTP/1.1 404 Not Found\r\nConnection: close\r\n\r\n")


def _handshake_server(sock, model_host=None) -> bool:
    """Read the HTTP request: WebSocket upgrades get a 101 (returns True);
    plain GETs are served the demo client page (returns False)."""
    data = b""
    while b"\r\n\r\n" not in data:
        chunk = sock.recv(4096)
        if not chunk:
            return False
        data += chunk
        if len(data) > 64 * 1024:
            return False
    head = data.split(b"\r\n\r\n", 1)[0].decode("latin-1")
    lines = head.split("\r\n")
    headers = {}
    for line in lines[1:]:
        if ":" in line:
            k, v = line.split(":", 1)
            headers[k.strip().lower()] = v.strip()
    key = headers.get("sec-websocket-key")
    if not lines or not lines[0].startswith("GET"):
        sock.sendall(b"HTTP/1.1 400 Bad Request\r\nConnection: close\r\n\r\n")
        return False
    if "websocket" not in headers.get("upgrade", "").lower() or key is None:
        _serve_http(sock, lines, model_host)
        return False
    sock.sendall(
        (
            "HTTP/1.1 101 Switching Protocols\r\n"
            "Upgrade: websocket\r\n"
            "Connection: Upgrade\r\n"
            f"Sec-WebSocket-Accept: {accept_key(key)}\r\n\r\n"
        ).encode("ascii")
    )
    return True


class _WSHandler(socketserver.BaseRequestHandler):
    def handle(self):
        sock = self.request
        conn = self.server.track(sock)
        live = {}  # the session, once opened
        try:
            if _handshake_server(sock, self.server.model_host):
                self._converse(sock, conn, live)
        except (ConnectionError, OSError, json.JSONDecodeError):
            pass
        finally:
            conn.finish(live.get("session"))

    def _converse(self, sock, conn, live):
        """The WebSocket conversation after the upgrade; the session goes
        into `live` for the handler to close."""
        host = self.server.model_host
        session = None
        send_lock = threading.Lock()  # pump + control replies share the socket

        def send(opcode, payload):
            with send_lock:
                sock.sendall(encode_frame(opcode, payload))

        def send_json(obj):
            send(OP_TEXT, json.dumps(obj, default=float).encode("utf-8"))

        while True:
            opcode, payload = read_message(sock)
            if opcode is None or opcode == OP_CLOSE:
                if opcode == OP_CLOSE:
                    with send_lock:
                        sock.sendall(encode_frame(OP_CLOSE, payload[:2]))
                break
            if opcode == OP_TEXT:
                msg = json.loads(payload.decode("utf-8"))
                op = msg.get("op")
                if op == "hello":
                    session = live["session"] = host.open_session(
                        float(msg.get("sample_rate", 48000))
                    )
                    conn.start_pump(self._pump, session, send)
                    send_json({"ok": True, "session": session.session_id})
                elif op == "set":
                    pid = _resolve_param(msg.get("param"))
                    if pid is None or session is None:
                        send_json({"ok": False, "error": "bad param/session"})
                    else:
                        err = session.set_parameter(pid, msg.get("value"))
                        send_json(
                            {"ok": err == ErrorCode.SUCCESS, "code": int(err)}
                        )
                elif op == "metrics":
                    send_json(host.metrics())
                elif op == "bye":
                    break
                else:
                    send_json({"ok": False, "error": f"unknown op {op!r}"})
            elif opcode == OP_BINARY and session is not None:
                session.push(np.frombuffer(payload, np.float32))

    @staticmethod
    def _pump(session, send, stop: threading.Event) -> None:
        import time

        while not stop.is_set():
            out = session.pull(4096)
            if len(out):
                try:
                    send(OP_BINARY, np.ascontiguousarray(out, np.float32).tobytes())
                except OSError:
                    return
            else:
                time.sleep(0.005)


class WSServer(ConnectionRegistry, socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True

    def __init__(self, address, model_host):
        self._init_registry()
        super().__init__(address, _WSHandler)
        self.model_host = model_host


def serve_ws(model_path: str, port: int = 7778, capacity: int = 64,
             compute_dtype: str | None = None,
             host_addr: str = "127.0.0.1", device="cuda"):
    """Blocking entry point used by `cli serve --ws`; exits as `serve`
    does (netserver.py): connections ended and joined, then the host."""
    from .service import ModelHost

    mh = ModelHost(capacity=capacity, compute_dtype=compute_dtype, device=device)
    err = mh.load_model(model_path)
    if err != ErrorCode.SUCCESS:
        raise SystemExit(f"model load failed: {err!r}")
    srv = WSServer((host_addr, port), mh)
    print(f"ws-serving {model_path} on ws://{host_addr}:{srv.server_address[1]} "
          f"(capacity {capacity}, {mh.device})", flush=True)
    try:
        srv.serve_forever()
    finally:
        exit_census("serve_ws", srv.close(mh))


class WSClient:
    """Minimal stdlib WebSocket client (also used by tests)."""

    def __init__(self, addr=("127.0.0.1", 7778), sample_rate=48000.0):
        self.sock = socket.create_connection(addr, timeout=10.0)
        key = base64.b64encode(os.urandom(16)).decode("ascii")
        self.sock.sendall(
            (
                f"GET / HTTP/1.1\r\nHost: {addr[0]}:{addr[1]}\r\n"
                "Upgrade: websocket\r\nConnection: Upgrade\r\n"
                f"Sec-WebSocket-Key: {key}\r\n"
                "Sec-WebSocket-Version: 13\r\n\r\n"
            ).encode("ascii")
        )
        resp = b""
        while b"\r\n\r\n" not in resp:
            chunk = self.sock.recv(4096)
            if not chunk:
                raise ConnectionError("handshake failed")
            resp += chunk
        head, rest = resp.split(b"\r\n\r\n", 1)
        if b"101" not in head.split(b"\r\n", 1)[0]:
            raise ConnectionError(f"handshake rejected: {head[:100]!r}")
        want = accept_key(key).encode("ascii")
        if want not in head:
            raise ConnectionError("bad Sec-WebSocket-Accept")
        self._pre = rest  # bytes already read past the handshake
        # A dedicated blocking reader thread keeps frame parsing atomic
        # (a poll timeout mid-frame would otherwise tear the stream).
        import queue

        self._json_q: "queue.Queue[dict]" = queue.Queue()
        self._audio = bytearray()
        self._audio_cv = threading.Condition()
        self._closed = threading.Event()
        threading.Thread(target=self._reader, daemon=True).start()
        self._send_json({"op": "hello", "sample_rate": sample_rate})
        msg = self._json_q.get(timeout=30.0)
        assert msg.get("ok"), msg

    def _recv_raw(self, n):
        # splice any pre-read bytes before the socket
        if self._pre:
            take, self._pre = self._pre[:n], self._pre[n:]
            if len(take) == n:
                return take
            more = _recv_exact(self.sock, n - len(take))
            return None if more is None else take + more
        return _recv_exact(self.sock, n)

    def _reader(self):
        class _S:
            def __init__(s, outer):
                s.outer = outer

            def recv(s, n):
                got = s.outer._recv_raw(n)
                return b"" if got is None else got

            def sendall(s, b):
                s.outer.sock.sendall(b)

        shim = _S(self)
        try:
            while True:
                opcode, payload = read_message(shim)
                if opcode is None or opcode == OP_CLOSE:
                    break
                if opcode == OP_TEXT:
                    self._json_q.put(json.loads(payload.decode("utf-8")))
                elif opcode == OP_BINARY:
                    with self._audio_cv:
                        self._audio.extend(payload)
                        self._audio_cv.notify_all()
        except (ConnectionError, OSError):
            pass
        finally:
            self._closed.set()
            with self._audio_cv:
                self._audio_cv.notify_all()

    def _send_json(self, obj):
        self.sock.sendall(
            encode_frame(OP_TEXT, json.dumps(obj).encode("utf-8"), mask=True)
        )

    def set_parameter(self, name, value):
        self._send_json({"op": "set", "param": name, "value": value})
        return self._json_q.get(timeout=30.0)

    def metrics(self):
        self._send_json({"op": "metrics"})
        return self._json_q.get(timeout=30.0)

    def push(self, audio: np.ndarray):
        self.sock.sendall(
            encode_frame(
                OP_BINARY,
                np.ascontiguousarray(audio, np.float32).tobytes(),
                mask=True,
            )
        )

    def pull(self, min_samples: int, timeout: float = 30.0):
        import time

        deadline = time.time() + timeout
        with self._audio_cv:
            while (len(self._audio) < min_samples * 4
                   and not self._closed.is_set()):
                remaining = deadline - time.time()
                if remaining <= 0:
                    break
                self._audio_cv.wait(timeout=min(remaining, 0.2))
            out = np.frombuffer(bytes(self._audio), np.float32)
            self._audio.clear()
        return out

    def close(self):
        try:
            self._send_json({"op": "bye"})
            self.sock.sendall(encode_frame(OP_CLOSE, b"", mask=True))
        except OSError:
            pass
        self.sock.close()
