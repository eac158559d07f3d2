"""gRPC serving front end (port of `beatrice_vst_tpu/runtime/grpcserver.py`).

Same session semantics as the TCP/WebSocket front ends (one RPC == one
ClientSession == one plugin instance in reference terms,
src/vst/processor.cc:103), exposed as a gRPC service:

    /beatrice.vc.VC/Convert   bidi stream of ClientMsg/ServerMsg
    /beatrice.vc.VC/Metrics   unary MetricsRequest -> MetricsReply

The wire contract is proto/vc.proto.  The service needs no protoc
codegen plugin (grpc_tools): it is registered through generic method
handlers over raw bytes and the
protobuf wire format is (de)coded by hand — every message in vc.proto
uses only length-delimited fields (wire type 2), i.e.
`key=(field_no<<3)|2, varint length, payload`, so the codec is ~20
lines.  External clients codegen from vc.proto with stock protoc and
interoperate byte-for-byte.  `grpc` itself is imported only inside the
functions that need it, so the module (and its codec) imports where
grpcio is not installed.

Back-compat: the original raw framing ([tag:u8][payload], tag 0 = JSON
control, tag 1 = float32 PCM) is still accepted on Convert; replies are
sent in whichever dialect the client's messages use (legacy tags 0x00/
0x01 never collide with proto keys 0x0a/0x12).
"""

from __future__ import annotations

import json
import queue
import threading

import numpy as np

from ..errors import ErrorCode
from .netserver import JOIN_TIMEOUT_S, _resolve_param, exit_census

SERVICE = "beatrice.vc.VC"
TAG_JSON = 0
TAG_AUDIO = 1


def _identity(b: bytes) -> bytes:
    return b


# --- hand-rolled protobuf codec for proto/vc.proto (wire type 2 only) ---


def _pb_varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _pb_field(field_no: int, payload: bytes) -> bytes:
    return bytes([(field_no << 3) | 2]) + _pb_varint(len(payload)) + payload


def _pb_fields(data: bytes):
    """Iterate (field_no, payload) over a message of length-delimited fields."""
    pos, n = 0, len(data)
    while pos < n:
        key = data[pos]
        pos += 1
        if key & 7 != 2:
            raise ValueError(f"unsupported wire type {key & 7}")
        ln = shift = 0
        while True:
            b = data[pos]
            pos += 1
            ln |= (b & 0x7F) << shift
            if not b & 0x80:
                break
            shift += 7
        yield key >> 3, data[pos:pos + ln]
        pos += ln


def _decode_frame(data: bytes):
    """-> (kind, payload, dialect): kind in {'json','audio',None}.

    Legacy frames start with tag 0x00/0x01; proto ClientMsg fields start
    with key 0x0a (control_json) / 0x12 (audio_f32) — disjoint first bytes.
    """
    tag = data[0]
    if tag in (TAG_JSON, TAG_AUDIO):
        return ("json" if tag == TAG_JSON else "audio"), data[1:], "legacy"
    kind = payload = None
    for field, chunk in _pb_fields(data):
        if field == 1:
            kind, payload = "json", chunk
        elif field == 2:
            kind, payload = "audio", chunk
    return kind, payload, "proto"


def _json_msg(obj, dialect: str = "proto") -> bytes:
    raw = json.dumps(obj, default=float).encode("utf-8")
    if dialect == "legacy":
        return bytes([TAG_JSON]) + raw
    return _pb_field(1, raw)


def _audio_msg(audio: np.ndarray, dialect: str = "proto") -> bytes:
    raw = np.ascontiguousarray(audio, np.float32).tobytes()
    if dialect == "legacy":
        return bytes([TAG_AUDIO]) + raw
    return _pb_field(2, raw)


class _ConvertHandler:
    """Bidi-stream handler: a reader thread drains client messages, a pump
    thread drains converted audio; the response generator multiplexes both
    through one queue (gRPC responses must come from a single generator).
    Each live call is registered (its stop flag, queue, threads and a flag
    set when its generator has closed the session), so that `close_calls`
    can end them before the model host stops."""

    def __init__(self, model_host):
        self.host = model_host
        self._calls = {}
        self._lock = threading.Lock()

    def close_calls(self) -> list[str]:
        """End every live call (after `server.stop`, which cancels them):
        stop its pump, wake its generator, and wait for its reader and pump
        threads and for its generator to close the session, within
        JOIN_TIMEOUT_S.  Returns the names of what is still alive."""
        import time

        with self._lock:
            calls = list(self._calls.values())
        for call in calls:
            call["stop"].set()
            try:
                call["outq"].put_nowait(None)
            except queue.Full:
                pass
        deadline = time.monotonic() + JOIN_TIMEOUT_S
        left = []
        for call in calls:
            for t in call["threads"]:
                t.join(max(deadline - time.monotonic(), 0.0))
                if t.is_alive():
                    left.append(t.name)
            if not call["done"].wait(max(deadline - time.monotonic(), 0.0)):
                left.append(f"{call['threads'][0].name} (its generator)")
        return left

    def __call__(self, request_iterator, context):
        outq: "queue.Queue[bytes | None]" = queue.Queue(maxsize=256)
        stop = threading.Event()
        session_box = {}

        def reader():
            try:
                for msg in request_iterator:
                    if not msg:
                        continue
                    kind, payload, dialect = _decode_frame(msg)
                    if kind == "json":
                        session_box["d"] = dialect
                        m = json.loads(payload.decode("utf-8"))
                        op = m.get("op")
                        if op == "hello":
                            s = self.host.open_session(
                                float(m.get("sample_rate", 48000))
                            )
                            session_box["s"] = s
                            outq.put(_json_msg(
                                {"ok": True, "session": s.session_id}, dialect))
                        elif op == "set":
                            s = session_box.get("s")
                            pid = _resolve_param(m.get("param"))
                            if pid is None or s is None:
                                outq.put(_json_msg(
                                    {"ok": False, "error": "bad param/session"},
                                    dialect))
                            else:
                                err = s.set_parameter(pid, m.get("value"))
                                outq.put(_json_msg(
                                    {"ok": err == ErrorCode.SUCCESS,
                                     "code": int(err)}, dialect))
                        elif op == "metrics":
                            outq.put(_json_msg(self.host.metrics(), dialect))
                        elif op == "bye":
                            break
                        else:
                            outq.put(_json_msg(
                                {"ok": False, "error": f"unknown op {op!r}"},
                                dialect))
                    elif kind == "audio" and "s" in session_box:
                        session_box["s"].push(np.frombuffer(payload, np.float32))
            except Exception:
                pass
            finally:
                stop.set()
                outq.put(None)

        def pump():
            import time

            while not stop.is_set():
                s = session_box.get("s")
                if s is None:
                    time.sleep(0.005)
                    continue
                out = s.pull(4096)
                if len(out):
                    try:
                        outq.put(
                            _audio_msg(out, session_box.get("d", "proto")),
                            timeout=1.0)
                    except queue.Full:
                        pass  # slow client: drop rather than stall the engine
                else:
                    time.sleep(0.005)

        call = {"stop": stop, "outq": outq, "done": threading.Event()}
        call["threads"] = [threading.Thread(target=reader, daemon=True,
                                            name=f"vc-grpc-reader-{id(call):x}"),
                           threading.Thread(target=pump, daemon=True,
                                            name=f"vc-pump-{id(call):x}")]
        with self._lock:
            self._calls[id(call)] = call
        for t in call["threads"]:
            t.start()
        try:
            while True:
                msg = outq.get()
                if msg is None:
                    break
                yield msg
        finally:
            stop.set()
            call["threads"][1].join(JOIN_TIMEOUT_S)  # the pump, before its session closes
            s = session_box.get("s")
            if s is not None:
                s.close()
            call["done"].set()
            with self._lock:
                self._calls.pop(id(call), None)


def make_server(model_host, port: int = 0, host_addr: str = "127.0.0.1",
                max_workers: int = 16):
    """-> (grpc.Server, bound_port).  The server carries its Convert
    handler (`convert_handler`, for `close_calls`) and its thread pool
    (`executor`)."""
    from concurrent.futures import ThreadPoolExecutor

    import grpc

    def metrics_handler(request, context):
        # MetricsReply{json = <metrics object>} per proto/vc.proto.
        raw = json.dumps(model_host.metrics(), default=float).encode("utf-8")
        return _pb_field(1, raw)

    convert = _ConvertHandler(model_host)
    handlers = {
        "Convert": grpc.stream_stream_rpc_method_handler(
            convert,
            request_deserializer=_identity,
            response_serializer=_identity,
        ),
        "Metrics": grpc.unary_unary_rpc_method_handler(
            metrics_handler,
            request_deserializer=_identity,
            response_serializer=_identity,
        ),
    }
    executor = ThreadPoolExecutor(max_workers=max_workers)
    server = grpc.server(executor)
    server.convert_handler, server.executor = convert, executor
    server.add_generic_rpc_handlers(
        (grpc.method_handlers_generic_handler(SERVICE, handlers),)
    )
    bound = server.add_insecure_port(f"{host_addr}:{port}")
    return server, bound


def serve_grpc(model_path: str, port: int = 7779, capacity: int = 64,
               compute_dtype: str | None = None,
               host_addr: str = "127.0.0.1", device="cuda"):
    """Blocking entry point used by `cli serve --grpc`.  At exit it stops
    the server (every call cancelled), ends and waits for each call's
    threads, and only then stops the model host."""
    from .service import ModelHost

    mh = ModelHost(capacity=capacity, compute_dtype=compute_dtype, device=device)
    err = mh.load_model(model_path)
    if err != ErrorCode.SUCCESS:
        raise SystemExit(f"model load failed: {err!r}")
    server, bound = make_server(mh, port, host_addr)
    server.start()
    print(f"grpc-serving {model_path} on {host_addr}:{bound} "
          f"(capacity {capacity}, {mh.device})", flush=True)
    try:
        server.wait_for_termination()
    finally:
        server.stop(grace=None).wait(JOIN_TIMEOUT_S)
        stragglers = server.convert_handler.close_calls()
        if not stragglers:
            server.executor.shutdown(wait=True)
        mh.stop()
        exit_census("serve_grpc", stragglers)


class GRPCClient:
    """Minimal reference client (also used by tests).

    Speaks the proto/vc.proto dialect by default; pass dialect="legacy"
    for the original raw tag framing.
    """

    def __init__(self, target: str, sample_rate: float = 48000.0,
                 dialect: str = "proto"):
        import grpc

        self.dialect = dialect
        self.channel = grpc.insecure_channel(target)
        self._call = self.channel.stream_stream(
            f"/{SERVICE}/Convert",
            request_serializer=_identity,
            response_deserializer=_identity,
        )
        self._sendq: "queue.Queue[bytes | None]" = queue.Queue()
        self._resp = self._call(iter(self._sendq.get, None))
        self._json_q: "queue.Queue[dict]" = queue.Queue()
        self._audio = bytearray()
        self._audio_cv = threading.Condition()
        self._closed = threading.Event()
        threading.Thread(target=self._reader, daemon=True).start()
        self._sendq.put(_json_msg(
            {"op": "hello", "sample_rate": sample_rate}, self.dialect))
        msg = self._json_q.get(timeout=30.0)
        assert msg.get("ok"), msg

    def _reader(self):
        try:
            for msg in self._resp:
                if not msg:
                    continue
                kind, payload, _ = _decode_frame(msg)
                if kind == "json":
                    self._json_q.put(json.loads(payload.decode("utf-8")))
                elif kind == "audio":
                    with self._audio_cv:
                        self._audio.extend(payload)
                        self._audio_cv.notify_all()
        except Exception:
            pass
        finally:
            self._closed.set()
            with self._audio_cv:
                self._audio_cv.notify_all()

    def set_parameter(self, name, value):
        self._sendq.put(_json_msg(
            {"op": "set", "param": name, "value": value}, self.dialect))
        return self._json_q.get(timeout=30.0)

    def metrics(self):
        self._sendq.put(_json_msg({"op": "metrics"}, self.dialect))
        return self._json_q.get(timeout=30.0)

    def push(self, audio: np.ndarray):
        self._sendq.put(_audio_msg(audio, self.dialect))

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
            self._sendq.put(_json_msg({"op": "bye"}, self.dialect))
            self._sendq.put(None)
        except Exception:
            pass
        self.channel.close()
