"""The port's network front ends (`runtime/netserver.py`, `wsserver.py`,
`grpcserver.py`) on the CPU: TCP, WebSocket and gRPC round trips against a
port `ModelHost(capacity=4, realtime=True, device="cpu")` on a small random
2.0.0-rc.0 directory; the replies to bad parameters equal the JAX servers'
(codes and messages) on the same directory; the WebSocket framing cases of
tests/test_wsserver.py:22-72 and the demo page; the gRPC codec against the
JAX one and its field numbers against proto/vc.proto, as
tests/test_proto_sync.py checks for the JAX codec."""

import json
import os
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from beatrice_vst_tpu.runtime import ModelHost as JModelHost
from beatrice_vst_tpu.runtime import grpcserver as jg
from beatrice_vst_tpu.runtime import netserver as jn
from beatrice_vst_tpu.runtime import wsserver as jw
from beatrice_vst_tpu_torch.errors import ErrorCode
from beatrice_vst_tpu_torch.models.io import init_random_model_dir
from beatrice_vst_tpu_torch.runtime import ModelHost
from beatrice_vst_tpu_torch.runtime import grpcserver as pg
from beatrice_vst_tpu_torch.runtime import netserver as pn
from beatrice_vst_tpu_torch.runtime import wsserver as pw
from test_proto_sync import parse_proto

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (parameter, value): refused or accepted alike by both packages' servers
EDITS = [("voice", 99), ("voice", 2), ("pitch_correction_type", 3), ("no_such_param", 1),
         (9999, 1.0), ("model", "/no/such/model"), ("pitch_shift", 4.0), ("Formant Shift", 1.0)]


def _serve(kind, host):
    """Start a front end of the port (or of the JAX package: the module is
    the JAX one) on port 0: (address, stop)."""
    if kind in (pn, jn):
        srv = kind.VCServer(("127.0.0.1", 0), host)
    elif kind in (pw, jw):
        srv = kind.WSServer(("127.0.0.1", 0), host)
    else:
        srv, port = kind.make_server(host, port=0)
        srv.start()
        return f"127.0.0.1:{port}", lambda: srv.stop(grace=None)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()

    def stop():
        srv.shutdown()
        srv.server_close()
        t.join(timeout=30)

    return srv.server_address, stop


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("served_rc0"))
    init_random_model_dir(d, version="2.0.0-rc.0", n_voices=2, seed=0)
    return d


@pytest.fixture(scope="module")
def port_host(model_dir):
    host = ModelHost(capacity=4, realtime=True, device="cpu")
    assert host.load_model(model_dir) == ErrorCode.SUCCESS
    deadline = time.monotonic() + 120
    while host.metrics().get("ticks", 0) < 1:
        assert time.monotonic() < deadline, "the scheduler never ticked"
        time.sleep(0.05)
    yield host
    host.stop()
    assert not host.server.running


@pytest.fixture(scope="module")
def jax_host(model_dir):
    # not ticking: it only answers the control plane
    host = JModelHost(capacity=4, realtime=False, jit=True)
    assert host.load_model(model_dir) == 0
    yield host
    host.stop()


def _tone(rate, seconds=0.5):
    n = np.arange(int(rate * seconds)) / rate
    return (0.3 * np.sin(2 * np.pi * (180 * n + 100 * n * n))).astype(np.float32)


def _client(kind, addr, rate):
    if kind in (pn, jn):
        return kind.VCClient(addr, sample_rate=rate, timeout=60.0)
    if kind in (pw, jw):
        return kind.WSClient(addr, sample_rate=rate)
    return kind.GRPCClient(addr, sample_rate=rate)


FRONT_ENDS = {"tcp": (pn, jn), "ws": (pw, jw), "grpc": (pg, jg)}


@pytest.mark.parametrize("front", sorted(FRONT_ENDS))
def test_round_trip_gives_audio(port_host, front):
    if front == "grpc":
        pytest.importorskip("grpc")
    mod = FRONT_ENDS[front][0]
    addr, stop = _serve(mod, port_host)
    try:
        c = _client(mod, addr, 44100.0)
        assert c.set_parameter("voice", 1)["ok"]
        assert c.set_parameter("pitch_shift", 3.0)["ok"]
        c.push(_tone(44100))
        out = c.pull(4410, timeout=90.0)
        metrics = c.metrics()
        c.close()
    finally:
        stop()
    assert len(out) >= 4410 and np.isfinite(out).all() and np.abs(out).max() > 1e-4
    assert metrics["ticks"] > 0 and "last_error" not in metrics
    assert "serve_tick_p50_ms" in metrics


@pytest.mark.parametrize("front", sorted(FRONT_ENDS))
def test_bad_parameters_get_the_jax_replies(port_host, jax_host, front):
    if front == "grpc":
        pytest.importorskip("grpc")
    replies = []
    for mod, host in zip(FRONT_ENDS[front], (port_host, jax_host)):
        addr, stop = _serve(mod, host)
        try:
            c = _client(mod, addr, 48000.0)
            replies.append([c.set_parameter(name, value) for name, value in EDITS])
            c.close()
        finally:
            stop()
    assert replies[0] == replies[1]
    codes = [r.get("code") for r in replies[0]]
    assert codes == [int(ErrorCode.SPEAKER_ID_OUT_OF_RANGE), 0,
                     int(ErrorCode.INVALID_PITCH_CORRECTION_TYPE), None,
                     int(ErrorCode.UNKNOWN_ERROR), int(ErrorCode.FILE_OPEN_ERROR), 0, 0]


def test_demo_page_and_info_over_http(port_host):
    addr, stop = _serve(pw, port_host)
    base = f"http://{addr[0]}:{addr[1]}"
    try:
        with urllib.request.urlopen(base + "/", timeout=30) as r:
            page = r.read()
        with urllib.request.urlopen(base + "/info", timeout=30) as r:
            info = json.loads(r.read())
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(base + "/portrait/0", timeout=30)
    finally:
        stop()
    with open(os.path.join(REPO, "docs", "demo", "index.html"), "rb") as f:
        assert page == f.read()
    assert info == json.loads(json.dumps(port_host.describe()))
    assert [v["name"] for v in info["voices"]] == ["voice0", "voice1"]


class FakeSock:
    def __init__(self, data):
        self.data = data
        self.sent = b""

    def recv(self, n):
        out, self.data = self.data[:n], self.data[n:]
        return out

    def sendall(self, b):
        self.sent += b


def test_ws_accept_key_rfc_example():
    assert pw.accept_key("dGhlIHNhbXBsZSBub25jZQ==") == "s3pPLMBiTxaQ9kYGzzhZRbK+xOo="


@pytest.mark.parametrize("size", [0, 1, 125, 126, 200, 65535, 70000])
def test_ws_frames_round_trip_like_the_jax_ones(size):
    payload = bytes(range(256)) * (size // 256) + bytes(range(size % 256))
    assert pw.encode_frame(pw.OP_BINARY, payload) == jw.encode_frame(jw.OP_BINARY, payload)
    for mask in (False, True):
        for enc, dec in ((pw.encode_frame, pw.read_message), (jw.encode_frame, pw.read_message),
                         (pw.encode_frame, jw.read_message)):
            opcode, got = dec(FakeSock(enc(pw.OP_BINARY, payload, mask=mask)))
            assert opcode == pw.OP_BINARY and got == payload


def test_ws_fragments_reassemble_and_pings_are_answered():
    f1 = pw.encode_frame(pw.OP_TEXT, b"hello ")
    f1 = bytes([f1[0] & 0x7F]) + f1[1:]  # clear FIN
    ping = pw.encode_frame(pw.OP_PING, b"p", mask=True)
    f2 = pw.encode_frame(pw.OP_CONT, b"world", mask=True)
    sock = FakeSock(f1 + ping + f2)
    assert pw.read_message(sock) == (pw.OP_TEXT, b"hello world")
    assert sock.sent == pw.encode_frame(pw.OP_PONG, b"p")
    assert pw.read_message(FakeSock(b"")) == (None, None)
    with pytest.raises(ConnectionError):
        pw.read_message(FakeSock(pw.encode_frame(0x3, b"x")))


def test_grpc_codec_matches_the_jax_one():
    for n in (0, 1, 127, 128, 300, 16384, 1 << 21):
        assert pg._pb_varint(n) == jg._pb_varint(n)
    msg = {"op": "hello", "sample_rate": 48000}
    audio = np.linspace(-1, 1, 1000, dtype=np.float32)
    for dialect in ("proto", "legacy"):
        jm, am = pg._json_msg(msg, dialect), pg._audio_msg(audio, dialect)
        assert jm == jg._json_msg(msg, dialect) and am == jg._audio_msg(audio, dialect)
        assert pg._decode_frame(jm) == jg._decode_frame(jm)
        kind, payload, got = pg._decode_frame(am)
        assert (kind, got) == ("audio", dialect)
        assert np.array_equal(np.frombuffer(payload, np.float32), audio)
    with pytest.raises(ValueError):
        list(pg._pb_fields(b"\x08\x01"))  # a varint field: not wire type 2


def test_grpc_codec_speaks_the_proto_field_numbers():
    msgs = parse_proto(os.path.join(REPO, "proto", "vc.proto"))
    for name in ("ClientMsg", "ServerMsg"):
        assert msgs[name]["control_json"] == (1, "string")
        assert msgs[name]["audio_f32"] == (2, "bytes")
    assert msgs["MetricsReply"]["json"] == (1, "string") and msgs["MetricsRequest"] == {}
    for fields in msgs.values():
        assert all(t in ("string", "bytes") for _, t in fields.values())
    assert pg._json_msg({})[0] == (1 << 3) | 2
    assert pg._audio_msg(np.ones(3, np.float32))[0] == (2 << 3) | 2
    assert pg.SERVICE == "beatrice.vc.VC"
