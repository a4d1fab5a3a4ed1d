"""The port's stream wire (`kubegpu_tpu_torch/core/codec.py`'s binary value
codec, `cluster/stream.py`'s frames, `cluster/httpapi.py`'s client on both
wires) held against the JAX package: byte-identical encodings each side
decodes, the same frame discipline, and the port's client against the JAX
API server (`serve_api`) on ``wire="json"`` and ``wire="stream"`` with the
same documents, typed errors and retry policy, and negotiation down to JSON
against a server without the stream wire."""

import contextlib
import io
import json
import socket
import struct
import threading

import pytest

pytest.importorskip("torch")

from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from kubegpu_tpu.cluster import stream as jax_stream  # noqa: E402
from kubegpu_tpu.cluster.apf import \
    TooManyRequests as JaxTooManyRequests  # noqa: E402
from kubegpu_tpu.cluster.apiserver import Conflict as JaxConflict  # noqa: E402
from kubegpu_tpu.cluster.apiserver import InMemoryAPIServer  # noqa: E402
from kubegpu_tpu.cluster.apiserver import NotFound as JaxNotFound  # noqa: E402
from kubegpu_tpu.cluster.httpapi import serve_api  # noqa: E402
from kubegpu_tpu.core import codec as jax_codec  # noqa: E402
from kubegpu_tpu_torch import metrics  # noqa: E402
from kubegpu_tpu_torch.cluster import stream  # noqa: E402
from kubegpu_tpu_torch.cluster.httpapi import (Conflict,  # noqa: E402
                                               HTTPAPIClient, NotFound,
                                               TooManyRequests)
from kubegpu_tpu_torch.core import codec  # noqa: E402
from tests.test_codec_binary import fat_pod  # noqa: E402

WIRES = ("json", "stream")

# ---- codec parity -----------------------------------------------------------

NODE_SNAPSHOT = {"metadata": {"name": "host0", "annotations": {
    codec.NODE_ANNOTATION_KEY: json.dumps({"name": "host0"}),
    codec.NODE_HEARTBEAT_ANNOTATION: "123.5"}},
    "status": {"allocatable": {"cpu": "128", "pods": 1000}}}

# every document tests/test_codec_binary.py encodes (the watch batch as the
# value its encoder builds), and the values the node side sends
CORPUS = [
    None, True, False, 0, 1, -1, 63, 64, 127, 128, 16384, -2**40, 2**70,
    -2**70, 0.0, 1.5, -3.25, "", "hello", "π ünïcode",
    [], {}, [1, [2, [3, None]]], {"a": {"b": {"c": [True, False]}}},
    {"metadata": {"name": "x", "labels": {"a": "1"}}},
    ["pod-name-that-repeats-often"] * 10,
    {"metadata": "spec", "name": "nodeName"}, ["dynamic-string-a"],
    [1, 2, 3], {"not": "the shape"}, [1],
    fat_pod(), NODE_SNAPSHOT,
    [[[1, "pod", "added", fat_pod("a")],
      [2, "node", "modified", {"metadata": {"name": "n1"}}],
      [5, "pod", "deleted", fat_pod("a")]], 5, 2, False, "e1", 77.25],
    [[], 9, 0, True, None, 0.0],
    2**69, -2**69, 2**200, 10**300, -(10**300),
    {"annotations": {codec.NODE_LINK_HEALTH_ANNOTATION: "{}",
                     codec.NODE_CHIP_HEALTH_ANNOTATION: "{}",
                     codec.NODE_ADDRESS_ANNOTATION: "10.0.0.1"}},
    {"error": "shed", "retry_after_s": 0.05, "tenant": "kgtpu.io/tenant"},
    ["x" * 300, "é" * 200, list(range(200))],
]
REQUESTS = [("POST", "/pods?x=1", fat_pod(), "trace-ctx"),
            ("GET", "/nodes", None, None),
            ("PATCH", "/nodes/host0/metadata", NODE_SNAPSHOT["metadata"], None),
            ("PUT", "/pods/p/annotations", {"a": "1"}, None)]
RESPONSES = [(409, {"error": "chip taken",
                    "per_pod": {"p1": "chip 0/0 claimed by p2"}}),
             (200, NODE_SNAPSHOT), (429, {"error": "x", "retry_after_s": 1.5}),
             (404, {"error": "node ghost"})]


def test_static_table_equals_the_jax_table_element_by_element():
    """Trap: an id is a position in the table, so one entry missing, added
    or moved decodes as another string without any error."""
    assert len(codec._STATIC_STRINGS) == len(jax_codec._STATIC_STRINGS)
    for i, (port, ref) in enumerate(zip(codec._STATIC_STRINGS,
                                        jax_codec._STATIC_STRINGS)):
        assert port == ref, i
    assert codec._STATIC_INDEX == jax_codec._STATIC_INDEX
    tags = [n for n in dir(jax_codec) if n.startswith("_T_")]
    assert {n: getattr(codec, n) for n in tags} == \
        {n: getattr(jax_codec, n) for n in tags}


def _same_value_both_ways(value):
    port, ref = codec.encode_value(value), jax_codec.encode_value(value)
    assert port == ref
    assert codec.decode_value(ref) == jax_codec.decode_value(port) == \
        json.loads(json.dumps(value))


@pytest.mark.parametrize("value", CORPUS, ids=range(len(CORPUS)))
def test_encode_value_bytes_equal_jax(value):
    _same_value_both_ways(value)


def test_non_json_leaves_coerce_like_jax():
    class Weird:
        def __str__(self):
            return "weird"

    class Name(str):
        pass

    value = {"k": Weird(), "t": (1, ("a", 2)), Name("n"): Name("v")}
    assert codec.encode_value(value) == jax_codec.encode_value(value)
    assert codec.decode_value(codec.encode_value(value)) == \
        {"k": "weird", "t": [1, ["a", 2]], "n": "v"}


JSONISH = st.recursive(
    st.none() | st.booleans() | st.text(max_size=20)
    | st.integers(min_value=-2**1000, max_value=2**1000)
    | st.integers(min_value=-300, max_value=300)
    | st.floats(allow_nan=False)
    | st.sampled_from(codec._STATIC_STRINGS),
    lambda kids: st.lists(kids, max_size=6)
    | st.dictionaries(st.text(max_size=8)
                      | st.sampled_from(codec._STATIC_STRINGS), kids,
                      max_size=6),
    max_leaves=40)


@settings(max_examples=150, deadline=None)
@given(JSONISH)
def test_drawn_documents_encode_alike(value):
    _same_value_both_ways(value)


@pytest.mark.parametrize("req", REQUESTS, ids=[r[0] for r in REQUESTS])
def test_encode_request_bytes_equal_jax(req):
    port, ref = codec.encode_request(*req), jax_codec.encode_request(*req)
    assert port == ref
    assert codec.decode_request(ref) == jax_codec.decode_request(port) == req


@pytest.mark.parametrize("resp", RESPONSES, ids=[r[0] for r in RESPONSES])
def test_encode_response_bytes_equal_jax(resp):
    port, ref = codec.encode_response(*resp), jax_codec.encode_response(*resp)
    assert port == ref
    assert codec.decode_response(ref) == jax_codec.decode_response(port) == \
        resp


HOSTILE_PAYLOADS = {
    "truncated": codec.encode_value(fat_pod())[:-5],
    "bad-tag": bytes([0x7F]),
    "dangling": bytes([0x06, 0xFF, 0x7F]),
    "oversized-varint": bytes([0x03]) + b"\xff" * 200 + b"\x01",
    "trailing": codec.encode_value({"a": 1}) + b"\x00",
    "nesting-bomb": bytes([0x07, 1]) * 20000,
    "bad-utf8": bytes([0x05, 2, 0xFF, 0xFE]),
}


@pytest.mark.parametrize("name", sorted(HOSTILE_PAYLOADS))
def test_malformed_payloads_raise_codec_error_in_both(name):
    data = HOSTILE_PAYLOADS[name]
    with pytest.raises(codec.CodecError):
        codec.decode_value(data)
    with pytest.raises(jax_codec.CodecError):
        jax_codec.decode_value(data)


def test_truncation_at_every_offset_and_wrong_shapes_raise_in_both():
    data = codec.encode_request(*REQUESTS[0])
    for cut in range(len(data)):
        for mod in (codec, jax_codec):
            with pytest.raises(mod.CodecError):
                mod.decode_request(data[:cut])
    for mod in (codec, jax_codec):
        for decoder in (mod.decode_request, mod.decode_response):
            with pytest.raises(mod.CodecError):
                decoder(mod.encode_value({"not": "the shape"}))


def test_integers_past_the_varint_cap_refuse_to_encode_in_both():
    for mod in (codec, jax_codec):
        with pytest.raises(mod.CodecError, match="too large"):
            mod.encode_value(2**1025)


# ---- frames -----------------------------------------------------------------


@pytest.mark.parametrize("ftype", ["REQ", "RESP", "PING", "REJECT"])
def test_encode_frame_bytes_equal_jax_and_read_across(ftype):
    payload = codec.encode_response(429, {"error": "shed"})
    port = stream.encode_frame(getattr(stream, ftype), 7, payload)
    ref = jax_stream.encode_frame(getattr(jax_stream, ftype), 7, payload)
    assert port == ref
    assert stream.read_frame(io.BytesIO(ref)) == \
        jax_stream.read_frame(io.BytesIO(port)) == \
        (getattr(stream, ftype), 7, payload)


def test_frame_constants_equal_jax():
    for name in ("REQ", "RESP", "SUB", "PUSH", "PING", "REJECT", "MAX_FRAME",
                 "UPGRADE_PATH", "UPGRADE_TOKEN", "WIRE_STREAM", "WIRE_JSON"):
        assert getattr(stream, name) == getattr(jax_stream, name), name
    assert stream._HEADER.format == jax_stream._HEADER.format
    assert issubclass(stream.FrameError, ConnectionError)
    assert issubclass(stream.StreamClosed, ConnectionError)
    assert not issubclass(stream.StreamUnsupported, ConnectionError)


def _corrupt_crc(data: bytes) -> bytes:
    out = bytearray(data)
    out[-1] ^= 0xFF
    return bytes(out)


FRAME = stream.encode_frame(stream.RESP, 1, b"hello world")
BAD_FRAMES = {
    "torn-header": (b"\x01\x00\x00", "truncated frame header"),
    "torn-payload": (FRAME[:-3], "truncated"),
    "crc": (_corrupt_crc(FRAME), "CRC"),
    "oversized": (struct.pack("<BIII", stream.REQ, 1, stream.MAX_FRAME + 1, 0),
                  "oversized"),
    "unknown-type": (struct.pack("<BIII", 0x7E, 1, 0, 0),
                     "unknown frame type"),
}


@pytest.mark.parametrize("name", sorted(BAD_FRAMES))
def test_bad_frames_are_frame_errors_in_both(name):
    data, match = BAD_FRAMES[name]
    with pytest.raises(stream.FrameError, match=match):
        stream.read_frame(io.BytesIO(data))
    with pytest.raises(jax_stream.FrameError, match=match):
        jax_stream.read_frame(io.BytesIO(data))


def test_clean_eof_is_stream_closed():
    with pytest.raises(stream.StreamClosed):
        stream.read_frame(io.BytesIO(b""))


# ---- StreamConn against a scripted peer ---------------------------------------


@contextlib.contextmanager
def _scripted_peer(reply):
    """A StreamConn over a socket pair whose peer answers the first REQ
    with ``reply(rid)`` (raw bytes)."""
    a, b = socket.socketpair()
    conn = stream.StreamConn(a)

    def peer():
        with b.makefile("rb") as rfile:
            ftype, rid, _ = jax_stream.read_frame(rfile)
            assert ftype == stream.REQ
            b.sendall(reply(rid))

    t = threading.Thread(target=peer, daemon=True)
    t.start()
    try:
        yield conn
    finally:
        t.join(5.0)
        assert not t.is_alive()
        conn.close()
        b.close()


def test_a_reject_for_the_request_is_a_429_not_a_fault():
    body = {"error": "shed", "retry_after_s": 0.25}
    with _scripted_peer(lambda rid: jax_stream.encode_frame(
            jax_stream.PING, 0, b"") + jax_stream.encode_frame(
            jax_stream.REJECT, rid,
            jax_codec.encode_response(429, body))) as conn:
        assert conn.request("GET", "/nodes/n", None, 5.0) == (429, body)
        assert not conn.closed


@pytest.mark.parametrize("case", ["other-rid", "reject-other-rid",
                                  "push", "undecodable"])
def test_out_of_protocol_replies_close_the_connection(case):
    def reply(rid):
        ok = jax_codec.encode_response(200, {})
        return {"other-rid": jax_stream.encode_frame(jax_stream.RESP,
                                                     rid + 1, ok),
                "reject-other-rid": jax_stream.encode_frame(
                    jax_stream.REJECT, rid + 1, ok),
                "push": jax_stream.encode_frame(jax_stream.PUSH, 0, ok),
                "undecodable": jax_stream.encode_frame(jax_stream.RESP, rid,
                                                       b"\xff\xff")}[case]

    with _scripted_peer(reply) as conn:
        with pytest.raises(stream.FrameError):
            conn.request("GET", "/nodes/n", None, 5.0)
        assert conn.closed


def test_close_closes_the_reader_and_the_socket():
    """Trap: the makefile reader holds a reference on the socket, so a
    close that skips it leaves the fd open until GC."""
    a, b = socket.socketpair()
    try:
        conn = stream.StreamConn(a)
        conn.close()
        assert conn.closed and conn._rfile.closed and a.fileno() == -1
        conn.close()   # idempotent
    finally:
        b.close()


# ---- the client against the JAX API server, on both wires -------------------


class FrontDoor:
    """A stand-in of the JAX server's priority-and-fairness front door
    (``serve_api(..., apf=...)``) that raises the queued exceptions, one a
    request, then admits."""

    def __init__(self):
        self.raise_next: list = []

    @contextlib.contextmanager
    def admit(self, method, parts, query, body, peer=""):
        if self.raise_next:
            raise self.raise_next.pop(0)
        yield "workload"


@pytest.fixture(params=WIRES)
def served(request):
    """The JAX API server with a `FrontDoor`, and the port's client on one
    wire: ``(api, client, door, server)``."""
    api = InMemoryAPIServer()
    door = FrontDoor()
    server, url = serve_api(api, apf=door)
    client = HTTPAPIClient(url, wire=request.param)
    yield api, client, door, server
    client.close()
    server.shutdown()
    # nothing negotiated the wire away
    assert client.wire == request.param


def test_unknown_wire_is_refused():
    with pytest.raises(ValueError, match="unknown wire"):
        HTTPAPIClient("http://127.0.0.1:1", wire="grpc")


def test_every_verb_round_trips_on_both_wires(served):
    api, client, _, _ = served
    node = {"metadata": {"name": "n1", "annotations": {"a": "1"}}}
    assert client.create_node(node)["metadata"] == node["metadata"]
    client.patch_node_metadata("n1", {"annotations": {"b": "2"}})
    assert client.get_node("n1") == api.get_node("n1")
    assert api.get_node("n1")["metadata"]["annotations"] == \
        {"a": "1", "b": "2"}
    api.create_pod(fat_pod("p"))
    assert client.get_pod("p") == api.get_pod("p")
    client.update_pod_annotations("p", {"x": "1", "y": "2"})
    assert api.get_pod("p")["metadata"]["annotations"] == {"x": "1", "y": "2"}
    assert client.retry_count == 0


@pytest.mark.parametrize("exc,status,cls", [
    (JaxNotFound("node n9", per_pod={"p": "gone"}), 404, NotFound),
    (JaxConflict("taken", per_pod={"p": "taken"}), 409, Conflict),
    (RuntimeError("boom"), 500, RuntimeError)])
def test_error_replies_are_typed_on_both_wires(served, exc, status, cls):
    _, client, door, _ = served
    door.raise_next.append(exc)
    with pytest.raises(cls) as err:
        client.patch_node_metadata("n1", {})
    assert client.retry_count == 0 and not door.raise_next
    if cls is RuntimeError:
        assert str(err.value).startswith(f"HTTP {status}")
    else:
        assert err.value.per_pod == exc.per_pod
    with pytest.raises(NotFound):
        client.get_node("ghost")


def _sever_server_side(server):
    """Drop every connection the server holds, as a restart would."""
    with server._conn_lock:
        conns = list(server._client_conns)
    for conn in conns:
        with contextlib.suppress(OSError):
            conn.shutdown(socket.SHUT_RDWR)


def test_idempotent_verb_retries_after_a_dropped_connection(served):
    api, client, _, server = served
    api.create_node({"metadata": {"name": "n1"}})
    assert client.get_node("n1")["metadata"]["name"] == "n1"
    _sever_server_side(server)
    assert client.get_node("n1")["metadata"]["name"] == "n1"
    assert client.retry_count == 1


def test_post_is_sent_once_after_a_dropped_connection(served):
    api, client, _, server = served
    client.create_node({"metadata": {"name": "n0"}})
    _sever_server_side(server)
    with pytest.raises(ConnectionError):
        client.create_node({"metadata": {"name": "n1"}})
    assert client.retry_count == 0
    with pytest.raises(KeyError):
        api.get_node("n1")


def test_a_torn_frame_is_retried_like_a_transport_fault(monkeypatch):
    api = InMemoryAPIServer()
    server, url = serve_api(api)
    client = HTTPAPIClient(url, wire="stream")
    real = stream.StreamConn.request
    torn = [stream.FrameError("injected torn frame")] * 2

    def request(self, *args):
        if torn:
            self.close()
            raise torn.pop()
        return real(self, *args)

    monkeypatch.setattr(stream.StreamConn, "request", request)
    try:
        api.create_node({"metadata": {"name": "n1"}})
        assert client.get_node("n1")["metadata"]["name"] == "n1"
        assert client.retry_count == 2
    finally:
        client.close()
        server.shutdown()


def _frames_seen(monkeypatch):
    seen = []
    real = stream.read_frame

    def read_frame(rfile, *wire):
        got = real(rfile, *wire)
        seen.append(got[0])
        return got

    monkeypatch.setattr(stream, "read_frame", read_frame)
    return seen


def test_a_429_is_honoured_then_retried_on_both_wires(served, monkeypatch):
    """On the stream wire the 429 arrives as a REJECT frame and takes the
    same path as the JSON wire's HTTP 429."""
    api, client, door, _ = served
    api.create_node({"metadata": {"name": "n1"}})
    frames = _frames_seen(monkeypatch)
    waits = []
    real_wait = client._stop.wait
    monkeypatch.setattr(client._stop, "wait",
                        lambda s: waits.append(s) or real_wait(0))
    door.raise_next.append(JaxTooManyRequests("shed", retry_after_s=0.05))
    assert client.get_node("n1")["metadata"]["name"] == "n1"
    assert client.throttled_count == 1 and client.retry_count == 0
    assert len(waits) == 1 and 0.05 <= waits[0] <= 0.05 * 1.25
    want = [stream.REJECT, stream.RESP] if client.wire == "stream" else []
    assert frames == want


def test_a_429_on_post_raises_typed_on_both_wires(served):
    _, client, door, _ = served
    door.raise_next.append(JaxTooManyRequests("shed", retry_after_s=0.5))
    with pytest.raises(TooManyRequests) as err:
        client.create_node({"metadata": {"name": "n1"}})
    assert err.value.retry_after_s == 0.5 and client.throttled_count == 0


def test_closed_client_dials_no_wire(served, monkeypatch):
    api, client, _, _ = served
    api.create_node({"metadata": {"name": "n1"}})
    client.get_node("n1")
    live = list(client._stream_conns)
    client.close()
    assert all(c.closed for c in live) and not client._stream_conns
    dials = []
    monkeypatch.setattr(stream.StreamConn, "connect",
                        classmethod(lambda cls, *a: dials.append(a)))
    monkeypatch.setattr(socket, "create_connection",
                        lambda *a, **k: dials.append(a))
    for _ in range(2):
        with pytest.raises(ConnectionError):
            client.get_node("n1")
    assert dials == []


def test_stream_client_negotiates_down_once_against_a_json_only_server(
        monkeypatch):
    api = InMemoryAPIServer()
    server, url = serve_api(api, stream_wire=False)
    client = HTTPAPIClient(url, wire="stream")
    dials = []
    real = stream.StreamConn.connect.__func__

    def connect(cls, *args, **kwargs):
        dials.append(args)
        return real(cls, *args, **kwargs)

    monkeypatch.setattr(stream.StreamConn, "connect", classmethod(connect))
    metrics.TRANSPORT_BYTES.reset()
    try:
        client.create_node({"metadata": {"name": "n1"}})
        assert client.wire == "json" and len(dials) == 1
        for _ in range(3):
            client.patch_node_metadata("n1", {"annotations": {"a": "1"}})
            assert client.get_node("n1")["metadata"]["annotations"] == \
                {"a": "1"}
        assert len(dials) == 1 and client.retry_count == 0
        assert metrics.TRANSPORT_BYTES.labels("json", "rx").value > 0
        assert metrics.TRANSPORT_BYTES.labels("stream", "tx").value == 0
    finally:
        client.close()
        server.shutdown()


@pytest.mark.parametrize("wire", WIRES)
def test_transport_counters_move_under_the_wire_in_use(wire):
    api = InMemoryAPIServer()
    server, url = serve_api(api)
    client = HTTPAPIClient(url, wire=wire)
    metrics.TRANSPORT_BYTES.reset()
    metrics.FRAME_ENCODE_MS.reset()
    metrics.FRAME_DECODE_MS.reset()
    other = "json" if wire == "stream" else "stream"
    try:
        client.create_node({"metadata": {"name": "n1"}})
        client.get_node("n1")
        tx = metrics.TRANSPORT_BYTES.labels(wire, "tx").value
        rx = metrics.TRANSPORT_BYTES.labels(wire, "rx").value
        assert tx > 0 and rx > 0
        assert metrics.TRANSPORT_BYTES.labels(other, "tx").value == 0
        assert metrics.FRAME_ENCODE_MS.n == metrics.FRAME_DECODE_MS.n == \
            (2 if wire == "stream" else 0)
        text = metrics.prometheus_text()
        assert "# TYPE transport_bytes_total counter" in text
        assert f'transport_bytes_total{{wire="{wire}",dir="tx"}} {tx}' in text
        assert "# TYPE frame_encode_ms histogram" in text
    finally:
        client.close()
        server.shutdown()
