"""The framed stream wire of the control plane.

The port's copy of ``kubegpu_tpu/cluster/stream.py``: the frame codec, the
server's locked writers (``send_frame``, ``send_raw``: responses and
pushes interleave on one socket) and the client's `StreamConn`.
The JSON wire pays an HTTP header parse and a JSON encode and decode on
every round trip. After an HTTP ``Upgrade: kgtpu-stream`` handshake the
stream wire carries the same requests as length-prefixed, CRC-checked
frames whose payloads ride the binary value codec of ``core/codec.py``.

Frame layout (little-endian):

    [1B type][4B request id][4B payload length][4B CRC32(payload)][payload]

Types::

    REQ    client -> server  codec.encode_request payload; the id is
                             echoed by the matching RESP
    RESP   server -> client  codec.encode_response payload
    SUB    client -> server  a watch subscription {since, kinds, batch};
                             acked by a RESP, then batches arrive as PUSH
    PUSH   server -> client  codec.encode_watch_batch payload, id 0,
                             unsolicited
    PING   either direction  liveness; empty payload, never acked
    REJECT server -> client  flow control: the server shed the request;
                             the payload is a 429 response carrying
                             retry_after_s, echoed with the REQ's id

A torn, corrupt, oversized or out-of-protocol frame poisons exactly one
connection: the reader raises :class:`FrameError` (a ``ConnectionError``,
so the client's retry policy treats it as the transport fault it is), the
socket is dropped, and the next request dials again (a watch resumes from
its cursor). Nothing is ever re-synchronised inside a damaged stream.
"""

from __future__ import annotations

import socket
import struct
import threading
import time
import urllib.parse
import zlib
from typing import Any, Callable, Optional, Tuple

from kubegpu_tpu_torch import metrics
from kubegpu_tpu_torch.analysis.explore import probe
from kubegpu_tpu_torch.core import codec

_HEADER = struct.Struct("<BIII")  # type, request id, length, CRC32

# Frame types, the JAX package's numbers.
REQ = 1
RESP = 2
SUB = 3
PUSH = 4
PING = 5
REJECT = 6

_FRAME_TYPES = frozenset({REQ, RESP, SUB, PUSH, PING, REJECT})

# One frame must fit a full list response of a large fleet with slack;
# anything larger is a protocol violation, not a workload.
MAX_FRAME = 128 * 1024 * 1024

UPGRADE_PATH = "/stream"
UPGRADE_TOKEN = "kgtpu-stream"
WIRE_STREAM = "stream"
WIRE_JSON = "json"
# the watch-cache proxy's upstream leg (cluster/proxy.py): its bytes count
# apart from the client legs'
WIRE_PROXY = "proxy"


class FrameError(ConnectionError):
    """The stream is no longer frame-aligned (a torn, corrupt, oversized or
    unexpected frame): the connection must be dropped. A
    ``ConnectionError`` on purpose, so the retry policy classifies it as a
    transport fault."""


class StreamClosed(ConnectionError):
    """Clean EOF at a frame boundary (the peer went away)."""


class StreamUnsupported(Exception):
    """The server answered the upgrade with a plain HTTP response: a
    JSON-only server. The client negotiates down to the JSON wire; this is
    the one handshake failure that is not a transport fault."""


def encode_frame(ftype: int, rid: int, payload: bytes) -> bytes:
    return _HEADER.pack(ftype, rid, len(payload),
                        zlib.crc32(payload)) + payload


def read_frame(rfile: Any, wire: str = WIRE_STREAM) -> Tuple[int, int, bytes]:
    """Read one frame off a buffered reader; raises :class:`StreamClosed`
    on clean EOF, :class:`FrameError` on anything torn or hostile. Its
    bytes count under ``transport_bytes_total{wire}``."""
    probe("stream.read_frame")
    header = rfile.read(_HEADER.size)
    if not header:
        raise StreamClosed("stream closed")
    if len(header) < _HEADER.size:
        raise FrameError("truncated frame header")
    ftype, rid, length, crc = _HEADER.unpack(header)
    if ftype not in _FRAME_TYPES:
        raise FrameError(f"unknown frame type 0x{ftype:02x}")
    if length > MAX_FRAME:
        raise FrameError(f"oversized frame ({length} bytes)")
    payload = rfile.read(length)
    if len(payload) < length:
        raise FrameError("truncated frame payload")
    if zlib.crc32(payload) != crc:
        raise FrameError("frame CRC mismatch")
    metrics.TRANSPORT_BYTES.labels(wire, "rx").inc(_HEADER.size + length)
    return ftype, rid, payload


def send_frame(sock: socket.socket, wlock: threading.Lock, ftype: int,
               rid: int, payload: bytes, wire: str = WIRE_STREAM) -> None:
    """Write one frame, whole, under ``wlock``: on the server a response
    and a watch push share one socket."""
    send_raw(sock, wlock, encode_frame(ftype, rid, payload), wire=wire)


def send_raw(sock: socket.socket, wlock: threading.Lock, data: bytes,
             wire: str = WIRE_STREAM) -> None:
    """Write pre-encoded frame bytes under ``wlock``: the event log encodes
    a push once and hands the same bytes to every subscriber."""
    probe("stream.send_frame")
    with wlock:
        sock.sendall(data)
    metrics.TRANSPORT_BYTES.labels(wire, "tx").inc(len(data))


def _timed(hist: Any, fn: Callable[..., Any], *args: Any) -> Any:
    t0 = time.perf_counter()
    out = fn(*args)
    hist.observe((time.perf_counter() - t0) * 1e3)
    return out


def _decode(fn: Callable[[bytes], Any], data: bytes) -> Any:
    """Decode a frame payload. The bytes passed the CRC, so a codec
    rejection means the peer no longer speaks the protocol: it surfaces as
    the same transport fault a torn frame raises."""
    try:
        return fn(data)
    except codec.CodecError as e:
        raise FrameError(f"undecodable frame payload: {e}") from e


class StreamConn:
    """Client side of one framed connection. It serves either serialised
    request/response round trips, one outstanding at a time (one
    connection per requesting thread, like the HTTP keep-alive sockets it
    replaces), or one watch subscription (`subscribe`, then `read_push`).
    Any framing fault closes the socket and surfaces as a
    ``ConnectionError``."""

    def __init__(self, sock: socket.socket,
                 label: Optional[str] = None) -> None:
        self._sock = sock
        # the wire its frames count under: WIRE_PROXY for a proxy's
        # upstream leg, else WIRE_STREAM
        self._label = label or WIRE_STREAM
        # one writer a connection (its requesting thread, or the watch
        # thread's single SUB): the lock is uncontended
        self._wlock = threading.Lock()
        self._rfile = sock.makefile("rb")
        # racer: single-writer -- a StreamConn serves one requesting
        # thread at a time (per-thread keep-alive contract)
        self._rid = 0
        # racer: single-writer -- one-way latch: close() may race the
        # owner but every writer stores True
        self.closed = False

    @classmethod
    def connect(cls, base_url: str, timeout: float,
                label: Optional[str] = None) -> "StreamConn":
        """Dial and upgrade. Raises :class:`StreamUnsupported` when the
        server speaks only JSON over HTTP, and ``OSError`` or
        ``ConnectionError`` on a transport fault."""
        split = urllib.parse.urlsplit(base_url)
        host = split.hostname or "127.0.0.1"
        port = split.port or 80
        sock = socket.create_connection((host, port), timeout=timeout)
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            sock.sendall((f"GET {UPGRADE_PATH} HTTP/1.1\r\n"
                          f"Host: {host}:{port}\r\n"
                          f"Connection: Upgrade\r\n"
                          f"Upgrade: {UPGRADE_TOKEN}\r\n\r\n").encode())
            status, headers = _read_http_head(sock)
            if status != 101 or \
                    headers.get("upgrade", "").lower() != UPGRADE_TOKEN:
                raise StreamUnsupported(
                    f"server answered upgrade with HTTP {status}")
        except BaseException:
            sock.close()
            raise
        return cls(sock, label)

    def request(self, method: str, path: str, body: object,
                timeout: float) -> Tuple[int, object]:
        """One round trip; returns ``(status, decoded body)``. Any frame or
        transport fault closes the connection and re-raises: the caller
        dials again, and may retry under its idempotency policy."""
        self._rid += 1
        rid = self._rid
        payload = _timed(metrics.FRAME_ENCODE_MS, codec.encode_request,
                         method, path, body, None)
        try:
            self._sock.settimeout(timeout)
            send_frame(self._sock, self._wlock, REQ, rid, payload,
                       self._label)
            while True:
                ftype, got_rid, data = read_frame(self._rfile, self._label)
                if ftype == PING:
                    continue
                # a REJECT for this request is flow control, not a fault:
                # its (429, body) response takes the JSON wire's 429 path
                if ftype not in (RESP, REJECT) or got_rid != rid:
                    raise FrameError(
                        f"unexpected frame type {ftype} rid {got_rid} "
                        f"while waiting for response {rid}")
                return _timed(metrics.FRAME_DECODE_MS, _decode,
                              codec.decode_response, data)
        except BaseException:
            self.close()
            raise

    def subscribe(self, since: int, kinds, batch_s: float,
                  timeout: float) -> dict:
        """Register this connection as a push watcher from cursor
        ``since``; returns the ack ``{"seq", "epoch"}``. Batches then
        arrive through :meth:`read_push`."""
        self._rid += 1
        rid = self._rid
        payload = codec.encode_value(
            {"since": since, "kinds": list(kinds) if kinds else None,
             "batch": batch_s})
        try:
            self._sock.settimeout(timeout)
            send_frame(self._sock, self._wlock, SUB, rid, payload,
                       self._label)
            while True:
                ftype, got_rid, data = read_frame(self._rfile, self._label)
                if ftype == PING:
                    continue
                if ftype != RESP or got_rid != rid:
                    raise FrameError("unexpected frame during subscribe")
                status, body = _decode(codec.decode_response, data)
                if status != 200 or not isinstance(body, dict):
                    raise FrameError(f"subscribe refused: HTTP {status}")
                return body
        except BaseException:
            self.close()
            raise

    def read_push(self, timeout: float):
        """The next pushed watch batch (decoded), or None for a liveness
        ``PING``. A socket timeout or a frame fault closes the connection
        and propagates."""
        try:
            self._sock.settimeout(timeout)
            ftype, _rid, data = read_frame(self._rfile, self._label)
            if ftype == PING:
                return None
            if ftype != PUSH:
                raise FrameError(f"unexpected frame type {ftype} on a "
                                 f"watch connection")
            return _timed(metrics.FRAME_DECODE_MS, _decode,
                          codec.decode_watch_batch, data)
        except BaseException:
            self.close()
            raise

    def close(self) -> None:
        self.closed = True
        try:
            # close() alone does not wake a reader blocked in recv() on
            # another thread; shutdown() does, at once
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            # the makefile reader holds a reference on the socket: without
            # closing it the OS fd outlives sock.close() until GC
            self._rfile.close()
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass


def _read_http_head(sock: socket.socket) -> Tuple[int, dict]:
    """Status and lowercased headers of the upgrade reply, read until the
    blank line (no body follows a 101; for any other status only the code
    matters before falling back)."""
    data = b""
    while b"\r\n\r\n" not in data:
        chunk = sock.recv(4096)
        if not chunk:
            raise ConnectionError("connection closed during upgrade")
        data += chunk
        if len(data) > 65536:
            raise FrameError("oversized upgrade response")
    head = data.split(b"\r\n\r\n", 1)[0].decode("latin-1")
    lines = head.split("\r\n")
    parts = lines[0].split(None, 2)
    if len(parts) < 2 or not parts[1].isdigit():
        raise FrameError(f"malformed upgrade response line: {lines[0]!r}")
    headers = {}
    for line in lines[1:]:
        if ":" in line:
            key, val = line.split(":", 1)
            headers[key.strip().lower()] = val.strip()
    return int(parts[1]), headers
