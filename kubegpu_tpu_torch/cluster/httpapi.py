"""A client of the JAX package's API server for the node side, on both of
its wires.

The port's copy of the subset of ``kubegpu_tpu/cluster/httpapi.py``'s
``HTTPAPIClient`` that the node agent, the advertiser, the runtime hook
and the workload supervisor call: nodes (``get_node``, ``create_node``,
``patch_node_metadata``) and pods (``get_pod``,
``update_pod_annotations``), on the same paths. The watchers are not part
of the port: the node side never watches.

``wire="json"`` sends each request over a per-thread keep-alive HTTP/1.1
connection. ``wire="stream"`` upgrades a per-thread connection to the
framed binary wire (``cluster/stream.py``) and sends the same requests as
frames; a server that answers the upgrade with plain HTTP negotiates the
client down to ``"json"``, once and for good. On either wire, idempotent
verbs (GET, PUT, PATCH, DELETE) retry a transport fault, a torn frame
included, up to three attempts with capped, jittered exponential backoff;
POST is sent once (a blind resend of a create could apply twice). A 429
(a ``REJECT`` frame on the stream wire) carries the server's advised
``retry_after_s``, which an idempotent verb waits out before it sends
again. Error replies come back typed: 404 as `NotFound` (a ``KeyError``),
403 as `QuotaExceeded`, 409 as `Conflict`, 429 as
`TooManyRequests`.
"""

from __future__ import annotations

import http.client
import json
import logging
import random
import socket
import threading
import urllib.parse

from kubegpu_tpu_torch import metrics
from kubegpu_tpu_torch.cluster import stream


class NotFound(KeyError):
    """Object missing (HTTP 404). ``per_pod`` carries the server's
    per-pod reasons for batched verbs."""

    def __init__(self, message: str = "", per_pod: dict | None = None):
        super().__init__(message)
        self.per_pod = dict(per_pod or {})

    def __str__(self) -> str:
        return str(self.args[0]) if self.args else ""


class Conflict(RuntimeError):
    """The write would contradict committed state (HTTP 409)."""

    def __init__(self, message: str = "", per_pod: dict | None = None):
        super().__init__(message)
        self.per_pod = dict(per_pod or {})


class QuotaExceeded(RuntimeError):
    """A tenant is over its quota (HTTP 403): the API server's hard cap at
    create time, or the scheduling engine's fair-share gate at admission."""

    def __init__(self, message: str = "", per_pod: dict | None = None):
        super().__init__(message)
        self.per_pod = dict(per_pod or {})


class TooManyRequests(RuntimeError):
    """Flow-control rejection (HTTP 429) with the server's advised
    backoff."""

    def __init__(self, message: str = "", per_pod: dict | None = None,
                 retry_after_s: float = 0.0):
        super().__init__(message)
        self.per_pod = dict(per_pod or {})
        self.retry_after_s = float(retry_after_s)


class HTTPAPIClient:
    """Nodes and pods of the API server at ``base_url``, over the JSON or
    the stream wire."""

    IDEMPOTENT_METHODS = frozenset({"GET", "PUT", "PATCH", "DELETE"})
    RETRY_ATTEMPTS = 3
    RETRY_BASE_S = 0.05
    RETRY_CAP_S = 0.5

    def __init__(self, base_url: str, timeout: float = 30.0,
                 wire: str = stream.WIRE_JSON):
        if wire not in (stream.WIRE_JSON, stream.WIRE_STREAM):
            raise ValueError(f"unknown wire {wire!r}")
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout
        # the wire in effect: "stream" may negotiate down to "json" on the
        # first round trip against a server without the upgrade
        self.wire = wire
        self._stop = threading.Event()
        self._local = threading.local()   # this thread's connections
        self._conn_lock = threading.Lock()
        self._conns: set = set()          # every live HTTP connection
        self._stream_conns: set = set()   # every live stream connection
        self.retry_count = 0              # transport retries, under _conn_lock
        self.throttled_count = 0          # 429s honoured, under _conn_lock

    def _roundtrip(self, method: str, path: str, data, timeout: float):
        """One request over this thread's keep-alive connection; returns
        ``(status, body bytes)``. A transport fault closes the connection
        so the next attempt dials again."""
        if self._stop.is_set():
            # before the cached connection too: http.client would re-dial
            # a closed one on its own
            raise ConnectionError("client is closed")
        conn = getattr(self._local, "conn", None)
        if conn is None:
            split = urllib.parse.urlsplit(self.base_url)
            cls = http.client.HTTPSConnection if split.scheme == "https" \
                else http.client.HTTPConnection
            conn = cls(split.hostname, split.port, timeout=timeout)
            self._local.conn = conn
            with self._conn_lock:
                self._conns.add(conn)
        try:
            if conn.sock is None:
                conn.timeout = timeout
                conn.connect()
                conn.sock.setsockopt(socket.IPPROTO_TCP,
                                     socket.TCP_NODELAY, 1)
            conn.sock.settimeout(timeout)
            conn.request(method, path, body=data,
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            payload = resp.read()
            # bodies only: the JSON wire's HTTP headers are not counted
            metrics.TRANSPORT_BYTES.labels(stream.WIRE_JSON, "tx").inc(
                len(data) if data else 0)
            metrics.TRANSPORT_BYTES.labels(stream.WIRE_JSON, "rx").inc(
                len(payload))
            return resp.status, payload
        except Exception:
            self._local.conn = None
            with self._conn_lock:
                self._conns.discard(conn)
            conn.close()
            raise

    def _stream_roundtrip(self, method: str, path: str, body,
                          timeout: float):
        """One framed request over this thread's stream connection;
        returns ``(status, decoded body)``. Any fault drops the connection
        so the next attempt dials again."""
        conn = getattr(self._local, "stream", None)
        if conn is None or conn.closed:
            if self._stop.is_set():
                raise ConnectionError("client is closed")
            conn = stream.StreamConn.connect(self.base_url, timeout)
            self._local.stream = conn
            with self._conn_lock:
                self._stream_conns.add(conn)
        try:
            return conn.request(method, path, body, timeout)
        except BaseException:
            self._local.stream = None
            with self._conn_lock:
                self._stream_conns.discard(conn)
            conn.close()
            raise

    def _wire_roundtrip(self, method: str, path: str, body,
                        timeout: float):
        """One round trip over the wire in effect; returns ``(status,
        decoded document)``. An upgrade answered with plain HTTP latches
        the client to the JSON wire."""
        if self.wire == stream.WIRE_STREAM:
            try:
                return self._stream_roundtrip(method, path, body, timeout)
            except stream.StreamUnsupported:
                logging.getLogger(__name__).info(
                    "server at %s has no stream wire; negotiated down to "
                    "json", self.base_url)
                # a one-way latch: every racing writer stores this value
                self.wire = stream.WIRE_JSON
        data = json.dumps(body).encode() if body is not None else None
        status, payload = self._roundtrip(method, path, data, timeout)
        text = payload.decode()
        try:
            doc = json.loads(text) if text else {}
        except ValueError:
            doc = {"error": text}
        return status, doc

    def _backoff(self, attempt: int) -> float:
        return min(self.RETRY_CAP_S, self.RETRY_BASE_S * 2 ** attempt)

    def _req(self, method: str, path: str, body=None):
        """One API round trip under the retry policy of the module
        docstring; returns the decoded document."""
        attempts = self.RETRY_ATTEMPTS \
            if method in self.IDEMPOTENT_METHODS else 1
        for attempt in range(attempts):
            try:
                status, doc = self._wire_roundtrip(method, path, body,
                                                   self.timeout)
            except (http.client.HTTPException, OSError):
                # ConnectionError (FrameError among them) and TimeoutError
                # are OSErrors
                if attempt + 1 >= attempts:
                    raise
                with self._conn_lock:
                    self.retry_count += 1
                # jitter, so a fleet of clients does not resend in step
                self._stop.wait(self._backoff(attempt)
                                * (0.5 + random.random() / 2.0))
                continue
            if status < 400:
                return doc if isinstance(doc, dict) else {}
            if status == 429 and attempt + 1 < attempts:
                advised = float(doc.get("retry_after_s") or 0.0) \
                    if isinstance(doc, dict) else 0.0
                with self._conn_lock:
                    self.throttled_count += 1
                # the server's advice wins; jitter only above it
                delay = advised if advised > 0 else self._backoff(attempt)
                self._stop.wait(delay * (1.0 + random.random() / 4.0))
                continue
            if status == 429:
                raise self._server_error(TooManyRequests, doc)
            if status == 403:
                raise self._server_error(QuotaExceeded, doc)
            if status == 404:
                raise self._server_error(NotFound, doc)
            if status == 409:
                raise self._server_error(Conflict, doc)
            detail = doc.get("error", doc) if isinstance(doc, dict) else doc
            raise RuntimeError(f"HTTP {status}: {detail}")

    @staticmethod
    def _server_error(cls, doc):
        """The typed error from the server's error document, its per-pod
        detail and advised ``retry_after_s`` kept."""
        per_pod, text, retry_after = None, str(doc), None
        if isinstance(doc, dict):
            per_pod = doc.get("per_pod")
            text = doc.get("error", text)
            retry_after = doc.get("retry_after_s")
        if cls is TooManyRequests:
            return cls(text, per_pod=per_pod,
                       retry_after_s=float(retry_after or 0.0))
        return cls(text, per_pod=per_pod)

    def close(self) -> None:
        """Close every connection on both wires; later requests raise."""
        self._stop.set()
        with self._conn_lock:
            conns, self._conns = list(self._conns), set()
            streams, self._stream_conns = list(self._stream_conns), set()
        for conn in conns:
            conn.close()
        for sconn in streams:
            sconn.close()

    # -- nodes and pods ------------------------------------------------------

    def create_node(self, node: dict) -> dict:
        return self._req("POST", "/nodes", node)

    def get_node(self, name: str) -> dict:
        return self._req("GET", f"/nodes/{name}")

    def patch_node_metadata(self, name: str, patch: dict) -> dict:
        return self._req("PATCH", f"/nodes/{name}/metadata", patch)

    def get_pod(self, name: str) -> dict:
        return self._req("GET", f"/pods/{name}")

    def update_pod_annotations(self, name: str, annotations: dict) -> dict:
        return self._req("PUT", f"/pods/{name}/annotations", annotations)
