"""A client of the JAX package's API server, on both of its wires.

The port's copy of the part of ``kubegpu_tpu/cluster/httpapi.py``'s
``HTTPAPIClient`` that the port's binaries call, on the same paths with the
same bodies: the node side's verbs (``get_node``, ``create_node``,
``patch_node_metadata``, ``get_pod``, ``update_pod_annotations``), the
scheduler's (nodes and pods listed, bound one by one or all at once with
``bind_many``, annotated and deleted; PDBs, volumes and claims, quotas,
events, leases), the node lifecycle controller's (``create_pod`` for a
requeued copy, ``delete_node`` for a lost node), and the informer the scheduling engine consumes
(``add_watcher``, ``add_batch_watcher``, ``add_relist_listener``).

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

The informer runs on one thread from the first watcher registered until
`close()`. On the JSON wire it long-polls ``GET /watch?since=<cursor>``;
on the stream wire it holds one subscription (``SUB``) and the server
pushes each coalesced batch (``PUSH``). Both wires share one cursor, which
survives a fall back from stream to JSON mid-loop. A transport fault backs
off and resumes from the cursor, so no event is skipped or replayed; a
cursor the server can no longer replay (its ``relist`` flag, a sequence
that went backwards, or a new ``epoch`` after a restart) adopts the
server's cursor and calls every relist listener, so the consumer lists
again instead of resuming with a gap.
"""

from __future__ import annotations

import http.client
import json
import logging
import random
import socket
import threading
import time
import urllib.parse

from kubegpu_tpu_torch import metrics, obs
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
    """The API server at ``base_url``, over the JSON or the stream wire.
    ``watch_batch_s`` is the server's linger per watch window (fuller,
    more coalesced batches for a later first event); ``watch_kinds``
    narrows the watch to those object kinds on the server (None: every
    kind)."""

    IDEMPOTENT_METHODS = frozenset({"GET", "PUT", "PATCH", "DELETE"})
    RETRY_ATTEMPTS = 3
    RETRY_BASE_S = 0.05
    RETRY_CAP_S = 0.5

    def __init__(self, base_url: str, timeout: float = 30.0,
                 wire: str = stream.WIRE_JSON, watch_batch_s: float = 0.0,
                 watch_kinds: tuple | None = None):
        if wire not in (stream.WIRE_JSON, stream.WIRE_STREAM):
            raise ValueError(f"unknown wire {wire!r}")
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout
        # the wire in effect: "stream" may negotiate down to "json" on the
        # first round trip against a server without the upgrade
        self.wire = wire
        self.watch_batch_s = watch_batch_s
        self.watch_kinds = tuple(watch_kinds) if watch_kinds else None
        self._watchers: list = []
        self._batch_watchers: list = []
        self._relist_listeners: list = []
        self._watch_thread = None
        self.watch_errors = 0             # failed watch rounds survived
        self.relist_count = 0             # resume gaps that forced a relist
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
        try:
            if conn.sock is None:
                conn.timeout = timeout
                conn.connect()
                conn.sock.setsockopt(socket.IPPROTO_TCP,
                                     socket.TCP_NODELAY, 1)
            with self._conn_lock:
                # registered under the lock close() sweeps with, so a
                # socket dialled after the sweep is never left open
                if self._stop.is_set():
                    raise ConnectionError("client is closed")
                self._conns.add(conn)
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
                if self._stop.is_set():
                    self._local.stream = None
                    conn.close()
                    raise ConnectionError("client is closed")
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

    def _req(self, method: str, path: str, body=None, timeout=None):
        """One API round trip under the retry policy of the module
        docstring; returns the decoded document."""
        attempts = self.RETRY_ATTEMPTS \
            if method in self.IDEMPOTENT_METHODS else 1
        for attempt in range(attempts):
            try:
                status, doc = self._wire_roundtrip(method, path, body,
                                                   timeout or self.timeout)
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
                if method == "DELETE" and attempt > 0:
                    # an earlier attempt may have landed and lost its
                    # reply: this 404 means "already deleted"
                    return {}
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
        """Close every connection on both wires and join the informer;
        later requests raise."""
        self._stop.set()
        with self._conn_lock:
            conns, self._conns = list(self._conns), set()
            streams, self._stream_conns = list(self._stream_conns), set()
        for conn in conns:
            if conn.sock is not None:
                # close() alone does not wake a reader blocked in recv()
                # (the informer's long poll); shutdown() does, at once
                try:
                    conn.sock.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
            conn.close()
        for sconn in streams:
            sconn.close()
        # its sockets are dead and no new one is dialled, so the informer
        # ends promptly
        watcher = self._watch_thread
        if watcher is not None and watcher is not threading.current_thread():
            watcher.join(timeout=5.0)

    # -- nodes and pods ------------------------------------------------------

    def create_node(self, node: dict) -> dict:
        return self._req("POST", "/nodes", node)

    def get_node(self, name: str) -> dict:
        return self._req("GET", f"/nodes/{name}")

    def delete_node(self, name: str) -> dict:
        return self._req("DELETE", f"/nodes/{name}")

    def patch_node_metadata(self, name: str, patch: dict) -> dict:
        return self._req("PATCH", f"/nodes/{name}/metadata", patch)

    def create_pod(self, pod: dict) -> dict:
        return self._req("POST", "/pods", pod)

    def get_pod(self, name: str) -> dict:
        return self._req("GET", f"/pods/{name}")

    def update_pod_annotations(self, name: str, annotations: dict) -> dict:
        return self._req("PUT", f"/pods/{name}/annotations", annotations)

    def list_nodes(self) -> list:
        return self._req("GET", "/nodes")["items"]

    def list_pods(self, node_name=None, phase=None, bound=False) -> list:
        q = [p for p in (f"node={node_name}" if node_name else "",
                         f"phase={phase}" if phase else "",
                         "bound=1" if bound else "") if p]
        path = "/pods" + ("?" + "&".join(q) if q else "")
        return self._req("GET", path)["items"]

    def update_pod_annotations_many(self, annotations: dict) -> dict:
        """{pod name: annotations}, replaced in one request (a gang's
        stamp)."""
        return self._req("PUT", "/podannotations", annotations)

    def bind_pod(self, name: str, node_name: str) -> dict:
        return self._req("POST", f"/pods/{name}/bind", {"node": node_name})

    def bind_many(self, bindings: dict, annotations: dict) -> dict:
        """Bind every pod of ``bindings`` ({pod: node}) with its
        annotations, all or none (the server's arbiter)."""
        return self._req("POST", "/bindmany",
                         {"bindings": bindings, "annotations": annotations})

    def delete_pod(self, name: str) -> dict:
        return self._req("DELETE", f"/pods/{name}")

    def list_pdbs(self) -> list:
        return self._req("GET", "/pdbs")["items"]

    # -- persistent volumes, claims and quotas -------------------------------

    def get_pvc(self, name: str) -> dict:
        return self._req("GET", f"/pvcs/{name}")

    def list_pvcs(self) -> list:
        return self._req("GET", "/pvcs")["items"]

    def get_pv(self, name: str) -> dict:
        return self._req("GET", f"/pvs/{name}")

    def list_pvs(self) -> list:
        return self._req("GET", "/pvs")["items"]

    def bind_volume(self, pv_name: str, claim_name: str) -> dict:
        return self._req("POST", "/bindvolume",
                         {"pv": pv_name, "pvc": claim_name})

    def list_quotas(self) -> dict:
        """{tenant: quota spec and live cards created}."""
        return self._req("GET", "/quotas")["items"]

    # -- events and leases ---------------------------------------------------

    def record_event(self, kind: str, name: str, event_type: str,
                     reason: str, message: str) -> dict:
        return self._req("POST", "/events",
                         {"kind": kind, "name": name, "type": event_type,
                          "reason": reason, "message": message})

    def record_events(self, events) -> dict:
        """Several events in one POST."""
        return self._req("POST", "/events", list(events))

    def list_events(self, involved_name=None) -> list:
        path = "/events" + (f"?involved={involved_name}"
                            if involved_name else "")
        return self._req("GET", path)["items"]

    def acquire_lease(self, name: str, holder: str, ttl_s: float) -> bool:
        """Take or renew lease ``name`` for ``holder``; False when another
        holder has it (the server's 409, whose body names the holder)."""
        try:
            self._req("POST", f"/leases/{name}",
                      {"holder": holder, "ttl": ttl_s})
            return True
        except Conflict:
            return False

    def lease_holder(self, name: str):
        """The lease's holder, or None when it is vacant or expired."""
        return self._req("GET", f"/leases/{name}").get("holder")

    def release_lease(self, name: str, holder: str) -> bool:
        """Drop a lease ``holder`` holds (a clean hand-over)."""
        self._req("DELETE", f"/leases/{name}?holder={holder}")
        return True

    # -- the informer --------------------------------------------------------

    def add_watcher(self, fn) -> None:
        """``fn(kind, event, obj)`` for every event, in order."""
        self._watchers.append(fn)
        self._ensure_watch_thread()

    def add_relist_listener(self, fn) -> None:
        """``fn()`` when the watch's resume window was lost: the consumer
        must list again."""
        self._relist_listeners.append(fn)

    def add_batch_watcher(self, fn) -> None:
        """``fn([(kind, event, obj), ...])`` once for each delivered
        batch, before the per-event watchers see it."""
        self._batch_watchers.append(fn)
        self._ensure_watch_thread()

    def _ensure_watch_thread(self) -> None:
        if self._watch_thread is None:
            self._watch_thread = threading.Thread(
                target=self._watch_loop, daemon=True, name="api-watch")
            self._watch_thread.start()

    def _watch_loop(self) -> None:
        """The informer: rounds of the wire in effect until `close()`. It
        outlives every transport fault, since the consumers behind it
        have no other source of events."""
        obs.register_thread("informer")
        log = logging.getLogger(__name__)
        st = {"seq": 0, "epoch": None, "failures": 0}
        while not self._stop.is_set():
            if self.wire == stream.WIRE_STREAM:
                self._watch_stream_session(st, log)
            else:
                self._watch_json_poll(st, log)

    def _watch_failed(self, st: dict, log, what: str) -> None:
        self.watch_errors += 1
        st["failures"] += 1
        if st["failures"] == 1:
            log.warning("%s failed; retrying from seq %d", what, st["seq"],
                        exc_info=True)
        self._stop.wait(min(5.0, 0.2 * 2 ** min(st["failures"] - 1, 5)))

    def _watch_json_poll(self, st: dict, log) -> None:
        """One long poll on the JSON wire."""
        path = f"/watch?since={st['seq']}&timeout=5"
        if self.watch_batch_s > 0:
            path += f"&batch={self.watch_batch_s}"
        if self.watch_kinds:
            path += "&kinds=" + ",".join(self.watch_kinds)
        try:
            out = self._req("GET", path, timeout=30.0)
        except Exception:
            if not self._stop.is_set():
                self._watch_failed(st, log, "watch poll")
            return
        if st["failures"]:
            log.info("watch recovered after %d failed polls; resuming "
                     "from seq %d", st["failures"], st["seq"])
            st["failures"] = 0
        self._apply_watch_out(st, out, log)

    def _watch_stream_session(self, st: dict, log) -> None:
        """One subscription on the stream wire: subscribe at the cursor,
        then apply the server's pushes until the connection dies. A server
        without the stream wire latches the client to JSON; the cursor
        carries over."""
        conn = None
        try:
            conn = stream.StreamConn.connect(self.base_url, 10.0)
            with self._conn_lock:
                if self._stop.is_set():
                    # close() already swept the set; the finally closes it
                    return
                self._stream_conns.add(conn)
            ack = conn.subscribe(st["seq"], self.watch_kinds,
                                 self.watch_batch_s, timeout=10.0)
            if st["failures"]:
                log.info("watch recovered after %d failed attempts; "
                         "resuming from seq %d", st["failures"], st["seq"])
                st["failures"] = 0
            # The ack carries the server's head and epoch. It never
            # advances the cursor (the pushes for the gap are on their
            # way), but a head behind the cursor or a new epoch is a
            # restart: the cursor is adopted and the session subscribes
            # again from it, so the server's own relist push cannot fire
            # the listeners a second time.
            if self._apply_watch_out(
                    st, {"events": [], "seq": ack.get("seq"),
                         "epoch": ack.get("epoch")}, log, advance=False):
                return
            while not self._stop.is_set():
                out = conn.read_push(timeout=30.0)
                if out is None:            # liveness ping
                    continue
                st["failures"] = 0
                ts = out.get("ts") or 0.0
                if ts:
                    # the server's wall-clock stamp: push lag across
                    # processes
                    metrics.WATCH_PUSH_LAG_MS.observe(
                        max(0.0, (time.time() - ts) * 1e3))
                self._apply_watch_out(st, out, log)
        except stream.StreamUnsupported:
            log.info("server at %s has no stream wire; the watch falls "
                     "back to the JSON long poll", self.base_url)
            self.wire = stream.WIRE_JSON
        except Exception:
            if not self._stop.is_set():
                self._watch_failed(st, log, "watch stream")
        finally:
            if conn is not None:
                conn.close()
                with self._conn_lock:
                    self._stream_conns.discard(conn)

    def _apply_watch_out(self, st: dict, out: dict, log,
                         advance: bool = True) -> bool:
        """The cursor and delivery contract of both wires: a relist flag,
        a server sequence behind the cursor or a new epoch adopts the
        server's cursor and (for a client that had seen events) calls the
        relist listeners, returning True; otherwise the batch goes to the
        batch watchers, then event by event to the watchers, and the
        cursor advances (unless ``advance`` is False: a subscribe ack)."""
        seq = st["seq"]
        srv_seq = int(out.get("seq", seq) or 0)
        srv_epoch = out.get("epoch")
        moved = (st["epoch"] is not None and srv_epoch is not None
                 and srv_epoch != st["epoch"])
        if srv_epoch is not None:
            st["epoch"] = srv_epoch
        if out.get("relist") or srv_seq < seq or moved:
            if seq > 0:
                # a fresh client (cursor 0) has missed nothing: its
                # consumers' first list covers the history
                self.relist_count += 1
                log.warning("watch resume window lost (client seq %d, "
                            "server seq %d); relisting", seq, srv_seq)
                st["seq"] = srv_seq
                for fn in list(self._relist_listeners):
                    try:
                        fn()
                    except Exception:
                        log.warning("relist listener %r failed", fn,
                                    exc_info=True)
            else:
                st["seq"] = srv_seq
            return True
        events = out.get("events", [])
        if events:
            metrics.WATCH_BATCH_SIZE.set(len(events))
            folded = int(out.get("coalesced", 0) or 0)
            if folded:
                metrics.WATCH_COALESCED.inc(folded)
            batch = []
            for ev_seq, kind, event, obj in events:
                if advance:
                    st["seq"] = max(st["seq"], ev_seq)
                batch.append((kind, event, obj))
            for bfn in list(self._batch_watchers):
                try:
                    bfn(batch)
                except Exception:
                    log.warning("batch watch consumer %r failed on a "
                                "%d-event batch", bfn, len(batch),
                                exc_info=True)
            for kind, event, obj in batch:
                for fn in list(self._watchers):
                    try:
                        fn(kind, event, obj)
                    except Exception:
                        # a bad consumer must not kill the informer, but it
                        # must be visible
                        log.warning("watch consumer %r failed on %s %s "
                                    "event", fn, kind, event, exc_info=True)
        if advance:
            st["seq"] = max(st["seq"], srv_seq)
        return False
