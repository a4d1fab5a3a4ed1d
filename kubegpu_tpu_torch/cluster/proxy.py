"""The watch-cache proxy: the control plane's fan-out tier.

The port's copy of ``kubegpu_tpu/cluster/proxy.py``. One API server
encodes each watch window once, but the sends, the sockets and the
bookkeeping of every subscriber live in its one process. A proxy replica
holds ONE subscription upstream and serves its own downstream watchers
from a local window, as Kubernetes' watch cache does:

* **One upstream subscription.** The proxy dials the server once (a
  stream ``SUB``, negotiated down to the JSON long poll against a server
  without the upgrade) and feeds every batch into an ``_EventLog`` with
  ``attach=False``, which keeps the upstream's sequence numbers. The
  sequence space is the server's (continued across restarts by its WAL),
  so a client moves between a proxy and the server, either way, and
  resumes seq-exact, with no relist.
* **The same surface downstream.** The proxy serves both wires through
  ``httpapi._serve_transport``: the same framing, typed errors and
  encode-once pump, so N downstream watchers cost the server one
  subscription whatever N is.
* **Reads from a mirror, writes forwarded.** GETs are answered from a
  mirrored `InMemoryAPIServer` kept by ``restore_object`` replay (watch
  events carry whole objects, so a replay is an idempotent upsert, and it
  never refuses a record: a card claimed before its old holder's delete
  arrives is taken over). Everything else goes upstream through
  `HTTPAPIClient.forward`; an upstream 429, 403, 404 or 409 is re-raised
  as the same typed error, so the proxy's own transport answers with the
  same status and body. Leases are always forwarded: a lease answer must
  be fresh and atomic, and the mirror is neither.
* **Shared-nothing replicas, each behind its own front door** (``apf=``):
  a flooding tenant saturates only the replica its flows reach.

A cursor below the proxy's floor need not be a gap: the upstream window
is deeper. The SUB path's ``on_subscribe`` and the long-poll route both
call `WatchCacheProxy._ensure_window` first, which replays the missing
prefix from upstream (``_EventLog.backfill``).
"""

from __future__ import annotations

import logging
import threading
import time

from kubegpu_tpu_torch import metrics, obs
from kubegpu_tpu_torch.cluster import stream
from kubegpu_tpu_torch.cluster.apf import TooManyRequests
from kubegpu_tpu_torch.cluster.apiserver import (Conflict,
                                                 InMemoryAPIServer,
                                                 NotFound, QuotaExceeded)
from kubegpu_tpu_torch.cluster.httpapi import (HTTPAPIClient, _EventLog,
                                                _route_request,
                                                _serve_transport)

logger = logging.getLogger(__name__)

# Every first path segment a client can reach lies in one of these:
# LOCAL_ROUTES are GETs answered from the mirror and this process's own
# observability routes, FORWARDED_ROUTES go upstream through `forward`. A
# segment in neither is a request the proxy would 404 and the server
# would serve: a hole in the hop.
LOCAL_ROUTES = frozenset({
    "healthz", "metrics", "debug", "watch", "nodes", "pods", "pvcs",
    "pvs", "pdbs", "quotas", "services", "rcs", "rss", "statefulsets",
    "events",
})
FORWARDED_ROUTES = frozenset({
    "nodes", "pods", "podannotations", "bindmany", "pvcs", "pvs",
    "bindvolume", "quotas", "pdbs", "services", "rcs", "rss",
    "statefulsets", "events", "leases",
})

# The mirror's bootstrap: every listable kind and its list route. Quotas
# list as {tenant: spec}, converted below.
_MIRROR_LISTS = (
    ("node", "/nodes"),
    ("pod", "/pods"),
    ("pvc", "/pvcs"),
    ("pv", "/pvs"),
    ("pdb", "/pdbs"),
    ("service", "/services"),
    ("rc", "/rcs"),
    ("rs", "/rss"),
    ("statefulset", "/statefulsets"),
    ("quota", "/quotas"),
    ("event", "/events"),
)

# A cursor beyond any real head: the watch route answers it with an empty
# relist carrying the head seq and the epoch.
_HEAD_PROBE = 1 << 62


class WatchCacheProxy:
    """One proxy replica: it syncs and subscribes upstream and serves
    downstream.

    The constructor returns once the first sync succeeded (a proxy that
    cannot reach its upstream has nothing to serve), with the upstream
    consumer thread and the dual-wire server running. ``url`` is the
    address clients dial; `stop` tears the replica down."""

    def __init__(self, upstream_url: str, name: str = "proxy",
                 host: str = "127.0.0.1", port: int = 0, apf=None,
                 limit: int = 10000, stream_wire: bool = True):
        self.upstream_url = upstream_url
        self.name = name
        self._apf = apf
        self._stop = threading.Event()
        self._conn_lock = threading.Lock()
        self._sub_conn = None  # the live upstream SUB connection
        # the upstream leg's bytes count as wire="proxy"
        self._upstream = HTTPAPIClient(upstream_url, wire=stream.WIRE_STREAM,
                                       transport_label=stream.WIRE_PROXY)
        self._mirror = InMemoryAPIServer()
        self._log = _EventLog(self._mirror, limit=limit, attach=False)
        # racer: single-writer -- cursor/epoch are written by __init__
        # (before the consumer thread exists) and then only by the
        # consumer thread; downstream handlers never read them
        self._cursor = 0
        self._epoch = None
        self._sync()
        self._thread = threading.Thread(target=self._upstream_loop,
                                        daemon=True,
                                        name=f"{name}-upstream")
        self._thread.start()
        self._server, self.url = _serve_transport(
            self._dispatch, self._log, host=host, port=port,
            stream_wire=stream_wire, on_subscribe=self._ensure_window,
            role="proxy")

    # ---- downstream --------------------------------------------------------

    def _dispatch(self, method: str, parts: list, query: dict, body,
                  peer: str):
        """The replica's own front door first (a flooding tenant is shed
        here, on its shard), then the local or forwarded route."""
        if self._apf is not None:
            with self._apf.admit(method, parts, query, body, peer=peer):
                return self._route(method, parts, query, body)
        return self._route(method, parts, query, body)

    def _route(self, method: str, parts: list, query: dict, body):
        head = parts[0] if parts else ""
        if parts == ["watch"]:
            # a long-poll resume may predate this window; the upstream's is
            # deeper, so backfill before the relist check can fire
            self._ensure_window(int(query.get("since", 0)))
            return _route_request(self._mirror, self._log, method,
                                  parts, query, body)
        if method == "GET" and head in LOCAL_ROUTES:
            try:
                return _route_request(self._mirror, self._log, method,
                                      parts, query, body)
            except NotFound:
                if len(parts) >= 2:
                    # a point GET can race the mirror's lag (created
                    # upstream, its event not applied here yet): the source
                    # of truth answers before a client sees a false 404
                    return self._forward(method, parts, query, body)
                raise
        if head in FORWARDED_ROUTES:
            return self._forward(method, parts, query, body)
        return 404, {"error": f"no route {method} /{'/'.join(parts)}"}

    def _forward(self, method: str, parts: list, query: dict, body):
        """One upstream round trip: the raw status in, an error document
        re-raised out as its typed error, which the proxy's transport maps
        back to the same status and body (``retry_after_s`` and
        ``per_pod`` kept). A reply that is no error document (a lease's
        409 names its holder) passes as it came; the JAX proxy rewrites
        that one into an error body (ROADMAP, deliberate divergences)."""
        path = "/" + "/".join(parts)
        if query:
            path += "?" + "&".join(f"{k}={v}" for k, v in query.items())
        status, doc = self._upstream.forward(method, path, body)
        if not (isinstance(doc, dict) and "error" in doc):
            return status, doc
        if status == 429:
            raise HTTPAPIClient._server_error(TooManyRequests, doc)
        if status == 403:
            raise HTTPAPIClient._server_error(QuotaExceeded, doc)
        if status == 404:
            raise HTTPAPIClient._server_error(NotFound, doc)
        if status == 409:
            raise HTTPAPIClient._server_error(Conflict, doc)
        return status, doc

    def _ensure_window(self, since: int) -> None:
        """Deepen the window to cover ``since`` where the upstream can
        replay it (a client moving over from the server, or from an older
        proxy life). On any upstream refusal (a relist, another epoch, a
        non-200) nothing changes: the pump then sends the relist the
        upstream would."""
        if since <= 0 or since >= self._log.floor():
            return
        status, doc = self._upstream.forward(
            "GET", f"/watch?since={since}&timeout=0")
        if status != 200 or not isinstance(doc, dict) \
                or doc.get("relist") or doc.get("epoch") != self._log.epoch:
            return
        self._log.backfill([tuple(ev) for ev in doc.get("events") or []],
                           since)

    # ---- upstream ----------------------------------------------------------

    def _sync(self) -> None:
        """A full resync: probe the upstream head, list every kind into a
        fresh mirror, adopt the head seq and epoch. The lists come after
        the probe and may hold later writes; replaying the stream from the
        probed head over them converges (``restore_object`` upserts whole
        objects, and deleting an absent one is a no-op)."""
        status, doc = self._upstream.forward(
            "GET", f"/watch?since={_HEAD_PROBE}&timeout=0")
        if status != 200 or not isinstance(doc, dict):
            raise ConnectionError(
                f"upstream head probe answered HTTP {status}")
        head, epoch = int(doc["seq"]), doc.get("epoch")
        mirror = InMemoryAPIServer()
        for kind, path in _MIRROR_LISTS:
            status, listed = self._upstream.forward("GET", path)
            if status != 200 or not isinstance(listed, dict):
                raise ConnectionError(
                    f"upstream list {path} answered HTTP {status}")
            items = listed.get("items")
            if kind == "quota":
                for tenant, spec in (items or {}).items():
                    mirror.restore_object(
                        "quota", "added",
                        {"metadata": {"name": tenant}, "spec": spec})
            else:
                for obj in items or []:
                    mirror.restore_object(kind, "added", obj)
        self._mirror = mirror
        self._cursor = head
        self._epoch = epoch
        self._log.reset(head, epoch)
        logger.info("proxy %s synced at upstream seq %d (epoch %s)",
                    self.name, head, epoch)

    def _apply(self, out: dict) -> bool:
        """Apply one upstream batch: the mirror first (a downstream GET
        must never miss an object the log already announced), then the
        window, then the cursor. False when the upstream declared the
        cursor unreplayable or changed its epoch: the caller resyncs and
        resubscribes, and every downstream watcher gets the relist through
        ``_EventLog.reset``."""
        if out.get("relist") or out.get("epoch") != self._epoch \
                or out["seq"] < self._cursor:
            self._sync()
            return False
        ts = out.get("ts") or 0.0
        if ts:
            # wall clock: the stamp was taken in the server's process
            now = time.time()  # analysis: disable=monotonic-time -- cross-process push-lag stamp, like the pump's
            metrics.PROXY_UPSTREAM_LAG_MS.observe(
                max(0.0, (now - ts) * 1e3))
        events = out.get("events") or []
        for _seq, kind, event, obj in events:
            self._mirror.restore_object(kind, event, obj)
        self._log.ingest(events, out["seq"])
        self._cursor = out["seq"]
        metrics.PROXY_DOWNSTREAM_WATCHERS.labels(self.name).set(
            self._log.stream_subscriber_count())
        return True

    def _upstream_loop(self) -> None:
        obs.register_thread(f"{self.name}-upstream")
        warned = False
        while not self._stop.is_set():
            conn = None
            try:
                try:
                    conn = stream.StreamConn.connect(
                        self.upstream_url, 10.0, label=stream.WIRE_PROXY)
                except stream.StreamUnsupported:
                    # a server without the upgrade: the one subscription
                    # is a JSON long-poll loop instead
                    self._json_poll_loop()
                    continue
                with self._conn_lock:
                    self._sub_conn = conn
                ack = conn.subscribe(self._cursor, None, 0.0, timeout=10.0)
                if ack.get("epoch") != self._epoch \
                        or int(ack.get("seq") or 0) < self._cursor:
                    # the upstream restarted without durability (a new
                    # epoch, or a sequence that went back): everything held
                    # is from another life
                    self._sync()
                    continue
                warned = False
                while not self._stop.is_set():
                    out = conn.read_push(timeout=30.0)
                    if out is None:
                        continue  # a liveness PING
                    if not self._apply(out):
                        break  # resynced: resubscribe at the new cursor
            except (ConnectionError, OSError) as e:
                if not self._stop.is_set() and not warned:
                    warned = True
                    logger.warning("proxy %s upstream subscription lost "
                                   "(%s); reconnecting", self.name, e)
                self._stop.wait(0.2)
            finally:
                with self._conn_lock:
                    self._sub_conn = None
                if conn is not None:
                    conn.close()

    def _json_poll_loop(self) -> None:
        """The negotiated-down consumer: long-poll /watch and feed each
        batch through `_apply`. Returns on stop alone; a transport fault
        reaches the outer loop's backoff."""
        while not self._stop.is_set():
            status, doc = self._upstream.forward(
                "GET", f"/watch?since={self._cursor}&timeout=5")
            if status != 200 or not isinstance(doc, dict):
                raise ConnectionError(
                    f"upstream watch poll answered HTTP {status}")
            self._apply(doc)

    # ---- lifecycle ---------------------------------------------------------

    @property
    def event_log(self) -> _EventLog:
        """The downstream window, as ``server.event_log`` is the API
        server's."""
        return self._log

    def downstream_watchers(self) -> int:
        return self._log.stream_subscriber_count()

    def stop(self) -> None:
        """Stop the downstream server (pump and writers joined, sockets
        severed), the upstream subscription and the upstream client."""
        self._stop.set()
        self._server.shutdown()
        with self._conn_lock:
            conn = self._sub_conn
        if conn is not None:
            # wake the consumer blocked in read_push now, not at its
            # 30 s timeout
            conn.close()
        self._thread.join(timeout=10.0)
        self._upstream.close()
