"""The port's API server on HTTP, and its client, on both wires.

The port's copy of ``kubegpu_tpu/cluster/httpapi.py``. `serve_api` exposes
an `InMemoryAPIServer` (``cluster/apiserver.py``) over HTTP and
`HTTPAPIClient` calls the same surface from another process, so the node
agent, the scheduler replicas and the runtime hook run as separate OS
processes wired only by the API endpoint.

Two negotiated wires share one port and one route table:

* **json**: request/response JSON over HTTP/1.1 keep-alive, the watch a
  long poll on ``GET /watch?since=<seq>``.
* **stream**: after an ``Upgrade: kgtpu-stream`` handshake the same socket
  carries length-prefixed, CRC-checked frames (``cluster/stream.py``) in
  the binary codec of ``core/codec.py``, and the watch becomes server
  PUSH: the event log encodes each coalesced batch once and sends the
  same bytes to every subscriber. ``serve_api(..., stream_wire=False)``
  answers the upgrade with a plain 404.

Routes (both wires):

    GET    /healthz
    GET    /nodes            | POST /nodes        | GET/DELETE /nodes/<name>
    PATCH  /nodes/<name>/metadata
    GET    /pods[?node=&phase=&bound=1] | POST /pods | GET/DELETE /pods/<name>
    PUT    /pods/<name>/annotations     | PUT /podannotations {pod: ann}
    POST   /pods/<name>/bind            {"node": ...}
    POST   /bindmany                    {"bindings": {...}, "annotations": {...}}
    GET    /pvcs | POST /pvcs | GET/DELETE /pvcs/<name>   (likewise /pvs)
    POST   /bindvolume                  {"pv": ..., "pvc": ...}
    GET    /quotas | PUT/DELETE /quotas/<tenant>
    GET    /pdbs | POST /pdbs | DELETE /pdbs/<name>  (likewise /services,
           /rcs, /rss, /statefulsets)
    GET    /events[?involved=] | POST /events (one, or a list)
    GET    /watch?since=<seq>[&kinds=&batch=&timeout=]
           -> {"events": [[seq, kind, event, obj]...], "seq", "epoch"}
    POST   /leases/<name> {"holder", "ttl"} -> 200/409 | GET | DELETE
    GET    /metrics | /metrics/history | /debug/traces | /debug/pod/<name>
           | /debug/profile

With ``wal=`` (``cluster/wal.py``) the event log is durable and a restart
recovers both the objects and the watch's sequence space; with ``apf=``
(``cluster/apf.py``) every request of both wires passes the front door
first. Error replies are typed: 404 `NotFound` (a ``KeyError``), 403
`QuotaExceeded`, 409 `Conflict`, 429 `TooManyRequests` (a ``REJECT``
frame on the stream wire).

The client sends each request over a per-thread keep-alive connection of
the wire in effect; a server that answers the upgrade with plain HTTP
negotiates it down to ``"json"``, once and for good. On either wire,
idempotent verbs (GET, PUT, PATCH, DELETE) retry a transport fault, a
torn frame included, up to three attempts with capped, jittered
exponential backoff; POST is sent once (a blind resend of a create could
apply twice). A 429 carries the server's advised ``retry_after_s``, which
an idempotent verb waits out before it sends again.

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
import os
import random
import select
import socket
import threading
import time
import urllib.parse
from bisect import bisect_right
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from kubegpu_tpu_torch import metrics, obs
from kubegpu_tpu_torch.analysis.explore import probe
from kubegpu_tpu_torch.cluster import stream
from kubegpu_tpu_torch.cluster.apf import APFDispatcher, TooManyRequests
from kubegpu_tpu_torch.cluster.apiserver import (Conflict,
                                                 InMemoryAPIServer,
                                                 NotFound, QuotaExceeded)
from kubegpu_tpu_torch.core import codec

# The typed errors are the server's own classes: one ``except Conflict``
# catches the in-process and the wire error alike.
__all__ = ["Conflict", "HTTPAPIClient", "NotFound", "QuotaExceeded",
           "TooManyRequests", "coalesce_events", "serve_api"]


def coalesce_events(events: list) -> tuple:
    """Fold one watch window per the informer compression table:
    added+modified -> added(latest), modified+modified -> modified(latest),
    added+deleted -> nothing (the client never saw the object),
    modified+deleted -> deleted. Chains never merge ACROSS a deleted
    event — a re-create is a new object history, and collapsing
    delete+add into a modify would skip the consumer's teardown path.

    Cross-object order follows each chain's first event, and a merged
    chain carries its LAST event's sequence number and object — so
    per-object versions only ever move forward and the client's
    seq-resume cursor lands exactly where a full replay would have put
    it. Returns ``(events, folded_count)``."""
    out: list = []
    tail: dict = {}  # (kind, object name) -> index of its chain in out
    folded = 0
    for ev in events:
        seq, kind, etype, obj = ev
        name = (obj.get("metadata") or {}).get("name") \
            if isinstance(obj, dict) else None
        key = (kind, name)
        idx = tail.get(key)
        prev = out[idx] if idx is not None else None
        if name is None or prev is None or prev[2] == "deleted" or \
                etype not in ("modified", "deleted"):
            tail[key] = len(out)
            out.append(ev)
            continue
        if etype == "modified":
            out[idx] = (seq, kind, prev[2], obj)
            folded += 1
        elif prev[2] == "added":
            out[idx] = None
            tail.pop(key)
            folded += 2
        else:
            out[idx] = (seq, kind, "deleted", obj)
            folded += 1
    return [e for e in out if e is not None], folded


class _StreamSubscriber:
    """One push watcher on the stream wire: a bounded outbound frame
    queue drained by its own writer thread, so a slow or dead consumer
    can neither wedge the fan-out pump nor any other watcher. Overflow
    or a send fault kills the CONNECTION (never the server): the client
    reconnects and resumes seq-exact from its cursor, which is the same
    recovery the JSON long-poll already has."""

    MAX_QUEUED = 256

    def __init__(self, send, cursor: int, kinds, batch_s: float,
                 threaded: bool = True, on_dead=None):
        self._send = send          # callable(frame bytes) -> None
        self.cursor = cursor       # last seq delivered; PUMP-owned
        self.kinds = frozenset(kinds) if kinds else None
        self.batch_s = batch_s
        # called exactly once on the alive->dead transition (severs the
        # connection, so the client notices IMMEDIATELY instead of
        # sitting out its read timeout on a socket nobody feeds)
        self._on_dead = on_dead
        self._lock = threading.Condition()
        self._queue: deque = deque()
        self._dead = False
        self._inflight = False  # an inline send is on the socket
        self._thread = None
        if threaded:
            self._thread = threading.Thread(
                target=self._writer_loop, daemon=True, name="watch-push")
            self._thread.start()

    def offer(self, data: bytes) -> None:
        """Hand one encoded frame to this subscriber; the fast path
        sends INLINE (the common case: queue empty, socket writable —
        one thread handoff fewer on the push latency path), falling back
        to the writer-thread queue whenever a send is already in
        flight. The server caps the socket's send timeout, so a wedged
        consumer costs the pump one bounded send before it is severed —
        it can never stall the fan-out indefinitely."""
        probe("stream.offer")
        if self._thread is None:
            # direct mode (unit tests): the caller IS the delivery
            # thread
            try:
                self._send(data)
            except Exception:
                self._die()
            return
        with self._lock:
            if self._dead:
                return
            if self._queue or self._inflight:
                overflow = len(self._queue) >= self.MAX_QUEUED
                if not overflow:
                    self._queue.append(data)
                    self._lock.notify_all()
                    return
                # a consumer this far behind will never catch up by
                # buffering more; sever it and let resume do its job
            else:
                self._inflight = True
                overflow = False
        if overflow:
            self._die()
            return
        try:
            self._send(data)  # outside locks; socket timeout bounds it
        except Exception:
            self._die()
        finally:
            with self._lock:
                self._inflight = False
                self._lock.notify_all()

    def is_dead(self) -> bool:
        with self._lock:
            return self._dead

    def stop(self) -> None:
        self._die()
        # a dead subscriber's writer exits on the notify; join it so
        # teardown leaves no writer thread behind (self-join guarded:
        # _die may be invoked from the writer's own send failure)
        thread = self._thread
        if thread is not None and thread is not threading.current_thread():
            thread.join(timeout=5.0)

    def _die(self) -> None:
        """Alive->dead transition: wake the writer and fire ``on_dead``
        exactly once, OUTSIDE the lock (it closes a socket) — severing
        the connection is what turns 'silently starved watcher' into an
        immediate client reconnect + seq-exact resume."""
        with self._lock:
            if self._dead:
                return
            self._dead = True
            self._lock.notify_all()
        cb = self._on_dead
        if cb is not None:
            try:
                cb()
            except Exception:
                pass  # the connection may already be gone

    def _writer_loop(self):
        obs.register_thread("stream-pump")
        while True:
            with self._lock:
                while (not self._queue or self._inflight) \
                        and not self._dead:
                    self._lock.wait()
                if self._dead:
                    return
                data = self._queue.popleft()
                # claim the socket so a concurrent offer() cannot jump
                # the queue with an inline send (frames must stay in
                # cursor order per subscriber)
                self._inflight = True
            try:
                self._send(data)  # blocking socket write, outside locks
            except Exception:
                with self._lock:
                    self._inflight = False
                self._die()
                return
            with self._lock:
                self._inflight = False
                self._lock.notify_all()


class _EventLog:
    """Bounded sequence-numbered event log backing /watch long-polls.

    With a ``wal`` (cluster/wal.py), the log is durable: every record is
    appended to the WAL *before* any watcher can see it, the apiserver's
    object state is rebuilt from snapshot+replay on construction, and
    the sequence space continues across a process restart — so a client
    resuming with ``since=seq`` gets exactly the events it missed.
    ``floor`` is the highest sequence number no longer replayable
    (snapshot compaction or the in-memory trim); a client presenting an
    older ``since`` is answered with a full-relist signal instead of a
    silent gap.

    With ``attach=False`` the log records nothing of its own: it is a
    watch-cache proxy's downstream window (``cluster/proxy.py``), fed the
    upstream's events with their upstream sequence numbers through
    `reset`, `ingest` and `backfill`. The sequence space stays the API
    server's, so a client moves between a proxy and the server and
    resumes seq-exact."""

    def __init__(self, api: InMemoryAPIServer, limit: int = 10000,
                 wal=None, attach: bool = True):
        self._lock = threading.Condition()
        self._events: list = []
        self._seq = 0
        self._floor = 0
        self.limit = limit
        self._wal = wal
        self._api = api
        # stream-wire push fan-out (add_stream_subscriber): subscribers,
        # their pump thread, and the encode-once accounting the tests
        # (and the 4k-node scaling story) assert on
        self._subs: list = []
        self._pump_thread = None
        self._pump_stop = False
        self.stream_encodes = 0   # batches encoded (once per window)
        self.stream_deliveries = 0  # frames offered across subscribers
        # the transport's faults, counted by its handlers (note_fault):
        # stream connections dropped on a torn or hostile frame, and
        # upgrades answered with plain HTTP by a server without the wire
        self.stream_poisoned = 0
        self.upgrades_refused = 0
        # stream identity: WAL-backed logs keep theirs across restarts
        # (sequence continuity is real); a volatile log mints a fresh
        # one per life, so clients can detect a restart even when the
        # new sequence space overlaps their old cursor
        self.epoch = wal.stream_epoch() if wal is not None \
            else os.urandom(8).hex()
        if wal is not None:
            # recovery BEFORE the watcher registers: replay must not
            # re-log itself, and clients must never see partial state
            last_seq, floor, tail = wal.recover(api)
            self._seq = last_seq
            self._floor = floor
            self._events = list(tail)[-limit:]
            if len(tail) > limit:
                self._floor = self._events[0][0] - 1
        if attach:
            api.add_watcher(self._record)

    # Recent events carried INSIDE each snapshot: they are already
    # reflected in the snapshotted state (never re-applied on recovery)
    # but extend the watch-resume window below the compaction point, so
    # a client up to this many events behind the final pre-crash
    # snapshot still resumes seq-exact instead of relisting.
    SNAPSHOT_TAIL = 256

    def seq(self) -> int:
        with self._lock:
            return self._seq

    def floor(self) -> int:
        with self._lock:
            return self._floor

    def tail(self, k: int) -> list:
        with self._lock:
            return list(self._events[-k:]) if k > 0 else []

    def stream_subscriber_count(self) -> int:
        with self._lock:
            return len(self._subs)

    def note_fault(self, kind: str) -> None:
        """Count one transport fault: ``"poisoned"`` or ``"refused"``."""
        with self._lock:
            if kind == "poisoned":
                self.stream_poisoned += 1
            else:
                self.upgrades_refused += 1

    # ---- a proxy's ingest (attach=False) ----------------------------------

    def reset(self, head_seq: int, epoch: str) -> None:
        """Adopt an upstream position: drop the window and go on from the
        upstream head under its epoch (at a proxy's sync, and whenever the
        upstream relists it). Every downstream cursor below the head then
        gets the relist the upstream gave, and a new epoch reaches the
        clients through the proxy as it would directly."""
        with self._lock:
            self._events = []
            self._seq = head_seq
            self._floor = head_seq
            self.epoch = epoch
            self._lock.notify_all()

    def ingest(self, events: list, head_seq: int) -> None:
        """Record one upstream watch batch with its upstream sequence
        numbers. A coalesced batch can interleave seqs across objects, so
        it is sorted before it is appended (the log stays bisectable; an
        object's own seqs only grow). The trim moves the floor as
        recording does."""
        with self._lock:
            batch = sorted((tuple(ev) for ev in events
                            if ev[0] > self._seq),
                           key=lambda ev: ev[0])
            self._events.extend(batch)
            if head_seq > self._seq:
                self._seq = head_seq
            if len(self._events) > self.limit:
                drop = len(self._events) - self.limit
                self._floor = self._events[drop - 1][0]
                self._events = self._events[drop:]
            self._lock.notify_all()

    def backfill(self, events: list, new_floor: int) -> None:
        """Extend the window downward to ``new_floor``: a downstream cursor
        lay below the floor and the deeper upstream window replayed the
        gap. Only events below the first held seq are prepended; a
        coalesced event whose seq lies inside the window is dropped with
        nothing lost, since the in-window event holds that object
        whole."""
        with self._lock:
            first = self._events[0][0] if self._events else self._seq + 1
            prefix = sorted((tuple(ev) for ev in events
                             if new_floor < ev[0] < first),
                            key=lambda ev: ev[0])
            self._events = prefix + self._events
            self._floor = min(self._floor, new_floor)
            self._lock.notify_all()

    def _record(self, kind, event, obj):
        # self._wal is set once in __init__ and never reassigned — it is
        # configuration, not guarded state (and never written under the
        # lock, so lock-discipline does not flag it)
        wal = self._wal
        with self._lock:
            self._seq += 1
            seq = self._seq
            if wal is not None:
                # write-ahead: durable before any watcher is woken
                wal.append(seq, kind, event, obj)
            self._events.append((seq, kind, event, obj))
            if len(self._events) > self.limit:
                drop = len(self._events) - self.limit
                self._floor = self._events[drop - 1][0]
                self._events = self._events[drop:]
            self._lock.notify_all()
        if wal is not None and kind == "pod":
            # continue the mutation's trace through durability: pod
            # records only, and only when a span context is active (a
            # traced bind reaching the WAL) — the steady watch stream
            # and a traced request's side-writes (Events, PVC flips)
            # must not flood the bounded ring
            name = (obj.get("metadata") or {}).get("name") \
                if isinstance(obj, dict) else None
            if name is not None and obs.parent_for(name) is not None:
                obs.event("wal_append", pod=name, proc="apiserver",
                          event=event, seq=seq)
        if wal is not None and wal.due_for_snapshot():
            # Outside the event-log lock (state dump -> event-log seq is
            # the apiserver-first order every mutator already takes; the
            # reverse here would be an inversion). The caller is the
            # mutator's notify, so its reentrant apiserver lock is still
            # held and (state, seq) is exactly this record's cut.
            state, snap_seq = self._api.snapshot_with(self.seq)
            wal.snapshot(state, snap_seq, tail=self.tail(self.SNAPSHOT_TAIL))

    def since(self, seq: int, timeout: float = 10.0, batch_s: float = 0.0,
              kinds: frozenset | None = None):
        """Events after ``seq``, coalesced per-object. ``batch_s`` > 0
        lingers that long after the first pending event so a burst in
        progress rides THIS response instead of costing another poll;
        ``kinds`` narrows the stream server-side (a scheduler that never
        consumes Event records must not pay their encode/decode).
        Returns ``(events, latest_seq, folded_count, relist)`` — the
        resume contract is unchanged: every returned event keeps a
        sequence number > ``seq``, and ``latest_seq`` advances the
        cursor past anything folded away or filtered out. ``relist``
        is True when ``seq`` falls outside the replayable window and
        the caller must fall back to a full list."""
        deadline = time.monotonic() + timeout
        with self._lock:
            while True:
                if seq < self._floor or seq > self._seq:
                    # outside the replayable window — below the floor
                    # (compaction/trim, possibly having moved WHILE this
                    # poll waited: the check lives under the serving
                    # lock so a concurrent trim cannot open a silent
                    # gap) or beyond the current sequence (a cursor from
                    # another server life): the caller must relist
                    return [], self._seq, 0, True
                out = self._window_locked(seq, kinds)
                if out:
                    if batch_s > 0:
                        end = min(time.monotonic() + batch_s, deadline)
                        while time.monotonic() < end:
                            self._lock.wait(end - time.monotonic())
                        out = self._window_locked(seq, kinds)
                    out, folded = coalesce_events(out)
                    return out, self._seq, folded, False
                if time.monotonic() >= deadline:
                    return [], self._seq, 0, False
                self._lock.wait(min(0.5, deadline - time.monotonic()))

    def _window_locked(self, seq: int, kinds) -> list:
        """Events after ``seq`` (kind-filtered), bisected instead of
        scanned: the log is seq-ordered and holds up to ``limit``
        entries, and a full scan per poll/push was the serving path's
        hidden O(log size) tax. Caller holds ``self._lock``."""
        idx = bisect_right(self._events, seq, key=lambda e: e[0])
        window = self._events[idx:]
        if kinds is None:
            return window
        return [e for e in window if e[1] in kinds]

    # ---- stream-wire push fan-out ------------------------------------------

    PING_EVERY_S = 5.0

    def add_stream_subscriber(self, send, since: int, kinds=None,
                              batch_s: float = 0.0,
                              threaded: bool = True,
                              on_dead=None) -> _StreamSubscriber:
        """Register a push watcher: ``send(frame bytes)`` receives every
        coalesced batch after ``since``. With ``threaded`` (production)
        the subscriber drains through its own writer thread and a shared
        pump thread runs the fan-out; tests pass ``threaded=False`` and
        drive :meth:`pump_once` themselves.
        ``on_dead`` fires once when the subscriber is severed (overflow
        or send fault) — the transport closes the connection there so
        the client reconnects immediately."""
        probe("stream.subscribe")
        sub = _StreamSubscriber(send, since, kinds, batch_s,
                                threaded=threaded, on_dead=on_dead)
        with self._lock:
            self._subs.append(sub)
            if threaded and self._pump_thread is None and \
                    not self._pump_stop:
                self._pump_thread = threading.Thread(
                    target=self._pump_loop, daemon=True,
                    name="watch-fanout")
                self._pump_thread.start()
            self._lock.notify_all()
        return sub

    def remove_stream_subscriber(self, sub: _StreamSubscriber) -> None:
        probe("stream.unsubscribe")
        with self._lock:
            if sub in self._subs:
                self._subs.remove(sub)
        sub.stop()

    def stop_stream(self) -> None:
        """Tear down the fan-out (server shutdown): stops the pump and
        every subscriber's writer thread, and JOINS them — a "stopped"
        stream with its pump still draining a wait was the unjoined-
        thread path the lifecycle work closed."""
        with self._lock:
            self._pump_stop = True
            subs = list(self._subs)
            self._subs = []
            pump = self._pump_thread
            self._pump_thread = None
            self._lock.notify_all()
        for sub in subs:
            sub.stop()
        if pump is not None and pump is not threading.current_thread():
            pump.join(timeout=5.0)

    def _pump_loop(self):
        obs.register_thread("stream-pump")
        while True:
            with self._lock:
                if self._pump_stop:
                    return
            self.pump_once(wait_s=self.PING_EVERY_S)

    def pump_once(self, wait_s: float = 0.0) -> int:
        """One fan-out pass: wait up to ``wait_s`` for any subscriber to
        fall behind the log head, then compute each lagging subscriber's
        window, encode every distinct ``(kinds, cursor)`` window exactly
        ONCE, and offer the identical frame bytes to each subscriber at
        that window — the per-watcher re-encode the long-poll wire pays
        is gone. A wait that expires idle pings every subscriber
        instead (liveness + dead-socket detection). Returns the number
        of frames offered."""
        probe("stream.pump")
        deadline = time.monotonic() + wait_s
        with self._lock:
            while True:
                self._subs = [s for s in self._subs if not s.is_dead()]
                behind = [s for s in self._subs if s.cursor != self._seq]
                if behind or self._pump_stop:
                    break
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._lock.wait(min(0.5, remaining))
            if self._pump_stop:
                return 0
            linger = max((s.batch_s for s in behind), default=0.0)
            if behind and linger > 0:
                # ride a burst in progress: linger so the window folds
                # into one fuller frame instead of N thin ones
                end = time.monotonic() + linger
                while time.monotonic() < end:
                    self._lock.wait(end - time.monotonic())
                behind = [s for s in self._subs
                          if not s.is_dead() and s.cursor != self._seq]
            seq = self._seq
            floor = self._floor
            epoch = self.epoch
            events = []
            if behind:
                in_window = [s.cursor for s in behind
                             if floor <= s.cursor <= seq]
                if in_window:
                    # one bisected slice covering every lagging cursor —
                    # never a full copy of the bounded log
                    idx = bisect_right(self._events, min(in_window),
                                       key=lambda e: e[0])
                    events = self._events[idx:]
            subs = list(self._subs)
        if not behind:
            ping = stream.encode_frame(stream.PING, 0, b"")
            for sub in subs:
                sub.offer(ping)
            return 0
        # Encode outside the event-log lock: mutators must never stall
        # behind a fan-out pass. The wall-clock stamp rides the frame so
        # the receiving process can measure push lag; wall clock on
        # purpose (cross-process stamp, like the advertiser heartbeat).
        now_ts = time.time()  # analysis: disable=monotonic-time -- cross-process push-lag stamp, like the heartbeat annotation
        sent = 0
        relist_frame = None
        cache: dict = {}    # (kinds, cursor) -> frame
        encoded: dict = {}  # filtered-window signature -> frame
        for sub in behind:
            if sub.cursor < floor or sub.cursor > seq:
                # outside the replayable window (compaction/trim, or a
                # cursor from another server life): explicit relist
                # signal, exactly like the long-poll contract
                if relist_frame is None:
                    payload = codec.encode_watch_batch(
                        [], seq, relist=True, epoch=epoch,
                        ts=now_ts)
                    relist_frame = stream.encode_frame(
                        stream.PUSH, 0, payload)
                sub.offer(relist_frame)
                sub.cursor = seq
                sent += 1
                continue
            key = (sub.kinds, sub.cursor)
            frame = cache.get(key)
            if frame is None:
                window = [e for e in events
                          if e[0] > sub.cursor
                          and (sub.kinds is None or e[1] in sub.kinds)]
                # Distinct (kinds, cursor) cohorts whose FILTERED
                # windows coincide — cursors straddling only
                # filtered-out events, or different kind filters
                # passing the same events — must share one encode: the
                # signature keys the frame by the events actually
                # delivered (seqs are unique, so equal seq tuples mean
                # equal windows), so steady-state fan-out encodes once
                # TOTAL, not once per cursor cohort.
                sig = tuple(e[0] for e in window)
                frame = encoded.get(sig)
                if frame is None:
                    window, folded = coalesce_events(window)
                    t0 = time.perf_counter()
                    payload = codec.encode_watch_batch(
                        window, seq, coalesced=folded, epoch=epoch,
                        ts=now_ts)
                    frame = stream.encode_frame(stream.PUSH, 0, payload)
                    metrics.FRAME_ENCODE_MS.observe(
                        (time.perf_counter() - t0) * 1e3)
                    self.stream_encodes += 1
                    encoded[sig] = frame
                cache[key] = frame
            sub.offer(frame)
            self.stream_deliveries += 1
            sub.cursor = seq
            sent += 1
        return sent


# How long a subscribed connection's reader waits for input between
# checks; its socket's timeout bounds the pushes' sends alone.
_SUB_IDLE_S = 5.0

# Raw-text response envelope: a route returning
# {RAW_CONTENT_TYPE: ..., RAW_TEXT: ...} is unwrapped by the JSON-wire
# HTTP handler into a plain text body with that content type (the
# Prometheus exposition must be scrapeable, not JSON-wrapped); the
# stream wire delivers the envelope dict unchanged.
RAW_CONTENT_TYPE = "__content_type__"
RAW_TEXT = "__text__"


def _split_path(path: str) -> tuple:
    """``"/pods?node=n1" -> (["pods"], {"node": "n1"})`` — one parser
    for both wires' route strings."""
    parts = [p for p in path.split("?")[0].split("/") if p]
    query: dict = {}
    if "?" in path:
        for kv in path.split("?", 1)[1].split("&"):
            if "=" in kv:
                k, v = kv.split("=", 1)
                query[k] = v
    return parts, query


def _error_body(e: Exception) -> dict:
    """The error payload both wires send for typed errors (NotFound /
    Conflict / QuotaExceeded / TooManyRequests) — per-pod conflict/bind
    detail and the front door's advised retry_after_s included, so the
    client reconstructs the identical typed error either wire carried
    (the binder's conflict handling and the retry policy's advised
    backoff both depend on it)."""
    body = {"error": str(e)}
    if getattr(e, "per_pod", None):
        body["per_pod"] = e.per_pod
    retry_after = getattr(e, "retry_after_s", None)
    if retry_after:
        body["retry_after_s"] = retry_after
    return body


def _route_request(api: InMemoryAPIServer, log: _EventLog, method: str,
                   parts: list, query: dict, body):
    """The transport-neutral route table: returns ``(status, object)``
    or raises NotFound/Conflict for the transport to map. Both the HTTP
    handler and the stream dispatcher call THIS — one route surface,
    two framings."""
    if parts == ["healthz"]:  # analysis: disable=wire-contract -- curl/monitoring liveness probe; no package client consumes it
        return 200, {"ok": True}
    if parts == ["debug", "traces"] and method == "GET":  # analysis: disable=wire-contract -- operator debug surface (curl/Perfetto), deliberately client-less
        # this process's span ring, Perfetto-loadable
        return 200, obs.chrome_trace()
    if parts == ["debug", "profile"] and method == "GET":
        # the sampling profiler's attribution table + collapsed stacks
        return 200, obs.profile_status()
    if parts == ["metrics", "history"] and method == "GET":  # analysis: disable=wire-contract -- operator/monitoring surface (curl), deliberately client-less
        # the metrics time-series' windowed summary (counter rates,
        # windowed histogram percentiles, gauge envelopes)
        return 200, obs.metrics_history(
            window_s=float(query.get("window_s", 300.0)),
            limit=int(query.get("limit", 0)))
    if parts == ["metrics"] and method == "GET":
        # Prometheus exposition: the HTTP handler unwraps the raw-text
        # envelope into a text/plain body for scrapers; stream-wire
        # callers receive the envelope dict as-is
        return 200, {RAW_CONTENT_TYPE: "text/plain; version=0.0.4",
                     RAW_TEXT: metrics.prometheus_text()}
    if parts[:2] == ["debug", "pod"] and len(parts) == 3 \
            and method == "GET":
        return 200, obs.explain_pod(urllib.parse.unquote(parts[2]))
    if parts == ["watch"]:
        kinds = frozenset(query["kinds"].split(",")) \
            if query.get("kinds") else None
        events, seq, folded, relist = log.since(
            int(query.get("since", 0)),
            float(query.get("timeout", 10.0)),
            float(query.get("batch", 0.0)), kinds)
        out = {"events": events, "seq": seq,
               "coalesced": folded, "epoch": log.epoch}
        if relist:
            # the cursor falls outside the replayable window
            # (pre-snapshot/trimmed, or from another server life): the
            # delta stream has a gap, so tell the client to relist
            # instead of resuming silently wrong
            out["relist"] = True
        return 200, out
    if parts and parts[0] == "leases" and len(parts) == 2:
        if method == "POST":
            ok = api.acquire_lease(parts[1], body["holder"],
                                   float(body.get("ttl", 15.0)))
            return (200 if ok else 409,
                    {"holder": api.lease_holder(parts[1])})
        if method == "GET":
            return 200, {"holder": api.lease_holder(parts[1])}
        if method == "DELETE":
            api.release_lease(parts[1], query.get("holder", ""))
            return 200, {}
    if parts and parts[0] == "nodes":
        if method == "GET" and len(parts) == 1:
            return 200, {"items": api.list_nodes()}
        if method == "POST" and len(parts) == 1:
            return 201, api.create_node(body)
        if method == "GET":
            return 200, api.get_node(parts[1])
        if method == "DELETE":
            api.delete_node(parts[1])
            return 200, {}
        if method == "PATCH" and parts[2:] == ["metadata"]:
            return 200, api.patch_node_metadata(parts[1], body)
    if parts == ["podannotations"] and method == "PUT":
        api.update_pod_annotations_many(body)
        return 200, {}
    if parts and parts[0] == "pods":
        if method == "GET" and len(parts) == 1:
            return 200, {"items": api.list_pods(
                node_name=query.get("node"),
                phase=query.get("phase"),
                bound=query.get("bound") in ("1", "true"))}
        if method == "POST" and len(parts) == 1:
            return 201, api.create_pod(body)
        if method == "GET":
            return 200, api.get_pod(parts[1])
        if method == "DELETE":
            api.delete_pod(parts[1])
            return 200, {}
        if method == "PUT" and parts[2:] == ["annotations"]:
            return 200, api.update_pod_annotations(parts[1], body)
        if method == "POST" and parts[2:] == ["bind"]:
            api.bind_pod(parts[1], body["node"])
            return 200, {}
    if parts == ["bindmany"] and method == "POST":
        api.bind_many(body["bindings"], body.get("annotations") or {})
        return 200, {}
    for kind, create, get_, list_, delete in (
            ("pvcs", api.create_pvc, api.get_pvc, api.list_pvcs,
             api.delete_pvc),
            ("pvs", api.create_pv, api.get_pv, api.list_pvs,
             api.delete_pv)):
        if parts and parts[0] == kind:
            if method == "GET" and len(parts) == 1:
                return 200, {"items": list_()}
            if method == "POST" and len(parts) == 1:
                return 201, create(body)
            if method == "GET" and len(parts) == 2:
                return 200, get_(parts[1])
            if method == "DELETE" and len(parts) == 2:
                delete(parts[1])
                return 200, {}
    if parts == ["bindvolume"] and method == "POST":
        api.bind_volume(body["pv"], body["pvc"])
        return 200, {}
    if parts and parts[0] == "quotas":
        if method == "GET" and len(parts) == 1:
            return 200, {"items": api.list_quotas()}
        if method == "PUT" and len(parts) == 2:
            return 200, api.set_quota(parts[1], body)
        if method == "DELETE" and len(parts) == 2:
            api.delete_quota(parts[1])
            return 200, {}
    if parts and parts[0] == "pdbs":
        if method == "GET" and len(parts) == 1:
            return 200, {"items": api.list_pdbs()}
        if method == "POST" and len(parts) == 1:
            return 201, api.create_pdb(body)
        if method == "DELETE" and len(parts) == 2:
            api.delete_pdb(parts[1])
            return 200, {}
    for kind, create, list_, delete in (
            ("services", api.create_service, api.list_services,
             api.delete_service),
            ("rcs", api.create_rc, api.list_rcs, api.delete_rc),
            ("rss", api.create_rs, api.list_rss, api.delete_rs),
            ("statefulsets", api.create_statefulset,
             api.list_statefulsets, api.delete_statefulset)):
        if parts and parts[0] == kind:
            if method == "GET" and len(parts) == 1:
                return 200, {"items": list_()}
            if method == "POST" and len(parts) == 1:
                return 201, create(body)
            if method == "DELETE" and len(parts) == 2:
                delete(parts[1])
                return 200, {}
    if parts == ["events"]:
        if method == "GET":
            return 200, {"items": api.list_events(
                involved_name=query.get("involved"))}
        if method == "POST":
            if isinstance(body, list):  # batched form
                api.record_events(body)
                return 200, {}
            return 201, api.record_event(
                body.get("kind", "Pod"), body["name"],
                body.get("type", "Normal"), body["reason"],
                body.get("message", ""))
    return 404, {"error": f"no route {method} /{'/'.join(parts)}"}


def serve_api(api: InMemoryAPIServer, host: str = "127.0.0.1", port: int = 0,
              wal=None, stream_wire: bool = True,
              apf: "APFDispatcher | None" = None):
    """Start serving; returns (ThreadingHTTPServer, base_url). The server
    runs on a daemon thread; ``server.shutdown()`` stops it COMPLETELY —
    live connections severed, the stream fan-out joined, the WAL handle
    closed, and the listening port released (a further
    ``server_close()`` is a harmless no-op). With ``wal``
    (a ``cluster.wal.WriteAheadLog``), the apiserver's state and watch
    log are recovered from disk before the first request is served, and
    every subsequent event is logged write-ahead — watch resume
    (``since=seq``) survives a crash. ``stream_wire=False`` refuses the
    ``kgtpu-stream`` upgrade (clients negotiate down to JSON). With
    ``apf`` (a ``cluster.apf.APFDispatcher``), every request on BOTH
    wires passes the priority-&-fairness front door before it reaches
    the route table: system traffic is exempt, tenant flows queue
    fairly, and shed work gets a typed 429 / REJECT frame carrying
    retry-after."""
    log = _EventLog(api, wal=wal)

    def _dispatch(method: str, parts: list, query: dict, body,
                  peer: str):
        """The ONE admission + routing path both wires share: a change
        to how requests pass the front door lands here once, or the
        wires drift."""
        if apf is not None:
            with apf.admit(method, parts, query, body, peer=peer):
                return _route_request(api, log, method, parts, query,
                                      body)
        return _route_request(api, log, method, parts, query, body)

    return _serve_transport(_dispatch, log, host=host, port=port,
                            stream_wire=stream_wire, wal=wal)


def _serve_transport(dispatch, log: _EventLog, host: str = "127.0.0.1",
                     port: int = 0, stream_wire: bool = True, wal=None,
                     on_subscribe=None, role: str = "apiserver"):
    """The transport half of :func:`serve_api`, over any admission and
    routing callable ``dispatch(method, parts, query, body, peer)``, so
    that a watch-cache proxy serves the same dual-wire surface (the same
    framing, typed-error-to-status mapping and REJECT flow control) over
    its own dispatch. ``on_subscribe(since)`` runs before a stream SUB
    registers (a proxy backfills a cursor below its floor there);
    ``role`` labels ``api_requests_total{server}``, counted once a
    request. Returns ``(server, base_url)``; the server exposes its event
    log as ``server.event_log``."""

    def _dispatch(method: str, parts: list, query: dict, body,
                  peer: str):
        metrics.API_REQUESTS.labels(role).inc()
        return dispatch(method, parts, query, body, peer)

    class Handler(BaseHTTPRequestHandler):
        # HTTP/1.1 so keep-alive works: every _send sets Content-Length,
        # which is what lets the connection persist across requests — a
        # fresh TCP handshake per API call was the single largest fixed
        # cost on the transport bench. Nagle off: small JSON replies must
        # not wait out a delayed-ACK window.
        protocol_version = "HTTP/1.1"
        disable_nagle_algorithm = True

        def setup(self):
            super().setup()
            self.server._track_connection(self.connection)

        def finish(self):
            self.server._untrack_connection(self.connection)
            super().finish()

        def log_message(self, *args):  # quiet
            pass

        def _body(self):
            n = int(self.headers.get("Content-Length") or 0)
            return json.loads(self.rfile.read(n).decode()) if n else {}

        def _send(self, code: int, obj=None):
            content_type = "application/json"
            if isinstance(obj, dict) and RAW_CONTENT_TYPE in obj:
                content_type = obj[RAW_CONTENT_TYPE]
                data = str(obj.get(RAW_TEXT, "")).encode()
            else:
                data = json.dumps(obj if obj is not None else {}).encode()
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def _route(self, method: str):
            parts, query = _split_path(self.path)
            try:
                body = self._body()
                # re-install the caller's span context (if any) so the
                # arbiter's and WAL's spans continue the caller's trace
                # across the process boundary
                with obs.remote_context(self.headers.get(obs.TRACE_HEADER)):
                    status, obj = _dispatch(method, parts, query, body,
                                            self.client_address[0])
                self._send(status, obj)
            except TooManyRequests as e:
                self._send(429, _error_body(e))
            except QuotaExceeded as e:
                self._send(403, _error_body(e))
            except NotFound as e:
                self._send(404, _error_body(e))
            except Conflict as e:
                self._send(409, _error_body(e))
            except (BrokenPipeError, ConnectionResetError):
                # client hung up mid-reply (e.g. a watcher killed during
                # its long-poll); there is nobody left to answer
                pass
            except Exception as e:  # noqa: BLE001
                try:
                    self._send(500, {"error": f"{type(e).__name__}: {e}"})
                except (BrokenPipeError, ConnectionResetError):
                    pass

        def _serve_stream(self):
            """Switch this connection to the framed stream wire and
            serve it until the peer goes away (or poisons the stream).
            Runs in this connection's handler thread: requests dispatch
            through the SAME route table as HTTP, responses and watch
            pushes interleave under a per-connection write lock."""
            self.send_response(101, "Switching Protocols")
            self.send_header("Upgrade", stream.UPGRADE_TOKEN)
            self.send_header("Connection", "Upgrade")
            self.end_headers()
            self.wfile.flush()
            conn = self.connection
            wlock = threading.Lock()
            sub = None
            slog = logging.getLogger(__name__)
            try:
                while True:
                    if sub is not None and not select.select(
                            [conn], [], [], _SUB_IDLE_S)[0]:
                        # a subscribed connection is a push channel: the
                        # client sends nothing after SUB but its EOF. The
                        # socket's timeout (set below) bounds the pushes'
                        # sends; a read that hit it would leave the
                        # buffered reader unusable and sever an idle
                        # watch, so the read waits here instead
                        continue
                    ftype, rid, payload = stream.read_frame(self.rfile)
                    if ftype == stream.PING:
                        continue
                    if ftype == stream.SUB:
                        if sub is not None:
                            raise stream.FrameError(
                                "duplicate subscription on one "
                                "connection")
                        args = codec.decode_value(payload)
                        if not isinstance(args, dict):
                            raise stream.FrameError(
                                "malformed subscribe frame")
                        kinds = args.get("kinds")
                        since = int(args.get("since") or 0)
                        if on_subscribe is not None:
                            # a cursor below this log's floor may be
                            # replayable from a deeper upstream window:
                            # backfill BEFORE registering, so the
                            # subscriber resumes seq-exact
                            try:
                                on_subscribe(since)
                            except Exception:
                                slog.warning(
                                    "subscribe backfill from upstream "
                                    "failed; the pump will relist",
                                    exc_info=True)
                        # ack BEFORE registering: once the subscriber is
                        # in the fan-out, the pump may push immediately,
                        # and a PUSH must never overtake the ack on this
                        # connection (the client reads the ack first)
                        stream.send_frame(
                            conn, wlock, stream.RESP, rid,
                            codec.encode_response(
                                200, {"seq": log.seq(),
                                      "epoch": log.epoch}))
                        # bound every subsequent push send (a wedged
                        # consumer costs the fan-out one capped send,
                        # then is severed) — also caps this reader's
                        # idle blocking, handled above
                        conn.settimeout(10.0)

                        def sever(c=conn):
                            # a severed subscriber's client must notice
                            # NOW, not at its read timeout: kill the
                            # socket so reconnect + seq-exact resume
                            # engage immediately
                            try:
                                c.shutdown(socket.SHUT_RDWR)
                            except OSError:
                                pass
                            try:
                                c.close()
                            except OSError:
                                pass

                        sub = log.add_stream_subscriber(
                            send=lambda data: stream.send_raw(
                                conn, wlock, data),
                            since=since,
                            kinds=tuple(kinds) if kinds else None,
                            batch_s=float(args.get("batch") or 0.0),
                            on_dead=sever)
                        continue
                    if ftype != stream.REQ:
                        raise stream.FrameError(
                            f"unexpected frame type {ftype}")
                    t0 = time.perf_counter()
                    method, path, body, trace = codec.decode_request(
                        payload)
                    metrics.FRAME_DECODE_MS.observe(
                        (time.perf_counter() - t0) * 1e3)
                    parts, query = _split_path(path)
                    try:
                        with obs.remote_context(trace):
                            status, obj = _dispatch(
                                method, parts, query, body,
                                self.client_address[0])
                    except TooManyRequests as e:
                        # flow control is a first-class frame, not a
                        # response: the 429 body (with retry_after_s)
                        # rides a REJECT echoing the request id
                        status, obj = 429, _error_body(e)
                        stream.send_frame(conn, wlock, stream.REJECT,
                                          rid,
                                          codec.encode_response(status,
                                                                obj))
                        continue
                    except QuotaExceeded as e:
                        status, obj = 403, _error_body(e)
                    except NotFound as e:
                        status, obj = 404, _error_body(e)
                    except Conflict as e:
                        status, obj = 409, _error_body(e)
                    except Exception as e:  # noqa: BLE001
                        status, obj = 500, \
                            {"error": f"{type(e).__name__}: {e}"}
                    t0 = time.perf_counter()
                    data = codec.encode_response(status, obj)
                    metrics.FRAME_ENCODE_MS.observe(
                        (time.perf_counter() - t0) * 1e3)
                    stream.send_frame(conn, wlock, stream.RESP, rid,
                                      data)
            except stream.StreamClosed:
                pass
            except (stream.FrameError, codec.CodecError) as e:
                # hostile/torn frame: THIS connection is poisoned and
                # dies; the server and every other connection carry on
                slog.warning("stream connection poisoned: %s", e)
                log.note_fault("poisoned")
            except (ConnectionError, OSError, ValueError):
                # the peer vanished, or shutdown or a severed subscriber
                # closed the socket (select refuses a closed one)
                pass
            finally:
                if sub is not None:
                    log.remove_stream_subscriber(sub)
                self.close_connection = True

        def do_GET(self):
            if self.path == stream.UPGRADE_PATH and \
                    (self.headers.get("Upgrade") or "").lower() == \
                    stream.UPGRADE_TOKEN:
                if stream_wire:
                    return self._serve_stream()
                log.note_fault("refused")
            self._route("GET")

        def do_POST(self):
            self._route("POST")

        def do_PUT(self):
            self._route("PUT")

        def do_PATCH(self):
            self._route("PATCH")

        def do_DELETE(self):
            self._route("DELETE")

    class Server(ThreadingHTTPServer):
        # handler threads must die with the process, and shutdown() must
        # sever live keep-alive connections: without that, a "restarted"
        # apiserver leaves ghost handler threads still serving the OLD
        # state to clients whose sockets never broke — the exact failure
        # a real process death cannot produce. Killing the sockets is
        # what makes restart observable (clients reconnect, and the
        # watch-resume / relist contract actually engages).
        daemon_threads = True

        def __init__(self, *args, **kwargs):
            self._client_conns: set = set()
            self._conn_lock = threading.Lock()
            super().__init__(*args, **kwargs)

        def _track_connection(self, conn) -> None:
            with self._conn_lock:
                self._client_conns.add(conn)

        def _untrack_connection(self, conn) -> None:
            with self._conn_lock:
                self._client_conns.discard(conn)

        def handle_error(self, request, client_address):
            pass  # severed-socket tracebacks are expected on shutdown

        def shutdown(self):
            super().shutdown()
            # stream-wire fan-out first: the pump and per-subscriber
            # writer threads must stop offering frames to sockets the
            # loop below is about to sever
            log.stop_stream()
            with self._conn_lock:
                conns = list(self._client_conns)
                self._client_conns.clear()
            for conn in conns:
                try:
                    # SHUT_RDWR first: close() alone does not wake a
                    # handler thread blocked in recv() on this socket
                    conn.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
                try:
                    conn.close()
                except OSError:
                    pass
            if wal is not None:
                # every mutator path is severed above; a "stopped"
                # apiserver must not keep its WAL file handle open
                # (apiserver_main also closes on its own exit path —
                # close() is idempotent — but tests and chaos restarts
                # call shutdown() directly and used to leak it)
                wal.close()
            # ...nor its port: serve_forever has returned by the time
            # super().shutdown() comes back, so releasing the listening
            # socket here is safe, and a second server_close() from a
            # caller following the old two-step contract is a no-op
            self.server_close()

    server = Server((host, port), Handler)
    # the log is closure state for the handlers; tests and the fan-out
    # bench need it by name (encode-once accounting, fake subscribers)
    server.event_log = log
    threading.Thread(target=server.serve_forever, daemon=True,
                     name=f"{role}-http").start()
    return server, f"http://{host}:{server.server_address[1]}"


class HTTPAPIClient:
    """The API server at ``base_url``, over the JSON or the stream wire.
    ``watch_batch_s`` is the server's linger per watch window (fuller,
    more coalesced batches for a later first event); ``watch_kinds``
    narrows the watch to those object kinds on the server (None: every
    kind). ``transport_label`` names the wire this client's bytes count
    under in ``transport_bytes_total{wire}`` (a proxy's upstream client
    passes ``stream.WIRE_PROXY``; None: the wire in effect)."""

    IDEMPOTENT_METHODS = frozenset({"GET", "PUT", "PATCH", "DELETE"})
    RETRY_ATTEMPTS = 3
    RETRY_BASE_S = 0.05
    RETRY_CAP_S = 0.5

    def __init__(self, base_url: str, timeout: float = 30.0,
                 wire: str = stream.WIRE_JSON, watch_batch_s: float = 0.0,
                 watch_kinds: tuple | None = None,
                 transport_label: str | None = None):
        if wire not in (stream.WIRE_JSON, stream.WIRE_STREAM):
            raise ValueError(f"unknown wire {wire!r}")
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout
        self.transport_label = transport_label
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
        # racer: single-writer -- threading.local: each thread writes
        # only its own slot by construction
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
            label = self.transport_label or stream.WIRE_JSON
            metrics.TRANSPORT_BYTES.labels(label, "tx").inc(
                len(data) if data else 0)
            metrics.TRANSPORT_BYTES.labels(label, "rx").inc(len(payload))
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
            conn = stream.StreamConn.connect(self.base_url, timeout,
                                             label=self.transport_label)
            with self._conn_lock:
                closed = self._stop.is_set()
                if not closed:
                    self._stream_conns.add(conn)
            if closed:
                # close() swept before this dial registered: never keep it
                conn.close()
                raise ConnectionError("client is closed")
            self._local.stream = conn
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
                # racer: single-writer -- one-way latch: every racing
                # writer stores the same constant, atomically under the GIL
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

    def _count_retry(self) -> None:
        """Count one transport retry, guarded: every thread with a
        keep-alive connection funnels through this counter, and an
        unguarded ``+=`` from N concurrent retriers loses updates."""
        probe("httpapi.count_retry")
        with self._conn_lock:
            self.retry_count += 1

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
                self._count_retry()
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

    def forward(self, method: str, path: str, body=None, timeout=None):
        """A hop-transparent round trip: the raw ``(status, document)``
        for any status. Typed errors are not raised and a 429's advice is
        not waited out here (a watch-cache proxy re-raises them itself, so
        its own transport maps them to the same status and body); a
        transport fault retries as in `_req`, idempotent verbs only."""
        attempts = self.RETRY_ATTEMPTS \
            if method in self.IDEMPOTENT_METHODS else 1
        for attempt in range(attempts):
            try:
                return self._wire_roundtrip(method, path, body,
                                            timeout or self.timeout)
            except (http.client.HTTPException, OSError):
                if attempt + 1 >= attempts:
                    raise
                self._count_retry()
                self._stop.wait(self._backoff(attempt)
                                * (0.5 + random.random() / 2.0))

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

    def create_pdb(self, pdb: dict) -> dict:
        return self._req("POST", "/pdbs", pdb)

    def list_pdbs(self) -> list:
        return self._req("GET", "/pdbs")["items"]

    def delete_pdb(self, name: str) -> dict:
        return self._req("DELETE", f"/pdbs/{name}")

    # -- selector owners (SelectorSpreadPriority's listers) ------------------

    def create_service(self, svc: dict) -> dict:
        return self._req("POST", "/services", svc)

    def list_services(self) -> list:
        return self._req("GET", "/services")["items"]

    def delete_service(self, name: str) -> dict:
        return self._req("DELETE", f"/services/{name}")

    def create_rc(self, rc: dict) -> dict:
        return self._req("POST", "/rcs", rc)

    def list_rcs(self) -> list:
        return self._req("GET", "/rcs")["items"]

    def delete_rc(self, name: str) -> dict:
        return self._req("DELETE", f"/rcs/{name}")

    def create_rs(self, rs: dict) -> dict:
        return self._req("POST", "/rss", rs)

    def list_rss(self) -> list:
        return self._req("GET", "/rss")["items"]

    def delete_rs(self, name: str) -> dict:
        return self._req("DELETE", f"/rss/{name}")

    def create_statefulset(self, ss: dict) -> dict:
        return self._req("POST", "/statefulsets", ss)

    def list_statefulsets(self) -> list:
        return self._req("GET", "/statefulsets")["items"]

    def delete_statefulset(self, name: str) -> dict:
        return self._req("DELETE", f"/statefulsets/{name}")

    # -- persistent volumes, claims and quotas -------------------------------

    def create_pvc(self, pvc: dict) -> dict:
        return self._req("POST", "/pvcs", pvc)

    def get_pvc(self, name: str) -> dict:
        return self._req("GET", f"/pvcs/{name}")

    def list_pvcs(self) -> list:
        return self._req("GET", "/pvcs")["items"]

    def delete_pvc(self, name: str) -> dict:
        return self._req("DELETE", f"/pvcs/{name}")

    def create_pv(self, pv: dict) -> dict:
        return self._req("POST", "/pvs", pv)

    def get_pv(self, name: str) -> dict:
        return self._req("GET", f"/pvs/{name}")

    def list_pvs(self) -> list:
        return self._req("GET", "/pvs")["items"]

    def delete_pv(self, name: str) -> dict:
        return self._req("DELETE", f"/pvs/{name}")

    def bind_volume(self, pv_name: str, claim_name: str) -> dict:
        return self._req("POST", "/bindvolume",
                         {"pv": pv_name, "pvc": claim_name})

    def list_quotas(self) -> dict:
        """{tenant: quota spec and live cards created}."""
        return self._req("GET", "/quotas")["items"]

    def set_quota(self, tenant: str, spec: dict) -> dict:
        """A tenant's fair-share ``weight`` and create-time ``hard_chips``
        cap (in cards)."""
        return self._req("PUT", f"/quotas/{tenant}", spec)

    def delete_quota(self, tenant: str) -> dict:
        return self._req("DELETE", f"/quotas/{tenant}")

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
            conn = stream.StreamConn.connect(
                self.base_url, 10.0, label=self.transport_label)
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
                        max(0.0, (time.time() - ts) * 1e3))  # analysis: disable=monotonic-time -- cross-process stamp comparison, never liveness
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
