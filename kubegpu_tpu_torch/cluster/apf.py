"""The API server's front door, and the tenant identity and demand of a pod.

The port's copy of ``kubegpu_tpu/cluster/apf.py`` (upstream
kube-apiserver's API Priority and Fairness). Every request either wire
carries is classified into a priority band and a flow (`classify`): the
``system`` band (health, watch, leases, debug and metrics, node PATCHes)
is exempt, never queued and never shed; the ``controller`` and
``workload`` bands have bounded seats, shuffle-sharded queues
(`shuffle_shard`: each flow hashes to a small hand of queues and joins the
shortest) and a queue-wait deadline. Work that cannot be seated in time
is shed with a typed `TooManyRequests` carrying ``retry_after_s``: HTTP
429 on the JSON wire, a ``REJECT`` frame on the stream wire
(`APFDispatcher.admit`, which ``cluster/httpapi.py`` wraps around its route
table).

The pod-side helpers are what the engine's fair-share gate
(``scheduler/quota.py``) and the API server's hard cap read. A pod
belongs to the tenant its ``kgtpu.io/tenant`` label names (or ``tenant``,
or the annotation of the same key); a pod with neither belongs to no
tenant and passes every quota untouched. Its demand is counted in GPU
cards and in core-resource CPU, the two dimensions of dominant-resource
fairness.
"""

from __future__ import annotations

import hashlib
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Dict, Iterator, List, Tuple

from kubegpu_tpu_torch import metrics
from kubegpu_tpu_torch.analysis.explore import probe
from kubegpu_tpu_torch.core import codec, grammar

# Tenant identity on pod objects: a label (primary) or annotation
# (fallback), under the JAX package's keys so both read one wire.
TENANT_LABEL = "kgtpu.io/tenant"
TENANT_ANNOTATION = "kgtpu.io/tenant"

BAND_SYSTEM = "system"
BAND_CONTROLLER = "controller"
BAND_WORKLOAD = "workload"

# First path segments that are system traffic regardless of verb:
# health, watch long-polls, lease acquire/renew/release, debug and
# metrics/profiling surfaces (observability must survive the floods it
# exists to explain).
_SYSTEM_SEGMENTS = frozenset({"healthz", "watch", "leases", "debug",
                              "metrics"})
# Control-loop write surfaces (scheduler binders, lifecycle, advertiser
# node registration, volume controllers, quota admin): above tenant
# workload, below system.
_CONTROLLER_SEGMENTS = frozenset({
    "bindmany", "podannotations", "bindvolume", "events", "nodes",
    "pvcs", "pvs", "pdbs", "quotas", "services", "rcs", "rss",
    "statefulsets"})


class TooManyRequests(RuntimeError):
    """Typed flow-control rejection: the request's band could not seat
    it within its queue-wait deadline (or its queue overflowed).
    ``retry_after_s`` is the server's advised backoff — mapped to HTTP
    429 on the JSON wire and a REJECT frame on the stream wire, and
    reconstructed typed by the client, whose idempotent-retry policy
    honors the advice. ``per_pod`` mirrors the NotFound/Conflict detail
    contract (empty here, but the error-body shape is shared)."""

    def __init__(self, message: str = "",
                 per_pod: "dict | None" = None,
                 retry_after_s: float = 0.0) -> None:
        super().__init__(message)
        self.per_pod = dict(per_pod or {})
        self.retry_after_s = float(retry_after_s)


def tenant_of_pod(pod: dict | None) -> str | None:
    """The tenant a pod object belongs to (label first, annotation as
    fallback), or None for untenanted/system pods."""
    if not isinstance(pod, dict):
        return None
    meta = pod.get("metadata") or {}
    labels = meta.get("labels") or {}
    tenant = labels.get(TENANT_LABEL) or labels.get("tenant")
    if tenant:
        return str(tenant)
    ann = meta.get("annotations") or {}
    tenant = ann.get(TENANT_ANNOTATION)
    return str(tenant) if tenant else None


def pod_chip_request(pod: dict | None) -> int:
    """GPU cards a pod asks for — the quantity tenant fair share is
    measured in: each running container's ``alpha.gpu/numgpu``, or, where
    a container gives none, its count of per-card
    ``.../gpu/<UUID>/cards`` leaf requests."""
    if not isinstance(pod, dict):
        return 0
    try:
        pi = codec.kube_pod_to_pod_info(pod, invalidate_existing=False)
    except (TypeError, ValueError, KeyError):
        return 0
    total = 0
    for cont in pi.running_containers.values():
        n = int(cont.requests.get(grammar.RESOURCE_NUM_GPU, 0) or 0)
        if n == 0:
            n = sum(1 for res in cont.requests
                    if grammar.gpu_id_from_path(str(res)) is not None)
        total += n
    return total


def pod_cpu_request(pod: dict | None) -> float:
    """Core-resource CPU a pod requests (DRF's second dimension)."""
    if not isinstance(pod, dict):
        return 0.0
    total = 0.0
    for cont in (pod.get("spec") or {}).get("containers") or []:
        req = ((cont.get("resources") or {}).get("requests") or {})
        raw = req.get("cpu")
        if raw is None:
            continue
        try:
            total += float(codec.parse_quantity(raw))
        except (TypeError, ValueError):
            continue
    return total


def classify(method: str, parts: List[str],
             query: "dict | None" = None, body: object = None,
             peer: str = "") -> Tuple[str, str]:
    """``(band, flow)`` for one request. Tenant identity comes from the
    pod body when one rides the request, else the client's peer
    identity — so an abusive tenant's CREATES (the floodable verb)
    land in its own flow even when every client shares one ingress
    host; body-less verbs flow by peer, the finest identity this
    unauthenticated wire carries."""
    seg = parts[0] if parts else ""
    if seg in _SYSTEM_SEGMENTS:
        return BAND_SYSTEM, BAND_SYSTEM
    if seg == "nodes" and method == "PATCH":
        # heartbeat/inventory re-patches: the liveness signal the node
        # lifecycle controller ages — starving it evicts healthy nodes
        return BAND_SYSTEM, BAND_SYSTEM
    if seg == "pods" and len(parts) >= 3 and \
            parts[2] in ("bind", "annotations"):
        # bind subresource + allocation stamps: the scheduler's commit
        # path — workload floods must not starve the thing that drains
        # the workload
        return BAND_CONTROLLER, peer or BAND_CONTROLLER
    if seg in _CONTROLLER_SEGMENTS:
        return BAND_CONTROLLER, peer or BAND_CONTROLLER
    tenant = tenant_of_pod(body) if seg == "pods" else None
    return BAND_WORKLOAD, tenant or peer or "anon"


def shuffle_shard(band: str, flow: str, queues: int,
                  hand: int) -> Tuple[int, ...]:
    """The flow's deterministic hand of queue indexes: ``hand`` distinct
    queues dealt from ``queues`` by consuming a SHA-1 of ``(band,
    flow)`` — stable across processes and runs (never Python's seeded
    ``hash``), so tests, replicas, and restarts all agree which queues
    a flow may use."""
    hand = max(1, min(hand, queues))
    value = int.from_bytes(
        hashlib.sha1(f"{band}\x00{flow}".encode()).digest(), "big")
    avail = list(range(queues))
    out: List[int] = []
    for i in range(hand):
        value, pick = divmod(value, queues - i)
        out.append(avail.pop(pick))
    return tuple(out)


class BandConfig:
    """One band's dispatch envelope. ``exempt`` bands bypass queuing
    entirely (the system band); for the rest: ``seats`` bounds
    concurrent execution, ``queues``/``queue_len`` bound waiting work,
    ``hand`` is the shuffle-shard hand size, and ``queue_wait_s`` is
    how long a request may wait for a seat before it is rejected with
    retry-after."""

    def __init__(self, seats: int = 8, queues: int = 16,
                 queue_len: int = 64, queue_wait_s: float = 1.0,
                 hand: int = 4, exempt: bool = False) -> None:
        self.seats = int(seats)
        self.queues = int(queues)
        self.queue_len = int(queue_len)
        self.queue_wait_s = float(queue_wait_s)
        self.hand = int(hand)
        self.exempt = bool(exempt)


def default_bands() -> Dict[str, BandConfig]:
    """The shipped band envelope: system exempt; the controller band
    wide and patient (control loops must converge, not bounce); the
    workload band — the floodable one — tightly bounded."""
    return {
        BAND_SYSTEM: BandConfig(exempt=True),
        BAND_CONTROLLER: BandConfig(seats=16, queues=8, queue_len=256,
                                    queue_wait_s=5.0, hand=4),
        BAND_WORKLOAD: BandConfig(seats=8, queues=16, queue_len=64,
                                  queue_wait_s=1.0, hand=4),
    }


class _Waiter:
    """One queued request. ``admitted`` is flipped by the releasing
    thread (seat handoff) under the band lock."""

    __slots__ = ("admitted",)

    def __init__(self) -> None:
        self.admitted = False


class _Band:
    """Runtime state of one non-exempt band: a monitor (every field
    below is guarded by ``lock``)."""

    def __init__(self, name: str, cfg: BandConfig) -> None:
        self.name = name
        self.cfg = cfg
        self.lock = threading.Condition()
        self.in_use = 0       # seats currently executing
        self.queued = 0       # waiters across all queues
        self.queues: List[deque] = [deque() for _ in range(cfg.queues)]
        self.rr = 0           # round-robin drain cursor


class APFDispatcher:
    """The front door: classify, queue fairly, bound concurrency,
    reject with retry-after. One instance serves both wire framings of
    one apiserver (``serve_api(..., apf=APFDispatcher())``)."""

    def __init__(self,
                 bands: "Dict[str, BandConfig] | None" = None) -> None:
        cfgs = dict(default_bands())
        cfgs.update(bands or {})
        self._configs = cfgs
        self._bands: Dict[str, _Band] = {
            name: _Band(name, cfg) for name, cfg in cfgs.items()
            if not cfg.exempt}

    def inflight(self, band: str) -> Tuple[int, int]:
        """(executing, queued) for one band — observability + tests."""
        b = self._bands.get(band)
        if b is None:
            return 0, 0
        with b.lock:
            return b.in_use, b.queued

    @contextmanager
    def admit(self, method: str, parts: List[str],
              query: "dict | None" = None, body: object = None,
              peer: str = "") -> Iterator[str]:
        """Gate one request: classify, then hold a seat for the body of
        the ``with``. Raises :class:`TooManyRequests` instead of
        yielding when the band cannot seat the request in time. Exempt
        bands yield immediately — system traffic is never queued."""
        band, flow = classify(method, parts, query, body, peer)
        cfg = self._configs.get(band)
        if cfg is None or cfg.exempt:
            yield band
            return
        wait_s = self._acquire(band, flow)
        metrics.APF_QUEUE_WAIT_MS.observe(wait_s * 1e3)
        try:
            yield band
        finally:
            self._release(band)

    # ---- seat mechanics ----------------------------------------------------

    def _acquire(self, band: str, flow: str) -> float:
        """Take a seat in ``band`` for ``flow``; returns the queue wait
        in seconds. Raises :class:`TooManyRequests` on queue overflow
        or deadline expiry."""
        b = self._bands[band]
        cfg = b.cfg
        with b.lock:
            probe("apf.admit")
            if b.in_use < cfg.seats and b.queued == 0:
                b.in_use += 1
                return 0.0
            hand = shuffle_shard(band, flow, cfg.queues, cfg.hand)
            qi = min(hand, key=lambda i: len(b.queues[i]))
            if len(b.queues[qi]) >= cfg.queue_len:
                # a flow this far behind will not be served by buffering
                # more of it; shed now, with honest advice
                self._reject_locked(b, flow, "queue full")
            waiter = _Waiter()
            b.queues[qi].append(waiter)
            b.queued += 1
            probe("apf.enqueue")
            t0 = time.monotonic()
            deadline = t0 + cfg.queue_wait_s
            while not waiter.admitted:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                b.lock.wait(remaining)
            if waiter.admitted:
                # the releasing thread handed us its seat (in_use was
                # transferred, never decremented)
                return time.monotonic() - t0
            b.queues[qi].remove(waiter)
            b.queued -= 1
            self._reject_locked(b, flow, "queue-wait deadline exceeded")
            raise AssertionError("unreachable")  # _reject_locked raises

    def _reject_locked(self, b: _Band, flow: str, why: str) -> None:
        probe("apf.reject")
        metrics.APF_REJECTS.labels(b.name).inc()
        raise TooManyRequests(
            f"{b.name} band over capacity for flow {flow!r} ({why}: "
            f"{b.in_use}/{b.cfg.seats} seats, {b.queued} queued)",
            retry_after_s=round(b.cfg.queue_wait_s, 3))

    def _release(self, band: str) -> None:
        """Give the seat back — or hand it directly to the next queued
        waiter, drained round-robin ACROSS queues so one deep queue
        (the abusive flow's hand) cannot monopolize freed seats."""
        b = self._bands[band]
        with b.lock:
            probe("apf.release")
            for k in range(len(b.queues)):
                qi = (b.rr + k) % len(b.queues)
                if b.queues[qi]:
                    waiter = b.queues[qi].popleft()
                    b.queued -= 1
                    waiter.admitted = True
                    b.rr = (qi + 1) % len(b.queues)
                    b.lock.notify_all()
                    return
            b.in_use -= 1
            b.lock.notify_all()
