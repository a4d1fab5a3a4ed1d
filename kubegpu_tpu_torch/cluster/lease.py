"""Lease-based coordination of scheduler replicas (the port's copy of
``kubegpu_tpu/cluster/lease.py``).

Three pieces, layered:

``LeaseTable``
    TTL leases with steal-on-expiry, the server-side primitive. A lease is
    (name, holder, expiry); ``acquire`` renews for the current holder,
    grants a vacant or expired lease to anyone, and refuses an unexpired
    lease held by someone else.

``Elector``
    One replica's view of one lease: acquire and lead, renew at an
    interval, demote on a real denial or once the lease could have
    expired (`cmd/app/server.go:396-403,437-461` of the reference). A
    transient transport error at renewal neither crashes the replica nor
    demotes a leader whose lease is still within its TTL: nobody else can
    take it before the TTL lapses.

``ShardCoordinator``
    N scheduler replicas each own one shard of the pod queue (by pod-name
    hash, ``shard_of``) and hold that shard's lease. A replica also
    processes any shard whose lease has no holder (its replica is dead or
    partitioned), and stops the moment the owner's renewals resume. Two
    replicas briefly processing one shard during a hand-over is safe: the
    API server's arbiter refuses the loser's commit and the binder's
    forget-and-requeue path absorbs it.

``shard_of`` is CRC32 of the pod name, equal to the JAX package's for
every name, so a fleet that mixes both packages' replicas agrees on every
pod's shard. Every clock here is monotonic.
"""

from __future__ import annotations

import logging
import threading
import time
import zlib
from typing import Callable, FrozenSet, Optional

from kubegpu_tpu_torch import metrics, obs
from kubegpu_tpu_torch.analysis.explore import probe

log = logging.getLogger(__name__)

# A lease acquire over the wire: (name, holder, ttl seconds) -> granted.
AcquireFn = Callable[[str, str, float], bool]
# A lease holder query: name -> current holder, or None when vacant.
HolderFn = Callable[[str], Optional[str]]

SHARD_LEASE_PREFIX = "kgtpu-sched-shard"
LIFECYCLE_LEASE = "kgtpu-lifecycle"
REPAIR_LEASE = "kgtpu-repair"


def shard_of(pod_name: str, replicas: int) -> int:
    """Stable shard assignment by pod name. CRC32, not ``hash()``:
    the mapping must agree across replica *processes* (PYTHONHASHSEED
    randomizes ``hash`` per process)."""
    if replicas <= 1:
        return 0
    return zlib.crc32(pod_name.encode("utf-8")) % replicas


class LeaseTable:
    """TTL leases for leader election / shard ownership."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        # name -> (holder, expires_at by monotonic clock)
        self._leases: dict = {}

    def acquire(self, name: str, holder: str, ttl_s: float) -> bool:
        """Grant/renew: the current holder always renews; anyone takes a
        vacant or expired lease (steal-on-expiry); an unexpired lease
        held by someone else is refused."""
        probe("lease.acquire")
        with self._lock:
            now = time.monotonic()
            current = self._leases.get(name)
            if current is not None and current[1] > now \
                    and current[0] != holder:
                return False
            self._leases[name] = (holder, now + ttl_s)
            return True

    def holder(self, name: str) -> Optional[str]:
        with self._lock:
            current = self._leases.get(name)
            if current is None or current[1] <= time.monotonic():
                return None
            return current[0]

    def release(self, name: str, holder: str) -> bool:
        """Drop the lease iff ``holder`` still holds it — a clean
        shutdown hands the shard over immediately instead of making the
        successor wait out the TTL."""
        probe("lease.release")
        with self._lock:
            current = self._leases.get(name)
            if current is None or current[0] != holder:
                return False
            del self._leases[name]
            return True


class Elector:
    """Acquire/renew one lease; promote and demote through callbacks.

    ``acquire`` is any ``AcquireFn`` — ``HTTPAPIClient.acquire_lease``,
    ``InMemoryAPIServer.acquire_lease``, or a bare ``LeaseTable.acquire``
    — so the same elector drives in-process simulations and real
    multi-process replicas. ``tick()`` performs one renewal attempt;
    ``start()`` runs ticks at ttl/3 on a daemon thread.
    """

    def __init__(self, acquire: AcquireFn, name: str, holder: str,
                 ttl_s: float,
                 on_acquire: Optional[Callable[[], None]] = None,
                 on_lose: Optional[Callable[[], None]] = None,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self.name = name
        self.holder = holder
        self.ttl_s = ttl_s
        self._acquire = acquire
        self._on_acquire = on_acquire
        self._on_lose = on_lose
        self._clock = clock
        self._lock = threading.Lock()
        self._leading = False
        self._valid_until = 0.0
        self.transitions = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    @property
    def leading(self) -> bool:
        with self._lock:
            return self._leading

    def tick(self) -> bool:
        """One renewal attempt. Stamps validity from BEFORE the round
        trip (the server's TTL starts when it grants, so counting from
        the reply would keep a leader ~one RTT past a lapse a standby
        can already take); a transient transport error keeps the leader
        leading while the last successful renewal is still within TTL."""
        asked_at = self._clock()
        granted: bool
        try:
            granted = bool(self._acquire(self.name, self.holder, self.ttl_s))
        except Exception:
            with self._lock:
                granted = self._leading and self._clock() < self._valid_until
            log.warning("lease %s: renewal transport error (%s grace)",
                        self.name, "within" if granted else "past",
                        exc_info=True)
            if granted:
                return True
        with self._lock:
            if granted:
                self._valid_until = asked_at + self.ttl_s
            was = self._leading
            self._leading = granted
        if granted and not was:
            self._count_transition()
            log.info("lease %s: %s became holder", self.name, self.holder)
            self._fire(self._on_acquire)
        elif not granted and was:
            self._count_transition()
            log.info("lease %s: %s lost the lease", self.name, self.holder)
            # losing a held lease mid-run is an anomaly worth evidence
            # (who was scheduling what when leadership moved); the
            # flight recorder is inert unless configured
            obs.FLIGHT.trigger("lease_lost", key=self.name,
                               holder=self.holder)
            self._fire(self._on_lose)
        return granted

    def _count_transition(self) -> None:
        """Count one leadership transition, guarded: ``stop()`` runs on
        the owner thread while ``tick()`` may still be finishing a
        renewal on the elector thread, and an unguarded ``+=`` between
        them loses updates."""
        probe("lease.count_transition")
        metrics.LEASE_TRANSITIONS.inc()
        with self._lock:
            self.transitions += 1

    @staticmethod
    def _fire(callback: Optional[Callable[[], None]]) -> None:
        if callback is None:
            return
        try:
            callback()
        except Exception:
            # a crashing promote/demote hook must not kill the elector
            # loop — the lease state machine is what keeps HA converging
            log.exception("elector callback failed")

    def start(self, interval_s: Optional[float] = None) -> None:
        interval = interval_s if interval_s is not None else self.ttl_s / 3.0

        def loop() -> None:
            obs.register_thread("elector")
            while not self._stop.is_set():
                try:
                    self.tick()
                except Exception:
                    log.exception("elector tick failed")
                self._stop.wait(interval)

        # racer: single-writer -- start()/stop() are owner-thread calls
        self._stop = threading.Event()
        # racer: single-writer -- stop() joins the loop before clearing
        self._thread = threading.Thread(target=loop, daemon=True,
                                        name=f"elector-{self.name}")
        self._thread.start()

    def stop(self, demote: bool = True) -> None:
        """Stop the loop. ``demote`` fires ``on_lose`` when leading —
        a clean shutdown must tear down what promotion built."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        with self._lock:
            was = self._leading
            self._leading = False
        if demote and was:
            self._count_transition()
            self._fire(self._on_lose)


class ShardCoordinator:
    """One replica's shard ownership: hold shard ``shard`` of
    ``replicas`` via its lease, and steal work from shards whose lease
    is vacant.

    ``owns(pod_name)`` is the filter the scheduler consults per pod —
    a cheap set lookup against the ownership computed by the last
    ``tick()``. Ownership changes call ``on_change`` (the scheduler
    wires this to a queue wake-up so freshly-stolen pods are retried
    immediately instead of waiting out their park delay).
    """

    def __init__(self, lease_api: object, shard: int, replicas: int,
                 holder: str, ttl_s: float = 5.0,
                 lease_prefix: str = SHARD_LEASE_PREFIX,
                 on_change: Optional[Callable[[], None]] = None) -> None:
        self.shard = shard
        self.replicas = max(1, replicas)
        self.holder = holder
        self.ttl_s = ttl_s
        self.lease_prefix = lease_prefix
        self._holder_fn: Optional[HolderFn] = \
            getattr(lease_api, "lease_holder", None)
        self._release_fn = getattr(lease_api, "release_lease", None)
        # public: the scheduler is typically built AFTER the coordinator
        # (it needs ``owns`` at construction), then wires its queue
        # wake-up in here
        self.on_change = on_change
        self._lock = threading.Lock()
        self._owned: FrozenSet[int] = frozenset()
        acquire: AcquireFn = getattr(lease_api, "acquire_lease")
        self._elector = Elector(acquire, f"{lease_prefix}-{shard}", holder,
                                ttl_s)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def lease_name(self, shard: int) -> str:
        return f"{self.lease_prefix}-{shard}"

    def owns(self, pod_name: str) -> bool:
        with self._lock:
            owned = self._owned
        return shard_of(pod_name, self.replicas) in owned

    def owned_shards(self) -> FrozenSet[int]:
        with self._lock:
            return self._owned

    def tick(self) -> FrozenSet[int]:
        """Renew the own-shard lease, then scan the other shards'
        holders: a vacant lease means its replica stopped renewing —
        steal that shard's WORK (not its lease: the moment the rightful
        owner's renewals resume, its holder reappears and the thief
        stands down, with no lease tug-of-war)."""
        owned = set()
        if self._elector.tick():
            owned.add(self.shard)
        for other in range(self.replicas):
            if other == self.shard:
                continue
            if self._holder_fn is None:
                continue
            try:
                current = self._holder_fn(self.lease_name(other))
            except Exception:
                # unknown: never steal on a blind transport — wrongly
                # assuming vacancy would double-process a live shard
                log.debug("holder query for shard %d failed; not "
                          "stealing", other, exc_info=True)
                continue
            if current is None or current == self.holder:
                owned.add(other)
        frozen = frozenset(owned)
        with self._lock:
            changed = frozen != self._owned
            self._owned = frozen
        if changed:
            log.info("shard coordinator %s: owns shards %s", self.holder,
                     sorted(frozen))
            Elector._fire(self.on_change)
        return frozen

    def start(self, interval_s: Optional[float] = None) -> None:
        interval = interval_s if interval_s is not None else self.ttl_s / 3.0

        def loop() -> None:
            obs.register_thread("elector")
            while not self._stop.is_set():
                try:
                    self.tick()
                except Exception:
                    log.exception("shard coordinator tick failed")
                self._stop.wait(interval)

        # racer: single-writer -- start()/stop() are owner-thread calls
        self._stop = threading.Event()
        # racer: single-writer -- stop() joins the loop before clearing
        self._thread = threading.Thread(target=loop, daemon=True,
                                        name=f"shard-coord-{self.shard}")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        self._elector.stop(demote=False)
        # hand the shard over immediately: a clean shutdown must not make
        # the stealing replica wait out the full TTL
        if self._release_fn is not None:
            try:
                self._release_fn(self.lease_name(self.shard), self.holder)
            except Exception:
                log.debug("shard lease release failed (successor waits "
                          "out the TTL)", exc_info=True)
        with self._lock:
            self._owned = frozenset()
