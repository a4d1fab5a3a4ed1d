"""Node lifecycle: heartbeat liveness, Ready -> Stale -> Lost, and
gang-aware eviction off Lost nodes.

The port's copy of ``kubegpu_tpu/scheduler/lifecycle.py`` for GPU nodes.
The paper's contract is that the scheduler owns placement; this module
adds the failure half of that contract. The node agent's advertiser stamps
a wall-clock heartbeat into the node annotations every pass
(`node/advertiser.py`); the ``NodeLifecycle`` controller ages those
heartbeats:

    Ready   age <  stale_after_s      normal
    Stale   age >= stale_after_s      suspect; observational only
    Lost    age >= lost_after_s       evict + (optionally) delete the node

On Lost, every pod bound to the node is evicted. Eviction is **gang
aware**: a running gang whose member sat on the lost node is stranded in
its next collective, so the WHOLE gang — surviving members included — is
failed and requeued as one unit. "Requeue" means delete-and-recreate with
the binding, the pinned cards (``allocate_from``), the gang's process
contract and the nomination stripped, but the ``alpha.gpu/*`` intent and
the gang membership kept, so the scheduler re-plans the pod-set on
surviving nodes from intent, exactly like a fresh submission. The watch
events from the deletions return every card through the scheduler cache,
and every such charge/release bumps the affected node's fit generation
(`SchedulerCache._invalidate_locked`), so eviction can never leave a stale
memoized "does not fit" verdict standing on a node whose cards it just
freed.

Nodes without a heartbeat annotation (registered out-of-band, or an older
advertiser) are exempt: liveness is simply not tracked for them.
"""

from __future__ import annotations

import copy
import logging
import threading
import time

from kubegpu_tpu_torch import metrics, obs
from kubegpu_tpu_torch.analysis.explore import probe
from kubegpu_tpu_torch.cluster.httpapi import Conflict
from kubegpu_tpu_torch.core import codec
from kubegpu_tpu_torch.scheduler.core import Scheduler
from kubegpu_tpu_torch.scheduler.gang import GANG_PROCESS_ANNOTATION, gang_key
from kubegpu_tpu_torch.utils import list_bound_pods

log = logging.getLogger(__name__)

READY = "ready"
STALE = "stale"
LOST = "lost"

DEFAULT_STALE_AFTER_S = 40.0
DEFAULT_LOST_AFTER_S = 120.0

# API writes during eviction retry a few times in-line: the controller
# runs exactly when the cluster is unhealthy, so a transient transport
# error must not strand half an eviction. The pause between attempts is
# what lets a multi-round-trip blip pass — immediate retries would all
# land inside the same outage.
_EVICT_ATTEMPTS = 3
_EVICT_BACKOFF_S = 0.05

# The repair controller's checkpoint request (the JAX package's
# ``scheduler/repair.py``, ROADMAP Queue 1, item 10.6): an eviction
# services it, so a requeued copy never carries it.
CHECKPOINT_REQUEST_ANNOTATION = "pod.alpha/CheckpointRequested"


def requeued_copy(kube_pod: dict) -> dict:
    """A fresh pending copy of a bound pod: binding, status, pinned
    cards, gang process contract, and nominated-node reservation all
    stripped; device intent (including gang membership) kept."""
    fresh = copy.deepcopy(kube_pod)
    (fresh.setdefault("spec", {})).pop("nodeName", None)
    fresh.pop("status", None)
    meta = fresh.setdefault("metadata", {})
    ann = dict(meta.get("annotations") or {})
    ann.pop(GANG_PROCESS_ANNOTATION, None)
    ann.pop(Scheduler.NOMINATED_NODE_ANNOTATION, None)
    # The checkpoint request was serviced by the eviction that produced
    # this copy; carrying it over would make the replacement checkpoint
    # itself on startup. Everything else — tenant label (DRF accounting),
    # user annotations, priority, gang membership — survives verbatim.
    ann.pop(CHECKPOINT_REQUEST_ANNOTATION, None)
    meta["annotations"] = ann
    if codec.POD_ANNOTATION_KEY in ann:
        # invalidate: allocate_from cleared, dev_requests reset to the
        # annotation's requests (alpha.gpu/* and the gang keys), node pin
        # dropped — the scheduler re-plans from intent
        # (`codec.kube_pod_to_pod_info` semantics)
        info = codec.kube_pod_to_pod_info(fresh, invalidate_existing=True)
        codec.pod_info_to_annotation(meta, info)
    return fresh


class NodeLifecycle:
    """Scheduler-side controller tracking node liveness from heartbeats.

    Talks only to the API server (any client with the
    ``InMemoryAPIServer`` surface — in-memory, HTTP, or chaos-proxied);
    the scheduler observes the resulting node/pod events through its
    ordinary informer and needs no direct coupling.
    """

    def __init__(self, api, stale_after_s: float = DEFAULT_STALE_AFTER_S,
                 lost_after_s: float = DEFAULT_LOST_AFTER_S,
                 delete_lost_nodes: bool = True, clock=None):
        self.api = api
        self.stale_after_s = stale_after_s
        self.lost_after_s = max(lost_after_s, stale_after_s)
        # Deleting the node object is what actually stops new placements
        # onto it (the scheduler cache drops it on the watch event); a
        # returning agent re-registers via --register-node. False keeps
        # the node listed (and re-evicts anything that lands there).
        self.delete_lost_nodes = delete_lost_nodes
        # Monotonic: this clock only AGES the controller's own local
        # observations (it is never compared against the advertiser's
        # wall-clock stamp — heartbeat values are compared for equality
        # only), and a wall-clock step here would age every node at once
        # and mass-evict a healthy cluster.
        self.clock = clock if clock is not None else time.monotonic
        # racer: single-writer -- tick() owns this; written on the loop
        # thread only (stop() joins the loop before reading leftovers)
        self.states: dict = {}   # node name -> READY/STALE/LOST
        # Heartbeat observations: node -> (last heartbeat VALUE, when
        # this controller first saw that value, by its own clock). Aging
        # the local observation instead of comparing wall clocks makes
        # liveness immune to cross-host clock skew — a node whose clock
        # runs minutes behind still changes its stamp every pass, and
        # that change is what proves it alive. Corollary: a fresh
        # controller must observe a heartbeat stand still for the full
        # grace period before declaring the node Lost (no mass eviction
        # on scheduler restart).
        # racer: single-writer -- tick()-thread-owned heartbeat ledger
        self._observed: dict = {}
        # Lost nodes whose eviction has not finished draining. A deleted
        # node disappears from list_nodes, so without this set a single
        # failed pod-list during its one LOST tick would strand its pods
        # bound to a nonexistent node forever.
        # racer: single-writer -- tick()-thread-owned drain set
        self._draining: set = set()
        # The pending-retry ledgers and the eviction counter are shared
        # between the tick loop and stop()'s last-chance drain — the
        # join in stop() is TIMED, so a wedged tick can still be
        # flushing while stop() drains (the racer rule's finding here):
        # every mutation holds _pending_lock, and _flush_pending_requeues
        # CLAIMS its batch under it so each replacement is created (and
        # counted) exactly once no matter how many flushers race.
        self._pending_lock = threading.Lock()
        # Evicted pods deleted from the API but whose replacement create
        # failed: the fresh copy lives only here, so it is retried every
        # tick until it lands (deleting it again can't bring it back).
        self._pending_requeue: dict = {}
        # Victims whose delete failed: pod name -> lost node. A gang
        # member widened in from a SURVIVING node is invisible to both
        # the per-lost-node drain listing and the orphan sweep (its node
        # still exists), so failed evictions are retried by name here.
        self._pending_evict: dict = {}
        # Sweep gating: orphans can only appear around node loss, so the
        # full-cluster sweep runs while loss activity is recent (plus a
        # periodic backstop) instead of on every steady-state tick.
        # racer: single-writer -- tick()-thread-owned pass counter
        self._ticks = 0
        # racer: single-writer -- tick()-thread-owned sweep gate
        self._sweep_hot = 1  # sweep on the first tick (fresh controller)
        self.evicted_total = 0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # ---- one pass ----------------------------------------------------------

    def tick(self, now: float | None = None) -> dict:
        """One liveness pass. Returns {"states": {node: state},
        "evicted": [pod names]} for tests and the chaos scenario."""
        now = self.clock() if now is None else now
        try:
            nodes = self.api.list_nodes()
        except Exception:
            log.warning("node lifecycle tick: node list failed",
                        exc_info=True)
            # the by-name flushes target pods directly and need no node
            # listing — an already-deleted pod's replacement must not
            # wait out extra ticks because an unrelated call dropped
            evicted = self._flush_pending_evicts()
            evicted.extend(self._flush_pending_requeues())
            return {"states": dict(self.states), "evicted": evicted}
        states: dict = {}
        evicted: list = []
        for node in nodes:
            name = (node.get("metadata") or {}).get("name")
            if not name:
                continue
            heartbeat = codec.annotation_to_heartbeat(
                node.get("metadata") or {})
            if heartbeat is None:
                states[name] = READY  # liveness not tracked for this node
                self._observed.pop(name, None)
                continue
            seen = self._observed.get(name)
            if seen is None or seen[0] != heartbeat:
                self._observed[name] = (heartbeat, now)
                age = 0.0
            else:
                age = now - seen[1]
            if age >= self.lost_after_s:
                state = LOST
            elif age >= self.stale_after_s:
                state = STALE
            else:
                state = READY
            states[name] = state
            prev = self.states.get(name)
            if state != prev:
                log.info("node %s: %s -> %s (heartbeat age %.1fs)",
                         name, prev or "new", state, age)
            if state == LOST:
                self._sweep_hot = 3  # binds race node deletion around loss
                if prev != LOST:
                    metrics.NODE_LOST.inc()
                    self._event(name, "NodeLost",
                                f"no heartbeat for {age:.1f}s "
                                f"(grace {self.lost_after_s:.1f}s)")
                # Delete the node BEFORE requeueing its pods: the watch
                # event drops it from the scheduler cache, so a requeued
                # gang can never be re-planned onto the dead node's cards
                # in the window between eviction and deletion. Then evict
                # on EVERY lost tick, not just the transition: with
                # delete_lost_nodes=False a pod could still bind here
                # between ticks (cheap once drained — the listing is empty).
                if self.delete_lost_nodes:
                    self._delete_node(name)
                done, drained = self._evict_node(name)
                evicted.extend(done)
                if drained:
                    self._draining.discard(name)
                else:
                    self._draining.add(name)
            elif state == READY:
                if prev in (STALE, LOST):
                    self._event(name, "NodeReady",
                                "heartbeat resumed; node is Ready again")
                # a re-registered node owns its pods again; stop draining
                self._draining.discard(name)
        # Deleted Lost nodes no longer appear in list_nodes, so their
        # eviction retries from here until the pod listing comes back
        # clean — a transient failure during the LOST tick must not be
        # the only chance those pods ever get.
        for name in sorted(self._draining - set(states)):
            done, drained = self._evict_node(name)
            evicted.extend(done)
            if drained:
                self._draining.discard(name)
        evicted.extend(self._flush_pending_evicts())
        with self._pending_lock:
            pending_flush = bool(self._pending_evict or
                                 self._pending_requeue)
        if (self._sweep_hot > 0 or self._draining or pending_flush
                or self._ticks % 10 == 0):
            self._sweep_hot = max(0, self._sweep_hot - 1)
            evicted.extend(self._sweep_orphans(set(states)))
        evicted.extend(self._flush_pending_requeues())
        self._ticks += 1
        self._observed = {k: v for k, v in self._observed.items()
                          if k in states}
        self.states = states
        metrics.NODE_READY.set(
            sum(1 for s in states.values() if s == READY))
        return {"states": states, "evicted": evicted}

    # ---- eviction ----------------------------------------------------------

    def _evict_node(self, node_name: str) -> tuple[list, bool]:
        """Evict every pod bound to ``node_name``. Returns
        ``(evicted pod names, drained)`` — drained=False means a listing
        or eviction failed and the caller must retry next tick."""
        try:
            bound = self.api.list_pods(node_name=node_name)
        except Exception:
            log.warning("eviction: pod list for %s failed", node_name,
                        exc_info=True)
            return [], False
        return self._evict_victims(
            {p["metadata"]["name"]: p for p in bound}, node_name)

    def _sweep_orphans(self, known_nodes: set) -> list:
        """Evict pods bound to nodes that no longer exist: a bind racing
        the node deletion can land AFTER the lost node drained (the bind
        subresource does not re-check node existence, same as upstream),
        and nothing else would ever reclaim such a pod."""
        try:
            # only BOUND pods can be orphans — the apiserver's node index
            # serves this slice without sweeping every pending pod
            pods = list_bound_pods(self.api)
            # Re-list nodes NOW: eviction retries above can burn hundreds
            # of ms, and a node registered (plus a pod bound to it) since
            # the tick's snapshot must not read as an orphan.
            known_nodes = known_nodes | {
                (n.get("metadata") or {}).get("name")
                for n in self.api.list_nodes()}
        except Exception:
            return []
        orphans: dict = {}
        for pod in pods:
            node = (pod.get("spec") or {}).get("nodeName")
            if node and node not in known_nodes:
                orphans.setdefault(node, {})[pod["metadata"]["name"]] = pod
        evicted = []
        for node in sorted(orphans):
            log.warning("orphan sweep: %d pod(s) bound to nonexistent "
                        "node %s", len(orphans[node]), node)
            done, _ = self._evict_victims(orphans[node], node)
            evicted.extend(done)
        return evicted

    def _evict_victims(self, victims: dict, lost_node: str) -> tuple[list, bool]:
        """Evict + requeue a victim set, widened to whole gangs: a gang
        with one member on a lost node is dead everywhere."""
        gang_ids = set()
        for pod in victims.values():
            key = gang_key(pod)
            if key is not None:
                gang_ids.add(key[0])
        if gang_ids:
            try:
                # gang widening only ever adds BOUND siblings (pending
                # members just stay queued), so the node-index slice is
                # the whole search space
                everything = list_bound_pods(self.api)
            except Exception:
                log.warning("eviction: cluster pod list failed "
                            "(gang widening for %s)", lost_node,
                            exc_info=True)
                return [], False
            for pod in everything:
                key = gang_key(pod)
                if key is not None and key[0] in gang_ids:
                    victims.setdefault(pod["metadata"]["name"], pod)
            # a node loss taking whole gangs down is exactly the class of
            # incident the flight recorder exists for: dump the span ring
            # (once per lost node) so the eviction ships with its timeline
            obs.FLIGHT.trigger("gang_eviction", key=lost_node,
                               gangs=sorted(gang_ids),
                               victims=sorted(victims))
        evicted = []
        drained = True
        for name in sorted(victims):
            status = self._evict_and_requeue(victims[name], lost_node)
            if status == "evicted":
                evicted.append(name)
                metrics.EVICTIONS.inc()
                with self._pending_lock:
                    self.evicted_total += 1
                    self._pending_evict.pop(name, None)
            elif status == "gone":
                # externally deleted: not our eviction, nothing pending
                with self._pending_lock:
                    self._pending_evict.pop(name, None)
            else:
                drained = False
                with self._pending_lock:
                    if name not in self._pending_requeue:
                        # delete failed, pod still bound: the drain
                        # listing only re-covers the LOST node, so a
                        # widened gang member on a surviving node must
                        # be retried by name
                        self._pending_evict[name] = lost_node
        return evicted, drained

    def _retry_write(self, call) -> tuple[str, bool]:
        """One API write with bounded, stop()-interruptible retries
        (stop() must not wait out a wide outage's worth of per-pod
        backoffs; an unset event wait is a plain sleep). Returns
        ``(status, ambiguous)``: status is ``"ok"``, ``"missing"`` (the
        object is not there), ``"conflict"`` (it already exists), or
        ``"failed"`` (attempts exhausted); ``ambiguous`` is True when an
        earlier attempt errored — a subsequent "missing" may then be our
        own failed-but-landed delete rather than an external actor's."""
        ambiguous = False
        for attempt in range(_EVICT_ATTEMPTS):
            try:
                call()
                return "ok", ambiguous
            except KeyError:
                return "missing", ambiguous
            except Conflict:
                return "conflict", ambiguous
            except Exception:
                ambiguous = True
                self._stop.wait(_EVICT_BACKOFF_S * (attempt + 1))
        return "failed", ambiguous

    def _evict_and_requeue(self, kube_pod: dict, lost_node: str) -> str:
        """Returns "evicted" (deleted + replacement landed), "gone"
        (externally deleted — nothing to do, nothing to count), or
        "failed" (retry next tick)."""
        name = kube_pod["metadata"]["name"]
        fresh = requeued_copy(kube_pod)
        status, ambiguous = self._retry_write(
            lambda: self.api.delete_pod(name))
        if status == "missing" and not ambiguous:
            # gone before we ever touched it: deleted externally (user
            # tore the job down) — resurrecting it as a pending copy is
            # not this controller's call, and it is no eviction either
            return "gone"
        if status in ("failed", "conflict"):
            # "conflict" is only a success for creates; a 409 on delete
            # (precondition/resourceVersion against a real API server)
            # means the pod is still there — retry next tick
            log.warning("eviction: could not delete pod %s (%s); "
                        "retrying next tick", name, status)
            return "failed"
        # "ok" — or "missing" because our own errored delete landed
        # only now is the pod actually off the API — an event stamped
        # earlier (or re-stamped per retry tick) would report evictions
        # that never happened
        self._event(name, "Evicted",
                    f"node {lost_node} lost; requeued for rescheduling",
                    kind="Pod", event_type="Warning")
        if self._create_requeued(name, fresh):
            return "evicted"
        # the pod is deleted and its replacement exists only in memory
        # now: park it for per-tick retry rather than dropping it
        with self._pending_lock:
            self._pending_requeue[name] = fresh
        log.warning("eviction: pod %s deleted but re-create failed; "
                    "parked for retry", name)
        return "failed"

    def _create_requeued(self, name: str, fresh: dict) -> bool:
        status, _ = self._retry_write(lambda: self.api.create_pod(fresh))
        # "conflict" = a duplicate/earlier create already landed
        return status in ("ok", "conflict")

    def _flush_pending_evicts(self) -> list:
        """Retry victims whose delete failed. The per-node drain listing
        only re-covers the LOST node, so a gang member widened in from a
        surviving node (whose own node never drains) lands here. The
        ledger is snapshotted, and every mutation holds the pending
        lock (API round trips stay outside it)."""
        landed = []
        with self._pending_lock:
            pending = dict(self._pending_evict)
        for name in sorted(pending):
            lost_node = pending[name]
            try:
                pod = self.api.get_pod(name)
            except KeyError:
                with self._pending_lock:
                    self._pending_evict.pop(name, None)  # already gone
                continue
            except Exception:
                log.debug("pending evict: get_pod(%s) failed; retrying "
                          "next tick", name, exc_info=True)
                continue
            if not (pod.get("spec") or {}).get("nodeName"):
                with self._pending_lock:
                    self._pending_evict.pop(name, None)  # already pending
                continue
            status = self._evict_and_requeue(pod, lost_node)
            if status == "evicted":
                landed.append(name)
                metrics.EVICTIONS.inc()
                with self._pending_lock:
                    self.evicted_total += 1
                    self._pending_evict.pop(name, None)
            else:
                with self._pending_lock:
                    if status == "gone" or name in self._pending_requeue:
                        # externally deleted — or the delete landed this
                        # time and the requeue path owns it now
                        self._pending_evict.pop(name, None)
        return landed

    def _flush_pending_requeues(self) -> list:
        """Retry replacement creates whose pods are already deleted —
        the one eviction state that cannot be recomputed from the API.

        The batch is CLAIMED atomically: stop()'s last-chance drain can
        run while a wedged tick (the stop() join is timed) is still
        flushing, and without the claim both flushers would walk the
        same map and create+count the same replacement twice — the race
        the JAX package's interleaving explorer pins. Failed
        creates are parked again; a create that succeeded under a racing
        tick's claim stays gone (setdefault, never overwrite)."""
        probe("lifecycle.flush_requeues")
        with self._pending_lock:
            claimed = dict(self._pending_requeue)
            self._pending_requeue.clear()
        landed = []
        failed: dict = {}
        for name in sorted(claimed):
            if self._create_requeued(name, claimed[name]):
                landed.append(name)
                metrics.EVICTIONS.inc()
            else:
                failed[name] = claimed[name]
        with self._pending_lock:
            self.evicted_total += len(landed)
            for name, fresh in failed.items():
                self._pending_requeue.setdefault(name, fresh)
        return landed

    def _delete_node(self, name: str) -> None:
        status, _ = self._retry_write(lambda: self.api.delete_node(name))
        if status in ("failed", "conflict"):
            log.warning("could not delete lost node %s (%s); will retry "
                        "next tick", name, status)

    def _event(self, name: str, reason: str, message: str,
               kind: str = "Node", event_type: str = "Warning") -> None:
        record = getattr(self.api, "record_event", None)
        if record is None:
            return
        try:
            record(kind, name, event_type, reason, message)
        except Exception:
            pass  # observability only

    # ---- loop --------------------------------------------------------------

    def start(self, interval_s: float | None = None) -> None:
        interval = interval_s if interval_s is not None \
            else max(0.05, self.stale_after_s / 2.0)
        # Re-armable: the controller is singleton-ELECTED now (a lease
        # Elector cycles start/stop as leadership moves between scheduler
        # replicas), so a fresh stop event per start lets a demoted
        # replica promote again later.
        # racer: single-writer -- start()/stop() are owner-thread calls
        # (the elector serializes promote/demote)
        self._stop = threading.Event()

        def loop():
            while not self._stop.is_set():
                try:
                    self.tick()
                except Exception:
                    log.exception("node lifecycle tick failed")
                self._stop.wait(interval)

        # racer: single-writer -- stop() joins the loop before clearing
        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="node-lifecycle")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        # Last-chance drain: a pod in _pending_requeue is already deleted
        # from the API and its replacement exists only in this process —
        # the one eviction state that cannot be recomputed. Dropping it
        # on demotion/shutdown would lose the workload silently. (The
        # join above is timed, so a wedged tick may still be flushing —
        # the claim in _flush_pending_requeues keeps the drains disjoint.)
        with self._pending_lock:
            parked = bool(self._pending_requeue)
        if parked:
            self._flush_pending_requeues()
        with self._pending_lock:
            leftover = sorted(self._pending_requeue)
        for name in leftover:
            log.error("stopping with evicted pod %s not requeued — its "
                      "replacement create kept failing; workload intent "
                      "is lost with this process", name)
