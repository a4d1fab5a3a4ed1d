"""Device-fault repair: health-driven gang migration with checkpointed
restart, counting GPU cards.

The port's copy of ``kubegpu_tpu/scheduler/repair.py``. Card health only
shrinks the advertised inventory for FUTURE placements; a bound pod
sitting on a now-degraded card runs broken forever on a node that stays
Ready. The ``RepairController`` closes that gap — the partial-hardware-
failure half of the lifecycle contract, next to ``NodeLifecycle``'s
whole-node half:

detect
    Per tick, decode every node's ``ChipHealth`` annotation (the per-card
    map the advertiser stamps, keyed by card UUID) and every bound pod's
    pinned cards (`allocated_card_ids`). A repair unit is a bound pod
    (widened to its WHOLE gang) whose allocated cards intersect the
    degraded set.

plan
    Before evicting anything, check a feasible replacement target
    exists: the unit's members, each with its card count, must place host
    by host on the cards that are healthy, advertised and not claimed by
    pods OUTSIDE the unit — the count check of gang preemption
    (`GangPlanner._counts_fit`), then `GangPlanner.plan` on those hosts.
    No target -> the unit PARKS with a typed ``UnrepairableReason``
    (visible in ``/debug/pod`` and as an API event) instead of
    evict-looping; it is re-planned every tick, so node growth or a heal
    un-parks it with no extra machinery. Its only purpose is to keep the
    controller from destroying a running-but-degraded gang when nothing
    better exists.

repair
    Gang-atomic migration: signal checkpoint (stamp
    ``CHECKPOINT_REQUEST_ANNOTATION`` + a ``CheckpointRequested`` event;
    the workload saves via ``workload/checkpoint.py``'s ``step_N``
    convention and the replacement restores from the same directory),
    then evict + requeue each member through the SAME delete-and-recreate
    path ``NodeLifecycle`` uses (``requeued_copy``), with bounded in-line
    retries, exponential per-unit backoff, and a per-unit retry budget.
    The delete releases the cards, a racing ``bind_many`` on a deleted
    member gets NotFound and refuses the whole batch, and a stale bind
    that lands on the recreated (pending) member simply re-binds it —
    possibly back onto the degraded card, which the NEXT tick re-detects
    and re-repairs under the same budget.

The JAX controller also migrates a gang whose allocation spans a dead ICI
link (``_gang_spans_dead_link``). No GPU inventory reports per-card links
the port could read — NVML reports no health and the fake backend no link
faults — so a ``LinkHealth`` stamp on a GPU node triggers no repair here.

PDB respect: repair is a VOLUNTARY disruption (unlike node-loss
eviction), so a unit whose eviction would breach a matching
PodDisruptionBudget is deferred — typed, counted, retried, never
budget-charged.

Singleton-elected like ``NodeLifecycle``: exactly one replica repairs
(``cluster/lease.REPAIR_LEASE``), wired in ``cmd/scheduler_main.py``
behind ``--repair``.
"""

from __future__ import annotations

import json
import logging
import math
import threading
import time

from kubegpu_tpu_torch import metrics, obs
from kubegpu_tpu_torch.analysis.explore import probe
from kubegpu_tpu_torch.cluster.httpapi import Conflict
from kubegpu_tpu_torch.core import codec, grammar
from kubegpu_tpu_torch.node.backend import CHIP_HEALTHY
from kubegpu_tpu_torch.scheduler.gang import GangPlanner, gang_key
from kubegpu_tpu_torch.scheduler.lifecycle import (
    _EVICT_ATTEMPTS, _EVICT_BACKOFF_S, CHECKPOINT_REQUEST_ANNOTATION,
    requeued_copy)
from kubegpu_tpu_torch.scheduler.registry import build_device_scheduler
from kubegpu_tpu_torch.utils import list_bound_pods

log = logging.getLogger(__name__)

# The checkpoint-request signal (``CHECKPOINT_REQUEST_ANNOTATION``,
# lifecycle's constant) the controller stamps on every member before
# eviction: {"gang": id|null, "reason": ..., "dir": step_N-convention
# checkpoint root}. The requeued replacement does NOT carry it
# (requeued_copy strips it — the request was serviced by the eviction)
# and restores from the same directory by convention.

# Typed UnrepairableReason values (surfaced in /debug/pod and events).
UNREPAIRABLE_NO_TARGET = "NoFeasibleTarget"
UNREPAIRABLE_BUDGET = "RetryBudgetExhausted"
DEFERRED_PDB = "DisruptionBudgetBlocked"

DEFAULT_RETRY_BUDGET = 5
DEFAULT_BACKOFF_S = 0.25
DEFAULT_MAX_BACKOFF_S = 8.0
# More units repaired inside one window than this is a repair storm —
# correlated hardware decay or a detector bug; either way the flight
# recorder should ship the timeline.
DEFAULT_STORM_THRESHOLD = 3
DEFAULT_STORM_WINDOW_S = 30.0


def _labels_match(selector: dict, pod: dict) -> bool:
    labels = (pod.get("metadata") or {}).get("labels") or {}
    return all(labels.get(k) == v for k, v in selector.items())


def allocated_card_ids(pod: dict) -> list:
    """``[(card UUID, card prefix)]`` pinned in a bound pod's allocation
    annotation (garbage-tolerant: undecodable -> [])."""
    try:
        info = codec.annotation_to_pod_info(pod.get("metadata") or {})
    except Exception:
        return []
    out = []
    for cont in info.running_containers.values():
        for path in (cont.allocate_from or {}).values():
            uuid = grammar.gpu_id_from_path(path)
            if uuid is not None:
                out.append((uuid, grammar.gpu_prefix_from_path(path)))
    return out


class RepairController:
    """Lease-singleton controller migrating gangs off failed hardware.

    Talks only to the API server (same client surface contract as
    ``NodeLifecycle``); the scheduler observes the evict/requeue churn
    through its ordinary informer and re-plans the gang from intent.
    """

    def __init__(self, api, clock=None,
                 retry_budget: int = DEFAULT_RETRY_BUDGET,
                 backoff_s: float = DEFAULT_BACKOFF_S,
                 max_backoff_s: float = DEFAULT_MAX_BACKOFF_S,
                 storm_threshold: int = DEFAULT_STORM_THRESHOLD,
                 storm_window_s: float = DEFAULT_STORM_WINDOW_S):
        self.api = api
        # Monotonic: only ages this controller's own backoff/latency
        # bookkeeping; never compared across processes.
        self.clock = clock if clock is not None else time.monotonic
        self.retry_budget = max(1, int(retry_budget))
        self.backoff_s = backoff_s
        self.max_backoff_s = max_backoff_s
        self.storm_threshold = max(1, int(storm_threshold))
        self.storm_window_s = storm_window_s
        # Per-unit repair ledger: unit key (("gang", id) | ("pod", name))
        # -> {"attempts", "next_try", "detected", "parked"}. Tick-thread
        # owned; stop() joins the loop before anything else reads it.
        # racer: single-writer -- tick()-thread-owned repair ledger
        self._units: dict = {}
        # racer: single-writer -- tick()-thread-owned storm window
        self._recent: list = []  # unit-repaired timestamps (monotonic)
        # Members deleted but whose replacement create failed: the fresh
        # copy exists only here (same contract as NodeLifecycle) —
        # mutations hold _pending_lock, flushes CLAIM their batch, so
        # the stop() last-chance drain and a wedged tick stay disjoint.
        self._pending_lock = threading.Lock()
        self._pending_requeue: dict = {}
        # racer: single-writer -- tick()-thread-owned success counter;
        # the lease elector serializes start/stop so at most one loop
        # thread is ever live
        self.repaired_total = 0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # ---- detection ---------------------------------------------------------

    def _cluster_view(self):
        """Decode the informer-visible state one repair pass needs:
        (bound pods, degraded {(node, card UUID): state}, node infos)."""
        nodes = self.api.list_nodes()
        bound = list_bound_pods(self.api)
        degraded: dict = {}
        node_infos: dict = {}
        for node in nodes:
            meta = node.get("metadata") or {}
            name = meta.get("name")
            if not name:
                continue
            for uuid, state in codec.annotation_to_chip_health(
                    meta).items():
                if state != CHIP_HEALTHY:
                    degraded[(name, uuid)] = state
            try:
                node_infos[name] = codec.annotation_to_node_info(meta)
            except Exception:  # analysis: disable=no-swallowed-exceptions -- undecodable node inventory is skipped this tick and re-read (and event-logged by the advertiser) next tick
                continue
        return bound, degraded, node_infos

    def _find_units(self, bound: list, degraded: dict) -> dict:
        """Repair units: {unit key: {"members": [pods], "reason": str}}.
        A unit is a whole gang (every BOUND member — pending members just
        stay queued) or a solo bound pod."""
        cards_of = {p["metadata"]["name"]: allocated_card_ids(p)
                    for p in bound}
        gangs: dict = {}  # gang id -> [pods]
        solos: list = []
        for pod in bound:
            key = gang_key(pod)
            if key is not None:
                gangs.setdefault(key[0], []).append(pod)
            else:
                solos.append(pod)
        units: dict = {}

        def card_fault(pod):
            node = (pod.get("spec") or {}).get("nodeName")
            for uuid, _ in cards_of.get(pod["metadata"]["name"], ()):
                state = degraded.get((node, uuid))
                if state is not None:
                    return f"chip-{state}:{uuid}"
            return None

        for pod in solos:
            reason = card_fault(pod)
            if reason:
                units[("pod", pod["metadata"]["name"])] = {
                    "members": [pod], "reason": reason}
        for gang, members in gangs.items():
            reason = next(
                (r for r in (card_fault(p) for p in members) if r), None)
            if reason:
                units[("gang", gang)] = {"members": members,
                                         "reason": reason}
        return units

    # ---- feasibility (graceful degradation) --------------------------------

    def _feasible(self, unit: dict, bound: list, degraded: dict,
                  node_infos: dict) -> bool:
        """Would the unit's members place host by host after its eviction,
        on cards that are healthy, advertised and not claimed by pods
        outside the unit? The count check first (each member's allocated
        card count, largest first, best fit over each host's free cards),
        then `GangPlanner.plan` through the device plugins' own fit."""
        member_names = {p["metadata"]["name"] for p in unit["members"]}
        sizes = sorted((n for n in (len(allocated_card_ids(p))
                                    for p in unit["members"]) if n > 0),
                       reverse=True)
        if not sizes:
            return True  # nothing pinned: nothing the scheduler can't redo
        try:
            devices = build_device_scheduler()
            hosts = {}
            for name in sorted(node_infos):
                node = node_infos[name].clone()
                node.used = {}
                for res, alloc in node.allocatable.items():
                    uuid = grammar.gpu_id_from_path(res)
                    if uuid is not None and (name, uuid) in degraded:
                        node.used[res] = alloc
                devices.add_node(name, node)
                hosts[name] = node
            for pod in bound:
                node = hosts.get((pod.get("spec") or {}).get("nodeName"))
                if node is None or pod["metadata"]["name"] in member_names:
                    continue
                devices.take_pod_resources(
                    codec.kube_pod_to_pod_info(pod,
                                               invalidate_existing=False),
                    node)
        except Exception:
            # inventory undecodable: claim feasibility rather than park
            # a repairable gang on a transient decode problem
            return True
        free = {h: len(GangPlanner._free_cards(n)) for h, n in hosts.items()}
        if not GangPlanner._counts_fit(sizes, free):
            return False
        members = [p for p in unit["members"] if allocated_card_ids(p)]
        planner = GangPlanner(None, devices=devices)
        return planner.plan(members, hosts=hosts) is not None

    # ---- PDB ---------------------------------------------------------------

    def _pdb_state(self, bound: list) -> list:
        """Per-PDB disruption allowance (same derivation as
        ``GenericScheduler._pdb_state``): allowed = matching bound pods
        - minAvailable; malformed PDBs are skipped."""
        list_pdbs = getattr(self.api, "list_pdbs", None)
        if list_pdbs is None:
            return []
        try:
            pdbs = list_pdbs() or []
        except Exception:
            return []
        state = []
        for pdb in pdbs:
            try:
                spec = pdb.get("spec") or {}
                selector = (spec.get("selector") or {}).get(
                    "matchLabels") or {}
                if not selector:
                    continue
                healthy = sum(1 for p in bound
                              if _labels_match(selector, p))
                raw = spec.get("minAvailable") or 0
                if isinstance(raw, str) and raw.endswith("%"):
                    min_avail = math.ceil(healthy * int(raw[:-1]) / 100.0)
                else:
                    min_avail = int(raw)
                state.append({"selector": selector,
                              "allowed": healthy - min_avail})
            except Exception:
                log.warning("repair: ignoring malformed PDB %s",
                            (pdb.get("metadata") or {}).get("name"),
                            exc_info=True)
        return state

    @staticmethod
    def _pdb_blocks(members: list, pdb_state: list) -> bool:
        """Would evicting ALL members breach a matching PDB? The unit is
        gang-atomic, so a single blocked member blocks the unit."""
        allowed = [dict(s) for s in pdb_state]
        for pod in sorted(members, key=lambda p: p["metadata"]["name"]):
            matched = [s for s in allowed
                       if _labels_match(s["selector"], pod)]
            if any(s["allowed"] <= 0 for s in matched):
                return True
            for s in matched:
                s["allowed"] -= 1
        return False

    # ---- one pass ----------------------------------------------------------

    def tick(self, now: float | None = None) -> dict:
        """One repair pass. Returns {"repaired": [unit keys],
        "evicted": [pod names], "parked": {unit key: reason}} for tests
        and the chaos scenario."""
        now = self.clock() if now is None else now
        try:
            bound, degraded, node_infos = self._cluster_view()
        except Exception:
            log.warning("repair tick: cluster view failed", exc_info=True)
            return {"repaired": [], "parked": self.parked(),
                    "evicted": self._flush_pending_requeues()}
        probe("repair.plan")
        units = self._find_units(bound, degraded)
        # forget state for healed/vanished units so a later recurrence
        # starts with a fresh budget
        for key in set(self._units) - set(units):
            del self._units[key]
        pdb_state = self._pdb_state(bound)
        repaired: list = []
        evicted: list = []
        for key in sorted(units, key=str):
            unit = units[key]
            state = self._units.setdefault(
                key, {"attempts": 0, "next_try": 0.0, "detected": now,
                      "parked": None})
            if now < state["next_try"]:
                continue
            if state["attempts"] >= self.retry_budget:
                self._park(key, unit, state, UNREPAIRABLE_BUDGET)
                continue
            if self._pdb_blocks(unit["members"], pdb_state):
                # voluntary disruption blocked: deferred, not budgeted —
                # the PDB owner is in control of when this unblocks
                metrics.REPAIRS.labels("deferred_pdb").inc()
                self._note_unrepairable(key, unit, DEFERRED_PDB,
                                        transitioned=state["parked"] !=
                                        DEFERRED_PDB)
                state["parked"] = DEFERRED_PDB
                continue
            if not self._feasible(unit, bound, degraded, node_infos):
                self._park(key, unit, state, UNREPAIRABLE_NO_TARGET)
                continue
            state["parked"] = None
            done = self._repair_unit(key, unit, evicted)
            if done:
                repaired.append(key)
                metrics.REPAIRS.labels("repaired").inc()
                metrics.REPAIR_LATENCY_MS.observe(
                    max(0.0, (self.clock() - state["detected"]) * 1000.0))
                self.repaired_total += 1
                self._recent.append(now)
                del self._units[key]
            else:
                state["attempts"] += 1
                state["next_try"] = now + min(
                    self.max_backoff_s,
                    self.backoff_s * (2 ** (state["attempts"] - 1)))
                metrics.REPAIRS.labels("failed").inc()
        evicted.extend(self._flush_pending_requeues())
        self._storm_check(now, repaired)
        return {"repaired": repaired, "evicted": evicted,
                "parked": self.parked()}

    def parked(self) -> dict:
        return {key: state["parked"] for key, state in self._units.items()
                if state["parked"]}

    def _park(self, key, unit: dict, state: dict, reason: str) -> None:
        transitioned = state["parked"] != reason
        state["parked"] = reason
        if transitioned:
            metrics.REPAIRS.labels(
                "parked_budget" if reason == UNREPAIRABLE_BUDGET
                else "parked_unrepairable").inc()
        self._note_unrepairable(key, unit, reason,
                                transitioned=transitioned)

    def _note_unrepairable(self, key, unit: dict, reason: str,
                           transitioned: bool) -> None:
        """Make the typed reason observable: an ``unrepairable`` span on
        each member's timeline (what ``/debug/pod`` digests) and, on the
        transition only, an API event."""
        for pod in unit["members"]:
            name = pod["metadata"]["name"]
            obs.event("unrepairable", pod=name, reason=reason,
                      unit=str(key), fault=unit["reason"])
            if transitioned:
                self._event(name, "Unrepairable",
                            f"repair blocked ({reason}): {unit['reason']}",
                            kind="Pod")

    def _storm_check(self, now: float, repaired: list) -> None:
        self._recent = [t for t in self._recent
                        if now - t <= self.storm_window_s]
        if len(self._recent) >= self.storm_threshold:
            obs.FLIGHT.trigger(
                "repair_storm", key="repair",
                window_s=self.storm_window_s, repairs=len(self._recent),
                last_units=[str(k) for k in repaired])

    # ---- execution ---------------------------------------------------------

    def _repair_unit(self, key, unit: dict, evicted: list) -> bool:
        """Checkpoint-signal then evict+requeue every member. True when
        every member is off the API with its replacement landed (or
        externally gone)."""
        members = sorted(unit["members"],
                         key=lambda p: p["metadata"]["name"])
        gang = key[1] if key[0] == "gang" else None
        self._signal_checkpoint(members, gang, unit["reason"])
        probe("repair.evict")
        done = True
        for pod in members:
            name = pod["metadata"]["name"]
            status = self._evict_and_requeue(pod, unit["reason"])
            if status == "evicted":
                evicted.append(name)
                metrics.EVICTIONS.inc()
                obs.event("repair_eviction", pod=name, unit=str(key),
                          fault=unit["reason"])
            elif status != "gone":
                done = False
        return done

    def _signal_checkpoint(self, members: list, gang, reason: str) -> None:
        """Stamp the checkpoint request on every member (best-effort:
        the eviction is the authoritative signal; a failed stamp must
        not stall the repair). The directory follows
        ``workload/checkpoint.py``'s convention so the replacement
        restores what the victim saved."""
        probe("repair.checkpoint")
        for pod in members:
            name = pod["metadata"]["name"]
            ann = dict((pod.get("metadata") or {}).get("annotations") or {})
            ann[CHECKPOINT_REQUEST_ANNOTATION] = json.dumps(
                {"gang": gang, "reason": reason,
                 "dir": f"ckpt/{name}"}, sort_keys=True)
            status, _ = self._retry_write(
                lambda: self.api.update_pod_annotations(name, ann))
            if status == "ok":
                self._event(name, "CheckpointRequested",
                            f"device fault ({reason}); checkpoint then "
                            f"migrate", kind="Pod", event_type="Normal")
            else:
                log.warning("repair: checkpoint signal for %s failed "
                            "(%s); evicting anyway", name, status)

    def _retry_write(self, call) -> tuple:
        """Same contract as ``NodeLifecycle._retry_write``: bounded,
        stop()-interruptible retries; (status, ambiguous) with status in
        ok/missing/conflict/failed."""
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

    def _evict_and_requeue(self, kube_pod: dict, reason: str) -> str:
        """Delete + recreate-pending one member. Mirrors
        ``NodeLifecycle._evict_and_requeue``: a clean "missing" on the
        delete means an external actor tore the pod down — never
        resurrect it; an ambiguous one may be our own landed delete."""
        name = kube_pod["metadata"]["name"]
        fresh = requeued_copy(kube_pod)
        status, ambiguous = self._retry_write(
            lambda: self.api.delete_pod(name))
        if status == "missing" and not ambiguous:
            return "gone"
        if status in ("failed", "conflict"):
            log.warning("repair: could not delete pod %s (%s); retrying "
                        "with backoff", name, status)
            return "failed"
        self._event(name, "Evicted",
                    f"device fault ({reason}); requeued for rescheduling",
                    kind="Pod")
        # The window between the landed delete and the replacement
        # create is the repair path's exactly-once seam: a rival bind
        # may take the released cards here, and the replacement must
        # re-enter as PENDING so a scheduler places it anew.
        probe("repair.requeue")
        status, _ = self._retry_write(lambda: self.api.create_pod(fresh))
        if status in ("ok", "conflict"):
            return "evicted"
        with self._pending_lock:
            self._pending_requeue[name] = fresh
        log.warning("repair: pod %s deleted but re-create failed; parked "
                    "for retry", name)
        return "failed"

    def _flush_pending_requeues(self) -> list:
        """Retry replacement creates for already-deleted members. The
        batch is CLAIMED under the pending lock — the stop() drain and a
        wedged tick must never create+count the same replacement twice
        (same rule as NodeLifecycle)."""
        probe("repair.flush_requeues")
        with self._pending_lock:
            claimed = dict(self._pending_requeue)
            self._pending_requeue.clear()
        landed = []
        failed: dict = {}
        for name in sorted(claimed):
            status, _ = self._retry_write(
                lambda: self.api.create_pod(claimed[name]))
            if status in ("ok", "conflict"):
                landed.append(name)
            else:
                failed[name] = claimed[name]
        with self._pending_lock:
            for name, fresh in failed.items():
                self._pending_requeue.setdefault(name, fresh)
        return landed

    def _event(self, name: str, reason: str, message: str,
               kind: str = "Pod", event_type: str = "Warning") -> None:
        record = getattr(self.api, "record_event", None)
        if record is None:
            return
        try:
            record(kind, name, event_type, reason, message)
        except Exception:
            pass  # observability only

    # ---- loop --------------------------------------------------------------

    def start(self, interval_s: float = 0.5) -> None:
        # Re-armable for the elector (fresh stop event per start), same
        # as NodeLifecycle.
        # racer: single-writer -- start()/stop() are owner-thread calls
        # (the elector serializes promote/demote)
        self._stop = threading.Event()

        def loop():
            while not self._stop.is_set():
                try:
                    self.tick()
                except Exception:
                    log.exception("repair tick failed")
                self._stop.wait(interval_s)

        # racer: single-writer -- stop() joins the loop before clearing
        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="device-repair")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        # Last-chance drain: a deleted member whose replacement exists
        # only in this process is the one repair state that cannot be
        # recomputed from the API.
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
