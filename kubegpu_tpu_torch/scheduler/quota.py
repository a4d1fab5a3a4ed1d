"""Dominant-resource fair-share GPU card quotas across tenants.

The port's copy of ``kubegpu_tpu/scheduler/quota.py``, counting GPU cards
where the JAX gate counts TPU chips: a pod's demand is its
``alpha.gpu/numgpu`` (``cluster/apf.py``), a node's capacity its advertised
``.../gpu/<UUID>/cards`` leaves. The JAX gate, run over a GPU fleet, sees 0
cards in every pod and on every node, so it shares CPU alone.

Ghodsi et al.'s Dominant Resource Fairness (NSDI'11) is the blueprint:
each tenant's **dominant share** is the largest fraction of any cluster
resource it holds (cards or CPU here — cards dominate in practice), and
fair allocation keeps every demanding tenant's dominant share at (or
below) its weighted fair fraction.

The gate runs at pod-POP time in the scheduling loop — before
allocation, not after bind (the decision point where cards are still
fungible):

* a pod whose tenant would exceed its fair share parks with a typed
  :class:`QuotaExceeded` unschedulable reason (visible in
  ``/debug/pod/<name>`` and the pod's event stream);
* **gangs admit whole or not at all** — the gate sees every member's
  demand in one call, so a gang can never straddle the quota boundary
  half-placed;
* parked pods live in the GATE, not the scheduling queue: they cost no
  pop cycles while over share (thousands of parked flood pods must not
  melt the scheduler), and every card release (pod deletion, node
  growth, weight change, a hungry tenant getting served) re-evaluates
  shares and **promptly re-queues** exactly the pods their tenants can
  now afford;
* the gate is work-conserving: a tenant may exceed its fair share
  whenever no other tenant is hungry (demanding and below ITS fair
  share) — fairness never idles cards that only one tenant wants.

Accounting is incremental and informer-fed: the owning ``Scheduler``
feeds node capacity and pod pending/bound/gone transitions straight
from its watch stream, so an admit decision is O(active tenants), never
a cluster scan. The resource key stays ``"chips"``, as in the JAX gate,
so both report shares under one name.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Tuple

from kubegpu_tpu_torch import metrics
from kubegpu_tpu_torch.analysis.explore import probe
from kubegpu_tpu_torch.cluster.apf import (pod_chip_request, pod_cpu_request,
                                           tenant_of_pod)
from kubegpu_tpu_torch.cluster.httpapi import QuotaExceeded
from kubegpu_tpu_torch.core import codec, grammar

__all__ = ["DRFQuotaGate", "QuotaExceeded", "node_resource_totals",
           "pod_resource_demand"]

_RESOURCES = ("chips", "cpu")


def node_resource_totals(kube_node: dict) -> Dict[str, float]:
    """``{"chips", "cpu"}`` a node contributes to cluster capacity: its
    advertised card leaves (``.../gpu/<UUID>/cards``) from the device
    inventory annotation, CPU from core allocatable."""
    chips = 0.0
    try:
        info = codec.annotation_to_node_info(
            kube_node.get("metadata") or {})
        for res in info.allocatable:
            if grammar.gpu_id_from_path(str(res)) is not None:
                chips += 1.0
    except (TypeError, ValueError, KeyError):
        chips = 0.0
    cpu = 0.0
    raw = ((kube_node.get("status") or {}).get("allocatable")
           or {}).get("cpu")
    if raw is not None:
        try:
            cpu = float(codec.parse_quantity(raw))
        except (TypeError, ValueError):
            cpu = 0.0
    return {"chips": chips, "cpu": cpu}


def pod_resource_demand(kube_pod: dict) -> Dict[str, float]:
    """``{"chips", "cpu"}`` one pod asks for: cards and CPU."""
    return {"chips": float(pod_chip_request(kube_pod)),
            "cpu": pod_cpu_request(kube_pod)}


def _add(dst: Dict[str, float], src: Dict[str, float],
         sign: float = 1.0) -> None:
    for res in _RESOURCES:
        dst[res] = dst.get(res, 0.0) + sign * src.get(res, 0.0)


class DRFQuotaGate:
    """Weighted dominant-resource fair-share gate over cluster cards.

    Thread-safe monitor: the scheduling loop calls :meth:`admit`, the
    informer thread feeds :meth:`set_node` / :meth:`pod_pending` /
    :meth:`pod_bound` / :meth:`pod_gone`, and parked pods are re-queued
    through ``requeue`` (set by the owning Scheduler to its queue's
    ``push``) OUTSIDE the gate lock."""

    # In-flight (admitted-but-not-yet-bound) charges expire after this
    # long — the backstop for failure paths that never re-pop the pod;
    # bound/deleted watch events clear them much sooner.
    INFLIGHT_TTL_S = 30.0
    _EPS = 1e-9

    def __init__(self, weights: "Dict[str, float] | None" = None,
                 requeue: "Callable[[dict], None] | None" = None,
                 hungry_grace_s: float = 5.0) -> None:
        # Work-conservation hysteresis: admission beyond fair share is
        # IRREVERSIBLE (the gate does not preempt), so any OTHER tenant
        # active within this window — holding cards, pending, or seen
        # doing either recently — keeps the over-share tenant capped at
        # its fair fraction. A millisecond gap in a churning tenant's
        # demand must not hand an over-share flood the whole cluster
        # for good; a genuinely idle cluster opens up to any tenant
        # once the grace lapses.
        self.hungry_grace_s = float(hungry_grace_s)
        self._last_active: Dict[str, float] = {}
        self._lock = threading.Lock()
        self._weights: Dict[str, float] = {
            str(t): float(w) for t, w in (weights or {}).items()}
        # the weights the gate was built with (the binary's
        # tenantWeights): the owning Scheduler keeps them under the API
        # server's quota objects, which replace the map at cold start
        self.configured_weights: Dict[str, float] = dict(self._weights)
        self._node_res: Dict[str, Dict[str, float]] = {}
        self._capacity: Dict[str, float] = {r: 0.0 for r in _RESOURCES}
        # tenant -> bound usage; pod name -> (tenant, demand) backing it
        self._bound: Dict[str, Dict[str, float]] = {}
        self._charged: Dict[str, Tuple[str, Dict[str, float]]] = {}
        # pod name -> (tenant, demand, expiry): admitted, bind in flight
        self._inflight: Dict[str, Tuple[str, Dict[str, float], float]] = {}
        # tenant -> count of pending (unbound) pods; pod name -> tenant
        self._pending: Dict[str, int] = {}
        self._pending_pods: Dict[str, str] = {}
        # tenant -> FIFO of (parked pod, aggregate demand a re-pop
        # would re-admit — the whole gang's for a gang member);
        # pod name -> tenant
        self._parked: Dict[str, List[Tuple[dict, Dict[str, float]]]] = {}
        self._parked_names: Dict[str, str] = {}
        # racer: single-writer -- wired once by the owning Scheduler's
        # constructor before any concurrent caller exists
        self.requeue = requeue
        # Optional batch form (a queue's ``push_many``): a 256-pod
        # release becomes ONE queue wake and ONE depth publish instead
        # of 256 of each. Falls back to per-pod ``requeue`` when unset.
        self.requeue_many = None

    # ---- capacity + usage feeds (informer thread) --------------------------

    def set_node(self, kube_node: dict) -> None:
        name = (kube_node.get("metadata") or {}).get("name")
        if not name:
            return
        res = node_resource_totals(kube_node)
        with self._lock:
            old = self._node_res.get(name)
            if old == res:
                return
            if old is not None:
                _add(self._capacity, old, -1.0)
            self._node_res[name] = res
            _add(self._capacity, res)
        self._release_parked()

    def drop_node(self, name: str) -> None:
        with self._lock:
            old = self._node_res.pop(name, None)
            if old is not None:
                _add(self._capacity, old, -1.0)

    def pod_pending(self, kube_pod: dict) -> None:
        """An unbound pod exists: its tenant is demanding. Idempotent
        per pod name (watch updates re-deliver)."""
        tenant = tenant_of_pod(kube_pod)
        if tenant is None:
            return
        name = kube_pod["metadata"]["name"]
        with self._lock:
            self._stamp_demand_locked(tenant, time.monotonic())
            if name in self._pending_pods:
                return
            self._pending_pods[name] = tenant
            self._pending[tenant] = self._pending.get(tenant, 0) + 1

    def pod_bound(self, kube_pod: dict) -> None:
        """A bound pod observed on the watch stream (ours or a
        competing replica's): move the tenant's demand into bound
        usage. Idempotent per pod name."""
        tenant = tenant_of_pod(kube_pod)
        name = kube_pod["metadata"]["name"]
        with self._lock:
            self._unpend_locked(name)
            self._inflight.pop(name, None)
            self._unpark_locked(name)
            if tenant is None or name in self._charged:
                served = False
            else:
                demand = pod_resource_demand(kube_pod)
                self._charged[name] = (tenant, demand)
                _add(self._bound.setdefault(
                    tenant, {r: 0.0 for r in _RESOURCES}), demand)
                served = True
        if served:
            # a hungry tenant just got served: tenants parked for ITS
            # sake may be affordable again
            self._release_parked()

    def pod_gone(self, kube_pod_or_name: "dict | str") -> None:
        """A pod was deleted: release its charges and promptly
        re-evaluate parked tenants against the freed cards."""
        if isinstance(kube_pod_or_name, str):
            name = kube_pod_or_name
        else:
            name = kube_pod_or_name["metadata"]["name"]
        with self._lock:
            self._unpend_locked(name)
            self._inflight.pop(name, None)
            self._unpark_locked(name)
            entry = self._charged.pop(name, None)
            if entry is not None:
                tenant, demand = entry
                usage = self._bound.get(tenant)
                if usage is not None:
                    _add(usage, demand, -1.0)
                    if all(v <= self._EPS for v in usage.values()):
                        self._bound.pop(tenant, None)
        self._release_parked()

    def set_weight(self, tenant: str, weight: float) -> None:
        with self._lock:
            self._weights[str(tenant)] = float(weight)
        self._release_parked()

    def set_weights(self, weights: Dict[str, float]) -> None:
        """Replace the WHOLE weight map (cold start / relist sync): a
        tenant absent from the authoritative listing reverts to the
        default — merging would let a quota deleted during a watch gap
        keep its stale weight forever."""
        with self._lock:
            self._weights = {str(t): float(w)
                             for t, w in weights.items()}
        self._release_parked()

    def resync(self, nodes: List[dict], pods: List[dict]) -> None:
        """Full rebuild after a watch relist: the delta stream had a
        gap, so recompute capacity and usage from listed state. Parked
        pods whose objects vanished are dropped; survivors re-queue."""
        with self._lock:
            survivors = [pod for fifo in self._parked.values()
                         for pod, _demand in fifo]
            self._node_res.clear()
            self._capacity = {r: 0.0 for r in _RESOURCES}
            self._bound.clear()
            self._charged.clear()
            self._inflight.clear()
            self._pending.clear()
            self._pending_pods.clear()
            self._parked.clear()
            self._parked_names.clear()
        for node in nodes:
            self.set_node(node)
        listed = set()
        for pod in pods:
            listed.add(pod["metadata"]["name"])
            if (pod.get("spec") or {}).get("nodeName"):
                self.pod_bound(pod)
            else:
                self.pod_pending(pod)
        alive = [pod for pod in survivors
                 if pod["metadata"]["name"] in listed]
        if self.requeue_many is not None:
            self.requeue_many(alive)
        elif self.requeue is not None:
            for pod in alive:
                self.requeue(pod)

    # ---- the gate (scheduling loop) ----------------------------------------

    def admit(self, pods: List[dict]) -> None:
        """Admit a pod — or a WHOLE gang — for scheduling, charging the
        demand in flight until the bind lands (or expires). Raises
        :class:`QuotaExceeded` when the tenant would exceed its
        weighted dominant-resource fair share while another tenant is
        hungry; untenanted pods pass untouched. All-or-nothing across
        ``pods``: a gang is never admitted half-way."""
        tenant = next((t for t in (tenant_of_pod(p) for p in pods)
                       if t is not None), None)
        if tenant is None:
            return
        probe("quota.admit")
        now = time.monotonic()
        with self._lock:
            self._stamp_demand_locked(tenant, now)
            self._expire_inflight_locked(now)
            demand = {r: 0.0 for r in _RESOURCES}
            per_pod: List[Dict[str, float]] = []
            for pod in pods:
                # a re-admitted pod's previous in-flight charge is
                # superseded, never stacked
                self._inflight.pop(pod["metadata"]["name"], None)
                per_pod.append(pod_resource_demand(pod))
                _add(demand, per_pod[-1])
            usage = self._usage_locked(tenant)
            after = dict(usage)
            _add(after, demand)
            share_before = self._dominant_locked(usage)
            share_after = self._dominant_locked(after)
            fair = self._fair_fraction_locked(tenant, now)
            # Progressive filling with a first-allocation guarantee:
            # work fits within the fair share, OR the tenant holds
            # nothing yet (a pod/gang bigger than the fair fraction
            # must still be schedulable once — task granularity must
            # never deadlock a tenant), OR nobody else wants the cards
            # (work conservation). A tenant already holding cards that
            # would overshoot parks while others are hungry.
            if share_after > fair + self._EPS and \
                    share_before > self._EPS and \
                    self._others_hungry_locked(tenant, now):
                raise QuotaExceeded(
                    f"tenant {tenant!r} over dominant-resource fair "
                    f"share: {share_after:.3f} would exceed fair "
                    f"fraction {fair:.3f} "
                    f"(+{demand['chips']:.0f} card(s) on "
                    f"{self._capacity['chips']:.0f})")
            expiry = now + self.INFLIGHT_TTL_S
            for pod, pod_demand in zip(pods, per_pod):
                name = pod["metadata"]["name"]
                self._inflight[name] = (tenant, pod_demand, expiry)
                self._unpark_locked(name)

    def forget(self, pod_name: str) -> None:
        """Discharge a pod's in-flight admission charge NOW: the
        scheduling cycle failed after admit (FitError, volume race,
        internal error, gang refusal) and the pod went back to the
        queue — leaving the charge up would phantom-bill the tenant
        until the TTL, and a backoff-cycling unfittable pod would
        refresh it forever."""
        with self._lock:
            self._inflight.pop(pod_name, None)

    def park(self, kube_pod: dict,
             members: "List[dict] | None" = None) -> None:
        """Hold a quota-refused pod in the gate (FIFO per tenant) until
        a release makes its tenant affordable again — it costs no
        scheduler pop cycles while parked. For a gang, ``members`` is
        the whole refused pod-set: the parked entry carries the gang's
        AGGREGATE demand, so the release path's affordability probe
        judges what a re-pop would actually re-admit (probing one
        member's demand would re-queue, reassemble, and re-refuse the
        gang on every card release)."""
        probe("quota.park")
        name = kube_pod["metadata"]["name"]
        tenant = tenant_of_pod(kube_pod) or ""
        demand = {r: 0.0 for r in _RESOURCES}
        for pod in (members or [kube_pod]):
            _add(demand, pod_resource_demand(pod))
        with self._lock:
            if self._parked_names.get(name) is not None:
                return
            self._parked_names[name] = tenant
            self._parked.setdefault(tenant, []).append((kube_pod, demand))
            # parked demand still counts as demand (fair-share math) —
            # pod_pending is idempotent, but a popped pod may never have
            # passed through it in this replica
            if tenant and name not in self._pending_pods:
                self._pending_pods[name] = tenant
                self._pending[tenant] = self._pending.get(tenant, 0) + 1
        metrics.QUOTA_PARKED.inc()

    def parked_count(self) -> int:
        with self._lock:
            return len(self._parked_names)

    def shares(self) -> Dict[str, Dict[str, float]]:
        """{tenant: {"dominant_share", "fair_fraction", "pending"}} —
        the debug/summary surface."""
        with self._lock:
            self._expire_inflight_locked(time.monotonic())
            tenants = (set(self._bound) | set(self._pending)
                       | {t for t, _d, _e in self._inflight.values()})
            out = {}
            for tenant in sorted(tenants):
                out[tenant] = {
                    "dominant_share": round(self._dominant_locked(
                        self._usage_locked(tenant)), 4),
                    "fair_fraction": round(
                        self._fair_fraction_locked(
                            tenant, time.monotonic()), 4),
                    "pending": float(self._pending.get(tenant, 0)),
                }
            return out

    # ---- internals (all *_locked called under self._lock) ------------------

    def _unpend_locked(self, name: str) -> None:
        tenant = self._pending_pods.pop(name, None)
        if tenant is not None:
            left = self._pending.get(tenant, 0) - 1
            if left > 0:
                self._pending[tenant] = left
            else:
                self._pending.pop(tenant, None)

    def _unpark_locked(self, name: str) -> None:
        tenant = self._parked_names.pop(name, None)
        if tenant is None:
            return
        fifo = self._parked.get(tenant)
        if fifo:
            self._parked[tenant] = [
                entry for entry in fifo
                if entry[0]["metadata"]["name"] != name]
            if not self._parked[tenant]:
                self._parked.pop(tenant, None)

    def _expire_inflight_locked(self, now: float) -> None:
        stale = [name for name, (_t, _d, exp) in self._inflight.items()
                 if exp <= now]
        for name in stale:
            self._inflight.pop(name, None)

    def _usage_locked(self, tenant: str) -> Dict[str, float]:
        usage = dict(self._bound.get(tenant)
                     or {r: 0.0 for r in _RESOURCES})
        for _name, (t, demand, _exp) in self._inflight.items():
            if t == tenant:
                _add(usage, demand)
        return usage

    def _dominant_locked(self, usage: Dict[str, float]) -> float:
        share = 0.0
        for res in _RESOURCES:
            cap = self._capacity.get(res, 0.0)
            if cap > self._EPS:
                share = max(share, usage.get(res, 0.0) / cap)
        return share

    def _active_locked(self) -> set:
        active = {t for t, u in self._bound.items()
                  if any(v > self._EPS for v in u.values())}
        active.update(t for t, n in self._pending.items() if n > 0)
        active.update(t for t, _d, _e in self._inflight.values())
        return active

    def _fair_fraction_locked(self, tenant: str, now: float) -> float:
        """``tenant``'s weighted fair fraction among tenants demanding
        now or within the hysteresis window — the grace widens the
        DENOMINATOR too, so a flood arriving in another tenant's
        momentary demand gap does not get the whole cluster declared
        its fair share."""
        active = self._active_locked()
        active.update(t for t, ts in self._last_active.items()
                      if now - ts < self.hungry_grace_s)
        active.add(tenant)
        total = sum(self._weights.get(t, 1.0) for t in active)
        if total <= self._EPS:
            return 1.0
        return self._weights.get(tenant, 1.0) / total

    def _others_hungry_locked(self, tenant: str, now: float) -> bool:
        """Work conservation with hysteresis: only park ``tenant`` when
        some OTHER tenant is hungry — demanding (pending pods now, or
        demand seen within ``hungry_grace_s``,
        :meth:`_stamp_demand_locked`) AND still below its own fair
        share. Over-share admission is irreversible (the gate does not
        preempt), so a churning tenant's momentary demand gap must not
        forfeit its share for good; but a demander already AT its fair
        share must not block others from cards nobody below-share
        wants (two at-share demanders would otherwise deadlock each
        other over an idle holder's cards), and tenants merely HOLDING
        cards with no demand never cap anyone."""
        stale = [t for t, ts in self._last_active.items()
                 if now - ts >= self.hungry_grace_s]
        for t in stale:
            self._last_active.pop(t, None)
        demanders = {t for t, n in self._pending.items() if n > 0}
        demanders.update(self._last_active)
        for other in demanders:
            if other == tenant:
                continue
            share = self._dominant_locked(self._usage_locked(other))
            if share < self._fair_fraction_locked(other, now) - self._EPS:
                return True
        return False

    def _stamp_demand_locked(self, tenant: "str | None",
                             now: float) -> None:
        if tenant is not None:
            self._last_active[tenant] = now

    def release_due(self) -> bool:
        """Re-evaluate parked tenants NOW (the scheduler's idle nudge:
        the hungry-grace window lapsing generates no watch event, so an
        idle loop asks). Returns True when any pod re-queued."""
        return self._release_parked() > 0

    def _release_parked(self) -> int:
        """Re-queue parked pods their tenants can now afford: shares
        are re-evaluated greedily per tenant (FIFO within a tenant,
        charging hypothetically so one release never floods the queue
        with pods that would all re-park). Requeue callbacks run
        OUTSIDE the gate lock. Returns the number re-queued."""
        requeue = self.requeue
        if requeue is None:
            return 0
        now = time.monotonic()
        to_push: List[dict] = []
        with self._lock:
            # the TTL backstop must not depend on admit() ever running
            # again: an idle scheduler's release nudge is sometimes the
            # only thing left touching the gate
            self._expire_inflight_locked(now)
            for tenant in sorted(self._parked):
                fifo = self._parked.get(tenant) or []
                hypo = self._usage_locked(tenant)
                fair = self._fair_fraction_locked(tenant, now)
                hungry = self._others_hungry_locked(tenant, now)
                for pod, demand in fifo:
                    after = dict(hypo)
                    _add(after, demand)
                    if self._dominant_locked(after) > fair + self._EPS \
                            and self._dominant_locked(hypo) > self._EPS \
                            and hungry:
                        break
                    to_push.append(pod)
                    hypo = after
            for pod in to_push:
                self._unpark_locked(pod["metadata"]["name"])
        for pod in to_push:
            probe("quota.release")
        requeue_many = self.requeue_many
        if requeue_many is not None:
            requeue_many(to_push)
        else:
            for pod in to_push:
                requeue(pod)
        return len(to_push)
