"""Scheduler cache: the in-memory cluster view with device extensions.

Reference: `kube-scheduler/pkg/schedulercache/` with the KubeGPU
touch-points (SURVEY.md §2.8): each cached node carries the decoded device
inventory (``node_ex``), pods charge/release device usage through the
device-scheduler registry on add/remove, and assumed pods expire on a TTL
so a crashed binding cannot leak cards (`schedulercache/cache.go:40-81`).

The API server remains the checkpoint: a scheduler restart rebuilds this
cache entirely from node/pod annotations (SURVEY.md §6 checkpoint/resume).
"""

from __future__ import annotations

import json
import threading
import time
from typing import Any

from kubegpu_tpu_torch import metrics
from kubegpu_tpu_torch.core import codec
from kubegpu_tpu_torch.core.types import NodeInfo, PodInfo
from kubegpu_tpu_torch.scheduler import interpod
from kubegpu_tpu_torch.scheduler.equivalence import EquivalenceCache
from kubegpu_tpu_torch.scheduler.predicates import (pod_core_requests,
                                              pod_host_ports, pod_volumes)

ASSUMED_POD_TTL_S = 30.0


class CacheCorruption(RuntimeError):
    """An unparseable pod device annotation — fatal, like the reference's
    panic (`node_info.go:336-340`): scheduling against corrupt accounting
    would silently misplace every subsequent pod."""


class CachedNode:
    def __init__(self, kube_node: dict) -> None:
        self.kube_node = kube_node
        self.fit_fingerprint: str = ""
        self.node_ex: NodeInfo = NodeInfo()
        self.pod_names: set = set()
        self.requested_core: dict = {}  # prechecked (cpu/memory) accounting
        self.pod_ports: dict = {}       # pod name -> {(proto, hostIP, port)}
        self.pod_labels: dict = {}      # pod name -> labels (for spreading)
        self.pod_volumes: dict = {}     # pod name -> volume dicts (disk conflicts)
        self.pod_affinity: dict = {}    # pod name -> spec.affinity (interpod)
        self.pod_namespaces: dict = {}  # pod name -> namespace

    def used_ports(self) -> set:
        out: set = set()
        for ports in self.pod_ports.values():
            out |= ports
        return out

    @property
    def name(self) -> str:
        return self.kube_node["metadata"]["name"]

    def core_allocatable(self) -> dict:
        alloc = (self.kube_node.get("status") or {}).get("allocatable") or {}
        return {k: codec.parse_quantity(v) for k, v in alloc.items()}


class NodeSnapshot:
    """Consistent point-in-time copy for lock-free fit/score evaluation.
    Fully self-contained — no live back-references — so a concurrent
    ``set_node``/``_charge_locked`` cannot tear a fit decision
    mid-evaluation."""

    def __init__(self, cached: CachedNode) -> None:
        self.name = cached.name
        self.node_ex = cached.node_ex.clone()
        self.requested_core = dict(cached.requested_core)
        self.used_ports = cached.used_ports()
        self.pod_labels = {k: dict(v) for k, v in cached.pod_labels.items()}
        self.pod_volumes = dict(cached.pod_volumes)  # lists replaced, not mutated
        self.pod_names = set(cached.pod_names)
        self.kube_node = _slim_node_copy(cached.kube_node)
        self.core_allocatable = cached.core_allocatable()


def _fit_fingerprint(kube_node: dict) -> str:
    """Stable digest of every node field a fit/score decision reads —
    labels, annotations (device inventory and card health included),
    taints, unschedulable, conditions, allocatable, images — EXCLUDING
    the liveness heartbeat stamp. The advertiser re-patches the heartbeat
    every pass; without this carve-out every heartbeat would bump the
    node's fit generation and the memo could never survive a single
    advertise interval on a live cluster."""
    meta = kube_node.get("metadata") or {}
    spec = kube_node.get("spec") or {}
    status = kube_node.get("status") or {}
    ann = {k: v for k, v in (meta.get("annotations") or {}).items()
           if k != codec.NODE_HEARTBEAT_ANNOTATION}
    return json.dumps(
        (meta.get("labels") or {}, ann, spec.get("taints") or [],
         spec.get("unschedulable"), status.get("conditions") or [],
         status.get("allocatable") or {}, status.get("images") or []),
        sort_keys=True, default=str)


def _slim_node_copy(kube_node: dict) -> dict:
    """Copy only what predicates/priorities read (labels, annotations,
    taints, unschedulable, conditions, allocatable). The snapshot runs on
    the per-pod-per-node hot path under the cache lock, so deep-copying
    the whole node object — device-inventory annotation blob included —
    would serialize the parallel fit workers; string values are shared,
    containers are copied one level deep, which keeps the snapshot torn-
    read-free (watchers replace the node dict wholesale, never mutate)."""
    meta = kube_node.get("metadata") or {}
    spec = kube_node.get("spec") or {}
    status = kube_node.get("status") or {}
    return {
        "metadata": {
            "name": meta.get("name"),
            "labels": dict(meta.get("labels") or {}),
            "annotations": dict(meta.get("annotations") or {}),
        },
        "spec": {
            "taints": [dict(t) for t in (spec.get("taints") or [])],
            "unschedulable": spec.get("unschedulable"),
        },
        "status": {
            "conditions": [dict(c) for c in (status.get("conditions") or [])],
            "allocatable": dict(status.get("allocatable") or {}),
            # image-locality priority reads present-image sizes
            "images": [dict(i) for i in (status.get("images") or [])],
        },
    }


class SchedulerCache:
    def __init__(self, device_scheduler: Any) -> None:
        self.device_scheduler = device_scheduler
        self._lock = threading.RLock()
        self.nodes: dict = {}           # name -> CachedNode
        self._assumed: dict = {}        # pod name -> (node_name, deadline)
        self._charged: set = set()      # pod names currently accounted
        self._affinity_pods = 0         # placed pods carrying ANY pod(Anti)Affinity
        self._required_anti_pods = 0    # subset with REQUIRED anti-affinity
        # Per-node fit generation: bumped on every fit-relevant change
        # (set_node with changed state, add/remove/assume/forget/expire of
        # a pod, node delete). The memoized fit verdicts AND the cycle
        # snapshots below are keyed by it — bump = both retired at once.
        # Entries deliberately outlive their node so a delete + re-add
        # cannot restart the counter and resurrect stale verdicts.
        self._gen: dict = {}            # node name -> generation
        self._snap: dict = {}           # node name -> (generation, NodeSnapshot)
        self.equivalence = EquivalenceCache()

    # ---- generations / invalidation ----------------------------------------

    def _invalidate_locked(self, name: str, record: bool = True) -> None:
        # Always called with self._lock held: the bump must be atomic with
        # the state change it publishes. ``record=False`` keeps first-time
        # node registration out of fit_cache_invalidations_total — a
        # fresh node retires nothing.
        self._gen[name] = self._gen.get(name, 0) + 1
        self._snap.pop(name, None)
        if record:
            metrics.FIT_CACHE_INVALIDATIONS.inc()

    def _invalidate_all_locked(self) -> None:
        # Only LIVE nodes: a departed node's retained generation already
        # exceeds anything an in-flight pass captured before its delete
        # (remove_node bumped it), so stale stores for it can never be
        # served — bumping the dead entries would only make this flush
        # O(every node name ever seen) under the cache lock.
        for name in self.nodes:
            self._gen[name] = self._gen.get(name, 0) + 1
        self._snap.clear()
        metrics.FIT_CACHE_INVALIDATIONS.inc(len(self.nodes))

    def node_generation(self, name: str) -> int:
        with self._lock:
            return self._gen.get(name, 0)

    # ---- nodes (`node_info.go:456-492`) ------------------------------------

    def set_node(self, kube_node: dict) -> None:
        """Add/update a node: decode its device annotation (preserving the
        in-memory ``used``) and (re-)register with the device scheduler.
        The fit generation bumps only when fit-relevant state actually
        changed — a heartbeat re-patch delivered through the watch must
        not retire the node's memoized verdicts."""
        with self._lock:
            name = kube_node["metadata"]["name"]
            cached = self.nodes.get(name)
            existing_ex = cached.node_ex if cached else None
            node_ex = codec.annotation_to_node_info(
                kube_node.get("metadata") or {}, existing_ex)
            node_ex.name = name
            if cached is None:
                old_labels = None
                cached = CachedNode(kube_node)
                self.nodes[name] = cached
            else:
                old_labels = (cached.kube_node.get("metadata") or {}) \
                    .get("labels") or {}
                cached.kube_node = kube_node
            cached.node_ex = node_ex
            self.device_scheduler.add_node(name, node_ex)
            fingerprint = _fit_fingerprint(kube_node)
            changed = old_labels is None or \
                fingerprint != cached.fit_fingerprint
            cached.fit_fingerprint = fingerprint
            if not changed:
                return
            if old_labels is None:
                # first registration: bump (a re-added name must move past
                # any generation an old pass captured) but don't count it
                # as an invalidation — a fresh node retires nothing
                self._invalidate_locked(name, record=False)
                return
            new_labels = (kube_node.get("metadata") or {}).get("labels") or {}
            if self._required_anti_pods and old_labels != new_labels:
                # topology-domain labels moved: the symmetry veto from
                # placed required-anti-affinity pods may flip memoized
                # verdicts on OTHER nodes sharing the domain
                self._invalidate_all_locked()
            else:
                self._invalidate_locked(name)

    def remove_node(self, name: str) -> None:
        with self._lock:
            cached = self.nodes.pop(name, None)
            if cached is not None:
                # The node's usage died with its CachedNode; un-mark its
                # pods so a node flap (delete + re-add + watch replay of
                # the bound pods as ADDED) re-charges them against the
                # fresh node instead of hitting the idempotency gate.
                for pod_name in cached.pod_names:
                    self._charged.discard(pod_name)
                self._affinity_pods -= len(cached.pod_affinity)
                departed_anti = sum(
                    interpod.has_required_anti_terms(aff)
                    for aff in cached.pod_affinity.values())
                self._required_anti_pods -= departed_anti
                self.device_scheduler.remove_node(name)
                # the departed node's own generation must always move —
                # it is no longer in self.nodes, so the all-flush below
                # would skip it and a re-add could resume at a generation
                # an in-flight pass still holds
                self._invalidate_locked(name)
                if departed_anti:
                    self._invalidate_all_locked()
                self.equivalence.drop_node(name)

    def get_node(self, name: str) -> CachedNode | None:
        with self._lock:
            return self.nodes.get(name)

    def node_names(self) -> list:
        with self._lock:
            return sorted(self.nodes)

    # ---- pod conversion (`schedulercache/devices.go:14-45`) ----------------

    def pod_info_for_node(self, kube_pod: dict, node_name: str) -> PodInfo:
        """Convert a kube pod for evaluation against one node, invalidating
        stale per-node state when the pod was customized for another node."""
        pod_info = codec.kube_pod_to_pod_info(kube_pod, invalidate_existing=False)
        if pod_info.node_name != node_name:
            pod_info = codec.kube_pod_to_pod_info(kube_pod, invalidate_existing=True)
        return pod_info

    # ---- pod lifecycle (`node_info.go:336-398`, `cache.go:40-81`) ----------

    def _charge_locked(self, kube_pod: dict, node_name: str, take: bool) -> None:
        # Always called with self._lock held (assume/forget/add/remove/expire).
        # Idempotent per pod: an informer replaying a bound pod that
        # _sync_existing already listed (or a duplicate delete) must not
        # double-charge/double-return device usage — a real k8s watch
        # always replays current objects as ADDED on (re)connect.
        name = (kube_pod.get("metadata") or {}).get("name")
        if take and name in self._charged:
            return
        if not take and name not in self._charged:
            return
        cached = self.nodes.get(node_name)
        if cached is None:
            # Node vanished: its usage is gone wholesale, but the pod must
            # not stay marked charged or a later same-named pod would
            # never be accounted anywhere.
            if not take:
                self._charged.discard(name)
            return
        try:
            pod_info = codec.kube_pod_to_pod_info(kube_pod, invalidate_existing=False)
        except Exception as e:
            raise CacheCorruption(
                f"unparseable device annotation on pod "
                f"{kube_pod.get('metadata', {}).get('name')}") from e
        if take:
            self.device_scheduler.take_pod_resources(pod_info, cached.node_ex)
        else:
            self.device_scheduler.return_pod_resources(pod_info, cached.node_ex)
        # Same effective-request semantics as the PodFitsResources predicate
        # (max(init) folded via max, not sum) so admission and accounting
        # cannot disagree.
        sign = 1 if take else -1
        for res, val in pod_core_requests(kube_pod).items():
            cached.requested_core[res] = \
                cached.requested_core.get(res, 0) + sign * val
        meta = kube_pod.get("metadata") or {}
        affinity = ((kube_pod.get("spec") or {}).get("affinity") or {})
        pod_level = {k: affinity[k] for k in ("podAffinity", "podAntiAffinity")
                     if affinity.get(k)}
        required_anti = interpod.has_required_anti_terms(pod_level)
        if take:
            cached.pod_ports[name] = pod_host_ports(kube_pod)
            cached.pod_labels[name] = dict(meta.get("labels") or {})
            vols = pod_volumes(kube_pod)
            if vols:
                cached.pod_volumes[name] = vols
            if pod_level:
                cached.pod_affinity[name] = pod_level
                self._affinity_pods += 1
                self._required_anti_pods += required_anti
            cached.pod_namespaces[name] = meta.get("namespace") or "default"
            self._charged.add(name)
        else:
            cached.pod_ports.pop(name, None)
            cached.pod_labels.pop(name, None)
            cached.pod_volumes.pop(name, None)
            if cached.pod_affinity.pop(name, None) is not None:
                self._affinity_pods -= 1
                self._required_anti_pods -= required_anti
            cached.pod_namespaces.pop(name, None)
            self._charged.discard(name)
        if required_anti:
            # A pod with REQUIRED anti-affinity changes predicate results
            # on every node sharing a topology domain — per-node
            # invalidation is not enough (the upstream equivalence-cache
            # affinity bug class). Preferred-only terms never flip a
            # predicate verdict, so they don't pay this flush.
            self._invalidate_all_locked()
        else:
            self._invalidate_locked(node_name)

    def assume_pod(self, kube_pod: dict, node_name: str,
                   now: float | None = None) -> None:
        """Optimistically place a pod before bind confirms
        (`scheduler.go:370-392`). Tolerates the node vanishing between
        allocate and assume — the charge no-ops and bind will fail
        cleanly. A pod ALREADY charged as bound (a competing replica's
        commit observed mid-cycle, between this cycle's pop and now) is
        not assumed on top: the accounting already reflects the server's
        truth, and registering an assume here would make the eventual
        Conflict's forget release a charge this assume never made —
        subtracting our planned cards from under the winner's."""
        with self._lock:
            name = kube_pod["metadata"]["name"]
            if name in self._charged and name not in self._assumed:
                return
            self._charge_locked(kube_pod, node_name, take=True)
            node = self.nodes.get(node_name)
            if node is not None:
                node.pod_names.add(name)
            deadline = (now if now is not None else time.monotonic()) + ASSUMED_POD_TTL_S
            self._assumed[name] = (node_name, deadline, kube_pod)

    def snapshot_node(self, name: str) -> "NodeSnapshot | None":
        """A PRIVATE ``NodeSnapshot`` for lock-free fit/score evaluation,
        or None. Always freshly built: callers (preemption simulation,
        nominated-demand charging) may mutate it freely."""
        with self._lock:
            cached = self.nodes.get(name)
            if cached is None:
                return None
            return NodeSnapshot(cached)

    def cycle_snapshot(self) -> tuple:
        """``(names, snapshots, generations)`` for one scheduling pass
        under ONE lock acquisition — the per-pod-per-node
        ``snapshot_node`` storm was the hot loop's biggest fixed cost at
        256 nodes.

        Snapshots are generation-cached and SHARED across passes: a node
        whose generation has not moved hands out the same object it did
        for the previous pod, so a stream of identical pods re-snapshots
        only the nodes that changed. Callers must treat these snapshots
        as immutable; anything that needs to mutate one (nominated-demand
        charging, eviction simulation) takes a private ``snapshot_node``.

        Generations are captured atomically with the snapshots, BEFORE
        the caller builds the cluster-wide inter-pod metadata: a watcher
        invalidation racing the metadata build moves the live generation,
        so the eventual memo store lands under a generation that is never
        served again instead of poisoning the cache (the upstream
        equivalence-cache race)."""
        with self._lock:
            names = sorted(self.nodes)
            snaps: dict = {}
            gens: dict = {}
            for name in names:
                gen = self._gen.get(name, 0)
                gens[name] = gen
                entry = self._snap.get(name)
                if entry is None or entry[0] != gen:
                    entry = (gen, NodeSnapshot(self.nodes[name]))
                    self._snap[name] = entry
                snaps[name] = entry[1]
            return names, snaps, gens

    def has_affinity_pods(self) -> bool:
        """Fast gate: any placed pod carrying pod(Anti)Affinity? Lets the
        filter skip building cluster-wide metadata for the common case
        (the reference gates the same way in its metadata producer)."""
        with self._lock:
            return self._affinity_pods > 0

    def interpod_snapshot(self) -> interpod.InterPodMetadata:
        """Cluster-wide affinity inputs under ONE lock acquisition — the
        `predicates/metadata.go` analogue, consumed by `interpod.py`."""
        with self._lock:
            node_labels = {}
            pods = []
            for name, cached in self.nodes.items():
                node_labels[name] = dict(
                    (cached.kube_node.get("metadata") or {}).get("labels") or {})
                for pod_name in cached.pod_names:
                    pods.append(interpod.ExistingPod(
                        pod_name,
                        cached.pod_namespaces.get(pod_name),
                        dict(cached.pod_labels.get(pod_name) or {}),
                        name,
                        cached.pod_affinity.get(pod_name)))
            return interpod.InterPodMetadata(node_labels, pods)

    def confirm_pod(self, pod_name: str) -> None:
        """Bind succeeded: the pod is no longer merely assumed."""
        with self._lock:
            self._assumed.pop(pod_name, None)

    def forget_pod(self, kube_pod: dict) -> None:
        """Bind failed: release the assumed resources
        (`scheduler.go:394-431`)."""
        with self._lock:
            name = kube_pod["metadata"]["name"]
            entry = self._assumed.pop(name, None)
            if entry is None:
                return
            node_name = entry[0]
            self._charge_locked(entry[2], node_name, take=False)
            node = self.nodes.get(node_name)
            if node:
                node.pod_names.discard(name)

    def add_pod(self, kube_pod: dict, node_name: str) -> None:
        """A bound pod observed from the API server. If it was assumed
        by us WITH THE SAME placement, the charge already happened. An
        assumed pod observed bound DIFFERENTLY (node or allocation) is a
        competing scheduler replica's bind that won the commit race and
        arrived before our own bind's Conflict reply: release our
        optimistic charge and account the server's truth — otherwise
        this cache both leaks our phantom cards and treats the winner's
        cards as free forever."""
        with self._lock:
            name = kube_pod["metadata"]["name"]
            entry = self._assumed.get(name)
            if entry is not None:
                assumed_node, _, assumed_pod = entry
                observed_ann = ((kube_pod.get("metadata") or {})
                                .get("annotations") or {}) \
                    .get(codec.POD_ANNOTATION_KEY)
                assumed_ann = ((assumed_pod.get("metadata") or {})
                               .get("annotations") or {}) \
                    .get(codec.POD_ANNOTATION_KEY)
                self._assumed.pop(name)
                if assumed_node == node_name and observed_ann == assumed_ann:
                    return  # our own bind confirmed; the charge stands
                self._charge_locked(assumed_pod, assumed_node, take=False)
                lost = self.nodes.get(assumed_node)
                if lost is not None:
                    lost.pod_names.discard(name)
            self._charge_locked(kube_pod, node_name, take=True)
            if node_name in self.nodes:
                self.nodes[node_name].pod_names.add(name)

    def remove_pod(self, kube_pod: dict, node_name: str) -> None:
        with self._lock:
            name = kube_pod["metadata"]["name"]
            self._assumed.pop(name, None)
            self._charge_locked(kube_pod, node_name, take=False)
            node = self.nodes.get(node_name)
            if node:
                node.pod_names.discard(name)

    def apply_batch(self, ops: list) -> None:
        """Apply a list of ``(bound method, args)`` informer mutations
        under ONE lock acquisition (the RLock is reentrant): a watch
        batch of N events costs one lock round-trip instead of N, and
        no fit pass can observe a half-applied batch."""
        with self._lock:
            for fn, args in ops:
                fn(*args)

    def expire_assumed(self, now: float | None = None) -> list:
        """Drop assumed pods whose bind never confirmed (TTL 30s,
        `cache.go:40-81`). Returns expired pod names."""
        with self._lock:
            now = now if now is not None else time.monotonic()
            expired = [n for n, (_, dl, _) in self._assumed.items() if dl <= now]
            for name in expired:
                node_name, _, kube_pod = self._assumed.pop(name)
                self._charge_locked(kube_pod, node_name, take=False)
                node = self.nodes.get(node_name)
                if node:
                    node.pod_names.discard(name)
            return expired
