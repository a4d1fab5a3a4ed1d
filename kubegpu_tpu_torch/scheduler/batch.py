"""Whole-backlog batch scheduling: one assignment problem per cycle.

The port's copy of ``kubegpu_tpu/scheduler/batch.py``, counting GPU cards.
The serial engine schedules pod-at-a-time: every pod pays a full
filter/score pass even when the backlog holds hundreds of clones of the
same controller (fleet restart, big gang submit, tenant burst). This
module turns one drained backlog (``SchedulingQueue.pop_many``) into one
masked filter/score pass per *equivalence class* plus a greedy
auction-style assignment: pods are awarded hosts in backlog order from a
shared score table, per-node capacity (free cards, core headroom) is
decremented in a cycle-local ledger, and only the awarded node's
verdict/score is recomputed for the rest of the class — O(classes) fleet
passes + O(awards) single-node refits instead of O(pods) fleet passes.

Placement parity with the serial path is the contract (the pod-at-a-time
engine stays on as oracle and fallback, ``KGTPU_BATCH=0``, mirroring the
``KGTPU_VECTORIZE=0`` discipline): pods are processed in the exact heap
order ``pop`` would have yielded, host selection threads the SAME
round-robin tie-break cursor, and every award updates the backlog's view
of the awarded node before the next pick. Documented deviations, all of
the watch-freshness kind: node condition/taint/nomination state is read
per-class rather than per-pod within one cycle.

Anything the masked pass cannot broadcast (volumes, inter-pod affinity,
auto-topology, extenders, live nominations on the pod itself) falls back
to the serial path per pod — same routing discipline as
``find_nodes_that_fit``'s own scalar fallback.
"""

from __future__ import annotations

import os
from typing import Any

from kubegpu_tpu_torch.core import codec, grammar
from kubegpu_tpu_torch.scheduler import factory, interpod
from kubegpu_tpu_torch.scheduler.equivalence import equivalence_class
from kubegpu_tpu_torch.scheduler.predicates import pod_core_requests

# One cycle drains at most this many pods: bounds the score-table memory
# and the freshness window (state frozen per class for a cycle) while
# still amortizing the fleet pass across a whole burst.
MAX_BATCH_PODS = 256


def enabled() -> bool:
    """``KGTPU_BATCH=0`` kills the batch cycle (serial oracle path)."""
    return os.environ.get("KGTPU_BATCH", "1") != "0"


def batch_class(generic: Any, kube_pod: dict) -> str | None:
    """The pod's batch grouping key, or None when the pod must take the
    serial path. STRICTER than the serial equivalence class: the owner
    shortcut is dropped, so two pods share a key only when their
    scheduling-relevant content (spec, labels, namespace, device
    requests) hashes identically — which is exactly what makes one
    representative's filter AND score pass valid for every member."""
    if generic.vector is None or not generic._memo_safe:
        return None
    if generic.extenders:
        # extender callouts see the representative's name — per-pod
        return None
    if generic._requests_auto_topology(kube_pod):
        return None
    if interpod.pod_declares_interpod_affinity(kube_pod) or \
            generic.cache.has_affinity_pods():
        return None
    if generic._volume_snapshot(kube_pod) is not None:
        return None
    if (kube_pod.get("metadata") or {}).get("name") in generic._nominations:
        # the pod holds preemption-freed room: its own reservation must
        # not be charged against it by a shared representative pass
        return None
    try:
        inv = codec.kube_pod_to_pod_info(kube_pod, invalidate_existing=True)
    except Exception:
        return None
    if not generic.vector.pod_eligible(kube_pod, inv):
        return None
    meta = dict(kube_pod.get("metadata") or {})
    meta.pop("ownerReferences", None)
    stripped = dict(kube_pod)
    stripped["metadata"] = meta
    return equivalence_class(stripped)


def pod_chip_demand(inv_info: Any) -> int:
    """Broadcastable card demand (``pod_eligible`` already excluded
    absolute device paths, so ``alpha.gpu/numgpu`` IS the device
    footprint). The JAX package's counterpart counts
    ``alpha.tpu/numchips``: a GPU pod demands 0 there."""
    return sum(
        int(cont.requests.get(grammar.RESOURCE_NUM_GPU, 0))
        for cont in inv_info.running_containers.values())


def free_chip_count(node_ex: Any) -> int:
    """Free cards on a node snapshot (``.../gpu/<UUID>/cards`` leaves) —
    same walk ``_FleetColumns.charge`` runs for the masked filter's
    free-card column."""
    used = node_ex.used
    return sum(
        max(alloc - used.get(path, 0), 0)
        for path, alloc in node_ex.allocatable.items()
        if grammar.gpu_id_from_path(path) is not None)


class CapacityLedger:
    """Cycle-local per-node capacity decrements — the auction's running
    balance. Seeded lazily from a node's pre-first-award snapshot,
    charged on every award (any class), and consulted as a SOUND prune:
    free cards and core headroom are necessary conditions for fit, so a
    node the ledger says cannot cover a class's demand is dropped
    without paying the single-node refit. An unseeded node never prunes
    (``covers`` -> True: no information, refit decides)."""

    def __init__(self) -> None:
        # racer: single-writer -- cycle-local, owned by the scheduling
        # thread that created it; never shared across threads
        self._free_chips: dict = {}   # node -> remaining cards
        # racer: single-writer -- same cycle-local ownership
        self._core_free: dict = {}    # node -> {res: remaining headroom}

    def seed(self, node_name: str, snap: Any) -> None:
        if node_name in self._free_chips or snap is None:
            return
        self._free_chips[node_name] = free_chip_count(snap.node_ex)
        self._core_free[node_name] = {
            res: alloc - snap.requested_core.get(res, 0)
            for res, alloc in snap.core_allocatable.items()}

    def charge(self, node_name: str, chips: int,
               core_requests: dict) -> None:
        if node_name not in self._free_chips:
            return
        self._free_chips[node_name] -= chips
        free = self._core_free[node_name]
        for res, val in core_requests.items():
            if res in free:
                free[res] -= val

    def note_award(self, node_name: str, snap: Any, chips: int,
                   core_requests: dict) -> None:
        """Record one committed award. The FIRST award on a node seeds
        the balance from its POST-award snapshot — the award is already
        subtracted there, so seeding and charging would double-count;
        every later award decrements the running balance."""
        if node_name in self._free_chips:
            self.charge(node_name, chips, core_requests)
        else:
            self.seed(node_name, snap)

    def covers(self, node_name: str, chips: int,
               core_requests: dict) -> bool:
        free_chips = self._free_chips.get(node_name)
        if free_chips is None:
            return True
        if chips > free_chips:
            return False
        free = self._core_free[node_name]
        return all(val <= free[res] for res, val in core_requests.items()
                   if res in free)


class ClassPass:
    """One shared filter/score pass serving every backlog pod of one
    batch class: the representative's feasible set, failure map, cycle
    snapshots and (lazily computed) score table, plus the hosts dirtied
    by awards since the last refresh."""

    __slots__ = ("key", "rep", "pget", "device_class", "chips",
                 "core_requests", "decomposable",
                 "feasible", "failures", "snaps", "scored", "dirty")


def scores_decompose(generic: Any, kube_pod: dict) -> bool:
    """True when a single awarded node can be re-scored in isolation —
    i.e. no configured priority normalizes across the candidate set.
    With the default vector-scorable suite the only cross-node kernel is
    selector spreading, and that one is provably FLAT (MAX_PRIORITY
    everywhere) exactly when the pod has no owner selectors and no
    identifying labels; any other spreading shape forces a full
    re-score of the class after each award."""
    algorithm = generic.algorithm
    if not algorithm.vector_priorities:
        return False
    if not any(name in factory.SPREADING_PRIORITY_NAMES
               for name, _, _ in algorithm.priorities):
        return True
    sels = generic._owner_selectors(kube_pod)
    if sels is None:
        labels = (kube_pod.get("metadata") or {}).get("labels") or {}
        return not any(k != "name" for k in labels)
    return not sels


def open_class_pass(generic: Any, key: str, kube_pod: dict) -> Any:
    """Run the pod-at-a-time filter ONCE for a whole batch class and
    package its outputs as the class's shared pass state. Returns None
    when the pass came back with inter-pod metadata (placed affinity
    pods appeared since the eligibility gate) — the caller then routes
    every member through the serial path, exactly as the serial engine
    itself would have gone scalar."""
    feasible, failures, snaps, meta = generic.find_nodes_that_fit(kube_pod)
    if meta is not None:
        return None
    cp = ClassPass()
    cp.key = key
    cp.rep = kube_pod
    cp.pget = generic._pod_info_provider(kube_pod)
    cp.device_class = generic._device_class(kube_pod)
    cp.chips = pod_chip_demand(cp.pget.inv_info)
    cp.core_requests = dict(pod_core_requests(kube_pod))
    cp.decomposable = scores_decompose(generic, kube_pod)
    cp.feasible = feasible
    cp.failures = failures
    cp.snaps = snaps
    cp.scored = None
    cp.dirty = set()
    return cp


def refresh_class_pass(generic: Any, cp: Any, ledger: Any) -> None:
    """Bring a class's shared pass up to date after awards dirtied some
    hosts: ledger-pruned hosts drop without a refit (sound — awards only
    consume within a cycle), the rest re-run the exact scalar oracle
    (``_fits_on_node``) against a fresh private snapshot, and a host
    that survives is re-scored in isolation when the class's score
    function decomposes, else the whole score table is invalidated."""
    for host in sorted(cp.dirty):
        if host not in cp.feasible:
            continue
        if not ledger.covers(host, cp.chips, cp.core_requests):
            cp.feasible.pop(host, None)
            if cp.scored is not None:
                cp.scored.pop(host, None)
            continue
        fits, _reasons, devscore = generic._fits_on_node(
            cp.rep, host, cp.key, None, cp.pget, cp.device_class,
            None, None)
        snap = generic.cache.snapshot_node(host)
        if snap is not None:
            cp.snaps[host] = snap
        if not fits or snap is None:
            cp.feasible.pop(host, None)
            if cp.scored is not None:
                cp.scored.pop(host, None)
            continue
        cp.feasible[host] = devscore
        if cp.scored is None:
            continue
        if not cp.decomposable:
            cp.scored = None
            continue
        rescored = generic.prioritize_nodes(
            cp.rep, {host: devscore}, cp.snaps, None)
        if host in rescored:
            cp.scored[host] = rescored[host]
        else:
            cp.feasible.pop(host, None)
            cp.scored.pop(host, None)
    cp.dirty.clear()


def pick_host(generic: Any, cp: Any) -> str | None:
    """Batch-side host selection: same max-score + sorted round-robin
    tie-break as the serial ``select_host``, threading the scheduler's
    OWN cursor so a batch cycle and its serial replay make identical
    choices — including the serial fast path that skips scoring (and
    the cursor bump) for a single feasible node."""
    if not cp.feasible:
        return None
    if len(cp.feasible) == 1:
        return next(iter(cp.feasible))
    if cp.scored is None:
        scored = generic.prioritize_nodes(
            cp.rep, dict(cp.feasible), cp.snaps, None)
        if not scored:
            return None
        cp.scored = scored
    best = max(cp.scored.values())
    top = sorted(n for n, s in cp.scored.items() if s == best)
    # racer: single-writer -- scheduling-thread-owned round-robin cursor
    generic._last_node_index += 1
    return top[generic._last_node_index % len(top)]
