"""Vectorized scheduling core: masked filter/score over the fleet columns.

The port's copy of ``kubegpu_tpu/scheduler/vectorized.py`` for NVIDIA
cards, the engine's default filter (``KGTPU_VECTORIZE=0`` turns it off).
It replaces the per-pod x per-node Python predicate loop for the common
case with ONE masked array pass over the struct-of-arrays fleet mirror
(`cache.ColumnarView`):

- The default predicate chain's node gates (conditions, pressure,
  resources) evaluate as boolean masks over all nodes at once, in the
  SAME order the scalar chain runs them, emitting the SAME first-failure
  reason strings.
- The device predicate — the expensive grpalloc search — runs once per
  *canonical device shape* (node inventory modulo which physical card is
  which, see `cache._canonical_paths`) and broadcasts: a fleet of
  identical HGX hosts pays one search per pod class instead of one per
  host. A verdict whose reasons name one of the representative's card
  UUIDs is identity-specific and is never broadcast: each node of that
  shape then pays its own search. The verdict memo is a plain dict owned
  by the scheduling thread, so the device-verdict lock is off the masked
  path entirely (`_run_predicates` keeps it for the scalar fallback
  only).
- The fit memo becomes a boolean mask keyed by the fleet's generation
  vector: a warm pass recomputes exactly the rows whose generation
  moved. The mask memo reads and writes THROUGH the `EquivalenceCache`,
  so scalar and vector passes share verdicts and neither path can serve
  the other a stale result — generation keys are the single invalidation
  currency.
- Scoring assembles the survivors' columns once and runs the default
  priority formulas as array arithmetic.
- Preemption reuses the same canonical-shape verdict memo for its
  evict-and-reprieve fit checks (`FastPreemptFit`), and prunes a node
  whose free cards plus the cards its evictable pods hold cannot cover
  the preemptor's ``alpha.gpu/numgpu``.

Nodes that genuinely need object-level predicates (taints, placed pod
volumes, live nominations) and pods that do (PVC/volume, inter-pod
affinity, auto-topology, explicit device paths, host pinning) fall out
of the mask into the existing scalar path, so behavior is bit-identical
by construction; the scalar path is the differential-test oracle
(`tests/test_torch_vectorized.py`).

Thread contract: one VectorizedFitPass belongs to one GenericScheduler
and is only touched from its scheduling thread — no locks anywhere on
the masked path.
"""

from __future__ import annotations

import os
from typing import Any

import numpy as _np

from kubegpu_tpu_torch.core import grammar
from kubegpu_tpu_torch.core.codec import POD_ANNOTATION_KEY
from kubegpu_tpu_torch.scheduler import priorities as prio_mod
from kubegpu_tpu_torch.scheduler.cache import card_ids
from kubegpu_tpu_torch.scheduler.factory import _is_best_effort as factory_is_best_effort
from kubegpu_tpu_torch.scheduler.predicates import (
    _toleration_tolerates, node_selector_term_matches, pod_core_requests,
    pod_host_ports)

MAX_SHAPE_VERDICTS = 4096
MAX_MASK_CLASSES = 256

_REASON_UNSCHEDULABLE = "node(s) were unschedulable"
_REASON_NOT_READY = "node(s) were not ready"
_REASON_MEM_PRESSURE = "node(s) had MemoryPressure"
_REASON_DISK_PRESSURE = "node(s) had DiskPressure"


def available() -> bool:
    """The kill-switch not thrown (``KGTPU_VECTORIZE=0`` keeps the scalar
    chain, the oracle)."""
    return os.environ.get("KGTPU_VECTORIZE", "1") != "0"


# The masked MemoryPressure gate must use EXACTLY the QoS definition the
# scalar CheckNodeMemoryPressure predicate uses, or the two paths drift:
# one shared implementation, no copy.
_is_best_effort = factory_is_best_effort


def broadcast_class(inv_info: Any) -> tuple:
    """Semantic identity of the pod's device demand as every NON-pinned
    node sees it (the invalidated PodInfo variant: intent only, no
    node-customized ``dev_requests``/``allocate_from``). Two pods with
    equal broadcast classes get identical device verdicts on nodes with
    equal canonical shapes — this is what lets a 4-member gang share one
    allocator search per shape even though their pinned annotations give
    them distinct equivalence classes."""
    parts: list = [tuple(sorted(inv_info.requests.items()))]
    for cname, cont, is_init in inv_info.all_containers():
        parts.append((cname, is_init,
                      tuple(sorted(cont.requests.items())),
                      tuple(sorted(cont.kube_requests.items())),
                      tuple(sorted(cont.scorer.items()))))
    return tuple(parts)


class VectorizedFitPass:
    """One engine's masked filter/score state: the generation-vector
    mask memo and the canonical-shape device-verdict memo."""

    def __init__(self, cache: Any, device_scheduler: Any) -> None:
        self.cache = cache
        self.device_scheduler = device_scheduler
        # (dev_fp, broadcast_class) -> (fits, reasons, score); plain dict
        # + insertion-order LRU, scheduling-thread-owned (no lock — this
        # is the device-verdict lock fix the hot-path report asked for)
        # racer: single-writer -- owned by the engine's scheduling
        # thread; the masked pass and the serial victim scan are the
        # only writers and both run on it
        self._shape_verdicts: dict = {}
        # eq_class -> {"epoch", "n", "gens", "valid", "fits", "scores",
        #              "reasons"} — the fit memo as a mask over the
        # generation vector
        # racer: single-writer -- scheduling-thread-owned, like
        # _shape_verdicts above
        self._mask_memo: dict = {}
        # (alloc_id, annotation string) -> canonical device-contribution
        # tuple: a bound pod's annotation is immutable (the apiserver
        # refuses rewrites), so its canonicalized charge effect per node
        # shape is too — the victim scan's fingerprints skip the PodInfo
        # decode for every pod seen in an earlier pass
        # racer: single-writer -- scheduling-thread-owned, like
        # _shape_verdicts above
        self._contrib_fps: dict = {}

    # ---- pod eligibility ----------------------------------------------------

    def pod_eligible(self, kube_pod: dict, inv_info: Any) -> bool:
        """Can this pod's verdicts be computed by the masked pass and
        broadcast across canonical shapes? Anything requiring object
        predicates or absolute device paths routes to the scalar path.
        Callers have already excluded PVC/volume snapshots and live
        inter-pod metadata. An auto-topology pod
        (``alpha.gpu/gpu-generate-topology: 1``) translates through the
        cluster-wide shape cache, which no node's fingerprint covers, so
        it never broadcasts."""
        if int(inv_info.requests.get(grammar.GPU_TOPOLOGY_GENERATION, 0)
               or 0) == 1:
            return False
        spec = kube_pod.get("spec") or {}
        if spec.get("nodeName") or spec.get("nodeSelector") or \
                spec.get("volumes"):
            return False
        affinity = spec.get("affinity") or {}
        if (affinity.get("nodeAffinity") or {}).get(
                "requiredDuringSchedulingIgnoredDuringExecution"):
            return False
        if pod_host_ports(kube_pod):
            return False
        # absolute device paths pin physical resources: their verdicts
        # are not translation-invariant, so no shape broadcast
        if any(grammar.is_group_resource(res) for res in inv_info.requests):
            return False
        for _name, cont, _init in inv_info.all_containers():
            if any(grammar.is_group_resource(res) for res in cont.requests):
                return False
        return True

    # ---- masked filter ------------------------------------------------------

    # hot-path: pure alloc=12
    # twin-of: kubegpu_tpu_torch.scheduler.core.GenericScheduler._run_predicates
    def run_filter(self, kube_pod: dict, eq_class: str, cols: Any,
                   snaps: dict, nominated: Any,
                   pod_info_get: Any) -> tuple:
        """One masked pass over the fleet. Returns ``(results,
        scalar_names)``: verdicts for every vector-evaluated node and the
        names that fell out of the mask for the scalar path."""
        np = _np
        n = len(cols.names)
        elig = ~(cols.tainted | cols.vol_heavy)
        for name in nominated:
            i = cols.idx.get(name)
            if i is not None:
                elig[i] = False
        scalar_names = [cols.names[i] for i in np.flatnonzero(~elig)]
        if not elig.any():
            return {}, scalar_names

        memo = self._mask_memo.get(eq_class)
        reuse = np.zeros(n, dtype=bool)
        if memo is not None and memo["epoch"] == cols.epoch \
                and memo["n"] == n:
            reuse = elig & memo["valid"] & (memo["gens"] == cols.gen)
        else:
            memo = None
        compute = elig & ~reuse

        results: dict = {}
        reuse_idx = np.flatnonzero(reuse)
        for i in reuse_idx:
            results[cols.names[i]] = (bool(memo["fits"][i]),
                                      memo["reasons"][i],
                                      float(memo["scores"][i]))

        eq_hits = 0
        computed: dict = {}
        comp_idx = np.flatnonzero(compute)
        if len(comp_idx):
            # read-through: verdicts another path (the devolumed sibling
            # split, a scalar fallback pass) already computed at these
            # generations are reused, not recomputed
            gens_sub = {cols.names[i]: int(cols.gen[i]) for i in comp_idx}
            stored = self.cache.equivalence.lookup_many(
                eq_class, gens_sub, {}, record=False)
            if stored:
                eq_hits = len(stored)
                keep = []
                for i in comp_idx:
                    hit = stored.get(cols.names[i])
                    if hit is None:
                        keep.append(i)
                    else:
                        results[cols.names[i]] = hit
                        computed[i] = hit  # fold into the mask memo
                comp_idx = np.array(keep, dtype=np.int64)
        if len(comp_idx):
            self._compute_rows(kube_pod, cols, snaps, pod_info_get,
                               comp_idx, computed, results)

        n_computed = len(computed) - eq_hits
        self.cache.equivalence.record(len(reuse_idx) + eq_hits, n_computed)
        if n_computed:
            self.cache.equivalence.store_many(
                eq_class,
                {cols.names[i]: computed[i] for i in computed},
                {cols.names[i]: int(cols.gen[i]) for i in computed})
        self._store_mask(eq_class, cols, memo, computed)
        return results, scalar_names

    # hot-path: pure alloc=12
    # twin-of: kubegpu_tpu_torch.scheduler.predicates.check_node_condition
    # twin-of: kubegpu_tpu_torch.scheduler.factory._p_memory_pressure
    # twin-of: kubegpu_tpu_torch.scheduler.factory._p_disk_pressure
    # twin-of: kubegpu_tpu_torch.scheduler.predicates.pod_fits_resources
    def _compute_rows(self, kube_pod: dict, cols: Any, snaps: dict,
                      pod_info_get: Any, comp_idx: Any, computed: dict,
                      results: dict) -> None:
        """The predicate chain as masks over the rows in ``comp_idx`` —
        same stage order, same first-failure reasons as the scalar
        chain in `factory.DEFAULT_PREDICATE_NAMES`."""
        np = _np
        pod_requests = pod_core_requests(kube_pod)
        is_be = _is_best_effort(kube_pod)
        undecided = np.zeros(len(cols.gen), dtype=bool)
        undecided[comp_idx] = True

        def _fail(mask: Any, reasons_for: Any) -> None:
            for i in np.flatnonzero(mask):
                verdict = (False, reasons_for(i), 0.0)
                computed[i] = verdict
                results[cols.names[i]] = verdict

        # CheckNodeCondition: unschedulable first, then Ready gates
        m = undecided & cols.unschedulable
        _fail(m, lambda i: [_REASON_UNSCHEDULABLE])
        undecided &= ~m
        m = undecided & (cols.n_notready > 0)
        _fail(m, lambda i: [_REASON_NOT_READY] * int(cols.n_notready[i]))
        undecided &= ~m
        # CheckNodeMemoryPressure (BestEffort pods only) / DiskPressure
        if is_be:
            m = undecided & cols.mem_pressure
            _fail(m, lambda i: [_REASON_MEM_PRESSURE])
            undecided &= ~m
        m = undecided & cols.disk_pressure
        _fail(m, lambda i: [_REASON_DISK_PRESSURE])
        undecided &= ~m
        # PodFitsHost / MatchNodeSelector / Taints / HostPorts: trivially
        # true for eligible pods on untainted nodes (pod_eligible +
        # the taint column excluded everything else).
        # PodFitsResources — per-resource insufficiency masks in request
        # order, reasons stacked exactly like the scalar loop
        res_flags = []
        res_any = np.zeros(len(undecided), dtype=bool)
        for res, req in pod_requests.items():
            alloc = cols.core_alloc.get(res)
            if alloc is None:
                continue  # res absent from every node's allocatable
            insufficient = ~np.isnan(alloc) & \
                (req + cols.core_req[res] > alloc)
            res_flags.append((res, insufficient))
            res_any |= insufficient
        m = undecided & res_any
        _fail(m, lambda i: [f"Insufficient {res}"
                            for res, flags in res_flags if flags[i]])
        undecided &= ~m
        # Volume predicates + CheckVolumeBinding + MatchInterPodAffinity:
        # trivially true (pod has no volumes / no PVC snapshot / no
        # inter-pod metadata; nodes with placed pod volumes fell out).
        # Device predicate: one search per canonical shape, broadcast.
        inv_info = pod_info_get.inv_info
        bclass = broadcast_class(inv_info)
        pinned = pod_info_get.pinned_node
        groups: dict = {}
        for i in np.flatnonzero(undecided):
            name = cols.names[i]
            if name == pinned:
                # the annotated node evaluates the PINNED variant — its
                # verdict is identity-specific, never broadcast
                verdict = self._node_verdict(name, snaps[name].node_ex,
                                             pod_info_get)
                computed[i] = verdict
                results[name] = verdict
                continue
            groups.setdefault(cols.dev_fps[i], []).append(i)
        for fp, rows in groups.items():
            verdict = self._shape_verdict(fp, bclass, cols.names[rows[0]],
                                          snaps, pod_info_get,
                                          cols.canon_maps[rows[0]])
            for i in rows:
                # None: the representative's reasons name one of its
                # cards, so every node of the shape pays its own search
                own = verdict if verdict is not None else self._node_verdict(
                    cols.names[i], snaps[cols.names[i]].node_ex, pod_info_get)
                computed[i] = own
                results[cols.names[i]] = own

    def _node_verdict(self, name: str, node_ex: Any,
                      pod_info_get: Any) -> tuple:
        """One node's own device verdict: the allocator's search."""
        fits, reasons, score = self.device_scheduler.pod_fits_resources(
            pod_info_get(name), node_ex, False)
        return (fits, [str(r) for r in reasons], score)

    # hot-path: pure alloc=8
    def _shape_verdict(self, fp: tuple, bclass: tuple, rep_name: str,
                       snaps: dict, pod_info_get: Any,
                       canon: dict) -> "tuple | None":
        """The device verdict for one canonical shape, computed on a
        live representative and memoized lock-free, or None when the
        verdict's reasons name one of the representative's cards (it is
        then not the shape's, and nothing is stored). The fingerprint
        embeds the node's full allocatable+used state, so no
        invalidation is ever needed (same soundness argument as the
        scalar `_device_verdicts` cache, minus its lock)."""
        key = (fp, bclass)
        hit = self._shape_verdicts.get(key)
        if hit is not None:
            # refresh for LRU-ish capacity eviction
            del self._shape_verdicts[key]
            self._shape_verdicts[key] = hit
            return hit
        verdict = self._node_verdict(rep_name, snaps[rep_name].node_ex,
                                     pod_info_get)
        if _names_card(verdict[1], canon):
            return None
        self._remember(key, verdict)
        return verdict

    def _remember(self, key: tuple, verdict: tuple) -> None:
        if len(self._shape_verdicts) >= MAX_SHAPE_VERDICTS:
            drop = max(1, len(self._shape_verdicts) // 4)
            for k in list(self._shape_verdicts)[:drop]:
                del self._shape_verdicts[k]
        self._shape_verdicts[key] = verdict

    # hot-path: pure alloc=8
    def _store_mask(self, eq_class: str, cols: Any, memo: dict | None,
                    computed: dict) -> None:
        np = _np
        n = len(cols.names)
        if memo is None:
            memo = {"epoch": cols.epoch, "n": n,
                    "gens": np.full(n, -1, dtype=np.int64),
                    "valid": np.zeros(n, dtype=bool),
                    "fits": np.zeros(n, dtype=bool),
                    "scores": np.zeros(n, dtype=np.float64),
                    "reasons": [None] * n}
            if len(self._mask_memo) >= MAX_MASK_CLASSES:
                self._mask_memo.pop(next(iter(self._mask_memo)))
            self._mask_memo[eq_class] = memo
        else:
            # LRU refresh
            self._mask_memo.pop(eq_class, None)
            self._mask_memo[eq_class] = memo
        for i, (fits, reasons, score) in computed.items():
            memo["gens"][i] = cols.gen[i]
            memo["valid"][i] = True
            memo["fits"][i] = fits
            memo["scores"][i] = score
            memo["reasons"][i] = reasons

    # ---- vectorized scoring -------------------------------------------------

    # twin-of: kubegpu_tpu_torch.scheduler.core.GenericScheduler.prioritize_nodes
    def run_scores(self, kube_pod: dict, feasible: dict, snaps: dict,
                   algorithm: Any, owner_selectors: Any) -> dict | None:
        """The default priority suite as array arithmetic over columns
        assembled from the pass's snapshots — same formulas, same
        accumulation order as `prioritize_nodes`' scalar combine, so the
        scores are float-for-float identical. Returns None when an
        unsupported priority is configured (caller falls back)."""
        np = _np
        names = []
        node_snaps = []
        for name in sorted(feasible):
            snap = snaps.get(name) or self.cache.snapshot_node(name)
            if snap is not None:
                names.append(name)
                node_snaps.append(snap)
        if not names:
            return {}
        n = len(names)
        pod_requests = pod_core_requests(kube_pod)
        cols = _ScoreColumns(node_snaps, pod_requests)
        combined = np.array([feasible[name] for name in names]) \
            * prio_mod.MAX_PRIORITY * algorithm.device_weight
        for pname, weight, _batch in algorithm.priorities:
            kernel = _SCORE_KERNELS.get(pname)
            if kernel is None:
                return None
            scores = kernel(kube_pod, pod_requests, cols, node_snaps,
                            owner_selectors)
            if scores is None:
                return None
            combined = combined + weight * scores
        return {name: float(combined[i]) for i, name in enumerate(names)}


class _ScoreColumns:
    """cpu/memory capacity+usage columns for the resource priorities,
    assembled once per scoring pass."""

    __slots__ = ("cpu_cap", "mem_cap", "cpu_used", "mem_used",
                 "cpu_present", "mem_present")

    def __init__(self, node_snaps: list, pod_requests: dict) -> None:
        np = _np
        n = len(node_snaps)
        self.cpu_cap = np.zeros(n)
        self.mem_cap = np.zeros(n)
        self.cpu_used = np.zeros(n)
        self.mem_used = np.zeros(n)
        req_cpu = pod_requests.get("cpu", 0)
        req_mem = pod_requests.get("memory", 0)
        for i, snap in enumerate(node_snaps):
            alloc = snap.core_allocatable
            used = snap.requested_core
            self.cpu_cap[i] = alloc.get("cpu") or 0
            self.mem_cap[i] = alloc.get("memory") or 0
            self.cpu_used[i] = used.get("cpu", 0) + req_cpu
            self.mem_used[i] = used.get("memory", 0) + req_mem
        self.cpu_present = self.cpu_cap != 0
        self.mem_present = self.mem_cap != 0


# hot-path: pure alloc=12
def _fractions(cols: _ScoreColumns) -> tuple:
    """`priorities._fraction` per resource, vectorized: min(max(u/c,0),1)
    with a poisoned denominator masked off afterwards."""
    np = _np
    cpu = np.clip(np.divide(cols.cpu_used,
                            np.where(cols.cpu_present, cols.cpu_cap, 1.0)),
                  0.0, 1.0)
    mem = np.clip(np.divide(cols.mem_used,
                            np.where(cols.mem_present, cols.mem_cap, 1.0)),
                  0.0, 1.0)
    return cpu, mem


# hot-path: pure alloc=8
# twin-of: kubegpu_tpu_torch.scheduler.priorities.least_requested
def _kernel_least_requested(kube_pod, pod_requests, cols, node_snaps, sels):
    np = _np
    cpu_f, mem_f = _fractions(cols)
    total = np.where(cols.cpu_present,
                     (1.0 - cpu_f) * prio_mod.MAX_PRIORITY, 0.0) \
        + np.where(cols.mem_present,
                   (1.0 - mem_f) * prio_mod.MAX_PRIORITY, 0.0)
    count = cols.cpu_present.astype(np.int64) \
        + cols.mem_present.astype(np.int64)
    return np.where(count > 0, total / np.maximum(count, 1),
                    prio_mod.MAX_PRIORITY / 2)


# hot-path: pure alloc=8
# twin-of: kubegpu_tpu_torch.scheduler.priorities.most_requested
def _kernel_most_requested(kube_pod, pod_requests, cols, node_snaps, sels):
    np = _np
    cpu_f, mem_f = _fractions(cols)
    total = np.where(cols.cpu_present, cpu_f * prio_mod.MAX_PRIORITY, 0.0) \
        + np.where(cols.mem_present, mem_f * prio_mod.MAX_PRIORITY, 0.0)
    count = cols.cpu_present.astype(np.int64) \
        + cols.mem_present.astype(np.int64)
    return np.where(count > 0, total / np.maximum(count, 1),
                    prio_mod.MAX_PRIORITY / 2)


# hot-path: pure alloc=8
# twin-of: kubegpu_tpu_torch.scheduler.priorities.balanced_allocation
def _kernel_balanced(kube_pod, pod_requests, cols, node_snaps, sels):
    np = _np
    cpu_f, mem_f = _fractions(cols)
    both = cols.cpu_present & cols.mem_present
    return np.where(both,
                    (1.0 - np.abs(cpu_f - mem_f)) * prio_mod.MAX_PRIORITY,
                    prio_mod.MAX_PRIORITY / 2)


# twin-of: kubegpu_tpu_torch.scheduler.factory._pr_spreading
def _kernel_spreading(kube_pod, pod_requests, cols, node_snaps, sels):
    np = _np
    n = len(node_snaps)
    if sels is None:
        # label-equality fallback (no owner listers)
        labels = (kube_pod.get("metadata") or {}).get("labels") or {}
        ident = {k: v for k, v in labels.items() if k != "name"}
        if not ident:
            return np.full(n, prio_mod.MAX_PRIORITY)
        same = np.zeros(n)
        for i, snap in enumerate(node_snaps):
            same[i] = sum(
                1 for other in snap.pod_labels.values()
                if all(other.get(k) == v for k, v in ident.items()))
        mx = same.max() if n else 0.0
        if mx <= 0:
            return np.full(n, prio_mod.MAX_PRIORITY)
        return (1.0 - same / mx) * prio_mod.MAX_PRIORITY
    if not sels:
        return np.full(n, prio_mod.MAX_PRIORITY)
    counts = np.zeros(n)
    zones = []
    for i, snap in enumerate(node_snaps):
        counts[i] = sum(
            1 for other in snap.pod_labels.values()
            if any(prio_mod.label_selector_matches(sel, other)
                   for sel in sels))
        node_labels = (snap.kube_node.get("metadata") or {}) \
            .get("labels") or {}
        zones.append(prio_mod.zone_key(node_labels))
    mx = int(counts.max()) if n else 0
    by_zone: dict = {}
    for i, z in enumerate(zones):
        if z:
            by_zone[z] = by_zone.get(z, 0) + counts[i]
    zmax = max(by_zone.values(), default=0)
    out = _np.zeros(n)
    for i in range(n):
        score = prio_mod.spread_score(counts[i], mx)
        z = zones[i]
        if by_zone and z:
            zscore = prio_mod.spread_score(by_zone[z], zmax)
            score = (score * (1.0 - prio_mod.ZONE_WEIGHTING)
                     + prio_mod.ZONE_WEIGHTING * zscore)
        out[i] = score
    return out


# twin-of: kubegpu_tpu_torch.scheduler.priorities.node_affinity
def _kernel_node_affinity(kube_pod, pod_requests, cols, node_snaps, sels):
    np = _np
    affinity = ((kube_pod.get("spec") or {}).get("affinity") or {}) \
        .get("nodeAffinity") or {}
    preferred = affinity.get(
        "preferredDuringSchedulingIgnoredDuringExecution") or []
    if not preferred:
        return np.zeros(len(node_snaps))
    total = sum(int(t.get("weight") or 0) for t in preferred)
    if total <= 0:
        return np.zeros(len(node_snaps))
    out = np.zeros(len(node_snaps))
    for i, snap in enumerate(node_snaps):
        labels = (snap.kube_node.get("metadata") or {}).get("labels") or {}
        matched = sum(
            int(t.get("weight") or 0) for t in preferred
            if node_selector_term_matches(labels, t.get("preference") or {}))
        out[i] = matched / total * prio_mod.MAX_PRIORITY
    return out


# twin-of: kubegpu_tpu_torch.scheduler.priorities.taint_toleration
def _kernel_taints(kube_pod, pod_requests, cols, node_snaps, sels):
    np = _np
    tolerations = (kube_pod.get("spec") or {}).get("tolerations") or []
    out = np.full(len(node_snaps), prio_mod.MAX_PRIORITY)
    for i, snap in enumerate(node_snaps):
        taints = (snap.kube_node.get("spec") or {}).get("taints")
        if not taints:
            continue
        intolerable = sum(
            1 for taint in taints
            if taint.get("effect") == "PreferNoSchedule"
            and not any(_toleration_tolerates(t, taint)
                        for t in tolerations))
        out[i] = max(prio_mod.MAX_PRIORITY - intolerable, 0.0)
    return out


# twin-of: kubegpu_tpu_torch.scheduler.priorities.node_prefer_avoid_pods
def _kernel_avoid(kube_pod, pod_requests, cols, node_snaps, sels):
    np = _np
    out = np.full(len(node_snaps), prio_mod.MAX_PRIORITY)
    owner = next(iter((kube_pod.get("metadata") or {})
                      .get("ownerReferences") or []), None)
    if owner is None:
        return out
    facts_cls = prio_mod.NodeFacts
    for i, snap in enumerate(node_snaps):
        ann = ((snap.kube_node.get("metadata") or {})
               .get("annotations") or {})
        if "scheduler.alpha.kubernetes.io/preferAvoidPods" not in ann:
            continue
        facts = facts_cls(snap.kube_node, snap.core_allocatable,
                          snap.requested_core, snap.pod_labels)
        out[i] = prio_mod.node_prefer_avoid_pods(kube_pod, facts)
    return out


# hot-path: pure alloc=4
# twin-of: kubegpu_tpu_torch.scheduler.factory._pr_interpod
def _kernel_interpod(kube_pod, pod_requests, cols, node_snaps, sels):
    # only reachable with meta is None (the engine gates on it): the
    # scalar batch returns 0.0 everywhere in that case
    return _np.zeros(len(node_snaps))


# hot-path: pure alloc=4
# twin-of: kubegpu_tpu_torch.scheduler.priorities.equal_priority
def _kernel_equal(kube_pod, pod_requests, cols, node_snaps, sels):
    return _np.ones(len(node_snaps))


_SCORE_KERNELS = {
    "LeastRequestedPriority": _kernel_least_requested,
    "MostRequestedPriority": _kernel_most_requested,
    "BalancedResourceAllocation": _kernel_balanced,
    "SelectorSpreadPriority": _kernel_spreading,
    "ServiceSpreadingPriority": _kernel_spreading,
    "NodeAffinityPriority": _kernel_node_affinity,
    "TaintTolerationPriority": _kernel_taints,
    "NodePreferAvoidPodsPriority": _kernel_avoid,
    "InterPodAffinityPriority": _kernel_interpod,
    "EqualPriority": _kernel_equal,
}

#: Priority registry names `run_scores` can compute as kernels — the
#: factory consults this to mark an algorithm's priorities vector-safe.
VECTOR_SCORABLE_PRIORITIES = frozenset(_SCORE_KERNELS)


# ---- preemption fast fit ----------------------------------------------------


class FastPreemptFit:
    """Per-preemption-pass fit evaluator for array-eligible preemptors on
    vector-eligible nodes: condition flags off the columns (eviction
    never changes them), resources as plain arithmetic on the mutated
    private snapshot, and the device verdict through the canonical-shape
    memo — the same ``(alloc_id, used-key)`` fingerprint the filter
    broadcasts on, so a uniform fleet's evict-and-reprieve scan pays one
    grpalloc search per distinct post-eviction shape, not ~2 per
    candidate per node. Scheduling-thread-owned; the victim scan runs
    serially when this is active."""

    def __init__(self, vec: VectorizedFitPass, kube_pod: dict,
                 pod_info_get: Any, cols: Any) -> None:
        self.vec = vec
        self.cols = cols
        self.pod_info_get = pod_info_get
        self.pod_requests = pod_core_requests(kube_pod)
        self.is_be = _is_best_effort(kube_pod)
        self.bclass = broadcast_class(pod_info_get.inv_info)
        self.chips_needed = _chips_demand(pod_info_get.inv_info)

    def sim_key(self, snap: Any, ordered_candidates: list,
                pdb_state: list, info_of: Any) -> "tuple | None":
        """Canonical identity of one node's evict-and-reprieve
        simulation: the node's device shape + usage + core state, and
        each candidate victim's (priority, core requests, canonical
        device contribution, PDB-match vector) in phase-2 processing
        order. Two nodes with equal keys run bitwise-identical
        simulations — same reprieve decisions at the same positions,
        same violation count — so the victim scan simulates ONE
        representative per key and maps the chosen indices back to each
        node's own pods (the uniform-fleet scan pays one simulation, not
        one per node). None = this node needs its own scalar simulation
        (off-columns node, tainted, volume-carrying, undecodable pod,
        or the preemptor's pinned node — ``fits()`` evaluates the PINNED
        PodInfo variant there, so its simulation is identity-specific
        and must neither store under nor replay from a shape key)."""
        if snap.name == self.pod_info_get.pinned_node:
            return None
        i = self.cols.idx.get(snap.name)
        if i is None or self.cols.tainted[i] or self.cols.vol_heavy[i]:
            return None
        cols = self.cols
        canon = cols.canon_maps[i]
        node_part = (
            cols.dev_fps[i][0],
            tuple(sorted((canon.get(k, k), v)
                         for k, v in snap.node_ex.used.items() if v)),
            tuple(sorted(snap.core_allocatable.items())),
            tuple(sorted(snap.requested_core.items())),
            bool(cols.unschedulable[i]), int(cols.n_notready[i]),
            bool(cols.mem_pressure[i]), bool(cols.disk_pressure[i]))
        alloc_id = cols.dev_fps[i][0]
        contrib_fps = self.vec._contrib_fps
        cand_parts = []
        for pod in ordered_candidates:
            ann = ((pod.get("metadata") or {}).get("annotations") or {}) \
                .get(POD_ANNOTATION_KEY, "")
            ckey = (alloc_id, ann)
            conts = contrib_fps.get(ckey)
            if conts is None:
                try:
                    info = info_of(pod)
                except Exception:
                    return None
                conts = []
                for conts_map, is_init in ((info.running_containers, False),
                                           (info.init_containers, True)):
                    for cname in sorted(conts_map):
                        cont = conts_map[cname]
                        conts.append((is_init, tuple(sorted(
                            (canon.get(rr, rr), canon.get(af, af),
                             cont.dev_requests.get(rr, 0))
                            for rr, af in cont.allocate_from.items()))))
                conts = tuple(conts)
                if len(contrib_fps) >= MAX_SHAPE_VERDICTS:
                    for k in list(contrib_fps)[:MAX_SHAPE_VERDICTS // 4]:
                        del contrib_fps[k]
                contrib_fps[ckey] = conts
            labels = (pod.get("metadata") or {}).get("labels") or {}
            pdb_match = tuple(
                j for j, s in enumerate(pdb_state)
                if all(labels.get(k) == v
                       for k, v in s["selector"].items()))
            cand_parts.append((
                int((pod.get("spec") or {}).get("priority") or 0),
                tuple(sorted(pod_core_requests(pod).items())),
                conts, pdb_match))
        return (node_part, tuple(cand_parts))

    def might_fit_after_full_eviction(self, name: str, prio: int,
                                      pods_by_name: dict,
                                      snap: Any) -> bool:
        """Card-capacity upper bound: free cards plus every evictable
        pod's charged cards must cover the demand, or phase 1 of the
        simulation cannot succeed. Over-approximate by construction
        (grpalloc can never place more cards than free leaves), so a
        pruned node is EXACTLY a node the full simulation would reject."""
        if self.chips_needed <= 0:
            return True
        i = self.cols.idx.get(name)
        if i is None:
            return True
        cached = self.cache_node(name)
        if cached is None:
            return True
        free = int(self.cols.free_chips[i])
        evictable = 0
        for pod_name in snap.pod_names:
            pod = pods_by_name.get(pod_name)
            if pod is None:
                continue
            if int((pod.get("spec") or {}).get("priority") or 0) < prio:
                evictable += cached.pod_chips.get(pod_name, 0)
        return free + evictable >= self.chips_needed

    def cache_node(self, name: str) -> Any:
        return self.vec.cache.get_node(name)

    # hot-path: pure alloc=10
    # twin-of: kubegpu_tpu_torch.scheduler.core.GenericScheduler._fits_after_evictions
    def fits(self, snap: Any) -> "bool | None":
        """The full-chain verdict for the mutated snapshot, or None when
        this node needs the scalar chain after all."""
        i = self.cols.idx.get(snap.name)
        if i is None or self.cols.tainted[i] or self.cols.vol_heavy[i]:
            return None
        cols = self.cols
        if cols.unschedulable[i] or cols.n_notready[i] > 0:
            return False
        if self.is_be and cols.mem_pressure[i]:
            return False
        if cols.disk_pressure[i]:
            return False
        alloc = snap.core_allocatable
        used = snap.requested_core
        for res, req in self.pod_requests.items():
            cap = alloc.get(res)
            if cap is None:
                continue
            if req + used.get(res, 0) > cap:
                return False
        if snap.name == self.pod_info_get.pinned_node:
            # pinned variant: identity-specific, never memoized
            fits, _, _ = self.vec.device_scheduler.pod_fits_resources(
                self.pod_info_get(snap.name), snap.node_ex, False)
            return fits
        canon = cols.canon_maps[i]
        node_used = snap.node_ex.used
        used_key = tuple(sorted(
            (canon.get(k, k), v) for k, v in node_used.items() if v))
        fp = (cols.dev_fps[i][0], used_key)
        verdict = self.vec._shape_verdicts.get((fp, self.bclass))
        if verdict is None:
            verdict = self.vec._node_verdict(snap.name, snap.node_ex,
                                             self.pod_info_get)
            if not _names_card(verdict[1], canon):
                self.vec._remember((fp, self.bclass), verdict)
        return verdict[0]


def _chips_demand(inv_info: Any) -> int:
    """Cards the pod demands, ``alpha.gpu/numgpu`` (running sum, init max
    — the effective request the allocator must place). The JAX package's
    counterpart counts ``alpha.tpu/numchips``, so a GPU pod demands 0
    there and its prune never fires."""
    running = sum(
        int(c.requests.get(grammar.RESOURCE_NUM_GPU, 0))
        for c in inv_info.running_containers.values())
    init = max(
        (int(c.requests.get(grammar.RESOURCE_NUM_GPU, 0))
         for c in inv_info.init_containers.values()), default=0)
    return max(running, init)


def _names_card(reasons: list, canon: dict) -> bool:
    """True when a reason string names one of the node's card UUIDs: such
    a verdict belongs to that node, not to its canonical shape."""
    if not reasons:
        return False
    ids = card_ids(canon)
    return any(uuid in reason for reason in reasons for uuid in ids)
