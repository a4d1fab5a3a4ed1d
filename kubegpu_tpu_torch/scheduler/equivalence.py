"""Equivalence cache: memoize predicate results per (pod-class, node).

Reference: `kube-scheduler/pkg/core/equivalence_cache.go` (222 LoC) — pods
from the same controller are equivalent for predicate purposes, so the
filter pass can reuse the previous pod's per-node results instead of
re-running the full chain.

Invalidation is generation-driven: ``SchedulerCache`` owns a per-node
generation counter bumped on every fit-relevant node change (watch
update, pod charge/release, assume/forget, node delete). Entries here are
stored with the generation they were computed against and served only
while it still matches — a 100-pod stream of one class against a 100-node
cluster runs the full chain once per node total, plus once per node that
received a pod since the class was last evaluated.

Entries are additionally keyed by the node's *nominated-reservation
fingerprint* (the sorted names of live nominated preemptors charged into
the verdict): a verdict computed while preemption-freed room was reserved
is only reused while the same reservations stand, and naturally misses
once they bind or expire — no TTL-driven invalidation hook needed.

The equivalence class is the controller UID when the pod has an owner
(upstream behavior), else a hash of the scheduling-relevant fields: spec
plus identifying labels plus the ``requests`` half of the device
annotation (``allocate_from`` is output, not identity).
"""

from __future__ import annotations

import hashlib
import json
import threading

from kubegpu_tpu_torch import metrics
from kubegpu_tpu_torch.core.codec import POD_ANNOTATION_KEY


def equivalence_class(kube_pod: dict) -> str:
    meta = kube_pod.get("metadata") or {}
    for owner in meta.get("ownerReferences") or []:
        if owner.get("uid"):
            return f"owner:{owner['uid']}"
    ident = {
        "spec": kube_pod.get("spec") or {},
        "labels": meta.get("labels") or {},
        # namespace-sensitive predicates (inter-pod affinity terms default
        # to the pod's own namespace) must not share verdicts across
        # namespaces
        "namespace": meta.get("namespace") or "default",
    }
    ann = (meta.get("annotations") or {}).get(POD_ANNOTATION_KEY)
    if ann:
        try:
            dev = json.loads(ann)
            # keep request identity, drop the pod's own identity and the
            # placement output (wire keys per `types.PodInfo.to_json`)
            for key in ("podname", "nodename"):
                dev.pop(key, None)
            for cont in list((dev.get("initcontainer") or {}).values()) + \
                    list((dev.get("runningcontainer") or {}).values()):
                cont.pop("allocatefrom", None)
            ident["device"] = dev
        except (TypeError, ValueError):
            ident["device"] = ann
    blob = json.dumps(ident, sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()


def devolumed_class(kube_pod: dict) -> tuple:
    """``(equivalence class, pod copy)`` of the pod with ``spec.volumes``
    stripped — the pod's *devolumed sibling*. Predicate verdicts are
    monotone in volumes (adding volumes only adds failure modes: disk
    conflicts, attach caps, zone pins, binding requirements), so a
    NEGATIVE sibling verdict is a sound negative for the real pod, and a
    positive one reduces the remaining work to the volume-reading
    predicates alone. This is what lets a PVC-referencing pod — whose own
    verdict moves with cluster-wide PV state and is therefore
    unmemoizable per node — still share the expensive non-volume chain
    (device search included) with its volume-less class."""
    spec = dict(kube_pod.get("spec") or {})
    spec.pop("volumes", None)
    stripped = dict(kube_pod)
    stripped["spec"] = spec
    return equivalence_class(stripped), stripped


MAX_CLASSES_PER_NODE = 512


class EquivalenceCache:
    """Pure memo store; ``SchedulerCache`` owns the generations. Lookup
    serves an entry only when its stored generation equals the caller's —
    a store computed from a pre-invalidation snapshot lands under the old
    generation and is simply never served (the upstream equivalence-cache
    race, resolved by construction). Per-node maps are bounded
    (oldest-first eviction) so ownerless one-off pods cannot grow the
    cache without limit."""

    def __init__(self):
        self._lock = threading.Lock()
        # node name -> {(class, nom_fp) -> (generation, result)}
        self._by_node: dict = {}
        self.hits = 0
        self.misses = 0

    def lookup(self, node_name: str, eq_class: str, generation: int,
               nom_fp: tuple = (), record: bool = True):
        """The memoized ``(fits, reasons, score)`` for this class against
        this node at this generation, or None. ``record=False`` peeks
        without touching hit/miss accounting (best-effort consumers like
        preemption pruning must not skew the fit pass's hit rate)."""
        with self._lock:
            entry = self._by_node.get(node_name, {}).get((eq_class, nom_fp))
            hit = entry[1] if entry is not None and entry[0] == generation \
                else None
            if record:
                if hit is None:
                    self.misses += 1
                else:
                    self.hits += 1
        if record:
            (metrics.FIT_CACHE_MISSES if hit is None
             else metrics.FIT_CACHE_HITS).inc()
        return hit

    def lookup_many(self, eq_class: str, gens: dict, nom_fps: dict,
                    record: bool = True) -> dict:
        """Batch lookup for a whole filter pass under ONE lock
        acquisition: {node: result} for every node in ``gens`` whose entry
        matches its generation (and its nomination fingerprint from
        ``nom_fps``, default ``()``). Per-node lookups from 16 parallel
        fit workers convoyed on this lock; the pass now resolves every
        hit serially — plain dict gets — and dispatches only the misses.
        ``record=False`` peeks without hit/miss accounting (the
        vectorized pass does its own, folding mask-memo reuse in)."""
        out: dict = {}
        with self._lock:
            for node_name, gen in gens.items():
                entry = self._by_node.get(node_name, {}) \
                    .get((eq_class, nom_fps.get(node_name, ())))
                if entry is not None and entry[0] == gen:
                    out[node_name] = entry[1]
            if record:
                self.hits += len(out)
                self.misses += len(gens) - len(out)
        if record:
            if out:
                metrics.FIT_CACHE_HITS.inc(len(out))
            if len(gens) > len(out):
                metrics.FIT_CACHE_MISSES.inc(len(gens) - len(out))
        return out

    def record(self, hits: int, misses: int) -> None:
        """Fold externally-resolved lookups into the hit/miss accounting
        — the vectorized pass serves most verdicts from its generation-
        vector mask memo and reports them here so the fit-memo
        effectiveness counters keep describing the WHOLE filter path."""
        with self._lock:
            self.hits += hits
            self.misses += misses
        if hits:
            metrics.FIT_CACHE_HITS.inc(hits)
        if misses:
            metrics.FIT_CACHE_MISSES.inc(misses)

    def store_many(self, eq_class: str, results: dict, gens: dict,
                   nom_fp: tuple = ()) -> None:
        """Batch store under ONE lock acquisition: ``results`` maps node
        -> verdict, ``gens`` node -> the generation it was computed
        against. Same monotonic-generation guard as ``store``."""
        with self._lock:
            for node_name, result in results.items():
                classes = self._by_node.setdefault(node_name, {})
                existing = classes.get((eq_class, nom_fp))
                if existing is not None and existing[0] > gens[node_name]:
                    continue
                if len(classes) >= MAX_CLASSES_PER_NODE:
                    classes.pop(next(iter(classes)))
                classes[(eq_class, nom_fp)] = (gens[node_name], result)

    def store(self, node_name: str, eq_class: str, generation: int,
              result, nom_fp: tuple = ()) -> None:
        with self._lock:
            classes = self._by_node.setdefault(node_name, {})
            existing = classes.get((eq_class, nom_fp))
            if existing is not None and existing[0] > generation:
                # generations are monotonic: a slow pass finishing late
                # must not evict the fresher entry a newer pass stored
                # (its own entry could never be served anyway)
                return
            if len(classes) >= MAX_CLASSES_PER_NODE:
                classes.pop(next(iter(classes)))
            classes[(eq_class, nom_fp)] = (generation, result)

    def drop_node(self, node_name: str) -> None:
        """Memory hygiene on node removal; staleness itself is handled by
        the generation mismatch (generations outlive the node so a
        delete + re-add cannot resurrect old verdicts)."""
        with self._lock:
            self._by_node.pop(node_name, None)
