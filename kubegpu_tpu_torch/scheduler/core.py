"""The standalone scheduling engine.

Replaces the reference's forked kube-scheduler (SURVEY.md §2 row 16) with a
compact engine exposing the same pipeline and the same five device
touch-points (§2.8), shaped like the modern scheduler-framework:

    pop -> filter (core fit + PodFitsDevices) -> score -> select host
        -> allocate devices (fills allocate_from, writes pod annotation)
        -> assume (charge cache) -> bind (annotation first, then binding)

Scheduling state is rebuilt from the API server on restart — the cache is
disposable, annotations are the checkpoint (SURVEY.md §6).

The port's copy of ``kubegpu_tpu/scheduler/core.py`` for NVIDIA cards, on
the JAX engine's default path: one cycle drains the ready backlog and
schedules it as one assignment problem (``scheduler/batch.py``), and the
filter is one masked pass over the fleet's columns with one allocator
search per canonical device shape (``scheduler/vectorized.py``).
``KGTPU_BATCH=0`` and ``KGTPU_VECTORIZE=0`` keep the scalar path, one pod a
cycle and the predicate chain node by node, which is the oracle: both
paths place every pod alike. The engine differs from the JAX one where
that counts TPU chips only: auto-topology pods
(``alpha.gpu/gpu-generate-topology``) bypass the per-node caches and the
masked pass, the room held for nominated preemptors, the batch ledger,
the preemption prune and the fleet columns count ``alpha.gpu/numgpu`` and
card leaves, GPU nodes have a canonical shape (their cards' UUIDs ranked),
and gangs are planned host by host (``scheduler/gang.py``). A gang that
does not fit preempts by pod-sets released host by host
(`Scheduler._try_gang_preempt`), where the JAX engine searches
ICI-contiguous blocks.
"""

from __future__ import annotations

import contextlib
import copy
import logging
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Iterable

from kubegpu_tpu_torch import metrics, obs
from kubegpu_tpu_torch.analysis.explore import probe
from kubegpu_tpu_torch.cluster.httpapi import Conflict, NotFound, QuotaExceeded
from kubegpu_tpu_torch.core import codec, grammar
from kubegpu_tpu_torch.scheduler import (batch, factory, interpod,
                                         predicates, priorities, vectorized)
from kubegpu_tpu_torch.scheduler.cache import SchedulerCache
from kubegpu_tpu_torch.scheduler.equivalence import (devolumed_class,
                                                     equivalence_class)
from kubegpu_tpu_torch.scheduler.gang import (RESOURCE_GANG,
                                              RESOURCE_GANG_SIZE, GangBuffer,
                                              GangPlanner,
                                              annotate_gang_processes,
                                              gang_key)
from kubegpu_tpu_torch.scheduler.queue import SchedulingQueue
from kubegpu_tpu_torch.scheduler.volumebinder import VolumeBinder
from kubegpu_tpu_torch.utils import list_bound_pods

log = logging.getLogger(__name__)

# Parallel fit evaluation width (reference: 16 workers,
# `core/generic_scheduler.go:310-383`).
DEFAULT_PARALLELISM = 16


class FitError(Exception):
    def __init__(self, pod_name: str, failures: dict) -> None:
        self.pod_name = pod_name
        self.failures = failures  # node name -> [reason strings]
        super().__init__(f"pod {pod_name} fits no node: {failures}")


_pod_core_requests = predicates.pod_core_requests


def _pod_priority(kube_pod: dict) -> int:
    return int((kube_pod.get("spec") or {}).get("priority") or 0)


class GenericScheduler:
    """Fit/score/select/allocate (`core/generic_scheduler.go:130-188`)."""

    def __init__(self, cache: SchedulerCache, device_scheduler: Any,
                 parallelism: int = DEFAULT_PARALLELISM,
                 extenders: list | None = None,
                 priority_weights: dict | None = None,
                 algorithm: factory.AlgorithmConfig | None = None) -> None:
        self.cache = cache
        self.device_scheduler = device_scheduler
        self.parallelism = max(1, parallelism)
        self.extenders = extenders or []
        # Predicate/priority composition: an explicit AlgorithmConfig (from
        # a Policy file via `factory.algorithm_from_policy`) wins; else the
        # default provider with optional per-priority weight overrides.
        self.algorithm = algorithm or factory.default_algorithm(priority_weights)
        # Vectorized scheduling core (scheduler/vectorized.py): one masked
        # array pass per class replaces the per-node predicate loop when
        # the algorithm is the default chain and the pod is array-eligible.
        # None when KGTPU_VECTORIZE=0 — every consumer then takes the
        # scalar path unchanged.
        self.vector = vectorized.VectorizedFitPass(cache, device_scheduler) \
            if vectorized.available() and self.algorithm.vector_predicates \
            else None
        self._last_node_index = 0
        # Device-verdict shape cache: (node shape_key, pod device class) ->
        # (fits, reasons, score). A uniform 64-host fleet runs the grpalloc
        # backtracking search ONCE per pod class instead of once per node —
        # the reference's tree-shape cluster-cache idea (`gpu.go:102-183`)
        # applied to the fit pass. No invalidation needed: the key embeds
        # the node's full allocatable+used state.
        self._device_verdicts: dict = {}
        self._device_lock = threading.Lock()
        self._device_inflight: dict = {}  # dev_key -> threading.Event
        self._owner_cache = None  # (expires, owner listings | None)
        # Set by Scheduler; None = no volume surface (predicate no-ops).
        self.volume_binder = None
        # Nominated preemptors: pod name -> (node, expiry, pod snapshot).
        # The room preemption freed is spoken-for until the preemptor
        # binds, its nomination expires, or the pod is deleted
        # (`generic_scheduler.go:226-290` routes the preemptor back with
        # its annotation visible; here other pods' fit passes charge the
        # nominated pod's demand onto the node, see `_fits_on_node`).
        self._nominations: dict = {}
        self._nom_lock = threading.Lock()
        self._pool = ThreadPoolExecutor(
            max_workers=self.parallelism, thread_name_prefix="fit",
            initializer=lambda: obs.register_thread("fit-pool"))
        # Memo-safety gate (see predicates.py): every configured predicate
        # must declare what it reads, or the equivalence memo stays off
        # for every pod — the generation counters can only invalidate
        # reads they know about. The volume-reading subset is what the
        # devolumed-split path re-runs against the real pod.
        self._memo_safe = all(
            getattr(fn, "reads", None) is not None
            for _, fn in self.algorithm.predicates)
        self._volume_predicates = [
            (name, fn) for name, fn in self.algorithm.predicates
            if getattr(fn, "reads", factory.VOLUME_READS)
            & factory.VOLUME_READS]

    def _parallel_map(self, fn: Callable[[Any], Any],
                      items: Iterable[Any]) -> list:
        """Order-preserving pool map in node-list chunks, not one task
        per node: at 64+ nodes the per-task queue/lock overhead of
        Executor.map dominated the (mostly GIL-serialized) per-node work
        — ~9.7k futures per preemption bench run, ~0.6 s of pure
        dispatch. One chunk per worker keeps the native-allocator calls
        (``native.grp_allocate``, a ctypes call, which DOES release the
        GIL) running concurrently.

        The effective width adapts to the live item count each cycle:
        a 2-node cluster submits 2 chunks, so the (lazily-spawned) pool
        never grows past 2 threads for it — 16 workers for a handful of
        nodes was pure dispatch overhead."""
        items = list(items)
        width = min(self.parallelism, len(items))
        if width <= 1:
            return [fn(x) for x in items]
        n = -(-len(items) // width)
        chunks = [items[i:i + n] for i in range(0, len(items), n)]
        out = []
        for part in self._pool.map(lambda c: [fn(x) for x in c], chunks):
            out.extend(part)
        return out

    # ---- predicates --------------------------------------------------------

    _AUTO_META = object()  # sentinel: compute inter-pod metadata if needed

    def _interpod_meta(self, kube_pod: dict) -> Any:
        """Cluster-wide inter-pod-affinity metadata, or None when neither
        the incoming pod nor any placed pod declares any — the gate that
        keeps affinity free for the common case (`metadata.go` analogue)."""
        if interpod.pod_declares_interpod_affinity(kube_pod) or \
                self.cache.has_affinity_pods():
            return self.cache.interpod_snapshot()
        return None

    def _pod_info_provider(self, kube_pod: dict) -> Callable[[str], Any]:
        """Parse the pod's device annotation ONCE per scheduling pass and
        hand out clones per node (same semantics as
        `cache.pod_info_for_node`, minus the per-node JSON decode — the
        old shape re-parsed the annotation for every node in the filter).
        Thread-safe: both variants are parsed eagerly before the parallel
        workers start; clones are per-call."""
        base = codec.kube_pod_to_pod_info(kube_pod, invalidate_existing=False)
        inv = codec.kube_pod_to_pod_info(kube_pod, invalidate_existing=True)

        def get(node_name: str) -> Any:
            return (base if base.node_name == node_name else inv).clone()
        # exposed so the device-verdict cache can tell WHICH variant a
        # node evaluates: the pod's annotated node sees the pinned
        # allocation, everyone else the invalidated one; the vectorized
        # pass reads the invalidated PodInfo directly to derive the
        # broadcastable demand class
        get.pinned_node = base.node_name
        get.inv_info = inv
        return get

    # ---- nominated-node reservations --------------------------------------

    NOMINATION_TTL_S = 30.0

    def nominate(self, kube_pod: dict, node_name: str,
                 ttl_s: float | None = None) -> None:
        """Reserve the room preemption just freed on ``node_name`` for this
        pod until it binds or the TTL expires."""
        name = kube_pod["metadata"]["name"]
        expires = time.monotonic() + (ttl_s if ttl_s is not None
                                      else self.NOMINATION_TTL_S)
        with self._nom_lock:
            self._nominations[name] = (node_name, expires,
                                       copy.deepcopy(kube_pod))

    def clear_nomination(self, pod_name: str) -> None:
        with self._nom_lock:
            self._nominations.pop(pod_name, None)

    def _nominations_by_node(self, exclude: str, min_priority: int) -> dict:
        """Live nominations grouped by node in ONE lock pass. The filter
        pass consults this instead of `_nominated_pods_on` per node — a
        lock round per node per pod from 16 workers convoyed here."""
        now = time.monotonic()
        out: dict = {}
        with self._nom_lock:
            for name in list(self._nominations):
                node, expires, pod = self._nominations[name]
                if expires <= now:
                    del self._nominations[name]
                    continue
                if name != exclude and _pod_priority(pod) >= min_priority:
                    out.setdefault(node, []).append(pod)
        return out

    def _nominated_pods_on(self, node_name: str, exclude: str,
                           min_priority: int) -> list:
        """Live nominations on ``node_name`` that an incoming pod of
        ``min_priority`` must respect: only nominated pods of >= priority
        hold their room (a strictly higher-priority pod may take it, like
        upstream), and a pod never blocks on its own nomination."""
        return self._nominations_by_node(exclude, min_priority) \
            .get(node_name, [])

    def _charge_nominated(self, nominated: list, snap: Any) -> None:
        """Charge nominated pods' demand onto a (private) fit snapshot:
        core requests always; device demand via a simulated allocation
        (the nominated pod has no allocate_from yet — its cards are
        whichever ones a fresh allocation would take). Ports/labels are
        not charged, matching upstream's resource-only treatment of
        nominated pods."""
        for pod in nominated:
            try:
                info = self.cache.pod_info_for_node(pod, snap.name)
                self.device_scheduler.pod_allocate(info, snap.node_ex)
                self.device_scheduler.take_pod_resources(info, snap.node_ex)
            except Exception:
                # freed room already retaken: the reservation is dead —
                # charge nothing (core charges included)
                log.debug("nominated pod %s no longer charges on %s",
                          (pod.get("metadata") or {}).get("name"),
                          snap.name, exc_info=True)
                continue
            for res, val in _pod_core_requests(pod).items():
                snap.requested_core[res] = \
                    snap.requested_core.get(res, 0) + val

    def _nominated_chip_reservation(self, exclude: set,
                                    min_priority: int) -> dict:
        """{node: card count} owed to live nominated preemptors of >=
        ``min_priority`` (excluding ``exclude`` names) — the gang
        planner's analogue of `_charge_nominated`: a gang must not
        swallow the room a single-pod preemption just freed. The cards
        are the preemptors' ``alpha.gpu/numgpu``."""
        now = time.monotonic()
        out: dict = {}
        with self._nom_lock:
            items = [(name, *self._nominations[name])
                     for name in list(self._nominations)]
        for name, node, expires, pod in items:
            if expires <= now or name in exclude or \
                    _pod_priority(pod) < min_priority:
                continue
            try:
                info = codec.kube_pod_to_pod_info(pod,
                                                  invalidate_existing=False)
                cards = sum(
                    int(c.requests.get(grammar.RESOURCE_NUM_GPU, 0))
                    for c in info.running_containers.values())
            except Exception:
                log.debug("unreadable nomination snapshot for %s; "
                          "reserving nothing for it", name, exc_info=True)
                continue
            if cards > 0:
                out[node] = out.get(node, 0) + cards
        return out

    def _volume_snapshot(self, kube_pod: dict) -> Any:
        """Pass-level PV/PVC snapshot for CheckVolumeBinding, or None when
        the pod references no PVCs / no binder is wired."""
        if self.volume_binder is None:
            return None
        return self.volume_binder.snapshot(kube_pod)

    def _fits_on_node(self, kube_pod: dict, node_name: str,
                      eq_class: str | None = None,
                      meta: Any = _AUTO_META, pod_info_get: Any = None,
                      device_class: Any = _AUTO_META,
                      eq_gen: int | None = None,
                      vol: Any = _AUTO_META, snap: Any = None,
                      vol_split: Any = None,
                      nominated: Any = None, memo_checked: bool = False,
                      sibling_hit: Any = None,
                      out_snaps: dict | None = None) -> tuple:
        """The full predicate chain against a point-in-time snapshot so
        concurrent watcher mutations of node usage cannot tear mid-fit.
        Order mirrors the reference providers: cheap node gates first, the
        device predicate (`devicepredicate.go:11-26`) last.

        ``snap`` is the node's shared cycle snapshot (read-only; the pass
        obtains all of them in one lock acquisition); a direct call
        without one takes a private snapshot. ``eq_gen`` is the node's fit
        generation captured with that snapshot — it must predate
        EVERYTHING the verdict reads, the inter-pod metadata included, so
        a node change while we compute makes the stored result land under
        a generation that is never served again instead of poisoning the
        cache (the upstream equivalence-cache race).

        Memoized verdicts are keyed by (class, generation, nominated-
        reservation fingerprint): a verdict computed with preemption-freed
        room charged stays reusable while the same reservations stand and
        naturally misses once they bind or expire. ``vol_split`` routes a
        PVC-referencing pod through its devolumed sibling class (see
        `equivalence.devolumed_class`): the expensive non-volume chain is
        shared with the volume-less class, then only the volume-reading
        predicates run against the real pod.

        The filter pass precomputes ``nominated`` (one lock pass for the
        whole cluster) and resolves the memo serially via ``lookup_many``
        — it passes ``memo_checked=True`` (with any positive sibling
        verdict as ``sibling_hit``) so only the store happens here. A
        direct call does its own per-node lookups."""
        if nominated is None:
            nominated = self._nominated_pods_on(
                node_name, exclude=kube_pod["metadata"]["name"],
                min_priority=_pod_priority(kube_pod))
        nom_fp = tuple(sorted(p["metadata"]["name"] for p in nominated))
        if eq_gen is None and (eq_class is not None or vol_split is not None):
            eq_gen = self.cache.node_generation(node_name)
        if eq_class is not None and not memo_checked:
            hit = self.cache.equivalence.lookup(
                node_name, eq_class, eq_gen, nom_fp)
            if hit is not None:
                return hit
        if meta is self._AUTO_META:
            meta = self._interpod_meta(kube_pod)
        if vol is self._AUTO_META:
            vol = self._volume_snapshot(kube_pod)
        if snap is None or nominated:
            # no shared snapshot, or about to charge nominated demand:
            # take a private (mutable) one — shared cycle snapshots are
            # immutable by contract
            snap = self.cache.snapshot_node(node_name)
        if snap is None:
            return False, ["node gone"], 0.0
        if nominated:
            self._charge_nominated(nominated, snap)
            if out_snaps is not None:
                # hand the charged private snapshot back so the scoring
                # pass ranks this node with the reservation's demand
                # accounted, not the uncharged cycle snapshot
                out_snaps[node_name] = snap
        if device_class is self._AUTO_META:
            device_class = self._device_class(kube_pod)
        if vol_split is not None:
            sibling_class, stripped_pod = vol_split
            stored = sibling_hit
            if stored is None and not memo_checked:
                stored = self.cache.equivalence.lookup(
                    node_name, sibling_class, eq_gen, nom_fp)
            if stored is None:
                stored = self._run_predicates(
                    stripped_pod, snap, meta, pod_info_get, device_class,
                    vol)
                self.cache.equivalence.store(
                    node_name, sibling_class, eq_gen, stored, nom_fp)
            if not stored[0]:
                # verdicts are monotone in volumes: the sibling's failure
                # is the real pod's failure — this is what prunes a full
                # fleet down to the nodes worth evaluating
                return stored
            ctx = factory.PredicateContext(kube_pod, snap, meta, vol)
            for _name, pred in self._volume_predicates:
                ok, reasons = pred(ctx)
                if not ok:
                    return False, reasons, 0.0
            return stored
        result = self._run_predicates(
            kube_pod, snap, meta, pod_info_get, device_class, vol)
        if eq_class is not None:
            self.cache.equivalence.store(
                node_name, eq_class, eq_gen, result, nom_fp)
        return result

    MAX_DEVICE_VERDICTS = 4096

    @staticmethod
    def _requests_auto_topology(kube_pod: dict) -> bool:
        """True when the pod asks for topology auto-generation
        (``alpha.gpu/gpu-generate-topology: 1``). Such pods translate via
        the CLUSTER-wide shape cache (`gpu_scheduler.py`
        ShapeCache.best_tree), which moves on any node add/remove/usage
        change — so no per-node-keyed cache entry for them can be
        invalidated by per-node events, and both the device-verdict cache
        and the equivalence cache must be bypassed."""
        import json as _json

        meta = kube_pod.get("metadata") or {}
        ann = (meta.get("annotations") or {}).get(codec.POD_ANNOTATION_KEY)
        if not ann:
            return False
        try:
            pod_requests = _json.loads(ann).get("requests") or {}
            return int(pod_requests.get(
                grammar.GPU_TOPOLOGY_GENERATION, 0) or 0) == 1
        except (TypeError, ValueError):
            return False

    @staticmethod
    def _device_class(kube_pod: dict, auto_topology: bool | None = None) -> str | None:
        """Identity of a pod's device demand: the device annotation
        (INCLUDING allocate_from, so gang-pinned pods never share entries)
        plus the container resource blocks. The pod's own name and node
        pin are canonicalized OUT of the annotation — they are identity,
        not demand — so a steady stream of same-shaped pods shares one
        verdict per node shape across passes instead of re-running the
        backtracking search once per pod. Unlike `equivalence_class`,
        this must key only what `pod_fits_device` reads. None = do not
        cache (auto-topology pods, see `_requests_auto_topology`);
        callers that already computed the flag pass it to skip the
        annotation re-parse."""
        import hashlib
        import json as _json

        if auto_topology is None:
            auto_topology = GenericScheduler._requests_auto_topology(kube_pod)
        if auto_topology:
            return None
        meta = kube_pod.get("metadata") or {}
        ann = (meta.get("annotations") or {}).get(codec.POD_ANNOTATION_KEY) or ""
        if ann:
            try:
                dev = _json.loads(ann)
                dev.pop("podname", None)
                dev.pop("nodename", None)
                ann = _json.dumps(dev, sort_keys=True, default=str)
            except (TypeError, ValueError):
                pass  # unparseable: the raw string is still a sound key
        spec = kube_pod.get("spec") or {}
        res = _json.dumps(
            [(c.get("name"), c.get("resources")) for c in
             (spec.get("initContainers") or []) + (spec.get("containers") or [])],
            sort_keys=True, default=str)
        return hashlib.sha256(f"{ann}|{res}".encode()).hexdigest()

    def _run_predicates(self, kube_pod: dict, snap: Any,
                        meta: Any = None,
                        pod_info_get: Any = None,
                        device_class: str | None = None,
                        vol: Any = None) -> tuple:
        ctx = factory.PredicateContext(kube_pod, snap, meta, vol)
        for _name, pred in self.algorithm.predicates:
            ok, reasons = pred(ctx)
            if not ok:
                return False, reasons, 0.0
        dev_key = None
        if device_class is not None and pod_info_get is not None:
            # The verdict depends on WHICH PodInfo variant this node sees:
            # the pod's annotated node evaluates the pinned allocation,
            # shape-equal other nodes the invalidated one — the variant
            # must be part of the key or a retry of a previously-allocated
            # pod would poison shape-equal nodes with the wrong verdict.
            pinned_here = pod_info_get.pinned_node == snap.name
            dev_key = (snap.node_ex.shape_key(), device_class, pinned_here)
            # compute-once discipline: on a uniform fleet every fit
            # worker shares one dev_key, and the search is CPU-bound
            # pure Python — 16 workers racing the same cold class
            # serialize on the GIL into ~16x the single search time
            # (the measured 256-node cold-pass tail). The first worker
            # computes; the rest wait for its verdict.
            wait_for = None
            registered = False
            with self._device_lock:
                hit = self._device_verdicts.get(dev_key)
                if hit is not None:
                    # refresh insertion order so capacity eviction (which
                    # drops the oldest quarter) behaves as LRU — a hot
                    # long-lived class must not be the first casualty
                    del self._device_verdicts[dev_key]
                    self._device_verdicts[dev_key] = hit
                else:
                    wait_for = self._device_inflight.get(dev_key)
                    if wait_for is None:
                        self._device_inflight[dev_key] = threading.Event()
                        registered = True
            if hit is not None:
                return hit
            if wait_for is not None:
                wait_for.wait(timeout=5.0)
                with self._device_lock:
                    hit = self._device_verdicts.get(dev_key)
                if hit is not None:
                    return hit
                # owner failed or timed out: compute it ourselves — and
                # count the recompute, or a wedged class silently doubles
                # every waiter's work with nothing visible in /metrics
                metrics.FIT_VERDICT_TIMEOUTS.inc()
        try:
            if pod_info_get is not None:
                pod_info = pod_info_get(snap.name)
            else:
                pod_info = self.cache.pod_info_for_node(kube_pod, snap.name)
            fits, reasons, score = self.device_scheduler.pod_fits_resources(
                pod_info, snap.node_ex, False)
            result = (fits, [str(r) for r in reasons], score)
            if dev_key is not None:
                with self._device_lock:
                    if len(self._device_verdicts) >= self.MAX_DEVICE_VERDICTS:
                        # evict the oldest quarter (insertion order), not
                        # the whole map: a full clear() re-cold-started
                        # every live class at once mid-stream
                        drop = max(1, len(self._device_verdicts) // 4)
                        for key in list(self._device_verdicts)[:drop]:
                            del self._device_verdicts[key]
                    self._device_verdicts[dev_key] = result
            return result
        finally:
            if dev_key is not None and registered:
                # wake waiters whether we stored or raised — a crashed
                # owner must not strand the class's other workers. Only
                # the thread that REGISTERED the event tears it down: a
                # timed-out waiter computing for itself must not pop an
                # event a still-computing owner (or a newer wave's
                # owner) is responsible for.
                with self._device_lock:
                    ev = self._device_inflight.pop(dev_key, None)
                if ev is not None:
                    ev.set()

    def find_nodes_that_fit(self, kube_pod: dict) -> tuple:
        """Parallel filter over all nodes (`generic_scheduler.go:310-383`),
        memoized per equivalence class, then extender callouts. The cycle
        snapshot (one lock acquisition for every node's snapshot + fit
        generation) and the inter-pod metadata are built ONCE here and
        shared by every worker — and, via the generation cache, with the
        passes that follow."""
        # A pod declaring REQUIRED inter-pod (anti-)affinity must NOT be
        # memoized: its verdict depends on every other pod's labels, so any
        # plain pod landing anywhere could invalidate it — per-node
        # invalidation can't express that, and whole-cluster flushes on
        # every charge would kill the cache for everyone else. Preferred-
        # only terms don't affect predicates, so those pods stay memoized.
        # Auto-topology pods are likewise uncacheable (cluster-wide shape
        # dependence, `_requests_auto_topology`).
        auto_topology = self._requests_auto_topology(kube_pod)
        # PVC-referencing pods: their own verdict moves with cluster-wide
        # PV state, which per-node invalidation cannot express — but the
        # non-volume chain is shared with the pod's devolumed sibling
        # class (`devolumed_class`), so only the volume-reading predicates
        # run uncached.
        vol = self._volume_snapshot(kube_pod)
        memo_ok = self._memo_safe and not auto_topology and \
            not interpod.pod_requires_interpod_affinity(kube_pod)
        eq_class = vol_split = None
        if memo_ok and vol is None:
            eq_class = equivalence_class(kube_pod)
        elif memo_ok:
            vol_split = devolumed_class(kube_pod)
        pod_info_get = self._pod_info_provider(kube_pod)
        # A PVC pod's masked pass runs its DEVOLUMED sibling (verdicts
        # are monotone in volumes); survivors owe the volume-reading
        # predicates a scalar run against the real pod afterwards —
        # exactly the devolumed-split contract the scalar path applies.
        filter_pod = kube_pod if vol_split is None else vol_split[1]
        lookup_class = eq_class if eq_class is not None else \
            (vol_split[0] if vol_split is not None else None)
        # The affinity pre-gate reads only a counter, not the metadata:
        # when the cluster holds placed (anti-)affinity pods this pass
        # ends scalar anyway (``meta`` below nulls the columns), so skip
        # paying the columnar snapshot copy up front. The post-snapshot
        # ``meta`` check stays authoritative — a stale False here just
        # means one wasted column copy, never a wrong verdict.
        want_vector = (
            self.vector is not None and lookup_class is not None
            and not interpod.pod_declares_interpod_affinity(kube_pod)
            and not self.cache.has_affinity_pods()
            and self.vector.pod_eligible(filter_pod, pod_info_get.inv_info))
        # Snapshots + generations BEFORE the metadata snapshot: a watcher
        # invalidation racing the metadata build must make the eventual
        # store() land under a never-served generation — a verdict
        # computed from pre-invalidation metadata stored under a
        # post-invalidation generation would persist wrongly. The
        # columnar view rides the same lock acquisition so the masked
        # pass and the object snapshots describe ONE state.
        if want_vector:
            names, snaps, eq_gens, cols = \
                self.cache.cycle_snapshot(with_columns=True)
        else:
            names, snaps, eq_gens = self.cache.cycle_snapshot()
            cols = None
        meta = self._interpod_meta(kube_pod)
        if meta is not None:
            # placed pods carry (anti-)affinity metadata: every node owes
            # MatchInterPodAffinity an object-level run — scalar pass
            cols = None
        device_class = self._device_class(kube_pod, auto_topology)
        # Nominations and memo hits resolve serially, up front: the
        # nominations in one lock pass, the memo in one `lookup_many` —
        # per-node lookups from 16 workers convoyed on those locks and
        # cost more than the dict reads they guarded. Only the MISSES are
        # dispatched to the pool; a warm pass dispatches almost nothing.
        nom_by_node = self._nominations_by_node(
            exclude=kube_pod["metadata"]["name"],
            min_priority=_pod_priority(kube_pod))
        nom_fps = {n: tuple(sorted(p["metadata"]["name"] for p in pods))
                   for n, pods in nom_by_node.items()}
        results: dict = {}
        scalar_names = names
        if cols is not None:
            # ONE masked pass resolves every array-eligible node's
            # verdict; the remainder (tainted / volume-carrying /
            # nominated nodes) falls through to the scalar path below.
            t0v = time.perf_counter()
            results, scalar_names = self.vector.run_filter(
                filter_pod, lookup_class, cols, snaps, nom_by_node,
                pod_info_get)
            if vol_split is not None:
                # positive sibling verdicts: only the volume-reading
                # predicates remain, run against the REAL pod (few
                # survivors — the sibling pass pruned the fleet)
                for n, r in results.items():
                    if not r[0]:
                        continue
                    ctx = factory.PredicateContext(kube_pod, snaps[n],
                                                   meta, vol)
                    for _pname, pred in self._volume_predicates:
                        ok, reasons = pred(ctx)
                        if not ok:
                            results[n] = (False, reasons, 0.0)
                            break
            metrics.FIT_VECTOR_PASS_MS.observe(
                (time.perf_counter() - t0v) * 1e3)
            metrics.FIT_VECTOR_NODES_PER_PASS.observe(
                len(names) - len(scalar_names))
            if scalar_names:
                metrics.FIT_SCALAR_FALLBACK.inc(len(scalar_names))
        elif self.vector is not None:
            # the array machinery exists but this pod (or this pass's
            # inter-pod metadata) needs object predicates: the whole
            # fleet is a scalar fallback — visible in the rate
            metrics.FIT_SCALAR_FALLBACK.inc(len(names))
        hits: dict = {}
        if lookup_class is not None and scalar_names:
            hits = self.cache.equivalence.lookup_many(
                lookup_class,
                eq_gens if cols is None
                else {n: eq_gens[n] for n in scalar_names},
                nom_fps)
        pending = []
        for n in scalar_names:
            hit = hits.get(n)
            if hit is not None and (vol_split is None or not hit[0]):
                # a positive sibling verdict still owes the volume-
                # reading predicates a run against the real pod
                results[n] = hit
                if hit[0] and n in nom_by_node:
                    # memoized-feasible on a node with live reservations:
                    # the verdict is reusable (fingerprint-keyed) but
                    # scoring still needs the reservation's demand
                    # charged onto a private snapshot
                    psnap = self.cache.snapshot_node(n)
                    if psnap is not None:
                        self._charge_nominated(nom_by_node[n], psnap)
                        snaps[n] = psnap
            else:
                pending.append(n)
        charged_snaps: dict = {}  # nominated nodes: scoring must see the
        # reservation's demand, not the uncharged cycle snapshot
        computed = self._parallel_map(
            lambda n: (n, self._fits_on_node(kube_pod, n, eq_class,
                                             meta, pod_info_get,
                                             device_class, eq_gens.get(n),
                                             vol, snaps.get(n), vol_split,
                                             nom_by_node.get(n, []), True,
                                             hits.get(n), charged_snaps)),
            pending)
        results.update(computed)
        snaps.update(charged_snaps)
        feasible = {n: r[2] for n, r in results.items() if r[0]}
        failures = {n: r[1] for n, r in results.items() if not r[0]}
        for ext in self.extenders:
            if not feasible:
                break
            survivors, failed = ext.filter(kube_pod, sorted(feasible))
            for name, reason in failed.items():
                if name in feasible:
                    feasible.pop(name)
                    failures[name] = [reason or "extender refused"]
            for name in list(feasible):
                if name not in survivors:
                    feasible.pop(name)
                    failures[name] = ["extender refused"]
        return feasible, failures, snaps, meta

    def prioritize_nodes(self, kube_pod: dict, feasible: dict,
                         snaps: dict | None = None,
                         meta: Any = _AUTO_META) -> dict:
        """Map-reduce the configured priority functions over feasible nodes
        (`generic_scheduler.go:526-...`): stock priorities + the device
        score from the fit pass + extender scores, weighted-summed.
        ``snaps`` are the fit pass's shared cycle snapshots (read-only);
        a feasible node missing from them (direct callers) is snapshotted
        here."""
        if meta is self._AUTO_META:
            meta = self._interpod_meta(kube_pod)
        if self.vector is not None and self.algorithm.vector_priorities \
                and meta is None:
            # every configured priority has an array kernel and no
            # placed pod carries affinity metadata: score the survivors
            # as column arithmetic (float-for-float the scalar combine)
            scored = self.vector.run_scores(
                kube_pod, feasible, snaps or {}, self.algorithm,
                self._owner_selectors(kube_pod))
            if scored is not None:
                for ext in self.extenders:
                    for name, score in ext.prioritize(
                            kube_pod, sorted(scored)).items():
                        scored[name] = scored.get(name, 0.0) + score
                return scored
        pod_requests = _pod_core_requests(kube_pod)
        snaps = snaps or {}
        facts: dict = {}
        for name in sorted(feasible):
            snap = snaps.get(name) or self.cache.snapshot_node(name)
            if snap is not None:
                facts[name] = priorities.NodeFacts(
                    snap.kube_node, snap.core_allocatable,
                    snap.requested_core, snap.pod_labels)
        if meta is self._AUTO_META:
            meta = self._interpod_meta(kube_pod)
        ctx = factory.PriorityContext(
            meta, self.algorithm.hard_pod_affinity_weight,
            owner_selectors=self._owner_selectors(kube_pod))
        combined = {name: feasible[name] * priorities.MAX_PRIORITY
                    * self.algorithm.device_weight for name in facts}
        for _name, weight, batch in self.algorithm.priorities:
            for name, score in batch(kube_pod, pod_requests, facts, ctx).items():
                combined[name] = combined.get(name, 0.0) + weight * score
        for ext in self.extenders:
            for name, score in ext.prioritize(kube_pod, sorted(combined)).items():
                combined[name] = combined.get(name, 0.0) + score
        return combined

    def select_host(self, scored: dict) -> str:
        """Max score; round-robin among ties for spreading
        (`generic_scheduler.go:204-223`)."""
        best = max(scored.values())
        top = sorted(n for n, s in scored.items() if s == best)
        # racer: single-writer -- scheduling-thread-owned round-robin cursor
        self._last_node_index += 1
        return top[self._last_node_index % len(top)]

    def schedule(self, kube_pod: dict) -> str:
        """Choose a host (`generic_scheduler.go:130-188`). The phases are
        traced as spans (obs) AND observed into the per-phase histograms
        — the same boundaries feed both the per-pod timeline and the
        aggregate /metrics view; a slow pass still logs its steps (the
        old utiltrace behavior, via ``slow_log_s``)."""
        pod_name = kube_pod["metadata"]["name"]
        proc = getattr(self, "obs_name", "scheduler")
        t0 = time.perf_counter()
        with obs.span("schedule", pod=pod_name, proc=proc,
                      slow_log_s=0.1) as alg:
            with obs.span("filter", pod=pod_name, proc=proc) as sp:
                feasible, failures, snaps, meta = \
                    self.find_nodes_that_fit(kube_pod)
                sp.attrs["feasible"] = len(feasible)
            metrics.SCHED_PHASE_MS.labels("filter").observe(sp.dur_s * 1e3)
            if not feasible:
                alg.attrs["outcome"] = "unschedulable"
                raise FitError(pod_name, failures)
            if len(feasible) == 1:
                host = next(iter(feasible))
            else:
                with obs.span("score", pod=pod_name, proc=proc) as sp:
                    scored = self.prioritize_nodes(kube_pod, feasible,
                                                   snaps, meta)
                metrics.SCHED_PHASE_MS.labels("score").observe(
                    sp.dur_s * 1e3)
                if not scored:  # every feasible node vanished mid-pass
                    alg.attrs["outcome"] = "unschedulable"
                    raise FitError(pod_name,
                                   {n: ["node gone"] for n in feasible})
                host = self.select_host(scored)
            alg.attrs["host"] = host
        metrics.ALGORITHM_LATENCY.observe((time.perf_counter() - t0) * 1e6)
        return host

    OWNER_LIST_TTL_S = 2.0

    def _owner_listings(self) -> Any:
        """The four owner lists, TTL-cached: prioritizing a burst of N
        pods must not cost 4N list round-trips on a networked transport.
        A transient lister failure keeps serving the stale listing (and
        logs) instead of silently flipping to label-fallback scoring."""
        now = time.monotonic()
        cached = self._owner_cache
        if cached is not None and cached[0] > now:
            return cached[1]
        api = getattr(self, "api", None)
        list_services = getattr(api, "list_services", None)
        if list_services is None:
            listings = None  # transport exposes no owner listers
        else:
            try:
                listings = (list_services(),
                            getattr(api, "list_rcs", list)(),
                            getattr(api, "list_rss", list)(),
                            getattr(api, "list_statefulsets", list)())
            except Exception:
                logging.getLogger(__name__).warning(
                    "owner listers failed; keeping previous listing",
                    exc_info=True)
                listings = cached[1] if cached is not None else None
        # racer: single-writer -- TTL cache rebuilt on the scheduling
        # thread (priorities run serially); peers only read
        self._owner_cache = (now + self.OWNER_LIST_TTL_S, listings)
        return listings

    def _owner_selectors(self, kube_pod: dict) -> Any:
        """Selectors of the Services/RCs/RSs/StatefulSets selecting this
        pod, for SelectorSpreadPriority — or None when the API transport
        exposes no owner listers (standalone engines fall back to
        label-based spreading). Skipped entirely when the configured
        algorithm does not score spreading."""
        if not any(name in factory.SPREADING_PRIORITY_NAMES
                   for name, _, _ in self.algorithm.priorities):
            return None
        listings = self._owner_listings()
        if listings is None:
            return None
        services, rcs, rss, statefulsets = listings
        return priorities.owner_selectors_for_pod(
            kube_pod, services=services, rcs=rcs, rss=rss,
            statefulsets=statefulsets)

    def allocate_devices(self, kube_pod: dict, node_name: str) -> dict:
        """Re-run the device scheduler with allocation on, then serialize
        the decision into the pod's annotation **in memory**
        (`generic_scheduler.go:108-125`)."""
        snap = self.cache.snapshot_node(node_name)
        if snap is None:
            raise FitError(kube_pod["metadata"]["name"], {node_name: ["node gone"]})
        node_ex = snap.node_ex
        pod_info = self.cache.pod_info_for_node(kube_pod, node_name)
        try:
            self.device_scheduler.pod_allocate(pod_info, node_ex)
        except RuntimeError as err:
            # the node's free set moved between the fit pass and this
            # allocation (a watch delta landed — under multi-scheduler
            # HA, typically a competing replica's bind): an ordinary
            # lost race, so requeue-and-replan, not an internal error
            raise FitError(kube_pod["metadata"]["name"],
                           {node_name: [str(err)]})
        pod_info.node_name = node_name
        codec.pod_info_to_annotation(kube_pod.setdefault("metadata", {}), pod_info)
        return kube_pod

    # ---- preemption (`generic_scheduler.go:226-290`) ----------------------

    # Failure-reason markers no eviction can cure: node identity, labels,
    # taints, conditions. A node that failed ONLY on these is excluded
    # from the victim search (upstream nodesWherePreemptionMightHelp) —
    # on a big cluster this prunes most nodes before the expensive
    # evict-and-reprieve simulation.
    UNRESOLVABLE_MARKERS = (
        "didn't match the requested hostname",
        "didn't match node selector",
        "didn't match pod affinity rules",   # NODE affinity (predicates.py)
        "were unschedulable",
        "that the pod didn't tolerate",
        "were not ready",
        "had MemoryPressure",
        "had DiskPressure",
        "didn't satisfy label presence",
        "had no available volume zone",
    )

    @classmethod
    def _preemption_might_help(cls, reasons: list) -> bool:
        return not any(marker in reason for reason in reasons
                       for marker in cls.UNRESOLVABLE_MARKERS)

    def preempt(self, kube_pod: dict,
                failures: dict | None = None) -> tuple | None:
        """Find the best node to preempt on. Victim selection per the
        reference: remove ALL lower-priority pods, verify fit, then
        reprieve victims — PDB-violating candidates first, then the rest,
        highest-priority-first — while the preemptor still fits, so a
        cheap low-priority pod survives when evicting one big pod
        sufficed. Node selection (pickOneNodeForPreemption,
        `generic_scheduler.go:674-699`): fewest PDB violations, then
        lowest highest-victim-priority, then lowest priority sum, then
        fewest victims, then lexical node name for determinism. Returns
        (node_name, victim pod dicts) or None."""
        prio = _pod_priority(kube_pod)
        # The cluster-wide inter-pod metadata is built ONCE per preemption
        # pass and filtered per-simulation (victims removed), mirroring the
        # reference re-running podFitsOnNode with adjusted metadata.
        meta = self._interpod_meta(kube_pod)
        vol = self._volume_snapshot(kube_pod)
        pdb_state = self._pdb_state()
        pod_info_get = self._pod_info_provider(kube_pod)
        want_vector = (
            self.vector is not None and meta is None and vol is None
            and not self._requests_auto_topology(kube_pod)
            and self.vector.pod_eligible(kube_pod, pod_info_get.inv_info))
        if want_vector:
            names, cycle_snaps, gens, cols = \
                self.cache.cycle_snapshot(with_columns=True)
        else:
            names, cycle_snaps, gens = self.cache.cycle_snapshot()
            cols = None
        if failures is None:
            # Direct call without a fit pass: the memo's stored negatives
            # stand in for one — a node whose cached verdict failed on an
            # unresolvable reason (taints, selectors, conditions) cannot
            # be helped by eviction. Peeking (record=False) keeps the fit
            # pass's hit-rate accounting honest.
            memo_ok = self._memo_safe and \
                not self._requests_auto_topology(kube_pod) and \
                not interpod.pod_requires_interpod_affinity(kube_pod)
            if memo_ok:
                lookup_class = equivalence_class(kube_pod) if vol is None \
                    else devolumed_class(kube_pod)[0]
                failures = {}
                for n in names:
                    stored = self.cache.equivalence.lookup(
                        n, lookup_class, gens[n], record=False)
                    if stored is not None and not stored[0]:
                        failures[n] = stored[1]
        if failures is not None:
            names = [n for n in names
                     if self._preemption_might_help(failures.get(n) or [])]
        # One pod-list fetch and ONE preemptor parse for the whole pass —
        # the simulation re-checks fit ~2x per candidate per node, so
        # per-check API fetches/JSON decodes would dominate at 64 nodes.
        # Only BOUND pods (the apiserver's node index): a victim must be
        # placed to be evictable, and an assumed-but-still-binding pod is
        # deliberately invisible — deleting a pod mid-bind would race its
        # own commit.
        api = getattr(self, "api", None)
        if api is None:
            return None
        lister = getattr(self, "pod_lister", None)
        try:
            bound = lister() if lister is not None else list_bound_pods(api)
            pods_by_name = {p["metadata"]["name"]: p for p in bound}
        except Exception:
            return None
        # Eviction can only change a verdict where something evictable
        # exists: drop nodes with no bound pod below the preemptor's
        # priority before paying a private snapshot + full simulation —
        # on a big cluster this removes every empty node and every node
        # running only peers (cheap reads off the shared cycle snapshot).
        def _has_evictable(node_name: str) -> bool:
            snap = cycle_snaps.get(node_name)
            if snap is None:
                return True  # defensive: let the simulation decide
            return any(_pod_priority(pods_by_name[p]) < prio
                       for p in snap.pod_names if p in pods_by_name)

        if cols is not None:
            # Columnar twin of the per-pod loop: the min bound-pod
            # priority column answers "anything evictable here?" in one
            # compare per node. Assumed pods widen the column's min, so
            # this prune only KEEPS extra nodes (the simulation still
            # decides) — it can never drop a node the loop would keep.
            def _has_evictable_fast(node_name: str) -> bool:
                i = cols.idx.get(node_name)
                if i is None:
                    return _has_evictable(node_name)
                return bool(cols.min_pod_priority[i] < prio)

            names = [n for n in names if _has_evictable_fast(n)]
        else:
            names = [n for n in names if _has_evictable(n)]
        device_class = self._device_class(kube_pod)
        # One PodInfo decode per victim candidate per PASS: the
        # simulation charges each victim up to three times per node
        # (evict, reprieve, re-evict), and the annotation JSON decode
        # dominated the per-charge cost. take/return never mutate the
        # PodInfo, so one shared decode is safe across nodes and phases.
        info_cache: dict = {}

        def info_of(pod: dict) -> Any:
            pod_name = pod["metadata"]["name"]
            info = info_cache.get(pod_name)
            if info is None:
                info = codec.kube_pod_to_pod_info(
                    pod, invalidate_existing=False)
                info_cache[pod_name] = info
            return info

        fast = vectorized.FastPreemptFit(self.vector, kube_pod,
                                         pod_info_get, cols) \
            if cols is not None else None
        # Canonical-simulation memo (fast path only): nodes whose
        # (device shape, usage, core state, ordered victim roster)
        # fingerprints match run isomorphic simulations, so one
        # representative's victim indices + violation count stand for
        # the whole group — the uniform-fleet victim scan collapses to
        # one simulation plus fingerprint computation per node.
        sim_memo: dict | None = {} if fast is not None else None
        if fast is not None:
            # card-capacity prune off the columns: a node whose free +
            # evictable cards cannot cover the demand fails phase 1 of
            # the simulation by construction — skip it before paying a
            # private snapshot + full evict-and-reprieve
            names = [n for n in names
                     if cycle_snaps.get(n) is None
                     or fast.might_fit_after_full_eviction(
                         n, prio, pods_by_name, cycle_snaps[n])]
        if fast is not None and names:
            cidx, tnt, vh = cols.idx, cols.tainted, cols.vol_heavy
            n_fast = sum(1 for n in names
                         if (i := cidx.get(n)) is not None
                         and not tnt[i] and not vh[i])
            if n_fast * 2 < len(names):
                # Mostly off-columns nodes (tainted / volume-carrying):
                # the canonical-shape memo can't collapse this scan, and
                # the serial dispatch below would forfeit the 16-way
                # pool for nothing — run the scalar parallel path.
                fast = None
                sim_memo = None

        def eval_node(node_name: str) -> tuple | None:
            snap = self.cache.snapshot_node(node_name)
            if snap is None:
                return None
            found = self._victims_on_node(kube_pod, snap, prio, meta,
                                          pdb_state, pods_by_name,
                                          pod_info_get, vol, device_class,
                                          fast, sim_memo, info_of)
            if found is None:
                return None
            victims, violations = found
            key = (violations,
                   max(_pod_priority(v) for v in victims),
                   sum(_pod_priority(v) for v in victims),
                   len(victims), node_name)
            return key, (node_name, victims)

        # Victim search parallelized over nodes with the fit pool — each
        # worker simulates on its own snapshot (the reference runs this
        # 16-way too). min() over keys keeps selection deterministic.
        # With the vectorized fast fit active the scan runs serially: its
        # canonical-shape verdict memo is scheduling-thread-owned, and on
        # a uniform fleet the memo collapses the whole scan to a handful
        # of allocator searches — cheaper than any pool dispatch.
        if fast is not None:
            results = [r for r in map(eval_node, names) if r is not None]
        else:
            results = [r for r in self._parallel_map(eval_node, names)
                       if r is not None]
        if not results:
            return None
        return min(results, key=lambda r: r[0])[1]

    @staticmethod
    def _labels_match(selector: dict, pod: dict) -> bool:
        labels = (pod.get("metadata") or {}).get("labels") or {}
        return all(labels.get(k) == v for k, v in selector.items())

    def _pdb_state(self) -> list:
        """Per-PDB disruption allowance, computed once per preemption pass:
        allowed = (bound pods matching the selector) - minAvailable. The
        reference reads pdb.Status.PodDisruptionsAllowed; here the status
        is derived on the fly since this scheduler is the only writer.
        minAvailable accepts an absolute count or a "50%" string (of
        currently-matching pods, rounded up, like upstream); a malformed
        PDB is skipped, never allowed to break the preemption pass."""
        import math

        api = getattr(self, "api", None)
        list_pdbs = getattr(api, "list_pdbs", None)
        if list_pdbs is None:
            return []
        try:
            pdbs = list_pdbs()
            if not pdbs:
                return []
            bound = list_bound_pods(api)
        except Exception:
            return []
        state = []
        for pdb in pdbs:
            try:
                spec = pdb.get("spec") or {}
                selector = (spec.get("selector") or {}).get("matchLabels") or {}
                if not selector:
                    continue
                healthy = sum(1 for p in bound
                              if self._labels_match(selector, p))
                raw = spec.get("minAvailable") or 0
                if isinstance(raw, str) and raw.endswith("%"):
                    min_avail = math.ceil(healthy * int(raw[:-1]) / 100.0)
                else:
                    min_avail = int(raw)
                state.append({"selector": selector,
                              "allowed": healthy - min_avail})
            except Exception:
                # malformed PDB: ignore it, don't drop the pod — but a
                # typo'd PDB silently not protecting anything is worse
                log.warning("ignoring malformed PDB %s",
                            (pdb.get("metadata") or {}).get("name"),
                            exc_info=True)
                continue
        return state

    @staticmethod
    def _split_by_pdb_violation(candidates: list,
                                pdb_state: list) -> tuple:
        """Partition candidate victims into (violating, non_violating) the
        way upstream's filterPodsWithPDBViolation does: walk candidates
        highest-priority-first (then name for determinism) with a copy of
        each PDB's allowance; a pod whose eviction would breach a matching
        PDB (allowance exhausted) is violating, otherwise it consumes one
        unit of allowance."""
        allowed = [dict(s) for s in pdb_state]
        violating, ok = [], []
        for pod in sorted(candidates,
                          key=lambda p: (-_pod_priority(p),
                                         p["metadata"]["name"])):
            matched = [s for s in allowed
                       if GenericScheduler._labels_match(s["selector"], pod)]
            if any(s["allowed"] <= 0 for s in matched):
                violating.append(pod)
            else:
                for s in matched:
                    s["allowed"] -= 1
                ok.append(pod)
        return violating, ok

    def _fits_after_evictions(self, kube_pod: dict, snap: Any,
                              meta: Any, evicted: set,
                              pod_info_get: Any = None, vol: Any = None,
                              device_class: Any = None,
                              fast: Any = None) -> bool:
        """Full predicate chain against the mutated snapshot — taints,
        selectors, volume conflicts, inter-pod terms AND device fit — the
        reference's podFitsOnNode during preemption. A node where only
        resources were checked could be selected, its victims deleted, and
        the preemptor still never schedule there.

        ``device_class`` keys the device-verdict shape cache across the
        simulation: on a uniform fleet the post-eviction node states
        repeat across nodes, so the grpalloc search runs once per unique
        (shape, demand) instead of ~2x per candidate per node — this is
        what holds preemption p50 flat at cluster scale."""
        if fast is not None:
            # vectorized evict-and-reprieve fit: columns for the
            # eviction-invariant gates, the canonical-shape memo for the
            # device search. None = this node needs the scalar chain.
            verdict = fast.fits(snap)
            if verdict is not None:
                return verdict
        sim_meta = meta
        if meta is not None and evicted:
            sim_meta = interpod.InterPodMetadata(
                meta.node_labels,
                [p for p in meta.pods if not (p.node_name == snap.name
                                              and p.name in evicted)])
        fits, _, _ = self._run_predicates(kube_pod, snap, sim_meta,
                                          pod_info_get, device_class, vol)
        return fits

    def _victims_on_node(self, kube_pod: dict, snap: Any, prio: int,
                         meta: Any = None,
                         pdb_state: list | None = None,
                         pods_by_name: dict | None = None,
                         pod_info_get: Any = None, vol: Any = None,
                         device_class: Any = None,
                         fast: Any = None, sim_memo: dict | None = None,
                         info_of: Any = None) -> tuple | None:
        pod_host_ports = predicates.pod_host_ports
        pod_volumes = predicates.pod_volumes
        sim, core_free = snap.node_ex, snap.requested_core
        api = getattr(self, "api", None)
        if api is None:
            return None
        preemptor_name = kube_pod["metadata"]["name"]
        candidates = []
        for pod_name in sorted(snap.pod_names):
            if pods_by_name is not None:
                p = pods_by_name.get(pod_name)
                if p is None:
                    continue
            else:
                try:
                    p = api.get_pod(pod_name)
                except NotFound:
                    continue
            if _pod_priority(p) < prio:
                candidates.append(p)
        if not candidates:
            return None
        # Reprieve processing order is pure over (candidates, pdb_state)
        # — computed up front so the canonical-simulation memo can key
        # and replay it before any charge is paid.
        violating, non_violating = self._split_by_pdb_violation(
            candidates, pdb_state or [])
        violating_names = {p["metadata"]["name"] for p in violating}
        by_prio = lambda p: (-_pod_priority(p), p["metadata"]["name"])  # noqa: E731
        order = sorted(violating, key=by_prio) + \
            sorted(non_violating, key=by_prio)
        nominated = self._nominated_pods_on(snap.name,
                                            exclude=preemptor_name,
                                            min_priority=prio)
        memo_key = None
        if fast is not None and sim_memo is not None and \
                info_of is not None and not nominated:
            memo_key = fast.sim_key(snap, order, pdb_state or [], info_of)
            if memo_key is not None and memo_key in sim_memo:
                hit = sim_memo[memo_key]
                if hit is None:
                    return None
                victim_idx, violations = hit
                return [order[i] for i in victim_idx], violations
        evicted: set = set()

        def charge(pod: dict, sign: int) -> None:
            """sign=-1 evicts (frees), +1 re-admits. Keeps the WHOLE
            snapshot consistent — core usage, device usage, ports, labels,
            volumes — because the full predicate chain reads all of it."""
            name = pod["metadata"]["name"]
            info = info_of(pod) if info_of is not None else \
                codec.kube_pod_to_pod_info(pod, invalidate_existing=False)
            if sign < 0:
                self.device_scheduler.return_pod_resources(info, sim)
                evicted.add(name)
                snap.pod_names.discard(name)
                snap.pod_labels.pop(name, None)
                snap.pod_volumes.pop(name, None)
                snap.used_ports -= pod_host_ports(pod)
            else:
                self.device_scheduler.take_pod_resources(info, sim)
                evicted.discard(name)
                snap.pod_names.add(name)
                labels = (pod.get("metadata") or {}).get("labels") or {}
                snap.pod_labels[name] = dict(labels)
                vols = pod_volumes(pod)
                if vols:
                    snap.pod_volumes[name] = vols
                snap.used_ports |= pod_host_ports(pod)
            for res, val in _pod_core_requests(pod).items():
                core_free[res] = core_free.get(res, 0) + sign * val

        # Phase 1: evict every candidate; if the preemptor still doesn't
        # fit, this node can't be helped by preemption. Room reserved for
        # another nominated preemptor (equal-or-higher priority) is
        # charged first — preempting onto it would defeat the reservation
        # and ping-pong evictions (upstream adds nominated pods into the
        # preemption fit simulation too).
        for victim in candidates:
            charge(victim, -1)
        if nominated:
            self._charge_nominated(nominated, snap)
        if not self._fits_after_evictions(kube_pod, snap, meta, evicted,
                                          pod_info_get, vol, device_class,
                                          fast):
            if memo_key is not None:
                sim_memo[memo_key] = None
            return None
        # Phase 2: reprieve — PDB-violating candidates FIRST (so they're
        # kept whenever possible, minimizing violations), then the rest;
        # within each class in descending priority (then name for
        # determinism); keep each pod that doesn't break the fit
        # (upstream selectVictimsOnNode's two-pass reprieve).
        victims = []
        for pod in order:
            charge(pod, +1)
            if self._fits_after_evictions(kube_pod, snap, meta, evicted,
                                          pod_info_get, vol, device_class,
                                          fast):
                continue  # reprieved
            charge(pod, -1)
            victims.append(pod)
        if not victims:
            if memo_key is not None:
                sim_memo[memo_key] = None
            return None
        violations = sum(1 for v in victims
                         if v["metadata"]["name"] in violating_names)
        if memo_key is not None:
            victim_names = {v["metadata"]["name"] for v in victims}
            sim_memo[memo_key] = (
                tuple(i for i, p in enumerate(order)
                      if p["metadata"]["name"] in victim_names),
                violations)
        return victims, violations


class BindWorkerPool:
    """Bounded pool of bind workers — the data-plane half of the
    assume-cache design: the scheduling cycle stops at ``assume`` and
    hands every transport round trip (volume bind, annotation write,
    binding POST) to this pool, so N binds overlap on the wire and the
    cycle's latency is independent of transport RTT (upstream
    kube-scheduler's asynchronous binder).

    Work items are ``(run, on_crash)`` closures from the Scheduler. A
    worker does its HTTP strictly outside any cache lock (the closures
    only touch the cache through its own locked methods), and a crashed
    item can never strand its pods: the catch-all runs ``on_crash``,
    which forgets the assumes and requeues — requeued, not lost."""

    def __init__(self, workers: int = 4) -> None:
        self.workers = max(1, int(workers))
        self._cond = threading.Condition()
        self._items: deque = deque()  # (run, on_crash, submitted_at)
        self._inflight = 0            # queued + executing
        self._stopped = False
        self._threads: list = []

    def submit(self, run: Callable[[], None],
               on_crash: Callable[[], None]) -> bool:
        """Queue a work item. Returns False (instead of raising) when the
        pool is stopped — a shutdown racing a cycle must let the caller
        run the item inline rather than strand an assumed pod."""
        with self._cond:
            if self._stopped:
                return False
            self._items.append((run, on_crash))
            self._inflight += 1
            metrics.BIND_INFLIGHT.set(self._inflight)
            if not self._threads:
                for i in range(self.workers):
                    t = threading.Thread(target=self._worker, daemon=True,
                                         name=f"bind-{i}")
                    self._threads.append(t)
                    t.start()
            self._cond.notify()
        return True

    def _worker(self) -> None:
        obs.register_thread("binder")
        while True:
            with self._cond:
                while not self._items and not self._stopped:
                    self._cond.wait(0.5)
                if not self._items:
                    return  # stopped and drained
                run, on_crash = self._items.popleft()
            try:
                run()
            except Exception:
                # a crashed bind worker must not strand its pods — the
                # handler releases their assumes and requeues them
                log.exception("bind work item crashed; requeueing its pods")
                try:
                    on_crash()
                except Exception:
                    log.exception("bind crash handler failed")
            finally:
                with self._cond:
                    self._inflight -= 1
                    metrics.BIND_INFLIGHT.set(self._inflight)
                    self._cond.notify_all()

    def flush(self, timeout: float = 30.0) -> bool:
        """Wait until every submitted item finished. Returns True when
        there was anything to wait for — the caller then re-checks its
        queue, because failed binds requeue pods."""
        waited = False
        deadline = time.monotonic() + timeout
        with self._cond:
            while self._inflight > 0:
                waited = True
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._cond.wait(min(0.5, remaining))
        return waited

    def inflight(self) -> int:
        with self._cond:
            return self._inflight

    def stop(self) -> None:
        with self._cond:
            self._stopped = True
            self._cond.notify_all()


class Scheduler:
    """The control loop: queue -> schedule -> assume -> bind
    (`kube-scheduler/pkg/scheduler.go:174-502`)."""

    # Transport retries inside one bind work item: the bind subresource
    # is idempotent for the same node (a duplicated or replayed bind is a
    # no-op), so resending after a lost reply converges — cheaper than a
    # forget + full replan for every transient blip.
    BIND_ATTEMPTS = 3
    # How long a pod outside this replica's shard parks before its
    # ownership is re-checked (a vacancy-driven steal is also pushed via
    # the coordinator's move_all_to_active, so this is only the backstop).
    SHARD_PARK_S = 0.5
    # Retry delay after LOSING a bind conflict to a competing replica:
    # the pod is not unschedulable — capacity exists elsewhere and the
    # replan runs against a cache that has (or is about to have) the
    # winner's bind charged — so it parks briefly instead of paying the
    # exponential unschedulable backoff. Progress is guaranteed: every
    # retry sees strictly more committed state.
    CONFLICT_RETRY_S = 0.05

    def __init__(self, api: Any, device_scheduler: Any,
                 bind_async: bool = False,
                 parallelism: int = DEFAULT_PARALLELISM,
                 extenders: list | None = None,
                 priority_weights: dict | None = None,
                 algorithm: factory.AlgorithmConfig | None = None,
                 bind_workers: int = 4,
                 shard_owned: Callable[[str], bool] | None = None,
                 name: str | None = None,
                 quota: Any | None = None) -> None:
        self.api = api
        self.device_scheduler = device_scheduler
        self.cache = SchedulerCache(device_scheduler)
        # guarded-by: SchedulingQueue._lock -- the queue is a monitor:
        # every mutator takes its own condition lock internally
        self.queue = SchedulingQueue()
        # span identity: which scheduler replica a trace row belongs to
        # (an HA run puts several engines over one apiserver — their
        # spans must be tellable apart in a merged timeline)
        self.obs_name = name or "scheduler"
        self.queue.obs_name = self.obs_name
        self.generic = GenericScheduler(self.cache, device_scheduler, parallelism,
                                        extenders=extenders,
                                        priority_weights=priority_weights,
                                        algorithm=algorithm)
        self.generic.api = api
        self.generic.obs_name = self.obs_name
        self.generic.pod_lister = self._view_list_bound
        self.volume_binder = VolumeBinder(api)
        self.generic.volume_binder = self.volume_binder
        # guarded-by: GangBuffer._lock -- monitor object, internally locked
        self.gang_buffer = GangBuffer()
        self.gang_planner = GangPlanner(self.cache)
        self.bind_async = bind_async
        # bind_async now means the pipelined binder pool, not a thread
        # per bind: the cycle stops at assume and the pool overlaps the
        # transport round trips of up to ``bind_workers`` binds.
        self._binder = BindWorkerPool(bind_workers) if bind_async else None
        # single-pod binds spool here and ONE drainer at a time commits
        # whole runs of them via bind_many — the write-path analogue of
        # watch delta batching (see _drain_bind_spool). Batch size adapts
        # to backlog: while the drainer is on the wire the spool grows,
        # so higher transport RTT yields bigger batches automatically.
        self._spool_lock = threading.Lock()
        self._bind_spool: deque = deque()
        self._spool_draining = False
        # coordinator ports promised to gangs whose commit is still in
        # flight (assumed but not yet bound): the port claim only becomes
        # API-visible when the annotations land, so a concurrent gang
        # plan must see these or two gangs could share a coordinator port
        self._gang_lock = threading.Lock()
        self._gang_ports_inflight: dict = {}  # gang id -> (node, port)
        # Informer pod mirror, maintained from watch events: the cycle's
        # per-pod freshness check reads this instead of paying a GET
        # round trip per pod (upstream kube-scheduler trusts its
        # informer the same way). Falls back to get_pod on a miss.
        self._view_lock = threading.Lock()
        self._pod_view: dict = {}  # pod name -> latest watched object
        self.preemption_enabled = True
        # Multi-scheduler sharding: ``shard_owned(pod_name) -> bool`` is
        # the replica's ownership filter (a ShardCoordinator's ``owns``).
        # It is an EFFICIENCY filter, not a correctness gate — two
        # replicas briefly processing the same pod during a lease
        # handoff is resolved by the apiserver's conflict arbiter.
        self._shard_owned = shard_owned
        # Consecutive lost-commit count per pod: the first few conflicts
        # retry promptly, a streak degrades to unschedulable backoff
        # (a replica repeatedly re-deriving a refused plan is working
        # from a stale view and must stop hammering the arbiter).
        self._conflict_lock = threading.Lock()
        self._conflict_streak: dict = {}
        self.resync_count = 0  # full relists performed (apiserver restart)
        # Dominant-resource fair-share card quota gate
        # (scheduler/quota.py), consulted at pod-pop time BEFORE any
        # allocation work: tenants over their fair share park in the
        # gate (typed QuotaExceeded reason) and re-queue promptly when
        # cards release. None = no tenancy enforcement (the default —
        # single-tenant deployments pay nothing).
        self.quota = quota
        if quota is not None:
            quota.requeue = self.queue.push
            # batch-aware gates re-admit a whole release under one queue
            # wake instead of one per pod
            quota.requeue_many = self.queue.push_many
        # (monotonic, pods) samples of committed binds for the headline
        # sched_throughput_pods_per_s gauge; bind workers append
        # concurrently with the drainer
        self._throughput_lock = threading.Lock()
        self._bound_window: deque = deque()
        # Whole-backlog batch scheduling (scheduler/batch.py): one pass
        # drains the ready backlog and schedules it as one assignment
        # problem — one fleet filter/score pass per equivalence class,
        # single-node refits per award. Captured once at construction;
        # KGTPU_BATCH=0 keeps the pod-at-a-time loop as oracle/fallback
        # (the KGTPU_VECTORIZE=0 discipline).
        self._batch = batch.enabled()
        self._stop = threading.Event()
        # A transport exposing batched watch delivery (HTTPAPIClient)
        # gets the whole batch applied under one cache lock; the
        # in-process server keeps the per-event path.
        add_batch = getattr(api, "add_batch_watcher", None)
        if add_batch is not None:
            add_batch(self._on_event_batch)
        else:
            api.add_watcher(self._on_event)
        # A transport that can lose its watch-resume window (apiserver
        # restart) tells us to relist instead of resuming stale.
        add_relist = getattr(api, "add_relist_listener", None)
        if add_relist is not None:
            add_relist(self._on_relist)
        self._sync_existing()

    # ---- informer plumbing -------------------------------------------------

    def _view_store(self, obj: dict) -> None:
        with self._view_lock:
            self._pod_view[obj["metadata"]["name"]] = obj

    def _view_drop(self, name: str) -> None:
        with self._view_lock:
            self._pod_view.pop(name, None)

    def _view_list_bound(self) -> list:
        """Bound pods straight from the informer mirror — the victim
        scan's pod source. One dict scan instead of an API list that
        deep-copies every bound pod per preemption pass; the returned
        objects are the mirror's own (read-only contract: preemption
        reads priority/labels/annotation and deletes victims by name,
        never mutates the dicts)."""
        with self._view_lock:
            return [obj for obj in self._pod_view.values()
                    if (obj.get("spec") or {}).get("nodeName")]

    def _view_get(self, name: str) -> dict | None:
        with self._view_lock:
            obj = self._pod_view.get(name)
        if obj is None:
            return None
        # shallow-copy the mutation path (metadata.annotations): the
        # cycle writes the allocation annotation into its working copy,
        # which must not corrupt this mirror of server state
        meta = dict(obj.get("metadata") or {})
        meta["annotations"] = dict(meta.get("annotations") or {})
        out = dict(obj)
        out["metadata"] = meta
        return out

    def _sync_existing(self) -> None:
        """Cold start / restart: rebuild state from the API server — the
        annotations are the checkpoint."""
        self._sync_quota_weights()
        for node in self.api.list_nodes():
            self.cache.set_node(node)
            if self.quota is not None:
                self.quota.set_node(node)
        for pod in self.api.list_pods():
            self._view_store(pod)
            node_name = (pod.get("spec") or {}).get("nodeName")
            if self.quota is not None:
                if node_name:
                    self.quota.pod_bound(pod)
                else:
                    self.quota.pod_pending(pod)
            if node_name:
                self.cache.add_pod(pod, node_name)
            else:
                # a pending preemptor's nomination survives restart via
                # its persisted annotation (the API server IS the
                # checkpoint) — re-reserve before scheduling resumes
                nominated = ((pod.get("metadata") or {})
                             .get("annotations") or {}) \
                    .get(self.NOMINATED_NODE_ANNOTATION)
                if nominated:
                    self.generic.nominate(pod, nominated)
                self.queue.push(pod)

    def _on_relist(self) -> None:
        """The watch transport lost its resume window (the apiserver
        restarted past our cursor, or our cursor predates its WAL
        snapshot): the delta stream has a gap, so re-list everything and
        reconcile the cache. All mutations here are idempotent — the
        charge gate, set_node's fingerprint, queue.push's replace — so
        overlapping with the freshly-resumed delta stream converges."""
        try:
            nodes = self.api.list_nodes()
            pods = self.api.list_pods()
        except Exception:
            # the next relist signal (or plain deltas against whatever
            # state survives) will retry; never kill the watch thread
            log.warning("relist failed; cache may lag until the next "
                        "watch delivery", exc_info=True)
            return
        self.resync_count += 1
        listed = {n["metadata"]["name"] for n in nodes}
        ops: list = [(self.cache.set_node, (n,)) for n in nodes]
        for name in set(self.cache.node_names()) - listed:
            ops.append((self.cache.remove_node, (name,)))
        listed_pods = {p["metadata"]["name"] for p in pods}
        for pod in pods:
            self._view_store(pod)
            node_name = (pod.get("spec") or {}).get("nodeName")
            if node_name:
                ops.append((self.cache.add_pod, (pod, node_name)))
        # pods deleted during the gap: absent from the fresh list but
        # still mirrored here — without this their charges (and queue /
        # gang-buffer entries) would leak until the node itself vanished.
        # A pod created after the list was taken re-arrives through the
        # resumed delta stream (its seq postdates the adopted cursor).
        with self._view_lock:
            known = {name: obj for name, obj in self._pod_view.items()
                     if name not in listed_pods}
        for name, obj in known.items():
            self._view_drop(name)
            self.queue.forget(name)
            self.generic.clear_nomination(name)
            self.gang_buffer.discard_pod(name)
            self._conflict_cleared(name)
            node_name = (obj.get("spec") or {}).get("nodeName")
            if node_name:
                ops.append((self.cache.remove_pod, (obj, node_name)))
        self.cache.apply_batch(ops)
        if self.quota is not None:
            self.quota.resync(nodes, pods)
            self._sync_quota_weights()
        for pod in pods:
            if not (pod.get("spec") or {}).get("nodeName"):
                self.queue.push(pod)
        self.queue.move_all_to_active()
        log.info("watch relist: resynced %d node(s), %d pod(s), dropped "
                 "%d deleted during the gap", len(nodes), len(pods),
                 len(known))

    def _on_event(self, kind: str, event: str, obj: dict) -> None:
        if kind == "node":
            name = obj["metadata"]["name"]
            if event in ("added", "modified"):
                self.cache.set_node(obj)
                if self.quota is not None:
                    self.quota.set_node(obj)
                self.queue.move_all_to_active()
            elif event == "deleted":
                self.cache.remove_node(name)
                if self.quota is not None:
                    self.quota.drop_node(name)
        elif kind == "pod":
            node_name = (obj.get("spec") or {}).get("nodeName")
            if event in ("added", "modified"):
                self._view_store(obj)
            if self.quota is not None:
                if event == "deleted":
                    self.quota.pod_gone(obj)
                elif node_name:
                    self.quota.pod_bound(obj)
                else:
                    self.quota.pod_pending(obj)
            if event == "added" and not node_name:
                self.queue.push(obj)
            elif event in ("added", "modified") and node_name:
                # bound pod observed: charge it. "added" covers static
                # pods / restart replays; "modified" is how a COMPETING
                # scheduler replica's bind arrives — without charging it,
                # this replica's cache would re-offer the same cards
                # forever. add_pod is idempotent (charge gate) and a
                # no-op for pods this replica assumed itself. A bound
                # pod also has no business queued here (another
                # replica's win would otherwise cycle through the
                # park/backoff sets until popped).
                self.cache.add_pod(obj, node_name)
                self.queue.forget(obj["metadata"]["name"])
                self._conflict_cleared(obj["metadata"]["name"])
                obs.event("watch_delivery", pod=obj["metadata"]["name"],
                          proc=self.obs_name, node=node_name)
            elif event == "deleted":
                self._view_drop(obj["metadata"]["name"])
                self.queue.forget(obj["metadata"]["name"])
                self._conflict_cleared(obj["metadata"]["name"])
                self.generic.clear_nomination(obj["metadata"]["name"])
                self.gang_buffer.discard_pod(obj["metadata"]["name"])
                if node_name:
                    self.cache.remove_pod(obj, node_name)
                self.queue.move_all_to_active()
        elif kind == "quota" and self.quota is not None:
            self._apply_quota_event(event, obj)
        elif kind in ("pv", "pvc"):
            # a new/changed volume can make an unschedulable PVC pod
            # feasible (unbound-PVC pods wait for a matching PV)
            self.queue.move_all_to_active()

    def _sync_quota_weights(self) -> None:
        """Cold start / relist: load the persisted tenant weights so a
        restarted (or watch-gapped) replica computes the same fair
        shares as one that saw every quota event — deltas alone would
        leave it on the default weight."""
        if self.quota is None:
            return
        list_quotas = getattr(self.api, "list_quotas", None)
        if list_quotas is None:
            return  # transport without a quota surface
        try:
            quotas = list_quotas()
        except Exception:
            log.warning("quota weight sync failed; weights follow "
                        "watch events until the next resync",
                        exc_info=True)
            return
        # wholesale replacement: a quota deleted during a watch gap
        # must revert to the default weight, not survive a merge. The
        # default is the tenant's configured weight (the binary's
        # tenantWeights), where the JAX engine drops it for 1.0
        configured = self._configured_weights()
        weights = dict(configured)
        for tenant, spec in quotas.items():
            weight = (spec or {}).get("weight")
            weights[tenant] = float(weight) if weight else \
                configured.get(tenant, 1.0)
        self.quota.set_weights(weights)

    def _configured_weights(self) -> dict:
        return dict(getattr(self.quota, "configured_weights", None) or {})

    def _apply_quota_event(self, event: str, obj: dict) -> None:
        """Quota config changed on the apiserver: feed the tenant's
        fair-share weight to the DRF gate (a deleted quota reverts to
        the tenant's configured weight, 1.0 by default). The apiserver
        emits these as ``quota`` watch records; clients that should
        react must include the kind in their watch filter."""
        tenant = (obj.get("metadata") or {}).get("name")
        if not tenant:
            return
        default = self._configured_weights().get(tenant, 1.0)
        if event == "deleted":
            self.quota.set_weight(tenant, default)
            return
        # set_quota replaces the spec wholesale, so a spec WITHOUT a
        # weight means "default", not "keep the old one" — otherwise a
        # running replica and a restarted one would diverge
        weight = (obj.get("spec") or {}).get("weight")
        self.quota.set_weight(
            tenant, float(weight) if weight is not None else default)

    def _on_event_batch(self, events: list) -> None:
        """Batched informer apply (HTTP transport): the whole watch batch
        becomes cache mutations under ONE cache lock (`apply_batch`),
        then the queue/gang side effects run outside it, and the queue
        wake-up fires once per batch instead of once per event. Event
        order within the batch is preserved for cache ops and for queue
        ops independently; nothing interleaves across the two groups that
        either side observes."""
        ops: list = []
        post: list = []
        pushes: list = []  # added-unbound pods -> ONE push_many
        wake = False
        for kind, event, obj in events:
            if kind == "node":
                if event in ("added", "modified"):
                    ops.append((self.cache.set_node, (obj,)))
                    if self.quota is not None:
                        post.append((self.quota.set_node, (obj,)))
                    wake = True
                elif event == "deleted":
                    ops.append((self.cache.remove_node,
                                (obj["metadata"]["name"],)))
                    if self.quota is not None:
                        post.append((self.quota.drop_node,
                                     (obj["metadata"]["name"],)))
            elif kind == "pod":
                name = obj["metadata"]["name"]
                node_name = (obj.get("spec") or {}).get("nodeName")
                if event in ("added", "modified"):
                    self._view_store(obj)
                if self.quota is not None:
                    if event == "deleted":
                        post.append((self.quota.pod_gone, (obj,)))
                    elif node_name:
                        post.append((self.quota.pod_bound, (obj,)))
                    else:
                        post.append((self.quota.pod_pending, (obj,)))
                if event == "added" and not node_name:
                    pushes.append(obj)
                elif event in ("added", "modified") and node_name:
                    # a bound pod (possibly a competing replica's bind
                    # arriving as "modified"): charge idempotently and
                    # drop any queue entry — see _on_event
                    ops.append((self.cache.add_pod, (obj, node_name)))
                    post.append((self.queue.forget, (name,)))
                    post.append((self._conflict_cleared, (name,)))
                    # the watch stream closing the loop: this replica's
                    # informer observed the committed bind (its own or a
                    # competitor's) — the last hop of the pod's timeline
                    obs.event("watch_delivery", pod=name,
                              proc=self.obs_name, node=node_name)
                elif event == "deleted":
                    self._view_drop(name)
                    post.append((self.queue.forget, (name,)))
                    post.append((self._conflict_cleared, (name,)))
                    post.append((self.generic.clear_nomination, (name,)))
                    post.append((self.gang_buffer.discard_pod, (name,)))
                    if node_name:
                        ops.append((self.cache.remove_pod, (obj, node_name)))
                    wake = True
            elif kind == "quota" and self.quota is not None:
                post.append((self._apply_quota_event, (event, obj)))
            elif kind in ("pv", "pvc"):
                wake = True
        if ops:
            self.cache.apply_batch(ops)
        for fn, args in post:
            fn(*args)
        if pushes:
            # one admission, one wake, one depth publish for the whole
            # batch — a pod deleted or bound by a LATER event in the same
            # batch is re-admitted here and dropped by the pop-time
            # freshness check, the same convergence the per-event path
            # already relies on for a one-delivery-stale mirror
            self.queue.push_many(pushes)
        if wake:
            self.queue.move_all_to_active()

    # ---- the loop (`scheduler.go:439-502`) ---------------------------------

    def schedule_one(self, timeout: float = 0.0) -> bool:
        """One pass; returns False when the queue stayed empty. With
        batch scheduling on (the default; ``KGTPU_BATCH=0`` reverts to
        the pod-at-a-time oracle) one pass drains the whole ready
        backlog and schedules it as one assignment problem."""
        if self._batch:
            pods = self.queue.pop_many(batch.MAX_BATCH_PODS,
                                       timeout=timeout)
            if not pods:
                return False
            self._schedule_backlog(pods)
            return True
        kube_pod = self.queue.pop(timeout=timeout)
        if kube_pod is None:
            return False
        kube_pod = self._prepare_backlog_pod(kube_pod)
        if kube_pod is not None:
            self._schedule_admitted(kube_pod)
        return True

    def _schedule_backlog(self, pods: list) -> None:
        """One batch cycle: intake every popped pod (shard/freshness/
        gang/quota — identical per-pod treatment to the serial loop),
        group the admitted remainder by batch class, then award hosts
        in the exact pop order the serial loop would have used. Each
        class pays ONE fleet filter/score pass (its first member's);
        every award dirties the awarded host in all live class passes
        and charges the cycle's capacity ledger, so the next pick sees
        it — a refit of one node, not a pass over the fleet."""
        self.cache.expire_assumed()
        if len(pods) == 1:
            # trickle shape: a single-pod cycle can share nothing, so
            # skip class grouping (and its content hash) entirely and
            # take the serial tail verbatim — the batch path costs
            # nothing when the queue never builds a backlog
            admitted = self._prepare_backlog_pod(pods[0])
            if admitted is not None:
                metrics.SCHED_BATCH_SIZE.observe(1)
                metrics.SCHED_BATCH_CLASSES.observe(1)
                self._schedule_admitted(admitted)
            return
        ledger = batch.CapacityLedger()
        passes: dict = {}  # class key -> ClassPass | None (None: serial)
        counted: set = set()
        n_scheduled = 0
        n_classes = 0
        for popped in pods:
            # intake AND scheduling run per pod in pop order — a gang
            # that completes during a later pod's intake must see every
            # earlier pod's award, exactly as the serial loop's
            # pop/schedule interleaving would have shown it
            kube_pod = self._prepare_backlog_pod(popped)
            if kube_pod is None:
                if passes and gang_key(popped) is not None:
                    # the pod routed to the gang handler, which may have
                    # just committed a whole gang: node state moved under
                    # every open class pass, so drop the cycle's shared
                    # state and let later pods re-open against fresh truth
                    passes.clear()
                    ledger = batch.CapacityLedger()
                continue
            n_scheduled += 1
            key = batch.batch_class(self.generic, kube_pod)
            cp = None
            opened = False
            if key is None:
                n_classes += 1
            else:
                if key not in counted:
                    counted.add(key)
                    n_classes += 1
                if key in passes:
                    cp = passes[key]
                    if cp is not None:
                        # class-pass reuse IS the equivalence cache
                        # working: every node served without a recompute
                        # folds into the fit-memo effectiveness counters
                        # (the refit lookups account for themselves)
                        self.cache.equivalence.record(
                            max(len(cp.feasible) + len(cp.failures)
                                - len(cp.dirty), 0), 0)
                else:
                    with self._batch_filter(kube_pod):
                        cp = batch.open_class_pass(self.generic, key,
                                                   kube_pod)
                    passes[key] = cp
                    opened = True
            if cp is None:
                # unbatchable pod (volumes, affinity, gang leftovers,
                # extenders...) — the serial path IS the batch fallback
                host = self._schedule_admitted(kube_pod)
                chips, core = self._pod_demand(kube_pod)
            else:
                if not opened:
                    # a fresh pass has no dirty host to refit
                    with self._batch_filter(kube_pod):
                        batch.refresh_class_pass(self.generic, cp, ledger)
                host = self._schedule_admitted(kube_pod, cp)
                chips, core = cp.chips, cp.core_requests
            if host is None:
                continue
            # ledger balances must never UNDERestimate remaining
            # capacity (covers() prunes without a refit): the first
            # award on a node seeds from its post-award snapshot — the
            # award is already subtracted there — later ones decrement
            ledger.note_award(host, self.cache.snapshot_node(host),
                              chips, core)
            for other in passes.values():
                if other is not None:
                    other.dirty.add(host)
        if n_scheduled:
            metrics.SCHED_BATCH_SIZE.observe(n_scheduled)
            metrics.SCHED_BATCH_CLASSES.observe(n_classes)

    @contextlib.contextmanager
    def _batch_filter(self, kube_pod: dict):
        """The filter phase of a batched pod — its class's shared pass
        opened, or the hosts earlier awards dirtied refitted — traced and
        observed as the serial path's ``filter`` phase is."""
        with obs.span("filter", pod=kube_pod["metadata"]["name"],
                      proc=self.obs_name, batched=True) as sp:
            yield sp
        metrics.SCHED_PHASE_MS.labels("filter").observe(sp.dur_s * 1e3)

    def _pod_demand(self, kube_pod: dict) -> tuple:
        """(cards, core requests) a placed pod consumes, for the batch
        ledger. The card demand may UNDERcount for exotic request shapes
        (absolute device paths) — an undercharge only ever costs an
        extra refit, never a wrong prune."""
        try:
            info = codec.kube_pod_to_pod_info(kube_pod,
                                              invalidate_existing=True)
            chips = batch.pod_chip_demand(info)
        except Exception:
            chips = 0
        return chips, _pod_core_requests(kube_pod)

    def _prepare_backlog_pod(self, kube_pod: dict) -> dict | None:
        """Per-pod intake, shared verbatim by the serial loop and the
        batch cycle: shard ownership, informer-mirror freshness, gang
        routing, and the DRF quota gate. Returns the fresh, admitted
        pod ready for a scheduling cycle — or None when the pod was
        fully handled here (parked, gang-buffered, deleted, already
        bound, or over fair share)."""
        name = kube_pod["metadata"]["name"]
        if self._shard_owned is not None and \
                not self._shard_owned(self._shard_key(kube_pod)):
            # another replica's shard (and its lease has a live holder):
            # park cheaply and re-check — ownership moves when that
            # holder dies (work stealing), and the coordinator fires
            # move_all_to_active so stolen pods skip the park delay
            self.queue.park(kube_pod, self.SHARD_PARK_S)
            return None
        # Freshness check against the informer mirror (no GET round trip
        # per pod — the upstream scheduler trusts its informer the same
        # way); the API is consulted only when the mirror misses. A copy
        # stale by one watch delivery converges: a deleted pod fails its
        # bind, gets requeued, and the next pass sees the mirror updated.
        current = self._view_get(name)
        if current is None:
            try:
                current = self.api.get_pod(name)
            except KeyError:
                return None  # deleted while queued
            except Exception:
                # transient transport failure: the pod was already popped,
                # so dropping it here would lose it forever — park it with
                # backoff instead and let the next pass re-fetch
                self.queue.add_unschedulable(kube_pod)
                return None
        if (current.get("spec") or {}).get("nodeName"):
            return None  # already bound elsewhere
        kube_pod = current
        gang = gang_key(kube_pod)
        if gang is not None:
            self._handle_gang_pod(kube_pod, *gang)
            return None

        if self.quota is not None and \
                not self._quota_admit([kube_pod], kube_pod):
            return None  # over fair share: parked in the gate
        return kube_pod

    def _schedule_admitted(self, kube_pod: dict,
                           cp: Any = None) -> str | None:
        """One scheduling cycle for an admitted pod: pick a host, assume
        volumes, allocate devices, assume, bind. ``cp`` is the pod's
        shared batch ClassPass — the host then comes from the class's
        score table (``batch.pick_host``) instead of a fresh fleet pass;
        every error path is the serial one, shared verbatim. Returns the
        host on a successful award (reached assume+bind), else None."""
        name = kube_pod["metadata"]["name"]
        metrics.SCHEDULE_ATTEMPTS.inc()
        t0 = time.perf_counter()
        if cp is None:
            self.cache.expire_assumed()
        with obs.span("schedule_cycle", pod=name, proc=self.obs_name) as cyc:
            try:
                if cp is None:
                    host = self.generic.schedule(kube_pod)
                else:
                    with obs.span("schedule", pod=name, proc=self.obs_name,
                                  batched=True) as alg:
                        host = batch.pick_host(self.generic, cp)
                        alg.attrs["host"] = host
                    if host is None:
                        # the class's table holds no host for this pod,
                        # but its failure map cannot name why: a host the
                        # ledger pruned or a refit refused since the pass
                        # opened left no reason. The serial pass raises
                        # the oracle's FitError, every node's reasons in
                        # it, which the event and preemption read.
                        host = self.generic.schedule(kube_pod)
                if not self._assume_volumes(kube_pod, host):
                    # volume state moved between the fit pass and host
                    # selection (another pod grabbed the PV): requeue, the
                    # next pass recomputes against fresh PV state
                    metrics.SCHEDULE_FAILURES.inc()
                    self._quota_forget(kube_pod)
                    self._event(name, "Warning", "FailedScheduling",
                                f"volume binding lost race on {host}")
                    self.queue.add_unschedulable(kube_pod)
                    return None
                with obs.span("allocate", pod=name, proc=self.obs_name,
                              node=host) as sp:
                    self.generic.allocate_devices(kube_pod, host)
                metrics.SCHED_PHASE_MS.labels("allocate").observe(
                    sp.dur_s * 1e3)
            except FitError as err:
                self.volume_binder.forget(name)
                metrics.SCHEDULE_FAILURES.inc()
                self._quota_forget(kube_pod)
                summary = self._summarize_failures(err.failures)
                cyc.attrs["outcome"] = "unschedulable"
                # the "why is this pod Pending" record /debug/pod serves:
                # the aggregate summary plus per-node reasons (capped —
                # a 4k-node FitError must not balloon the ring)
                obs.event("unschedulable", pod=name, proc=self.obs_name,
                          message=summary,
                          failures={n: err.failures[n] for n in
                                    sorted(err.failures)[:16]})
                self._event(name, "Warning", "FailedScheduling", summary)
                if self.preemption_enabled and \
                        self._try_preempt(kube_pod, err.failures):
                    self.queue.push(kube_pod)
                else:
                    self.queue.add_unschedulable(kube_pod)
                return None
            except Exception as err:
                # NOT a FitError: an internal code fault. Log loudly,
                # count separately, and park the pod so the loop survives
                # — but never silently (reference stance:
                # `node_info.go:336-340` panics on corrupted internal
                # state).
                self.volume_binder.forget(name)
                metrics.INTERNAL_ERRORS.inc()
                self._quota_forget(kube_pod)
                cyc.attrs["outcome"] = "internal_error"
                logging.getLogger(__name__).exception(
                    "internal scheduler error while scheduling %s", name)
                obs.FLIGHT.trigger("internal_error", key=name, pod=name,
                                   error=f"{type(err).__name__}: {err}")
                self._event(name, "Warning", "SchedulerInternalError",
                            f"{type(err).__name__}: {err}")
                self.queue.add_unschedulable(kube_pod)
                return None

            self.cache.assume_pod(kube_pod, host)
            obs.event("assume", pod=name, proc=self.obs_name, node=host)
            cyc.attrs["host"] = host
            if self._binder is not None:
                # the cycle stops here: the transport half runs on a bind
                # worker, overlapping with the next pod's scheduling pass
                self._submit_bind(kube_pod, host, t0, parent=cyc.context())
            else:
                self._bind(kube_pod, host, t0, parent=cyc.context())
        return host

    def _quota_forget(self, *pods: dict) -> None:
        """Discharge quota in-flight charges for pods whose scheduling
        cycle failed AFTER admission (FitError, volume race, internal
        error, gang refusal): they re-admit on their next pop, and a
        lingering charge would phantom-bill the tenant meanwhile."""
        if self.quota is None:
            return
        for pod in pods:
            self.quota.forget(pod["metadata"]["name"])

    def _quota_admit(self, members: list, park_pod: dict) -> bool:
        """All-or-nothing DRF quota gate for one pod or one assembled
        gang, run BEFORE any filter/allocate work. False = the tenant
        is over its dominant-resource fair share while others are
        hungry: the popped pod parks in the GATE (zero queue churn
        while over share — card releases re-queue it promptly) and the
        typed QuotaExceeded reason lands in the pod's event stream and
        ``/debug/pod/<name>`` timeline."""
        try:
            self.quota.admit(members)
            return True
        except QuotaExceeded as err:
            name = park_pod["metadata"]["name"]
            obs.event("unschedulable", pod=name, proc=self.obs_name,
                      reason="QuotaExceeded",
                      message=f"QuotaExceeded: {err}")
            self._event(name, "Warning", "QuotaExceeded", str(err))
            self.quota.park(park_pod, members)
            return False

    @staticmethod
    def _shard_key(kube_pod: dict) -> str:
        """What a pod hashes into a shard BY: gang members route by
        their gang id, not their own names — a gang split across
        replicas would park in two buffers and never assemble."""
        gk = gang_key(kube_pod)
        if gk is not None:
            return f"gang:{gk[0]}"
        return kube_pod["metadata"]["name"]

    def _submit_bind(self, kube_pod: dict, host: str, t0: float,
                     parent: Any = None) -> None:
        binder_ext = next((e for e in self.generic.extenders
                           if getattr(e, "bind_verb", None)), None)
        if binder_ext is not None:
            # a bind-verb extender is not promised thread safety (the
            # gang path keeps extender binds on this thread for the same
            # reason), so its binds never ride the worker pool
            self._bind(kube_pod, host, t0, parent=parent)
            return
        probe("core.submit_bind")
        with self._spool_lock:
            self._bind_spool.append((kube_pod, host, t0,
                                     time.perf_counter(), parent))
            if self._spool_draining:
                return  # the active drainer's loop will pick this up
            self._spool_draining = True
        if not self._binder.submit(self._drain_bind_spool,
                                   self._spool_crashed):
            # pool stopped (shutdown race): drain inline so the assumed
            # pod is bound or requeued, never silently dropped
            self._drain_bind_spool()

    def _spool_crashed(self) -> None:
        """Crash handler for the spool drainer: clear the draining flag
        (items already popped were requeued by the drainer's own
        handling) and re-arm if work remains."""
        probe("core.spool_crashed")
        with self._spool_lock:
            self._spool_draining = bool(self._bind_spool)
            rearm = self._spool_draining
        if rearm and not self._binder.submit(self._drain_bind_spool,
                                             self._spool_crashed):
            self._drain_bind_spool()

    def _bind_failed(self, kube_pod: dict) -> None:
        """Crash handler for a bind work item: whatever died mid-bind,
        the pod's assumed cards are released and the pod is requeued —
        requeued, never lost."""
        self.volume_binder.forget(kube_pod["metadata"]["name"])
        self.cache.forget_pod(kube_pod)
        self.queue.add_unschedulable(kube_pod)

    def _conflict_requeue(self, kube_pod: dict) -> None:
        """A competing scheduler replica won this pod's commit: release
        the assume and retry PROMPTLY (short park, not unschedulable
        backoff) — the replan runs against the winner's committed
        state. A conflict STREAK means the replans keep losing (stale
        view, pathological contention): degrade to the exponential
        backoff so the pod cannot hot-loop against the arbiter."""
        probe("core.conflict_requeue")
        name = kube_pod["metadata"]["name"]
        self.volume_binder.forget(name)
        self.cache.forget_pod(kube_pod)
        with self._conflict_lock:
            streak = self._conflict_streak.get(name, 0) + 1
            self._conflict_streak[name] = streak
        obs.event("conflict_loss", pod=name, proc=self.obs_name,
                  streak=streak)
        if streak <= 3:
            self.queue.park(kube_pod, self.CONFLICT_RETRY_S)
        else:
            # escalation is an anomaly worth evidence: the replica keeps
            # re-deriving plans the arbiter refuses (stale view or
            # pathological contention)
            obs.FLIGHT.trigger("conflict_streak", key=name, pod=name,
                               streak=streak)
            self.queue.add_unschedulable(kube_pod)

    def _conflict_cleared(self, name: str) -> None:
        with self._conflict_lock:
            self._conflict_streak.pop(name, None)

    # A spool drain caps its batch so one worker cannot hoard the whole
    # backlog while its siblings idle.
    MAX_BIND_BATCH = 16

    def _drain_bind_spool(self) -> None:
        """The spool drainer: loop popping runs of spooled single-pod
        binds and committing each run as ONE ``bind_many`` (annotations +
        bindings in a single round trip) until the spool is empty. Only
        one drainer runs at a time — that is what makes batching engage:
        while this loop is on the wire the cycle keeps spooling, so the
        next run is bigger. A crash mid-run releases every popped pod's
        assume and requeues it."""
        while True:
            with self._spool_lock:
                count = min(len(self._bind_spool), self.MAX_BIND_BATCH)
                items = [self._bind_spool.popleft() for _ in range(count)]
                if not items:
                    self._spool_draining = False
                    return
            try:
                self._process_bind_items(items)
            except Exception:
                log.exception("bind batch crashed; requeueing its pods")
                for kube_pod, _, _, _, _ in items:
                    try:
                        self._bind_failed(kube_pod)
                    except Exception:
                        log.exception("bind crash handler failed for %s",
                                      kube_pod["metadata"]["name"])

    def _process_bind_items(self, items: list) -> None:
        if getattr(self.api, "bind_many", None) is None:
            # no batch verb on this transport: per-pod writes
            # (bind-verb extenders never reach here — _submit_bind keeps
            # their binds on the scheduling thread)
            for kube_pod, host, t0, ts, parent in items:
                if self._bind(kube_pod, host, t0,
                              attempts=self.BIND_ATTEMPTS, parent=parent):
                    metrics.BIND_LATENCY_MS.observe(
                        (time.perf_counter() - ts) * 1e3)
            return
        # even a single pod rides the batch form: bind_many carries its
        # annotations AND binding in one round trip (vs two)
        self._bind_batch(items)

    def _bind_batch(self, items: list) -> None:
        """Coalesced single-pod binds through one ``bind_many``. NOT
        semantically all-or-nothing (these pods are independent): if the
        batch write fails, each pod degrades to its own per-pod bind so
        one bad pod (deleted mid-flight, bound elsewhere) cannot requeue
        its batch-mates.

        Each pod gets a ``bind_commit`` span parented under its
        scheduling cycle; the span contexts ride the batch write
        (``obs.batch_context`` → wire header on HTTP transports) so the
        apiserver's arbiter-commit and WAL-append spans continue the
        same per-pod traces."""
        ready = []
        for kube_pod, host, t0, ts, parent in items:
            name = kube_pod["metadata"]["name"]
            if not self.volume_binder.bind(name):
                self.cache.forget_pod(kube_pod)
                self._event(name, "Warning", "FailedScheduling",
                            "volume bind conflict; rescheduling")
                self.queue.add_unschedulable(kube_pod)
                continue
            ready.append((kube_pod, host, t0, ts, parent))
        if not ready:
            return
        tb = time.perf_counter()
        spans = {p["metadata"]["name"]:
                 obs.start_span("bind_commit",
                                pod=p["metadata"]["name"], parent=parent,
                                proc=self.obs_name, node=host)
                 for p, host, _, _, parent in ready}
        while ready:
            try:
                with obs.batch_context({n: sp.context()
                                        for n, sp in spans.items()}):
                    self._gang_bind_write(
                        [(p["metadata"]["name"], host, p)
                         for p, host, _, _, _ in ready],
                        attempts=self.BIND_ATTEMPTS)
                break
            except Conflict as err:
                # The arbiter named the losers (per-pod detail): forget +
                # requeue exactly those — a Conflict is a definitive
                # server answer, NEVER retried — and re-send the rest as
                # one batch. Without detail (older server), degrade to
                # the pessimistic per-pod path below.
                losers = {n for n in getattr(err, "per_pod", None) or ()}
                if not losers:
                    for sp in spans.values():
                        sp.finish(outcome="degraded")
                    self._bind_batch_pessimistic(ready)
                    return
                survivors = []
                for item in ready:
                    name = item[0]["metadata"]["name"]
                    if name in losers:
                        spans.pop(name).finish(
                            outcome="conflict",
                            reason=err.per_pod.get(name))
                        self._event(name, "Warning", "FailedScheduling",
                                    f"bind conflict: "
                                    f"{err.per_pod.get(name)}; rescheduling")
                        self._conflict_requeue(item[0])
                    else:
                        survivors.append(item)
                ready = survivors
                if not ready:
                    return
            except Exception:
                for sp in spans.values():
                    sp.finish(outcome="degraded")
                self._bind_batch_pessimistic(ready)
                return
        now = time.perf_counter()
        events = []
        for kube_pod, host, t0, ts, _parent in ready:
            name = kube_pod["metadata"]["name"]
            self.cache.confirm_pod(name)
            self._conflict_cleared(name)
            self.generic.clear_nomination(name)
            self.queue.forget(name)
            events.append({"kind": "Pod", "name": name, "type": "Normal",
                           "reason": "Scheduled",
                           "message": f"Successfully assigned {name} "
                                      f"to {host}"})
            spans[name].finish(outcome="committed")
            metrics.SCHED_PHASE_MS.labels("bind_commit").observe(
                (now - tb) * 1e3)
            metrics.BIND_LATENCY_MS.observe((now - ts) * 1e3)
            metrics.BINDING_LATENCY.observe((now - tb) * 1e6)
            metrics.E2E_SCHEDULING_LATENCY.observe((now - t0) * 1e6)
        self._note_bound(len(ready))
        self._events_batch(events)

    def _bind_batch_pessimistic(self, items: list) -> list:
        """Degrade a failed coalesced batch to per-pod binds with the
        same in-place retry budget (volume binds are already committed
        and bind() re-entry no-ops on them) — one bad pod fails alone."""
        for kube_pod, host, t0, ts, parent in items:
            if self._bind(kube_pod, host, t0, attempts=self.BIND_ATTEMPTS,
                          parent=parent):
                metrics.BIND_LATENCY_MS.observe(
                    (time.perf_counter() - ts) * 1e3)
        return []

    def _events_batch(self, events: list) -> None:
        """Batched Event recording — observability only (an API hiccup
        must never affect scheduling); one request for the whole batch
        when the transport offers it."""
        if not events:
            return
        record_many = getattr(self.api, "record_events", None)
        if record_many is not None:
            try:
                record_many(events)
            except Exception:
                pass
            return
        for e in events:
            self._event(e["name"], e["type"], e["reason"], e["message"])

    def _handle_gang_pod(self, kube_pod: dict, gang: int, size: int) -> None:
        """Buffer gang members; when complete, place the whole pod-set
        host by host (`GangPlanner.plan`), all-or-nothing. A gang that
        does not fit preempts lower-priority pods when it can
        (`_try_gang_preempt`); otherwise it stays buffered and one member
        waits in the unschedulable set, so a cluster change retries the
        whole gang."""
        members = self.gang_buffer.add(kube_pod, gang, size)
        if members is None:
            return  # waiting for the rest of the gang
        if self.quota is not None and \
                not self._quota_admit(members, kube_pod):
            # admitted whole or not at all: the gate saw every member's
            # demand in one call and refused; siblings stay buffered,
            # the popped member parks in the gate and its re-queue
            # re-triggers the whole gang
            return
        metrics.SCHEDULE_ATTEMPTS.inc()
        t0 = time.perf_counter()
        self.cache.expire_assumed()
        member_names = {m["metadata"]["name"] for m in members}
        gang_prio = min(_pod_priority(m) for m in members)
        reserved = self.generic._nominated_chip_reservation(
            exclude=member_names, min_priority=gang_prio)
        with obs.span("gang_plan", pod=kube_pod["metadata"]["name"],
                      proc=self.obs_name, gang=gang, size=size) as sp:
            assignment = self.gang_planner.plan(members, reserved=reserved)
            sp.attrs["planned"] = assignment is not None
        if assignment is None:
            outcome = (self._try_gang_preempt(members, gang_prio, reserved)
                       if self.preemption_enabled else False)
            if isinstance(outcome, dict):
                assignment = outcome  # room among free cards: place now
            elif outcome:
                # victims evicted, each member nominated onto its host:
                # retry promptly (members stay buffered; the pop re-plans)
                metrics.SCHEDULE_FAILURES.inc()
                self.queue.push(kube_pod)
                return
            else:
                # members stay buffered; requeue one so a later pop
                # retries the whole gang once the cluster changes
                metrics.SCHEDULE_FAILURES.inc()
                self._quota_forget(*members)
                self._event(kube_pod["metadata"]["name"], "Warning",
                            "FailedScheduling",
                            f"gang {gang} of {size} does not fit")
                self.queue.add_unschedulable(kube_pod)
                return
        # any member nominations did their job (the planner just placed
        # the gang); clear them so sibling reservations don't double-
        # charge the per-member validation below
        for name in member_names:
            self.generic.clear_nomination(name)
        # Write each member's process contract (rank/count/coordinator)
        # so the runtime hook can hand the gang torchrun's variables.
        # Ports promised to gangs whose pipelined commit is still in
        # flight are not API-visible yet, so they ride in explicitly —
        # without this, two overlapping gangs could share a coordinator.
        with self._gang_lock:
            inflight_ports = set(self._gang_ports_inflight.values())
        with self._view_lock:
            mirror_pods = list(self._pod_view.values())
        coord = annotate_gang_processes(members, assignment, gang,
                                        api=self.api,
                                        extra_used=inflight_ports,
                                        pods=mirror_pods)
        with self._gang_lock:
            self._gang_ports_inflight[gang] = coord
        # Pin every member, then validate each against its host through the
        # full predicate stack (taints, selectors, core resources) — the
        # planner only reasons about cards and must not bypass feasibility.
        pinned_members = []
        for member in members:
            name = member["metadata"]["name"]
            node_name, cards = assignment[name]
            pinned = self.gang_planner.pin_pod(member, node_name, cards)
            pinned_members.append((name, node_name, pinned))
        # Build the cluster metadata once if ANY member declares affinity
        # (members may differ) or any placed pod carries it.
        need_meta = self.cache.has_affinity_pods() or any(
            interpod.pod_declares_interpod_affinity(p)
            for _, _, p in pinned_members)
        meta = self.cache.interpod_snapshot() if need_meta else None
        for name, node_name, pinned in pinned_members:
            fits, _, _ = self.generic._fits_on_node(pinned, node_name,
                                                    meta=meta)
            if not fits:
                metrics.SCHEDULE_FAILURES.inc()
                self._quota_forget(*members)
                self._release_gang_port(gang)
                self.queue.add_unschedulable(kube_pod)
                return
        # Volumes: reserve every member's pvc->pv pairings before any pod
        # binds (same contract as the single-pod path — the kubelet must
        # find claims bound when the pod lands); all-or-nothing like the
        # rest of the gang commit.
        vol_assumed: list = []
        for name, node_name, pinned in pinned_members:
            if self._assume_volumes(pinned, node_name):
                vol_assumed.append(name)
            else:
                for done in vol_assumed:
                    self.volume_binder.forget(done)
                metrics.SCHEDULE_FAILURES.inc()
                self._quota_forget(*members)
                self._release_gang_port(gang)
                self.queue.add_unschedulable(kube_pod)
                return
        self.gang_buffer.drop_gang(gang)
        # Two-phase commit: assume everything HERE, in the scheduling
        # cycle (reversible, and the very next pod must see the charges),
        # then bind the pod-set. Without a delegated binder the bind is
        # one atomic `bind_many` (all-or-nothing) — with the pipelined
        # binder it runs on a bind worker, overlapping the next cycle. A
        # bind-verb extender owns EVERY binding (same contract as the
        # single-pod path), binds members one at a time, and stays on the
        # scheduling thread (extenders are not promised thread safety) —
        # atomicity then holds only up to the first failure, and members
        # already bound stay bound.
        binder = next((e for e in self.generic.extenders
                       if getattr(e, "bind_verb", None)), None)
        assumed: list = []
        try:
            for _, node_name, pinned in pinned_members:
                self.cache.assume_pod(pinned, node_name)
                assumed.append(pinned)
        except Exception:
            metrics.SCHEDULE_FAILURES.inc()
            for pinned in assumed:
                self.cache.forget_pod(pinned)
            for name, _, _ in pinned_members:
                self.volume_binder.forget(name)
            self._quota_forget(*members)
            self._release_gang_port(gang)
            for member in members:
                self.queue.add_unschedulable(member)
            return
        if self._binder is not None and binder is None:
            queued = self._binder.submit(
                lambda: self._commit_gang(members, pinned_members, gang,
                                          t0, None,
                                          attempts=self.BIND_ATTEMPTS),
                lambda: self._gang_commit_failed(members, pinned_members,
                                                 gang))
            if queued:
                return
            # pool stopped (shutdown race): commit inline rather than
            # strand a fully-assumed gang
        self._commit_gang(members, pinned_members, gang, t0, binder)

    def _gang_bind_write(self, pinned_members: list,
                         attempts: int = 1) -> None:
        """One atomic ``bind_many`` with bounded transient-failure retry
        (pipelined binder only): re-applying the identical bind_many
        converges — every pod rebinding to its own node is a no-op — so
        a lost reply is resent instead of costing the gang a replan.
        Conflict (a member bound elsewhere) and NotFound (a member
        deleted mid-flight) are definitive server answers: never
        retried.

        Over a transport whose ``bind_many`` is not atomic
        (``KubeAPIClient``: annotate every member, then bind every
        member) a refused member keeps its stamp, unlike the single-pod
        path's (`_bind_write`). That is deliberate: the reader keeps a
        pending member's same-node allocation as its pin, which is how a
        partially committed gang's stragglers retry on their planned
        cards."""
        bindings = {n: node for n, node, _ in pinned_members}
        annotations = {n: p["metadata"].get("annotations") or {}
                       for n, _, p in pinned_members}
        attempts = max(1, attempts)
        for attempt in range(attempts):
            try:
                self.api.bind_many(bindings, annotations)
                return
            except Conflict as err:
                # a competing replica committed first: count each refused
                # pod — the callers forget + requeue, never retry
                metrics.SCHED_CONFLICTS.inc(
                    max(1, len(getattr(err, "per_pod", None) or ())))
                raise
            except NotFound:
                raise
            except Exception:
                if attempt + 1 >= attempts:
                    raise
                self._stop.wait(0.02 * (attempt + 1))

    def _commit_gang(self, members: list, pinned_members: list,
                     gang: int, t0: float, binder: Any,
                     attempts: int = 1) -> None:
        """The transport half of a gang commit: volume binds, then the
        atomic batch bind (or the delegated binder's per-member path).
        All members are already assumed; ANY failure forgets every
        non-committed sibling's assume — zero leaked cards — and
        requeues."""
        committed: list = []
        spans = {n: obs.start_span("bind_commit", pod=n,
                                   proc=self.obs_name, node=node,
                                   gang=gang)
                 for n, node, _ in pinned_members}
        try:
            for name, _, _ in pinned_members:
                if not self.volume_binder.bind(name):
                    raise RuntimeError(f"volume bind conflict for {name}")
            if binder is None:
                with obs.batch_context({n: sp.context()
                                        for n, sp in spans.items()}):
                    self._gang_bind_write(pinned_members, attempts)
                committed = [n for n, _, _ in pinned_members]
            else:
                for name, node_name, pinned in pinned_members:
                    self.api.update_pod_annotations(
                        name, pinned["metadata"].get("annotations") or {})
                    try:
                        binder.bind(name, node_name)
                    except Exception:
                        # same contract as the single-pod path: an
                        # ignorable binder falls back to the API binding
                        if not binder.ignorable:
                            raise
                        self.api.bind_pod(name, node_name)
                    committed.append(name)
            for name, _, _ in pinned_members:
                self.cache.confirm_pod(name)
                self._conflict_cleared(name)
                self.queue.forget(name)
                spans[name].finish(outcome="committed")
                metrics.E2E_SCHEDULING_LATENCY.observe(
                    (time.perf_counter() - t0) * 1e6)
            self._note_bound(len(pinned_members))
        except Exception as err:
            # Release every assume EXCEPT members a delegated binder
            # already bound (they are placed; their charge must stand).
            # Committed volume binds stay (idempotent and harmless, see
            # volumebinder.py) — the retry recomputes against them.
            metrics.SCHEDULE_FAILURES.inc()
            done = set(committed)
            for name, _, pinned in pinned_members:
                if name in done:
                    self.cache.confirm_pod(name)
                    self.queue.forget(name)
                    spans[name].finish(outcome="committed")
                    continue
                spans[name].finish(
                    outcome="failed",
                    reason=f"{type(err).__name__}: {err}")
                self.volume_binder.forget(name)
                self.cache.forget_pod(pinned)
            if not done:
                # nothing bound: the whole gang re-buffers and retries
                for member in members:
                    self.queue.add_unschedulable(member)
                return
            # Partial delegated commit: the gang can never re-buffer to
            # full size (bound members won't return), so stragglers
            # retry as SOLO pods pinned to their planned cards. The
            # de-ganged annotation must be persisted — schedule_one
            # re-fetches the pod from the API and would otherwise see
            # the gang request again and park it in the buffer forever.
            for name, _, pinned in pinned_members:
                if name in done:
                    continue
                try:
                    info = codec.kube_pod_to_pod_info(
                        pinned, invalidate_existing=False)
                    info.requests.pop(RESOURCE_GANG, None)
                    info.requests.pop(RESOURCE_GANG_SIZE, None)
                    codec.pod_info_to_annotation(pinned["metadata"], info)
                    self.api.update_pod_annotations(
                        name, pinned["metadata"]["annotations"])
                except Exception:
                    # keep the gang shape; the buffer retry below is
                    # degraded but the pod is not lost
                    log.warning("could not strip gang shape off %s; "
                                "member retries gang-shaped", name,
                                exc_info=True)
                self._event(name, "Warning", "FailedScheduling",
                            "gang partially bound; retrying member solo "
                            "pinned to its planned cards")
                self.queue.add_unschedulable(pinned)
        finally:
            self._release_gang_port(gang)

    def _gang_commit_failed(self, members: list, pinned_members: list,
                            gang: int) -> None:
        """Crash handler for a gang bind work item: the atomic batch's
        all-or-nothing contract holds even when the commit path itself
        dies — forget EVERY sibling's assume and requeue the whole
        gang."""
        metrics.SCHEDULE_FAILURES.inc()
        for name, _, pinned in pinned_members:
            self.volume_binder.forget(name)
            self.cache.forget_pod(pinned)
        self._release_gang_port(gang)
        for member in members:
            self.queue.add_unschedulable(member)

    def _release_gang_port(self, gang: int) -> None:
        with self._gang_lock:
            self._gang_ports_inflight.pop(gang, None)

    NOMINATED_NODE_ANNOTATION = "scheduler.alpha.kubernetes.io/nominated-node-name"

    def _event(self, pod_name: str, event_type: str, reason: str,
               message: str) -> None:
        """Record a scheduling Event on the pod (`scheduler.go:198,242`);
        observability only — an API hiccup must never affect scheduling."""
        record = getattr(self.api, "record_event", None)
        if record is None:
            return
        try:
            record("Pod", pod_name, event_type, reason, message)
        except Exception:
            pass

    def _summarize_failures(self, failures: dict, cap: int = 5) -> str:
        """Aggregate per-node failure reasons into the compact
        '0/N nodes are available: M reason' shape operators expect. N is
        the CLUSTER node count — a FitError raised outside the main
        predicate pass (e.g. allocate_devices on a vanished node) carries
        only the offending node in ``failures``."""
        total = len(self.cache.node_names())
        counts: dict = {}
        for reasons in failures.values():
            for reason in reasons or ["unknown"]:
                counts[reason] = counts.get(reason, 0) + 1
        if not counts:
            return "no nodes available to schedule pods"
        parts = [f"{n} {r}" for r, n in
                 sorted(counts.items(), key=lambda kv: (-kv[1], kv[0]))[:cap]]
        return (f"0/{total} nodes are available: " + "; ".join(parts) + ".")

    def _try_preempt(self, kube_pod: dict,
                     failures: dict | None = None) -> bool:
        found = self.generic.preempt(kube_pod, failures)
        if not found:
            return False
        node_name, victims = found
        preemptor = kube_pod["metadata"]["name"]
        for victim in victims:
            metrics.PREEMPTION_VICTIMS.inc()
            victim_name = victim["metadata"]["name"]
            self._event(victim_name, "Normal", "Preempted",
                        f"by pod {preemptor} on node {node_name}")
            try:
                self.api.delete_pod(victim_name)
            except KeyError:
                pass  # victim already gone: the room is free either way
        # record where the preemption made room (upstream's nominated
        # node). Must be persisted via the API: the next scheduling pass
        # re-fetches the pod, so a local-dict-only annotation would be lost.
        try:
            name = kube_pod["metadata"]["name"]
            annotations = dict(
                (kube_pod.get("metadata") or {}).get("annotations") or {})
            annotations[self.NOMINATED_NODE_ANNOTATION] = node_name
            self.api.update_pod_annotations(name, annotations)
        except Exception:
            pass  # the annotation is the persisted mirror; the in-memory
            # nomination below still protects the room this side of a
            # scheduler restart
        self.generic.nominate(kube_pod, node_name)
        return True

    def _try_gang_preempt(self, members: list, gang_prio: int,
                          reserved: dict | None = None) -> Any:
        """Gang preemption: when the gang places nowhere, evict the
        cheapest set of lower-priority pods whose cards let it place
        (`GangPlanner.plan_preemption`). Victim cost follows the
        reference's pickOneNodeForPreemption order (fewest PDB
        violations, lowest highest victim priority, lowest priority sum,
        fewest victims, then the victims' sorted names); the freed room
        is held by per-member nominations until the retry lands, as on
        the single-pod path.

        Returns the assignment when the search placed the gang on cards
        already free (place now, no eviction), True when victims were
        evicted and the members nominated (requeue and retry), False
        otherwise."""
        try:
            # bound pods only, from the informer mirror (read-only;
            # victims are deleted by name)
            pods = self._view_list_bound()
        except Exception:
            return False
        pods_by_name: dict = {}
        owners: dict = {}
        may_evict: set = set()
        gang_of: dict = {}       # bound pod -> its gang id
        gang_members: dict = {}  # gang id -> bound member names
        member_names = {m["metadata"]["name"] for m in members}
        for p in pods:
            name = p["metadata"]["name"]
            if name in member_names:
                continue
            node = p["spec"]["nodeName"]
            try:
                info = codec.kube_pod_to_pod_info(
                    p, invalidate_existing=False)
            except Exception:
                # this pod's cards cannot be attributed to an owner, so
                # they are invisible to preemption planning
                log.debug("unreadable device annotation on %s; its cards "
                          "are not preemptible this pass", name,
                          exc_info=True)
                continue
            pods_by_name[name] = p
            for _, cont, _ in info.all_containers():
                for path in cont.allocate_from.values():
                    prefix = grammar.gpu_prefix_from_path(path)
                    if prefix is not None:
                        owners[(node, prefix)] = name
            gk = gang_key(p)
            if gk is not None:
                gang_of[name] = gk[0]
                gang_members.setdefault(gk[0], set()).add(name)
            if _pod_priority(p) < gang_prio:
                may_evict.add(name)
        if not may_evict:
            return False
        pdb_state = self.generic._pdb_state()

        def closure(victim_names) -> frozenset | None:
            """Victims widened to whole bound gangs: evicting one member
            of a running gang strands its siblings mid-collective, so the
            eviction unit is the gang. None when a widened member may not
            be evicted (its priority is not below the gang's)."""
            out = set(victim_names)
            for n in victim_names:
                g = gang_of.get(n)
                if g is not None:
                    out |= gang_members[g]
            if not out <= may_evict:
                return None
            return frozenset(out)

        def cost(victim_names: frozenset) -> tuple | None:
            if not victim_names:
                # below every real eviction set (priorities may be
                # negative, so only a shorter tuple is safely minimal)
                return (-1,)
            full = closure(victim_names)
            if full is None:
                return None
            victims = [pods_by_name[n] for n in full]
            violating, _ = GenericScheduler._split_by_pdb_violation(
                victims, pdb_state)
            prios = [_pod_priority(v) for v in victims]
            return (len(violating), max(prios), sum(prios), len(victims))

        units: dict = {}
        for name in sorted(may_evict):
            full = closure({name})
            if full is not None and full not in units:
                units[full] = [pods_by_name[n] for n in sorted(full)]
        stats: dict = {}
        with obs.span("gang_preempt", pod=sorted(member_names)[0],
                      proc=self.obs_name, units=len(units)) as sp:
            found = self.gang_planner.plan_preemption(
                members, list(units.values()), owners, cost,
                reserved=reserved, stats=stats)
            sp.attrs.update(stats)
            sp.attrs["victims"] = len(found[1]) if found else 0
        if found is None:
            return False
        assignment, victim_names = found
        if not victim_names:
            # the search placed the gang on cards already free: hand the
            # assignment straight back — retrying plan() would fail the
            # same way and ping-pong forever
            return assignment
        for victim_name in sorted(victim_names):
            metrics.PREEMPTION_VICTIMS.inc()
            self._event(victim_name, "Normal", "Preempted",
                        f"by gang of {sorted(member_names)}")
            try:
                self.api.delete_pod(victim_name)
            except KeyError:
                pass  # victim already gone: the room is free either way
            except Exception:
                return False  # retry later; cache unchanged for the rest
        # hold the freed room: nominate every member onto its planned
        # host, persisted in ONE batched request when the transport
        # offers it (restart-safe, like _try_preempt)
        batch_ann: dict = {}
        for member in members:
            name = member["metadata"]["name"]
            annotations = dict(
                (member.get("metadata") or {}).get("annotations") or {})
            annotations[self.NOMINATED_NODE_ANNOTATION] = assignment[name][0]
            batch_ann[name] = annotations
        update_many = getattr(self.api, "update_pod_annotations_many", None)
        try:
            if update_many is not None:
                update_many(batch_ann)
            else:
                for name, annotations in batch_ann.items():
                    self.api.update_pod_annotations(name, annotations)
        except Exception:
            # the in-memory nominations below still hold the room; only
            # restart-safety is lost — worth a trace
            log.warning("could not persist nominated-node annotations on "
                        "gang %s", sorted(batch_ann), exc_info=True)
        for member in members:
            self.generic.nominate(member,
                                  assignment[member["metadata"]["name"]][0])
        return True

    def _assume_volumes(self, kube_pod: dict, host: str) -> bool:
        """Reserve pvc->pv pairings for the chosen host (the reference
        assumes volume bindings after host selection,
        `volume_binder.go:1-74`). True = nothing to do or reserved."""
        snap = self.cache.snapshot_node(host)
        if snap is None:
            return False
        return self.volume_binder.assume(kube_pod, snap.kube_node)

    THROUGHPUT_WINDOW_S = 5.0

    def _note_bound(self, count: int) -> None:
        """Fold ``count`` freshly committed binds into the headline
        ``sched_throughput_pods_per_s`` gauge — a rolling window over
        recent commits, so both the steady trickle and a batch cycle's
        burst read as a rate. Bind workers call this concurrently with
        the spool drainer."""
        now = time.monotonic()
        with self._throughput_lock:
            window = self._bound_window
            window.append((now, count))
            cutoff = now - self.THROUGHPUT_WINDOW_S
            while window and window[0][0] < cutoff:
                window.popleft()
            total = sum(c for _, c in window)
            span = max(now - window[0][0], 0.05)
        metrics.SCHED_THROUGHPUT.set(total / span)

    def _bind(self, kube_pod: dict, host: str, t0: float,
              attempts: int = 1, parent: Any = None) -> bool:
        """Volumes first (the kubelet must find claims bound when the pod
        lands), then annotation, then the binding — the kubelet-side hook
        must see allocate_from the moment the pod lands
        (`scheduler.go:405-417`). ``attempts`` > 1 (the pipelined binder)
        retries transient transport failures in place before falling back
        to forget + requeue. Returns True only when the pod actually
        bound (failures requeue and return False)."""
        name = kube_pod["metadata"]["name"]
        tb = time.perf_counter()
        if not self.volume_binder.bind(name):
            # bind-time conflict (external writer grabbed the PV):
            # requeue; the next pass recomputes against fresh PV state
            self.cache.forget_pod(kube_pod)
            self._event(name, "Warning", "FailedScheduling",
                        "volume bind conflict; rescheduling")
            self.queue.add_unschedulable(kube_pod)
            return False
        sp = obs.start_span("bind_commit", pod=name, parent=parent,
                            proc=self.obs_name, node=host)
        try:
            with obs.batch_context({name: sp.context()}):
                self._bind_write(name, kube_pod, host, attempts)
        except Exception as err:
            if isinstance(err, Conflict):
                sp.finish(outcome="conflict", reason=str(err))
                self._conflict_requeue(kube_pod)
            else:
                sp.finish(outcome="failed",
                          reason=f"{type(err).__name__}: {err}")
                self.cache.forget_pod(kube_pod)
                self.queue.add_unschedulable(kube_pod)
            return False
        self.cache.confirm_pod(name)
        self._conflict_cleared(name)
        self.generic.clear_nomination(name)  # reservation served its purpose
        self.queue.forget(name)  # clears any leftover backoff state
        self._event(name, "Normal", "Scheduled",
                    f"Successfully assigned {name} to {host}")
        now = time.perf_counter()
        sp.finish(outcome="committed")
        metrics.SCHED_PHASE_MS.labels("bind_commit").observe(
            (now - tb) * 1e3)
        metrics.BINDING_LATENCY.observe((now - tb) * 1e6)
        metrics.E2E_SCHEDULING_LATENCY.observe((now - t0) * 1e6)
        self._note_bound(1)
        return True

    def _bind_write(self, name: str, kube_pod: dict, host: str,
                    attempts: int = 1) -> None:
        """The transport half of one bind: annotation and binding in one
        atomic ``bind_many``, or, for a bind-verb extender, the annotation
        write and then the extender's binding. Retried up to ``attempts``
        times on transient failures — safe because the writes converge on
        resend (the annotation replace is idempotent; the bind re-applied
        for the SAME node is a no-op, so a duplicated or lost-reply bind
        cannot double-apply). Conflict (bound elsewhere) and NotFound
        (deleted mid-flight) are the server speaking and are never
        retried.

        Under sharded replicas a competing replica may take the card
        first. Were the refused attempt's allocation left stamped on the
        pending pod, every replan on that host would read it back as the
        pod's own pinned allocation and fail on the taken card: hence one
        write, and for the extender's two writes a stamp withdrawn when
        the bind fails (`_withdraw_stamp`). A transport whose
        ``bind_many`` is not atomic (``atomic_bind_many = False``:
        ``KubeAPIClient``, since Kubernetes has none) annotates and then
        binds, so its refused bind is withdrawn the same way."""
        # an extender declaring a bind verb owns the binding
        # (`extender.go:44,90`); an ignorable binder that errors falls
        # back to the API binding, a non-ignorable one fails the bind
        # like any API error
        binder = next((e for e in self.generic.extenders
                       if getattr(e, "bind_verb", None)), None)
        annotations = kube_pod["metadata"].get("annotations") or {}
        attempts = max(1, attempts)
        two_stage = not getattr(self.api, "atomic_bind_many", True)
        stamped = False
        for attempt in range(attempts):
            try:
                if binder is None:
                    # a two-stage bind_many may have stamped before failing
                    stamped = two_stage
                    self.api.bind_many({name: host}, {name: annotations})
                    return
                self.api.update_pod_annotations(name, annotations)
                stamped = True
                try:
                    binder.bind(name, host)
                except Exception:
                    if not binder.ignorable:
                        raise
                    self.api.bind_pod(name, host)
                return
            except Conflict:
                # taken card / taken port / bound elsewhere: a competing
                # replica won this commit — forget + requeue, never retry
                metrics.SCHED_CONFLICTS.inc()
                if stamped:
                    self._withdraw_stamp(name, kube_pod)
                raise
            except NotFound:
                raise
            except Exception:
                if attempt + 1 >= attempts:
                    if stamped:
                        self._withdraw_stamp(name, kube_pod)
                    raise
                self._stop.wait(0.02 * (attempt + 1))

    def _withdraw_stamp(self, name: str, kube_pod: dict) -> None:
        """Rewrite a pod whose bind failed after its allocation was
        stamped with that allocation invalidated (node pin and
        ``allocate_from`` dropped, requests kept, as a requeued pod is
        written), so the replan starts from intent. Best effort: a pod
        bound meanwhile refuses the rewrite, and that is fine."""
        meta = copy.deepcopy(kube_pod["metadata"])
        info = codec.kube_pod_to_pod_info(kube_pod, invalidate_existing=True)
        codec.pod_info_to_annotation(meta, info)
        try:
            self.api.update_pod_annotations(name, meta.get("annotations")
                                            or {})
        except Exception:
            log.warning("could not withdraw the allocation stamped on %s "
                        "after its bind failed", name, exc_info=True)

    def run_until_idle(self, max_passes: int = 10000) -> int:
        """Drain the queue synchronously (tests, benchmarks). Returns the
        number of pods processed. With the pipelined binder, "idle" also
        means the bind pool drained — a failed in-flight bind requeues
        its pod, so the queue is re-checked after every flush."""
        n = 0
        while n < max_passes:
            if self.schedule_one(timeout=0.0):
                n += 1
                continue
            if self._binder is not None and self._binder.flush():
                continue
            if self.quota is not None and self.quota.release_due():
                # quota-parked pods became affordable (cards released,
                # grace lapsed): they re-queued, so drain again
                continue
            break
        return n

    def run_forever(self, poll_s: float = 0.2) -> None:
        obs.register_thread("sched-loop")
        while not self._stop.is_set():
            try:
                if not self.schedule_one(timeout=poll_s):
                    if self.quota is not None:
                        # idle nudge: a lapsed hungry-grace window makes
                        # parked tenants affordable without any watch
                        # event announcing it
                        self.quota.release_due()
                    time.sleep(0)
            except Exception:
                # One bad pod or a racing node deletion must not kill the
                # scheduling thread.
                metrics.log.exception("schedule_one failed")
                time.sleep(0.01)

    def start(self) -> threading.Thread:
        t = threading.Thread(target=self.run_forever, daemon=True,
                             name="scheduler")
        t.start()
        return t

    def stop(self) -> None:
        self._stop.set()
        if self._binder is not None:
            self._binder.stop()
        self.generic._pool.shutdown(wait=False)
