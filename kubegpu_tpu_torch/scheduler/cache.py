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
import re
import threading
import time
from typing import Any

import numpy as np

from kubegpu_tpu_torch import metrics
from kubegpu_tpu_torch.analysis.explore import probe
from kubegpu_tpu_torch.core import codec, grammar
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
        self.pod_priorities: dict = {}  # pod name -> spec.priority (preempt scan)
        self.pod_chips: dict = {}       # pod name -> charged card-leaf count

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


def _charged_chip_count(pod_info: PodInfo) -> int:
    """Card leaves (``.../gpu/<UUID>/cards``) this pod's allocation
    charges — what eviction would free, exact by construction (the same
    ``allocate_from`` values ``return_pod_resources`` walks). 0 for
    device-less pods. The JAX package's counterpart counts TPU chips."""
    cards = 0
    for conts in (pod_info.init_containers, pod_info.running_containers):
        for cont in conts.values():
            for phys in cont.allocate_from.values():
                if grammar.gpu_id_from_path(phys) is not None:
                    cards += 1
    return cards


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


# ---- struct-of-arrays fleet mirror ------------------------------------------
#
# The vectorized scheduling core (scheduler/vectorized.py) filters and
# scores the WHOLE fleet in masked array passes instead of per-node
# Python predicate calls. These columns are its input: one row per node,
# maintained under the SAME lock and on the SAME mutation paths that bump
# fit generations today (set_node / remove_node / _charge_locked /
# _invalidate_*), so a column can never disagree with the object it
# mirrors. Rows hold only what the masked predicates read: condition
# flags, taints, core alloc/req, free-card counts (the ``free_chips``
# column keeps the JAX package's name), the canonical device-shape
# fingerprint, and the min bound-pod priority (the vectorized victim
# scan's prune key).

_NO_PODS_PRIORITY = 2 ** 62
# .../gpu/<UUID>/<suffix> — every card-attribute path (cards, memory)
_CARD_SEG_RE = re.compile(r"^(.*/" + grammar.GPU_LEAF + r"/)([^/]+)(/[^/]+)$")


def _canonical_paths(allocatable: dict) -> dict:
    """path -> identity-normalized path: each card's UUID replaced by its
    rank among the node's UUIDs in sorted order, so two nodes whose
    inventories are identical modulo which physical card is which (the
    gpugrp1/gpugrp0 tree, per-card memory, scorer values) produce
    identical canonical paths. The ranks keep the UUIDs' order, so the
    allocator's sorted-key search walks the same sequence on both, and
    its verdict for a pod whose requests name no absolute device paths
    (count mode translates per node) is the same: one search stands in
    for a whole uniform fleet. The GPU counterpart of the JAX package's
    TPU version, which shifts chip coordinates to the node's origin."""
    parsed = {}
    for res in allocatable:
        m = _CARD_SEG_RE.match(res)
        if m is not None:
            parsed[res] = (m.group(1), m.group(2), m.group(3))
    if not parsed:
        return {}
    rank = {uuid: i for i, uuid in
            enumerate(sorted({uuid for _, uuid, _ in parsed.values()}))}
    return {res: f"{head}{rank[uuid]}{tail}"
            for res, (head, uuid, tail) in parsed.items()}


def card_ids(canon: dict) -> frozenset:
    """The UUIDs a node's canonicalization map renames: a device verdict
    whose reasons name one of them is identity-specific and must not be
    broadcast to another node of the same shape."""
    return frozenset(m.group(2) for m in map(_CARD_SEG_RE.match, canon)
                     if m is not None)


class _NodeRow:
    """Per-node columnar fields, recomputed only on the mutation path
    that owns them (node flags at set_node, usage at charge time)."""

    __slots__ = ("unschedulable", "n_notready", "mem_pressure",
                 "disk_pressure", "tainted",
                 "core_alloc", "canon", "alloc_id", "chip_paths",
                 "used_key", "free_chips", "vol_heavy",
                 "min_prio", "gen")

    def __init__(self) -> None:
        self.gen = 0
        self.vol_heavy = False
        self.min_prio = _NO_PODS_PRIORITY


class ColumnarView:
    """Read-only struct-of-arrays snapshot handed to one scheduling pass
    (published under the cache lock and never written afterwards, so a
    concurrent charge cannot tear a masked filter mid-pass; successive
    views share untouched columns copy-on-write). ``names`` is sorted
    and row-aligned with
    ``cycle_snapshot``'s name list; ``dev_fps[i]`` is node i's canonical
    device-shape fingerprint (equal fingerprint => identical device
    verdict for any translation-invariant request); ``canon_maps[i]``
    its path canonicalization (shared refs — treat as immutable)."""

    __slots__ = ("names", "idx", "epoch", "gen", "unschedulable",
                 "n_notready", "mem_pressure", "disk_pressure", "tainted",
                 "vol_heavy", "free_chips",
                 "min_pod_priority", "core_alloc", "core_req",
                 "dev_fps", "canon_maps")


class _FleetColumns:
    """The live mirror. guarded-by: SchedulerCache._lock — every method
    here is only called with the cache lock held. Arrays materialize
    lazily after membership changes (a 4k-node fleet registering pays
    one O(n) build, not n of them) and are updated in place per-row
    afterwards; ``view()`` hands out copies."""

    def __init__(self) -> None:
        self.rows: dict = {}          # node name -> _NodeRow
        self._alloc_ids: dict = {}    # canonical alloc/scorer tuple -> id
        self._names: list = []
        self._idx: dict = {}
        self._arrays: dict | None = None
        self._res_keys: tuple = ()
        self._dirty = True
        self.epoch = 0  # bumped per rebuild: O(1) membership identity
        # Incremental-view state: which rows moved since the last view()
        # was published. A steady stream of charges touches O(1) rows per
        # pass, so the next view shares every untouched column with its
        # predecessor (copy-on-write: published arrays are never written
        # again) and pays only a memcpy + per-dirty-row writes for the
        # columns that moved — not the full O(nodes) Python rebuild of
        # dev_fps/canon_maps the snapshot copy used to run per pass.
        self._view_cache: "ColumnarView | None" = None
        # guarded-by: SchedulerCache._lock -- full-row changes (charge path)
        self._dirty_rows: set = set()
        # guarded-by: SchedulerCache._lock -- generation-only changes, made
        # by set_gen and bump_all_gens under _invalidate_*_locked. Declared
        # here, unlike the reference: the race twins of analysis/races.py
        # subclass SchedulerCache and call _charge_locked under the lock
        # they inherit, which the lockset model cannot see through the
        # subclass, so it would otherwise read those paths as lock-free
        self._dirty_gen: set = set()
        self._dirty_canon: set = set()  # canonicalization map changes
        # guarded-by: SchedulerCache._lock -- bump_all_gens: whole gen
        # column (declared for the same reason as _dirty_gen)
        self._gen_all = False

    # -- row computation (mutation-path hooks) ------------------------------

    def set_node(self, cached: CachedNode) -> None:
        name = cached.name
        row = self.rows.get(name)
        if row is None:
            row = _NodeRow()
            self.rows[name] = row
            self._dirty = True
        kube_node = cached.kube_node
        spec = kube_node.get("spec") or {}
        row.unschedulable = bool(spec.get("unschedulable"))
        n_notready = 0
        mem_p = disk_p = False
        for cond in (kube_node.get("status") or {}).get("conditions") or []:
            ctype, status = cond.get("type"), cond.get("status")
            if ctype == "Ready" and status != "True":
                n_notready += 1
            elif ctype == "MemoryPressure" and status == "True":
                mem_p = True
            elif ctype == "DiskPressure" and status == "True":
                disk_p = True
        row.n_notready = n_notready
        row.mem_pressure = mem_p
        row.disk_pressure = disk_p
        row.tainted = any(
            taint.get("effect") in ("NoSchedule", "NoExecute")
            for taint in spec.get("taints") or [])
        row.core_alloc = cached.core_allocatable()
        if set(row.core_alloc) - set(self._res_keys):
            self._dirty = True
        node_ex = cached.node_ex
        row.canon = _canonical_paths(node_ex.allocatable)
        canon = row.canon
        alloc_key = (
            tuple(sorted((canon.get(k, k), v)
                         for k, v in node_ex.allocatable.items())),
            tuple(sorted((canon.get(k, k), v)
                         for k, v in node_ex.scorer.items())))
        alloc_id = self._alloc_ids.get(alloc_key)
        if alloc_id is None:
            alloc_id = len(self._alloc_ids)
            self._alloc_ids[alloc_key] = alloc_id
        row.alloc_id = alloc_id
        # card-leaf paths (.../gpu/<UUID>/cards) in canonical sorted
        # order — the fixed roster the free-card count walks on every
        # charge
        row.chip_paths = tuple(sorted(
            (p for p in node_ex.allocatable
             if grammar.gpu_id_from_path(p) is not None),
            key=lambda p: canon.get(p, p)))
        if not self._dirty and self._arrays is not None:
            # canon objects live outside the arrays; the delta view
            # patches canon_maps from this set
            self._dirty_canon.add(self._idx[name])
        self.charge(cached)

    def charge(self, cached: CachedNode) -> None:
        """Usage-derived fields, recomputed on every pod charge/release
        (the same event that bumps the node's fit generation)."""
        row = self.rows.get(cached.name)
        if row is None:
            return
        node_ex = cached.node_ex
        canon = row.canon
        used = node_ex.used
        row.used_key = tuple(sorted(
            (canon.get(k, k), v) for k, v in used.items() if v))
        row.free_chips = sum(
            max(node_ex.allocatable.get(path, 0) - used.get(path, 0), 0)
            for path in row.chip_paths)
        row.vol_heavy = bool(cached.pod_volumes)
        row.min_prio = min(cached.pod_priorities.values()) \
            if cached.pod_priorities else _NO_PODS_PRIORITY
        if not self._dirty and self._arrays is not None:
            self._write_row(self._idx[cached.name], row, cached)

    def set_gen(self, name: str, gen: int) -> None:
        row = self.rows.get(name)
        if row is None:
            return
        row.gen = gen
        if not self._dirty and self._arrays is not None:
            i = self._idx[name]
            self._arrays["gen"][i] = gen
            self._dirty_gen.add(i)

    def bump_all_gens(self, gens: dict) -> None:
        for name, row in self.rows.items():
            row.gen = gens.get(name, row.gen)
        if not self._dirty and self._arrays is not None:
            arr = self._arrays["gen"]
            for i, name in enumerate(self._names):
                arr[i] = self.rows[name].gen
            self._gen_all = True

    def drop(self, name: str) -> None:
        if self.rows.pop(name, None) is not None:
            self._dirty = True

    # -- materialization ----------------------------------------------------

    def _write_row(self, i: int, row: _NodeRow, cached: CachedNode) -> None:
        arrays = self._arrays
        self._dirty_rows.add(i)
        arrays["free_chips"][i] = row.free_chips
        arrays["min_prio"][i] = row.min_prio
        arrays["vol_heavy"][i] = row.vol_heavy
        arrays["gen"][i] = row.gen
        arrays["unschedulable"][i] = row.unschedulable
        arrays["n_notready"][i] = row.n_notready
        arrays["mem_pressure"][i] = row.mem_pressure
        arrays["disk_pressure"][i] = row.disk_pressure
        arrays["tainted"][i] = row.tainted
        arrays["dev_fps"][i] = (row.alloc_id, row.used_key)
        req = cached.requested_core
        for res in self._res_keys:
            arrays["core_alloc"][res][i] = row.core_alloc.get(res, np.nan)
            arrays["core_req"][res][i] = req.get(res, 0)

    def _rebuild(self, nodes: dict) -> None:
        self._names = sorted(self.rows)
        self._idx = {n: i for i, n in enumerate(self._names)}
        n = len(self._names)
        res_keys: set = set()
        for row in self.rows.values():
            res_keys.update(row.core_alloc)
        self._res_keys = tuple(sorted(res_keys))
        self._arrays = {
            "gen": np.zeros(n, dtype=np.int64),
            "unschedulable": np.zeros(n, dtype=bool),
            "n_notready": np.zeros(n, dtype=np.int16),
            "mem_pressure": np.zeros(n, dtype=bool),
            "disk_pressure": np.zeros(n, dtype=bool),
            "tainted": np.zeros(n, dtype=bool),
            "vol_heavy": np.zeros(n, dtype=bool),
            "free_chips": np.zeros(n, dtype=np.int64),
            "min_prio": np.zeros(n, dtype=np.int64),
            "core_alloc": {res: np.full(n, np.nan)
                           for res in self._res_keys},
            "core_req": {res: np.zeros(n) for res in self._res_keys},
            "dev_fps": [None] * n,
        }
        for i, name in enumerate(self._names):
            self._write_row(i, self.rows[name], nodes[name])
        self._dirty = False
        self.epoch += 1
        # row indices renumbered: the cached view and its dirty deltas
        # no longer describe these arrays
        self._view_cache = None
        self._dirty_rows.clear()
        self._dirty_gen.clear()
        self._dirty_canon.clear()
        self._gen_all = False

    def view(self, nodes: dict) -> "ColumnarView | None":
        if len(self.rows) != len(nodes):
            return None
        if self._dirty or self._arrays is None:
            self._rebuild(nodes)
        prev = self._view_cache
        if prev is not None and prev.epoch == self.epoch:
            out = self._delta_view(prev)
        else:
            out = self._full_view()
        self._view_cache = out
        self._dirty_rows.clear()
        self._dirty_gen.clear()
        self._dirty_canon.clear()
        self._gen_all = False
        return out

    def _full_view(self) -> "ColumnarView":
        arrays = self._arrays
        out = ColumnarView()
        out.names = list(self._names)
        out.idx = self._idx
        out.epoch = self.epoch
        for field in ("gen", "unschedulable", "n_notready", "mem_pressure",
                      "disk_pressure", "tainted", "vol_heavy",
                      "free_chips"):
            setattr(out, field, arrays[field].copy())
        out.min_pod_priority = arrays["min_prio"].copy()
        out.core_alloc = {res: arr.copy()
                          for res, arr in arrays["core_alloc"].items()}
        out.core_req = {res: arr.copy()
                        for res, arr in arrays["core_req"].items()}
        out.dev_fps = list(arrays["dev_fps"])
        out.canon_maps = [self.rows[n].canon for n in self._names]
        return out

    def _delta_view(self, prev: "ColumnarView") -> "ColumnarView":
        """O(changed) successor view. Published views are immutable —
        in-place mutations only ever land in ``self._arrays`` — so a
        column with no dirty rows since ``prev`` was published is
        SHARED with it outright; a touched column is copied once and
        patched at the dirty rows. A trickle pass (one charge + one gen
        bump between views) therefore pays a handful of row writes and
        skips the per-node Python rebuild of dev_fps/canon_maps that
        the full snapshot copy runs, keeping 4k–64k-node fleets flat."""
        arrays = self._arrays
        ii = sorted(self._dirty_rows) if self._dirty_rows else None

        def patched(live, prev_col, idx):
            if idx is None:
                return prev_col
            col = prev_col.copy()
            col[idx] = live[idx]
            return col

        out = ColumnarView()
        out.names = prev.names
        out.idx = prev.idx
        out.epoch = prev.epoch
        if self._gen_all:
            out.gen = arrays["gen"].copy()
        else:
            gi = ii
            if self._dirty_gen:
                gi = sorted(self._dirty_rows | self._dirty_gen)
            out.gen = patched(arrays["gen"], prev.gen, gi)
        for field in ("unschedulable", "n_notready", "mem_pressure",
                      "disk_pressure", "tainted", "vol_heavy",
                      "free_chips"):
            setattr(out, field, patched(arrays[field],
                                        getattr(prev, field), ii))
        out.min_pod_priority = patched(arrays["min_prio"],
                                       prev.min_pod_priority, ii)
        out.core_alloc = {res: patched(arr, prev.core_alloc[res], ii)
                          for res, arr in arrays["core_alloc"].items()}
        out.core_req = {res: patched(arr, prev.core_req[res], ii)
                        for res, arr in arrays["core_req"].items()}
        if ii is None:
            out.dev_fps = prev.dev_fps
        else:
            live_fps = arrays["dev_fps"]
            fps = list(prev.dev_fps)
            for i in ii:
                fps[i] = live_fps[i]
            out.dev_fps = fps
        if self._dirty_canon:
            maps = list(prev.canon_maps)
            for i in self._dirty_canon:
                maps[i] = self.rows[self._names[i]].canon
            out.canon_maps = maps
        else:
            out.canon_maps = prev.canon_maps
        return out


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
        # Struct-of-arrays fleet mirror for the vectorized scheduling
        # core (scheduler/vectorized.py).
        self.columns = _FleetColumns()

    # ---- generations / invalidation ----------------------------------------

    def _invalidate_locked(self, name: str, record: bool = True) -> None:
        # Always called with self._lock held: the bump must be atomic with
        # the state change it publishes. ``record=False`` keeps first-time
        # node registration out of fit_cache_invalidations_total — a
        # fresh node retires nothing.
        self._gen[name] = self._gen.get(name, 0) + 1
        self._snap.pop(name, None)
        self.columns.set_gen(name, self._gen[name])
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
        self.columns.bump_all_gens(self._gen)
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
            self.columns.set_node(cached)
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
                self.columns.drop(name)
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
            cached.pod_priorities[name] = \
                int((kube_pod.get("spec") or {}).get("priority") or 0)
            cached.pod_chips[name] = _charged_chip_count(pod_info)
            self._charged.add(name)
        else:
            cached.pod_ports.pop(name, None)
            cached.pod_labels.pop(name, None)
            cached.pod_volumes.pop(name, None)
            if cached.pod_affinity.pop(name, None) is not None:
                self._affinity_pods -= 1
                self._required_anti_pods -= required_anti
            cached.pod_namespaces.pop(name, None)
            cached.pod_priorities.pop(name, None)
            cached.pod_chips.pop(name, None)
            self._charged.discard(name)
        self.columns.charge(cached)
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
        probe("cache.assume_pod")
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

    def cycle_snapshot(self, with_columns: bool = False) -> tuple:
        """``(names, snapshots, generations[, columns])`` for one
        scheduling pass under ONE lock acquisition — the per-pod-per-node
        ``snapshot_node`` storm was the hot loop's biggest fixed cost at
        256 nodes. ``with_columns`` additionally returns a
        ``ColumnarView`` captured atomically with the snapshots and
        generations, so the vectorized pass and
        the object snapshots can never describe different states.

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
            if with_columns:
                return names, snaps, gens, self.columns.view(self.nodes)
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
        probe("cache.confirm_pod")
        with self._lock:
            self._assumed.pop(pod_name, None)

    def forget_pod(self, kube_pod: dict) -> None:
        """Bind failed: release the assumed resources
        (`scheduler.go:394-431`)."""
        probe("cache.forget_pod")
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
        probe("cache.add_pod")
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
        probe("cache.remove_pod")
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
        probe("cache.expire_assumed")
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
