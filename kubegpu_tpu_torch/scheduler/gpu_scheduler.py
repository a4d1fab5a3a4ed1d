"""The GPU device-scheduler plugin.

The counterpart of ``kubegpu_tpu/scheduler/tpu_scheduler.py``'s
`TPUScheduler` (without its ICI-only contiguous mode) and of the
reference's `NvidiaGPUScheduler` (`plugins/gpuschedulerplugin/`), with two
request-translation modes chosen by pod-level knobs:

1. **Count** (default): ``alpha.gpu/numgpu`` becomes per-card group
   requests (with per-card memory floors from ``alpha.gpu/memory-per-gpu``),
   promoted gpu -> gpugrp0 -> gpugrp1 to the node's advertised depth
   (`gpu.go:16-66`). A demand the node cannot absorb fails with its
   reason, since ``numgpu`` itself is prechecked and would otherwise fit
   every node.
2. **Auto-topology** (``alpha.gpu/gpu-generate-topology: 1``): requests are
   rewritten to the best-connected inventory shape in the cluster that
   some node can take now, through the shape-tree cache (`gpu.go:102-261`).

The plugin is group-capable. The JAX registry runs the shared group
allocator in the LAST group-capable plugin only
(``kubegpu_tpu/scheduler/registry.py``), and the compiled-in TPU plugin is
registered before any plugin a directory loads. So this plugin translates
first and then runs the port's ``grpalloc`` over every group resource of
the pod, the TPU plugin's translated requests included. Node and pod
objects are read by attribute alone: the JAX control plane hands its own
``NodeInfo``/``PodInfo`` here.
"""

from __future__ import annotations

import re
import threading

from kubegpu_tpu_torch import native
from kubegpu_tpu_torch.allocator import grpalloc
from kubegpu_tpu_torch.allocator.translate import (InsufficientResourceError,
                                                   translate_resource)
from kubegpu_tpu_torch.core import grammar
from kubegpu_tpu_torch.core.types import DEVICE_GROUP_PREFIX
from kubegpu_tpu_torch.topology.tree import (compare_trees, compute_tree_score,
                                             tree_from_resources)
from kubegpu_tpu_torch.utils import sorted_keys

_GPU_REQ_RE = re.compile(
    re.escape(DEVICE_GROUP_PREFIX)
    + rf".*/{grammar.GPU_LEAF}/(.*?)/{grammar.CARDS_SUFFIX}")
_GPU_PATH_RE = re.compile(rf".*/{grammar.GPU_LEAF}/.*")
_CARD_LEAF_RE = re.compile(
    rf".*/{grammar.GPU_LEAF}/.*/{grammar.CARDS_SUFFIX}$")


def translate_gpu_count(num_gpu: int, memory_per_gpu: int,
                        node_resources: dict, requests: dict) -> dict:
    """Expand a flat card count into per-card group requests, then promote
    them to the node's hierarchy depth (`gpu.go:16-66`). A node that
    advertises no cards leaves the requests as they are."""
    if not any(_GPU_REQ_RE.match(res) for res in node_resources):
        return requests

    have = 0
    max_index = -1
    for res in requests:
        m = _GPU_REQ_RE.match(res)
        if m:
            have += 1
            try:
                max_index = max(max_index, int(m.group(1)))
            except ValueError:
                pass
    requests = dict(requests)
    leaf = f"{DEVICE_GROUP_PREFIX}/{grammar.GPU_LEAF}"
    for i in range(num_gpu - have):
        idx = max_index + i + 1
        requests[f"{leaf}/{idx}/{grammar.CARDS_SUFFIX}"] = 1
        if memory_per_gpu > 0:
            requests[f"{leaf}/{idx}/{grammar.MEMORY_SUFFIX}"] = memory_per_gpu

    for this_stage, next_stage in ((grammar.GPU_GRP0, grammar.GPU_LEAF),
                                   (grammar.GPU_GRP1, grammar.GPU_GRP0)):
        _, requests = translate_resource(node_resources, requests,
                                         this_stage, next_stage)
    return requests


class ShapeCache:
    """Cluster-wide canonical inventory-shape cache (`gpu.go:102-183`).

    Nodes with structurally identical topologies share one tree entry.
    ``best_tree`` is usage-aware, as the JAX plugin's is: it keeps a live
    reference to each node's inventory and only returns a shape some
    member node can take right now.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._entries: list = []       # [tree, node_names:set, score]
        self._node_entry: dict = {}    # node_name -> entry
        self._node_infos: dict = {}    # node_name -> live NodeInfo

    def add_node(self, node_name: str, node_info) -> None:
        resources = node_info.allocatable
        if not any(_CARD_LEAF_RE.match(r) for r in resources):
            self.remove_node(node_name)
            return
        tree = tree_from_resources(resources)
        with self._lock:
            self._node_infos[node_name] = node_info
            current = self._node_entry.get(node_name)
            if current is not None and compare_trees(tree, current[0]):
                return
            self._remove_shape_locked(node_name)
            for entry in self._entries:
                if compare_trees(tree, entry[0]):
                    entry[1].add(node_name)
                    self._node_entry[node_name] = entry
                    return
            entry = [tree, {node_name}, compute_tree_score(tree)]
            self._entries.append(entry)
            self._node_entry[node_name] = entry

    def _remove_shape_locked(self, node_name: str) -> None:
        entry = self._node_entry.pop(node_name, None)
        if entry is not None:
            entry[1].discard(node_name)
            if not entry[1]:
                self._entries.remove(entry)

    def remove_node(self, node_name: str) -> None:
        with self._lock:
            self._node_infos.pop(node_name, None)
            self._remove_shape_locked(node_name)

    @staticmethod
    def _free_cards(node_info) -> int:
        return sum(max(0, alloc - node_info.used.get(res, 0))
                   for res, alloc in node_info.allocatable.items()
                   if _CARD_LEAF_RE.match(res))

    def best_tree(self, num_gpu: int):
        """Highest-scoring cached shape with at least ``num_gpu`` cards
        and a member node with that many free."""
        with self._lock:
            best = None
            best_score = 0.0
            for tree, node_names, score in self._entries:
                if tree.val < num_gpu or score <= best_score:
                    continue
                for name in node_names:
                    info = self._node_infos.get(name)
                    if info is not None and self._free_cards(info) >= num_gpu:
                        best, best_score = tree, score
                        break
            return best


def _assign_cards(tree, prefix: str, level: int, num_left: list) -> dict:
    """Walk a shape tree emitting card requests shaped like it
    (`gpu.go:185-209`)."""
    out: dict = {}
    if level == 0:
        take = min(tree.val, num_left[0])
        for i in range(take):
            out[f"{prefix}/{grammar.GPU_LEAF}/{i}/{grammar.CARDS_SUFFIX}"] = 1
        num_left[0] -= take
    else:
        for i, child in enumerate(tree.children):
            new_prefix = f"{prefix}{level - 1}/{i}"
            if level - 1 != 0:
                new_prefix += f"/{grammar.GPU_GRP_STEM}"
            out.update(_assign_cards(child, new_prefix, level - 1, num_left))
    return out


def _rewrite_to_tree(tree, cont) -> None:
    """Replace a container's card requests with best-tree-shaped ones
    (`gpu.go:211-228`)."""
    cont.dev_requests = {
        k: v for k, v in cont.dev_requests.items() if not _GPU_PATH_RE.match(k)
    }
    num = [int(cont.requests.get(grammar.RESOURCE_NUM_GPU, 0))]
    prefix = f"{DEVICE_GROUP_PREFIX}/{grammar.GPU_GRP_STEM}"
    cont.dev_requests.update(_assign_cards(tree, prefix, 2, num))


class GPUScheduler:
    """DeviceScheduler implementation for NVIDIA cards
    (`gpu_scheduler.go:18-108`)."""

    def __init__(self):
        self.shape_cache = ShapeCache()
        # the allocator core is built and loaded here, before the first
        # search, so the search path takes no lock
        native.load_grpalloc()

    def uses_group_scheduler(self) -> bool:
        return True

    # ---- node lifecycle ----------------------------------------------------

    def add_node(self, node_name: str, node_info) -> None:
        self.shape_cache.add_node(node_name, node_info)

    def remove_node(self, node_name: str) -> None:
        self.shape_cache.remove_node(node_name)

    # ---- request translation ----------------------------------------------

    def _translate(self, node_info, pod_info) -> tuple[bool, list]:
        mode = int(pod_info.requests.get(grammar.GPU_TOPOLOGY_GENERATION, 0))
        if mode == 0:
            # a container asking for more cards than the node advertises
            # (none, on a node without cards) fails here, naming numgpu
            cards = sum(1 for r in node_info.allocatable
                        if _CARD_LEAF_RE.match(r))
            reasons: list = []
            for name, cont, _ in pod_info.all_containers():
                num = int(cont.requests.get(grammar.RESOURCE_NUM_GPU, 0))
                mem = int(cont.requests.get(grammar.RESOURCE_MEMORY_PER_GPU, 0))
                cont.dev_requests = translate_gpu_count(
                    num, mem, node_info.allocatable, cont.dev_requests)
                have = sum(1 for r in cont.dev_requests if _GPU_REQ_RE.match(r))
                if num > min(have, cards):
                    reasons.append(InsufficientResourceError(
                        f"{name}/{grammar.RESOURCE_NUM_GPU}", num, 0,
                        min(have, cards)))
            return not reasons, reasons
        if mode == 1:
            return self._translate_auto_topology(pod_info)
        return False, [InsufficientResourceError(
            grammar.GPU_TOPOLOGY_GENERATION, mode, 0, 1)]

    def _translate_auto_topology(self, pod_info) -> tuple[bool, list]:
        """Rewrite pending containers' requests to the cluster's best shape
        (`gpu.go:231-261`). Placed containers keep their pinned requests,
        and only pending ones count toward the demand: a placed
        container's cards are already charged as used."""
        num = 0
        pending = []
        for n in sorted_keys(pod_info.running_containers):
            cont = pod_info.running_containers[n]
            if cont.allocate_from:
                continue
            pending.append(cont)
            num += int(cont.requests.get(grammar.RESOURCE_NUM_GPU, 0))
        for n in sorted_keys(pod_info.init_containers):
            cont = pod_info.init_containers[n]
            if cont.allocate_from:
                continue
            pending.append(cont)
            num = max(num, int(cont.requests.get(grammar.RESOURCE_NUM_GPU, 0)))
        if not pending:
            return True, []
        tree = self.shape_cache.best_tree(num)
        if tree is None:
            return False, [InsufficientResourceError(
                grammar.RESOURCE_NUM_GPU, num, 0, 0)]
        for cont in pending:
            _rewrite_to_tree(tree, cont)
        return True, []

    # ---- DeviceScheduler surface (`gpu_scheduler.go:54-99`) ---------------

    def pod_fits_device(self, node_info, pod_info, fill_allocate_from: bool,
                        run_grp_scheduler: bool):
        ok, reasons = self._translate(node_info, pod_info)
        if not ok:
            return False, reasons, 0.0
        if run_grp_scheduler:
            return grpalloc.pod_fits_group_constraints(
                node_info, pod_info, fill_allocate_from)
        return True, [], 0.0

    def pod_allocate(self, node_info, pod_info, run_grp_scheduler: bool) -> None:
        ok, reasons = self._translate(node_info, pod_info)
        if not ok:
            raise RuntimeError(f"GPU translation failed: {[str(r) for r in reasons]}")
        if run_grp_scheduler:
            fits, reasons, _ = grpalloc.pod_fits_group_constraints(
                node_info, pod_info, True)
            if not fits:
                raise RuntimeError(
                    f"pod {pod_info.name} no longer fits: {[str(r) for r in reasons]}")

    def take_pod_resources(self, node_info, pod_info, run_grp_scheduler: bool) -> None:
        if run_grp_scheduler:
            grpalloc.take_pod_group_resource(node_info, pod_info)

    def return_pod_resources(self, node_info, pod_info,
                             run_grp_scheduler: bool) -> None:
        if run_grp_scheduler:
            grpalloc.return_pod_group_resource(node_info, pod_info)
