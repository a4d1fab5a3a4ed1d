"""Hierarchical group allocation: the scheduling heart.

The port's copy of ``kubegpu_tpu/allocator/grpalloc.py``: every search
goes to the native core (``native/grpalloc.cpp``, through the port's own
``native.py``), and the Python search below stays as its plain version,
which the tests hold it against. It re-implements the reference's
backtracking group allocator
(`device-scheduler/grpalloc/grpallocate.go`) with identical observable
semantics:

- Requests and inventories are flat ``{path: amount}`` maps; hierarchy is
  discovered structurally by splitting paths as ``base/<name>/<index>/<rest>``
  (`grpallocate.go:16-32`). A request subtree matches an inventory subtree
  by *name-pattern*, so any topology the advertiser encodes (gpugrp1 /
  gpugrp0 / gpu) is allocated without device-specific code.
- For each required group the allocator tries every allocatable location in
  sorted order, recursively allocates subgroups, scores the whole location
  (mean over every resource under it), and keeps the max score — ties go to
  the lexicographically last location, and with ``prefer_used`` a location
  already used by this pod wins over a better-scoring fresh one
  (`grpallocate.go:314-385`).
- Init containers are allocated after running containers with
  ``prefer_used`` semantics and max-not-sum accounting, since they run
  before the main containers and their usage overlaps
  (`grpallocate.go:550-565`, `scorer.go:24-34`).
- A container whose ``allocate_from`` is already set is only re-scored
  (never re-placed) — the idempotent re-check path that makes scheduling
  restart-safe (`grpallocate.go:471-480`).
- Determinism: every decision iterates in sorted-key order.

Accounting (`grpallocate.go:592-641`): pod usage is recomputed from
``allocate_from`` — the pod annotation is the source of truth — and added
to / removed from ``NodeInfo.used``.
"""

from __future__ import annotations

import functools
import re

from kubegpu_tpu_torch import metrics, native
from kubegpu_tpu_torch.allocator import scorers
from kubegpu_tpu_torch.allocator.translate import InsufficientResourceError
from kubegpu_tpu_torch.core import grammar
from kubegpu_tpu_torch.core.types import DEVICE_GROUP_PREFIX, ContainerInfo, NodeInfo, PodInfo
from kubegpu_tpu_torch.utils import assign_nested, sorted_keys


@functools.lru_cache(maxsize=4096)
def _subgroup_split_re(base: str):
    """``base/<name>/<index>/<rest>`` splitter (`grpallocate.go:16-32`)."""
    return re.compile(re.escape(base) + r"/(\S*?)/(\S*?)/(\S*)")


def _find_subgroups(base: str, grp: dict) -> tuple[dict, dict]:
    """Partition a level's resources into subgroups by path structure.

    ``grp`` maps local key -> global path. Returns
    ``(subgroups[name][index][rest] = global_path, is_subgroup[local_key])``.
    """
    pat = _subgroup_split_re(base)
    subgroups: dict = {}
    is_subgroup: dict = {}
    for local_key, global_path in grp.items():
        m = pat.match(global_path)
        if m:
            assign_nested(subgroups, m.groups(), global_path)
            is_subgroup[local_key] = True
        else:
            is_subgroup[local_key] = False
    return subgroups, is_subgroup


class _AllocContext:
    """Read-only-ish data shared by one container's whole allocation search.

    ``used_groups`` is the exception: it is shared *mutable* state across
    all containers of a pod so later containers prefer groups earlier ones
    chose (`grpallocate.go:56,377-381`).
    """

    __slots__ = ("cont_name", "init_container", "prefer_used", "required",
                 "req_scorer", "alloc", "alloc_scorer", "used_groups")

    def __init__(self, cont_name, init_container, prefer_used, required,
                 req_scorer, alloc, alloc_scorer, used_groups):
        self.cont_name = cont_name
        self.init_container = init_container
        self.prefer_used = prefer_used
        self.required = required          # global req path -> amount
        self.req_scorer = req_scorer      # global req path -> ScoreFunc | None
        self.alloc = alloc                # global alloc path -> amount
        self.alloc_scorer = alloc_scorer  # global alloc path -> ScoreFunc
        self.used_groups = used_groups    # full location name -> True


class _GrpAllocator:
    """One level of the recursive allocation search (`grpallocate.go:43-74`).

    Mutable search state (``allocate_from``, ``pod_resource``,
    ``node_resource``, ``score``) is cloned per candidate location and
    adopted from the winning candidate, exactly like the reference's
    cloneGroup/takeGroup/resetGroup discipline (`grpallocate.go:99-136`).
    """

    def __init__(self, ctx, grp_required, grp_alloc, req_base, alloc_base_prefix,
                 allocate_from, pod_resource, node_resource, score=0.0):
        self.ctx = ctx
        self.grp_required = grp_required            # local key -> global req path
        self.grp_alloc = grp_alloc                  # location -> (local key -> global path)
        self.req_base = req_base
        self.alloc_base_prefix = alloc_base_prefix
        self.allocate_from = allocate_from          # global req path -> global alloc path
        self.pod_resource = pod_resource            # global alloc path -> used by pod
        self.node_resource = node_resource          # global alloc path -> used on node
        self.score = score
        self.is_req_subgrp: dict = {}

    # -- state discipline ---------------------------------------------------

    def _clone(self) -> "_GrpAllocator":
        """Fresh copies of the mutable maps (`grpallocate.go:99-123`)."""
        c = _GrpAllocator(
            self.ctx, self.grp_required, self.grp_alloc, self.req_base,
            self.alloc_base_prefix, dict(self.allocate_from),
            dict(self.pod_resource), dict(self.node_resource), self.score,
        )
        c.is_req_subgrp = self.is_req_subgrp
        return c

    def _take(self, other: "_GrpAllocator") -> None:
        """Adopt another allocator's state (`grpallocate.go:125-130`).
        Search-private: each fit worker builds, mutates, and discards
        its own allocator inside one ``pod_fits_resources`` call —
        instances never cross threads."""
        self.allocate_from = other.allocate_from    # racer: single-writer
        self.pod_resource = other.pod_resource      # racer: single-writer
        self.node_resource = other.node_resource    # racer: single-writer
        self.score = other.score                    # racer: single-writer

    def _reset_resources(self, saved: "_GrpAllocator") -> None:
        """Restore usage/score but keep allocate_from (`grpallocate.go:132-136`)."""
        self.pod_resource = saved.pod_resource
        self.node_resource = saved.node_resource
        self.score = saved.score

    # -- search -------------------------------------------------------------

    def _resource_available(self, location: str) -> tuple[bool, list]:
        """Check/charge this level's direct (leaf) requirements at a location.

        Reference: `grpallocate.go:141-189`. Matching is by local key: the
        requirement's remaining path must literally exist under the
        candidate location.
        """
        loc_alloc = self.grp_alloc.get(location, {})
        found = True
        fails: list = []
        for req_key in sorted_keys(self.grp_required):
            if self.is_req_subgrp.get(req_key):
                continue
            req_global = self.grp_required[req_key]
            required = self.ctx.required.get(req_global, 0)
            global_name = loc_alloc.get(req_key)
            if global_name is None:
                found = False
                fails.append(InsufficientResourceError(
                    f"{self.ctx.cont_name}/{req_global}", required, 0, 0))
                continue
            fn = self.ctx.req_scorer.get(req_global) or self.ctx.alloc_scorer[global_name]
            allocatable = self.ctx.alloc[global_name]
            used_node = self.node_resource.get(global_name, 0)
            r = fn(allocatable, self.pod_resource.get(global_name, 0), used_node,
                   [required], self.ctx.init_container)
            if not r.found:
                found = False
                fails.append(InsufficientResourceError(
                    f"{self.ctx.cont_name}/{req_global}", required, used_node, allocatable))
                continue
            self.pod_resource[global_name] = r.new_used_by_pod
            self.node_resource[global_name] = r.new_used_by_node
            self.allocate_from[req_global] = global_name
        return found, fails

    def _allocate_subgroups(self, location, subgrps_req, subgrps_alloc):
        """Recursively allocate every required subgroup (`grpallocate.go:193-220`)."""
        found = True
        fails: list = []
        for name in sorted_keys(subgrps_req):
            by_index = subgrps_req[name]
            for index in sorted_keys(by_index):
                sub = _GrpAllocator(
                    ctx=self.ctx,
                    grp_required=by_index[index],
                    grp_alloc=subgrps_alloc.get(name, {}),
                    req_base=f"{self.req_base}/{name}/{index}",
                    alloc_base_prefix=f"{self.alloc_base_prefix}/{location}/{name}",
                    allocate_from=self.allocate_from,
                    pod_resource=self.pod_resource,
                    node_resource=self.node_resource,
                    score=0.0,
                )
                ok, reasons = sub.allocate_group()
                if not ok:
                    found = False
                    fails.append(InsufficientResourceError(
                        f"{self.ctx.cont_name}/{sub.req_base}"))
                    fails.extend(reasons)
                    continue
                self._take(sub)
        return found, fails

    def _find_score_and_update(self, location: str) -> tuple[bool, list]:
        """Re-score a whole location subtree from ``allocate_from``.

        Reference: `grpallocate.go:222-263`. Aggregates every requirement
        routed to each physical resource, then scores *all* resources under
        the location (unrequested ones contribute their packing score), and
        charges pod/node usage in one pass. Also the idempotent re-check
        path when ``allocate_from`` was already set.
        """
        found = True
        fails: list = []
        requested: dict = {}
        for req_global in self.grp_required.values():
            alloc_from = self.allocate_from.get(req_global, "")
            if alloc_from not in self.ctx.alloc:
                found = False
                fails.append(InsufficientResourceError(
                    req_global, self.ctx.required.get(req_global, 0), 0, 0))
                continue
            requested.setdefault(alloc_from, []).append(self.ctx.required.get(req_global, 0))

        self.score = 0.0
        loc_resources = self.grp_alloc.get(location, {})
        for key in sorted_keys(loc_resources):
            global_name = loc_resources[key]
            allocatable = self.ctx.alloc[global_name]
            fn = self.ctx.alloc_scorer[global_name]
            used_node = self.node_resource.get(global_name, 0)
            r = fn(allocatable, self.pod_resource.get(global_name, 0), used_node,
                   requested.get(global_name, []), self.ctx.init_container)
            if not r.found:
                found = False
                fails.append(InsufficientResourceError(
                    global_name, r.used_by_container, used_node, allocatable))
                continue
            self.score += r.score
            self.pod_resource[global_name] = r.new_used_by_pod
            self.node_resource[global_name] = r.new_used_by_node
        if loc_resources:
            self.score /= len(loc_resources)
        return found, fails

    def _allocate_group_at(self, location: str, subgrps_req: dict) -> tuple[bool, list]:
        """Try to satisfy this group entirely inside one location.

        Reference: `grpallocate.go:265-294`: charge leaves, recurse into
        subgroups, then roll usage back and re-charge via the single
        scoring pass so within-group accounting isn't double-counted.
        """
        location_name = f"{self.alloc_base_prefix}/{location}"
        loc_resources = self.grp_alloc.get(location, {})
        subgrps_alloc, _ = _find_subgroups(location_name, loc_resources)

        saved = self._clone()
        found_res, fails = self._resource_available(location)
        found_next, fails_next = self._allocate_subgroups(location, subgrps_req, subgrps_alloc)
        if found_res and found_next:
            self._reset_resources(saved)
            found_score, fails_score = self._find_score_and_update(location)
            if not found_score:
                found_next = False
                fails_next.extend(fails_score)
        return (found_res and found_next), fails + fails_next

    def allocate_group(self) -> tuple[bool, list]:
        """Pick the best location for this group (`grpallocate.go:314-385`).

        Branch-and-keep-best over sorted candidate locations; ties go to the
        last candidate (``>=``); with ``prefer_used``, used locations beat
        unused regardless of score.
        """
        if not self.grp_required:
            return True, []

        # racer: single-writer -- search-private allocator state (see _take)
        subgrps_req, self.is_req_subgrp = _find_subgroups(self.req_base, self.grp_required)

        best: _GrpAllocator | None = None
        best_score = self.score
        best_is_used = False
        best_name = ""
        any_find = False
        fails: list = []

        locations = sorted_keys(self.grp_alloc)
        for location in locations:
            cand = self._clone()
            found, reasons = cand._allocate_group_at(location, subgrps_req)
            location_name = f"{self.alloc_base_prefix}/{location}"
            if found:
                cand_is_used = bool(self.ctx.used_groups.get(location_name))
                if not self.ctx.prefer_used:
                    take_new = cand.score >= best_score
                elif best_is_used:
                    take_new = cand_is_used and cand.score >= best_score
                else:
                    take_new = cand_is_used or cand.score >= best_score
                if take_new:
                    any_find = True
                    best = cand
                    best_score = cand.score
                    best_is_used = cand_is_used
                    best_name = location_name
            elif len(self.grp_alloc) == 1:
                fails.extend(reasons)

        if best is not None:
            self._take(best)
        if any_find:
            self.ctx.used_groups[best_name] = True
            return True, []
        return False, fails


def _container_fits_group_constraints(
    cont_name: str,
    cont: ContainerInfo,
    init_container: bool,
    node: NodeInfo,
    alloc_scorer: dict,
    pod_resource: dict,
    node_resource: dict,
    used_groups: dict,
    prefer_used: bool,
    set_allocate_from: bool,
) -> tuple[_GrpAllocator, bool, list, float]:
    """Allocate (or re-score) one container (`grpallocate.go:388-488`)."""
    required: dict = {}
    req_scorer: dict = {}
    for res, val in cont.dev_requests.items():
        if grammar.prechecked_resource(res):
            continue
        required[res] = val
        if res in cont.scorer:
            req_scorer[res] = scorers.scorer_for(res, cont.scorer[res])
        else:
            req_scorer[res] = None

    grp_prefix, grp_name = DEVICE_GROUP_PREFIX.rsplit("/", 1)
    alloc: dict = {}
    top_location: dict = {}
    for res, val in node.allocatable.items():
        if grammar.prechecked_resource(res):
            continue
        alloc[res] = val
        top_location[res] = res

    grp = _GrpAllocator(
        ctx=_AllocContext(cont_name, init_container, prefer_used, required,
                          req_scorer, alloc, alloc_scorer, used_groups),
        grp_required={r: r for r in required},
        grp_alloc={grp_name: top_location},
        req_base=DEVICE_GROUP_PREFIX,
        alloc_base_prefix=grp_prefix,
        allocate_from={},
        pod_resource=pod_resource,
        node_resource=node_resource,
    )

    if not cont.allocate_from and required:
        found, reasons = grp.allocate_group()
        score = grp.score
        if set_allocate_from:
            cont.allocate_from = dict(grp.allocate_from)
    else:
        # allocate_from already decided (by a previous pass or a scheduler
        # restart), or the container has no group requests: re-validate and
        # re-score only, never re-place (`grpallocate.go:461,471-480` — in
        # every reference flow AllocateFrom is non-nil, so its condition
        # reduces to "allocate iff requests exist and no placement yet").
        grp.allocate_from = dict(cont.allocate_from)
        found, reasons = grp._find_score_and_update(grp_name)
        score = grp.score

    return grp, found, reasons, score


def pod_fits_group_constraints(
    node: NodeInfo, pod: PodInfo, allocating: bool
) -> tuple[bool, list, float]:
    """Does the pod fit this node's group resources — and where?

    Reference: `grpallocate.go:521-570`. Running containers first (they
    coexist, usage sums), then init containers (sequential, max semantics,
    preferring groups the running containers already picked). When
    ``allocating`` is set, each container's ``allocate_from`` is filled in —
    the scheduler's binding decision.

    Returns ``(fits, failure_reasons, score)``; the score is the last
    running container's whole-node packing score, which already reflects
    every earlier allocation.

    ``node`` and ``pod`` are read and written by attribute alone, so the
    JAX control plane's own ``NodeInfo``/``PodInfo`` work here as the
    port's do.

    The search runs in the native core. Only the two inputs its line
    protocol cannot carry take the Python path, each counted in
    ``allocator_native_fallbacks_total``: a token with whitespace and a
    scorer that is neither leftover nor enum. A failed build, a native
    error or a reply out of step with the request raises: unlike the JAX
    package, the port never falls back on a fault.
    """
    result = _native_pod_fits(node, pod, allocating)
    if result is None:
        metrics.NATIVE_FALLBACKS.inc()
        return _pod_fits_group_constraints_py(node, pod, allocating)
    return result


def _pod_fits_group_constraints_py(
    node: NodeInfo, pod: PodInfo, allocating: bool
) -> tuple[bool, list, float]:
    pod_resource: dict = {}
    node_resource = dict(node.used)
    used_groups: dict = {}
    total_score = 0.0
    fails: list = []
    found = True

    alloc_scorer = {
        res: scorers.scorer_for(res, node.scorer.get(res, scorers.DEFAULT_SCORER))
        for res in node.allocatable
    }

    for phase_conts, is_init in ((pod.running_containers, False), (pod.init_containers, True)):
        for cont_name in sorted_keys(phase_conts):
            cont = phase_conts[cont_name]
            grp, fits, reasons, score = _container_fits_group_constraints(
                cont_name, cont, is_init, node, alloc_scorer,
                pod_resource, node_resource, used_groups, True, allocating,
            )
            if not fits:
                found = False
                fails.extend(reasons)
            elif not is_init:
                total_score = score
            pod_resource = grp.pod_resource
            node_resource = grp.node_resource

    return found, fails, total_score


# ---- native dispatch (`native/grpalloc.cpp`) --------------------------------

# The line protocol is whitespace-delimited: a token with whitespace (pod
# annotations are user-writable) would inject lines, so such inputs take
# the Python path.
_WS_RE = re.compile(r"\s")


def _resolved_scorer_kind(res: str, scorer_type: int) -> int:
    """Map a (resource, scorer enum) pair onto the native core's resolved
    kinds: 0 leftover, 1 enum, -1 none/unresolvable."""
    fn = scorers.scorer_for(res, scorer_type)
    if fn is scorers.leftover_score:
        return 0
    if fn is scorers.enum_score:
        return 1
    return -1


def _native_request(node: NodeInfo, pod: PodInfo):
    """The core's request lines and the containers it searches, in the
    order of its reply; None when an input cannot be carried."""
    unsafe = _WS_RE.search
    lines = []
    for res in sorted_keys(node.allocatable):
        if grammar.prechecked_resource(res):
            continue
        kind = _resolved_scorer_kind(
            res, node.scorer.get(res, scorers.DEFAULT_SCORER))
        if unsafe(res) or kind < 0:
            return None
        lines.append(f"A {res} {node.allocatable[res]} {kind}")
    for res in sorted_keys(node.used):
        if grammar.prechecked_resource(res):
            continue
        if unsafe(res):
            return None
        lines.append(f"U {res} {node.used[res]}")

    searched = []
    for phase_conts, is_init in ((pod.running_containers, False),
                                 (pod.init_containers, True)):
        for cont_name in sorted_keys(phase_conts):
            cont = phase_conts[cont_name]
            if unsafe(cont_name):
                return None
            required = {res: val for res, val in cont.dev_requests.items()
                        if not grammar.prechecked_resource(res)}
            rescore = bool(cont.allocate_from) or not required
            lines.append(f"C {cont_name} {int(is_init)} {int(rescore)}")
            if not rescore:
                searched.append(cont)
            for res in sorted_keys(required):
                override = -1
                if res in cont.scorer:
                    override = _resolved_scorer_kind(res, cont.scorer[res])
                if unsafe(res):
                    return None
                lines.append(f"R {res} {required[res]} {override}")
            if rescore:
                for req in sorted_keys(cont.allocate_from):
                    alloc = cont.allocate_from[req]
                    if unsafe(req) or unsafe(alloc):
                        return None
                    lines.append(f"F {req} {alloc}")
    lines.append("E")
    return "\n".join(lines) + "\n", searched


def _native_pod_fits(node: NodeInfo, pod: PodInfo, allocating: bool):
    """``(fits, reasons, score)`` from the native core, or None for an
    input that its protocol cannot carry."""
    request = _native_request(node, pod)
    if request is None:
        return None
    payload, searched = request
    reply = native.grp_allocate(payload)

    fits, score = True, 0.0
    reasons: list = []
    # one C block per searched container, in request order: matched by
    # position, not by name (a running and an init container may share
    # a name)
    placements: list = []
    for line in reply.splitlines():
        parts = line.split(" ")
        if parts[0] == "FITS":
            fits = parts[1] == "1"
        elif parts[0] == "SCORE":
            score = float(parts[1])
        elif parts[0] == "C":
            placements.append({})
        elif parts[0] == "F" and placements:
            placements[-1][parts[1]] = parts[2]
        elif parts[0] == "REASON":
            reasons.append(InsufficientResourceError(
                parts[1], int(parts[2]), int(parts[3]), int(parts[4])))
        else:
            raise RuntimeError(f"grp_allocate: unexpected reply line "
                               f"{line!r}")
    if len(placements) != len(searched):
        raise RuntimeError(
            f"grp_allocate: {len(placements)} placements for "
            f"{len(searched)} searched containers")
    if allocating:
        for cont, alloc_from in zip(searched, placements):
            cont.allocate_from = alloc_from
    return fits, reasons, score


def pod_clear_allocate_from(pod: PodInfo) -> None:
    """Drop all placement decisions so the next fit re-places from scratch.

    Reference: `grpallocate.go:499-508`.
    """
    for cont in pod.running_containers.values():
        cont.allocate_from = {}
    for cont in pod.init_containers.values():
        cont.allocate_from = {}


# ---- accounting (`grpallocate.go:573-641`) ---------------------------------


def _charge_container(node: NodeInfo, cont: ContainerInfo, init_container: bool,
                      pod_resources: dict, used_by_node: dict) -> None:
    for req_res, alloc_from in cont.allocate_from.items():
        if grammar.prechecked_resource(req_res):
            continue
        val = cont.dev_requests.get(req_res, 0)
        fn = scorers.scorer_for(alloc_from, node.scorer.get(alloc_from, scorers.DEFAULT_SCORER))
        if fn is None:
            continue
        r = fn(node.allocatable.get(alloc_from, 0), pod_resources.get(alloc_from, 0),
               used_by_node.get(alloc_from, 0), [val], init_container)
        pod_resources[alloc_from] = r.new_used_by_pod
        used_by_node[alloc_from] = r.new_used_by_node


def compute_pod_group_resources(
    node: NodeInfo, pod: PodInfo, remove_pod: bool
) -> tuple[dict, dict]:
    """Recompute a pod's device usage from its ``allocate_from`` decisions.

    Reference: `grpallocate.go:592-623`. Returns
    ``(pod_resources, updated_used_by_node)``. For removal, the pod's total
    is charged *negatively* against the node's current usage — the
    "negative request" trick (`grpallocate.go:611-618`) that keeps init
    max-semantics and enum attributes consistent on release.
    """
    used_by_node = dict(node.used)
    pod_resources: dict = {}
    for cont in pod.running_containers.values():
        _charge_container(node, cont, False, pod_resources, used_by_node)
    for cont in pod.init_containers.values():
        _charge_container(node, cont, True, pod_resources, used_by_node)

    if remove_pod:
        for alloc_from, pod_used in pod_resources.items():
            fn = scorers.scorer_for(
                alloc_from, node.scorer.get(alloc_from, scorers.DEFAULT_SCORER))
            if fn is None:
                continue
            r = fn(0, 0, node.used.get(alloc_from, 0), [-pod_used], False)
            used_by_node[alloc_from] = r.new_used_by_node

    return pod_resources, used_by_node


def take_pod_group_resource(node: NodeInfo, pod: PodInfo) -> None:
    """Charge a pod's usage to the node (pod assumed/bound).

    Reference: `grpallocate.go:626-632`.
    """
    _, used = compute_pod_group_resources(node, pod, remove_pod=False)
    node.used.update(used)


def return_pod_group_resource(node: NodeInfo, pod: PodInfo) -> None:
    """Release a pod's usage from the node (pod removed).

    Reference: `grpallocate.go:635-641`.
    """
    _, used = compute_pod_group_resources(node, pod, remove_pod=True)
    node.used.update(used)
