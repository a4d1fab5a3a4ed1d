"""Algorithm factory: named predicate/priority registries + policy config.

Reference: `kube-scheduler/pkg/factory/` plugin registration and
`algorithmprovider/defaults/defaults.go` — every predicate and priority is
registered under a public name, the default provider picks a set, and a
`Policy` config file (`kube-scheduler/pkg/api/types.go`) can re-compose
the algorithm from those names, parameterize the label-based plugins, add
extenders, and tune the hard-pod-affinity symmetric weight.

The engine consumes an ``AlgorithmConfig``:

- ``predicates``: ordered ``(name, fn)`` where ``fn(ctx) -> (ok, reasons)``
  over a ``PredicateContext`` (pod, node snapshot, optional cluster-wide
  inter-pod metadata). The device predicate (`devicepredicate.go:11-26`)
  is NOT in this list — the engine always runs it last, it is the point
  of the framework.
- ``priorities``: ``(name, weight, batch_fn)`` where
  ``batch_fn(kube_pod, pod_requests, facts_by_node, ctx) -> {node: score}``
  on the upstream 0..10 scale; cluster-wide functions (spreading,
  inter-pod affinity) normalize internally like the upstream reduce pass.
- ``device_weight``: weight of the device score from the fit pass.
"""

from __future__ import annotations

from kubegpu_tpu_torch.scheduler import interpod, predicates, priorities


class PredicateContext:
    __slots__ = ("kube_pod", "snap", "meta", "vol")

    def __init__(self, kube_pod, snap, meta=None, vol=None):
        self.kube_pod = kube_pod
        self.snap = snap
        self.meta = meta  # interpod.InterPodMetadata | None
        self.vol = vol    # VolumeBinder.snapshot() | None (no PVCs)


class PriorityContext:
    __slots__ = ("meta", "hard_pod_affinity_weight", "owner_selectors")

    def __init__(self, meta=None,
                 hard_pod_affinity_weight=interpod.DEFAULT_HARD_POD_AFFINITY_WEIGHT,
                 owner_selectors=None):
        self.meta = meta
        self.hard_pod_affinity_weight = hard_pod_affinity_weight
        # selectors of the Services/RCs/RSs/StatefulSets that select the
        # pod being scheduled (`selector_spreading.go` getSelectors);
        # None = the transport exposes no owner listers (label fallback)
        self.owner_selectors = owner_selectors


class AlgorithmConfig:
    def __init__(self, predicates_list, priorities_list,
                 device_weight: float = 2.0,
                 hard_pod_affinity_weight: int =
                 interpod.DEFAULT_HARD_POD_AFFINITY_WEIGHT):
        self.predicates = predicates_list
        self.priorities = priorities_list
        self.device_weight = device_weight
        self.hard_pod_affinity_weight = hard_pod_affinity_weight
        # Vector-safety marks (set by the factory functions): the masked
        # pass in scheduler/vectorized.py hard-codes the DEFAULT
        # predicate chain's semantics, so only an algorithm using
        # exactly that chain (unparameterized) may vectorize its filter;
        # priorities vectorize when every configured name has an array
        # kernel. A policy-composed algorithm defaults to scalar — the
        # sound choice for predicate sets the kernels don't model.
        self.vector_predicates = False
        self.vector_priorities = False


# ---- fit predicate registry -------------------------------------------------
# name -> builder(args: dict | None) -> fn(ctx) -> (ok, reasons)
#
# Every registered predicate DECLARES what state it reads (``fn.reads``)
# so the engine can prove its memoization sound (see predicates.py module
# docstring for the contract). The vocabulary:
#
#   "pod"             the incoming pod object (captured by its class)
#   "node"            the node object + device inventory/usage
#   "node_pods"       placed pods' ports/labels/volumes on that node
#   "cluster_pods"    every pod in the cluster (inter-pod affinity)
#   "pod_volumes"     the incoming pod's spec.volumes
#   "cluster_volumes" cluster-wide PV/PVC state
#
# "node"/"node_pods" reads are invalidated by that node's fit generation;
# "cluster_pods" by the required-anti-affinity flush discipline in
# SchedulerCache; volume reads route the pod through the engine's
# devolumed-sibling split. A predicate WITHOUT a declaration disables
# memoization for the whole algorithm — the sound default for an
# out-of-tree predicate the engine knows nothing about.

VOLUME_READS = frozenset({"pod_volumes", "cluster_volumes"})


def _declare(*reads):
    """Wrap a predicate builder so every built fn carries its read-set."""
    read_set = frozenset(reads)

    def wrap(builder):
        def build(args):
            fn = builder(args)
            setattr(fn, "reads", read_set)
            return fn
        return build
    return wrap


# vector-gate: pod_eligible routes nodeName-pinned pods to the scalar chain
def _p_host(args):
    return lambda ctx: predicates.pod_fits_host(ctx.kube_pod, ctx.snap.kube_node)


# vector-gate: pod_eligible routes nodeSelector/required-affinity pods to the scalar chain
def _p_selector(args):
    return lambda ctx: predicates.pod_matches_node_selector(
        ctx.kube_pod, ctx.snap.kube_node)


# vector-gate: pod_eligible routes hostPort-requesting pods to the scalar chain
def _p_ports(args):
    return lambda ctx: predicates.pod_fits_host_ports(
        ctx.kube_pod, ctx.snap.used_ports)


# vector-gate: the tainted column drops NoSchedule/NoExecute nodes out of the mask
def _p_taints(args):
    return lambda ctx: predicates.pod_tolerates_node_taints(
        ctx.kube_pod, ctx.snap.kube_node)


def _p_condition(args):
    return lambda ctx: predicates.check_node_condition(
        ctx.kube_pod, ctx.snap.kube_node)


def _node_has_condition(snap, condition: str) -> bool:
    for cond in (snap.kube_node.get("status") or {}).get("conditions") or []:
        if cond.get("type") == condition and cond.get("status") == "True":
            return True
    return False


def _is_best_effort(kube_pod: dict) -> bool:
    """BestEffort QoS: no container declares any request or limit."""
    spec = kube_pod.get("spec") or {}
    for c in (spec.get("containers") or []) + (spec.get("initContainers") or []):
        resources = c.get("resources") or {}
        if resources.get("requests") or resources.get("limits"):
            return False
    return True


def _p_memory_pressure(args):
    # Upstream CheckNodeMemoryPressurePredicate: only BestEffort-QoS pods
    # are kept off a memory-pressured node.
    def fn(ctx):
        if _is_best_effort(ctx.kube_pod) and \
                _node_has_condition(ctx.snap, "MemoryPressure"):
            return False, ["node(s) had MemoryPressure"]
        return True, []
    return fn


def _p_disk_pressure(args):
    # Upstream CheckNodeDiskPressurePredicate: disk pressure keeps off ALL pods.
    def fn(ctx):
        if _node_has_condition(ctx.snap, "DiskPressure"):
            return False, ["node(s) had DiskPressure"]
        return True, []
    return fn


def _p_resources(args):
    return lambda ctx: predicates.pod_fits_resources(
        ctx.kube_pod, ctx.snap.core_allocatable, ctx.snap.requested_core)


# vector-gate: the vol_heavy column drops nodes with placed pod volumes; pod_eligible routes volume-carrying pods scalar
def _p_disk_conflict(args):
    return lambda ctx: predicates.no_disk_conflict(
        ctx.kube_pod, ctx.snap.pod_volumes)


# vector-gate: vol_heavy column + pod_eligible volume gate (see _p_disk_conflict)
def _p_max_volumes(kind: str, default_cap: int):
    def build(args):
        cap = int((args or {}).get("maxVolumes") or default_cap)
        limits = {kind: cap}
        return lambda ctx: predicates.max_attachable_volume_count(
            ctx.kube_pod, ctx.snap.pod_volumes, limits)
    return build


# vector-gate: pod_eligible routes volume-carrying pods to the scalar chain
def _p_volume_zone(args):
    return lambda ctx: predicates.no_volume_zone_conflict(
        ctx.kube_pod, ctx.snap.kube_node)


# vector-gate: the devolumed-sibling split runs the masked pass volume-free; survivors pay the volume predicates scalar
def _p_volume_binding(args):
    """CheckVolumeBinding (`predicates.go:1443-1465`): bound PVCs' PVs must
    tolerate the node; unbound PVCs must have a matchable available PV.
    ``ctx.vol`` is the pass-level `VolumeBinder.snapshot()`; None means the
    pod references no PVCs (or the API has no volume surface) and the
    predicate is free."""
    def fn(ctx):
        if ctx.vol is None:
            return True, []
        pvcs, pvs, reserved = ctx.vol
        ok, reasons, _ = predicates.check_volume_binding(
            ctx.kube_pod, ctx.snap.kube_node, pvcs, pvs, reserved)
        return ok, reasons
    return fn


def _p_general(args):
    return lambda ctx: predicates.general_predicates(
        ctx.kube_pod, ctx.snap.kube_node, ctx.snap.used_ports,
        ctx.snap.core_allocatable, ctx.snap.requested_core)


# vector-gate: find_nodes_that_fit nulls the columns whenever inter-pod metadata exists (meta is not None => scalar pass)
def _p_interpod(args):
    def fn(ctx):
        if ctx.meta is None:
            # gate: no placed pod carries affinity and the incoming pod
            # declares none — nothing to evaluate
            return True, []
        return interpod.match_interpod_affinity(
            ctx.kube_pod, ctx.snap.name, ctx.meta)
    return fn


def _p_label_presence(args):
    """CheckNodeLabelPresence (policy-only, `predicates.go`): require the
    listed labels to be present/absent on the node."""
    spec = (args or {}).get("labelsPresence") or {}
    labels = spec.get("labels") or []
    presence = bool(spec.get("presence", True))

    def fn(ctx):
        node_labels = (ctx.snap.kube_node.get("metadata") or {}) \
            .get("labels") or {}
        for label in labels:
            if (label in node_labels) != presence:
                return False, [f"node(s) didn't satisfy label presence "
                               f"{label}={presence}"]
        return True, []
    return fn


FIT_PREDICATES = {
    "PodFitsHost": _declare("pod", "node")(_p_host),
    "HostName": _declare("pod", "node")(_p_host),
    "MatchNodeSelector": _declare("pod", "node")(_p_selector),
    "PodFitsHostPorts": _declare("pod", "node_pods")(_p_ports),
    # upstream back-compat alias
    "PodFitsPorts": _declare("pod", "node_pods")(_p_ports),
    "PodToleratesNodeTaints": _declare("pod", "node")(_p_taints),
    "CheckNodeCondition": _declare("pod", "node")(_p_condition),
    "CheckNodeMemoryPressure": _declare("pod", "node")(_p_memory_pressure),
    "CheckNodeDiskPressure": _declare("pod", "node")(_p_disk_pressure),
    "PodFitsResources": _declare("pod", "node", "node_pods")(_p_resources),
    "NoDiskConflict": _declare("pod_volumes", "node_pods")(_p_disk_conflict),
    "MaxEBSVolumeCount": _declare("pod_volumes", "node_pods")(
        _p_max_volumes("awsElasticBlockStore", 39)),
    "MaxGCEPDVolumeCount": _declare("pod_volumes", "node_pods")(
        _p_max_volumes("gcePersistentDisk", 16)),
    "NoVolumeZoneConflict": _declare("pod_volumes", "node")(_p_volume_zone),
    "CheckVolumeBinding": _declare("pod_volumes", "cluster_volumes")(
        _p_volume_binding),
    "GeneralPredicates": _declare("pod", "node", "node_pods")(_p_general),
    "MatchInterPodAffinity": _declare("pod", "cluster_pods")(_p_interpod),
    "CheckNodeLabelPresence": _declare("pod", "node")(_p_label_presence),
}


# ---- priority registry ------------------------------------------------------
# name -> builder(args) -> batch_fn(kube_pod, pod_requests, facts, ctx) -> dict

def _per_node(fn):
    """Adapt a per-node priority to the batch signature."""
    def batch(kube_pod, pod_requests, facts, ctx):
        return {name: fn(kube_pod, pod_requests, f)
                for name, f in facts.items()}
    return batch


def _pr_least(args):
    return _per_node(lambda pod, req, f: priorities.least_requested(req, f))


def _pr_most(args):
    return _per_node(lambda pod, req, f: priorities.most_requested(req, f))


def _pr_balanced(args):
    return _per_node(lambda pod, req, f: priorities.balanced_allocation(req, f))


def _pr_node_affinity(args):
    return _per_node(lambda pod, req, f: priorities.node_affinity(pod, f))


def _pr_taints(args):
    return _per_node(lambda pod, req, f: priorities.taint_toleration(pod, f))


def _pr_avoid(args):
    return _per_node(
        lambda pod, req, f: priorities.node_prefer_avoid_pods(pod, f))


def _pr_image(args):
    return _per_node(lambda pod, req, f: priorities.image_locality(pod, f))


def _pr_limits(args):
    return _per_node(lambda pod, req, f: priorities.resource_limits(pod, f))


def _pr_equal(args):
    return _per_node(lambda pod, req, f: priorities.equal_priority(pod, f))


def _pr_node_label(args):
    spec = (args or {}).get("labelPreference") or {}
    label = spec.get("label") or ""
    presence = bool(spec.get("presence", True))
    return _per_node(
        lambda pod, req, f: priorities.node_label(f, label, presence))


# Registry names that resolve to the spreading batch below — the
# scheduler consults this to decide whether owner listers are needed at
# all (both names must behave identically).
SPREADING_PRIORITY_NAMES = frozenset(
    {"SelectorSpreadPriority", "ServiceSpreadingPriority"})


def _pr_spreading(args):
    def batch(kube_pod, pod_requests, facts, ctx):
        sels = getattr(ctx, "owner_selectors", None)
        if sels is None:
            # standalone engine without Service/RC listers: spread by
            # the pod's own identifying labels (documented fallback)
            max_same = max((priorities._count_same_labeled(kube_pod, f)
                            for f in facts.values()), default=0)
            return {name: priorities.selector_spreading(kube_pod, f,
                                                        max_same)
                    for name, f in facts.items()}
        if not sels:
            # no owning object selects this pod: upstream's map phase
            # scores 0 and its reduce turns the all-zero column into
            # MaxPriority everywhere (`selector_spreading.go`) — emit
            # the post-reduce value, consistent with the
            # owner-matches-no-pods branch below
            return {name: priorities.MAX_PRIORITY for name in facts}
        counts = {name: priorities.count_matching_selectors(f, sels)
                  for name, f in facts.items()}
        mx = max(counts.values(), default=0)
        # zone weighting (`selector_spreading.go` reduce): when any node
        # carries zone labels, a zoned node's score blends 1/3 node
        # spread with 2/3 zone spread (zone counts = sum of its nodes')
        zones = {name: priorities.zone_key(f.labels)
                 for name, f in facts.items()}
        by_zone: dict = {}
        for name, z in zones.items():
            if z:
                by_zone[z] = by_zone.get(z, 0) + counts[name]
        zmax = max(by_zone.values(), default=0)
        out = {}
        for name in facts:
            score = priorities.spread_score(counts[name], mx)
            z = zones[name]
            if by_zone and z:
                zscore = priorities.spread_score(by_zone[z], zmax)
                score = (score * (1.0 - priorities.ZONE_WEIGHTING)
                         + priorities.ZONE_WEIGHTING * zscore)
            out[name] = score
        return out
    return batch


def _pr_interpod(args):
    def batch(kube_pod, pod_requests, facts, ctx):
        if ctx.meta is None:
            return {name: 0.0 for name in facts}
        raw = interpod.interpod_affinity_scores(
            kube_pod, sorted(facts), ctx.meta,
            hard_weight=ctx.hard_pod_affinity_weight)
        return interpod.reduce_to_priority_scale(raw)
    return batch


PRIORITIES = {
    "LeastRequestedPriority": _pr_least,
    "MostRequestedPriority": _pr_most,
    "BalancedResourceAllocation": _pr_balanced,
    "NodeAffinityPriority": _pr_node_affinity,
    "TaintTolerationPriority": _pr_taints,
    "NodePreferAvoidPodsPriority": _pr_avoid,
    "ImageLocalityPriority": _pr_image,
    "ResourceLimitsPriority": _pr_limits,
    "EqualPriority": _pr_equal,
    "NodeLabelPriority": _pr_node_label,
    "SelectorSpreadPriority": _pr_spreading,
    "ServiceSpreadingPriority": _pr_spreading,
    "InterPodAffinityPriority": _pr_interpod,
}

# engine-internal snake names (pre-factory API, still accepted in
# ``priorityWeights`` config) -> registry names
PRIORITY_ALIASES = {
    "least_requested": "LeastRequestedPriority",
    "most_requested": "MostRequestedPriority",
    "balanced_allocation": "BalancedResourceAllocation",
    "selector_spreading": "SelectorSpreadPriority",
    "node_affinity": "NodeAffinityPriority",
    "taint_toleration": "TaintTolerationPriority",
    "node_prefer_avoid_pods": "NodePreferAvoidPodsPriority",
    "image_locality": "ImageLocalityPriority",
    "interpod_affinity": "InterPodAffinityPriority",
}


# ---- providers --------------------------------------------------------------

# Mirrors defaultPredicates()/defaultPriorities() in defaults.go, ordered
# cheap-first like the engine always ran them; the volume and inter-pod
# checks are no-ops for pods that declare nothing.
DEFAULT_PREDICATE_NAMES = (
    "CheckNodeCondition", "CheckNodeMemoryPressure", "CheckNodeDiskPressure",
    "PodFitsHost", "MatchNodeSelector",
    "PodToleratesNodeTaints", "PodFitsHostPorts", "PodFitsResources",
    "NoDiskConflict", "NoVolumeZoneConflict", "MaxEBSVolumeCount",
    "MaxGCEPDVolumeCount", "CheckVolumeBinding", "MatchInterPodAffinity",
)

DEFAULT_PRIORITIES = (
    ("LeastRequestedPriority", 1.0),
    ("BalancedResourceAllocation", 1.0),
    ("SelectorSpreadPriority", 1.0),
    ("NodeAffinityPriority", 1.0),
    ("TaintTolerationPriority", 1.0),
    ("NodePreferAvoidPodsPriority", 1.0),
    ("InterPodAffinityPriority", 1.0),
)

DEFAULT_DEVICE_WEIGHT = 2.0


def default_algorithm(priority_weights: dict | None = None) -> AlgorithmConfig:
    """The DefaultProvider. ``priority_weights`` REPLACES the weight set
    (pre-factory `priorities.combine` semantics): only the named
    priorities run, at the given weights, and ``device_score`` must be
    listed to keep the device score in the sum. Without it the default
    priority set applies."""
    preds = [(name, FIT_PREDICATES[name](None))
             for name in DEFAULT_PREDICATE_NAMES]
    if priority_weights is None:
        prios = [(name, weight, PRIORITIES[name](None))
                 for name, weight in DEFAULT_PRIORITIES]
        return _mark_vector_safe(
            AlgorithmConfig(preds, prios,
                            device_weight=DEFAULT_DEVICE_WEIGHT))
    device_weight = 0.0
    prios = []
    for key in sorted(priority_weights):
        weight = float(priority_weights[key])
        if key == "device_score":
            device_weight = weight
            continue
        name = PRIORITY_ALIASES.get(key, key)
        if weight and name in PRIORITIES:
            prios.append((name, weight, PRIORITIES[name](None)))
    return _mark_vector_safe(
        AlgorithmConfig(preds, prios, device_weight=device_weight))


def _mark_vector_safe(algo: AlgorithmConfig) -> AlgorithmConfig:
    """Set the vector-safety marks for an algorithm built from the
    DEFAULT predicate chain: the masked filter models exactly that
    chain; priorities vectorize iff every name has an array kernel."""
    from kubegpu_tpu_torch.scheduler.vectorized import VECTOR_SCORABLE_PRIORITIES

    algo.vector_predicates = True
    algo.vector_priorities = all(
        name in VECTOR_SCORABLE_PRIORITIES
        for name, _weight, _fn in algo.priorities)
    return algo


class PolicyError(ValueError):
    pass


def cluster_autoscaler_algorithm() -> AlgorithmConfig:
    """ClusterAutoscalerProvider (`defaults.go`): the default set with
    LeastRequestedPriority swapped for MostRequestedPriority — pack nodes
    tight so the autoscaler can drain and remove empties."""
    algo = default_algorithm()
    algo.priorities = [
        ("MostRequestedPriority", w, PRIORITIES["MostRequestedPriority"](None))
        if name == "LeastRequestedPriority" else (name, w, fn)
        for name, w, fn in algo.priorities]
    return _mark_vector_safe(algo)


ALGORITHM_PROVIDERS = {
    "DefaultProvider": default_algorithm,
    "ClusterAutoscalerProvider": cluster_autoscaler_algorithm,
}


def algorithm_provider(name: str | None) -> AlgorithmConfig:
    """Look up a registered provider by name (None -> DefaultProvider),
    like the factory's GetAlgorithmProvider."""
    build = ALGORITHM_PROVIDERS.get(name or "DefaultProvider")
    if build is None:
        raise PolicyError(f"unknown algorithm provider {name!r}")
    return build()


def algorithm_from_policy(policy: dict) -> AlgorithmConfig:
    """Compose from a reference-style Policy document
    (`kube-scheduler/pkg/api/types.go`):

        {"kind": "Policy",
         "predicates": [{"name": "PodFitsResources"},
                        {"name": "CheckNodeLabelPresence",
                         "argument": {"labelsPresence": {...}}}],
         "priorities": [{"name": "LeastRequestedPriority", "weight": 2}],
         "hardPodAffinitySymmetricWeight": 1}

    Empty predicate/priority lists fall back to the default provider's
    set (upstream behavior). Unknown names raise ``PolicyError`` like the
    factory's fatal lookup."""
    if policy.get("kind") not in (None, "Policy"):
        raise PolicyError(f"not a Policy document: kind={policy.get('kind')}")
    preds = []
    for spec in policy.get("predicates") or []:
        name = spec.get("name")
        build = FIT_PREDICATES.get(name)
        if build is None:
            raise PolicyError(f"unknown fit predicate {name!r}")
        preds.append((name, build(spec.get("argument"))))
    prios = []
    for spec in policy.get("priorities") or []:
        name = spec.get("name")
        build = PRIORITIES.get(name)
        if build is None:
            raise PolicyError(f"unknown priority {name!r}")
        weight = float(spec.get("weight", 1))
        if weight:
            prios.append((name, weight, build(spec.get("argument"))))
    default = default_algorithm()
    return AlgorithmConfig(
        preds or default.predicates,
        prios or default.priorities,
        device_weight=float(policy.get("deviceScoreWeight",
                                       DEFAULT_DEVICE_WEIGHT)),
        hard_pod_affinity_weight=int(policy.get(
            "hardPodAffinitySymmetricWeight",
            interpod.DEFAULT_HARD_POD_AFFINITY_WEIGHT)))
