"""Stock priority functions.

The reference fork ships the upstream priority suite
(`kube-scheduler/pkg/algorithm/priorities/`, ~1100 LoC) and combines it
with the device score produced during the fit pass
(`core/generic_scheduler.go:170-171,526-...`). Each function here maps a
feasible node to a score on the upstream 0..10 scale; ``combine`` does the
weighted sum. All functions are pure over the pod dict plus per-node facts
gathered from the cache snapshot, so the map-reduce can run in the same
parallel workers as the filter.

Implemented (reference file in parens):

- ``least_requested``          (least_requested.go) — favor idle nodes
- ``balanced_allocation``      (balanced_resource_allocation.go) — favor
  nodes where cpu and memory utilization stay close to each other
- ``selector_spreading``       (selector_spreading.go) — spread pods with
  the same labels across nodes
- ``node_affinity``            (node_affinity.go) — sum of matched
  preferredDuringScheduling term weights
- ``taint_toleration``         (taint_toleration.go) — fewer intolerable
  PreferNoSchedule taints is better
- ``node_prefer_avoid_pods``   (node_prefer_avoid_pods.go) — node
  annotation veto for controller-owned pods
- ``most_requested``           (most_requested.go) — bin-packing twin of
  least_requested
- ``image_locality``           (image_locality.go) — favor nodes already
  holding the pod's container images
- ``resource_limits``          (resource_limits.go) — node satisfies the
  pod's resource *limits*
- ``node_label``               (node_label.go) — policy-configured label
  presence/absence preference
- ``equal_priority``           (core.EqualPriorityMap) — flat score

Inter-pod affinity priority lives in ``interpod.py`` (cluster-wide
metadata). ``combine`` does the weighted sum over whatever subset the
factory configured.
"""

from __future__ import annotations

import json

MAX_PRIORITY = 10.0

# Upstream default weights (algorithmprovider/defaults/defaults.go): every
# standard priority is weight 1; device score rides with the same weight as
# a resource priority.
DEFAULT_WEIGHTS = {
    "least_requested": 1.0,
    "balanced_allocation": 1.0,
    "selector_spreading": 1.0,
    "node_affinity": 1.0,
    "taint_toleration": 1.0,
    "node_prefer_avoid_pods": 1.0,
    "device_score": 2.0,
}


class NodeFacts:
    """Per-node inputs to the priority functions, extracted from one cache
    snapshot so scoring never races the watcher."""

    def __init__(self, kube_node: dict, core_allocatable: dict,
                 requested_core: dict, pod_labels: dict):
        self.kube_node = kube_node
        self.core_allocatable = core_allocatable  # res -> int
        self.requested_core = requested_core      # res -> int (incl. assumed)
        self.pod_labels = pod_labels              # pod name -> labels dict

    @property
    def labels(self) -> dict:
        return (self.kube_node.get("metadata") or {}).get("labels") or {}


def _fraction(requested: float, capacity: float) -> float:
    if capacity <= 0:
        return 1.0
    return min(max(requested / capacity, 0.0), 1.0)


def least_requested(pod_requests: dict, facts: NodeFacts) -> float:
    """((capacity - requested) / capacity) * 10, averaged over cpu+memory
    (`least_requested.go`)."""
    scores = []
    for res in ("cpu", "memory"):
        cap = facts.core_allocatable.get(res)
        if not cap:
            continue
        used = facts.requested_core.get(res, 0) + pod_requests.get(res, 0)
        scores.append((1.0 - _fraction(used, cap)) * MAX_PRIORITY)
    return sum(scores) / len(scores) if scores else MAX_PRIORITY / 2


def balanced_allocation(pod_requests: dict, facts: NodeFacts) -> float:
    """10 - |cpuFraction - memoryFraction| * 10 (`balanced_resource_
    allocation.go`): penalize lopsided utilization."""
    fracs = []
    for res in ("cpu", "memory"):
        cap = facts.core_allocatable.get(res)
        if not cap:
            continue
        used = facts.requested_core.get(res, 0) + pod_requests.get(res, 0)
        fracs.append(_fraction(used, cap))
    if len(fracs) < 2:
        return MAX_PRIORITY / 2
    return (1.0 - abs(fracs[0] - fracs[1])) * MAX_PRIORITY


def selector_spreading(kube_pod: dict, facts: NodeFacts,
                       max_same: int) -> float:
    """Fewer same-labeled pods on the node → higher score, normalized by
    the cluster-wide max (`selector_spreading.go`). The reference selects
    by service/RC selector; the standalone engine uses label equality of
    the pod's identifying labels."""
    same = _count_same_labeled(kube_pod, facts)
    if max_same <= 0:
        return MAX_PRIORITY
    return (1.0 - same / max_same) * MAX_PRIORITY


def label_selector_matches(sel: dict, labels: dict) -> bool:
    """Full LabelSelector semantics — one matcher for the whole
    scheduler: delegates to `interpod.label_selector_matches` (built on
    `predicates._match_expression`, incl. Gt/Lt and upstream's
    absent-key behavior for NotIn/DoesNotExist) so spread scoring can
    never diverge from affinity matching for the same selector."""
    from kubegpu_tpu_torch.scheduler import interpod

    return interpod.label_selector_matches(sel, labels)


def count_matching_selectors(facts: NodeFacts, selectors: list) -> int:
    """Pods on the node matched by ANY of the owning objects' selectors
    (`selector_spreading.go` CalculateSpreadPriorityMap: a pod counts
    once even when several selectors match it)."""
    n = 0
    for other in facts.pod_labels.values():
        if any(label_selector_matches(sel, other) for sel in selectors):
            n += 1
    return n


ZONE_REGION_LABEL = "failure-domain.beta.kubernetes.io/region"
ZONE_FAILURE_DOMAIN_LABEL = "failure-domain.beta.kubernetes.io/zone"
# zone spreading outweighs node spreading 2:1 (`selector_spreading.go:34`)
ZONE_WEIGHTING = 2.0 / 3.0


def zone_key(node_labels: dict) -> str:
    """Unique per-failure-zone identifier from the node's region+zone
    labels (upstream `GetZoneKey`); empty when the node is unzoned."""
    region = node_labels.get(ZONE_REGION_LABEL, "")
    zone = node_labels.get(ZONE_FAILURE_DOMAIN_LABEL, "")
    if not region and not zone:
        return ""
    return f"{region}:\x00:{zone}"


def spread_score(count: int, max_count: int) -> float:
    """The reference's reduce formula
    (`selector_spreading.go` CalculateSpreadPriorityReduce):
    ``MaxPriority * (max - count) / max``; all nodes score MaxPriority
    when no node has a matching pod. Zone weighting sits ABOVE this
    (`factory._pr_spreading` blends node and zone spread_scores by
    `ZONE_WEIGHTING` when nodes carry `zone_key` labels)."""
    if max_count <= 0:
        return MAX_PRIORITY
    return MAX_PRIORITY * (max_count - count) / max_count


def owner_selectors_for_pod(kube_pod: dict, services=(), rcs=(), rss=(),
                            statefulsets=()) -> list:
    """Selectors of the owning objects that SELECT this pod
    (`selector_spreading.go` getSelectors): a Service/RC contributes its
    ``spec.selector`` label map, an RS/StatefulSet its full
    ``spec.selector`` LabelSelector (matchLabels AND matchExpressions),
    each only when non-empty and matching the pod's labels. Returned
    selectors are normalized to LabelSelector shape."""
    labels = (kube_pod.get("metadata") or {}).get("labels") or {}
    out = []
    for objs, nested in ((services, False), (rcs, False), (rss, True),
                         (statefulsets, True)):
        for obj in objs:
            raw = (obj.get("spec") or {}).get("selector") or {}
            if not isinstance(raw, dict):
                continue
            if nested:
                sel = {"matchLabels": dict(raw.get("matchLabels") or {}),
                       "matchExpressions":
                           list(raw.get("matchExpressions") or [])}
            else:
                sel = {"matchLabels": dict(raw),
                       "matchExpressions": []}
            if not (sel["matchLabels"] or sel["matchExpressions"]):
                continue  # empty selector owns nothing (upstream)
            if label_selector_matches(sel, labels):
                out.append(sel)
    return out


def _count_same_labeled(kube_pod: dict, facts: NodeFacts) -> int:
    labels = (kube_pod.get("metadata") or {}).get("labels") or {}
    ident = {k: v for k, v in labels.items() if k != "name"}
    if not ident:
        return 0
    n = 0
    for other in facts.pod_labels.values():
        if all(other.get(k) == v for k, v in ident.items()):
            n += 1
    return n


def node_affinity(kube_pod: dict, facts: NodeFacts) -> float:
    """Sum of matched preferredDuringSchedulingIgnoredDuringExecution
    weights, normalized to 0..10 (`node_affinity.go`)."""
    from kubegpu_tpu_torch.scheduler.predicates import node_selector_term_matches

    affinity = ((kube_pod.get("spec") or {}).get("affinity") or {}) \
        .get("nodeAffinity") or {}
    preferred = affinity.get(
        "preferredDuringSchedulingIgnoredDuringExecution") or []
    if not preferred:
        return 0.0
    total = sum(int(t.get("weight") or 0) for t in preferred)
    if total <= 0:
        return 0.0
    matched = sum(
        int(t.get("weight") or 0) for t in preferred
        if node_selector_term_matches(facts.labels, t.get("preference") or {}))
    return matched / total * MAX_PRIORITY


def taint_toleration(kube_pod: dict, facts: NodeFacts) -> float:
    """10 minus a point per intolerable PreferNoSchedule taint
    (`taint_toleration.go`, simplified from the normalize pass)."""
    from kubegpu_tpu_torch.scheduler.predicates import _toleration_tolerates

    taints = (facts.kube_node.get("spec") or {}).get("taints") or []
    tolerations = (kube_pod.get("spec") or {}).get("tolerations") or []
    intolerable = sum(
        1 for taint in taints
        if taint.get("effect") == "PreferNoSchedule"
        and not any(_toleration_tolerates(t, taint) for t in tolerations))
    return max(MAX_PRIORITY - intolerable, 0.0)


def node_prefer_avoid_pods(kube_pod: dict, facts: NodeFacts) -> float:
    """Node annotation `scheduler.alpha.kubernetes.io/preferAvoidPods`
    vetoes controller-owned pods (`node_prefer_avoid_pods.go`): 0 when the
    pod's controller is listed, 10 otherwise."""
    ann = ((facts.kube_node.get("metadata") or {}).get("annotations") or {}) \
        .get("scheduler.alpha.kubernetes.io/preferAvoidPods")
    if not ann:
        return MAX_PRIORITY
    owner = next(iter((kube_pod.get("metadata") or {})
                      .get("ownerReferences") or []), None)
    if owner is None:
        return MAX_PRIORITY
    try:
        avoid = json.loads(ann)
    except (TypeError, ValueError):
        return MAX_PRIORITY
    for entry in avoid.get("preferAvoidPods") or []:
        sig = (entry.get("podSignature") or {}).get("podController") or {}
        if (sig.get("kind") == owner.get("kind")
                and sig.get("name") == owner.get("name")):
            return 0.0
    return MAX_PRIORITY


def most_requested(pod_requests: dict, facts: NodeFacts) -> float:
    """(requested / capacity) * 10 averaged over cpu+memory
    (`most_requested.go`) — bin-packing: fill hot nodes first."""
    scores = []
    for res in ("cpu", "memory"):
        cap = facts.core_allocatable.get(res)
        if not cap:
            continue
        used = facts.requested_core.get(res, 0) + pod_requests.get(res, 0)
        scores.append(_fraction(used, cap) * MAX_PRIORITY)
    return sum(scores) / len(scores) if scores else MAX_PRIORITY / 2


# Upstream image-locality thresholds (`image_locality.go`): below 23MB of
# already-present image data the node scores 0, above 1000MB it scores 10.
_IMAGE_MIN_BYTES = 23 * 1024 * 1024
_IMAGE_MAX_BYTES = 1000 * 1024 * 1024


def image_locality(kube_pod: dict, facts: NodeFacts) -> float:
    """Sum the sizes of the pod's container images already present on the
    node (node.status.images) and scale between the thresholds."""
    wanted = set()
    spec = kube_pod.get("spec") or {}
    for c in (spec.get("containers") or []) + (spec.get("initContainers") or []):
        if c.get("image"):
            wanted.add(c["image"])
    if not wanted:
        return 0.0
    present = 0
    for img in (facts.kube_node.get("status") or {}).get("images") or []:
        if wanted & set(img.get("names") or []):
            present += int(img.get("sizeBytes") or 0)
    if present < _IMAGE_MIN_BYTES:
        return 0.0
    if present > _IMAGE_MAX_BYTES:
        return MAX_PRIORITY
    return (present - _IMAGE_MIN_BYTES) / \
        (_IMAGE_MAX_BYTES - _IMAGE_MIN_BYTES) * MAX_PRIORITY


def _pod_core_limits(kube_pod: dict) -> dict:
    from kubegpu_tpu_torch.core import codec
    out: dict = {}
    spec = kube_pod.get("spec") or {}
    for c in spec.get("containers") or []:
        for res, val in ((c.get("resources") or {}).get("limits") or {}).items():
            out[res] = out.get(res, 0) + codec.parse_quantity(val)
    for c in spec.get("initContainers") or []:
        for res, val in ((c.get("resources") or {}).get("limits") or {}).items():
            out[res] = max(out.get(res, 0), codec.parse_quantity(val))
    return out


def resource_limits(kube_pod: dict, facts: NodeFacts) -> float:
    """1 when the node's allocatable covers the pod's cpu+memory *limits*,
    else 0 (`resource_limits.go` — a nudge, deliberately not 0..10)."""
    limits = _pod_core_limits(kube_pod)
    for res in ("cpu", "memory"):
        want = limits.get(res)
        if want and want > facts.core_allocatable.get(res, 0):
            return 0.0
    return 1.0 if any(limits.get(r) for r in ("cpu", "memory")) else 0.0


def node_label(facts: NodeFacts, label: str, presence: bool = True) -> float:
    """Policy-configured label preference (`node_label.go`): 10 when the
    label's presence matches the desired ``presence``, else 0."""
    return MAX_PRIORITY if (label in facts.labels) == presence else 0.0


def equal_priority(kube_pod: dict, facts: NodeFacts) -> float:
    """EqualPriorityMap: every node scores 1."""
    return 1.0


def combine(per_function: dict, weights: dict | None = None) -> float:
    """Weighted sum over priority scores (`generic_scheduler.go:526-...`)."""
    weights = weights or DEFAULT_WEIGHTS
    return sum(per_function.get(name, 0.0) * w
               for name, w in weights.items())
