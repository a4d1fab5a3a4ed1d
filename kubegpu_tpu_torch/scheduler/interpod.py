"""Inter-pod affinity/anti-affinity: predicate + priority + metadata.

Reference: the fork's `kube-scheduler/pkg/algorithm/predicates/predicates.go`
(InterPodAffinityMatches and its helpers) and
`algorithm/priorities/interpod_affinity.go`, with the one-pass cluster scan
factored into a metadata producer like `algorithm/predicates/metadata.go` —
the cluster is walked once per scheduled pod, not once per node.

Semantics kept from upstream:

- requiredDuringSchedulingIgnoredDuringExecution podAffinity terms are
  ANDed; each needs an existing pod matching the term's labelSelector (in
  the term's namespaces, defaulting to the incoming pod's namespace) whose
  node shares the candidate node's topologyKey value. A term no pod in the
  cluster matches is still satisfied when the incoming pod matches it
  itself (first pod of a self-affine group can land).
- required podAntiAffinity terms fail a node when any matching existing
  pod sits in the same topology domain.
- symmetry: an existing pod's required anti-affinity veto applies to the
  incoming pod even when the incoming pod declares nothing.
- the priority sums preferred-term weights over existing pods (positive
  for affinity, negative for anti-affinity, both directions of symmetry)
  and is reduce-normalized across nodes to the 0..10 scale.
"""

from __future__ import annotations

from kubegpu_tpu_torch.scheduler.predicates import _match_expression

MAX_PRIORITY = 10.0
# Upstream default for the symmetric weight of *required* affinity terms in
# the priority (`--hard-pod-affinity-symmetric-weight`).
DEFAULT_HARD_POD_AFFINITY_WEIGHT = 1


class ExistingPod:
    """One placed pod, slimmed to what affinity evaluation reads."""

    __slots__ = ("name", "namespace", "labels", "node_name", "affinity")

    def __init__(self, name, namespace, labels, node_name, affinity):
        self.name = name
        self.namespace = namespace or "default"
        self.labels = labels or {}
        self.node_name = node_name
        self.affinity = affinity or {}  # {"podAffinity": ..., "podAntiAffinity": ...}


class InterPodMetadata:
    """Cluster-wide inputs gathered under one cache lock acquisition
    (`metadata.go`'s PredicateMetadata analogue)."""

    def __init__(self, node_labels: dict, pods: list):
        self.node_labels = node_labels  # node name -> labels dict
        self.pods = pods                # list[ExistingPod]

    def topology_value(self, node_name: str, key: str):
        labels = self.node_labels.get(node_name)
        if labels is None:
            return None
        return labels.get(key)


# ---- selectors --------------------------------------------------------------

def label_selector_matches(selector: dict | None, labels: dict) -> bool:
    """k8s LabelSelector: matchLabels AND matchExpressions, empty selector
    matches everything, missing selector matches nothing (upstream)."""
    if selector is None:
        return False
    for key, val in (selector.get("matchLabels") or {}).items():
        if labels.get(key) != val:
            return False
    for expr in selector.get("matchExpressions") or []:
        if not _match_expression(labels, expr):
            return False
    return True


def _term_namespaces(term: dict, default_namespace: str) -> list:
    return term.get("namespaces") or [default_namespace]


def term_matches_pod(term: dict, owner_namespace: str,
                     other: ExistingPod) -> bool:
    """Does ``other`` match one affinity term declared by a pod living in
    ``owner_namespace``?"""
    if other.namespace not in _term_namespaces(term, owner_namespace):
        return False
    return label_selector_matches(term.get("labelSelector"), other.labels)


def pod_affinity_terms(kube_pod_or_affinity, kind: str, required: bool) -> list:
    """Extract terms; ``kind`` is podAffinity|podAntiAffinity. Accepts a
    kube pod dict or a pre-extracted spec.affinity dict."""
    if isinstance(kube_pod_or_affinity, dict) and "spec" in kube_pod_or_affinity:
        affinity = ((kube_pod_or_affinity.get("spec") or {})
                    .get("affinity") or {})
    else:
        affinity = kube_pod_or_affinity or {}
    section = affinity.get(kind) or {}
    if required:
        return section.get(
            "requiredDuringSchedulingIgnoredDuringExecution") or []
    return section.get(
        "preferredDuringSchedulingIgnoredDuringExecution") or []


def _pod_namespace(kube_pod: dict) -> str:
    return (kube_pod.get("metadata") or {}).get("namespace") or "default"


def has_any_terms(affinity: dict | None) -> bool:
    """True when a pod's affinity spec carries any pod(Anti)Affinity
    content (required OR preferred) — the metadata-building gate: the
    priority reads preferred terms too."""
    if not affinity:
        return False
    for kind in ("podAffinity", "podAntiAffinity"):
        section = affinity.get(kind) or {}
        if section.get("requiredDuringSchedulingIgnoredDuringExecution") or \
                section.get("preferredDuringSchedulingIgnoredDuringExecution"):
            return True
    return False


def has_required_anti_terms(affinity: dict | None) -> bool:
    """True when the spec carries REQUIRED podAntiAffinity terms — the only
    placed-pod content that can flip another pod's predicate verdict (the
    symmetry veto), hence the only content that must flush memoized
    verdicts cluster-wide."""
    if not affinity:
        return False
    section = affinity.get("podAntiAffinity") or {}
    return bool(section.get("requiredDuringSchedulingIgnoredDuringExecution"))


# ---- the predicate ----------------------------------------------------------

def match_interpod_affinity(kube_pod: dict, node_name: str,
                            meta: InterPodMetadata) -> tuple:
    """(fits, reasons) for one candidate node."""
    namespace = _pod_namespace(kube_pod)
    pod_labels = (kube_pod.get("metadata") or {}).get("labels") or {}
    candidate_labels = meta.node_labels.get(node_name) or {}
    # the incoming pod viewed as a match target — invariant across the
    # loops below, built once
    self_pod = ExistingPod(None, namespace, pod_labels, node_name, None)

    # (a) existing pods' required anti-affinity vs the incoming pod
    for other in meta.pods:
        for term in pod_affinity_terms(other.affinity, "podAntiAffinity",
                                       required=True):
            if not term_matches_pod(term, other.namespace, self_pod):
                continue
            key = term.get("topologyKey")
            if not key:
                continue
            other_val = meta.topology_value(other.node_name, key)
            if other_val is not None and candidate_labels.get(key) == other_val:
                return False, [
                    "node(s) violated existing pod anti-affinity "
                    f"(pod {other.name}, topologyKey {key})"]

    # (b) the incoming pod's required affinity terms (ANDed)
    for term in pod_affinity_terms(kube_pod, "podAffinity", required=True):
        key = term.get("topologyKey")
        if not key:
            return False, ["pod affinity term missing topologyKey"]
        matches_anywhere = False
        satisfied = False
        for other in meta.pods:
            if not term_matches_pod(term, namespace, other):
                continue
            matches_anywhere = True
            other_val = meta.topology_value(other.node_name, key)
            if other_val is not None and candidate_labels.get(key) == other_val:
                satisfied = True
                break
        if satisfied:
            continue
        # first-pod-of-group escape hatch (upstream,
        # `predicates.go:1305-1326` satisfiesPodsAffinityAntiAffinity):
        # nothing in the cluster matches and the pod matches its own term
        # — the term is disregarded entirely, even on nodes that lack the
        # topology label, so the first pod of a self-affine group can land.
        if not matches_anywhere and \
                term_matches_pod(term, namespace, self_pod):
            continue
        return False, ["node(s) didn't satisfy pod affinity rules"]

    # (c) the incoming pod's required anti-affinity terms
    for term in pod_affinity_terms(kube_pod, "podAntiAffinity", required=True):
        key = term.get("topologyKey")
        if not key:
            continue
        for other in meta.pods:
            if not term_matches_pod(term, namespace, other):
                continue
            other_val = meta.topology_value(other.node_name, key)
            if other_val is not None and candidate_labels.get(key) == other_val:
                return False, ["node(s) didn't satisfy pod anti-affinity rules"]

    return True, []


# ---- the priority -----------------------------------------------------------

def interpod_affinity_scores(kube_pod: dict, node_names: list,
                             meta: InterPodMetadata,
                             hard_weight: int =
                             DEFAULT_HARD_POD_AFFINITY_WEIGHT) -> dict:
    """Raw (un-normalized) per-node scores (`interpod_affinity.go`):
    weighted matches of preferred terms in both directions plus the
    symmetric contribution of existing pods' *required* affinity terms."""
    namespace = _pod_namespace(kube_pod)
    pod_labels = (kube_pod.get("metadata") or {}).get("labels") or {}
    incoming = ExistingPod(None, namespace, pod_labels, None, None)

    pref_aff = pod_affinity_terms(kube_pod, "podAffinity", required=False)
    pref_anti = pod_affinity_terms(kube_pod, "podAntiAffinity", required=False)

    # Accumulate weight per topology (key, value) domain during the pod
    # scan, then apply to the candidate nodes in ONE sweep — O(pods×terms
    # + nodes×domains), not O(pods×terms×nodes).
    domain_weight: dict = {}

    def credit(node_of_other: str, key: str, weight: float) -> None:
        if not key or not weight:
            return
        other_val = meta.topology_value(node_of_other, key)
        if other_val is None:
            return
        domain_weight[(key, other_val)] = \
            domain_weight.get((key, other_val), 0.0) + weight

    for other in meta.pods:
        # incoming pod's preferences vs the existing pod
        for weighted in pref_aff:
            term = weighted.get("podAffinityTerm") or {}
            if term_matches_pod(term, namespace, other):
                credit(other.node_name, term.get("topologyKey"),
                       float(weighted.get("weight") or 0))
        for weighted in pref_anti:
            term = weighted.get("podAffinityTerm") or {}
            if term_matches_pod(term, namespace, other):
                credit(other.node_name, term.get("topologyKey"),
                       -float(weighted.get("weight") or 0))
        # symmetry: the existing pod's terms vs the incoming pod
        for term in pod_affinity_terms(other.affinity, "podAffinity",
                                       required=True):
            if hard_weight and term_matches_pod(term, other.namespace, incoming):
                credit(other.node_name, term.get("topologyKey"),
                       float(hard_weight))
        for weighted in pod_affinity_terms(other.affinity, "podAffinity",
                                           required=False):
            term = weighted.get("podAffinityTerm") or {}
            if term_matches_pod(term, other.namespace, incoming):
                credit(other.node_name, term.get("topologyKey"),
                       float(weighted.get("weight") or 0))
        for weighted in pod_affinity_terms(other.affinity, "podAntiAffinity",
                                           required=False):
            term = weighted.get("podAffinityTerm") or {}
            if term_matches_pod(term, other.namespace, incoming):
                credit(other.node_name, term.get("topologyKey"),
                       -float(weighted.get("weight") or 0))
    scores = {name: 0.0 for name in node_names}
    for (key, val), weight in domain_weight.items():
        for name in node_names:
            if (meta.node_labels.get(name) or {}).get(key) == val:
                scores[name] += weight
    return scores


def reduce_to_priority_scale(raw: dict) -> dict:
    """Upstream reduce: spread raw scores linearly onto 0..10; a flat map
    (all equal, incl. all-zero) scores everything 0."""
    if not raw:
        return {}
    lo, hi = min(raw.values()), max(raw.values())
    if hi == lo:
        return {name: 0.0 for name in raw}
    return {name: (val - lo) / (hi - lo) * MAX_PRIORITY
            for name, val in raw.items()}


def pod_declares_interpod_affinity(kube_pod: dict) -> bool:
    """Any terms at all — gates metadata building (predicate + priority)."""
    affinity = ((kube_pod.get("spec") or {}).get("affinity") or {})
    return has_any_terms(affinity)


def pod_requires_interpod_affinity(kube_pod: dict) -> bool:
    """REQUIRED terms only — gates equivalence-cache bypass: preferred
    terms never change a predicate verdict, so preferred-only pods can
    stay memoized."""
    affinity = ((kube_pod.get("spec") or {}).get("affinity") or {})
    for kind in ("podAffinity", "podAntiAffinity"):
        section = affinity.get(kind) or {}
        if section.get("requiredDuringSchedulingIgnoredDuringExecution"):
            return True
    return False
