"""Stock fit predicates.

The reference scheduler fork ships the full upstream predicate suite
(`kube-scheduler/pkg/algorithm/predicates/predicates.go`, ~1498 LoC) and
inserts the device predicate alongside it
(`algorithmprovider/defaults/defaults.go:82-84`). This module provides the
non-device predicates the engine runs before ``PodFitsDevices``:

- ``pod_fits_host``        — spec.nodeName pinning (PodFitsHost)
- ``pod_matches_node_selector`` — nodeSelector labels + required node
  affinity terms (PodMatchNodeSelector)
- ``pod_fits_host_ports``  — hostPort conflicts (PodFitsHostPorts)
- ``pod_tolerates_node_taints`` — NoSchedule/NoExecute taints vs
  tolerations (PodToleratesNodeTaints)
- ``check_node_condition`` — Ready / unschedulable gates
  (CheckNodeCondition; the QoS-aware pressure predicates live in
  ``factory.py``)
- ``pod_fits_resources``   — prechecked cpu/memory accounting
  (PodFitsResources; group resources are the device predicate's job,
  cf. ``PrecheckedResource`` in `resource/resourcetranslate.go:97-99`)
- ``no_disk_conflict``     — exclusive-volume double-mount conflicts
  (NoDiskConflict: GCE PD / AWS EBS / RBD / ISCSI semantics)
- ``max_attachable_volume_count`` — per-node attachable-volume caps
  (MaxEBSVolumeCount / MaxGCEPDVolumeCount analogues)
- ``no_volume_zone_conflict`` — zone-labeled volumes must land in-zone
  (NoVolumeZoneConflict, over inline volume zone labels instead of a
  PV lister)
- ``general_predicates``   — the resources+host+ports+selector composite
  (GeneralPredicates)

Inter-pod affinity lives in ``interpod.py`` (needs cluster-wide
metadata, not just one node's snapshot).

Each predicate returns ``(fits: bool, reasons: list[str])`` and is pure
over the pod dict plus a point-in-time node snapshot, so the chain can run
inside the parallel filter workers and its results can be memoized by the
equivalence cache.

Memo-safety contract: a predicate's registration in ``factory.py`` MUST
declare the state slices its verdict reads (``fn.reads`` — "pod", "node",
"node_pods", "cluster_pods", "pod_volumes", "cluster_volumes"). The
engine only memoizes a verdict per (equivalence class, node generation)
when every configured predicate carries a declaration, because the
per-node generation can only invalidate what it knows a verdict read:
node-local reads are covered by that node's generation, cluster-wide pod
reads by the required-anti-affinity flush in ``SchedulerCache``, and
volume reads by the devolumed-sibling split in the engine. An undeclared
predicate therefore disables memoization entirely rather than risk a
stale verdict it cannot invalidate.
"""

from __future__ import annotations

from kubegpu_tpu_torch.core import codec


# ---- helpers ---------------------------------------------------------------

def pod_core_requests(kube_pod: dict) -> dict:
    """Sum of container resource requests; init containers use max-not-sum
    semantics like upstream (effective request = max(max(init), sum(run)))."""
    running: dict = {}
    init_max: dict = {}
    spec = kube_pod.get("spec") or {}
    for c in spec.get("containers") or []:
        for res, val in ((c.get("resources") or {}).get("requests") or {}).items():
            running[res] = running.get(res, 0) + codec.parse_quantity(val)
    for c in spec.get("initContainers") or []:
        for res, val in ((c.get("resources") or {}).get("requests") or {}).items():
            init_max[res] = max(init_max.get(res, 0), codec.parse_quantity(val))
    out = dict(running)
    for res, val in init_max.items():
        out[res] = max(out.get(res, 0), val)
    return out


def pod_host_ports(kube_pod: dict) -> set:
    """(protocol, hostIP, hostPort) triples requested by the pod."""
    out = set()
    spec = kube_pod.get("spec") or {}
    for c in (spec.get("containers") or []) + (spec.get("initContainers") or []):
        for port in c.get("ports") or []:
            hp = port.get("hostPort")
            if hp:
                out.add((port.get("protocol") or "TCP",
                         port.get("hostIP") or "0.0.0.0", int(hp)))
    return out


def _ports_conflict(a: tuple, b: tuple) -> bool:
    proto_a, ip_a, port_a = a
    proto_b, ip_b, port_b = b
    if proto_a != proto_b or port_a != port_b:
        return False
    # 0.0.0.0 conflicts with every hostIP on the same port/protocol
    return ip_a == ip_b or ip_a == "0.0.0.0" or ip_b == "0.0.0.0"


# ---- node selector / affinity ----------------------------------------------

def _match_expression(labels: dict, expr: dict) -> bool:
    key = expr.get("key")
    op = expr.get("operator")
    values = expr.get("values") or []
    present = key in labels
    val = labels.get(key)
    if op == "In":
        return present and val in values
    if op == "NotIn":
        return not present or val not in values
    if op == "Exists":
        return present
    if op == "DoesNotExist":
        return not present
    if op in ("Gt", "Lt"):
        if not present or not values:
            return False
        try:
            lhs, rhs = int(val), int(values[0])
        except (TypeError, ValueError):
            return False
        return lhs > rhs if op == "Gt" else lhs < rhs
    return False


def node_selector_term_matches(labels: dict, term: dict) -> bool:
    """All matchExpressions of one nodeSelectorTerm must hold (AND)."""
    exprs = term.get("matchExpressions") or []
    return all(_match_expression(labels, e) for e in exprs)


def required_affinity_matches(kube_pod: dict, node_labels: dict) -> bool:
    affinity = ((kube_pod.get("spec") or {}).get("affinity") or {}) \
        .get("nodeAffinity") or {}
    required = affinity.get("requiredDuringSchedulingIgnoredDuringExecution")
    if not required:
        return True
    terms = required.get("nodeSelectorTerms") or []
    if not terms:
        return True
    # terms are ORed
    return any(node_selector_term_matches(node_labels, t) for t in terms)


# ---- the predicates ---------------------------------------------------------

def pod_fits_host(kube_pod: dict, kube_node: dict) -> tuple:
    wanted = (kube_pod.get("spec") or {}).get("nodeName")
    if wanted and wanted != kube_node["metadata"]["name"]:
        return False, [f"node(s) didn't match the requested hostname {wanted}"]
    return True, []


def pod_matches_node_selector(kube_pod: dict, kube_node: dict) -> tuple:
    labels = (kube_node.get("metadata") or {}).get("labels") or {}
    selector = (kube_pod.get("spec") or {}).get("nodeSelector") or {}
    for key, val in selector.items():
        if labels.get(key) != val:
            return False, ["node(s) didn't match node selector"]
    if not required_affinity_matches(kube_pod, labels):
        return False, ["node(s) didn't match pod affinity rules"]
    return True, []


def pod_fits_host_ports(kube_pod: dict, used_ports: set) -> tuple:
    wanted = pod_host_ports(kube_pod)
    for w in sorted(wanted):
        for u in used_ports:
            if _ports_conflict(w, u):
                return False, [f"node(s) didn't have free ports ({w[2]}/{w[0]})"]
    return True, []


def _toleration_tolerates(tol: dict, taint: dict) -> bool:
    effect = tol.get("effect")
    if effect and effect != taint.get("effect"):
        return False
    op = tol.get("operator") or "Equal"
    if op == "Exists":
        return not tol.get("key") or tol.get("key") == taint.get("key")
    return (tol.get("key") == taint.get("key")
            and tol.get("value") == taint.get("value"))


def pod_tolerates_node_taints(kube_pod: dict, kube_node: dict) -> tuple:
    taints = (kube_node.get("spec") or {}).get("taints") or []
    tolerations = (kube_pod.get("spec") or {}).get("tolerations") or []
    for taint in taints:
        if taint.get("effect") not in ("NoSchedule", "NoExecute"):
            continue  # PreferNoSchedule is a priority, not a predicate
        if not any(_toleration_tolerates(t, taint) for t in tolerations):
            return False, [
                f"node(s) had taint {{{taint.get('key')}: "
                f"{taint.get('value')}}}, that the pod didn't tolerate"]
    return True, []


def check_node_condition(kube_pod: dict, kube_node: dict) -> tuple:
    """Ready + unschedulable gates (upstream CheckNodeCondition). Memory/
    disk pressure are their own predicates with QoS-aware semantics —
    `factory.py` CheckNodeMemoryPressure/CheckNodeDiskPressure."""
    spec = kube_node.get("spec") or {}
    if spec.get("unschedulable"):
        return False, ["node(s) were unschedulable"]
    reasons = []
    for cond in (kube_node.get("status") or {}).get("conditions") or []:
        if cond.get("type") == "Ready" and cond.get("status") != "True":
            reasons.append("node(s) were not ready")
    return not reasons, reasons


def pod_fits_resources(kube_pod: dict, core_allocatable: dict,
                       requested_core: dict) -> tuple:
    reasons = []
    for res, req in pod_core_requests(kube_pod).items():
        if res not in core_allocatable:
            continue  # group/device resources: the device predicate's job
        if req + requested_core.get(res, 0) > core_allocatable[res]:
            reasons.append(f"Insufficient {res}")
    return not reasons, reasons


# ---- volumes ----------------------------------------------------------------

# Exclusive volume sources and their identity/read-only extraction, per the
# reference's NoDiskConflict (`predicates.go` isVolumeConflict): GCE PDs
# conflict unless every mount is read-only; EBS, RBD and ISCSI volumes
# conflict on any double mount.
_VOLUME_IDENTITY = {
    "gcePersistentDisk": lambda src: ("gce", src.get("pdName")),
    "awsElasticBlockStore": lambda src: ("ebs", src.get("volumeID")),
    "rbd": lambda src: ("rbd", ",".join(sorted(src.get("monitors") or [])),
                        src.get("pool") or "rbd", src.get("image")),
    "iscsi": lambda src: ("iscsi", src.get("targetPortal"), src.get("iqn"),
                          src.get("lun")),
}
_READONLY_OK = {"gcePersistentDisk"}


def pod_volumes(kube_pod: dict) -> list:
    """The pod's volume dicts (spec.volumes)."""
    return (kube_pod.get("spec") or {}).get("volumes") or []


def _exclusive_volume_keys(volumes: list):
    """Yield (identity, read_only) for conflict-capable volumes. Identity
    components stay POSITIONAL (None → ""), never filtered: an iSCSI
    volume with lun=0 must not collide with one that has no lun, and a
    pdName-less GCE PD must not collide with a NAMED one (two pdName-less
    PDs still share the ("gce", "") identity, as upstream's string
    comparison would)."""
    for vol in volumes:
        for kind, ident_fn in _VOLUME_IDENTITY.items():
            src = vol.get(kind)
            if src is not None:
                yield (kind, *("" if c is None else c for c in ident_fn(src))), \
                    bool(src.get("readOnly")), kind


def no_disk_conflict(kube_pod: dict, node_pod_volumes: dict) -> tuple:
    """``node_pod_volumes``: existing pod name -> its volume list."""
    existing = {}
    for vols in node_pod_volumes.values():
        for ident, read_only, kind in _exclusive_volume_keys(vols):
            existing[ident] = existing.get(ident, True) and read_only
    for ident, read_only, kind in _exclusive_volume_keys(pod_volumes(kube_pod)):
        if ident not in existing:
            continue
        if kind in _READONLY_OK and read_only and existing[ident]:
            continue  # GCE PDs tolerate all-read-only sharing
        return False, [f"node(s) had no available disk ({ident[0]} volume "
                       "already mounted)"]
    return True, []


# Upstream defaults: 39 for EBS (DefaultMaxEBSVolumes), 16 for GCE PD.
MAX_ATTACHABLE = {"awsElasticBlockStore": 39, "gcePersistentDisk": 16}


def max_attachable_volume_count(kube_pod: dict, node_pod_volumes: dict,
                                limits: dict | None = None) -> tuple:
    """Cap distinct attachable volumes per node per cloud-disk kind
    (MaxEBSVolumeCount / MaxGCEPDVolumeCount)."""
    limits = limits or MAX_ATTACHABLE
    attached: dict = {kind: set() for kind in limits}
    for vols in node_pod_volumes.values():
        for vol in vols:
            for kind in limits:
                src = vol.get(kind)
                if src is not None:
                    ident = _VOLUME_IDENTITY[kind](src)
                    attached[kind].add(ident)
    for vol in pod_volumes(kube_pod):
        for kind in limits:
            src = vol.get(kind)
            if src is not None:
                attached[kind].add(_VOLUME_IDENTITY[kind](src))
    for kind, cap in limits.items():
        if len(attached[kind]) > cap:
            return False, [f"node(s) exceed max volume count ({kind})"]
    return True, []


_ZONE_LABELS = ("failure-domain.beta.kubernetes.io/zone",
                "failure-domain.beta.kubernetes.io/region",
                "topology.kubernetes.io/zone",
                "topology.kubernetes.io/region")


def no_volume_zone_conflict(kube_pod: dict, kube_node: dict) -> tuple:
    """Zone-labeled volumes must match the node's zone labels
    (NoVolumeZoneConflict). The reference resolves zones through a PV
    lister; standalone, the zone rides on the volume dict itself as
    ``labels`` (same failure-domain keys)."""
    node_labels = (kube_node.get("metadata") or {}).get("labels") or {}
    for vol in pod_volumes(kube_pod):
        vol_labels = vol.get("labels") or {}
        for key in _ZONE_LABELS:
            want = vol_labels.get(key)
            if want is None:
                continue
            have = node_labels.get(key)
            # zone label value may be a comma-separated set (upstream
            # multi-zone volumes)
            if have is None or have not in str(want).split(","):
                return False, ["node(s) had no available volume zone"]
    return True, []


# ---- volume binding (CheckVolumeBinding, `predicates.go:1443-1465`) --------


def pod_pvc_names(kube_pod: dict) -> list:
    """Names of the PersistentVolumeClaims the pod's volumes reference."""
    out = []
    for vol in pod_volumes(kube_pod):
        src = vol.get("persistentVolumeClaim")
        if src and src.get("claimName"):
            out.append(src["claimName"])
    return out


def pv_node_affinity_matches(pv: dict, kube_node: dict) -> bool:
    """A PV's ``spec.nodeAffinity.required`` nodeSelectorTerms against the
    node's labels (OR across terms, like node affinity)."""
    required = ((pv.get("spec") or {}).get("nodeAffinity") or {}) \
        .get("required") or {}
    terms = required.get("nodeSelectorTerms") or []
    if not terms:
        return True  # no affinity: usable anywhere
    labels = (kube_node.get("metadata") or {}).get("labels") or {}
    return any(node_selector_term_matches(labels, term) for term in terms)


def _pv_capacity(pv: dict) -> int:
    from kubegpu_tpu_torch.core import codec as _codec

    cap = ((pv.get("spec") or {}).get("capacity") or {}).get("storage", 0)
    try:
        return _codec.parse_quantity(cap)
    except ValueError:
        return 0


def _pvc_request(pvc: dict) -> int:
    from kubegpu_tpu_torch.core import codec as _codec

    req = (((pvc.get("spec") or {}).get("resources") or {})
           .get("requests") or {}).get("storage", 0)
    try:
        return _codec.parse_quantity(req)
    except ValueError:
        return 0


def _pv_available(pv: dict) -> bool:
    spec = pv.get("spec") or {}
    return not spec.get("claimRef") and \
        (pv.get("status") or {}).get("phase", "Available") != "Bound"


def check_volume_binding(kube_pod: dict, kube_node: dict,
                         pvcs_by_name: dict, pvs: list,
                         reserved_pvs: set | None = None) -> tuple:
    """CheckVolumeBinding (`predicates.go:1443-1465`): every bound PVC's PV
    must tolerate this node (node affinity); every unbound PVC must have a
    matchable available PV compatible with this node.

    Returns ``(ok, reasons, proposed)`` where ``proposed`` maps
    pvc name -> pv name for the unbound claims — the provisional decision
    the binder commits at bind time (`volume_binder.go:1-74` queues the
    same work). ``reserved_pvs`` are PVs already promised to in-flight
    pods and excluded from matching. Matching picks the smallest adequate
    PV (upstream smallest-fit), deterministic by (capacity, name)."""
    reserved = set(reserved_pvs or ())
    proposed: dict = {}
    for claim_name in pod_pvc_names(kube_pod):
        pvc = pvcs_by_name.get(claim_name)
        if pvc is None:
            return False, [f"persistentvolumeclaim \"{claim_name}\" "
                           "not found"], {}
        bound_pv = (pvc.get("spec") or {}).get("volumeName")
        if bound_pv:
            pv = next((p for p in pvs
                       if p["metadata"]["name"] == bound_pv), None)
            if pv is None or not pv_node_affinity_matches(pv, kube_node):
                return False, ["node(s) had volume node affinity "
                               "conflict"], {}
            continue
        # A PV whose claimRef already names THIS claim is the ONLY
        # permissible match (real-Kubernetes prebinding semantics) —
        # operator prebinding, and the recovery path for a half-committed
        # two-patch bind (PV claimRef landed, PVC volumeName patch
        # failed): without it the claim could never reach the idempotent
        # re-bind, and matching a DIFFERENT PV here would strand the
        # pre-claimed one claimRef'd forever (no PV controller exists to
        # clear it). If none tolerates this node, the node fails — the
        # pod is steered to where its pre-claimed PV lives.
        pod_ns = (kube_pod.get("metadata") or {}).get("namespace")

        def _prebound_for_claim(p):
            ref = ((p.get("spec") or {}).get("claimRef") or {})
            if ref.get("name") != claim_name:
                return False
            # PVs are cluster-scoped: a same-named claim in ANOTHER
            # namespace is a foreign binding, not ours. Either side
            # omitting the namespace (the single-namespace in-memory
            # model) matches.
            ref_ns = ref.get("namespace")
            return ref_ns is None or pod_ns is None or ref_ns == pod_ns

        prebound = sorted((p for p in pvs if _prebound_for_claim(p)),
                          key=lambda p: p["metadata"]["name"])
        if prebound:
            usable = [p for p in prebound
                      if pv_node_affinity_matches(p, kube_node)]
            if not usable:
                return False, ["node(s) had volume node affinity "
                               "conflict"], {}
            proposed[claim_name] = usable[0]["metadata"]["name"]
            continue
        want_class = (pvc.get("spec") or {}).get("storageClassName") or ""
        need = _pvc_request(pvc)
        candidates = sorted(
            (p for p in pvs
             if _pv_available(p)
             and p["metadata"]["name"] not in reserved
             and p["metadata"]["name"] not in proposed.values()
             and ((p.get("spec") or {}).get("storageClassName") or "")
             == want_class
             and _pv_capacity(p) >= need
             and pv_node_affinity_matches(p, kube_node)),
            key=lambda p: (_pv_capacity(p), p["metadata"]["name"]))
        if not candidates:
            return False, ["node(s) didn't find available persistent "
                           "volumes to bind"], {}
        proposed[claim_name] = candidates[0]["metadata"]["name"]
    return True, [], proposed


def general_predicates(kube_pod: dict, kube_node: dict, used_ports: set,
                       core_allocatable: dict, requested_core: dict) -> tuple:
    """The GeneralPredicates composite: resources + host + ports +
    selector in one registered name."""
    reasons: list = []
    for ok, why in (
            pod_fits_resources(kube_pod, core_allocatable, requested_core),
            pod_fits_host(kube_pod, kube_node),
            pod_fits_host_ports(kube_pod, used_ports),
            pod_matches_node_selector(kube_pod, kube_node)):
        if not ok:
            reasons.extend(why)
    return not reasons, reasons
