"""Annotation codec: node/pod annotations <-> the device side's types.

The port's copy of the JSON path of ``kubegpu_tpu/core/codec.py``: the
node advertises its inventory as one JSON blob under
``node.alpha/DeviceInformation``, the scheduler writes the allocation back
as ``pod.alpha/DeviceInformation`` (`kubeinterface/kubeinterface.go:29-123`).
Both are ``json.dumps(..., sort_keys=True)``, so the JAX codec and this
one write the same bytes for the same object. Kubernetes objects are
plain dicts in their JSON shape. The binary stream codec of the JAX
package is not part of the port.
"""

from __future__ import annotations

import json
import math
import re

from kubegpu_tpu_torch.core.types import ContainerInfo, NodeInfo, PodInfo

NODE_ANNOTATION_KEY = "node.alpha/DeviceInformation"
POD_ANNOTATION_KEY = "pod.alpha/DeviceInformation"
# Routable address of the node agent's host, advertised alongside the
# inventory; the runtime hook resolves a gang's coordinator node through
# it (node names need not resolve).
NODE_ADDRESS_ANNOTATION = "node.alpha/Address"
# Wall-clock seconds the advertiser stamps on every pass that lands: the
# liveness signal the JAX control plane's NodeLifecycle ages into
# Ready/Stale/Lost. Wall clock, since the stamp crosses hosts.
NODE_HEARTBEAT_ANNOTATION = "node.alpha/Heartbeat"
# Per-card health map {uuid: "healthy" | ...} from the device backend; a
# card that is not healthy is withheld from the advertised allocatable.
NODE_CHIP_HEALTH_ANNOTATION = "node.alpha/ChipHealth"
# Per-device dead-link bitmask map {id: mask}; zero masks are dropped.
NODE_LINK_HEALTH_ANNOTATION = "node.alpha/LinkHealth"

# Kubernetes quantity suffixes -> multiplier; the reference reads requests
# through resource.Quantity.Value(), which rounds up to a whole int64.
_QUANTITY_SUFFIXES = {
    "": 1,
    "m": 1e-3,
    "k": 1e3, "M": 1e6, "G": 1e9, "T": 1e12, "P": 1e15, "E": 1e18,
    "Ki": 2**10, "Mi": 2**20, "Gi": 2**30, "Ti": 2**40, "Pi": 2**50, "Ei": 2**60,
}
_QUANTITY_RE = re.compile(r"^([+-]?[0-9.eE+-]+?)([A-Za-z]*)$")


def parse_quantity(val: "int | float | str") -> int:
    """Parse a Kubernetes resource quantity to a whole number, rounding up
    (``"500m"`` -> 1, ``"1Gi"`` -> 2**30)."""
    if isinstance(val, (int, float)):
        return math.ceil(val)
    m = _QUANTITY_RE.match(str(val).strip())
    if not m or m.group(2) not in _QUANTITY_SUFFIXES:
        raise ValueError(f"invalid quantity: {val!r}")
    number, suffix = m.groups()
    try:
        parsed = float(number)
    except ValueError:
        raise ValueError(f"invalid quantity: {val!r}") from None
    return math.ceil(parsed * _QUANTITY_SUFFIXES[suffix])


def _annotations(meta: dict) -> dict:
    # Tolerate "annotations": null, which some serializers emit for empty maps.
    if not meta.get("annotations"):
        meta["annotations"] = {}
    return meta["annotations"]


def node_info_to_annotation(meta: dict, node_info: NodeInfo) -> None:
    """Serialize a node's device inventory into its metadata annotations
    (`kubeinterface.go:29-40`)."""
    _annotations(meta)[NODE_ANNOTATION_KEY] = json.dumps(
        node_info.to_json(), sort_keys=True
    )


def annotation_to_node_info(meta: dict, existing: NodeInfo | None = None) -> NodeInfo:
    """Decode a node annotation, keeping ``existing``'s in-memory ``used``
    accounting, which the advertiser never writes (`kubeinterface.go:42-61`)."""
    node_info = NodeInfo()
    ann = meta.get("annotations") or {}
    raw = ann.get(NODE_ANNOTATION_KEY)
    if raw is not None:
        node_info = NodeInfo.from_json(json.loads(raw))
    if existing is not None and existing.used:
        for key, val in existing.used.items():
            node_info.used[key] = val
    return node_info


def heartbeat_to_annotation(meta: dict, timestamp: float) -> None:
    """Stamp the advertiser's liveness heartbeat (wall-clock seconds)."""
    _annotations(meta)[NODE_HEARTBEAT_ANNOTATION] = json.dumps(
        round(float(timestamp), 3))


def annotation_to_heartbeat(meta: dict) -> float | None:
    """The heartbeat timestamp; None when there is none or it does not
    parse (liveness is then not tracked for the node)."""
    raw = (meta.get("annotations") or {}).get(NODE_HEARTBEAT_ANNOTATION)
    if raw is None:
        return None
    try:
        return float(json.loads(raw))
    except (TypeError, ValueError):
        return None


def chip_health_to_annotation(meta: dict, health: dict) -> None:
    """Serialize the backend's per-card health map."""
    _annotations(meta)[NODE_CHIP_HEALTH_ANNOTATION] = json.dumps(
        dict(health), sort_keys=True)


def annotation_to_chip_health(meta: dict) -> dict:
    """Decode the per-card health map; {} = everything healthy."""
    raw = (meta.get("annotations") or {}).get(NODE_CHIP_HEALTH_ANNOTATION)
    if not raw:
        return {}
    try:
        decoded = json.loads(raw)
    except (TypeError, ValueError):
        return {}
    return decoded if isinstance(decoded, dict) else {}


def link_health_to_annotation(meta: dict, dead_links: dict) -> None:
    """Serialize the per-device dead-link bitmask map, zero masks
    dropped (absence means every link up)."""
    _annotations(meta)[NODE_LINK_HEALTH_ANNOTATION] = json.dumps(
        {k: int(v) for k, v in dict(dead_links).items() if int(v)},
        sort_keys=True)


def annotation_to_link_health(meta: dict) -> dict:
    """Decode the dead-link map; {} = every link up."""
    raw = (meta.get("annotations") or {}).get(NODE_LINK_HEALTH_ANNOTATION)
    if not raw:
        return {}
    try:
        decoded = json.loads(raw)
    except (TypeError, ValueError):
        return {}
    if not isinstance(decoded, dict):
        return {}
    out = {}
    for dev_id, mask in decoded.items():
        try:
            if int(mask):
                out[str(dev_id)] = int(mask)
        except (TypeError, ValueError):
            continue
    return out


def pod_info_to_annotation(meta: dict, pod_info: PodInfo) -> None:
    """Serialize the scheduler's decision into pod metadata annotations
    (`kubeinterface.go:111-123`)."""
    _annotations(meta)[POD_ANNOTATION_KEY] = json.dumps(
        pod_info.to_json(), sort_keys=True
    )


def annotation_to_pod_info(meta: dict) -> PodInfo:
    """Decode the persisted decision from pod metadata, raw: no pod-spec
    merge, no invalidation (that is :func:`kube_pod_to_pod_info`)."""
    raw = (meta.get("annotations") or {}).get(POD_ANNOTATION_KEY)
    if raw is None:
        return PodInfo()
    return PodInfo.from_json(json.loads(raw))


def _merge_kube_containers(
    containers: dict, kube_containers: list, invalidate: bool
) -> None:
    """Fold core-Kubernetes container requests into ContainerInfos
    (`kubeinterface.go:63-85`). With ``invalidate``, stale scheduler output
    (``allocate_from``/``dev_requests``) is dropped and ``dev_requests``
    reset to the annotation's ``requests``."""
    for c in kube_containers:
        name = c["name"]
        info = containers.setdefault(name, ContainerInfo())
        for res, val in ((c.get("resources") or {}).get("requests") or {}).items():
            info.kube_requests[res] = parse_quantity(val)
    if invalidate:
        for info in containers.values():
            info.allocate_from = {}
            info.dev_requests = dict(info.requests)


def kube_pod_to_pod_info(kube_pod: dict, invalidate_existing: bool) -> PodInfo:
    """Convert a Kubernetes pod (JSON dict) into the scheduler's PodInfo
    (`kubeinterface.go:88-109`): the existing device annotation first, then
    the spec's container requests merged into ``kube_requests``."""
    meta = kube_pod.get("metadata") or {}
    pod_info = PodInfo()
    raw = (meta.get("annotations") or {}).get(POD_ANNOTATION_KEY)
    if raw is not None:
        pod_info = PodInfo.from_json(json.loads(raw))
    pod_info.name = meta.get("name", "")
    spec = kube_pod.get("spec") or {}
    _merge_kube_containers(
        pod_info.init_containers, spec.get("initContainers") or [], invalidate_existing
    )
    _merge_kube_containers(
        pod_info.running_containers, spec.get("containers") or [], invalidate_existing
    )
    if invalidate_existing:
        pod_info.node_name = ""
    return pod_info
