"""Tenant identity and demand of a pod object.

The pod-side helpers of ``kubegpu_tpu/cluster/apf.py`` that the scheduling
engine's fair-share gate (``scheduler/quota.py``) reads. A pod belongs to
the tenant its ``kgtpu.io/tenant`` label names (or ``tenant``, or the
annotation of the same key); a pod with neither belongs to no tenant and
passes every quota untouched. Its demand is counted in GPU cards and in
core-resource CPU, the two dimensions of dominant-resource fairness.

The front door the JAX module also holds (request classification and
fair queuing in front of the API server) comes with the port's API
server (ROADMAP Queue 1, item 10.7.2).
"""

from __future__ import annotations

from kubegpu_tpu_torch.core import codec, grammar

# Tenant identity on pod objects: a label (primary) or annotation
# (fallback), under the JAX package's keys so both read one wire.
TENANT_LABEL = "kgtpu.io/tenant"
TENANT_ANNOTATION = "kgtpu.io/tenant"


def tenant_of_pod(pod: dict | None) -> str | None:
    """The tenant a pod object belongs to (label first, annotation as
    fallback), or None for untenanted/system pods."""
    if not isinstance(pod, dict):
        return None
    meta = pod.get("metadata") or {}
    labels = meta.get("labels") or {}
    tenant = labels.get(TENANT_LABEL) or labels.get("tenant")
    if tenant:
        return str(tenant)
    ann = meta.get("annotations") or {}
    tenant = ann.get(TENANT_ANNOTATION)
    return str(tenant) if tenant else None


def pod_chip_request(pod: dict | None) -> int:
    """GPU cards a pod asks for — the quantity tenant fair share is
    measured in: each running container's ``alpha.gpu/numgpu``, or, where
    a container gives none, its count of per-card
    ``.../gpu/<UUID>/cards`` leaf requests."""
    if not isinstance(pod, dict):
        return 0
    try:
        pi = codec.kube_pod_to_pod_info(pod, invalidate_existing=False)
    except (TypeError, ValueError, KeyError):
        return 0
    total = 0
    for cont in pi.running_containers.values():
        n = int(cont.requests.get(grammar.RESOURCE_NUM_GPU, 0) or 0)
        if n == 0:
            n = sum(1 for res in cont.requests
                    if grammar.gpu_id_from_path(str(res)) is not None)
        total += n
    return total


def pod_cpu_request(pod: dict | None) -> float:
    """Core-resource CPU a pod requests (DRF's second dimension)."""
    if not isinstance(pod, dict):
        return 0.0
    total = 0.0
    for cont in (pod.get("spec") or {}).get("containers") or []:
        req = ((cont.get("resources") or {}).get("requests") or {})
        raw = req.get("cpu")
        if raw is None:
            continue
        try:
            total += float(codec.parse_quantity(raw))
        except (TypeError, ValueError):
            continue
    return total
