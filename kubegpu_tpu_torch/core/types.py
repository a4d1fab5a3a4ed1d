"""Core data model of the port's device side: its own copy of
``kubegpu_tpu/core/types.py``, with the same attribute names and the same
JSON, so an annotation written by either package reads in the other.

These are the equivalents of the reference's L1 types
(`types/types.go:3-112`). Resource lists are plain ``dict[str, int]`` keyed
by hierarchical resource-path strings (see `core.grammar`) —
the string grammar is the wire format, carried in node/pod annotations.

Scorer selection rides per-resource as a small int enum
(reference: `device-scheduler/types/types.go:32-36`).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterator

# Namespace prefix for group resources (reference: `types/types.go:5-8`).
# Everything under this prefix is handled by the group allocator; everything
# else is "prechecked" — assumed handled by the core scheduler's ordinary
# resource accounting (reference: `resource/resourcetranslate.go:97-99`).
DEVICE_GROUP_PREFIX = "alpha/grpresource"

# A resource path -> requested/available amount.
ResourceList = dict  # dict[str, int]
# A request path -> the physical device path it is satisfied from.
ResourceLocation = dict  # dict[str, str]
# A resource path -> scorer enum (see allocator.scorers).
ResourceScorer = dict  # dict[str, int]


@dataclass
class ContainerInfo:
    """Per-container device requests and (after scheduling) the allocation.

    Reference: `types/types.go:19-25`.

    - ``kube_requests``: requests handled by the core scheduler (CPU/memory);
      kept only for resource translation, never serialized.
    - ``requests``: device requests as specified in pod annotations.
    - ``dev_requests``: requests after topology translation — what the group
      allocator actually schedules.
    - ``allocate_from``: request path -> physical device path; the scheduler's
      decision, and the only thing the runtime hook trusts.
    - ``scorer``: per-resource scorer overrides from the pod spec.
    """

    kube_requests: ResourceList = field(default_factory=dict)
    requests: ResourceList = field(default_factory=dict)
    dev_requests: ResourceList = field(default_factory=dict)
    allocate_from: ResourceLocation = field(default_factory=dict)
    scorer: ResourceScorer = field(default_factory=dict)

    def clone(self) -> "ContainerInfo":
        return ContainerInfo(
            kube_requests=dict(self.kube_requests),
            requests=dict(self.requests),
            dev_requests=dict(self.dev_requests),
            allocate_from=dict(self.allocate_from),
            scorer=dict(self.scorer),
        )

    # Wire format mirrors the reference's JSON tags (`types/types.go:19-25`)
    # so annotations are shape-compatible.
    def to_json(self) -> dict:
        out: dict = {}
        if self.requests:
            out["requests"] = dict(self.requests)
        if self.dev_requests:
            out["devrequests"] = dict(self.dev_requests)
        if self.allocate_from:
            out["allocatefrom"] = dict(self.allocate_from)
        if self.scorer:
            out["scorer"] = dict(self.scorer)
        return out

    @classmethod
    def from_json(cls, data: dict) -> "ContainerInfo":
        return cls(
            requests=dict(data.get("requests") or {}),
            dev_requests=dict(data.get("devrequests") or {}),
            allocate_from=dict(data.get("allocatefrom") or {}),
            scorer=dict(data.get("scorer") or {}),
        )


@dataclass
class PodInfo:
    """Pod-level view the device scheduler operates on.

    Reference: `types/types.go:51-57`. ``node_name`` is the node for which
    ``dev_requests``/``allocate_from`` are valid — set when the scheduler
    customizes the pod for a host, cleared when requests are invalidated.
    """

    name: str = ""
    node_name: str = ""
    requests: ResourceList = field(default_factory=dict)
    init_containers: dict = field(default_factory=dict)  # name -> ContainerInfo
    running_containers: dict = field(default_factory=dict)  # name -> ContainerInfo

    def container(self, name: str) -> "ContainerInfo | None":
        if name in self.init_containers:
            return self.init_containers[name]
        return self.running_containers.get(name)

    def all_containers(self) -> "Iterator[tuple[str, ContainerInfo, bool]]":
        """(name, info, is_init) triples, deterministic order."""
        for name in sorted(self.running_containers):
            yield name, self.running_containers[name], False
        for name in sorted(self.init_containers):
            yield name, self.init_containers[name], True

    def clone(self) -> "PodInfo":
        return PodInfo(
            name=self.name,
            node_name=self.node_name,
            requests=dict(self.requests),
            init_containers={k: v.clone() for k, v in self.init_containers.items()},
            running_containers={k: v.clone() for k, v in self.running_containers.items()},
        )

    def to_json(self) -> dict:
        out: dict = {}
        if self.name:
            out["podname"] = self.name
        if self.node_name:
            out["nodename"] = self.node_name
        if self.requests:
            out["requests"] = dict(self.requests)
        if self.init_containers:
            out["initcontainer"] = {k: v.to_json() for k, v in self.init_containers.items()}
        if self.running_containers:
            out["runningcontainer"] = {
                k: v.to_json() for k, v in self.running_containers.items()
            }
        return out

    @classmethod
    def from_json(cls, data: dict) -> "PodInfo":
        return cls(
            name=data.get("podname", ""),
            node_name=data.get("nodename", ""),
            requests=dict(data.get("requests") or {}),
            init_containers={
                k: ContainerInfo.from_json(v)
                for k, v in (data.get("initcontainer") or {}).items()
            },
            running_containers={
                k: ContainerInfo.from_json(v)
                for k, v in (data.get("runningcontainer") or {}).items()
            },
        )


@dataclass
class NodeInfo:
    """Device inventory a node advertises, plus scheduler-side usage.

    Reference: `types/types.go:76-82`. ``used`` is scheduler-side state —
    the advertiser never writes it, and the annotation decoder preserves the
    in-memory value across re-patches (`kubeinterface.go:54-58`).
    """

    name: str = ""
    capacity: ResourceList = field(default_factory=dict)
    allocatable: ResourceList = field(default_factory=dict)
    used: ResourceList = field(default_factory=dict)
    scorer: ResourceScorer = field(default_factory=dict)

    def clone(self) -> "NodeInfo":
        return NodeInfo(
            name=self.name,
            capacity=dict(self.capacity),
            allocatable=dict(self.allocatable),
            used=dict(self.used),
            scorer=dict(self.scorer),
        )

    def shape_key(self) -> tuple:
        """Hashable fingerprint of everything a fit decision reads —
        inventory, usage, scorer config — deliberately excluding ``name``:
        two nodes with equal shape keys give identical (fits, reasons,
        score) for the same request, which is what lets a uniform fleet
        share one allocator search (the reference's tree-shape cluster
        cache idea, `gpu.go:102-183`, applied to the fit pass)."""
        # zero used-entries are accounting residue (take then return):
        # a churned node must shape-match a fresh one
        return (tuple(sorted(self.allocatable.items())),
                tuple(sorted((k, v) for k, v in self.used.items() if v)),
                tuple(sorted(self.scorer.items())))

    def to_json(self) -> dict:
        out: dict = {}
        if self.name:
            out["name"] = self.name
        if self.capacity:
            out["capacity"] = dict(self.capacity)
        if self.allocatable:
            out["allocatable"] = dict(self.allocatable)
        if self.used:
            out["used"] = dict(self.used)
        if self.scorer:
            out["scorer"] = dict(self.scorer)
        return out

    @classmethod
    def from_json(cls, data: dict) -> "NodeInfo":
        return cls(
            name=data.get("name", ""),
            capacity=dict(data.get("capacity") or {}),
            allocatable=dict(data.get("allocatable") or {}),
            used=dict(data.get("used") or {}),
            scorer=dict(data.get("scorer") or {}),
        )


def add_group_resource(res: ResourceList, key: str, val: int) -> None:
    """Add an amount under the group-resource prefix.

    Reference: `types/types.go:114-116`.
    """
    res[f"{DEVICE_GROUP_PREFIX}/{key}"] = val
