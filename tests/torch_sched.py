"""Shared by the port's engine tests (tests/test_torch_scheduler.py,
test_torch_gang.py, test_torch_gang_preempt.py, test_torch_quota.py,
test_torch_extender.py and test_torch_repair.py among them):
GPU clusters on the JAX package's in-memory API server, scheduled either
by the port's engine (`kubegpu_tpu_torch.scheduler.core.Scheduler` over
`build_device_scheduler`) or by the JAX engine with the port's plugin
file (the `make_cluster` pattern of tests/test_torch_gpu_e2e.py).

By default the JAX engine runs its scalar path (``KGTPU_VECTORIZE=0``,
``KGTPU_BATCH=0``) and the port's engine its default path (batch cycle
and masked pass on); ``path=`` picks either for either engine. The port's
engine catches the port's typed API errors, so it sees the in-memory
server through `PortAPI`, which re-raises the JAX server's errors as the
port's."""

from __future__ import annotations

import json
import socket

from kubegpu_tpu.cluster import apiserver as jax_api
from kubegpu_tpu.cluster.apiserver import InMemoryAPIServer
from kubegpu_tpu.core import codec as jax_codec
from kubegpu_tpu.scheduler.core import Scheduler as JaxScheduler
from kubegpu_tpu.scheduler.registry import DevicesScheduler as JaxRegistry
from kubegpu_tpu.scheduler.tpu_scheduler import TPUScheduler
from kubegpu_tpu_torch.cluster import httpapi
from kubegpu_tpu_torch.core import codec, grammar
from kubegpu_tpu_torch.scheduler import gang
from kubegpu_tpu_torch.scheduler.core import Scheduler
from kubegpu_tpu_torch.scheduler.registry import build_device_scheduler
from tests.test_torch_gpu_e2e import SCHEDULER_PLUGINS, GPUHost, gpu_pod

_ERRORS = ((jax_api.Conflict, httpapi.Conflict),
           (jax_api.NotFound, httpapi.NotFound),
           (jax_api.QuotaExceeded, httpapi.QuotaExceeded))


class PortAPI:
    """The in-memory API server, its typed errors re-raised as the
    port's (`cluster/httpapi.py`)."""

    def __init__(self, api):
        self._api = api

    def __getattr__(self, name):
        attr = getattr(self._api, name)
        if not callable(attr):
            return attr

        def call(*args, **kwargs):
            try:
                return attr(*args, **kwargs)
            except tuple(j for j, _ in _ERRORS) as err:
                port = next(p for j, p in _ERRORS if isinstance(err, j))
                raise port(str(err), per_pod=err.per_pod) from err
        return call


def cluster(engine: str, *inventories, tweak=None, monkeypatch=None,
            path: str | None = None, **engine_kw):
    """``(api, hosts, scheduler)``: one `GPUHost` per inventory
    (``host0``, ``host1``, ...), ``tweak(api, hosts)`` applied to the
    cluster before the engine starts, then the engine on ``path``
    (``"scalar"`` or ``"default"``; the JAX engine's is scalar unless
    asked, the port's default), built with ``engine_kw`` (``quota=``,
    ``extenders=``). Without ``monkeypatch`` the port's engine takes the
    path the environment gives it."""
    api = InMemoryAPIServer()
    hosts = {f"host{i}": GPUHost(api, f"host{i}", inv)
             for i, inv in enumerate(inventories)}
    if tweak is not None:
        tweak(api, hosts)
    path = path or ("scalar" if engine == "jax" else "default")
    if monkeypatch is not None:
        switch = "1" if path == "default" else "0"
        monkeypatch.setenv("KGTPU_VECTORIZE", switch)
        monkeypatch.setenv("KGTPU_BATCH", switch)
    if engine == "jax":
        ds = JaxRegistry()
        ds.add_device(TPUScheduler())
        assert ds.add_devices_from_plugins(SCHEDULER_PLUGINS) == 1
        return api, hosts, JaxScheduler(api, ds, **engine_kw)
    return api, hosts, Scheduler(PortAPI(api), build_device_scheduler(),
                                 **engine_kw)


def edit_node(api, name: str, labels=None, taints=None) -> None:
    """Set a node's labels and taints (before the engine starts)."""
    node = api.get_node(name)
    if labels:
        node["metadata"].setdefault("labels", {}).update(labels)
    if taints:
        node.setdefault("spec", {})["taints"] = taints
    api.restore_object("node", "modified", node)


def pod(name: str, numgpu: int, *, memory: int = 0, auto: bool = False,
        priority: int = 0, labels=None, spec=None, gang_id=None,
        gang_size=None) -> dict:
    """A GPU pod (`gpu_pod`) with scheduling fields and gang keys."""
    p = gpu_pod(name, numgpu, auto=auto, memory=memory)
    if gang_id is not None:
        pi = jax_codec.kube_pod_to_pod_info(p, invalidate_existing=False)
        pi.requests[grammar.RESOURCE_GANG] = gang_id
        pi.requests[grammar.RESOURCE_GANG_SIZE] = gang_size
        jax_codec.pod_info_to_annotation(p["metadata"], pi)
    if labels:
        p["metadata"]["labels"] = dict(labels)
    p["spec"]["priority"] = priority
    p["spec"].update(spec or {})
    return p


def placement(api, name: str):
    """``(nodeName, {container: allocate_from})`` of a pod, or None when
    it is gone."""
    try:
        p = api.get_pod(name)
    except KeyError:
        return None
    node = p["spec"].get("nodeName")
    alloc = {}
    if node:
        info = codec.kube_pod_to_pod_info(p, invalidate_existing=False)
        alloc = {c: dict(ci.allocate_from)
                 for c, ci in sorted(info.running_containers.items())}
    return node, alloc


def contract(api, name: str) -> dict | None:
    raw = api.get_pod(name)["metadata"].get("annotations", {}).get(
        gang.GANG_PROCESS_ANNOTATION)
    return json.loads(raw) if raw else None


def free_gang_id() -> int:
    """A gang id whose coordinator port is free on this machine, outside
    the ids the JAX package's gang tests draw (733-832)."""
    for gid in range(1200, 1400):
        with socket.socket() as s:
            try:
                s.bind(("127.0.0.1", gang.gang_coordinator_port(gid)))
                return gid
            except OSError:
                continue
    raise RuntimeError("no free coordinator port")


def card_paths(api, node: str) -> dict:
    """``{card UUID: its cards-leaf path}`` as ``node`` advertises them."""
    info = codec.annotation_to_node_info(api.get_node(node)["metadata"])
    return {grammar.gpu_id_from_path(p): p for p in info.allocatable
            if grammar.gpu_id_from_path(p) is not None}


def bound_pod(api, node: str, name: str, uuids, *, priority: int = 0,
              labels=None, gang_id=None, gang_size=None) -> dict:
    """A pod already bound to exact cards of ``node`` (identity
    ``allocate_from``, as the engine pins a gang member), created on the
    API server: a fixed pattern for preemption scenarios."""
    paths = card_paths(api, node)
    p = pod(name, len(uuids), priority=priority, labels=labels,
            gang_id=gang_id, gang_size=gang_size)
    pi = jax_codec.kube_pod_to_pod_info(p, invalidate_existing=False)
    cont = pi.running_containers["main"]
    for uuid in uuids:
        cont.dev_requests[paths[uuid]] = 1
        cont.allocate_from[paths[uuid]] = paths[uuid]
    pi.node_name = node
    jax_codec.pod_info_to_annotation(p["metadata"], pi)
    p["spec"]["nodeName"] = node
    api.create_pod(p)
    return p


def alive(api, name: str) -> bool:
    try:
        api.get_pod(name)
        return True
    except KeyError:
        return False
