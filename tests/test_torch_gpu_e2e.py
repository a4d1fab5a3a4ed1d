"""The JAX package's control plane carrying NVIDIA cards through the
port's two plugin files and nothing else: the in-memory API server, the
node agent's `DevicesManager` loading `kubegpu_tpu_torch/plugins/device/`
(its NVML backend swapped for a fake host), `DeviceAdvertiser`, and
`DevicesScheduler` with the compiled-in `TPUScheduler` plus
`kubegpu_tpu_torch/plugins/scheduler/` loaded through
`add_devices_from_plugins`, then `Scheduler` (the pattern of
tests/test_e2e.py). The port's `GPURuntimeHook` then hands each placed pod
its cards, directly and through the JAX `CRIHookServer`."""

import json
import os
import socket

import pytest

pytest.importorskip("torch")

from kubegpu_tpu.cluster.apiserver import InMemoryAPIServer  # noqa: E402
from kubegpu_tpu.core import codec  # noqa: E402
from kubegpu_tpu.core.types import ContainerInfo, PodInfo  # noqa: E402
from kubegpu_tpu.node.advertiser import DeviceAdvertiser  # noqa: E402
from kubegpu_tpu.node.manager import DevicesManager  # noqa: E402
from kubegpu_tpu.runtime.server import (CRIHookServer,  # noqa: E402
                                        request_create_container)
from kubegpu_tpu.scheduler.core import Scheduler  # noqa: E402
from kubegpu_tpu.scheduler.registry import DevicesScheduler  # noqa: E402
from kubegpu_tpu.scheduler.tpu_scheduler import TPUScheduler  # noqa: E402
from kubegpu_tpu_torch.core import grammar  # noqa: E402
from kubegpu_tpu_torch.node import fake  # noqa: E402
from kubegpu_tpu_torch.node.manager import GPUDeviceManager  # noqa: E402
from kubegpu_tpu_torch.runtime.hook import (GANG_PROCESS_ANNOTATION,  # noqa: E402
                                            AllocationMismatch,
                                            GPURuntimeHook)
from kubegpu_tpu_torch.scheduler.gpu_scheduler import GPUScheduler  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEVICE_PLUGINS = os.path.join(REPO, "kubegpu_tpu_torch", "plugins", "device")
SCHEDULER_PLUGINS = os.path.join(REPO, "kubegpu_tpu_torch", "plugins",
                                 "scheduler")


def gpu_pod(name, numgpu, auto=False, memory=0):
    pi = PodInfo(name=name)
    if auto:
        pi.requests[grammar.GPU_TOPOLOGY_GENERATION] = 1
    reqs = {grammar.RESOURCE_NUM_GPU: numgpu}
    if memory:
        reqs[grammar.RESOURCE_MEMORY_PER_GPU] = memory
    pi.running_containers["main"] = ContainerInfo(requests=reqs)
    meta = {"name": name}
    codec.pod_info_to_annotation(meta, pi)
    return {"metadata": meta,
            "spec": {"containers": [{"name": "main", "resources": {
                "requests": {"cpu": "1"}}}]}}


class GPUHost:
    """One simulated host: the plugin-loaded GPU device on a fake backend,
    the advertiser and the port's runtime hook."""

    def __init__(self, api, name, inventory):
        api.create_node({"metadata": {"name": name},
                         "status": {"allocatable": {"cpu": "64", "pods": 100}}})
        self.dev_mgr = DevicesManager()
        assert self.dev_mgr.add_devices_from_plugins(DEVICE_PLUGINS) == 1
        self.gpu = self.dev_mgr.devices[0]
        assert isinstance(self.gpu, GPUDeviceManager)
        self.backend = fake.FakeGPUBackend(inventory)
        self.gpu.backend = self.backend
        self.dev_mgr.start()
        self.advertiser = DeviceAdvertiser(api, self.dev_mgr, name,
                                           address="127.0.0.1")
        self.advertiser.advertise_once()
        self.hook = GPURuntimeHook(api, self.gpu)
        self.inventory = inventory


def make_cluster(*inventories):
    api = InMemoryAPIServer()
    hosts = {f"host{i}": GPUHost(api, f"host{i}", inv)
             for i, inv in enumerate(inventories)}
    ds = DevicesScheduler()
    ds.add_device(TPUScheduler())
    assert ds.add_devices_from_plugins(SCHEDULER_PLUGINS) == 1
    assert isinstance(ds.devices[-1], GPUScheduler)
    assert ds.run_group_scheduler == [False, True]
    return api, hosts, Scheduler(api, ds)


def visible(config) -> list:
    env = {e["key"]: e["value"] for e in config["envs"]}
    assert env["NVIDIA_VISIBLE_DEVICES"] == env["CUDA_VISIBLE_DEVICES"]
    return env["CUDA_VISIBLE_DEVICES"].split(",")


def indices(host, uuids) -> list:
    return sorted(host.inventory.gpu(u).index for u in uuids)


@pytest.mark.parametrize("numgpu,pairs", [(1, 1), (2, 1), (4, 2), (8, 4)])
def test_pods_land_on_whole_nvlink_pairs(numgpu, pairs):
    api, hosts, sched = make_cluster(fake.pcie_h100_inventory())
    api.create_pod(gpu_pod("p", numgpu))
    sched.run_until_idle()
    assert api.get_pod("p")["spec"]["nodeName"] == "host0"
    host = hosts["host0"]
    cfg = host.hook.create_container("p", "main", {})
    idx = indices(host, visible(cfg))
    assert len(idx) == numgpu
    assert len({i // 2 for i in idx}) == pairs      # inside NVLink pairs
    devs = [d["host_path"] for d in cfg["devices"]]
    assert devs[:numgpu] == [f"/dev/nvidia{i}" for i in idx]
    assert "/dev/nvidiactl" in devs and "/dev/nvidia-uvm" in devs


@pytest.mark.parametrize("batch", ["1", "0"])
def test_contention_leaves_the_third_pod_pending_with_reasons(batch, monkeypatch):
    # KGTPU_BATCH=0 is the control plane's serial path, whose event names
    # each node's reasons; the batch cycle's event does not
    monkeypatch.setenv("KGTPU_BATCH", batch)
    api, hosts, sched = make_cluster(fake.pcie_h100_inventory())
    for name, n in (("a", 4), ("b", 2), ("c", 4)):
        api.create_pod(gpu_pod(name, n))
    sched.run_until_idle()
    assert api.get_pod("a")["spec"]["nodeName"] == "host0"
    assert api.get_pod("b")["spec"]["nodeName"] == "host0"
    assert api.get_pod("c")["spec"].get("nodeName") is None
    assert sched.queue.pending_count() == 1
    msgs = [e.get("message", "") for e in api.list_events("c")]
    assert msgs
    if batch == "0":
        assert any("Insufficient main/alpha/grpresource/gpugrp1" in m
                   for m in msgs), msgs
    host = hosts["host0"]
    got_a = visible(host.hook.create_container("a", "main", {}))
    got_b = visible(host.hook.create_container("b", "main", {}))
    assert set(got_a).isdisjoint(got_b)
    assert len({i // 2 for i in indices(host, got_a)}) == 2
    assert len({i // 2 for i in indices(host, got_b)}) == 1
    # a leaves: c fits on the pairs a held
    api.delete_pod("a")
    sched.run_until_idle()
    assert api.get_pod("c")["spec"]["nodeName"] == "host0"
    got_c = visible(host.hook.create_container("c", "main", {}))
    assert set(got_c).isdisjoint(got_b)


def test_numgpu_beyond_the_host_names_numgpu():
    api, hosts, sched = make_cluster(fake.rig_inventory())
    api.create_pod(gpu_pod("two", 2))
    sched.run_until_idle()
    assert api.get_pod("two")["spec"].get("nodeName") is None
    msgs = " ".join(e.get("message", "") for e in api.list_events("two"))
    assert grammar.RESOURCE_NUM_GPU in msgs, msgs


def test_gpu_pod_never_fits_a_tpu_only_cluster_vacuously():
    from kubegpu_tpu.node.fake import FakeTPUBackend
    from kubegpu_tpu.node.manager import TPUDeviceManager

    api = InMemoryAPIServer()
    api.create_node({"metadata": {"name": "tpu0"},
                     "status": {"allocatable": {"cpu": "16", "pods": 100}}})
    dm = DevicesManager()
    dm.add_device(TPUDeviceManager(FakeTPUBackend()))
    dm.start()
    DeviceAdvertiser(api, dm, "tpu0").advertise_once()
    ds = DevicesScheduler()
    ds.add_device(TPUScheduler())
    ds.add_devices_from_plugins(SCHEDULER_PLUGINS)
    sched = Scheduler(api, ds)
    api.create_pod(gpu_pod("g", 1))
    sched.run_until_idle()
    assert api.get_pod("g")["spec"].get("nodeName") is None


def test_unhealthy_card_is_never_placed():
    inv = fake.pcie_h100_inventory()
    api, hosts, sched = make_cluster(inv)
    host = hosts["host0"]
    bad = inv.gpus[2].uuid
    host.backend.set_chip_health(bad, "failed")
    host.advertiser.advertise_once()
    for i in range(8):
        api.create_pod(gpu_pod(f"p{i}", 1))
    sched.run_until_idle()
    placed = [f"p{i}" for i in range(8)
              if api.get_pod(f"p{i}")["spec"].get("nodeName")]
    assert len(placed) == 7
    cards = [u for p in placed
             for u in visible(host.hook.create_container(p, "main", {}))]
    assert len(set(cards)) == 7 and bad not in cards


def test_auto_topology_mode_places_inside_one_group():
    api, hosts, sched = make_cluster(fake.pcie_h100_inventory(),
                                     fake.hgx_h100_inventory(host=1))
    api.create_pod(gpu_pod("auto", 4, auto=True))
    sched.run_until_idle()
    node = api.get_pod("auto")["spec"]["nodeName"]
    host = hosts[node]
    idx = indices(host, visible(host.hook.create_container("auto", "main", {})))
    assert len(idx) == 4
    # the best-connected shape in the cluster is the HGX board's one
    # NVLink group of eight
    assert node == "host1"
    ann = json.loads(api.get_pod("auto")["metadata"]["annotations"][
        codec.POD_ANNOTATION_KEY])
    reqs = ann["runningcontainer"]["main"]["devrequests"]
    assert len({k.split("/gpu/")[0] for k in reqs if "/gpu/" in k}) == 1


def test_memory_per_gpu_floor():
    api, hosts, sched = make_cluster(fake.pcie_h100_inventory())
    api.create_pod(gpu_pod("fits", 2, memory=fake.H100_MEMORY))
    api.create_pod(gpu_pod("toobig", 1, memory=fake.H100_MEMORY + 1))
    sched.run_until_idle()
    assert api.get_pod("fits")["spec"]["nodeName"] == "host0"
    assert api.get_pod("toobig")["spec"].get("nodeName") is None


def _placed_cluster():
    api, hosts, sched = make_cluster(fake.pcie_h100_inventory())
    api.create_pod(gpu_pod("p", 2))
    sched.run_until_idle()
    return api, hosts["host0"]


STALE = {"devices": [
    {"host_path": "/dev/nvidia7", "container_path": "/dev/nvidia7"},
    {"host_path": "/dev/nvidiactl", "container_path": "/dev/nvidiactl"},
    {"host_path": "/dev/null", "container_path": "/dev/null"}],
    "envs": [{"key": "KEEP", "value": "1"},
             {"key": "CUDA_VISIBLE_DEVICES", "value": "0"}]}


def test_hook_strips_stale_entries():
    api, host = _placed_cluster()
    cfg = host.hook.create_container("p", "main", json.loads(json.dumps(STALE)))
    uuids = visible(cfg)
    paths = [d["host_path"] for d in cfg["devices"]]
    want = [f"/dev/nvidia{i}" for i in indices(host, uuids)]
    assert paths[0] == "/dev/null"
    assert [p for p in paths if p.startswith("/dev/nvidia")] == \
        want + ["/dev/nvidiactl", "/dev/nvidia-uvm"]
    keys = [e["key"] for e in cfg["envs"]]
    assert keys.count("CUDA_VISIBLE_DEVICES") == 1 and "KEEP" in keys
    # a container the pod does not have is left alone
    assert host.hook.create_container("p", "other", {"x": 1}) == {"x": 1}


def test_hook_refuses_a_short_allocation():
    api, host = _placed_cluster()
    pod = api.get_pod("p")
    pi = codec.kube_pod_to_pod_info(pod, invalidate_existing=False)
    cont = pi.running_containers["main"]
    cont.allocate_from = dict(sorted(cont.allocate_from.items())[:1])
    meta = dict(pod["metadata"])
    codec.pod_info_to_annotation(meta, pi)
    pod["metadata"] = meta
    api.restore_object("pod", "modified", pod)
    with pytest.raises(AllocationMismatch, match="requested 2 GPUs"):
        host.hook.create_container("p", "main", {})


def test_hook_served_through_the_cri_hook_server(tmp_path):
    api, host = _placed_cluster()
    direct = host.hook.create_container("p", "main", json.loads(json.dumps(STALE)))
    server = CRIHookServer(host.hook, unix_socket=str(tmp_path / "cri.sock"))
    server.start()
    try:
        endpoint = f"unix://{tmp_path / 'cri.sock'}"
        served = request_create_container(endpoint, "p", "main",
                                          json.loads(json.dumps(STALE)))
        assert served == direct
        assert server.requests_served == 1
    finally:
        server.stop()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_gang_env_forms_a_two_rank_group(tmp_path):
    """Two 1-card pods on two hosts, a hand-written gang annotation of two
    ranks coordinated on host1: each pod's hook env forms one 2-rank gloo
    group through `spmd.distributed_init_from_env`."""
    import torch

    from tests import torch_worlds

    api, hosts, sched = make_cluster(fake.rig_inventory(0),
                                     fake.rig_inventory(1))
    for r in range(2):
        api.create_pod(gpu_pod(f"rank{r}", 1))
    sched.run_until_idle()
    port = _free_port()
    envs = []
    for r in range(2):
        pod = api.get_pod(f"rank{r}")
        node = pod["spec"]["nodeName"]
        pod["metadata"]["annotations"][GANG_PROCESS_ANNOTATION] = json.dumps({
            "gang": 7, "rank": r, "count": 2, "coordinator_node": "host1",
            "coordinator_port": port})
        api.restore_object("pod", "modified", pod)
        cfg = hosts[node].hook.create_container(f"rank{r}", "main", {})
        env = {e["key"]: e["value"] for e in cfg["envs"]}
        assert env["MASTER_ADDR"] == "127.0.0.1"      # host1's address
        assert (env["MASTER_PORT"], env["WORLD_SIZE"], env["RANK"],
                env["LOCAL_RANK"]) == (str(port), "2", str(r), "0")
        assert env["CUDA_VISIBLE_DEVICES"] == \
            hosts[node].inventory.gpus[0].uuid
        envs.append(env)
    in_dir = tmp_path / "in"
    in_dir.mkdir()
    torch.save({"envs": envs}, in_dir / "inputs.pt")
    out = torch_worlds.run_world("tests.torch_worlds.job_gang_env", 2,
                                 str(in_dir), str(tmp_path / "out"))
    assert out == [{"formed": True, "rank": r, "world": 2, "sum": 3.0}
                   for r in range(2)]


def test_gang_coordinator_without_an_address_resolves_to_its_name():
    api, host = _placed_cluster()
    pod = api.get_pod("p")
    pod["metadata"]["annotations"][GANG_PROCESS_ANNOTATION] = json.dumps({
        "gang": 1, "rank": 0, "count": 1, "coordinator_node": "nowhere",
        "coordinator_port": 29500})
    api.restore_object("pod", "modified", pod)
    env = {e["key"]: e["value"]
           for e in host.hook.create_container("p", "main", {})["envs"]}
    assert env["MASTER_ADDR"] == "nowhere"
