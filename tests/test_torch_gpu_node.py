"""The port's GPU node side on the CPU: NVML's pure part (link codes and
grouping) on canned link matrices, grouping and advertising on the three
fake hosts, health, the debounce, `allocate`, and the tree shape of a GPU
host against a TPU host in both packages. One test, marked `cuda`, reads
NVML on a card."""

import os

import pytest

torch = pytest.importorskip("torch")

from kubegpu_tpu.core import grammar as jgrammar  # noqa: E402
from kubegpu_tpu.core import types as jtypes  # noqa: E402
from kubegpu_tpu.node.fake import FakeTPUBackend, v5p_host_inventory  # noqa: E402
from kubegpu_tpu.node.manager import TPUDeviceManager  # noqa: E402
from kubegpu_tpu.topology import tree as jtree  # noqa: E402
from kubegpu_tpu_torch.core import grammar  # noqa: E402
from kubegpu_tpu_torch.core.types import ContainerInfo, NodeInfo, PodInfo  # noqa: E402
from kubegpu_tpu_torch.node import fake, nvml  # noqa: E402
from kubegpu_tpu_torch.node.backend import GPUInfo, GPUInventory  # noqa: E402
from kubegpu_tpu_torch.node.manager import (CONTROL_DEVICES,  # noqa: E402
                                            GPUDeviceManager)
from kubegpu_tpu_torch.topology import tree as ttree  # noqa: E402

G = "alpha/grpresource"
N = nvml


# ---- the pure part of nvml.py ----------------------------------------------

@pytest.mark.parametrize("level,nvlink,code", [
    (N.NVML_TOPOLOGY_INTERNAL, False, 6), (N.NVML_TOPOLOGY_SINGLE, False, 5),
    (N.NVML_TOPOLOGY_MULTIPLE, False, 4), (N.NVML_TOPOLOGY_HOSTBRIDGE, False, 3),
    (N.NVML_TOPOLOGY_NODE, False, 2), (N.NVML_TOPOLOGY_SYSTEM, False, 1),
    (None, False, 0), (35, False, 0),
    (N.NVML_TOPOLOGY_SYSTEM, True, 6), (None, True, 6)])
def test_link_code_table(level, nvlink, code):
    assert N.link_code(level, nvlink) == code


def _matrix(n, code_of):
    return [[0 if i == j else code_of(i, j) for j in range(n)] for i in range(n)]


# name -> (link-code matrix, order keys, expected (gpugrp1, gpugrp0) per card)
MATRICES = {
    # PCIe switch pairs, two sockets: gpugrp0 = switch pair, one gpugrp1
    "switch_pairs_two_sockets": (
        _matrix(4, lambda i, j: 5 if i // 2 == j // 2 else 1), [0, 1, 2, 3],
        [(0, 0), (0, 0), (0, 1), (0, 1)]),
    # a switch tree (code 4) still joins gpugrp0; a host bridge (3) does not
    "multi_switch_vs_host_bridge": (
        _matrix(4, lambda i, j: 4 if i // 2 == j // 2 else 3), [0, 1, 2, 3],
        [(0, 0), (0, 0), (0, 1), (0, 1)]),
    # unknown links (NVML withholds the level): every card alone
    "unknown_links": (_matrix(3, lambda i, j: 0), [0, 1, 2],
                      [(0, 0), (1, 1), (2, 2)]),
    # NVML listed the cards in another order than their bus ids: indices
    # follow the lowest bus id, not the listing
    "order_by_lowest_bus_id": (
        _matrix(4, lambda i, j: 6 if i % 2 == j % 2 else 0),
        [("0000:9A",), ("0000:18",), ("0000:DB",), ("0000:2A",)],
        [(1, 1), (0, 0), (1, 1), (0, 0)]),
    # transitive: 0-1 and 1-2 at code 5 put 0, 1, 2 in one gpugrp0
    "transitive_chain": (
        [[0, 5, 1, 1], [5, 0, 5, 1], [1, 5, 0, 1], [1, 1, 1, 0]], [0, 1, 2, 3],
        [(0, 0), (0, 0), (0, 0), (0, 1)]),
    # two islands that never reach each other: two gpugrp1
    "two_islands": (_matrix(4, lambda i, j: 2 if i // 2 == j // 2 else 0),
                    [0, 1, 2, 3], [(0, 0), (0, 1), (1, 2), (1, 3)]),
}


@pytest.mark.parametrize("case", sorted(MATRICES))
def test_group_cards_on_canned_matrices(case):
    links, order, expected = MATRICES[case]
    assert N.group_cards(links, order) == expected


def test_inventory_from_reads_is_symmetric():
    cards = [(i, f"GPU-{i}", 10 + i, 1 << 30, None) for i in range(3)]
    pairs = {(0, 1): (N.NVML_TOPOLOGY_SINGLE, False),
             (0, 2): (None, True), (1, 2): (N.NVML_TOPOLOGY_SYSTEM, False)}
    inv = N.inventory_from_reads(cards, pairs)
    assert inv.links == [[0, 5, 6], [5, 0, 1], [6, 1, 0]]
    assert [g.device_paths for g in inv.gpus] == \
        [["/dev/nvidia10"], ["/dev/nvidia11"], ["/dev/nvidia12"]]
    assert N.card_order(inv.gpus[0]) < N.card_order(inv.gpus[1])


def test_struct_layouts_match_the_header():
    # nvml.h:185-197: 16 + 5 * 4 + 32 bytes; nvml.h:244-250: 3 * 8
    import ctypes

    assert ctypes.sizeof(N.NvmlPciInfo) == 68
    assert N.NvmlPciInfo.busId.offset == 36
    assert ctypes.sizeof(N.NvmlMemory) == 24


class _ErrLib:
    @staticmethod
    def nvmlErrorString(code):
        return b"Not Supported" if code == 3 else b"Unknown Error"


def test_check_raises_except_on_optional_not_supported():
    assert N.NVMLBackend._check(_ErrLib, "f", N.NVML_SUCCESS)
    assert not N.NVMLBackend._check(_ErrLib, "f", N.NVML_ERROR_NOT_SUPPORTED,
                                    optional=True)
    with pytest.raises(N.NVMLError, match="Not Supported"):
        N.NVMLBackend._check(_ErrLib, "f", N.NVML_ERROR_NOT_SUPPORTED)
    with pytest.raises(N.NVMLError):
        N.NVMLBackend._check(_ErrLib, "f", 999, optional=True)


def test_nvml_that_cannot_load_raises_and_the_node_advertises_zero():
    backend = N.NVMLBackend("libnvidia-ml-absent.so.1")
    with pytest.raises(RuntimeError, match="NVML cannot load"):
        backend.enumerate()
    mgr = GPUDeviceManager(backend)
    mgr.start()
    assert mgr.inventory is None
    info = NodeInfo()
    mgr.update_node_info(info)
    assert info.capacity == {grammar.RESOURCE_NUM_GPU: 0}
    assert info.allocatable == {grammar.RESOURCE_NUM_GPU: 0}


# ---- grouping and advertising on the fakes --------------------------------

def _advertise(inv, **kw):
    backend = fake.FakeGPUBackend(inv)
    mgr = GPUDeviceManager(backend, **kw)
    info = NodeInfo(name="n")
    mgr.update_node_info(info)
    return backend, mgr, info


def _groups(res: dict) -> dict:
    """gpugrp1/<i>/gpugrp0/<j> -> sorted UUIDs of its cards leaves."""
    out: dict = {}
    for key in res:
        uuid = grammar.gpu_id_from_path(key)
        if uuid is not None:
            grp = key[len(G) + 1:key.index("/gpu/")]
            out.setdefault(grp, []).append(uuid)
    return {k: sorted(v) for k, v in out.items()}


@pytest.mark.parametrize("name,groups", [
    ("hgx_h100_inventory", {"gpugrp1/0/gpugrp0/0": list(range(8))}),
    ("pcie_h100_inventory", {f"gpugrp1/0/gpugrp0/{p}": [2 * p, 2 * p + 1]
                             for p in range(4)}),
    ("rig_inventory", {"gpugrp1/0/gpugrp0/0": [0]})])
def test_grouping_and_advertising_on_the_fakes(name, groups):
    inv = getattr(fake, name)()
    _, _, info = _advertise(inv)
    want = {g: sorted(fake.fake_uuid(0, i) for i in idx)
            for g, idx in groups.items()}
    assert _groups(info.allocatable) == want
    assert _groups(info.capacity) == want
    n = len(inv.gpus)
    assert info.capacity[grammar.RESOURCE_NUM_GPU] == n
    assert info.allocatable[grammar.RESOURCE_NUM_GPU] == n
    for gpu in inv.gpus:
        cards = [k for k in info.allocatable
                 if k.endswith(f"/gpu/{gpu.uuid}/cards")]
        assert len(cards) == 1 and info.allocatable[cards[0]] == 1
        mem = cards[0][:-len("cards")] + "memory"
        assert info.allocatable[mem] == gpu.memory_bytes
    assert len(info.allocatable) == 2 * n + 1


def test_group_indices_do_not_follow_the_listing_order():
    inv = fake.pcie_h100_inventory()
    perm = [5, 2, 7, 0, 3, 6, 1, 4]
    shuffled = GPUInventory(
        gpus=[inv.gpus[p] for p in perm],
        links=[[inv.links[p][q] for q in perm] for p in perm])
    assert _advertise(shuffled)[2].allocatable == _advertise(inv)[2].allocatable


def test_discovery_failure_advertises_zero_cards():
    backend, mgr, info = _advertise(fake.hgx_h100_inventory())
    backend.fail = True
    info = NodeInfo()
    mgr.update_node_info(info)
    assert info.capacity == {grammar.RESOURCE_NUM_GPU: 0}
    assert info.allocatable == {grammar.RESOURCE_NUM_GPU: 0}


def test_unhealthy_card_withheld_from_allocatable():
    inv = fake.pcie_h100_inventory()
    backend = fake.FakeGPUBackend(inv)
    bad = inv.gpus[3].uuid
    backend.set_chip_health(bad, "failed")
    mgr = GPUDeviceManager(backend)
    info = NodeInfo()
    mgr.update_node_info(info)
    assert info.capacity[grammar.RESOURCE_NUM_GPU] == 8
    assert info.allocatable[grammar.RESOURCE_NUM_GPU] == 7
    assert any(bad in k for k in info.capacity)
    assert not any(bad in k for k in info.allocatable)
    assert mgr.chip_health() == {bad: "failed"}
    backend.set_chip_health(bad, "healthy")
    info = NodeInfo()
    mgr.update_node_info(info)
    assert info.allocatable[grammar.RESOURCE_NUM_GPU] == 8


def test_health_debounce():
    inv = fake.hgx_h100_inventory()
    backend = fake.FakeGPUBackend(inv)
    mgr = GPUDeviceManager(backend, health_debounce=2)
    uuid = inv.gpus[5].uuid

    def allocatable():
        info = NodeInfo()
        mgr.update_node_info(info)
        return info.allocatable[grammar.RESOURCE_NUM_GPU]

    # a 1-in-2 flapper never lands
    backend.set_chip_flapper(uuid, "degraded", period=2)
    assert [allocatable() for _ in range(6)] == [8] * 6
    backend.set_chip_flapper(uuid, None)
    # a steady fault lands on the second probe, and heals on the second
    backend.set_chip_health(uuid, "failed")
    assert [allocatable(), allocatable(), allocatable()] == [8, 7, 7]
    backend.set_chip_health(uuid, "healthy")
    assert [allocatable(), allocatable()] == [7, 8]


def test_health_probe_failure_is_advisory():
    class Broken(fake.FakeGPUBackend):
        def chip_health(self):
            raise RuntimeError("probe down")

    mgr = GPUDeviceManager(Broken(fake.rig_inventory()))
    info = NodeInfo()
    mgr.update_node_info(info)
    assert info.allocatable[grammar.RESOURCE_NUM_GPU] == 1


# ---- allocate ---------------------------------------------------------------

def _container(mgr, uuids, extra=None):
    paths = {}
    for i, uuid in enumerate(uuids):
        gpu = mgr.inventory.gpu(uuid) or GPUInfo(0, uuid, 0, 0)
        base = (mgr.gpu_group_path(gpu) if uuid in mgr.groups
                else f"gpugrp1/0/gpugrp0/0/gpu/{uuid}")
        paths[f"{G}/gpu/{i}/cards"] = f"{G}/{base}/cards"
        paths[f"{G}/gpu/{i}/memory"] = f"{G}/{base}/memory"
    paths.update(extra or {})
    return ContainerInfo(allocate_from=paths)


@pytest.mark.parametrize("uvm_tools", [False, True])
def test_allocate_paths_and_env(uvm_tools):
    inv = fake.pcie_h100_inventory()
    mgr = GPUDeviceManager(fake.FakeGPUBackend(inv),
                           device_exists=lambda p: uvm_tools)
    mgr.start()
    pick = [inv.gpus[6].uuid, inv.gpus[1].uuid]
    vols, devs, env = mgr.allocate(PodInfo(name="p"), _container(mgr, pick))
    assert vols == []
    assert devs == ["/dev/nvidia1", "/dev/nvidia6", *CONTROL_DEVICES] + \
        (["/dev/nvidia-uvm-tools"] if uvm_tools else [])
    want = f"{inv.gpus[1].uuid},{inv.gpus[6].uuid}"
    assert env == {"CUDA_VISIBLE_DEVICES": want, "NVIDIA_VISIBLE_DEVICES": want}


def test_allocate_minor_numbers_name_the_device_nodes():
    inv = GPUInventory(gpus=[GPUInfo(0, "GPU-a", 5, 1), GPUInfo(1, "GPU-b", 2, 1)],
                       links=[[0, 6], [6, 0]])
    mgr = GPUDeviceManager(fake.FakeGPUBackend(inv), device_exists=lambda p: False)
    mgr.start()
    _, devs, env = mgr.allocate(PodInfo(), _container(mgr, ["GPU-b", "GPU-a"]))
    assert devs[:2] == ["/dev/nvidia5", "/dev/nvidia2"]
    assert env["CUDA_VISIBLE_DEVICES"] == "GPU-a,GPU-b"


def test_allocate_unknown_uuid_raises_and_other_paths_are_ignored():
    mgr = GPUDeviceManager(fake.FakeGPUBackend(fake.rig_inventory()))
    mgr.start()
    with pytest.raises(RuntimeError, match="not on this host"):
        mgr.allocate(PodInfo(name="p"), _container(mgr, ["GPU-elsewhere"]))
    tpu_only = ContainerInfo(allocate_from={
        f"{G}/tpu/0/chips": f"{G}/tpugrp1/0/tpugrp0/0/tpu/0.0.0/chips",
        f"{G}/gpu/0/memory": f"{G}/gpugrp1/0/gpugrp0/0/gpu/GPU-x/memory"})
    assert mgr.allocate(PodInfo(), tpu_only) == ([], [], {})
    assert mgr.allocate(PodInfo(), ContainerInfo()) == ([], [], {})
    uuid = fake.rig_inventory().gpus[0].uuid
    _, devs, env = mgr.allocate(PodInfo(), _container(mgr, [uuid], {
        f"{G}/tpu/0/chips": f"{G}/tpugrp1/0/tpugrp0/0/tpu/0.0.0/chips"}))
    assert devs[0] == "/dev/nvidia0" and env["CUDA_VISIBLE_DEVICES"] == uuid


def test_allocate_before_discovery_raises():
    mgr = GPUDeviceManager(fake.FakeGPUBackend(fail=True))
    mgr.start()
    with pytest.raises(RuntimeError, match="not discovered"):
        mgr.allocate(PodInfo(), ContainerInfo(allocate_from={"a": "b"}))


# ---- grammar and tree shape ---------------------------------------------

def test_grammar_helpers():
    path = grammar.gpu_resource("GPU-1", "cards", ("gpugrp1", 0), ("gpugrp0", 2))
    assert path == f"{G}/gpugrp1/0/gpugrp0/2/gpu/GPU-1/cards"
    assert grammar.gpu_id_from_path(path) == "GPU-1"
    assert grammar.gpu_prefix_from_path(path) == path[:-len("/cards")]
    assert grammar.gpu_id_from_path(path[:-5] + "memory") is None
    assert grammar.gpu_prefix_from_path(f"{G}/tpu/0.0.0/chips") is None
    for name in (path, "cpu", f"{G}/gpu/a/enumType", f"{G}/gpu/a/Enumx",
                 "alpha.gpu/numgpu", f"{G}/x"):
        assert grammar.is_group_resource(name) == jgrammar.is_group_resource(name)
        assert grammar.prechecked_resource(name) == \
            jgrammar.prechecked_resource(name)
        assert grammar.is_enum_resource(name) == jgrammar.is_enum_resource(name)


def test_pcie_pairs_have_the_tree_shape_of_v5p_trays():
    """The PCIe fake's first two NVLink pairs and a v5p host's two trays of
    two chips canonicalise to the same shape tree, in both packages."""
    _, _, info = _advertise(fake.pcie_h100_inventory())
    gpu_res = {k: v for k, v in info.allocatable.items()
               if "/gpugrp0/0/" in k or "/gpugrp0/1/" in k}
    tpu = jtypes.NodeInfo()
    TPUDeviceManager(FakeTPUBackend(v5p_host_inventory())).update_node_info(tpu)
    trees = [ttree.tree_from_resources(gpu_res),
             jtree.tree_from_resources(gpu_res, "gpugrp", "cards"),
             ttree.tree_from_resources(tpu.allocatable, "tpugrp", "chips"),
             jtree.tree_from_resources(tpu.allocatable)]
    assert trees[0].val == 4 and [c.val for c in trees[0].children] == [4]
    for a in trees:
        for b in trees:
            assert ttree.compare_trees(a, b) and jtree.compare_trees(a, b)
    assert ttree.compute_tree_score(trees[0]) == \
        jtree.compute_tree_score(trees[3])
    whole = ttree.tree_from_resources(info.allocatable)
    assert not ttree.compare_trees(whole, trees[0])
    assert [c.val for c in whole.children[0].children] == [2, 2, 2, 2]


# ---- on a card --------------------------------------------------------------

@pytest.mark.cuda
def test_nvml_backend_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and NVIDIA's NVML")
    inv = N.NVMLBackend().enumerate()
    assert len(inv.gpus) >= torch.cuda.device_count() >= 1
    uuids = {g.uuid for g in inv.gpus}
    for d in range(torch.cuda.device_count()):
        assert f"GPU-{torch.cuda.get_device_properties(d).uuid}" in uuids
    for g in inv.gpus:
        assert g.memory_bytes > 0
        assert os.path.exists(f"/dev/nvidia{g.minor}")
    info = NodeInfo()
    GPUDeviceManager(N.NVMLBackend()).update_node_info(info)
    assert info.allocatable[grammar.RESOURCE_NUM_GPU] == len(inv.gpus)
