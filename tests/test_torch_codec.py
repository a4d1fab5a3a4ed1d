"""The port's annotation codec against the JAX package's: the same
objects give the same annotation bytes, and each side reads what the
other wrote."""

import pytest

pytest.importorskip("torch")

from kubegpu_tpu.core import codec as jcodec  # noqa: E402
from kubegpu_tpu.core import types as jtypes  # noqa: E402
from kubegpu_tpu_torch.core import codec as tcodec  # noqa: E402
from kubegpu_tpu_torch.core import types as ttypes  # noqa: E402
from kubegpu_tpu_torch.node import fake  # noqa: E402
from kubegpu_tpu_torch.node.manager import GPUDeviceManager  # noqa: E402

G = "alpha/grpresource"


def _advertised(inventory_fn, **health):
    backend = fake.FakeGPUBackend(inventory_fn())
    for uuid, state in health.items():
        backend.set_chip_health(uuid, state)
    info = ttypes.NodeInfo(name="gpu-host")
    GPUDeviceManager(backend).update_node_info(info)
    return info.to_json()


NODES = {
    "tpu_host": {"name": "host0",
                 "capacity": {f"{G}/tpu/0.0.0/chips": 1, "cpu": 8},
                 "allocatable": {f"{G}/tpu/0.0.0/chips": 1, "cpu": 8},
                 "scorer": {f"{G}/tpu/0.0.0/chips": 0}},
    "hgx": _advertised(fake.hgx_h100_inventory),
    "pcie_one_unhealthy": _advertised(
        fake.pcie_h100_inventory, **{fake.fake_uuid(0, 3): "failed"}),
    "rig_with_used": dict(_advertised(fake.rig_inventory),
                          used={f"{G}/gpugrp1/0/gpugrp0/0/gpu/x/cards": 1}),
    "empty": {},
}


@pytest.mark.parametrize("case", sorted(NODES))
def test_node_annotation_both_ways(case):
    data = NODES[case]
    tmeta, jmeta = {"name": "n"}, {"name": "n"}
    tcodec.node_info_to_annotation(tmeta, ttypes.NodeInfo.from_json(data))
    jcodec.node_info_to_annotation(jmeta, jtypes.NodeInfo.from_json(data))
    assert tmeta == jmeta                     # wire-equal bytes
    assert jcodec.annotation_to_node_info(tmeta).to_json() == data
    assert tcodec.annotation_to_node_info(jmeta).to_json() == data
    # the in-memory `used` survives a re-patch on either side
    used = {f"{G}/gpu/GPU-a/cards": 1}
    assert tcodec.annotation_to_node_info(
        jmeta, jtypes.NodeInfo(used=used)).used["alpha/grpresource/gpu/GPU-a/cards"] == 1
    assert jcodec.annotation_to_node_info(
        tmeta, ttypes.NodeInfo(used=used)).to_json() == \
        tcodec.annotation_to_node_info(jmeta, ttypes.NodeInfo(used=used)).to_json()


PODS = {
    "gpu_placed": {
        "podname": "p1", "nodename": "gpu-host",
        "requests": {"alpha.gpu/gpu-generate-topology": 0},
        "runningcontainer": {"main": {
            "requests": {"alpha.gpu/numgpu": 2},
            "devrequests": {f"{G}/gpugrp1/0/gpugrp0/0/gpu/0/cards": 1,
                            f"{G}/gpugrp1/0/gpugrp0/0/gpu/1/cards": 1},
            "allocatefrom": {
                f"{G}/gpugrp1/0/gpugrp0/0/gpu/0/cards":
                    f"{G}/gpugrp1/0/gpugrp0/3/gpu/GPU-6/cards",
                f"{G}/gpugrp1/0/gpugrp0/0/gpu/1/cards":
                    f"{G}/gpugrp1/0/gpugrp0/3/gpu/GPU-7/cards"},
            "scorer": {f"{G}/gpugrp1/0/gpugrp0/0/gpu/0/cards": 1}}},
        "initcontainer": {"init": {"requests": {"alpha.gpu/numgpu": 1}}}},
    "tpu_placed": {
        "podname": "p1", "nodename": "host0",
        "requests": {"alpha.tpu/numchips": 4},
        "runningcontainer": {"main": {
            "requests": {"alpha.tpu/numchips": 4},
            "devrequests": {f"{G}/tpu/0/chips": 1},
            "allocatefrom": {f"{G}/tpu/0/chips": f"{G}/tpu/0.0.0/chips"}}}},
    "stale": {"podname": "p1", "nodename": "host0", "runningcontainer": {
        "main": {"requests": {"r": 2}, "devrequests": {"stale": 1},
                 "allocatefrom": {"stale": "loc"}}}},
    "empty": {},
}


@pytest.mark.parametrize("case", sorted(PODS))
def test_pod_annotation_both_ways(case):
    data = PODS[case]
    tmeta, jmeta = {"name": "p1"}, {"name": "p1"}
    tcodec.pod_info_to_annotation(tmeta, ttypes.PodInfo.from_json(data))
    jcodec.pod_info_to_annotation(jmeta, jtypes.PodInfo.from_json(data))
    assert tmeta == jmeta
    assert jcodec.annotation_to_pod_info(tmeta).to_json() == data
    assert tcodec.annotation_to_pod_info(jmeta).to_json() == data


def _full(pi) -> dict:
    """Everything a PodInfo holds, ``kube_requests`` included (which
    ``to_json`` leaves out)."""
    out = pi.to_json()
    out["kube"] = {name: dict(c.kube_requests)
                   for name, c, _ in pi.all_containers()}
    out["name"] = pi.name
    return out


def _kube_pod(annotation, spec, annotations_null=False):
    meta = {"name": "p1"}
    if annotation is not None:
        jcodec.pod_info_to_annotation(
            meta, jtypes.PodInfo.from_json(PODS[annotation]))
    if annotations_null:
        meta["annotations"] = None
    return {"metadata": meta, "spec": spec}


# the pods of tests/test_codec.py's cases, and a GPU pod
KUBE_PODS = {
    "roundtrip": _kube_pod("tpu_placed", {"containers": [
        {"name": "main", "resources": {"requests": {"cpu": 2}}}]}),
    "invalidation": _kube_pod("stale", {"containers": [{"name": "main"}]}),
    "spec_only": _kube_pod(None, {
        "initContainers": [{"name": "init0",
                            "resources": {"requests": {"cpu": 1}}}],
        "containers": [{"name": "main"}]}),
    "quantities": _kube_pod(None, {"containers": [
        {"name": "m", "resources": {"requests": {"cpu": "500m",
                                                 "memory": "1Gi"}}}]},
        annotations_null=True),
    "gpu": _kube_pod("gpu_placed", {
        "initContainers": [{"name": "init"}],
        "containers": [{"name": "main", "resources": {"requests": {
            "cpu": "1500m", "memory": "2Ki"}}}, {"name": "sidecar"}]}),
}


@pytest.mark.parametrize("invalidate", [False, True])
@pytest.mark.parametrize("case", sorted(KUBE_PODS))
def test_kube_pod_to_pod_info_equal(case, invalidate):
    pod = KUBE_PODS[case]
    got = tcodec.kube_pod_to_pod_info(pod, invalidate_existing=invalidate)
    ref = jcodec.kube_pod_to_pod_info(pod, invalidate_existing=invalidate)
    assert _full(got) == _full(ref)


@pytest.mark.parametrize("val", [2, 2.5, "2", "500m", "1Gi", "1500m", "1e3",
                                 "2k", "3Mi", "-1", "0.1Ki"])
def test_parse_quantity_equal(val):
    assert tcodec.parse_quantity(val) == jcodec.parse_quantity(val)


@pytest.mark.parametrize("val", ["garbage-units", "1Qi", ""])
def test_parse_quantity_rejects_as_reference(val):
    with pytest.raises(ValueError):
        jcodec.parse_quantity(val)
    with pytest.raises(ValueError):
        tcodec.parse_quantity(val)


def test_keys_and_group_prefix_equal():
    for key in ("NODE_ANNOTATION_KEY", "POD_ANNOTATION_KEY",
                "NODE_ADDRESS_ANNOTATION"):
        assert getattr(tcodec, key) == getattr(jcodec, key)
    assert ttypes.DEVICE_GROUP_PREFIX == jtypes.DEVICE_GROUP_PREFIX
    res_t, res_j = {}, {}
    ttypes.add_group_resource(res_t, "gpu/GPU-a/cards", 1)
    jtypes.add_group_resource(res_j, "gpu/GPU-a/cards", 1)
    assert res_t == res_j


def test_node_shape_key_equal():
    data = NODES["rig_with_used"]
    assert ttypes.NodeInfo.from_json(data).shape_key() == \
        jtypes.NodeInfo.from_json(data).shape_key()
